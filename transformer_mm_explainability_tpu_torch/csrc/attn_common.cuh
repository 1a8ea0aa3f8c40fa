// Pieces shared by the attention sources (attn_block.cu, fp32 products;
// attn_block_bf16.cu, bf16 products): warp reductions, the (batch, head,
// row) strides of an attention operand, and the fixed-order head sum of
// the rule-6 fold.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kWarp = 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Every [B, H, S, dh] operand of the attention kernels is a base pointer
// plus its (batch, head, row) strides in elements; the dh axis has stride 1.
// The row stride is 32-bit (the wrappers check that it fits), so a row
// offset is one widening multiply; batch and head offsets are 64-bit.
struct Strides {
  long long b, h;
  int s;
};

// Offset of the (b, h) head of an operand.
__device__ __forceinline__ long long head_at(const Strides& t, int b, int h) {
  return (long long)b * t.b + (long long)h * t.h;
}

// e_row[b, k] = (1/H) sum_h e_part[b, h, k], the heads in a fixed order.
__global__ void e_row_kernel(const float* __restrict__ e_part, float* __restrict__ e_row,
                             int B, int S, int H) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * S) return;
  const int b = idx / S, k = idx % S;
  float s = 0.f;
  for (int h = 0; h < H; ++h) s += e_part[((size_t)b * H + h) * S + k];
  e_row[idx] = s * (1.0f / H);
}

}  // namespace
