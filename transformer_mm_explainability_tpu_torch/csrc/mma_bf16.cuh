// bf16 building blocks for the bf16-product kernels on Hopper (and the
// bf16 storage of the fp32 ones and of RoIPool): the round-to-nearest-even
// conversion, the accumulator-to-A-fragment repack that feeds a
// probability tile to the next wgmma, and element access to tensors stored
// as fp32 or bf16.
//
// The arithmetic is the JAX package's fast_dots mode
// (transformer_mm_explainability_tpu/ops/attn_block_pallas.py _dot/_cast,
// flash_attention.py _dot/_dot_tt): every operand of a product rounded to
// bf16, to nearest with ties to even as XLA's astype rounds
// (__floats2bfloat162_rn, cvt.rn.bf16x2.f32; not the ties-away rounding of
// mma_tf32.cuh's to_tf32), the products exact and summed in fp32.
//
// A wgmma accumulator tile (m64nN, fp32) gives each warp 16 rows; for the
// lane with g = lane / 4 and t = lane % 4, its element 4 j + 2 hh + e is
// row g + 8 hh, column 8 j + 2 t + e. The A operand of wgmma from registers
// takes, per warp and 16-deep k step, the m16n8k16 A fragment (each
// register two bf16, the lower k in the low half):
//   a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//   a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
// so two neighbouring 8-column groups of accumulators, packed in pairs, are
// the A fragment over k = their 16 columns (a_from_acc_bf16): a probability
// or ds tile in registers feeds the next product with no shuffle.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// (lo, hi) -> bf16x2, each rounded to nearest, ties to even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two groups of four accumulators (columns 0-7 in c0, 8-15 in c1) as the A
// fragment of their 16 columns, each value rounded to bf16.
__device__ __forceinline__ void a_from_acc_bf16(const float c0[4], const float c1[4],
                                                uint32_t a[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ float bf16_value(bf16 v) { return __bfloat162float(v); }

// The two bf16 of a 32-bit word (the first element in the low half), widened.
__device__ __forceinline__ float2 widen_bf16x2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// One element of a tensor stored as fp32 or bf16 (is_bf16), as fp32.
__device__ __forceinline__ float load_any(const void* p, long long i, bool is_bf16) {
  return is_bf16 ? bf16_value(static_cast<const bf16*>(p)[i]) : static_cast<const float*>(p)[i];
}

// Stores v into a tensor of fp32 or bf16 (rounded to nearest even).
__device__ __forceinline__ void store_any(void* p, long long i, float v, bool is_bf16) {
  if (is_bf16)
    static_cast<bf16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

}  // namespace
