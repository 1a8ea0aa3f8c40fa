// Hand-written fp32 CUDA kernels for the rule-6 relevancy chain on Hopper.
//
// Replaces the Pallas TPU kernel of
// transformer_mm_explainability_tpu/ops/relevancy_pallas.py:
//   self_attention_relevancy_pallas (_chain_kernel):
//   R = I; per layer l: E = (1/H) sum_h relu(A_lh o G_lh); R <- R + E R.
// The Pallas kernel is one program per image that DMAs each layer's [H, S, S]
// slabs into VMEM (double-buffered), reduces them into E and multiplies on
// the MXU, with S padded to 128. On an H100 one block per image would use 8
// of the 132 SMs, and the [H, S, S] slabs (1.9 MB per image and layer at
// ViT-B) do not fit in 227 KB of shared memory. So each layer is two
// launches over the whole batch:
//
//   ehat_kernel   E[b] = (1/H) sum_h relu(A[b,h] * G[b,h]), one thread per
//                 element of the S x S plane, heads summed in a fixed order.
//   gemm_tc_kernel (common.cuh) the batched fp32 GEMM on the tensor cores
//                 (3xTF32 mma.sync), the image in blockIdx.z, with a
//                 residual epilogue: R_next[b] = E[b] R[b] + R[b], written
//                 to the other of two ping-pong buffers.
//
// No padding: both kernels bound-check their tiles, so S = 197 runs as is.
//
// What bounds it on this card: the captures are read once, 2 x B x L x H x
// S^2 x 4 bytes (358 MB at B=8, ViT-B), against 2 B L S^3 = 1.5 GFLOP of
// chain products: bytes, 0.107 ms at 3.35 TB/s. The reduction is a plain
// coalesced streaming pass with 2H independent loads per thread in flight.
// It loads scalars: a [S, S] plane of fp32 holds S^2 elements, odd for
// S = 197, so the planes of consecutive heads are not 16-byte aligned and a
// float4 load would need a second code path. The GEMM is the one the block
// kernels use; at S = 197 its rows are not 16-byte aligned either, so the
// wrapper asks for its 4-byte copies (copy_bytes), and it takes 64 x 64
// tiles of 8 warps (128 blocks at B = 8, one per SM).

#include "common.cuh"

namespace {

constexpr int kEhatThreads = 256;

// a, g: layer l of the captures, the (b, h) plane at b*ab + h*ah (g alike),
// each plane S*S contiguous; e: [B, S*S].
__global__ void __launch_bounds__(kEhatThreads)
ehat_kernel(const float* __restrict__ a, const float* __restrict__ g,
            float* __restrict__ e, long long ab, long long ah, long long gb,
            long long gh, int H, int SS) {
  const int i = blockIdx.x * kEhatThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= SS) return;
  const float* ap = a + b * ab + i;
  const float* gp = g + b * gb + i;
  float s = 0.f;
#pragma unroll 4
  for (int h = 0; h < H; ++h) s += fmaxf(ap[h * ah] * gp[h * gh], 0.f);
  e[(long long)b * SS + i] = s / H;
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes). Launches on the given stream, never
// synchronises, and returns cudaGetLastError().
// ---------------------------------------------------------------------------

extern "C" {

const char* tmx_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// cams, grads: [B, L, H, S, S], the last two axes contiguous; strides: the
// (batch, layer, head) element strides of cams, then of grads. e: scratch
// [B, S, S]; r0: [B, S, S] holding I on entry; r1: scratch [B, S, S]. Runs
// layers start..L-1; the result is in r0 when L - start is even, else r1.
// copy_bytes: the GEMM's cp.async width, 16 (every row of e, r0 and r1
// 16-byte aligned) or 4.
int tmx_relevancy_chain(const float* cams, const float* grads, float* e, float* r0,
                        float* r1, const long long* strides, int B, int L, int H, int S,
                        int start, int copy_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int SS = S * S;
  const dim3 grid((SS + kEhatThreads - 1) / kEhatThreads, B);
  float* cur = r0;
  float* nxt = r1;
  for (int l = start; l < L; ++l) {
    ehat_kernel<<<grid, kEhatThreads, 0, st>>>(
        cams + l * strides[1], grads + l * strides[4], e, strides[0], strides[2],
        strides[3], strides[5], H, SS);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const GemmArgs p = {e, cur, nxt, nullptr, cur, nullptr, SS, SS, SS, S, S, S, kActNone,
                        false};
    err = gemm(p, false, B, copy_bytes, st);
    if (err != cudaSuccess) return (int)err;
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
