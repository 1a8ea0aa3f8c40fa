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
// ViT-B) do not fit in 227 KB of shared memory.
//
// What bounds it on this card: the captures are read once, 2 x B x L x H x
// S^2 x 4 bytes (358 MB at B=8, ViT-B), against 2 B L S^3 = 1.5 GFLOP of
// chain products: bytes, 0.107 ms at 3.35 TB/s. Only the reduction reads
// them; the products are 12 small dependent steps (8 x 197^3 each) whose
// operands stay in L2.
//
// The earlier design of this kernel ran 24 dependent launches per call: per
// layer, a reduction of 30 MB (0.150 ms for the 12, about 2.4 TB/s, each
// launch filling and draining the card) and a product whose rows of 197
// floats are not 16-byte aligned, so it copied 4 bytes at a time. Ê of a
// layer does not depend on R, so here:
//
//   ehat_kernel   one launch for every layer: E[b, l] = (1/H) sum_h
//                 relu(A[b,l,h] * G[b,l,h]), heads summed in a fixed order,
//                 over all (image, layer >= start, element) at once, each
//                 thread kEhatItems elements a block-width apart (2 x
//                 kEhatItems independent loads per head), the blocks of one
//                 plane consecutive, so that the card streams the captures
//                 plane by plane. Written as [B, L', S, Sp], Sp the next
//                 multiple of 4, the padded columns 0 (15 MB at B=8); the
//                 captures are loaded evict-first, so that E stays in L2
//                 for the products. The same launch sets R0 = I and R1 = 0,
//                 both [B, Sp, Sp]. The capture planes are read with 4-byte
//                 loads: S^2 is odd at S = 197, so the planes of
//                 consecutive heads do not share an alignment.
//   gemm_tc_kernel (common.cuh) per layer, the batched fp32 GEMM on the
//                 tensor cores (3xTF32 mma.sync), the image in blockIdx.z,
//                 with a residual epilogue: R_next[b] = E[b] R[b] + R[b],
//                 M = S, N = K = Sp, written to the other of the two R
//                 buffers. Every row of E and R starts on a 16-byte boundary,
//                 so the GEMM takes 16-byte cp.async copies. The padded
//                 columns of E and rows and columns of R are 0: their terms
//                 in the 3xTF32 product are exact zeros (as the GEMM's own
//                 zero-filled k tail is), R's padded rows are never written
//                 (M = S) and its padded columns come out 0, so R[:S, :S] is
//                 the unpadded chain, bit for bit.

#include "common.cuh"

namespace {

constexpr int kEhatThreads = 256;
constexpr int kEhatItems = 4;  // output elements per thread

// a, g: the captures, plane (b, l, h) at b*ab + l*al + h*ah (g alike), each
// S*S contiguous. e: [B, Lr, S, Sp] for layers start..start+Lr-1; r0, r1:
// [B, Sp, Sp]. blockIdx.x = (b * (Lr + 1) + i) * chunks + chunk, the chunks
// of one plane consecutive: i < Lr reduces kPerBlock elements of layer
// start + i, i == Lr sets R0 = I and R1 = 0 for image b.
__global__ void __launch_bounds__(kEhatThreads)
ehat_kernel(const float* __restrict__ a, const float* __restrict__ g,
            float* __restrict__ e, float* __restrict__ r0, float* __restrict__ r1,
            long long ab, long long al, long long ah, long long gb, long long gl,
            long long gh, int H, int S, int Sp, int start, int Lr) {
  constexpr int kPerBlock = kEhatThreads * kEhatItems;
  const int chunks = (S * Sp + kPerBlock - 1) / kPerBlock;
  const int plane = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const int b = plane / (Lr + 1), i = plane % (Lr + 1);
  if (i == Lr) {
    const int n = Sp * Sp;
    float* p0 = r0 + (long long)b * n;
    float* p1 = r1 + (long long)b * n;
    for (int o = chunk * kEhatThreads + threadIdx.x; o < n;
         o += chunks * kEhatThreads) {
      const int row = o / Sp, col = o % Sp;
      p0[o] = (row == col && row < S) ? 1.f : 0.f;
      p1[o] = 0.f;
    }
    return;
  }
  const int l = start + i;
  const float* ap = a + b * ab + l * al;
  const float* gp = g + b * gb + l * gl;
  float* ep = e + ((long long)b * Lr + i) * S * Sp;
  const int n = S * Sp, base = chunk * kPerBlock;
  int src[kEhatItems];
  bool ok[kEhatItems];
  float s[kEhatItems];
#pragma unroll
  for (int j = 0; j < kEhatItems; ++j) {
    const int o = base + j * kEhatThreads + threadIdx.x;
    const int row = o / Sp, col = o % Sp;
    ok[j] = o < n && col < S;
    src[j] = ok[j] ? row * S + col : 0;
    s[j] = 0.f;
  }
  // the captures are read once: evict-first loads keep E in L2
#pragma unroll 2
  for (int h = 0; h < H; ++h) {
    const float* a_h = ap + h * ah;
    const float* g_h = gp + h * gh;
#pragma unroll
    for (int j = 0; j < kEhatItems; ++j)
      if (ok[j]) s[j] += fmaxf(__ldcs(a_h + src[j]) * __ldcs(g_h + src[j]), 0.f);
  }
#pragma unroll
  for (int j = 0; j < kEhatItems; ++j) {
    const int o = base + j * kEhatThreads + threadIdx.x;
    if (o < n) ep[o] = ok[j] ? s[j] / H : 0.f;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes). Launches on the given stream, never
// synchronises, and returns cudaGetLastError().
// ---------------------------------------------------------------------------

extern "C" {

const char* tmx_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// cams, grads: [B, L, H, S, S], the last two axes contiguous; strides: the
// (batch, layer, head) element strides of cams, then of grads. Sp: S rounded
// up to a multiple of 4. e: scratch [B, L - start, S, Sp]; r0, r1: scratch
// [B, Sp, Sp], 16-byte aligned, set here. Runs layers start..L-1 (start <
// L); the result is R[:, :S, :S] of r0 when L - start is even, else of r1.
int tmx_relevancy_chain(const float* cams, const float* grads, float* e, float* r0,
                        float* r1, const long long* strides, int B, int L, int H, int S,
                        int Sp, int start, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int Lr = L - start;
  if (B < 1 || Lr < 1 || S < 1 || Sp < S || Sp % 4 != 0) return (int)cudaErrorInvalidValue;
  constexpr int kPerBlock = kEhatThreads * kEhatItems;
  const long long chunks = ((long long)S * Sp + kPerBlock - 1) / kPerBlock;
  if ((long long)B * (Lr + 1) * chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(B * (Lr + 1) * chunks));
  ehat_kernel<<<grid, kEhatThreads, 0, st>>>(cams, grads, e, r0, r1, strides[0], strides[1],
                                             strides[2], strides[3], strides[4], strides[5], H,
                                             S, Sp, start, Lr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long plane = (long long)S * Sp, rplane = (long long)Sp * Sp;
  float* cur = r0;
  float* nxt = r1;
  for (int i = 0; i < Lr; ++i) {
    // R_next = E_i R + R: A = E_i (image stride Lr planes), B = res = R
    const GemmArgs p = {e + i * plane, cur, nxt, nullptr, cur, nullptr,
                        Lr * plane, rplane, rplane, S, Sp, Sp, kActNone, 0, false};
    if ((err = gemm(p, false, B, 16, st)) != cudaSuccess) return (int)err;
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
