// Hand-written fp32 CUDA kernels for the ViT block branches and the fused
// attention on Hopper.
//
// Replaces the four Pallas TPU kernels of
// transformer_mm_explainability_tpu/ops/attn_block_pallas.py:
//   attn_block_fwd (_fwd_kernel), mlp_block_fwd (_mlp_fwd_kernel),
//   mlp_block_bwd (_mlp_bwd_kernel), attn_block_bwd (_bwd_kernel);
// and, through the same attention kernels, the four of
// transformer_mm_explainability_tpu/ops/flash_attention.py:
//   flash_fwd (_fwd_kernel), flash_bwd_ehat (_bwd_kernel),
//   flash_fwd_qkv (_fwd_kernel2), flash_bwd_ehat_qkv (_bwd_kernel2).
// The attention kernels take every operand as a base pointer plus (batch,
// head, row) strides in elements, the head axis contiguous: one body serves
// the merged [B, S, 3D] / [B, S, D] layouts of the block branches and
// flash_*_qkv, and the per-head [B, H, S, dh] layout (or any split-head view
// of a merged tensor) of flash_fwd / flash_bwd_ehat. The Pallas kernels of
// flash_attention.py hold one whole (image, head) [S, S] tile per program;
// here that is one block per (query or key tile, head, image), as below.
//
// Each attn_block_pallas kernel is one program per image with every weight resident
// in VMEM. That does not map to an H100: fp32 W_qkv alone is 7 MB against
// 227 KB of shared memory per SM, and one program per image leaves most of
// the 132 SMs idle at B=8. So each branch is rebuilt from a few kernels that
// the Python wrappers in ops/attn_block.py chain together:
//
//   ln_fwd_kernel      LayerNorm forward, one warp per row, fp32 statistics;
//                      also writes (mean, 1/sigma) for the backward.
//   ln_vjp_kernel      LayerNorm input-cotangent (the Pallas _ln_vjp) plus
//                      the residual skip, one warp per row.
//   gemm_tc_kernel     (common.cuh) the fp32 GEMM on the tensor cores,
//                      3xTF32 mma.sync fed by a cp.async ring, with an
//                      optional transposed B and fused epilogues: bias,
//                      residual add, exact-erf GELU, multiply by GELU'(aux).
//                      Every product of the Pallas bodies runs here:
//                      LN1*W_qkv, merged*W_out, LN2*W1, GELU*W2, cot*W2^T,
//                      da*W1^T, cot*W_out^T and dqkv*W_qkv^T.
//   attn_fwd_kernel    the attention forward on the tensor cores (below).
//   attn_bwd_q_kernel / attn_bwd_kv_kernel / e_row_kernel
//                      the attention backward on the tensor cores with A
//                      recomputed (never stored): the q pass -> the row
//                      statistics and dq; the kv pass -> dk, dv and the
//                      rule-6 fold sum_q r_q relu(A o dA) per head; e_row
//                      sums the heads in a fixed order. No atomics: the
//                      result is the same on every run.
//
// What bounds them on this card: the branches do 1.05 / 1.86 / 2.79 / 1.92
// GFLOP per image and layer (attention fwd / MLP fwd / MLP bwd / attention
// bwd) against a few MB of traffic, so they are bound by operations, not
// by bytes. The GEMM is where the time goes; it runs on the tensor cores
// as 3xTF32 (three TF32 products of split operands per product, fp32
// accuracy: mma_tf32.cuh), whose bound is the TF32 peak (495 TFLOP/s) over
// three, against 67 TFLOP/s for fp32 on the CUDA cores. Its design is in
// common.cuh. The attention forward and backward run on the tensor cores
// the same way (below); the LayerNorm rows are fp32 CUDA-core code. All of
// it is held to the fp32 CPU reference, and the GEMM and the attention to
// float64 on the card.
//
// The attention forward (attn_fwd_kernel) replaces the attention of
// attn_block_pallas.py _fwd_kernel (:81-103) and flash_attention.py
// _fwd_kernel (:79) and _fwd_kernel2 (:187). It does 4*S*S*dh flops per
// (image, head) against 16*S*dh bytes, so it is bound by operations; at
// fp32 on the CUDA cores that bound is 14 us at ViT-B/16, B=8. It runs both
// products on the tensor cores instead, as 3xTF32 mma.sync (mma_tf32.cuh:
// three TF32 products of split operands per product, fp32 accuracy), which
// moves its bound to the TF32 peak (495 TFLOP/s over 3). The design:
//   - one block of 4 warps per (64-query tile, head, image); each warp owns
//     16 query rows (one m16 fragment row block) and walks every key tile
//     in a fixed order, so an output row is written by one warp with no
//     atomics and no split across blocks: the same bits on every run and
//     for every layout of the same values;
//   - Q is loaded once into shared memory; K and V stream through a
//     two-stage cp.async ring of 32-key tiles, the next tile in flight
//     while the current one is multiplied; rows padded to dh8 + 4 floats
//     (dh8: dh rounded up to 8, zero-filled, exact for both products) so
//     that every fragment load is free of bank conflicts. 16-byte copies
//     where every operand's base, strides and dh allow them, else 4-byte
//     copies (a template flag the wrapper picks);
//   - online softmax in registers (scores in the log2 domain, running row
//     max and sum, the O accumulator rescaled per tile, one division at the
//     end); keys at or past S are -inf before the row max;
//   - P feeds the P*V product straight from the score accumulators, the
//     product's k index taken in the paired order of mma_tf32.cuh.
// Its shared memory is fixed by dh (52 KB at dh=64), so S is not bounded.
//
// The attention backward replaces the attention part of attn_block_pallas.py
// _bwd_kernel (:106-145) and flash_attention.py _bwd_kernel (:91) and
// _bwd_kernel2 (:213-254): dq, dk, dv of A = softmax(q k^T / sqrt(dh)) and
// the fold e_row = r . mean_h relu(A o dA), dA = dout v^T. The function is
// 5 S*S*dh products (q k^T, dout v^T, ds k, ds^T q, A^T dout), bound by
// operations like the forward. Two passes of the forward's shape share its
// tiles, ring and fragment path, all products 3xTF32 mma.sync:
//   - the q pass, one block per (64-query tile, head, image), sweeps the
//     32-key tiles twice: first s = q k^T and dA = dout v^T for the online
//     row max m, sum l and u = sum 2^(s - m) dA (log2 domain, rescaled
//     together), so dsum = u / l = sum_j A_j dA_j; then s and dA again,
//     ds = A (dA - dsum) scale in registers and dq += ds k. It saves
//     (m, 1/l, dsum) per query row;
//   - the kv pass, one block per (64-key tile, head, image), holds K and V
//     and streams 32-query tiles of q, dout and their (m, 1/l, dsum, r):
//     s^T = k q^T, dA^T = v dout^T, A^T = 2^(s^T - m) / l, the fold
//     sum_q r_q relu(A^T dA^T) in registers, then dv += A^T dout and
//     dk += ds^T q. Queries at or past S get 1/l = 0 and r = 0, keys at or
//     past S are never written;
//   - the dq / dk / dv sums over S go into a fresh accumulator per 32-row
//     tile, added in fp32 (one accumulator over a long k drifts from
//     float64: common.cuh); e_row_kernel sums the heads in a fixed order.
// That is 9 products where the function needs 5 (the q pass recomputes s
// and dA, the kv pass both again), the price of writing each output row
// from one warp without atomics. Shared memory is fixed by dh (69 KB at
// dh=64), so S is not bounded either.
//
// bf16 storage with fp32 products (the JAX kernels upcast bf16 tensors
// on load and multiply in fp32 where fast_dots is off): every kernel above
// reads bf16 x, weights, biases, LayerNorm parameters and cotangents (and
// q, k, v, dout for the flash wrappers) and writes bf16 x_mid, x_out,
// cot_mid, cot_x (out, dq, dk, dv); the intermediates of the block branches
// (LayerNorm outputs, qkv, the merged attention output, a1, dqkv) stay fp32,
// as the JAX bodies keep them, and so do the statistics and e_row. A bf16
// value is exact in TF32, so the lo part of its 3xTF32 split is 0 and the
// zero products are kept: the same fragments in the same order give, bit
// for bit, the fp32 kernels' result on the widened tensors, rounded once.
// The LayerNorm rows take the storage as a template; the GEMM and the
// attention stage a bf16 tile through registers into their fp32 tiles
// (common.cuh). Their bf16 instances are compiled in attn_block_s16.cu (the
// attention, T = bf16) and gemm_s16.cu (the GEMM, gemm<true>), the second
// and third objects of this library, so that the three build in parallel;
// the attention kernels' templates live in attn_fp32.cuh.
//
// Memory: the MLP wrappers materialise the [B*S, I] hidden activations in
// device memory (77 MB fp32 at B=32, I=3072), where the Pallas kernels kept
// [S, I/chunks] tiles in VMEM. The attention probabilities are never stored:
// each pass recomputes them from q and k.

#include "attn_common.cuh"
#include "attn_fp32.cuh"
#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

// ---------------------------------------------------------------------------
// LayerNorm
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 256;  // 8 rows (one per warp) per block

// y = (x - mean) / sigma * gamma + beta in fp32 (the JAX body multiplies h1
// unrounded); x, gamma, beta stored as T (fp32 or bf16).
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
              const T* __restrict__ beta, float* __restrict__ y,
              float* __restrict__ mean, float* __restrict__ rstd, int M, int D,
              float eps) {
  const int row = blockIdx.x * (kRowThreads / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= M) return;
  const T* xr = x + (size_t)row * D;
  float s = 0.f;
  for (int j = lane; j < D; j += kWarp) s += f32_of(xr[j]);
  const float mu = warp_sum(s) / D;
  float v = 0.f;
  for (int j = lane; j < D; j += kWarp) {
    const float c = f32_of(xr[j]) - mu;
    v = fmaf(c, c, v);
  }
  const float rs = 1.0f / sqrtf(warp_sum(v) / D + eps);
  float* yr = y + (size_t)row * D;
  for (int j = lane; j < D; j += kWarp)
    yr[j] = (f32_of(xr[j]) - mu) * rs * f32_of(gamma[j]) + f32_of(beta[j]);
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

// out = cot + rstd * (g - mean(g) - xh * mean(g * xh)),  g = dy * gamma;
// dy fp32, x, gamma, cot and out stored as T (out rounded once).
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
ln_vjp_kernel(const float* __restrict__ dy, const T* __restrict__ x,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              const T* __restrict__ gamma, const T* __restrict__ cot,
              T* __restrict__ out, int M, int D) {
  const int row = blockIdx.x * (kRowThreads / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= M) return;
  const size_t base = (size_t)row * D;
  const float mu = mean[row], rs = rstd[row];
  float sg = 0.f, sgx = 0.f;
  for (int j = lane; j < D; j += kWarp) {
    const float g = dy[base + j] * f32_of(gamma[j]);
    sg += g;
    sgx = fmaf(g, (f32_of(x[base + j]) - mu) * rs, sgx);
  }
  const float gm = warp_sum(sg) / D;
  const float gx = warp_sum(sgx) / D;
  for (int j = lane; j < D; j += kWarp) {
    const float g = dy[base + j] * f32_of(gamma[j]);
    const float xh = (f32_of(x[base + j]) - mu) * rs;
    put_f32(out + base + j, f32_of(cot[base + j]) + rs * (g - gm - xh * gx));
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes). Every entry point launches on the given
// stream, never synchronises, and returns cudaGetLastError().
// ---------------------------------------------------------------------------

// The bf16-storage halves of tmx_gemm (gemm_s16.cu), tmx_attn_fwd and
// tmx_attn_bwd (attn_block_s16.cu): the same arguments, strides as below.
extern "C" int tmx_gemm_s16(const void* A, const void* B, void* C, int M, int N, int K,
                            int trans_b, const void* bias, const void* res, const float* aux,
                            int act, int dtypes, int batch, long long bsA, long long bsB,
                            long long bsC, int copy_bytes, void* stream);
extern "C" int tmx_attn_fwd_s16(const void* q, const void* k, const void* v, void* out,
                                const long long* strides, int B, int S, int H, int dh,
                                float scale, int copy_bytes, void* stream);
extern "C" int tmx_attn_bwd_s16(const void* q, const void* k, const void* v, const void* dout,
                                const float* r, void* dq, void* dk, void* dv, float* stats,
                                float* e_part, float* e_row, const long long* strides, int B,
                                int S, int H, int dh, float scale, int copy_bytes,
                                void* stream);

extern "C" {

const char* tmx_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int tmx_max_dh() { return kMaxDh; }

// x, gamma, beta: fp32, or bf16 where is_bf16; y [M, D], mean, rstd [M]: fp32.
int tmx_layer_norm(const void* x, const void* gamma, const void* beta, float* y,
                   float* mean, float* rstd, int M, int D, float eps, int is_bf16,
                   void* stream) {
  const int rows = kRowThreads / kWarp;
  const dim3 grid((M + rows - 1) / rows);
  if (is_bf16)
    ln_fwd_kernel<bf16><<<grid, kRowThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(gamma),
        static_cast<const bf16*>(beta), y, mean, rstd, M, D, eps);
  else
    ln_fwd_kernel<float><<<grid, kRowThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), y, mean, rstd, M, D, eps);
  return (int)cudaGetLastError();
}

// dy, mean, rstd fp32; x, gamma, cot and out fp32, or bf16 where is_bf16.
int tmx_layer_norm_vjp(const float* dy, const void* x, const float* mean,
                       const float* rstd, const void* gamma, const void* cot,
                       void* out, int M, int D, int is_bf16, void* stream) {
  const int rows = kRowThreads / kWarp;
  const dim3 grid((M + rows - 1) / rows);
  if (is_bf16)
    ln_vjp_kernel<bf16><<<grid, kRowThreads, 0, (cudaStream_t)stream>>>(
        dy, static_cast<const bf16*>(x), mean, rstd, static_cast<const bf16*>(gamma),
        static_cast<const bf16*>(cot), static_cast<bf16*>(out), M, D);
  else
    ln_vjp_kernel<float><<<grid, kRowThreads, 0, (cudaStream_t)stream>>>(
        dy, static_cast<const float*>(x), mean, rstd, static_cast<const float*>(gamma),
        static_cast<const float*>(cot), static_cast<float*>(out), M, D);
  return (int)cudaGetLastError();
}

// C = epilogue(A op(B)) for `batch` products (common.cuh): A [M, K], B
// [K, N] or, with trans_b, [N, K]; bias [N] or null; res, aux [M, N] or
// null (aux may be C); act: an Act. dtypes: the Bf16Operand bits of the bf16
// tensors among A, B, C, bias and res (aux is fp32); 0 runs the fp32-only
// instances here, anything else the bf16-storage ones (tmx_gemm_s16). bsA,
// bsB, bsC: element batch strides. copy_bytes: 16 (every row of A and B
// 16-byte aligned; refused otherwise) or 4, the width of the kernel's copies.
int tmx_gemm(const void* A, const void* B, void* C, int M, int N, int K, int trans_b,
             const void* bias, const void* res, const float* aux, int act, int dtypes,
             int batch, long long bsA, long long bsB, long long bsC, int copy_bytes,
             void* stream) {
  if (dtypes != 0)
    return tmx_gemm_s16(A, B, C, M, N, K, trans_b, bias, res, aux, act, dtypes, batch, bsA,
                        bsB, bsC, copy_bytes, stream);
  const GemmArgs p = {A, B, C, bias, res, aux, bsA, bsB, bsC, M, N, K, act, 0, false};
  return (int)gemm(p, trans_b != 0, batch, copy_bytes, (cudaStream_t)stream);
}

// Warps per 64 x 64 block that tmx_gemm takes for this output (4 or 8).
int tmx_gemm_warps(int M, int N, int batch) { return gemm_warps(M, N, batch); }

// Bytes of dynamic shared memory one attention block needs (the forward's,
// or the larger of the two backward passes'; both fixed by dh: S does not
// change them), and the most the device lets one block opt in to. The
// wrappers compare the two before launch.
int tmx_attn_smem(int S, int dh, int backward) {
  (void)S;
  return (int)(backward ? bwd_smem(dh) : fwd_smem(dh));
}

int tmx_smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

// q, k, v, out: [B, H, S, dh] operands, fp32, or bf16 where is_bf16;
// strides: [4][3] (batch, head, row) element strides of q, k, v, out in
// that order. copy_bytes: 16 (every row of q, k and v 16-byte aligned and
// dh a multiple of 4 fp32 or 8 bf16 elements; refused otherwise) or 4, a
// copy of one element.
int tmx_attn_fwd(const void* q, const void* k, const void* v, void* out,
                 const long long* strides, int B, int S, int H, int dh, float scale,
                 int is_bf16, int copy_bytes, void* stream) {
  if (is_bf16)
    return tmx_attn_fwd_s16(q, k, v, out, strides, B, S, H, dh, scale, copy_bytes, stream);
  return (int)attn_fwd_entry<float>(q, k, v, out, strides, B, S, H, dh, scale, copy_bytes,
                                    (cudaStream_t)stream);
}

// q, k, v, dout in and dq, dk, dv out: [B, H, S, dh] operands, fp32, or
// bf16 where is_bf16; strides: [7][3] (batch, head, row) element strides of
// q, k, v, dout, dq, dk, dv in that order. r, e_row: [B, S] fp32; stats:
// scratch [3, B, H, S]; e_part: scratch [B, H, S]. copy_bytes: as
// tmx_attn_fwd's, over q, k, v and dout.
int tmx_attn_bwd(const void* q, const void* k, const void* v, const void* dout,
                 const float* r, void* dq, void* dk, void* dv, float* stats,
                 float* e_part, float* e_row, const long long* strides, int B, int S,
                 int H, int dh, float scale, int is_bf16, int copy_bytes, void* stream) {
  if (is_bf16)
    return tmx_attn_bwd_s16(q, k, v, dout, r, dq, dk, dv, stats, e_part, e_row, strides, B,
                            S, H, dh, scale, copy_bytes, stream);
  return (int)attn_bwd_entry<float>(q, k, v, dout, r, dq, dk, dv, stats, e_part, e_row,
                                    strides, B, S, H, dh, scale, copy_bytes,
                                    (cudaStream_t)stream);
}

}  // extern "C"
