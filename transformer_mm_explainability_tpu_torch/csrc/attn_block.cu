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
// Memory: the MLP wrappers materialise the [B*S, I] hidden activations in
// device memory (77 MB fp32 at B=32, I=3072), where the Pallas kernels kept
// [S, I/chunks] tiles in VMEM. The attention probabilities are never stored:
// each pass recomputes them from q and k.

#include "attn_common.cuh"
#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

// ---------------------------------------------------------------------------
// LayerNorm
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 256;  // 8 rows (one per warp) per block

__global__ void __launch_bounds__(kRowThreads)
ln_fwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, float* __restrict__ y,
              float* __restrict__ mean, float* __restrict__ rstd, int M, int D,
              float eps) {
  const int row = blockIdx.x * (kRowThreads / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= M) return;
  const float* xr = x + (size_t)row * D;
  float s = 0.f;
  for (int j = lane; j < D; j += kWarp) s += xr[j];
  const float mu = warp_sum(s) / D;
  float v = 0.f;
  for (int j = lane; j < D; j += kWarp) {
    const float c = xr[j] - mu;
    v = fmaf(c, c, v);
  }
  const float rs = 1.0f / sqrtf(warp_sum(v) / D + eps);
  float* yr = y + (size_t)row * D;
  for (int j = lane; j < D; j += kWarp) yr[j] = (xr[j] - mu) * rs * gamma[j] + beta[j];
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

// out = cot + rstd * (g - mean(g) - xh * mean(g * xh)),  g = dy * gamma.
__global__ void __launch_bounds__(kRowThreads)
ln_vjp_kernel(const float* __restrict__ dy, const float* __restrict__ x,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              const float* __restrict__ gamma, const float* __restrict__ cot,
              float* __restrict__ out, int M, int D) {
  const int row = blockIdx.x * (kRowThreads / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= M) return;
  const size_t base = (size_t)row * D;
  const float mu = mean[row], rs = rstd[row];
  float sg = 0.f, sgx = 0.f;
  for (int j = lane; j < D; j += kWarp) {
    const float g = dy[base + j] * gamma[j];
    sg += g;
    sgx = fmaf(g, (x[base + j] - mu) * rs, sgx);
  }
  const float gm = warp_sum(sg) / D;
  const float gx = warp_sum(sgx) / D;
  for (int j = lane; j < D; j += kWarp) {
    const float g = dy[base + j] * gamma[j];
    const float xh = (x[base + j] - mu) * rs;
    out[base + j] = cot[base + j] + rs * (g - gm - xh * gx);
  }
}

// ---------------------------------------------------------------------------
// Attention. Every [B, H, S, dh] operand is a base pointer plus its (batch,
// head, row) strides in elements; the dh axis has stride 1. Merged qkv
// [B, S, 3D]: q at +0, k at +D, v at +2D, strides (S*3D, dh, 3D); merged
// [B, S, D]: (S*D, dh, D); per-head [B, H, S, dh]: (H*S*dh, S*dh, dh).
// ---------------------------------------------------------------------------

constexpr int kMaxDh = 128;

// Both directions: 4 warps of 16 rows (query rows, or keys in the kv pass
// of the backward) per block; the other operand streams through a
// two-stage cp.async ring of 32-row tiles.
constexpr int kAttThreads = 128;
constexpr int kAttRows = 64;   // rows per block
constexpr int kAttTile = 32;   // rows per streamed tile
constexpr int kAttStages = 2;

// Copies rows [row0, row0 + ROWS) of one head (row stride `stride`, dh
// values each) into a [ROWS][DP + 4] tile with cp.async; rows at or past S
// and columns at or past dh become 0. VEC: 16-byte copies (dh % 4 == 0 and
// 16-byte aligned rows, checked before launch), else 4-byte copies.
template <int DP, int ROWS, bool VEC>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int S,
                                          int stride, int dh) {
  constexpr int LD = DP + 4;
  constexpr int W = VEC ? 4 : 1;  // floats per copy
  constexpr int PER_ROW = DP / W;
  for (int e = threadIdx.x; e < ROWS * PER_ROW; e += kAttThreads) {
    const int r = e / PER_ROW, d = (e % PER_ROW) * W;
    float* to = dst + r * LD + d;
    const bool ok = row0 + r < S && d < dh;
    const float* from = src + (long long)(row0 + r) * stride + d;
    if constexpr (VEC) {
      if (ok)
        cp_async16(to, from);
      else
        *reinterpret_cast<float4*>(to) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      if (ok)
        cp_async4(to, from);
      else
        *to = 0.f;
    }
  }
}

// One key tile for one warp: s = q k^T (3xTF32), the online-softmax update
// of (m, l) and o, then o += p v with the score accumulators as the A
// operand, keys paired. Per lane: rows g and g + 8 of the warp's 16
// (index 0 and 1 of m and l).
template <int DP>
__device__ __forceinline__ void fwd_tile(const float* Qw, const float* Kt,
                                         const float* Vt, int lane, int k0, int S,
                                         float scale_log2, float (&o)[DP / 8][4],
                                         float (&m)[2], float (&l)[2]) {
  constexpr int LD = DP + 4, NT = DP / 8, KT = kAttTile / 8;
  const int t = lane & 3;
  float s[KT][4];
#pragma unroll
  for (int n = 0; n < KT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    uint32_t a_hi[4], a_lo[4];
    load_a_3x(Qw + kk * 8, LD, lane, a_hi, a_lo);
#pragma unroll
    for (int n = 0; n < KT; ++n) {
      uint32_t b_hi[2], b_lo[2];
      load_bt_3x(Kt + n * 8 * LD + kk * 8, LD, lane, b_hi, b_lo);
      mma_3xtf32(s[n], a_hi, a_lo, b_hi, b_lo);
    }
  }

  // online softmax: scale into the log2 domain, mask keys >= S, new max
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < KT; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = k0 + n * 8 + 2 * t + e < S;
      s[n][e] = ok ? s[n][e] * scale_log2 : -INFINITY;
      s[n][2 + e] = ok ? s[n][2 + e] * scale_log2 : -INFINITY;
      mx[0] = fmaxf(mx[0], s[n][e]);
      mx[1] = fmaxf(mx[1], s[n][2 + e]);
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the 4 lanes of a group share a row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2f(m[r] - mx[r]);  // 0 on the first tile
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int n = 0; n < KT; ++n) {
    s[n][0] = exp2f(s[n][0] - m[0]);
    s[n][1] = exp2f(s[n][1] - m[0]);
    s[n][2] = exp2f(s[n][2] - m[1]);
    s[n][3] = exp2f(s[n][3] - m[1]);
    l[0] += s[n][0] + s[n][1];
    l[1] += s[n][2] + s[n][3];
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }

  // o += p v: the score accumulators are the A operand, keys paired
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    uint32_t a_hi[4], a_lo[4];
    a_from_acc_3x(s[j], a_hi, a_lo);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t b_hi[2], b_lo[2];
      load_b_paired_3x(Vt + j * 8 * LD + n * 8, LD, lane, b_hi, b_lo);
      mma_3xtf32(o[n], a_hi, a_lo, b_hi, b_lo);
    }
  }
}

// out = softmax(q k^T * scale) v for one (64-query tile, head, image);
// scale_log2 = scale * log2(e). DP: dh rounded up to a multiple of 8.
template <int DP, bool VEC>
__global__ void __launch_bounds__(kAttThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out, Strides sq,
                Strides sk, Strides sv, Strides so, int S, int dh, float scale_log2) {
  constexpr int LD = DP + 4;  // ld % 8 == 4: conflict-free fragment loads
  constexpr int NT = DP / 8;  // 8-wide steps along dh
  extern __shared__ __align__(16) float fwd_sm[];
  float* Qs = fwd_sm;                            // [kAttRows][LD]
  float* Ks = Qs + kAttRows * LD;                // [kAttStages][kAttTile][LD]
  float* Vs = Ks + kAttStages * kAttTile * LD;   // [kAttStages][kAttTile][LD]
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kAttRows;
  q += head_at(sq, b, h);
  k += head_at(sk, b, h);
  v += head_at(sv, b, h);
  out += head_at(so, b, h);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int ntiles = (S + kAttTile - 1) / kAttTile;

  load_rows<DP, kAttRows, VEC>(Qs, q, q0, S, sq.s, dh);
  load_rows<DP, kAttTile, VEC>(Ks, k, 0, S, sk.s, dh);
  load_rows<DP, kAttTile, VEC>(Vs, v, 0, S, sv.s, dh);
  cp_async_commit();

  // Per lane: rows g and g + 8 of the warp's 16 (index 0 and 1 below).
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running row max (log2 domain)
  float l[2] = {0.f, 0.f};              // this lane's part of the row sum
  const float* Qw = Qs + warp * 16 * LD;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kAttTile;
    if (it + 1 < ntiles) {
      const int next = (it + 1) % kAttStages;
      load_rows<DP, kAttTile, VEC>(Ks + next * kAttTile * LD, k, k0 + kAttTile, S, sk.s, dh);
      load_rows<DP, kAttTile, VEC>(Vs + next * kAttTile * LD, v, k0 + kAttTile, S, sv.s, dh);
    }
    cp_async_commit();    // empty on the last tile: one group per iteration
    cp_async_wait<1>();   // everything but the newest group: this tile
    __syncthreads();
    const float* Kt = Ks + (it % kAttStages) * kAttTile * LD;
    const float* Vt = Vs + (it % kAttStages) * kAttTile * LD;
    fwd_tile<DP>(Qw, Kt, Vt, lane, k0, S, scale_log2, o, m, l);
    __syncthreads();  // the next iteration refills the stage just read
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.0f / l[r];
  }
  const int row = q0 + warp * 16 + g;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = n * 8 + 2 * t + e;
      if (d >= dh) continue;
      if (row < S) out[(long long)row * so.s + d] = o[n][e] * inv[0];
      if (row + 8 < S) out[(long long)(row + 8) * so.s + d] = o[n][2 + e] * inv[1];
    }
  }
}

// The backward's products take the GEMM's operand path (mma_tf32.cuh):
// fragments through ldmatrix where the tile is row-major, every operand
// split with split_tf32_fast. On an H100 that took a tenth off the
// backward's time against the forward's scalar loads and rounded split, at
// the same distance from float64.
//
// acc[n] += A B^T for one warp (3xTF32): A the warp's 16 rows of a [.][LD]
// tile, B the 8 * N rows of another, both DP wide: s = q k^T, dA = dout v^T
// and, in the kv pass, their transposes.
template <int DP, int N>
__device__ __forceinline__ void mma_rows_bt(const float* Aw, const float* Bt, int lane,
                                            float (&acc)[N][4]) {
  constexpr int LD = DP + 4;
  static_assert(N % 2 == 0, "B fragments come in pairs");
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    uint32_t a_hi[4], a_lo[4];
    load_a_ldsm_3x(Aw + kk * 8, LD, lane, a_hi, a_lo);
#pragma unroll
    for (int n = 0; n < N; n += 2) {
      uint32_t b_hi[2][2], b_lo[2][2];
      load_bt2_ldsm_3x(Bt + n * 8 * LD + kk * 8, LD, lane, b_hi, b_lo);
      mma_3xtf32(acc[n], a_hi, a_lo, b_hi[0], b_lo[0]);
      mma_3xtf32(acc[n + 1], a_hi, a_lo, b_hi[1], b_lo[1]);
    }
  }
}

// acc += P W for one warp (3xTF32): P a 16 x kAttTile accumulator tile
// (the warp's rows; the tile's rows are the product's k, taken in the
// paired order of mma_tf32.cuh), W the tile's kAttTile rows of a [.][LD]
// tile: dq += ds k, dv += A^T dout, dk += ds^T q. The tile's product goes
// into a fresh accumulator per 8 columns and is then added in fp32: a sum
// over S in one mma accumulator drifts from float64 (common.cuh).
template <int DP>
__device__ __forceinline__ void mma_acc_rows(const float (&p)[kAttTile / 8][4],
                                             const float* W, int lane,
                                             float (&acc)[DP / 8][4]) {
  constexpr int LD = DP + 4, KT = kAttTile / 8;
  uint32_t a_hi[KT][4], a_lo[KT][4];
#pragma unroll
  for (int j = 0; j < KT; ++j) a_from_acc_fast_3x(p[j], a_hi[j], a_lo[j]);
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      uint32_t b_hi[2], b_lo[2];
      load_b_paired_fast_3x(W + j * 8 * LD + n * 8, LD, lane, b_hi, b_lo);
      mma_3xtf32(c, a_hi[j], a_lo[j], b_hi, b_lo);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += c[e];
  }
}

// Writes a warp's [16][DP] accumulator rows to rows row0 .. row0 + 15 of
// one head (rows at or past S and columns at or past dh are skipped).
template <int DP>
__device__ __forceinline__ void store_rows(float* out, int stride, const float (&acc)[DP / 8][4],
                                           int row0, int lane, int S, int dh) {
  const int row = row0 + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = n * 8 + 2 * t + e;
      if (d >= dh) continue;
      if (row < S) out[(long long)row * stride + d] = acc[n][e];
      if (row + 8 < S) out[(long long)(row + 8) * stride + d] = acc[n][2 + e];
    }
  }
}

// Register targets, from ptxas and event times on an H100: the q pass
// declares 3 blocks per SM where its shared memory allows 3 (DP <= 64),
// at most 170 registers, without which ptxas spilled at DP = 48. The kv
// pass declares 2 (at most 255; 214 at DP = 64): at 170 its dk and dv
// accumulators spilled from DP = 48 to 64, and with the forward's loaders
// instead it was no faster at B = 8 and slower on small grids.
//
// The q pass: one block per (64-query tile, head, image), each warp 16
// query rows, two sweeps over the 32-key tiles with one cp.async ring
// running on from the first sweep into the second (tile it % ntiles).
// Sweep 1: s = q k^T and dA = dout v^T; the online row max m, sum l and
// u = sum_j 2^(s_j - m) dA_j in the log2 domain, all three rescaled by the
// same alpha; dsum = u / l = sum_j A_j dA_j. Sweep 2: s and dA again,
// ds = A (dA - dsum) scale, dq += ds k. Writes dq and stats[0..2] =
// (m, 1/l, dsum) per row (planes of B * H * S).
template <int DP, bool VEC>
__global__ void __launch_bounds__(kAttThreads, DP <= 64 ? 3 : 1)
attn_bwd_q_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  float* __restrict__ dq, float* __restrict__ stats, Strides sq, Strides sk,
                  Strides sv, Strides sdo, Strides sdq, int B, int S, int H, int dh,
                  float scale_log2, float scale) {
  constexpr int LD = DP + 4, NT = DP / 8, KT = kAttTile / 8;
  extern __shared__ __align__(16) float bwd_sm[];
  float* Qs = bwd_sm;                            // [kAttRows][LD]
  float* Os = Qs + kAttRows * LD;                // [kAttRows][LD]  dout rows
  float* Ks = Os + kAttRows * LD;                // [kAttStages][kAttTile][LD]
  float* Vs = Ks + kAttStages * kAttTile * LD;   // [kAttStages][kAttTile][LD]
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kAttRows;
  q += head_at(sq, b, h);
  k += head_at(sk, b, h);
  v += head_at(sv, b, h);
  dout += head_at(sdo, b, h);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int t = lane & 3;
  const int ntiles = (S + kAttTile - 1) / kAttTile;

  load_rows<DP, kAttRows, VEC>(Qs, q, q0, S, sq.s, dh);
  load_rows<DP, kAttRows, VEC>(Os, dout, q0, S, sdo.s, dh);
  load_rows<DP, kAttTile, VEC>(Ks, k, 0, S, sk.s, dh);
  load_rows<DP, kAttTile, VEC>(Vs, v, 0, S, sv.s, dh);
  cp_async_commit();

  // Per lane: rows g and g + 8 of the warp's 16 (index 0 and 1 below).
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running row max (log2 domain)
  float l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};  // this lane's parts of l, u
  float inv[2], dsum[2];
  const float* Qw = Qs + warp * 16 * LD;
  const float* Ow = Os + warp * 16 * LD;

  for (int it = 0; it < 2 * ntiles; ++it) {
    if (it + 1 < 2 * ntiles) {
      const int next = (it + 1) % ntiles * kAttTile, st = (it + 1) % kAttStages;
      load_rows<DP, kAttTile, VEC>(Ks + st * kAttTile * LD, k, next, S, sk.s, dh);
      load_rows<DP, kAttTile, VEC>(Vs + st * kAttTile * LD, v, next, S, sv.s, dh);
    }
    cp_async_commit();    // empty on the last step: one group per step
    cp_async_wait<1>();   // everything but the newest group: this tile
    __syncthreads();
    const float* Kt = Ks + (it % kAttStages) * kAttTile * LD;
    const float* Vt = Vs + (it % kAttStages) * kAttTile * LD;
    const int k0 = (it % ntiles) * kAttTile;
    float s[KT][4], g[KT][4];
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = g[n][e] = 0.f;
    mma_rows_bt<DP>(Qw, Kt, lane, s);
    mma_rows_bt<DP>(Ow, Vt, lane, g);
    // the log2 domain; keys at or past S are -inf (A = 0 there)
#pragma unroll
    for (int n = 0; n < KT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = k0 + n * 8 + 2 * t + e < S;
        s[n][e] = ok ? s[n][e] * scale_log2 : -INFINITY;
        s[n][2 + e] = ok ? s[n][2 + e] * scale_log2 : -INFINITY;
      }
    }
    if (it < ntiles) {  // sweep 1: the online statistics
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < KT; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // the 4 lanes of a group share a row
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float alpha = exp2f(m[r] - mx[r]);  // 0 on the first tile
        m[r] = mx[r];
        l[r] *= alpha;
        u[r] *= alpha;
      }
#pragma unroll
      for (int n = 0; n < KT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[n][e] - m[e >> 1]);
          l[e >> 1] += p;
          u[e >> 1] = fmaf(p, g[n][e], u[e >> 1]);
        }
      }
      if (it == ntiles - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
          u[r] += __shfl_xor_sync(0xffffffffu, u[r], 1);
          u[r] += __shfl_xor_sync(0xffffffffu, u[r], 2);
          inv[r] = 1.0f / l[r];
          dsum[r] = u[r] * inv[r];
        }
      }
    } else {  // sweep 2: ds = A (dA - dsum) scale, then dq += ds k
#pragma unroll
      for (int n = 0; n < KT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float a = exp2f(s[n][e] - m[e >> 1]) * inv[e >> 1];
          g[n][e] = a * (g[n][e] - dsum[e >> 1]) * scale;
        }
      }
      mma_acc_rows<DP>(g, Kt, lane, acc);
    }
    __syncthreads();  // the next step refills the stage just read
  }

  const int row = q0 + warp * 16 + (lane >> 2);
  // output offsets only now: no register holds them through the sweeps
  store_rows<DP>(dq + head_at(sdq, b, h), sdq.s, acc, q0 + warp * 16, lane, S, dh);
  if (t == 0) {
    const size_t plane = (size_t)B * H * S, base = ((size_t)b * H + h) * S;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row + 8 * r;
      if (i >= S) continue;
      stats[base + i] = m[r];
      stats[plane + base + i] = inv[r];
      stats[2 * plane + base + i] = dsum[r];
    }
  }
}

// Copies the statistics of queries [q0, q0 + kAttTile) into a [4][kAttTile]
// tile: m, 1/l, dsum (the q pass's stats at st, planes `plane` apart) and r
// (at rb). Queries at or past S get 1/l = 0 and r = 0 (m = dsum = 0): A is
// 0 there and nothing of theirs reaches dk, dv or the fold.
__device__ __forceinline__ void load_stats(float* dst, const float* st, const float* rb,
                                           int q0, int S, size_t plane) {
  const int which = threadIdx.x / kAttTile, i = threadIdx.x % kAttTile;
  static_assert(kAttThreads == 4 * kAttTile, "one value per thread");
  if (q0 + i < S)
    cp_async4(dst + threadIdx.x, which < 3 ? st + which * plane + q0 + i : rb + q0 + i);
  else
    dst[threadIdx.x] = 0.f;
}

// The kv pass: one block per (64-key tile, head, image), each warp 16 keys;
// K and V rows stay in shared memory while 32-query tiles of q, dout and
// their statistics stream through the ring. Per tile: s^T = k q^T,
// dA^T = v dout^T, A^T = 2^(s^T - m) / l with the q pass's m and 1/l,
// the fold e += r_q relu(A^T dA^T) in registers, ds^T = A^T (dA^T - dsum)
// scale, then dv += A^T dout and dk += ds^T q. Writes dk, dv and
// e_part[b, h, key] = sum_q r_q relu(A dA) for keys below S. Past DP = 80
// the dk and dv accumulators and the products' fragments do not fit in 255
// registers together (ptxas spilled at DP = 120 and used all 255 from 96):
// there the pass sweeps the query tiles twice, dv alone first (s and A
// only), then dk and the fold, one accumulator live at a time.
template <int DP, bool VEC>
__global__ void __launch_bounds__(kAttThreads, 2)
attn_bwd_kv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ rvec, const float* __restrict__ stats,
                   float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ e_part,
                   Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                   int B, int S, int H, int dh, float scale_log2, float scale) {
  constexpr int LD = DP + 4, NT = DP / 8, KT = kAttTile / 8;
  constexpr bool TWO = DP > 80;  // two sweeps over the query tiles (above)
  extern __shared__ __align__(16) float bwd_sm[];
  float* Ks = bwd_sm;                            // [kAttRows][LD]
  float* Vs = Ks + kAttRows * LD;                // [kAttRows][LD]
  float* Qs = Vs + kAttRows * LD;                // [kAttStages][kAttTile][LD]
  float* Os = Qs + kAttStages * kAttTile * LD;   // [kAttStages][kAttTile][LD]
  float* Ts = Os + kAttStages * kAttTile * LD;   // [kAttStages][4][kAttTile]
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kAttRows;
  q += head_at(sq, b, h);
  k += head_at(sk, b, h);
  v += head_at(sv, b, h);
  dout += head_at(sdo, b, h);
  const size_t plane = (size_t)B * H * S, base = ((size_t)b * H + h) * S;
  const float* st = stats + base;
  const float* rb = rvec + (size_t)b * S;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int t = lane & 3;
  const int ntiles = (S + kAttTile - 1) / kAttTile;

  load_rows<DP, kAttRows, VEC>(Ks, k, k0, S, sk.s, dh);
  load_rows<DP, kAttRows, VEC>(Vs, v, k0, S, sv.s, dh);
  load_rows<DP, kAttTile, VEC>(Qs, q, 0, S, sq.s, dh);
  load_rows<DP, kAttTile, VEC>(Os, dout, 0, S, sdo.s, dh);
  load_stats(Ts, st, rb, 0, S, plane);
  cp_async_commit();

  // Per lane: keys g and g + 8 of the warp's 16 (index 0 and 1 below).
  // ak: dk, or dv in the first of two sweeps; av: dv (one sweep only).
  float ak[NT][4], av[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[n][e] = av[n][e] = 0.f;
  float fold[2] = {0.f, 0.f};  // this lane's part of sum_q r_q relu(A dA)
  const int key = k0 + warp * 16 + (lane >> 2);
  const bool key_ok[2] = {key < S, key + 8 < S};
  const float* Kw = Ks + warp * 16 * LD;
  const float* Vw = Vs + warp * 16 * LD;

  const int steps = (TWO ? 2 : 1) * ntiles;
  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) {
      const int next = (it + 1) % ntiles * kAttTile, sg = (it + 1) % kAttStages;
      load_rows<DP, kAttTile, VEC>(Qs + sg * kAttTile * LD, q, next, S, sq.s, dh);
      load_rows<DP, kAttTile, VEC>(Os + sg * kAttTile * LD, dout, next, S, sdo.s, dh);
      load_stats(Ts + sg * 4 * kAttTile, st, rb, next, S, plane);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Qt = Qs + (it % kAttStages) * kAttTile * LD;
    const float* Ot = Os + (it % kAttStages) * kAttTile * LD;
    const float* T = Ts + (it % kAttStages) * 4 * kAttTile;
    const bool dv_only = TWO && it < ntiles;
    float s[KT][4], g[KT][4];
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = g[n][e] = 0.f;
    mma_rows_bt<DP>(Kw, Qt, lane, s);
    if (!dv_only) mma_rows_bt<DP>(Vw, Ot, lane, g);
#pragma unroll
    for (int n = 0; n < KT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // query column n * 8 + 2t + (e & 1)
        const int c = n * 8 + 2 * t + (e & 1);
        const float a =
            key_ok[e >> 1] ? exp2f(s[n][e] * scale_log2 - T[c]) * T[kAttTile + c] : 0.f;
        if (!dv_only) {
          fold[e >> 1] += fmaxf(a * g[n][e], 0.f) * T[3 * kAttTile + c];
          g[n][e] = a * (g[n][e] - T[2 * kAttTile + c]) * scale;
        }
        s[n][e] = a;
      }
    }
    if constexpr (TWO) {
      if (dv_only) {
        mma_acc_rows<DP>(s, Ot, lane, ak);
        if (it == ntiles - 1) {  // dv done: the registers take dk next
          store_rows<DP>(dv + head_at(sdv, b, h), sdv.s, ak, k0 + warp * 16, lane, S, dh);
#pragma unroll
          for (int n = 0; n < NT; ++n) ak[n][0] = ak[n][1] = ak[n][2] = ak[n][3] = 0.f;
        }
      } else {
        mma_acc_rows<DP>(g, Qt, lane, ak);
      }
    } else {
      mma_acc_rows<DP>(s, Ot, lane, av);
      mma_acc_rows<DP>(g, Qt, lane, ak);
    }
    __syncthreads();
  }

  store_rows<DP>(dk + head_at(sdk, b, h), sdk.s, ak, k0 + warp * 16, lane, S, dh);
  if constexpr (!TWO)
    store_rows<DP>(dv + head_at(sdv, b, h), sdv.s, av, k0 + warp * 16, lane, S, dh);
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // fixed order over the 4 lanes of a key
    fold[r] += __shfl_xor_sync(0xffffffffu, fold[r], 1);
    fold[r] += __shfl_xor_sync(0xffffffffu, fold[r], 2);
  }
  if (t == 0) {
    if (key_ok[0]) e_part[base + key] = fold[0];
    if (key_ok[1]) e_part[base + key + 8] = fold[1];
  }
}

// dh rounded up to the forward's 8-wide fragment steps.
int att_dp(int dh) { return (dh + 7) / 8 * 8; }

// The forward's Q tile and K/V rings, rows of dp + 4 floats: fixed by dh.
size_t fwd_smem(int dh) {
  return sizeof(float) * (size_t)(kAttRows + 2 * kAttStages * kAttTile) * (att_dp(dh) + 4);
}

// The backward's shared memory: two [kAttRows][LD] row blocks, two rings
// of [kAttTile][LD] tiles and, in the kv pass, a ring of [4][kAttTile]
// query statistics. Fixed by dh.
size_t bwd_smem(int dh) {
  return sizeof(float) * ((size_t)(2 * kAttRows + 2 * kAttStages * kAttTile) * (att_dp(dh) + 4) +
                          kAttStages * 4 * kAttTile);
}

struct FwdArgs {
  const float *q, *k, *v;
  float* out;
  Strides sq, sk, sv, so;
  int B, S, H, dh;
  float scale_log2;
};

// Launches attn_fwd_kernel<DP, vec> for DP = att_dp(dh), found by walking
// the 16 instantiations DP = 8, 16, ..., kMaxDh.
template <int DP>
cudaError_t launch_fwd(const FwdArgs& a, bool vec, cudaStream_t stream) {
  if constexpr (DP > kMaxDh) {
    return cudaErrorInvalidValue;
  } else {
    if (att_dp(a.dh) != DP) return launch_fwd<DP + 8>(a, vec, stream);
    auto kernel = vec ? attn_fwd_kernel<DP, true> : attn_fwd_kernel<DP, false>;
    const size_t smem = fwd_smem(a.dh);
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.S + kAttRows - 1) / kAttRows, a.H, a.B);
    kernel<<<grid, kAttThreads, smem, stream>>>(a.q, a.k, a.v, a.out, a.sq, a.sk, a.sv,
                                                 a.so, a.S, a.dh, a.scale_log2);
    return cudaGetLastError();
  }
}

// Every row of every head starts on a 16-byte boundary.
bool rows_aligned16(const float* p, const Strides& s) {
  return ((uintptr_t)p & 15) == 0 && s.b % 4 == 0 && s.h % 4 == 0 && s.s % 4 == 0;
}

struct BwdArgs {
  const float *q, *k, *v, *dout, *r;
  float *dq, *dk, *dv, *stats, *e_part, *e_row;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int B, S, H, dh;
  float scale_log2, scale;
};

// Launches the q pass, the kv pass and e_row_kernel for DP = att_dp(dh),
// found by walking the 16 instantiations DP = 8, 16, ..., kMaxDh.
template <int DP>
cudaError_t launch_bwd(const BwdArgs& a, bool vec, cudaStream_t stream) {
  if constexpr (DP > kMaxDh) {
    return cudaErrorInvalidValue;
  } else {
    if (att_dp(a.dh) != DP) return launch_bwd<DP + 8>(a, vec, stream);
    auto qk = vec ? attn_bwd_q_kernel<DP, true> : attn_bwd_q_kernel<DP, false>;
    auto kv = vec ? attn_bwd_kv_kernel<DP, true> : attn_bwd_kv_kernel<DP, false>;
    const size_t smem = bwd_smem(a.dh);
    cudaError_t err = allow_smem(qk, smem);
    if (err == cudaSuccess) err = allow_smem(kv, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.S + kAttRows - 1) / kAttRows, a.H, a.B);
    qk<<<grid, kAttThreads, smem, stream>>>(a.q, a.k, a.v, a.dout, a.dq, a.stats, a.sq, a.sk,
                                            a.sv, a.sdo, a.sdq, a.B, a.S, a.H, a.dh,
                                            a.scale_log2, a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    kv<<<grid, kAttThreads, smem, stream>>>(a.q, a.k, a.v, a.dout, a.r, a.stats, a.dk, a.dv,
                                            a.e_part, a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv,
                                            a.B, a.S, a.H, a.dh, a.scale_log2, a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    e_row_kernel<<<(a.B * a.S + 255) / 256, 256, 0, stream>>>(a.e_part, a.e_row, a.B, a.S,
                                                               a.H);
    return cudaGetLastError();
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes). Every entry point launches on the given
// stream, never synchronises, and returns cudaGetLastError().
// ---------------------------------------------------------------------------

extern "C" {

const char* tmx_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int tmx_max_dh() { return kMaxDh; }

int tmx_layer_norm(const float* x, const float* gamma, const float* beta, float* y,
                   float* mean, float* rstd, int M, int D, float eps, void* stream) {
  const int rows = kRowThreads / kWarp;
  ln_fwd_kernel<<<(M + rows - 1) / rows, kRowThreads, 0, (cudaStream_t)stream>>>(
      x, gamma, beta, y, mean, rstd, M, D, eps);
  return (int)cudaGetLastError();
}

int tmx_layer_norm_vjp(const float* dy, const float* x, const float* mean,
                       const float* rstd, const float* gamma, const float* cot,
                       float* out, int M, int D, void* stream) {
  const int rows = kRowThreads / kWarp;
  ln_vjp_kernel<<<(M + rows - 1) / rows, kRowThreads, 0, (cudaStream_t)stream>>>(
      dy, x, mean, rstd, gamma, cot, out, M, D);
  return (int)cudaGetLastError();
}

// C = epilogue(A op(B)) for `batch` products (common.cuh): A [M, K], B
// [K, N] or, with trans_b, [N, K]; bias [N] or null; res, aux [M, N] or
// null (aux may be C); act: an Act. bsA, bsB, bsC: element batch strides.
// copy_bytes: 16 (every row of A and B 16-byte aligned; refused
// otherwise) or 4, the width of the kernel's cp.async copies.
int tmx_gemm(const float* A, const float* B, float* C, int M, int N, int K,
             int trans_b, const float* bias, const float* res, const float* aux,
             int act, int batch, long long bsA, long long bsB, long long bsC,
             int copy_bytes, void* stream) {
  const GemmArgs p = {A, B, C, bias, res, aux, bsA, bsB, bsC, M, N, K, act, false};
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

// q, k, v, out: [B, H, S, dh] operands; strides: [4][3] (batch, head, row)
// element strides of q, k, v, out in that order. copy_bytes: 16 (every row
// of q, k and v 16-byte aligned and dh % 4 == 0; refused otherwise) or 4,
// the width of the kernel's cp.async copies.
int tmx_attn_fwd(const float* q, const float* k, const float* v, float* out,
                 const long long* strides, int B, int S, int H, int dh, float scale,
                 int copy_bytes, void* stream) {
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], (int)strides[3 * i + 2]};
  const bool vec = copy_bytes == 16;
  if (!vec && copy_bytes != 4) return (int)cudaErrorInvalidValue;
  if (vec && !(dh % 4 == 0 && rows_aligned16(q, st[0]) && rows_aligned16(k, st[1]) &&
               rows_aligned16(v, st[2])))
    return (int)cudaErrorMisalignedAddress;
  const FwdArgs a = {q, k, v, out, st[0], st[1], st[2], st[3],
                     B, S, H, dh, scale * 1.4426950408889634f};
  return (int)launch_fwd<8>(a, vec, (cudaStream_t)stream);
}

// q, k, v, dout in and dq, dk, dv out: [B, H, S, dh] operands; strides: [7][3]
// (batch, head, row) element strides of q, k, v, dout, dq, dk, dv in that
// order. r, e_row: [B, S]; stats: scratch [3, B, H, S]; e_part: scratch
// [B, H, S]. copy_bytes: 16 (every row of q, k, v and dout 16-byte aligned
// and dh % 4 == 0; refused otherwise) or 4, the width of the kernels'
// cp.async copies.
int tmx_attn_bwd(const float* q, const float* k, const float* v, const float* dout,
                 const float* r, float* dq, float* dk, float* dv, float* stats,
                 float* e_part, float* e_row, const long long* strides, int B, int S,
                 int H, int dh, float scale, int copy_bytes, void* stream) {
  Strides st[7];
  for (int i = 0; i < 7; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], (int)strides[3 * i + 2]};
  const bool vec = copy_bytes == 16;
  if (!vec && copy_bytes != 4) return (int)cudaErrorInvalidValue;
  if (vec && !(dh % 4 == 0 && rows_aligned16(q, st[0]) && rows_aligned16(k, st[1]) &&
               rows_aligned16(v, st[2]) && rows_aligned16(dout, st[3])))
    return (int)cudaErrorMisalignedAddress;
  const BwdArgs a = {q,     k,     v,     dout,  r,     dq,    dk, dv, stats, e_part,
                     e_row, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
                     B,     S,     H,     dh,    scale * 1.4426950408889634f, scale};
  return (int)launch_bwd<8>(a, vec, (cudaStream_t)stream);
}

}  // extern "C"
