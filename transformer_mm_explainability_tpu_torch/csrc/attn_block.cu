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
//   attn_bwd_rows_kernel / attn_bwd_cols_kernel / e_row_kernel
//                      the attention backward with A recomputed (never
//                      stored): rows pass -> ds, dq and per-row statistics;
//                      columns pass -> dk, dv and the rule-6 fold
//                      sum_q r_q relu(A o dA) per head; e_row sums the heads
//                      in a fixed order. No atomics: the result is the same
//                      on every run.
//
// What bounds them on this card: the branches do 1.05 / 1.86 / 2.79 / 1.92
// GFLOP per image and layer (attention fwd / MLP fwd / MLP bwd / attention
// bwd) against a few MB of traffic, so they are bound by operations, not
// by bytes. The GEMM is where the time goes; it runs on the tensor cores
// as 3xTF32 (three TF32 products of split operands per product, fp32
// accuracy: mma_tf32.cuh), whose bound is the TF32 peak (495 TFLOP/s) over
// three, against 67 TFLOP/s for fp32 on the CUDA cores. Its design is in
// common.cuh. The attention forward runs on the tensor cores the same way
// (below); the LayerNorm rows and the attention backward are fp32
// CUDA-core code. All of it is held to the fp32 CPU reference, and the
// GEMM and the attention forward also to float64 on the card.
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
// Memory: the MLP wrappers materialise the [B*S, I] hidden activations in
// device memory (77 MB fp32 at B=32, I=3072), where the Pallas kernels kept
// [S, I/chunks] tiles in VMEM. The attention probabilities are never stored:
// each pass recomputes them from q and k. The backward rows pass keeps two
// whole [16][S] score rows in shared memory, so S is bounded by the 227 KB
// a block may opt in to: about 1,490 at dh=64 for the backward.
// tmx_attn_smem lets the wrappers refuse a longer S before launch.

#include <limits.h>

#include "common.cuh"
#include "mma_tf32.cuh"

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

constexpr int kAttThreads = 256;
constexpr int kMaxDh = 128;
constexpr int kKeyTile = 64;   // keys per shared-memory tile (bwd rows)
constexpr int kRowQ = 16;      // queries per block (bwd rows)
constexpr int kColK = 16;      // keys per block (bwd columns)
constexpr int kColQ = 64;      // queries per tile (bwd columns)

// The forward: 4 warps of 16 query rows each; 32-key tiles in a two-stage
// cp.async ring.
constexpr int kFwdThreads = 128;
constexpr int kFwdQ = 64;      // queries per block
constexpr int kFwdK = 32;      // keys per tile
constexpr int kFwdStages = 2;

// Copies rows [row0, row0 + ROWS) of one head (row stride `stride`, dh
// values each) into a [ROWS][DP + 4] tile with cp.async; rows at or past S
// and columns at or past dh become 0. VEC: 16-byte copies (dh % 4 == 0 and
// 16-byte aligned rows, checked before launch), else 4-byte copies.
template <int DP, int ROWS, bool VEC>
__device__ __forceinline__ void fwd_load_rows(float* dst, const float* src, int row0,
                                              int S, int stride, int dh) {
  constexpr int LD = DP + 4;
  constexpr int W = VEC ? 4 : 1;  // floats per copy
  constexpr int PER_ROW = DP / W;
  for (int e = threadIdx.x; e < ROWS * PER_ROW; e += kFwdThreads) {
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
  constexpr int LD = DP + 4, NT = DP / 8, KT = kFwdK / 8;
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
__global__ void __launch_bounds__(kFwdThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out, Strides sq,
                Strides sk, Strides sv, Strides so, int S, int dh, float scale_log2) {
  constexpr int LD = DP + 4;  // ld % 8 == 4: conflict-free fragment loads
  constexpr int NT = DP / 8;  // 8-wide steps along dh
  extern __shared__ __align__(16) float fwd_sm[];
  float* Qs = fwd_sm;                          // [kFwdQ][LD]
  float* Ks = Qs + kFwdQ * LD;                 // [kFwdStages][kFwdK][LD]
  float* Vs = Ks + kFwdStages * kFwdK * LD;    // [kFwdStages][kFwdK][LD]
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kFwdQ;
  q += head_at(sq, b, h);
  k += head_at(sk, b, h);
  v += head_at(sv, b, h);
  out += head_at(so, b, h);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int ntiles = (S + kFwdK - 1) / kFwdK;

  fwd_load_rows<DP, kFwdQ, VEC>(Qs, q, q0, S, sq.s, dh);
  fwd_load_rows<DP, kFwdK, VEC>(Ks, k, 0, S, sk.s, dh);
  fwd_load_rows<DP, kFwdK, VEC>(Vs, v, 0, S, sv.s, dh);
  cp_async_commit();

  // Per lane: rows g and g + 8 of the warp's 16 (index 0 and 1 below).
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running row max (log2 domain)
  float l[2] = {0.f, 0.f};              // this lane's part of the row sum
  const float* Qw = Qs + warp * 16 * LD;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kFwdK;
    if (it + 1 < ntiles) {
      const int next = (it + 1) % kFwdStages;
      fwd_load_rows<DP, kFwdK, VEC>(Ks + next * kFwdK * LD, k, k0 + kFwdK, S, sk.s, dh);
      fwd_load_rows<DP, kFwdK, VEC>(Vs + next * kFwdK * LD, v, k0 + kFwdK, S, sv.s, dh);
    }
    cp_async_commit();    // empty on the last tile: one group per iteration
    cp_async_wait<1>();   // everything but the newest group: this tile
    __syncthreads();
    const float* Kt = Ks + (it % kFwdStages) * kFwdK * LD;
    const float* Vt = Vs + (it % kFwdStages) * kFwdK * LD;
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

// Rows pass: one block per (query tile, head, image). Holds whole rows, so
// the softmax-VJP row sum dsum_i = sum_j A_ij dA_ij is taken directly (as the
// Pallas body does); it is saved with the row max and 1/sum so that the
// columns pass recomputes A_ij = exp(s_ij - m_i) / l_i and ds_ij from q, k
// alone, without reducing any row again.
__global__ void __launch_bounds__(kAttThreads)
attn_bwd_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     float* __restrict__ dq, float* __restrict__ stats, Strides sq,
                     Strides sk, Strides sv, Strides sdo, Strides sdq, int B, int S,
                     int H, int dh, float scale) {
  extern __shared__ float sm[];
  const int dp = dh + 1;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRowQ;
  const int nq = min(kRowQ, S - q0);
  float* Qs = sm;                   // [kRowQ][dh]
  float* Os = Qs + kRowQ * dh;      // [kRowQ][dh]   dout rows
  float* Ks = Os + kRowQ * dh;      // [kKeyTile][dp]
  float* Vs = Ks + kKeyTile * dp;   // [kKeyTile][dp]
  float* Ps = Vs + kKeyTile * dp;   // [kRowQ][S]    s, then A, then ds
  float* Gs = Ps + kRowQ * S;       // [kRowQ][S]    dA
  q += head_at(sq, b, h);
  k += head_at(sk, b, h);
  v += head_at(sv, b, h);
  dout += head_at(sdo, b, h);
  dq += head_at(sdq, b, h);
  const int tid = threadIdx.x;

  for (int e = tid; e < kRowQ * dh; e += kAttThreads) {
    const int i = e / dh, d = e % dh;
    const bool ok = i < nq;
    Qs[e] = ok ? q[(long long)(q0 + i) * sq.s + d] : 0.f;
    Os[e] = ok ? dout[(long long)(q0 + i) * sdo.s + d] : 0.f;
  }
  for (int k0 = 0; k0 < S; k0 += kKeyTile) {
    const int nk = min(kKeyTile, S - k0);
    __syncthreads();
    for (int e = tid; e < kKeyTile * dh; e += kAttThreads) {
      const int j = e / dh, d = e % dh;
      Ks[j * dp + d] = (j < nk) ? k[(long long)(k0 + j) * sk.s + d] : 0.f;
      Vs[j * dp + d] = (j < nk) ? v[(long long)(k0 + j) * sv.s + d] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < kRowQ * kKeyTile; e += kAttThreads) {
      const int i = e / kKeyTile, j = e % kKeyTile;
      if (j < nk) {
        float s = 0.f, g = 0.f;
        for (int d = 0; d < dh; ++d) {
          s = fmaf(Qs[i * dh + d], Ks[j * dp + d], s);
          g = fmaf(Os[i * dh + d], Vs[j * dp + d], g);
        }
        Ps[i * S + k0 + j] = s * scale;
        Gs[i * S + k0 + j] = g;
      }
    }
  }
  __syncthreads();

  const int warp = tid / kWarp, lane = tid % kWarp;
  const size_t sbase = ((size_t)b * H + h) * S + q0;
  const size_t plane = (size_t)B * H * S;
  for (int i = warp; i < nq; i += kAttThreads / kWarp) {
    float* row = Ps + i * S;
    const float* grow = Gs + i * S;
    float m = -INFINITY;
    for (int j = lane; j < S; j += kWarp) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < S; j += kWarp) l += expf(row[j] - m);
    const float inv = 1.0f / warp_sum(l);
    float ds = 0.f;
    for (int j = lane; j < S; j += kWarp) {
      const float a = expf(row[j] - m) * inv;
      row[j] = a;
      ds = fmaf(a, grow[j], ds);
    }
    const float dsum = warp_sum(ds);
    for (int j = lane; j < S; j += kWarp) row[j] = row[j] * (grow[j] - dsum) * scale;
    if (lane == 0) {
      stats[sbase + i] = m;
      stats[plane + sbase + i] = inv;
      stats[2 * plane + sbase + i] = dsum;
    }
  }

  // dq_i = sum_j ds_ij k_j
  constexpr int R = kRowQ * kMaxDh / kAttThreads;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < S; k0 += kKeyTile) {
    const int nk = min(kKeyTile, S - k0);
    __syncthreads();
    for (int e = tid; e < kKeyTile * dh; e += kAttThreads) {
      const int j = e / dh, d = e % dh;
      Ks[j * dp + d] = (j < nk) ? k[(long long)(k0 + j) * sk.s + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = tid + r * kAttThreads;
      if (e < kRowQ * dh) {
        const int i = e / dh, d = e % dh;
        float a = acc[r];
        for (int j = 0; j < nk; ++j) a = fmaf(Ps[i * S + k0 + j], Ks[j * dp + d], a);
        acc[r] = a;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = tid + r * kAttThreads;
    if (e < kRowQ * dh) {
      const int i = e / dh, d = e % dh;
      if (i < nq) dq[(long long)(q0 + i) * sdq.s + d] = acc[r];
    }
  }
}

// Columns pass: one block per (key tile, head, image), walking all queries.
// dk_j = sum_i ds_ij q_i, dv_j = sum_i A_ij do_i, and the rule-6 fold of this
// head e_h[j] = sum_i r_i relu(A_ij dA_ij), each summed in a fixed order.
__global__ void __launch_bounds__(kAttThreads)
attn_bwd_cols_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ rvec, const float* __restrict__ stats,
                     float* __restrict__ dk_out, float* __restrict__ dv_out,
                     float* __restrict__ e_part, Strides sq, Strides sk, Strides sv,
                     Strides sdo, Strides sdk, Strides sdv, int B, int S, int H, int dh,
                     float scale) {
  extern __shared__ float sm[];
  const int dp = dh + 1, cp = kColK + 1;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kColK;
  const int nk = min(kColK, S - k0);
  float* Ks = sm;                    // [kColK][dh]
  float* Vs = Ks + kColK * dh;       // [kColK][dh]
  float* Qs = Vs + kColK * dh;       // [kColQ][dp]
  float* Os = Qs + kColQ * dp;       // [kColQ][dp]
  float* As = Os + kColQ * dp;       // [kColQ][cp]  A
  float* Ds = As + kColQ * cp;       // [kColQ][cp]  ds
  float* Es = Ds + kColQ * cp;       // [kColQ][cp]  r_i relu(A dA)
  float* st = Es + kColQ * cp;       // [4][kColQ]   m, 1/l, dsum, r
  float* eacc = st + 4 * kColQ;      // [kColK]
  q += head_at(sq, b, h);
  k += head_at(sk, b, h);
  v += head_at(sv, b, h);
  dout += head_at(sdo, b, h);
  dk_out += head_at(sdk, b, h);
  dv_out += head_at(sdv, b, h);
  const size_t plane = (size_t)B * H * S;
  const size_t sbase = ((size_t)b * H + h) * S;
  const int tid = threadIdx.x;

  for (int e = tid; e < kColK * dh; e += kAttThreads) {
    const int j = e / dh, d = e % dh;
    Ks[e] = (j < nk) ? k[(long long)(k0 + j) * sk.s + d] : 0.f;
    Vs[e] = (j < nk) ? v[(long long)(k0 + j) * sv.s + d] : 0.f;
  }
  if (tid < kColK) eacc[tid] = 0.f;

  constexpr int R = kColK * kMaxDh / kAttThreads;
  float dk[R], dv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) dk[r] = dv[r] = 0.f;

  for (int qb = 0; qb < S; qb += kColQ) {
    const int nq = min(kColQ, S - qb);
    __syncthreads();
    for (int e = tid; e < kColQ * dh; e += kAttThreads) {
      const int i = e / dh, d = e % dh;
      const bool ok = i < nq;
      Qs[i * dp + d] = ok ? q[(long long)(qb + i) * sq.s + d] : 0.f;
      Os[i * dp + d] = ok ? dout[(long long)(qb + i) * sdo.s + d] : 0.f;
    }
    if (tid < kColQ) {  // padded queries get inv = 0, so A = 0 there
      const bool ok = tid < nq;
      st[tid] = ok ? stats[sbase + qb + tid] : 0.f;
      st[kColQ + tid] = ok ? stats[plane + sbase + qb + tid] : 0.f;
      st[2 * kColQ + tid] = ok ? stats[2 * plane + sbase + qb + tid] : 0.f;
      st[3 * kColQ + tid] = ok ? rvec[(size_t)b * S + qb + tid] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < kColQ * kColK; e += kAttThreads) {
      const int i = e % kColQ, j = e / kColQ;
      float s = 0.f, g = 0.f;
      for (int d = 0; d < dh; ++d) {
        s = fmaf(Qs[i * dp + d], Ks[j * dh + d], s);
        g = fmaf(Os[i * dp + d], Vs[j * dh + d], g);
      }
      const float a = (j < nk) ? expf(s * scale - st[i]) * st[kColQ + i] : 0.f;
      As[i * cp + j] = a;
      Ds[i * cp + j] = a * (g - st[2 * kColQ + i]) * scale;
      Es[i * cp + j] = fmaxf(a * g, 0.f) * st[3 * kColQ + i];
    }
    __syncthreads();
    if (tid < kColK) {
      float s = 0.f;
      for (int i = 0; i < nq; ++i) s += Es[i * cp + tid];
      eacc[tid] += s;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = tid + r * kAttThreads;
      if (e < kColK * dh) {
        const int j = e / dh, d = e % dh;
        float a = dk[r], c = dv[r];
        for (int i = 0; i < nq; ++i) {
          a = fmaf(Ds[i * cp + j], Qs[i * dp + d], a);
          c = fmaf(As[i * cp + j], Os[i * dp + d], c);
        }
        dk[r] = a;
        dv[r] = c;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = tid + r * kAttThreads;
    if (e < kColK * dh) {
      const int j = e / dh, d = e % dh;
      if (j < nk) {
        dk_out[(long long)(k0 + j) * sdk.s + d] = dk[r];
        dv_out[(long long)(k0 + j) * sdv.s + d] = dv[r];
      }
    }
  }
  if (tid < nk) e_part[sbase + k0 + tid] = eacc[tid];
}

__global__ void e_row_kernel(const float* __restrict__ e_part, float* __restrict__ e_row,
                             int B, int S, int H) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * S) return;
  const int b = idx / S, k = idx % S;
  float s = 0.f;
  for (int h = 0; h < H; ++h) s += e_part[((size_t)b * H + h) * S + k];
  e_row[idx] = s * (1.0f / H);
}

// dh rounded up to the forward's 8-wide fragment steps.
int fwd_dp(int dh) { return (dh + 7) / 8 * 8; }

// The forward's Q tile and K/V rings, rows of dp + 4 floats: fixed by dh.
size_t fwd_smem(int dh) {
  return sizeof(float) * (size_t)(kFwdQ + 2 * kFwdStages * kFwdK) * (fwd_dp(dh) + 4);
}

struct FwdArgs {
  const float *q, *k, *v;
  float* out;
  Strides sq, sk, sv, so;
  int B, S, H, dh;
  float scale_log2;
};

// Launches attn_fwd_kernel<DP, vec> for DP = fwd_dp(dh), found by walking
// the 16 instantiations DP = 8, 16, ..., kMaxDh.
template <int DP>
cudaError_t launch_fwd(const FwdArgs& a, bool vec, cudaStream_t stream) {
  if constexpr (DP > kMaxDh) {
    return cudaErrorInvalidValue;
  } else {
    if (fwd_dp(a.dh) != DP) return launch_fwd<DP + 8>(a, vec, stream);
    auto kernel = vec ? attn_fwd_kernel<DP, true> : attn_fwd_kernel<DP, false>;
    const size_t smem = fwd_smem(a.dh);
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.S + kFwdQ - 1) / kFwdQ, a.H, a.B);
    kernel<<<grid, kFwdThreads, smem, stream>>>(a.q, a.k, a.v, a.out, a.sq, a.sk, a.sv,
                                                 a.so, a.S, a.dh, a.scale_log2);
    return cudaGetLastError();
  }
}

// Every row of every head starts on a 16-byte boundary.
bool rows_aligned16(const float* p, const Strides& s) {
  return ((uintptr_t)p & 15) == 0 && s.b % 4 == 0 && s.h % 4 == 0 && s.s % 4 == 0;
}

size_t rows_smem(int S, int dh) {
  return sizeof(float) * (2 * (size_t)kRowQ * dh + 2 * (size_t)kKeyTile * (dh + 1) +
                          2 * (size_t)kRowQ * S);
}

size_t cols_smem(int dh) {
  return sizeof(float) * (2 * (size_t)kColK * dh + 2 * (size_t)kColQ * (dh + 1) +
                          3 * (size_t)kColQ * (kColK + 1) + 4 * (size_t)kColQ + kColK);
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
// fixed by dh; or the larger of the two backward passes, which grows with
// S), saturated at INT_MAX; and the most
// the device lets one block opt in to. The wrappers compare the two before
// launch.
int tmx_attn_smem(int S, int dh, int backward) {
  const size_t rs = rows_smem(S, dh), cs = cols_smem(dh);
  const size_t bytes = backward ? (rs > cs ? rs : cs) : fwd_smem(dh);
  return bytes > (size_t)INT_MAX ? INT_MAX : (int)bytes;
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
// [B, H, S].
int tmx_attn_bwd(const float* q, const float* k, const float* v, const float* dout,
                 const float* r, float* dq, float* dk, float* dv, float* stats,
                 float* e_part, float* e_row, const long long* strides, int B, int S,
                 int H, int dh, float scale, void* stream) {
  Strides st[7];
  for (int i = 0; i < 7; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], (int)strides[3 * i + 2]};
  cudaStream_t s = (cudaStream_t)stream;
  const size_t rs = rows_smem(S, dh), cs = cols_smem(dh);
  cudaError_t err = allow_smem(attn_bwd_rows_kernel, rs);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(attn_bwd_cols_kernel, cs);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_rows_kernel<<<dim3((S + kRowQ - 1) / kRowQ, H, B), kAttThreads, rs, s>>>(
      q, k, v, dout, dq, stats, st[0], st[1], st[2], st[3], st[4], B, S, H, dh, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_cols_kernel<<<dim3((S + kColK - 1) / kColK, H, B), kAttThreads, cs, s>>>(
      q, k, v, dout, r, stats, dk, dv, e_part, st[0], st[1], st[2], st[3], st[5], st[6],
      B, S, H, dh, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  e_row_kernel<<<(B * S + 255) / 256, 256, 0, s>>>(e_part, e_row, B, S, H);
  return (int)cudaGetLastError();
}

}  // extern "C"
