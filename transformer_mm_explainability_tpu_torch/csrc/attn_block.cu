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
//   gemm_kernel        (common.cuh) tiled fp32 GEMM (shared-memory tiles,
//                      register micro-tile, register prefetch of the next K
//                      slice) with an optional transposed B and fused
//                      epilogues: bias, residual add, exact-erf GELU, multiply
//                      by GELU'(aux). Every product of the Pallas bodies runs
//                      here: LN1*W_qkv, merged*W_out, LN2*W1, GELU*W2,
//                      cot*W2^T, da*W1^T, cot*W_out^T and dqkv*W_qkv^T.
//   attn_fwd_kernel    one block per (query tile, head, image): fp32 softmax
//                      over all S keys, A*V, written through the output's
//                      strides.
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
// bwd) against a few MB of traffic, so at fp32 on the CUDA cores (67 TFLOP/s
// published peak) they are bound by operations, not by bytes. The GEMM is
// where the time goes. Its design answers that with the classic SIMT
// recipe: 128x128 (or 64x64 when the big tiles would leave SMs idle) output
// tiles, an 8x8 (4x4) register micro-tile per thread read from shared
// memory as float4, and the next K slice loaded into registers while the
// current one is multiplied. Tensor cores (TF32/bf16 wgmma) and TMA are not
// used: the port is held to the fp32 CPU reference first.
//
// Memory: the MLP wrappers materialise the [B*S, I] hidden activations in
// device memory (77 MB fp32 at B=32, I=3072), where the Pallas kernels kept
// [S, I/chunks] tiles in VMEM. The attention probabilities are never stored:
// each pass recomputes them from q and k. The forward and the rows pass keep
// whole score rows in shared memory ([16][S], two of them in the rows pass),
// so S is bounded by the 227 KB a block may opt in to: about 1,490 at dh=64
// for the backward. tmx_attn_smem lets the wrappers refuse a longer S before
// launch.

#include <limits.h>

#include "common.cuh"

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
constexpr int kKeyTile = 64;   // keys per shared-memory tile (fwd, bwd rows)
constexpr int kFwdQ = 16;      // queries per block (fwd, bwd rows)
constexpr int kColK = 16;      // keys per block (bwd columns)
constexpr int kColQ = 64;      // queries per tile (bwd columns)

__global__ void __launch_bounds__(kAttThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out, Strides sq,
                Strides sk, Strides sv, Strides so, int S, int dh, float scale) {
  extern __shared__ float sm[];
  const int dp = dh + 1;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kFwdQ;
  const int nq = min(kFwdQ, S - q0);
  float* Qs = sm;                  // [kFwdQ][dh]
  float* Ts = Qs + kFwdQ * dh;     // [kKeyTile][dp]  K, then V tiles
  float* Ps = Ts + kKeyTile * dp;  // [kFwdQ][S]      scores, then A
  q += head_at(sq, b, h);
  k += head_at(sk, b, h);
  v += head_at(sv, b, h);
  out += head_at(so, b, h);
  const int tid = threadIdx.x;

  for (int e = tid; e < kFwdQ * dh; e += kAttThreads) {
    const int i = e / dh, d = e % dh;
    Qs[e] = (i < nq) ? q[(long long)(q0 + i) * sq.s + d] : 0.f;
  }
  for (int k0 = 0; k0 < S; k0 += kKeyTile) {
    const int nk = min(kKeyTile, S - k0);
    __syncthreads();
    for (int e = tid; e < kKeyTile * dh; e += kAttThreads) {
      const int j = e / dh, d = e % dh;
      Ts[j * dp + d] = (j < nk) ? k[(long long)(k0 + j) * sk.s + d] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < kFwdQ * kKeyTile; e += kAttThreads) {
      const int i = e / kKeyTile, j = e % kKeyTile;
      if (j < nk) {
        float s = 0.f;
        for (int d = 0; d < dh; ++d) s = fmaf(Qs[i * dh + d], Ts[j * dp + d], s);
        Ps[i * S + k0 + j] = s * scale;
      }
    }
  }
  __syncthreads();

  const int warp = tid / kWarp, lane = tid % kWarp;
  for (int i = warp; i < nq; i += kAttThreads / kWarp) {
    float* row = Ps + i * S;
    float m = -INFINITY;
    for (int j = lane; j < S; j += kWarp) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < S; j += kWarp) {
      const float ex = expf(row[j] - m);
      row[j] = ex;
      l += ex;
    }
    const float inv = 1.0f / warp_sum(l);
    for (int j = lane; j < S; j += kWarp) row[j] *= inv;
  }

  constexpr int R = kFwdQ * kMaxDh / kAttThreads;
  float o[R];
#pragma unroll
  for (int r = 0; r < R; ++r) o[r] = 0.f;
  for (int k0 = 0; k0 < S; k0 += kKeyTile) {
    const int nk = min(kKeyTile, S - k0);
    __syncthreads();
    for (int e = tid; e < kKeyTile * dh; e += kAttThreads) {
      const int j = e / dh, d = e % dh;
      Ts[j * dp + d] = (j < nk) ? v[(long long)(k0 + j) * sv.s + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = tid + r * kAttThreads;
      if (e < kFwdQ * dh) {
        const int i = e / dh, d = e % dh;
        float acc = o[r];
        for (int j = 0; j < nk; ++j) acc = fmaf(Ps[i * S + k0 + j], Ts[j * dp + d], acc);
        o[r] = acc;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = tid + r * kAttThreads;
    if (e < kFwdQ * dh) {
      const int i = e / dh, d = e % dh;
      if (i < nq) out[(long long)(q0 + i) * so.s + d] = o[r];
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
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kFwdQ;
  const int nq = min(kFwdQ, S - q0);
  float* Qs = sm;                   // [kFwdQ][dh]
  float* Os = Qs + kFwdQ * dh;      // [kFwdQ][dh]   dout rows
  float* Ks = Os + kFwdQ * dh;      // [kKeyTile][dp]
  float* Vs = Ks + kKeyTile * dp;   // [kKeyTile][dp]
  float* Ps = Vs + kKeyTile * dp;   // [kFwdQ][S]    s, then A, then ds
  float* Gs = Ps + kFwdQ * S;       // [kFwdQ][S]    dA
  q += head_at(sq, b, h);
  k += head_at(sk, b, h);
  v += head_at(sv, b, h);
  dout += head_at(sdo, b, h);
  dq += head_at(sdq, b, h);
  const int tid = threadIdx.x;

  for (int e = tid; e < kFwdQ * dh; e += kAttThreads) {
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
    for (int e = tid; e < kFwdQ * kKeyTile; e += kAttThreads) {
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
  constexpr int R = kFwdQ * kMaxDh / kAttThreads;
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
      if (e < kFwdQ * dh) {
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
    if (e < kFwdQ * dh) {
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

// Sets the dynamic shared-memory limit a launch needs (above the 48 KB
// default); the launch itself reports a size the card cannot give.
template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

size_t fwd_smem(int S, int dh) {
  return sizeof(float) * ((size_t)kFwdQ * dh + (size_t)kKeyTile * (dh + 1) + (size_t)kFwdQ * S);
}

size_t rows_smem(int S, int dh) {
  return sizeof(float) * (2 * (size_t)kFwdQ * dh + 2 * (size_t)kKeyTile * (dh + 1) +
                          2 * (size_t)kFwdQ * S);
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

int tmx_gemm(const float* A, const float* B, float* C, int M, int N, int K,
             int trans_b, const float* bias, const float* res, const float* aux,
             int act, void* stream) {
  gemm<false>(A, B, C, M, N, K, trans_b != 0, bias, res, aux, act, 1, 0, 0, 0,
              (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory one attention block needs (the forward, or
// the larger of the two backward passes), saturated at INT_MAX; and the most
// the device lets one block opt in to. The wrappers compare the two before
// launch.
int tmx_attn_smem(int S, int dh, int backward) {
  const size_t rs = rows_smem(S, dh), cs = cols_smem(dh);
  const size_t bytes = backward ? (rs > cs ? rs : cs) : fwd_smem(S, dh);
  return bytes > (size_t)INT_MAX ? INT_MAX : (int)bytes;
}

int tmx_smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

// q, k, v, out: [B, H, S, dh] operands; strides: [4][3] (batch, head, row)
// element strides of q, k, v, out in that order.
int tmx_attn_fwd(const float* q, const float* k, const float* v, float* out,
                 const long long* strides, int B, int S, int H, int dh, float scale,
                 void* stream) {
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], (int)strides[3 * i + 2]};
  const size_t smem = fwd_smem(S, dh);
  cudaError_t err = allow_smem(attn_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kFwdQ - 1) / kFwdQ, H, B);
  attn_fwd_kernel<<<grid, kAttThreads, smem, (cudaStream_t)stream>>>(
      q, k, v, out, st[0], st[1], st[2], st[3], S, dh, scale);
  return (int)cudaGetLastError();
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
  attn_bwd_rows_kernel<<<dim3((S + kFwdQ - 1) / kFwdQ, H, B), kAttThreads, rs, s>>>(
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
