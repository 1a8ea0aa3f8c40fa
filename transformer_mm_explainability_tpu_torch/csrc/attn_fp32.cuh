// The fp32-product attention kernels of attn_block.cu (their design is in
// that file's header), templated on the storage T of q, k, v, dout and the
// outputs: fp32, or bf16 (widened on load into the same fp32 tiles,
// outputs rounded once, e_row and the statistics fp32). attn_block.cu
// instantiates T = float, attn_block_s16.cu T = bf16; both objects link
// into one library, so the two sets of 96 instances compile in parallel.

#pragma once

#include "attn_common.cuh"
#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

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
// values each) into a [ROWS][DP + 4] fp32 tile with cp.async, or through
// registers (stage_bf16) where the storage T is bf16; rows at or past S and
// columns at or past dh become 0. VEC: 16-byte copies (dh a multiple of a
// copy's 4 fp32 or 8 bf16 elements and 16-byte aligned rows, checked before
// launch), else copies of one element.
template <int DP, int ROWS, bool VEC, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int row0, int S,
                                          int stride, int dh) {
  constexpr int LD = DP + 4;
  constexpr int W = VEC ? 16 / (int)sizeof(T) : 1;  // elements per copy
  constexpr int PER_ROW = DP / W;
  for (int e = threadIdx.x; e < ROWS * PER_ROW; e += kAttThreads) {
    const int r = e / PER_ROW, d = (e % PER_ROW) * W;
    float* to = dst + r * LD + d;
    const bool ok = row0 + r < S && d < dh;
    const T* from = src + (long long)(row0 + r) * stride + d;
    if constexpr (sizeof(T) == 2) {
      stage_bf16<VEC>(to, from, ok);
    } else if constexpr (VEC) {
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
// scale_log2 = scale * log2(e). DP: dh rounded up to a multiple of 8. T:
// the storage of q, k, v and out (fp32, or bf16 widened on load and out
// rounded once).
template <int DP, bool VEC, typename T>
__global__ void __launch_bounds__(kAttThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ out, Strides sq,
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
      if (row < S) put_f32(out + (long long)row * so.s + d, o[n][e] * inv[0]);
      if (row + 8 < S) put_f32(out + (long long)(row + 8) * so.s + d, o[n][2 + e] * inv[1]);
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
// one head (rows at or past S and columns at or past dh are skipped), each
// stored as T (fp32, or bf16 rounded to nearest even).
template <int DP, typename T>
__device__ __forceinline__ void store_rows(T* out, int stride, const float (&acc)[DP / 8][4],
                                           int row0, int lane, int S, int dh) {
  const int row = row0 + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = n * 8 + 2 * t + e;
      if (d >= dh) continue;
      if (row < S) put_f32(out + (long long)row * stride + d, acc[n][e]);
      if (row + 8 < S) put_f32(out + (long long)(row + 8) * stride + d, acc[n][2 + e]);
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
template <int DP, bool VEC, typename T>
__global__ void __launch_bounds__(kAttThreads, DP <= 64 ? 3 : 1)
attn_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  T* __restrict__ dq, float* __restrict__ stats, Strides sq, Strides sk,
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
template <int DP, bool VEC, typename T>
__global__ void __launch_bounds__(kAttThreads, 2)
attn_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ rvec, const float* __restrict__ stats,
                   T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ e_part,
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

// Pointers to T storage (launch_fwd / launch_bwd's T).
struct FwdArgs {
  const void *q, *k, *v;
  void* out;
  Strides sq, sk, sv, so;
  int B, S, H, dh;
  float scale_log2;
};

// Launches attn_fwd_kernel<DP, vec, T> for DP = att_dp(dh), found by walking
// the 16 instantiations DP = 8, 16, ..., kMaxDh.
template <int DP, typename T>
cudaError_t launch_fwd(const FwdArgs& a, bool vec, cudaStream_t stream) {
  if constexpr (DP > kMaxDh) {
    return cudaErrorInvalidValue;
  } else {
    if (att_dp(a.dh) != DP) return launch_fwd<DP + 8, T>(a, vec, stream);
    auto kernel = vec ? attn_fwd_kernel<DP, true, T> : attn_fwd_kernel<DP, false, T>;
    const size_t smem = fwd_smem(a.dh);
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.S + kAttRows - 1) / kAttRows, a.H, a.B);
    kernel<<<grid, kAttThreads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<T*>(a.out), a.sq, a.sk, a.sv, a.so, a.S, a.dh, a.scale_log2);
    return cudaGetLastError();
  }
}

// Every row of every head starts on a 16-byte boundary: the pointer, and
// the strides in whole copies of `per` elements (4 fp32, 8 bf16).
bool rows_aligned16(const void* p, const Strides& s, int per) {
  return ((uintptr_t)p & 15) == 0 && s.b % per == 0 && s.h % per == 0 && s.s % per == 0;
}

struct BwdArgs {
  const void *q, *k, *v, *dout;  // T storage, as dq, dk, dv
  const float* r;
  void *dq, *dk, *dv;
  float *stats, *e_part, *e_row;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int B, S, H, dh;
  float scale_log2, scale;
};

// Launches the q pass, the kv pass and e_row_kernel for DP = att_dp(dh),
// found by walking the 16 instantiations DP = 8, 16, ..., kMaxDh.
template <int DP, typename T>
cudaError_t launch_bwd(const BwdArgs& a, bool vec, cudaStream_t stream) {
  if constexpr (DP > kMaxDh) {
    return cudaErrorInvalidValue;
  } else {
    if (att_dp(a.dh) != DP) return launch_bwd<DP + 8, T>(a, vec, stream);
    auto qk = vec ? attn_bwd_q_kernel<DP, true, T> : attn_bwd_q_kernel<DP, false, T>;
    auto kv = vec ? attn_bwd_kv_kernel<DP, true, T> : attn_bwd_kv_kernel<DP, false, T>;
    const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k);
    const T *v = static_cast<const T*>(a.v), *dout = static_cast<const T*>(a.dout);
    const size_t smem = bwd_smem(a.dh);
    cudaError_t err = allow_smem(qk, smem);
    if (err == cudaSuccess) err = allow_smem(kv, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.S + kAttRows - 1) / kAttRows, a.H, a.B);
    qk<<<grid, kAttThreads, smem, stream>>>(q, k, v, dout, static_cast<T*>(a.dq), a.stats, a.sq,
                                            a.sk, a.sv, a.sdo, a.sdq, a.B, a.S, a.H, a.dh,
                                            a.scale_log2, a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    kv<<<grid, kAttThreads, smem, stream>>>(q, k, v, dout, a.r, a.stats, static_cast<T*>(a.dk),
                                            static_cast<T*>(a.dv), a.e_part, a.sq, a.sk, a.sv,
                                            a.sdo, a.sdk, a.sdv, a.B, a.S, a.H, a.dh,
                                            a.scale_log2, a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    e_row_kernel<<<(a.B * a.S + 255) / 256, 256, 0, stream>>>(a.e_part, a.e_row, a.B, a.S,
                                                               a.H);
    return cudaGetLastError();
  }
}

// The entry points' argument checks and launches, for storage T. strides:
// the (batch, head, row) element strides of each [B, H, S, dh] operand in
// the entry point's order (flattened [n][3]). copy_bytes: 16 (dh and every
// row of the operands read in whole 16-byte copies, of 4 fp32 or 8 bf16
// elements; refused otherwise) or 4, a copy of one element.
template <typename T>
cudaError_t attn_fwd_entry(const void* q, const void* k, const void* v, void* out,
                           const long long* strides, int B, int S, int H, int dh, float scale,
                           int copy_bytes, cudaStream_t stream) {
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], (int)strides[3 * i + 2]};
  const bool vec = copy_bytes == 16;
  const int per = 16 / (int)sizeof(T);
  if (!vec && copy_bytes != 4) return cudaErrorInvalidValue;
  if (vec && !(dh % per == 0 && rows_aligned16(q, st[0], per) && rows_aligned16(k, st[1], per) &&
               rows_aligned16(v, st[2], per)))
    return cudaErrorMisalignedAddress;
  const FwdArgs a = {q, k, v, out, st[0], st[1], st[2], st[3],
                     B, S, H, dh, scale * 1.4426950408889634f};
  return launch_fwd<8, T>(a, vec, stream);
}

template <typename T>
cudaError_t attn_bwd_entry(const void* q, const void* k, const void* v, const void* dout,
                           const float* r, void* dq, void* dk, void* dv, float* stats,
                           float* e_part, float* e_row, const long long* strides, int B, int S,
                           int H, int dh, float scale, int copy_bytes, cudaStream_t stream) {
  Strides st[7];
  for (int i = 0; i < 7; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], (int)strides[3 * i + 2]};
  const bool vec = copy_bytes == 16;
  const int per = 16 / (int)sizeof(T);
  if (!vec && copy_bytes != 4) return cudaErrorInvalidValue;
  if (vec && !(dh % per == 0 && rows_aligned16(q, st[0], per) && rows_aligned16(k, st[1], per) &&
               rows_aligned16(v, st[2], per) && rows_aligned16(dout, st[3], per)))
    return cudaErrorMisalignedAddress;
  const BwdArgs a = {q,     k,     v,     dout,  r,     dq,    dk, dv, stats, e_part,
                     e_row, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
                     B,     S,     H,     dh,    scale * 1.4426950408889634f, scale};
  return launch_bwd<8, T>(a, vec, stream);
}

}  // namespace
