// Hand-written CUDA kernels for the bf16-product mode (fast_dots) of the ViT
// block branches and the fused attention on Hopper, and for bf16 tensors.
//
// The JAX package runs kernels #1-#8 with fast_dots=True on its chip: every
// operand of every product rounded to bf16, the products summed in fp32;
// softmax, the LayerNorm statistics and VJP, GELU, the residual adds, dsum
// and the rule-6 fold stay fp32 (attn_block_pallas.py _dot/_cast :54-61,
// _fwd_kernel :64, _bwd_kernel :84, _mlp_fwd_kernel :167,
// _mlp_bwd_kernel :224; flash_attention.py _dot/_dot_tt :43-57,
// _fwd_kernel :79, _bwd_kernel :91, _fwd_kernel2 :187, _bwd_kernel2 :213).
// Its throughput mode also stores x, the cotangents, the weights, the biases
// and the LayerNorm parameters in bf16; the kernels upcast them on load and
// write x_mid, x_out, cot_x, the attention outputs and dq, dk, dv (dqkv) in
// the inputs' dtype, e_row in fp32. This file holds what that mode needs
// beside the bf16-product GEMM of gemm_bf16.cuh (gemm_bf16_wgmma_kernel):
//
//   ln_fwd_bf16_kernel   LayerNorm forward of fp32 or bf16 rows, fp32
//                        statistics (also written for the VJP); the output
//                        is only ever a product operand, so it is written
//                        rounded to bf16, which is what the JAX body
//                        multiplies.
//   ln_vjp_any_kernel    LayerNorm input cotangent plus the residual skip,
//                        fp32 arithmetic on fp32 or bf16 storage.
//   attn_fwd_bf16_kernel, attn_bwd_q_bf16_kernel, attn_bwd_kv_bf16_kernel
//                        the attention forward and the two passes of its
//                        backward with bf16 products (below); e_row_kernel
//                        (attn_common.cuh) sums the heads of the fold.
//
// What bounds them: the attention does 4 S*S*dh (forward) and 10 S*S*dh
// (backward) flops per (image, head) against 16 and 28 S*dh bytes, bound by
// operations at the dense bf16 tensor-core rate (989 TFLOP/s); the
// LayerNorm rows are bound by bytes. The design follows attn_block.cu's
// fp32 kernels (one block of 4 warps per 64-row tile, head and image; the
// other operand streamed in 32-row tiles; no atomics, every output row
// written by one warp, so the same bits on every run), with these changes:
//   - every operand tile is staged through registers (mma_bf16.cuh
//     TileRegs): fp32 or bf16 rows are read, rounded to bf16 and written
//     to one of two shared-memory buffers, bf16 rows of dh16 + 8 elements
//     (dh16: dh rounded up to 16, zero-filled), read by ldmatrix; the next
//     tile's reads are in flight while this one is multiplied;
//   - the forward runs two sweeps over the key tiles: the row max and sum
//     first, then A = 2^(s - m) / l normalised before it is rounded to bf16
//     for the A v product. The JAX body rounds the normalised A; an online
//     softmax would round unnormalised terms, a different rounding whose
//     distance from JAX is of the order of the fast_dots rounding itself.
//     The price is one more q k^T product (3 S*S*dh products for 2);
//   - q k^T and dout v^T take q, k, v and dout as bf16 fragments; A (or its
//     transpose) and ds go to bf16 from the accumulators for the A v,
//     ds k, A^T dout and ds^T q products (mma_bf16.cuh a_from_acc_bf16).
//     The row statistics, dsum, ds before its rounding and the fold are
//     fp32, from the same fp32 scores.
// Shared memory is fixed by dh (28 KB forward, 37 KB backward at dh = 64),
// so any S runs.

#include "attn_common.cuh"
#include "common.cuh"
#include "gemm_bf16.cuh"
#include "mma_bf16.cuh"

namespace {

// ---------------------------------------------------------------------------
// LayerNorm, one warp per row (as attn_block.cu's fp32 kernels)
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 256;  // 8 rows (one per warp) per block

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// y = (x - mean) / sigma * gamma + beta rounded to bf16; x, gamma, beta of
// type T; mean and 1/sigma (fp32) kept for the VJP.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
ln_fwd_bf16_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                   const T* __restrict__ beta, bf16* __restrict__ y, float* __restrict__ mean,
                   float* __restrict__ rstd, int M, int D, float eps) {
  const int row = blockIdx.x * (kRowThreads / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= M) return;
  const T* xr = x + (size_t)row * D;
  float s = 0.f;
  for (int j = lane; j < D; j += kWarp) s += as_float(xr[j]);
  const float mu = warp_sum(s) / D;
  float v = 0.f;
  for (int j = lane; j < D; j += kWarp) {
    const float c = as_float(xr[j]) - mu;
    v = fmaf(c, c, v);
  }
  const float rs = 1.0f / sqrtf(warp_sum(v) / D + eps);
  bf16* yr = y + (size_t)row * D;
  for (int j = lane; j < D; j += kWarp)
    yr[j] = __float2bfloat16_rn((as_float(xr[j]) - mu) * rs * as_float(gamma[j]) +
                                as_float(beta[j]));
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

// out = cot + rstd * (g - mean(g) - xh * mean(g * xh)),  g = dy * gamma;
// dy fp32, x, gamma, cot and out of type T.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
ln_vjp_any_kernel(const float* __restrict__ dy, const T* __restrict__ x,
                  const float* __restrict__ mean, const float* __restrict__ rstd,
                  const T* __restrict__ gamma, const T* __restrict__ cot, T* __restrict__ out,
                  int M, int D) {
  const int row = blockIdx.x * (kRowThreads / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= M) return;
  const size_t base = (size_t)row * D;
  const float mu = mean[row], rs = rstd[row];
  float sg = 0.f, sgx = 0.f;
  for (int j = lane; j < D; j += kWarp) {
    const float g = dy[base + j] * as_float(gamma[j]);
    sg += g;
    sgx = fmaf(g, (as_float(x[base + j]) - mu) * rs, sgx);
  }
  const float gm = warp_sum(sg) / D;
  const float gx = warp_sum(sgx) / D;
  for (int j = lane; j < D; j += kWarp) {
    const float g = dy[base + j] * as_float(gamma[j]);
    const float xh = (as_float(x[base + j]) - mu) * rs;
    out[base + j] = from_float<T>(as_float(cot[base + j]) + rs * (g - gm - xh * gx));
  }
}

// ---------------------------------------------------------------------------
// Attention with bf16 products. Operands as in attn_block.cu (base pointer,
// (batch, head, row) strides, unit stride along dh), all of one storage
// type: fp32, or bf16 where `bf` is set; r, the statistics and the fold
// fp32.
// ---------------------------------------------------------------------------

constexpr int kMaxDh = 128;
constexpr int kAttThreads = 128;  // 4 warps of 16 rows
constexpr int kAttRows = 64;      // rows per block
constexpr int kAttTile = 32;      // rows per streamed tile
constexpr int kKT = kAttTile / 8; // n8 fragments of a streamed tile

struct Operand {
  const void* p;
  Strides st;
};

// Rows [row0, row0 + ROWS) of head (b, h) of an operand into registers.
template <int ROWS, int DP>
__device__ __forceinline__ void fetch_rows(TileRegs<ROWS, DP, kAttThreads>& regs,
                                           const Operand& o, int b, int h, int row0, int S,
                                           int dh, bool bf, bool vec) {
  const long long at = head_at(o.st, b, h) + (long long)row0 * o.st.s;
  regs.load(elem_at(o.p, at, bf), bf, vec, o.st.s, S - row0, dh);
}

// acc[n] = A B^T for one warp: A the warp's 16 rows of a [.][LD] bf16 tile,
// B the 8 * N rows of another, both DP wide (q k^T, dout v^T and, in the
// kv pass, their transposes).
template <int DP, int N>
__device__ __forceinline__ void mma_rows_bt(const bf16* Aw, const bf16* Bt, int lane,
                                            float (&acc)[N][4]) {
  constexpr int LD = DP + 8;
  static_assert(N % 2 == 0, "B fragments come in pairs");
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP; kk += 16) {
    uint32_t a[4];
    load_a_bf16(Aw + kk, LD, lane, a);
#pragma unroll
    for (int n = 0; n < N; n += 2) {
      uint32_t b[2][2];
      load_bt2_bf16(Bt + n * 8 * LD + kk, LD, lane, b);
      mma_bf16(acc[n], a, b[0]);
      mma_bf16(acc[n + 1], a, b[1]);
    }
  }
}

// acc += P W for one warp: P a 16 x kAttTile accumulator tile (the warp's
// rows; the tile's rows are the product's k), rounded to bf16; W the
// tile's kAttTile rows of a [.][LD] bf16 tile: o += A v, dq += ds k,
// dv += A^T dout, dk += ds^T q. Each pair of output fragments takes the
// tile's product in a fresh accumulator, then adds it in fp32.
template <int DP>
__device__ __forceinline__ void mma_acc_rows(const float (&p)[kKT][4], const bf16* W, int lane,
                                             float (&acc)[DP / 8][4]) {
  constexpr int LD = DP + 8;
  uint32_t a[kKT / 2][4];
#pragma unroll
  for (int j = 0; j < kKT / 2; ++j) a_from_acc_bf16(p[2 * j], p[2 * j + 1], a[j]);
#pragma unroll
  for (int n = 0; n < DP / 8; n += 2) {
    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < kKT / 2; ++j) {
      uint32_t b[2][2];
      load_b2_bf16(W + j * 16 * LD + n * 8, LD, lane, b);
      mma_bf16(c[0], a[j], b[0]);
      mma_bf16(c[1], a[j], b[1]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[n][e] += c[0][e];
      acc[n + 1][e] += c[1][e];
    }
  }
}

// Writes a warp's [16][DP] accumulator rows to rows row0 .. row0 + 15 of
// one head (rows at or past S and columns at or past dh are skipped).
template <int DP>
__device__ __forceinline__ void store_rows(void* out, long long head, int stride, bool bf,
                                           const float (&acc)[DP / 8][4], int row0, int lane,
                                           int S, int dh) {
  const int row = row0 + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = n * 8 + 2 * t + e;
      if (d >= dh) continue;
      if (row < S) store_any(out, head + (long long)row * stride + d, acc[n][e], bf);
      if (row + 8 < S) store_any(out, head + (long long)(row + 8) * stride + d, acc[n][2 + e], bf);
    }
  }
}

// Scores of a streamed tile in the log2 domain; keys at or past S are -inf.
__device__ __forceinline__ void scale_mask(float (&s)[kKT][4], int k0, int S, int t,
                                           float scale_log2) {
#pragma unroll
  for (int n = 0; n < kKT; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = k0 + n * 8 + 2 * t + e < S;
      s[n][e] = ok ? s[n][e] * scale_log2 : -INFINITY;
      s[n][2 + e] = ok ? s[n][2 + e] * scale_log2 : -INFINITY;
    }
  }
}

// Online row max m (log2 domain) of a tile's scores for rows g and g + 8 of
// the warp; returns the factor 2^(m_old - m_new) (0 on the first tile).
__device__ __forceinline__ void update_max(const float (&s)[kKT][4], float (&m)[2],
                                           float (&alpha)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < kKT; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the 4 lanes of a group share a row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2f(m[r] - mx[r]);
    m[r] = mx[r];
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

struct FwdBf16Args {
  Operand q, k, v;
  void* out;
  Strides so;
  int S, dh;
  float scale_log2;
  bool bf, vec;
};

// out = softmax(q k^T * scale) v for one (64-query tile, head, image), in
// two sweeps over the 32-key tiles: it < ntiles the row max m and sum l
// (online), then A = 2^(s - m) / l, rounded to bf16, times v.
template <int DP>
__global__ void __launch_bounds__(kAttThreads)
attn_fwd_bf16_kernel(FwdBf16Args a) {
  constexpr int LD = DP + 8, NT = DP / 8;
  extern __shared__ __align__(16) bf16 fwd16_sm[];
  bf16* Qs = fwd16_sm;                     // [kAttRows][LD]
  bf16* Ks = Qs + kAttRows * LD;           // [2][kAttTile][LD]
  bf16* Vs = Ks + 2 * kAttTile * LD;       // [2][kAttTile][LD]
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kAttRows;
  const int S = a.S, dh = a.dh;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int t = lane & 3;
  const int ntiles = (S + kAttTile - 1) / kAttTile, steps = 2 * ntiles;

  {
    TileRegs<kAttRows, DP, kAttThreads> rq;
    fetch_rows(rq, a.q, b, h, q0, S, dh, a.bf, a.vec);
    rq.store(Qs, LD);
  }
  TileRegs<kAttTile, DP, kAttThreads> rk, rv;
  fetch_rows(rk, a.k, b, h, 0, S, dh, a.bf, a.vec);
  rk.store(Ks, LD);
  __syncthreads();

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv[2];
  const bf16* Qw = Qs + warp * 16 * LD;

  for (int it = 0; it < steps; ++it) {
    const int cur = it & 1, next = it + 1;
    if (next < steps) {  // v only for the second sweep
      fetch_rows(rk, a.k, b, h, next % ntiles * kAttTile, S, dh, a.bf, a.vec);
      if (next >= ntiles) fetch_rows(rv, a.v, b, h, next % ntiles * kAttTile, S, dh, a.bf, a.vec);
    }
    const bf16* Kt = Ks + cur * kAttTile * LD;
    const bf16* Vt = Vs + cur * kAttTile * LD;
    float s[kKT][4];
    mma_rows_bt<DP>(Qw, Kt, lane, s);
    scale_mask(s, (it % ntiles) * kAttTile, S, t, a.scale_log2);
    if (it < ntiles) {  // sweep 1: the online statistics
      float alpha[2];
      update_max(s, m, alpha);
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] *= alpha[r];
#pragma unroll
      for (int n = 0; n < kKT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) l[e >> 1] += exp2f(s[n][e] - m[e >> 1]);
      if (it == ntiles - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) inv[r] = 1.0f / quad_sum(l[r]);
      }
    } else {  // sweep 2: o += A v, A normalised before its rounding
#pragma unroll
      for (int n = 0; n < kKT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = exp2f(s[n][e] - m[e >> 1]) * inv[e >> 1];
      mma_acc_rows<DP>(s, Vt, lane, o);
    }
    if (next < steps) {  // the other buffer: its last readers passed the barrier
      rk.store(Ks + (cur ^ 1) * kAttTile * LD, LD);
      if (next >= ntiles) rv.store(Vs + (cur ^ 1) * kAttTile * LD, LD);
    }
    __syncthreads();
  }
  store_rows<DP>(a.out, head_at(a.so, b, h), a.so.s, a.bf, o, q0 + warp * 16, lane, S, dh);
}

struct BwdBf16Args {
  Operand q, k, v, dout;
  const float* r;
  void *dq, *dk, *dv;
  Strides sdq, sdk, sdv;
  float *stats, *e_part, *e_row;
  int B, S, H, dh;
  float scale_log2, scale;
  bool bf, vec;
};

// The q pass: one block per (64-query tile, head, image), each warp 16
// query rows, two sweeps over the 32-key tiles (tile it % ntiles). Sweep 1:
// s = q k^T and dA = dout v^T, the online row max m, sum l and
// u = sum_j 2^(s_j - m) dA_j (log2 domain, rescaled together); dsum = u / l.
// Sweep 2: s and dA again, ds = A (dA - dsum) scale, dq += ds k. Writes dq
// and stats[0..2] = (m, 1/l, dsum) per row (planes of B * H * S).
template <int DP>
__global__ void __launch_bounds__(kAttThreads, DP <= 64 ? 3 : 1)
attn_bwd_q_bf16_kernel(BwdBf16Args a) {
  constexpr int LD = DP + 8, NT = DP / 8;
  extern __shared__ __align__(16) bf16 bwd16_sm[];
  bf16* Qs = bwd16_sm;                     // [kAttRows][LD]
  bf16* Os = Qs + kAttRows * LD;           // [kAttRows][LD]  dout rows
  bf16* Ks = Os + kAttRows * LD;           // [2][kAttTile][LD]
  bf16* Vs = Ks + 2 * kAttTile * LD;       // [2][kAttTile][LD]
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kAttRows;
  const int S = a.S, dh = a.dh;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int t = lane & 3;
  const int ntiles = (S + kAttTile - 1) / kAttTile, steps = 2 * ntiles;

  {
    TileRegs<kAttRows, DP, kAttThreads> rows;
    fetch_rows(rows, a.q, b, h, q0, S, dh, a.bf, a.vec);
    rows.store(Qs, LD);
    fetch_rows(rows, a.dout, b, h, q0, S, dh, a.bf, a.vec);
    rows.store(Os, LD);
  }
  TileRegs<kAttTile, DP, kAttThreads> rk, rv;
  fetch_rows(rk, a.k, b, h, 0, S, dh, a.bf, a.vec);
  fetch_rows(rv, a.v, b, h, 0, S, dh, a.bf, a.vec);
  rk.store(Ks, LD);
  rv.store(Vs, LD);
  __syncthreads();

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};  // this lane's parts of l, u
  float inv[2], dsum[2];
  const bf16* Qw = Qs + warp * 16 * LD;
  const bf16* Ow = Os + warp * 16 * LD;

  for (int it = 0; it < steps; ++it) {
    const int cur = it & 1, next = it + 1;
    if (next < steps) {
      fetch_rows(rk, a.k, b, h, next % ntiles * kAttTile, S, dh, a.bf, a.vec);
      fetch_rows(rv, a.v, b, h, next % ntiles * kAttTile, S, dh, a.bf, a.vec);
    }
    const bf16* Kt = Ks + cur * kAttTile * LD;
    const bf16* Vt = Vs + cur * kAttTile * LD;
    float s[kKT][4], g[kKT][4];
    mma_rows_bt<DP>(Qw, Kt, lane, s);
    mma_rows_bt<DP>(Ow, Vt, lane, g);
    scale_mask(s, (it % ntiles) * kAttTile, S, t, a.scale_log2);
    if (it < ntiles) {  // sweep 1: the online statistics
      float alpha[2];
      update_max(s, m, alpha);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] *= alpha[r];
        u[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < kKT; ++n) {
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
          inv[r] = 1.0f / quad_sum(l[r]);
          dsum[r] = quad_sum(u[r]) * inv[r];
        }
      }
    } else {  // sweep 2: ds = A (dA - dsum) scale, then dq += ds k
#pragma unroll
      for (int n = 0; n < kKT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[n][e] - m[e >> 1]) * inv[e >> 1];
          g[n][e] = p * (g[n][e] - dsum[e >> 1]) * a.scale;
        }
      }
      mma_acc_rows<DP>(g, Kt, lane, acc);
    }
    if (next < steps) {
      rk.store(Ks + (cur ^ 1) * kAttTile * LD, LD);
      rv.store(Vs + (cur ^ 1) * kAttTile * LD, LD);
    }
    __syncthreads();
  }

  store_rows<DP>(a.dq, head_at(a.sdq, b, h), a.sdq.s, a.bf, acc, q0 + warp * 16, lane, S, dh);
  if (t == 0) {
    const int row = q0 + warp * 16 + (lane >> 2);
    const size_t plane = (size_t)a.B * a.H * S, base = ((size_t)b * a.H + h) * S;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row + 8 * r;
      if (i >= S) continue;
      a.stats[base + i] = m[r];
      a.stats[plane + base + i] = inv[r];
      a.stats[2 * plane + base + i] = dsum[r];
    }
  }
}

// The kv pass: one block per (64-key tile, head, image), each warp 16 keys;
// K and V rows stay in shared memory while 32-query tiles of q, dout and
// their (m, 1/l, dsum, r) stream through. Per tile: s^T = k q^T,
// dA^T = v dout^T, A^T = 2^(s^T - m) / l, the fold e += r_q relu(A^T dA^T),
// ds^T = A^T (dA^T - dsum) scale, then dv += A^T dout and dk += ds^T q.
// Queries at or past S get 1/l = 0 and r = 0. Past DP = 80 the pass sweeps
// the query tiles twice, dv alone first, so one accumulator is live at a
// time (as attn_block.cu's kv pass, for the same register budget).
template <int DP>
__global__ void __launch_bounds__(kAttThreads, 2)
attn_bwd_kv_bf16_kernel(BwdBf16Args a) {
  constexpr int LD = DP + 8, NT = DP / 8;
  constexpr bool TWO = DP > 80;
  extern __shared__ __align__(16) bf16 bwd16_sm[];
  bf16* Ks = bwd16_sm;                     // [kAttRows][LD]
  bf16* Vs = Ks + kAttRows * LD;           // [kAttRows][LD]
  bf16* Qs = Vs + kAttRows * LD;           // [2][kAttTile][LD]
  bf16* Os = Qs + 2 * kAttTile * LD;       // [2][kAttTile][LD]
  float* Ts = reinterpret_cast<float*>(Os + 2 * kAttTile * LD);  // [2][4][kAttTile]
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kAttRows;
  const int S = a.S, dh = a.dh;
  const size_t plane = (size_t)a.B * a.H * S, base = ((size_t)b * a.H + h) * S;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int t = lane & 3;
  const int ntiles = (S + kAttTile - 1) / kAttTile, steps = (TWO ? 2 : 1) * ntiles;

  // one statistic per thread: m, 1/l, dsum of the q pass, then r
  static_assert(kAttThreads == 4 * kAttTile, "one value per thread");
  const int which = threadIdx.x / kAttTile, qi = threadIdx.x % kAttTile;
  auto fetch_stat = [&](int q0) -> float {
    if (q0 + qi >= S) return 0.f;
    return which < 3 ? a.stats[which * plane + base + q0 + qi] : a.r[(size_t)b * S + q0 + qi];
  };

  {
    TileRegs<kAttRows, DP, kAttThreads> rows;
    fetch_rows(rows, a.k, b, h, k0, S, dh, a.bf, a.vec);
    rows.store(Ks, LD);
    fetch_rows(rows, a.v, b, h, k0, S, dh, a.bf, a.vec);
    rows.store(Vs, LD);
  }
  TileRegs<kAttTile, DP, kAttThreads> rq, ro;
  fetch_rows(rq, a.q, b, h, 0, S, dh, a.bf, a.vec);
  fetch_rows(ro, a.dout, b, h, 0, S, dh, a.bf, a.vec);
  rq.store(Qs, LD);
  ro.store(Os, LD);
  Ts[threadIdx.x] = fetch_stat(0);
  __syncthreads();

  // Per lane: keys g and g + 8 of the warp's 16 (index 0 and 1 below).
  // ak: dk, or dv in the first of two sweeps; av: dv (one sweep only).
  float ak[NT][4], av[TWO ? 1 : NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) ak[n][0] = ak[n][1] = ak[n][2] = ak[n][3] = 0.f;
  if constexpr (!TWO) {
#pragma unroll
    for (int n = 0; n < NT; ++n) av[n][0] = av[n][1] = av[n][2] = av[n][3] = 0.f;
  }
  float fold[2] = {0.f, 0.f};  // this lane's part of sum_q r_q relu(A dA)
  const int key = k0 + warp * 16 + (lane >> 2);
  const bool key_ok[2] = {key < S, key + 8 < S};
  const bf16* Kw = Ks + warp * 16 * LD;
  const bf16* Vw = Vs + warp * 16 * LD;

  // The next tile's reads are issued before this tile's products where the
  // registers allow (DP <= 80); past that, after them: staged through the
  // products, the two 32-row tiles spilled at DP = 112 and 128.
  const auto fetch_next = [&](int it, float& stat) {
    if (it + 1 < steps) {
      const int nq = (it + 1) % ntiles * kAttTile;
      fetch_rows(rq, a.q, b, h, nq, S, dh, a.bf, a.vec);
      fetch_rows(ro, a.dout, b, h, nq, S, dh, a.bf, a.vec);
      stat = fetch_stat(nq);
    }
  };
  for (int it = 0; it < steps; ++it) {
    const int cur = it & 1, next = it + 1;
    float stat = 0.f;
    if constexpr (!TWO) fetch_next(it, stat);
    const bf16* Qt = Qs + cur * kAttTile * LD;
    const bf16* Ot = Os + cur * kAttTile * LD;
    const float* T = Ts + cur * 4 * kAttTile;
    const bool dv_only = TWO && it < ntiles;
    float s[kKT][4], g[kKT][4];
    mma_rows_bt<DP>(Kw, Qt, lane, s);
    if (!dv_only) mma_rows_bt<DP>(Vw, Ot, lane, g);
#pragma unroll
    for (int n = 0; n < kKT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // query column n * 8 + 2t + (e & 1)
        const int c = n * 8 + 2 * t + (e & 1);
        const float p =
            key_ok[e >> 1] ? exp2f(s[n][e] * a.scale_log2 - T[c]) * T[kAttTile + c] : 0.f;
        if (!dv_only) {
          fold[e >> 1] += fmaxf(p * g[n][e], 0.f) * T[3 * kAttTile + c];
          g[n][e] = p * (g[n][e] - T[2 * kAttTile + c]) * a.scale;
        }
        s[n][e] = p;
      }
    }
    if constexpr (TWO) {
      if (dv_only) {
        mma_acc_rows<DP>(s, Ot, lane, ak);
        if (it == ntiles - 1) {  // dv done: the registers take dk next
          store_rows<DP>(a.dv, head_at(a.sdv, b, h), a.sdv.s, a.bf, ak, k0 + warp * 16, lane, S,
                         dh);
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
    if constexpr (TWO) fetch_next(it, stat);
    if (next < steps) {
      rq.store(Qs + (cur ^ 1) * kAttTile * LD, LD);
      ro.store(Os + (cur ^ 1) * kAttTile * LD, LD);
      Ts[(cur ^ 1) * 4 * kAttTile + threadIdx.x] = stat;
    }
    __syncthreads();
  }

  store_rows<DP>(a.dk, head_at(a.sdk, b, h), a.sdk.s, a.bf, ak, k0 + warp * 16, lane, S, dh);
  if constexpr (!TWO)
    store_rows<DP>(a.dv, head_at(a.sdv, b, h), a.sdv.s, a.bf, av, k0 + warp * 16, lane, S, dh);
#pragma unroll
  for (int r = 0; r < 2; ++r) fold[r] = quad_sum(fold[r]);  // fixed order over 4 lanes
  if (t == 0) {
    if (key_ok[0]) a.e_part[base + key] = fold[0];
    if (key_ok[1]) a.e_part[base + key + 8] = fold[1];
  }
}

// dh rounded up to the m16n8k16 product's 16-deep steps.
int att_dp16(int dh) { return (dh + 15) / 16 * 16; }

size_t fwd16_smem(int dh) {
  return sizeof(bf16) * (size_t)(kAttRows + 4 * kAttTile) * (att_dp16(dh) + 8);
}

size_t bwd16_smem(int dh) {
  return sizeof(bf16) * (size_t)(2 * kAttRows + 4 * kAttTile) * (att_dp16(dh) + 8) +
         sizeof(float) * 2 * 4 * kAttTile;
}

// Launches attn_fwd_bf16_kernel<DP> for DP = att_dp16(dh), found by walking
// the 8 instantiations DP = 16, 32, ..., kMaxDh.
template <int DP>
cudaError_t launch_fwd16(const FwdBf16Args& a, int B, int H, cudaStream_t stream) {
  if constexpr (DP > kMaxDh) {
    return cudaErrorInvalidValue;
  } else {
    if (att_dp16(a.dh) != DP) return launch_fwd16<DP + 16>(a, B, H, stream);
    const size_t smem = fwd16_smem(a.dh);
    const cudaError_t err = allow_smem(attn_fwd_bf16_kernel<DP>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.S + kAttRows - 1) / kAttRows, H, B);
    attn_fwd_bf16_kernel<DP><<<grid, kAttThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
}

template <int DP>
cudaError_t launch_bwd16(const BwdBf16Args& a, cudaStream_t stream) {
  if constexpr (DP > kMaxDh) {
    return cudaErrorInvalidValue;
  } else {
    if (att_dp16(a.dh) != DP) return launch_bwd16<DP + 16>(a, stream);
    const size_t smem = bwd16_smem(a.dh);
    cudaError_t err = allow_smem(attn_bwd_q_bf16_kernel<DP>, smem);
    if (err == cudaSuccess) err = allow_smem(attn_bwd_kv_bf16_kernel<DP>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.S + kAttRows - 1) / kAttRows, a.H, a.B);
    attn_bwd_q_bf16_kernel<DP><<<grid, kAttThreads, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    attn_bwd_kv_bf16_kernel<DP><<<grid, kAttThreads, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    e_row_kernel<<<(a.B * a.S + 255) / 256, 256, 0, stream>>>(a.e_part, a.e_row, a.B, a.S, a.H);
    return cudaGetLastError();
  }
}

// Every row of every head starts on a 4-element boundary: the 4-wide loads
// of TileRegs (16 bytes of fp32, 8 of bf16).
bool rows_aligned4(const void* p, const Strides& s, bool bf) {
  return aligned(p, bf ? 8 : 16) && s.b % 4 == 0 && s.h % 4 == 0 && s.s % 4 == 0;
}

Strides strides_at(const long long* s, int i) {
  return {s[3 * i], s[3 * i + 1], (int)s[3 * i + 2]};
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes). Every entry point launches on the given
// stream, never synchronises, and returns cudaGetLastError(). `bf` (or the
// dtypes bits of the GEMM) says which tensors are bf16; the others are fp32.
// ---------------------------------------------------------------------------

extern "C" {

const char* tmx_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int tmx_max_dh() { return kMaxDh; }

int tmx_smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

// x, gamma, beta: [M, D], [D], [D], bf16 where bf else fp32; y: [M, D] bf16.
int tmx_layer_norm_bf16(const void* x, const void* gamma, const void* beta, void* y,
                        float* mean, float* rstd, int M, int D, float eps, int bf,
                        void* stream) {
  const int rows = kRowThreads / kWarp;
  const dim3 grid((M + rows - 1) / rows);
  if (bf)
    ln_fwd_bf16_kernel<bf16><<<grid, kRowThreads, 0, (cudaStream_t)stream>>>(
        (const bf16*)x, (const bf16*)gamma, (const bf16*)beta, (bf16*)y, mean, rstd, M, D, eps);
  else
    ln_fwd_bf16_kernel<float><<<grid, kRowThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)gamma, (const float*)beta, (bf16*)y, mean, rstd, M, D,
        eps);
  return (int)cudaGetLastError();
}

// dy: [M, D] fp32; x, gamma, cot, out: bf16 where bf else fp32.
int tmx_layer_norm_vjp_any(const float* dy, const void* x, const float* mean, const float* rstd,
                           const void* gamma, const void* cot, void* out, int M, int D, int bf,
                           void* stream) {
  const int rows = kRowThreads / kWarp;
  const dim3 grid((M + rows - 1) / rows);
  if (bf)
    ln_vjp_any_kernel<bf16><<<grid, kRowThreads, 0, (cudaStream_t)stream>>>(
        dy, (const bf16*)x, mean, rstd, (const bf16*)gamma, (const bf16*)cot, (bf16*)out, M, D);
  else
    ln_vjp_any_kernel<float><<<grid, kRowThreads, 0, (cudaStream_t)stream>>>(
        dy, (const float*)x, mean, rstd, (const float*)gamma, (const float*)cot, (float*)out, M,
        D);
  return (int)cudaGetLastError();
}

// C = epilogue(A op(B)) with bf16 products for `batch` products
// (gemm_bf16.cuh gemm_bf16): A [M, K], B [K, N] or, with trans_b, [N, K];
// bias [N] or null; res [M, N] or null; aux [M, N] fp32 or null; act: an
// Act; dtypes: Bf16Operand bits. bsA, bsB, bsC: element batch strides.
// Every row of A and B starts on a 16-byte boundary (cudaErrorMisalignedAddress
// otherwise: ops/attn_block._gemm_bf16 copies such operands first).
int tmx_gemm_bf16(const void* A, const void* B, void* C, int M, int N, int K, int trans_b,
                  const void* bias, const void* res, const float* aux, int act, int dtypes,
                  int batch, long long bsA, long long bsB, long long bsC, void* stream) {
  const GemmBf16Args p = {A, B, C, bias, res, aux, bsA, bsB, bsC, M, N, K, act, dtypes};
  return (int)gemm_bf16(p, trans_b != 0, batch, (cudaStream_t)stream);
}

// The GEMM's tile width for an M x N grid of `batch` products (the
// launcher's table), after tmx_gemm_bf16_force_tile.
int tmx_gemm_bf16_tile(int M, int N, int batch) { return gemm_bf16_tile_n(M, N, batch); }

// Makes every later call take tile width bn (64 or 128), or the table
// again with 0: for measuring the table's entries. Returns the width set.
int tmx_gemm_bf16_force_tile(int bn) {
  g16_forced_tile_n = bn == 64 || bn == 128 ? bn : 0;
  return g16_forced_tile_n;
}

// x: n fp32 values; y: n bf16, x rounded to nearest even.
int tmx_round_bf16(const float* x, void* y, long long n, void* stream) {
  return (int)round_bf16(x, static_cast<bf16*>(y), n, (cudaStream_t)stream);
}

// Bytes of dynamic shared memory one attention block needs (fixed by dh).
int tmx_attn_smem_bf16(int S, int dh, int backward) {
  (void)S;
  return (int)(backward ? bwd16_smem(dh) : fwd16_smem(dh));
}

// q, k, v, out: [B, H, S, dh] operands, bf16 where bf else fp32; strides:
// [4][3] (batch, head, row) element strides of q, k, v, out in that order.
int tmx_attn_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                      const long long* strides, int B, int S, int H, int dh, float scale, int bf,
                      void* stream) {
  FwdBf16Args a;
  a.q = {q, strides_at(strides, 0)};
  a.k = {k, strides_at(strides, 1)};
  a.v = {v, strides_at(strides, 2)};
  a.out = out;
  a.so = strides_at(strides, 3);
  a.S = S;
  a.dh = dh;
  a.scale_log2 = scale * 1.4426950408889634f;
  a.bf = bf != 0;
  a.vec = dh % 4 == 0 && rows_aligned4(q, a.q.st, a.bf) && rows_aligned4(k, a.k.st, a.bf) &&
          rows_aligned4(v, a.v.st, a.bf);
  return (int)launch_fwd16<16>(a, B, H, (cudaStream_t)stream);
}

// q, k, v, dout in and dq, dk, dv out: [B, H, S, dh] operands, bf16 where
// bf else fp32; strides: [7][3] (batch, head, row) element strides of q, k,
// v, dout, dq, dk, dv in that order. r, e_row: [B, S] fp32; stats: scratch
// [3, B, H, S]; e_part: scratch [B, H, S].
int tmx_attn_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                      const float* r, void* dq, void* dk, void* dv, float* stats, float* e_part,
                      float* e_row, const long long* strides, int B, int S, int H, int dh,
                      float scale, int bf, void* stream) {
  BwdBf16Args a;
  a.q = {q, strides_at(strides, 0)};
  a.k = {k, strides_at(strides, 1)};
  a.v = {v, strides_at(strides, 2)};
  a.dout = {dout, strides_at(strides, 3)};
  a.r = r;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.sdq = strides_at(strides, 4);
  a.sdk = strides_at(strides, 5);
  a.sdv = strides_at(strides, 6);
  a.stats = stats;
  a.e_part = e_part;
  a.e_row = e_row;
  a.B = B;
  a.S = S;
  a.H = H;
  a.dh = dh;
  a.scale_log2 = scale * 1.4426950408889634f;
  a.scale = scale;
  a.bf = bf != 0;
  a.vec = dh % 4 == 0 && rows_aligned4(q, a.q.st, a.bf) && rows_aligned4(k, a.k.st, a.bf) &&
          rows_aligned4(v, a.v.st, a.bf) && rows_aligned4(dout, a.dout.st, a.bf);
  return (int)launch_bwd16<16>(a, (cudaStream_t)stream);
}

}  // extern "C"
