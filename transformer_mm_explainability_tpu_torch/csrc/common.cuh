// The fp32 GEMM on the tensor cores (3xTF32) and the GELU of its epilogue,
// shared by the port's CUDA sources (gemm_bf16.cuh builds its bf16-product
// variant of the fast_dots mode on them), and the loads and stores through
// which the fp32-product kernels read and write bf16 storage.
//
// Each csrc/<name>.cu is built on its own into one shared library (one
// translation unit), so everything here has internal linkage. ops/_build.py
// hashes this header with every source, so a change here rebuilds them all.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16 storage under fp32 products. A bf16 value is exact in fp32 (and in
// TF32: the lo part of its 3xTF32 split is 0), so a kernel that reads bf16,
// widens it and then runs its fp32 arithmetic unchanged computes, bit for
// bit, what it computes on the widened tensors; an output is rounded to
// bf16 once, to nearest even. cp.async copies raw bytes, so a bf16 tile is
// staged through registers instead: read, widened, stored to the same fp32
// shared-memory tile the fp32 path fills, so every fragment loader and
// product is the fp32 path's own.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float f32_of(float v) { return v; }
__device__ __forceinline__ float f32_of(bf16 v) { return __bfloat162float(v); }

// Stores v in a float, or in a bf16 rounded to nearest even.
__device__ __forceinline__ void put_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void put_f32(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// One copy of a tile loader into an fp32 shared-memory tile from bf16 at
// `from`: with VEC 8 elements (16 bytes, 16-byte aligned) into to[0..7],
// else one; zeros where !ok. The fp32 counterpart is cp_async16 / cp_async4.
template <bool VEC>
__device__ __forceinline__ void stage_bf16(float* to, const bf16* from, bool ok) {
  if constexpr (VEC) {
    uint4 u = make_uint4(0u, 0u, 0u, 0u);  // bf16 zeros
    if (ok) u = __ldg(reinterpret_cast<const uint4*>(from));
    const float2 a = widen_bf16x2(u.x), b = widen_bf16x2(u.y);
    const float2 c = widen_bf16x2(u.z), d = widen_bf16x2(u.w);
    reinterpret_cast<float4*>(to)[0] = make_float4(a.x, a.y, b.x, b.y);
    reinterpret_cast<float4*>(to)[1] = make_float4(c.x, c.y, d.x, d.y);
  } else {
    *to = ok ? __bfloat162float(*from) : 0.f;
  }
}

// Two neighbouring elements (i even, 8-byte aligned for fp32, 4-byte for
// bf16) of a tensor stored as fp32 or bf16 (bf), as fp32; and the store.
__device__ __forceinline__ float2 load_pair(const void* p, long long i, bool bf) {
  if (bf) return widen_bf16x2(*reinterpret_cast<const uint32_t*>(static_cast<const bf16*>(p) + i));
  return *reinterpret_cast<const float2*>(static_cast<const float*>(p) + i);
}

__device__ __forceinline__ void store_pair(void* p, long long i, float v0, float v1, bool bf) {
  if (bf)
    *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p) + i) = pack_bf16(v0, v1);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(p) + i) = make_float2(v0, v1);
}

// Exact (erf) GELU and its derivative Phi(x) + x*phi(x). CUDA's erff is the
// exact function to fp32 rounding, so the rational erf the TPU kernels need
// (Mosaic has no erf) is not carried over.
__device__ __forceinline__ float gelu_f(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_grad_f(float x) {
  const float cdf = 0.5f * (1.0f + erff(x * 0.70710678118654752f));
  const float pdf = expf(-0.5f * x * x) * 0.39894228040143268f;
  return cdf + x * pdf;
}

// Sets the dynamic shared-memory limit a launch needs (above the 48 KB
// default); the launch itself reports a size the card cannot give.
template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

// ---------------------------------------------------------------------------
// GEMM: C = epilogue(A @ op(B)), op(B) = B[K,N] or B[N,K]^T, any M, N, K >= 1;
// A, B and C row-major with rows of K, N (or K) and N elements, each of A,
// B, C, bias and res stored as fp32 or bf16 (GemmArgs::dtypes; aux fp32). One product
// per z = blockIdx.z, operands offset by z times their batch strides
// (elements; a single product has z = 0); bias is [N], res and aux share
// C's layout and batch stride. The epilogue, per element: + bias, then
// GELU, or * GELU'(aux), then + res. aux may be C itself: the thread that
// writes C[m,n] is the one that read aux[m,n], and no other reads it.
//
// It runs on the tensor cores as 3xTF32 mma.sync (mma_tf32.cuh), which
// holds an fp32 product to a few ulps where a single TF32 product keeps
// about three decimal digits. The products of the block branches (7.2
// GFLOP per image and layer at ViT-B) are bound by operations, and the
// fp32 CUDA cores (67 TFLOP/s) are a seventh of the TF32 rate (495, three
// products each). The design:
//   - a 64 x 64 output tile per block of 4 warps, each warp 32 x 32 (2 x 4
//     m16n8 accumulators); 32-deep k slices in a three-stage cp.async ring,
//     two slices in flight while one is multiplied. Bigger tiles (128 x
//     128, 128 x 64, 64 x 128) were slower over the main path's shapes
//     (PERF.md): the 768-wide outputs at M = 1576 make 78 tiles of 128 x 128
//     for 132 SMs, and the bigger warp tiles cost registers and so blocks
//     in flight. Where the grid has no more tiles than the card has SMs
//     (the chain's 197 x 197 planes at B = 8: 128 tiles), a block of 8
//     warps of 32 x 16 keeps twice the warps in flight (gemm_warps);
//   - every operand split into hi/lo as its fragment is read (split_tf32_fast;
//     the A and B^T fragments through ldmatrix). Splitting whole tiles once
//     per stage into hi/lo planes was slower: it trades split instructions
//     for twice the shared-memory reads and another barrier per stage;
//   - summed over all of k in one mma accumulator, a product drifts from
//     float64 as k grows (1.1-2.4e-5 of max|C| at k = 1576-3072 on the H100,
//     where fp32 sums stay near 1e-6): the tensor cores' fp32 accumulation
//     loses more than rounding to nearest does. So each 32-deep slice is
//     summed into a fresh accumulator d (lo*hi, then hi*lo, then hi*hi: one
//     round of independent mma at a time) and d is added to acc in fp32;
//   - shared-memory rows padded so that every fragment load hits 32 banks:
//     A and B^T tiles [rows][32 + 4] (ld % 8 == 4), B[K,N] tiles
//     [32][64 + 8] (ld % 32 == 8);
//   - tails zero-filled in shared memory (exact in the product), so every
//     M, N, K runs; 16-byte copies where every row of A and B starts on a
//     16-byte boundary, else 4-byte copies (the VEC flag, picked by the
//     caller). The shared-memory contents, and so the bits, are the same;
//   - the epilogue straight from the accumulator registers to global
//     memory, two neighbouring columns at a time (8-byte accesses where N
//     is even and the pointers allow);
//   - each output element is summed by one thread in a fixed k order, with
//     no split over k and no atomics: the same bits on every run;
//   - bf16 storage: a bf16 A or B is read through registers into the
//     same fp32 tiles (stage_bf16; a 16-byte copy carries 8 elements, so
//     VEC asks for rows of whole 8-element groups), a bf16 bias or res is
//     widened in the epilogue and a bf16 C rounded there once. The products
//     and their order are the fp32 path's, so the result is the fp32
//     kernel's on the widened tensors, rounded once. Those instances
//     (gemm<true>) are compiled in gemm_s16.cu.
// The one template choice is the warps' layout, WN = 2 or 4 columns of warps
// (gemm_warps); TRANS_B and VEC pick the loaders, TA and TB the operands'
// storage, ANY16 whether the epilogue reads GemmArgs::dtypes (false: all
// fp32, gemm_tc_kernel, the fp32 path's own code; true: gemm_tc_s16_kernel).
// ---------------------------------------------------------------------------

enum Act { kActNone = 0, kActGelu = 1, kActMulGeluGrad = 2 };

// the bits of GemmArgs::dtypes and of gemm_bf16.cuh's GemmBf16Args::dtypes
// (ops/attn_block.py _BF16_BITS): which tensors are bf16
enum Bf16Operand { kBf16A = 1, kBf16B = 2, kBf16C = 4, kBf16Bias = 8, kBf16Res = 16 };

struct GemmArgs {
  const void* A;
  const void* B;
  void* C;
  const void* bias;
  const void* res;
  const float* aux;
  long long bsA, bsB, bsC;
  int M, N, K, act;
  int dtypes;  // Bf16Operand bits; the others fp32
  bool pair;   // N even; C, bias, res, aux 8-byte aligned: paired epilogue
};

constexpr int kGemmBM = 64, kGemmBN = 64;  // output tile per block
constexpr int kGemmWM = 2;                   // rows of warps
constexpr int kGemmBK = 32;                  // k per stage
constexpr int kGemmST = 3;                   // cp.async stages
constexpr int kGemmFlush = 4;                // k8 steps per fresh accumulator
constexpr int kGemmLdK = kGemmBK + 4;        // A and B^T tile rows (k values)
constexpr int kGemmLdN = kGemmBN + 8;        // B[K,N] tile rows (n values)

template <bool TRANS_B>
constexpr size_t gemm_smem() {
  return sizeof(float) * kGemmST *
         (kGemmBM * kGemmLdK + (TRANS_B ? kGemmBN * kGemmLdK : kGemmBK * kGemmLdN));
}

// Copies the ROWS x COLS tile at src (row stride ld) into the fp32 tile dst
// (row stride LD) with cp.async, or through registers (stage_bf16) for a
// bf16 src; elements at or past rows_valid / cols_valid become 0. With VEC,
// cols_valid is a multiple of a copy's elements, 4 or 8 (checked before
// launch).
template <int ROWS, int COLS, int LD, int THREADS, bool VEC, typename T>
__device__ __forceinline__ void gemm_load_tile(float* dst, const T* src, int ld,
                                               int rows_valid, int cols_valid) {
  constexpr int W = VEC ? 16 / (int)sizeof(T) : 1;  // elements per copy
  constexpr int PER_ROW = COLS / W;
  static_assert(ROWS * PER_ROW % THREADS == 0, "tile/thread mismatch");
#pragma unroll
  for (int i = 0; i < ROWS * PER_ROW / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / PER_ROW, c = (e % PER_ROW) * W;
    float* to = dst + r * LD + c;
    const bool ok = r < rows_valid && c < cols_valid;
    const T* from = src + (long long)r * ld + c;
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

// v + bias, then the activation, then + res: one output element. res is
// at the product's offset; with ANY16 bias and res may be bf16.
template <bool ANY16>
__device__ __forceinline__ float gemm_epilogue(float v, const GemmArgs& p, long long idx,
                                               int n, const void* res, const float* aux) {
  if (p.bias) v += load_any(p.bias, n, ANY16 && (p.dtypes & kBf16Bias));
  if (p.act == kActGelu) v = gelu_f(v);
  if (p.act == kActMulGeluGrad) v *= gelu_grad_f(aux[idx]);
  if (res) v += load_any(res, idx, ANY16 && (p.dtypes & kBf16Res));
  return v;
}

template <int WN, bool TRANS_B, bool VEC, typename TA, typename TB, bool ANY16>
__device__ __forceinline__ void gemm_tc_body(const GemmArgs& p) {
  constexpr int BM = kGemmBM, BN = kGemmBN, WM = kGemmWM, ST = kGemmST;
  constexpr int FLUSH = kGemmFlush;
  constexpr int THREADS = 32 * WM * WN;
  constexpr int TM = BM / WM, TN = BN / WN;  // warp tile
  constexpr int MT = TM / 16, NT = TN / 8;   // m16 / n8 fragments per warp
  constexpr int BK = kGemmBK, LDK = kGemmLdK, LDN = kGemmLdN;
  constexpr int A_TILE = BM * LDK;
  constexpr int B_TILE = TRANS_B ? BN * LDK : BK * LDN;
  static_assert(TM % 16 == 0 && NT % 2 == 0, "warp tile must be m16 x n16 fragments");
  static_assert((BK / 8) % FLUSH == 0, "FLUSH must divide the k8 steps of a stage");

  extern __shared__ __align__(16) float smem[];
  float* As = smem;                // [ST][BM][LDK]
  float* Bs = smem + ST * A_TILE;  // [ST][BN][LDK] (B^T) or [ST][BK][LDN]

  const long long z = blockIdx.z;
  const int M = p.M, N = p.N, K = p.K;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const TA* Ab = static_cast<const TA*>(p.A) + z * p.bsA + (long long)m0 * K;
  const TB* Bb =
      static_cast<const TB*>(p.B) + z * p.bsB + (TRANS_B ? (long long)n0 * K : (long long)n0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WN, wn = warp % WN;

  auto load = [&](int stage, int k0) {
    gemm_load_tile<BM, BK, LDK, THREADS, VEC>(As + stage * A_TILE, Ab + k0, K, M - m0,
                                              K - k0);
    if constexpr (TRANS_B)
      gemm_load_tile<BN, BK, LDK, THREADS, VEC>(Bs + stage * B_TILE, Bb + k0, K, N - n0,
                                                K - k0);
    else
      gemm_load_tile<BK, BN, LDN, THREADS, VEC>(Bs + stage * B_TILE,
                                                Bb + (long long)k0 * N, N, K - k0, N - n0);
  };

  float acc[MT][NT][4], d[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < KT) load(s, s * BK);
    cp_async_commit();  // one group per slice, empty past the last
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<ST - 2>();  // slice kt has landed (this thread's copies)
    __syncthreads();          // everyone's; and slice kt - 1 is consumed
    if (kt + ST - 1 < KT) load((kt + ST - 1) % ST, (kt + ST - 1) * BK);
    cp_async_commit();
    const float* a = As + (kt % ST) * A_TILE + wm * TM * LDK;
    const float* b = Bs + (kt % ST) * B_TILE + (TRANS_B ? wn * TN * LDK : wn * TN);
#pragma unroll
    for (int step = 0; step < BK / 8; ++step) {
      const int kk = step * 8;
      uint32_t a_hi[MT][4], a_lo[MT][4], b_hi[NT][2], b_lo[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        load_a_ldsm_3x(a + i * 16 * LDK + kk, LDK, lane, a_hi[i], a_lo[i]);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        if constexpr (TRANS_B) {
          load_bt2_ldsm_3x(b + j * 8 * LDK + kk, LDK, lane, b_hi + j, b_lo + j);
        } else {
          load_b_3x(b + kk * LDN + j * 8, LDN, lane, b_hi[j], b_lo[j]);
          load_b_3x(b + kk * LDN + j * 8 + 8, LDN, lane, b_hi[j + 1], b_lo[j + 1]);
        }
      }
      // lo*hi + hi*lo + hi*hi, one round of independent mma at a time,
      // into d; d is added to acc in fp32 every FLUSH steps (see above)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (step % FLUSH == 0)
            mma_tf32_zero(d[i][j], a_lo[i], b_hi[j]);
          else
            mma_tf32(d[i][j], a_lo[i], b_hi[j]);
        }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(d[i][j], a_hi[i], b_lo[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(d[i][j], a_hi[i], b_hi[j]);
      if (step % FLUSH == FLUSH - 1) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += d[i][j][e];
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: c0, c1 at (row g, columns 2t, 2t + 1); c2, c3 at row g + 8.
  // Offsets in elements from the product's C, res and aux.
  const int g = lane >> 2, t = lane & 3;
  const bool c16 = ANY16 && (p.dtypes & kBf16C), bias16 = ANY16 && (p.dtypes & kBf16Bias);
  const bool res16 = ANY16 && (p.dtypes & kBf16Res);
  void* C = c16 ? (void*)(static_cast<bf16*>(p.C) + z * p.bsC)
                : (void*)(static_cast<float*>(p.C) + z * p.bsC);
  const void* res = !p.res ? nullptr
                    : res16 ? (const void*)(static_cast<const bf16*>(p.res) + z * p.bsC)
                            : (const void*)(static_cast<const float*>(p.res) + z * p.bsC);
  const float* aux = p.aux ? p.aux + z * p.bsC : nullptr;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * TM + i * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + wn * TN + j * 8 + 2 * t;
        if (n >= N) continue;
        const long long idx = (long long)m * N + n;
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (p.pair) {  // n even and N even: n + 1 < N
          if (p.bias) {
            const float2 bb = load_pair(p.bias, n, bias16);
            v0 += bb.x;
            v1 += bb.y;
          }
          if (p.act == kActGelu) {
            v0 = gelu_f(v0);
            v1 = gelu_f(v1);
          } else if (p.act == kActMulGeluGrad) {
            const float2 x = *reinterpret_cast<const float2*>(aux + idx);
            v0 *= gelu_grad_f(x.x);
            v1 *= gelu_grad_f(x.y);
          }
          if (res) {
            const float2 r = load_pair(res, idx, res16);
            v0 += r.x;
            v1 += r.y;
          }
          store_pair(C, idx, v0, v1, c16);
        } else {
          store_any(C, idx, gemm_epilogue<ANY16>(v0, p, idx, n, res, aux), c16);
          if (n + 1 < N)
            store_any(C, idx + 1, gemm_epilogue<ANY16>(v1, p, idx + 1, n + 1, res, aux), c16);
        }
      }
    }
  }
}

// The fp32 GEMM, and its bf16-storage instances (gemm<true>): the same body.
// The second declares one block an SM, so that ptxas may take the registers
// the bf16 staging needs: left to its own target, the 8-warp instance with
// a bf16 A and an fp32 B[K, N] spilled 8 bytes.
template <int WN, bool TRANS_B, bool VEC>
__global__ void __launch_bounds__(32 * kGemmWM * WN) gemm_tc_kernel(GemmArgs p) {
  gemm_tc_body<WN, TRANS_B, VEC, float, float, false>(p);
}

template <int WN, bool TRANS_B, bool VEC, typename TA, typename TB>
__global__ void __launch_bounds__(32 * kGemmWM * WN, 1) gemm_tc_s16_kernel(GemmArgs p) {
  gemm_tc_body<WN, TRANS_B, VEC, TA, TB, true>(p);
}

bool aligned(const void* p, int bytes) { return ((uintptr_t)p & (bytes - 1)) == 0; }

// Warps per 64 x 64 block of a launch: 8 (of 32 x 16) where the grid has no
// more tiles than the card has SMs, so one block per SM; else 4 (of 32 x
// 32), which run more of the block products' tiles at once.
int gemm_warps(int M, int N, int batch) {
  const long long tiles =
      (long long)((M + kGemmBM - 1) / kGemmBM) * ((N + kGemmBN - 1) / kGemmBN) * batch;
  return tiles <= num_sms() ? 8 : 4;
}

template <int WN, bool TRANS_B, bool VEC, typename TA, typename TB, bool ANY16>
auto gemm_kernel() {
  if constexpr (ANY16)
    return gemm_tc_s16_kernel<WN, TRANS_B, VEC, TA, TB>;
  else
    return gemm_tc_kernel<WN, TRANS_B, VEC>;
}

template <int WN, typename TA, typename TB, bool ANY16>
cudaError_t launch_gemm(const GemmArgs& p, bool trans_b, bool vec, int batch,
                        cudaStream_t stream) {
  auto kernel = trans_b ? (vec ? gemm_kernel<WN, true, true, TA, TB, ANY16>()
                               : gemm_kernel<WN, true, false, TA, TB, ANY16>())
                        : (vec ? gemm_kernel<WN, false, true, TA, TB, ANY16>()
                               : gemm_kernel<WN, false, false, TA, TB, ANY16>());
  const size_t smem = trans_b ? gemm_smem<true>() : gemm_smem<false>();
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + kGemmBN - 1) / kGemmBN, (p.M + kGemmBM - 1) / kGemmBM, batch);
  kernel<<<grid, 32 * kGemmWM * WN, smem, stream>>>(p);
  return cudaGetLastError();
}

// The GEMM of every caller. Checks the arguments, sets p.pair and launches
// gemm_tc_kernel for `batch` products. copy_bytes: 16 (every row of A and B
// 16-byte aligned: the pointers, and K, B's row length and the batch
// strides in whole copies of 4 fp32 or 8 bf16 elements; refused otherwise)
// or 4, the width of the cp.async copies (a bf16 operand then takes one
// element a copy). A template, so that a source which includes this header
// without calling it (attn_block_bf16.cu) compiles none of gemm_tc_kernel's
// instantiations; the default, ANY16 = false, launches the fp32-only ones
// and refuses any dtypes bit (gemm_s16.cu's gemm<true> takes those).
template <bool ANY16 = false>
cudaError_t gemm(GemmArgs p, bool trans_b, int batch, int copy_bytes, cudaStream_t stream) {
  if (p.M < 1 || p.N < 1 || p.K < 1 || batch < 1 || batch > 65535 ||
      (p.M + kGemmBM - 1) / kGemmBM > 65535 || (!ANY16 && p.dtypes != 0) ||
      (p.dtypes & ~31) != 0)
    return cudaErrorInvalidValue;
  const bool vec = copy_bytes == 16;
  if (!vec && copy_bytes != 4) return cudaErrorInvalidValue;
  const int per_a = p.dtypes & kBf16A ? 8 : 4, per_b = p.dtypes & kBf16B ? 8 : 4;
  if (vec && !(aligned(p.A, 16) && aligned(p.B, 16) && p.K % per_a == 0 &&
               (trans_b ? p.K : p.N) % per_b == 0 && p.bsA % per_a == 0 &&
               p.bsB % per_b == 0))
    return cudaErrorMisalignedAddress;
  p.pair = p.N % 2 == 0 && p.bsC % 2 == 0 && aligned(p.C, 8) && aligned(p.bias, 8) &&
           aligned(p.res, 8) && aligned(p.aux, 8);
  const bool wide = gemm_warps(p.M, p.N, batch) == 8;
  if constexpr (ANY16) {
    const int ab = p.dtypes & (kBf16A | kBf16B);
#define TMX_GEMM_TYPES(TA, TB)                                                  \
  return wide ? launch_gemm<4, TA, TB, true>(p, trans_b, vec, batch, stream) \
              : launch_gemm<2, TA, TB, true>(p, trans_b, vec, batch, stream)
    if (ab == (kBf16A | kBf16B)) TMX_GEMM_TYPES(bf16, bf16);
    if (ab == kBf16A) TMX_GEMM_TYPES(bf16, float);
    if (ab == kBf16B) TMX_GEMM_TYPES(float, bf16);
    TMX_GEMM_TYPES(float, float);
#undef TMX_GEMM_TYPES
  } else {
    if (wide) return launch_gemm<4, float, float, false>(p, trans_b, vec, batch, stream);
    return launch_gemm<2, float, float, false>(p, trans_b, vec, batch, stream);
  }
}

}  // namespace
