// The tiled fp32 GEMM (and the GELU of its epilogues) shared by the port's
// CUDA sources.
//
// Each csrc/<name>.cu is built on its own into one shared library (one
// translation unit), so everything here has internal linkage. ops/_build.py
// hashes this header with every source, so a change here rebuilds them all.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// ---------------------------------------------------------------------------
// GEMM: C = epilogue(A @ op(B)),  op(B) = B[K,N] or B[N,K]^T. BATCHED: one
// product per z = blockIdx.z, operands offset by z times their batch
// strides (elements); res and aux share C's layout and batch stride. The
// single product compiles without the batch arithmetic.
// ---------------------------------------------------------------------------

enum Act { kActNone = 0, kActGelu = 1, kActMulGeluGrad = 2 };

template <int BM, int BN, int BK, int TM, int TN, bool TRANS_B, bool BATCHED>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gemm_kernel(const float* __restrict__ A, const float* __restrict__ B, float* C,
            int M, int N, int K, const float* __restrict__ bias,
            const float* __restrict__ res, const float* aux, int act,
            long long bsA, long long bsB, long long bsC) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int A_PER = BM * BK / NT;
  constexpr int B_PER = BN * BK / NT;
  constexpr int GM = TM / 4, GN = TN / 4;  // float4 groups per micro-tile
  constexpr int SPAN_M = BM / GM, SPAN_N = BN / GN;
  static_assert(BM * BK % NT == 0 && BN * BK % NT == 0, "tile/thread mismatch");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "micro-tile must be float4 groups");

  // +4 padding: transposed stores are bank-conflict free, float4 reads stay
  // 16-byte aligned.
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];

  if constexpr (BATCHED) {
    const long long z = blockIdx.z;
    A += z * bsA;
    B += z * bsB;
    C += z * bsC;
    if (res) res += z * bsC;
    if (aux) aux += z * bsC;
  }

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float ra[A_PER], rb[B_PER];

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int e = tid + i * NT, r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      ra[i] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * NT;
      if (TRANS_B) {  // B is [N, K]: walk K fastest
        const int r = e / BK, c = e % BK;
        const int gn = n0 + r, gk = k0 + c;
        rb[i] = (gn < N && gk < K) ? B[(size_t)gn * K + gk] : 0.f;
      } else {  // B is [K, N]: walk N fastest
        const int r = e / BN, c = e % BN;
        const int gk = k0 + r, gn = n0 + c;
        rb[i] = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : 0.f;
      }
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int e = tid + i * NT;
      As[e % BK][e / BK] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * NT;
      if (TRANS_B)
        Bs[e % BK][e / BK] = rb[i];
      else
        Bs[e / BN][e % BN] = rb[i];
    }
  };

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store();
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);  // in flight while this slice is used
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float4 t = *reinterpret_cast<const float4*>(&As[kk][g * SPAN_M + ty * 4]);
        a[g * 4 + 0] = t.x; a[g * 4 + 1] = t.y; a[g * 4 + 2] = t.z; a[g * 4 + 3] = t.w;
      }
#pragma unroll
      for (int g = 0; g < GN; ++g) {
        const float4 t = *reinterpret_cast<const float4*>(&Bs[kk][g * SPAN_N + tx * 4]);
        b[g * 4 + 0] = t.x; b[g * 4 + 1] = t.y; b[g * 4 + 2] = t.z; b[g * 4 + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i / 4) * SPAN_M + ty * 4 + (i % 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + (j / 4) * SPAN_N + tx * 4 + (j % 4);
      if (n >= N) continue;
      const size_t idx = (size_t)m * N + n;
      float v = acc[i][j];
      if (bias) v += bias[n];
      if (act == kActGelu) v = gelu_f(v);
      if (act == kActMulGeluGrad) v *= gelu_grad_f(aux[idx]);
      if (res) v += res[idx];
      C[idx] = v;
    }
  }
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

template <int BM, int BN, int BK, int TM, int TN, bool BATCHED>
void launch_gemm(const float* A, const float* B, float* C, int M, int N, int K,
                 bool trans_b, const float* bias, const float* res,
                 const float* aux, int act, int batch, long long bsA,
                 long long bsB, long long bsC, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  const int threads = (BM / TM) * (BN / TN);
  if (trans_b)
    gemm_kernel<BM, BN, BK, TM, TN, true, BATCHED><<<grid, threads, 0, stream>>>(
        A, B, C, M, N, K, bias, res, aux, act, bsA, bsB, bsC);
  else
    gemm_kernel<BM, BN, BK, TM, TN, false, BATCHED><<<grid, threads, 0, stream>>>(
        A, B, C, M, N, K, bias, res, aux, act, bsA, bsB, bsC);
}

// 128x128 tiles (8x8 micro-tile) where they cover the SMs, else 64x64 (4x4):
// big tiles would leave SMs idle on the 768-wide outputs at small batch.
// gemm<false> is one product (batch 1, strides unused); gemm<true> runs
// batch products, and only a source that batches instantiates it.
template <bool BATCHED>
void gemm(const float* A, const float* B, float* C, int M, int N, int K,
          bool trans_b, const float* bias, const float* res, const float* aux,
          int act, int batch, long long bsA, long long bsB, long long bsC,
          cudaStream_t stream) {
  const long big_tiles = (long)((M + 127) / 128) * ((N + 127) / 128) * batch;
  if (big_tiles >= num_sms())
    launch_gemm<128, 128, 8, 8, 8, BATCHED>(A, B, C, M, N, K, trans_b, bias, res,
                                            aux, act, batch, bsA, bsB, bsC, stream);
  else
    launch_gemm<64, 64, 8, 4, 4, BATCHED>(A, B, C, M, N, K, trans_b, bias, res,
                                          aux, act, batch, bsA, bsB, bsC, stream);
}

}  // namespace
