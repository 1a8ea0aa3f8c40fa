// Tensor-core building blocks for fp32 kernels on Hopper: the TF32
// mma.sync.m16n8k8 product with 3xTF32 split operands, fragment loaders
// from shared memory, and cp.async global -> shared copies.
//
// 3xTF32: an fp32 value x is split into hi = tf32(x) and lo = tf32(x - hi),
// tf32() rounding to nearest, ties away from zero, as cvt.rna.tf32.f32 does.
// hi carries the top 11 bits of the significand, lo the next 11, so hi + lo
// holds x to about 2^-22 of |x|. A product a*b is taken as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b (the
// lo*lo term, below 2^-22 relative, is dropped), accumulated in fp32 with
// the small terms first. The result matches an fp32 CUDA-core product to a
// few ulps, where one TF32 product (hi*hi alone) keeps about three decimal
// digits. Nothing here goes through a library switch: each kernel asks for
// the split explicitly.
//
// Fragment layouts of mma.m16n8k8.row.col.f32.tf32.tf32.f32, for the lane
// with g = lane / 4 ("group") and t = lane % 4 ("thread in group"):
//   A (16x8, row-major):  a0 = A[g][t],   a1 = A[g+8][t],
//                         a2 = A[g][t+4], a3 = A[g+8][t+4]
//   B (8x8, k by n):      b0 = B[t][g],   b1 = B[t+4][g]
//   C (16x8 accumulator): c0 = C[g][2t],  c1 = C[g][2t+1],
//                         c2 = C[g+8][2t], c3 = C[g+8][2t+1]
// An accumulator is not an A fragment: its thread holds columns 2t and
// 2t+1 where A wants t and t+4. a_from_acc_3x / load_b_paired_3x take the
// product's k index in the paired order (A column t <-> k 2t, column t+4
// <-> k 2t+1) on both operands, which permutes the terms of the sum over k
// and changes nothing else: a C fragment feeds the next product with no
// shuffle and no shared-memory round trip.
//
// Shared-memory tiles read by these loaders: a row stride ld with
// ld % 8 == 4 (in floats) makes every loader below free of bank conflicts
// (the 32 lanes hit 32 distinct banks) and keeps 16-byte rows aligned for
// cp.async; load_b_3x has its own rule.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// 3xTF32 products
// ---------------------------------------------------------------------------

// cvt.rna.tf32.f32 in two integer operations: add half a TF32 ulp to the
// magnitude bits, then clear the 13 bits TF32 drops. For finite x this is
// the same bits as cvt.rna.tf32.f32 (a carry out of the significand bumps
// the exponent, as the rounding must); the conversion instruction issues at
// a quarter of the integer rate, and a kernel of 3xTF32 products splits
// every operand it reads.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// split_tf32 with lo = x - hi passed unrounded, two integer operations
// fewer: an mma reads a .tf32 operand at TF32 precision whatever its 13 low
// bits hold (CUTLASS's fast fp32 split leaves them set the same way), so lo
// enters the product cut to TF32, within 2^-10 of lo: about 2^-21 of x,
// the size of the dropped lo*lo term. The GEMM's float64 gates hold it.
__device__ __forceinline__ void split_tf32_fast(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += A * B, one TF32 product.
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = A * B, one TF32 product into a fresh accumulator.
__device__ __forceinline__ void mma_tf32_zero(float d[4], const uint32_t a[4],
                                              const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// c += A * B at fp32 accuracy: lo*hi + hi*lo + hi*hi, small terms first.
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t a_hi[4],
                                           const uint32_t a_lo[4],
                                           const uint32_t b_hi[2],
                                           const uint32_t b_lo[2]) {
  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);
}

// ---------------------------------------------------------------------------
// Fragment loaders (shared memory -> split registers); lane is the lane id.
// ---------------------------------------------------------------------------

// A, 16x8, row-major at a with row stride ld.
__device__ __forceinline__ void load_a_3x(const float* a, int ld, int lane,
                                          uint32_t hi[4], uint32_t lo[4]) {
  const int g = lane >> 2, t = lane & 3;
  split_tf32(a[g * ld + t], hi[0], lo[0]);
  split_tf32(a[(g + 8) * ld + t], hi[1], lo[1]);
  split_tf32(a[g * ld + t + 4], hi[2], lo[2]);
  split_tf32(a[(g + 8) * ld + t + 4], hi[3], lo[3]);
}

// B, 8x8, stored transposed (as its 8 columns, each a row of 8 k values:
// B[k][n] = bt[n * ld + k]); e.g. keys for q * k^T.
__device__ __forceinline__ void load_bt_3x(const float* bt, int ld, int lane,
                                           uint32_t hi[2], uint32_t lo[2]) {
  const int g = lane >> 2, t = lane & 3;
  split_tf32(bt[g * ld + t], hi[0], lo[0]);
  split_tf32(bt[g * ld + t + 4], hi[1], lo[1]);
}

// B, 8x8, stored as rows of k (B[k][n] = b[k * ld + n]), in the paired k
// order of a_from_acc_3x: b0 from row 2t, b1 from row 2t+1.
__device__ __forceinline__ void load_b_paired_3x(const float* b, int ld, int lane,
                                                 uint32_t hi[2], uint32_t lo[2]) {
  const int g = lane >> 2, t = lane & 3;
  split_tf32(b[(2 * t) * ld + g], hi[0], lo[0]);
  split_tf32(b[(2 * t + 1) * ld + g], hi[1], lo[1]);
}

// A C fragment (16 rows x 8 k values) as an A fragment in the paired k
// order: a0 = C[g][2t], a1 = C[g+8][2t], a2 = C[g][2t+1], a3 = C[g+8][2t+1].
__device__ __forceinline__ void a_from_acc_3x(const float c[4], uint32_t hi[4],
                                              uint32_t lo[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// ---------------------------------------------------------------------------
// The GEMM's loaders (common.cuh): they split with split_tf32_fast, and the
// row-major ones read through ldmatrix, one instruction for what load_a_3x
// reads in four. ldmatrix .x4 reads four 8x8 b16 matrices, here four 8 x 4
// blocks of fp32: lane l gives the address of row l % 8 of block l / 8
// (16-byte aligned) and receives element (g, t) of each block, the layout
// of an mma fragment. With ld % 8 == 4 the eight rows of a block hit
// distinct banks.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(const float* row, uint32_t r[4]) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// A, 16x8, row-major at a with row stride ld: the blocks (rows 0-7, k 0-3),
// (8-15, 0-3), (0-7, 4-7), (8-15, 4-7) are a0..a3.
__device__ __forceinline__ void load_a_ldsm_3x(const float* a, int ld, int lane,
                                               uint32_t hi[4], uint32_t lo[4]) {
  const int q = lane >> 3, r = lane & 7;
  uint32_t v[4];
  ldsm_x4(a + ((q & 1) * 8 + r) * ld + (q >> 1) * 4, v);
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32_fast(__uint_as_float(v[e]), hi[e], lo[e]);
}

// Two B fragments, n 0-7 and 8-15, stored transposed as for load_bt_3x: the
// blocks (n 0-7, k 0-3), (0-7, 4-7), (8-15, 0-3), (8-15, 4-7) are b0 and b1
// of the first, then of the second.
__device__ __forceinline__ void load_bt2_ldsm_3x(const float* bt, int ld, int lane,
                                                 uint32_t hi[2][2], uint32_t lo[2][2]) {
  const int q = lane >> 3, r = lane & 7;
  uint32_t v[4];
  ldsm_x4(bt + ((q >> 1) * 8 + r) * ld + (q & 1) * 4, v);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    split_tf32_fast(__uint_as_float(v[e]), hi[e >> 1][e & 1], lo[e >> 1][e & 1]);
}

// B, 8x8, stored as rows of k (B[k][n] = b[k * ld + n]), in the mma's own
// k order: b0 from row t, b1 from row t + 4; e.g. a B[K,N] weight tile.
// ldmatrix cannot transpose 32-bit elements, so two scalar loads; lane
// (g, t) reads t * ld + g, so ld % 32 == 8 (or 24) keeps them on 32 banks.
__device__ __forceinline__ void load_b_3x(const float* b, int ld, int lane,
                                          uint32_t hi[2], uint32_t lo[2]) {
  const int g = lane >> 2, t = lane & 3;
  split_tf32_fast(b[t * ld + g], hi[0], lo[0]);
  split_tf32_fast(b[(t + 4) * ld + g], hi[1], lo[1]);
}

// The paired-k pair of a_from_acc_3x / load_b_paired_3x with split_tf32_fast,
// for the attention backward (attn_block.cu).
__device__ __forceinline__ void a_from_acc_fast_3x(const float c[4], uint32_t hi[4],
                                                   uint32_t lo[4]) {
  split_tf32_fast(c[0], hi[0], lo[0]);
  split_tf32_fast(c[2], hi[1], lo[1]);
  split_tf32_fast(c[1], hi[2], lo[2]);
  split_tf32_fast(c[3], hi[3], lo[3]);
}

__device__ __forceinline__ void load_b_paired_fast_3x(const float* b, int ld, int lane,
                                                      uint32_t hi[2], uint32_t lo[2]) {
  const int g = lane >> 2, t = lane & 3;
  split_tf32_fast(b[(2 * t) * ld + g], hi[0], lo[0]);
  split_tf32_fast(b[(2 * t + 1) * ld + g], hi[1], lo[1]);
}

// ---------------------------------------------------------------------------
// cp.async: global -> shared without a register round trip. A thread's
// copies since its last commit form one group; wait<N> returns once at most
// N of its groups are still in flight. A __syncthreads() after the wait
// makes every thread's copies visible to the block.
// ---------------------------------------------------------------------------

// 16 bytes, L2 only (cg); both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

// 4 bytes (ca: cp.async.cg takes only 16).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
