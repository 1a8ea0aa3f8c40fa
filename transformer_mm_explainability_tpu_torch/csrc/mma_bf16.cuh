// Tensor-core building blocks for the bf16-product kernels on Hopper: the
// bf16 mma.sync.m16n8k16 product with fp32 accumulation, fragment loaders
// from bf16 shared-memory tiles, the round-to-nearest-even conversion, and
// a tile loader that stages fp32 or bf16 rows through registers.
//
// The arithmetic is the JAX package's fast_dots mode
// (transformer_mm_explainability_tpu/ops/attn_block_pallas.py _dot/_cast,
// flash_attention.py _dot/_dot_tt): every operand of a product rounded to
// bf16, to nearest with ties to even as XLA's astype rounds
// (__floats2bfloat162_rn, cvt.rn.bf16x2.f32; not the ties-away rounding of
// mma_tf32.cuh's to_tf32), the products exact and summed in fp32.
//
// Fragment layouts of mma.m16n8k16.row.col.f32.bf16.bf16.f32, for the lane
// with g = lane / 4 and t = lane % 4; each register holds two bf16, the
// lower k in the low half:
//   A (16x16, row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                         a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16x8, k by n):     b0 = B[2t..2t+1][g],   b1 = B[2t+8..2t+9][g]
//   C (16x8 accumulator): c0 = C[g][2t], c1 = C[g][2t+1],
//                         c2 = C[g+8][2t], c3 = C[g+8][2t+1]
// Two neighbouring C fragments (n 0-7 and 8-15) are, packed in pairs, an A
// fragment over k = their 16 columns (a_from_acc_bf16): a probability or
// ds tile in registers feeds the next product with no shuffle.
//
// Shared-memory tiles are bf16 with a row stride ld where ld % 8 == 0 and
// ld / 8 is odd (in elements): every row starts on a 16-byte boundary, as
// ldmatrix needs, and the eight rows of an 8x8 block fall in distinct
// bank groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// (lo, hi) -> bf16x2, each rounded to nearest, ties to even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += A * B, one bf16 product with fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ldmatrix .x4: lane l gives the address of row l % 8 of 8x8 block l / 8
// (16 bytes of bf16); each lane receives element pair (g, 2t..2t+1) of
// every block, or with .trans the pair (2t..2t+1, g).
__device__ __forceinline__ void ldsm_x4_bf16(const bf16* row, uint32_t r[4]) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans_bf16(const bf16* row, uint32_t r[4]) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// A, 16x16, row-major at a (row stride ld): blocks (rows 0-7, k 0-7),
// (8-15, 0-7), (0-7, 8-15), (8-15, 8-15) are a0..a3.
__device__ __forceinline__ void load_a_bf16(const bf16* a, int ld, int lane, uint32_t r[4]) {
  const int q = lane >> 3, i = lane & 7;
  ldsm_x4_bf16(a + ((q & 1) * 8 + i) * ld + (q >> 1) * 8, r);
}

// Two B fragments (n 0-7 and 8-15, k 0-15) of a tile stored as rows of k
// (bt[n * ld + k], e.g. keys for q k^T or a weight [N, K]): blocks (n 0-7,
// k 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15) are b0, b1 of the first,
// then of the second.
__device__ __forceinline__ void load_bt2_bf16(const bf16* bt, int ld, int lane, uint32_t b[2][2]) {
  const int q = lane >> 3, i = lane & 7;
  uint32_t r[4];
  ldsm_x4_bf16(bt + ((q >> 1) * 8 + i) * ld + (q & 1) * 8, r);
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

// The same two B fragments of a tile stored as rows of n (b[k * ld + n],
// e.g. v for A v or a weight [K, N]), transposed by ldmatrix .trans:
// blocks (k 0-7, n 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15).
__device__ __forceinline__ void load_b2_bf16(const bf16* b, int ld, int lane, uint32_t f[2][2]) {
  const int q = lane >> 3, i = lane & 7;
  uint32_t r[4];
  ldsm_x4_trans_bf16(b + ((q & 1) * 8 + i) * ld + (q >> 1) * 8, r);
  f[0][0] = r[0];
  f[0][1] = r[1];
  f[1][0] = r[2];
  f[1][1] = r[3];
}

// Two C fragments (columns 0-7 in c0, 8-15 in c1) as the A fragment of
// their 16 columns, each value rounded to bf16.
__device__ __forceinline__ void a_from_acc_bf16(const float c0[4], const float c1[4],
                                                uint32_t a[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ float bf16_value(bf16 v) { return __bfloat162float(v); }

// One element of a tensor stored as fp32 or bf16 (is_bf16), as fp32.
__device__ __forceinline__ float load_any(const void* p, long long i, bool is_bf16) {
  return is_bf16 ? bf16_value(static_cast<const bf16*>(p)[i]) : static_cast<const float*>(p)[i];
}

// Element i of a tensor stored as fp32 or bf16.
__device__ __forceinline__ const void* elem_at(const void* p, long long i, bool is_bf16) {
  return static_cast<const char*>(p) + i * (is_bf16 ? 2 : 4);
}

// Stores v into a tensor of fp32 or bf16 (rounded to nearest even).
__device__ __forceinline__ void store_any(void* p, long long i, float v, bool is_bf16) {
  if (is_bf16)
    static_cast<bf16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// Four consecutive elements at p as packed bf16 (rounded to nearest even);
// only the first `valid` (< 4 leaves the rest 0). VEC: one 16-byte (fp32)
// or 8-byte (bf16) load, p aligned to it and valid >= 4 or <= 0 (checked
// before launch); else element by element.
template <typename T, bool VEC>
__device__ __forceinline__ uint2 load4_bf16(const T* p, int valid) {
  float f[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (sizeof(T) == 2) {
    if constexpr (VEC) {
      if (valid > 0) return *reinterpret_cast<const uint2*>(p);
      return make_uint2(0u, 0u);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < valid) f[e] = bf16_value(p[e]);
    }
  } else {
    if constexpr (VEC) {
      if (valid > 0) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < valid) f[e] = p[e];
    }
  }
  return make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
}

// A ROWS x COLS tile of a row-major matrix (fp32 or bf16 in device memory,
// row stride ld) staged through registers into a bf16 shared-memory tile
// (row stride LD): load() issues the global reads, store() converts and
// writes them, so a kernel can multiply one tile while the next is in
// flight. Rows at or past rows_valid and columns at or past cols_valid
// become 0 (exact in every product). Thread e of THREADS takes the 4-wide
// chunks e, e + THREADS, ...
template <int ROWS, int COLS, int THREADS>
struct TileRegs {
  static_assert(COLS % 4 == 0 && (ROWS * COLS / 4) % THREADS == 0, "tile/thread mismatch");
  static constexpr int PER_ROW = COLS / 4;
  static constexpr int CHUNKS = ROWS * PER_ROW / THREADS;
  uint2 v[CHUNKS];

  template <typename T, bool VEC>
  __device__ __forceinline__ void load_t(const T* src, long long ld, int rows_valid,
                                         int cols_valid) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int r = e / PER_ROW, c = (e % PER_ROW) * 4;
      v[i] = r < rows_valid ? load4_bf16<T, VEC>(src + r * ld + c, cols_valid - c)
                            : make_uint2(0u, 0u);
    }
  }

  // src: fp32, or bf16 where is_bf16; vec: the 4-wide loads of load4_bf16.
  __device__ __forceinline__ void load(const void* src, bool is_bf16, bool vec, long long ld,
                                       int rows_valid, int cols_valid) {
    if (is_bf16) {
      if (vec)
        load_t<bf16, true>(static_cast<const bf16*>(src), ld, rows_valid, cols_valid);
      else
        load_t<bf16, false>(static_cast<const bf16*>(src), ld, rows_valid, cols_valid);
    } else {
      if (vec)
        load_t<float, true>(static_cast<const float*>(src), ld, rows_valid, cols_valid);
      else
        load_t<float, false>(static_cast<const float*>(src), ld, rows_valid, cols_valid);
    }
  }

  __device__ __forceinline__ void store(bf16* dst, int LD) const {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int e = threadIdx.x + i * THREADS;
      *reinterpret_cast<uint2*>(dst + (e / PER_ROW) * LD + (e % PER_ROW) * 4) = v[i];
    }
  }
};

}  // namespace
