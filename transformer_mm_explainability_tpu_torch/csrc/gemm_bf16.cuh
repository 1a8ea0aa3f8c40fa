// The bf16-product GEMM of the fast_dots mode on Hopper: C = epilogue(A @
// op(B)) as common.cuh's gemm(), with every product of the JAX package's
// fast_dots mode: each operand rounded to bf16 (to nearest even), the
// products summed in fp32. A and B are bf16 in device memory (the wrapper,
// ops/attn_block._gemm_bf16, rounds an fp32 operand with round_bf16_kernel
// first), C, bias and res each fp32 or bf16 (GemmBf16Args::dtypes), aux
// fp32; the epilogue is fp32. It replaces no TPU kernel of its own: it is
// the products of the four block kernels (#1-#4) in that mode, where the
// Pallas bodies round each dot operand to bf16 (attn_block_pallas.py _dot,
// :54-61).
//
// Bound by operations at the main path's shapes, at the dense bf16
// tensor-core rate (989 TFLOP/s), which only wgmma reaches. The design:
//   - a 128 x BN output tile per block of three warpgroups: warpgroups 0
//     and 1 each multiply a 64 x BN half with wgmma.mma_async m64nBNk16,
//     both operands from shared memory; warpgroup 2 is the producer and
//     hands its registers to them (setmaxnreg). A persistent grid (one
//     block an SM) walks the tiles, so one tile's copies overlap the
//     previous one's epilogue;
//   - TMA copies (cp.async.bulk.tensor, one producer thread) of 64-deep k
//     slices of A and B into a ring of five (BN = 128) or six stages, with the 128-byte
//     swizzle that wgmma reads (64 bf16 = one 128-byte row); mbarriers mark
//     each stage full (the copies' bytes landed) and empty (every consumer
//     warp is done with it). A and B^T ([N, K]) tiles are K-major; a
//     B[K, N] tile is MN-major, in 64-wide column chunks, which wgmma reads
//     transposed (its trans-b flag). TMA fills whatever lies outside the
//     tensors with zeros (exact in the product), so every M, N and K runs
//     (the wrapper pads K, or N of a B[K, N], to a multiple of 8 and
//     counts the copies);
//   - each group of four slices (256 deep) is summed by wgmma into a fresh
//     accumulator d, which is added to acc in fp32: one tensor-core
//     accumulator over all of k drifts from a rounded fp32 sum as k grows
//     (3.3-4.5e-6 of max|C| at k = 3072 and 1.4e-5 at 12288 on an H100,
//     against 3-5e-7 with groups of four at both). Slice k's wgmma run
//     while slice k - 1's stage is handed back. Every output element has
//     one fixed summation order: the same bits on every run, no split over
//     k, no atomics;
//   - the epilogue is deferred: a finished tile is parked in the warps'
//     shared-memory buffers, and each k slice of the next tile, while its
//     wgmma run, finishes one 32-column chunk of it (+ bias, GELU or
//     GELU'(aux), + res; reads and writes of whole 128-byte lines). Writing
//     the accumulator fragments to C directly (8 rows of 32 bytes per warp
//     access) took longer than the products;
//   - the tile width BN (64 or 128) comes from the grid's shape
//     (gemm_bf16_tile_n).
// Measured per shape, against cuBLAS on the same operands, in PERF.md.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no link to libcuda)
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace {

// dtypes bits: common.cuh's Bf16Operand (kBf16A, kBf16B, kBf16C, kBf16Bias,
// kBf16Res), shared with the fp32 GEMM's bf16 storage

struct GemmBf16Args {
  const void* A;
  const void* B;
  void* C;
  const void* bias;
  const void* res;
  const float* aux;
  long long bsA, bsB, bsC;
  int M, N, K, act;
  int dtypes;  // Bf16Operand bits: these tensors are bf16, the others fp32
};

constexpr int kG16BM = 128;          // rows per tile: two warpgroups of 64
constexpr int kG16BK = 64;           // k per stage: one 128-byte row of bf16
constexpr int kG16Threads = 384;     // consumer warpgroups 0, 1; producer 2
constexpr int kG16Consumers = 256;
constexpr int kG16MaxStages = 6;
constexpr int kG16ProducerRegs = 40;  // setmaxnreg: 128 * 40 + 256 * 232 <= 65536
constexpr int kG16ConsumerRegs = 232;
constexpr int kG16SmemMax = 232448;  // the opt-in limit of a block on sm_90
// a consumer warp's epilogue buffer: its 16 rows of a tile, BN fp32 each
template <int BN>
__host__ __device__ constexpr uint32_t g16_park_bytes() {
  return (kG16Consumers / 32) * 16 * BN * 4;
}
constexpr int kG16Group = 4;         // slices per fresh wgmma accumulator (256 deep)

// The launch's shape beside the operands: a persistent grid walks the
// tiles (batch, row, column; columns fastest) from blockIdx.x in steps of
// gridDim.x.
struct G16Plan {
  int stages;            // ring stages, as shared memory allows
  int tiles_n, tiles_m;  // column and row tiles of one product
  int tiles;             // of all products
  int za, zb;            // A, B batched: their copies take the product's z
  int vec;               // N % 4 == 0, C, bias, res, aux aligned: four columns at a time
};

// Shared-memory bytes of one ring stage: a 128 x 64 A tile and a BN x 64 B tile.
template <int BN>
__host__ __device__ constexpr uint32_t g16_stage_bytes() {
  return (kG16BM + BN) * kG16BK * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA copy of the box at (c0, c1, c2) of `map` into shared memory at
// dst; its bytes are counted on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma's shared-memory matrix descriptor for a 128-byte-swizzled tile:
// start address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t g16_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// Pins each register of r at this point of the program: the compiler
// moves no read or write of them across it (wgmma writes them
// asynchronously, behind the compiler's back).
template <int N>
__device__ __forceinline__ void g16_fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A B for one k16 step of a 64 x N warpgroup tile, A and B read
// through descriptors; scale_d = 0 starts d afresh. TRANS_B = 1: B is
// MN-major (a B[K, N] tile).
template <int N, int TRANS_B>
struct Wgmma;

template <int TRANS_B>
struct Wgmma<64, TRANS_B> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
  }
};

template <int TRANS_B>
struct Wgmma<128, TRANS_B> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
  }
};

// Four consecutive elements at i of a tensor stored as fp32 or bf16 (16-
// or 8-byte aligned), as fp32; and the store of four.
__device__ __forceinline__ float4 load4_any(const void* p, long long i, bool is_bf16) {
  if (!is_bf16) return *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
  const uint2 u = *reinterpret_cast<const uint2*>(static_cast<const bf16*>(p) + i);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4_any(void* p, long long i, float4 v, bool is_bf16) {
  if (is_bf16)
    *reinterpret_cast<uint2*>(static_cast<bf16*>(p) + i) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  else
    *reinterpret_cast<float4*>(static_cast<float*>(p) + i) = v;
}

// Adds b to v (four columns), elementwise.
__device__ __forceinline__ void add4(float4& v, float4 b) {
  v.x += b.x, v.y += b.y, v.z += b.z, v.w += b.w;
}

// Four elements at i of a tensor stored as fp32 or bf16 (those at or past
// `valid` read as 0): one vector access with vec, else one at a time.
__device__ __forceinline__ float4 load4_at(const void* t, long long i, bool is_bf16, bool vec,
                                           int valid) {
  if (vec) return load4_any(t, i, is_bf16);
  float x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = e < valid ? load_any(t, i + e, is_bf16) : 0.f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

// The epilogue of one lane's four rows of four products v[i] at C[idx[i]
// ..] (columns n .. n + 3; rows with ok[i] false are left): + bias, then
// GELU or * GELU'(aux), then + res, in fp32. Each step is one branch over
// all sixteen values, so that the activations are computed only where the
// call asks for them.
__device__ __forceinline__ void g16_finish(const GemmBf16Args& p, bool vec,
                                           const long long (&idx)[4], const bool (&ok)[4], int n,
                                           float4 (&v)[4], bool bias16, bool res16) {
  const int valid = vec ? 4 : p.N - n;
  if (p.bias) {
    const float4 b = n < p.N ? load4_at(p.bias, n, bias16, vec, valid)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) add4(v[i], b);
  }
  if (p.act == kActGelu) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = make_float4(gelu_f(v[i].x), gelu_f(v[i].y), gelu_f(v[i].z), gelu_f(v[i].w));
  } else if (p.act == kActMulGeluGrad) {
    float4 x[4];  // all four rows' reads in flight before the first is used
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = ok[i] ? load4_at(p.aux, idx[i], false, vec, valid) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i].x *= gelu_grad_f(x[i].x), v[i].y *= gelu_grad_f(x[i].y);
      v[i].z *= gelu_grad_f(x[i].z), v[i].w *= gelu_grad_f(x[i].w);
    }
  }
  if (p.res) {
    float4 r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = ok[i] ? load4_at(p.res, idx[i], res16, vec, valid) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) add4(v[i], r[i]);
  }
}

// Stores four finished values at C[idx ..] (column n of N) from the lanes.
__device__ __forceinline__ void g16_store(void* C, bool vec, long long idx, int n, int N,
                                          float4 v, bool c16) {
  if (vec) {
    store4_any(C, idx, v, c16);
    return;
  }
  const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (n + e < N) store_any(C, idx + e, x[e], c16);
}

template <int BN, bool TRANS_B>
__global__ void __launch_bounds__(kG16Threads, 1)
gemm_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b, GemmBf16Args p, G16Plan plan) {
  constexpr uint32_t A_BYTES = kG16BM * kG16BK * 2, STAGE = g16_stage_bytes<BN>();
  extern __shared__ __align__(1024) unsigned char g16_raw[];
  // the swizzle repeats every 1024 bytes: every tile starts on such a boundary
  const uint32_t raw = smem_u32(g16_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int stages = plan.stages;
  const uint32_t epi = base + stages * STAGE;  // the consumer warps' epilogue buffers
  const uint32_t bars = epi + g16_park_bytes<BN>();
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kG16MaxStages + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kG16Consumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int KT = (p.K + kG16BK - 1) / kG16BK;
  const int per_z = plan.tiles_m * plan.tiles_n;
  // tile -> (z, first row, first column)
  auto origin = [&](int tile, int& z, int& m0, int& n0) {
    z = tile / per_z;
    const int r = tile - z * per_z;
    m0 = (r / plan.tiles_n) * kG16BM;
    n0 = (r % plan.tiles_n) * BN;
  };

  if (threadIdx.x >= kG16Consumers) {
    // ---- producer warpgroup: one thread issues every TMA copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kG16ProducerRegs));
    if (threadIdx.x != kG16Consumers) return;
    int s = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < plan.tiles; tile += gridDim.x) {
      int z, m0, n0;
      origin(tile, z, m0, n0);
      const int za = plan.za ? z : 0, zb = plan.zb ? z : 0;
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(empty(s), phase ^ 1);  // the first pass finds every stage free
        const uint32_t dst = base + s * STAGE;
        mbar_arrive_tx(full(s), STAGE);
        tma_load(dst, &map_a, full(s), kt * kG16BK, m0, za);
        if (TRANS_B) {
          tma_load(dst + A_BYTES, &map_b, full(s), kt * kG16BK, n0, zb);
        } else {
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            tma_load(dst + A_BYTES + c * (64 * 128), &map_b, full(s), n0 + 64 * c, kt * kG16BK,
                     zb);
        }
        if (++s == stages) s = 0, phase ^= 1;
      }
    }
  } else {
    // ---- consumer warpgroups: wgmma on 64 x BN halves, then the epilogue
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kG16ConsumerRegs));
    const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const bool c16 = p.dtypes & kBf16C, bias16 = p.dtypes & kBf16Bias,
               res16 = p.dtypes & kBf16Res;
    // this warp's epilogue buffer: row r's 16-byte unit u at u ^ (r % 8), so
    // that the fragments' float2 writes and the rows' float4 reads each
    // spread over the banks
    float* park = reinterpret_cast<float*>(g16_raw + (epi - raw)) + (threadIdx.x / 32) * 16 * BN;
    auto parked = [&](int r, int col) {
      return park + r * BN + (((col / 4) ^ (r & 7)) * 4) + col % 4;
    };
    // the tile parked last: its origin, and the next of its 32-column
    // chunks to finish (BN / 32: none left)
    int pz = 0, pm0 = 0, pn0 = 0, pc = BN / 32;
    auto finish_chunk = [&]() {
      const long long cz = (long long)pz * p.bsC;
      const int n = pn0 + 32 * pc + 4 * (lane % 8);
      float4 v[4];
      long long idx[4];
      bool ok[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // the lane's rows lane / 8 + 4 i, columns n .. n + 3
        const int r = lane / 8 + 4 * i, m = pm0 + wg * 64 + warp * 16 + r;
        v[i] = *reinterpret_cast<const float4*>(parked(r, 32 * pc + 4 * (lane % 8)));
        ok[i] = m < p.M && n < p.N;
        idx[i] = cz + (long long)m * p.N + n;
      }
      g16_finish(p, plan.vec, idx, ok, n, v, bias16, res16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (ok[i]) g16_store(p.C, plan.vec, idx[i], n, p.N, v[i], c16);
      ++pc;
    };
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    };
    // one k16 step of slice stage s into d (scale_d 0: d afresh)
    auto slice = [&](float (&d)[BN / 2], int s, bool fresh) {
      const uint32_t a = base + s * STAGE + wg * (64 * 128), b = base + s * STAGE + A_BYTES;
#pragma unroll
      for (int kk = 0; kk < kG16BK / 16; ++kk) {
        // K-major tiles step 32 bytes along their swizzled rows; the
        // MN-major B tile steps 16 rows of 128 bytes (its 64-column
        // chunks 64 rows apart)
        const uint64_t da = g16_desc(a + 32 * kk, 16, 1024);
        const uint64_t db = TRANS_B ? g16_desc(b + 32 * kk, 16, 1024)
                                    : g16_desc(b + 2048 * kk, 64 * 128, 1024);
        Wgmma<BN, TRANS_B ? 0 : 1>::mma(d, da, db, fresh && kk == 0 ? 0 : 1);
      }
    };
    int s = 0;
    uint32_t phase = 0;
    // each group of kG16Group slices is summed by wgmma into d afresh, and
    // d is added to acc in fp32
    float acc[BN / 2], d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
    for (int tile = blockIdx.x; tile < plan.tiles; tile += gridDim.x) {
      int z, m0, n0;
      origin(tile, z, m0, n0);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int k0 = 0; k0 < KT; k0 += kG16Group) {
        int prev = 0;
#pragma unroll
        for (int i = 0; i < kG16Group; ++i) {
          if (k0 + i < KT) {
            mbar_wait(full(s), phase);
            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
            slice(d, s, i == 0);
            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
            // while the tensor cores run, a chunk of the previous tile's epilogue
            if (pc < BN / 32) finish_chunk();
            if (i > 0) {  // slice k0 + i - 1 is done: hand its stage back
              asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
              release(prev);
            }
            prev = s;
            if (++s == stages) s = 0, phase ^= 1;
          }
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        g16_fence_regs(d);
        release(prev);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += d[i];
      }

      // epilogue: the previous tile's chunks that its k slices left, then
      // this tile parked (acc[4j + 2h + e] is row lane / 4 + 8h, column 8j
      // + 2 (lane % 4) + e) for the next tile's slices, or the end, to finish
      while (pc < BN / 32) finish_chunk();
      __syncwarp();
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(parked(lane / 4 + 8 * h, 8 * j + 2 * (lane % 4))) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      __syncwarp();
      pz = z, pm0 = m0, pn0 = n0, pc = 0;
    }
    while (pc < BN / 32) finish_chunk();
  }
}

// x (n fp32 values) rounded to bf16 (to nearest even) into y: the product
// operands that are stored in fp32 (the weights of an fp32 model, fp32
// cotangents), once before the GEMM reads them (see the design note).
// VEC: x 16-byte and y 8-byte aligned, four values a thread.
template <bool VEC>
__global__ void round_bf16_kernel(const float* __restrict__ x, bf16* __restrict__ y,
                                  long long n) {
  const long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (VEC && i + 4 <= n) {
    const float4 v = *reinterpret_cast<const float4*>(x + i);
    *reinterpret_cast<uint2*>(y + i) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    return;
  }
  for (long long e = i; e < n && e < i + 4; ++e) y[e] = __float2bfloat16_rn(x[e]);
}

// ---------------------------------------------------------------------------
// host side: tensor maps, the tile table, the launch
// ---------------------------------------------------------------------------

typedef CUresult (*TensorMapEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                         const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                         const cuuint32_t*, CUtensorMapInterleave,
                                         CUtensorMapSwizzle, CUtensorMapL2promotion,
                                         CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime
// (the library does not link libcuda); null where the driver has none.
TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<TensorMapEncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A 3-D map of a batch of bf16 row-major matrices [batch][rows][cols]
// (batch stride bs elements), copied in boxes of box_rows x box_cols with
// the 128-byte swizzle that wgmma reads.
bool g16_tensor_map(CUtensorMap* map, const void* ptr, long long cols, long long rows, int batch,
                    long long bs, int box_cols, int box_rows) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)(batch > 1 ? bs : rows * cols) * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int g16_forced_tile_n = 0;  // 0: the table; 64 or 128: that width (measurements)

// The tile width of a call: 128, or 64 where 128-wide tiles would leave
// more than half the SMs idle (PERF.md: 64 was faster on every product of
// one image, M = 197, and 128 on every product at B = 8 and 32).
int gemm_bf16_tile_n(int M, int N, int batch) {
  if (g16_forced_tile_n) return g16_forced_tile_n;
  const long long rows = (long long)((M + kG16BM - 1) / kG16BM) * batch;
  return 2 * rows * ((N + 127) / 128) < num_sms() ? 64 : 128;
}

template <int BN, bool TRANS_B>
cudaError_t gemm_bf16_launch_bn(const GemmBf16Args& p, int batch, cudaStream_t stream) {
  G16Plan plan;
  plan.tiles_n = (p.N + BN - 1) / BN;
  plan.tiles_m = (p.M + kG16BM - 1) / kG16BM;
  plan.tiles = plan.tiles_n * plan.tiles_m * batch;
  plan.za = batch > 1 && p.bsA != 0;
  plan.zb = batch > 1 && p.bsB != 0;
  const bool c16 = p.dtypes & kBf16C, bias16 = p.dtypes & kBf16Bias, res16 = p.dtypes & kBf16Res;
  plan.vec = p.N % 4 == 0 && p.bsC % 4 == 0 && aligned(p.C, c16 ? 8 : 16) &&
             aligned(p.bias, bias16 ? 8 : 16) && aligned(p.res, res16 ? 8 : 16) &&
             aligned(p.aux, 16);
  // alignment slack, epilogue buffers, barriers
  const uint32_t fixed = 1024 + g16_park_bytes<BN>() + 16 * kG16MaxStages;
  plan.stages = (int)((kG16SmemMax - fixed) / g16_stage_bytes<BN>());
  if (plan.stages > kG16MaxStages) plan.stages = kG16MaxStages;
  const size_t smem = fixed + plan.stages * g16_stage_bytes<BN>();

  CUtensorMap map_a, map_b;
  const int za = plan.za ? batch : 1, zb = plan.zb ? batch : 1;
  if (!g16_tensor_map(&map_a, p.A, p.K, p.M, za, p.bsA, kG16BK, kG16BM) ||
      !(TRANS_B ? g16_tensor_map(&map_b, p.B, p.K, p.N, zb, p.bsB, kG16BK, BN)
                : g16_tensor_map(&map_b, p.B, p.N, p.K, zb, p.bsB, 64, kG16BK)))
    return cudaErrorInvalidValue;

  auto kernel = gemm_bf16_wgmma_kernel<BN, TRANS_B>;
  static unsigned long long devices_set = 0;  // per instantiation: the limit is set once a card
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !(devices_set >> dev & 1)) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kG16SmemMax);
    if (err != cudaSuccess) return err;
    if (dev < 64) devices_set |= 1ull << dev;
  }
  const int grid = plan.tiles < num_sms() ? plan.tiles : num_sms();
  kernel<<<grid, kG16Threads, smem, stream>>>(map_a, map_b, p, plan);
  return cudaGetLastError();
}

// The bf16-product GEMM of every caller: checks the arguments (A and B
// bf16; every row TMA reads starts on a 16-byte boundary: the pointers, K,
// N of a B[K, N] and the batch strides; refused otherwise) and launches
// the tile width of the table.
cudaError_t gemm_bf16(const GemmBf16Args& p, bool trans_b, int batch, cudaStream_t stream) {
  if (p.M < 1 || p.N < 1 || p.K < 1 || batch < 1 || batch > 65535)
    return cudaErrorInvalidValue;
  if ((p.dtypes & (kBf16A | kBf16B)) != (kBf16A | kBf16B)) return cudaErrorInvalidValue;
  if (!aligned(p.A, 16) || !aligned(p.B, 16) || p.K % 8 || (!trans_b && p.N % 8) ||
      p.bsA % 8 || p.bsB % 8)
    return cudaErrorMisalignedAddress;
  if (gemm_bf16_tile_n(p.M, p.N, batch) == 64)
    return trans_b ? gemm_bf16_launch_bn<64, true>(p, batch, stream)
                   : gemm_bf16_launch_bn<64, false>(p, batch, stream);
  return trans_b ? gemm_bf16_launch_bn<128, true>(p, batch, stream)
                 : gemm_bf16_launch_bn<128, false>(p, batch, stream);
}

cudaError_t round_bf16(const float* x, bf16* y, long long n, cudaStream_t stream) {
  if (n < 1) return n == 0 ? cudaSuccess : cudaErrorInvalidValue;
  constexpr int threads = 256;
  const long long blocks = (n + 4LL * threads - 1) / (4LL * threads);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (aligned(x, 16) && aligned(y, 8))
    round_bf16_kernel<true><<<(unsigned)blocks, threads, 0, stream>>>(x, y, n);
  else
    round_bf16_kernel<false><<<(unsigned)blocks, threads, 0, stream>>>(x, y, n);
  return cudaGetLastError();
}

}  // namespace
