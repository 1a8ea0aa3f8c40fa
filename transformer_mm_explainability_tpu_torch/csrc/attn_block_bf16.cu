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
//   attn_fwd_*_kernel    the attention forward, on wgmma and TMA: one
//                        sweep over the keys where a row's scores fit the
//                        accumulators, two past that (the section note
//                        before kFwdTiles).
//   attn_bwd_*_kernel    its backward with the fold, on wgmma and TMA: a
//                        statistics pass, a key-major pass and a finishing
//                        sum (the section note before kAtRows).
//   attn_pack_kernel     operands TMA cannot read in place (fp32, rows off
//                        the 16-byte grid) rounded to bf16 into an aligned
//                        scratch, for both attention directions.
//
// What bounds them: the attention does 4 S*S*dh (forward) and 10 S*S*dh
// (backward) flops per (image, head) against 16 and 28 S*dh bytes, bound by
// operations at the dense bf16 tensor-core rate (989 TFLOP/s) at long S and
// by bytes at ViT-B's S = 197; the LayerNorm rows are bound by bytes. Both
// attention directions take their tiles by TMA into 128-byte-swizzled
// shared memory, multiply on wgmma (64-row warpgroup tiles, fp32
// accumulators), keep the row statistics in fp32 registers and feed a
// probability tile to the next product as bf16 A fragments straight from
// the accumulators (mma_bf16.cuh a_from_acc_bf16). Shared memory is fixed
// by dh and by S up to 256 keys, so any S runs.

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
// Attention with bf16 products, on wgmma and TMA. Operands as in
// attn_block.cu (base pointer, (batch, head, row) strides, unit stride
// along dh), all of one storage type: fp32, or bf16 where `bf` is set; r,
// the statistics and the fold fp32. TMA reads a bf16 operand in place where
// every row starts on a 16-byte boundary (attn16_in_place); any other
// operand is rounded to bf16 into an aligned scratch first
// (attn_pack_kernel, shared by both directions). Tiles are 64 rows of 64
// bf16 columns (128 bytes, the 128-byte swizzle that wgmma reads); dh is
// padded to 64 (DC = 1) or 128 (DC = 2): TMA fills the columns at or past
// dh, and the rows at or past S, with zeros, exact in every product.
// ---------------------------------------------------------------------------

constexpr int kMaxDh = 128;

struct Operand {
  const void* p;
  Strides st;
};

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// The attention backward with bf16 products on wgmma and TMA (#4, #6 and #8
// in the fast_dots mode). Three launches, four with operands that TMA cannot
// read in place:
//
//   attn_pack_kernel        (only where needed) an operand stored in fp32,
//                           or in bf16 with rows off the 16-byte grid (dh
//                           not a multiple of 8, a view's odd stride or
//                           base), rounded to bf16 into an aligned [B, H, S,
//                           dh8] scratch (dh8: dh rounded up to 8);
//   attn_bwd_stats_wgmma_kernel  one warpgroup per (64-query tile, head,
//                           image): s = q k^T and dA = dout v^T on wgmma over
//                           the 64-key tiles, which a producer warp streams
//                           by TMA through a two-stage ring; the online row
//                           max m, sum l and u = sum_j 2^(s_j - m) dA_j (log2
//                           domain, rescaled together), then (m, 1/l,
//                           dsum = u / l, r) per query into `stats`
//                           (queries at or past S get zeros: 1/l = 0, r = 0);
//   attn_bwd_keys_wgmma_kernel   a persistent grid; a block holds the K and V
//                           rows of NWG warpgroups of 64 keys in shared
//                           memory (the next key block's loaded into a second
//                           buffer meanwhile) while a producer warpgroup
//                           streams the 64-query tiles of q, dout and their
//                           statistics through the ring. Per tile: S^T =
//                           K q^T and dA^T = V dout^T (wgmma, both operands
//                           in shared memory); A^T = 2^(S^T - m) / l, the
//                           fold e += r relu(A^T dA^T) and dS^T = A^T (dA^T -
//                           dsum) scale in registers; dV += A^T dout and
//                           dK += dS^T q on wgmma with A from registers (the
//                           accumulator layout, rounded to bf16, is the A
//                           fragment); dS^T rounded to bf16 into shared
//                           memory (128-byte swizzle), and the partial dq =
//                           dS K of the block's keys on wgmma (A transposed
//                           from shared memory; with two warpgroups, the
//                           second's handed to the first through shared
//                           memory and added, in key order) into an fp32
//                           scratch [n_sub][B*H][S_pad][64 DC];
//   attn_bwd_finish_kernel  dq = the partials summed in key order, written in
//                           the outputs' dtype; e_row = (1/H) sum_h e_part,
//                           the heads in a fixed order.
//
// Seven S*S*dh products per (image, head) for the function's five: s and dA
// twice, dV, dK, dq once. Both passes are bound by latency at ViT-B's S =
// 197 (a block streams four tiles; one or two warps a scheduler) and by the
// exponentials and the tensor cores at long S; the finish by the partials'
// bytes. No atomics and no sum ordered by timing: the same
// inputs give the same bits, whatever their layout (per-head views or the
// merged qkv; operands that are packed first hold the same bf16 values).
// Keys at or past S are masked in the kernels (A = 0), queries at or past S
// by their statistics (1/l = 0, r = 0). dh is padded to 64 (DC = 1) or 128
// (DC = 2): TMA copies 64-column boxes and fills the columns at or past dh,
// and the rows at or past S, with zeros, exact in every product. Shared
// memory is fixed by dh, so any S runs.
// ---------------------------------------------------------------------------

constexpr int kAtRows = 64;                  // rows of a tile: queries or keys
constexpr uint32_t kAtTile = kAtRows * 128;  // [64][64] bf16, 128-byte swizzled rows
constexpr int kAtStages = 2;                 // ring stages of the streamed tiles
constexpr int kAtProducer = 32;              // the producer warp, after the warpgroups
constexpr int kAtSmemSlack = 1024 + 128;     // tile alignment, up to 16 barriers

struct BwdArgs {
  const float* r;        // [B, S]
  void *dq, *dk, *dv;    // [B, H, S, dh] views, fp32 or bf16 (bf)
  Strides sdq, sdk, sdv;
  float4* stats;         // [B*H][s_pad]: (m, 1/l, dsum, r) per query
  float* dq_part;        // [n_sub][B*H][s_pad][64 DC], n_sub = S / (64 NWG) rounded up
  float* e_part;         // [B*H][S]
  float* e_row;          // [B][S]
  int B, S, H, dh, s_pad, n_sub;
  float scale_log2, scale;
  bool bf;
  bool pair_kv, pair_q;  // dk and dv (dq) take two neighbouring columns a store
};

// 2^x (ex2.approx: 2 ulp, denormal results flushed to 0; -inf gives 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two neighbouring elements at i of a tensor of fp32 or bf16 (rounded to
// nearest even), one store where `pair` (i even, the tensor aligned for it).
__device__ __forceinline__ void store2_any(void* p, long long i, float x, float y, bool bf,
                                           bool pair) {
  if (!pair) {
    store_any(p, i, x, bf);
    store_any(p, i + 1, y, bf);
  } else if (bf) {
    *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p) + i) = pack_bf16(x, y);
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(p) + i) = make_float2(x, y);
  }
}

// One TMA copy of the 64 x 64 box at (column c0, row c1) of head (c2 = h,
// c3 = b) of a [B, H, S, dh] map into shared memory at dst.
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One bulk copy of `bytes` contiguous bytes (16-byte aligned) into shared memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The 128 threads of warpgroup w meet (named barrier 1 + w), after their
// shared-memory writes are made visible to wgmma's reads (the async proxy).
__device__ __forceinline__ void wg_publish(int w) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
}

// d (+)= A B for one k16 step of a 64 x 64 warpgroup tile, both operands in
// shared memory; TA / TB: A / B MN-major (read transposed).
template <int TA, int TB>
__device__ __forceinline__ void wg_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// The same for a 64 x 32 tile (m64n32k16).
template <int TA, int TB>
__device__ __forceinline__ void wg_ss(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// The same with A from registers: the m16n8k16 A fragments of the warp's 16
// rows (a_from_acc_bf16 of two accumulator columns of eight); TB as above.
template <int TB>
__device__ __forceinline__ void wg_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

// Descriptors of k16 step kk (0 .. 4 DC - 1) of a 128-byte-swizzled operand
// of DC chunks [64 rows][64 columns] (kAtTile apart): K-major (the rows are
// the product's m or n, the columns its k: 32 bytes a step within a chunk)
// and MN-major (the rows are the product's k: 16 rows of 128 bytes a step).
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return g16_desc(tile + (kk / 4) * kAtTile + 32 * (kk % 4), 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return g16_desc(tile + 2048 * kk, kAtTile, 1024);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

template <int DC>
constexpr uint32_t bwd16_stats_smem() {
  return kAtSmemSlack + (2 + 2 * kAtStages) * DC * kAtTile;
}

constexpr int kBwKV = 2;  // K and V buffers of the keys pass: the next block's loads early

// With two warpgroups, warpgroup 1 hands its partial dq (64 x 64 fp32 a
// chunk) to warpgroup 0 through a buffer of its own, two of them (by tile
// parity) for each chunk.
template <int DC, int NWG>
__host__ __device__ constexpr uint32_t bwd16_xchg_bytes() {
  return NWG == 2 ? 2 * DC * 128 * 32 * 4 : 0;
}

template <int DC, int NWG>
constexpr uint32_t bwd16_keys_smem() {
  return kAtSmemSlack + (2 * kBwKV * NWG * DC + NWG) * kAtTile +
         kAtStages * (2 * DC * kAtTile + 1024) + bwd16_xchg_bytes<DC, NWG>();
}

// s = q k^T and dA = dout v^T over the key tiles of one (64-query tile,
// head, image); the online statistics (see the section note). Warps 0-3 are
// the consumer warpgroup, warp 4 the producer.
template <int DC>
__global__ void __launch_bounds__(128 + kAtProducer)
attn_bwd_stats_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const __grid_constant__ CUtensorMap map_do, BwdArgs a) {
  constexpr uint32_t OP = DC * kAtTile;  // one operand's 64 rows
  extern __shared__ __align__(1024) unsigned char bw_raw[];
  const uint32_t base = (smem_u32(bw_raw) + 1023) & ~1023u;
  const uint32_t qs = base, os = base + OP;  // this tile's q and dout rows
  const uint32_t ring = base + 2 * OP;       // stage s: k at ring + 2 OP s, v after it
  const uint32_t bars = ring + kAtStages * 2 * OP;
  auto full = [&](int s) { return bars + 8 + 8 * s; };
  auto empty = [&](int s) { return bars + 8 + 8 * (kAtStages + s); };
  const int b = blockIdx.z, h = blockIdx.y, S = a.S;
  const int q0 = blockIdx.x * kAtRows, nk = (S + kAtRows - 1) / kAtRows;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < kAtStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // ---- producer: one thread starts every copy
    if (threadIdx.x != 128) return;
    mbar_arrive_tx(bars, 2 * OP);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      tma_load4(qs + c * kAtTile, &map_q, bars, 64 * c, q0, h, b);
      tma_load4(os + c * kAtTile, &map_do, bars, 64 * c, q0, h, b);
    }
    int s = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(empty(s), phase ^ 1);  // the first pass finds every stage free
      mbar_arrive_tx(full(s), 2 * OP);
      const uint32_t dst = ring + s * 2 * OP;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        tma_load4(dst + c * kAtTile, &map_k, full(s), 64 * c, kt * kAtRows, h, b);
        tma_load4(dst + OP + c * kAtTile, &map_v, full(s), 64 * c, kt * kAtRows, h, b);
      }
      if (++s == kAtStages) s = 0, phase ^= 1;
    }
    return;
  }

  // ---- consumers: this lane's rows are queries q0 + 16 warp + g + 8 hh;
  // accumulator element 4 j + 2 hh + e is key 8 j + 2 t + e of the tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane & 3;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
  mbar_wait(bars, 0);
  int s = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(full(s), phase);
    const uint32_t ks = ring + s * 2 * OP, vs = ks + OP;
    float sc[32], dg[32];  // fresh: the first k step does not read them
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * DC; ++kk) wg_ss<0, 0>(sc, kmajor(qs, kk), kmajor(ks, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4 * DC; ++kk) wg_ss<0, 0>(dg, kmajor(os, kk), kmajor(vs, kk), kk > 0);
    wg_commit();
    wg_wait0();
    g16_fence_regs(sc);
    g16_fence_regs(dg);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    if (++s == kAtStages) s = 0, phase ^= 1;

    const int k0 = kt * kAtRows;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = k0 + 8 * j + 2 * t + e < S;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float& v = sc[4 * j + 2 * hh + e];
          v = ok ? v * a.scale_log2 : -INFINITY;
        }
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = m[hh];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = ex2(m[hh] - mx);  // 0 on the first tile
      m[hh] = mx;
      l[hh] *= alpha;
      u[hh] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          const float p = ex2(sc[i] - mx);
          l[hh] += p;
          u[hh] = fmaf(p, dg[i], u[hh]);
        }
    }
  }

  const size_t bh = (size_t)b * a.H + h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float L = quad_sum(l[hh]), U = quad_sum(u[hh]);
    const int row = q0 + 16 * warp + (lane >> 2) + 8 * hh;
    if (t == 0)
      a.stats[bh * a.s_pad + row] =
          row < S ? make_float4(m[hh], 1.0f / L, U / L, a.r[(size_t)b * S + row])
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// dK, dV, the fold and the partial dq of blocks of 64 NWG keys of one
// (head, image), each streaming every query tile (see the section note).
// The grid is persistent: block i takes key blocks i, i + gridDim.x, ...
// (the key blocks of a head consecutive), and the producer loads the next
// one's K and V rows into the other of two buffers while this one is
// computed. Warpgroups 0 .. NWG - 1 are the consumers (warpgroup w: keys
// k0 + 64 w ..), the last one the producer, which hands its registers to
// them (setmaxnreg). The S^T and dA^T products take the query tile in DC
// steps of 64 / DC queries, so that with dh > 64 (DC = 2) the 128
// accumulators of dK and dV fit beside them.
template <int DC, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), NWG == 1 ? 2 : 1)
attn_bwd_keys_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_do, BwdArgs a) {
  constexpr uint32_t OP = DC * kAtTile;
  constexpr uint32_t STAGE = 2 * OP + kAtRows * sizeof(float4);  // q, dout, statistics
  constexpr uint32_t KV = 2 * NWG * OP;                           // one K and V buffer
  constexpr int DP = 64 * DC;
  constexpr int QH = kAtRows / DC;  // queries of one S^T step
  constexpr int NA = QH / 2;        // its accumulator registers a thread
  extern __shared__ __align__(1024) unsigned char bw_raw[];
  const uint32_t raw = smem_u32(bw_raw), base = (raw + 1023) & ~1023u;
  // K/V buffer x at base + KV x: warpgroup w's k rows at + OP w, v rows at
  // + OP (NWG + w); dS^T of warpgroup w at dss + kAtTile w; the ring after
  const uint32_t dss = base + kBwKV * KV;
  const uint32_t ring = dss + NWG * kAtTile;
  const uint32_t xchg = ring + kAtStages * STAGE;  // the partial dq handed over (NWG = 2)
  const uint32_t bars = xchg + bwd16_xchg_bytes<DC, NWG>();
  auto kv_full = [&](int x) { return bars + 8 * x; };
  auto kv_empty = [&](int x) { return bars + 8 * (kBwKV + x); };
  auto full = [&](int s) { return bars + 8 * (2 * kBwKV + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * kBwKV + kAtStages + s); };
  const int S = a.S, nq = a.s_pad / kAtRows;
  const int n_kb = (S + kAtRows * NWG - 1) / (kAtRows * NWG);
  const int items = n_kb * a.B * a.H;

  if (threadIdx.x == 0) {
    for (int x = 0; x < kBwKV; ++x) {
      mbar_init(kv_full(x), 1);
      mbar_init(kv_empty(x), 4 * NWG);
    }
    for (int s = 0; s < kAtStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NWG) {
    // ---- producer warpgroup: one thread starts every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(NWG == 1 ? 24 : 40));
    if (threadIdx.x != 128 * NWG) return;
    int s = 0, x = 0;
    uint32_t phase = 0, kv_phase = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int bh = it / n_kb, k0 = (it % n_kb) * kAtRows * NWG, b = bh / a.H, h = bh % a.H;
      mbar_wait(kv_empty(x), kv_phase ^ 1);  // the first pass finds both buffers free
      mbar_arrive_tx(kv_full(x), KV);
#pragma unroll
      for (int w = 0; w < NWG; ++w)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int row = k0 + kAtRows * w;
          tma_load4(base + x * KV + w * OP + c * kAtTile, &map_k, kv_full(x), 64 * c, row, h, b);
          tma_load4(base + x * KV + (NWG + w) * OP + c * kAtTile, &map_v, kv_full(x), 64 * c,
                    row, h, b);
        }
      if (++x == kBwKV) x = 0, kv_phase ^= 1;
      for (int qt = 0; qt < nq; ++qt) {
        mbar_wait(empty(s), phase ^ 1);
        mbar_arrive_tx(full(s), STAGE);
        const uint32_t dst = ring + s * STAGE;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          tma_load4(dst + c * kAtTile, &map_q, full(s), 64 * c, qt * kAtRows, h, b);
          tma_load4(dst + OP + c * kAtTile, &map_do, full(s), 64 * c, qt * kAtRows, h, b);
        }
        bulk_load(dst + 2 * OP, a.stats + (size_t)bh * a.s_pad + qt * kAtRows,
                  kAtRows * sizeof(float4), full(s));
        if (++s == kAtStages) s = 0, phase ^= 1;
      }
    }
  } else {
    // ---- consumers: warpgroup w, warp wi; this lane's rows are keys
    // kw0 + 16 wi + g + 8 hh; accumulator element 4 j + 2 hh + e of S^T is
    // query 8 j + 2 t + e of the step, of dV, dK or dq column 8 j + 2 t + e
    // of a 64-column chunk
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int w = threadIdx.x / 128, wi = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t ds = dss + w * kAtTile;
    int s = 0, x = 0;
    uint32_t phase = 0, kv_phase = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int bh = it / n_kb, b = bh / a.H, h = bh % a.H;
      const int kw0 = (it % n_kb) * kAtRows * NWG + kAtRows * w;
      const bool live = kw0 < S;  // a warpgroup past the last key only keeps the ring turning
      // with two warpgroups, the block's partial dq is warpgroup 0's plus
      // warpgroup 1's (keys in order), where warpgroup 1 has keys
      const bool pair_dq = NWG == 2 && kw0 - kAtRows * w + kAtRows < S;
      const bool key_ok[2] = {kw0 + 16 * wi + g < S, kw0 + 16 * wi + g + 8 < S};
      const uint32_t ks = base + x * KV + w * OP, vs = base + x * KV + (NWG + w) * OP;
      float dv[DC][32], dk[DC][32];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        zero(dv[c]);
        zero(dk[c]);
      }
      float fold[2] = {0.f, 0.f};  // this lane's part of sum_q r_q relu(A dA), keys g, g + 8
      float* part = a.dq_part + ((size_t)(it % n_kb) * a.B * a.H + bh) * (size_t)a.s_pad * DP;
      mbar_wait(kv_full(x), kv_phase);
      for (int qt = 0; qt < nq; ++qt) {
        mbar_wait(full(s), phase);
        if (live) {
          const uint32_t qs = ring + s * STAGE, os = qs + OP;
          const float4* stat = reinterpret_cast<const float4*>(bw_raw + (qs + 2 * OP - raw));
          // queries hq QH .. hq QH + QH - 1 of the tile; not unrolled: with
          // DC = 2 the two steps interleaved spill past 232 registers
#pragma unroll 1
          for (int hq = 0; hq < DC; ++hq) {
            float sc[NA], dg[NA];  // fresh: the first k step does not read them
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < 4 * DC; ++kk)
              wg_ss<0, 0>(sc, kmajor(ks, kk), kmajor(qs + hq * QH * 128, kk), kk > 0);
#pragma unroll
            for (int kk = 0; kk < 4 * DC; ++kk)
              wg_ss<0, 0>(dg, kmajor(vs, kk), kmajor(os + hq * QH * 128, kk), kk > 0);
            wg_commit();
            wg_wait0();
            g16_fence_regs(sc);
            g16_fence_regs(dg);

#pragma unroll
            for (int j = 0; j < QH / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float4 st = stat[hq * QH + 8 * j + 2 * t + e];  // m, 1/l, dsum, r
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                  const int i = 4 * j + 2 * hh + e;
                  const float p = key_ok[hh] ? ex2(sc[i] * a.scale_log2 - st.x) * st.y : 0.f;
                  fold[hh] += fmaxf(p * dg[i], 0.f) * st.w;
                  dg[i] = p * (dg[i] - st.z) * a.scale;
                  sc[i] = p;
                }
              }
            // A^T and dS^T as bf16 A fragments (16 queries each), and dS^T
            // into shared memory, row = key, in the 128-byte swizzle
            uint32_t pa[QH / 16][4], sa[QH / 16][4];
#pragma unroll
            for (int kk = 0; kk < QH / 16; ++kk) {
              a_from_acc_bf16(&sc[8 * kk], &sc[8 * kk + 4], pa[kk]);
              a_from_acc_bf16(&dg[8 * kk], &dg[8 * kk + 4], sa[kk]);
            }
            const int row = 16 * wi + g;  // and row + 8, of the same swizzle phase
            const uint32_t at = ds + row * 128 + 4 * t;
#pragma unroll
            for (int kk = 0; kk < QH / 16; ++kk)
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) {
                const uint32_t col = (((hq * QH / 8 + 2 * kk + jj) ^ (row & 7)) << 4);
                asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at + col), "r"(sa[kk][2 * jj])
                             : "memory");
                asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at + 8 * 128 + col),
                             "r"(sa[kk][2 * jj + 1])
                             : "memory");
              }
            // dV += A^T dout, dK += dS^T q over this step's queries
            wg_fence();
#pragma unroll
            for (int c = 0; c < DC; ++c)
#pragma unroll
              for (int kk = 0; kk < QH / 16; ++kk) {
                const int k16 = hq * QH / 16 + kk;
                wg_rs<1>(dv[c], pa[kk], mnmajor(os + c * kAtTile, k16), 1);
                wg_rs<1>(dk[c], sa[kk], mnmajor(qs + c * kAtTile, k16), 1);
              }
            wg_commit();
            wg_wait0();
          }
          wg_publish(w);
          // the partial dq of this warpgroup's keys, one 64-column chunk at a time
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            float dq[32];  // fresh, as sc
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wg_ss<1, 1>(dq, mnmajor(ds, kk), mnmajor(ks + c * kAtTile, kk), kk > 0);
            wg_commit();
            wg_wait0();
            g16_fence_regs(dq);
            if (pair_dq) {
              float* xb = reinterpret_cast<float*>(
                              bw_raw + (xchg - raw + ((qt & 1) * DC + c) * 128 * 32 * 4)) +
                          threadIdx.x % 128;
              if (w == 1) {
#pragma unroll
                for (int i = 0; i < 32; ++i) xb[128 * i] = dq[i];
              }
              asm volatile("bar.sync 3, 256;\n" ::: "memory");
              if (w == 1) continue;
#pragma unroll
              for (int i = 0; i < 32; ++i) dq[i] += xb[128 * i];
            }
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float* prow =
                  part + (size_t)(qt * kAtRows + 16 * wi + g + 8 * hh) * DP + 64 * c + 2 * t;
#pragma unroll
              for (int j = 0; j < 8; ++j)
                *reinterpret_cast<float2*>(prow + 8 * j) =
                    make_float2(dq[4 * j + 2 * hh], dq[4 * j + 2 * hh + 1]);
            }
          }
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            g16_fence_regs(dv[c]);
            g16_fence_regs(dk[c]);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));
        if (++s == kAtStages) s = 0, phase ^= 1;
      }
      // this block's K and V are read no more: the producer may load the next
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty(x));
      if (++x == kBwKV) x = 0, kv_phase ^= 1;
      if (!live) continue;

#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (!key_ok[hh]) continue;
        const int key = kw0 + 16 * wi + g + 8 * hh;
        const long long rk = head_at(a.sdk, b, h) + (long long)key * a.sdk.s;
        const long long rv = head_at(a.sdv, b, h) + (long long)key * a.sdv.s;
#pragma unroll
        for (int c = 0; c < DC; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int d = 64 * c + 8 * j + 2 * t, i = 4 * j + 2 * hh;
            if (d + 1 < a.dh) {
              store2_any(a.dk, rk + d, dk[c][i], dk[c][i + 1], a.bf, a.pair_kv);
              store2_any(a.dv, rv + d, dv[c][i], dv[c][i + 1], a.bf, a.pair_kv);
            } else if (d < a.dh) {
              store_any(a.dk, rk + d, dk[c][i], a.bf);
              store_any(a.dv, rv + d, dv[c][i], a.bf);
            }
          }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float f = quad_sum(fold[hh]);  // fixed order over the 4 lanes
        if (t == 0 && key_ok[hh]) a.e_part[(size_t)bh * S + kw0 + 16 * wi + g + 8 * hh] = f;
      }
    }
  }
}

// blockIdx.y == 0: dq[b, h, q, 4 i .. 4 i + 3] = the partials summed in key
// order (the first partial plus the next, and so on); 1: e_row[b, k] =
// (1/H) sum_h e_part[b, h, k], the heads in order (as e_row_kernel).
__global__ void attn_bwd_finish_kernel(BwdArgs a, int DP) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int S = a.S;
  if (blockIdx.y == 1) {
    if (idx >= (long long)a.B * S) return;
    const int b = idx / S, k = idx % S;
    float sum = 0.f;
    for (int h = 0; h < a.H; ++h) sum += a.e_part[((size_t)b * a.H + h) * S + k];
    a.e_row[idx] = sum * (1.0f / a.H);
    return;
  }
  const int groups = (a.dh + 3) / 4;
  if (idx >= (long long)a.B * a.H * S * groups) return;
  const int col = (int)(idx % groups) * 4;
  const long long row = idx / groups;  // (b, h, q)
  const int q = row % S;
  const long long bh = row / S;
  const size_t plane = (size_t)a.B * a.H * a.s_pad * DP;
  const float* p = a.dq_part + ((size_t)bh * a.s_pad + q) * DP + col;
  float4 acc = *reinterpret_cast<const float4*>(p);
  for (int i = 1; i < a.n_sub; ++i) add4(acc, *reinterpret_cast<const float4*>(p + i * plane));
  const int b = bh / a.H, h = bh % a.H;
  const long long at = head_at(a.sdq, b, h) + (long long)q * a.sdq.s + col;
  const float v[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
  for (int e = 0; e < 4; e += 2) {
    if (col + e + 1 < a.dh)
      store2_any(a.dq, at + e, v[e], v[e + 1], a.bf, a.pair_q);
    else if (col + e < a.dh)
      store_any(a.dq, at + e, v[e], a.bf);
  }
}

// ---------------------------------------------------------------------------
// The attention forward with bf16 products on wgmma and TMA (#1, #5 and #7
// in the fast_dots mode): out = softmax(q k^T * scale) v, A normalised,
// 2^(s - m) / l, before it is rounded to bf16 for the A v product, as the
// JAX body rounds e / sum(e) (flash_attention.py _fwd_kernel :79-88). One
// launch, two with operands that TMA cannot read in place (attn_pack_kernel
// first):
//
//   attn_fwd_tile_wgmma_kernel   where every key of a row fits the
//                           accumulators (S <= 64 kFwdTiles = 256), a block
//                           a 64-query tile: its thread 0 starts every TMA
//                           copy at once (q, all of K, all of V, a barrier a
//                           tile); the warpgroup computes s = q k^T for
//                           every key tile (wgmma, 32 accumulators a tile),
//                           the row max and sum from registers, A = 2^(s -
//                           m) / l rounded to bf16 in the accumulator
//                           layout, which is the A fragment of o = A v
//                           (wgmma with A from registers, v read
//                           MN-major): two S*S*dh products, the function's
//                           own. 154 registers a thread and 72 KB of tiles
//                           at dh <= 64: three blocks an SM;
//   attn_fwd_sweeps_wgmma_kernel past 256 keys: one warpgroup a 64-query
//                           tile; a producer warp streams K (first sweep),
//                           then K and V (second) through a two-stage ring;
//                           the first sweep takes the online row max and
//                           sum, the second s again and o += A v: three
//                           S*S*dh products for two.
//
// Outputs stored in bf16 with rows on the 16-byte grid go through the q
// tile's shared memory, 16 bytes a thread (fwd16_store_staged); others two
// columns a store (fwd16_store).
// Bound by bytes at ViT-B's S = 197 (16 S*dh bytes of bf16 q, k, v and out
// against 4 S*S*dh flops an (image, head)), by the tensor cores and the
// exponentials at long S. Every output element is written by one thread
// after a fixed order of sums: no atomics, the same bits on every call and
// whatever the operands' layout (packed operands hold the same bf16
// values). Keys at or past S are masked (A = 0); queries at or past S are
// computed on TMA's zero rows and not stored.
// ---------------------------------------------------------------------------

constexpr int kFwdTiles = 4;  // key tiles the one-sweep forward holds: S <= 256

struct FwdArgs {
  void* out;   // [B, H, S, dh] view, fp32 or bf16 (bf)
  Strides so;
  int S, dh;
  float scale_log2;
  bool bf, pair;  // pair: two neighbouring columns a store
  bool stage;     // bf16 rows on the 16-byte grid: 16-byte stores from shared memory
};

// Shared memory of attn_fwd_tile_wgmma_kernel for nk key tiles, and of
// attn_fwd_sweeps_wgmma_kernel.
__host__ __device__ constexpr uint32_t fwd16_tile_smem(int DC, int nk) {
  return kAtSmemSlack + (1 + 2 * nk) * DC * kAtTile;
}
__host__ __device__ constexpr uint32_t fwd16_sweeps_smem(int DC) {
  return kAtSmemSlack + (1 + 2 * kAtStages) * DC * kAtTile;
}

// Rows 16 wi + g (+ 8) of o, a warpgroup's 64 x 64 DC accumulators, into
// the output rows q0 + ...; rows at or past S and columns at or past dh are
// not written.
template <int DC>
__device__ __forceinline__ void fwd16_store(const FwdArgs& a, int b, int h, int q0,
                                            const float (&o)[DC][32], int wi, int g, int t) {
  const long long head = head_at(a.so, b, h);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + 16 * wi + g + 8 * hh;
    if (row >= a.S) continue;
    const long long at = head + (long long)row * a.so.s;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * c + 8 * j + 2 * t, i = 4 * j + 2 * hh;
        if (d + 1 < a.dh)
          store2_any(a.out, at + d, o[c][i], o[c][i + 1], a.bf, a.pair);
        else if (d < a.dh)
          store_any(a.out, at + d, o[c][i], a.bf);
      }
  }
}

// The same through shared memory (a.stage): the warpgroup's o, rounded to
// bf16, into the 64 DC x 64 tile at `tile` (a q tile's, whose last reader
// has completed) in the 128-byte swizzle, then read back 16 bytes a thread
// and stored a row of 64 columns by 8 threads. The block's one consumer
// warpgroup meets on named barrier 1.
template <int DC>
__device__ __forceinline__ void fwd16_store_staged(const FwdArgs& a, int b, int h, int q0,
                                                   const float (&o)[DC][32], uint32_t tile,
                                                   int wi, int g, int t) {
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = 16 * wi + g + 8 * hh;
      const uint32_t at = tile + c * kAtTile + row * 128 + 4 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * hh;
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at + ((j ^ (row & 7)) << 4)),
                     "r"(pack_bf16(o[c][i], o[c][i + 1]))
                     : "memory");
      }
    }
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  const long long head = head_at(a.so, b, h);
  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int k = 0; k < 4 * DC; ++k) {
    const int u = threadIdx.x % 128 + 128 * k;  // 16-byte unit: chunk, row, column
    const int c = u / 512, row = (u / 8) % 64, col = u % 8;
    const int d = 64 * c + 8 * col;
    if (q0 + row >= a.S || d >= a.dh) continue;
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(tile + c * kAtTile + row * 128 + ((col ^ (row & 7)) << 4))
                 : "memory");
    *reinterpret_cast<uint4*>(out + head + (long long)(q0 + row) * a.so.s + d) = v;
  }
}

// The scores of key tile kt (accumulator element 4 j + 2 hh + e is key 64
// kt + 8 j + 2 t + e of row hh) in the log2 domain; keys at or past S -inf.
__device__ __forceinline__ void fwd16_scale_mask(float (&s)[32], int kt, int S, int t,
                                                 float scale_log2) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = kt * kAtRows + 8 * j + 2 * t + e < S;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float& v = s[4 * j + 2 * hh + e];
        v = ok ? v * scale_log2 : -INFINITY;
      }
    }
}

// A = p inv of one key tile (p = 2^(s - m), in place), as the four bf16 A
// fragments of its 16-key steps.
__device__ __forceinline__ void fwd16_probs(float (&p)[32], const float (&inv)[2],
                                            uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] *= inv[(i >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) a_from_acc_bf16(&p[8 * kk], &p[8 * kk + 4], pa[kk]);
}

// One sweep, a block of one warpgroup a 64-query tile (blockIdx.x) of head
// (h = blockIdx.y, b = blockIdx.z); this lane's rows are 16 wi + g + 8 hh
// of the tile. Shared memory: the q tile, K's nk tiles, V's nk tiles, then
// a barrier each (q; k tile j at 8 (kFwdTiles + j), v tile j at 8 (2
// kFwdTiles + j)).
template <int DC>
__global__ void __launch_bounds__(128)
attn_fwd_tile_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v, FwdArgs a) {
  constexpr uint32_t OP = DC * kAtTile;
  extern __shared__ __align__(1024) unsigned char at_raw[];
  const uint32_t qs = (smem_u32(at_raw) + 1023) & ~1023u;
  const int b = blockIdx.z, h = blockIdx.y, S = a.S, nk = (S + kAtRows - 1) / kAtRows;
  const uint32_t ks = qs + OP, vs = ks + nk * OP, bars = vs + nk * OP;
  auto kbar = [&](int j) { return bars + 8 * (kFwdTiles + j); };
  auto vbar = [&](int j) { return bars + 8 * (2 * kFwdTiles + j); };
  if (threadIdx.x == 0) {  // every copy at once
    for (int i = 0; i < 3 * kFwdTiles; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arrive_tx(bars, OP);
    for (int c = 0; c < DC; ++c)
      tma_load4(qs + c * kAtTile, &map_q, bars, 64 * c, blockIdx.x * kAtRows, h, b);
    for (int j = 0; j < nk; ++j) {
      mbar_arrive_tx(kbar(j), OP);
      for (int c = 0; c < DC; ++c)
        tma_load4(ks + j * OP + c * kAtTile, &map_k, kbar(j), 64 * c, j * kAtRows, h, b);
    }
    for (int j = 0; j < nk; ++j) {
      mbar_arrive_tx(vbar(j), OP);
      for (int c = 0; c < DC; ++c)
        tma_load4(vs + j * OP + c * kAtTile, &map_v, vbar(j), 64 * c, j * kAtRows, h, b);
    }
  }
  __syncthreads();

  const int wi = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  float s[kFwdTiles][32];  // fresh: the first k step does not read them
  mbar_wait(bars, 0);
  wg_fence();
#pragma unroll
  for (int j = 0; j < kFwdTiles; ++j) {
    if (j >= nk) break;
    mbar_wait(kbar(j), 0);
#pragma unroll
    for (int kk = 0; kk < 4 * DC; ++kk)
      wg_ss<0, 0>(s[j], kmajor(qs, kk), kmajor(ks + j * OP, kk), kk > 0);
  }
  wg_commit();
  wg_wait0();
#pragma unroll
  for (int j = 0; j < kFwdTiles; ++j) g16_fence_regs(s[j]);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv[2];
#pragma unroll
  for (int j = 0; j < kFwdTiles; ++j) {
    if (j >= nk) break;
    fwd16_scale_mask(s[j], j, S, t, a.scale_log2);
#pragma unroll
    for (int e = 0; e < 32; ++e) m[(e >> 1) & 1] = fmaxf(m[(e >> 1) & 1], s[j][e]);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {  // the 4 lanes of a quad share a row
    m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
    m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 2));
  }
#pragma unroll
  for (int j = 0; j < kFwdTiles; ++j) {
    if (j >= nk) break;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      s[j][e] = ex2(s[j][e] - m[(e >> 1) & 1]);
      l[(e >> 1) & 1] += s[j][e];
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) inv[hh] = 1.0f / quad_sum(l[hh]);

  // A = p / l as the bf16 A fragments of o = A v, in registers (the
  // accumulator layout); the 16-key steps at or past S are skipped
  uint32_t pa[kFwdTiles][4][4];
#pragma unroll
  for (int j = 0; j < kFwdTiles; ++j) {
    if (j >= nk) break;
    fwd16_probs(s[j], inv, pa[j]);
  }
  float o[DC][32];
  wg_fence();
#pragma unroll
  for (int j = 0; j < kFwdTiles; ++j) {
    if (j >= nk) break;
    mbar_wait(vbar(j), 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (j * kAtRows + 16 * kk >= S) break;
#pragma unroll
      for (int c = 0; c < DC; ++c)
        wg_rs<1>(o[c], pa[j][kk], mnmajor(vs + j * OP + c * kAtTile, kk), j > 0 || kk > 0);
    }
  }
  wg_commit();
  wg_wait0();
#pragma unroll
  for (int c = 0; c < DC; ++c) g16_fence_regs(o[c]);
  const int q0 = blockIdx.x * kAtRows;
  if (a.stage)
    fwd16_store_staged<DC>(a, b, h, q0, o, qs, wi, g, t);
  else
    fwd16_store<DC>(a, b, h, q0, o, wi, g, t);
}

// Two sweeps over the key tiles of one (64-query tile, head, image): the
// online row max and sum, then A = 2^(s - m) / l and o += A v. Warps 0-3
// are the consumer warpgroup, warp 4 the producer.
template <int DC>
__global__ void __launch_bounds__(128 + kAtProducer)
attn_fwd_sweeps_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, FwdArgs a) {
  constexpr uint32_t OP = DC * kAtTile;
  extern __shared__ __align__(1024) unsigned char at_raw[];
  const uint32_t base = (smem_u32(at_raw) + 1023) & ~1023u;
  const uint32_t qs = base, ring = base + OP;  // stage s: k at ring + 2 OP s, v after it
  const uint32_t bars = ring + kAtStages * 2 * OP;
  auto full = [&](int s) { return bars + 8 + 8 * s; };
  auto empty = [&](int s) { return bars + 8 + 8 * (kAtStages + s); };
  const int b = blockIdx.z, h = blockIdx.y, S = a.S;
  const int q0 = blockIdx.x * kAtRows, nk = (S + kAtRows - 1) / kAtRows;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < kAtStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // ---- producer: one thread starts every copy
    if (threadIdx.x != 128) return;
    mbar_arrive_tx(bars, OP);
#pragma unroll
    for (int c = 0; c < DC; ++c) tma_load4(qs + c * kAtTile, &map_q, bars, 64 * c, q0, h, b);
    int s = 0;
    uint32_t phase = 0;
    for (int it = 0; it < 2 * nk; ++it) {
      const int kt = it < nk ? it : it - nk;
      const bool with_v = it >= nk;
      mbar_wait(empty(s), phase ^ 1);  // the first pass finds every stage free
      mbar_arrive_tx(full(s), with_v ? 2 * OP : OP);
      const uint32_t dst = ring + s * 2 * OP;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        tma_load4(dst + c * kAtTile, &map_k, full(s), 64 * c, kt * kAtRows, h, b);
        if (with_v)
          tma_load4(dst + OP + c * kAtTile, &map_v, full(s), 64 * c, kt * kAtRows, h, b);
      }
      if (++s == kAtStages) s = 0, phase ^= 1;
    }
    return;
  }

  // ---- consumers: this lane's rows are queries q0 + 16 wi + g + 8 hh
  const int wi = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv[2];
  mbar_wait(bars, 0);
  int s = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < nk; ++kt) {  // sweep 1: the online statistics
    mbar_wait(full(s), phase);
    const uint32_t kts = ring + s * 2 * OP;
    float sc[32];  // fresh, as in fwd16_tile
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * DC; ++kk) wg_ss<0, 0>(sc, kmajor(qs, kk), kmajor(kts, kk), kk > 0);
    wg_commit();
    wg_wait0();
    g16_fence_regs(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    if (++s == kAtStages) s = 0, phase ^= 1;
    fwd16_scale_mask(sc, kt, S, t, a.scale_log2);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = m[hh];
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      l[hh] *= ex2(m[hh] - mx);  // 0 on the first tile
      m[hh] = mx;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) l[hh] += ex2(sc[4 * j + 2 * hh + e] - mx);
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) inv[hh] = 1.0f / quad_sum(l[hh]);

  float o[DC][32];
  for (int kt = 0; kt < nk; ++kt) {  // sweep 2: o += A v, A normalised first
    mbar_wait(full(s), phase);
    const uint32_t kts = ring + s * 2 * OP, vts = kts + OP;
    float sc[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * DC; ++kk) wg_ss<0, 0>(sc, kmajor(qs, kk), kmajor(kts, kk), kk > 0);
    wg_commit();
    wg_wait0();
    g16_fence_regs(sc);
    fwd16_scale_mask(sc, kt, S, t, a.scale_log2);
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = ex2(sc[i] - m[(i >> 1) & 1]);
    uint32_t pa[4][4];
    fwd16_probs(sc, inv, pa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < DC; ++c)
        wg_rs<1>(o[c], pa[kk], mnmajor(vts + c * kAtTile, kk), kt > 0 || kk > 0);
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int c = 0; c < DC; ++c) g16_fence_regs(o[c]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    if (++s == kAtStages) s = 0, phase ^= 1;
  }
  if (a.stage)
    fwd16_store_staged<DC>(a, b, h, q0, o, qs, wi, g, t);
  else
    fwd16_store<DC>(a, b, h, q0, o, wi, g, t);
}

struct PackArgs {
  Operand src[4];
  bf16* dst[4];  // null: the operand is read in place
};

// dst[o][b, h, s, :dh8] = src[o][b, h, s, :dh] rounded to bf16, zeros past
// dh; eight columns a thread (one 16-byte store).
__global__ void attn_pack_kernel(PackArgs p, int H, int S, int dh, int dh8, long long rows,
                                 bool bf) {
  const int o = blockIdx.y;
  bf16* dst = p.dst[o];
  if (!dst) return;
  const int per = dh8 / 8;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * per) return;
  const long long row = i / per;
  const int c0 = (int)(i % per) * 8, s = row % S;
  const long long bh = row / S;
  const long long at = head_at(p.src[o].st, bh / H, bh % H) + (long long)s * p.src[o].st.s;
  float x[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = c0 + e < dh ? load_any(p.src[o].p, at + c0 + e, bf) : 0.f;
  *reinterpret_cast<uint4*>(dst + row * dh8 + c0) =
      make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]),
                 pack_bf16(x[6], x[7]));
}

// TMA reads an operand in place where it is bf16 and every row starts on a
// 16-byte boundary (strides of dimensions of size 1 do not matter);
// ops/flash_attention.tma_packs states the same rule.
bool attn16_in_place(const Operand& o, int B, int H, int S, int dh, bool bf) {
  return bf && dh % 8 == 0 && aligned(o.p, 16) && (B == 1 || o.st.b % 8 == 0) &&
         (H == 1 || o.st.h % 8 == 0) && (S == 1 || o.st.s % 8 == 0);
}

// A 4-D map (dh8, S, H, B; innermost first) of a bf16 operand, copied in
// 64 x 64 boxes with the 128-byte swizzle that wgmma reads; TMA fills what
// lies past dh8 or S with zeros (an operand read in place has dh8 = dh; a
// packed one holds zeros past dh).
bool attn16_map(CUtensorMap* map, const Operand& o, int B, int H, int S, int dh) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (!encode) return false;
  // a dimension of size 1 takes a stride that TMA accepts; it is never stepped
  const cuuint64_t rs = S > 1 ? 2 * o.st.s : (cuuint64_t)(dh + 7) / 8 * 16;
  const cuuint64_t hs = H > 1 ? 2 * o.st.h : rs * S;
  const cuuint64_t bs = B > 1 ? 2 * o.st.b : hs * H;
  const cuuint64_t dims[4] = {(cuuint64_t)(dh + 7) / 8 * 8, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {rs, hs, bs};
  const cuuint32_t box[4] = {64, kAtRows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(o.p), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Sets a kernel's dynamic shared-memory limit to `bytes` once a card (the
// kernel's largest need); every later call is free.
template <auto KERNEL>
cudaError_t smem_limit_once(uint32_t bytes) {
  static unsigned long long devices = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && (devices >> dev & 1)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < 64) devices |= 1ull << dev;
  return err;
}

int bwd16_forced_keys = 0;  // 0: the table; 64 or 128: that width (measurements)

// Keys a block of the keys pass holds: 128 (two warpgroups, one block an
// SM, half the dq partials) where the 128-key blocks still give every SM
// one, else 64 (one warpgroup, two blocks an SM); 64 past dh = 64, where
// two warpgroups' dK and dV accumulators do not fit the registers. Measured
// in PERF.md (scripts/attn_bf16_ab.py): 128 faster at B = 8 and 32
// (S = 197, H = 12), 64 at B = 1 and at S = 2,000 and 4,000 (H = 2).
int bwd16_keys(int S, int dh, int BH) {
  if (dh > 64) return 64;
  if (bwd16_forced_keys) return bwd16_forced_keys;
  return (long long)((S + 127) / 128) * BH >= num_sms() ? 128 : 64;
}

// Launches a pass on a persistent grid: as many blocks as the SMs hold at
// once (the kernel's occupancy, asked once a card, when its shared-memory
// limit is set), or one an item where there are fewer.
template <auto KERNEL>
cudaError_t bwd16_persistent(int threads, uint32_t smem, long long items,
                             const CUtensorMap (&m)[4], const BwdArgs& a, cudaStream_t stream) {
  static int resident[64] = {0};  // blocks an SM, by device
  int dev = 0;
  cudaGetDevice(&dev);
  int per_sm = dev < 64 ? resident[dev] : 0;
  if (per_sm == 0) {
    cudaError_t err =
        cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, KERNEL, threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    if (dev < 64) resident[dev] = per_sm;
  }
  const long long slots = (long long)per_sm * num_sms();
  KERNEL<<<(unsigned)(items < slots ? items : slots), threads, smem, stream>>>(m[0], m[1], m[2],
                                                                              m[3], a);
  return cudaGetLastError();
}

// The three passes for dh <= 64 DC, with blocks of 64 NWG keys in the keys
// pass.
template <int DC, int NWG>
cudaError_t bwd16_launch(const CUtensorMap (&m)[4], BwdArgs a, cudaStream_t stream) {
  const long long heads = (long long)a.B * a.H;
  constexpr uint32_t smem = bwd16_stats_smem<DC>();
  cudaError_t err = smem_limit_once<attn_bwd_stats_wgmma_kernel<DC>>(smem);
  if (err != cudaSuccess) return err;
  attn_bwd_stats_wgmma_kernel<DC><<<dim3(a.s_pad / kAtRows, a.H, a.B), 128 + kAtProducer, smem,
                                    stream>>>(m[0], m[1], m[2], m[3], a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  a.n_sub = (a.S + kAtRows * NWG - 1) / (kAtRows * NWG);  // partial dq sums of a query
  err = bwd16_persistent<attn_bwd_keys_wgmma_kernel<DC, NWG>>(
      128 * (NWG + 1), bwd16_keys_smem<DC, NWG>(), heads * a.n_sub, m, a, stream);
  if (err != cudaSuccess) return err;
  const long long dq_threads = heads * a.S * ((a.dh + 3) / 4);
  const long long threads = dq_threads > (long long)a.B * a.S ? dq_threads : (long long)a.B * a.S;
  attn_bwd_finish_kernel<<<dim3((unsigned)((threads + 255) / 256), 2), 256, 0, stream>>>(
      a, 64 * DC);
  return cudaGetLastError();
}

// Points each operand that TMA cannot read in place (attn16_in_place) at a
// [B, H, S, dh8] bf16 slot of `packed` (one a slot, in operand order) and
// rounds it there (attn_pack_kernel, one launch for all), then encodes the
// N maps. A null `packed` where a slot is needed: cudaErrorInvalidValue.
template <int N>
cudaError_t attn16_operands(Operand (&ops)[N], CUtensorMap (&maps)[N], int B, int H, int S,
                            int dh, bool bf, bf16* packed, cudaStream_t stream) {
  static_assert(N <= 4, "one pack launch holds four operands");
  if (B < 1 || S < 1 || H < 1 || dh < 1 || dh > kMaxDh || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  const int dh8 = (dh + 7) / 8 * 8;
  const long long rows = (long long)B * H * S;
  PackArgs pack;
  int slots = 0;
  for (int o = 0; o < 4; ++o) {
    pack.dst[o] = nullptr;
    if (o >= N) continue;
    pack.src[o] = ops[o];
    if (attn16_in_place(ops[o], B, H, S, dh, bf)) continue;
    if (!packed) return cudaErrorInvalidValue;
    pack.dst[o] = packed + slots++ * rows * dh8;
    ops[o] = {pack.dst[o], {H * S * (long long)dh8, S * (long long)dh8, dh8}};
  }
  if (slots) {
    const long long threads = rows * (dh8 / 8);
    attn_pack_kernel<<<dim3((unsigned)((threads + 255) / 256), N), 256, 0, stream>>>(
        pack, H, S, dh, dh8, rows, bf);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  for (int o = 0; o < N; ++o)
    if (!attn16_map(&maps[o], ops[o], B, H, S, dh)) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The backward of every caller: the operands through attn16_operands, then
// the passes.
cudaError_t attn_bwd_bf16(Operand (&ops)[4], BwdArgs& a, bf16* packed, cudaStream_t stream) {
  CUtensorMap maps[4];
  const cudaError_t err = attn16_operands(ops, maps, a.B, a.H, a.S, a.dh, a.bf, packed, stream);
  if (err != cudaSuccess) return err;
  if (a.dh > 64) return bwd16_launch<2, 1>(maps, a, stream);
  return bwd16_keys(a.S, a.dh, a.B * a.H) == 128 ? bwd16_launch<1, 2>(maps, a, stream)
                                                 : bwd16_launch<1, 1>(maps, a, stream);
}

template <int DC>
cudaError_t fwd16_launch(const CUtensorMap (&m)[3], FwdArgs a, int B, int H,
                         cudaStream_t stream) {
  const int nk = (a.S + kAtRows - 1) / kAtRows;
  cudaError_t err;
  if (nk > kFwdTiles) {
    constexpr uint32_t smem = fwd16_sweeps_smem(DC);
    err = smem_limit_once<attn_fwd_sweeps_wgmma_kernel<DC>>(smem);
    if (err != cudaSuccess) return err;
    attn_fwd_sweeps_wgmma_kernel<DC><<<dim3(nk, H, B), 128 + kAtProducer, smem, stream>>>(
        m[0], m[1], m[2], a);
    return cudaGetLastError();
  }
  err = smem_limit_once<attn_fwd_tile_wgmma_kernel<DC>>(fwd16_tile_smem(DC, kFwdTiles));
  if (err != cudaSuccess) return err;
  attn_fwd_tile_wgmma_kernel<DC><<<dim3(nk, H, B), 128, fwd16_tile_smem(DC, nk), stream>>>(
      m[0], m[1], m[2], a);
  return cudaGetLastError();
}

// The forward of every caller: the operands through attn16_operands, then
// one kernel.
cudaError_t attn_fwd_bf16(Operand (&ops)[3], FwdArgs& a, int B, int H, bf16* packed,
                          cudaStream_t stream) {
  CUtensorMap maps[3];
  const cudaError_t err = attn16_operands(ops, maps, B, H, a.S, a.dh, a.bf, packed, stream);
  if (err != cudaSuccess) return err;
  return a.dh > 64 ? fwd16_launch<2>(maps, a, B, H, stream)
                   : fwd16_launch<1>(maps, a, B, H, stream);
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

// Bytes of dynamic shared memory one attention block needs: the forward,
// its block for S (q and every key tile where one sweep runs, else a ring
// of two); the backward, its largest
// block, the keys pass at its widest key tile.
int tmx_attn_smem_bf16(int S, int dh, int backward) {
  const int DC = dh <= 64 ? 1 : 2;
  if (!backward) {
    const int nk = (S + kAtRows - 1) / kAtRows;
    if (nk > kFwdTiles) return (int)fwd16_sweeps_smem(DC);
    return (int)fwd16_tile_smem(DC, nk);
  }
  return (int)(DC == 1 ? bwd16_keys_smem<1, 2>() : bwd16_keys_smem<2, 1>());
}

// q, k, v, out: [B, H, S, dh] operands, bf16 where bf else fp32; strides:
// [4][3] (batch, head, row) element strides of q, k, v, out in that order.
// packed: one [B, H, S, dh8] bf16 slot (dh8: dh rounded up to 8) for each
// of q, k, v that TMA cannot read in place (fp32, or rows off the 16-byte
// grid), in operand order, or null where none needs one
// (cudaErrorInvalidValue if one does); ops/flash_attention.fwd16_plan
// sizes it.
int tmx_attn_fwd_bf16(const void* q, const void* k, const void* v, void* out, void* packed,
                      const long long* strides, int B, int S, int H, int dh, float scale, int bf,
                      void* stream) {
  Operand ops[3] = {{q, strides_at(strides, 0)},
                    {k, strides_at(strides, 1)},
                    {v, strides_at(strides, 2)}};
  FwdArgs a;
  a.out = out;
  a.so = strides_at(strides, 3);
  a.S = S;
  a.dh = dh;
  a.scale_log2 = scale * 1.4426950408889634f;
  a.bf = bf != 0;
  a.pair = dh % 2 == 0 && aligned(out, a.bf ? 4 : 8) && a.so.b % 2 == 0 && a.so.h % 2 == 0 &&
           a.so.s % 2 == 0;
  a.stage = a.bf && dh % 8 == 0 && aligned(out, 16) && a.so.b % 8 == 0 && a.so.h % 8 == 0 &&
            a.so.s % 8 == 0;
  return (int)attn_fwd_bf16(ops, a, B, H, static_cast<bf16*>(packed), (cudaStream_t)stream);
}

// q, k, v, dout in and dq, dk, dv out: [B, H, S, dh] operands, bf16 where
// bf else fp32; strides: [7][3] (batch, head, row) element strides of q, k,
// v, dout, dq, dk, dv in that order. r, e_row: [B, S] fp32. Scratch, with
// s_pad = S rounded up to 64 and n_sub = s_pad / 64 (key blocks of 128 use
// half): stats [B, H, s_pad, 4]
// fp32; e_part [B, H, S] fp32; dq_part [n_sub, B, H, s_pad, 64 DC] fp32 (DC
// = 1 where dh <= 64, else 2); packed: one [B, H, S, dh8] bf16 slot (dh8: dh
// rounded up to 8) for each operand that TMA cannot read in place (fp32, or
// rows off the 16-byte grid), in operand order, or null where none needs one
// (cudaErrorInvalidValue if one does). ops/flash_attention.bwd16_plan sizes
// them.
int tmx_attn_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                      const float* r, void* dq, void* dk, void* dv, float* stats, float* e_part,
                      float* dq_part, void* packed, float* e_row, const long long* strides, int B,
                      int S, int H, int dh, float scale, int bf, void* stream) {
  Operand ops[4] = {{q, strides_at(strides, 0)},
                    {k, strides_at(strides, 1)},
                    {v, strides_at(strides, 2)},
                    {dout, strides_at(strides, 3)}};
  BwdArgs a;
  a.r = r;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.sdq = strides_at(strides, 4);
  a.sdk = strides_at(strides, 5);
  a.sdv = strides_at(strides, 6);
  a.stats = reinterpret_cast<float4*>(stats);
  a.dq_part = dq_part;
  a.e_part = e_part;
  a.e_row = e_row;
  a.B = B;
  a.S = S;
  a.H = H;
  a.dh = dh;
  a.s_pad = (S + kAtRows - 1) / kAtRows * kAtRows;  // n_sub: set by the launcher
  a.scale_log2 = scale * 1.4426950408889634f;
  a.scale = scale;
  a.bf = bf != 0;
  const int align = a.bf ? 4 : 8;
  auto even = [](const Strides& s) { return s.b % 2 == 0 && s.h % 2 == 0 && s.s % 2 == 0; };
  a.pair_kv = dh % 2 == 0 && aligned(dk, align) && aligned(dv, align) && even(a.sdk) &&
              even(a.sdv);
  a.pair_q = dh % 2 == 0 && aligned(dq, align) && even(a.sdq);
  return (int)attn_bwd_bf16(ops, a, static_cast<bf16*>(packed), (cudaStream_t)stream);
}

// Keys a block of the backward's keys pass holds for (S, dh, B*H): the
// launcher's table, after tmx_attn_bwd_bf16_force_keys.
int tmx_attn_bwd_bf16_keys(int S, int dh, int BH) { return bwd16_keys(S, dh, BH); }

// Makes every later call with dh <= 64 take key blocks of `keys` (64 or
// 128), or the table again with 0: for measuring the table's entries.
// Returns the width set.
int tmx_attn_bwd_bf16_force_keys(int keys) {
  bwd16_forced_keys = keys == 64 || keys == 128 ? keys : 0;
  return bwd16_forced_keys;
}

}  // extern "C"
