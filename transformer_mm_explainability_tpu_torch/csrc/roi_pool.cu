// Hand-written CUDA kernel for torchvision-exact RoIPool on Hopper, on fp32
// or bf16 features (the output in the features' dtype, as the JAX kernel
// keeps it; boxes fp32).
//
// Replaces the Pallas TPU kernel of
// transformer_mm_explainability_tpu/ops/roi_pool_pallas.py:
//   roi_pool_pallas (_kernel): features [H, W, C], boxes [K, 4] -> [K, P, P, C];
//   box corners floor(x * scale + 0.5), roi = max(x1 - x0 + 1, 1), bin p
//   spans [floor(p roi / P), ceil((p + 1) roi / P)) clipped to the map, each
//   bin is the max over its rows x columns, and an empty bin, or a maximum
//   that is not finite, gives 0.
// The Pallas kernel keeps a [H, W, C_T] slab resident in VMEM across boxes
// and reduces each box in two masked-max passes: over x per bin column, then
// over y per bin row. This kernel keeps that separable order: the max over
// a bin row's columns, row by row, then over its rows.
//
// What bounds it on this card: bytes. The function reads the map once and
// writes the output once, (H W C + K P P C) x 4 bytes: 818 MB at the
// protocol shape ([50, 76, 1024], K = 1000, P = 14), 0.244 ms at 3.35 TB/s,
// of which the output write is 803 MB (half of each in bf16). The 15.6 MB map stays in the 50 MB
// L2 across boxes, so the kernel's own traffic is the box reads from L2 and
// the output stream to device memory.
//
// The earlier design of this kernel ran one block per (box, bin row) and walked
// each bin's window for itself. Neighbouring bins share a row and a column
// (bin p ends at ceil((p + 1) roi / P), bin p + 1 starts at floor of the
// same), so with bins of 2-3 pixels most pixels were read from L2 two to
// four times: 3.10 GB of L2 reads at the protocol shape, where the boxes
// cover 1.20 GB. Its bins came from 33 torch operations per call.
//
//   roi_pool_kernel  one block per (box, chunk of kLanes channel vectors,
//                    group of bin rows); the block's threads form kBands
//                    bands, each of up to kBandBins column bins, lanes along
//                    C (16-byte float4 loads and stores where C % 4 == 0 and
//                    the pointers are 16-byte aligned, one float each
//                    otherwise). Each thread walks its group once: bin row
//                    by bin row, each row of the bin row's window read pixel
//                    by pixel across its band's bins and folded into the
//                    band's column maxima (registers). Bin p + 1 starts at
//                    or after the last row and column of bin p, so the pixel
//                    read last serves the column two bins of a band share,
//                    and the last row of a bin row, written with it, starts
//                    the next bin row's maxima: the row two bin rows share
//                    is read once, also where roi < P puts a row or column
//                    in several bins. A pixel is read once per (group, band)
//                    that holds it: 1.14 times the box pixels at the
//                    protocol's box law (tests/test_torch_roi_pool_tiles.py
//                    counts it), the extra being the row where the two
//                    groups meet and the three columns where bands meet. A walk of the whole box by one
//                    thread, or a window staged through shared memory, reads
//                    each pixel exactly once but leaves a few long dependent
//                    chains per box, and both ran slower than the kernel this
//                    replaces; groups and bands keep 8,000 blocks of short
//                    walks in flight, two loads each. The max keeps a NaN
//                    (max.NaN) and compares nothing else across the order of
//                    the walk, so the result equals the plain version's to
//                    the bit. Outputs go out with streaming stores
//                    (st.global.cs), so the 803 MB stream does not push the
//                    map out of L2.
//
// The bin bounds are computed here, by each thread in registers (its
// group's bin rows, its band's column bins), from the box: floor(x * scale +
// 0.5) with __fmul_rn then __fadd_rn (each rounded to fp32, never contracted
// into an FMA, as torch and XLA round a separate multiply and add), then the
// integer bin arithmetic of roi_bin_bounds.
//
// bf16 features: the template's storage T. A pixel's channels are
// widened to fp32 as they are read and each maximum is rounded back to bf16
// when it is stored: a maximum is one of its inputs, so the round trip is
// exact and the result equals the plain version's to the bit, as in fp32.
// A vector is 4 channels, 8 bytes in bf16 (C % 4 == 0, 8-byte aligned).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kLanes = 64;     // channel vectors per block (threads per band)
constexpr int kBands = 4;      // bands of column bins per block
constexpr int kThreads = kLanes * kBands;
constexpr int kBandBins = 4;   // column bins per band and pass (16 per pass)
constexpr int kRowGroups = 2;  // groups of bin rows: blocks per box and chunk

// max that keeps a NaN: NaN if either operand is NaN
__device__ __forceinline__ float take_max(float m, float v) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(m), "f"(v));
  return r;
}

__device__ __forceinline__ float finite_or_zero(float m) { return isfinite(m) ? m : 0.f; }

// V floats of one pixel's channels: a float4 or a float
template <int V>
struct __align__(4 * V) Vec {
  float v[V];
};

template <int V>
__device__ __forceinline__ Vec<V> vec_fill(float x) {
  Vec<V> r;
#pragma unroll
  for (int i = 0; i < V; ++i) r.v[i] = x;
  return r;
}

template <int V>
__device__ __forceinline__ Vec<V> vec_max(Vec<V> m, const Vec<V>& x) {
#pragma unroll
  for (int i = 0; i < V; ++i) m.v[i] = take_max(m.v[i], x.v[i]);
  return m;
}

template <int V>
__device__ __forceinline__ void vec_store_cs(float* p, const Vec<V>& m) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<float4*>(p),
           make_float4(finite_or_zero(m.v[0]), finite_or_zero(m.v[1]),
                       finite_or_zero(m.v[2]), finite_or_zero(m.v[3])));
  } else {
    __stcs(p, finite_or_zero(m.v[0]));
  }
}

template <int V>
__device__ __forceinline__ void vec_store_cs(bf16* p, const Vec<V>& m) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<uint2*>(p),
           make_uint2(pack_bf16(finite_or_zero(m.v[0]), finite_or_zero(m.v[1])),
                      pack_bf16(finite_or_zero(m.v[2]), finite_or_zero(m.v[3]))));
  } else {
    __stcs(reinterpret_cast<unsigned short*>(p),
           (unsigned short)(pack_bf16(finite_or_zero(m.v[0]), 0.f) & 0xffffu));
  }
}

template <int V>
__device__ __forceinline__ Vec<V> vec_load(const float* p) {
  if constexpr (V == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    return Vec<V>{{x.x, x.y, x.z, x.w}};
  } else {
    return Vec<V>{{*p}};
  }
}

template <int V>
__device__ __forceinline__ Vec<V> vec_load(const bf16* p) {
  if constexpr (V == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const float2 a = widen_bf16x2(x.x), b = widen_bf16x2(x.y);
    return Vec<V>{{a.x, a.y, b.x, b.y}};
  } else {
    return Vec<V>{{__bfloat162float(*p)}};
  }
}

// floor(x * scale + 0.5) as an int, each step rounded as torch rounds it
__device__ __forceinline__ int quantize(float x, float scale) {
  return (int)floorf(__fadd_rn(__fmul_rn(x, scale), 0.5f));
}

// bin p of a side of roi pixels from o: [floor(p roi / P), ceil((p + 1) roi
// / P)) + o, clipped to [0, n]
__device__ __forceinline__ int bin_start(int p, int roi, int P, int o, int n) {
  return min(max(p * roi / P + o, 0), n);
}
__device__ __forceinline__ int bin_end(int p, int roi, int P, int o, int n) {
  return min(max(((p + 1) * roi + P - 1) / P + o, 0), n);
}

// f: [H, W, C] of T (fp32 or bf16); boxes: [K, 4] fp32 xyxy (image
// scale); out: [K, P, P, C] of T.
// blockIdx.x: the box; blockIdx.y: the chunk of kLanes * V channels;
// blockIdx.z: the group of bin rows. Thread (band b, lane l) = threadIdx.x
// / kLanes, % kLanes: channel vector l, the column bins of band b. Each
// thread computes the bins it walks in registers.
template <int V, typename T>
__global__ void __launch_bounds__(kThreads)
roi_pool_kernel(const T* __restrict__ f, const float* __restrict__ boxes,
                T* __restrict__ out, int H, int W, int C, int P, float scale) {
  const int k = blockIdx.x;
  const float* b = boxes + 4 * (long long)k;
  const int x0 = quantize(b[0], scale), y0 = quantize(b[1], scale);
  const int roi_w = max(quantize(b[2], scale) - x0 + 1, 1);
  const int roi_h = max(quantize(b[3], scale) - y0 + 1, 1);
  const int band = threadIdx.x / kLanes;
  const int c = (blockIdx.y * kLanes + threadIdx.x % kLanes) * V;
  if (c >= C) return;
  const T* fc = f + c;
  T* oc = out + (long long)k * P * P * C + c;
  const long long row = (long long)W * C;
  // this block's bin rows
  const int g = gridDim.z, ph0 = blockIdx.z * P / g, ph1 = (blockIdx.z + 1) * P / g;

  const int passes = (P + kBands * kBandBins - 1) / (kBands * kBandBins);
  for (int pass = 0; pass < passes; ++pass) {
    // this band's column bins j0..j0+nb-1
    const int p0 = pass * P / passes, n = (pass + 1) * P / passes - p0;
    const int j0 = p0 + n * band / kBands, nb = p0 + n * (band + 1) / kBands - j0;
    int ws[kBandBins], we[kBandBins];  // the band's column bins
#pragma unroll
    for (int jj = 0; jj < kBandBins; ++jj) {
      ws[jj] = bin_start(j0 + jj, roi_w, P, x0, W);
      we[jj] = bin_end(j0 + jj, roi_w, P, x0, W);
    }
    Vec<V> acc[kBandBins];  // the bin row's column maxima so far
    int carried = -1;       // the row whose column maxima acc starts from
    for (int ph = ph0; ph < ph1; ++ph) {
      T* o = oc + ((long long)ph * P + j0) * C;
      const int h1 = bin_end(ph, roi_h, P, y0, H);
      int h = bin_start(ph, roi_h, P, y0, H);
      if (h >= h1) {  // an empty bin row (clipped away)
#pragma unroll
        for (int jj = 0; jj < kBandBins; ++jj)
          if (jj < nb) vec_store_cs<V>(o + (long long)jj * C, vec_fill<V>(0.f));
        continue;
      }
      if (h == carried) {
        ++h;  // the bin row before ended on this row: acc holds it
      } else {
#pragma unroll
        for (int jj = 0; jj < kBandBins; ++jj) acc[jj] = vec_fill<V>(-INFINITY);
      }
      // each row of the bin row not read yet, in order; its last row is
      // written with it and starts the next bin row's maxima
      for (; h < h1; ++h) {
        const T* fr = fc + h * row;
        const bool last = h == h1 - 1;
        Vec<V> prev = vec_fill<V>(0.f);  // the pixel read last, column w_prev
        int w_prev = -1;
#pragma unroll
        for (int jj = 0; jj < kBandBins; ++jj) {
          if (jj < nb) {
            const int w0 = ws[jj], w1 = we[jj];
            int w = w0;
            Vec<V> m = vec_fill<V>(-INFINITY);
            if (w < w1 && w == w_prev) {  // shared with the bin before
              m = prev;
              ++w;
            }
            for (; w + 1 < w1; w += 2) {  // two loads in flight
              const Vec<V> x = vec_load<V>(fr + (long long)w * C);
              prev = vec_load<V>(fr + (long long)(w + 1) * C);
              m = vec_max<V>(vec_max<V>(m, x), prev);
            }
            if (w < w1) {
              prev = vec_load<V>(fr + (long long)w * C);
              m = vec_max<V>(m, prev);
            }
            if (w0 < w1) w_prev = w1 - 1;
            if (last) {
              vec_store_cs<V>(o + (long long)jj * C, vec_max<V>(acc[jj], m));
              acc[jj] = m;
            } else {
              acc[jj] = vec_max<V>(acc[jj], m);
            }
          }
        }
      }
      if (carried == h1 - 1) {  // the bin row is the carried row alone
#pragma unroll
        for (int jj = 0; jj < kBandBins; ++jj)
          if (jj < nb) vec_store_cs<V>(o + (long long)jj * C, acc[jj]);
      }
      carried = h1 - 1;
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes). Launches on the given stream, never
// synchronises, and returns cudaGetLastError().
// ---------------------------------------------------------------------------

extern "C" {

const char* tmx_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// features: [H, W, C] contiguous, fp32 or, where is_bf16, bf16; boxes:
// [K, 4] contiguous fp32 xyxy at image scale; out: [K, P, P, C] of the
// features' type. K, P >= 1.
int tmx_roi_pool(const void* features, const float* boxes, void* out, int K, int H, int W,
                 int C, int P, float spatial_scale, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (K < 1 || P < 1 || C < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const uintptr_t vec_bytes = is_bf16 ? 8 : 16;  // 4 channels
  const bool vec4 = C % 4 == 0 && reinterpret_cast<uintptr_t>(features) % vec_bytes == 0 &&
                    reinterpret_cast<uintptr_t>(out) % vec_bytes == 0;
  const int V = vec4 ? 4 : 1;
  const dim3 grid(K, (C + kLanes * V - 1) / (kLanes * V), min(kRowGroups, P));
  if (is_bf16) {
    auto kernel = vec4 ? roi_pool_kernel<4, bf16> : roi_pool_kernel<1, bf16>;
    kernel<<<grid, kThreads, 0, st>>>(static_cast<const bf16*>(features), boxes,
                                      static_cast<bf16*>(out), H, W, C, P, spatial_scale);
  } else {
    auto kernel = vec4 ? roi_pool_kernel<4, float> : roi_pool_kernel<1, float>;
    kernel<<<grid, kThreads, 0, st>>>(static_cast<const float*>(features), boxes,
                                      static_cast<float*>(out), H, W, C, P, spatial_scale);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
