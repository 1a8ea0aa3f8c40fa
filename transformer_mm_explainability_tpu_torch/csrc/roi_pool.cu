// Hand-written fp32 CUDA kernel for torchvision-exact RoIPool on Hopper.
//
// Replaces the Pallas TPU kernel of
// transformer_mm_explainability_tpu/ops/roi_pool_pallas.py:
//   roi_pool_pallas (_kernel): features [H, W, C], boxes [K, 4] -> [K, P, P, C];
//   each bin is the max over rows [hs, he) x columns [ws, we) of the map, an
//   empty bin gives 0, and so does a maximum that is not finite.
// The Pallas kernel keeps a [H, W, C_T] slab resident in VMEM across boxes
// and reduces each box with additive 0/-inf masks in two passes. Here the
// bin bounds are computed by the wrapper in torch (integer arithmetic,
// roi_bin_bounds) and passed in: recomputing floor(box * scale + 0.5) here
// would let nvcc contract the multiply-add into an FMA, which rounds
// differently from torch's separate multiply and add.
//
//   roi_pool_kernel  one block per (box, bin row); threads run along C, the
//                    contiguous axis, with 16-byte float4 loads and stores
//                    where C % 4 == 0 and the map is 16-byte aligned. Each
//                    thread walks the bins of its row and takes the max of
//                    its channel over the bin's window, starting from
//                    -INFINITY (a NaN is kept, as jnp.max keeps it), then
//                    writes isfinite(m) ? m : 0.
//
// What bounds it on this card: bytes. The map is read once and the output
// written once, (H W C + K P P C) x 4 bytes: 818 MB at the protocol shape
// ([50, 76, 1024], K = 1000, P = 14), 0.244 ms at 3.35 TB/s; the output
// write is 803 MB of it. The 15.6 MB map stays in the 50 MB L2 across boxes,
// so the window reads (up to about twice the box area, bins overlap by a
// pixel) come from L2 and the stores stream to device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float take_max(float m, float v) {
  // v > m, or v is NaN: a NaN, once taken, stays (v > NaN is false)
  return (v > m || v != v) ? v : m;
}

__device__ __forceinline__ float finite_or_zero(float m) { return isfinite(m) ? m : 0.f; }

// f: [H, W, C]; hs, he, ws, we: [K, P] int32; out: [K, P, P, C].
template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
roi_pool_kernel(const float* __restrict__ f, const int* __restrict__ hs,
                const int* __restrict__ he, const int* __restrict__ ws,
                const int* __restrict__ we, float* __restrict__ out, int W, int C,
                int P) {
  const int k = blockIdx.x;
  const int ph = blockIdx.y;
  const int h0 = hs[k * P + ph];
  const int h1 = he[k * P + ph];
  const long long row = (long long)W * C;
  for (int pw = 0; pw < P; ++pw) {
    const int w0 = ws[k * P + pw];
    const int w1 = we[k * P + pw];
    float* o = out + (((long long)k * P + ph) * P + pw) * C;
    if (kVec4) {
      const int C4 = C / 4;
      for (int c = threadIdx.x; c < C4; c += kThreads) {
        float4 m = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
        for (int h = h0; h < h1; ++h) {
          const float4* src = reinterpret_cast<const float4*>(f + h * row) + c;
          for (int w = w0; w < w1; ++w) {
            const float4 v = src[(long long)w * C4];
            m.x = take_max(m.x, v.x);
            m.y = take_max(m.y, v.y);
            m.z = take_max(m.z, v.z);
            m.w = take_max(m.w, v.w);
          }
        }
        reinterpret_cast<float4*>(o)[c] = make_float4(
            finite_or_zero(m.x), finite_or_zero(m.y), finite_or_zero(m.z), finite_or_zero(m.w));
      }
    } else {
      for (int c = threadIdx.x; c < C; c += kThreads) {
        float m = -INFINITY;
        for (int h = h0; h < h1; ++h) {
          const float* src = f + h * row + c;
          for (int w = w0; w < w1; ++w) m = take_max(m, src[(long long)w * C]);
        }
        o[c] = finite_or_zero(m);
      }
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

// features: [H, W, C] contiguous fp32; hs, he, ws, we: [K, P] contiguous
// int32 bin bounds, already clipped to the map; out: [K, P, P, C]. K >= 1.
int tmx_roi_pool(const float* features, const int* hs, const int* he, const int* ws,
                 const int* we, float* out, int K, int H, int W, int C, int P,
                 void* stream) {
  (void)H;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(K, P);
  const bool vec4 = C % 4 == 0 && reinterpret_cast<uintptr_t>(features) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec4) {
    roi_pool_kernel<true><<<grid, kThreads, 0, st>>>(features, hs, he, ws, we, out, W, C, P);
  } else {
    roi_pool_kernel<false><<<grid, kThreads, 0, st>>>(features, hs, he, ws, we, out, W, C, P);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
