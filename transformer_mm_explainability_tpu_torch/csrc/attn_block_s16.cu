// The bf16-storage instances of attn_block.cu's fp32-product attention
// kernels: q, k, v, dout and the outputs in bf16 (attn_fp32.cuh, T =
// bf16: 96 instances). What they compute is the fp32 kernels' function on
// the widened tensors, rounded once, and the same bits (see attn_block.cu's
// header).
//
// This file and gemm_s16.cu (the GEMM's bf16-storage instances) are the
// second and third objects of attn_block.cu's library (ops/_build.py
// PARTS): the three compile at once, each with a part of the library's
// template instances, and link into one shared library, whose C interface
// (attn_block.cu) hands a bf16 call to the entry points below.

#include "attn_common.cuh"
#include "attn_fp32.cuh"
#include "common.cuh"

extern "C" {

int tmx_attn_fwd_s16(const void* q, const void* k, const void* v, void* out,
                     const long long* strides, int B, int S, int H, int dh, float scale,
                     int copy_bytes, void* stream) {
  return (int)attn_fwd_entry<bf16>(q, k, v, out, strides, B, S, H, dh, scale, copy_bytes,
                                   (cudaStream_t)stream);
}

int tmx_attn_bwd_s16(const void* q, const void* k, const void* v, const void* dout,
                     const float* r, void* dq, void* dk, void* dv, float* stats,
                     float* e_part, float* e_row, const long long* strides, int B, int S,
                     int H, int dh, float scale, int copy_bytes, void* stream) {
  return (int)attn_bwd_entry<bf16>(q, k, v, dout, r, dq, dk, dv, stats, e_part, e_row,
                                   strides, B, S, H, dh, scale, copy_bytes,
                                   (cudaStream_t)stream);
}

}  // extern "C"
