// The bf16-storage instances of the fp32 GEMM (common.cuh, gemm<true>: A
// and B each fp32 or bf16, bias, residual and output each fp32 or bf16; 32
// instances) for attn_block.cu's library. What they compute is the
// fp32 GEMM's function on the widened tensors, rounded once, and the same
// bits. A separate object of that library (ops/_build.py PARTS), so that it
// compiles beside attn_block.cu and attn_block_s16.cu; attn_block.cu's
// tmx_gemm hands it every call with a dtypes bit set.

#include "common.cuh"

extern "C" int tmx_gemm_s16(const void* A, const void* B, void* C, int M, int N, int K,
                            int trans_b, const void* bias, const void* res, const float* aux,
                            int act, int dtypes, int batch, long long bsA, long long bsB,
                            long long bsC, int copy_bytes, void* stream) {
  const GemmArgs p = {A, B, C, bias, res, aux, bsA, bsB, bsC, M, N, K, act, dtypes, false};
  return (int)gemm<true>(p, trans_b != 0, batch, copy_bytes, (cudaStream_t)stream);
}
