// The Hopper (sm_90a) entry point of the weight-only int8 matmul above
// decode-sized M (the prefill):
//   y[M,N] = (x[M,K] @ (q[K,N] [⊙ mask[K,N]])) · scale[N]
// on the TMA + wgmma main loop of wgmma_tile.cuh, unsplit where the output
// tiles fill the card and split-K across a thread-block cluster where they
// do not.  Replaces, at those shapes, the inner `kernel` of the Pallas TPU
// kernel `_int8_matmul_pallas` (vlm_compression_tpu/ops/quant.py:84, its
// pl.pallas_call at :116), as int8_matmul.cu's WMMA loop did before;
// decode-sized M runs matmul_decode.cu (ops/masked_linear.py `plan`).  A
// file of its own so that it builds in parallel with the others.
//
// Arithmetic: the JAX package's default path, `_int8_matmul_ref` then
// `(out * scale).astype(x.dtype)`: the codes, masked, become bf16 exactly
// (|q| ≤ 127), the products sum in fp32 (after the split-K sum), the scale
// multiplies the fp32 sum, and the result is rounded to bf16 once.
//
// What bounds it on an H100: 2MNK operations against 2MK + KN + 4N + 2MN
// bytes (plus KN for a bool mask, KN·b/8 for a packed one, b = 2 or 1):
// operations at every prefill shape of the main path.  The design: the
// producer stages the 8 KB code tile of a K step by TMA beside x and the
// mask; the transform warpgroup masks the code bytes and converts them
// into the bf16 W tile that the consumers' wgmmas read, as the bf16
// kernels' W tile; the scale is applied in the epilogue.  The dequantized
// weight never exists in device memory.

#include "wgmma_tile.cuh"

namespace {

typedef __nv_bfloat16 bf16;

template <int KIND>
__global__ void __launch_bounds__(wg::THREADS, 1)
int8_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_m,
                         const bf16* lora_a, const bf16* lora_b, float scale,
                         const float* col_scale, bf16* y, int M, int N, int K,
                         int k_split, int group) {
  wg::mm_wgmma<KIND, 0, true>(&tm_x, &tm_q, &tm_m, lora_a, lora_b, scale,
                              col_scale, y, M, N, K, k_split, group);
}

template <int KIND>
int launch(const void* x, const void* q, const void* mask, int group,
           const float* scale, void* y, int M, int N, int K, int splits,
           int k_split, cudaStream_t st) {
  return wg::launch_wgmma<KIND, true, int8_matmul_wgmma_kernel<KIND>>(
      x, q, mask, group, nullptr, nullptr, 0.f, scale, y, M, N, K, splits,
      k_split, st);
}

}  // namespace

// C entry point (bound with ctypes).  x (M, K) bf16; q (K, N) int8 codes;
// mask_kind 0 none (mask null), 1 bool bytes (K, N), 2 packed words
// (8·⌈K/group⌉, N), group 128 or 256; scale N floats; y (M, N) bf16.
// 16-byte aligned x, q and mask; K % 8 == 0, N % 16 == 0; `splits` blocks
// of `k_split` K rows a tile (one split: k_split = K; more: a multiple of
// 256, at most 8), as ops/masked_linear.py `plan_wgmma` gives them.
// Returns the launch's cudaError_t.
extern "C" int int8_matmul_wgmma(const void* x, const void* q,
                                 const void* mask, int mask_kind, int group,
                                 const void* scale, void* y, int M, int N,
                                 int K, int splits, int k_split,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  switch (mask_kind) {
    case wg::NO_MASK:
      return launch<wg::NO_MASK>(x, q, mask, group, sc, y, M, N, K, splits,
                                 k_split, st);
    case wg::BOOL_MASK:
      return launch<wg::BOOL_MASK>(x, q, mask, group, sc, y, M, N, K, splits,
                                   k_split, st);
    case wg::PACKED_MASK:
      return launch<wg::PACKED_MASK>(x, q, mask, group, sc, y, M, N, K,
                                     splits, k_split, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

#ifdef WG_TRACE
extern "C" int wg_trace_read(void* dst) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(dst, wg::wg_trace, sizeof(wg::wg_trace)));
}
#endif
