// The Hopper (sm_90a) entry points of the bool-mask, packed-mask and
// sparse-LoRA matmuls: the TMA + wgmma main loop of wgmma_tile.cuh, which
// masks (and merges) the W tile in shared memory.  They replace the WMMA
// loop of masked_matmul.cu (the same functions, so the same Pallas TPU
// kernels: `_mm_kernel`, `_mm_packed_kernel` and `_mm_lora_kernel` of
// vlm_compression_tpu/ops/masked_linear.py:67,194,309) wherever the
// output tiles fill the card
// without split-K; ops/masked_linear.py `plan` decides.  A file of its own
// so that it builds in parallel with masked_matmul.cu.
//
// What bounds them: 2MNK operations on the tensor cores against the
// bytes of x, W, the mask (and A, B) and y — operations at every shape
// they run (calibration, training, prefill).  See wgmma_tile.cuh for the
// design.

#include "wgmma_tile.cuh"

namespace {

typedef __nv_bfloat16 bf16;

__global__ void __launch_bounds__(wg::THREADS, 1)
masked_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                           const __grid_constant__ CUtensorMap tm_w,
                           const __grid_constant__ CUtensorMap tm_m,
                           const bf16* lora_a, const bf16* lora_b, float scale,
                           bf16* y, int M, int N, int K, int group) {
  wg::mm_wgmma<wg::BOOL_MASK, 0>(&tm_x, &tm_w, &tm_m, lora_a, lora_b, scale, y,
                                 M, N, K, group);
}

__global__ void __launch_bounds__(wg::THREADS, 1)
masked_matmul_packed_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                                  const __grid_constant__ CUtensorMap tm_w,
                                  const __grid_constant__ CUtensorMap tm_m,
                                  const bf16* lora_a, const bf16* lora_b,
                                  float scale, bf16* y, int M, int N, int K,
                                  int group) {
  wg::mm_wgmma<wg::PACKED_MASK, 0>(&tm_x, &tm_w, &tm_m, lora_a, lora_b, scale,
                                   y, M, N, K, group);
}

template <int R>
__global__ void __launch_bounds__(wg::THREADS, 1)
sparse_lora_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_w,
                         const __grid_constant__ CUtensorMap tm_m,
                         const bf16* lora_a, const bf16* lora_b, float scale,
                         bf16* y, int M, int N, int K, int group) {
  wg::mm_wgmma<wg::BOOL_MASK, R>(&tm_x, &tm_w, &tm_m, lora_a, lora_b, scale, y,
                                 M, N, K, group);
}

}  // namespace

// The Hopper loop (wgmma_tile.cuh), one launch over all of K: 16-byte
// aligned x, W and mask (and A, B); K % 8 == 0, N % 16 == 0; the caller
// (ops/masked_linear.py `plan`) sends only shapes whose output tiles fill
// the card.  Arguments as the float32 entry points.
extern "C" int masked_matmul_wgmma(const void* x, const void* w,
                                   const void* mask, void* y, int M, int N,
                                   int K, void* stream) {
  return wg::launch_wgmma<wg::BOOL_MASK, masked_matmul_wgmma_kernel>(
      x, w, mask, 0, nullptr, nullptr, 0.f, y, M, N, K,
      static_cast<cudaStream_t>(stream));
}

extern "C" int masked_matmul_packed_wgmma(const void* x, const void* w,
                                          const void* packed, int group,
                                          void* y, int M, int N, int K,
                                          void* stream) {
  return wg::launch_wgmma<wg::PACKED_MASK, masked_matmul_packed_wgmma_kernel>(
      x, w, packed, group, nullptr, nullptr, 0.f, y, M, N, K,
      static_cast<cudaStream_t>(stream));
}

// rank r = 2, 4 or 8
extern "C" int sparse_lora_matmul_wgmma(const void* x, const void* w,
                                        const void* mask, const void* lora_a,
                                        const void* lora_b, int r, float scale,
                                        void* y, int M, int N, int K,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 2:
      return wg::launch_wgmma<wg::BOOL_MASK, sparse_lora_wgmma_kernel<2>>(
          x, w, mask, 0, lora_a, lora_b, scale, y, M, N, K, st);
    case 4:
      return wg::launch_wgmma<wg::BOOL_MASK, sparse_lora_wgmma_kernel<4>>(
          x, w, mask, 0, lora_a, lora_b, scale, y, M, N, K, st);
    case 8:
      return wg::launch_wgmma<wg::BOOL_MASK, sparse_lora_wgmma_kernel<8>>(
          x, w, mask, 0, lora_a, lora_b, scale, y, M, N, K, st);
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
