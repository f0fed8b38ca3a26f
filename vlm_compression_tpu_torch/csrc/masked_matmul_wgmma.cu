// The Hopper (sm_90a) entry points of the bool-mask, packed-mask and
// sparse-LoRA matmuls: the TMA + wgmma main loop of wgmma_tile.cuh, which
// masks (and merges) the W tile in shared memory, unsplit where the output
// tiles fill the card and split-K across a thread-block cluster where they
// do not.  They replace the WMMA loop of masked_matmul.cu (the same
// functions, so the same Pallas TPU kernels: `_mm_kernel`,
// `_mm_packed_kernel` and `_mm_lora_kernel` of
// vlm_compression_tpu/ops/masked_linear.py:67,194,309) at every shape
// above decode-sized M that TMA can take; ops/masked_linear.py `plan`
// decides.  A file of its own so that it builds in parallel with
// masked_matmul.cu.
//
// What bounds them: 2MNK operations on the tensor cores against the
// bytes of x, W, the mask (and A, B) and y — operations at every shape
// they run (calibration, training, prefill).  See wgmma_tile.cuh for the
// design.

#include "wgmma_tile.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// one kernel name per form, for the profiler's readings; F32: `y` is the
// fp32 output of a row-parallel shard (bf16* in the signature only)
#define WGMMA_KERNEL(name, KIND, R, F32)                                     \
  __global__ void __launch_bounds__(wg::THREADS, 1)                          \
  name(const __grid_constant__ CUtensorMap tm_x,                             \
       const __grid_constant__ CUtensorMap tm_w,                             \
       const __grid_constant__ CUtensorMap tm_m, const bf16* lora_a,         \
       const bf16* lora_b, float scale, const float* col_scale, bf16* y,     \
       int M, int N, int K, int k_split, int group) {                        \
    wg::mm_wgmma<KIND, R, false, F32>(&tm_x, &tm_w, &tm_m, lora_a, lora_b,   \
                                      scale, col_scale, y, M, N, K, k_split, \
                                      group);                                \
  }

WGMMA_KERNEL(masked_matmul_wgmma_kernel, wg::BOOL_MASK, 0, false)
WGMMA_KERNEL(masked_matmul_packed_wgmma_kernel, wg::PACKED_MASK, 0, false)
WGMMA_KERNEL(sparse_lora_wgmma_kernel_r2, wg::BOOL_MASK, 2, false)
WGMMA_KERNEL(sparse_lora_wgmma_kernel_r4, wg::BOOL_MASK, 4, false)
WGMMA_KERNEL(sparse_lora_wgmma_kernel_r8, wg::BOOL_MASK, 8, false)
WGMMA_KERNEL(masked_matmul_out32_wgmma_kernel, wg::BOOL_MASK, 0, true)
WGMMA_KERNEL(sparse_lora_out32_wgmma_kernel_r2, wg::BOOL_MASK, 2, true)
WGMMA_KERNEL(sparse_lora_out32_wgmma_kernel_r4, wg::BOOL_MASK, 4, true)
WGMMA_KERNEL(sparse_lora_out32_wgmma_kernel_r8, wg::BOOL_MASK, 8, true)

template <int KIND, auto kernel>
int launch(const void* x, const void* w, const void* mask, int group,
           const void* lora_a, const void* lora_b, float scale, void* y,
           int M, int N, int K, int splits, int k_split, void* stream) {
  return wg::launch_wgmma<KIND, false, kernel>(
      x, w, mask, group, lora_a, lora_b, scale, nullptr, y, M, N, K, splits,
      k_split, static_cast<cudaStream_t>(stream));
}

}  // namespace

// The Hopper loop (wgmma_tile.cuh): 16-byte aligned x, W and mask (and A,
// B); K % 8 == 0, N % 16 == 0; `splits` blocks of `k_split` K rows a tile
// (one split: k_split = K; more: a multiple of 256, at most 8), as
// ops/masked_linear.py `plan_wgmma` gives them.  Other arguments as the
// float32 entry points; returns the launch's cudaError_t.
extern "C" int masked_matmul_wgmma(const void* x, const void* w,
                                   const void* mask, void* y, int M, int N,
                                   int K, int splits, int k_split,
                                   void* stream) {
  return launch<wg::BOOL_MASK, masked_matmul_wgmma_kernel>(
      x, w, mask, 0, nullptr, nullptr, 0.f, y, M, N, K, splits, k_split,
      stream);
}

extern "C" int masked_matmul_packed_wgmma(const void* x, const void* w,
                                          const void* packed, int group,
                                          void* y, int M, int N, int K,
                                          int splits, int k_split,
                                          void* stream) {
  return launch<wg::PACKED_MASK, masked_matmul_packed_wgmma_kernel>(
      x, w, packed, group, nullptr, nullptr, 0.f, y, M, N, K, splits,
      k_split, stream);
}

// rank r = 2, 4 or 8
extern "C" int sparse_lora_matmul_wgmma(const void* x, const void* w,
                                        const void* mask, const void* lora_a,
                                        const void* lora_b, int r, float scale,
                                        void* y, int M, int N, int K,
                                        int splits, int k_split,
                                        void* stream) {
  switch (r) {
    case 2:
      return launch<wg::BOOL_MASK, sparse_lora_wgmma_kernel_r2>(
          x, w, mask, 0, lora_a, lora_b, scale, y, M, N, K, splits, k_split,
          stream);
    case 4:
      return launch<wg::BOOL_MASK, sparse_lora_wgmma_kernel_r4>(
          x, w, mask, 0, lora_a, lora_b, scale, y, M, N, K, splits, k_split,
          stream);
    case 8:
      return launch<wg::BOOL_MASK, sparse_lora_wgmma_kernel_r8>(
          x, w, mask, 0, lora_a, lora_b, scale, y, M, N, K, splits, k_split,
          stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// fp32 y, unrounded (a row-parallel shard's partial sums; the sum over
// ranks rounds once): otherwise as masked_matmul_wgmma and
// sparse_lora_matmul_wgmma
extern "C" int masked_matmul_out32_wgmma(const void* x, const void* w,
                                         const void* mask, void* y, int M,
                                         int N, int K, int splits,
                                         int k_split, void* stream) {
  return launch<wg::BOOL_MASK, masked_matmul_out32_wgmma_kernel>(
      x, w, mask, 0, nullptr, nullptr, 0.f, y, M, N, K, splits, k_split,
      stream);
}

extern "C" int sparse_lora_matmul_out32_wgmma(const void* x, const void* w,
                                              const void* mask,
                                              const void* lora_a,
                                              const void* lora_b, int r,
                                              float scale, void* y, int M,
                                              int N, int K, int splits,
                                              int k_split, void* stream) {
  switch (r) {
    case 2:
      return launch<wg::BOOL_MASK, sparse_lora_out32_wgmma_kernel_r2>(
          x, w, mask, 0, lora_a, lora_b, scale, y, M, N, K, splits, k_split,
          stream);
    case 4:
      return launch<wg::BOOL_MASK, sparse_lora_out32_wgmma_kernel_r4>(
          x, w, mask, 0, lora_a, lora_b, scale, y, M, N, K, splits, k_split,
          stream);
    case 8:
      return launch<wg::BOOL_MASK, sparse_lora_out32_wgmma_kernel_r8>(
          x, w, mask, 0, lora_a, lora_b, scale, y, M, N, K, splits, k_split,
          stream);
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
