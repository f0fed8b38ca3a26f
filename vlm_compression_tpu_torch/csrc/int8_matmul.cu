// Weight-only int8 matmul for Hopper (sm_90a):
//   y[M,N] = (x[M,K] @ (q[K,N] [⊙ mask[K,N]])) · scale[N]
//
// Replaces the inner `kernel` of the Pallas TPU kernel `_int8_matmul_pallas`
// (vlm_compression_tpu/ops/quant.py:84, launched at :60-126 from
// `int8_matmul`).  q holds int8 codes (in, out) row-major with one fp32
// scale per output column (ops/quant.py's per-column absmax scheme); the
// optional keep-mask is a bool byte per weight or the bit-packed words of
// ops/bitmask.py (G = 128 or 256).  y is x's dtype.
//
// Arithmetic: the default path of the JAX package, `_int8_matmul_ref`
// followed by `int8_matmul`'s `(out * scale).astype(x.dtype)`: the product
// sums in fp32, the scale multiplies the fp32 sum (after the split-K sum),
// and the result is rounded to x's dtype once.  (The Pallas kernel wrote
// its product in x's dtype and was scaled and rounded again afterwards:
// in bf16 that rounds twice.)
//
// What bounds it on an H100: 2MNK operations against 2MK + KN + 4N + 2MN
// bytes (plus KN·b/8 for a packed mask, b = 2 or 1, or KN for a bool mask).
// At decode shapes (M = batch × beams = 20) the bytes; those run the
// decode kernel of matmul_decode.cu, and the prefill runs the Hopper loop
// of int8_matmul_wgmma.cu (ops/masked_linear.py `plan`).  This loop takes
// only what TMA cannot take (misaligned bases, K % 8 or N % 16), float32,
// and the launches forced onto it (`_loop`) for timing.
//
// Design: the masked matmul's tile loop (tile_mma.cuh: 128 × 128 output
// tiles, K steps of 32, WMMA bf16 products with fp32 accumulation, register
// prefetch of the next tile, split-K where the tiles do not fill the card).  W tiles travel
// as int8, 8 codes (8 bytes) a chunk; in registers each code converts to
// x's dtype (|q| ≤ 127 is exact in bf16), is zeroed where the mask is false
// (packed words held in registers for a whole group, as in the packed
// masked kernel) and only then goes to shared memory: the dequantized
// weight never exists in device memory.  The scale is applied in the fp32
// epilogue.  A float32 variant multiplies on the CUDA cores (no TF32).
//
// Not yet done (later PRs): the W8A8 products (int8 × int8 on the tensor
// cores).

#include "tile_mma.cuh"

namespace {

using namespace tile;

// tile_mma.cuh's loops with an int8 W loader and no, bool or packed mask;
// two blocks per SM (≤ 128 registers a thread), as the masked kernel
template <bool VEC, int MASK>
__global__ void __launch_bounds__(THREADS, 2)
int8_matmul_bf16_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                        const void* __restrict__ mask, int group,
                        const float* __restrict__ scale, bf16* __restrict__ y,
                        float* __restrict__ partial, int M, int N, int K,
                        int k_split) {
  mm_bf16_tile<VEC>(x, WTile<int8_t, MASK>(q, mask, group, N), scale, y,
                    partial, M, N, K, k_split);
}

template <int MASK>
__global__ void __launch_bounds__(FTHREADS)
int8_matmul_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                       const void* __restrict__ mask, int group,
                       const float* __restrict__ scale, float* __restrict__ y,
                       int M, int N, int K) {
  mm_f32_tile(x, WTile<int8_t, MASK>(q, mask, group, N), scale, y, M, N, K);
}

template <int MASK>
cudaError_t int8_bf16(const void* x, const void* q, const void* mask,
                      int group, const float* scale, void* y, void* workspace,
                      int M, int N, int K, int splits, int k_split, int vec,
                      cudaStream_t st) {
  return launch_bf16(vec ? int8_matmul_bf16_kernel<true, MASK>
                         : int8_matmul_bf16_kernel<false, MASK>,
                     x, static_cast<const int8_t*>(q), mask, group, scale, y,
                     workspace, M, N, K, splits, k_split, st);
}

template <int MASK>
cudaError_t int8_f32(const void* x, const void* q, const void* mask,
                     int group, const float* scale, void* y, int M, int N,
                     int K, cudaStream_t st) {
  return launch_f32(int8_matmul_f32_kernel<MASK>, x,
                    static_cast<const int8_t*>(q), mask, group, scale, y, M,
                    N, K, st);
}

bool bad_mask(const void* mask, int mask_kind, int group) {
  if (mask_kind < NO_MASK || mask_kind > PACKED_MASK) return true;
  if ((mask_kind == NO_MASK) != (mask == nullptr)) return true;
  return mask_kind == PACKED_MASK && group != 128 && group != 256;
}

}  // namespace

// C entry points (bound with ctypes).  Pointers are device pointers, the
// stream is a cudaStream_t; the return value is cudaGetLastError() after
// the launches.  mask_kind: 0 none (mask null), 1 bool bytes (K, N),
// 2 packed words (8·⌈K/group⌉, N), group 128 or 256.  `vec` promises
// 16-byte aligned x rows, 8-byte aligned code and bool-mask rows and
// 16-byte aligned packed-word rows (K % 8 == 0, N % 8 == 0 and aligned base
// pointers).  splits > 1: fp32 partials in workspace (splits × M × N), then
// one ordered sum that also applies the scale.
extern "C" int int8_matmul_bf16(const void* x, const void* q, const void* mask,
                                int mask_kind, int group, const void* scale,
                                void* y, void* workspace, int M, int N, int K,
                                int splits, int k_split, int vec,
                                void* stream) {
  if (splits < 1 || (long long)splits * k_split < K ||
      (splits > 1 && workspace == nullptr) || bad_mask(mask, mask_kind, group))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  return static_cast<int>(
      mask_kind == BOOL_MASK
          ? int8_bf16<BOOL_MASK>(x, q, mask, group, sc, y, workspace, M, N, K,
                                 splits, k_split, vec, st)
      : mask_kind == PACKED_MASK
          ? int8_bf16<PACKED_MASK>(x, q, mask, group, sc, y, workspace, M, N,
                                   K, splits, k_split, vec, st)
          : int8_bf16<NO_MASK>(x, q, mask, group, sc, y, workspace, M, N, K,
                               splits, k_split, vec, st));
}

extern "C" int int8_matmul_f32(const void* x, const void* q, const void* mask,
                               int mask_kind, int group, const void* scale,
                               void* y, int M, int N, int K, void* stream) {
  if (bad_mask(mask, mask_kind, group))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  return static_cast<int>(
      mask_kind == BOOL_MASK
          ? int8_f32<BOOL_MASK>(x, q, mask, group, sc, y, M, N, K, st)
      : mask_kind == PACKED_MASK
          ? int8_f32<PACKED_MASK>(x, q, mask, group, sc, y, M, N, K, st)
          : int8_f32<NO_MASK>(x, q, mask, group, sc, y, M, N, K, st));
}
