// Masked matmul for Hopper (sm_90a): y[M,N] = x[M,K] @ (W[K,N] ⊙ mask[K,N]).
//
// Replaces the Pallas TPU kernel `_mm_kernel`
// (vlm_compression_tpu/ops/masked_linear.py:67, launched by
// `_masked_matmul_pallas`).  Layout as in the JAX package: W and the bool
// mask are (in, out), row-major; x is (M, K) row-major; y is x's dtype.
//
// What bounds it on an H100: at calibration shapes (M in the tens of
// thousands, K, N ≥ 1408) the product is compute-bound (2MNK operations
// against 2MK + 3KN + 2MN bytes in bf16 with a 1-byte mask); at decode
// shapes (M = batch × beams = 20) it is bound by the W and mask bytes.
//
// Design: a tiled GEMM on the tensor cores through WMMA (bf16 in, fp32
// accumulate).  Each W tile is read from device memory together with its
// mask tile, zeroed where the mask is false while it passes through
// registers into shared memory, and only then fed to the MMA: the masked
// weight never exists in device memory, as on the TPU.  The next tile's
// global loads are issued before the current tile's MMAs (register
// prefetch), so loads overlap the math.  Ragged M/N/K edges are masked in
// the loads and the stores, so every shape launches (the JAX wrapper fell
// back to XLA on shapes that do not tile).  A float32 variant multiplies on
// the CUDA cores (no TF32), so it holds exact-fp32 semantics.
//
// Decode-sized M leaves too few output tiles to fill the card's 132 SMs;
// there the wrapper splits K across blocks (fp32 partials, then one
// ordered sum), so the W and mask bytes stream through enough SMs.
//
// The same file holds the sparse-LoRA kernels, y = x @ ((W + s·A·B) ⊙ M),
// which replace the Pallas TPU kernel `_mm_lora_kernel`
// (vlm_compression_tpu/ops/masked_linear.py:309, launched by
// `_sparse_lora_pallas`).  They run the masked matmul's tile loop; each W
// tile, on its way from registers to shared memory, gets its rank-r delta
// Σ_r A[k, r]·B[r, n] in fp32 on the CUDA cores (the A rows of the K step
// and the block's B columns staged in shared memory as fp32), scaled and
// added to W in fp32, zeroed where the mask is false and cast to W's dtype
// — the TPU kernel's fp32 merge — before the MMA.  The merged weight never
// exists in device memory, which is the kernel's purpose: the plain version
// writes (W + s·A·B) ⊙ M for every layer on every forward.  What bounds it:
// the masked matmul's bound (2MNK operations; 2MK + 3KN + 2MN bytes) plus
// the A and B bytes and the delta's recompute, 2KNr operations per M tile
// ((M/128)·2KNr in all), small next to 2MNK at r ≤ 8.
//
// The packed entry points, y = x @ (W ⊙ unpack(P)), replace the Pallas TPU
// kernel `_mm_packed_kernel` (vlm_compression_tpu/ops/masked_linear.py:194,
// launched by `_masked_matmul_packed_pallas`).  P holds the keep-mask as
// 32-bit words, 2 bits a weight (G = 128) or 1 bit (G = 256), in the
// interleave of ops/bitmask.py.  They run the bool kernel's tile loop with
// one difference, the mask loader: each thread keeps the 8 words of its W
// chunks' columns for a whole G-row group in registers (4 K steps at
// G = 128, 8 at G = 256; see tile_mma.cuh) and expands the bit of each row
// as the chunk passes from registers to shared memory.  The words are read
// from device memory once per group — 2 or 1 bits a weight instead of the
// bool mask's 8 — with no shared-memory staging and no extra barrier.  The
// K steps, the split-K and the fp32 summation order are the bool kernel's,
// so for the same W and mask the two outputs are bit-equal.  What bounds
// it: 2MNK operations against 2MK + 2KN + KN·b/8 + 2MN bytes (b = 2 or 1);
// at decode shapes the bytes, where the packed mask saves 3/8 or 7/16 of
// the bool kernel's weight-side traffic.
//
// Three main loops.  The WMMA loop of tile_mma.cuh (128 × 128 tiles,
// mma.sync through WMMA, register prefetch, split-K) runs the shapes TMA
// cannot take, adapter ranks other than 2, 4 and 8, and float32.  Above
// decode-sized M (calibration, training, prefill) the bool, packed and
// sparse-LoRA entry points `*_wgmma` of masked_matmul_wgmma.cu run the
// Hopper loop of wgmma_tile.cuh instead: TMA loads into a 3-stage
// mbarrier ring, the mask (or the LoRA merge) applied to the W tile in
// shared memory by a transform warpgroup while two consumer warpgroups run
// wgmma on the previous stage, K split across a cluster where the tiles
// do not fill the card.  At decode-sized M the bool and packed matmuls run
// matmul_decode.cu.  ops/masked_linear.py `plan` picks the loop from the
// shape and the alignment alone; the packed entry point takes the same
// loop as the bool one at every shape, so the two stay bit-equal.

#include "tile_mma.cuh"

namespace {

using namespace tile;

// The masked kernels are tile_mma.cuh's loops with a bf16 (float) W loader
// and a bool or packed mask.  Two blocks per SM (≤ 128 registers a
// thread): the packed loader's words would otherwise take the bf16 kernel
// to 172 registers and one block per SM.
template <bool VEC, bool PACKED>
__global__ void __launch_bounds__(THREADS, 2)
masked_matmul_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                          const void* __restrict__ mask, int group,
                          const float* __restrict__ scale, bf16* __restrict__ y,
                          float* __restrict__ partial, int M, int N, int K,
                          int k_split) {
  mm_bf16_tile<VEC>(
      x, WTile<bf16, PACKED ? PACKED_MASK : BOOL_MASK>(w, mask, group, N),
      scale, y, partial, M, N, K, k_split);
}

// ---------------------------------------------------- sparse-LoRA, bf16 path

// W tile chunks and their mask bytes as loaded (two per thread, as
// WTile::load in tile_mma.cuh); out-of-range elements read as W = 0,
// mask = 0
template <bool VEC>
__device__ __forceinline__ void load_w_raw(const bf16* __restrict__ w,
                                           const uint8_t* __restrict__ mask,
                                           int N, int k_end, int n0, int k0,
                                           int tid, Pack8 (&pw)[2],
                                           Mask8 (&pm)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;
    const int gk = k0 + (c >> 4), gn = n0 + (c & 15) * 8;
    if (VEC) {
      if (gk < k_end && gn < N) {
        const size_t off = (size_t)gk * N + gn;
        pw[i].u = *reinterpret_cast<const uint4*>(w + off);
        pm[i].u = *reinterpret_cast<const uint2*>(mask + off);
      } else {
        pw[i].u = make_uint4(0u, 0u, 0u, 0u);
        pm[i].u = make_uint2(0u, 0u);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const size_t off = (size_t)gk * N + gn + e;
        const bool ok = gk < k_end && gn + e < N;
        pw[i].h[e] = ok ? __bfloat16_as_ushort(w[off]) : 0;
        pm[i].b[e] = ok ? mask[off] : 0;
      }
    }
  }
}

// E = (W + s·Σ_r A[k,r]·B[r,n]) ⊙ M for one chunk of 8 columns, merged in
// fp32 exactly as the plain version (delta first, then s·delta, then the
// add; no fused multiply-add across the two) and cast to bf16
__device__ __forceinline__ uint4 merge_chunk(const Pack8& pw, const Mask8& pm,
                                             const float* __restrict__ a_row,
                                             const float* __restrict__ b_col,
                                             int r, float scale) {
  float d[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) d[e] = 0.f;
  for (int rr = 0; rr < r; ++rr) {
    const float a = a_row[rr];
    const float4 b0 = *reinterpret_cast<const float4*>(b_col + rr * BN);
    const float4 b1 = *reinterpret_cast<const float4*>(b_col + rr * BN + 4);
    d[0] = fmaf(a, b0.x, d[0]);
    d[1] = fmaf(a, b0.y, d[1]);
    d[2] = fmaf(a, b0.z, d[2]);
    d[3] = fmaf(a, b0.w, d[3]);
    d[4] = fmaf(a, b1.x, d[4]);
    d[5] = fmaf(a, b1.y, d[5]);
    d[6] = fmaf(a, b1.z, d[6]);
    d[7] = fmaf(a, b1.w, d[7]);
  }
  Pack8 out;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float wv = __uint_as_float(static_cast<uint32_t>(pw.h[e]) << 16);
    const float v = pm.b[e] ? __fadd_rn(wv, __fmul_rn(scale, d[e])) : 0.f;
    out.h[e] = __bfloat16_as_ushort(__float2bfloat16(v));
  }
  return out.u;
}

// two blocks per SM (≤ 128 registers a thread), as the masked kernel gets
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
sparse_lora_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        const uint8_t* __restrict__ mask,
                        const bf16* __restrict__ lora_a,
                        const bf16* __restrict__ lora_b, int r, float scale,
                        bf16* __restrict__ y, float* __restrict__ partial,
                        int M, int N, int K, int k_split) {
  __shared__ __align__(128) bf16 As[BM * LDA];
  __shared__ __align__(128) bf16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[THREADS / 32][16 * 16];
  // dynamic: the block's B columns (r × BN) and the K step's A rows (BK × r)
  extern __shared__ __align__(16) float lora_smem[];
  float* sB = lora_smem;
  float* sA = lora_smem + r * BN;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);

  for (int e = tid; e < r * BN; e += THREADS) {
    const int gn = n0 + e % BN;
    sB[e] = gn < N ? __bfloat162float(lora_b[(size_t)(e / BN) * N + gn]) : 0.f;
  }

  Acc acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  uint4 ra[2];
  Pack8 pw[2];
  Mask8 pm[2];
  load_x<VEC>(x, M, K, k_end, m0, k_begin, tid, ra);
  load_w_raw<VEC>(w, mask, N, k_end, n0, k_begin, tid, pw, pm);

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int e = tid; e < BK * r; e += THREADS) {
      const int gk = k0 + e / r;
      sA[e] = gk < k_end ? __bfloat162float(lora_a[(size_t)gk * r + e % r]) : 0.f;
    }
    __syncthreads();   // this step's A rows (and, once, B) are in place
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int row = c >> 4, col = (c & 15) * 8;
      *reinterpret_cast<uint4*>(As + (c >> 2) * LDA + (c & 3) * 8) = ra[i];
      *reinterpret_cast<uint4*>(Bs + row * LDB + col) =
          merge_chunk(pw[i], pm[i], sA + row * r, sB + col, r, scale);
    }
    __syncthreads();
    if (k0 + BK < k_end) {   // next tile's raw loads in flight during the MMAs
      load_x<VEC>(x, M, K, k_end, m0, k0 + BK, tid, ra);
      load_w_raw<VEC>(w, mask, N, k_end, n0, k0 + BK, tid, pw, pm);
    }
    mma_step(acc, As, Bs, wm, wn);
    __syncthreads();
  }

  store_tile(acc, Cs[warp], lane, m0 + wm * 64, n0 + wn * 32, M, N, y,
             partial, nullptr);
}

// ------------------------------------------------------------- float32 path
template <bool PACKED>
__global__ void __launch_bounds__(FTHREADS)
masked_matmul_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         const void* __restrict__ mask, int group,
                         const float* __restrict__ scale, float* __restrict__ y,
                         int M, int N, int K) {
  mm_f32_tile(x,
              WTile<float, PACKED ? PACKED_MASK : BOOL_MASK>(w, mask, group, N),
              scale, y, M, N, K);
}

// fp32 sparse-LoRA: the float32 tile loop with the merge on the W tile
__global__ void __launch_bounds__(FTHREADS)
sparse_lora_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const uint8_t* __restrict__ mask,
                       const float* __restrict__ lora_a,
                       const float* __restrict__ lora_b, int r, float scale,
                       float* __restrict__ y, int M, int N, int K) {
  __shared__ float As[FBK][FBM + 4];
  __shared__ float Bs[FBK][FBN + 4];
  extern __shared__ __align__(16) float lora_smem[];
  float* sB = lora_smem;             // r × FBN
  float* sA = lora_smem + r * FBN;   // FBK × r
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  for (int e = tid; e < r * FBN; e += FTHREADS) {
    const int gn = n0 + e % FBN;
    sB[e] = gn < N ? lora_b[(size_t)(e / FBN) * N + gn] : 0.f;
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FBK) {
    for (int e = tid; e < FBK * r; e += FTHREADS) {
      const int gk = k0 + e / r;
      sA[e] = gk < K ? lora_a[(size_t)gk * r + e % r] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * FTHREADS;
      const int ar = e >> 4, ac = e & 15;
      const int gm = m0 + ar, gk = k0 + ac;
      As[ac][ar] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
      const int br = e >> 6, bc = e & 63;
      const int wk = k0 + br, wn = n0 + bc;
      float v = 0.f;
      if (wk < K && wn < N) {
        const size_t off = (size_t)wk * N + wn;
        if (mask[off]) {
          float d = 0.f;
          for (int rr = 0; rr < r; ++rr)
            d = fmaf(sA[br * r + rr], sB[rr * FBN + bc], d);
          v = __fadd_rn(w[off], __fmul_rn(scale, d));
        }
      }
      Bs[br][bc] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gm < M && gn < N) y[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

// C entry points (bound with ctypes).  Pointers are device pointers, the
// stream is a cudaStream_t; the return value is cudaGetLastError() after
// the launches.  `vec` promises 16-byte aligned x/W rows and 8-byte aligned
// bool-mask rows, or 16-byte aligned packed-word rows (K % 8 == 0,
// N % 8 == 0 and aligned base pointers).

namespace {

// splits > 1 (decode-sized M, too few output tiles to fill the card):
// each of `splits` K-ranges of k_split columns writes an fp32 partial
// into workspace (splits × M × N), then one pass sums them in order
template <bool PACKED>
int masked_bf16(const void* x, const void* w, const void* mask, int group,
                void* y, void* workspace, int M, int N, int K, int splits,
                int k_split, int vec, void* stream) {
  if (splits < 1 || (long long)splits * k_split < K ||
      (splits > 1 && workspace == nullptr) ||
      (PACKED && group != 128 && group != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_bf16(
      vec ? masked_matmul_bf16_kernel<true, PACKED>
          : masked_matmul_bf16_kernel<false, PACKED>,
      x, static_cast<const bf16*>(w), mask, group, nullptr, y, workspace, M, N,
      K, splits, k_split, static_cast<cudaStream_t>(stream)));
}

template <bool PACKED>
int masked_f32(const void* x, const void* w, const void* mask, int group,
               void* y, int M, int N, int K, void* stream) {
  if (PACKED && group != 128 && group != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_f32(
      masked_matmul_f32_kernel<PACKED>, x, static_cast<const float*>(w), mask,
      group, nullptr, y, M, N, K, static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" int masked_matmul_bf16(const void* x, const void* w, const void* mask,
                                  void* y, void* workspace, int M, int N, int K,
                                  int splits, int k_split, int vec,
                                  void* stream) {
  return masked_bf16<false>(x, w, mask, 0, y, workspace, M, N, K, splits,
                            k_split, vec, stream);
}

extern "C" int masked_matmul_f32(const void* x, const void* w, const void* mask,
                                 void* y, int M, int N, int K, void* stream) {
  return masked_f32<false>(x, w, mask, 0, y, M, N, K, stream);
}

// `packed`: (8·⌈K/group⌉, N) 32-bit words, group 128 or 256
extern "C" int masked_matmul_packed_bf16(const void* x, const void* w,
                                         const void* packed, int group, void* y,
                                         void* workspace, int M, int N, int K,
                                         int splits, int k_split, int vec,
                                         void* stream) {
  return masked_bf16<true>(x, w, packed, group, y, workspace, M, N, K, splits,
                           k_split, vec, stream);
}

extern "C" int masked_matmul_packed_f32(const void* x, const void* w,
                                        const void* packed, int group, void* y,
                                        int M, int N, int K, void* stream) {
  return masked_f32<true>(x, w, packed, group, y, M, N, K, stream);
}

// splits > 1: as masked_matmul_bf16.  A (K, r) and B (r, N) are row-major
// bf16; 1 ≤ r ≤ 128 (the block stages r·(BN + BK) fp32 values).
extern "C" int sparse_lora_matmul_bf16(const void* x, const void* w,
                                       const void* mask, const void* lora_a,
                                       const void* lora_b, int r, float scale,
                                       void* y, void* workspace, int M, int N,
                                       int K, int splits, int k_split, int vec,
                                       void* stream) {
  if (splits < 1 || (long long)splits * k_split < K ||
      (splits > 1 && workspace == nullptr) || r < 1 || r > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = r * (BN + BK) * static_cast<int>(sizeof(float));
  auto kernel = vec ? sparse_lora_bf16_kernel<true> : sparse_lora_bf16_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* partial = splits > 1 ? static_cast<float*>(workspace) : nullptr;
  kernel<<<grid, THREADS, smem, st>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(w),
          static_cast<const uint8_t*>(mask), static_cast<const bf16*>(lora_a),
          static_cast<const bf16*>(lora_b), r, scale, static_cast<bf16*>(y),
          partial, M, N, K, k_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(
      splitk_reduce(partial, static_cast<bf16*>(y), M, N, splits, nullptr, st));
}

// fp32 y, unrounded (a row-parallel shard's partial sums; the sum over
// ranks rounds once): one split writes y as its partial, more write the
// workspace and the split-K pass sums it into y; bool masks, otherwise as
// masked_matmul_bf16 and sparse_lora_matmul_bf16
extern "C" int masked_matmul_out32_bf16(const void* x, const void* w,
                                        const void* mask, void* y,
                                        void* workspace, int M, int N, int K,
                                        int splits, int k_split, int vec,
                                        void* stream) {
  if (splits < 1 || (long long)splits * k_split < K ||
      (splits > 1 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* partial = static_cast<float*>(splits > 1 ? workspace : y);
  auto kernel = vec ? masked_matmul_bf16_kernel<true, false>
                    : masked_matmul_bf16_kernel<false, false>;
  kernel<<<grid, THREADS, 0, st>>>(static_cast<const bf16*>(x),
                                   static_cast<const bf16*>(w), mask, 0,
                                   nullptr, nullptr, partial, M, N, K,
                                   k_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(splitk_reduce(partial, static_cast<float*>(y), M,
                                        N, splits, nullptr, st));
}

extern "C" int sparse_lora_matmul_out32_bf16(
    const void* x, const void* w, const void* mask, const void* lora_a,
    const void* lora_b, int r, float scale, void* y, void* workspace, int M,
    int N, int K, int splits, int k_split, int vec, void* stream) {
  if (splits < 1 || (long long)splits * k_split < K ||
      (splits > 1 && workspace == nullptr) || r < 1 || r > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = r * (BN + BK) * static_cast<int>(sizeof(float));
  auto kernel = vec ? sparse_lora_bf16_kernel<true> : sparse_lora_bf16_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* partial = static_cast<float*>(splits > 1 ? workspace : y);
  kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const uint8_t*>(mask), static_cast<const bf16*>(lora_a),
      static_cast<const bf16*>(lora_b), r, scale, nullptr, partial, M, N, K,
      k_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(splitk_reduce(partial, static_cast<float*>(y), M,
                                        N, splits, nullptr, st));
}

extern "C" int sparse_lora_matmul_f32(const void* x, const void* w,
                                      const void* mask, const void* lora_a,
                                      const void* lora_b, int r, float scale,
                                      void* y, int M, int N, int K,
                                      void* stream) {
  if (r < 1 || r > 128) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = r * (FBN + FBK) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      sparse_lora_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
  sparse_lora_f32_kernel<<<grid, FTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(lora_a),
      static_cast<const float*>(lora_b), r, scale, static_cast<float*>(y),
      M, N, K);
  return static_cast<int>(cudaGetLastError());
}

