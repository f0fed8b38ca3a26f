// The tiled matmul of masked_matmul.cu and int8_matmul.cu for Hopper
// (sm_90a): y = (x @ (W ⊙ mask)) [· scale], one tile loop for bf16 (WMMA,
// fp32 accumulate, split-K partials and their ordered sum) and one for
// float32 (CUDA cores), each templated on the W tile's loader — bf16,
// float or int8 weights, with no mask, a bool byte per weight or the
// bit-packed words of vlm_compression_tpu_torch/ops/bitmask.py.  The
// kernels of both files are these loops with one loader each.
//
// Every kernel runs the same loop, so for the same weights and mask their
// fp32 sums run in the same order: the packed-mask kernel's output is
// bit-equal to the bool-mask kernel's.
//
// The bf16 loop is the WMMA (mma.sync) one, with split-K: it runs shapes
// TMA cannot take, ranks other than 2, 4 and 8, small M with an adapter,
// and launches forced onto it for timing.  At decode-sized M the bool,
// packed and int8 matmuls run the decode kernel of matmul_decode.cu;
// above it all four run the Hopper TMA + wgmma loop of wgmma_tile.cuh,
// split-K across a cluster where the tiles do not fill the card
// (ops/masked_linear.py `plan`).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace tile {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------- bf16 path
constexpr int BM = 128, BN = 128, BK = 32, THREADS = 256;
constexpr int LDA = BK + 8;   // shared row of the x tile, in elements (80 B)
constexpr int LDB = BN + 8;   // shared row of the W tile, in elements (272 B)

union Pack8 {
  uint4 u;
  uint32_t w[4];
  uint16_t h[8];   // bf16 bit patterns
};

union Mask8 {
  uint2 u;
  uint8_t b[8];
};

// x tile: BM × BK = 512 chunks of 8 elements, two per thread.
// Columns at or past k_end read as zeros (the split's or the matrix's end).
template <bool VEC>
__device__ __forceinline__ void load_x(const bf16* __restrict__ x, int M, int K,
                                       int k_end, int m0, int k0, int tid,
                                       uint4 (&r)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;
    const int row = c >> 2, col = (c & 3) * 8;
    const int gm = m0 + row, gk = k0 + col;
    Pack8 p;
    if (VEC) {
      p.u = (gm < M && gk < k_end)
                ? *reinterpret_cast<const uint4*>(x + (size_t)gm * K + gk)
                : make_uint4(0u, 0u, 0u, 0u);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        p.h[e] = (gm < M && gk + e < k_end)
                     ? __bfloat16_as_ushort(x[(size_t)gm * K + gk + e]) : 0;
    }
    r[i] = p.u;
  }
}

// The W tile (BK × BN) is 512 chunks of 8 columns, two per thread: chunk i
// of thread tid is row (tid >> 4) + 16·i, columns ((tid & 15) · 8) + 0..7.
__device__ __forceinline__ int w_row(int tid, int i) { return (tid >> 4) + 16 * i; }
__device__ __forceinline__ int w_col(int tid) { return (tid & 15) * 8; }

// ------------------------------------------------------- bit-packed masks
// Mask row G·g + r lives in word row 8g + r % 8 at bit r / 8 (G = 128 or
// 256, words (8·⌈K/G⌉, N) row-major).  A K step (BK = 32 rows, starting at
// a multiple of 32) lies inside one group, and a thread's two W chunks
// (rows 16 apart) share the residue row % 8: so all chunks of a thread, in
// every K step of one group, read the same 8 words (word row
// 8·(k0 / G) + (tid >> 4) % 8, the chunk's 8 columns).  The kernels keep
// them in registers and reload them only when a K step enters a new group.
template <bool VEC>
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ packed,
                                           int N, int k0, int group, int tid,
                                           int gn, uint32_t (&wd)[8]) {
  const uint32_t* row =
      packed + (size_t)(8 * (k0 / group) + ((tid >> 4) & 7)) * N;
  if (VEC) {
    uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
    if (gn < N) {   // N % 8 == 0: the whole chunk is in range
      a = *reinterpret_cast<const uint4*>(row + gn);
      b = *reinterpret_cast<const uint4*>(row + gn + 4);
    }
    wd[0] = a.x; wd[1] = a.y; wd[2] = a.z; wd[3] = a.w;
    wd[4] = b.x; wd[5] = b.y; wd[6] = b.z; wd[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) wd[e] = gn + e < N ? row[gn + e] : 0u;
  }
}

// bit of K row gk in its word (shifts on the raw bits: bit 31 is no sign)
__device__ __forceinline__ int word_bit(int gk, int group) {
  return (gk % group) >> 3;
}

// zero the bf16 values of a chunk whose mask bit is clear
__device__ __forceinline__ void apply_bits(Pack8& p, const uint32_t (&wd)[8],
                                           int bit) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t lo = (wd[2 * j] >> bit) & 1u;
    const uint32_t hi = (wd[2 * j + 1] >> bit) & 1u;
    p.w[j] &= ((0u - lo) & 0x0000FFFFu) | ((0u - hi) & 0xFFFF0000u);
  }
}

// one mask bit of element (gk, gn) (the unvectorized and float32 paths)
__device__ __forceinline__ bool packed_keep(const uint32_t* __restrict__ packed,
                                            int N, int gk, int gn, int group) {
  const uint32_t w = packed[(size_t)(8 * (gk / group) + (gk & 7)) * N + gn];
  return (w >> word_bit(gk, group)) & 1u;
}

// ------------------------------------------------------- MMA and epilogue
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

// a warp's 64 × 32 accumulators → y (bf16) or its split's fp32 partial,
// through the warp's 16 × 16 staging tile; ragged edges masked.  A non-null
// `scale` multiplies column n by scale[n] in fp32 before the one rounding
// (the int8 kernels' per-column scale; never on a partial).
__device__ __forceinline__ void store_tile(Acc (&acc)[4][2], float* cs,
                                           int lane, int row0, int col0,
                                           int M, int N, bf16* __restrict__ y,
                                           float* __restrict__ partial,
                                           const float* __restrict__ scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = row0 + i * 16 + (e >> 4);
        const int gn = col0 + j * 16 + (e & 15);
        if (gm >= M || gn >= N) continue;
        if (partial)
          partial[((size_t)blockIdx.z * M + gm) * N + gn] = cs[e];
        else
          y[(size_t)gm * N + gn] =
              __float2bfloat16(scale ? cs[e] * scale[gn] : cs[e]);
      }
      __syncwarp();
    }
  }
}

// acc += As · Bs over one BK step (the warp's 64 × 32 slice)
__device__ __forceinline__ void mma_step(Acc (&acc)[4][2], const bf16* As,
                                         const bf16* Bs, int wm, int wn) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wmma::load_matrix_sync(a[i], As + (wm * 64 + i * 16) * LDA + kk, LDA);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(b[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void put_out(bf16* y, long long i, float v) {
  y[i] = __float2bfloat16(v);
}
__device__ __forceinline__ void put_out(float* y, long long i, float v) {
  y[i] = v;
}

// y = Σ_z partial[z] in a fixed order (· scale[n] when given), cast to bf16
// (a float y: unrounded, a row-parallel shard's partial sums)
template <typename T>
__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     T* __restrict__ y, long long mn,
                                     int splits, int N,
                                     const float* __restrict__ scale) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += partial[z * mn + i];
    put_out(y, i, scale ? s * scale[i % N] : s);
  }
}

// the split-K sum after a tile kernel; returns cudaGetLastError()
template <typename T>
inline cudaError_t splitk_reduce(const float* partial, T* y, int M, int N,
                                 int splits, const float* scale,
                                 cudaStream_t st) {
  const long long mn = (long long)M * N;
  const long long want = (mn + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  splitk_reduce_kernel<<<blocks, 256, 0, st>>>(partial, y, mn, splits, N,
                                               scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------ W loaders
enum MaskKind { NO_MASK = 0, BOOL_MASK = 1, PACKED_MASK = 2 };

union Code8 {
  uint2 u;
  int8_t c[8];
};

// one weight as bf16 bits: bf16 as is; an int8 code converted (|q| ≤ 127
// is exact in bf16)
__device__ __forceinline__ uint16_t bf16_bits(bf16 v) {
  return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ uint16_t bf16_bits(int8_t v) {
  return __bfloat16_as_ushort(__float2bfloat16(static_cast<float>(v)));
}

// 8 weights of one row from an aligned address, as bf16 bits: 16 bytes of
// bf16, or 8 bytes of int8 codes converted in registers
__device__ __forceinline__ void load8(const bf16* p, Pack8& out) {
  out.u = *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void load8(const int8_t* p, Pack8& out) {
  Code8 c;
  c.u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int e = 0; e < 8; ++e) out.h[e] = bf16_bits(c.c[e]);
}

// The W tile's loader: weights of type T (bf16 or int8 for the bf16 loop,
// float or int8 for the float32 one), (K, N) row-major, and the mask of
// kind MASK.  A packed mask's 8 words of the thread's chunk columns are
// held for a whole group (`wd`, of group `wg`).
template <typename T, int MASK>
struct WTile {
  const T* __restrict__ w;
  const void* __restrict__ mask;
  int group, N;
  uint32_t wd[8];
  int wg;

  __device__ WTile(const T* w_, const void* mask_, int group_, int N_)
      : w(w_), mask(mask_), group(group_), N(N_), wg(-1) {}

  __device__ __forceinline__ const uint8_t* bytes() const {
    return static_cast<const uint8_t*>(mask);
  }
  __device__ __forceinline__ const uint32_t* words() const {
    return static_cast<const uint32_t*>(mask);
  }

  // bf16 loop: the thread's two chunks of the BK × BN tile at k0, as bf16
  // bits, zeroed where the mask is false (in registers, on their way to
  // shared memory) or out of range
  template <bool VEC>
  __device__ __forceinline__ void load(int k_end, int n0, int k0, int tid,
                                       uint4 (&r)[2]) {
    const int gn = n0 + w_col(tid);
    if (MASK == PACKED_MASK && k0 / group != wg) {
      wg = k0 / group;
      load_words<VEC>(words(), N, k0, group, tid, gn, wd);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gk = k0 + w_row(tid, i);
      Pack8 p;
      if (VEC) {
        p.u = make_uint4(0u, 0u, 0u, 0u);
        if (gk < k_end && gn < N) {
          const size_t off = (size_t)gk * N + gn;
          load8(w + off, p);
          if (MASK == BOOL_MASK) {
            Mask8 m;
            m.u = *reinterpret_cast<const uint2*>(bytes() + off);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              p.w[j] &= (m.b[2 * j] ? 0x0000FFFFu : 0u) |
                        (m.b[2 * j + 1] ? 0xFFFF0000u : 0u);
          }
          if (MASK == PACKED_MASK) apply_bits(p, wd, word_bit(gk, group));
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const size_t off = (size_t)gk * N + gn + e;
          bool keep = gk < k_end && gn + e < N;
          if (keep && MASK == BOOL_MASK) keep = bytes()[off] != 0;
          if (keep && MASK == PACKED_MASK)
            keep = (wd[e] >> word_bit(gk, group)) & 1u;
          p.h[e] = keep ? bf16_bits(w[off]) : 0;
        }
      }
      r[i] = p.u;
    }
  }

  // float32 loop: element (wk, wn) as float, 0 where masked or out of range
  __device__ __forceinline__ float at(int K, int wk, int wn) const {
    if (wk >= K || wn >= N) return 0.f;
    const size_t off = (size_t)wk * N + wn;
    if (MASK == BOOL_MASK && !bytes()[off]) return 0.f;
    if (MASK == PACKED_MASK && !packed_keep(words(), N, wk, wn, group))
      return 0.f;
    return static_cast<float>(w[off]);
  }
};

// ------------------------------------------------------------ bf16 loop
// One 128 × 128 output tile (blockIdx.x, blockIdx.y) over K in
// [blockIdx.z · k_split, + k_split): 8 warps of 64 × 32, K steps of 32,
// the next step's x and W loads in flight during the MMAs (register
// prefetch).  One split writes y (· scale, one rounding); more write their
// fp32 partials, which splitk_reduce sums.  The caller's __global__
// carries __launch_bounds__(THREADS, 2): at most 128 registers a thread,
// two blocks per SM.
template <bool VEC, typename T, int MASK>
__device__ __forceinline__ void mm_bf16_tile(const bf16* __restrict__ x,
                                             WTile<T, MASK> wt,
                                             const float* __restrict__ scale,
                                             bf16* __restrict__ y,
                                             float* __restrict__ partial,
                                             int M, int N, int K, int k_split) {
  __shared__ __align__(128) bf16 As[BM * LDA];
  __shared__ __align__(128) bf16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[THREADS / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;      // 2 × 4 warps, 64 × 32 each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // split-K: block z sums k in [k_begin, k_end) into its own fp32 partial
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);

  Acc acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  uint4 ra[2], rb[2];
  load_x<VEC>(x, M, K, k_end, m0, k_begin, tid, ra);
  wt.template load<VEC>(k_end, n0, k_begin, tid, rb);

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      *reinterpret_cast<uint4*>(As + (c >> 2) * LDA + (c & 3) * 8) = ra[i];
      *reinterpret_cast<uint4*>(Bs + (c >> 4) * LDB + (c & 15) * 8) = rb[i];
    }
    __syncthreads();
    if (k0 + BK < k_end) {   // next tile's loads in flight during the MMAs
      load_x<VEC>(x, M, K, k_end, m0, k0 + BK, tid, ra);
      wt.template load<VEC>(k_end, n0, k0 + BK, tid, rb);
    }
    mma_step(acc, As, Bs, wm, wn);
    __syncthreads();
  }

  // one split: scale and round here; else the split-K pass does both
  store_tile(acc, Cs[warp], lane, m0 + wm * 64, n0 + wn * 32, M, N, y,
             partial, partial ? nullptr : scale);
}

// launch the bf16 loop's kernel over (N/BN, M/BM, splits), then the split-K
// sum; returns cudaGetLastError().  `kernel` is a __global__ wrapping
// mm_bf16_tile with the same arguments.
template <typename Kernel, typename T>
cudaError_t launch_bf16(Kernel kernel, const void* x, const T* w,
                        const void* mask, int group, const float* scale,
                        void* y, void* workspace, int M, int N, int K,
                        int splits, int k_split, cudaStream_t st) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  float* partial = splits > 1 ? static_cast<float*>(workspace) : nullptr;
  kernel<<<grid, THREADS, 0, st>>>(static_cast<const bf16*>(x), w, mask, group,
                                   scale, static_cast<bf16*>(y), partial, M, N,
                                   K, k_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return splitk_reduce(partial, static_cast<bf16*>(y), M, N, splits, scale,
                       st);
}

// ---------------------------------------------------------- float32 loop
constexpr int FBM = 64, FBN = 64, FBK = 16, FTHREADS = 256;

// One 64 × 64 output tile on the CUDA cores (no TF32: exact-fp32
// semantics), K steps of 16; y = sum (· scale[n] when given).
template <typename T, int MASK>
__device__ __forceinline__ void mm_f32_tile(const float* __restrict__ x,
                                            const WTile<T, MASK>& wt,
                                            const float* __restrict__ scale,
                                            float* __restrict__ y, int M,
                                            int N, int K) {
  __shared__ float As[FBK][FBM + 4];   // transposed x tile: As[k][m]
  __shared__ float Bs[FBK][FBN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * FTHREADS;
      const int ar = e >> 4, ac = e & 15;           // x: 64 rows × 16 cols
      const int gm = m0 + ar, gk = k0 + ac;
      As[ac][ar] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
      const int br = e >> 6, bc = e & 63;           // W: 16 rows × 64 cols
      Bs[br][bc] = wt.at(K, k0 + br, n0 + bc);
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
      if (gm < M && gn < N)
        y[(size_t)gm * N + gn] = scale ? acc[i][j] * scale[gn] : acc[i][j];
    }
  }
}

// launch the float32 loop's kernel over (N/FBN, M/FBM)
template <typename Kernel, typename T>
cudaError_t launch_f32(Kernel kernel, const void* x, const T* w,
                       const void* mask, int group, const float* scale,
                       void* y, int M, int N, int K, cudaStream_t st) {
  dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
  kernel<<<grid, FTHREADS, 0, st>>>(static_cast<const float*>(x), w, mask,
                                    group, scale, static_cast<float*>(y), M, N,
                                    K);
  return cudaGetLastError();
}

}  // namespace tile
