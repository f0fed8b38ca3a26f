// The decode-shaped matmuls for Hopper (sm_90a): one kernel for
//   bf16 weights   y = x · (W ⊙ mask)            (bool bytes or packed words)
//   int8 codes     y = (x · (q ⊙ mask)) · scale  (no mask, bool or packed)
// at decode-sized M (batch × beams, ≤ 64 rows), bf16 x and y.
//
// Replaces, at those shapes, the Pallas TPU kernels `_mm_packed_kernel`
// (vlm_compression_tpu/ops/masked_linear.py:194) and the inner `kernel` of
// `_int8_matmul_pallas` (vlm_compression_tpu/ops/quant.py:84), and runs the
// bool-mask matmul's (`_mm_kernel`, masked_linear.py:67) decode launches
// too: ops/masked_linear.py `plan` sends every form of one shape to one
// loop, so packed ≡ bool and int8-masked ≡ int8-zeroed-unmasked stay
// bit-equal.  Larger M keeps the Hopper loop (wgmma_tile.cuh) or the WMMA
// loop (tile_mma.cuh).
//
// What bounds it on an H100: bytes.  At M = 20 the function does 2·M = 40
// operations a weight against 2 bytes (bf16) or 1 (int8) plus the mask's
// 1/4 or 1/8 (packed) or 1 (bool): under 40 operations a byte, against the
// card's 295 a byte of bf16 peak over HBM rate.  So the design keeps many
// weight bytes in flight, reads each exactly once and does nothing else
// through device memory.  Measured (scripts/torch_decode_trace.py, PERF.md
// §6): bf16 blocks wait on their loads; int8 blocks on their fragment
// build (the codes' conversion and the mask); at the T5 shapes a block's
// fixed costs (the first stage's landing, the split-K sum) are up to a
// third of its life.
//
//  * Swap A and B: yᵀ = (W ⊙ M)ᵀ · xᵀ.  The weight's N columns fill the MMA
//    rows (mma.sync m16n8k16: 16 rows a warp), x's M rows the narrow side
//    (8 a tile, MT tiles), so no MMA row multiplies padding; at M = 20 one
//    n8 tile in three is partly padding (24 for 20).
//  * W (bf16, or the int8 codes), the mask tile (bool bytes, or the 8 word
//    rows of ops/bitmask.py's layout of the step's G-row group) and the
//    step's x slice stream by TMA (one producer thread) into a ring of
//    STAGES shared-memory stages, sized so a block keeps 72-91 KB of loads
//    in flight, two blocks an SM.
//  * Four consumer warps, 16 weight columns each, build the A fragment in
//    registers: ldmatrix.trans from the staged [k][n] bf16 tile (128-byte
//    swizzle), then the mask; or, for the codes (64-byte swizzle),
//    ldmatrix.trans of byte pairs (A rows then map to columns 2g, 2g + 1),
//    the mask on the bytes, and each byte to bf16 through the float
//    2^23 + q + 128 (exact for |q| ≤ 127; no int-to-float conversions).
//    xᵀ is the B fragment: ldmatrix of the K-contiguous x rows.  The
//    masked, dequantized weight never exists in shared or device memory.
//  * Split-K across a thread-block cluster: the K splits of one 64-column
//    tile are the cluster's blocks (gridDim.x = splits, ≤ 8).  Once all
//    are past their main loops (a cluster barrier), blocks 1, 2, … send
//    their fp32 accumulators into block 0's spent ring through distributed
//    shared memory; after a second barrier block 0 adds them to its own in
//    rank order, scales (int8: the fp32 sum times scale[n], as quant.py),
//    rounds to bf16 once and stores.  One launch, no workspace, no
//    atomics: the same inputs give the same bits, and every mask form of
//    one weight sums the same products in the same order.
//
// Split boundaries fall on multiples of 256 (the larger pack group), so
// no block straddles a group's words; a K tail past the matrix loads as
// zeros (TMA's out-of-bounds fill; the packed rows are padded to whole
// groups).  The pure-Python `plan_decode` (ops/masked_linear.py) picks the
// splits, the same for every mask kind of a weight form.
//
// Preconditions (checked here and by `plan`): 1 ≤ M ≤ 64; K % 8 == 0 and
// N % 16 == 0 (TMA strides of x, W, codes and bool bytes); 16-byte aligned
// x, W and mask bases; packed group 128 or 256.  Compile with
// -DDECODE_TRACE for a clock64 timeline of block (0, 0)
// (scripts/torch_decode_trace.py).

#include "hopper.cuh"   // mbarriers, TMA, 2-D tensor maps, bind_context

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int BN = 64;           // weight columns (output columns) a block
constexpr int BK = 64;           // K rows a stage
constexpr int K_UNIT = 256;      // split boundaries (ops/masked_linear.py)
constexpr int MAX_SPLITS = 8;    // portable cluster size
constexpr int CONSUMERS = BN / 16;   // warps, 16 columns each
constexpr int THREADS = 32 * (CONSUMERS + 1);
constexpr int KI = BK / 16;          // k16 steps a stage
constexpr int RING_BUDGET = 96 * 1024;   // two blocks an SM
constexpr int MAX_STAGES = 8;

enum MaskKind { NO_MASK = 0, BOOL_MASK = 1, PACKED_MASK = 2 };

// shared-memory layout of one stage: the W tile (bf16 128-byte swizzled
// [k][n] rows, or int8 codes 64-byte swizzled), x (8·MT rows of 64 k,
// 128-byte swizzle), the mask (bool bytes as the codes, or 8 × 64 words);
// every part a multiple of 1 KB, so each stays 1024-byte aligned.
template <bool INT8, int MASK, int MT>
struct Cfg {
  static constexpr int W_BYTES = INT8 ? BK * BN : BK * BN * 2;
  static constexpr int X_BYTES = MT * 8 * BK * 2;
  static constexpr int M_BYTES =
      MASK == BOOL_MASK ? BK * BN : MASK == PACKED_MASK ? 8 * BN * 4 : 0;
  static constexpr int STAGE = W_BYTES + X_BYTES + M_BYTES;
  static constexpr int STAGES = RING_BUDGET / STAGE < MAX_STAGES
                                    ? RING_BUDGET / STAGE : MAX_STAGES;
  static constexpr int RING = STAGES * STAGE;
  // block 0's receive buffer of the split-K sum, over the spent ring: the
  // accumulators of every other block's consumer threads
  static constexpr int RECV = (MAX_SPLITS - 1) * CONSUMERS * 32 * MT * 16;
  static constexpr int SMEM = (RING > RECV ? RING : RECV) + 1024;
  static_assert(STAGE % 1024 == 0 && STAGES >= 2, "stage layout");
};

// -DDECODE_TRACE: block (0, 0) records clock64 per K step: the producer's
// issue [0], consumer warp 0 seeing the stage land [1] and freeing it [2];
// and [3]: kernel start, every block past its main loop, the partials in
// block 0, stores done
#ifdef DECODE_TRACE
__device__ long long dc_trace[4][256];
#define TRACE(e, i)                                                  \
  if (blockIdx.x == 0 && blockIdx.y == 0 && (i) < 256)               \
    dc_trace[e][i] = clock64();
#else
#define TRACE(e, i)
#endif

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

// d[16 × 8] += a[16 × 16] · b[16 × 8], bf16 in, fp32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte (k, n) of a 64 × 64 byte tile under TMA's 64-byte swizzle (16-byte
// chunk ^= (k / 2) % 4)
__device__ __forceinline__ int sw64(int k, int n) {
  return k * 64 + ((((n >> 4) ^ (k >> 1)) & 3) << 4) + (n & 15);
}

// 16-byte row chunk `chunk` of row `row` of a 128-byte-row tile under the
// 128-byte swizzle (chunk ^= row % 8)
__device__ __forceinline__ uint32_t sw128(uint32_t base, int row, int chunk) {
  return base + row * 128 + (((chunk ^ row) & 7) << 4);
}

// One block: output columns [n0, n0 + 64) over K in [blockIdx.x · k_split,
// + k_split); the cluster is the blockIdx.x row of splits.  F32: `y` points
// at an fp32 output, written unrounded (a row-parallel shard's partial
// sums; the sum over ranks rounds once).
template <bool INT8, int MASK, int MT, bool F32 = false>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const __grid_constant__ CUtensorMap tm_x,
              const __grid_constant__ CUtensorMap tm_w,
              const __grid_constant__ CUtensorMap tm_m,
              const float* __restrict__ scale, bf16* __restrict__ y, int M,
              int N, int K, int k_split, int group) {
  using C = Cfg<INT8, MASK, MT>;
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t full[C::STAGES], empty[C::STAGES];
  __shared__ float s_scale[BN];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(dyn_smem) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int splits = gridDim.x;
  const int n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.x * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int n_k = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (tid == THREADS - 32) {   // the producer: its maps into the cache
    asm volatile("prefetch.tensormap [%0];" ::"l"(&tm_w) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(&tm_x) : "memory");
    if (MASK != NO_MASK)
      asm volatile("prefetch.tensormap [%0];" ::"l"(&tm_m) : "memory");
  }
  if (tid == 0) {
    TRACE(3, 0);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  float acc[MT][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;

  if (warp == CONSUMERS) {
    // ------------------------------------------------------------ producer
    if (lane == 0) {
      for (int j = 0; j < n_k; ++j) {
        const int s = j % C::STAGES, k0 = k_begin + j * BK;
        if (j >= C::STAGES)
          mbar_wait(&empty[s], ((j / C::STAGES) & 1) ^ 1);
        uint8_t* st = smem + s * C::STAGE;
        mbar_expect_tx(&full[s], C::STAGE);
        tma_load(st, &tm_w, &full[s], n0, k0);
        tma_load(st + C::W_BYTES, &tm_x, &full[s], k0, 0);
        if (MASK == BOOL_MASK)
          tma_load(st + C::W_BYTES + C::X_BYTES, &tm_m, &full[s], n0, k0);
        if (MASK == PACKED_MASK)
          tma_load(st + C::W_BYTES + C::X_BYTES, &tm_m, &full[s], n0,
                   8 * (k0 / group));
        TRACE(0, j);
      }
    } else if (INT8) {   // the tile's scales, read at the end
      for (int i = lane - 1; i < BN; i += 31)
        s_scale[i] = n0 + i < N ? scale[n0 + i] : 0.f;
    }
    __syncwarp();
  } else {
    // ----------------------------------------------------------- consumers
    // mma fragments: g = lane / 4 is the A row and the x row (B column)
    // of a thread, c = lane % 4 its pair of k; ldmatrix lanes j8 = lane / 8
    // address matrix j8's row r8 = lane % 8.  A row g is weight column
    // nw + g and row g + 8 column nw + g + 8 (bf16); for int8 codes, which
    // ldmatrix moves as byte pairs of neighbouring columns, row g is
    // column nw + 2g and row g + 8 column nw + 2g + 1
    const int g = lane >> 2, c = lane & 3;
    const int nw = warp * 16;
    const int j8 = lane >> 3, r8 = lane & 7;
    const int col0 = nw + (INT8 ? 2 * g : g), col1 = col0 + (INT8 ? 1 : 8);
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % C::STAGES;
      mbar_wait(&full[s], (kt / C::STAGES) & 1);
      if (warp == 0 && lane == 0) TRACE(1, kt);
      const uint8_t* st = smem + s * C::STAGE;
      const uint32_t w_addr = smem_u32(st);
      const uint32_t x_addr = smem_u32(st + C::W_BYTES);
      const uint8_t* ms = st + C::W_BYTES + C::X_BYTES;
      // packed: rows 2c + e of the step's group hold the bits of k rows
      // 2c + e (mod 8) at the thread's columns (h = 0: col0, 1: col1); k16
      // step kk, half (k + 8) reads bit (k % G) / 8 = bit + 2kk + half.
      // The stage's 8 bits from `bit` of each word, gathered once: pair[h]
      // holds row 2c's at bits 0-7 and row 2c + 1's at 16-23 (a bf16
      // pair's two halves), quad row 2c's col0, col1 and row 2c + 1's
      // col0, col1 in bytes 0-3 (an int8 quad's bytes)
      uint32_t pair[2] = {0u, 0u}, quad_bits = 0u;
      if (MASK == PACKED_MASK) {
        const uint32_t* words = reinterpret_cast<const uint32_t*>(ms);
        const int bit = ((k_begin + kt * BK) % group) >> 3;
        uint32_t b8[2][2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            b8[e][h] =
                (words[(2 * c + e) * BN + (h ? col1 : col0)] >> bit) & 0xFFu;
        pair[0] = b8[0][0] | b8[1][0] << 16;
        pair[1] = b8[0][1] | b8[1][1] << 16;
        quad_bits = b8[0][0] | b8[0][1] << 8 | b8[1][0] << 16 | b8[1][1] << 24;
      }
      // the stage's k16 steps kk: every shared-memory load first, then the conversions and masks, then the
      // MMAs, so the loads' latencies overlap.  A = (W ⊙ M)ᵀ, 16 columns ×
      // 16 k: a[ki][j] holds k = 16kk + 8(j / 2) + 2c + {0, 1} of A row
      // g + 8(j % 2); B = xᵀ, 16 k × 8 rows a tile, from the K-contiguous
      // x rows
      uint32_t a[KI][4], b[KI][MT][2];
      uint32_t codes[KI][2], keep[KI][2];   // int8: byte quads, see below
#pragma unroll
      for (int ki = 0; ki < KI; ++ki) {
        const int kk = ki;
        if (!INT8)
          ldsm_x4_trans(a[ki], sw128(w_addr, kk * 16 + (j8 >> 1) * 8 + r8,
                                     (nw >> 3) + (j8 & 1)));
        const int kc = kk * 2 + (j8 & 1);
#pragma unroll
        for (int t = 0; t < MT; t += 2) {
          if (t + 1 < MT) {
            uint32_t r[4];
            ldsm_x4(r, sw128(x_addr, 8 * (t + (j8 >> 1)) + r8, kc));
            b[ki][t][0] = r[0];
            b[ki][t][1] = r[1];
            b[ki][t + 1][0] = r[2];
            b[ki][t + 1][1] = r[3];
          } else {
            ldsm_x2(b[ki][t][0], b[ki][t][1], sw128(x_addr, 8 * t + r8, kc));
          }
        }
      }
      if (INT8) {
        // ldmatrix.trans of the codes as 16-bit pairs: matrix (ki, half)
        // is k 16kk + 8·half + 0..7 × the warp's 16 columns; lane gets the
        // bytes (2c, 2g), (2c, 2g + 1), (2c + 1, 2g), (2c + 1, 2g + 1).
        // A bool mask tile (same layout) comes the same way.
#pragma unroll
        for (int ki = 0; ki < KI; ki += 2) {
          const int kk = ki + (j8 >> 1);
          const int off = sw64(kk * 16 + (j8 & 1) * 8 + r8, nw);
          uint32_t r[4];
          ldsm_x4_trans(r, w_addr + off);
          codes[ki][0] = r[0];
          codes[ki][1] = r[1];
          codes[ki + 1][0] = r[2];
          codes[ki + 1][1] = r[3];
          if (MASK == BOOL_MASK) {
            ldsm_x4_trans(r, smem_u32(ms) + off);
            keep[ki][0] = r[0];
            keep[ki][1] = r[1];
            keep[ki + 1][0] = r[2];
            keep[ki + 1][1] = r[3];
          }
        }
      }
#pragma unroll
      for (int ki = 0; ki < KI; ++ki) {
        const int kk = ki;
        if (INT8) {
          // q → bf16 exactly: the byte q + 128 under the exponent of 2^23
          // is the float 2^23 + q + 128
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            uint32_t quad = codes[ki][half];
            if (MASK == BOOL_MASK) quad &= keep[ki][half] * 0xFFu;
            if (MASK == PACKED_MASK)
              quad &= ((quad_bits >> (2 * kk + half)) & 0x01010101u) * 0xFFu;
            quad ^= 0x80808080u;
            const float bias = 8388736.0f;   // 2^23 + 128
#pragma unroll
            for (int h = 0; h < 2; ++h)
              a[ki][2 * half + h] = pack_bf16(
                  __uint_as_float(__byte_perm(quad, 0x4B000000u, 0x7540 + h)) -
                      bias,
                  __uint_as_float(__byte_perm(quad, 0x4B000000u,
                                              0x7542 + h)) -
                      bias);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!INT8 && MASK == BOOL_MASK) {
            const int k = kk * 16 + (j >> 1) * 8 + 2 * c;
            const int n = nw + g + (j & 1) * 8;
            a[ki][j] &= (ms[sw64(k, n)] ? 0x0000FFFFu : 0u) |
                        (ms[sw64(k + 1, n)] ? 0xFFFF0000u : 0u);
          } else if (!INT8 && MASK == PACKED_MASK) {
            a[ki][j] &= ((pair[j & 1] >> (2 * kk + (j >> 1))) & 0x00010001u) *
                        0xFFFFu;
          }
        }
      }
#pragma unroll
      for (int ki = 0; ki < KI; ++ki)
#pragma unroll
        for (int t = 0; t < MT; ++t)
          mma(acc[t], a[ki], b[ki][t][0], b[ki][t][1]);
      __syncwarp();
      if (warp == 0 && lane == 0) TRACE(2, kt);
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  // the split-K sum, in block 0: once every block is past its main loop
  // (so block 0's ring is free), each other block's consumer threads send
  // their accumulators into block 0's ring through distributed shared
  // memory (thread u of block r at slot r - 1, u); after a second cluster
  // barrier block 0's thread u adds them to its own in rank order 1, 2, …,
  // scales (int8), rounds to bf16 once and stores its outputs.
  const int rank = splits > 1 ? static_cast<int>(cluster_rank()) : 0;
  float* recv = reinterpret_cast<float*>(smem);
  if (splits > 1) cluster_sync();
  if (tid == 0) TRACE(3, 1);
  if (rank > 0 && warp < CONSUMERS) {
    const uint32_t dst = smem_u32(
        recv + ((rank - 1) * CONSUMERS * 32 + tid) * (4 * MT));
#pragma unroll
    for (int t = 0; t < MT; ++t) st_cluster_v4(dst + 16 * t, 0, acc[t]);
  }
  if (splits > 1)
    cluster_sync();
  else
    __syncthreads();   // the scales
  if (tid == 0) TRACE(3, 2);
  if (rank == 0 && warp < CONSUMERS) {
    const int g = lane >> 2, c = lane & 3, nw = warp * 16;
    const int col0 = nw + (INT8 ? 2 * g : g), col1 = col0 + (INT8 ? 1 : 8);
    for (int r = 1; r < splits; ++r) {
      const float4* src = reinterpret_cast<const float4*>(
          recv + ((r - 1) * CONSUMERS * 32 + tid) * (4 * MT));
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const float4 v = src[t];
        acc[t][0] = __fadd_rn(acc[t][0], v.x);
        acc[t][1] = __fadd_rn(acc[t][1], v.y);
        acc[t][2] = __fadd_rn(acc[t][2], v.z);
        acc[t][3] = __fadd_rn(acc[t][3], v.w);
      }
    }
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = 8 * t + 2 * c + (i & 1), col = i < 2 ? col0 : col1;
        if (m >= M || n0 + col >= N) continue;
        const float v = INT8 ? __fmul_rn(acc[t][i], s_scale[col]) : acc[t][i];
        if constexpr (F32)
          reinterpret_cast<float*>(y)[static_cast<size_t>(m) * N + n0 + col] =
              v;
        else
          y[static_cast<size_t>(m) * N + n0 + col] = __float2bfloat16(v);
      }
  }
  if (tid == 0) TRACE(3, 3);
}

template <bool INT8, int MASK, int MT, bool F32>
int launch(const void* x, const void* w, const void* mask, int group,
           const float* scale, void* y, int M, int N, int K, int splits,
           int k_split, cudaStream_t st) {
  using C = Cfg<INT8, MASK, MT>;
  auto kernel = decode_kernel<INT8, MASK, MT, F32>;
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return static_cast<int>(bound);
  CUtensorMap tx, tw, tm;
  bool ok = encode_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K,
                      MT * 8, BK, CU_TENSOR_MAP_SWIZZLE_128B) &&
            (INT8 ? encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, K, N,
                              BK, BN, CU_TENSOR_MAP_SWIZZLE_64B)
                  : encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, K,
                              N, BK, BN, CU_TENSOR_MAP_SWIZZLE_128B));
  if (MASK == BOOL_MASK)
    ok = ok && encode_2d(&tm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, mask, K, N,
                         BK, BN, CU_TENSOR_MAP_SWIZZLE_64B);
  else if (MASK == PACKED_MASK)
    ok = ok && encode_2d(&tm, CU_TENSOR_MAP_DATA_TYPE_UINT32, 4, mask,
                         8 * ((K + group - 1) / group), N, 8, BN,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
  else
    tm = tw;   // unread
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + BN - 1) / BN);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, tx, tw, tm, scale,
                         static_cast<bf16*>(y), M, N, K, k_split, group);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// the x tiles a launch needs: 8·MT ≥ M rows
template <bool INT8, int MASK, bool F32 = false>
int by_rows(const void* x, const void* w, const void* mask, int group,
            const float* scale, void* y, int M, int N, int K, int splits,
            int k_split, cudaStream_t st) {
  if (M <= 8)
    return launch<INT8, MASK, 1, F32>(x, w, mask, group, scale, y, M, N, K,
                                      splits, k_split, st);
  if (M <= 16)
    return launch<INT8, MASK, 2, F32>(x, w, mask, group, scale, y, M, N, K,
                                      splits, k_split, st);
  if (M <= 24)
    return launch<INT8, MASK, 3, F32>(x, w, mask, group, scale, y, M, N, K,
                                      splits, k_split, st);
  if (M <= 32)
    return launch<INT8, MASK, 4, F32>(x, w, mask, group, scale, y, M, N, K,
                                      splits, k_split, st);
  return launch<INT8, MASK, 8, F32>(x, w, mask, group, scale, y, M, N, K,
                                    splits, k_split, st);
}

}  // namespace

// C entry point (bound with ctypes).  x (M, K) bf16; w (K, N) bf16
// (w_int8 = 0) or int8 codes (w_int8 = 1, with scale: N floats); mask_kind
// 0 none (int8 only; mask null), 1 bool bytes (K, N), 2 packed words
// (8·⌈K/group⌉, N), group 128 or 256; y (M, N) bf16.  `splits` blocks of
// `k_split` K rows (a multiple of 256) cover K, one cluster a column tile.
// Returns the launch's cudaError_t.
extern "C" int matmul_decode(const void* x, const void* w, int w_int8,
                             const void* mask, int mask_kind, int group,
                             const void* scale, void* y, int M, int N, int K,
                             int splits, int k_split, void* stream) {
  const bool bad =
      M < 1 || M > 64 || N < 1 || K < 1 || K % 8 != 0 || N % 16 != 0 ||
      splits < 1 || splits > MAX_SPLITS || k_split < 1 ||
      k_split % K_UNIT != 0 ||
      static_cast<long long>(splits) * k_split < K ||
      static_cast<long long>(splits - 1) * k_split >= K ||
      mask_kind < (w_int8 ? NO_MASK : BOOL_MASK) || mask_kind > PACKED_MASK ||
      (mask_kind == NO_MASK) != (mask == nullptr) ||
      (mask_kind == PACKED_MASK && group != 128 && group != 256) ||
      (w_int8 != 0) != (scale != nullptr) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(mask)) % 16 != 0;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (!w_int8)
    return mask_kind == BOOL_MASK
               ? by_rows<false, BOOL_MASK>(x, w, mask, group, sc, y, M, N, K,
                                           splits, k_split, st)
               : by_rows<false, PACKED_MASK>(x, w, mask, group, sc, y, M, N,
                                             K, splits, k_split, st);
  if (mask_kind == BOOL_MASK)
    return by_rows<true, BOOL_MASK>(x, w, mask, group, sc, y, M, N, K,
                                    splits, k_split, st);
  if (mask_kind == PACKED_MASK)
    return by_rows<true, PACKED_MASK>(x, w, mask, group, sc, y, M, N, K,
                                      splits, k_split, st);
  return by_rows<true, NO_MASK>(x, w, mask, group, sc, y, M, N, K, splits,
                                k_split, st);
}

// fp32 y, unrounded (a row-parallel shard's partial sums): bf16 x and w,
// a bool mask (K, N); otherwise as matmul_decode
extern "C" int matmul_decode_out32(const void* x, const void* w,
                                   const void* mask, void* y, int M, int N,
                                   int K, int splits, int k_split,
                                   void* stream) {
  const bool bad =
      M < 1 || M > 64 || N < 1 || K < 1 || K % 8 != 0 || N % 16 != 0 ||
      splits < 1 || splits > MAX_SPLITS || k_split < 1 ||
      k_split % K_UNIT != 0 ||
      static_cast<long long>(splits) * k_split < K ||
      static_cast<long long>(splits - 1) * k_split >= K || mask == nullptr ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(mask)) % 16 != 0;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  return by_rows<false, BOOL_MASK, true>(x, w, mask, 0, nullptr, y, M, N, K,
                                         splits, k_split,
                                         static_cast<cudaStream_t>(stream));
}

#ifdef DECODE_TRACE
extern "C" int decode_trace_read(void* dst) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(dst, dc_trace, sizeof(dc_trace)));
}
#endif
