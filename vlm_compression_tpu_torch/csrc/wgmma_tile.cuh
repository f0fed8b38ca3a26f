// The Hopper main loop of the bf16 masked, packed-mask and sparse-LoRA
// matmuls (sm_90a): y = x @ ((W [+ s·A·B]) ⊙ mask), TMA + wgmma, with the
// mask (and the LoRA merge) applied to the W tile in shared memory.
//
// One block computes a BM × BN = 256 × 128 output tile over all of K, in K
// steps of BK = 64, through a ring of STAGES = 3 shared-memory stages
// (57 KB each).  Three warpgroups:
//   * WG0, the transform warpgroup.  Its thread 0 is also the producer: it
//     issues, per step, the TMA loads (cp.async.bulk.tensor, completion on
//     the stage's `full` mbarrier) of the x tile (256 × 64, 128-byte
//     swizzle), the raw W tile (64 × 128 as two 64 × 64 boxes, 128-byte
//     swizzle), the mask tile (uint8 64 × 128, or the (8, 128) 32-bit words
//     of ops/bitmask.py's layout for the step's G-row group) and, for
//     sparse-LoRA, the step's rows of A (a plain cp.async.bulk: A's rows are
//     4-16 bytes, below TMA's 16-byte stride).  Every thread of WG0
//     rewrites its 8 chunks of 8 columns of the stage's W tile in place:
//     zeroed where the mask is false (bool bytes or packed bits), or merged
//     as (W + s·Σ_r A[k,r]·B[r,n]) ⊙ M in fp32 — Σ_r fmaf in r order, then
//     __fadd_rn(w, __fmul_rn(s, d)), as the WMMA loop's merge_chunk — and
//     cast to bf16.  A thread owns one 8-column chunk for the whole K loop,
//     so its r × 8 B values stay in registers; 256 rows a tile halve the
//     merge's recompute against a 128-row tile.  It then fences the
//     generic-proxy writes for the async proxy (fence.proxy.async) and
//     arrives on the stage's `ready` mbarrier; thread 0 then refills the
//     stage that step k - 1 used once its consumers free it (`empty`).  The
//     masked or merged weight never exists in device memory, as on the TPU.
//   * WG1, WG2, the consumers: 128 rows each, two wgmma.mma_async
//     m64n128k16 per k16 (bf16 in, fp32 accumulators in registers; x
//     K-major, W MN-major through the descriptor's transpose bit).  Each
//     frees a stage as soon as its products on it are done.  So the
//     transform of step k + 1 runs on the CUDA cores while the tensor cores
//     work on step k.
// setmaxnreg moves registers from WG0 to the consumers.  The epilogue
// stages the tile in shared memory as bf16 and writes 16-byte rows, masking
// the ragged M/N edge; TMA's out-of-bounds zero fill covers the loads.
//
// What bounds it on the H100: the function, by operations (2MNK); this
// loop, by its ring: a K step's loads take longer to land than its
// wgmmas take to run, and the sparse-LoRA merge takes longer still, so
// the tensor cores idle part of each step (PERF.md §6).  Compile with
// -DWG_TRACE for a per-step clock64 timeline of block (0, 0)
// (scripts/torch_wgmma_trace.py).
//
// Preconditions (checked by the wrapper's dispatch, ops/masked_linear.py
// `plan`): bf16; K % 8 == 0 and N % 16 == 0 (TMA strides), 16-byte
// aligned x, W, mask (and A, B) bases; packed group 128 or 256 (a K step of
// 64 lies in one group); LoRA rank 2, 4 or 8.  No split-K: the loop runs
// where the output tiles fill the card.
//
// For the same x, W and mask the bool and packed kernels write the same
// bf16 W tile and issue the same wgmma sequence, so their outputs are
// bit-equal.

#pragma once

#include "hopper.cuh"   // the PTX helpers: mbarriers, TMA, wgmma
#include "tile_mma.cuh"

namespace wg {

using namespace hopper;

typedef __nv_bfloat16 bf16;
using tile::Mask8;
using tile::Pack8;

constexpr int BM = 256, BN = 128, BK = 64, STAGES = 3, THREADS = 384;
constexpr int X_BYTES = BM * BK * 2;          // 32 KB, 128-byte swizzle
constexpr int W_BOX_BYTES = BK * 64 * 2;      // one 64 × 64 W box, 8 KB
constexpr int W_BYTES = 2 * W_BOX_BYTES;
constexpr int MASK_BYTES = BK * BN;           // bool; packed words use 4 KB
constexpr int WORD_BYTES = 8 * BN * 4;
constexpr int A_BYTES = BK * 8 * 2;           // LoRA A rows, rank ≤ 8
constexpr int STAGE_BYTES = X_BYTES + W_BYTES + MASK_BYTES + A_BYTES;
constexpr int LDC = BN + 8;                   // epilogue staging row (272 B)
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;   // + alignment
static_assert(STAGE_BYTES % 1024 == 0, "stages must stay 1024-byte aligned");
static_assert(BM * LDC * 2 <= STAGES * STAGE_BYTES, "epilogue staging");

enum Kind { BOOL_MASK = 1, PACKED_MASK = 2 };

// -DWG_TRACE: block (0, 0) records clock64 at five points of each K step
// (scripts/torch_wgmma_trace.py reads them)
#ifdef WG_TRACE
__device__ long long wg_trace[6][1024];
#define TRACE(e, g)                                                  \
  if (blockIdx.x == 0 && blockIdx.y == 0 && (g) < 1024)              \
    wg_trace[e][g] = clock64();
#else
#define TRACE(e, g)
#endif

// one m64n128 accumulator (rows row0 + {0, 8} of each lane quad) into the
// epilogue's bf16 staging tile: lane l holds columns 8j + 2(l % 4) + {0, 1}
__device__ __forceinline__ void stage_acc(bf16* cs, const float (&acc)[64],
                                          int row0, int lane) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = j * 8 + (lane & 3) * 2;
    *reinterpret_cast<__nv_bfloat162*>(cs + row0 * LDC + col) =
        __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<__nv_bfloat162*>(cs + (row0 + 8) * LDC + col) =
        __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ------------------------------------------------------------- transform
// Thread t of WG0 owns column chunk c = t % 16 (columns 8c..8c+7 of the
// tile: W box c / 8, logical 16-byte chunk c % 8) and rows q + 8i, i < 8,
// q = t / 16.  Every row of the thread has row % 8 == q, so under the
// 128-byte swizzle (chunk ^= row % 8) its chunks sit at one fixed physical
// chunk, (c % 8) ^ q, of each 128-byte row, 1 KB apart.
template <int KIND, int R>
__device__ __forceinline__ void transform_stage(uint8_t* ws, const uint8_t* ms,
                                                const bf16* as, int k0,
                                                int group, int t,
                                                const float (&b)[R ? R : 1][8],
                                                float scale) {
  const int c = t & 15, q = t >> 4;
  uint8_t* wrow = ws + (c >> 3) * W_BOX_BYTES + q * 128 + (((c & 7) ^ q) << 4);
  if constexpr (R == 0) {
    // masking only: load all eight rows (and their mask), then mask and
    // store, so the shared-memory latencies overlap
    Pack8 p[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      p[i].u = *reinterpret_cast<const uint4*>(wrow + i * 1024);
    if (KIND == PACKED_MASK) {   // the stage's word row q, the chunk's columns
      const uint4* wp = reinterpret_cast<const uint4*>(ms + q * BN * 4 + c * 32);
      const uint4 lo = wp[0], hi = wp[1];
      const uint32_t wd[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
        tile::apply_bits(p[i], wd, tile::word_bit(k0 + q + 8 * i, group));
    } else {
      Mask8 m[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        m[i].u = *reinterpret_cast<const uint2*>(ms + (q + 8 * i) * BN + c * 8);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          p[i].w[j] &= (m[i].b[2 * j] ? 0x0000FFFFu : 0u) |
                       (m[i].b[2 * j + 1] ? 0xFFFF0000u : 0u);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<uint4*>(wrow + i * 1024) = p[i].u;
    return;
  }
  // the merge, a row at a time (its registers go to the B columns), on
  // bf16 pairs: one unpack and one rounding instruction per two weights,
  // each weight rounded as __float2bfloat16 would
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint4* wp = reinterpret_cast<uint4*>(wrow + i * 1024);
    Pack8 p;
    p.u = *wp;
    Mask8 m;
    m.u = *reinterpret_cast<const uint2*>(ms + (q + 8 * i) * BN + c * 8);
    float a[R ? R : 1];
    const __nv_bfloat162* ar =
        reinterpret_cast<const __nv_bfloat162*>(as + (q + 8 * i) * R);
#pragma unroll
    for (int rr = 0; rr < R; rr += 2) {
      const float2 f = __bfloat1622float2(ar[rr / 2]);
      a[rr] = f.x;
      a[rr + 1] = f.y;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        d0 = fmaf(a[rr], b[rr][2 * j], d0);
        d1 = fmaf(a[rr], b[rr][2 * j + 1], d1);
      }
      const float2 wv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p.w[j]));
      const float v0 = m.b[2 * j] ? __fadd_rn(wv.x, __fmul_rn(scale, d0)) : 0.f;
      const float v1 =
          m.b[2 * j + 1] ? __fadd_rn(wv.y, __fmul_rn(scale, d1)) : 0.f;
      const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
      p.w[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *wp = p.u;
  }
}

// -------------------------------------------------------------- the loop
// tm_x: x (M, K) bf16; tm_w: W (K, N) bf16; tm_m: the bool mask (K, N)
// uint8 or the packed words (8·⌈K/G⌉, N) uint32.  R = 0: no adapter;
// R = 2, 4, 8: sparse-LoRA with A (K, R) and B (R, N) bf16.  One block
// per output tile.
template <int KIND, int R>
__device__ __forceinline__ void mm_wgmma(const CUtensorMap* tm_x,
                                         const CUtensorMap* tm_w,
                                         const CUtensorMap* tm_m,
                                         const bf16* __restrict__ lora_a,
                                         const bf16* __restrict__ lora_b,
                                         float scale, bf16* __restrict__ y,
                                         int M, int N, int K, int group) {
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t full[STAGES], ready[STAGES], empty[STAGES];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(dyn_smem) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x, t = tid & 127, warp_group = tid >> 7;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_k = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], 128);      // every transform thread
      mbar_init(&empty[s], 8);        // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp_group == 0) {
    // ---------------------------------------------- producer + transform
    asm volatile("setmaxnreg.dec.sync.aligned.u32 152;\n" ::: "memory");
    auto issue = [&](int j) {
      const int s = j % STAGES, k0 = j * BK;
      uint8_t* st = smem + s * STAGE_BYTES;
      const uint32_t a_bytes = R ? min(BK, K - k0) * R * 2 : 0;
      mbar_expect_tx(&full[s], X_BYTES + W_BYTES +
                                   (KIND == PACKED_MASK ? WORD_BYTES
                                                        : MASK_BYTES) +
                                   a_bytes);
      tma_load(st, tm_x, &full[s], k0, m0);
      tma_load(st + X_BYTES, tm_w, &full[s], n0, k0);
      tma_load(st + X_BYTES + W_BOX_BYTES, tm_w, &full[s], n0 + 64, k0);
      tma_load(st + X_BYTES + W_BYTES, tm_m, &full[s], n0,
               KIND == PACKED_MASK ? 8 * (k0 / group) : k0);
      if (R)
        bulk_load(st + X_BYTES + W_BYTES + MASK_BYTES,
                  lora_a + static_cast<size_t>(k0) * R, a_bytes, &full[s]);
      TRACE(0, j);
    };
    if (t == 0)
      for (int j = 0; j < STAGES && j < n_k; ++j) issue(j);

    float b[R ? R : 1][8];   // the thread's 8 columns of B, for all of K
    if (R) {
      const int gn = n0 + (t & 15) * 8;
#pragma unroll
      for (int rr = 0; rr < (R ? R : 1); ++rr) {
        Pack8 p;
        p.u = gn < N ? *reinterpret_cast<const uint4*>(
                           lora_b + static_cast<size_t>(rr) * N + gn)
                     : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          b[rr][e] = __uint_as_float(static_cast<uint32_t>(p.h[e]) << 16);
      }
    }

    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % STAGES;
      uint8_t* st = smem + s * STAGE_BYTES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      if (t == 0) TRACE(1, kt);
      transform_stage<KIND, R>(st + X_BYTES, st + X_BYTES + W_BYTES,
                               reinterpret_cast<const bf16*>(
                                   st + X_BYTES + W_BYTES + MASK_BYTES),
                               kt * BK, group, t, b, scale);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(&ready[s]);
      if (t == 0) TRACE(2, kt);
      // refill the stage that step kt - 1 used, once its consumers are done
      const int j = kt + STAGES - 1;
      if (t == 0 && kt >= 1 && j < n_k) {
        mbar_wait(&empty[j % STAGES], ((j / STAGES) & 1) ^ 1);
        issue(j);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 176;\n" ::: "memory");
    const int g = warp_group - 1, warp = t >> 5, lane = t & 31;
    float acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;

    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % STAGES;
      const uint32_t par = (kt / STAGES) & 1;
      mbar_wait(&full[s], par);
      mbar_wait(&ready[s], par);
      if (tid == 128) TRACE(3, kt);
      const uint32_t xa = smem_u32(smem + s * STAGE_BYTES) + g * 128 * 128;
      const uint32_t wa = smem_u32(smem + s * STAGE_BYTES + X_BYTES);
      fence_acc(acc0);
      fence_acc(acc1);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // W: 16 rows further per k16; the two 64-column boxes 8 KB apart
        // (leading offset), 8-row groups 1 KB apart (stride offset)
        const uint64_t db = sw128_desc(wa + kk * 2048, W_BOX_BYTES, 1024);
        // x: 32 bytes further per k16 inside the swizzled 128-byte rows;
        // 8-row groups 1 KB apart; the second 64 rows 8 KB further
        wgmma_m64n128k16(acc0, sw128_desc(xa + kk * 32, 16, 1024), db);
        wgmma_m64n128k16(acc1, sw128_desc(xa + 8192 + kk * 32, 16, 1024), db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // free the stage as soon as its products are done
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc0);
      fence_acc(acc1);
      if (tid == 128) TRACE(4, kt);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // epilogue: both consumer warpgroups are done with the ring; stage the
    // tile as bf16 (row stride LDC), then 16-byte stores of whole rows
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    bf16* cs = reinterpret_cast<bf16*>(smem);
    const int row = g * 128 + warp * 16 + (lane >> 2);
    stage_acc(cs, acc0, row, lane);
    stage_acc(cs, acc1, row + 64, lane);
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    const int u = tid - 128;
#pragma unroll 4
    for (int it = 0; it < BM * BN / 8 / 256; ++it) {
      const int id = u + it * 256, r = id >> 4, ch = id & 15;
      const int gm = m0 + r, gn = n0 + ch * 8;
      if (gm < M && gn < N)   // N % 16 == 0: a chunk is all in or all out
        *reinterpret_cast<uint4*>(y + static_cast<size_t>(gm) * N + gn) =
            *reinterpret_cast<const uint4*>(cs + r * LDC + ch * 8);
    }
    if (tid == 128) TRACE(5, n_k - 1);
  }
}

// ------------------------------------------------------------------ host
// encode the maps and launch `kernel` (a __global__ wrapping mm_wgmma<KIND,
// R> with the same arguments) over (N/BN, M/BM); returns a cudaError_t.
// The shared-memory opt-in is set once per kernel.
template <int KIND, auto kernel>
int launch_wgmma(const void* x, const void* w, const void* mask, int group,
                 const void* lora_a, const void* lora_b, float scale, void* y,
                 int M, int N, int K, cudaStream_t st) {
  if (K % 8 != 0 || N % 16 != 0 ||
      (KIND == PACKED_MASK && group != 128 && group != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return static_cast<int>(bound);
  CUtensorMap tx, tw, tm;
  const bool ok =
      encode_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, BM, BK,
                CU_TENSOR_MAP_SWIZZLE_128B) &&
      encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, K, N, BK, 64,
                CU_TENSOR_MAP_SWIZZLE_128B) &&
      (KIND == PACKED_MASK
           ? encode_2d(&tm, CU_TENSOR_MAP_DATA_TYPE_UINT32, 4, mask,
                       8 * ((K + group - 1) / group), N, 8, BN,
                       CU_TENSOR_MAP_SWIZZLE_NONE)
           : encode_2d(&tm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, mask, K, N, BK,
                       BN, CU_TENSOR_MAP_SWIZZLE_NONE));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
      tx, tw, tm, static_cast<const bf16*>(lora_a),
      static_cast<const bf16*>(lora_b), scale, static_cast<bf16*>(y), M, N, K,
      group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg
