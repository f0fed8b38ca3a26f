// The Hopper main loop of the masked, packed-mask, sparse-LoRA and int8
// matmuls (sm_90a), bf16 x and y (or, F32, an fp32 y: the unrounded sums
// of a row-parallel shard, rounded once after the sum over ranks):
//   bf16 W      y = x @ ((W [+ s·A·B]) ⊙ mask)
//   int8 codes  y = (x @ (q ⊙ mask)) · scale      (no, bool or packed mask)
// TMA + wgmma, with the mask (the LoRA merge, the codes' conversion)
// applied to the W tile in shared memory.
//
// One block computes a BM × BN = 256 × 128 output tile over its split of
// K (all of K, or k_split rows of it), in K steps of BK = 64, through a
// ring of STAGES = 3 shared-memory stages (57 KB each; 65 KB with the
// int8 codes' staging area).  Three warpgroups:
//   * WG0, the transform warpgroup.  Its thread 0 is also the producer: it
//     issues, per step, the TMA loads (cp.async.bulk.tensor, completion on
//     the stage's `full` mbarrier) of the x tile (256 × 64, 128-byte
//     swizzle), the raw W tile (64 × 128 as two 64 × 64 boxes, 128-byte
//     swizzle) or the int8 code tile (64 × 128 bytes, 8 KB, unswizzled,
//     into a staging area of its own: codes cannot widen in place), the
//     mask tile (uint8 64 × 128, or the (8, 128) 32-bit words of
//     ops/bitmask.py's layout for the step's G-row group) and, for
//     sparse-LoRA, the step's rows of A (a plain cp.async.bulk: A's rows are
//     4-16 bytes, below TMA's 16-byte stride).  Every thread of WG0
//     rewrites its 8 chunks of 8 columns of the stage's W tile in place:
//     zeroed where the mask is false (bool bytes or packed bits), or merged
//     as (W + s·Σ_r A[k,r]·B[r,n]) ⊙ M in fp32 — Σ_r fmaf in r order, then
//     __fadd_rn(w, __fmul_rn(s, d)), as the WMMA loop's merge_chunk — and
//     cast to bf16; or, for int8, it masks the codes' bytes and writes them
//     as bf16 into the same swizzled W layout (exact: each byte q + 128
//     under the exponent of 2^23 is the float 2^23 + q + 128, less
//     2^23 + 128; the decode kernel's conversion).  A thread owns one
//     8-column chunk for the whole K loop, so its r × 8 B values stay in
//     registers; 256 rows a tile halve the merge's recompute against a
//     128-row tile.  It then fences the generic-proxy writes for the async
//     proxy (fence.proxy.async) and arrives on the stage's `ready`
//     mbarrier; thread 0 then refills the stage that step k - 1 used once
//     its consumers free it (`empty`).  The masked, merged or dequantized
//     weight never exists in device memory, as on the TPU.
//   * WG1, WG2, the consumers: 128 rows each, two wgmma.mma_async
//     m64n128k16 per k16 (bf16 in, fp32 accumulators in registers; x
//     K-major, W MN-major through the descriptor's transpose bit).  Each
//     frees a stage as soon as its products on it are done.  So the
//     transform of step k + 1 runs on the CUDA cores while the tensor cores
//     work on step k.
// setmaxnreg moves registers from WG0 to the consumers.
//
// Split-K (where the output tiles do not fill the card; ops/masked_linear.py
// `plan_wgmma` picks the splits): the `splits` blocks of one output tile
// are one thread-block cluster (gridDim.x = splits ≤ 8), block r over K
// rows [r·k_split, (r + 1)·k_split), k_split a multiple of 256 (the larger
// pack group, so no split straddles a group's words).  Their sum is a
// reduce-scatter over distributed shared memory: the tile's 16 units of 16
// rows (one consumer warp's rows of one accumulator) are owned by the
// cluster's blocks in turn (unit u by rank u % splits).  After a cluster
// barrier (every ring is spent), each block sends the fp32 accumulators of
// the units it does not own into their owners' rings (st.shared::cluster,
// landing slot by source rank); after a second barrier each owner adds the
// others' partials to its own in rank order, scales (int8: the fp32 sum
// times scale[n], as quant.py, never a partial), rounds to bf16 once and
// stores its units' rows.  One launch, no workspace, no atomics: the same
// inputs give the same bits, and every mask kind of a weight form sums the
// same products in the same order.
//
// The epilogue stages the tile (or the block's units of it) in shared
// memory as bf16 and writes 16-byte rows, masking the ragged M/N edge;
// TMA's out-of-bounds zero fill covers the loads.
//
// What bounds it on the H100: the function, by operations (2MNK) at every
// shape it runs but the smallest prefill ones; this loop, by its ring: a
// K step's loads take longer to land than its wgmmas take to run, and the
// sparse-LoRA merge takes longer still, so the tensor cores idle part of
// each step (PERF.md §6).  Compile with -DWG_TRACE for a per-step clock64
// timeline of block (0, 0, 0) (scripts/torch_wgmma_trace.py).
//
// Preconditions (checked by the launch below and by the wrapper's
// dispatch, ops/masked_linear.py `plan`): bf16 x; K % 8 == 0 and
// N % 16 == 0 (TMA strides), 16-byte aligned x, W (codes), mask (and A,
// B) bases; packed group 128 or 256 (a K step of 64 lies in one group);
// LoRA rank 2, 4 or 8.
//
// For the same x, W and mask the bool and packed kernels write the same
// bf16 W tile and issue the same wgmma sequence, so their outputs are
// bit-equal; so are int8 with a mask and int8 without one on codes zeroed
// off it (a masked byte and a zero code both become +0).

#pragma once

#include "hopper.cuh"   // the PTX helpers: mbarriers, TMA, wgmma, clusters
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
constexpr int CODE_BYTES = BK * BN;           // int8 codes, staged
constexpr int MASK_OFF = X_BYTES + W_BYTES;
constexpr int A_OFF = MASK_OFF + MASK_BYTES;
constexpr int CODE_OFF = A_OFF + A_BYTES;
// a stage of the bf16 kinds, and of int8 (its codes' staging area after)
__host__ __device__ constexpr int stage_bytes(bool int8) {
  return int8 ? CODE_OFF + CODE_BYTES : CODE_OFF;
}
constexpr int STAGE_BYTES = stage_bytes(false);
constexpr int LDC = BN + 8;                   // epilogue staging row (272 B)
constexpr int LDC32 = BN + 4;                 // the fp32 staging row (528 B)
__host__ __device__ constexpr int smem_bytes(bool int8) {
  return STAGES * stage_bytes(int8) + 1024;   // + alignment
}
// split-K: the most splits (a portable cluster), the unit of their
// boundaries (the larger pack group), the tile's 16-row units and one
// unit's fp32 partial
constexpr int MAX_SPLITS = 8, K_UNIT = 256;
constexpr int UNITS = BM / 16, UNIT_BYTES = 16 * BN * 4;
static_assert(stage_bytes(false) % 1024 == 0 && stage_bytes(true) % 1024 == 0,
              "stages must stay 1024-byte aligned");
static_assert(CODE_OFF % 128 == 0, "TMA destinations 128-byte aligned");
static_assert(BM * LDC * 2 <= STAGES * STAGE_BYTES, "epilogue staging");
static_assert(BM * LDC32 * 4 <= STAGES * STAGE_BYTES, "fp32 staging");
// the landing slots of the split-K sum, over the spent ring: `splits`
// source slots of ⌈UNITS / splits⌉ units each, most at 7 splits (21 units)
static_assert(7 * 3 * UNIT_BYTES <= STAGES * STAGE_BYTES, "landing slots");
static_assert(smem_bytes(true) <= 227 * 1024, "the shared-memory opt-in");

enum Kind { NO_MASK = 0, BOOL_MASK = 1, PACKED_MASK = 2 };

// -DWG_TRACE: block (0, 0, 0) records clock64 at five points of each K step
// (rows 0-4) and at its fixed points (row 5: start, the consumers' loop
// end, past each cluster barrier, the sum done, the stores done);
// scripts/torch_wgmma_trace.py reads them
#ifdef WG_TRACE
__device__ long long wg_trace[6][1024];
#define TRACE(e, g)                                                  \
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&       \
      (g) < 1024)                                                    \
    wg_trace[e][g] = clock64();
#else
#define TRACE(e, g)
#endif

// one m64n128 accumulator (rows row0 + {0, 8} of each lane quad) into the
// epilogue's bf16 staging tile: lane l holds columns 8j + 2(l % 4) + {0, 1};
// int8 (SCALE): each column times its scale in fp32 before the rounding.
// F32: into the fp32 staging tile (row stride LDC32), unrounded
template <bool SCALE, bool F32 = false>
__device__ __forceinline__ void stage_acc(void* cs_, const float (&acc)[64],
                                          const float* sc, int row0,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = j * 8 + (lane & 3) * 2;
    float v[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]};
    if (SCALE) {
      v[0] = __fmul_rn(v[0], sc[col]);
      v[1] = __fmul_rn(v[1], sc[col + 1]);
      v[2] = __fmul_rn(v[2], sc[col]);
      v[3] = __fmul_rn(v[3], sc[col + 1]);
    }
    if constexpr (F32) {
      float* cs = static_cast<float*>(cs_);
      *reinterpret_cast<float2*>(cs + row0 * LDC32 + col) =
          make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(cs + (row0 + 8) * LDC32 + col) =
          make_float2(v[2], v[3]);
    } else {
      bf16* cs = static_cast<bf16*>(cs_);
      *reinterpret_cast<__nv_bfloat162*>(cs + row0 * LDC + col) =
          __floats2bfloat162_rn(v[0], v[1]);
      *reinterpret_cast<__nv_bfloat162*>(cs + (row0 + 8) * LDC + col) =
          __floats2bfloat162_rn(v[2], v[3]);
    }
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

// bytes b and b + 1 of u (each the code q + 128) as a bf16 pair: the float
// 2^23 + byte, less 2^23 + 128, is q exactly (|q| ≤ 128), and so is its bf16
__device__ __forceinline__ uint32_t code_pair(uint32_t u, int b) {
  const float bias = 8388736.0f;   // 2^23 + 128
  return pack_bf16(
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + b)) - bias,
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541 + b)) - bias);
}

// int8: the stage's codes (64 rows of 128 bytes) masked and converted into
// the bf16 W tile, in the thread's chunks as transform_stage's.  The mask
// acts on the code bytes: a bool byte b keeps its code through b · 0xFF; a
// packed mask's eight rows q + 8i of a column are its word's bits
// bit0 + i (the step lies in one group, k0 % 8 == 0), gathered per column
// into one byte.
template <int KIND>
__device__ __forceinline__ void convert_codes(uint8_t* ws, const uint8_t* cs,
                                              const uint8_t* ms, int k0,
                                              int group, int t) {
  const int c = t & 15, q = t >> 4;
  uint8_t* wrow = ws + (c >> 3) * W_BOX_BYTES + q * 128 + (((c & 7) ^ q) << 4);
  uint2 code[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    code[i] = *reinterpret_cast<const uint2*>(cs + (q + 8 * i) * BN + c * 8);
  if (KIND == BOOL_MASK) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint2 m =
          *reinterpret_cast<const uint2*>(ms + (q + 8 * i) * BN + c * 8);
      code[i].x &= m.x * 0xFFu;
      code[i].y &= m.y * 0xFFu;
    }
  }
  if (KIND == PACKED_MASK) {
    const uint4* wp = reinterpret_cast<const uint4*>(ms + q * BN * 4 + c * 32);
    const uint4 lo = wp[0], hi = wp[1];
    const int bit = tile::word_bit(k0 + q, group);
    // byte e of kl (kh): the 8 rows' bits of column e (4 + e)
    const uint32_t kl = __byte_perm(
        __byte_perm(lo.x >> bit, lo.y >> bit, 0x0040),
        __byte_perm(lo.z >> bit, lo.w >> bit, 0x0040), 0x5410);
    const uint32_t kh = __byte_perm(
        __byte_perm(hi.x >> bit, hi.y >> bit, 0x0040),
        __byte_perm(hi.z >> bit, hi.w >> bit, 0x0040), 0x5410);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      code[i].x &= ((kl >> i) & 0x01010101u) * 0xFFu;
      code[i].y &= ((kh >> i) & 0x01010101u) * 0xFFu;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t u0 = code[i].x ^ 0x80808080u, u1 = code[i].y ^ 0x80808080u;
    Pack8 p;
    p.w[0] = code_pair(u0, 0);
    p.w[1] = code_pair(u0, 2);
    p.w[2] = code_pair(u1, 0);
    p.w[3] = code_pair(u1, 2);
    *reinterpret_cast<uint4*>(wrow + i * 1024) = p.u;
  }
}

// ----------------------------------------------------------- split-K sum
// landing slot of (source rank, unit u) in the owner's ring, for `splits`
// blocks: ⌈UNITS / splits⌉ units a source
__device__ __forceinline__ int slot_offset(int src, int u, int splits) {
  return (src * ((UNITS + splits - 1) / splits) + u / splits) * UNIT_BYTES;
}

// a warp's unit u (its lane's 64 accumulators) into the owner's landing
// slot: lane l's four floats i at 512·i + 16·l, so each store instruction
// writes 512 contiguous bytes
__device__ __forceinline__ void send_unit(const float (&acc)[64],
                                          uint32_t base, int rank, int u,
                                          int splits, int lane) {
  const uint32_t dst = base + slot_offset(rank, u, splits) + lane * 16;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float v[4] = {acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                        acc[4 * i + 3]};
    st_cluster_v4(dst + i * 512, u % splits, v);
  }
}

// the owner adds the other ranks' partials of unit u to its own, in rank
// order
__device__ __forceinline__ void add_unit(float (&acc)[64], const uint8_t* smem,
                                         int rank, int u, int splits,
                                         int lane) {
  for (int s = 0; s < splits; ++s) {
    if (s == rank) continue;
    const float4* src = reinterpret_cast<const float4*>(
        smem + slot_offset(s, u, splits) + lane * 16);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float4 v = src[i * 32];
      acc[4 * i] = __fadd_rn(acc[4 * i], v.x);
      acc[4 * i + 1] = __fadd_rn(acc[4 * i + 1], v.y);
      acc[4 * i + 2] = __fadd_rn(acc[4 * i + 2], v.z);
      acc[4 * i + 3] = __fadd_rn(acc[4 * i + 3], v.w);
    }
  }
}

// -------------------------------------------------------------- the loop
// tm_x: x (M, K) bf16; tm_w: W (K, N) bf16, or the int8 codes (K, N)
// (INT8, with col_scale: N floats); tm_m: the bool mask (K, N) uint8 or the
// packed words (8·⌈K/G⌉, N) uint32 (unread for NO_MASK).  R = 0: no
// adapter; R = 2, 4, 8: sparse-LoRA with A (K, R) and B (R, N) bf16.  Grid
// (splits, N tiles, M tiles), one cluster of `splits` blocks a tile.  F32:
// `y` points at an fp32 (M, N) output, written unrounded.
template <int KIND, int R, bool INT8, bool F32 = false>
__device__ __forceinline__ void mm_wgmma(const CUtensorMap* tm_x,
                                         const CUtensorMap* tm_w,
                                         const CUtensorMap* tm_m,
                                         const bf16* __restrict__ lora_a,
                                         const bf16* __restrict__ lora_b,
                                         float scale,
                                         const float* __restrict__ col_scale,
                                         bf16* __restrict__ y, int M, int N,
                                         int K, int k_split, int group) {
  static_assert(!INT8 || R == 0, "no adapter on int8 codes");
  static_assert(!(INT8 && F32), "int8 codes write bf16");
  constexpr int STAGE = stage_bytes(INT8);
  static_assert(INT8 || KIND != NO_MASK, "bf16 W comes with a mask");
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t full[STAGES], ready[STAGES], empty[STAGES];
  __shared__ float s_scale[BN];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(dyn_smem) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x, t = tid & 127, warp_group = tid >> 7;
  const int splits = gridDim.x, rank = blockIdx.x;   // rank in the cluster
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * BM;
  const int k_begin = rank * k_split;
  const int n_k = (min(K, k_begin + k_split) - k_begin + BK - 1) / BK;

  if (tid == 0) {
    TRACE(5, 0);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], 128);      // every transform thread
      mbar_init(&empty[s], 8);        // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (INT8 && tid < BN) s_scale[tid] = n0 + tid < N ? col_scale[n0 + tid] : 0.f;
  __syncthreads();

  if (warp_group == 0) {
    // ---------------------------------------------- producer + transform
    asm volatile("setmaxnreg.dec.sync.aligned.u32 152;\n" ::: "memory");
    auto issue = [&](int j) {
      const int s = j % STAGES, k0 = k_begin + j * BK;
      uint8_t* st = smem + s * STAGE;
      const uint32_t a_bytes = R ? min(BK, K - k0) * R * 2 : 0;
      mbar_expect_tx(&full[s], X_BYTES + (INT8 ? CODE_BYTES : W_BYTES) +
                                   (KIND == PACKED_MASK ? WORD_BYTES
                                    : KIND == BOOL_MASK ? MASK_BYTES
                                                        : 0) +
                                   a_bytes);
      tma_load(st, tm_x, &full[s], k0, m0);
      if (INT8) {
        tma_load(st + CODE_OFF, tm_w, &full[s], n0, k0);
      } else {
        tma_load(st + X_BYTES, tm_w, &full[s], n0, k0);
        tma_load(st + X_BYTES + W_BOX_BYTES, tm_w, &full[s], n0 + 64, k0);
      }
      if (KIND != NO_MASK)
        tma_load(st + MASK_OFF, tm_m, &full[s], n0,
                 KIND == PACKED_MASK ? 8 * (k0 / group) : k0);
      if (R)
        bulk_load(st + A_OFF, lora_a + static_cast<size_t>(k0) * R, a_bytes,
                  &full[s]);
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
      uint8_t* st = smem + s * STAGE;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      if (t == 0) TRACE(1, kt);
      if constexpr (INT8)
        convert_codes<KIND>(st + X_BYTES, st + CODE_OFF, st + MASK_OFF,
                            k_begin + kt * BK, group, t);
      else
        transform_stage<KIND, R>(st + X_BYTES, st + MASK_OFF,
                                 reinterpret_cast<const bf16*>(st + A_OFF),
                                 k_begin + kt * BK, group, t, b, scale);
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
    if (splits > 1) {   // the consumers' two barriers of the split-K sum
      __syncwarp();
      cluster_sync();
      cluster_sync();
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
      const uint32_t xa = smem_u32(smem + s * STAGE) + g * 128 * 128;
      const uint32_t wa = smem_u32(smem + s * STAGE + X_BYTES);
      fence_acc(acc0);
      fence_acc(acc1);
      wgmma_fence();
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
      wgmma_commit();
      // free the stage as soon as its products are done
      wgmma_wait<0>();
      fence_acc(acc0);
      fence_acc(acc1);
      if (tid == 128) TRACE(4, kt);
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (tid == 128) TRACE(5, 1);

    // the tile's units of 16 rows: acc0's and acc1's of this warp; a unit
    // wholly past M is neither sent, summed nor stored
    const int u0 = g * 8 + warp, u1 = u0 + 4;
    const bool live0 = m0 + 16 * u0 < M, live1 = m0 + 16 * u1 < M;
    if (splits > 1) {
      __syncwarp();
      cluster_sync();   // every block of the cluster is past its main loop
      if (tid == 128) TRACE(5, 2);
      const uint32_t base = smem_u32(smem);
      if (live0 && u0 % splits != rank)
        send_unit(acc0, base, rank, u0, splits, lane);
      if (live1 && u1 % splits != rank)
        send_unit(acc1, base, rank, u1, splits, lane);
      cluster_sync();   // the partials have landed
      if (tid == 128) TRACE(5, 3);
      if (live0 && u0 % splits == rank)
        add_unit(acc0, smem, rank, u0, splits, lane);
      if (live1 && u1 % splits == rank)
        add_unit(acc1, smem, rank, u1, splits, lane);
      if (tid == 128) TRACE(5, 4);
    }

    // epilogue: both consumer warpgroups are done with the ring (and the
    // landing slots); stage the block's units as bf16 (row stride LDC; F32:
    // fp32, LDC32), then 16-byte stores of whole rows
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    const int row = g * 128 + warp * 16 + (lane >> 2);
    if (live0 && u0 % splits == rank)
      stage_acc<INT8, F32>(smem, acc0, s_scale, row, lane);
    if (live1 && u1 % splits == rank)
      stage_acc<INT8, F32>(smem, acc1, s_scale, row + 64, lane);
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    const int u = tid - 128;
    if constexpr (F32) {
      const float* cs = reinterpret_cast<const float*>(smem);
      float* yf = reinterpret_cast<float*>(y);
#pragma unroll 4
      for (int it = 0; it < BM * BN / 4 / 256; ++it) {
        const int id = u + it * 256, r = id >> 5, ch = id & 31;
        const int gm = m0 + r, gn = n0 + ch * 4;
        // N % 16 == 0: a chunk is all in or all out
        if (gm < M && gn < N && (splits == 1 || (r >> 4) % splits == rank))
          *reinterpret_cast<float4*>(yf + static_cast<size_t>(gm) * N + gn) =
              *reinterpret_cast<const float4*>(cs + r * LDC32 + ch * 4);
      }
    } else {
      const bf16* cs = reinterpret_cast<const bf16*>(smem);
#pragma unroll 4
      for (int it = 0; it < BM * BN / 8 / 256; ++it) {
        const int id = u + it * 256, r = id >> 4, ch = id & 15;
        const int gm = m0 + r, gn = n0 + ch * 8;
        // N % 16 == 0: a chunk is all in or all out
        if (gm < M && gn < N && (splits == 1 || (r >> 4) % splits == rank))
          *reinterpret_cast<uint4*>(y + static_cast<size_t>(gm) * N + gn) =
              *reinterpret_cast<const uint4*>(cs + r * LDC + ch * 8);
      }
    }
    if (tid == 128) TRACE(5, 5);
  }
}

// ------------------------------------------------------------------ host
// encode the maps and launch `kernel` (a __global__ wrapping
// mm_wgmma<KIND, R, INT8> with the same arguments) over (splits, N/BN,
// M/BM) in clusters of `splits`: `splits` blocks of `k_split` K rows cover
// K, each non-empty (one split: k_split ≥ K; more: k_split a multiple of
// K_UNIT, at most MAX_SPLITS).  Returns a cudaError_t.  The shared-memory
// opt-in is set once per kernel.
template <int KIND, bool INT8, auto kernel>
int launch_wgmma(const void* x, const void* w, const void* mask, int group,
                 const void* lora_a, const void* lora_b, float scale,
                 const float* col_scale, void* y, int M, int N, int K,
                 int splits, int k_split, cudaStream_t st) {
  if (M < 1 || N < 1 || K < 1 || K % 8 != 0 || N % 16 != 0 ||
      (KIND == PACKED_MASK && group != 128 && group != 256) || splits < 1 ||
      splits > MAX_SPLITS || k_split < 1 ||
      (splits > 1 && k_split % K_UNIT != 0) ||
      static_cast<long long>(splits) * k_split < K ||
      static_cast<long long>(splits - 1) * k_split >= K ||
      (KIND == NO_MASK) != (mask == nullptr) || INT8 != (col_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return static_cast<int>(bound);
  CUtensorMap tx, tw, tm;
  bool ok = encode_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, BM,
                      BK, CU_TENSOR_MAP_SWIZZLE_128B) &&
            (INT8 ? encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, K, N,
                              BK, BN, CU_TENSOR_MAP_SWIZZLE_NONE)
                  : encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, K,
                              N, BK, 64, CU_TENSOR_MAP_SWIZZLE_128B));
  if (KIND == PACKED_MASK)
    ok = ok && encode_2d(&tm, CU_TENSOR_MAP_DATA_TYPE_UINT32, 4, mask,
                         8 * ((K + group - 1) / group), N, 8, BN,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
  else if (KIND == BOOL_MASK)
    ok = ok && encode_2d(&tm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, mask, K, N,
                         BK, BN, CU_TENSOR_MAP_SWIZZLE_NONE);
  else
    tm = tw;   // unread
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(INT8));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + BN - 1) / BN, (M + BM - 1) / BM);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes(INT8);
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = splits > 1;   // one split: no cluster
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, tx, tw, tm, static_cast<const bf16*>(lora_a),
      static_cast<const bf16*>(lora_b), scale, col_scale,
      static_cast<bf16*>(y), M, N, K, k_split, group);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace wg
