// Flash-attention backward for Hopper (sm_90a), bf16: dq, dk, dv and the
// gradient of each bias that keeps the query and key dims, from one TMA +
// wgmma kernel per kv tile, with delta, the dq sum and a broadcast dbias's
// sum done by small passes.
//
// Replaces, on the bf16 route that ops/attention.py `plan` picks, the
// Pallas TPU kernels `_flash_dq_kernel` and `_flash_dkv_kernel`
// (vlm_compression_tpu/ops/attention.py:296 and :331, launched by
// `_flash_backward_pallas`), which flash_attention_bwd.cu ported as two
// mma.sync kernels (they stay: fp32, and the shapes this one does not
// take), and, for every bias of shape (1 | b, 1 | h, n, m) on that route
// (`plan_dbias`), `_flash_dbias_kernel` (:371), which
// flash_attention_bwd.cu ported as a kernel of its own (it stays for the
// other biases, fp32 and the mma.sync route).  The contract is theirs
// (flash_attention_bwd.cu:6-22):
//   s  = (q · kᵀ) * scale + Σ bias_i (fp32, the forward's order),
//   p  = exp(s − lse), u = p ⊙ (g · vᵀ − delta), ds = u · scale,
//   dq = ds · k;  dk = dsᵀ · q;  dv = pᵀ · g  (bf16 operands, fp32 sums);
//   dbias_i = u summed over the batch and head axes bias i broadcasts
//   (fp32);
// hidden entries of the right-aligned causal flag have u = ds = 0, and rows
// that see no key take the exact uniform p = 1/m in dv.  q/g (b, n, h, d)
// and k/v (b, m, h, d) are strided views with a contiguous last dim; the
// biases (at most two) are read at their broadcast shapes; dq, dk, dv are
// written contiguous in bf16, each dbias contiguous in fp32 at its bias's
// shape.
//
// Up to four kernels, launched in order on one stream by one C entry
// point:
//   1. `flash_bwd_delta_kernel`: delta = rowsum(g ⊙ out) in fp32, half a
//      warp a row, 16-byte loads; it copies lse beside it into a (b, h,
//      n_pad) layout whose q tiles are 256-byte aligned (n_pad = n rounded
//      up to 64).  Alone it also serves the mma.sync route and the dbias
//      kernel (any dtype, scalar loads where 16-byte ones do not fit).
//   2. `flash_bwd_wgmma_kernel`, one block per (kv tile of 64 rows, head,
//      batch), walking the q tiles once; two warpgroups:
//      * the producer (one thread): TMA loads (cp.async.bulk.tensor.4d,
//        64-byte swizzle, boxes of 64 rows × 32 columns) of the block's K
//        and V once, then of each q tile's Q and G into a ring of two
//        stages, with its lse and delta rows (cp.async.bulk), on `full`
//        mbarriers; a stage is refilled when the consumers free it
//        (`empty`).  TMA's out-of-bounds zero fill pads d to DP (88 → 96)
//        and blanks rows ≥ n or ≥ m, so nothing else handles an edge.
//      * the consumer warpgroup owns the block's 64 kv rows, dK and dV in
//        fp32 registers.  Per q tile: Sᵀ = K·Qᵀ and dPᵀ = V·Gᵀ (SS wgmma
//        m64n64k16 over DP); pᵀ = exp(Sᵀ·scale + biases − lse) and
//        uᵀ = pᵀ ⊙ (dPᵀ − delta) in the accumulator registers; uᵀ is each
//        asked-for dbias's tile (stored, below), and dSᵀ = uᵀ · scale;
//        cast to bf16 pᵀ and dSᵀ are the register A operands of
//        dV += Pᵀ·G and dK += dSᵀ·Q (RS wgmma m64nDPk16, G and Q
//        MN-major); dSᵀ is also stored in shared memory (128-byte
//        swizzle, two buffers) as the M-major A of dQ_tile = dS·K (SS
//        wgmma), whose fp32 result goes to the kv tile's own dq slab
//        (below).  The five products of the function, not the mma.sync
//        route's seven, and none more for dbias.  Only tiles on the ragged
//        edge or the causal diagonal test each element; fully hidden
//        tiles are skipped.
//      setmaxnreg moves registers from the producer to the consumers; two
//      blocks share an SM.
//      At DP = 128 (LLaMA's heads) one warpgroup cannot hold it all: dK and
//      dV are 128 fp32 registers a thread, Sᵀ and dPᵀ 64 more, and a
//      64 × 128 dQ tile 64 more, past the 255 a thread can have.  So the
//      block has a second consumer warpgroup, and the two split the
//      accumulators: the first keeps dK, Sᵀ and dPᵀ, loads the tile's
//      biases while its Sᵀ and dPᵀ products run (it has the registers
//      for them, so their latency hides under the products), stores Pᵀ
//      and dSᵀ into the step's buffers (128-byte swizzle, two of each)
//      and arrives on the step's `ds_full` mbarrier before its dK product;
//      the second keeps dV and a dQ tile, waits there, runs dV += Pᵀ·G
//      (SS wgmma, Pᵀ K-major) and dQ = dS·K (SS), frees the buffers and,
//      with the first warpgroup's four warps, the ring stage (`ds_empty`,
//      `empty`), and stores dQ into the kv tile's slab while the first
//      already works on the next q tile.  Still the five products, dq
//      still summed from one slab a kv tile in kv order, no atomics.  Both
//      consumers take 240 registers by setmaxnreg (the producer 24: three
//      warpgroups' 168 each at launch); with 130 KB of shared memory, one
//      block an SM.
//   3. `flash_bwd_dq_cast_kernel` (with dq): the slabs summed in kv order
//      and cast to bf16 into q's (b, n, h, d) layout.
//   4. `flash_bwd_dbias_sum_kernel` (for each dbias that broadcasts over
//      batch or heads): the (b, h) tiles summed in order into it.
//
// The sums across blocks run in one fixed order, and no block waits on
// another.  A q tile's dq sums the dQ tiles of every kv tile: each block
// stores its dQ tiles into an fp32 slab of its own, one slab a kv tile,
// and the cast adds the slabs 0, 1, … in kv order (the order in which the
// TPU kernel's sequential kv axis sums them), stopping at the first that
// the causal flag hid from the row's q tile (those are a suffix of the kv
// order).  A dbias that keeps the batch and the head, or has one block an
// output tile (b = 1 with the head kept), is stored directly; one that
// broadcasts over batch or heads is stored a (batch, head) slice each
// into a scratch (b, h, n, m), which the sum pass adds in batch order,
// then head.  A tile the causal flag hides writes its zeros there.  So two
// identical calls are bit-equal: no atomics, and no turn that a block
// could wait for on one not yet running.  A dbias tile is [kv][q] in the
// registers and [q][kv] in memory: 8 lanes write 8 consecutive kv columns
// of a row, so every 32-byte sector is written whole and no staging
// through shared memory is needed.
//
// What bounds it on the H100: the function's 10·b·h·n·m·d operations on
// the tensor cores against q, k, v, g, lse, delta (and the biases) read
// once and dq, dk, dv (and dbias) written once.  At the ViT's shape (b 32,
// n = m = 257, h 16, d 88) the bytes, 163 MB, 49 µs at 3.35 TB/s (the
// operations, 29.8 GFLOP, take 30 µs at 989 TFLOP/s).  This design moves
// more: the pre-pass reads g and out, the kernel reads Q and G once per kv
// tile (5 times at the ViT's shape, from L2) and writes 64 × DP fp32 a tile
// pair into the slabs (315 MB at the ViT's shape), which the cast reads
// back.  Its tiles pad the tensor work: 5 × 5 tiles of 64 cover 257 × 257
// and DP = 96 covers 88, so 41 % of it is padding at the ViT's shape.  What
// bounds the kernel in practice is the chain of each q step (products,
// elementwise, products, the dQ store) in one consumer warpgroup.  Two
// ordered designs measured slower: blocks adding into one workspace in
// turn on per-tile counters (each add a round trip to L2 on the step's
// critical path), and a thread-block cluster of the kv tiles that
// reduce-scattered each q tile's dQ through distributed shared memory in
// rank order (its blocks in lockstep every step): PERF.md §6 has their
// costs.  Compile with -DBWD_TRACE for a per-q-step clock64 timeline of
// block (0, 0, 0) (scripts/torch_bwd_trace.py).
//
// Preconditions (ops/attention.py `plan`): bf16; 32 < d ≤ 128, d % 8 == 0;
// 16-byte aligned q, k, v, g, out bases and (batch, seq, head) strides.

#include "hopper.cuh"

#include <math.h>

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int BQ = 64, BKV = 64, STAGES = 2;
constexpr int BOX = 32;                    // d columns a TMA box: 64 bytes
constexpr int BOX_BYTES = 64 * BOX * 2;    // a 64-row box, 4 KB
constexpr int DS_BYTES = BKV * BQ * 2;     // the bf16 dSᵀ tile, 8 KB
constexpr float LOG2E = 1.4426950408889634f;

// The block's warpgroups: the producer and one consumer (two blocks an
// SM), or at DP = 128 (SPLIT) the producer, the dK consumer and the dV /
// dQ one (one block an SM); the registers setmaxnreg gives the consumers
template <int DP>
struct Cfg {
  static_assert(DP == 64 || DP == 96 || DP == 128, "DP is 64, 96 or 128");
  static constexpr bool SPLIT = DP == 128;
  static constexpr int THREADS = SPLIT ? 384 : 256;
  static constexpr int MIN_BLOCKS = SPLIT ? 1 : 2;
  static constexpr int CONSUMER_REGS = SPLIT ? 240 : 232;
};

// K, V; two dSᵀ buffers (SPLIT: and two Pᵀ buffers); the ring's Q and G
// tiles; its lse and delta rows (130 KB at DP = 128)
template <int DP>
struct Smem {
  static constexpr int NB = DP / BOX;                     // boxes a tile
  static constexpr int TILE = NB * BOX_BYTES;             // 64 × DP bf16
  static constexpr int STAGE = 2 * TILE;                  // Q and G
  static constexpr int K_OFF = 0, V_OFF = TILE, DS_OFF = 2 * TILE;
  static constexpr int P_OFF = DS_OFF + 2 * DS_BYTES;
  static constexpr int RING_OFF = P_OFF + (Cfg<DP>::SPLIT ? 2 * DS_BYTES : 0);
  static constexpr int ROWS_OFF = RING_OFF + STAGES * STAGE;
  static constexpr int BYTES =
      ROWS_OFF + STAGES * 2 * BQ * 4 + 1024;   // + the alignment
};

struct Params {
  const float* lse;     // (b, h, NP) fp32, rows ≥ n zero
  const float* delta;   // (b, h, NP)
  float* dq_ws;         // (kv tiles, b, h, NP, DP) fp32: a slab a kv
                        // tile; null: no dq
  long long dq_slab;    // floats between kv tiles' slabs
  bf16* dk;             // (b, m, h, d); null: no dk/dv
  bf16* dv;
  const float* bias[2];
  long long bias_s[2][4];   // strides of (b, h, n, m), 0 on broadcast axes
  float* dbias[2];      // where block (b, h) stores its uᵀ tiles: the
                        // fp32 dbias (1 | b, 1 | h, n, m), or the (b, h,
                        // n, m) scratch the sum pass reduces; null: not
                        // asked for
  long long dbias_s[2][2];  // floats between its batches, heads (0 on an
                            // axis the stored dbias broadcasts)
  int B, N, M, H, D, NP;
  float scale;
  int causal;
};

// -DBWD_TRACE: block (0, 0, 0) records clock64 at six points of each q
// step (scripts/torch_bwd_trace.py reads them)
#ifdef BWD_TRACE
__device__ long long bwd_trace[6][64];
#define TRACE(e, it)                                                      \
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && (it) < 64) \
    bwd_trace[e][it] = clock64();
#else
#define TRACE(e, it)
#endif

// no row of the q tile sees a key of the kv tile, and each sees one
// elsewhere (so its p here is exactly 0): nothing to add (hidden entries
// have u = ds = 0).  For a q tile, the kv tiles it skips are those past its
// last visible column: a suffix of the kv order, kv tile 0 never among them
__device__ __forceinline__ bool skip_tile(const Params& p, int q0, int kv0) {
  const int off = p.M - p.N;
  return p.causal && q0 + off >= 0 && min(q0 + BQ - 1, p.N - 1) + off < kv0;
}

// the tile's uᵀ (ZERO: zeros, for a tile the causal flag hides) into
// block (b, h)'s dbias slice `out` at (q row, kv column)
template <bool ZERO>
__device__ __forceinline__ void dbias_tile(const Params& p, float* out,
                                           const float (&u)[32], int q0,
                                           int kv0, int r0, int lane) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = q0 + 8 * jj + 2 * (lane & 3) + (e & 1);
      const int j = kv0 + r0 + (e < 2 ? 0 : 8);
      if (i < p.N && j < p.M)
        out[static_cast<long long>(i) * p.M + j] = ZERO ? 0.f : u[4 * jj + e];
    }
}

// The biases' sum at a thread's 32 elements of the tile (scores' order),
// loaded while the tile's products run; edge tiles read at a clamped
// index, an entry the mask then overwrites.  Summed before the scores are
// added, as the forward sums them.
template <bool EDGE>
__device__ __forceinline__ void load_bias_t(const Params& p, float (&bv)[32],
                                            const float* b0, const float* b1,
                                            int q0, int kv0, int r0,
                                            int lane) {
  const long long s0i = p.bias_s[0][2], s0j = p.bias_s[0][3];
  const long long s1i = p.bias_s[1][2], s1j = p.bias_s[1][3];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = q0 + 8 * jj + 2 * (lane & 3) + (e & 1);
      const int j = kv0 + r0 + (e < 2 ? 0 : 8);
      const long long ii = EDGE ? min(i, p.N - 1) : i;
      const long long jc = EDGE ? min(j, p.M - 1) : j;
      float v = b0[ii * s0i + jc * s0j];
      if (b1 != nullptr) v += b1[ii * s1i + jc * s1j];
      bv[4 * jj + e] = v;
    }
}

// pᵀ and uᵀ (unscaled: dsᵀ = uᵀ · scale) of the tile in place of the Sᵀ
// and dPᵀ accumulators.  Element
// 4jj + e of a thread: kv row r0 (e < 2) or r0 + 8, q column
// 8jj + 2(lane % 4) + (e & 1).  EDGE: the tile crosses n, m or the causal
// diagonal, so each element is tested.  NBIAS (0, 1, 2) is a template
// argument so that the 32 elements unroll without a branch between them
// and their latencies overlap.  PRE: the biases' sum is preloaded in bv
// (``load_bias_t``; any NBIAS > 0), else read here.
template <bool EDGE, int NBIAS, bool PRE>
__device__ __forceinline__ void scores(const Params& p, float (&sc)[32],
                                       float (&dp)[32], const float* s_lse,
                                       const float* s_delta, const float* b0,
                                       const float* b1, const float* bv,
                                       int q0, int kv0, int r0, int lane) {
  const int N = p.N, M = p.M, off = M - N;
  const bool causal = p.causal;
  const float scale = p.scale;
  const long long s0i = p.bias_s[0][2], s0j = p.bias_s[0][3];
  const long long s1i = p.bias_s[1][2], s1j = p.bias_s[1][3];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int c = 8 * jj + 2 * (lane & 3);
    const float2 l2 = *reinterpret_cast<const float2*>(s_lse + c);
    const float2 d2 = *reinterpret_cast<const float2*>(s_delta + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * jj + e;
      const int i = q0 + c + (e & 1), j = kv0 + r0 + (e < 2 ? 0 : 8);
      const float lse_i = (e & 1) ? l2.y : l2.x;
      const float delta_i = (e & 1) ? d2.y : d2.x;
      float s = sc[x] * scale;
      if (PRE && NBIAS > 0) {
        s += bv[x];
      } else if (NBIAS > 0) {
        // edge tiles read the bias at a clamped index; the entry is
        // overwritten below
        const long long ii = EDGE ? min(i, N - 1) : i;
        const long long jc = EDGE ? min(j, M - 1) : j;
        s += b0[ii * s0i + jc * s0j];
        if (NBIAS > 1) s += b1[ii * s1i + jc * s1j];
      }
      float pv = exp2_approx((s - lse_i) * LOG2E);
      float u = pv * (dp[x] - delta_i);
      if (EDGE) {
        if (i >= N || j >= M) {
          pv = 0.f;
          u = 0.f;
        } else if (causal && j > i + off) {
          // exact p of a hidden entry: 1/m in a row that sees no key (its
          // lse, −1e9 + log m, rounds to −1e9 in fp32), else 0; u = 0
          pv = i + off < 0 ? 1.f / M : 0.f;
          u = 0.f;
        }
      }
      sc[x] = pv;
      dp[x] = u;
    }
  }
}

// A q tile's dQ into this kv tile's own slab (the cast sums them in
// order); valid rows and columns only
template <int DP>
__device__ __forceinline__ void store_dq(const Params& p,
                                         const float (&dq)[DP / 2], int j_kv,
                                         long long row0, int q0, int r0,
                                         int lane) {
  float2* wrow = reinterpret_cast<float2*>(p.dq_ws + j_kv * p.dq_slab +
                                           (row0 + q0) * DP);
#pragma unroll
  for (int jj = 0; jj < DP / 8; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int col = 8 * jj + 2 * (lane & 3), r = r0 + 8 * hh;
      if (col < p.D && q0 + r < p.N)
        wrow[(r * DP + col) / 2] =
            make_float2(dq[4 * jj + 2 * hh], dq[4 * jj + 2 * hh + 1]);
    }
}

// dK or dV (fp32 in the consumer's registers) into its contiguous (b, m,
// h, d) bf16 output; valid rows and columns only
template <int DP>
__device__ __forceinline__ void store_kv(const Params& p, bf16* dst,
                                         const float (&acc)[DP / 2], int b,
                                         int h, int kv0, int r0, int lane) {
#pragma unroll
  for (int jj = 0; jj < DP / 8; ++jj) {
    const int col = 8 * jj + 2 * (lane & 3);
    if (col >= p.D) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = kv0 + r0 + 8 * hh;
      if (j >= p.M) continue;
      const long long o =
          ((static_cast<long long>(b) * p.M + j) * p.H + h) * p.D + col;
      *reinterpret_cast<__nv_bfloat162*>(dst + o) = __floats2bfloat162_rn(
          acc[4 * jj + 2 * hh], acc[4 * jj + 2 * hh + 1]);
    }
  }
}

// a bf16 [kv row][q column] tile (the register A operand layout of a k16
// step over q, `a`) into shared memory: 128-byte rows, 128-byte swizzle
// (16-byte chunk ^= row % 8)
__device__ __forceinline__ void store_tile_t(uint8_t* tile,
                                             const uint32_t (&a)[4][4],
                                             int r0, int lane) {
#pragma unroll
  for (int kq = 0; kq < 4; ++kq)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + ((e & 1) ? 8 : 0), chunk = 2 * kq + (e >> 1);
      *reinterpret_cast<uint32_t*>(tile + r * 128 + ((chunk ^ (r & 7)) << 4) +
                                   (lane & 3) * 4) = a[kq][e];
    }
}

// DB: some dbias is asked for (the instantiations without it keep the
// registers of the uᵀ tile's stores out of the dq, dk/dv path)
template <int DP, bool DB>
__global__ void __launch_bounds__(Cfg<DP>::THREADS, Cfg<DP>::MIN_BLOCKS)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_g,
                       const __grid_constant__ Params p) {
  using S = Smem<DP>;
  constexpr int NB = S::NB, KS = DP / 16, ND = DP / 2;
  constexpr bool SPLIT = Cfg<DP>::SPLIT;
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], kv_full;
  // SPLIT: a step's Pᵀ and dSᵀ buffers written (every thread of the dK
  // consumer) and read out by the dV and dQ products (a lane of each warp
  // of the dV/dQ consumer)
  __shared__ __align__(8) uint64_t ds_full[2], ds_empty[2];
  // aligned by an offset from the shared array (not an integer round
  // trip), so that the compiler keeps shared loads and stores
  uint8_t* smem = dyn_smem + ((1024 - (smem_u32(dyn_smem) & 1023)) & 1023);
  uint8_t* ring = smem + S::RING_OFF;

  const int tid = threadIdx.x, t = tid & 127, warp_group = tid >> 7;
  const int kv0 = blockIdx.x * BKV, h = blockIdx.y, b = blockIdx.z;
  const int N = p.N, M = p.M, off = M - N;
  const int n_qt = (N + BQ - 1) / BQ;
  const long long row0 = (static_cast<long long>(b) * p.H + h) * p.NP;
  const int j_kv = blockIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      // every consumer warp (SPLIT: the dK consumer reads Q, the dV/dQ
      // one G)
      mbar_init(&empty[s], SPLIT ? 8 : 4);
    }
    mbar_init(&kv_full, 1);
    if (SPLIT)
      for (int s = 0; s < 2; ++s) {
        mbar_init(&ds_full[s], 128);
        mbar_init(&ds_empty[s], 4);
      }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp_group == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (t == 0) {
      mbar_expect_tx(&kv_full, 2 * S::TILE);
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        tma_load_4d(smem + S::K_OFF + c * BOX_BYTES, &tm_k, &kv_full,
                    c * BOX, kv0, h, b);
        tma_load_4d(smem + S::V_OFF + c * BOX_BYTES, &tm_v, &kv_full,
                    c * BOX, kv0, h, b);
      }
      int it = 0;
      for (int qt = 0; qt < n_qt; ++qt) {
        const int q0 = qt * BQ;
        if (skip_tile(p, q0, kv0)) continue;
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        uint8_t* st = ring + s * S::STAGE;
        uint8_t* rows = smem + S::ROWS_OFF + s * 2 * BQ * 4;
        mbar_expect_tx(&full[s], 2 * S::TILE + 2 * BQ * 4);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_load_4d(st + c * BOX_BYTES, &tm_q, &full[s], c * BOX, q0, h, b);
          tma_load_4d(st + S::TILE + c * BOX_BYTES, &tm_g, &full[s], c * BOX,
                      q0, h, b);
        }
        bulk_load(rows, p.lse + row0 + q0, BQ * 4, &full[s]);
        bulk_load(rows + BQ * 4, p.delta + row0 + q0, BQ * 4, &full[s]);
        TRACE(0, it);
        ++it;
      }
    }
  } else if (SPLIT && warp_group == 2) {
    // ------------------------------------- dV and dQ consumer (DP = 128)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int warp = t >> 5, lane = t & 31;
    const int r0 = warp * 16 + (lane >> 2);
    const bool need_dkv = p.dk != nullptr, need_dq = p.dq_ws != nullptr;
    const uint32_t k_a = smem_u32(smem + S::K_OFF);
    float dv[ND];
#pragma unroll
    for (int x = 0; x < ND; ++x) dv[x] = 0.f;
    mbar_wait(&kv_full, 0);
    int it = 0;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      if (skip_tile(p, q0, kv0)) continue;
      const int s = it % STAGES, buf = it & 1;
      mbar_wait(&full[s], (it / STAGES) & 1);
      mbar_wait(&ds_full[buf], (it >> 1) & 1);
      const uint32_t g_a = smem_u32(ring + s * S::STAGE + S::TILE);
      const uint32_t p_a = smem_u32(smem + S::P_OFF + buf * DS_BYTES);
      const uint32_t ds_a = smem_u32(smem + S::DS_OFF + buf * DS_BYTES);
      float dq[ND];
#pragma unroll
      for (int x = 0; x < ND; ++x) dq[x] = 0.f;
      fence_acc(dq);
      fence_acc(dv);
      wgmma_fence();
      if (need_dkv) {
        // dV += Pᵀ·G: A = the Pᵀ tile K-major (128-byte rows of q, k16
        // steps 32 bytes apart, 8-row groups 1 KB apart), B = G MN-major
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_dp<DP, 0, 1>(dv, sw128_desc(p_a + kk * 32, 16, 1024),
                                sw64_desc(g_a + kk * 1024, BOX_BYTES, 512),
                                1);
      }
      if (need_dq) {
        // dQ = dS·K: A = the dSᵀ tile read M-major (128-byte rows, k16
        // steps 2 KB apart), B = K MN-major
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_dp<DP, 1, 1>(dq, sw128_desc(ds_a + kk * 2048, 8192, 1024),
                                sw64_desc(k_a + kk * 1024, BOX_BYTES, 512),
                                kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dq);
      fence_acc(dv);
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&empty[s]);
        mbar_arrive(&ds_empty[buf]);
      }
      if (need_dq) store_dq<DP>(p, dq, j_kv, row0, q0, r0, lane);
      ++it;
    }
    if (need_dkv) store_kv<DP>(p, p.dv, dv, b, h, kv0, r0, lane);
  } else {
    // ---------------------------- consumer (dK and dV; SPLIT: dK alone)
    if constexpr (SPLIT)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = t >> 5, lane = t & 31;
    const int r0 = warp * 16 + (lane >> 2);   // rows r0, r0 + 8 of a tile
    const float* b0 = p.bias[0] ? p.bias[0] + b * p.bias_s[0][0] +
                                      h * p.bias_s[0][1] : nullptr;
    const float* b1 = p.bias[1] ? p.bias[1] + b * p.bias_s[1][0] +
                                      h * p.bias_s[1][1] : nullptr;
    const bool need_dkv = p.dk != nullptr, need_dq = p.dq_ws != nullptr;
    // this block's slice of each asked-for dbias
    float* db[2];
#pragma unroll
    for (int k = 0; k < 2; ++k)
      db[k] = DB && p.dbias[k] ? p.dbias[k] + b * p.dbias_s[k][0] +
                                     h * p.dbias_s[k][1]
                               : nullptr;
    const uint32_t k_a = smem_u32(smem + S::K_OFF);
    const uint32_t v_a = smem_u32(smem + S::V_OFF);
    // (SPLIT: dV is the other consumer's; its array is never used and
    // takes no registers)
    float dk[ND], dv[SPLIT ? 1 : ND];
#pragma unroll
    for (int x = 0; x < ND; ++x) dk[x] = 0.f;
#pragma unroll
    for (int x = 0; x < (SPLIT ? 1 : ND); ++x) dv[x] = 0.f;

    mbar_wait(&kv_full, 0);
    int it = 0;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      if (skip_tile(p, q0, kv0)) {
        // hidden: its dbias tiles are zeros; its dq slab tile is never read
        if (DB) {
          float none[32];
#pragma unroll
          for (int k = 0; k < 2; ++k)
            if (db[k] != nullptr)
              dbias_tile<true>(p, db[k], none, q0, kv0, r0, lane);
        }
        continue;
      }
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      if (t == 0) TRACE(1, it);
      uint8_t* st = ring + s * S::STAGE;
      const uint32_t q_a = smem_u32(st), g_a = q_a + S::TILE;
      const float* s_lse = reinterpret_cast<const float*>(
          smem + S::ROWS_OFF + s * 2 * BQ * 4);
      const float* s_delta = s_lse + BQ;

      const bool edge = q0 + BQ > N || kv0 + BKV > M ||
                        (p.causal && kv0 + BKV - 1 > q0 + off);
      const int nbias = (b0 != nullptr) + (b1 != nullptr);

      // Sᵀ = K·Qᵀ and dPᵀ = V·Gᵀ: both operands K-major (64-byte rows of
      // 32 d columns; k16 steps 32 bytes apart inside a box, boxes 4 KB
      // apart; 8-row groups 512 bytes apart)
      float sc[32], dp[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) sc[x] = dp[x] = 0.f;
      fence_acc(sc);
      fence_acc(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t o = (kk >> 1) * BOX_BYTES + (kk & 1) * 32;
        wgmma_ss_n64<0, 0>(sc, sw64_desc(k_a + o, 16, 512),
                           sw64_desc(q_a + o, 16, 512), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t o = (kk >> 1) * BOX_BYTES + (kk & 1) * 32;
        wgmma_ss_n64<0, 0>(dp, sw64_desc(v_a + o, 16, 512),
                           sw64_desc(g_a + o, 16, 512), kk > 0);
      }
      wgmma_commit();
      // SPLIT: the tile's biases' sum loaded while the products run (this
      // warpgroup holds dK alone, so the 32 values fit beside them)
      float bv[SPLIT ? 32 : 1];
      if constexpr (SPLIT) {
        if (nbias > 0) {
          if (edge)
            load_bias_t<true>(p, bv, b0, b1, q0, kv0, r0, lane);
          else
            load_bias_t<false>(p, bv, b0, b1, q0, kv0, r0, lane);
        }
      }
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);
      if (t == 0) TRACE(2, it);

      // NB: nbias 1 and 2 read the same preloaded sum when SPLIT
#define SCORES(EDGE, NBIAS)                                              \
  scores<EDGE, NBIAS, SPLIT>(p, sc, dp, s_lse, s_delta, b0, b1, bv, q0, \
                             kv0, r0, lane)
      if (edge) {
        if (nbias == 0)
          SCORES(true, 0);
        else if (nbias == 1 || SPLIT)
          SCORES(true, 1);
        else
          SCORES(true, 2);
      } else {
        if (nbias == 0)
          SCORES(false, 0);
        else if (nbias == 1 || SPLIT)
          SCORES(false, 1);
        else
          SCORES(false, 2);
      }
#undef SCORES

      // bf16 A operands of the four k16 steps over the tile's q columns:
      // pᵀ and dSᵀ = uᵀ · scale
      const float scale = p.scale;
      uint32_t pa[4][4], sa[4][4];
#pragma unroll
      for (int kq = 0; kq < 4; ++kq)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pa[kq][e] = pack_bf16(sc[8 * kq + 2 * e], sc[8 * kq + 2 * e + 1]);
          sa[kq][e] = pack_bf16(dp[8 * kq + 2 * e] * scale,
                                dp[8 * kq + 2 * e + 1] * scale);
        }
      // uᵀ into each asked-for dbias
      if (DB) {
#pragma unroll
        for (int k = 0; k < 2; ++k)
          if (db[k] != nullptr)
            dbias_tile<false>(p, db[k], dp, q0, kv0, r0, lane);
      }
      // dSᵀ (SPLIT: and Pᵀ) [kv row][q column] into this step's buffers;
      // the buffers two steps back were last read by a dQ (dV) product
      // every warp has waited for before the barrier of the step in
      // between (SPLIT: that the other consumer has freed)
      uint8_t* ds = smem + S::DS_OFF + (it & 1) * DS_BYTES;
      if constexpr (SPLIT) {
        if (it >= 2) mbar_wait(&ds_empty[it & 1], ((it >> 1) - 1) & 1);
        if (need_dq) store_tile_t(ds, sa, r0, lane);
        if (need_dkv)
          store_tile_t(smem + S::P_OFF + (it & 1) * DS_BYTES, pa, r0, lane);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(&ds_full[it & 1]);
      } else {
        if (need_dq) {
          store_tile_t(ds, sa, r0, lane);
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        }
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
      }
      if (t == 0) TRACE(3, it);

      // (SPLIT: no dQ here)
      float dq[SPLIT ? 1 : ND];
#pragma unroll
      for (int x = 0; x < (SPLIT ? 1 : ND); ++x) dq[x] = 0.f;
      fence_acc(dq);
      fence_acc(dk);
      fence_acc(dv);
      wgmma_fence();
      if (need_dkv) {
        // dV += Pᵀ·G (not SPLIT) and dK += dSᵀ·Q: G and Q MN-major
        // (transpose bit), k16 steps 16 rows (1 KB) apart, 32-column
        // boxes 4 KB apart
        if constexpr (!SPLIT) {
#pragma unroll
          for (int kq = 0; kq < 4; ++kq)
            wgmma_rs_dp<DP>(dv, pa[kq],
                            sw64_desc(g_a + kq * 1024, BOX_BYTES, 512));
        }
#pragma unroll
        for (int kq = 0; kq < 4; ++kq)
          wgmma_rs_dp<DP>(dk, sa[kq],
                          sw64_desc(q_a + kq * 1024, BOX_BYTES, 512));
      }
      if constexpr (!SPLIT) {
        if (need_dq) {
          // dQ = dS·K: A = the dSᵀ tile read M-major (128-byte rows, k16
          // steps 2 KB apart), B = K MN-major
          const uint32_t ds_a = smem_u32(ds);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_dp<DP, 1, 1>(dq,
                                  sw128_desc(ds_a + kk * 2048, 8192, 1024),
                                  sw64_desc(k_a + kk * 1024, BOX_BYTES, 512),
                                  kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dq);
      fence_acc(dk);
      fence_acc(dv);
      fence_regs(pa[0]);
      fence_regs(pa[1]);
      fence_regs(pa[2]);
      fence_regs(pa[3]);
      fence_regs(sa[0]);
      fence_regs(sa[1]);
      fence_regs(sa[2]);
      fence_regs(sa[3]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (t == 0) TRACE(4, it);

      if constexpr (!SPLIT) {
        if (need_dq) store_dq<DP>(p, dq, j_kv, row0, q0, r0, lane);
      }
      if (t == 0) TRACE(5, it);
      ++it;
    }

    if (need_dkv) {
      store_kv<DP>(p, p.dk, dk, b, h, kv0, r0, lane);
      if constexpr (!SPLIT) store_kv<DP>(p, p.dv, dv, b, h, kv0, r0, lane);
    }
  }
}

// ------------------------------------------------------------ the passes

template <typename T>
__device__ __forceinline__ float dot8(const T* a, const T* b);

template <>
__device__ __forceinline__ float dot8<bf16>(const bf16* a, const bf16* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 u = __bfloat1622float2(xs[e]), v = __bfloat1622float2(ys[e]);
    s = fmaf(u.x, v.x, s);
    s = fmaf(u.y, v.y, s);
  }
  return s;
}

template <>
__device__ __forceinline__ float dot8<float>(const float* a, const float* b) {
  const float4 x0 = *reinterpret_cast<const float4*>(a);
  const float4 x1 = *reinterpret_cast<const float4*>(a + 4);
  const float4 y0 = *reinterpret_cast<const float4*>(b);
  const float4 y1 = *reinterpret_cast<const float4*>(b + 4);
  float s = x0.x * y0.x;
  s = fmaf(x0.y, y0.y, s);
  s = fmaf(x0.z, y0.z, s);
  s = fmaf(x0.w, y0.w, s);
  s = fmaf(x1.x, y1.x, s);
  s = fmaf(x1.y, y1.y, s);
  s = fmaf(x1.z, y1.z, s);
  return fmaf(x1.w, y1.w, s);
}

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

struct DeltaArgs {
  const void* g;
  const void* out;
  const float* lse;     // (b, h, n) contiguous
  float* delta;         // (b, h, pitch)
  float* lse_pad;       // (b, h, pitch) or null
  long long g_s[3], o_s[3];   // strides of (b, n, h)
  int B, N, H, D, pitch, vec;
};

// half a warp a row (b, h, i < pitch) of the padded layout: delta (0 for
// i ≥ n) and lse beside it
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const DeltaArgs a) {
  const long long row = blockIdx.x * 16ll + (threadIdx.x >> 4);
  const int lane = threadIdx.x & 15;
  const bool live = row < static_cast<long long>(a.B) * a.H * a.pitch;
  const int i = live ? static_cast<int>(row % a.pitch) : a.N;
  const long long bh = row / a.pitch;
  const int h = static_cast<int>(bh % a.H), b = static_cast<int>(bh / a.H);
  float sum = 0.f;
  if (i < a.N) {
    const T* g = static_cast<const T*>(a.g) + b * a.g_s[0] + i * a.g_s[1] +
                 h * a.g_s[2];
    const T* o = static_cast<const T*>(a.out) + b * a.o_s[0] +
                 i * a.o_s[1] + h * a.o_s[2];
    if (a.vec) {
      for (int c = lane * 8; c < a.D; c += 128) sum += dot8<T>(g + c, o + c);
    } else {
      for (int c = lane; c < a.D; c += 16)
        sum = fmaf(to_f32(g[c]), to_f32(o[c]), sum);
    }
  }
  // the half-warp's sum (xor below 16 stays in the half)
#pragma unroll
  for (int w = 8; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
  if (live && lane == 0) {
    a.delta[row] = sum;
    if (a.lse_pad) a.lse_pad[row] = i < a.N ? a.lse[bh * a.N + i] : 0.f;
  }
}

// dq (b, n, h, d) bf16 ← the sum of the kv tiles' slabs (each (b, h, np,
// dp), `slab` floats apart) 0, 1, … in that order, stopping at the first
// that skipped the row's q tile: 8 columns a thread
__global__ void __launch_bounds__(256)
flash_bwd_dq_cast_kernel(const float* __restrict__ ws, bf16* __restrict__ dq,
                         int B, int N, int M, int H, int D, int np, int dp,
                         long long slab, int causal) {
  const long long idx = blockIdx.x * 256ll + threadIdx.x;
  const int chunks = D / 8;
  if (idx >= static_cast<long long>(B) * N * H * chunks) return;
  const int c = static_cast<int>(idx % chunks);
  long long r = idx / chunks;
  const int h = static_cast<int>(r % H);
  r /= H;
  const int i = static_cast<int>(r % N), b = static_cast<int>(r / N);
  const float4* src = reinterpret_cast<const float4*>(
      ws + ((static_cast<long long>(b) * H + h) * np + i) * dp + c * 8);
  float4 x = src[0], y = src[1];
  // skip_tile's rule for the row's q tile: a kv tile past its last visible
  // column stored nothing (a suffix of the kv order)
  const int q0 = i / BQ * BQ, off = M - N;
  const int last = causal && q0 + off >= 0 ? min(q0 + BQ - 1, N - 1) + off
                                           : M - 1;
  for (int kv0 = BKV; kv0 < M && kv0 <= last; kv0 += BKV) {
    src += slab / 4;
    const float4 u = src[0], v = src[1];
    x.x += u.x;
    x.y += u.y;
    x.z += u.z;
    x.w += u.w;
    y.x += v.x;
    y.y += v.y;
    y.z += v.z;
    y.w += v.w;
  }
  uint4 v;
  v.x = pack_bf16(x.x, x.y);
  v.y = pack_bf16(x.z, x.w);
  v.z = pack_bf16(y.x, y.y);
  v.w = pack_bf16(y.z, y.w);
  reinterpret_cast<uint4*>(dq)[idx] = v;
}

// a dbias (1 | b, 1 | h, n, m) ← the scratch (b, h, n, m) of the main
// kernel's (b, h) slices, summed over the axes it broadcasts in batch
// order, then head (keep bit 0: it keeps the batch, bit 1: the head); one
// element a thread
__global__ void __launch_bounds__(256)
flash_bwd_dbias_sum_kernel(const float* __restrict__ ws,
                           float* __restrict__ dbias, int B, int H, int N,
                           int M, int keep) {
  const bool kb = keep & 1, kh = keep & 2;
  const long long nm = static_cast<long long>(N) * M;
  const int ob_n = kb ? B : 1, oh_n = kh ? H : 1;
  const long long idx = blockIdx.x * 256ll + threadIdx.x;
  if (idx >= ob_n * oh_n * nm) return;
  const long long ij = idx % nm, slice = idx / nm;
  const int oh = static_cast<int>(slice % oh_n);
  const int ob = static_cast<int>(slice / oh_n);
  float sum = 0.f;
  bool first = true;
  for (int b = kb ? ob : 0; b < (kb ? ob + 1 : B); ++b)
    for (int h = kh ? oh : 0; h < (kh ? oh + 1 : H); ++h) {
      const float x = ws[(static_cast<long long>(b) * H + h) * nm + ij];
      sum = first ? x : sum + x;
      first = false;
    }
  dbias[idx] = sum;
}

// ------------------------------------------------------------------ host

int launch_delta(int is_bf16, const DeltaArgs& a, cudaStream_t st) {
  const long long rows = static_cast<long long>(a.B) * a.H * a.pitch;
  const unsigned grid = static_cast<unsigned>((rows + 15) / 16);
  if (is_bf16)
    flash_bwd_delta_kernel<bf16><<<grid, 256, 0, st>>>(a);
  else
    flash_bwd_delta_kernel<float><<<grid, 256, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, bool DB>
int launch_main(const CUtensorMap* maps, const Params& p, cudaStream_t st) {
  using C = Cfg<DP>;
  constexpr int bytes = Smem<DP>::BYTES;
  // opt in to the shared memory and check the setmaxnreg budget once: the
  // producer's 24 registers and each consumer's
  static const cudaError_t ready = [] {
    const void* fn =
        reinterpret_cast<const void*>(flash_bwd_wgmma_kernel<DP, DB>);
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    return err != cudaSuccess
               ? err
               : check_setmaxnreg(fn, C::THREADS / 128, 0,
                                  24 + (C::THREADS / 128 - 1) *
                                           C::CONSUMER_REGS);
  }();
  if (ready != cudaSuccess) return static_cast<int>(ready);
  const dim3 grid((p.M + BKV - 1) / BKV, p.H, p.B);
  flash_bwd_wgmma_kernel<DP, DB><<<grid, C::THREADS, bytes, st>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dp(const CUtensorMap* maps, const Params& p, cudaStream_t st) {
  return p.dbias[0] != nullptr || p.dbias[1] != nullptr
             ? launch_main<DP, true>(maps, p, st)
             : launch_main<DP, false>(maps, p, st);
}

}  // namespace

// delta = rowsum(g ⊙ out) (fp32, (b, h, n) contiguous) for the mma.sync
// route and the dbias kernel.  strides: g (b, n, h), out (b, n, h); `vec`
// promises 16-byte aligned rows of 8 elements (bf16: d % 8 == 0; fp32: the
// same, 32-byte rows).  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_bwd_delta(int is_bf16, const void* g,
                                         const void* out, void* delta,
                                         const long long* strides, int B,
                                         int N, int H, int D, int vec,
                                         void* stream) {
  DeltaArgs a{g, out, nullptr, static_cast<float*>(delta), nullptr,
              {strides[0], strides[1], strides[2]},
              {strides[3], strides[4], strides[5]}, B, N, H, D, N, vec};
  return launch_delta(is_bf16, a, static_cast<cudaStream_t>(stream));
}

// The whole bf16 backward: the pre-pass, the main kernel, (with dq) the
// cast and (for each dbias summed over batch or heads) its sum.  strides
// holds 23 int64 values: q (b, n, h), k (b, m, h), v (b, m, h), bias0 (b,
// h, n, m), bias1 (b, h, n, m), g (b, n, h), out (b, n, h).  lse is the
// forward's contiguous (b, h, n) fp32.  Scratch from the caller: delta_pad
// and lse_pad (b, h, np) fp32 with np = n rounded up to 64, and dq_ws
// (kv tiles, b, h, np, dp) fp32 with dp = 64 (d ≤ 64), 96 (d ≤ 96) or 128
// (ops/attention.py `_head_pad`).  dq (b, n, h, d), dk and dv (b, m, h, d)
// are contiguous bf16; a null dq (with a null dq_ws) or null dk and dv
// skips that gradient.  dbias0 / dbias1, where not
// null, receive the gradient of bias0 / bias1, contiguous fp32 at the
// bias's shape (1 | b, 1 | h, n, m); dbias_keep bit 2k says that bias k
// keeps the batch, bit 2k + 1 the head.  A dbias that broadcasts over
// batch or heads (where b > 1 or h > 1) needs its scratch, dbias_ws0 /
// dbias_ws1, (b, h, n, m) fp32; the others take none.  Returns the first
// non-zero cudaError_t of the launches (cudaErrorInvalidValue for a shape,
// layout or scratch it does not take).
extern "C" int flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* g,
    const void* out, const void* lse, void* delta_pad, void* lse_pad,
    void* dq_ws, void* dq, void* dk, void* dv, const void* bias0,
    const void* bias1, const long long* strides, int B, int N, int M, int H,
    int D, float scale, int causal, void* dbias0, void* dbias1,
    void* dbias_ws0, void* dbias_ws1, int dbias_keep, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return static_cast<int>(bound);
  if (D <= 32 || D > 128 || D % 8 != 0 ||
      (dq == nullptr) != (dq_ws == nullptr)
      || (dk == nullptr) != (dv == nullptr)
      || (dbias0 != nullptr && bias0 == nullptr)
      || (dbias1 != nullptr && bias1 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int dp = D <= 64 ? 64 : D <= 96 ? 96 : 128;
  const int np = (N + BQ - 1) / BQ * BQ;
  CUtensorMap maps[4];
  if (!encode_4d(&maps[0], q, B, N, H, D, strides, BOX, 64) ||
      !encode_4d(&maps[1], k, B, M, H, D, strides + 3, BOX, 64) ||
      !encode_4d(&maps[2], v, B, M, H, D, strides + 6, BOX, 64) ||
      !encode_4d(&maps[3], g, B, N, H, D, strides + 17, BOX, 64))
    return static_cast<int>(cudaErrorInvalidValue);

  Params p;
  p.lse = static_cast<const float*>(lse_pad);
  p.delta = static_cast<const float*>(delta_pad);
  p.dq_ws = static_cast<float*>(dq_ws);
  p.dq_slab = static_cast<long long>(B) * H * np * dp;
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.bias[0] = static_cast<const float*>(bias0);
  p.bias[1] = static_cast<const float*>(bias1);
  for (int t = 0; t < 4; ++t) {
    p.bias_s[0][t] = strides[9 + t];
    p.bias_s[1][t] = strides[13 + t];
  }
  // where each dbias's (b, h) tiles go: the dbias itself where each of its
  // elements has one (b, h), else the scratch the sum pass reduces
  float* const dbias[2] = {static_cast<float*>(dbias0),
                           static_cast<float*>(dbias1)};
  float* const dbias_ws[2] = {static_cast<float*>(dbias_ws0),
                              static_cast<float*>(dbias_ws1)};
  const long long nm = static_cast<long long>(N) * M;
  for (int s = 0; s < 2; ++s) {
    const bool kb = (dbias_keep >> (2 * s)) & 1;
    const bool kh = (dbias_keep >> (2 * s)) & 2;
    const bool summed = (kb ? 1 : B) * (kh ? 1 : H) > 1;
    if (dbias[s] != nullptr && summed != (dbias_ws[s] != nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    p.dbias[s] = summed ? dbias_ws[s] : dbias[s];
    p.dbias_s[s][0] = summed ? H * nm : kb ? (kh ? H : 1) * nm : 0;
    p.dbias_s[s][1] = summed || kh ? nm : 0;
  }
  p.B = B;
  p.N = N;
  p.M = M;
  p.H = H;
  p.D = D;
  p.NP = np;
  p.scale = scale;
  p.causal = causal;

  DeltaArgs a{g, out, static_cast<const float*>(lse),
              static_cast<float*>(delta_pad), static_cast<float*>(lse_pad),
              {strides[17], strides[18], strides[19]},
              {strides[20], strides[21], strides[22]}, B, N, H, D, np, 1};
  int err = launch_delta(1, a, st);
  if (err != 0) return err;
  err = dp == 64   ? launch_dp<64>(maps, p, st)
        : dp == 96 ? launch_dp<96>(maps, p, st)
                   : launch_dp<128>(maps, p, st);
  if (err != 0) return err;

  if (dq != nullptr) {
    const long long n_chunks = static_cast<long long>(B) * N * H * (D / 8);
    flash_bwd_dq_cast_kernel<<<static_cast<unsigned>((n_chunks + 255) / 256),
                               256, 0, st>>>(
        static_cast<const float*>(dq_ws), static_cast<bf16*>(dq), B, N, M, H,
        D, np, dp, p.dq_slab, causal);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  for (int s = 0; s < 2; ++s) {
    if (dbias[s] == nullptr || dbias_ws[s] == nullptr) continue;
    const int keep = (dbias_keep >> (2 * s)) & 3;
    const long long n_out =
        ((keep & 1) ? B : 1) * static_cast<long long>((keep & 2) ? H : 1) * nm;
    flash_bwd_dbias_sum_kernel<<<static_cast<unsigned>((n_out + 255) / 256),
                                 256, 0, st>>>(dbias_ws[s], dbias[s], B, H, N,
                                               M, keep);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return 0;
}

#ifdef BWD_TRACE
extern "C" int bwd_trace_read(void* dst) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(dst, bwd_trace, sizeof(bwd_trace)));
}
#endif
