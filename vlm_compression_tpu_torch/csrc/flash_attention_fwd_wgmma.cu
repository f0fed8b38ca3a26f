// Flash-attention forward for Hopper (sm_90a), bf16: one TMA + wgmma
// kernel, a block per (q tile, head, batch).
//
// Replaces, on the bf16 route that ops/attention.py `plan_forward` picks,
// the Pallas TPU kernel `_flash_kernel` (vlm_compression_tpu/ops/
// attention.py:107, launched by `_flash_attention_pallas` at :232), which
// flash_attention.cu ported on mma.sync (it stays: fp32, and the shapes
// this one does not take).  The contract is theirs
// (flash_attention.cu:6-14):
//   s   = (q · kᵀ) * scale + Σ bias_i          (fp32)
//   s   = NEG_INF where causal hides a key      (right-aligned: j ≤ i + m − n)
//   p   = softmax(s)                            (fp32, online)
//   out = p.astype(bf16) · v                    (fp32 sums)
//   lse = max + log(Σ exp(s − max))             (natural log, (b, h, n))
// q (b, n, h, d) and k/v (b, m, h, d) are strided views with a contiguous
// last dim (the ViT's fused-qkv slices need no copy); up to two fp32 biases
// are read at their broadcast shapes through four strides each (0 on
// size-1 axes); out is written contiguous (b, n, h, d).  A row that sees no
// key (causal with n > m, or every bias NEG_INF) takes the uniform average
// over the real m keys, as the plain version does: kv columns ≥ m are −inf,
// never NEG_INF.
//
// Design: warp-specialised and persistent: as many blocks as the SMs
// hold at once, each walking tiles of (64 · WGS query rows, head, batch),
// q tile fastest; WGS = 1 (two blocks an SM, a ring of two kv stages) or 3
// (one block an SM, three stages; bias-free calls) consumer warpgroups a
// block, the launcher's `wgs`:
//   * the producer (one thread of warpgroup 0): TMA loads
//     (cp.async.bulk.tensor.4d, 64-byte swizzle, boxes of 64 rows × 32
//     columns) of each tile's Q into one of two buffers, so that the next
//     tile's Q lands under this one, then of its kv tiles' K and V into the
//     ring, K and V on `full` mbarriers of their own so that the score
//     product starts before V lands; a Q buffer or stage is refilled when
//     every consumer warp has freed it (`q_empty`, `empty`).  TMA's zero
//     fill pads d to DP (88 → 96) and blanks rows ≥ n or ≥ m, so nothing
//     else handles an edge by address arithmetic (LLaMA's d = 128 fills
//     DP = 128 exactly; 104 and 120 pad to it).
//   * each consumer warpgroup owns 64 query rows of the tile and keeps
//     everything of them in registers: S = Q·Kᵀ by SS wgmma m64n64k16 over
//     DP (both K-major), with the tile's bias values loaded while it runs;
//     the online softmax in the accumulator registers (a row spans the
//     four lanes of a quad: max by two shuffles; exp as ex2.approx of
//     (s − max)·log2 e, so that scores near NEG_INF subtract exactly, or,
//     on inner tiles with no bias, of one FMA of the raw product; the row
//     sums kept per thread and reduced once at the end); P cast to bf16 in
//     registers is the register A operand of O += P·V by RS wgmma
//     m64nDPk16 (V MN-major), O rescaled between steps.  The bias count is
//     a template argument (no branch between a thread's elements), and
//     only tiles on the ragged kv edge or on the causal diagonal test each
//     element; a last tile of at most 16 keys runs as an m64n16 product and
//     one k16 step of P·V; tiles wholly above the diagonal are skipped when
//     every row of the warpgroup sees a key (the rule of
//     flash_attention.cu's `kv_limit`), so rows with no visible key keep
//     their uniform average.  The epilogue stages O / l in bf16 in the
//     warpgroup's O tile and writes it with one TMA store (rows ≥ n and
//     columns ≥ d clipped by the map), which runs on under the next tile.
//   setmaxnreg moves registers from the producer to the consumers.
//
// DP = 128 (LLaMA's heads): one consumer warpgroup a block always (three
// would need 144 KB of Q and O tiles beside a 96 KB ring, more than a
// block's 227 KB).  A consumer then holds O in 64 fp32 registers beside S
// (32), the biases' sum (32) and P in bf16 (16), under the 232 that
// setmaxnreg gives it.  Two blocks an SM still fit: two Q buffers, the O
// tile and two K + V stages are 112 KB a block, and the dynamic shared
// memory is aligned to the 64-byte swizzle's 512-byte period (not 1024),
// so a block asks for 112.5 KB, 2 × (112.5 KB + the 1 KB the card keeps a
// block) within the SM's 228 KB.  The launcher sizes the persistent grid
// from the occupancy the card reports for the instantiation, so a
// layout that fit one block an SM would still run, on half the blocks.
// At a decode step (n = 1: b · h tiles of one query row each, one or two
// kv tiles) each tile is a chain of latencies, Q and K landing, the S
// product, the softmax, the P·V product and the epilogue, which the
// second block on the SM and the Q tile loaded under the previous one
// overlap.
//
// What bounds it on the H100: the function's bytes.  At the ViT's
// calibration shape (b 128, n = m = 257, h 16, d 88) q, k, v, out and lse
// are 370 MB, 0.1112 ms at 3.35 TB/s; its 4·b·h·n·m·d operations, 95
// GFLOP, take 0.0962 ms at 989 TFLOP/s.  The two are close, so the kernel
// has to keep the tensor cores and the memory busy at once: the ring and
// the second Q buffer keep the next loads in flight while a warpgroup
// multiplies, and three warpgroups an SM overlap one's softmax with the
// others' products.  Padding costs tensor work: at the ViT's shape the
// warpgroups cover n = 257 as 320 rows (the third warpgroup of a tile's
// second block of 192 rows holds no row and only frees its stages), kv
// tiles cover m as 4 × 64 + 16 and DP = 96 covers 88, so 30 % of the
// products multiply padding.  What bounds it in practice is each
// warpgroup's serial chain per kv step (S product, softmax, P·V product;
// PERF.md §6 has the timeline).  Compile with -DFWD_TRACE for a per-kv-step
// clock64 timeline of block 0's first tiles (scripts/torch_fwd_trace.py).
//
// Preconditions (ops/attention.py `plan_forward`): bf16; 32 < d ≤ 128,
// d % 8 == 0 (three consumer warpgroups: d ≤ 96); 16-byte aligned q, k, v
// bases and (batch, seq, head) strides.

#include "hopper.cuh"

#include <math.h>

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int BQ = 64, BKV = 64;
constexpr int BOX = 32;                    // d columns a TMA box: 64 bytes
constexpr int BOX_BYTES = 64 * BOX * 2;    // a 64-row box, 4 KB
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF = -1e9f;    // the towers' additive-mask constant
constexpr float M_INIT = -1e30f;    // running-max start, as on the TPU
// every tile is laid out in the 64-byte swizzle, whose pattern repeats
// every 512 bytes: the shared tiles start on that period
constexpr int ALIGN = 512;

// two buffers of the consumer warpgroups' Q tiles (the next tile's load
// runs under this one), their O tiles (the epilogue's staging), and the
// ring's K and V stages (two with one consumer warpgroup, three with
// three: 185 KB at DP = 96; 112 KB at DP = 128, one warpgroup)
template <int DP, int WGS>
struct Smem {
  static_assert(WGS == 1 || DP <= 96, "three warpgroups hold d <= 96");
  static constexpr int STAGES = WGS == 1 ? 2 : 3;
  static constexpr int NB = DP / BOX;                     // boxes a tile
  static constexpr int TILE = NB * BOX_BYTES;             // 64 × DP bf16
  static constexpr int STAGE = 2 * TILE;                  // K and V
  static constexpr int Q_OFF = 0, O_OFF = 2 * WGS * TILE;
  static constexpr int RING_OFF = 3 * WGS * TILE;
  static constexpr int BYTES = RING_OFF + STAGES * STAGE + ALIGN;  // + the
                                                                   // alignment
};

struct Params {
  bf16* out;            // (b, n, h, d) contiguous
  float* lse;           // (b, h, n) contiguous
  const float* bias[2];
  long long bias_s[2][4];   // strides of (b, h, n, m), 0 on broadcast axes
  int B, N, M, H, D;
  float scale;
  int causal;
};

// -DFWD_TRACE: block 0 records clock64 at six points of each of the first
// eight kv steps of its first eight tiles (scripts/torch_fwd_trace.py
// reads them): 0, the producer's issue of the step's loads; in the first
// consumer warpgroup 1, K landed, 2, the S product done, 3, the softmax
// done and V landed, 4, the P·V product done; and 5 at steps 0, 1, 2: the
// tile's start, its Q tile landed, its epilogue issued
#ifdef FWD_TRACE
__device__ long long fwd_trace[8][6][8];
#define TRACE(lt, e, it)                                    \
  if (blockIdx.x == 0 && (lt) < 8 && (it) < 8)              \
    fwd_trace[lt][e][it] = clock64();
#else
#define TRACE(lt, e, it)
#endif

// last kv column (exclusive) that the rows [first, last] can see: with the
// causal flag, when every one of them sees key 0, nothing past the last
// row's diagonal; else all m (rows with no visible key average over all)
__device__ __forceinline__ int kv_limit(const Params& p, int first,
                                        int last) {
  const int off = p.M - p.N;
  if (p.causal && first + off >= 0) return min(p.M, last + off + 1);
  return p.M;
}

// One tile of the persistent walk: q tile fastest, then head, then batch
// (blocks that run together share the K and V of a few heads in L2)
struct Tile {
  int q0, h, b;
  int active;   // consumer warpgroups with a row < n
  int n_kv;     // kv tiles any of its rows sees
};

__device__ __forceinline__ Tile tile_at(const Params& p, int tile, int n_qt,
                                        int wgs) {
  Tile w;
  const int bh = tile / n_qt;
  w.q0 = (tile % n_qt) * BQ * wgs;
  w.h = bh % p.H;
  w.b = bh / p.H;
  w.active = min(wgs, (p.N - w.q0 + BQ - 1) / BQ);
  w.n_kv = (kv_limit(p, w.q0, min(w.q0 + BQ * wgs, p.N) - 1) + BKV - 1) /
           BKV;
  return w;
}

// The biases' sum at a thread's NT elements of a kv tile (32 of a 64-key
// tile, 8 of a 16-key one), loaded while the tile's S product runs.
// Element 4jj + e of a thread: query row i0 (e < 2) or i0 + 8, key
// kv0 + 8jj + 2(lane % 4) + (e & 1).  br0 / br1: the two biases' rows of
// i0 and i0 + 8 (rows ≥ n clamped to n − 1: their results are not
// stored); edge tiles read them at a clamped key, an entry that the mask
// then overwrites.  vec: both biases hold keys contiguously and the
// thread's rows are 8-byte aligned, so an inner tile reads key pairs as
// float2.
template <bool EDGE, int NBIAS, int NT>
__device__ __forceinline__ void load_bias(const Params& p, float (&bv)[32],
                                          const float* const* br0,
                                          const float* const* br1, int kv0,
                                          int lane, bool vec) {
  if (!EDGE && vec) {
#pragma unroll
    for (int x = 0; x < NT; x += 2) {
      const int j = kv0 + 8 * (x >> 2) + 2 * (lane & 3), hh = (x >> 1) & 1;
      float2 v = *reinterpret_cast<const float2*>(br0[hh] + j);
      if (NBIAS > 1) {
        const float2 w = *reinterpret_cast<const float2*>(br1[hh] + j);
        v.x += w.x;
        v.y += w.y;
      }
      bv[x] = v.x;
      bv[x + 1] = v.y;
    }
    return;
  }
  const long long s0j = p.bias_s[0][3], s1j = p.bias_s[1][3];
#pragma unroll
  for (int x = 0; x < NT; ++x) {
    const int j = kv0 + 8 * (x >> 2) + 2 * (lane & 3) + (x & 1);
    const int hh = (x >> 1) & 1;
    const long long jc = EDGE ? min(j, p.M - 1) : j;
    float v = br0[hh][jc * s0j];
    if (NBIAS > 1) v += br1[hh][jc * s1j];
    bv[x] = v;
  }
}

// One kv tile's online-softmax step in place of the S accumulators (the
// NT elements as in load_bias; bv their biases' sum).  EDGE: the tile
// crosses m or the causal diagonal, so each element is tested.  NBIAS (0,
// 1, 2) is a template argument so that the elements unroll without a
// branch between them.  FOLD (no bias, no edge, scale > 0): the max is
// taken over the raw products and scale · log2 e folds into one FMA before
// the exp (no score near NEG_INF can occur there).  On return sc holds
// p = exp(s − max) (fp32), m_run the rows' running max, l_run this
// thread's part of the rows' running sums, alpha the factor O is rescaled
// by.
template <bool EDGE, int NBIAS, bool FOLD, int NT>
__device__ __forceinline__ void softmax_tile(const Params& p, float (&sc)[32],
                                             const float (&bv)[32],
                                             float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&alpha)[2], int i0,
                                             int kv0, int lane) {
  const int M = p.M, off = M - p.N;
  const float scale = p.scale;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int x = 0; x < NT; ++x) {
    const int hh = (x >> 1) & 1;
    if (!FOLD) {
      const int j = kv0 + 8 * (x >> 2) + 2 * (lane & 3) + (x & 1);
      float s = sc[x] * scale;
      if (NBIAS > 0) s += bv[x];
      if (EDGE) {
        if (j >= M)
          s = -INFINITY;    // past the last key: exp → 0
        else if (p.causal && j > i0 + 8 * hh + off)
          s = NEG_INF;
      }
      sc[x] = s;
    }
    mx[hh] = fmaxf(mx[hh], sc[x]);
  }
  float mlog[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    const float m_new = fmaxf(m_run[hh], FOLD ? mx[hh] * scale : mx[hh]);
    alpha[hh] = exp2_approx((m_run[hh] - m_new) * LOG2E);
    m_run[hh] = m_new;
    mlog[hh] = m_new * LOG2E;
  }
  const float c = scale * LOG2E;
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int x = 0; x < NT; ++x) {
    const int hh = (x >> 1) & 1;
    sc[x] = FOLD ? exp2_approx(fmaf(sc[x], c, -mlog[hh]))
                 : exp2_approx((sc[x] - m_run[hh]) * LOG2E);
    sum[hh] += sc[x];
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l_run[hh] = l_run[hh] * alpha[hh] + sum[hh];
}

// S = Q·Kᵀ over NT / 2 keys (64, or 16 for a tile's last few keys),
// issued and committed as one group: both operands K-major (64-byte rows
// of 32 d columns; k16 steps 32 bytes apart inside a box, boxes 4 KB
// apart; 8-row groups 512 bytes apart)
template <int KS, int NT>
__device__ __forceinline__ void scores_product(float (&sc)[32], uint32_t q_a,
                                               uint32_t k_a) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t o = (kk >> 1) * BOX_BYTES + (kk & 1) * 32;
    const uint64_t da = sw64_desc(q_a + o, 16, 512);
    const uint64_t db = sw64_desc(k_a + o, 16, 512);
    if constexpr (NT == 32)
      wgmma_ss_n64<0, 0>(sc, da, db, kk > 0);
    else
      wgmma_ss_n16<0, 0>(sc, da, db, kk > 0);
  }
  wgmma_commit();
}

// O += P·V over NT / 2 keys, issued and committed as one group: P the
// register A operand, V MN-major (transpose bit), k16 steps 16 rows (1 KB)
// apart, 32-column boxes 4 KB apart
template <int DP, int NT>
__device__ __forceinline__ void pv_product(float (&o)[DP / 2],
                                           const uint32_t (&pa)[4][4],
                                           uint32_t v_a) {
#pragma unroll
  for (int kq = 0; kq < NT / 8; ++kq)
    wgmma_rs_dp<DP>(o, pa[kq], sw64_desc(v_a + kq * 1024, BOX_BYTES, 512));
  wgmma_commit();
}

// P in bf16 as the A operands of the k16 steps over a tile's keys
template <int NT>
__device__ __forceinline__ void pack_p(const float (&sc)[32],
                                       uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kq = 0; kq < NT / 8; ++kq)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[kq][e] = pack_bf16(sc[8 * kq + 2 * e], sc[8 * kq + 2 * e + 1]);
}

// keep P's registers in place until the wgmma that reads them is done
__device__ __forceinline__ void fence_p(uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kq = 0; kq < 4; ++kq) fence_regs(pa[kq]);
}

// One kv tile of a consumer warpgroup: S = Q·Kᵀ, the biases loaded under
// it, the softmax step, O rescaled, then O += P·V once V has landed (V
// follows K in the stage).  NT: 32 (64 keys) or 8 (a last tile of at most
// 16 keys: an m64n16 product, one k16 step of P·V).
template <int DP, bool EDGE, int NBIAS, bool FOLD, int NT>
__device__ __forceinline__ void kv_step(
    const Params& p, float (&o)[DP / 2], float (&sc)[32], float (&m_run)[2],
    float (&l_run)[2], const float* const* br0, const float* const* br1,
    bool vec, int i0, int kv0, int lane, uint32_t q_a, uint32_t k_a,
    uint64_t* v_full, int ph, bool tr, int lt, int it) {
  fence_acc(sc);
  wgmma_fence();
  scores_product<DP / 16, NT>(sc, q_a, k_a);
  float bv[32];
  if (NBIAS > 0) load_bias<EDGE, NBIAS, NT>(p, bv, br0, br1, kv0, lane, vec);
  wgmma_wait<0>();
  fence_acc(sc);
  if (tr) TRACE(lt, 2, it);
  float alpha[2];
  softmax_tile<EDGE, NBIAS, FOLD, NT>(p, sc, bv, m_run, l_run, alpha, i0,
                                      kv0, lane);
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
  uint32_t pa[4][4];
  pack_p<NT>(sc, pa);
  mbar_wait(v_full, ph);
  if (tr) TRACE(lt, 3, it);
  fence_acc(o);
  wgmma_fence();
  pv_product<DP, NT>(o, pa, k_a + (DP / BOX) * BOX_BYTES);
  wgmma_wait<0>();
  fence_acc(o);
  fence_p(pa);
  if (tr) TRACE(lt, 4, it);
}

template <int DP, int WGS>
__global__ void __launch_bounds__(128 * (WGS + 1), WGS == 1 ? 2 : 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_o,
                       const __grid_constant__ Params p) {
  using S = Smem<DP, WGS>;
  constexpr int NB = S::NB, ND = DP / 2, STAGES = S::STAGES;
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t full_k[STAGES], full_v[STAGES],
      empty[STAGES], q_full[2], q_empty[2];
  // aligned by an offset from the shared array (not an integer round
  // trip), so that the compiler keeps shared loads and stores
  uint8_t* smem =
      dyn_smem + ((ALIGN - (smem_u32(dyn_smem) & (ALIGN - 1))) & (ALIGN - 1));
  uint8_t* ring = smem + S::RING_OFF;

  const int tid = threadIdx.x, t = tid & 127, warp_group = tid >> 7;
  const int N = p.N;
  const int n_qt = (N + BQ * WGS - 1) / (BQ * WGS);
  const int n_tiles = n_qt * p.H * p.B;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 4 * WGS);    // every consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], 4 * WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp_group == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (t == 0) {
      int g = 0;    // kv tiles loaded, over the block's tiles
      int lt = 0;   // the block's tiles
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++lt) {
        const Tile w = tile_at(p, tile, n_qt, WGS);
        const int qs = lt & 1;
        if (lt >= 2) mbar_wait(&q_empty[qs], ((lt >> 1) - 1) & 1);
        mbar_expect_tx(&q_full[qs], w.active * S::TILE);
        for (int x = 0; x < w.active; ++x)
#pragma unroll
          for (int c = 0; c < NB; ++c)
            tma_load_4d(smem + S::Q_OFF + (qs * WGS + x) * S::TILE +
                            c * BOX_BYTES,
                        &tm_q, &q_full[qs], c * BOX, w.q0 + x * BQ, w.h,
                        w.b);
        for (int it = 0; it < w.n_kv; ++it, ++g) {
          const int s = g % STAGES;
          if (g >= STAGES) mbar_wait(&empty[s], ((g / STAGES) - 1) & 1);
          uint8_t* st = ring + s * S::STAGE;
          mbar_expect_tx(&full_k[s], S::TILE);
#pragma unroll
          for (int c = 0; c < NB; ++c)
            tma_load_4d(st + c * BOX_BYTES, &tm_k, &full_k[s], c * BOX,
                        it * BKV, w.h, w.b);
          mbar_expect_tx(&full_v[s], S::TILE);
#pragma unroll
          for (int c = 0; c < NB; ++c)
            tma_load_4d(st + S::TILE + c * BOX_BYTES, &tm_v, &full_v[s],
                        c * BOX, it * BKV, w.h, w.b);
          if (lt < 8) TRACE(lt, 0, it);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    if (WGS == 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
    const int w = warp_group - 1;
    const int warp = t >> 5, lane = t & 31;
    const bool first = tid == 128;
    const auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    uint8_t* o_tile = smem + S::O_OFF + w * S::TILE;
    int g = 0, lt = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++lt) {
      const Tile tw = tile_at(p, tile, n_qt, WGS);
      const int qs = lt & 1, h = tw.h, b = tw.b;
      const int qw = tw.q0 + w * BQ;                // this warpgroup's rows
      const int i0 = qw + warp * 16 + (lane >> 2);  // rows i0, i0 + 8
      // the warpgroup's own kv tiles (none if it holds no row < n): past
      // them, the block's tiles are only waited for and freed, so that no
      // arrival runs ahead of the producer's phases
      const int n_mine =
          w < tw.active
              ? (kv_limit(p, qw, min(qw + BQ, N) - 1) + BKV - 1) / BKV
              : 0;
      const float* br0[2] = {nullptr, nullptr};
      const float* br1[2] = {nullptr, nullptr};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long i = min(i0 + 8 * hh, N - 1);
        if (p.bias[0])
          br0[hh] = p.bias[0] + b * p.bias_s[0][0] + h * p.bias_s[0][1] +
                    i * p.bias_s[0][2];
        if (p.bias[1])
          br1[hh] = p.bias[1] + b * p.bias_s[1][0] + h * p.bias_s[1][1] +
                    i * p.bias_s[1][2];
      }
      const int nbias = (p.bias[0] != nullptr) + (p.bias[1] != nullptr);
      const bool fold = nbias == 0 && p.scale > 0.f;
      const bool vec =
          nbias > 0 && p.bias_s[0][3] == 1 &&
          (nbias < 2 || p.bias_s[1][3] == 1) &&
          ((reinterpret_cast<uintptr_t>(br0[0]) |
            reinterpret_cast<uintptr_t>(br0[1]) |
            reinterpret_cast<uintptr_t>(br1[0]) |
            reinterpret_cast<uintptr_t>(br1[1])) & 7) == 0;
      const uint32_t q_a =
          smem_u32(smem + S::Q_OFF + (qs * WGS + w) * S::TILE);

      float o[ND], sc[32];
#pragma unroll
      for (int x = 0; x < ND; ++x) o[x] = 0.f;
#pragma unroll
      for (int x = 0; x < 32; ++x) sc[x] = 0.f;
      float m_run[2] = {M_INIT, M_INIT}, l_run[2] = {0.f, 0.f};

      if (first && lt < 8) TRACE(lt, 5, 0);
      if (n_mine > 0) mbar_wait(&q_full[qs], (lt >> 1) & 1);
      if (first && lt < 8) TRACE(lt, 5, 1);
      for (int it = 0; it < tw.n_kv; ++it, ++g) {
        const int s = g % STAGES, ph = (g / STAGES) & 1, kv0 = it * BKV;
        const uint32_t k_a = smem_u32(ring + s * S::STAGE);
        mbar_wait(&full_k[s], ph);
        if (it >= n_mine) {
          mbar_wait(&full_v[s], ph);
          release(&empty[s]);
          continue;
        }
        if (first && lt < 8) TRACE(lt, 1, it);
        const bool tr = first && lt < 8;
        // three consumer warpgroups hold 160 registers each: bias-free
        // calls only (the launcher refuses others), so their bias paths are
        // not built
        constexpr int B1 = WGS == 1 ? 1 : 0, B2 = WGS == 1 ? 2 : 0;
#define KV_STEP(EDGE, NBIAS, FOLD, NT)                                      \
  kv_step<DP, EDGE, NBIAS, FOLD, NT>(p, o, sc, m_run, l_run, br0, br1, vec, \
                                     i0, kv0, lane, q_a, k_a, &full_v[s],  \
                                     ph, tr, lt, it)
        if (p.M - kv0 <= 16) {
          // the last keys, at most 16 of them
          if (nbias == 0)
            KV_STEP(true, 0, false, 8);
          else if (nbias == 1)
            KV_STEP(true, B1, false, 8);
          else
            KV_STEP(true, B2, false, 8);
        } else if (kv0 + BKV > p.M ||
                   (p.causal && kv0 + BKV - 1 > qw + p.M - N)) {
          if (nbias == 0)
            KV_STEP(true, 0, false, 32);
          else if (nbias == 1)
            KV_STEP(true, B1, false, 32);
          else
            KV_STEP(true, B2, false, 32);
        } else if (nbias == 0) {
          if (fold)
            KV_STEP(false, 0, true, 32);
          else
            KV_STEP(false, 0, false, 32);
        } else if (nbias == 1) {
          KV_STEP(false, B1, false, 32);
        } else {
          KV_STEP(false, B2, false, 32);
        }
#undef KV_STEP
        release(&empty[s]);
      }
      // the Q tile is free for the tile after next
      release(&q_empty[qs]);
      if (n_mine == 0) continue;

      // out = O / l in bf16, staged in the warpgroup's O tile in the loads'
      // 64-byte-swizzled box layout (a 16-byte chunk of row r at
      // chunk ^ (r / 2) % 4), then one TMA store of the boxes: rows ≥ n
      // and columns ≥ d are clipped by the map.  The previous tile's store
      // has read the O tile out before it is written again.  lse beside
      // it.  Rows that saw only NEG_INF scores have l ≥ 1 (the uniform
      // average).
      float inv[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 1);
        l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 2);
        inv[hh] = 1.f / l_run[hh];
      }
      if (t == 0) bulk_wait_read<0>();
      asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory");
#pragma unroll
      for (int jj = 0; jj < DP / 8; ++jj) {
        const int col = 8 * jj + 2 * (lane & 3);   // of the tile's DP
        uint8_t* box = o_tile + (col / BOX) * BOX_BYTES;
        const int chunk = (col % BOX) / 8, in_chunk = (col % 8) * 2;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = warp * 16 + (lane >> 2) + 8 * hh;
          *reinterpret_cast<uint32_t*>(
              box + r * 64 + ((chunk ^ ((r >> 1) & 3)) << 4) + in_chunk) =
              pack_bf16(o[4 * jj + 2 * hh] * inv[hh],
                        o[4 * jj + 2 * hh + 1] * inv[hh]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory");
      if (t == 0) {
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_store_4d(&tm_o, o_tile + c * BOX_BYTES, c * BOX, qw, h, b);
        bulk_commit();
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + 8 * hh;
        if (i < N && (lane & 3) == 0)
          p.lse[(static_cast<long long>(b) * p.H + h) * N + i] =
              m_run[hh] + logf(l_run[hh]);
      }
      if (first && lt < 8) TRACE(lt, 5, 2);
    }
    // the last store must read its O tile out before the block's shared
    // memory goes
    if (t == 0) bulk_wait_read<0>();
  }
}

// The blocks of one instantiation an SM holds at once (shared memory,
// registers and threads, as the card reports them), after its shared
// memory is opted in and its setmaxnreg budget checked; found once.
// Returns the count, or minus the cudaError_t of a step that failed.
template <int DP, int WGS>
int blocks_per_sm() {
  static const int blocks = [] {
    const void* fn =
        reinterpret_cast<const void*>(flash_fwd_wgmma_kernel<DP, WGS>);
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<DP, WGS>::BYTES);
    // the producer's 24 registers and each consumer's 232 (160 with three)
    if (err == cudaSuccess)
      err = check_setmaxnreg(fn, WGS + 1, 0,
                             24 + WGS * (WGS == 1 ? 232 : 160));
    int n = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, fn, 128 * (WGS + 1), Smem<DP, WGS>::BYTES);
    if (err == cudaSuccess && n == 0) err = cudaErrorInvalidConfiguration;
    return err == cudaSuccess ? n : -static_cast<int>(err);
  }();
  return blocks;
}

template <int DP, int WGS>
int launch(const CUtensorMap* maps, const Params& p, cudaStream_t st) {
  constexpr int bytes = Smem<DP, WGS>::BYTES;
  const int per_sm = blocks_per_sm<DP, WGS>();
  if (per_sm < 0) return -per_sm;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: as many blocks as the SMs hold at once (two an SM with one
  // consumer warpgroup, one with three, as the card reports), or one per
  // tile where there are fewer tiles
  const long long tiles =
      static_cast<long long>((p.N + BQ * WGS - 1) / (BQ * WGS)) * p.H * p.B;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  flash_fwd_wgmma_kernel<DP, WGS><<<grid, 128 * (WGS + 1), bytes, st>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 forward.  strides holds 17 int64 values: q (b, n, h), k (b, m,
// h), v (b, m, h), bias0 (b, h, n, m), bias1 (b, h, n, m) — the mma.sync
// entry point's.  out is a contiguous (b, n, h, d) bf16 tensor, lse a
// contiguous (b, h, n) float32 one.  wgs: consumer warpgroups a block (1:
// 64 query rows, two blocks an SM; 3: 192 rows, one block, no bias, d ≤
// 96).
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a shape,
// layout or wgs it does not take).
extern "C" int flash_attention_fwd_wgmma(const void* q, const void* k,
                                         const void* v, void* out, void* lse,
                                         const void* bias0, const void* bias1,
                                         const long long* strides, int B,
                                         int N, int M, int H, int D,
                                         float scale, int causal, int wgs,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return static_cast<int>(bound);
  if (D <= 32 || D > 128 || D % 8 != 0 || (wgs != 1 && wgs != 3) ||
      N <= 0 || M <= 0 ||
      (wgs == 3 && (bias0 != nullptr || bias1 != nullptr || D > 96)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long out_strides[3] = {static_cast<long long>(N) * H * D,
                                    static_cast<long long>(H) * D, D};
  CUtensorMap maps[4];
  if (!encode_4d(&maps[0], q, B, N, H, D, strides, BOX, 64) ||
      !encode_4d(&maps[1], k, B, M, H, D, strides + 3, BOX, 64) ||
      !encode_4d(&maps[2], v, B, M, H, D, strides + 6, BOX, 64) ||
      !encode_4d(&maps[3], out, B, N, H, D, out_strides, BOX, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.bias[0] = static_cast<const float*>(bias0);
  p.bias[1] = static_cast<const float*>(bias1);
  for (int t = 0; t < 4; ++t) {
    p.bias_s[0][t] = strides[9 + t];
    p.bias_s[1][t] = strides[13 + t];
  }
  p.B = B;
  p.N = N;
  p.M = M;
  p.H = H;
  p.D = D;
  p.scale = scale;
  p.causal = causal;
  if (D <= 64)
    return wgs == 1 ? launch<64, 1>(maps, p, st) : launch<64, 3>(maps, p, st);
  if (D <= 96)
    return wgs == 1 ? launch<96, 1>(maps, p, st) : launch<96, 3>(maps, p, st);
  return launch<128, 1>(maps, p, st);
}

// The blocks an SM holds of the instantiation that a call of head dim d
// with wgs consumer warpgroups runs (the persistent grid's per-SM count),
// or minus a cudaError_t (cudaErrorInvalidValue for a d or wgs the entry
// point does not take).
extern "C" int flash_attention_fwd_wgmma_blocks_per_sm(int D, int wgs) {
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return -static_cast<int>(bound);
  if (D <= 32 || D > 128 || (wgs != 1 && wgs != 3) || (wgs == 3 && D > 96))
    return -static_cast<int>(cudaErrorInvalidValue);
  if (D <= 64)
    return wgs == 1 ? blocks_per_sm<64, 1>() : blocks_per_sm<64, 3>();
  if (D <= 96)
    return wgs == 1 ? blocks_per_sm<96, 1>() : blocks_per_sm<96, 3>();
  return blocks_per_sm<128, 1>();
}

#ifdef FWD_TRACE
extern "C" int fwd_trace_read(void* dst) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(dst, fwd_trace, sizeof(fwd_trace)));
}
#endif
