// Flash-attention backward for Hopper (sm_90a): dq, dk with dv, and dbias.
//
// Replaces the Pallas TPU kernels `_flash_dq_kernel`, `_flash_dkv_kernel`
// and `_flash_dbias_kernel` (vlm_compression_tpu/ops/attention.py:296, :331
// and :371, launched by `_flash_backward_pallas`).  Same contract, from the
// forward's saved log-sum-exp and delta = rowsum(g ⊙ out) (formed by the
// caller in fp32):
//   s  = (q · kᵀ) * scale + Σ bias_i                  (fp32, as the forward)
//   p  = exp(s − lse)
//   ds = p ⊙ (g · vᵀ − delta) · scale, cast to the input dtype; 0 where the
//        causal flag hides the entry (a `where` in the reference, so those
//        entries carry no gradient — rows that see no key included), and
//        there p is exact: 1/m in a row that sees no key, 0 elsewhere (the
//        saved lse of such a row, −1e9 + log m, rounds to −1e9 in fp32)
//   dq = ds · k;   dk = dsᵀ · q;   dv = p.astype(g.dtype)ᵀ · g   (fp32 sums)
//   dbias_i = p ⊙ (g · vᵀ − delta)  (unscaled: ∂s/∂bias = 1), in fp32,
//        summed over every axis bias i broadcasts (batch, head, query, key)
// q/g are (b, n, h, d), k/v (b, m, h, d), read through their strides (last
// dim contiguous); dq/dk/dv are written contiguous in q/k/v's dtype, dbias
// contiguous fp32 at the bias's shape.  Up to two additive fp32 biases are
// read at their broadcast shape through four strides each (0 on size-1
// axes), as in the forward: never expanded.
//
// What bounds it on an H100: 10·b·h·n·m·d operations (five products: the
// score recompute, g·vᵀ, and ds·k, dsᵀ·q, pᵀ·g; six of them in the dq
// kernel, eight in the dk/dv kernel, which both recompute s and g·vᵀ)
// against the bytes of q, k, v, g, dq, dk, dv, lse, delta and the biases.
// At the towers' training shapes (n, m in the tens to hundreds, d = 64 or
// 88) the bytes bound it: each kernel reads every input once per tile pair
// from L2, and the score tiles never reach device memory.  The dbias kernel
// does the two products of the recompute, 4·b·h·n·m·d operations, against
// q, k, v, g, lse, delta and the biases read once and dbias written once:
// at T5's shapes (n = m = 72, d = 64) its bytes bound it too, and its
// design keeps the reduced sum in registers so that each output entry is
// written once and no (b, h, n, m) ds ever reaches device memory.
//
// Design: on the TPU one grid axis ran in order and carried the dq (or
// dk/dv) sums in VMEM scratch; Hopper blocks run in no order, so that axis
// is a loop inside the block.  The dq kernel has one block of 4 warps per
// (q tile of 64 rows, head, batch) and loops over kv tiles; the dk/dv
// kernel has one block per (kv tile of 64 rows, head, batch) and loops over
// q tiles, with dk and dv summed in fp32 registers.  The dbias kernel has
// one block per tile of the output at the bias's real dims (kv tile if the
// bias has a key dim, q tile if it has a query dim, batch and head if it
// has them) and loops inside the block over every reduced (batch, head,
// q tile, kv tile), summing ds in fp32 registers in the score tile's
// layout; where rows or columns are reduced too it sums them through
// shared memory at the end, and writes once — deterministic, no atomics,
// no second pass (the TPU kernel carried the same sum across its
// sequential reduced grid axes).  bf16 multiplies on the tensor cores
// (mma.sync, fp32 accumulate) in the forward kernel's register
// layout, described above the bf16 kernels; float32 multiplies on the CUDA
// cores (no TF32): two lanes share a row, each recomputes 32 of the tile's
// 64 scores and g·vᵀ entries in registers, writes ds (and p) to shared
// memory as fp32 tiles, and sums half of the row's d columns.  The head dim
// is padded to a multiple of 32 in shared memory only (d = 88 runs as 96).
// The score recompute repeats the forward's arithmetic (scale, then the
// biases in order), so exp(s − lse) stays consistent with the saved lse
// (exactly so where the forward summed in the same order); the dbias
// kernels recompute s and g·vᵀ with the dq kernels' code, so their p and
// ds are the dq kernels' bit for bit.  Causal calls skip the tiles that
// hold no visible entry: all of them in the dq and dbias kernels (hidden
// entries have ds = 0), and in the dk/dv kernel those of q rows that see a
// key elsewhere (their p is exactly 0 there); rows that see no key at all
// (n > m) keep the reference's uniform p in dv.
//
// Not yet done (later PRs): TMA + wgmma with a pipelined tile ring; dbias
// fused into the dq kernel (per-batch partials summed in a second pass).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64, BKV = 64, THREADS = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  const float* lse;     // (b, h, n)
  const float* delta;   // (b, h, n)
  void* dq;
  void* dk;
  void* dv;
  float* dbias;         // contiguous fp32 at its bias's shape
  const float* bias[2];
  long long q_s[3], k_s[3], v_s[3], g_s[3];  // strides of (batch, seq, head)
  long long bias_s[2][4];                    // strides of (b, h, n, m)
  int B, N, M, H, D;
  float scale;
  int causal;
  int vec;   // 16-byte bf16 row loads: d % 8 == 0, aligned bases and strides
  int keep;  // dbias: the axes its bias keeps, bits b 1, h 2, n 4, m 8
};

__device__ __forceinline__ bool hidden(const Params& p, int i, int j) {
  return p.causal && j > i + (p.M - p.N);
}

// the forward's biased score of (row i < N, key j < M), before masking
__device__ __forceinline__ float biased(const Params& p, const float* b0,
                                        const float* b1, float acc, int i,
                                        int j) {
  float x = acc * p.scale;
  if (b0) x += b0[i * p.bias_s[0][2] + j * p.bias_s[0][3]];
  if (b1) x += b1[i * p.bias_s[1][2] + j * p.bias_s[1][3]];
  return x;
}

// rows [row0, row0 + 64) of a (seq, d) slice with row stride `rs` into a
// 64 × (DP + 1) fp32 tile; rows ≥ rows_valid and columns ≥ d read as zeros
template <int DP>
__device__ __forceinline__ void load_rows(float* s, const float* g, long long rs,
                                          int row0, int rows_valid, int d,
                                          int tid) {
  constexpr int LD = DP + 1;
  for (int e = tid; e < 64 * DP; e += THREADS) {
    const int r = e / DP, c = e % DP, gr = row0 + r;
    s[r * LD + c] = (gr < rows_valid && c < d) ? g[gr * rs + c] : 0.f;
  }
}

template <int DP>
struct Layout {
  static constexpr int LD = DP + 1;     // q/k/v/g tile rows (odd: no conflicts)
  static constexpr int LDS = 64 + 1;    // ds / p rows
  static constexpr int TILE = 64 * LD;
  // four q/k/v/g tiles, two ds/p tiles, lse and delta
  static constexpr int BYTES = (4 * TILE + 2 * 64 * LDS + 2 * 64) * 4;
};

// ==================================== float32 kernels (CUDA cores, no TF32)

template <int DP>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(Params p) {
  using L = Layout<DP>;
  constexpr int LD = L::LD, LDS = L::LDS, HALF = DP / 2;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sG = sQ + L::TILE;
  float* sK = sG + L::TILE;
  float* sV = sK + L::TILE;
  float* sDS = sV + L::TILE;
  float* sLse = sDS + 2 * 64 * LDS;
  float* sDelta = sLse + 64;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int N = p.N, M = p.M, D = p.D;
  const float* q = static_cast<const float*>(p.q) + b * p.q_s[0] + h * p.q_s[2];
  const float* k = static_cast<const float*>(p.k) + b * p.k_s[0] + h * p.k_s[2];
  const float* v = static_cast<const float*>(p.v) + b * p.v_s[0] + h * p.v_s[2];
  const float* g = static_cast<const float*>(p.g) + b * p.g_s[0] + h * p.g_s[2];
  const float* bias0 = p.bias[0] ? p.bias[0] + b * p.bias_s[0][0] + h * p.bias_s[0][1] : nullptr;
  const float* bias1 = p.bias[1] ? p.bias[1] + b * p.bias_s[1][0] + h * p.bias_s[1][1] : nullptr;
  const long long row_off = ((long long)b * p.H + h) * N;

  load_rows<DP>(sQ, q, p.q_s[1], q0, N, D, tid);
  load_rows<DP>(sG, g, p.g_s[1], q0, N, D, tid);
  if (tid < BQ) {
    const int i = q0 + tid;
    sLse[tid] = i < N ? p.lse[row_off + i] : 0.f;
    sDelta[tid] = i < N ? p.delta[row_off + i] : 0.f;
  }

  // each warp owns 16 rows: two lanes per row, 32 keys / HALF columns each
  const int r = warp * 16 + (lane >> 1), half = lane & 1, i = q0 + r;
  float acc[HALF];
#pragma unroll
  for (int c = 0; c < HALF; ++c) acc[c] = 0.f;

  // hidden entries have ds = 0: stop after the block's last visible key
  const int i_last = min(q0 + BQ - 1, N - 1);
  const int kv_end = p.causal ? min(M, i_last + (M - N) + 1) : M;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();   // the previous tile is done (and q/g/lse in place)
    load_rows<DP>(sK, k, p.k_s[1], kv0, M, D, tid);
    load_rows<DP>(sV, v, p.v_s[1], kv0, M, D, tid);
    __syncthreads();

    float s[32], dp[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) s[c] = dp[c] = 0.f;
    for (int dd = 0; dd < DP; ++dd) {
      const float qv = sQ[r * LD + dd], gv = sG[r * LD + dd];
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        s[c] = fmaf(qv, sK[(half * 32 + c) * LD + dd], s[c]);
        dp[c] = fmaf(gv, sV[(half * 32 + c) * LD + dd], dp[c]);
      }
    }
    const float lse_i = sLse[r], delta_i = sDelta[r];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int j = kv0 + half * 32 + c;
      float ds = 0.f;
      if (i < N && j < M && !hidden(p, i, j)) {
        const float pr = expf(biased(p, bias0, bias1, s[c], i, j) - lse_i);
        ds = pr * (dp[c] - delta_i) * p.scale;
      }
      sDS[r * LDS + half * 32 + c] = ds;
    }
    __syncwarp();      // the row's two lanes share it
    for (int kk = 0; kk < BKV; ++kk) {
      const float dsv = sDS[r * LDS + kk];
#pragma unroll
      for (int c = 0; c < HALF; ++c)
        acc[c] = fmaf(dsv, sK[kk * LD + half * HALF + c], acc[c]);
    }
  }

  if (i < N) {
    float* dq = static_cast<float*>(p.dq) + (((long long)b * N + i) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < HALF; ++c) {
      const int col = half * HALF + c;
      if (col < D) dq[col] = acc[c];
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(Params p) {
  using L = Layout<DP>;
  constexpr int LD = L::LD, LDS = L::LDS, HALF = DP / 2;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + L::TILE;
  float* sQ = sV + L::TILE;
  float* sG = sQ + L::TILE;
  float* sP = sG + L::TILE;
  float* sDS = sP + 64 * LDS;
  float* sLse = sDS + 64 * LDS;
  float* sDelta = sLse + 64;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kv0 = blockIdx.x * BKV, h = blockIdx.y, b = blockIdx.z;
  const int N = p.N, M = p.M, D = p.D, off = M - N;
  const float* q = static_cast<const float*>(p.q) + b * p.q_s[0] + h * p.q_s[2];
  const float* k = static_cast<const float*>(p.k) + b * p.k_s[0] + h * p.k_s[2];
  const float* v = static_cast<const float*>(p.v) + b * p.v_s[0] + h * p.v_s[2];
  const float* g = static_cast<const float*>(p.g) + b * p.g_s[0] + h * p.g_s[2];
  const float* bias0 = p.bias[0] ? p.bias[0] + b * p.bias_s[0][0] + h * p.bias_s[0][1] : nullptr;
  const float* bias1 = p.bias[1] ? p.bias[1] + b * p.bias_s[1][0] + h * p.bias_s[1][1] : nullptr;
  const long long row_off = ((long long)b * p.H + h) * N;

  load_rows<DP>(sK, k, p.k_s[1], kv0, M, D, tid);
  load_rows<DP>(sV, v, p.v_s[1], kv0, M, D, tid);

  // each warp owns 16 kv rows: two lanes per row, 32 queries / HALF columns
  const int jr = warp * 16 + (lane >> 1), half = lane & 1, j = kv0 + jr;
  float dk[HALF], dv[HALF];
#pragma unroll
  for (int c = 0; c < HALF; ++c) dk[c] = dv[c] = 0.f;

  for (int q0 = 0; q0 < N; q0 += BQ) {
    // no row of this q tile sees a key of this kv block, and each sees one
    // elsewhere (so its p here is exactly 0): nothing to add
    if (p.causal && q0 + off >= 0 && min(q0 + BQ - 1, N - 1) + off < kv0)
      continue;
    __syncthreads();   // the previous tile is done (and k/v in place)
    load_rows<DP>(sQ, q, p.q_s[1], q0, N, D, tid);
    load_rows<DP>(sG, g, p.g_s[1], q0, N, D, tid);
    if (tid < BQ) {
      const int i = q0 + tid;
      sLse[tid] = i < N ? p.lse[row_off + i] : 0.f;
      sDelta[tid] = i < N ? p.delta[row_off + i] : 0.f;
    }
    __syncthreads();

    float s[32], dp[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) s[c] = dp[c] = 0.f;
    for (int dd = 0; dd < DP; ++dd) {
      const float kv = sK[jr * LD + dd], vv = sV[jr * LD + dd];
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        s[c] = fmaf(sQ[(half * 32 + c) * LD + dd], kv, s[c]);
        dp[c] = fmaf(sG[(half * 32 + c) * LD + dd], vv, dp[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int qi = half * 32 + c, i = q0 + qi;
      float pv = 0.f, ds = 0.f;
      if (i < N && j < M) {
        if (hidden(p, i, j)) {
          // exact p of a hidden entry: 1/m in a row that sees no key (its
          // lse, −1e9 + log m, rounds to −1e9 in fp32), else 0; ds = 0
          pv = i + off < 0 ? 1.f / M : 0.f;
        } else {
          pv = expf(biased(p, bias0, bias1, s[c], i, j) - sLse[qi]);
          ds = pv * (dp[c] - sDelta[qi]) * p.scale;
        }
      }
      sP[jr * LDS + qi] = pv;
      sDS[jr * LDS + qi] = ds;
    }
    __syncwarp();      // the row's two lanes share it
    for (int qq = 0; qq < BQ; ++qq) {
      const float pv = sP[jr * LDS + qq], dsv = sDS[jr * LDS + qq];
#pragma unroll
      for (int c = 0; c < HALF; ++c) {
        dv[c] = fmaf(pv, sG[qq * LD + half * HALF + c], dv[c]);
        dk[c] = fmaf(dsv, sQ[qq * LD + half * HALF + c], dk[c]);
      }
    }
  }

  if (j < M) {
    const long long o = (((long long)b * M + j) * p.H + h) * D;
    float* dkp = static_cast<float*>(p.dk) + o;
    float* dvp = static_cast<float*>(p.dv) + o;
#pragma unroll
    for (int c = 0; c < HALF; ++c) {
      const int col = half * HALF + c;
      if (col < D) {
        dkp[col] = dk[c];
        dvp[col] = dv[c];
      }
    }
  }
}

// ============================================ bf16 kernels (mma.sync m16n8k16)
//
// The forward kernel's register layout (csrc/flash_attention.cu), with the
// roles it gives each operand: a warp owns 16 rows and keeps everything of
// them in registers in the tensor cores' fragment layout.  dq: the q and g
// rows are A operands read once (S = Q·Kᵀ and dP = G·Vᵀ take K's and V's
// rows as B), ds is formed in the score accumulators and, cast to bf16, is
// the A operand of dQ += dS·K (K read transposed with ldmatrix).  dk/dv:
// the warp's k and v rows are the A operands (Sᵀ = K·Qᵀ, dPᵀ = V·Gᵀ take
// the q tile's Q and G rows as B); pᵀ and dsᵀ, cast to bf16, are the A
// operands of dV += Pᵀ·G and dK += dSᵀ·Q.  Only k/v (or q/g) tiles pass
// through shared memory.

union Pack8 {
  uint4 u;
  uint16_t h[8];   // bf16 bit patterns
};

// rows [row0, row0 + 64) of a (seq, d) slice with row stride `rs` into a
// 64 × (DP + 8) bf16 tile; rows ≥ rows_valid and columns ≥ d read as zeros
template <int DP>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, long long rs,
                                          int row0, int rows_valid, int d,
                                          bool vec, int tid) {
  constexpr int LD = DP + 8, CH = DP / 8;
  for (int c = tid; c < 64 * CH; c += THREADS) {
    const int r = c / CH, col = (c % CH) * 8, gr = row0 + r;
    Pack8 v;
    v.u = make_uint4(0u, 0u, 0u, 0u);
    if (gr < rows_valid) {
      const bf16* src = g + gr * rs + col;
      if (vec) {
        if (col < d) v.u = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (col + e < d) v.h[e] = __bfloat16_as_ushort(src[e]);
      }
    }
    *reinterpret_cast<uint4*>(s + r * LD + col) = v.u;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a · b on the tensor cores: a 16×16 bf16 (row), b 16×8 bf16 (col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the B operand (k × n = 16 × 8) of a row-major (k, n) shared tile, read
// transposed: lanes 0-15 address rows k0..k0+15 at column n0
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const bf16* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// the A fragments (16 rows × 16 of d) of rows r, r + 8 of a shared tile
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const bf16* base,
                                       int ld) {
  a[0] = lds32(base);
  a[1] = lds32(base + 8 * ld);
  a[2] = lds32(base + 8);
  a[3] = lds32(base + 8 * ld + 8);
}

// acc[nt] += A · (rows nt·8 + gid of a shared (n, d) tile)ᵀ over d
template <int DP>
__device__ __forceinline__ void mma_rows(float (&acc)[8][4],
                                         const uint32_t (&a)[4],
                                         const bf16* tile, int kk, int gid,
                                         int tig) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const bf16* b = tile + (nt * 8 + gid) * LD + kk * 16 + tig * 2;
    mma_bf16(acc[nt], a[0], a[1], a[2], a[3], lds32(b), lds32(b + 8));
  }
}

// out[nd] += X · tile over the tile's 64 rows, X the bf16 A operand packed
// from the fp32 accumulators x[8][4] (16 rows × 64), tile row-major (64, d)
template <int DP>
__device__ __forceinline__ void mma_acc_tile(float (&out)[DP / 8][4],
                                             const float (&x)[8][4],
                                             const bf16* tile, int lane) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const uint32_t a0 = pack_bf16(x[2 * t][0], x[2 * t][1]);
    const uint32_t a1 = pack_bf16(x[2 * t][2], x[2 * t][3]);
    const uint32_t a2 = pack_bf16(x[2 * t + 1][0], x[2 * t + 1][1]);
    const uint32_t a3 = pack_bf16(x[2 * t + 1][2], x[2 * t + 1][3]);
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd) {
      uint32_t b0, b1;
      ldmatrix_x2_trans(b0, b1, tile + (t * 16 + (lane & 15)) * LD + nd * 8);
      mma_bf16(out[nd], a0, a1, a2, a3, b0, b1);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_mma_kernel(Params p) {
  constexpr int LD = DP + 8, KS = DP / 16, ND = DP / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sG = sQ + BQ * LD;
  bf16* sK = sG + BQ * LD;
  bf16* sV = sK + BKV * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int N = p.N, M = p.M, D = p.D;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_s[0] + h * p.q_s[2];
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_s[0] + h * p.k_s[2];
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_s[0] + h * p.v_s[2];
  const bf16* g = static_cast<const bf16*>(p.g) + b * p.g_s[0] + h * p.g_s[2];
  const float* bias0 = p.bias[0] ? p.bias[0] + b * p.bias_s[0][0] + h * p.bias_s[0][1] : nullptr;
  const float* bias1 = p.bias[1] ? p.bias[1] + b * p.bias_s[1][0] + h * p.bias_s[1][1] : nullptr;
  const long long row_off = ((long long)b * p.H + h) * N;

  load_tile<DP>(sQ, q, p.q_s[1], q0, N, D, p.vec, tid);
  load_tile<DP>(sG, g, p.g_s[1], q0, N, D, p.vec, tid);
  __syncthreads();
  // this thread's rows of the warp's 16: r (fragment rows gid) and r + 8
  const int r = warp * 16 + gid;
  const int i0 = q0 + r, i1 = i0 + 8;
  uint32_t qa[KS][4], ga[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a_frag(qa[kk], sQ + r * LD + kk * 16 + tig * 2, LD);
    a_frag(ga[kk], sG + r * LD + kk * 16 + tig * 2, LD);
  }
  const float lse[2] = {i0 < N ? p.lse[row_off + i0] : 0.f,
                        i1 < N ? p.lse[row_off + i1] : 0.f};
  const float delta[2] = {i0 < N ? p.delta[row_off + i0] : 0.f,
                          i1 < N ? p.delta[row_off + i1] : 0.f};

  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;

  // hidden entries have ds = 0: stop after the block's last visible key
  const int i_last = min(q0 + BQ - 1, N - 1);
  const int kv_end = p.causal ? min(M, i_last + (M - N) + 1) : M;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();   // every warp is done with the previous k/v tile
    load_tile<DP>(sK, k, p.k_s[1], kv0, M, D, p.vec, tid);
    load_tile<DP>(sV, v, p.v_s[1], kv0, M, D, p.vec, tid);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = dp[nt][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      mma_rows<DP>(s, qa[kk], sK, kk, gid, tig);
      mma_rows<DP>(dp, ga[kk], sV, kk, gid, tig);
    }
    // element c of n-tile nt: row (c < 2 ? i0 : i1), key nt·8 + tig·2 + c&1
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c < 2 ? i0 : i1, j = kv0 + nt * 8 + tig * 2 + (c & 1);
        float ds = 0.f;
        if (i < N && j < M && !hidden(p, i, j)) {
          const float pr = expf(biased(p, bias0, bias1, s[nt][c], i, j)
                                - lse[c >> 1]);
          ds = pr * (dp[nt][c] - delta[c >> 1]) * p.scale;
        }
        s[nt][c] = ds;
      }
    }
    mma_acc_tile<DP>(o, s, sK, lane);   // dQ += dS · K
  }

  bf16* dq = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = nd * 8 + tig * 2 + e;
      if (col >= D) continue;
      if (i0 < N)
        dq[(((long long)b * N + i0) * p.H + h) * D + col] = __float2bfloat16(o[nd][e]);
      if (i1 < N)
        dq[(((long long)b * N + i1) * p.H + h) * D + col] = __float2bfloat16(o[nd][2 + e]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_mma_kernel(Params p) {
  constexpr int LD = DP + 8, KS = DP / 16, ND = DP / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BKV * LD;
  bf16* sQ = sV + BKV * LD;
  bf16* sG = sQ + BQ * LD;
  float* sLse = reinterpret_cast<float*>(sG + BQ * LD);
  float* sDelta = sLse + BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int kv0 = blockIdx.x * BKV, h = blockIdx.y, b = blockIdx.z;
  const int N = p.N, M = p.M, D = p.D, off = M - N;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_s[0] + h * p.q_s[2];
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_s[0] + h * p.k_s[2];
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_s[0] + h * p.v_s[2];
  const bf16* g = static_cast<const bf16*>(p.g) + b * p.g_s[0] + h * p.g_s[2];
  const float* bias0 = p.bias[0] ? p.bias[0] + b * p.bias_s[0][0] + h * p.bias_s[0][1] : nullptr;
  const float* bias1 = p.bias[1] ? p.bias[1] + b * p.bias_s[1][0] + h * p.bias_s[1][1] : nullptr;
  const long long row_off = ((long long)b * p.H + h) * N;

  load_tile<DP>(sK, k, p.k_s[1], kv0, M, D, p.vec, tid);
  load_tile<DP>(sV, v, p.v_s[1], kv0, M, D, p.vec, tid);

  // this thread's kv rows of the warp's 16: r (fragment rows gid), r + 8
  const int r = warp * 16 + gid;
  const int j0 = kv0 + r, j1 = j0 + 8;
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[nd][c] = dv[nd][c] = 0.f;

  for (int q0 = 0; q0 < N; q0 += BQ) {
    // no row of this q tile sees a key of this kv block, and each sees one
    // elsewhere (so its p here is exactly 0): nothing to add
    if (p.causal && q0 + off >= 0 && min(q0 + BQ - 1, N - 1) + off < kv0)
      continue;
    __syncthreads();   // every warp is done with the previous q/g tile
    load_tile<DP>(sQ, q, p.q_s[1], q0, N, D, p.vec, tid);
    load_tile<DP>(sG, g, p.g_s[1], q0, N, D, p.vec, tid);
    if (tid < BQ) {
      const int i = q0 + tid;
      sLse[tid] = i < N ? p.lse[row_off + i] : 0.f;
      sDelta[tid] = i < N ? p.delta[row_off + i] : 0.f;
    }
    __syncthreads();

    float st[8][4], dpt[8][4];   // Sᵀ and dPᵀ: kv rows × 64 queries
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[nt][c] = dpt[nt][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      a_frag(ka, sK + r * LD + kk * 16 + tig * 2, LD);
      a_frag(va, sV + r * LD + kk * 16 + tig * 2, LD);
      mma_rows<DP>(st, ka, sQ, kk, gid, tig);
      mma_rows<DP>(dpt, va, sG, kk, gid, tig);
    }
    // element c of n-tile nt: kv row (c < 2 ? j0 : j1), query
    // q0 + nt·8 + tig·2 + c&1; st becomes pᵀ, dpt becomes dsᵀ
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = c < 2 ? j0 : j1, qi = nt * 8 + tig * 2 + (c & 1);
        const int i = q0 + qi;
        float pv = 0.f, ds = 0.f;
        if (i < N && j < M) {
          if (hidden(p, i, j)) {
            // exact p of a hidden entry: 1/m in a row that sees no key
            pv = i + off < 0 ? 1.f / M : 0.f;
          } else {
            pv = expf(biased(p, bias0, bias1, st[nt][c], i, j) - sLse[qi]);
            ds = pv * (dpt[nt][c] - sDelta[qi]) * p.scale;
          }
        }
        st[nt][c] = pv;
        dpt[nt][c] = ds;
      }
    }
    mma_acc_tile<DP>(dv, st, sG, lane);    // dV += Pᵀ · G
    mma_acc_tile<DP>(dk, dpt, sQ, lane);   // dK += dSᵀ · Q
  }

  bf16* dkp = static_cast<bf16*>(p.dk);
  bf16* dvp = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = nd * 8 + tig * 2 + e;
      if (col >= D) continue;
      if (j0 < M) {
        const long long o = (((long long)b * M + j0) * p.H + h) * D + col;
        dkp[o] = __float2bfloat16(dk[nd][e]);
        dvp[o] = __float2bfloat16(dv[nd][e]);
      }
      if (j1 < M) {
        const long long o = (((long long)b * M + j1) * p.H + h) * D + col;
        dkp[o] = __float2bfloat16(dk[nd][2 + e]);
        dvp[o] = __float2bfloat16(dv[nd][2 + e]);
      }
    }
  }
}


// ============================================ dbias kernels (both dtypes)
//
// blockIdx.x: the kv tile (a bias with a key dim), .y the q tile (one with
// a query dim), .z the kept (batch, head).  Iteration `it` of the block's
// loop names one reduced (batch, head, q tile, kv tile) folding into its
// tile; `DbiasLoop::at` decodes it.

struct DbiasTile {
  int b, h, q0, kv0;
};

struct DbiasLoop {
  bool kb, kh, kq, kk;
  int zb, zh, nb, nh, nq, nk;

  __device__ __forceinline__ DbiasLoop(const Params& p) {
    kb = p.keep & 1;
    kh = p.keep & 2;
    kq = p.keep & 4;
    kk = p.keep & 8;
    const int hk = kh ? p.H : 1;
    zb = blockIdx.z / hk;
    zh = blockIdx.z % hk;
    nb = kb ? 1 : p.B;
    nh = kh ? 1 : p.H;
    nq = kq ? 1 : (p.N + BQ - 1) / BQ;
    nk = kk ? 1 : (p.M + BKV - 1) / BKV;
  }
  __device__ __forceinline__ int count() const { return nb * nh * nq * nk; }
  __device__ __forceinline__ DbiasTile at(int it) const {
    const int ik = it % nk;
    it /= nk;
    const int iq = it % nq;
    it /= nq;
    const int ih = it % nh;
    const int ib = it / nh;
    return {kb ? zb : ib, kh ? zh : ih, (kq ? (int)blockIdx.y : iq) * BQ,
            (kk ? (int)blockIdx.x : ik) * BKV};
  }
};

// no entry of the tile is visible under the causal flag: its ds is all 0
__device__ __forceinline__ bool dbias_skip(const Params& p, const DbiasTile& t) {
  return p.causal && t.kv0 > min(t.q0 + BQ - 1, p.N - 1) + (p.M - p.N);
}

// the block's summed 64 × 64 tile `red` (row stride 65, fp32, in shared
// memory) → dbias: written as it is, or summed over its rows and/or
// columns where the bias has no query and/or key dim
__device__ __forceinline__ void dbias_store(const Params& p, const DbiasLoop& L,
                                            const float* red, int tid) {
  constexpr int LDS = 65;
  const int N = p.N, M = p.M;
  const int hk = L.kh ? p.H : 1, nk = L.kq ? N : 1, mk = L.kk ? M : 1;
  const int q0 = L.kq ? blockIdx.y * BQ : 0, kv0 = L.kk ? blockIdx.x * BKV : 0;
  float* out = p.dbias + ((long long)(L.kb ? L.zb : 0) * hk + (L.kh ? L.zh : 0))
                             * nk * mk;
  if (L.kq && L.kk) {
    for (int e = tid; e < BQ * BKV; e += THREADS) {
      const int r = e / BKV, c = e % BKV, i = q0 + r, j = kv0 + c;
      if (i < N && j < M) out[(long long)i * M + j] = red[r * LDS + c];
    }
  } else if (L.kk) {            // no query dim: sum the rows
    for (int c = tid; c < BKV; c += THREADS) {
      float sum = 0.f;
      for (int r = 0; r < BQ; ++r) sum += red[r * LDS + c];
      if (kv0 + c < M) out[kv0 + c] = sum;
    }
  } else if (L.kq) {            // no key dim: sum the columns
    for (int r = tid; r < BQ; r += THREADS) {
      float sum = 0.f;
      for (int c = 0; c < BKV; ++c) sum += red[r * LDS + c];
      if (q0 + r < N) out[q0 + r] = sum;
    }
  } else if (tid == 0) {        // neither: one sum
    float sum = 0.f;
    for (int r = 0; r < BQ; ++r)
      for (int c = 0; c < BKV; ++c) sum += red[r * LDS + c];
    out[0] = sum;
  }
}

// float32: the dq kernel's lanes and arithmetic (two lanes per row, 32
// keys each), ds summed in acc[32]
template <int DP>
__global__ void __launch_bounds__(THREADS) flash_bwd_dbias_kernel(Params p) {
  constexpr int LD = DP + 1, TILE = 64 * LD;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sG = sQ + TILE;
  float* sK = sG + TILE;
  float* sV = sK + TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int N = p.N, M = p.M, D = p.D;
  const int r = warp * 16 + (lane >> 1), half = lane & 1;
  const DbiasLoop L(p);
  float acc[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) acc[c] = 0.f;

  for (int it = 0; it < L.count(); ++it) {
    const DbiasTile t = L.at(it);
    if (dbias_skip(p, t)) continue;
    const float* q = static_cast<const float*>(p.q) + t.b * p.q_s[0] + t.h * p.q_s[2];
    const float* k = static_cast<const float*>(p.k) + t.b * p.k_s[0] + t.h * p.k_s[2];
    const float* v = static_cast<const float*>(p.v) + t.b * p.v_s[0] + t.h * p.v_s[2];
    const float* g = static_cast<const float*>(p.g) + t.b * p.g_s[0] + t.h * p.g_s[2];
    const float* bias0 = p.bias[0] ? p.bias[0] + t.b * p.bias_s[0][0] + t.h * p.bias_s[0][1] : nullptr;
    const float* bias1 = p.bias[1] ? p.bias[1] + t.b * p.bias_s[1][0] + t.h * p.bias_s[1][1] : nullptr;
    __syncthreads();   // every warp is done with the previous tiles
    load_rows<DP>(sQ, q, p.q_s[1], t.q0, N, D, tid);
    load_rows<DP>(sG, g, p.g_s[1], t.q0, N, D, tid);
    load_rows<DP>(sK, k, p.k_s[1], t.kv0, M, D, tid);
    load_rows<DP>(sV, v, p.v_s[1], t.kv0, M, D, tid);
    __syncthreads();

    float s[32], dp[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) s[c] = dp[c] = 0.f;
    for (int dd = 0; dd < DP; ++dd) {
      const float qv = sQ[r * LD + dd], gv = sG[r * LD + dd];
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        s[c] = fmaf(qv, sK[(half * 32 + c) * LD + dd], s[c]);
        dp[c] = fmaf(gv, sV[(half * 32 + c) * LD + dd], dp[c]);
      }
    }
    const int i = t.q0 + r;
    if (i < N) {
      const long long row = ((long long)t.b * p.H + t.h) * N + i;
      const float lse_i = p.lse[row], delta_i = p.delta[row];
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int j = t.kv0 + half * 32 + c;
        if (j < M && !hidden(p, i, j)) {
          const float pr = expf(biased(p, bias0, bias1, s[c], i, j) - lse_i);
          acc[c] += pr * (dp[c] - delta_i);
        }
      }
    }
  }

  __syncthreads();     // the tiles' shared memory becomes the sum tile
#pragma unroll
  for (int c = 0; c < 32; ++c) smem[r * 65 + half * 32 + c] = acc[c];
  __syncthreads();
  dbias_store(p, L, smem, tid);
}

// bf16: the dq mma kernel's fragments and arithmetic, ds summed in the
// score accumulators' layout acc[8][4]
template <int DP>
__global__ void __launch_bounds__(THREADS) flash_bwd_dbias_mma_kernel(Params p) {
  constexpr int LD = DP + 8, KS = DP / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sG = sQ + BQ * LD;
  bf16* sK = sG + BQ * LD;
  bf16* sV = sK + BKV * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int N = p.N, M = p.M, D = p.D;
  const int r = warp * 16 + gid;   // this thread's rows: r and r + 8
  const DbiasLoop L(p);
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;

  for (int it = 0; it < L.count(); ++it) {
    const DbiasTile t = L.at(it);
    if (dbias_skip(p, t)) continue;
    const bf16* q = static_cast<const bf16*>(p.q) + t.b * p.q_s[0] + t.h * p.q_s[2];
    const bf16* k = static_cast<const bf16*>(p.k) + t.b * p.k_s[0] + t.h * p.k_s[2];
    const bf16* v = static_cast<const bf16*>(p.v) + t.b * p.v_s[0] + t.h * p.v_s[2];
    const bf16* g = static_cast<const bf16*>(p.g) + t.b * p.g_s[0] + t.h * p.g_s[2];
    const float* bias0 = p.bias[0] ? p.bias[0] + t.b * p.bias_s[0][0] + t.h * p.bias_s[0][1] : nullptr;
    const float* bias1 = p.bias[1] ? p.bias[1] + t.b * p.bias_s[1][0] + t.h * p.bias_s[1][1] : nullptr;
    __syncthreads();   // every warp is done with the previous tiles
    load_tile<DP>(sQ, q, p.q_s[1], t.q0, N, D, p.vec, tid);
    load_tile<DP>(sG, g, p.g_s[1], t.q0, N, D, p.vec, tid);
    load_tile<DP>(sK, k, p.k_s[1], t.kv0, M, D, p.vec, tid);
    load_tile<DP>(sV, v, p.v_s[1], t.kv0, M, D, p.vec, tid);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = dp[nt][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], ga[4];
      a_frag(qa, sQ + r * LD + kk * 16 + tig * 2, LD);
      a_frag(ga, sG + r * LD + kk * 16 + tig * 2, LD);
      mma_rows<DP>(s, qa, sK, kk, gid, tig);
      mma_rows<DP>(dp, ga, sV, kk, gid, tig);
    }
    const int i0 = t.q0 + r, i1 = i0 + 8;
    const long long row_off = ((long long)t.b * p.H + t.h) * N;
    const float lse[2] = {i0 < N ? p.lse[row_off + i0] : 0.f,
                          i1 < N ? p.lse[row_off + i1] : 0.f};
    const float delta[2] = {i0 < N ? p.delta[row_off + i0] : 0.f,
                            i1 < N ? p.delta[row_off + i1] : 0.f};
    // element c of n-tile nt: row (c < 2 ? i0 : i1), key nt·8 + tig·2 + c&1
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c < 2 ? i0 : i1, j = t.kv0 + nt * 8 + tig * 2 + (c & 1);
        if (i < N && j < M && !hidden(p, i, j)) {
          const float pr = expf(biased(p, bias0, bias1, s[nt][c], i, j)
                                - lse[c >> 1]);
          acc[nt][c] += pr * (dp[nt][c] - delta[c >> 1]);
        }
      }
    }
  }

  __syncthreads();     // the tiles' shared memory becomes the sum tile
  float* red = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      red[(r + (c < 2 ? 0 : 8)) * 65 + nt * 8 + tig * 2 + (c & 1)] = acc[nt][c];
  __syncthreads();
  dbias_store(p, L, red, tid);
}

template <typename Kernel>
int launch(Kernel kernel, int smem_bytes, dim3 grid, const Params& p,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, smem_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

enum Which { DQ, DKV, DBIAS };

template <int DP>
int launch_dp(Which which, bool is_bf16, const Params& p, cudaStream_t stream) {
  const int f32_bytes = Layout<DP>::BYTES;
  // bf16: four 64 × (DP + 8) tiles, and the q tile's lse and delta
  const int bf16_bytes = 4 * 64 * (DP + 8) * 2 + 2 * 64 * 4;
  if (which == DQ) {
    const dim3 grid((p.N + BQ - 1) / BQ, p.H, p.B);
    return is_bf16 ? launch(flash_bwd_dq_mma_kernel<DP>, bf16_bytes, grid, p, stream)
                   : launch(flash_bwd_dq_kernel<DP>, f32_bytes, grid, p, stream);
  }
  if (which == DBIAS) {
    // four q/g/k/v tiles; the 64 × 65 fp32 sum tile reuses them
    const bool kb = p.keep & 1, kh = p.keep & 2, kq = p.keep & 4,
               kk = p.keep & 8;
    const dim3 grid(kk ? (p.M + BKV - 1) / BKV : 1,
                    kq ? (p.N + BQ - 1) / BQ : 1,
                    (kb ? p.B : 1) * (kh ? p.H : 1));
    return is_bf16
        ? launch(flash_bwd_dbias_mma_kernel<DP>, 4 * 64 * (DP + 8) * 2, grid, p,
                 stream)
        : launch(flash_bwd_dbias_kernel<DP>, 4 * Layout<DP>::TILE * 4, grid, p,
                 stream);
  }
  const dim3 grid((p.M + BKV - 1) / BKV, p.H, p.B);
  return is_bf16 ? launch(flash_bwd_dkv_mma_kernel<DP>, bf16_bytes, grid, p, stream)
                 : launch(flash_bwd_dkv_kernel<DP>, f32_bytes, grid, p, stream);
}

Params make_params(const void* q, const void* k, const void* v, const void* g,
                   const void* lse, const void* delta, const void* bias0,
                   const void* bias1, const long long* strides, int B, int N,
                   int M, int H, int D, float scale, int causal, int vec) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.g = g;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = p.dk = p.dv = nullptr;
  p.dbias = nullptr;
  p.keep = 0;
  p.bias[0] = static_cast<const float*>(bias0);
  p.bias[1] = static_cast<const float*>(bias1);
  for (int t = 0; t < 3; ++t) {
    p.q_s[t] = strides[t];
    p.k_s[t] = strides[3 + t];
    p.v_s[t] = strides[6 + t];
    p.g_s[t] = strides[17 + t];
  }
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
  p.vec = vec;
  return p;
}

int dispatch(Which which, int is_bf16, const Params& p, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf = is_bf16 != 0;
  if (p.D <= 32) return launch_dp<32>(which, bf, p, st);
  if (p.D <= 64) return launch_dp<64>(which, bf, p, st);
  if (p.D <= 96) return launch_dp<96>(which, bf, p, st);
  if (p.D <= 128) return launch_dp<128>(which, bf, p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry points (bound with ctypes).  strides holds 20 int64 values: q
// (b, n, h), k (b, m, h), v (b, m, h), bias0 (b, h, n, m), bias1 (b, h, n,
// m), g (b, n, h) — the forward's 17, then g's.  lse and delta are
// contiguous (b, h, n) float32; dq is a contiguous (b, n, h, d) tensor of
// q's dtype, dk and dv contiguous (b, m, h, d).  `vec` promises 16-byte
// aligned bf16 rows (d % 8 == 0, aligned bases, strides multiples of 8).
// dbias is a contiguous float32 tensor at its bias's shape; `keep` names
// the axes the bias keeps (bits: b 1, h 2, n 4, m 8), every other axis is
// summed.  Each returns cudaGetLastError() after its launch (or the attribute
// call's error).
extern "C" int flash_attention_bwd_dq(int is_bf16, const void* q, const void* k,
                                      const void* v, const void* g,
                                      const void* lse, const void* delta,
                                      void* dq, const void* bias0,
                                      const void* bias1,
                                      const long long* strides, int B, int N,
                                      int M, int H, int D, float scale,
                                      int causal, int vec, void* stream) {
  Params p = make_params(q, k, v, g, lse, delta, bias0, bias1, strides, B, N,
                         M, H, D, scale, causal, vec);
  p.dq = dq;
  return dispatch(DQ, is_bf16, p, stream);
}

extern "C" int flash_attention_bwd_dkv(int is_bf16, const void* q,
                                       const void* k, const void* v,
                                       const void* g, const void* lse,
                                       const void* delta, void* dk, void* dv,
                                       const void* bias0, const void* bias1,
                                       const long long* strides, int B, int N,
                                       int M, int H, int D, float scale,
                                       int causal, int vec, void* stream) {
  Params p = make_params(q, k, v, g, lse, delta, bias0, bias1, strides, B, N,
                         M, H, D, scale, causal, vec);
  p.dk = dk;
  p.dv = dv;
  return dispatch(DKV, is_bf16, p, stream);
}

extern "C" int flash_attention_bwd_dbias(int is_bf16, const void* q,
                                         const void* k, const void* v,
                                         const void* g, const void* lse,
                                         const void* delta, void* dbias,
                                         int keep, const void* bias0,
                                         const void* bias1,
                                         const long long* strides, int B,
                                         int N, int M, int H, int D,
                                         float scale, int causal, int vec,
                                         void* stream) {
  Params p = make_params(q, k, v, g, lse, delta, bias0, bias1, strides, B, N,
                         M, H, D, scale, causal, vec);
  p.dbias = static_cast<float*>(dbias);
  p.keep = keep;
  return dispatch(DBIAS, is_bf16, p, stream);
}
