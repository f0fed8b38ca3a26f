// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (vlm_compression_tpu/ops/attention.py:107, launched by
// `_flash_attention_pallas`).  Same contract:
//   s   = (q · kᵀ) * scale + Σ bias_i          (fp32)
//   s   = NEG_INF where causal hides a key      (right-aligned: j ≤ i + m − n)
//   p   = softmax(s)                            (fp32, online)
//   out = p.astype(v.dtype) · v                 (fp32 accumulate)
// plus the per-row log-sum-exp.  q is (b, n, h, d), k/v (b, m, h, d), read
// through their strides (the last dim must be contiguous), so head splits
// and fused-qkv slices need no copies.  Up to two additive fp32 biases are
// read at their broadcast shape through four strides each (0 on size-1
// axes): nothing of size (b, h, n, m) is ever materialized.
//
// What bounds it on an H100: at the towers' shapes (d = 64 or 88, n and m
// in the hundreds) the q/k/v/out bytes bound it (4·b·h·n·m·d operations
// are few next to 989 TFLOP/s); at decode steps (n = 1) reading k and v.
//
// Design: one block of 4 warps per (q tile of 64 rows, head, batch).  On
// the TPU the kv grid dimension ran in order and carried the online-softmax
// state in VMEM scratch; Hopper blocks run in no order, so a loop over kv
// tiles of 64 inside the block carries that state.  In bf16 each warp owns
// 16 query rows and keeps everything of them in registers, in the layout
// of the tensor cores' mma.sync m16n8k16: the q fragments, the 16×64 score
// tile, the running max and sum, and the output accumulators.  The score
// accumulators are exactly the A operand of P·V once cast to bf16, so P
// never leaves registers; only the k and v tiles pass through shared
// memory (v is read transposed with ldmatrix).  float32 keeps scores and
// output rows in shared memory and multiplies on the CUDA cores (no TF32).
// The head dim is padded to a multiple of 32 in shared memory only (d = 88
// runs as 96), never in device memory.  A causal call skips kv tiles that
// lie wholly above the diagonal — only when every row of the block sees at
// least one key, so rows with no visible key (n > m) keep the reference's
// uniform average over NEG_INF scores instead of a 0/0.
//
// Not yet done (later PRs): TMA + wgmma with a kv pipeline, a split-kv
// decode path for n = 1.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64, BKV = 64, THREADS = 128;
constexpr float NEG_INF = -1e9f;    // the towers' additive-mask constant
constexpr float M_INIT = -1e30f;    // running-max start, as on the TPU

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  const float* bias[2];
  long long q_s[3], k_s[3], v_s[3];  // strides of (batch, seq, head)
  long long bias_s[2][4];            // strides of (b, h, n, m)
  int B, N, M, H, D;
  float scale;
  int causal;
  int vec;   // 16-byte loads: d % 8 == 0, aligned bases and strides
};

constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

// last kv column (exclusive) any row of the block can see; every row of a
// block with q0 + off >= 0 sees key 0, and past the block's last visible
// key the scores are NEG_INF (exp → 0 exactly)
__device__ __forceinline__ int kv_limit(const Params& p, int q0) {
  const int off = p.M - p.N;
  if (p.causal && q0 + off >= 0)
    return min(p.M, min(q0 + BQ - 1, p.N - 1) + off + 1);
  return p.M;
}

// score of (row i, key j) after scale, biases and causal masking
__device__ __forceinline__ float biased_score(const Params& p, const float* b0,
                                              const float* b1, float acc,
                                              int i, int j) {
  float x = acc * p.scale;
  if (i < p.N) {
    if (b0) x += b0[i * p.bias_s[0][2] + j * p.bias_s[0][3]];
    if (b1) x += b1[i * p.bias_s[1][2] + j * p.bias_s[1][3]];
    if (p.causal && j > i + (p.M - p.N)) x = NEG_INF;
  }
  return x;
}

// =========================================================== bf16 (mma.sync)

union Pack8 {
  uint4 u;
  uint16_t h[8];   // bf16 bit patterns
};

// rows [row0, row0 + 64) of a (seq, d) slice with row stride `rs` into a
// 64 × DP shared tile; rows ≥ rows_valid and columns ≥ d read as zeros
template <int DP>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, long long rs,
                                          int row0, int rows_valid, int d,
                                          bool vec, int tid) {
  constexpr int LD = DP + 8, CH = DP / 8;
  for (int c = tid; c < BQ * CH; c += THREADS) {
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

template <int DP>
__global__ void __launch_bounds__(THREADS) flash_fwd_bf16_kernel(Params p) {
  constexpr int LD = DP + 8, KS = DP / 16, NT = BKV / 8, ND = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LD;
  bf16* sV = sK + BKV * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;   // mma fragment coordinates
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_s[0] + h * p.q_s[2];
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_s[0] + h * p.k_s[2];
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_s[0] + h * p.v_s[2];
  const float* bias0 = p.bias[0] ? p.bias[0] + b * p.bias_s[0][0] + h * p.bias_s[0][1] : nullptr;
  const float* bias1 = p.bias[1] ? p.bias[1] + b * p.bias_s[1][0] + h * p.bias_s[1][1] : nullptr;

  load_tile<DP>(sQ, q, p.q_s[1], q0, p.N, p.D, p.vec, tid);
  __syncthreads();
  // this thread's rows of the warp's 16: r (fragment rows gid) and r + 8
  const int r = warp * 16 + gid;
  const int i0 = q0 + r, i1 = i0 + 8;
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const bf16* base = sQ + r * LD + kk * 16 + tig * 2;
    qa[kk][0] = lds32(base);
    qa[kk][1] = lds32(base + 8 * LD);
    qa[kk][2] = lds32(base + 8);
    qa[kk][3] = lds32(base + 8 * LD + 8);
  }

  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m_run[2] = {M_INIT, M_INIT}, l_run[2] = {0.f, 0.f};

  const int kv_end = kv_limit(p, q0);
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();   // every warp is done with the previous k/v tile
    load_tile<DP>(sK, k, p.k_s[1], kv0, p.M, p.D, p.vec, tid);
    load_tile<DP>(sV, v, p.v_s[1], kv0, p.M, p.D, p.vec, tid);
    __syncthreads();

    // S = Q · Kᵀ: the B operand (d × kv) is K's rows, read as 32-bit pairs
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* kb = sK + (nt * 8 + gid) * LD + kk * 16 + tig * 2;
        mma_bf16(s[nt], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3],
                 lds32(kb), lds32(kb + 8));
      }
    }

    // online softmax; element c of n-tile nt is row (c < 2 ? i0 : i1),
    // key kv0 + nt·8 + tig·2 + (c & 1); a row spans the 4 lanes of a group
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = kv0 + nt * 8 + tig * 2 + (c & 1);
        float x = -INFINITY;   // past the last key: exp → 0
        if (j < p.M) {
          x = biased_score(p, bias0, bias1, s[nt][c], c < 2 ? i0 : i1, j);
          mx[c >> 1] = fmaxf(mx[c >> 1], x);
        }
        s[nt][c] = x;
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m_run[rr], mx[rr]);
      alpha[rr] = expf(m_run[rr] - m_new);
      m_run[rr] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[nt][c] = expf(s[nt][c] - m_run[c >> 1]);
        sum[c >> 1] += s[nt][c];
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 1);
      sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 2);
      l_run[rr] = l_run[rr] * alpha[rr] + sum[rr];
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
    }

    // O += P · V: the score accumulators of n-tiles 2t, 2t+1 are the A
    // operand of k-step t once cast to bf16
#pragma unroll
    for (int t = 0; t < BKV / 16; ++t) {
      const uint32_t a0 = pack_bf16(s[2 * t][0], s[2 * t][1]);
      const uint32_t a1 = pack_bf16(s[2 * t][2], s[2 * t][3]);
      const uint32_t a2 = pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3]);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, sV + (t * 16 + (lane & 15)) * LD + nd * 8);
        mma_bf16(o[nd], a0, a1, a2, a3, b0, b1);
      }
    }
  }

  // rows that saw only NEG_INF scores have l ≥ 1 (uniform average), so
  // the division is safe for every real row
  bf16* out = static_cast<bf16*>(p.out);
  const int d = p.D;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = nd * 8 + tig * 2 + e;
      if (col >= d) continue;
      if (i0 < p.N)
        out[(((long long)b * p.N + i0) * p.H + h) * d + col] =
            __float2bfloat16(o[nd][e] / l_run[0]);
      if (i1 < p.N)
        out[(((long long)b * p.N + i1) * p.H + h) * d + col] =
            __float2bfloat16(o[nd][2 + e] / l_run[1]);
    }
  }
  if (tig == 0) {
    if (i0 < p.N) p.lse[((long long)b * p.H + h) * p.N + i0] = m_run[0] + logf(l_run[0]);
    if (i1 < p.N) p.lse[((long long)b * p.H + h) * p.N + i1] = m_run[1] + logf(l_run[1]);
  }
}

// ====================================================== float32 (CUDA cores)

template <int DP>
struct F32Layout {
  static constexpr int LDT = DP + 8;    // q/k/v tile rows
  static constexpr int LDS = BKV + 4;   // scores; also the probabilities
  static constexpr int LDO = DP + 4;    // output accumulator
  static constexpr int Q = 0;
  static constexpr int K = Q + align128(BQ * LDT * 4);
  static constexpr int V = K + align128(BKV * LDT * 4);
  static constexpr int S = V + align128(BKV * LDT * 4);
  static constexpr int O = S + align128(BQ * LDS * 4);
  static constexpr int STATS = O + align128(BQ * LDO * 4);
  static constexpr int BYTES = STATS + align128(3 * BQ * 4);
};

template <int DP>
__global__ void __launch_bounds__(THREADS) flash_fwd_f32_kernel(Params p) {
  using L = F32Layout<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::Q);
  float* sK = reinterpret_cast<float*>(smem + L::K);
  float* sV = reinterpret_cast<float*>(smem + L::V);
  float* sS = reinterpret_cast<float*>(smem + L::S);
  float* sO = reinterpret_cast<float*>(smem + L::O);
  float* sM = reinterpret_cast<float*>(smem + L::STATS);
  float* sL = sM + BQ;
  float* sA = sL + BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int N = p.N, M = p.M, D = p.D;
  const float* q = static_cast<const float*>(p.q) + b * p.q_s[0] + h * p.q_s[2];
  const float* k = static_cast<const float*>(p.k) + b * p.k_s[0] + h * p.k_s[2];
  const float* v = static_cast<const float*>(p.v) + b * p.v_s[0] + h * p.v_s[2];
  const float* bias0 = p.bias[0] ? p.bias[0] + b * p.bias_s[0][0] + h * p.bias_s[0][1] : nullptr;
  const float* bias1 = p.bias[1] ? p.bias[1] + b * p.bias_s[1][0] + h * p.bias_s[1][1] : nullptr;

  for (int e = tid; e < BQ * DP; e += THREADS) {
    const int r = e / DP, c = e % DP, i = q0 + r;
    sQ[r * L::LDT + c] = (i < N && c < D) ? q[i * p.q_s[1] + c] : 0.f;
    sO[r * L::LDO + c] = 0.f;
  }
  if (tid < BQ) {
    sM[tid] = M_INIT;
    sL[tid] = 0.f;
  }
  __syncthreads();

  // each warp owns 16 rows: two lanes per row, 32 columns each
  const int r = warp * 16 + (lane >> 1), half = lane & 1, i = q0 + r;
  const int kv_end = kv_limit(p, q0);
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    for (int e = tid; e < BKV * DP; e += THREADS) {
      const int rr = e / DP, c = e % DP, j = kv0 + rr;
      const bool ok = j < M && c < D;
      sK[rr * L::LDT + c] = ok ? k[j * p.k_s[1] + c] : 0.f;
      sV[rr * L::LDT + c] = ok ? v[j * p.v_s[1] + c] : 0.f;
    }
    __syncthreads();

    float s[32];
    float mx = M_INIT;
#pragma unroll
    for (int c = 0; c < 32; ++c) s[c] = 0.f;
    for (int dd = 0; dd < DP; ++dd) {
      const float qv = sQ[r * L::LDT + dd];
#pragma unroll
      for (int c = 0; c < 32; ++c)
        s[c] = fmaf(qv, sK[(half * 32 + c) * L::LDT + dd], s[c]);
    }
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int j = kv0 + half * 32 + c;
      float x = -INFINITY;
      if (j < M) {
        x = biased_score(p, bias0, bias1, s[c], i, j);
        mx = fmaxf(mx, x);
      }
      s[c] = x;
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_old = sM[r];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float e = expf(s[c] - m_new);
      sS[r * L::LDS + half * 32 + c] = e;
      sum += e;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = expf(m_old - m_new);
    __syncwarp();
    if (half == 0) {
      sM[r] = m_new;
      sL[r] = sL[r] * alpha + sum;
      sA[r] = alpha;
    }
    __syncwarp();
    for (int c = half * (DP / 2); c < (half + 1) * (DP / 2); ++c) {
      float acc = 0.f;
      for (int kk = 0; kk < BKV; ++kk)
        acc = fmaf(sS[r * L::LDS + kk], sV[kk * L::LDT + c], acc);
      sO[r * L::LDO + c] = sO[r * L::LDO + c] * sA[r] + acc;
    }
    __syncthreads();
  }

  float* out = static_cast<float*>(p.out);
  for (int e = tid; e < BQ * DP; e += THREADS) {
    const int rr = e / DP, c = e % DP, ii = q0 + rr;
    if (ii < N && c < D)
      out[(((long long)b * N + ii) * p.H + h) * D + c] = sO[rr * L::LDO + c] / sL[rr];
  }
  if (tid < BQ && q0 + tid < N)
    p.lse[((long long)b * p.H + h) * N + q0 + tid] = sM[tid] + logf(sL[tid]);
}

template <typename Kernel>
int launch(Kernel kernel, int smem_bytes, const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.N + BQ - 1) / BQ, p.H, p.B);
  kernel<<<grid, THREADS, smem_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dp(bool is_bf16, const Params& p, cudaStream_t stream) {
  if (is_bf16)
    return launch(flash_fwd_bf16_kernel<DP>, 3 * BQ * (DP + 8) * 2, p, stream);
  return launch(flash_fwd_f32_kernel<DP>, F32Layout<DP>::BYTES, p, stream);
}

}  // namespace

// C entry point (bound with ctypes).  strides holds 17 int64 values:
// q (b, n, h), k (b, m, h), v (b, m, h), bias0 (b, h, n, m), bias1 (b, h,
// n, m).  out is a contiguous (b, n, h, d) tensor of q's dtype, lse a
// contiguous (b, h, n) float32 tensor.  `vec` promises 16-byte aligned
// bf16 rows (d % 8 == 0, aligned bases, strides multiples of 8).  Returns
// cudaGetLastError() after the launch (or the attribute call's error).
extern "C" int flash_attention_fwd(int is_bf16, const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   const void* bias0, const void* bias1,
                                   const long long* strides, int B, int N, int M,
                                   int H, int D, float scale, int causal,
                                   int vec, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.bias[0] = static_cast<const float*>(bias0);
  p.bias[1] = static_cast<const float*>(bias1);
  for (int t = 0; t < 3; ++t) {
    p.q_s[t] = strides[t];
    p.k_s[t] = strides[3 + t];
    p.v_s[t] = strides[6 + t];
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf = is_bf16 != 0;
  if (D <= 32) return launch_dp<32>(bf, p, st);
  if (D <= 64) return launch_dp<64>(bf, p, st);
  if (D <= 96) return launch_dp<96>(bf, p, st);
  if (D <= 128) return launch_dp<128>(bf, p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
