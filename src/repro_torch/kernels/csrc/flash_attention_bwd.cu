// Exact attention backward for Hopper (sm_90a), B4': the vector-Jacobian
// product of flash_attention.cu's forward, with its masks (causal, sliding
// window), grouped-query / multi-query heads and tanh soft-capping.
//
// Replaces no TPU kernel: the JAX package differentiates its XLA attention
// (attention_chunked / attention_reference) and has no backward kernel.
// This one replaces autograd's VJP through the port's plain version, which
// materialises (B, H, S, T) scores. q (B, S, H, hd), k and v (B, T, K, hd)
// and g (B, S, H, hd), the cotangent of the output, all contiguous and of
// one type, f32 or bf16, positions from 0 -> dq, dk, dv in that type. With
// q_scaled = q * scale rounded to the storage type (the forward's rounding)
// and everything else in f32, per query row:
//
//   s_t  = q_scaled . k_t, soft-capped: c * tanh(s_t / c), masked: no term
//   P_t  = exp(s_t - lse),  lse = log sum_t exp(s_t)
//   dP_t = g . v_t,  D = sum_t P_t dP_t,  dS_t = P_t (dP_t - D) (1 - tanh^2)
//   dV_t += P_t g,  dK_t += dS_t q_scaled,  dQ = scale * sum_t dS_t k_t
//
// summed over the H / K query heads that read a kv head. D is taken as
// sum_t P_t dP_t and not as rowsum(g * out): the bf16 output is rounded,
// and in D that rounding would fall on the difference dP_t - D.
//
// Bound: operations. Per visible (query, key) pair per (batch, q head) the
// gradient needs five products of length hd (q.k, g.v, and the three
// accumulations), 10 * hd flops; the data are read or written once. Both
// paths do 18 * hd: the dq grid's lse / D walk (4 hd), its dq walk (6 hd),
// the dk/dv grid (8 hd; 12 hd at head_dim 256 in bf16, see below).
//
// Both paths use no atomics, so two launches on the same inputs give the
// same bits (the captured training programs are held == their eager
// runs). One entry point a type, three grids in order on the caller's
// stream: a dq grid, which also writes each row's lse and D to stats; a
// dk/dv grid, which reads them; and flash_attention_bwd_reduce_kernel.
// The dk/dv grid splits a kv head's q heads over `splits` blocks where
// the kv tiles alone would leave most of the 132 SMs idle (MQA: one kv
// head for 16 q heads); every block writes its f32 sums and the reduce
// grid adds a tile's splits in split order and rounds once.
//
// bf16: the tensor-core kernels (namespace tc), built from the forward's
// machinery (hopper_common.cuh: TMA, mbarriers, wgmma descriptors).
// - Warp specialisation: one producer warpgroup (setmaxnreg 24; one thread
//   issues every TMA load over the forward's 4-d maps) feeds two consumer
//   warpgroups (setmaxnreg 240) through a ring of 2 stages, each with full
//   and empty mbarriers, so the next tile lands while this one is used.
// - dq grid (flash_attention_bwd_dq_kernel_tc), a block per (q head, 128
//   query rows, batch row), 64 rows a consumer (one consumer of 64 rows at
//   head_dim 256, where q, g and the two rings fill 192 KB): q and g
//   loaded once, q scaled in place and written unswizzled to the qs
//   scratch for the dk/dv grid; the kv tiles that the masks leave visible
//   stream twice. Walk 1: S = q k^T and dP = g v^T, m64n64k16 with both
//   operands in shared memory (K-major), into lse and D online. Walk 2:
//   S and dP again, dS = P (dP - D) (1 - tanh^2) in registers, dQ += dS k
//   as m64n{hd}k16 with dS from registers (the score fragment is the A
//   layout) and k read MN-major, as the forward reads v in P v.
// - dk/dv grid (flash_attention_bwd_dkdv_kernel_tc), a block per (128
//   keys, kv head, batch row and split), 64 keys a consumer: k and v
//   loaded once; q_scaled, g and the 64 rows' lse and D (a plain bulk
//   copy, stats padded to 64 rows a head) stream through the ring for each
//   q head and query tile the masks leave visible. S^T = k q_scaled^T and
//   dP^T = v g^T (K-major), then dV += P^T g and dK += dS^T q_scaled with
//   g and q_scaled read MN-major. At head_dim 256 a block holds 64 keys
//   and each consumer half of head_dim (m64n128 accumulators: two m64n256
//   ones would need 256 registers a thread), both computing S^T and dP^T.
// - P and dS enter their products rounded to bf16 once (kSplitP,
//   kSplitDS: the forward's hi + lo split, kept off; PERF.md has the
//   measurement); every sum is f32.
// - Softcap (the forward's tanh_exp) and the masks are evaluated only on
//   tiles that cross the causal diagonal, the window's edge, S or T; a
//   tile that no row of a consumer sees is waited for and released but
//   not computed. Rows past S and T arrive as zeros and are masked out of
//   lse, D and the sums.
// - head_dim pads to a multiple of 8 in the wrapper (TMA rows are 16-byte
//   multiples), to 64, 128 or 256 in the TMA boxes.
//
// f32: the SIMT kernels (TF32 would not meet the f32 gate of 1e-4): tiles
// f32 in shared memory, rows padded by 4 floats: q, g (BQ x hd) and k, v
// (64 x hd) with BQ = 64 query rows, or 32 at hd 256 to stay within the
// 227 KB a block may use; the 16 x 16 threads own 4 (or 2) rows of the
// score tile each and reduce a row's max and sums over the half warp that
// shares it, as the forward's SIMT kernel does. The dq grid's first walk
// computes lse and D, its second dq; the dk/dv grid's block keeps its 64
// keys' k and v and walks its q heads and query tiles. Tiles arrive by
// 16-byte loads, four in flight a thread (one element at a time where
// head_dim is not a multiple of 4), a warp reading consecutive columns;
// a block waits for each tile (no ring).
// Shapes: head_dim <= 256 (the wrapper refuses more by name), kv head and
// batch counts <= 65535 (grid y and z), S and T < 2^30.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

#include "hopper_common.cuh"

namespace repro_torch {
namespace {

constexpr int kBK = 64;         // keys per kv tile
constexpr int kThreads = 256;   // a 16 x 16 grid of threads

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ void st(float v, float* p) { *p = v; }
__device__ __forceinline__ void st(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// 16 bytes of one row as f32
__device__ __forceinline__ void unpack(uint4 raw, float (&x)[4], const float*) {
  const float4 f = *reinterpret_cast<const float4*>(&raw);
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}

// rows [r0, r0 + ROWS) of one head of a (batch, seq, heads, hd) tensor into
// a shared tile of ROWS x LD floats, zeros past n_rows and hd; q rows are
// scaled and rounded to the storage type as the forward rounds q_scaled.
// vec (hd a multiple of 16 bytes, 16-byte aligned bases): 16-byte loads,
// kLoads of them in flight a thread; else one element a thread at a time.
template <typename T, int HDP, int ROWS, bool kScale>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0,
                                          int n_rows, int64_t row_stride,
                                          int hd, float scale, bool vec) {
  constexpr int LD = HDP + 4;
  if (vec) {
    constexpr int E = 16 / sizeof(T);          // elements a load
    constexpr int CPR = HDP / E;               // loads a row
    constexpr int N = ROWS * CPR / kThreads;   // loads a thread
    constexpr int G = N < 4 ? N : 4;           // of them in flight
    static_assert(N % G == 0, "whole groups of loads");
#pragma unroll
    for (int j0 = 0; j0 < N; j0 += G) {
      uint4 raw[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int c = threadIdx.x + (j0 + j) * kThreads;
        const int r = c / CPR, d = (c % CPR) * E;
        raw[j] = make_uint4(0u, 0u, 0u, 0u);
        if (r0 + r < n_rows && d < hd)
          raw[j] = *reinterpret_cast<const uint4*>(
              src + (r0 + r) * row_stride + d);
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int c = threadIdx.x + (j0 + j) * kThreads;
        const int r = c / CPR, d = (c % CPR) * E;
        float x[E];
        unpack(raw[j], x, src);
        if (kScale) {
#pragma unroll
          for (int e = 0; e < E; ++e)
            x[e] = round_to(__fmul_rn(x[e], scale), src);
        }
#pragma unroll
        for (int e = 0; e < E; e += 4)
          *reinterpret_cast<float4*>(dst + r * LD + d + e) =
              make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < ROWS * HDP; i += kThreads) {
    const int r = i / HDP, d = i % HDP;
    float x = 0.f;
    if (r0 + r < n_rows && d < hd) {
      x = ld(src + (r0 + r) * row_stride + d);
      if (kScale) x = round_to(__fmul_rn(x, scale), src);
    }
    dst[r * LD + d] = x;
  }
}

__device__ __forceinline__ bool visible(int qp, int kp, int S, int T_len,
                                        int causal, int window) {
  return qp < S && kp < T_len && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}

template <int HDP>
__host__ __device__ constexpr int block_q() { return HDP == 256 ? 32 : 64; }

template <int HDP>
constexpr size_t dq_smem() {
  return ((2 * block_q<HDP>() + 2 * kBK) * (HDP + 4) +
          block_q<HDP>() * (kBK + 4)) * sizeof(float);
}

template <int HDP>
constexpr size_t dkdv_smem() {
  return ((2 * block_q<HDP>() + 2 * kBK) * (HDP + 4) +
          2 * kBK * (block_q<HDP>() + 4) + 2 * block_q<HDP>()) *
         sizeof(float);
}

// ---------------------------------------------------------------------------
// dq, with each row's lse and D
// ---------------------------------------------------------------------------

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dq_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ g, T* __restrict__ dq,
        float* __restrict__ stats, int B, int S, int T_len, int H, int K,
        int hd, int causal, int window, float softcap, float scale,
        int vec) {
  constexpr int BQ = block_q<HDP>();
  constexpr int RM = BQ / 16;     // score rows per thread
  constexpr int LD = HDP + 4;
  constexpr int LDS = kBK + 4;
  constexpr int NJ = HDP / 64;    // 4-wide dq column groups per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sG = sQ + BQ * LD;
  float* sK = sG + BQ * LD;
  float* sV = sK + kBK * LD;
  float* sDS = sV + kBK * LD;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int group = H / K;
  const int64_t qstride = static_cast<int64_t>(H) * hd;
  const int64_t kstride = static_cast<int64_t>(K) * hd;
  const T* qb = q + bi * S * qstride + static_cast<int64_t>(h) * hd;
  const T* gb = g + bi * S * qstride + static_cast<int64_t>(h) * hd;
  const T* kb = k + bi * T_len * kstride + static_cast<int64_t>(h / group) * hd;
  const T* vb = v + bi * T_len * kstride + static_cast<int64_t>(h / group) * hd;

  load_rows<T, HDP, BQ, true>(sQ, qb, q0, S, qstride, hd, scale, vec);
  load_rows<T, HDP, BQ, false>(sG, gb, q0, S, qstride, hd, scale, vec);

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_hi = causal ? min(T_len - 1, q_last) : T_len - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_first = k_lo / kBK;
  const int kt_last = k_hi >= k_lo ? k_hi / kBK : kt_first - 1;

  // scores and dP of this thread's RM x 4 entries of one kv tile; the
  // soft-capped score in s, tanh in th, visibility in the mask bits
  auto tile = [&](int k0, float (&s)[RM][4], float (&dp)[RM][4],
                  float (&th)[RM][4], unsigned (&ok)[RM]) {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HDP; d += 4) {
      float4 kv[4], vv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ld4(sK + (tx + 16 * j) * LD + d);
        vv[j] = ld4(sV + (tx + 16 * j) * LD + d);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 qv = ld4(sQ + (ty * RM + i) * LD + d);
        const float4 gv = ld4(sG + (ty * RM + i) * LD + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = dot4(qv, kv[j], s[i][j]);
          dp[i][j] = dot4(gv, vv[j], dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qp = q0 + ty * RM + i;
      ok[i] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        th[i][j] = 0.f;
        if (softcap > 0.f) {
          th[i][j] = tanhf(s[i][j] / softcap);
          s[i][j] = softcap * th[i][j];
        }
        ok[i] |= static_cast<unsigned>(
                     visible(qp, kp, S, T_len, causal, window)) << j;
      }
    }
  };

  auto load_kv = [&](int k0) {
    __syncthreads();    // the previous tile's reads are done
    load_rows<T, HDP, kBK, false>(sK, kb, k0, T_len, kstride, hd, scale,
                                  vec);
    load_rows<T, HDP, kBK, false>(sV, vb, k0, T_len, kstride, hd, scale,
                                  vec);
    __syncthreads();
  };

  // walk 1: lse and D, online
  float m[RM], l[RM], dn[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = dn[i] = 0.f;
  }
  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k0 = kt * kBK;
    load_kv(k0);
    float s[RM][4], dp[RM][4], th[RM][4];
    unsigned ok[RM];
    tile(k0, s, dp, th, ok);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mt = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if ((ok[i] >> j) & 1u) mt = fmaxf(mt, s[i][j]);
      const float m_new = fmaxf(m[i], half_warp_max(mt));
      // while m is -inf, l and the sum of P dP are 0 and stay so; every
      // thread of the warp takes the shuffles below
      const float corr = m[i] == -CUDART_INF_F ? 0.f : expf(m[i] - m_new);
      float ls = 0.f, ds = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if ((ok[i] >> j) & 1u) {
          const float p = expf(s[i][j] - m_new);
          ls += p;
          ds = fmaf(p, dp[i][j], ds);
        }
      l[i] = l[i] * corr + half_warp_sum(ls);
      dn[i] = dn[i] * corr + half_warp_sum(ds);
      m[i] = m_new;
    }
  }
  float lse[RM], dd[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const bool any = l[i] > 0.f;
    lse[i] = any ? m[i] + logf(l[i]) : 0.f;
    dd[i] = any ? dn[i] / l[i] : 0.f;
    const int qp = q0 + ty * RM + i;
    if (tx == 0 && qp < S) {
      const int64_t at = (bi * H + h) * S + qp;
      stats[at] = lse[i];
      stats[static_cast<int64_t>(B) * H * S + at] = dd[i];
    }
  }

  // walk 2: dS and dQ
  float acc[RM][NJ][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k0 = kt * kBK;
    load_kv(k0);
    float s[RM][4], dp[RM][4], th[RM][4];
    unsigned ok[RM];
    tile(k0, s, dp, th, ok);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float ds = 0.f;
        if ((ok[i] >> j) & 1u) {
          ds = expf(s[i][j] - lse[i]) * (dp[i][j] - dd[i]);
          if (softcap > 0.f) ds *= 1.f - th[i][j] * th[i][j];
        }
        sDS[(ty * RM + i) * LDS + tx + 16 * j] = ds;
      }
    __syncwarp();   // this half warp's dS rows are written
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float p[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 t = ld4(sDS + (ty * RM + i) * LDS + c);
        p[i][0] = t.x;
        p[i][1] = t.y;
        p[i][2] = t.z;
        p[i][3] = t.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 kk = ld4(sK + (c + cc) * LD + tx * 4 + 64 * j);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            acc[i][j][0] = fmaf(p[i][cc], kk.x, acc[i][j][0]);
            acc[i][j][1] = fmaf(p[i][cc], kk.y, acc[i][j][1]);
            acc[i][j][2] = fmaf(p[i][cc], kk.z, acc[i][j][2]);
            acc[i][j][3] = fmaf(p[i][cc], kk.w, acc[i][j][3]);
          }
        }
    }
    __syncwarp();   // done reading dS before the next tile rewrites it
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qp = q0 + ty * RM + i;
    if (qp >= S) continue;
    T* row = dq + (bi * S + qp) * qstride + static_cast<int64_t>(h) * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = tx * 4 + 64 * j + e;
        if (d < hd) st(acc[i][j][e] * scale, row + d);
      }
  }
}

// ---------------------------------------------------------------------------
// dk and dv
// ---------------------------------------------------------------------------

// f32 sums of a split's q heads, at (split, B, T, K, hd)
template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dkdv_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ g,
        const float* __restrict__ stats, float* __restrict__ dk,
        float* __restrict__ dv, int B, int S, int T_len, int H, int K, int hd,
        int causal, int window, float softcap, float scale,
        int heads_per_split, int vec) {
  constexpr int BQ = block_q<HDP>();
  constexpr int CJ = BQ / 16;     // score columns (queries) per thread
  constexpr int LD = HDP + 4;
  constexpr int LDP = BQ + 4;
  constexpr int NJ = HDP / 64;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kBK * LD;
  float* sQ = sV + kBK * LD;
  float* sG = sQ + BQ * LD;
  float* sP = sG + BQ * LD;
  float* sDS = sP + kBK * LDP;
  float* sL = sDS + kBK * LDP;    // lse of the tile's rows
  float* sD = sL + BQ;            // D of the tile's rows

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = blockIdx.x * kBK, kh = blockIdx.y;
  const int64_t bi = blockIdx.z % B;
  const int split = blockIdx.z / B;
  const int group = H / K;
  const int h_first = kh * group + split * heads_per_split;
  const int h_end = min(kh * group + group, h_first + heads_per_split);
  const int64_t qstride = static_cast<int64_t>(H) * hd;
  const int64_t kstride = static_cast<int64_t>(K) * hd;
  const int64_t koff = bi * T_len * kstride + static_cast<int64_t>(kh) * hd;

  load_rows<T, HDP, kBK, false>(sK, k + koff, k0, T_len, kstride, hd, scale,
                                vec);
  load_rows<T, HDP, kBK, false>(sV, v + koff, k0, T_len, kstride, hd, scale,
                                vec);

  // the query tiles some key of this tile is visible to
  const int k_last = min(k0 + kBK, T_len) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S - 1, k_last + window - 1) : S - 1;
  const int qt_first = q_lo / BQ;
  const int qt_last = q_hi >= q_lo ? q_hi / BQ : qt_first - 1;

  float adk[4][NJ][4], adv[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) adk[i][j][e] = adv[i][j][e] = 0.f;

  for (int h = h_first; h < h_end; ++h) {
    const int64_t qoff = bi * S * qstride + static_cast<int64_t>(h) * hd;
    const float* st_l = stats + (bi * H + h) * S;
    const float* st_d = st_l + static_cast<int64_t>(B) * H * S;
    for (int qt = qt_first; qt <= qt_last; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();    // the previous tile's reads are done
      load_rows<T, HDP, BQ, true>(sQ, q + qoff, q0, S, qstride, hd, scale,
                                  vec);
      load_rows<T, HDP, BQ, false>(sG, g + qoff, q0, S, qstride, hd, scale,
                                   vec);
      for (int i = tid; i < BQ; i += kThreads) {
        sL[i] = q0 + i < S ? st_l[q0 + i] : 0.f;
        sD[i] = q0 + i < S ? st_d[q0 + i] : 0.f;
      }
      __syncthreads();

      // scores and dP, keys (rows) 4ty + i, queries (columns) tx + 16j
      float s[4][CJ], dp[4][CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < HDP; d += 4) {
        float4 qv[CJ], gv[CJ];
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          qv[j] = ld4(sQ + (tx + 16 * j) * LD + d);
          gv[j] = ld4(sG + (tx + 16 * j) * LD + d);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 kk = ld4(sK + (ty * 4 + i) * LD + d);
          const float4 vv = ld4(sV + (ty * 4 + i) * LD + d);
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            s[i][j] = dot4(qv[j], kk, s[i][j]);
            dp[i][j] = dot4(gv[j], vv, dp[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int col = tx + 16 * j;
          const int qp = q0 + col;
          float p = 0.f, ds = 0.f;
          if (visible(qp, kp, S, T_len, causal, window)) {
            float x = s[i][j], th = 0.f;
            if (softcap > 0.f) {
              th = tanhf(x / softcap);
              x = softcap * th;
            }
            p = expf(x - sL[col]);
            ds = p * (dp[i][j] - sD[col]);
            if (softcap > 0.f) ds *= 1.f - th * th;
          }
          sP[(ty * 4 + i) * LDP + col] = p;
          sDS[(ty * 4 + i) * LDP + col] = ds;
        }
      }
      __syncwarp();   // this half warp's P and dS rows are written

#pragma unroll 2
      for (int c = 0; c < BQ; c += 4) {
        float p[4][4], w[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 a = ld4(sP + (ty * 4 + i) * LDP + c);
          const float4 b = ld4(sDS + (ty * 4 + i) * LDP + c);
          p[i][0] = a.x; p[i][1] = a.y; p[i][2] = a.z; p[i][3] = a.w;
          w[i][0] = b.x; w[i][1] = b.y; w[i][2] = b.z; w[i][3] = b.w;
        }
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float4 gg = ld4(sG + (c + cc) * LD + tx * 4 + 64 * j);
            const float4 qq = ld4(sQ + (c + cc) * LD + tx * 4 + 64 * j);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              adv[i][j][0] = fmaf(p[i][cc], gg.x, adv[i][j][0]);
              adv[i][j][1] = fmaf(p[i][cc], gg.y, adv[i][j][1]);
              adv[i][j][2] = fmaf(p[i][cc], gg.z, adv[i][j][2]);
              adv[i][j][3] = fmaf(p[i][cc], gg.w, adv[i][j][3]);
              adk[i][j][0] = fmaf(w[i][cc], qq.x, adk[i][j][0]);
              adk[i][j][1] = fmaf(w[i][cc], qq.y, adk[i][j][1]);
              adk[i][j][2] = fmaf(w[i][cc], qq.z, adk[i][j][2]);
              adk[i][j][3] = fmaf(w[i][cc], qq.w, adk[i][j][3]);
            }
          }
      }
    }
  }

  // this split's f32 sums at (split, B, T, K, hd)
  const int64_t out0 = static_cast<int64_t>(split) * B * T_len * kstride + koff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty * 4 + i;
    if (kp >= T_len) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = tx * 4 + 64 * j + e;
        if (d < hd) {
          st(adk[i][j][e], dk + out0 + kp * kstride + d);
          st(adv[i][j][e], dv + out0 + kp * kstride + d);
        }
      }
  }
}

// dk, dv = the sum of `splits` f32 partials, in split order, rounded once
template <typename T>
__global__ void flash_attention_bwd_reduce_kernel(
    const float* __restrict__ pk, const float* __restrict__ pv,
    T* __restrict__ dk, T* __restrict__ dv, int64_t n, int splits) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int s = 0; s < splits; ++s) {
      a += pk[s * n + i];
      b += pv[s * n + i];
    }
    st(a, dk + i);
    st(b, dv + i);
  }
}

template <typename T, int HDP>
int launch_hd(const T* q, const T* k, const T* v, const T* g, T* dq, T* dk,
              T* dv, float* stats, float* partial, int B, int S, int T_len,
              int H, int K, int hd, int causal, int window, float softcap,
              float scale, int splits, cudaStream_t stream) {
  constexpr int BQ = block_q<HDP>();
  // 16-byte loads: whole 16-byte pieces of every row (q, g, k, v are
  // contiguous, so their row and head offsets are multiples of hd)
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = hd % (16 / sizeof(T)) == 0 && aligned(q) && aligned(k) &&
                  aligned(v) && aligned(g);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_dq_kernel<T, HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_smem<HDP>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 gq(static_cast<unsigned>((S + BQ - 1) / BQ), static_cast<unsigned>(H),
          static_cast<unsigned>(B));
  flash_attention_bwd_dq_kernel<T, HDP>
      <<<gq, kThreads, dq_smem<HDP>(), stream>>>(
          q, k, v, g, dq, stats, B, S, T_len, H, K, hd, causal, window,
          softcap, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int group = H / K;
  const int per = (group + splits - 1) / splits;
  dim3 gk(static_cast<unsigned>((T_len + kBK - 1) / kBK),
          static_cast<unsigned>(K), static_cast<unsigned>(B * splits));
  err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<T, HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dkdv_smem<HDP>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(B) * T_len * K * hd;
  float* pk = partial;
  float* pv = partial + splits * n;
  flash_attention_bwd_dkdv_kernel<T, HDP>
      <<<gk, kThreads, dkdv_smem<HDP>(), stream>>>(
          q, k, v, g, stats, pk, pv, B, S, T_len, H, K, hd, causal, window,
          softcap, scale, per, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (n + 255) / 256;
  flash_attention_bwd_reduce_kernel<T>
      <<<static_cast<unsigned>(blocks < 65535 ? blocks : 65535), 256, 0,
         stream>>>(pk, pv, dk, dv, n, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* g,
           void* dq, void* dk, void* dv, void* stats, void* partial,
           long long B, long long S, long long T_len, long long H,
           long long K, long long hd, long long splits, int causal,
           int window, float softcap, float scale, void* stream) {
  auto run = [&](auto hdp) {
    constexpr int HDP = decltype(hdp)::value;
    return launch_hd<T, HDP>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(g),
        static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
        static_cast<float*>(stats), static_cast<float*>(partial),
        static_cast<int>(B), static_cast<int>(S), static_cast<int>(T_len),
        static_cast<int>(H), static_cast<int>(K), static_cast<int>(hd), causal,
        window, softcap, scale, static_cast<int>(splits),
        static_cast<cudaStream_t>(stream));
  };
  if (hd <= 64) return run(std::integral_constant<int, 64>());
  if (hd <= 128) return run(std::integral_constant<int, 128>());
  if (hd <= 256) return run(std::integral_constant<int, 256>());
  return static_cast<int>(cudaErrorInvalidValue);
}


// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA, warp specialisation
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr float kNegInf = -1073741824.0f;   // -2^30, a masked score
constexpr int kBK = 64;       // kv tile keys (dq grid), q tile rows (dk/dv)
constexpr int kStages = 2;    // ring depth
// P (in dV += P^T g) and dS (in dQ += dS k, dK += dS^T q_scaled) enter the
// products as one bf16 rounding each; true makes that operand hi + lo, two
// products on the same tile, as the forward's P (tools/kernel_variants.py
// backward measures both)
constexpr bool kSplitP = false;
constexpr bool kSplitDS = false;

// dq grid: kWG consumer warpgroups of 64 query rows and one producer
// warpgroup. Shared memory from a 1024-byte aligned base: q (scaled in
// place), g, the k ring, the v ring, the mbarriers. One consumer at HDP
// 256, where two would need 256 KB.
template <int HDP>
struct DqLayout {
  static constexpr int kWG = HDP == 256 ? 1 : 2;
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kBoxes = HDP / kBoxCols;
  static constexpr uint32_t kTile = kBoxes * kBoxBytes;   // 64 rows x HDP
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kG = kWG * kTile;
  static constexpr uint32_t kK = 2 * kWG * kTile;
  static constexpr uint32_t kV = kK + kStages * kTile;
  static constexpr uint32_t kBar = kV + kStages * kTile;
  static constexpr uint32_t kBytes = kBar + 128 + 1024;   // + alignment slack
};

// dk/dv grid: two consumer warpgroups, each with 64 keys of its own (128
// a block), or at HDP 256 the same 64 keys and half of head_dim each (the
// m64n256 dK and dV accumulators would take 256 registers a thread); one
// producer warpgroup. Shared memory: k, v, the q_scaled ring, the g ring,
// the ring of the q tiles' lse and D (64 floats each), the mbarriers.
template <int HDP>
struct DkdvLayout {
  static constexpr bool kSplitHd = HDP == 256;
  static constexpr int kKeys = kSplitHd ? 64 : 128;
  static constexpr int kCols = kSplitHd ? HDP / 2 : HDP;  // dK, dV columns
  static constexpr int kThreads = 384;
  static constexpr int kBoxes = HDP / kBoxCols;
  static constexpr uint32_t kTile = kBoxes * kBoxBytes;
  static constexpr int kKT = kKeys / 64;                  // k (and v) tiles
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kKT * kTile;
  static constexpr uint32_t kQ = 2 * kKT * kTile;
  static constexpr uint32_t kG = kQ + kStages * kTile;
  static constexpr uint32_t kSt = kG + kStages * kTile;
  static constexpr uint32_t kBar = kSt + kStages * 512;
  static constexpr uint32_t kBytes = kBar + 128 + 1024;
};

// dq grid mbarriers: q and g; k full, v full, k empty, v empty per stage
__device__ __forceinline__ int bar_k_full(int s) { return 1 + s; }
__device__ __forceinline__ int bar_v_full(int s) { return 1 + kStages + s; }
__device__ __forceinline__ int bar_k_empty(int s) { return 1 + 2 * kStages + s; }
__device__ __forceinline__ int bar_v_empty(int s) { return 1 + 3 * kStages + s; }

// A = X . Y^T and B = Z . W^T, 64 x 64 each in f32, from four 64 x HDP
// bf16 tiles in shared memory (K-major, 128-byte swizzle). The result is
// the wgmma fragment: element e of a thread is row 16 warp + lane / 4 + 8
// ((e / 2) % 2), column 8 (e / 4) + 2 (lane % 4) + e % 2.
template <int HDP>
__device__ __forceinline__ void products_ss(float (&a)[32], float (&b)[32],
                                            uint32_t x, uint32_t y,
                                            uint32_t z, uint32_t w) {
#pragma unroll
  for (int e = 0; e < 32; ++e) a[e] = b[e] = 0.f;
  __syncwarp();   // converged for the .aligned wgmma instructions
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < HDP / 16; ++ks) {
    const uint32_t off = (ks / 4) * kBoxBytes + (ks % 4) * 32;
    wgmma_ss_m64n64(a, desc_k_major(x + off), desc_k_major(y + off), ks > 0);
  }
#pragma unroll
  for (int ks = 0; ks < HDP / 16; ++ks) {
    const uint32_t off = (ks / 4) * kBoxBytes + (ks % 4) * 32;
    wgmma_ss_m64n64(b, desc_k_major(z + off), desc_k_major(w + off), ks > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(a);
  fence_regs(b);
}

// a 64 x 64 f32 fragment as the bf16 A operand of four k-steps (element
// pair (2e, 2e + 1) is register e)
__device__ __forceinline__ void to_bf16(const float (&x)[32],
                                        uint32_t (&a)[16]) {
#pragma unroll
  for (int e = 0; e < 16; ++e) a[e] = pack_bf16(x[2 * e], x[2 * e + 1]);
}

// acc (64 x N) += X . Y: X 64 x 64 bf16 in registers (to_bf16), Y 64 x N
// in shared memory from address y, read MN-major (rows 128 bytes apart,
// 64-column boxes kBoxBytes apart). Issued only: the caller commits and
// waits.
template <int N>
__device__ __forceinline__ void mma_rs_tile(float (&acc)[N / 2],
                                            const uint32_t (&x)[16],
                                            uint32_t y) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint32_t a[4] = {x[4 * ks], x[4 * ks + 1], x[4 * ks + 2],
                           x[4 * ks + 3]};
    wgmma_rs<N>(acc, a, desc_mn_major(y + ks * 16 * 128));
  }
}

// the visible entries of a dq-grid score tile (keys k0 .., rows row0 and
// row0 + 8), as bits by fragment element; all of them off the edges
__device__ __forceinline__ uint32_t dq_mask(bool edge, int k0, int row0,
                                            int col0, int T_len, int causal,
                                            int window) {
  uint32_t ok = 0xffffffffu;
  if (edge) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int kp = k0 + 8 * (e / 4) + col0 + (e & 1);
      const int qp = row0 + ((e & 2) ? 8 : 0);
      if (!(kp < T_len && (!causal || kp <= qp) &&
            (window <= 0 || kp > qp - window)))
        ok &= ~(1u << e);
    }
  }
  return ok;
}

// a thread's two rows' running max m, and per-thread partial sums of P
// (l) and of P dP (n) relative to m; the quad adds the partials at the end
struct Stats {
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f, n0 = 0.f, n1 = 0.f;
};

// one tile into the online lse and D: softcap, mask, rescale, add
__device__ __forceinline__ void stats_tile(float (&sc)[32],
                                           const float (&dp)[32], Stats& rows,
                                           uint32_t ok, float softcap,
                                           float inv_cap) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    if (softcap > 0.f) sc[e] = softcap * tanh_exp(sc[e] * inv_cap);
    if (!((ok >> e) & 1u)) sc[e] = kNegInf;
  }
  float mx0 = rows.m0, mx1 = rows.m1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  // the 4 threads of a quad hold one row's 64 keys
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float corr0 = exp2f((rows.m0 - mx0) * kLog2e);
  const float corr1 = exp2f((rows.m1 - mx1) * kLog2e);
  rows.m0 = mx0;
  rows.m1 = mx1;
  const float ms0 = mx0 * kLog2e, ms1 = mx1 * kLog2e;
  float l0 = 0.f, l1 = 0.f, n0 = 0.f, n1 = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const bool r1 = e & 2;
    const float p = (ok >> e) & 1u
                        ? exp2f(fmaf(sc[e], kLog2e, r1 ? -ms1 : -ms0))
                        : 0.f;
    if (r1) {
      l1 += p;
      n1 = fmaf(p, dp[e], n1);
    } else {
      l0 += p;
      n0 = fmaf(p, dp[e], n0);
    }
  }
  rows.l0 = rows.l0 * corr0 + l0;
  rows.l1 = rows.l1 * corr1 + l1;
  rows.n0 = rows.n0 * corr0 + n0;
  rows.n1 = rows.n1 * corr1 + n1;
}

// raw score x, its dP, lse (times log2 e) and D -> (P, dS) of one entry
__device__ __forceinline__ float2 p_ds(float x, float dp, float ls, float d,
                                       float softcap, float inv_cap) {
  float th = 0.f;
  if (softcap > 0.f) {
    th = tanh_exp(x * inv_cap);
    x = softcap * th;
  }
  const float p = exp2f(fmaf(x, kLog2e, -ls));
  float ds = p * (dp - d);
  if (softcap > 0.f) ds *= 1.f - th * th;
  return make_float2(p, ds);
}

// columns c, c + 1 of a row of hd values, in pairs where they align
__device__ __forceinline__ void store2(__nv_bfloat16* row, int c, int hd,
                                       float x, float y) {
  if (c + 1 < hd && !(hd & 1)) {
    *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(x, y);
  } else {
    if (c < hd) row[c] = __float2bfloat16_rn(x);
    if (c + 1 < hd) row[c + 1] = __float2bfloat16_rn(y);
  }
}

__device__ __forceinline__ void store2(float* row, int c, int hd, float x,
                                       float y) {
  if (c + 1 < hd && !(hd & 1)) {
    *reinterpret_cast<float2*>(row + c) = make_float2(x, y);
  } else {
    if (c < hd) row[c] = x;
    if (c + 1 < hd) row[c + 1] = y;
  }
}

// dq, each row's lse and D, and q_scaled. Block (q head, 64 kWG query
// rows, batch row), the query tiles longest-first.
template <int HDP>
__global__ void __launch_bounds__(DqLayout<HDP>::kThreads, 1)
    flash_attention_bwd_dq_kernel_tc(
        const __grid_constant__ CUtensorMap map_q,
        const __grid_constant__ CUtensorMap map_k,
        const __grid_constant__ CUtensorMap map_v,
        const __grid_constant__ CUtensorMap map_g,
        __nv_bfloat16* __restrict__ qs, __nv_bfloat16* __restrict__ dq,
        float* __restrict__ stats, int B, int S, int T_len, int H, int group,
        int hd, int hd_in, int s_pad, int causal, int window, float softcap,
        float scale) {
  using L = DqLayout<HDP>;
  constexpr int NW = L::kWG;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  auto bar = [base](int i) { return base + L::kBar + 8u * i; };

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 64 * NW;
  const int b = blockIdx.z;

  // the key tiles some query of this block can see
  const int q_last = min(q0 + 64 * NW, S) - 1;
  const int k_hi = causal ? min(T_len - 1, q_last) : T_len - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_first = k_lo / kBK;
  const int n_tiles = k_hi >= k_lo ? k_hi / kBK - kt_first + 1 : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar(0), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar(bar_k_full(s)), 1);
      mbar_init(bar(bar_v_full(s)), 1);
      mbar_init(bar(bar_k_empty(s)), 128 * NW);   // every consumer thread
      mbar_init(bar(bar_v_empty(s)), 128 * NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NW) {
    // producer: one thread issues every TMA load; the k and v tiles come
    // twice, for the lse / D walk and for the dq walk
    if constexpr (NW == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * NW) {
      const int kvh = h / group;
      mbar_expect_tx(bar(0), 2 * NW * L::kTile);
      for (int w = 0; w < NW; ++w)
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load(base + L::kQ + w * L::kTile + c * kBoxBytes, &map_q,
                   bar(0), c * kBoxCols, h, q0 + 64 * w, b);
          tma_load(base + L::kG + w * L::kTile + c * kBoxBytes, &map_g,
                   bar(0), c * kBoxCols, h, q0 + 64 * w, b);
        }
      for (int i = 0; i < 2 * n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t parity = (i / kStages) & 1;
        const int k0 = (kt_first + i % n_tiles) * kBK;
        mbar_wait(bar(bar_k_empty(s)), parity ^ 1);
        mbar_expect_tx(bar(bar_k_full(s)), L::kTile);
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load(base + L::kK + s * L::kTile + c * kBoxBytes, &map_k,
                   bar(bar_k_full(s)), c * kBoxCols, kvh, k0, b);
        mbar_wait(bar(bar_v_empty(s)), parity ^ 1);
        mbar_expect_tx(bar(bar_v_full(s)), L::kTile);
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load(base + L::kV + s * L::kTile + c * kBoxBytes, &map_v,
                   bar(bar_v_full(s)), c * kBoxCols, kvh, k0, b);
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows qa .. qa + 63
    if constexpr (NW == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int qa = q0 + 64 * wg;
    const bool active = qa < S;
    const int qb = min(qa + 63, S - 1);
    const int row0 = qa + 16 * warp + (lane >> 2), row1 = row0 + 8;
    const int col0 = 2 * (lane & 3);
    const int wk_hi = causal ? min(T_len - 1, qb) : T_len - 1;
    const int wk_lo = window > 0 ? max(0, qa - window + 1) : 0;
    const uint32_t sq = base + L::kQ + wg * L::kTile;
    const uint32_t sg = base + L::kG + wg * L::kTile;
    const float inv_cap = softcap > 0.f ? 1.0f / softcap : 0.f;

    if (active) {
      // q_scaled = q * scale rounded to bf16, in place (elementwise), and
      // unswizzled into qs for the dk/dv grid: chunk i of the tile is row
      // r = (i % 512) / 8 of box i / 512, its 16 bytes columns 8 ((i % 8)
      // ^ (r % 8)) on
      mbar_wait(bar(0), 0);
      uint4* qv = reinterpret_cast<uint4*>(smem + L::kQ + wg * L::kTile);
      for (int i = t; i < static_cast<int>(L::kTile / 16); i += 128) {
        uint4 x = qv[i];
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(e[j]);
          e[j] = __floats2bfloat162_rn(__fmul_rn(f.x, scale),
                                       __fmul_rn(f.y, scale));
        }
        qv[i] = x;
        const int r = (i % 512) / 8;
        const int col = (i / 512) * kBoxCols + 8 * ((i % 8) ^ (r % 8));
        if (qa + r < S && col < hd_in)
          *reinterpret_cast<uint4*>(
              qs + ((static_cast<int64_t>(b) * S + qa + r) * H + h) * hd_in +
              col) = x;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      warpgroup_sync(1 + wg);
    }

    // The tiles this warpgroup's rows see are a contiguous run i_lo ..
    // i_hi of the block's; the others are waited for and released, in
    // order, but not computed.
    const int i_lo = active ? max(0, wk_lo / kBK - kt_first) : n_tiles;
    const int i_hi = active ? min(n_tiles - 1, wk_hi / kBK - kt_first) : -1;
    auto edge = [&](int k0) {
      return !(k0 + kBK - 1 < T_len && (!causal || k0 + kBK - 1 <= qa) &&
               (window <= 0 || k0 > qb - window));
    };

    // walk 1: lse and D = sum P dP, online
    Stats rows;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      const bool vis = i_lo <= i && i <= i_hi;
      const int k0 = (kt_first + i) * kBK;
      float sc[32], dp[32];
      mbar_wait(bar(bar_k_full(s)), parity);
      mbar_wait(bar(bar_v_full(s)), parity);
      if (vis)
        products_ss<HDP>(sc, dp, sq, base + L::kK + s * L::kTile, sg,
                         base + L::kV + s * L::kTile);
      mbar_arrive(bar(bar_k_empty(s)));
      mbar_arrive(bar(bar_v_empty(s)));
      if (vis)
        stats_tile(sc, dp, rows,
                   dq_mask(edge(k0), k0, row0, col0, T_len, causal, window),
                   softcap, inv_cap);
    }
    float l0 = rows.l0, l1 = rows.l1, n0 = rows.n0, n1 = rows.n1;
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
      n0 += __shfl_xor_sync(0xffffffffu, n0, o);
      n1 += __shfl_xor_sync(0xffffffffu, n1, o);
    }
    // a row that sees no key: lse 0, D 0 (dq 0 and no terms elsewhere)
    const float lse0 = l0 > 0.f ? rows.m0 + logf(l0) : 0.f;
    const float lse1 = l1 > 0.f ? rows.m1 + logf(l1) : 0.f;
    const float d0 = l0 > 0.f ? n0 / l0 : 0.f;
    const float d1 = l1 > 0.f ? n1 / l1 : 0.f;
    if (active && (lane & 3) == 0) {
      // every row of the tile, past S too: the dk/dv grid reads whole
      // 64-row tiles (and masks rows past S)
      float* sl = stats + (static_cast<int64_t>(b) * H + h) * s_pad;
      float* sd = sl + static_cast<int64_t>(B) * H * s_pad;
      sl[row0] = lse0;
      sl[row1] = lse1;
      sd[row0] = d0;
      sd[row1] = d1;
    }

    // walk 2: dS, then dQ += dS k on the tensor cores
    const float ls0 = lse0 * kLog2e, ls1 = lse1 * kLog2e;
    float acc[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
    for (int i = 0; i < n_tiles; ++i) {
      const int j = n_tiles + i;
      const int s = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      const bool vis = i_lo <= i && i <= i_hi;
      const int k0 = (kt_first + i) * kBK;
      const uint32_t sk = base + L::kK + s * L::kTile;
      float sc[32], dp[32];
      mbar_wait(bar(bar_k_full(s)), parity);
      mbar_wait(bar(bar_v_full(s)), parity);
      if (vis)
        products_ss<HDP>(sc, dp, sq, sk, sg, base + L::kV + s * L::kTile);
      mbar_arrive(bar(bar_v_empty(s)));
      if (vis) {
        const uint32_t ok =
            dq_mask(edge(k0), k0, row0, col0, T_len, causal, window);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const bool r1 = e & 2;
          const float2 pd = p_ds(sc[e], dp[e], r1 ? ls1 : ls0, r1 ? d1 : d0,
                                 softcap, inv_cap);
          sc[e] = (ok >> e) & 1u ? pd.y : 0.f;
        }
        uint32_t dh[16], dl[16];
        if constexpr (kSplitDS) split_bf16(sc, dh, dl);
        else to_bf16(sc, dh);
        __syncwarp();
        wgmma_fence();
        mma_rs_tile<HDP>(acc, dh, sk);
        if constexpr (kSplitDS) mma_rs_tile<HDP>(acc, dl, sk);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        fence_regs(dh);
        if constexpr (kSplitDS) fence_regs(dl);
      }
      mbar_arrive(bar(bar_k_empty(s)));
    }

    if (active) {
      const int64_t H64 = H;
      __nv_bfloat16* o0 =
          dq + ((static_cast<int64_t>(b) * S + row0) * H64 + h) * hd;
      __nv_bfloat16* o1 = o0 + 8 * H64 * hd;
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
        const int c = 8 * j + col0;
        if (row0 < S)
          store2(o0, c, hd, acc[4 * j] * scale, acc[4 * j + 1] * scale);
        if (row1 < S)
          store2(o1, c, hd, acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
      }
    }
  }
}

// dk and dv of one split's q heads as f32 sums at (split, B, T, K, hd).
// Block (kKeys-key tile, kv head, batch row and split).
template <int HDP>
__global__ void __launch_bounds__(DkdvLayout<HDP>::kThreads, 1)
    flash_attention_bwd_dkdv_kernel_tc(
        const __grid_constant__ CUtensorMap map_qs,
        const __grid_constant__ CUtensorMap map_k,
        const __grid_constant__ CUtensorMap map_v,
        const __grid_constant__ CUtensorMap map_g,
        const float* __restrict__ stats, float* __restrict__ pk,
        float* __restrict__ pv, int B, int S, int T_len, int H, int K, int hd,
        int s_pad, int causal, int window, float softcap,
        int heads_per_split) {
  using L = DkdvLayout<HDP>;
  constexpr int NC = L::kCols;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* smem = smem_raw + (base - raw);
  auto bar = [base](int i) { return base + L::kBar + 8u * i; };
  auto full = [](int s) { return 1 + s; };
  auto empty = [](int s) { return 1 + kStages + s; };

  const int k_blk = blockIdx.x * L::kKeys, kh = blockIdx.y;
  const int b = blockIdx.z % B, split = blockIdx.z / B;
  const int group = H / K;
  const int h_first = kh * group + split * heads_per_split;
  const int n_heads =
      max(0, min(kh * group + group, h_first + heads_per_split) - h_first);
  // the query tiles some key of this block is visible to, for each head
  const int k_last = min(k_blk + L::kKeys, T_len) - 1;
  const int q_lo = causal ? k_blk : 0;
  const int q_hi = window > 0 ? min(S - 1, k_last + window - 1) : S - 1;
  const int qt_first = q_lo / kBK;
  const int n_qt = q_hi >= q_lo ? q_hi / kBK - qt_first + 1 : 0;
  const int n_items = n_heads * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(bar(0), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar(full(s)), 1);
      mbar_init(bar(empty(s)), 256);   // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: k and v once, then q_scaled, g and the rows' lse and D of
    // each (head, query tile) through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar(0), 2 * L::kKT * L::kTile);
      for (int w = 0; w < L::kKT; ++w)
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load(base + L::kK + w * L::kTile + c * kBoxBytes, &map_k,
                   bar(0), c * kBoxCols, kh, k_blk + 64 * w, b);
          tma_load(base + L::kV + w * L::kTile + c * kBoxBytes, &map_v,
                   bar(0), c * kBoxCols, kh, k_blk + 64 * w, b);
        }
      for (int i = 0; i < n_items; ++i) {
        const int hh = h_first + i / n_qt;
        const int q0 = (qt_first + i % n_qt) * kBK;
        const int s = i % kStages;
        const uint32_t parity = (i / kStages) & 1;
        mbar_wait(bar(empty(s)), parity ^ 1);
        mbar_expect_tx(bar(full(s)), 2 * L::kTile + 512);
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load(base + L::kQ + s * L::kTile + c * kBoxBytes, &map_qs,
                   bar(full(s)), c * kBoxCols, hh, q0, b);
          tma_load(base + L::kG + s * L::kTile + c * kBoxBytes, &map_g,
                   bar(full(s)), c * kBoxCols, hh, q0, b);
        }
        const float* sl =
            stats + (static_cast<int64_t>(b) * H + hh) * s_pad + q0;
        bulk_load(base + L::kSt + s * 512, sl, 256, bar(full(s)));
        bulk_load(base + L::kSt + s * 512 + 256,
                  sl + static_cast<int64_t>(B) * H * s_pad, 256,
                  bar(full(s)));
      }
    }
  } else {
    // consumers: warpgroup wg owns keys ka .. ka + 63, dK and dV columns
    // cb .. cb + NC - 1
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int ka = L::kSplitHd ? k_blk : k_blk + 64 * wg;
    const int cb = L::kSplitHd ? wg * NC : 0;
    const uint32_t sk = base + L::kK + (L::kSplitHd ? 0 : wg * L::kTile);
    const uint32_t sv = base + L::kV + (L::kSplitHd ? 0 : wg * L::kTile);
    const uint32_t col_off = (cb / kBoxCols) * kBoxBytes;
    const bool active = ka < T_len;
    const int kz = min(ka + 63, T_len - 1);
    const int wq_lo = causal ? ka : 0;
    const int wq_hi = window > 0 ? min(S - 1, kz + window - 1) : S - 1;
    const int key0 = ka + 16 * warp + (lane >> 2);   // rows key0, key0 + 8
    const int col0 = 2 * (lane & 3);
    const float inv_cap = softcap > 0.f ? 1.0f / softcap : 0.f;

    float dka[NC / 2], dva[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) dka[i] = dva[i] = 0.f;
    if (active) mbar_wait(bar(0), 0);
    for (int i = 0; i < n_items; ++i) {
      const int q0 = (qt_first + i % n_qt) * kBK;
      const int s = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      const bool vis = active && q0 <= wq_hi && q0 + kBK - 1 >= wq_lo;
      mbar_wait(bar(full(s)), parity);
      if (vis) {
        const uint32_t sq = base + L::kQ + s * L::kTile;
        const uint32_t sg = base + L::kG + s * L::kTile;
        // S^T = k q_scaled^T and dP^T = v g^T: rows keys, columns queries
        float sc[32], dp[32];
        products_ss<HDP>(sc, dp, sk, sq, sv, sg);
        const float* lse =
            reinterpret_cast<const float*>(smem + L::kSt + s * 512);
        const bool edge = !(q0 + kBK - 1 < S && (!causal || q0 >= ka + 63) &&
                            (window <= 0 || q0 + kBK - 1 < ka + window));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + col0;
          const float2 l2 = *reinterpret_cast<const float2*>(lse + c);
          const float2 d2 = *reinterpret_cast<const float2*>(lse + 64 + c);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = 4 * j + u;
            bool ok = true;
            if (edge) {
              const int qp = q0 + c + (u & 1);
              const int kp = key0 + ((u & 2) ? 8 : 0);
              ok = qp < S && (!causal || kp <= qp) &&
                   (window <= 0 || kp > qp - window);
            }
            const float2 pd = p_ds(sc[e], dp[e],
                                   ((u & 1) ? l2.y : l2.x) * kLog2e,
                                   (u & 1) ? d2.y : d2.x, softcap, inv_cap);
            sc[e] = ok ? pd.x : 0.f;
            dp[e] = ok ? pd.y : 0.f;
          }
        }
        // dV += P^T g and dK += dS^T q_scaled, g and q_scaled read MN-major
        uint32_t ph[16], pl[16], dh[16], dl[16];
        if constexpr (kSplitP) split_bf16(sc, ph, pl);
        else to_bf16(sc, ph);
        if constexpr (kSplitDS) split_bf16(dp, dh, dl);
        else to_bf16(dp, dh);
        __syncwarp();
        wgmma_fence();
        mma_rs_tile<NC>(dva, ph, sg + col_off);
        if constexpr (kSplitP) mma_rs_tile<NC>(dva, pl, sg + col_off);
        mma_rs_tile<NC>(dka, dh, sq + col_off);
        if constexpr (kSplitDS) mma_rs_tile<NC>(dka, dl, sq + col_off);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dva);
        fence_regs(dka);
        fence_regs(ph);
        fence_regs(dh);
        if constexpr (kSplitP) fence_regs(pl);
        if constexpr (kSplitDS) fence_regs(dl);
      }
      mbar_arrive(bar(empty(s)));
    }

    if (active) {
      const int64_t rs = static_cast<int64_t>(K) * hd;
      const int64_t at =
          (static_cast<int64_t>(split) * B + b) * T_len * rs +
          static_cast<int64_t>(kh) * hd;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kp = key0 + 8 * r;
        if (kp >= T_len) continue;
#pragma unroll
        for (int j = 0; j < NC / 8; ++j) {
          const int c = cb + 8 * j + col0;
          store2(pk + at + kp * rs, c, hd, dka[4 * j + 2 * r],
                 dka[4 * j + 2 * r + 1]);
          store2(pv + at + kp * rs, c, hd, dva[4 * j + 2 * r],
                 dva[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

template <int HDP>
int launch_hd(const void* q, const void* k, const void* v, const void* g,
              void* qs, void* dq, void* dk, void* dv, float* stats,
              float* partial, long long B, long long S, long long T_len,
              long long H, long long K, long long hd, long long hd_in,
              long long splits, int causal, int window, float softcap,
              float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mg, mqs;
  const long long hs = H * hd_in, ks = K * hd_in;
  if (!encode(&mq, q, hd_in, H, S, B, hd_in, hs, S * hs) ||
      !encode(&mg, g, hd_in, H, S, B, hd_in, hs, S * hs) ||
      !encode(&mqs, qs, hd_in, H, S, B, hd_in, hs, S * hs) ||
      !encode(&mk, k, hd_in, K, T_len, B, hd_in, ks, T_len * ks) ||
      !encode(&mv, v, hd_in, K, T_len, B, hd_in, ks, T_len * ks))
    return kTensorMapRefused;
  const int s_pad = static_cast<int>((S + 63) / 64 * 64);

  using LQ = DqLayout<HDP>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_dq_kernel_tc<HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(LQ::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 gq(static_cast<unsigned>(H),
          static_cast<unsigned>((S + 64 * LQ::kWG - 1) / (64 * LQ::kWG)),
          static_cast<unsigned>(B));
  flash_attention_bwd_dq_kernel_tc<HDP>
      <<<gq, LQ::kThreads, LQ::kBytes, stream>>>(
          mq, mk, mv, mg, static_cast<__nv_bfloat16*>(qs),
          static_cast<__nv_bfloat16*>(dq), stats, static_cast<int>(B),
          static_cast<int>(S), static_cast<int>(T_len), static_cast<int>(H),
          static_cast<int>(H / K), static_cast<int>(hd),
          static_cast<int>(hd_in), s_pad, causal, window, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  using LK = DkdvLayout<HDP>;
  err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel_tc<HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(LK::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long group = H / K;
  const int per = static_cast<int>((group + splits - 1) / splits);
  const int64_t n = B * T_len * K * hd;
  float* pk = partial;
  float* pv = partial + splits * n;
  dim3 gk(static_cast<unsigned>((T_len + LK::kKeys - 1) / LK::kKeys),
          static_cast<unsigned>(K), static_cast<unsigned>(B * splits));
  flash_attention_bwd_dkdv_kernel_tc<HDP>
      <<<gk, LK::kThreads, LK::kBytes, stream>>>(
          mqs, mk, mv, mg, stats, pk, pv, static_cast<int>(B),
          static_cast<int>(S), static_cast<int>(T_len), static_cast<int>(H),
          static_cast<int>(K), static_cast<int>(hd), s_pad, causal, window,
          softcap, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (n + 255) / 256;
  flash_attention_bwd_reduce_kernel<__nv_bfloat16>
      <<<static_cast<unsigned>(blocks < 65535 ? blocks : 65535), 256, 0,
         stream>>>(pk, pv, static_cast<__nv_bfloat16*>(dk),
                   static_cast<__nv_bfloat16*>(dv), n,
                   static_cast<int>(splits));
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, const void* g,
           void* qs, void* dq, void* dk, void* dv, void* stats, void* partial,
           long long B, long long S, long long T_len, long long H,
           long long K, long long hd, long long hd_in, long long splits,
           int causal, int window, float softcap, float scale, void* stream) {
  auto run = [&](auto hdp) {
    constexpr int HDP = decltype(hdp)::value;
    return launch_hd<HDP>(q, k, v, g, qs, dq, dk, dv,
                          static_cast<float*>(stats),
                          static_cast<float*>(partial), B, S, T_len, H, K, hd,
                          hd_in, splits, causal, window, softcap, scale,
                          static_cast<cudaStream_t>(stream));
  };
  if (hd_in <= 64) return run(std::integral_constant<int, 64>());
  if (hd_in <= 128) return run(std::integral_constant<int, 128>());
  if (hd_in <= 256) return run(std::integral_constant<int, 256>());
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

}  // namespace
}  // namespace repro_torch

// q, g (B, S, H, hd), k, v (B, T, K, hd), contiguous; dq, dk, dv of the same
// shapes; stats (2, B, H, S) and partial (2, splits, B, T, K, hd) f32
// scratch. Returns the first CUDA error.
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* g, void* dq,
    void* dk, void* dv, void* stats, void* partial, long long B, long long S,
    long long T, long long H, long long K, long long hd, long long splits,
    int causal, int window, float softcap, float scale, void* stream) {
  return repro_torch::launch<float>(q, k, v, g, dq, dk, dv, stats, partial, B,
                                    S, T, H, K, hd, splits, causal, window,
                                    softcap, scale, stream);
}

// bf16 (tensor cores): q, k, v, g hold hd_in >= hd columns (hd rounded up
// to 8, the extra ones zero), contiguous, 16-byte aligned (TMA); qs a (B,
// S, H, hd_in) bf16 scratch for q_scaled; dq, dk, dv hold hd columns;
// stats (2, B, H, ceil(S / 64) * 64) and partial (2, splits, B, T, K, hd)
// f32 scratch. Returns the first CUDA error, or -1 if the driver refuses a
// tensor map.
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* g, void* qs,
    void* dq, void* dk, void* dv, void* stats, void* partial, long long B,
    long long S, long long T, long long H, long long K, long long hd,
    long long hd_in, long long splits, int causal, int window, float softcap,
    float scale, void* stream) {
  return repro_torch::tc::launch(q, k, v, g, qs, dq, dk, dv, stats, partial,
                                 B, S, T, H, K, hd, hd_in, splits, causal,
                                 window, softcap, scale, stream);
}

// the dynamic shared memory a block of pass 0 (dq) or 1 (dk, dv) takes at
// head_dim hd (ptxas reports only static shared memory): f32 (the SIMT
// kernels) or, with bf16 set, the tensor-core kernels; -1 past 256
extern "C" long long flash_attention_bwd_smem_bytes(long long hd, int pass,
                                                    int bf16) {
  using namespace repro_torch;
  auto bytes = [&](auto hdp) -> long long {
    constexpr int HDP = decltype(hdp)::value;
    if (bf16)
      return pass ? tc::DkdvLayout<HDP>::kBytes : tc::DqLayout<HDP>::kBytes;
    return pass ? dkdv_smem<HDP>() : dq_smem<HDP>();
  };
  if (hd <= 64) return bytes(std::integral_constant<int, 64>());
  if (hd <= 128) return bytes(std::integral_constant<int, 128>());
  if (hd <= 256) return bytes(std::integral_constant<int, 256>());
  return -1;
}
