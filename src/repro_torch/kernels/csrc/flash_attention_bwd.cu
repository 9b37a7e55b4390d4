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
// accumulations), 10 * hd flops; the data are read or written once.
//
// Design: a simple kernel on CUDA cores, in f32, with no atomics, so two
// launches on the same inputs give the same bits (the captured training
// programs are held == their eager runs). One entry point, two or three
// grids in order on the caller's stream:
// - flash_attention_bwd_dq_kernel, one block of 256 threads per (query
//   tile, q head, batch row): a first walk over the kv tiles the masks
//   leave visible computes each row's lse and D online (running max, sum
//   and sum of P dP, as the forward's softmax), written to stats (2, B, H,
//   S) f32; a second walk recomputes P and dS and accumulates dQ in
//   registers.
// - flash_attention_bwd_dkdv_kernel, one block per (64-key tile, kv head,
//   batch row) and head split: it keeps its k and v tile in shared memory
//   and walks its q heads and the query tiles the masks leave visible,
//   reading lse and D, accumulating dK and dV in registers. Where a grid
//   of kv tiles alone would leave most of the 132 SMs idle (MQA: one kv
//   head for 16 q heads), the group's q heads are split over `splits`
//   blocks. Every block writes its f32 sums, and
//   flash_attention_bwd_reduce_kernel adds a tile's splits in split order
//   and rounds once to the storage type.
// - Tiles are f32 in shared memory, rows padded by 4 floats: q, g (BQ x hd)
//   and k, v (64 x hd) with BQ = 64 query rows, or 32 at hd 256 to stay
//   within the 227 KB a block may use; the 16 x 16 threads own 4 (or 2)
//   rows of the score tile each and reduce a row's max and sums over the
//   half warp that shares it, as the forward's SIMT kernel does. Tiles
//   arrive by 16-byte loads, four in flight a thread (one element at a time
//   where head_dim is not a multiple of 16 bytes), a warp reading
//   consecutive columns; a block waits for each tile (no ring).
// Shapes: head_dim <= 256 (the wrapper refuses more by name), kv head and
// batch counts <= 65535 (grid y and z), S and T < 2^30.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

namespace repro_torch {
namespace {

constexpr int kBK = 64;         // keys per kv tile
constexpr int kThreads = 256;   // a 16 x 16 grid of threads

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
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
__device__ __forceinline__ void unpack(uint4 raw, float (&x)[8],
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
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

extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* g, void* dq,
    void* dk, void* dv, void* stats, void* partial, long long B, long long S,
    long long T, long long H, long long K, long long hd, long long splits,
    int causal, int window, float softcap, float scale, void* stream) {
  return repro_torch::launch<__nv_bfloat16>(q, k, v, g, dq, dk, dv, stats,
                                            partial, B, S, T, H, K, hd, splits,
                                            causal, window, softcap, scale,
                                            stream);
}

// the dynamic shared memory a block of pass 0 (dq) or 1 (dk, dv) takes at
// head_dim hd (ptxas reports only static shared memory); -1 past 256
extern "C" long long flash_attention_bwd_smem_bytes(long long hd, int pass) {
  using repro_torch::dkdv_smem;
  using repro_torch::dq_smem;
  if (hd <= 64) return pass ? dkdv_smem<64>() : dq_smem<64>();
  if (hd <= 128) return pass ? dkdv_smem<128>() : dq_smem<128>();
  if (hd <= 256) return pass ? dkdv_smem<256>() : dq_smem<256>();
  return -1;
}
