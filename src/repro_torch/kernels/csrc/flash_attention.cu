// Exact attention forward for Hopper (sm_90a): causal and sliding-window
// masks, grouped-query / multi-query heads, tanh soft-capping, online
// softmax, with fully masked kv tiles skipped.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _attn_kernel). q (B, S, H, hd), k and v (B, T, K, hd) of
// one type, f32 or bf16, positions from 0, H % K == 0, q head h reads kv
// head h / (H / K) -> out (B, S, H, hd) in q's type. For each query row:
//
//   s_t = softcap * tanh((q_scaled . k_t) / softcap)    (when softcap > 0)
//   s_t = NEG_INF where k_t is masked (t >= T; causal: t > q; window: t <= q - window)
//   out = sum_t exp(s_t - max) v_t / max(sum_t exp(s_t - max), 1e-30), masked terms 0
//
// with q_scaled = q / sqrt(hd) rounded back to the storage type, as the
// plain version does. All sums run in f32.
//
// Bound: operations. For each visible (query, key) pair the kernel does a
// dot product and an axpy of length hd, 4 * hd flops; the data (q, k, v,
// out) are read or written once and the window keeps the visible pairs at
// O(window * T), so flops over the card's rate exceed bytes over its memory
// rate at every shape the model runs (recurrentgemma-9b's prefill: 4.1e11
// flops against 0.27 GB, 0.42 ms at the bf16 tensor-core rate).
//
// bf16: flash_attention_kernel_tc, tensor cores fed by TMA.
// - One block of 384 threads per (q head, 128-query tile, batch row); the
//   head is blockIdx.x, so the H / K q heads that read one kv head's tiles
//   run side by side and find them in the 50 MB L2. Query tiles run
//   longest-first (the causal frontier makes late tiles see more keys).
// - Warp specialisation: warpgroups 0 and 1 each own 64 query rows and do
//   all the arithmetic; one thread of warpgroup 2 issues every load. The
//   producer gives up registers (setmaxnreg 24) so that each consumer
//   thread holds 240: the 64 x hd f32 output accumulator (128 registers at
//   hd 256), the 64 x 64 score tile (32) and the probabilities (32). While
//   one consumer forms its probabilities, the other's products keep the
//   tensor cores busy.
// - Loads are TMA (cp.async.bulk.tensor, 4-d maps over (hd, heads, seq,
//   batch) built on the host): q once per block, then k and v tiles of 64
//   keys through a ring of 2 stages, each stage with a full and an empty
//   mbarrier for k and for v, so the next tile arrives while this one is
//   multiplied, and v still lands while the scores of its tile are formed.
//   The 128-byte swizzle caps a box at 64 bf16 columns, so a tile of hd 256
//   is 4 boxes of 64 rows x 128 bytes, which is also the layout the wgmma
//   descriptors read. Rows past S or T and columns past hd arrive as zeros
//   (hd pads to 64, 128 or 256 this way).
// - Both products are wgmma with f32 accumulators: S = q k^T as m64n64k16
//   over hd / 16 steps with q and k from shared memory (K-major), then
//   O += P v as m64n{hd}k16 over 4 steps with P in registers (the score
//   accumulator's fragment is the A operand's register layout) and v read
//   transposed (MN-major) from shared memory. P goes in as two bf16 terms,
//   hi = bf16(p) and lo = bf16(p - hi), two products on the same v: one
//   bf16 rounding of P (up to 2^-8 relative) on top of the plain version's
//   own exceeds the bf16 gate at sharp softmaxes (q x 20: 1.05 of it on
//   the H100, tools/kernel_variants.py), hi + lo is within 2^-16 of p; the
//   second product costs 14 % of the kernel's time. The running sum l adds
//   the f32 p.
// - q is scaled in place in shared memory (f32 multiply, rounded back to
//   bf16) before the first product. The softcap's tanh is
//   1 - 2 / (e^{2x} + 1) with __expf (a few f32 ulps; tanh.approx's 2^-11
//   would not meet the bf16 gate); the softmax uses exp2f with log2(e)
//   folded in. The masks are evaluated only on tiles that cross the causal
//   diagonal, the window's lower edge or T; a tile that no row of a
//   warpgroup can see is waited for and released but not computed.
// - ptxas (CUDA 12.8, sm_90a): no spills at hd 64, 128 or 256 (168
//   registers at entry, the consumers' code within their 240);
//   chip_smoke.py prints the report.
//
// f32: flash_attention_kernel, the SIMT kernel (TF32 would not meet the
// f32 gate of 2e-3).
// - One block of 256 threads per (64-query tile, q head, batch row); the
//   block loops only over the 64-key tiles that the causal frontier and
//   the window leave visible (as the Pallas kernel's pl.when does).
// - Tiles are held in shared memory as f32, rows padded by 4 floats so
//   that 16-byte reads of 8 different rows fall in different banks: q 64 x
//   hd, k and v 64 x hd, probabilities 64 x 64 (217,088 bytes at hd 256).
// - Thread (ty, tx) of a 16 x 16 grid owns query rows 4ty .. 4ty+3 in both
//   products: scores for keys tx + 16j, and output columns 4tx + 64j. The
//   16 threads that share rows form half a warp, so the running max and sum
//   are reduced with warp shuffles and stay in registers. Products are f32
//   FMAs from 16-byte shared-memory reads.
//
// Both launches opt in to more than 48 KB of shared memory with
// cudaFuncSetAttribute; a refused launch returns its CUDA error, which the
// wrapper raises on.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_common.cuh"

namespace repro_torch {
namespace {

constexpr float kNegInf = -1073741824.0f;   // -2^30, the plain version's NEG_INF

// ---------------------------------------------------------------------------
// f32: the SIMT kernel
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store4(float4 v, float* p) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ float round(float v) { return v; }
};

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

template <int HDP>
constexpr size_t smem_bytes() {
  return ((kBQ + 2 * kBK) * (HDP + 4) + kBQ * (kBK + 4)) * sizeof(float);
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int S, int T_len, int H, int group, int hd,
                           int64_t qsb, int64_t qss, int64_t qsh,
                           int64_t ksb, int64_t kss, int64_t ksh,
                           int64_t vsb, int64_t vss, int64_t vsh,
                           int causal, int window, float softcap,
                           float scale) {
  constexpr int LD = HDP + 4;     // row stride of the q, k, v tiles (floats)
  constexpr int LDP = kBK + 4;    // row stride of the probability tile
  constexpr int NJ = HDP / 64;    // 4-wide output column groups per thread
  constexpr int C4 = HDP / 4;     // 4-wide chunks per row
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sP = sV + kBK * LD;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const T* qb = q + bi * qsb + h * qsh;
  const T* kb = k + bi * ksb + (h / group) * ksh;
  const T* vb = v + bi * vsb + (h / group) * vsh;

  for (int i = tid; i < kBQ * C4; i += kThreads) {
    const int r = i / C4, d = (i % C4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S && d < hd) {
      x = Io<T>::load4(qb + (q0 + r) * qss + d);
      x.x = Io<T>::round(__fmul_rn(x.x, scale));
      x.y = Io<T>::round(__fmul_rn(x.y, scale));
      x.z = Io<T>::round(__fmul_rn(x.z, scale));
      x.w = Io<T>::round(__fmul_rn(x.w, scale));
    }
    *reinterpret_cast<float4*>(sQ + r * LD + d) = x;
  }

  // the key tiles some query of this tile can see
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_hi = causal ? min(T_len - 1, q_last) : T_len - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_first = k_lo / kBK;
  const int kt_last = k_hi >= k_lo ? k_hi / kBK : kt_first - 1;

  float m[4], l[4], acc[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();    // the previous tile's reads of sK, sV are done
    for (int i = tid; i < kBK * C4; i += kThreads) {
      const int r = i / C4, d = (i % C4) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < T_len && d < hd) {
        kx = Io<T>::load4(kb + (k0 + r) * kss + d);
        vx = Io<T>::load4(vb + (k0 + r) * vss + d);
      }
      *reinterpret_cast<float4*>(sK + r * LD + d) = kx;
      *reinterpret_cast<float4*>(sV + r * LD + d) = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (ty * 4 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qp = q0 + r;
      unsigned ok = 0;
      float mt = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool vis = kp < T_len && (!causal || kp <= qp) &&
                         (window <= 0 || kp > qp - window);
        ok |= static_cast<unsigned>(vis) << j;
        s[i][j] = vis ? x : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = half_warp_max(mt);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (ok >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        sP[r * LDP + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= corr;
    }
    __syncwarp();   // this half warp's probability rows are written

#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t =
            *reinterpret_cast<const float4*>(sP + (ty * 4 + i) * LDP + c);
        p[i][0] = t.x;
        p[i][1] = t.y;
        p[i][2] = t.z;
        p[i][3] = t.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 vv = *reinterpret_cast<const float4*>(
              sV + (c + cc) * LD + tx * 4 + 64 * j);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][j][0] = fmaf(p[i][cc], vv.x, acc[i][j][0]);
            acc[i][j][1] = fmaf(p[i][cc], vv.y, acc[i][j][1]);
            acc[i][j][2] = fmaf(p[i][cc], vv.z, acc[i][j][2]);
            acc[i][j][3] = fmaf(p[i][cc], vv.w, acc[i][j][3]);
          }
        }
    }
  }

  const int64_t H64 = H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= S) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = out + ((bi * S + qp) * H64 + h) * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx * 4 + 64 * j;
      if (d < hd)
        Io<T>::store4(make_float4(acc[i][j][0] / li, acc[i][j][1] / li,
                                  acc[i][j][2] / li, acc[i][j][3] / li),
                      orow + d);
    }
  }
}

template <typename T, int HDP>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              long long B, long long S, long long T_len, long long H,
              long long K, long long hd, const long long* st, int causal,
              int window, float softcap, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>((S + kBQ - 1) / kBQ),
            static_cast<unsigned>(H), static_cast<unsigned>(B));
  flash_attention_kernel<T, HDP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), static_cast<int>(S),
      static_cast<int>(T_len), static_cast<int>(H), static_cast<int>(H / K),
      static_cast<int>(hd), st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, void* out,
               long long B, long long S, long long T_len, long long H,
               long long K, long long hd, const long long* strides, int causal,
               int window, float softcap, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    return launch_hd<float, 64>(q, k, v, out, B, S, T_len, H, K, hd, strides,
                                causal, window, softcap, scale, s);
  if (hd <= 128)
    return launch_hd<float, 128>(q, k, v, out, B, S, T_len, H, K, hd,
                                 strides, causal, window, softcap, scale, s);
  return launch_hd<float, 256>(q, k, v, out, B, S, T_len, H, K, hd, strides,
                               causal, window, softcap, scale, s);
}


// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA, warp specialisation
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int kBQ = 128;       // query rows per block, 64 per consumer warpgroup
constexpr int kBK = 64;        // keys per kv tile
constexpr int kStages = 2;     // ring depth of the k and v tiles
constexpr int kThreads = 384;  // warpgroups 0 and 1 compute, 2 loads

// Shared memory, in bytes from a 1024-byte aligned base (the swizzle's
// period): q (one 64-row tile per consumer), the k ring, the v ring, then
// the mbarriers.
template <int HDP>
struct Layout {
  static constexpr int kBoxes = HDP / kBoxCols;
  static constexpr uint32_t kTile = kBoxes * kBoxBytes;   // 64 rows x HDP
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = 2 * kTile;
  static constexpr uint32_t kV = kK + kStages * kTile;
  static constexpr uint32_t kBar = kV + kStages * kTile;
  static constexpr uint32_t kBytes = kBar + 128 + 1024;   // + alignment slack
};

// mbarrier indices: q full; k full, v full, k empty, v empty per stage
__device__ __forceinline__ int bar_k_full(int s) { return 1 + s; }
__device__ __forceinline__ int bar_v_full(int s) { return 1 + kStages + s; }
__device__ __forceinline__ int bar_k_empty(int s) { return 1 + 2 * kStages + s; }
__device__ __forceinline__ int bar_v_empty(int s) { return 1 + 3 * kStages + s; }

// running max and (per-thread partial) sum of a thread's two rows
struct Rows {
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
};

// Scores of one 64-key tile (the wgmma fragment: element e of a thread is
// row row0 + 8 ((e / 2) % 2), key k0 + 8 (e / 4) + col0 + e % 2) to f32
// probabilities in place, with the running max and sum updated and the
// rescale factors of the output rows returned. Softcap, then the masks
// (edge tiles only), then the online softmax.
__device__ __forceinline__ void probabilities(
    float (&sc)[32], Rows& rows, float& corr0, float& corr1, bool edge,
    int k0, int row0, int col0, int T_len, int causal, int window,
    float softcap, float inv_cap) {
  if (softcap > 0.f) {
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = softcap * tanh_exp(sc[e] * inv_cap);
  }
  uint32_t ok = 0xffffffffu;
  if (edge) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int kp = k0 + 8 * (e / 4) + col0 + (e & 1);
      const int qp = row0 + ((e & 2) ? 8 : 0);
      const bool v = kp < T_len && (!causal || kp <= qp) &&
                     (window <= 0 || kp > qp - window);
      if (!v) {
        ok &= ~(1u << e);
        sc[e] = kNegInf;
      }
    }
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
  corr0 = exp2f((rows.m0 - mx0) * kLog2e);
  corr1 = exp2f((rows.m1 - mx1) * kLog2e);
  rows.m0 = mx0;
  rows.m1 = mx1;
  const float ms0 = mx0 * kLog2e, ms1 = mx1 * kLog2e;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const bool r1 = e & 2;
    const float p = (ok >> e) & 1u
                        ? exp2f(fmaf(sc[e], kLog2e, r1 ? -ms1 : -ms0))
                        : 0.f;
    sc[e] = p;
    if (r1) rs1 += p; else rs0 += p;
  }
  // per-thread partial sums; the quad adds them up at the end
  rows.l0 = rows.l0 * corr0 + rs0;
  rows.l1 = rows.l1 * corr1 + rs1;
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel_tc(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              __nv_bfloat16* __restrict__ out, int S,
                              int T_len, int H, int group, int hd, int causal,
                              int window, float softcap, float scale) {
  using L = Layout<HDP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  auto bar = [base](int i) { return base + L::kBar + 8u * i; };

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int b = blockIdx.z;

  // the key tiles some query of this block can see
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_hi = causal ? min(T_len - 1, q_last) : T_len - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_first = k_lo / kBK;
  const int n_tiles = k_hi >= k_lo ? k_hi / kBK - kt_first + 1 : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar(0), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar(bar_k_full(s)), 1);
      mbar_init(bar(bar_v_full(s)), 1);
      mbar_init(bar(bar_k_empty(s)), 256);   // every consumer thread arrives
      mbar_init(bar(bar_v_empty(s)), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      const int kvh = h / group;
      mbar_expect_tx(bar(0), 2 * L::kTile);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load(base + L::kQ + w * L::kTile + c * kBoxBytes, &map_q,
                   bar(0), c * kBoxCols, h, q0 + 64 * w, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t parity = (i / kStages) & 1;
        const int k0 = (kt_first + i) * kBK;
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
    const float inv_cap = softcap > 0.f ? 1.0f / softcap : 0.f;

    if (active) {
      // q_scaled = q * scale rounded to bf16, in place (elementwise, so the
      // swizzle does not matter), then made visible to the tensor cores
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
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      warpgroup_sync(1 + wg);
    }

    float o[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
    Rows rows;

    // The tiles this warpgroup's rows see are a contiguous run i_lo .. i_hi
    // of the block's; the others are still waited for and released, in
    // order, but not computed.
    const int i_lo = active ? max(0, wk_lo / kBK - kt_first) : n_tiles;
    const int i_hi = active ? min(n_tiles - 1, wk_hi / kBK - kt_first) : -1;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      const bool vis = i_lo <= i && i <= i_hi;
      const int k0 = (kt_first + i) * kBK;

      // S = q k^T on the tensor cores
      float sc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.f;
      mbar_wait(bar(bar_k_full(s)), parity);
      if (vis) {
        __syncwarp();   // converged for the .aligned wgmma instructions
        const uint32_t sk = base + L::kK + s * L::kTile;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < HDP / 16; ++ks) {
          const uint32_t off = (ks / 4) * kBoxBytes + (ks % 4) * 32;
          wgmma_ss_m64n64(sc, desc_k_major(sq + off), desc_k_major(sk + off),
                          ks > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
      }
      mbar_arrive(bar(bar_k_empty(s)));

      // probabilities, split for P v; the output rows rescaled
      uint32_t ph[16], pl[16];
      if (vis) {
        const bool edge = !(k0 + kBK - 1 < T_len &&
                            (!causal || k0 + kBK - 1 <= qa) &&
                            (window <= 0 || k0 > qb - window));
        float corr0, corr1;
        probabilities(sc, rows, corr0, corr1, edge, k0, row0, col0, T_len,
                      causal, window, softcap, inv_cap);
        split_bf16(sc, ph, pl);
#pragma unroll
        for (int j = 0; j < HDP / 8; ++j) {
          o[4 * j] *= corr0;
          o[4 * j + 1] *= corr0;
          o[4 * j + 2] *= corr1;
          o[4 * j + 3] *= corr1;
        }
      }

      // O += (P_hi + P_lo) v on the tensor cores
      mbar_wait(bar(bar_v_full(s)), parity);
      if (vis) {
        __syncwarp();
        const uint32_t sv = base + L::kV + s * L::kTile;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks) {
          const uint64_t dv = desc_mn_major(sv + ks * 16 * 128);
          const uint32_t ah[4] = {ph[4 * ks], ph[4 * ks + 1], ph[4 * ks + 2],
                                  ph[4 * ks + 3]};
          const uint32_t al[4] = {pl[4 * ks], pl[4 * ks + 1], pl[4 * ks + 2],
                                  pl[4 * ks + 3]};
          wgmma_rs<HDP>(o, ah, dv);
          wgmma_rs<HDP>(o, al, dv);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
        fence_regs(ph);
        fence_regs(pl);
      }
      mbar_arrive(bar(bar_v_empty(s)));
    }

    if (active) {
      float l0 = rows.l0, l1 = rows.l1;
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
      const int64_t H64 = H;
      __nv_bfloat16* o0 =
          out + ((static_cast<int64_t>(b) * S + row0) * H64 + h) * hd;
      __nv_bfloat16* o1 = o0 + 8 * H64 * hd;
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
        const int c = 8 * j + col0;
        if (c < hd) {
          if (row0 < S)
            *reinterpret_cast<__nv_bfloat162*>(o0 + c) =
                __floats2bfloat162_rn(o[4 * j] / d0, o[4 * j + 1] / d0);
          if (row1 < S)
            *reinterpret_cast<__nv_bfloat162*>(o1 + c) =
                __floats2bfloat162_rn(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
        }
      }
    }
  }
}

template <int HDP>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              long long B, long long S, long long T_len, long long H,
              long long K, long long hd, long long hd_in, const long long* st,
              int causal, int window, float softcap, float scale,
              cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!encode(&mq, q, hd_in, H, S, B, st[2], st[1], st[0]) ||
      !encode(&mk, k, hd_in, K, T_len, B, st[5], st[4], st[3]) ||
      !encode(&mv, v, hd_in, K, T_len, B, st[8], st[7], st[6]))
    return kTensorMapRefused;
  constexpr uint32_t smem = Layout<HDP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel_tc<HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>(H), static_cast<unsigned>((S + kBQ - 1) / kBQ),
            static_cast<unsigned>(B));
  flash_attention_kernel_tc<HDP><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), static_cast<int>(S),
      static_cast<int>(T_len), static_cast<int>(H), static_cast<int>(H / K),
      static_cast<int>(hd), causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, void* out, long long B,
           long long S, long long T_len, long long H, long long K, long long hd,
           long long hd_in, const long long* st, int causal, int window,
           float softcap, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd_in <= 64)
    return launch_hd<64>(q, k, v, out, B, S, T_len, H, K, hd, hd_in, st,
                         causal, window, softcap, scale, s);
  if (hd_in <= 128)
    return launch_hd<128>(q, k, v, out, B, S, T_len, H, K, hd, hd_in, st,
                          causal, window, softcap, scale, s);
  return launch_hd<256>(q, k, v, out, B, S, T_len, H, K, hd, hd_in, st, causal,
                        window, softcap, scale, s);
}

}  // namespace tc

}  // namespace
}  // namespace repro_torch

// strides: 9 element strides (batch, sequence, head) of q, k and v; the
// head_dim stride is 1 and out is contiguous.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, long long B, long long S,
                                   long long T, long long H, long long K,
                                   long long hd, const long long* strides,
                                   int causal, int window, float softcap,
                                   float scale, void* stream) {
  return repro_torch::launch_f32(q, k, v, out, B, S, T, H, K, hd, strides,
                                 causal, window, softcap, scale, stream);
}

// bf16: q, k, v hold hd_in >= hd columns (hd rounded up to 8, the extra
// ones zero), with 16-byte aligned bases and strides (TMA); out holds hd.
// Returns -1 if the driver refuses a tensor map.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* out, long long B, long long S,
                                    long long T, long long H, long long K,
                                    long long hd, long long hd_in,
                                    const long long* strides, int causal,
                                    int window, float softcap, float scale,
                                    void* stream) {
  return repro_torch::tc::launch(q, k, v, out, B, S, T, H, K, hd, hd_in,
                                 strides, causal, window, softcap, scale,
                                 stream);
}
