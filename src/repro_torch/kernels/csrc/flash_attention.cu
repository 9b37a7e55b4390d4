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
// rate at every shape the model runs.
//
// Design, a simple kernel that is right first (tensor cores, TMA and
// warp specialisation are later work):
// - One block of 256 threads per (64-query tile, q head, batch row). A block
//   indexes its kv head as h / (H / K) itself: the 16 q heads of one MQA kv
//   head re-read the same k and v tiles, which stay in the 50 MB L2.
// - The block loops only over the 64-key tiles that the causal frontier and
//   the window leave visible (as the Pallas kernel's pl.when does), so a
//   4096-token prompt with a 2048 window costs about 34 tiles per query tile
//   instead of 64.
// - Tiles are held in shared memory as f32 (converted once at load, rows
//   padded by 4 floats so that 16-byte reads of 8 different rows fall in
//   different banks): q 64 x hd, k and v 64 x hd, probabilities 64 x 64.
//   At hd 256 that is 217,088 bytes, above the 48 KB default, so the launch
//   opts in with cudaFuncSetAttribute; a refused launch returns its CUDA
//   error, which the wrapper raises on.
// - Thread (ty, tx) of a 16 x 16 grid owns query rows 4ty .. 4ty+3 in both
//   products: scores for keys tx + 16j, and output columns 4tx + 64j. The
//   16 threads that share rows form half a warp, so the running max and sum
//   are reduced with warp shuffles and stay in registers, and the
//   probability tile they write is read back by the same warp after a
//   __syncwarp. Products are f32 FMAs from 16-byte shared-memory reads.
// - hd is padded with zeros to the tile width (64, 128 or 256); ragged S
//   and T are masked per row and per key.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {
namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1073741824.0f;   // -2^30, the plain version's NEG_INF

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

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void store4(float4 v, __nv_bfloat16* p) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 raw;
    raw.x = *reinterpret_cast<uint32_t*>(&lo);
    raw.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = raw;
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
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

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, long long B,
           long long S, long long T_len, long long H, long long K, long long hd,
           const long long* strides, int causal, int window, float softcap,
           float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    return launch_hd<T, 64>(q, k, v, out, B, S, T_len, H, K, hd, strides,
                            causal, window, softcap, scale, s);
  if (hd <= 128)
    return launch_hd<T, 128>(q, k, v, out, B, S, T_len, H, K, hd, strides,
                             causal, window, softcap, scale, s);
  return launch_hd<T, 256>(q, k, v, out, B, S, T_len, H, K, hd, strides,
                           causal, window, softcap, scale, s);
}

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
  return repro_torch::launch<float>(q, k, v, out, B, S, T, H, K, hd, strides,
                                    causal, window, softcap, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* out, long long B, long long S,
                                    long long T, long long H, long long K,
                                    long long hd, const long long* strides,
                                    int causal, int window, float softcap,
                                    float scale, void* stream) {
  return repro_torch::launch<__nv_bfloat16>(q, k, v, out, B, S, T, H, K, hd,
                                            strides, causal, window, softcap,
                                            scale, stream);
}
