// Population-level fused Eq.-(6) consensus update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/consensus_update.py
// (consensus_update / _consensus_kernel), which the JAX package calls once
// per agent under vmap on a pre-gathered (H, N) neighbour block. Here one
// launch covers K owned rows of one parameter leaf:
//
//   out[k, n] = x[k, n] + sum_h sig[k, h] * (src[idx[k, h], n] - x[k, n])
//
// x (K, N) f32 or bf16, src (Ks, N) of x's type (the population itself,
// src == x, on the sparse plan; the gathered wire on the sharded plan; the
// received payloads on the distributed plan), idx (K, H) int32 in [0, Ks),
// sig (K, H) f32 -> out (K, N) in x's type, accumulated in f32 in fixed h
// order. A lane with sig = 0 adds 0 * (src - x) = +0 for finite values: an
// exact no-op (padding lanes index the agent itself).
//
// Bound: device-memory bytes. The kernel does 3 flops per neighbour per
// element on data it must stream, far below the card's flops-per-byte
// balance. Counting each input byte read once and each output byte written
// once, that is 8 * K * N bytes in f32 (4 * K * N in bf16) plus the 8 * K * H
// of the lane tables, and the source's own rows where it is not x. Each row is re-read by its H neighbours' blocks;
// those re-reads are expected to hit the 50 MB L2, since blocks of nearby
// agents run together and a ring's or small world's neighbours are mostly
// nearby. Each thread moves 16 bytes per load (4 f32 or 8 bf16); a ragged
// tail or a misaligned row falls back to masked scalar loads.
#include <cuda_bf16.h>

#include "consensus_common.cuh"

namespace repro_torch {
namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    consensus_pop_kernel(const T* __restrict__ x, const T* __restrict__ src,
                         const int* __restrict__ idx,
                         const float* __restrict__ sig, T* __restrict__ out,
                         int64_t N, int H, int64_t Ks, int vec_ok) {
  extern __shared__ int smem[];
  int* s_idx = smem;
  float* s_sig = reinterpret_cast<float*>(smem + H);
  const int64_t k = blockIdx.y;
  load_lanes(idx, sig, k, H, Ks, s_idx, s_sig);

  constexpr int V = 16 / sizeof(T);
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * V;
  if (base >= N) return;
  const T* xk = x + k * N;
  T* ok = out + k * N;

  if (vec_ok && base + V <= N) {
    float xv[V], acc[V];
    const uint4 raw = *reinterpret_cast<const uint4*>(xk + base);
    const T* xe = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      xv[i] = to_f32(xe[i]);
      acc[i] = 0.0f;
    }
    for (int h = 0; h < H; ++h) {
      const float s = s_sig[h];
      const uint4 nraw = *reinterpret_cast<const uint4*>(
          src + static_cast<int64_t>(s_idx[h]) * N + base);
      const T* ne = reinterpret_cast<const T*>(&nraw);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = combine(acc[i], s, to_f32(ne[i]), xv[i]);
    }
    uint4 o;
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int i = 0; i < V; ++i) from_f32(__fadd_rn(xv[i], acc[i]), oe + i);
    *reinterpret_cast<uint4*>(ok + base) = o;
    return;
  }
  for (int64_t n = base; n < base + V && n < N; ++n) {
    const float xv = to_f32(xk[n]);
    float acc = 0.0f;
    for (int h = 0; h < H; ++h)
      acc = combine(acc, s_sig[h],
                    to_f32(src[static_cast<int64_t>(s_idx[h]) * N + n]), xv);
    from_f32(__fadd_rn(xv, acc), ok + n);
  }
}

template <typename T>
int launch(const void* x, const void* src, const void* idx, const void* sig,
           void* out, long long K, long long N, int H, long long Ks,
           int vec_ok, void* stream) {
  constexpr int V = 16 / sizeof(T);
  const long long tile = static_cast<long long>(kThreads) * V;
  dim3 grid(static_cast<unsigned>((N + tile - 1) / tile),
            static_cast<unsigned>(K));
  const size_t smem = static_cast<size_t>(H) * (sizeof(int) + sizeof(float));
  consensus_pop_kernel<T><<<grid, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(src),
      static_cast<const int*>(idx), static_cast<const float*>(sig),
      static_cast<T*>(out), N, H, Ks, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

extern "C" int consensus_update_pop_f32(const void* x, const void* src,
                                        const void* idx, const void* sig,
                                        void* out, long long K, long long N,
                                        int H, long long Ks, int vec_ok,
                                        void* stream) {
  return repro_torch::launch<float>(x, src, idx, sig, out, K, N, H, Ks, vec_ok,
                                    stream);
}

extern "C" int consensus_update_pop_bf16(const void* x, const void* src,
                                         const void* idx, const void* sig,
                                         void* out, long long K, long long N,
                                         int H, long long Ks, int vec_ok,
                                         void* stream) {
  return repro_torch::launch<__nv_bfloat16>(x, src, idx, sig, out, K, N, H, Ks,
                                            vec_ok, stream);
}
