// RG-LRU linear recurrence for Hopper (sm_90a):
//
//   h_t = exp(log_a_t) * h_{t-1} + b_t,   t = 0 .. T-1, carry in f32
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (rglru_scan / _rglru_kernel). log_a, b (B, T, W) f32 or bf16 and h0 (B, W)
// f32 -> h (B, T, W) in log_a's type and h_last (B, W) f32.
//
// Bound: device-memory bytes. Each step is one exp and two flops per
// channel on 2 loads and 1 store; counting each input read once and each
// output written once, that is (2 + 1) * B * T * W elements plus the two
// (B, W) f32 rows, far below the card's flops-per-byte balance.
//
// Design: parallel over (batch, channel), serial in time. One thread owns
// one channel of one batch row and walks T with the carry in a register, so
// nothing crosses threads or blocks and the TPU kernel's time chunking (a
// VMEM carry between grid steps) has no counterpart. Neighbouring threads
// own neighbouring channels, so every load and store of a step is one
// coalesced row segment. The loads of kUnroll steps are issued before their
// serial updates, keeping kUnroll * 2 loads in flight per thread to cover
// device-memory latency with only B * W threads. Small blocks (kThreads)
// spread the B * W threads over all SMs. exp is expf and the update is
// __fmul_rn then __fadd_rn (no FMA contraction), so the kernel equals a
// plain version that steps in the same order bit for bit. A ragged W is
// masked per thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {
namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float v, float* out) { *out = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float step(float h, float log_a, float b) {
  return __fadd_rn(__fmul_rn(expf(log_a), h), b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const T* __restrict__ log_a, const T* __restrict__ b,
                      const float* __restrict__ h0, T* __restrict__ out,
                      float* __restrict__ h_last, int64_t steps, int64_t W) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (w >= W) return;
  const int64_t row = blockIdx.y;
  const int64_t base = row * steps * W + w;
  const T* la = log_a + base;
  const T* bb = b + base;
  T* o = out + base;
  float h = h0[row * W + w];

  int64_t t = 0;
  for (; t + kUnroll <= steps; t += kUnroll) {
    float a[kUnroll], x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a[u] = to_f32(la[(t + u) * W]);
      x[u] = to_f32(bb[(t + u) * W]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = step(h, a[u], x[u]);
      store(h, o + (t + u) * W);
    }
  }
  for (; t < steps; ++t) {
    h = step(h, to_f32(la[t * W]), to_f32(bb[t * W]));
    store(h, o + t * W);
  }
  h_last[row * W + w] = h;
}

template <typename T>
int launch(const void* log_a, const void* b, const void* h0, void* out,
           void* h_last, long long B, long long steps, long long W,
           void* stream) {
  dim3 grid(static_cast<unsigned>((W + kThreads - 1) / kThreads),
            static_cast<unsigned>(B));
  rglru_scan_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(log_a), static_cast<const T*>(b),
      static_cast<const float*>(h0), static_cast<T*>(out),
      static_cast<float*>(h_last), steps, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

extern "C" int rglru_scan_f32(const void* log_a, const void* b, const void* h0,
                              void* out, void* h_last, long long B,
                              long long T, long long W, void* stream) {
  return repro_torch::launch<float>(log_a, b, h0, out, h_last, B, T, W, stream);
}

extern "C" int rglru_scan_bf16(const void* log_a, const void* b, const void* h0,
                               void* out, void* h_last, long long B,
                               long long T, long long W, void* stream) {
  return repro_torch::launch<__nv_bfloat16>(log_a, b, h0, out, h_last, B, T, W,
                                            stream);
}
