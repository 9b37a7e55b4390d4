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
// nothing crosses threads and the TPU kernel's time chunking (a VMEM carry
// between grid steps) has no counterpart. exp is expf and the update is
// __fmul_rn then __fadd_rn (no FMA contraction), so the kernel equals a
// plain version that steps in the same order bit for bit.
//
// The loads are what a serial walk cannot hide by itself, so they arrive
// through a pipeline: a block of kCh threads (kCh channels of one batch
// row) stages tiles of kSteps steps x kCh channels of both inputs into
// shared memory with cp.async (16-byte copies, spread over the block's
// threads), in a ring of kStages tiles. While a thread walks tile i from
// shared memory, the copies of tiles i+1 .. i+kStages-1 are in flight: 16 KB
// a block in f32, about 32 KB on each SM at recurrentgemma-9b's prefill
// (B * W / kCh = 256 blocks, two on each SM). The ring's shape is the
// fastest of a sweep on the H100 (tools/kernel_variants.py, PERF.md):
// 32-step tiles in rings of 3 to 8 (48 to 112 KB in flight a block) ran
// 13-34 % slower, rings of 2 21-59 % slower, 32 or 128 channels a block
// the same. Each step's stores are one coalesced row segment per warp. A ragged T ends in a partial tile; a ragged W masks threads
// (they still copy and synchronise). Where W or a base is not 16-byte
// aligned, the tiles are filled with plain loads instead (the same
// arithmetic, without the overlap).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {
namespace {

constexpr int kCh = 64;       // channels (threads) per block
constexpr int kSteps = 16;    // time steps per tile
constexpr int kStages = 3;    // tiles in the ring

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
struct Tile {
  T a[kSteps][kCh];
  T x[kSteps][kCh];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Stage steps t0 .. t0 + kSteps - 1 of channels w0 .. w0 + kCh - 1 (those
// that exist) of one batch row. kVec: 16-byte cp.async copies, chunk c of
// a tile row going to thread c % kCh; else plain loads, each thread its
// own channel.
template <typename T, bool kVec>
__device__ __forceinline__ void load_tile(Tile<T>& tile, const T* la,
                                          const T* bb, int64_t t0,
                                          int64_t steps, int64_t W,
                                          int64_t w0, int tid) {
  if constexpr (kVec) {
    constexpr int kE = 16 / sizeof(T);     // elements per copy
    constexpr int kRow = kCh / kE;         // copies per tile row
#pragma unroll
    for (int j = 0; j < kSteps * kRow / kCh; ++j) {
      const int i = tid + j * kCh;
      const int u = i / kRow, c = (i % kRow) * kE;
      const int64_t t = t0 + u, w = w0 + c;
      if (t < steps && w < W) {
        cp_async16(&tile.a[u][c], la + t * W + w);
        cp_async16(&tile.x[u][c], bb + t * W + w);
      }
    }
  } else {
    const int64_t w = w0 + tid;
    if (w < W) {
      for (int u = 0; u < kSteps && t0 + u < steps; ++u) {
        tile.a[u][tid] = la[(t0 + u) * W + w];
        tile.x[u][tid] = bb[(t0 + u) * W + w];
      }
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kCh)
    rglru_scan_kernel(const T* __restrict__ log_a, const T* __restrict__ b,
                      const float* __restrict__ h0, T* __restrict__ out,
                      float* __restrict__ h_last, int64_t steps, int64_t W) {
  extern __shared__ __align__(16) uint8_t smem[];
  Tile<T>* ring = reinterpret_cast<Tile<T>*>(smem);
  const int tid = threadIdx.x;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kCh;
  const int64_t w = w0 + tid;
  const int64_t row = blockIdx.y;
  const T* la = log_a + row * steps * W;
  const T* bb = b + row * steps * W;
  T* o = out + row * steps * W + w;
  const bool mine = w < W;
  float h = mine ? h0[row * W + w] : 0.f;

  const int64_t n_tiles = (steps + kSteps - 1) / kSteps;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles)
      load_tile<T, kVec>(ring[s], la, bb, s * kSteps, steps, W, w0, tid);
    cp_async_commit();
  }
  for (int64_t i = 0; i < n_tiles; ++i) {
    // tile i has landed for every thread, and every thread is done with
    // tile i - 1, whose slot the next copies refill
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int64_t next = i + kStages - 1;
    if (next < n_tiles)
      load_tile<T, kVec>(ring[next % kStages], la, bb, next * kSteps, steps,
                         W, w0, tid);
    cp_async_commit();

    const Tile<T>& tile = ring[i % kStages];
    const int64_t t0 = i * kSteps;
    if (!mine) continue;
    if (t0 + kSteps <= steps) {
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        h = step(h, to_f32(tile.a[u][tid]), to_f32(tile.x[u][tid]));
        store(h, o + (t0 + u) * W);
      }
    } else {
      for (int u = 0; t0 + u < steps; ++u) {
        h = step(h, to_f32(tile.a[u][tid]), to_f32(tile.x[u][tid]));
        store(h, o + (t0 + u) * W);
      }
    }
  }
  if (mine) h_last[row * W + w] = h;
}

// the ring is dynamic shared memory (24 KB in f32), so that deeper rings
// than the 48 KB static limit can be measured (tools/kernel_variants.py)
template <typename T, bool kVec>
int launch_as(const void* log_a, const void* b, const void* h0, void* out,
              void* h_last, long long B, long long steps, long long W,
              cudaStream_t stream) {
  constexpr int smem = kStages * sizeof(Tile<T>);
  cudaError_t err = cudaFuncSetAttribute(
      rglru_scan_kernel<T, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>((W + kCh - 1) / kCh),
            static_cast<unsigned>(B));
  rglru_scan_kernel<T, kVec><<<grid, kCh, smem, stream>>>(
      static_cast<const T*>(log_a), static_cast<const T*>(b),
      static_cast<const float*>(h0), static_cast<T*>(out),
      static_cast<float*>(h_last), steps, W);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* log_a, const void* b, const void* h0, void* out,
           void* h_last, long long B, long long steps, long long W,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = W % (16 / sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(log_a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  return vec ? launch_as<T, true>(log_a, b, h0, out, h_last, B, steps, W, s)
             : launch_as<T, false>(log_a, b, h0, out, h_last, B, steps, W, s);
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
