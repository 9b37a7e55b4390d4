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
//
// B3', the scan's vector-Jacobian product (rglru_scan_bwd_*): the JAX
// package differentiates its XLA scan and has no backward kernel; this one
// replaces autograd's T-step loop through the plain version. Given the
// cotangents g (B, T, W) of h and g_last (B, W) of h_last, stepping back in
// time with a_t = exp(log_a_t) and h_{t-1} the f32 carry (h0 first):
//
//   l_{T-1} = g_{T-1} + g_last,  l_t = g_t + a_{t+1} * l_{t+1}
//   db_t = l_t,  dlog_a_t = (l_t * h_{t-1}) * a_t,  dh0 = l_0 * a_0
//
// Bound: device-memory bytes, as the forward: per element an exp and four
// flops on three loads (log_a, g and the carry's source) and two stores.
// Design: the forward's parallelism, one thread per (batch row, channel)
// walking T in reverse with l in a register; a block is one warp of 32
// channels, so a step's loads and stores are one 128-byte row segment per
// array (f32). The loads do not depend on l, so each thread issues those of
// kBwdU steps together into registers before it steps through them. expf,
// __fmul_rn and __fadd_rn in the plain version's order keep the kernel
// equal to it bit for bit. For f32 inputs the saved output h IS the carry
// and is read; a bf16 output is not (and is not kept), so for bf16 the
// thread first walks T forwards writing its f32 carry to a scratch buffer
// (B, T, W) f32 that the wrapper allocates, then reads it back in reverse
// (its own writes: no synchronisation).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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

constexpr int kBwdCh = 32;    // channels (threads) per block: one warp
constexpr int kBwdU = 16;     // steps whose loads are issued together

// step back through steps hi, hi - 1, ... hi - n + 1 (n <= kBwdU)
template <typename T, bool kScratch, bool kFull>
__device__ __forceinline__ void bwd_steps(
    const T* __restrict__ la, const T* __restrict__ gh,
    const T* __restrict__ hs, const float* __restrict__ carry, float hinit,
    T* __restrict__ dla, T* __restrict__ db, int64_t hi, int n, int64_t W,
    float& lam, float& a_next) {
  float x[kBwdU], g[kBwdU], hp[kBwdU];
#pragma unroll
  for (int u = 0; u < kBwdU; ++u) {
    if (kFull || u < n) {
      const int64_t t = hi - u;
      x[u] = to_f32(la[t * W]);
      g[u] = to_f32(gh[t * W]);
      if (t == 0)
        hp[u] = hinit;
      else if constexpr (kScratch)
        hp[u] = carry[(t - 1) * W];
      else
        hp[u] = to_f32(hs[(t - 1) * W]);
    }
  }
#pragma unroll
  for (int u = 0; u < kBwdU; ++u) {
    if (kFull || u < n) {
      const int64_t t = hi - u;
      const float a = expf(x[u]);
      lam = __fadd_rn(g[u], __fmul_rn(lam, a_next));
      store(lam, db + t * W);
      store(__fmul_rn(__fmul_rn(lam, hp[u]), a), dla + t * W);
      a_next = a;
    }
  }
}

template <typename T, bool kScratch>
__global__ void __launch_bounds__(kBwdCh)
    rglru_scan_bwd_kernel(const T* __restrict__ log_a,
                          const T* __restrict__ b,
                          const float* __restrict__ h0,
                          const T* __restrict__ h, const T* __restrict__ g_h,
                          const float* __restrict__ g_last,
                          T* __restrict__ dlog_a, T* __restrict__ db,
                          float* __restrict__ dh0, float* __restrict__ carry,
                          int64_t steps, int64_t W) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kBwdCh + threadIdx.x;
  if (w >= W) return;
  const int64_t row = blockIdx.y;
  const int64_t base = row * steps * W + w;
  const float hinit = h0 ? h0[row * W + w] : 0.f;
  if constexpr (kScratch) {
    // the f32 carry after each step, as the forward computes it
    float c = hinit;
    for (int64_t t0 = 0; t0 < steps; t0 += kBwdU) {
      float x[kBwdU], y[kBwdU];
      const int n = static_cast<int>(steps - t0 < kBwdU ? steps - t0 : kBwdU);
#pragma unroll
      for (int u = 0; u < kBwdU; ++u)
        if (u < n) {
          x[u] = to_f32(log_a[base + (t0 + u) * W]);
          y[u] = to_f32(b[base + (t0 + u) * W]);
        }
#pragma unroll
      for (int u = 0; u < kBwdU; ++u)
        if (u < n) {
          c = step(c, x[u], y[u]);
          carry[base + (t0 + u) * W] = c;
        }
    }
  }
  // l_T = g_last with a_T = 1, so that l_{T-1} = g_{T-1} + g_last exactly
  float lam = g_last ? g_last[row * W + w] : 0.f;
  float a_next = 1.f;
  const T* la = log_a + base;
  const T* gh = g_h + base;
  const T* hs = kScratch ? nullptr : h + base;
  const float* cs = kScratch ? carry + base : nullptr;
  T* dl = dlog_a + base;
  T* dbb = db + base;
  int64_t hi = steps - 1;
  for (; hi + 1 >= kBwdU; hi -= kBwdU)
    bwd_steps<T, kScratch, true>(la, gh, hs, cs, hinit, dl, dbb, hi, kBwdU, W,
                                 lam, a_next);
  if (hi >= 0)
    bwd_steps<T, kScratch, false>(la, gh, hs, cs, hinit, dl, dbb, hi,
                                  static_cast<int>(hi + 1), W, lam, a_next);
  dh0[row * W + w] = __fmul_rn(lam, a_next);
}

template <typename T>
int launch_bwd(const void* log_a, const void* b, const void* h0,
               const void* h, const void* g_h, const void* g_last,
               void* dlog_a, void* db, void* dh0, void* carry, long long B,
               long long steps, long long W, void* stream) {
  // the saved output is the carry only for f32 inputs
  const bool scratch = h == nullptr || !std::is_same<T, float>::value;
  if (scratch && carry == nullptr) return -1;
  dim3 grid(static_cast<unsigned>((W + kBwdCh - 1) / kBwdCh),
            static_cast<unsigned>(B));
  auto kernel = scratch ? rglru_scan_bwd_kernel<T, true>
                        : rglru_scan_bwd_kernel<T, false>;
  kernel<<<grid, kBwdCh, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(log_a), static_cast<const T*>(b),
      static_cast<const float*>(h0), static_cast<const T*>(h),
      static_cast<const T*>(g_h), static_cast<const float*>(g_last),
      static_cast<T*>(dlog_a), static_cast<T*>(db), static_cast<float*>(dh0),
      static_cast<float*>(carry), steps, W);
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

// B3': h0 and g_last may be null (zeros); h, the forward's output, may be
// null; carry is an f32 (B, T, W) scratch buffer, needed for bf16 or
// without h (else null: the f32 output is the carry).
extern "C" int rglru_scan_bwd_f32(const void* log_a, const void* b,
                                  const void* h0, const void* h,
                                  const void* g_h, const void* g_last,
                                  void* dlog_a, void* db, void* dh0,
                                  void* carry, long long B, long long T,
                                  long long W, void* stream) {
  return repro_torch::launch_bwd<float>(log_a, b, h0, h, g_h, g_last, dlog_a,
                                        db, dh0, carry, B, T, W, stream);
}

extern "C" int rglru_scan_bwd_bf16(const void* log_a, const void* b,
                                   const void* h0, const void* h,
                                   const void* g_h, const void* g_last,
                                   void* dlog_a, void* db, void* dh0,
                                   void* carry, long long B, long long T,
                                   long long W, void* stream) {
  return repro_torch::launch_bwd<__nv_bfloat16>(log_a, b, h0, h, g_h, g_last,
                                                dlog_a, db, dh0, carry, B, T,
                                                W, stream);
}
