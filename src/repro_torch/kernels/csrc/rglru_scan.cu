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
// For f32 inputs the saved output h IS the carry and is read; a bf16
// output is not (and is not kept), so for bf16, or without h, the kernel
// recomputes the carry with the forward's step() first.
//
// Bound: device-memory bytes, as the forward: per element an exp and four
// flops on three loads (log_a, g and the carry's source) and two stores,
// 20 bytes a position in f32 and 10 in bf16 (0.0251 / 0.0125 ms at the
// hybrid's (2, 512, 4096) on the H100). The first design, one thread per
// (batch row, channel) walking T in reverse from device memory, missed it
// by 5-19x: it is latency-bound, 8192 chains of 512 serial steps in
// one-warp blocks (two warps an SM), each step waiting on its loads, and
// for bf16 a second serial walk through an f32 carry scratch of 8 more
// bytes a position.
//
// Design: an exact chunked scan over a thread-block cluster. The adjoint
// is linear, but splitting it into independent pieces would reassociate
// the sum and change the bits; instead time is cut into chunks of
// kBwdSteps steps and only the exact l (and a_next), or for the forward
// walk the exact f32 carry, is handed from chunk to chunk, so every
// element sees the same expf, __fmul_rn and __fadd_rn in the same order as
// the plain version (ref.rglru_scan_backward_reference): the outputs are
// equal bit for bit. The grid is (W / kBwdCh, B, S), one cluster of S
// CTAs along z; CTA s owns chunks s, s + S, s + 2S, ... (a ring; T longer
// than S chunks goes around it more than once). Everything that does not
// depend on the hand-off runs at once in every CTA: the TMA loads of its
// chunk's tiles (kBwdSteps x kBwdCh of log_a, g and the carry's source,
// 3-d tensor maps, zeros out of bounds) and a_t = expf(log_a_t) for the
// whole chunk. What is left serial is a walk through registers and shared
// memory, two dependent flops a step, and one hand-off a chunk: the
// sender stores into the receiver's shared memory (st.shared::cluster)
// and arrives on its mbarrier; CTAs of a cluster are co-scheduled, so the
// wait cannot deadlock the grid. A walk hands off before it stores
// anything to device memory: the arrival's release would wait for those
// stores to land (0.088 -> 0.051 ms in f32 at the hybrid's shape on the
// H100, tools/kernel_variants.py). The reverse walk keeps l in registers,
// hands off, and only then writes d log_a and db.
// Where the carry is recomputed (bf16, or without h), a forward walk of
// the carry runs the same ring the other way; the two chains do not
// depend on each other (only the outputs need both), so with one lap
// each CTA walks first the chain whose hand-off reaches it first, and
// the two run at once. A CTA keeps only its chunk's entry carry, in a
// register for one lap or in an f32 (B, chunks, W) scratch the wrapper
// allocates for more (then every forward walk comes before every
// reverse one); the outputs recompute the chunk's carries from it with
// the same steps. With two laps or more, a CTA loads its next chunk into
// a second slot while it walks. The kernel allocates nothing and uses no
// atomics: a launch is one graph node and two launches give equal bits.
// Where W or a base is not 16-byte
// aligned, each thread loads its own column instead of the TMA (the same
// arithmetic, without the overlap). The launch plan (kBwdCh, kBwdSteps,
// S, shared memory) comes from the wrapper (ops._rglru_scan_backward_plan)
// and is refused if it is not this build's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper_common.cuh"

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

constexpr int kBwdCh = 64;          // channels (threads) a CTA owns: C
constexpr int kBwdSteps = 64;       // steps a chunk holds: L
constexpr int kBwdMaxCluster = 16;  // CTAs a cluster may hold (8 portable)
constexpr int kBwdWrongPlan = -2;   // the wrapper's plan is not this build's
// ahead of the tiles: four mbarriers (two slots' tiles landed, a forward
// and a reverse hand-off arrived), then the three hand-off rows
constexpr int kBwdHead = (4 * 8 + 3 * 4 * kBwdCh + 127) / 128 * 128;
constexpr int kBwdTile = kBwdSteps * kBwdCh;   // elements of one tile

// A CTA's jobs, in order. Reading h (kHasH): a reverse walk of each owned
// chunk, last lap first. With the carry recomputed and one lap: one job
// that runs both walks of the chunk (the two chains are independent: the
// carry's runs 0 -> S-1 while l's runs S-1 -> 0, so a CTA first walks
// the one whose hand-off reaches it first). With more laps, on every rank
// (so that no forward walk waits on a reverse one): a forward walk of
// each owned chunk, first lap first, then a reverse walk of each, last
// lap first. Job j's tiles go to slot j % slots.
struct Jobs {
  int s, S, m;   // cluster rank, cluster size, chunks owned
  bool has_h;
  int laps;      // of the cluster's ring
  __device__ bool split() const { return !has_h && laps > 1; }
  __device__ int count() const { return split() ? 2 * m : m; }
  __device__ int slots() const { return m > 1 ? 2 : 1; }
  __device__ bool forward(int j) const { return split() && j < m; }
  __device__ int chunk(int j) const {
    if (forward(j)) return j * S + s;
    return (m - 1 - (split() ? j - m : j)) * S + s;
  }
};

template <typename T, bool kHasH, bool kVec>
__global__ void __launch_bounds__(kBwdCh)
    rglru_scan_bwd_kernel(const __grid_constant__ CUtensorMap map_la,
                          const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_g,
                          const T* __restrict__ log_a,
                          const T* __restrict__ xs,
                          const T* __restrict__ g_h,
                          const float* __restrict__ h0,
                          const float* __restrict__ g_last,
                          T* __restrict__ dlog_a, T* __restrict__ db,
                          float* __restrict__ dh0,
                          float* __restrict__ entry, int64_t steps,
                          int64_t W, int n_chunks) {
  using namespace hopper;
  extern __shared__ __align__(128) uint8_t bwd_smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(bwd_smem);
  float* carry_in = reinterpret_cast<float*>(bwd_smem + 32);
  float* lam_in = carry_in + kBwdCh;
  float* anext_in = lam_in + kBwdCh;
  T* tiles = reinterpret_cast<T*>(bwd_smem + kBwdHead);

  const int tid = threadIdx.x;
  const int S = static_cast<int>(gridDim.z);
  const int s = static_cast<int>(cluster_ctarank());
  const int64_t row = blockIdx.y;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kBwdCh;
  const int64_t w = w0 + tid;
  const bool mine = w < W;
  const int64_t base = row * steps * W + w;
  // the plan gives every rank a chunk (S <= chunks)
  const Jobs jobs{s, S, (n_chunks - 1 - s) / S + 1, kHasH,
                  (n_chunks + S - 1) / S};
  const int n_jobs = jobs.count(), n_slots = jobs.slots();

  // job j's tiles into slot j % n_slots: log_a, the carry's source (h from
  // a row early, h_{t-1} for step t; else b), and g where the job needs it
  auto issue = [&](int j) {
    const int64_t t0 = static_cast<int64_t>(jobs.chunk(j)) * kBwdSteps;
    const bool with_g = !jobs.forward(j);
    T* slot = tiles + (j % n_slots) * 3 * kBwdTile;
    constexpr int kShift = kHasH ? 1 : 0;
    if constexpr (kVec) {
      if (tid == 0) {
        const uint32_t bar = smem_u32(&bars[j % n_slots]);
        mbar_expect_tx(bar, (with_g ? 3 : 2) * kBwdTile * sizeof(T));
        tma_load_3d(smem_u32(slot), &map_la, bar, static_cast<int>(w0),
                    static_cast<int>(t0), static_cast<int>(row));
        tma_load_3d(smem_u32(slot + kBwdTile), &map_x, bar,
                    static_cast<int>(w0), static_cast<int>(t0 - kShift),
                    static_cast<int>(row));
        if (with_g)
          tma_load_3d(smem_u32(slot + 2 * kBwdTile), &map_g, bar,
                      static_cast<int>(w0), static_cast<int>(t0),
                      static_cast<int>(row));
      }
    } else if (mine) {
      // each thread its own column, which only it reads
      for (int u = 0; u < kBwdSteps && t0 + u < steps; ++u) {
        const int64_t t = t0 + u;
        slot[u * kBwdCh + tid] = log_a[base + t * W];
        if (t - kShift >= 0)
          slot[kBwdTile + u * kBwdCh + tid] = xs[base + (t - kShift) * W];
        if (with_g) slot[2 * kBwdTile + u * kBwdCh + tid] = g_h[base + t * W];
      }
    }
  };

  if (tid == 0) {
    for (int i = 0; i < 4; ++i)
      mbar_init(smem_u32(&bars[i]), i < 2 ? 1 : kBwdCh);
    fence_mbarrier_init_cluster();
  }
  __syncthreads();
  cluster_arrive();
  for (int j = 0; j < n_slots && j < n_jobs; ++j) issue(j);
  // every CTA's mbarriers exist before anyone hands off to it
  cluster_wait();

  const uint32_t next = static_cast<uint32_t>((s + 1) % S);
  const uint32_t prev = static_cast<uint32_t>((s + S - 1) % S);
  const uint32_t carry_next = mapa(smem_u32(&carry_in[tid]), next);
  const uint32_t fwd_bar_next = mapa(smem_u32(&bars[2]), next);
  const uint32_t lam_prev = mapa(smem_u32(&lam_in[tid]), prev);
  const uint32_t anext_prev = mapa(smem_u32(&anext_in[tid]), prev);
  const uint32_t bwd_bar_prev = mapa(smem_u32(&bars[3]), prev);
  const float hinit = h0 != nullptr && mine ? h0[row * W + w] : 0.f;

  // Each walk does first what the hand-off waits for and no more: the
  // forward walk only the carry, the reverse walk only l (kept in
  // registers); then it hands off, and only then are the outputs stored
  // (the hand-off's release would otherwise wait for them to land).
  float a[kBwdSteps];     // a_t of the chunk's steps
  float lam[kBwdSteps];   // l_t of the chunk's steps
  float c_in = hinit;     // the chunk's entry carry (carry recomputed)
  uint32_t n_fwd = 0, n_bwd = 0;   // hand-offs received
  for (int j = 0; j < n_jobs; ++j) {
    const int k = jobs.chunk(j);
    const int64_t t0 = static_cast<int64_t>(k) * kBwdSteps;
    const int n = static_cast<int>(steps - t0 < kBwdSteps ? steps - t0
                                                          : kBwdSteps);
    const T* slot = tiles + (j % n_slots) * 3 * kBwdTile + tid;
    const T* A = slot;
    const T* X = slot + kBwdTile;
    const T* G = slot + 2 * kBwdTile;
    if constexpr (kVec)
      mbar_wait(smem_u32(&bars[j % n_slots]),
                static_cast<uint32_t>(j / n_slots) & 1u);
#pragma unroll
    for (int u = 0; u < kBwdSteps; ++u) a[u] = expf(to_f32(A[u * kBwdCh]));

    // the carry through the chunk from its entry carry, handed on
    auto forward_walk = [&]() {
      c_in = hinit;
      if (k > 0) {
        mbar_wait_cluster(smem_u32(&bars[2]), n_fwd++ & 1u);
        c_in = carry_in[tid];
      }
      float c = c_in;
#pragma unroll
      for (int u = 0; u < kBwdSteps; ++u)
        if (u < n) c = __fadd_rn(__fmul_rn(a[u], c), to_f32(X[u * kBwdCh]));
      if (k + 1 < n_chunks) {
        st_cluster(carry_next, c);
        mbar_arrive_cluster(fwd_bar_next);
      }
    };
    // l back through the chunk, handed on (dh0 from chunk 0)
    auto reverse_walk = [&]() {
      // l_T = g_last with a_T = 1, so that l_{T-1} = g_{T-1} + g_last
      float l = 0.f, a_next = 1.f;
      if (k == n_chunks - 1) {
        if (g_last != nullptr && mine) l = g_last[row * W + w];
      } else {
        mbar_wait_cluster(smem_u32(&bars[3]), n_bwd++ & 1u);
        l = lam_in[tid];
        a_next = anext_in[tid];
      }
#pragma unroll
      for (int u = kBwdSteps - 1; u >= 0; --u)
        if (u < n) {
          l = __fadd_rn(to_f32(G[u * kBwdCh]), __fmul_rn(l, a_next));
          lam[u] = l;
          a_next = a[u];
        }
      if (k > 0) {
        st_cluster(lam_prev, l);
        st_cluster(anext_prev, a_next);
        mbar_arrive_cluster(bwd_bar_prev);
      } else if (mine) {
        dh0[row * W + w] = __fmul_rn(l, a_next);
      }
    };
    // d log_a and db, stepping forwards: h_{t-1} read (h) or recomputed
    // from the entry carry with the forward's steps
    auto outputs = [&]() {
      if (!mine) return;
      T* dl = dlog_a + base;
      T* dbb = db + base;
      float c = c_in;
#pragma unroll
      for (int u = 0; u < kBwdSteps; ++u)
        if (u < n) {
          const int64_t t = t0 + u;
          float hprev;
          if constexpr (kHasH) {
            hprev = t == 0 ? hinit : to_f32(X[u * kBwdCh]);
          } else {
            hprev = c;
            c = __fadd_rn(__fmul_rn(a[u], c), to_f32(X[u * kBwdCh]));
          }
          store(lam[u], dbb + t * W);
          store(__fmul_rn(__fmul_rn(lam[u], hprev), a[u]), dl + t * W);
        }
    };

    if (jobs.forward(j)) {
      forward_walk();
      if (mine) entry[(row * n_chunks + k) * W + w] = c_in;
    } else {
      if constexpr (kHasH) {
        reverse_walk();
      } else if (jobs.split()) {
        c_in = mine ? entry[(row * n_chunks + k) * W + w] : 0.f;
        reverse_walk();
      } else if (2 * k < n_chunks - 1) {
        forward_walk();
        reverse_walk();
      } else {
        reverse_walk();
        forward_walk();
      }
      outputs();
    }
    if (j + n_slots < n_jobs) {
      __syncthreads();   // every thread is done with the slot
      issue(j + n_slots);
    }
  }
}

template <typename T, bool kHasH, bool kVec>
int launch_bwd_as(const void* log_a, const void* xs, const void* g_h,
                  const void* h0, const void* g_last, void* dlog_a, void* db,
                  void* dh0, void* entry, long long B, long long steps,
                  long long W, int cluster, int smem, int n_chunks,
                  cudaStream_t stream) {
  auto kernel = rglru_scan_bwd_kernel<T, kHasH, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[3] = {};
  if constexpr (kVec) {
    constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
    const void* src[3] = {log_a, xs, g_h};
    for (int i = 0; i < 3; ++i)
      if (!hopper::encode_3d(&maps[i], src[i], bf16, W, steps, B, kBwdCh,
                             kBwdSteps))
        return hopper::kTensorMapRefused;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((W + kBwdCh - 1) / kBwdCh),
                     static_cast<unsigned>(B), static_cast<unsigned>(cluster));
  cfg.blockDim = dim3(kBwdCh);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = static_cast<unsigned>(cluster);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, maps[0], maps[1], maps[2], static_cast<const T*>(log_a),
      static_cast<const T*>(xs), static_cast<const T*>(g_h),
      static_cast<const float*>(h0), static_cast<const float*>(g_last),
      static_cast<T*>(dlog_a), static_cast<T*>(db), static_cast<float*>(dh0),
      static_cast<float*>(entry), static_cast<int64_t>(steps),
      static_cast<int64_t>(W), n_chunks);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* log_a, const void* b, const void* h0,
               const void* h, const void* g_h, const void* g_last,
               void* dlog_a, void* db, void* dh0, void* entry, long long B,
               long long steps, long long W, int ch, int chunk, int cluster,
               int smem, void* stream) {
  // the saved output is the carry only for f32 inputs
  const bool has_h = h != nullptr && std::is_same<T, float>::value;
  const long long n_chunks = (steps + kBwdSteps - 1) / kBwdSteps;
  const long long laps = (n_chunks + cluster - 1) / cluster;
  const int want = kBwdHead + (laps > 1 ? 2 : 1) * 3 * kBwdTile *
                                  static_cast<int>(sizeof(T));
  if (ch != kBwdCh || chunk != kBwdSteps || cluster < 1 ||
      cluster > kBwdMaxCluster || cluster > n_chunks || smem != want ||
      (!has_h && laps > 1 && entry == nullptr))
    return kBwdWrongPlan;
  const void* xs = has_h ? h : b;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = W * static_cast<long long>(sizeof(T)) % 16 == 0 &&
                   aligned(log_a) && aligned(xs) && aligned(g_h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = static_cast<int>(n_chunks);
#define REPRO_B3P_LAUNCH(H, V)                                              \
  return launch_bwd_as<T, H, V>(log_a, xs, g_h, h0, g_last, dlog_a, db,     \
                                dh0, entry, B, steps, W, cluster, smem, nc, \
                                s)
  if constexpr (std::is_same<T, float>::value) {
    if (has_h) {
      if (vec) REPRO_B3P_LAUNCH(true, true);
      REPRO_B3P_LAUNCH(true, false);
    }
  }
  if (vec) REPRO_B3P_LAUNCH(false, true);
  REPRO_B3P_LAUNCH(false, false);
#undef REPRO_B3P_LAUNCH
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
// null; entry is an f32 (B, chunks, W) scratch buffer, needed where the
// carry is recomputed (bf16, or no h) and T takes more than one lap of
// the cluster (else null). ch, chunk, cluster and smem are the wrapper's
// plan (ops._rglru_scan_backward_plan): kBwdWrongPlan (-2) if they are not
// this build's.
extern "C" int rglru_scan_bwd_f32(const void* log_a, const void* b,
                                  const void* h0, const void* h,
                                  const void* g_h, const void* g_last,
                                  void* dlog_a, void* db, void* dh0,
                                  void* entry, long long B, long long T,
                                  long long W, int ch, int chunk,
                                  int cluster, int smem, void* stream) {
  return repro_torch::launch_bwd<float>(log_a, b, h0, h, g_h, g_last, dlog_a,
                                        db, dh0, entry, B, T, W, ch, chunk,
                                        cluster, smem, stream);
}

extern "C" int rglru_scan_bwd_bf16(const void* log_a, const void* b,
                                   const void* h0, const void* h,
                                   const void* g_h, const void* g_last,
                                   void* dlog_a, void* db, void* dh0,
                                   void* entry, long long B, long long T,
                                   long long W, int ch, int chunk,
                                   int cluster, int smem, void* stream) {
  return repro_torch::launch_bwd<__nv_bfloat16>(
      log_a, b, h0, h, g_h, g_last, dlog_a, db, dh0, entry, B, T, W, ch,
      chunk, cluster, smem, stream);
}
