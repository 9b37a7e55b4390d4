// Population-level fused int-wire dequantize + Eq.-(6) consensus update for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/quant_consensus.py
// (quant_consensus_update / _quant_consensus_kernel and
// _quant_consensus_kernel_blocked), which the JAX package calls once per
// agent under vmap on a pre-gathered (H, N) int8 neighbour block. Here one
// launch covers K owned rows of one parameter leaf:
//
//   xhat_k[n]  = q[k, n] * s[k, n / qblock]             (own decoded wire)
//   nbr_j[n]   = q_src[j, n] * s_src[j, n / qblock]     (source wire)
//   out[k, n]  = x[k, n] + sum_h sig[k, h] * (nbr_{idx[k,h]}[n] - xhat_k[n])
//
// x (K, N) f32; q (K, N) int8 lanes (int8 or int4 values); s (K, S) f32
// with S = 1 per-tensor scale (the wrapper passes a qblock larger than N)
// or S = ceil(N / qblock) block scales for the "int8:b64" wire; q_src
// (Ks, N) and s_src (Ks, S) the source wire (the population's own wire,
// the same pointers, on the sparse plan; the gathered wire on the sharded
// plan; the received payloads on the distributed plan); idx (K, H) int32
// in [0, Ks); sig (K, H) f32 -> out (K, N) f32. The neighbour lanes stay
// int8 through the gather and are dequantized inside the combine,
// recentred on the agent's own decoded copy (CHOCO), in fixed h order. A
// lane with sig = 0 adds 0 * (nbr - xhat_k) = +0: an exact no-op.
//
// Bound: device-memory bytes. Counting each input byte read once and each
// output byte written once: 4 * K * N (x) + K * N (q) + 4 * K * N (out) =
// 9 * K * N bytes, plus 4 * K * S of scales and 8 * K * H of lane tables,
// and the source wire's own rows where it is not the owned rows' wire.
// Each wire row is re-read by its H neighbours' blocks; those re-reads are
// expected to hit the 50 MB L2. Each thread handles 16 elements: one
// 16-byte load of int8 lanes per row and four 16-byte loads of x; a ragged
// tail, a misaligned row, or a qblock that is not a multiple of 16 falls
// back to masked scalar loads.
#include "consensus_common.cuh"

namespace repro_torch {
namespace {

constexpr int V = 16;

__global__ void __launch_bounds__(kThreads)
    quant_consensus_pop_kernel(const float* __restrict__ x,
                               const int8_t* __restrict__ q,
                               const float* __restrict__ s,
                               const int8_t* __restrict__ q_src,
                               const float* __restrict__ s_src,
                               const int* __restrict__ idx,
                               const float* __restrict__ sig,
                               float* __restrict__ out, int64_t N, int H,
                               int64_t Ks, int64_t qblock, int64_t s_stride,
                               int vec_ok) {
  extern __shared__ int smem[];
  int* s_idx = smem;
  float* s_sig = reinterpret_cast<float*>(smem + H);
  const int64_t k = blockIdx.y;
  load_lanes(idx, sig, k, H, Ks, s_idx, s_sig);

  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * V;
  if (base >= N) return;
  const float* xk = x + k * N;
  float* ok = out + k * N;

  if (vec_ok && base + V <= N) {
    // qblock % 16 == 0 here, so the 16 lanes share one scale block
    const int64_t sb = base / qblock;
    float xv[V], xhat[V], acc[V];
#pragma unroll
    for (int c = 0; c < V / 4; ++c) {
      const float4 f = *reinterpret_cast<const float4*>(xk + base + 4 * c);
      xv[4 * c] = f.x;
      xv[4 * c + 1] = f.y;
      xv[4 * c + 2] = f.z;
      xv[4 * c + 3] = f.w;
    }
    const uint4 qraw = *reinterpret_cast<const uint4*>(q + k * N + base);
    const int8_t* qe = reinterpret_cast<const int8_t*>(&qraw);
    const float s_self = s[k * s_stride + sb];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      xhat[i] = __fmul_rn(static_cast<float>(qe[i]), s_self);
      acc[i] = 0.0f;
    }
    for (int h = 0; h < H; ++h) {
      const int64_t j = s_idx[h];
      const float sg = s_sig[h];
      const float sj = s_src[j * s_stride + sb];
      const uint4 nraw = *reinterpret_cast<const uint4*>(q_src + j * N + base);
      const int8_t* ne = reinterpret_cast<const int8_t*>(&nraw);
#pragma unroll
      for (int i = 0; i < V; ++i)
        acc[i] = combine(acc[i], sg, __fmul_rn(static_cast<float>(ne[i]), sj),
                         xhat[i]);
    }
#pragma unroll
    for (int c = 0; c < V / 4; ++c) {
      float4 f;
      f.x = __fadd_rn(xv[4 * c], acc[4 * c]);
      f.y = __fadd_rn(xv[4 * c + 1], acc[4 * c + 1]);
      f.z = __fadd_rn(xv[4 * c + 2], acc[4 * c + 2]);
      f.w = __fadd_rn(xv[4 * c + 3], acc[4 * c + 3]);
      *reinterpret_cast<float4*>(ok + base + 4 * c) = f;
    }
    return;
  }
  for (int64_t n = base; n < base + V && n < N; ++n) {
    const int64_t sb = n / qblock;
    const float xhat =
        __fmul_rn(static_cast<float>(q[k * N + n]), s[k * s_stride + sb]);
    float acc = 0.0f;
    for (int h = 0; h < H; ++h) {
      const int64_t j = s_idx[h];
      acc = combine(acc, s_sig[h],
                    __fmul_rn(static_cast<float>(q_src[j * N + n]),
                              s_src[j * s_stride + sb]),
                    xhat);
    }
    ok[n] = __fadd_rn(xk[n], acc);
  }
}

}  // namespace
}  // namespace repro_torch

extern "C" int quant_consensus_pop(const void* x, const void* q,
                                   const void* s, const void* q_src,
                                   const void* s_src, const void* idx,
                                   const void* sig, void* out, long long K,
                                   long long N, int H, long long Ks,
                                   long long qblock, long long s_stride,
                                   int vec_ok, void* stream) {
  using namespace repro_torch;
  const long long tile = static_cast<long long>(kThreads) * V;
  dim3 grid(static_cast<unsigned>((N + tile - 1) / tile),
            static_cast<unsigned>(K));
  const size_t smem = static_cast<size_t>(H) * (sizeof(int) + sizeof(float));
  quant_consensus_pop_kernel<<<grid, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<const int8_t*>(q_src),
      static_cast<const float*>(s_src), static_cast<const int*>(idx),
      static_cast<const float*>(sig), static_cast<float*>(out), N, H, Ks,
      qblock, s_stride, vec_ok);
  return static_cast<int>(cudaGetLastError());
}
