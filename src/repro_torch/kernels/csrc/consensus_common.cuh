// Shared plumbing of the two population-level Eq.-(6) consensus kernels.
//
// Both kernels run one launch per parameter leaf over K owned agent rows:
// grid (ceil(N / tile), K), one block per (tile of the flat leaf, owned
// agent). Each block first copies its own agent's H neighbour indices and
// sigma weights into shared memory, then every thread gathers its VEC-wide
// slice of each neighbour row straight from a (Ks, N) source stack in
// device memory. The source is the population itself (the sparse plan:
// Ks = K, the same pointer), a gathered wire of which the K rows are one
// block (the sharded plan), or the payloads one agent received (the
// distributed plan on a mesh). The (K, H, N) gathered tensor of the JAX
// path never exists.
//
// Arithmetic uses the round-to-nearest intrinsics (__fsub_rn, __fmul_rn,
// __fadd_rn) so nvcc does not contract it into FMAs: the kernels then
// round exactly like the plain PyTorch versions in repro_torch/kernels/
// ref.py, which sum the same terms in the same fixed h order.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kThreads = 256;
// Largest neighbour count the shared-memory table holds without opting in
// to more than 48 KB of dynamic shared memory (8 bytes per lane).
constexpr int kMaxNeighbors = 6144;

// Copy agent k's (index, sigma) lanes into shared memory. An index outside
// [0, Ks), the source's row count, traps the launch before any thread of
// the block gathers with it (the trapping thread never reaches the
// barrier).
__device__ __forceinline__ void load_lanes(const int* __restrict__ idx,
                                           const float* __restrict__ sig,
                                           int64_t k, int H, int64_t Ks,
                                           int* s_idx, float* s_sig) {
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    const int j = idx[k * H + h];
    if (j < 0 || j >= Ks) __trap();
    s_idx[h] = j;
    s_sig[h] = sig[k * H + h];
  }
  __syncthreads();
}

// acc + s * (a - b), rounded after every operation (no FMA contraction).
__device__ __forceinline__ float combine(float acc, float s, float a,
                                         float b) {
  return __fadd_rn(acc, __fmul_rn(s, __fsub_rn(a, b)));
}

}  // namespace repro_torch
