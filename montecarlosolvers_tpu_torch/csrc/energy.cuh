// The per-step energy kernel of collect_energy=: one launch a step from the
// per-phase host loops of split_sa.cu, split_qmc.cu, split_qmc_bath.cu,
// split_svmc.cu, plane_sa.cu, plane_qmc.cu and plane_svmc.cu, and from the
// stand-alone entry points of energy.cu (the samplers' exchanges read the
// energies of kernel A's chain-bit words through chain_bits_energy_kernel).
//
// Replaces no TPU kernel: the JAX package computes the per-step energies in
// XLA inside its scans (ops/split.py:245, :324-330, :676, :715;
// solvers/qmc.py:176). On the card the per-phase routes keep the state in
// device memory between launches, so the energy is read there by a kernel
// launched from the same C++ loop, with no host sync and no per-step
// Python. Plain PyTorch versions: ops/energy.py.
//
// What it computes. Per chain, the classical energy
//   E = sum_i s_i (sum of the couplings of the bonds i owns * s_nb + h_i),
// each bond counted once, as ops/split.py::classical_energy_split (split
// halves: every bond joins a site of half A to one of half B, so the
// stencil of half A owns them all) and LatticeProblem.energy (planes: a
// site owns its right and down bonds, wrap bonds included, so an odd
// torus's wrap bonds count once) count it; over the P Trotter slices of a
// chain, the least of the P slice energies (the best-slice readout). The
// spins are read as stored (+/-1 floats) or, for SVMC, from cos theta as
// sign(cos theta), +1 at cos theta = 0 (ops/svmc_ops.py::
// z_projection_from_cos). It writes out[chain] for the step's row of the
// (steps, chains) energy buffer.
//
// What bounds it on an H100. It reads the state once a step: at the SA
// cell's 1280 chains on 80x80, 33 MB, at least 10 us at 3.35 TB/s; at
// PIQMC P = 40, 32 chains, the same 33 MB. The couplings (7 slots x 2 x
// Nh floats) stay in L2.
//
// What the design does about that. One CTA per chain loops over the
// chain's slices, and its threads stride over the sites, so a warp reads
// consecutive floats. The reduction order is fixed: each thread adds its
// sites in order, a warp adds its lanes by a shuffle tree, and thread 0
// adds the warps' sums in warp order from shared memory; no atomics, so a
// seed reproduces its energies bitwise. The minimum over slices is taken
// by thread 0 in slice order. Simple first: a chain's slices on one SM
// leave SMs idle at 32 chains (ROADMAP.md: energies inside the cluster
// kernels).
#pragma once

#include <cuda_runtime.h>

#include "counter_hash.cuh"

namespace mcs {

constexpr int kEnergyThreads = 512;

// the spin a stored value stands for: the value itself, or for SVMC's cos
// theta its sign, +1 at 0
template <bool kCos>
__device__ __forceinline__ float spin_of(float v) {
  if (kCos) return v >= 0.0f ? 1.0f : -1.0f;
  return v;
}

// The sum of x over the block in a fixed order: a shuffle tree in each
// warp, then thread 0 adds the warps' sums in warp order. red holds
// blockDim.x / 32 floats; the result is thread 0's.
__device__ __forceinline__ float block_sum(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_down_sync(0xffffffffu, x, off);
  }
  __syncthreads();  // the last call's reads of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i) s += red[i];
  }
  return s;
}

// This thread's share of the energy of one slice in the split layout:
// the spins of half a (color A) and half b (color B), nh sites each, read
// by sa(j) and sb(j); w (nslots, 2, nh), h (2, nh).
template <typename ReadA, typename ReadB>
__device__ __forceinline__ float halves_share_of(ReadA sa, ReadB sb,
                                                 const float* __restrict__ w,
                                                 const float* __restrict__ h,
                                                 int nh, int K, int nslots) {
  float acc = 0.0f;
  for (int j = threadIdx.x; j < nh; j += blockDim.x) {
    const float f = stencil(sb, w, 0, nh, K, nslots, j);
    acc += sa(j) * (f + __ldg(h + j)) + __ldg(h + nh + j) * sb(j);
  }
  return acc;
}

// halves_share_of over halves stored as floats (or SVMC's cos theta)
template <bool kCos>
__device__ __forceinline__ float halves_share(const float* __restrict__ a,
                                              const float* __restrict__ b,
                                              const float* __restrict__ w,
                                              const float* __restrict__ h,
                                              int nh, int K, int nslots) {
  return halves_share_of(
      [a](int i) { return spin_of<kCos>(__ldg(a + i)); },
      [b](int i) { return spin_of<kCos>(__ldg(b + i)); }, w, h, nh, K,
      nslots);
}

// out[chain] = min over p < P of the energy of slice p of halves a, b
// (chains, P, nh): SA and SVMC at P = 1, the bath engine's halves per slice
template <bool kCos>
__global__ void __launch_bounds__(kEnergyThreads)
halves_energy_kernel(const float* __restrict__ w, const float* __restrict__ h,
                     const float* __restrict__ a, const float* __restrict__ b,
                     int P, int nh, int K, int nslots,
                     float* __restrict__ out) {
  __shared__ float red[kEnergyThreads / 32];
  const size_t base = static_cast<size_t>(blockIdx.x) * P * nh;
  float best = 0.0f;
  for (int p = 0; p < P; ++p) {
    const size_t at = base + static_cast<size_t>(p) * nh;
    const float e = block_sum(
        halves_share<kCos>(a + at, b + at, w, h, nh, K, nslots), red);
    best = p == 0 ? e : fminf(best, e);
  }
  if (threadIdx.x == 0) out[blockIdx.x] = best;
}

// out[chain] = the energy of one chain of halves a, b held as kernel A's
// chain bits (ops/split_kernels.py::pack_chain_bits): (ceil(chains/C), nh)
// int32 words each, bit c of word (g, j) the sign of chain g*C + c at site
// j, 1 for -1. The same sum in the same order as halves_energy_kernel at
// P = 1, so the two agree bitwise on the same spins.
__global__ void __launch_bounds__(kEnergyThreads)
chain_bits_energy_kernel(const float* __restrict__ w,
                         const float* __restrict__ h,
                         const int* __restrict__ a, const int* __restrict__ b,
                         int C, int nh, int K, int nslots,
                         float* __restrict__ out) {
  __shared__ float red[kEnergyThreads / 32];
  const int g = blockIdx.x / C;
  const int c = blockIdx.x - g * C;
  const int* wa = a + static_cast<size_t>(g) * nh;
  const int* wb = b + static_cast<size_t>(g) * nh;
  const float e = block_sum(
      halves_share_of(
          [wa, c](int i) { return (__ldg(wa + i) >> c) & 1 ? -1.0f : 1.0f; },
          [wb, c](int i) { return (__ldg(wb + i) >> c) & 1 ? -1.0f : 1.0f; },
          w, h, nh, K, nslots),
      red);
  if (threadIdx.x == 0) out[blockIdx.x] = e;
}

// out[chain] = min over the 2Q slices of the energy of PIQMC quarters
// (chains, Q, nh) each: slice 2q is xe[q] (A) with ye[q] (B), slice 2q + 1
// is yo[q] (A) with xo[q] (B) (ops/split.py::pack_qmc)
__global__ void __launch_bounds__(kEnergyThreads)
quarters_energy_kernel(const float* __restrict__ w,
                       const float* __restrict__ h,
                       const float* __restrict__ xe,
                       const float* __restrict__ xo,
                       const float* __restrict__ ye,
                       const float* __restrict__ yo, int Q, int nh, int K,
                       int nslots, float* __restrict__ out) {
  __shared__ float red[kEnergyThreads / 32];
  const size_t base = static_cast<size_t>(blockIdx.x) * Q * nh;
  float best = 0.0f;
  for (int p = 0; p < 2 * Q; ++p) {
    const size_t at = base + static_cast<size_t>(p / 2) * nh;
    const float* sa = (p & 1) ? yo : xe;
    const float* sb = (p & 1) ? xo : ye;
    const float e = block_sum(
        halves_share<false>(sa + at, sb + at, w, h, nh, K, nslots), red);
    best = p == 0 ? e : fminf(best, e);
  }
  if (threadIdx.x == 0) out[blockIdx.x] = best;
}

// out[chain] = min over p < P of the energy of plane p of s (chains, P,
// L, L); w holds the planes jr, jl, jd, ju, h (plane.cuh). A site owns its
// right and down bonds, the wrap bonds of a torus included.
template <bool kCos>
__global__ void __launch_bounds__(kEnergyThreads)
plane_energy_kernel(const float* __restrict__ w, const float* __restrict__ s,
                    int P, int L, float* __restrict__ out) {
  __shared__ float red[kEnergyThreads / 32];
  const int n = L * L;
  float best = 0.0f;
  for (int p = 0; p < P; ++p) {
    const float* sp = s + (static_cast<size_t>(blockIdx.x) * P + p) * n;
    float acc = 0.0f;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int r = i / L;
      const int c = i - r * L;
      const int right = c + 1 == L ? 0 : c + 1;
      const int down = r + 1 == L ? 0 : r + 1;
      const float f =
          __ldg(w + i) * spin_of<kCos>(__ldg(sp + r * L + right)) +
          __ldg(w + 2 * n + i) * spin_of<kCos>(__ldg(sp + down * L + c)) +
          __ldg(w + 4 * n + i);
      acc += spin_of<kCos>(__ldg(sp + i)) * f;
    }
    const float e = block_sum(acc, red);
    best = p == 0 ? e : fminf(best, e);
  }
  if (threadIdx.x == 0) out[blockIdx.x] = best;
}

// Host launchers, one CTA per chain on `st`; the caller checks
// cudaGetLastError().
inline void launch_halves_energy(const float* w, const float* h,
                                 const float* a, const float* b, int chains,
                                 int P, int L, int nslots, bool cos_theta,
                                 float* out, cudaStream_t st) {
  const int K = L / 2;
  const auto kernel = cos_theta ? halves_energy_kernel<true>
                                : halves_energy_kernel<false>;
  kernel<<<chains, kEnergyThreads, 0, st>>>(w, h, a, b, P, L * K, K, nslots,
                                            out);
}

inline void launch_chain_bits_energy(const float* w, const float* h,
                                     const int* a, const int* b, int chains,
                                     int C, int L, int nslots, float* out,
                                     cudaStream_t st) {
  const int K = L / 2;
  chain_bits_energy_kernel<<<chains, kEnergyThreads, 0, st>>>(
      w, h, a, b, C, L * K, K, nslots, out);
}

inline void launch_quarters_energy(const float* w, const float* h,
                                   const float* xe, const float* xo,
                                   const float* ye, const float* yo,
                                   int chains, int Q, int L, int nslots,
                                   float* out, cudaStream_t st) {
  const int K = L / 2;
  quarters_energy_kernel<<<chains, kEnergyThreads, 0, st>>>(
      w, h, xe, xo, ye, yo, Q, L * K, K, nslots, out);
}

inline void launch_plane_energy(const float* w, const float* s, int chains,
                                int P, int L, bool cos_theta, float* out,
                                cudaStream_t st) {
  const auto kernel = cos_theta ? plane_energy_kernel<true>
                                : plane_energy_kernel<false>;
  kernel<<<chains, kEnergyThreads, 0, st>>>(w, s, P, L, out);
}

}  // namespace mcs
