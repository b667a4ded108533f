// The class-major packed layout of an IsingProblem, shared by the generic
// kernels (packed_sa.cu, packed_svmc.cu, generic_qmc.cu).
//
// Device form of montecarlosolvers_tpu/ops/packed.py (PackedGraph :45,
// the block fields of packed_sweep :129 and packed_energy :113); the plain
// PyTorch form is montecarlosolvers_tpu_torch/ops/packed.py.
//
// Layout. The sites are sorted by color, stably: packed position i holds
// original site perm[i], and color class c is the block
// [starts[c], starts[c+1]). nbr_idx (N, maxnb) int32 and nbr_J (N, maxnb)
// float32 hold each row's slots in packed indices (padding and field slots
// point at the row itself with J = 0; the fields are in h). A color class
// is an independent set, so a block updates in place with no masks: its
// sites read only neighbours of other blocks.
//
// Rounding. The field is the slot products summed in slot order from slot
// 0, then h, with __fmul_rn / __fadd_rn so nvcc contracts nothing into an
// FMA: the order of models/ising.py::slot_sum and of the JAX package's
// jnp.sum over the slot axis. For spins the products are exact; for SVMC's
// cos theta they round, and the order fixes the result.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"
#include "energy.cuh"

namespace mcs {

// One CTA a chain, this many threads (ops/generic_kernels.py::THREADS).
constexpr int kPackedThreads = 256;

// sum_k J[i, k] * x[nbr[i, k]] in slot order; x is read through the
// ordinary (coherent) path, since the CTA writes it between phases.
template <typename Read>
__device__ __forceinline__ float slot_sum(Read x,
                                          const int* __restrict__ nbr_idx,
                                          const float* __restrict__ nbr_J,
                                          int i, int maxnb) {
  const int* ri = nbr_idx + static_cast<size_t>(i) * maxnb;
  const float* rj = nbr_J + static_cast<size_t>(i) * maxnb;
  float f = __fmul_rn(__ldg(rj), x(__ldg(ri)));
  for (int k = 1; k < maxnb; ++k) {
    f = __fadd_rn(f, __fmul_rn(__ldg(rj + k), x(__ldg(ri + k))));
  }
  return f;
}

// The local field sum_k J x_nb + h of packed site i of values x.
__device__ __forceinline__ float packed_field(const float* x,
                                              const int* __restrict__ nbr_idx,
                                              const float* __restrict__ nbr_J,
                                              const float* __restrict__ h,
                                              int i, int maxnb) {
  return __fadd_rn(
      slot_sum([x](int j) { return x[j]; }, nbr_idx, nbr_J, i, maxnb),
      __ldg(h + i));
}

// The local field of packed site i of slice values sk, its neighbours in
// the block [lo, hi) read from `same` (sk itself when the coloring is
// proper, and then none lies there).
__device__ __forceinline__ float field_in_phase(
    const float* sk, const float* same, const int* __restrict__ nbr_idx,
    const float* __restrict__ nbr_J, const float* __restrict__ h, int i,
    int maxnb, int lo, int hi) {
  return __fadd_rn(
      slot_sum(
          [sk, same, lo, hi](int j) {
            return j >= lo && j < hi ? same[j] : sk[j];
          },
          nbr_idx, nbr_J, i, maxnb),
      __ldg(h + i));
}

// The classical energy of n packed sites x (spins, or cos theta read as
// sign(cos theta) with kCos), 0.5 * sum_i s_i (sum_k J s_nb) + sum_i h_i
// s_i, reduced over the CTA in a fixed order (energy.cuh::block_sum): no
// atomics, so a seed reproduces its energies bitwise. The result is
// thread 0's; every thread of the CTA must call it.
template <bool kCos>
__device__ __forceinline__ float packed_block_energy(
    const float* x, const int* __restrict__ nbr_idx,
    const float* __restrict__ nbr_J, const float* __restrict__ h, int n,
    int maxnb, float* red) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float s = spin_of<kCos>(x[i]);
    const float cf = slot_sum([x](int j) { return spin_of<kCos>(x[j]); },
                              nbr_idx, nbr_J, i, maxnb);
    acc += s * (0.5f * cf + __ldg(h + i));
  }
  return block_sum(acc, red);
}

}  // namespace mcs
