// Fortuin-Kasteleyn draws shared by the cluster kernels (fk_wolff.cu,
// fk_label.cu, fk_line.cu).
//
// Device form of the cluster streams of
// montecarlosolvers_tpu_torch/ops/counter_rng.py (cluster_counter, the
// stream indices, index_draw) and of ops/cluster.py::bond_prob, whose JAX
// form is montecarlosolvers_tpu/ops/cluster.py::_bond_prob (:70). The uid
// layout of each stream is counter_rng.py's table.
//
// Rounding. bond_prob is 1 - expf(dE / T_eff) with the division and the
// subtraction written as __fdiv_rn / __fsub_rn; expf is the CUDA math
// library's (no --use_fast_math), which torch's CUDA exp also calls, so a
// plain version run on the card gives the same probabilities.
#pragma once

#include <stdint.h>

#include "counter_hash.cuh"

namespace mcs {

// counter_rng.CLUSTER_INDEX and the streams
constexpr int kClusterIndex = 8;
enum FkStream {
  kSpBond = 0,
  kTrotterBond = 1,
  kBathBond = 2,
  kWolffSeed = 3,
  kAccept = 4,
  kLineAccept = 5,
  kLineSeed = 6,
  kCoin = 7,
  kGhost = 8,
};

// counter(seed, step, kClusterIndex + stream)
__device__ __forceinline__ uint32_t cluster_counter(uint32_t seed_term,
                                                    int step, int stream) {
  return counter(seed_term, step, kClusterIndex + stream);
}

// p = 1 - exp(dE / T_eff) for dE < 0, else 0
__device__ __forceinline__ float bond_prob(float de, float teff) {
  return de < 0.0f ? __fsub_rn(1.0f, expf(__fdiv_rn(de, teff))) : 0.0f;
}

// floor(u * n) clamped to n - 1, the product rounded in float32
__device__ __forceinline__ int index_draw(float u, int n) {
  const int k =
      static_cast<int>(floorf(__fmul_rn(u, static_cast<float>(n))));
  return k < n - 1 ? k : n - 1;
}

// The bath pair's bond probability of ring offset d (1 <= d < P) for equal
// (p_same) and opposite (p_diff) spins: dE = (-2 T_eff lut[d-1]) s_a s_b,
// whose spin products are exact sign flips (ops/cluster.py::bath_bond_prob)
__device__ __forceinline__ void bath_probs(const float* __restrict__ lut,
                                           int d, float teff, float* p_same,
                                           float* p_diff) {
  const float x = __fmul_rn(__fmul_rn(-2.0f, teff), __ldg(lut + d - 1));
  *p_same = bond_prob(x, teff);
  *p_diff = bond_prob(-x, teff);
}

}  // namespace mcs
