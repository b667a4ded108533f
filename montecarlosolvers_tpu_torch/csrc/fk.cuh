// Fortuin-Kasteleyn draws shared by the cluster kernels (fk_wolff.cu,
// fk_label.cu, fk_line.cu), and the union-find of fk_label.cu and
// houdayer.cu.
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

// The root of x, halving the path as it goes (parent[x] = x at a root).
__device__ __forceinline__ int find_root(volatile int* parent, int x) {
  for (;;) {
    const int p = parent[x];
    if (p == x) return x;
    const int gp = parent[p];
    if (gp != p) parent[x] = gp;  // path halving: gp is an ancestor of x
    x = p;
  }
}

// Unite the sets of a and b, hooking the larger root under the smaller with
// atomicCAS (a failed hook retries from the new root): the least node of a
// set is never hooked, so once every bond is united each set's one root is
// its least node, whatever order the threads united in.
__device__ __forceinline__ void unite(int* parent, int a, int b) {
  volatile int* vp = parent;
  for (;;) {
    a = find_root(vp, a);
    b = find_root(vp, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    // hook the larger root b under the smaller a, if b is still a root
    const int old = atomicCAS(parent + b, b, a);
    if (old == b) return;
    b = old;
  }
}

}  // namespace mcs
