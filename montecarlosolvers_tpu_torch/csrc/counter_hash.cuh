// Counter-hash uniforms shared by the kernels.
//
// Device form of montecarlosolvers_tpu/ops/pallas_sa.py::_mix32 (:110) and
// _uniform01 (:129), of the counter of ops/pallas_split.py:137-141 and
// pallas_sa.py:189-193, of the line-move counter of
// ops/pallas_qmc.py:124,131-133 and of the SVMC acceptance counter of
// ops/pallas_svmc.py:93-96. The plain PyTorch form is
// montecarlosolvers_tpu_torch/ops/counter_rng.py.
//
// Trouble spot: the JAX code hashes on int32 and relies on wrapping
// multiplies; signed overflow is undefined in C++, so everything here is
// uint32_t, where wrapping is defined and gives the same bits. The JAX
// logical shifts (shift_right_logical) are plain >> on uint32_t.
#pragma once

#include <stdint.h>

namespace mcs {

constexpr uint32_t kSeedMult = 0x9E3779B1u;   // 2654435761
constexpr uint32_t kStepMult = 40503u;
constexpr uint32_t kIndexMult = 1013904223u;
constexpr uint32_t kGolden = 0x9E3779B9u;     // -1640531527 as int32
constexpr uint32_t kLineXor = 374761393u;
constexpr uint32_t kLineMult = 69069u;

// murmur3 finalizer, twice: 6 xor-shifts and 4 multiplies.
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
  }
  return x;
}

// counter of (step, index) for a seed term seed * kSeedMult
__device__ __forceinline__ uint32_t counter(uint32_t seed_term, int step,
                                            int index) {
  return seed_term + static_cast<uint32_t>(step) * kStepMult +
         static_cast<uint32_t>(index) * kIndexMult;
}

// counter of the full-plane PIQMC line moves of `color`: the (seed, step)
// base XOR kLineXor, plus color * kLineMult (XOR, not add; 69069, not
// kIndexMult)
__device__ __forceinline__ uint32_t line_counter(uint32_t seed_term, int step,
                                                 int color) {
  return ((seed_term + static_cast<uint32_t>(step) * kStepMult) ^ kLineXor) +
         static_cast<uint32_t>(color) * kLineMult;
}

// counter of the full-plane SVMC acceptance uniforms of `color`
// (pallas_svmc.py:93-96): counter(seed, step, color) XOR kLineXor; the
// Pallas `base + color * M ^ X` adds first and XORs after
__device__ __forceinline__ uint32_t svmc_accept_counter(uint32_t seed_term,
                                                        int step, int color) {
  return counter(seed_term, step, color) ^ kLineXor;
}

// uniform in [0, 1) with 24 bits; (float) of a value < 2^24 is exact
__device__ __forceinline__ float uniform01(uint32_t ctr, uint32_t uid) {
  const uint32_t bits = mix32(uid * kGolden + ctr);
  return static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
}

// Metropolis acceptance in log form (ops/metropolis.py:20):
// dE <= 0*T, or -T*log1p(-u) > dE. The product is written with __fmul_rn so
// no contraction can change its rounding; log1pf is the CUDA math library's,
// which torch's CUDA log1p also calls (no --use_fast_math in the build).
__device__ __forceinline__ bool metropolis_accept(float de, float temp,
                                                  float u) {
  return (de <= 0.0f * temp) || (__fmul_rn(-temp, log1pf(-u)) > de);
}

// metropolis_accept with u = the uniform01 of the hash input
// x = uid * kGolden + ctr, both sides evaluated with no branch: the hash
// and log1pf run whatever dE is (the decision is the same), so the lanes of
// a warp stay converged; kernel A's chain loop runs faster this way than
// when it hashes only where dE > 0 (PERF.md).
__device__ __forceinline__ bool metropolis_accept_hashed(float de, float temp,
                                                         uint32_t x) {
  const float u = static_cast<float>(mix32(x) >> 8) * (1.0f / 16777216.0f);
  return (de <= 0.0f * temp) | (__fmul_rn(-temp, log1pf(-u)) > de);
}

// j + d mod n for |d| <= n
__device__ __forceinline__ int wrap_index(int j, int n) {
  return j >= n ? j - n : (j < 0 ? j + n : j);
}

// Weighted neighbour sum over the opposite half at site j for `color`,
// w laid out (nslots, 2, nh); o(i) reads the opposite half's value at site
// i. The slots read these offsets, mod nh (ops/split.py:161-175):
//   slot 0: o[j]        slot 1: o[j+1]        slot 2: o[j-1]
//   slot 3: o[j+K]      slot 4: o[j-K]
//   slot 5: o[j-(K-1)]  slot 6: o[j+(K-1)]    (row wrap, 7-slot lattices)
// They are summed in this order, as the JAX code sums them. For spins each
// product w*(+/-1) is exact, so the order alone fixes the float32 result;
// for the SVMC kernel's cos values the products round, and
// __fadd_rn/__fmul_rn keep nvcc from contracting them into FMAs.
template <typename Read>
__device__ __forceinline__ float stencil(Read o, const float* __restrict__ w,
                                         int color, int nh, int K,
                                         int nslots, int j) {
  const float* wc = w + color * nh + j;
  const int st = 2 * nh;
  float f = __fmul_rn(__ldg(wc), o(j));
  f = __fadd_rn(f, __fmul_rn(__ldg(wc + st), o(wrap_index(j + 1, nh))));
  f = __fadd_rn(f, __fmul_rn(__ldg(wc + 2 * st), o(wrap_index(j - 1, nh))));
  f = __fadd_rn(f, __fmul_rn(__ldg(wc + 3 * st), o(wrap_index(j + K, nh))));
  f = __fadd_rn(f, __fmul_rn(__ldg(wc + 4 * st), o(wrap_index(j - K, nh))));
  if (nslots > 5) {
    f = __fadd_rn(f, __fmul_rn(__ldg(wc + 5 * st),
                               o(wrap_index(j - (K - 1), nh))));
    f = __fadd_rn(f, __fmul_rn(__ldg(wc + 6 * st),
                               o(wrap_index(j + (K - 1), nh))));
  }
  return f;
}

// `stencil` over a half stored as floats
__device__ __forceinline__ float half_field(const float* o,
                                            const float* __restrict__ w,
                                            int color, int nh, int K,
                                            int nslots, int j) {
  return stencil([o](int i) { return o[i]; }, w, color, nh, K, nslots, j);
}

}  // namespace mcs
