// The uniform source of kernels A, B, 4 and 5: the counter hash, or an
// in-kernel generator (hw_rng=True).
//
// Device form of the two branches of the uniform draws in
// montecarlosolvers_tpu/ops/pallas_split.py: the counter hash (:136-143,
// counter_hash.cuh) and the TPU's on-chip generator, which the Pallas
// kernels seed once per grid step with pltpu.prng_seed(seed, block * 2^16 +
// chunk) and then read in sequence with pltpu.prng_random_bits (:128-135,
// :253-259, :465-490, :719-725). Its Hopper counterpart is a stream per
// thread, held in registers for the whole launch: seeded once per launch
// from (seed, the thread's global index, and for the per-phase kernels the
// launch's number), then read in the fixed order the kernel's loops give.
// A uniform is the top 24 bits of a 32-bit draw times 2^-24, as
// pallas_split.py:133-135 turns prng_random_bits into a float, so the
// Metropolis test and the TF proposal take it unchanged.
//
// The generator: xoshiro128+ (Blackman and Vigna), four words of state,
// eight integer operations a draw, seeded by one Philox4x32-10 draw of
// curand (curand_kernel.h, the CUDA toolkit's device API) at key = the
// kernel's seed term and subsequence = the thread's stream number. Philox
// makes the four words of distinct streams independent; xoshiro128+'s low
// bits are its weak ones and are the 8 that the uniform drops. It takes
// fewer SASS instructions an update than curand's Philox4x32-10 drawn for
// every uniform would (PERF.md section 6).
//
// Neither stream equals the counter hash's or the TPU's: a seed gives the
// same result again at the same geometry (cluster size, threads, chains
// per word), but a different one from the hash path or on a TPU.
#pragma once

#include <curand_kernel.h>
#include <stdint.h>

#include "counter_hash.cuh"

namespace mcs {

// The uniform source of a kernel instantiation. Uniforms<false> is the
// counter hash: u(x) hashes x = uid * kGolden + ctr, as
// counter_hash.cuh::uniform01 does, and holds no state, so the hash
// instantiations compile as they did without it. Uniforms<true> is the
// thread's stream: u(x) ignores x and returns the next draw, one per
// decision whatever dE is (metropolis_accept_u has no branch).
template <bool kHw>
struct Uniforms;

template <>
struct Uniforms<false> {
  __device__ __forceinline__ Uniforms(uint32_t, unsigned long long) {}
  __device__ __forceinline__ float operator()(uint32_t x) {
    return uniform24(mix32(x));
  }
  __device__ __forceinline__ bool accept(float de, float temp, uint32_t x) {
    return metropolis_accept_hashed(de, temp, x);
  }
};

template <>
struct Uniforms<true> {
  uint32_t s0, s1, s2, s3;
  __device__ __forceinline__ Uniforms(uint32_t key,
                                      unsigned long long stream) {
    curandStatePhilox4_32_10_t st;
    curand_init(key, stream, 0, &st);
    const uint4 v = curand4(&st);
    s0 = v.x;
    s1 = v.y;
    s2 = v.z;
    s3 = v.w;
    // xoshiro's one forbidden state, all zero (odds 2^-128)
    s0 |= static_cast<uint32_t>((s0 | s1 | s2 | s3) == 0u);
  }
  // xoshiro128+: the sum of the first and last words, then the state's
  // linear step
  __device__ __forceinline__ uint32_t next() {
    const uint32_t r = s0 + s3;
    const uint32_t t = s1 << 9;
    s2 ^= s0;
    s3 ^= s1;
    s1 ^= s2;
    s0 ^= s3;
    s2 ^= t;
    s3 = (s3 << 11) | (s3 >> 21);
    return r;
  }
  __device__ __forceinline__ float operator()(uint32_t) {
    return uniform24(next());
  }
  __device__ __forceinline__ bool accept(float de, float temp, uint32_t) {
    return metropolis_accept_u(de, temp, uniform24(next()));
  }
};

// The stream number of a thread of a one-launch (cluster) kernel: its
// global index
__device__ __forceinline__ unsigned long long thread_stream() {
  return static_cast<unsigned long long>(blockIdx.y * gridDim.x +
                                         blockIdx.x) *
             blockDim.x +
         threadIdx.x;
}

// The stream number of a thread of launch `launch` of a per-phase kernel:
// the launch's number above the thread's global index
__device__ __forceinline__ unsigned long long phase_stream(uint32_t launch) {
  return (static_cast<unsigned long long>(launch) << 40) | thread_stream();
}

}  // namespace mcs
