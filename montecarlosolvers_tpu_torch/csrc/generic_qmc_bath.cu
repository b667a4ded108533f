// Generic dissipative PIQMC: the bath on the packed layout of an
// IsingProblem graph, or of a lattice with its own checkerboard, at any
// P >= 2, sequential or colored, with optional whole-line moves, the whole
// schedule in one launch.
//
// Replaces no TPU kernel: the JAX package runs this path as an XLA scan,
// the masked sweeps of montecarlosolvers_tpu/solvers/qmc.py (:152-180),
// ops/piqmc.py::dissipative_local_sweep (:110), dissipative_colored_sweep
// (:152) and global_line_moves (:193). Plain PyTorch version:
// ops/generic_kernels.py::generic_qmc_bath_anneal_ref (the port's
// ops/piqmc.py sweeps of the same names on the packed problem, on the
// counter hash).
//
// What it computes. A chain's P Trotter slices of N spins (+/-1 floats),
// slices-major, each slice in packed order (packed.cuh). Step t (B_t,
// J_perp_t, T_eff = P*T, the (P, P) bath matrix M) updates a site on
//   dE = (-2B s) f + (2 s J_perp)(s[k-1] + s[k+1]) + (2 T_eff s) bath,
//   bath = sum_p M[k, p] s_p   (p in index order from 0, M[k, k] = 0),
// added left to right, and flips it if dE <= 0 or -T_eff log1p(-u) > dE,
// u = uniform01(counter(seed, t, 0), (chain * P + k) * N + perm[i]).
// - Sequential (kColored = false): the masked sweep visits slices k = 0..P-1
//   in order, and within slice k the color classes in order, the slice's
//   bath and Trotter sums taken at its start.
// - Colored: m = spacetime_num_phases(C, P) phases; phase p updates the
//   sites with (color + k) mod m == p, every term taken from the state at
//   the phase's start.
// With global moves, the lines of each color class c in turn flip whole on
// dE = sum_k (-2B s_k) f_k, in slice order (J_perp and the bath cancel),
// u = uniform01(line_counter(seed, t, 0), chain * P * N + perm[i]). With
// `energies`, the least slice energy after step t goes into
// energies[t, chain], reduced in the kernel.
//
// What bounds it on an H100. At the main path's P = 40, 32 chains of 6400
// sites a sweep is 8.19 M updates, each with a bath of 39 dependent adds
// over its line's slices, read from L1/L2 (476 MFLOP, a float32 bound of
// 7.1 us). One CTA a chain fills 32 of the 132 SMs with 8 warps each, every
// thread on a serial chain of slices and adds: latency, not bandwidth or
// issue, sets its time (2.62 ms a sweep sequential, H100 80GB HBM3, 700 W,
// PERF.md; kernel 5 takes 0.142 on the same torus from bits in shared
// memory over a cluster).
//
// The design, simply (a first kernel): one CTA of 256 threads a chain, the
// state in device memory, as csrc/generic_qmc.cu.
// - Sequential, color-major. Each thread owns whole lines: all P slices of
//   its sites of class c, in slice order. So the Trotter and bath terms
//   read only the thread's own line. Class c at slice k then reads class
//   c' < c after its step-k update and c' > c before it, and its own line's
//   slices p < k after theirs, which is what the slice-major order gives
//   it: C barriers a step, not P*C.
// - Colored, in two passes a phase. A phase writes slices k and k + m of
//   one line, which read each other through M, so no update of a phase may
//   see another's write: the first pass writes each update's new spin
//   into the scratch copy `snap`, reading only the state, and after a
//   barrier the second copies them back. 2m barriers a step.
// - A coloring that is not proper (the checkerboard of an odd periodic
//   lattice: its wrap pairs share a class, ROADMAP.md queue 3). The masked
//   sweep reads a same-class neighbour as it stood before the class's
//   phase. So the sequential sweep and the line moves copy the class's
//   block, all slices, into `snap` at the phase's start and read
//   same-class neighbours from it (`proper` = 0); the colored passes read
//   nothing the phase writes anyway.
// Rounding: the field is the slot products in slot order, then h; every
// product and sum with __fmul_rn / __fadd_rn, so nvcc contracts nothing
// into an FMA that the plain version rounds twice.
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"
#include "energy.cuh"
#include "packed.cuh"

namespace {

// sum_p M[k, p] s_p of the line at `line` (slice p at line[p * stride]), p
// in index order from 0; every product with a spin is exact
__device__ __forceinline__ float bath_field(const float* __restrict__ mk,
                                            const float* line, size_t stride,
                                            int P) {
  float bf = __fmul_rn(__ldg(mk), line[0]);
  for (int p = 1; p < P; ++p)
    bf = __fadd_rn(bf, __fmul_rn(__ldg(mk + p), line[p * stride]));
  return bf;
}

// Copy the block [lo, hi) of every slice of a chain from s to snap.
__device__ __forceinline__ void copy_block(const float* s, float* snap,
                                           size_t stride, int P, int lo,
                                           int hi) {
  for (int k = 0; k < P; ++k)
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x)
      snap[k * stride + i] = s[k * stride + i];
}

template <bool kColored, bool kGlobal>
__global__ void __launch_bounds__(mcs::kPackedThreads)
generic_qmc_bath_kernel(const int* __restrict__ nbr_idx,
                        const float* __restrict__ nbr_J,
                        const float* __restrict__ h,
                        const int* __restrict__ perm,
                        const int* __restrict__ starts,
                        const float* __restrict__ b_sched,
                        const float* __restrict__ jp,
                        const float* __restrict__ bath, float teff,
                        float two_teff, float* s, float* snap,
                        float* __restrict__ energies, int chains, int P,
                        int n, int maxnb, int ncolors, int m, int steps,
                        uint32_t seed_term, int proper) {
  __shared__ float red[mcs::kPackedThreads / 32];
  const int chain = blockIdx.x;
  const size_t stride = static_cast<size_t>(n);
  const size_t off = static_cast<size_t>(chain) * P * stride;
  float* const base = s + off;
  float* const sbase = snap == nullptr ? nullptr : snap + off;
  const uint32_t N = static_cast<uint32_t>(n);
  const uint32_t line_uid0 = static_cast<uint32_t>(chain) *
                             static_cast<uint32_t>(P) * N;
  for (int t = 0; t < steps; ++t) {
    const float bc = __fmul_rn(-2.0f, __ldg(b_sched + t));
    const float jpt = __ldg(jp + t);
    const uint32_t ctr = mcs::counter(seed_term, t, 0);
    // the new spin of site i at slice k, the state read through `same` for
    // the block [lo, hi)
    auto update = [&](int k, int i, const float* same, int lo, int hi) {
      const float* sk = base + k * stride;
      const float si = sk[i];
      const float f = mcs::field_in_phase(sk, same + k * stride, nbr_idx,
                                          nbr_J, h, i, maxnb, lo, hi);
      const int up = k == 0 ? P - 1 : k - 1;
      const int dn = k + 1 == P ? 0 : k + 1;
      const float tr = __fadd_rn(base[up * stride + i], base[dn * stride + i]);
      const float bf = bath_field(bath + k * P, base + i, stride, P);
      const float de = __fadd_rn(
          __fadd_rn(__fmul_rn(__fmul_rn(bc, si), f),
                    __fmul_rn(__fmul_rn(__fmul_rn(2.0f, si), jpt), tr)),
          __fmul_rn(__fmul_rn(two_teff, si), bf));
      const uint32_t uid =
          (static_cast<uint32_t>(chain) * static_cast<uint32_t>(P) +
           static_cast<uint32_t>(k)) * N +
          static_cast<uint32_t>(__ldg(perm + i));
      return mcs::metropolis_accept_hashed(de, teff, uid * mcs::kGolden + ctr)
                 ? -si
                 : si;
    };
    if (!kColored) {
      for (int c = 0; c < ncolors; ++c) {
        const int lo = __ldg(starts + c), hi = __ldg(starts + c + 1);
        if (!proper) {
          copy_block(base, sbase, stride, P, lo, hi);
          __syncthreads();
        }
        const float* same = proper ? base : sbase;
        for (int i = lo + threadIdx.x; i < hi; i += blockDim.x)
          for (int k = 0; k < P; ++k)
            base[k * stride + i] = update(k, i, same, lo, hi);
        __syncthreads();
      }
    } else {
      for (int p = 0; p < m; ++p) {
        for (int pass = 0; pass < 2; ++pass) {
          for (int k = 0; k < P; ++k) {
            const int c = ((p - k) % m + m) % m;
            if (c >= ncolors) continue;
            const int lo = __ldg(starts + c), hi = __ldg(starts + c + 1);
            for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
              const size_t at = k * stride + i;
              if (pass == 0)
                sbase[at] = update(k, i, base, lo, lo);  // reads no block
              else
                base[at] = sbase[at];
            }
          }
          __syncthreads();
        }
      }
    }
    if (kGlobal) {
      const uint32_t lctr = mcs::line_counter(seed_term, t, 0);
      for (int c = 0; c < ncolors; ++c) {
        const int lo = __ldg(starts + c), hi = __ldg(starts + c + 1);
        if (!proper) {
          copy_block(base, sbase, stride, P, lo, hi);
          __syncthreads();
        }
        const float* same = proper ? base : sbase;
        for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
          float de = 0.0f;
          for (int k = 0; k < P; ++k) {
            const float* sk = base + k * stride;
            const float term = __fmul_rn(
                __fmul_rn(bc, sk[i]),
                mcs::field_in_phase(sk, same + k * stride, nbr_idx, nbr_J,
                                    h, i, maxnb, lo, hi));
            de = k == 0 ? term : __fadd_rn(de, term);
          }
          const uint32_t uid =
              line_uid0 + static_cast<uint32_t>(__ldg(perm + i));
          if (mcs::metropolis_accept_hashed(de, teff,
                                            uid * mcs::kGolden + lctr)) {
            for (int k = 0; k < P; ++k) base[k * stride + i] *= -1.0f;
          }
        }
        __syncthreads();
      }
    }
    if (energies != nullptr) {
      float best = 0.0f;
      for (int k = 0; k < P; ++k) {
        const float e = mcs::packed_block_energy<false>(
            base + k * stride, nbr_idx, nbr_J, h, n, maxnb, red);
        best = k == 0 ? e : fminf(best, e);
      }
      if (threadIdx.x == 0) {
        energies[static_cast<size_t>(t) * chains + chain] = best;
      }
    }
  }
}

}  // namespace

// Anneal `chains` chains of P packed slices `s` (chains, P, n) in place
// over the (steps,) schedules B and J_perp with the (P, P) bath matrix at
// T_eff = `teff` (two_teff: 2 T_eff rounded to float32), one CTA of
// `threads` (256) threads a chain, in one launch. The packed layout's
// nbr_idx / nbr_J (n, maxnb), h (n), perm (n), starts (ncolors + 1);
// colored != 0 runs m space-time phases a step, else the sequential sweep;
// global_moves != 0 adds the line moves; proper == 0 says a class is not
// an independent set; snap: scratch of the state's size, needed when
// colored or not proper (null otherwise); energies: a (steps, chains)
// float32 buffer or null; step0: the step the hash counts the first sweep
// as. All device pointers; launches on `stream` and returns
// cudaGetLastError().
extern "C" int generic_qmc_bath_anneal(
    const int* nbr_idx, const float* nbr_J, const float* h, const int* perm,
    const int* starts, const float* b_sched, const float* jp,
    const float* bath, float teff, float two_teff, float* s, float* snap,
    float* energies, int chains, int P, int n, int maxnb, int ncolors, int m,
    int steps, int seed, int step0, int colored, int global_moves, int proper,
    int threads, void* stream) {
  if (chains == 0 || n == 0 || P == 0) return cudaSuccess;
  if ((colored || !proper) && snap == nullptr) return cudaErrorInvalidValue;
  // step0 folds into the seed term: counter(seed_term, t, i) is then
  // counter(seed, step0 + t, i), and so is every other counter of the step
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult +
                             static_cast<uint32_t>(step0) * mcs::kStepMult;
  auto kernel = colored ? (global_moves ? generic_qmc_bath_kernel<true, true>
                                        : generic_qmc_bath_kernel<true, false>)
                        : (global_moves ? generic_qmc_bath_kernel<false, true>
                                        : generic_qmc_bath_kernel<false, false>);
  kernel<<<chains, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      nbr_idx, nbr_J, h, perm, starts, b_sched, jp, bath, teff, two_teff, s,
      snap, energies, chains, P, n, maxnb, ncolors, m, steps, seed_term,
      proper);
  return cudaGetLastError();
}

extern "C" const char* generic_qmc_bath_anneal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
