// Generic PIQMC: the space-time colored local sweep and the whole-line
// moves of an IsingProblem graph at any P, the whole schedule in one
// launch.
//
// Replaces no TPU kernel: the JAX package runs this path as an XLA scan,
// the masked space-time sweep of montecarlosolvers_tpu/solvers/qmc.py
// (:152-180) on ops/piqmc.py::local_sweep (:79) and global_line_moves
// (:193). Plain PyTorch version: ops/generic_kernels.py::
// generic_qmc_anneal_ref (the port's ops/piqmc.py::local_sweep and
// global_line_moves on the packed problem, on the counter hash).
//
// What it computes. A chain's P Trotter slices of N spins (+/-1 floats),
// slices-major, each slice in packed order (packed.cuh). Step t (B_t,
// J_perp_t, T_eff = P*T) runs m = spacetime_num_phases(C, P) local phases:
// phase p updates, in every slice k, the block of spatial color
// (p - k) mod m (none when that is >= C), which is the set of sites with
// (color + k) mod m == p of the JAX masked sweep, with no mask. Spatial
// neighbours at one slice differ in color, Trotter neighbours in phase, so
// every update of a phase reads only sites the phase does not write. A site
// takes dE = (-2B s) f + (2 s J_perp)(s[k-1] + s[k+1]) (ring mod P) and
// flips if dE <= 0 or -T_eff log1p(-u) > dE, u = uniform01(counter(seed,
// t, 0), (chain * P + k) * N + perm[i]). With global moves, the lines of
// each color class c in turn flip whole on dE = sum_k (-2B s_k) f_k, in
// slice order, with u = uniform01(line_counter(seed, t, 0), chain * P * N
// + perm[i]). With `energies`, the least slice energy after step t goes
// into energies[t, chain], reduced in the kernel.
//
// What bounds it on an H100. Per local update: maxnb gathered spins, the
// two Trotter neighbours, the hash and log1pf; per line, P fields again
// and one hash. At the main path's P = 40, 32 chains of 6400 spins the
// state is 33 MB in L2. With one CTA a chain, 32 chains fill 32 of the
// 132 SMs: at this size the kernel is occupancy-bound, not bandwidth- or
// issue-bound.
//
// What the design does about that, simply (a first kernel): one CTA of 256
// threads a chain, the state in device memory (any N, P, color count),
// threads striding over a slice's block, slice after slice, and a
// __syncthreads() between phases and between line colors.
//
// A J_perp per chain (quantum parallel tempering, solvers/pt.py::
// sample_piqmc): the template argument kPerChain reads jp[t * stride_t +
// chain * stride_c] once a step; the shared instantiation reads jp[t]. A
// packing that is not proper (an odd periodic lattice's checkerboard,
// ops/packed.py::packed_from_lattice) takes kImproper: a local phase
// copies the blocks it updates, and a line color its block, all slices,
// into the scratch `snap` first and reads same-class neighbours there, as
// the plain version's masked phases read them (csrc/generic_qmc_bath.cu
// does the same).
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"
#include "energy.cuh"
#include "packed.cuh"

namespace {

template <bool kGlobal, bool kPerChain, bool kImproper>
__global__ void __launch_bounds__(mcs::kPackedThreads)
generic_qmc_kernel(const int* __restrict__ nbr_idx,
                   const float* __restrict__ nbr_J,
                   const float* __restrict__ h, const int* __restrict__ perm,
                   const int* __restrict__ starts,
                   const float* __restrict__ b_sched,
                   const float* __restrict__ jp, float teff, float* s,
                   float* snap, float* __restrict__ energies, int chains,
                   int P, int n, int maxnb, int ncolors, int m, int steps,
                   uint32_t seed_term, int stride_t, int stride_c) {
  __shared__ float red[mcs::kPackedThreads / 32];
  const int chain = blockIdx.x;
  const size_t stride = static_cast<size_t>(n);
  float* const base = s + static_cast<size_t>(chain) * P * stride;
  float* const sbase =
      kImproper ? snap + static_cast<size_t>(chain) * P * stride : nullptr;
  const uint32_t N = static_cast<uint32_t>(n);
  const uint32_t line_uid0 = static_cast<uint32_t>(chain) *
                             static_cast<uint32_t>(P) * N;
  for (int t = 0; t < steps; ++t) {
    const float bc = __fmul_rn(-2.0f, __ldg(b_sched + t));
    const float jpt =
        kPerChain ? __ldg(jp + static_cast<size_t>(t) * stride_t +
                          static_cast<size_t>(chain) * stride_c)
                  : __ldg(jp + t);
    const uint32_t ctr = mcs::counter(seed_term, t, 0);
    for (int p = 0; p < m; ++p) {
      if (kImproper) {  // the blocks this phase updates, as they stand
        for (int k = 0; k < P; ++k) {
          const int c = ((p - k) % m + m) % m;
          if (c >= ncolors) continue;
          const int hi = __ldg(starts + c + 1);
          for (int i = __ldg(starts + c) + threadIdx.x; i < hi;
               i += blockDim.x)
            sbase[k * stride + i] = base[k * stride + i];
        }
        __syncthreads();
      }
      for (int k = 0; k < P; ++k) {
        const int c = ((p - k) % m + m) % m;
        if (c >= ncolors) continue;
        float* sk = base + k * stride;
        const int lo = __ldg(starts + c);
        const float* up = base + (k == 0 ? P - 1 : k - 1) * stride;
        const float* dn = base + (k + 1 == P ? 0 : k + 1) * stride;
        const uint32_t uid0 =
            (static_cast<uint32_t>(chain) * static_cast<uint32_t>(P) +
             static_cast<uint32_t>(k)) * N;
        const int hi = __ldg(starts + c + 1);
        for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
          const float si = sk[i];
          const float f =
              kImproper ? mcs::field_in_phase(sk, sbase + k * stride,
                                              nbr_idx, nbr_J, h, i, maxnb,
                                              lo, hi)
                        : mcs::packed_field(sk, nbr_idx, nbr_J, h, i, maxnb);
          const float de = __fadd_rn(
              __fmul_rn(__fmul_rn(bc, si), f),
              __fmul_rn(__fmul_rn(__fmul_rn(2.0f, si), jpt),
                        __fadd_rn(up[i], dn[i])));
          const uint32_t uid = uid0 + static_cast<uint32_t>(__ldg(perm + i));
          if (mcs::metropolis_accept_hashed(de, teff,
                                            uid * mcs::kGolden + ctr)) {
            sk[i] = -si;
          }
        }
      }
      __syncthreads();
    }
    if (kGlobal) {
      const uint32_t lctr = mcs::line_counter(seed_term, t, 0);
      for (int c = 0; c < ncolors; ++c) {
        const int lo = __ldg(starts + c), hi = __ldg(starts + c + 1);
        if (kImproper) {
          for (int k = 0; k < P; ++k)
            for (int i = lo + threadIdx.x; i < hi; i += blockDim.x)
              sbase[k * stride + i] = base[k * stride + i];
          __syncthreads();
        }
        for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
          float de = 0.0f;
          for (int k = 0; k < P; ++k) {
            const float* sk = base + k * stride;
            const float f =
                kImproper ? mcs::field_in_phase(sk, sbase + k * stride,
                                                nbr_idx, nbr_J, h, i, maxnb,
                                                lo, hi)
                          : mcs::packed_field(sk, nbr_idx, nbr_J, h, i,
                                              maxnb);
            const float term = __fmul_rn(__fmul_rn(bc, sk[i]), f);
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
// over the (steps,) schedules B and J_perp at T_eff = `teff`, m local
// phases a step, one CTA of `threads` (256) threads a chain, in one
// launch. The packed layout's nbr_idx / nbr_J (n, maxnb), h (n), perm (n),
// starts (ncolors + 1); global_moves != 0 adds the line moves; energies: a
// (steps, chains) float32 buffer or null; step0: the step the hash counts
// the first sweep as; stride_c != 0 reads a J_perp per chain, jp[t *
// stride_t + chain * stride_c]; snap, scratch of the state's size or null,
// marks a packing that is not proper. All device pointers; launches on
// `stream` and returns cudaGetLastError().
extern "C" int generic_qmc_anneal(const int* nbr_idx, const float* nbr_J,
                                  const float* h, const int* perm,
                                  const int* starts, const float* b_sched,
                                  const float* jp, float teff, float* s,
                                  float* snap, float* energies, int chains,
                                  int P, int n,
                                  int maxnb, int ncolors, int m, int steps,
                                  int seed, int step0, int global_moves,
                                  int threads, int stride_t, int stride_c,
                                  void* stream) {
  if (chains == 0 || n == 0 || P == 0) return cudaSuccess;
  // step0 folds into the seed term: counter(seed_term, t, i) is then
  // counter(seed, step0 + t, i), and so is every other counter of the step
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult +
                             static_cast<uint32_t>(step0) * mcs::kStepMult;
  using Kernel = decltype(&generic_qmc_kernel<false, false, false>);
  // [global_moves][per chain][improper]
  const Kernel kernels[2][2][2] = {
      {{generic_qmc_kernel<false, false, false>,
        generic_qmc_kernel<false, false, true>},
       {generic_qmc_kernel<false, true, false>,
        generic_qmc_kernel<false, true, true>}},
      {{generic_qmc_kernel<true, false, false>,
        generic_qmc_kernel<true, false, true>},
       {generic_qmc_kernel<true, true, false>,
        generic_qmc_kernel<true, true, true>}}};
  const Kernel kernel =
      kernels[global_moves != 0][stride_c != 0][snap != nullptr];
  kernel<<<chains, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      nbr_idx, nbr_J, h, perm, starts, b_sched, jp, teff, s, snap, energies,
      chains, P, n, maxnb, ncolors, m, steps, seed_term, stride_t, stride_c);
  return cudaGetLastError();
}

extern "C" const char* generic_qmc_anneal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
