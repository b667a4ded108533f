// Generic SA: class-major Metropolis sweeps of an IsingProblem graph, the
// whole schedule in one launch.
//
// Replaces no TPU kernel: the JAX package runs this path as an XLA scan,
// montecarlosolvers_tpu/ops/packed.py::packed_sweep_scan (:282), whose
// body is packed_sweep (:129) under _sa_scan (:206). Plain PyTorch
// version: ops/generic_kernels.py::packed_sa_anneal_ref (ops/packed.py::
// packed_sweep on the counter hash), which equals the masked engine
// ops/metropolis.py::sweep_scan bitwise.
//
// What it computes. A chain's N spins (+/-1 floats) in packed order
// (packed.cuh). Step t at temperature temps[t] visits the C color blocks in
// order; every site i of a block takes dE = (-2 s_i) f_i, f_i its field
// (packed.cuh::packed_field), and flips if dE <= 0 or
// -T log1p(-u) > dE, u = uniform01(counter(seed, t, 0), chain * N +
// perm[i]): the uniform is keyed by the site's original index, so the
// masked engine draws the same one. With `energies`, the chain's classical
// energy after step t is reduced inside the kernel into energies[t, chain]
// (packed.cuh::packed_block_energy): no launch a step.
//
// Noisy anneals (per-step couplings, sa.anneal_noisy). The same kernel
// reads the tables of step t at nbr_J + (t / mcsteps) * j_stride and h +
// (t / mcsteps) * h_stride: strides 0 give the static tables, strides N *
// maxnb and N a (rows, N, maxnb) and (rows, N) stack in packed row order,
// each row held for `mcsteps` sweeps. That is the JAX package's
// montecarlosolvers_tpu/ops/packed.py::_noisy_scan (:221) over
// packed_sweep(nbr_J=, h=) (:124-129) with its tables repeated mcsteps
// times (solvers/sa.py:150-151), still one launch an anneal. The tables
// add their bytes to the bound: 1000 steps of the 80x80 torus's are 154
// MB, past L2, read once each.
//
// What bounds it on an H100. Per update: maxnb gathered neighbour spins and
// couplings, the hash (about 19 integer operations), log1pf and a few
// float operations. At the main path's 1280 chains of the 80x80 torus
// (maxnb 5) the state is 33 MB, which stays in the 50 MB L2; the table,
// 6400 x 5 x 8 B, is shared by every chain. The gathers make it an
// L2-latency- and issue-bound kernel, far from the 3.35 TB/s bound of its
// bytes.
//
// What the design does about that, simply (a first kernel): one CTA of 256
// threads a chain, its threads striding over a block, the state in device
// memory (any N, any color count, any maxnb with one design), a
// __syncthreads() between blocks since only this CTA touches the chain.
//
// A temperature per chain (parallel tempering, solvers/pt.py): the template
// argument kPerChain reads temps[t * stride_t + chain * stride_c] once a
// step; the shared instantiation reads temps[t]. A packing that is not
// proper (the checkerboard of an odd periodic lattice, whose wrap pairs
// share a class: ops/packed.py::packed_from_lattice, which the samplers
// sweep) takes kImproper: each phase copies its block into the scratch
// `snap` first and reads same-class neighbours there, as they stood before
// the phase, as the plain version's block fields read them.
// No fast math; the rounding is the plain version's (packed.cuh).
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"
#include "energy.cuh"
#include "packed.cuh"

namespace {

template <bool kPerChain, bool kImproper>
__global__ void __launch_bounds__(mcs::kPackedThreads)
packed_sa_kernel(const int* __restrict__ nbr_idx,
                 const float* __restrict__ nbr_J,
                 const float* __restrict__ h, const int* __restrict__ perm,
                 const int* __restrict__ starts,
                 const float* __restrict__ temps, float* s, float* snap,
                 float* __restrict__ energies, int chains, int n, int maxnb,
                 int ncolors, int steps, uint32_t seed_term, int j_stride,
                 int h_stride, int mcsteps, int stride_t, int stride_c) {
  __shared__ float red[mcs::kPackedThreads / 32];
  const int chain = blockIdx.x;
  float* sc = s + static_cast<size_t>(chain) * n;
  float* const ss = kImproper ? snap + static_cast<size_t>(chain) * n
                              : nullptr;
  const uint32_t uid0 =
      static_cast<uint32_t>(chain) * static_cast<uint32_t>(n);
  for (int t = 0; t < steps; ++t) {
    const float temp =
        kPerChain ? __ldg(temps + static_cast<size_t>(t) * stride_t +
                          static_cast<size_t>(chain) * stride_c)
                  : __ldg(temps + t);
    const uint32_t ctr = mcs::counter(seed_term, t, 0);
    const size_t row = static_cast<size_t>(t / mcsteps);
    const float* jt = nbr_J + row * j_stride;
    const float* ht = h + row * h_stride;
    for (int c = 0; c < ncolors; ++c) {
      const int lo = __ldg(starts + c), hi = __ldg(starts + c + 1);
      if (kImproper) {
        for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) ss[i] = sc[i];
        __syncthreads();
      }
      for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
        const float si = sc[i];
        const float f =
            kImproper
                ? mcs::field_in_phase(sc, ss, nbr_idx, jt, ht, i, maxnb, lo,
                                      hi)
                : mcs::packed_field(sc, nbr_idx, jt, ht, i, maxnb);
        const float de = __fmul_rn(__fmul_rn(-2.0f, si), f);
        const uint32_t uid = uid0 + static_cast<uint32_t>(__ldg(perm + i));
        if (mcs::metropolis_accept_hashed(de, temp,
                                          uid * mcs::kGolden + ctr)) {
          sc[i] = -si;
        }
      }
      __syncthreads();
    }
    if (energies != nullptr) {
      const float e = mcs::packed_block_energy<false>(sc, nbr_idx, jt, ht,
                                                      n, maxnb, red);
      if (threadIdx.x == 0) {
        energies[static_cast<size_t>(t) * chains + chain] = e;
      }
    }
  }
}

}  // namespace

// Anneal `chains` chains of n packed spins `s` (chains, n) in place over
// the (steps,) temperatures, one CTA of `threads` (256) threads a chain, in
// one launch (stride_c != 0: the temperature of chain c at step t is
// temps[t * stride_t + c * stride_c]). nbr_idx / nbr_J (n, maxnb), h (n),
// perm (n) and starts (ncolors + 1) are the packed layout's; snap: scratch
// of the state's size for a packing that is not proper, else null;
// energies: a (steps, chains) float32 buffer or null; j_stride, h_stride
// and mcsteps: 0, 0 and 1 for the static tables, else the per-step stacks'
// strides and the sweeps a row (above); step0: the step the hash counts
// the first sweep as (a one-sweep launch inside a longer anneal). All
// device pointers; launches on `stream` and returns cudaGetLastError().
extern "C" int packed_sa_anneal(const int* nbr_idx, const float* nbr_J,
                                const float* h, const int* perm,
                                const int* starts, const float* temps,
                                float* s, float* snap, float* energies,
                                int chains, int n, int maxnb, int ncolors,
                                int steps, int seed, int step0, int threads,
                                int j_stride, int h_stride, int mcsteps,
                                int stride_t, int stride_c, void* stream) {
  if (chains == 0 || n == 0) return cudaSuccess;
  if (mcsteps < 1) return cudaErrorInvalidValue;
  // step0 folds into the seed term: counter(seed_term, t, i) is then
  // counter(seed, step0 + t, i), and so is every other counter of the step
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult +
                             static_cast<uint32_t>(step0) * mcs::kStepMult;
  const auto kernel =
      snap ? (stride_c ? packed_sa_kernel<true, true>
                       : packed_sa_kernel<false, true>)
           : (stride_c ? packed_sa_kernel<true, false>
                       : packed_sa_kernel<false, false>);
  kernel<<<chains, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      nbr_idx, nbr_J, h, perm, starts, temps, s, snap, energies, chains, n,
      maxnb,
      ncolors, steps, seed_term, j_stride, h_stride, mcsteps, stride_t,
      stride_c);
  return cudaGetLastError();
}

extern "C" const char* packed_sa_anneal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
