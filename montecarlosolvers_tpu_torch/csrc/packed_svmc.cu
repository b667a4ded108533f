// Generic SVMC: class-major rotor sweeps of an IsingProblem graph on carried
// cos / sin caches, uniform or TF proposals, the whole schedule in one
// launch.
//
// Replaces no TPU kernel: the JAX package runs this path as an XLA scan,
// montecarlosolvers_tpu/ops/packed.py::packed_svmc_scan (:298), whose body
// is packed_svmc_sweep_cached (:149) under _svmc_scan (:237). Plain
// PyTorch version: ops/generic_kernels.py::packed_svmc_anneal_ref
// (ops/packed.py::packed_svmc_sweep_cached on the counter hash), which
// equals the masked ops/svmc_ops.py::svmc_sweep_cached bitwise.
//
// What it computes. A chain's N rotor angles theta in [0, pi], in packed
// order (packed.cuh), with cos theta and sin theta carried beside them.
// Step t at (A_t, B_t) visits the C color blocks in order; every site i of
// a block proposes pi*u, or with TF proposals clip(theta + min(A/B, 1) *
// (2 pi u - pi), 0, pi) (svmc.cuh), u = uniform01(counter(seed, t, 0),
// chain * N + perm[i]), and accepts on dE = B (cos' - cos) z + A (sin -
// sin'), z = sum_k J cos_nb + h (packed.cuh::packed_field on the cos
// cache), if dE <= 0 or -T log1p(-u') > dE, u' at svmc_accept_counter(seed,
// t, 0) and the same uid. With `energies`, the classical energy of
// sign(cos theta) after step t goes into energies[t, chain], reduced in
// the kernel.
//
// What bounds it on an H100. Per update: two hashed uniforms, one sincosf
// of the proposal, log1pf, maxnb gathered cos values and couplings and
// about 12 rounded float operations: issue- and special-function-bound.
// The main path's 256 chains of 6400 rotors keep three floats a site, 19.7
// MB, in L2.
//
// What the design does about that, simply (a first kernel): one CTA of 256
// threads a chain, theta and both caches in device memory (any N, any
// color count), a __syncthreads() between blocks. Every multiply and add
// is written __fmul_rn / __fadd_rn in the plain version's order (svmc.cuh).
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"
#include "energy.cuh"
#include "packed.cuh"
#include "svmc.cuh"

namespace {

template <bool kTF>
__global__ void __launch_bounds__(mcs::kPackedThreads)
packed_svmc_kernel(const int* __restrict__ nbr_idx,
                   const float* __restrict__ nbr_J,
                   const float* __restrict__ h, const int* __restrict__ perm,
                   const int* __restrict__ starts,
                   const float* __restrict__ a_sched,
                   const float* __restrict__ b_sched, float temp, float* th,
                   float* cs, float* sn, float* __restrict__ energies,
                   int chains, int n, int maxnb, int ncolors, int steps,
                   uint32_t seed_term) {
  __shared__ float red[mcs::kPackedThreads / 32];
  const int chain = blockIdx.x;
  const size_t base = static_cast<size_t>(chain) * n;
  th += base;
  cs += base;
  sn += base;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sincosf(th[i], sn + i, cs + i);
  }
  __syncthreads();
  const uint32_t uid0 =
      static_cast<uint32_t>(chain) * static_cast<uint32_t>(n);
  for (int t = 0; t < steps; ++t) {
    const float a = __ldg(a_sched + t);
    const float b = __ldg(b_sched + t);
    const float width = kTF ? mcs::tf_width(a, b) : 0.0f;
    const uint32_t ctr = mcs::counter(seed_term, t, 0);
    const uint32_t ctr_acc = mcs::svmc_accept_counter(seed_term, t, 0);
    for (int c = 0; c < ncolors; ++c) {
      const int hi = __ldg(starts + c + 1);
      for (int i = __ldg(starts + c) + threadIdx.x; i < hi; i += blockDim.x) {
        const uint32_t uid = uid0 + static_cast<uint32_t>(__ldg(perm + i));
        const float theta = th[i];
        const float prop =
            mcs::propose<kTF>(theta, mcs::uniform01(ctr, uid), width);
        float sin_p, cos_p;
        sincosf(prop, &sin_p, &cos_p);
        const float z = mcs::packed_field(cs, nbr_idx, nbr_J, h, i, maxnb);
        const float de = mcs::delta_e(b, a, cos_p, cs[i], z, sn[i], sin_p);
        if (mcs::metropolis_accept_hashed(de, temp,
                                          uid * mcs::kGolden + ctr_acc)) {
          th[i] = prop;
          cs[i] = cos_p;
          sn[i] = sin_p;
        }
      }
      __syncthreads();
    }
    if (energies != nullptr) {
      const float e = mcs::packed_block_energy<true>(cs, nbr_idx, nbr_J, h, n,
                                                     maxnb, red);
      if (threadIdx.x == 0) {
        energies[static_cast<size_t>(t) * chains + chain] = e;
      }
    }
  }
}

}  // namespace

// Anneal `chains` chains of n packed angles `th` (chains, n) in place over
// the (steps,) schedules A and B at temperature `temp`, one CTA of
// `threads` (256) threads a chain, in one launch. scratch: 2 * chains * n
// floats for the cos and sin caches; the packed layout's nbr_idx / nbr_J
// (n, maxnb), h (n), perm (n), starts (ncolors + 1); tf != 0 selects the
// TF proposals; energies: a (steps, chains) float32 buffer or null. All
// device pointers; launches on `stream` and returns cudaGetLastError().
extern "C" int packed_svmc_anneal(const int* nbr_idx, const float* nbr_J,
                                  const float* h, const int* perm,
                                  const int* starts, const float* a_sched,
                                  const float* b_sched, float temp, float* th,
                                  float* scratch, float* energies, int chains,
                                  int n, int maxnb, int ncolors, int steps,
                                  int seed, int tf, int threads,
                                  void* stream) {
  if (chains == 0 || n == 0) return cudaSuccess;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  auto kernel = tf ? packed_svmc_kernel<true> : packed_svmc_kernel<false>;
  float* cs = scratch;
  float* sn = scratch + static_cast<size_t>(chains) * n;
  kernel<<<chains, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      nbr_idx, nbr_J, h, perm, starts, a_sched, b_sched, temp, th, cs, sn,
      energies, chains, n, maxnb, ncolors, steps, seed_term);
  return cudaGetLastError();
}

extern "C" const char* packed_svmc_anneal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
