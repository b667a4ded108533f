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
// What bounds it on an H100. Per local update: maxnb neighbour spins, the
// two Trotter neighbours, the hash and log1pf; per line, P fields again
// and one hash. The float32 work of a sweep at the main path's 80x80
// generic form, P = 40, 32 chains is 148.5 MFLOP, a bound of 0.002216 ms.
// The file's first kernel (generic_qmc_kernel below: one CTA of 256
// threads a chain, the state as floats in device memory, a
// __syncthreads() between phases) filled 32 of the 132 SMs and walked
// every update through L1/L2: 1.436-1.446 ms a sweep, 643x the bound (H100
// 80GB HBM3, 700.00 W; PERF.md).
//
// What the design does about that: the cluster route of
// csrc/generic_words.cuh (generic_qmc_words_anneal below): a chain's
// slices as bits of each site's words, spread over a cluster of R CTAs
// (R = 8 at 32 chains: 256 CTAs on 132 SMs), both ping-pong buffers in
// shared memory, one cluster barrier a phase; 0.1333-0.1458 ms a sweep at
// that shape (same card, PERF.md), 60-66x the bound. generic_qmc_kernel
// stays, unchanged, for a chain whose words no cluster of 16 CTAs holds
// (ops/generic_kernels.py::generic_qmc_geometry;
// LAUNCHES["generic_qmc_wide"]): there one CTA a chain is what it gets.
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
//
// chain0, the global index of the first chain of a chain shard
// (parallel/mesh.py), counts every uid from the global chain; 0
// unsharded. The shard kernels S3 and S4 at the end (ops/shard_kernels.py)
// run one phase, or one color's line moves, a launch on a rank's slab of
// slices, for parallel/trotter.py::anneal_sharded.
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"
#include "energy.cuh"
#include "generic_words.cuh"
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
                   uint32_t seed_term, int stride_t, int stride_c,
                   uint32_t chain0) {
  __shared__ float red[mcs::kPackedThreads / 32];
  const int chain = blockIdx.x;
  const size_t stride = static_cast<size_t>(n);
  float* const base = s + static_cast<size_t>(chain) * P * stride;
  float* const sbase =
      kImproper ? snap + static_cast<size_t>(chain) * P * stride : nullptr;
  const uint32_t N = static_cast<uint32_t>(n);
  // the chain of the uids, counted from chain0 (the first chain of a chain
  // shard)
  const uint32_t uchain = chain0 + static_cast<uint32_t>(chain);
  const uint32_t line_uid0 = uchain * static_cast<uint32_t>(P) * N;
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
            (uchain * static_cast<uint32_t>(P) + static_cast<uint32_t>(k)) *
            N;
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

// ---- the shard kernels of the Trotter-sharded generic engine
// (parallel/trotter.py::anneal_sharded), a rank's slab of slices k0 .. k0 +
// Ps - 1 of a P-slice state, one thread per (chain, slice, site)

// The color class of packed site i: the block [starts[c], starts[c+1])
// holding it.
__device__ __forceinline__ int class_of(const int* __restrict__ starts,
                                        int ncolors, int i) {
  int c = 0;
  while (c + 1 < ncolors && i >= __ldg(starts + c + 1)) ++c;
  return c;
}

// S3: local phase p of step t on a slab, out of place: site i of slice k
// (global kg = k0 + k) is updated when (class(i) + kg) mod m == p, reading
// the slab `src` as the phase found it; every site is written to `dst`.
// The Trotter partners past the slab's edges are the neighbour ranks' rows
// `halo_up` (slice k0 - 1) and `halo_dn` (slice k0 + Ps), (chains, n) with
// their chains halo_stride floats apart, filled by the ring exchange before
// the phase. Since every read is of the
// phase's start, a packing that is not proper reads its same-class
// neighbours as generic_qmc_kernel's kImproper snapshot does. uid
// ((chain0 + chain)*P + kg)*N + perm[i] at counter(seed, t, 0).
__global__ void __launch_bounds__(mcs::kPackedThreads)
generic_shard_phase_kernel(
    const int* __restrict__ nbr_idx, const float* __restrict__ nbr_J,
    const float* __restrict__ h, const int* __restrict__ perm,
    const int* __restrict__ starts, const float* __restrict__ b_sched,
    const float* __restrict__ jp, float teff, const float* __restrict__ src,
    float* __restrict__ dst, const float* __restrict__ halo_up,
    const float* __restrict__ halo_dn, int halo_stride, int Ps, int n,
    int maxnb, int ncolors, int m, int p, int xblocks, int t,
    uint32_t seed_term, uint32_t chain0, uint32_t k0, uint32_t P) {
  const int ck = blockIdx.x / xblocks;  // chain * Ps + k
  const int i = (blockIdx.x - ck * xblocks) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int chain = ck / Ps;
  const int k = ck - chain * Ps;
  const size_t stride = static_cast<size_t>(n);
  const float* sk = src + static_cast<size_t>(ck) * stride;
  const float si = sk[i];
  const uint32_t kg = k0 + static_cast<uint32_t>(k);
  const int c = class_of(starts, ncolors, i);
  if ((static_cast<uint32_t>(c) + kg) % static_cast<uint32_t>(m) !=
      static_cast<uint32_t>(p)) {
    dst[static_cast<size_t>(ck) * stride + i] = si;
    return;
  }
  const size_t at = static_cast<size_t>(chain) * halo_stride + i;
  const float up = k == 0 ? halo_up[at] : sk[i - stride];
  const float dn = k + 1 == Ps ? halo_dn[at] : sk[i + stride];
  const float bc = __fmul_rn(-2.0f, __ldg(b_sched + t));
  const float f = mcs::packed_field(sk, nbr_idx, nbr_J, h, i, maxnb);
  const float de = __fadd_rn(
      __fmul_rn(__fmul_rn(bc, si), f),
      __fmul_rn(__fmul_rn(__fmul_rn(2.0f, si), __ldg(jp + t)),
                __fadd_rn(up, dn)));
  const uint32_t uid =
      ((chain0 + static_cast<uint32_t>(chain)) * P + kg) *
          static_cast<uint32_t>(n) +
      static_cast<uint32_t>(__ldg(perm + i));
  dst[static_cast<size_t>(ck) * stride + i] =
      mcs::metropolis_accept_hashed(de, teff,
                                    uid * mcs::kGolden +
                                        mcs::counter(seed_term, t, 0))
          ? -si
          : si;
}

// S4, first half: a slab's part of the line dE of the lines of class c
// (packed sites lo .. lo + nc - 1), sum_k (-2B s_k) f_k over the slab's
// slices in order, into part (chains, nc); no site is written.
__global__ void __launch_bounds__(mcs::kPackedThreads)
generic_shard_line_part_kernel(
    const int* __restrict__ nbr_idx, const float* __restrict__ nbr_J,
    const float* __restrict__ h, const float* __restrict__ b_sched,
    const float* __restrict__ s, float* __restrict__ part, int Ps, int n,
    int maxnb, int lo, int nc, int xblocks, int t) {
  const int chain = blockIdx.x / xblocks;
  const int a = (blockIdx.x - chain * xblocks) * blockDim.x + threadIdx.x;
  if (a >= nc) return;
  const int i = lo + a;
  const size_t stride = static_cast<size_t>(n);
  const float* base = s + static_cast<size_t>(chain) * Ps * stride;
  const float bc = __fmul_rn(-2.0f, __ldg(b_sched + t));
  float de = 0.0f;
  for (int k = 0; k < Ps; ++k) {
    const float* sk = base + k * stride;
    const float term = __fmul_rn(
        __fmul_rn(bc, sk[i]), mcs::packed_field(sk, nbr_idx, nbr_J, h, i,
                                                maxnb));
    de = k == 0 ? term : __fadd_rn(de, term);
  }
  part[static_cast<size_t>(chain) * nc + a] = de;
}

// S4, second half: the lines of class c accept on the summed dE `total`
// (chains, nc) at line_counter(seed, t, 0), uid (chain0 + chain)*P*N +
// perm[i], and flip the slab's slices of their site.
__global__ void __launch_bounds__(mcs::kPackedThreads)
generic_shard_line_accept_kernel(const int* __restrict__ perm, float teff,
                                 const float* __restrict__ total, float* s,
                                 int Ps, int n, int lo, int nc, int xblocks,
                                 int t, uint32_t seed_term, uint32_t chain0,
                                 uint32_t P) {
  const int chain = blockIdx.x / xblocks;
  const int a = (blockIdx.x - chain * xblocks) * blockDim.x + threadIdx.x;
  if (a >= nc) return;
  const int i = lo + a;
  const uint32_t uid =
      (chain0 + static_cast<uint32_t>(chain)) * P *
          static_cast<uint32_t>(n) +
      static_cast<uint32_t>(__ldg(perm + i));
  if (!mcs::metropolis_accept_hashed(
          total[static_cast<size_t>(chain) * nc + a], teff,
          uid * mcs::kGolden + mcs::line_counter(seed_term, t, 0)))
    return;
  float* base = s + static_cast<size_t>(chain) * Ps * n + i;
  for (int k = 0; k < Ps; ++k) base[static_cast<size_t>(k) * n] *= -1.0f;
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
// marks a packing that is not proper; chain0: the global index of the
// first chain, which the uids count from (a chain shard; 0 unsharded). All
// device pointers; launches on `stream` and returns cudaGetLastError().
extern "C" int generic_qmc_anneal(const int* nbr_idx, const float* nbr_J,
                                  const float* h, const int* perm,
                                  const int* starts, const float* b_sched,
                                  const float* jp, float teff, float* s,
                                  float* snap, float* energies, int chains,
                                  int P, int n,
                                  int maxnb, int ncolors, int m, int steps,
                                  int seed, int step0, int global_moves,
                                  int threads, int stride_t, int stride_c,
                                  int chain0, void* stream) {
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
      chains, P, n, maxnb, ncolors, m, steps, seed_term, stride_t, stride_c,
      static_cast<uint32_t>(chain0));
  return cudaGetLastError();
}

// The cluster route (csrc/generic_words.cuh): anneal `chains` chains of P
// slices of +/-1 floats s_in (chains, P, n), which the kernel packs into
// W = ceil(P/32) words a site as it loads them (bit k % 32 of word k / 32
// the sign of slice k), into s_out (the same shape), each chain over
// a cluster of R CTAs of `threads` threads holding nr slots each;
// slot_site (R, nr), slot_starts (ncolors + 1) and nbr_loc (n, maxnb) the
// slot layout (ops/generic_kernels.py::word_layout); the rest as for
// generic_qmc_anneal. All device pointers; launches on `stream` and
// returns the launch's error.
extern "C" int generic_qmc_words_anneal(
    const int* slot_site, const int* slot_starts, const int* nbr_loc,
    const float* nbr_J, const float* h, const int* perm,
    const float* b_sched, const float* jp, float teff, const float* s_in,
    float* s_out, float* energies, int chains, int P, int n, int maxnb,
    int ncolors, int m, int R, int nr, int threads, int steps, int seed,
    int step0, int global_moves, int stride_t, int stride_c, int chain0,
    void* stream) {
  if (chains == 0 || n == 0 || P == 0) return cudaSuccess;
  if (R < 1 || R > 16 || threads > mcs::gw::kWordThreads)
    return cudaErrorInvalidValue;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult +
                             static_cast<uint32_t>(step0) * mcs::kStepMult;
  using mcs::gw::generic_words_kernel;
  using mcs::gw::kPiqmc;
  using Kernel = decltype(&generic_words_kernel<kPiqmc, false, false>);
  // [global_moves][per chain]
  const Kernel kernels[2][2] = {
      {generic_words_kernel<kPiqmc, false, false>,
       generic_words_kernel<kPiqmc, false, true>},
      {generic_words_kernel<kPiqmc, true, false>,
       generic_words_kernel<kPiqmc, true, true>}};
  const Kernel kernel = kernels[global_moves != 0][stride_c != 0];
  return mcs::gw::launch_words(
      kernel, chains, R, threads,
      mcs::gw::words_smem_bytes(P, nr, energies != nullptr, false),
      static_cast<cudaStream_t>(stream), slot_site, slot_starts, nbr_loc,
      nbr_J, h, perm, b_sched, jp, static_cast<const float*>(nullptr), teff,
      0.0f, s_in, s_out, energies, chains, P, n, maxnb, ncolors, m, R, nr,
      steps, seed_term, stride_t, stride_c, static_cast<uint32_t>(chain0));
}

extern "C" const char* generic_qmc_anneal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// S3 on a rank's slab: phase p of step t from src to dst (chains, Ps, n),
// with the halo rows halo_up, halo_dn (chains, n), their chains
// halo_stride floats apart; the packed layout, schedules and seed as for
// generic_qmc_anneal; chain0, k0 and P the slab's global first chain,
// first slice and the state's P. One launch on `stream`; returns
// cudaGetLastError().
extern "C" int generic_qmc_shard_phase(
    const int* nbr_idx, const float* nbr_J, const float* h, const int* perm,
    const int* starts, const float* b_sched, const float* jp, float teff,
    const float* src, float* dst, const float* halo_up, const float* halo_dn,
    int halo_stride, int chains, int Ps, int n, int maxnb, int ncolors,
    int m, int p, int t, int seed, int chain0, int k0, int P,
    void* stream) {
  if (chains == 0 || Ps == 0 || n == 0) return cudaSuccess;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  const int xblocks = (n + mcs::kPackedThreads - 1) / mcs::kPackedThreads;
  generic_shard_phase_kernel<<<static_cast<unsigned>(xblocks) * chains * Ps,
                               mcs::kPackedThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      nbr_idx, nbr_J, h, perm, starts, b_sched, jp, teff, src, dst, halo_up,
      halo_dn, halo_stride, Ps, n, maxnb, ncolors, m, p, xblocks, t,
      seed_term, static_cast<uint32_t>(chain0), static_cast<uint32_t>(k0),
      static_cast<uint32_t>(P));
  return cudaGetLastError();
}

// S4's first half: the part (chains, nc) of the line dE of class block
// [lo, lo + nc) over the slab s (chains, Ps, n) at step t. One launch.
extern "C" int generic_qmc_shard_line_part(
    const int* nbr_idx, const float* nbr_J, const float* h,
    const float* b_sched, const float* s, float* part, int chains, int Ps,
    int n, int maxnb, int lo, int nc, int t, void* stream) {
  if (chains == 0 || nc == 0) return cudaSuccess;
  const int xblocks = (nc + mcs::kPackedThreads - 1) / mcs::kPackedThreads;
  generic_shard_line_part_kernel<<<static_cast<unsigned>(xblocks) * chains,
                                   mcs::kPackedThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      nbr_idx, nbr_J, h, b_sched, s, part, Ps, n, maxnb, lo, nc, xblocks, t);
  return cudaGetLastError();
}

// S4's second half: the lines of block [lo, lo + nc) accept on `total`
// (chains, nc) and flip the slab s (chains, Ps, n) in place; seed, chain0
// and P as for generic_qmc_shard_phase. One launch.
extern "C" int generic_qmc_shard_line_accept(
    const int* perm, float teff, const float* total, float* s, int chains,
    int Ps, int n, int lo, int nc, int t, int seed, int chain0, int P,
    void* stream) {
  if (chains == 0 || nc == 0) return cudaSuccess;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  const int xblocks = (nc + mcs::kPackedThreads - 1) / mcs::kPackedThreads;
  generic_shard_line_accept_kernel<<<static_cast<unsigned>(xblocks) * chains,
                                     mcs::kPackedThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      perm, teff, total, s, Ps, n, lo, nc, xblocks, t, seed_term,
      static_cast<uint32_t>(chain0), static_cast<uint32_t>(P));
  return cudaGetLastError();
}
