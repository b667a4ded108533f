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
// over its line's slices (476 MFLOP, a float32 bound of 0.007107 ms).
//
// The cluster route (generic_qmc_bath_words_anneal below, the kernel in
// csrc/generic_words.cuh, shared with generic PIQMC): a chain's slices as
// bits of each site's words over a cluster of R CTAs, ping-pong buffers in
// shared memory, the sequential sweep a line a thread walking its slices
// in the write buffer, the colored sweep a byte of slices a thread in one
// pass (the ping-pong gives every update its phase's starting state). What
// bounds it is the 40-term bath sum of every update, a serial chain of
// dependent adds; the design stages the (P, P) matrix in each CTA's shared
// memory (a warp's updates read one row of it, mostly the same entry) and
// unrolls each word's 32 terms, so each bit's sign is a shift by a
// constant. At the shape above 0.2603-0.2661 ms a sweep sequential,
// 0.2511-0.2586 colored (H100 80GB HBM3, 700.00 W; PERF.md), 35-37x the
// bound; a first design that read the matrix through __ldg and shifted by
// a variable bit took 0.381-0.429 and 0.379-0.386 (the same card).
//
// The file's first kernel (generic_qmc_bath_kernel below) stays, unchanged,
// for a chain no cluster of 16 CTAs holds
// (LAUNCHES["generic_qmc_bath_wide"]): one CTA of 256 threads a chain, the
// state as floats in device memory, every thread on a serial chain of
// slices and adds from L1/L2 (2.66-2.72 ms a sweep sequential at the shape
// above, 368x the bound, the same card). Its design:
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
//
// S5, the sharded bath's slice step (parallel/trotter.py::
// anneal_sharded(lookuptable=)). Replaces no TPU kernel: the JAX package
// runs `updated_slice` of montecarlosolvers_tpu/parallel/trotter.py::
// _sharded_dissipative_sweep (:170-192) as XLA inside shard_map. Plain
// PyTorch version: ops/shard_kernels.py::generic_shard_bath_slice_ref. A
// rank owns Ps of the P slices; one launch updates its local slice kloc
// (global kglob) of every chain through the classes in order, on the same
// dE, sums and uniforms as the sequential sweep above, the Trotter and bath
// terms read from `full`, every rank's slices gathered at the step's start
// (at one rank the slab itself: M[k, k] = 0 makes the slice's own entry
// +/-0). So one rank's sharded anneal equals the sequential kernel
// bitwise. What bounds it on an H100: the gathered state, read once (at
// 32 chains of 40 x 6400 float32 spins 32.8 MB, 0.0098 ms at 3.35 TB/s).
//
// The cluster route (generic_shard_bath_slice_cluster_kernel below), after
// the generic bath's (csrc/generic_words.cuh): one chain's slice over a
// cluster of R <= 16 CTAs, chains along gridDim.x, so 32 chains fill the
// card (R from ops/shard_kernels.py::shard_bath_geometry). CTA r holds the
// r-th chunk of every class on the same slot layout
// (ops/generic_kernels.py::word_layout).
// - Each of its sites' P slices of `full` is loaded once a launch, as
//   float32 or as the int8 the gather sends, and packed into W = ceil(P/32)
//   words in shared memory as it loads; the bath row M[kglob, .] is staged
//   beside them. The Trotter partners and the whole bath sum are then bits
//   of the site's own words (generic_words.cuh::bath_of_line), not P float
//   loads in a chain.
// - The slice's own spins sit in two ping-pong buffers of a word a slot
//   (bit 0); a class reads `src` and writes `dst`, same-class neighbours in
//   other CTAs through distributed shared memory, and ends with one
//   cluster.sync(): so a packing that is not proper (the 81x81
//   checkerboard) reads a same-class neighbour as it stood before the
//   class's phase, as the plain version does, with no snapshot in device
//   memory.
// The file's first S5 kernel (generic_shard_bath_slice_kernel below) stays,
// unchanged, for a chain no cluster of 16 CTAs holds
// (LAUNCHES["generic_shard_bath_slice_wide"]): one CTA of 256 threads a
// chain, a barrier between classes, an improper class's snapshot (`snap`,
// one slice a chain) in device memory, every update a serial chain of P
// float loads from the gathered state (0.1113-0.1235 ms a launch at the
// shape above, 11-12x the bound, H100 80GB HBM3, 700.00 W; PERF.md).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "counter_hash.cuh"
#include "energy.cuh"
#include "generic_words.cuh"
#include "packed.cuh"

namespace {

namespace cg = cooperative_groups;

// the head of an S5 cluster-route CTA's dynamic shared memory: the R <= 16
// CTAs' spin buffers (ops/shard_kernels.py::SHARD_HEAD_BYTES); the kernel
// has no static shared memory
constexpr int kShardHeadBytes = 16 * sizeof(uint32_t*);

// Shared memory of one S5 cluster-route CTA, all of it dynamic: the head,
// both buffers of its nr slots' spins, the slots' W line words and the bath
// row (ops/shard_kernels.py::shard_bath_smem_bytes counts the same)
inline size_t shard_bath_smem_bytes(int P, int nr) {
  return kShardHeadBytes +
         (2 + static_cast<size_t>((P + 31) / 32)) * nr * sizeof(uint32_t) +
         static_cast<size_t>(P) * sizeof(float);
}

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
                        uint32_t seed_term, int proper, uint32_t chain0) {
  __shared__ float red[mcs::kPackedThreads / 32];
  const int chain = blockIdx.x;
  const size_t stride = static_cast<size_t>(n);
  const size_t off = static_cast<size_t>(chain) * P * stride;
  float* const base = s + off;
  float* const sbase = snap == nullptr ? nullptr : snap + off;
  const uint32_t N = static_cast<uint32_t>(n);
  // the chain of the uids, counted from chain0 (the first chain of a chain
  // shard)
  const uint32_t uchain = chain0 + static_cast<uint32_t>(chain);
  const uint32_t line_uid0 = uchain * static_cast<uint32_t>(P) * N;
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
          (uchain * static_cast<uint32_t>(P) + static_cast<uint32_t>(k)) *
              N +
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


// S5: slice kloc of the slab s (chains, Ps, n), global slice kglob of P,
// through the classes in order; `full` (chains, P, n) at chain stride
// full_stride holds the state the Trotter and bath terms read.
__global__ void __launch_bounds__(mcs::kPackedThreads)
generic_shard_bath_slice_kernel(
    const int* __restrict__ nbr_idx, const float* __restrict__ nbr_J,
    const float* __restrict__ h, const int* __restrict__ perm,
    const int* __restrict__ starts, const float* __restrict__ b_sched,
    const float* __restrict__ jp, const float* __restrict__ bath,
    float teff, float two_teff, float* s, const float* full, float* snap,
    int Ps, int n, int maxnb, int ncolors, int kloc, int kglob, int P, int t,
    uint32_t seed_term, int proper, uint32_t chain0) {
  const int chain = blockIdx.x;
  const size_t stride = static_cast<size_t>(n);
  float* const sk = s + (static_cast<size_t>(chain) * Ps + kloc) * stride;
  const float* const line0 = full + static_cast<size_t>(chain) * P * stride;
  float* const ssnap = snap == nullptr ? nullptr : snap + chain * stride;
  const float bc = __fmul_rn(-2.0f, __ldg(b_sched + t));
  const float jpt = __ldg(jp + t);
  const uint32_t ctr = mcs::counter(seed_term, t, 0);
  const int up = kglob == 0 ? P - 1 : kglob - 1;
  const int dn = kglob + 1 == P ? 0 : kglob + 1;
  const uint32_t row =
      (chain0 + static_cast<uint32_t>(chain)) * static_cast<uint32_t>(P) +
      static_cast<uint32_t>(kglob);
  for (int c = 0; c < ncolors; ++c) {
    const int lo = __ldg(starts + c), hi = __ldg(starts + c + 1);
    if (!proper) {
      for (int i = lo + threadIdx.x; i < hi; i += blockDim.x)
        ssnap[i] = sk[i];
      __syncthreads();
    }
    // the same-class neighbours: the slice itself when proper (none lies
    // in the block), else the copy; field_in_phase reads `same + j`
    const float* same = proper ? sk : ssnap;
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      const float si = sk[i];
      const float f = mcs::field_in_phase(sk, same, nbr_idx, nbr_J, h, i,
                                          maxnb, lo, hi);
      const float tr =
          __fadd_rn(line0[up * stride + i], line0[dn * stride + i]);
      const float bf = bath_field(bath + static_cast<size_t>(kglob) * P,
                                  line0 + i, stride, P);
      const float de = __fadd_rn(
          __fadd_rn(__fmul_rn(__fmul_rn(bc, si), f),
                    __fmul_rn(__fmul_rn(__fmul_rn(2.0f, si), jpt), tr)),
          __fmul_rn(__fmul_rn(two_teff, si), bf));
      const uint32_t uid =
          row * static_cast<uint32_t>(n) +
          static_cast<uint32_t>(__ldg(perm + i));
      if (mcs::metropolis_accept_hashed(de, teff, uid * mcs::kGolden + ctr))
        sk[i] = -si;
    }
    __syncthreads();
  }
}

// S5's cluster route: slice kloc of chain blockIdx.x / R of the slab s
// (chains, Ps, n), global slice kglob of P, over R CTAs; `full` (chains,
// P, n) float32 or int8 (a spin is negative where its bit is set).
template <typename Full>
__global__ void __launch_bounds__(mcs::gw::kWordThreads, 2)
generic_shard_bath_slice_cluster_kernel(
    const int* __restrict__ slot_site, const int* __restrict__ slot_starts,
    const int* __restrict__ nbr_loc, const float* __restrict__ nbr_J,
    const float* __restrict__ h, const int* __restrict__ perm,
    const float* __restrict__ b_sched, const float* __restrict__ jp,
    const float* __restrict__ bath, float teff, float two_teff, float* s,
    const Full* full, int Ps, int n, int maxnb, int ncolors, int kloc,
    int kglob, int P, int t, int R, int nr, uint32_t seed_term,
    uint32_t chain0) {
  using mcs::gw::spin_of;
  extern __shared__ __align__(16) unsigned char s5_smem_raw[];
  uint32_t** const peers = reinterpret_cast<uint32_t**>(s5_smem_raw);
  // the two buffers of the slice's spins (bit 0 of a word a slot), the
  // line words of the slots, the bath row
  uint32_t* const spins =
      reinterpret_cast<uint32_t*>(s5_smem_raw + kShardHeadBytes);
  uint32_t* const line = spins + 2 * nr;
  const int W = (P + 31) >> 5;
  float* const mrow = reinterpret_cast<float*>(line + W * nr);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int chain = blockIdx.x / R;
  const int* const slots = slot_site + static_cast<size_t>(rank) * nr;
  for (int x = threadIdx.x; x < P; x += blockDim.x)
    mrow[x] = __ldg(bath + static_cast<size_t>(kglob) * P + x);
  if (static_cast<int>(threadIdx.x) < R)
    peers[threadIdx.x] = static_cast<int>(threadIdx.x) == rank
                             ? spins
                             : cluster.map_shared_rank(spins, threadIdx.x);
  float* const sk =
      s + (static_cast<size_t>(chain) * Ps + kloc) * static_cast<size_t>(n);
  for (int l = threadIdx.x; l < nr; l += blockDim.x) {
    const int info = __ldg(slots + l);
    spins[l] = info >= 0 ? static_cast<uint32_t>(sk[info & 0xffffff] < 0.0f)
                         : 0u;
  }
  // the lines, a word a thread at a time: bit b of word w is slice 32 w + b
  const Full* const f0 = full + static_cast<size_t>(chain) * P * n;
  for (int it = threadIdx.x; it < W * nr; it += blockDim.x) {
    const int w = it / nr;
    const int l = it - w * nr;
    const int info = __ldg(slots + l);
    uint32_t v = 0u;
    if (info >= 0) {
      const Full* const x = f0 + (info & 0xffffff);
      const int nbits = min(32, P - 32 * w);
      for (int b = 0; b < nbits; ++b)
        v |= static_cast<uint32_t>(
                 x[static_cast<size_t>(32 * w + b) * n] < static_cast<Full>(0))
             << b;
    }
    line[w * nr + l] = v;
  }
  cluster.sync();  // every CTA's spins and `peers` are in place

  const float bc = __fmul_rn(-2.0f, __ldg(b_sched + t));
  const float jpt = __ldg(jp + t);
  const uint32_t ctr = mcs::counter(seed_term, t, 0);
  const int up = kglob == 0 ? P - 1 : kglob - 1;
  const int dn = kglob + 1 == P ? 0 : kglob + 1;
  const uint32_t uid_row =
      ((chain0 + static_cast<uint32_t>(chain)) * static_cast<uint32_t>(P) +
       static_cast<uint32_t>(kglob)) *
      static_cast<uint32_t>(n);
  int src = 0;
  for (int c = 0; c < ncolors; ++c) {
    const int dst = nr - src;
    const int lo = __ldg(slot_starts + c), hi = __ldg(slot_starts + c + 1);
    for (int l = threadIdx.x; l < nr; l += blockDim.x)
      if (l < lo || l >= hi) spins[dst + l] = spins[src + l];
    for (int l = lo + threadIdx.x; l < hi; l += blockDim.x) {
      const int info = slots[l];
      const uint32_t word = spins[src + l];
      if (info < 0) {
        spins[dst + l] = word;
        continue;
      }
      const int i = info & 0xffffff;
      mcs::gw::Nbrs nb;
      nb.load(nbr_loc, nbr_J, h, i, maxnb);
      mcs::gw::load_words(nb, peers, src, nr, 0);
      const float si = spin_of(word, 0);
      const float f = mcs::gw::field_bit(nb, peers, src, nr, 0, 0);
      const float tr = __fadd_rn(spin_of(line[(up >> 5) * nr + l], up & 31),
                                 spin_of(line[(dn >> 5) * nr + l], dn & 31));
      const float bf = mcs::gw::bath_of_line(mrow, line + l, nr, P);
      const float de = __fadd_rn(
          __fadd_rn(__fmul_rn(__fmul_rn(bc, si), f),
                    __fmul_rn(__fmul_rn(__fmul_rn(2.0f, si), jpt), tr)),
          __fmul_rn(__fmul_rn(two_teff, si), bf));
      const uint32_t uid =
          uid_row + static_cast<uint32_t>(__ldg(perm + i));
      spins[dst + l] =
          mcs::metropolis_accept_hashed(de, teff, uid * mcs::kGolden + ctr)
              ? word ^ 1u
              : word;
    }
    cluster.sync();  // the next class reads this one's writes
    src = dst;
  }
  for (int l = threadIdx.x; l < nr; l += blockDim.x) {
    const int info = slots[l];
    if (info >= 0) sk[info & 0xffffff] = spin_of(spins[src + l], 0);
  }
  cluster.sync();  // no CTA leaves while another may read its spins
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
// as; chain0: the global index of the first chain, which the uids count
// from (a chain shard; 0 unsharded). All device pointers; launches on
// `stream` and returns cudaGetLastError().
extern "C" int generic_qmc_bath_anneal(
    const int* nbr_idx, const float* nbr_J, const float* h, const int* perm,
    const int* starts, const float* b_sched, const float* jp,
    const float* bath, float teff, float two_teff, float* s, float* snap,
    float* energies, int chains, int P, int n, int maxnb, int ncolors, int m,
    int steps, int seed, int step0, int colored, int global_moves, int proper,
    int threads, int chain0, void* stream) {
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
      proper, static_cast<uint32_t>(chain0));
  return cudaGetLastError();
}

// S5's first kernel: one local slice step of the sharded bath (see the
// header): slice kloc of the slab s (chains, Ps, n) in place, global slice
// kglob of P, at step t of the (steps,) schedules B and J_perp, the (P, P)
// bath matrix at T_eff = `teff` (two_teff: 2 T_eff rounded to float32);
// full (chains, P, n) float32, the gathered state (s itself at one rank);
// snap (chains, n) scratch when proper == 0, else null; chain0 the global
// index of the first chain. One CTA of 256 threads a chain. All device
// pointers; launches on `stream` and returns cudaGetLastError().
extern "C" int generic_qmc_bath_shard_slice(
    const int* nbr_idx, const float* nbr_J, const float* h, const int* perm,
    const int* starts, const float* b_sched, const float* jp,
    const float* bath, float teff, float two_teff, float* s,
    const float* full, float* snap, int chains, int Ps, int n, int maxnb,
    int ncolors, int kloc, int kglob, int P, int t, int seed, int proper,
    int chain0, void* stream) {
  if (chains == 0 || n == 0) return cudaSuccess;
  if (!proper && snap == nullptr) return cudaErrorInvalidValue;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  generic_shard_bath_slice_kernel<<<chains, mcs::kPackedThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      nbr_idx, nbr_J, h, perm, starts, b_sched, jp, bath, teff, two_teff, s,
      full, snap, Ps, n, maxnb, ncolors, kloc, kglob, P, t, seed_term, proper,
      static_cast<uint32_t>(chain0));
  return cudaGetLastError();
}

// S5's cluster route (see the header): the step of
// generic_qmc_bath_shard_slice on slice kloc of the slab s (chains, Ps, n)
// in place, `full` (chains, P, n) float32 (full_int8 == 0; s itself at one
// rank) or int8 (the gather's), each chain over a cluster of R CTAs of
// `threads` threads holding nr slots each; slot_site (R, nr), slot_starts
// (ncolors + 1) and nbr_loc (n, maxnb) the slot layout
// (ops/generic_kernels.py::word_layout). A packing that is not proper
// needs no flag here. All device pointers; launches on `stream` and
// returns the launch's error.
extern "C" int generic_qmc_bath_shard_slice_cluster(
    const int* slot_site, const int* slot_starts, const int* nbr_loc,
    const float* nbr_J, const float* h, const int* perm,
    const float* b_sched, const float* jp, const float* bath, float teff,
    float two_teff, float* s, const void* full, int full_int8, int chains,
    int Ps, int n, int maxnb, int ncolors, int kloc, int kglob, int P, int t,
    int seed, int R, int nr, int threads, int chain0, void* stream) {
  if (chains == 0 || n == 0) return cudaSuccess;
  if (R < 1 || R > 16 || threads > mcs::gw::kWordThreads)
    return cudaErrorInvalidValue;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  const size_t smem = shard_bath_smem_bytes(P, nr);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (full_int8)
    return mcs::gw::launch_words(
        generic_shard_bath_slice_cluster_kernel<int8_t>, chains, R, threads,
        smem, st, slot_site, slot_starts, nbr_loc, nbr_J, h, perm, b_sched,
        jp, bath, teff, two_teff, s, static_cast<const int8_t*>(full), Ps, n,
        maxnb, ncolors, kloc, kglob, P, t, R, nr, seed_term,
        static_cast<uint32_t>(chain0));
  return mcs::gw::launch_words(
      generic_shard_bath_slice_cluster_kernel<float>, chains, R, threads,
      smem, st, slot_site, slot_starts, nbr_loc, nbr_J, h, perm, b_sched, jp,
      bath, teff, two_teff, s, static_cast<const float*>(full), Ps, n, maxnb,
      ncolors, kloc, kglob, P, t, R, nr, seed_term,
      static_cast<uint32_t>(chain0));
}

// Clusters of R CTAs of `threads` threads the card holds at once of S5's
// cluster route at P slices and nr slots a CTA, with float32 or int8
// `full` (cudaOccupancyMaxActiveClusters)
extern "C" int generic_qmc_bath_shard_max_active_clusters(
    int P, int nr, int R, int threads, int full_int8, int* count) {
  const size_t smem = shard_bath_smem_bytes(P, nr);
  if (full_int8)
    return mcs::max_active_clusters(
        generic_shard_bath_slice_cluster_kernel<int8_t>, R, threads, smem,
        count);
  return mcs::max_active_clusters(
      generic_shard_bath_slice_cluster_kernel<float>, R, threads, smem,
      count);
}

// The cluster route (csrc/generic_words.cuh): the anneal of
// generic_qmc_bath_anneal on chains of P slices of +/-1 floats s_in
// (chains, P, n), packed into words as the kernel loads them, into s_out
// (the same shape), each chain over a cluster of R CTAs of
// `threads` threads holding nr slots each; slot_site (R, nr), slot_starts
// (ncolors + 1) and nbr_loc (n, maxnb) the slot layout
// (ops/generic_kernels.py::word_layout). A packing that is not proper
// needs no flag here. All device pointers; launches on `stream` and
// returns the launch's error.
extern "C" int generic_qmc_bath_words_anneal(
    const int* slot_site, const int* slot_starts, const int* nbr_loc,
    const float* nbr_J, const float* h, const int* perm,
    const float* b_sched, const float* jp, const float* bath, float teff,
    float two_teff, const float* s_in, float* s_out, float* energies,
    int chains, int P, int n, int maxnb, int ncolors, int m, int R, int nr,
    int threads, int steps, int seed, int step0, int colored,
    int global_moves, int chain0, void* stream) {
  if (chains == 0 || n == 0 || P == 0) return cudaSuccess;
  if (R < 1 || R > 16 || threads > mcs::gw::kWordThreads)
    return cudaErrorInvalidValue;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult +
                             static_cast<uint32_t>(step0) * mcs::kStepMult;
  using mcs::gw::generic_words_kernel;
  using mcs::gw::kBathColored;
  using mcs::gw::kBathSequential;
  using Kernel = decltype(&generic_words_kernel<kBathColored, false, false>);
  // [colored][global_moves]
  const Kernel kernels[2][2] = {
      {generic_words_kernel<kBathSequential, false, false>,
       generic_words_kernel<kBathSequential, true, false>},
      {generic_words_kernel<kBathColored, false, false>,
       generic_words_kernel<kBathColored, true, false>}};
  const Kernel kernel = kernels[colored != 0][global_moves != 0];
  return mcs::gw::launch_words(
      kernel, chains, R, threads,
      mcs::gw::words_smem_bytes(P, nr, energies != nullptr, true),
      static_cast<cudaStream_t>(stream), slot_site, slot_starts, nbr_loc,
      nbr_J, h, perm, b_sched, jp, bath, teff, two_teff, s_in, s_out,
      energies, chains, P, n, maxnb, ncolors, m, R, nr, steps, seed_term, 0,
      0, static_cast<uint32_t>(chain0));
}

extern "C" const char* generic_qmc_bath_anneal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
