// The cluster route of generic PIQMC (csrc/generic_qmc.cu) and of the
// generic bath (csrc/generic_qmc_bath.cu): one chain's slices as bits of
// each site's words, spread over a thread-block cluster, the whole schedule
// in one launch. The SA mode at the end of the file runs generic SA
// (csrc/packed_sa.cu) on the same layout, a group of chains as the bits.
//
// What it computes is the kernels' of the two files, bitwise: the same
// flip decisions from the same counter-hash uniforms (counter(seed, t, 0)
// at uid ((chain0 + chain) * P + k) * N + perm[i], the line moves at
// line_counter(seed, t, 0), uid (chain0 + chain) * P * N + perm[i]), and
// every __fmul_rn / __fadd_rn in the same order: the field is the slot
// products in slot order, then h; the bath sum sum_p M[k, p] s_p in index
// order, added left to right; a line's dE sum_k (bc s_k) f_k in slice
// order.
//
// What bounds the first kernels of those files (one CTA of 256 threads a
// chain, the state as floats in device memory): 32 chains fill 32 of the
// 132 SMs, and every update walks a serial chain of loads from L1/L2
// (PERF.md: 643x and 368x their bound at 80x80, P = 40). What this design
// does about that, after kernels B, 3 and 5 (csrc/split_qmc.cu,
// plane_qmc.cu, split_qmc_bath.cu) on an arbitrary graph:
// - The state as line words. Bit k % 32 of word k / 32 of a site is the
//   sign of slice k (1 for -1), W = ceil(P/32) words a site, as
//   ops/plane_kernels.py::pack_slice_bits packs them; the kernel packs the
//   float (chains, P, N) state as it loads it and writes floats back, so
//   the round trip costs no launch of its own. The Trotter partners and
//   the whole bath line are bits of the site's own words; a neighbour's
//   word is read once for the slices a site owns in a phase, so a line
//   move's P fields cost maxnb word reads a word, not P x maxnb float
//   loads.
// - One chain over a cluster of R <= 16 CTAs (chains along gridDim.x).
//   CTA r holds, of every color class c, the r-th of R equal chunks
//   (ceil(n_c / R) slots; every CTA the same slot layout, class c from slot
//   slot_starts[c]), so the phases that update one class at a time (the
//   line moves, the sequential bath) keep every CTA busy. `slot_site`
//   (R, nr) names each slot's packed site and class ((c << 24) | i, -1
//   for an empty slot); `nbr_loc` (N, maxnb) each neighbour's CTA and slot
//   ((r << 16) | slot). A neighbour in another CTA is read through
//   distributed shared memory (cluster.map_shared_rank); the tables, h
//   and perm through __ldg, the bath matrix staged in shared memory (a
//   warp's updates read one row of it, mostly the same entry).
// - Ping-pong. Both buffers of a CTA's slots sit in its shared memory
//   (2 W nr words), after a head of kHeadBytes (the cluster's buffer
//   pointers and block_sum's warp sums): the kernel has no static shared
//   memory, so words_smem_bytes counts every byte the CTA asks for. Every
//   phase reads `src`, writes every slot's words into `dst` and ends with
//   one cluster.sync(); so every decision sees the state its phase began
//   with, which is what the plain versions' masked phases see. A packing that is not proper (an odd torus's
//   checkerboard) needs no case of its own, and the colored bath no second
//   pass.
// - Local phases (PIQMC, colored bath): a thread takes one byte of a
//   site's words (8 slices) and updates the slices k of it with
//   (class + k) % m == p, one word read a neighbour for all of them; a
//   warp's bytes are of one byte index and neighbouring slots, so its
//   threads walk the same slices. The sequential bath keeps its
//   class-major order: a thread owns a line of class c and walks k = 0 ..
//   P - 1 in `dst`, reading classes c' < c after this step's update and
//   c' > c before it from `src`: C cluster barriers a step. The line moves
//   take a line a thread.
// - With `energies`, each CTA sums its slots' share of every slice's
//   energy in a fixed order (energy.cuh::block_sum) and CTA 0 adds the R
//   shares in rank order: the least slice energy after step t, reduced
//   across the cluster with no atomics.
// The wrappers (ops/generic_kernels.py) choose R and the threads by
// `generic_qmc_geometry` (`generic_qmc_bath_geometry`, whose CTAs also
// hold the bath matrix); a chain whose words do not fit 16 CTAs' shared
// memory takes the file's first kernel, kept as it was (the "_wide"
// launch keys). 512 threads a CTA at two CTAs an SM cap a thread at 64
// registers, and ptxas spills 60-168 bytes (144-168 with line moves);
// 256 threads a CTA spill nothing and ran 3-15 % slower a sweep (H100
// 80GB HBM3, 700.00 W; PERF.md), so the cap stays.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "counter_hash.cuh"
#include "energy.cuh"

namespace mcs {
namespace gw {

namespace cg = cooperative_groups;

// at most this many threads a CTA (ops/generic_kernels.py::WORD_THREADS),
// registers for two CTAs an SM
constexpr int kWordThreads = 512;
// the head of the dynamic shared memory: the R <= 16 CTAs' buffer pointers
// and block_sum's sums of the kWordThreads / 32 warps; the words follow
constexpr int kHeadBytes =
    16 * sizeof(uint32_t*) + (kWordThreads / 32) * sizeof(float);
static_assert(kHeadBytes % 16 == 0, "the words start 16-byte aligned");
// neighbour slots whose table entries and words a thread keeps in
// registers; the slots past it are read from memory each time
constexpr int kSlotCache = 6;

enum Mode { kPiqmc = 0, kBathSequential = 1, kBathColored = 2 };

// s of bit b of a word: bit 1 is s = -1
__device__ __forceinline__ float spin_of(uint32_t word, int b) {
  return (word >> b) & 1u ? -1.0f : 1.0f;
}

// The neighbour table of one site: the first kSlotCache slots' locations
// and couplings, and the words of one word index of those neighbours.
struct Nbrs {
  int loc[kSlotCache];
  float J[kSlotCache];
  uint32_t nw[kSlotCache];
  const int* loc_row;
  const float* J_row;
  int maxnb;
  float h;

  __device__ __forceinline__ void load(const int* __restrict__ nbr_loc,
                                       const float* __restrict__ nbr_J,
                                       const float* __restrict__ hv, int i,
                                       int mnb) {
    maxnb = mnb;
    loc_row = nbr_loc + static_cast<size_t>(i) * mnb;
    J_row = nbr_J + static_cast<size_t>(i) * mnb;
    h = __ldg(hv + i);
#pragma unroll
    for (int s = 0; s < kSlotCache; ++s) {
      if (s < maxnb) {
        loc[s] = __ldg(loc_row + s);
        J[s] = __ldg(J_row + s);
      }
    }
  }
};

// The word `w` of the slot at `loc` ((rank << 16) | slot) in the buffer at
// word offset `off` of every CTA of the cluster
__device__ __forceinline__ uint32_t word_at(uint32_t* const* peers, int off,
                                            int nr, int loc, int w) {
  return peers[loc >> 16][off + w * nr + (loc & 0xffff)];
}

// Fill nb.nw with word w of the cached neighbours
__device__ __forceinline__ void load_words(Nbrs& nb, uint32_t* const* peers,
                                           int off, int nr, int w) {
#pragma unroll
  for (int s = 0; s < kSlotCache; ++s)
    if (s < nb.maxnb) nb.nw[s] = word_at(peers, off, nr, nb.loc[s], w);
}

// sum_s J_s s_nb(bit b) in slot order from slot 0 (no h); nb.nw holds word
// `w` of the cached neighbours
__device__ __forceinline__ float slot_sum_bit(const Nbrs& nb,
                                              uint32_t* const* peers,
                                              int off, int nr, int w,
                                              int b) {
  float f = signed_by(nb.J[0], nb.nw[0], b);
#pragma unroll
  for (int s = 1; s < kSlotCache; ++s)
    if (s < nb.maxnb) f = __fadd_rn(f, signed_by(nb.J[s], nb.nw[s], b));
  for (int s = kSlotCache; s < nb.maxnb; ++s) {
    const uint32_t x = word_at(peers, off, nr, __ldg(nb.loc_row + s), w);
    f = __fadd_rn(f, signed_by(__ldg(nb.J_row + s), x, b));
  }
  return f;
}

// The local field of slice 32 w + b: the slot sum, then h
__device__ __forceinline__ float field_bit(const Nbrs& nb,
                                           uint32_t* const* peers, int off,
                                           int nr, int w, int b) {
  return __fadd_rn(slot_sum_bit(nb, peers, off, nr, w, b), nb.h);
}

// sum_p M[k, p] s_p of a line whose words sit at `line` (word q at
// line[q * nr]), p in index order from 0, M's row k at `mk` (shared
// memory); every product with a spin is a sign flip (exact). A whole word's
// 32 terms are unrolled, so each bit's sign is a shift by a constant.
__device__ __forceinline__ float bath_of_line(const float* mk,
                                              const uint32_t* line, int nr,
                                              int P) {
  float bf = 0.0f;
  const int full = P >> 5;
  for (int q = 0; q < full; ++q) {
    const uint32_t word = line[q * nr];
    const float* m = mk + 32 * q;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const float term = signed_by(m[b], word, b);
      bf = q == 0 && b == 0 ? term : __fadd_rn(bf, term);
    }
  }
  if (P & 31) {
    const uint32_t word = line[full * nr];
    const float* m = mk + 32 * full;
    for (int b = 0; b < (P & 31); ++b) {
      const float term = signed_by(m[b], word, b);
      bf = full == 0 && b == 0 ? term : __fadd_rn(bf, term);
    }
  }
  return bf;
}

template <int kMode, bool kGlobal, bool kPerChain>
__global__ void __launch_bounds__(kWordThreads, 2)
generic_words_kernel(const int* __restrict__ slot_site,
                     const int* __restrict__ slot_starts,
                     const int* __restrict__ nbr_loc,
                     const float* __restrict__ nbr_J,
                     const float* __restrict__ h,
                     const int* __restrict__ perm,
                     const float* __restrict__ b_sched,
                     const float* __restrict__ jp,
                     const float* __restrict__ bath, float teff,
                     float two_teff, const float* __restrict__ s_in,
                     float* __restrict__ s_out,
                     float* __restrict__ energies, int chains, int P, int n,
                     int maxnb, int ncolors, int m, int R, int nr, int steps,
                     uint32_t seed_term, int stride_t, int stride_c,
                     uint32_t chain0) {
  constexpr bool kBath = kMode != kPiqmc;
  extern __shared__ __align__(16) unsigned char words_smem_raw[];
  uint32_t** const peers = reinterpret_cast<uint32_t**>(words_smem_raw);
  float* const red =
      reinterpret_cast<float*>(words_smem_raw + 16 * sizeof(uint32_t*));
  uint32_t* const smem =
      reinterpret_cast<uint32_t*>(words_smem_raw + kHeadBytes);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int chain = blockIdx.x / R;
  const int W = (P + 31) >> 5;
  const int nbytes = (P + 7) >> 3;
  const int buf = W * nr;  // words of one buffer; the buffers at 0 and buf
  // with the bath, its (P, P) matrix after the buffers and the energies'
  // shares
  float* const msm = reinterpret_cast<float*>(
      smem + 2 * buf + (energies != nullptr ? P : 0));
  const int* const slots = slot_site + static_cast<size_t>(rank) * nr;
  if (kBath)
    for (int x = threadIdx.x; x < P * P; x += blockDim.x)
      msm[x] = __ldg(bath + x);
  if (static_cast<int>(threadIdx.x) < R)
    peers[threadIdx.x] = static_cast<int>(threadIdx.x) == rank
                             ? smem
                             : cluster.map_shared_rank(smem, threadIdx.x);
  // the chain's (P, n) floats; bit b of word w is slice 32 w + b < 0
  const size_t in0 = static_cast<size_t>(chain) * P * n;
  for (int l = threadIdx.x; l < nr; l += blockDim.x) {
    const int info = __ldg(slots + l);
    for (int w = 0; w < W; ++w) {
      uint32_t v = 0u;
      if (info >= 0) {
        const float* const x = s_in + in0 + (info & 0xffffff);
        const int nbits = min(32, P - 32 * w);
        for (int b = 0; b < nbits; ++b)
          v |= static_cast<uint32_t>(
                   x[static_cast<size_t>(32 * w + b) * n] < 0.0f)
               << b;
      }
      smem[w * nr + l] = v;
      smem[buf + w * nr + l] = v;
    }
  }
  cluster.sync();  // every CTA's words and `peers` are in place

  const uint32_t N = static_cast<uint32_t>(n);
  const uint32_t uchain = chain0 + static_cast<uint32_t>(chain);
  const uint32_t line_uid0 = uchain * static_cast<uint32_t>(P) * N;
  // the bits of a whole line in its last word
  const uint32_t last_mask = (P & 31) ? (1u << (P & 31)) - 1u : ~0u;
  int src = 0;
  for (int t = 0; t < steps; ++t) {
    const float bc = __fmul_rn(-2.0f, __ldg(b_sched + t));
    const float jpt =
        kPerChain ? __ldg(jp + static_cast<size_t>(t) * stride_t +
                          static_cast<size_t>(chain) * stride_c)
                  : __ldg(jp + t);
    const uint32_t ctr = counter(seed_term, t, 0);
    // dE of slice k (spin sv) of the site with neighbours nb, its field
    // from word w's bit b, the Trotter sum tr and, with the bath, the bath
    // sum of the line at `line`
    auto local_de = [&](const Nbrs& nb, int off, int w, int b, float sv,
                        float tr, int k, const uint32_t* line) {
      const float f = field_bit(nb, peers, off, nr, w, b);
      float de = __fadd_rn(__fmul_rn(__fmul_rn(bc, sv), f),
                           __fmul_rn(__fmul_rn(__fmul_rn(2.0f, sv), jpt),
                                     tr));
      if (kBath) {
        const float bf = bath_of_line(msm + k * P, line, nr, P);
        de = __fadd_rn(de, __fmul_rn(__fmul_rn(two_teff, sv), bf));
      }
      return de;
    };

    if (kMode != kBathSequential) {
      // m local phases: phase p updates slice k of a site of class c when
      // (c + k) % m == p; a thread takes one byte (8 slices) of a slot
      for (int p = 0; p < m; ++p) {
        const int dst = buf - src;
        for (int it = threadIdx.x; it < nr * nbytes; it += blockDim.x) {
          const int q = it / nr;  // the byte: a warp's threads share it
          const int l = it - q * nr;
          const int info = slots[l];
          if (info < 0) continue;
          const int i = info & 0xffffff, c = info >> 24;
          const int w = q >> 2;
          const uint32_t word = smem[src + w * nr + l];
          // the first slice >= 8q with (c + k) % m == p
          int k = 8 * q + ((p - c - 8 * q) % m + m) % m;
          const int end = min(P, 8 * q + 8);
          uint32_t flips = 0u;
          if (k < end) {
            Nbrs nb;
            nb.load(nbr_loc, nbr_J, h, i, maxnb);
            load_words(nb, peers, src, nr, w);
            const uint32_t uid_site =
                static_cast<uint32_t>(__ldg(perm + i));
            for (; k < end; k += m) {
              const int b = k & 31;
              const float sv = spin_of(word, b);
              // the Trotter ring partners k - 1 and k + 1, mod P
              const int ku = k == 0 ? P - 1 : k - 1;
              const int kd = k + 1 == P ? 0 : k + 1;
              const uint32_t wu =
                  (ku >> 5) == w ? word : smem[src + (ku >> 5) * nr + l];
              const uint32_t wdn =
                  (kd >> 5) == w ? word : smem[src + (kd >> 5) * nr + l];
              const float tr =
                  __fadd_rn(spin_of(wu, ku & 31), spin_of(wdn, kd & 31));
              const float de =
                  local_de(nb, src, w, b, sv, tr, k, smem + src + l);
              const uint32_t uid =
                  (uchain * static_cast<uint32_t>(P) +
                   static_cast<uint32_t>(k)) * N + uid_site;
              if (metropolis_accept_hashed(de, teff, uid * kGolden + ctr))
                flips |= 1u << b;
            }
          }
          reinterpret_cast<uint8_t*>(smem + dst + w * nr + l)[q & 3] =
              static_cast<uint8_t>((word ^ flips) >> ((q & 3) * 8));
        }
        cluster.sync();  // the next phase reads this one's writes
        src = dst;
      }
    } else {
      // the sequential bath: class after class, each line walking its
      // slices in order in `dst`
      for (int c = 0; c < ncolors; ++c) {
        const int dst = buf - src;
        const int lo = __ldg(slot_starts + c), hi = __ldg(slot_starts + c + 1);
        for (int l = threadIdx.x; l < nr; l += blockDim.x)
          if (l < lo || l >= hi)
            for (int w = 0; w < W; ++w)
              smem[dst + w * nr + l] = smem[src + w * nr + l];
        for (int l = lo + threadIdx.x; l < hi; l += blockDim.x) {
          const int info = slots[l];
          if (info < 0) continue;
          const int i = info & 0xffffff;
          for (int w = 0; w < W; ++w)
            smem[dst + w * nr + l] = smem[src + w * nr + l];
          Nbrs nb;
          nb.load(nbr_loc, nbr_J, h, i, maxnb);
          const uint32_t uid_site = static_cast<uint32_t>(__ldg(perm + i));
          uint32_t* const line = smem + dst + l;
          for (int k = 0; k < P; ++k) {
            const int w = k >> 5, b = k & 31;
            if (b == 0) load_words(nb, peers, src, nr, w);
            const uint32_t word = line[w * nr];
            const float sv = spin_of(word, b);
            const int ku = k == 0 ? P - 1 : k - 1;
            const int kd = k + 1 == P ? 0 : k + 1;
            const float tr = __fadd_rn(spin_of(line[(ku >> 5) * nr], ku & 31),
                                       spin_of(line[(kd >> 5) * nr], kd & 31));
            const float de = local_de(nb, src, w, b, sv, tr, k, line);
            const uint32_t uid =
                (uchain * static_cast<uint32_t>(P) +
                 static_cast<uint32_t>(k)) * N + uid_site;
            if (metropolis_accept_hashed(de, teff, uid * kGolden + ctr))
              line[w * nr] = word ^ (1u << b);
          }
        }
        cluster.sync();
        src = dst;
      }
    }

    if (kGlobal) {
      // the lines of each class in turn flip whole on sum_k (bc s_k) f_k
      const uint32_t lctr = line_counter(seed_term, t, 0);
      for (int c = 0; c < ncolors; ++c) {
        const int dst = buf - src;
        const int lo = __ldg(slot_starts + c), hi = __ldg(slot_starts + c + 1);
        for (int l = threadIdx.x; l < nr; l += blockDim.x)
          if (l < lo || l >= hi)
            for (int w = 0; w < W; ++w)
              smem[dst + w * nr + l] = smem[src + w * nr + l];
        for (int l = lo + threadIdx.x; l < hi; l += blockDim.x) {
          const int info = slots[l];
          if (info < 0) continue;
          const int i = info & 0xffffff;
          Nbrs nb;
          nb.load(nbr_loc, nbr_J, h, i, maxnb);
          float de = 0.0f;
          for (int w = 0; w < W; ++w) {
            load_words(nb, peers, src, nr, w);
            const uint32_t word = smem[src + w * nr + l];
            const int nbits = min(32, P - 32 * w);
            for (int b = 0; b < nbits; ++b) {
              const float term =
                  __fmul_rn(__fmul_rn(bc, spin_of(word, b)),
                            field_bit(nb, peers, src, nr, w, b));
              de = w == 0 && b == 0 ? term : __fadd_rn(de, term);
            }
          }
          const uint32_t uid =
              line_uid0 + static_cast<uint32_t>(__ldg(perm + i));
          const bool flip =
              metropolis_accept_hashed(de, teff, uid * kGolden + lctr);
          for (int w = 0; w < W; ++w)
            smem[dst + w * nr + l] =
                smem[src + w * nr + l] ^
                (flip ? (w + 1 == W ? last_mask : ~0u) : 0u);
        }
        cluster.sync();
        src = dst;
      }
    }

    if (energies != nullptr) {
      // this CTA's share of each slice's energy, then CTA 0 adds the
      // shares in rank order and keeps the least slice
      float* const part = reinterpret_cast<float*>(smem + 2 * buf);
      for (int k = 0; k < P; ++k) {
        const int w = k >> 5, b = k & 31;
        float acc = 0.0f;
        for (int l = threadIdx.x; l < nr; l += blockDim.x) {
          const int info = slots[l];
          if (info < 0) continue;
          Nbrs nb;
          nb.load(nbr_loc, nbr_J, h, info & 0xffffff, maxnb);
          load_words(nb, peers, src, nr, w);
          const float s = spin_of(smem[src + w * nr + l], b);
          acc += s * (0.5f * slot_sum_bit(nb, peers, src, nr, w, b) + nb.h);
        }
        const float e = block_sum(acc, red);
        if (threadIdx.x == 0) part[k] = e;
      }
      cluster.sync();  // every CTA's shares are in place
      if (rank == 0 && threadIdx.x == 0) {
        float best = 0.0f;
        for (int k = 0; k < P; ++k) {
          float e = 0.0f;
          for (int r = 0; r < R; ++r)
            e += reinterpret_cast<const float*>(peers[r] + 2 * buf)[k];
          best = k == 0 ? e : fminf(best, e);
        }
        energies[static_cast<size_t>(t) * chains + chain] = best;
      }
    }
  }

  for (int l = threadIdx.x; l < nr; l += blockDim.x) {
    const int info = slots[l];
    if (info < 0) continue;
    float* const x = s_out + in0 + (info & 0xffffff);
    for (int k = 0; k < P; ++k)
      x[static_cast<size_t>(k) * n] =
          spin_of(smem[src + (k >> 5) * nr + l], k & 31);
  }
  cluster.sync();  // no CTA leaves while another may read its words
}

// Shared memory of one CTA, all of it dynamic: the head, both buffers of
// its nr slots' W words, with energies one float a slice, and with the
// bath its (P, P) matrix (ops/generic_kernels.py::words_smem_bytes counts
// the same)
inline size_t words_smem_bytes(int P, int nr, bool energies, bool bath) {
  return kHeadBytes +
         2 * static_cast<size_t>((P + 31) / 32) * nr * sizeof(uint32_t) +
         (energies ? static_cast<size_t>(P) * sizeof(float) : 0) +
         (bath ? static_cast<size_t>(P) * P * sizeof(float) : 0);
}

// Launch `kernel` over chains clusters of R CTAs of `threads` threads
template <typename Kernel, typename... Args>
cudaError_t launch_words(Kernel kernel, int chains, int R, int threads,
                         size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config(kernel, chains * R, R, threads, smem, stream,
                                 &cfg, &attr);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The SA mode: generic SA (csrc/packed_sa.cu's cluster route) on the same
// slot layout, with chains, not slices, as the bits of a word.
//
// What it computes is packed_sa.cu's first kernel's, bitwise: step t at
// temperature T visits the classes in order, and every site i of class c
// flips chain k when dE = (-2 s) f <= 0*T or -T log1p(-u) > dE, f the slot
// products in slot order, then h, u = uniform01(counter(seed, t, 0),
// (chain0 + k) * N + perm[i]). It is generic PIQMC's local phase with the
// group as the chain and its chain bits as the slices: every bit of a word
// updates in its class's phase, there is no Trotter term, and T is the
// chain's temperature.
//
// What the design does, after kernel A (csrc/split_sa.cu) on this file's
// layout:
// - Chains as bits. A group of C <= 32 chains shares each site's word: bit
//   b is the sign of chain group * C + b (1 for -1). A thread loads a
//   site's slots (location, J) and h once a phase, reads each neighbour's
//   word once, then updates the group's chains in turn; every w * s is a
//   sign flip of w (exact), so the slot order alone fixes the sum. A
//   ragged last group updates only its own chains.
// - One group over a cluster of R CTAs, its words in both ping-pong
//   buffers of the CTAs' shared memory: phase c reads `src`, writes class
//   c's new words and copies the other slots into `dst`, then one
//   cluster.sync(); so a packing that is not proper reads a same-class
//   neighbour as it stood before the phase, as the plain version does.
// - The group's temperatures sit in shared memory (kPerChain: read from
//   temps[t * stride_t + chain * stride_c] once a step, or once a launch
//   when stride_t = 0), as in kernel A.
// - Per-step tables (the noisy anneal): step t reads nbr_J + (t / mcsteps)
//   * j_stride and h + (t / mcsteps) * h_stride. A disorder batch
//   (d_chains > 0): C divides d_chains, so a group lies in one realization
//   r = chain / d_chains, whose tables (nbr_J + r N maxnb, h + r N), hash
//   seed seeds[r] and chain index chain - r d_chains the group takes.
// - With `energies`, warp w of each CTA sums its slots' share of the
//   energies of the group's chains w, w + warps, ... (lanes in slot order,
//   then a shuffle tree), and CTA 0 adds the R shares in rank order into
//   energies[t, chain]: no atomics.
// - The kernel packs the float (chains, n) state into words as it loads it
//   and writes floats back, so the round trip costs no launch.
// At most kSaThreads threads a CTA, registers for kSaMinBlocks CTAs an SM
// (64 a thread), so 16-CTA clusters share the SMs of a GPC as kernel A's
// do; ops/generic_kernels.py::packed_sa_geometry picks C, R and the
// threads.
constexpr int kSaThreads = 256;
constexpr int kSaMinBlocks = 4;
// floats after the buffers: the group's temperatures, then, with energies,
// the CTA's share of each chain's energy
constexpr int kSaTail = 32;

template <bool kPerChain>
__global__ void __launch_bounds__(kSaThreads, kSaMinBlocks)
packed_sa_words_kernel(const int* __restrict__ slot_site,
                       const int* __restrict__ slot_starts,
                       const int* __restrict__ nbr_loc,
                       const float* __restrict__ nbr_J,
                       const float* __restrict__ h,
                       const int* __restrict__ perm,
                       const float* __restrict__ temps, const float* s_in,
                       float* s_out, float* __restrict__ energies,
                       int chains, int C, int n, int maxnb, int ncolors,
                       int R, int nr, int steps, uint32_t seed_term,
                       uint32_t step_term, int j_stride, int h_stride,
                       int mcsteps, int stride_t, int stride_c,
                       uint32_t chain0, int d_chains,
                       const int* __restrict__ seeds) {
  extern __shared__ __align__(16) unsigned char words_smem_raw[];
  uint32_t** const peers = reinterpret_cast<uint32_t**>(words_smem_raw);
  uint32_t* const smem =
      reinterpret_cast<uint32_t*>(words_smem_raw + kHeadBytes);
  float* const tg = reinterpret_cast<float*>(smem + 2 * nr);
  float* const part = tg + kSaTail;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int g0 = static_cast<int>(blockIdx.x) / R * C;  // first chain
  const int cv = min(C, chains - g0);  // chains of this group
  // a disorder batch: the group's realization, its tables and seed, and
  // its first chain's index inside the realization
  int rc0 = g0;
  if (d_chains) {
    const int r = g0 / d_chains;
    rc0 = g0 - r * d_chains;
    nbr_J += static_cast<size_t>(r) * n * maxnb;
    h += static_cast<size_t>(r) * n;
    seed_term =
        static_cast<uint32_t>(__ldg(seeds + r)) * kSeedMult + step_term;
  }
  const int* const slots = slot_site + static_cast<size_t>(rank) * nr;
  if (static_cast<int>(threadIdx.x) < R)
    peers[threadIdx.x] = static_cast<int>(threadIdx.x) == rank
                             ? smem
                             : cluster.map_shared_rank(smem, threadIdx.x);
  // the group's (cv, n) floats; bit b of a word is chain g0 + b < 0
  const size_t in0 = static_cast<size_t>(g0) * n;
  for (int l = threadIdx.x; l < nr; l += blockDim.x) {
    const int info = __ldg(slots + l);
    uint32_t v = 0u;
    if (info >= 0) {
      const float* const x = s_in + in0 + (info & 0xffffff);
      for (int b = 0; b < cv; ++b)
        v |= static_cast<uint32_t>(x[static_cast<size_t>(b) * n] < 0.0f)
             << b;
    }
    smem[l] = v;
    smem[nr + l] = v;
  }
  const float* const tcol = temps + static_cast<size_t>(g0) * stride_c;
  if (kPerChain && static_cast<int>(threadIdx.x) < cv)
    tg[threadIdx.x] = __ldg(tcol + threadIdx.x * stride_c);
  cluster.sync();  // every CTA's words and `peers` are in place

  const uint32_t N = static_cast<uint32_t>(n);
  // uid = (chain0 + chain) N + perm[i]: the hash input uid * kGolden + ctr
  // steps by N * kGolden from chain to chain
  const uint32_t chain_step = N * kGolden;
  const uint32_t uid_group = (chain0 + static_cast<uint32_t>(rc0)) * N;
  int src = 0;
  for (int t = 0; t < steps; ++t) {
    if (kPerChain && t > 0 && stride_t != 0) {
      // the last step ended at a cluster barrier: no thread still reads
      if (static_cast<int>(threadIdx.x) < cv)
        tg[threadIdx.x] = __ldg(tcol + static_cast<size_t>(t) * stride_t +
                                threadIdx.x * stride_c);
      __syncthreads();
    }
    const float temp = kPerChain ? 0.0f : __ldg(temps + t);
    const uint32_t ctr = counter(seed_term, t, 0);
    const size_t row = static_cast<size_t>(t / mcsteps);
    const float* const jt = nbr_J + row * j_stride;
    const float* const ht = h + row * h_stride;
    for (int c = 0; c < ncolors; ++c) {
      const int dst = nr - src;
      const int lo = __ldg(slot_starts + c), hi = __ldg(slot_starts + c + 1);
      for (int l = threadIdx.x; l < nr; l += blockDim.x)
        if (l < lo || l >= hi) smem[dst + l] = smem[src + l];
      for (int l = lo + threadIdx.x; l < hi; l += blockDim.x) {
        const int info = __ldg(slots + l);
        if (info < 0) continue;
        const int i = info & 0xffffff;
        Nbrs nb;
        nb.load(nbr_loc, jt, ht, i, maxnb);
        load_words(nb, peers, src, nr, 0);
        const uint32_t word = smem[src + l];
        uint32_t x =
            (uid_group + static_cast<uint32_t>(__ldg(perm + i))) * kGolden +
            ctr;
        uint32_t flips = 0u;
        for (int b = 0; b < cv; ++b, x += chain_step) {
          // the threshold -T log1p(-u) first: it needs no neighbour, so
          // its hash and logarithm run while the words are in flight
          // (metropolis_accept_hashed's decision, term by term)
          const float tb = kPerChain ? tg[b] : temp;
          const float th = __fmul_rn(-tb, log1pf(-uniform24(mix32(x))));
          const float f = field_bit(nb, peers, src, nr, 0, b);
          const float de = __fmul_rn(__fmul_rn(-2.0f, spin_of(word, b)), f);
          if ((de <= 0.0f * tb) | (th > de)) flips |= 1u << b;
        }
        smem[dst + l] = word ^ flips;
      }
      cluster.sync();  // the next phase reads this one's writes
      src = dst;
    }

    if (energies != nullptr) {
      const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
      for (int b = threadIdx.x >> 5; b < cv; b += warps) {
        float acc = 0.0f;
        for (int l = lane; l < nr; l += 32) {
          const int info = __ldg(slots + l);
          if (info < 0) continue;
          Nbrs nb;
          nb.load(nbr_loc, jt, ht, info & 0xffffff, maxnb);
          load_words(nb, peers, src, nr, 0);
          acc += spin_of(smem[src + l], b) *
                 (0.5f * slot_sum_bit(nb, peers, src, nr, 0, b) + nb.h);
        }
        for (int off = 16; off > 0; off >>= 1)
          acc += __shfl_down_sync(0xffffffffu, acc, off);
        if (lane == 0) part[b] = acc;
      }
      cluster.sync();  // every CTA's shares are in place
      if (rank == 0 && static_cast<int>(threadIdx.x) < cv) {
        float e = 0.0f;
        for (int r = 0; r < R; ++r)
          e += reinterpret_cast<const float*>(peers[r] + 2 * nr +
                                              kSaTail)[threadIdx.x];
        energies[static_cast<size_t>(t) * chains + g0 + threadIdx.x] = e;
      }
    }
  }

  for (int l = threadIdx.x; l < nr; l += blockDim.x) {
    const int info = __ldg(slots + l);
    if (info < 0) continue;
    const uint32_t w = smem[src + l];
    float* const x = s_out + in0 + (info & 0xffffff);
    for (int b = 0; b < cv; ++b) x[static_cast<size_t>(b) * n] = spin_of(w, b);
  }
  cluster.sync();  // no CTA leaves while another may read its words
}

// Shared memory of one SA-mode CTA, all of it dynamic: the head, both
// buffers of its nr slots' words, the group's temperatures and, with
// energies, its shares (ops/generic_kernels.py::sa_words_smem_bytes)
inline size_t sa_words_smem_bytes(int nr, bool energies) {
  return kHeadBytes + 2 * static_cast<size_t>(nr) * sizeof(uint32_t) +
         (energies ? 2 : 1) * kSaTail * sizeof(float);
}

}  // namespace gw
}  // namespace mcs
