// Kernel 5: dissipative PIQMC on the split checkerboard, any P >= 2, with
// optional whole-line moves.
//
// Replaces montecarlosolvers_tpu/ops/pallas_split.py::_qmc_bath_split_kernel
// (:696), launched there by _run_qmc_bath_split (:814) under
// anneal_lattice_qmc_bath_split (:857). Plain PyTorch version:
// ops/split_kernels.py::qmc_bath_split_anneal_ref.
//
// What it computes. The Trotter state of a chain is its per-slice halves
// a, b, each (P, Nh): a spin line lives in one half (ops/split.py:485-492).
// Per schedule step, slices k = 0..P-1 in order: half A of slice k updates,
// then half B of slice k against the new A (pallas_split.py:746-778), with
//   dE = -2B s f + 2 s J_perp (s_up + s_dn) + 2 T_eff s bath,
//   bath = sum_p M[k, p] s_p   (p = 0..P-1 in index order, M[k, k] = 0),
// the Trotter ring up = (k+P-1) mod P, dn = (k+1) mod P, and the uniforms at
// counter(seed, step, 2k + half), uid = chain*2Nh + half*Nh + site. With
// global moves, whole lines of half A and then of half B (against the
// flipped A) flip with dE = -2B sum_p s_p (f_p + h), at counter index
// 2P + half (:782-803); J_perp and the bath cancel for a whole-line flip.
//
// What bounds it on an H100. The work of a sweep at the main path's 80x80,
// P = 40, 32 chains is 8.19 M site updates; the bath sum is P - 1 dependent
// adds in index order, which no reordering may shorten (the plain version's
// rounding fixes the order), and a line's P updates are serial (each reads
// the line the one before left). As compiled (sm_90a SASS at P = 40,
// tools/sass_counts.py), the slice loop is 250 instructions an update: the
// bath about 130 (one LDS.128 of M[k, p..p+3] per four terms; per term an
// IMAD.SHL of the line word, a LOP3 sign flip of M and an FADD), the
// stencil from the neighbour words 21, the counter hash 19 integer
// operations, log1pf about 30, the spin, Trotter and dE terms, the line's
// loads and store and the loop the rest. At one instruction per scheduler
// and cycle on 132 SMs that is 69 us per sweep; measured 0.142 ms (H100
// 80GB HBM3, 700 W, PERF.md), about twice that: about 7 warps a scheduler,
// each on its site's serial chain of slices, do not keep the issue full
// (inferred; no profiler of the card's stalls runs there). The float32
// bound is 7.1 us.
//
// What the design does about that.
// - The state as bits. Bit p of word p/32 of site j is the sign of s_p (1
//   for -1), in planes [word][site], so a chain is 2*ceil(P/32)*Nh words.
//   Each thread owns fixed sites of both halves for the whole anneal, so
//   the Trotter and bath terms of a site read only its own line, which only
//   its owner writes, and only the spatial stencil crosses threads.
// - Two phases a step. Half A of slice k reads B at slice k, which the
//   plain order updates only after A(k); B(k) reads A at slice k, which no
//   later update of the step changes. So a thread runs all P slices of its
//   A sites, then, after one barrier, all P slices of its B sites, and every
//   update reads what the plain version's order gives it: 2 barriers a step
//   (4 with global moves) instead of 2P + 2. The other half does not change
//   within a phase, so a site's weights are read once a phase and its
//   neighbour words once per 32 slices.
// - One chain over a cluster. The R CTAs of a cluster each hold a band of
//   rows of both halves' bit planes, beside the (P, P) bath matrix
//   (csrc/cluster.cuh); a stencil read across a band edge, and the torus
//   wrap, go to the owning CTA through distributed shared memory, and
//   cluster.sync() separates the phases. The wrapper
//   (ops/split_kernels.py::qmc_bath_geometry) takes the largest R whose
//   band fits a CTA's 227 KB and whose clusters the card holds at once
//   (cudaOccupancyMaxActiveClusters): at the main path's 32 chains R = 16,
//   512 CTAs of 224 threads, up to 5 an SM, where one block per chain used
//   32 SMs; every even L up to 256 runs at every P <= 128.
// - P at compile time. The entry point switches to an instantiation with P
//   a constant for every P from 2 to 64 (a runtime-P instantiation of the
//   same kernel takes larger P): the bath loop unrolls, the line words sit
//   in registers and M is read four terms a load, instead of a loop of
//   about 9 instructions a term.
// - The uniform source is a template argument (csrc/hw_rng.cuh): the
//   counter hash, or with hw_rng the thread's own generator stream, which
//   draws a site's slices in slice order, then its line moves. The hash
//   instantiations are the kernel as it was; the generator's take P at
//   compile time only at the bench's P = 40 (kHwStaticP), so the build
//   adds two instantiations, not 65.
// - The bath field is recomputed in index order at every update, never
//   carried as a running sum updated on flips, which would round
//   differently; M[k, p] * s_p is exact, so the sign flip is bitwise the
//   product the plain version rounds.
// - A chain no cluster holds (qmc_bath_geometry returns None: even L from
//   402 at P = 128, from 674 at P = 40) runs on the per-phase kernels below
//   (split_qmc_bath_phased_anneal): the halves as floats in device memory,
//   updated in place; per half-phase one thread owns a (chain, site) line
//   and walks its P slices in the plain version's order, and the line
//   moves of each half are a phase of their own; chains along gridDim.x.
//
// Trouble spots, each handled where it bites below: the FMA contraction of
// dE (B*s*f rounds when B != 1, 2*T_eff*s*bath always rounds), the phase
// order (B reads the new A; line B reads A after line A's flips), the ring
// at P = 2 (up == dn), and the uid, which is the same for every slice of a
// half: only the counter index 2k + half differs.
//
// The colored template (kColored, even P): the approximate space-time
// colored sweep of bath_update="colored" on the quarter layout, JAX
// ops/split.py::qmc_bath_split_colored_sweep (:578) with the line moves of
// qmc_split_global (:413); plain PyTorch version:
// ops/split_kernels.py::qmc_bath_split_colored_anneal_ref. A step is four
// quarter phases, xe (half A, even slices), xo (B, odd), ye (B, even), yo
// (A, odd), in that order, each against the other half as it stands and
// with the bath of its line taken before the phase,
//   bath = sum over even p of M[k, p] s_p, then over odd p, then the two
//   added (two (Q, Q) blocks, each in index order),
// the uniforms keyed as kernel B keys its quarters (csrc/split_qmc.cu:
// counter(seed, step, phase), uid = chain*4QNh + phase*QNh + (k/2)*Nh +
// site) and the line moves as kernel B's (even slices summed, then odd,
// counter index 4 + half, the SA uids). Slices k and k + 2 of one line are
// in one phase and read each other through M, so a thread takes its
// line's words at the phase's start and updates a copy: 4 cluster barriers
// a step, 6 with global moves. The per-phase kernels of this template
// (bath_colored_local_kernel) write each phase out of place, the line's
// old state in one buffer and its new in another. The work and its bound
// are the sequential sweep's; measured 0.161 ms a sweep at the main path's
// shape, 1.14x the sequential kernel (H100 80GB HBM3, 700 W, PERF.md),
// with 36 bytes spilled at P = 40 against 28.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <utility>

#include "cluster.cuh"
#include "counter_hash.cuh"
#include "energy.cuh"
#include "hw_rng.cuh"

namespace {

namespace cg = cooperative_groups;

// At most 256 threads a CTA and registers for 5 such CTAs an SM (<= 51 a
// thread): then 5 CTAs of a 16-CTA cluster share each SM of a GPC, and the
// card holds 35 such clusters at once, more than the main path's 32
// chains (ops/split_kernels.py::MAX_THREADS is the same number).
constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 5;
constexpr int kMaxStaticP = 64;

// s_p of a line word, bit p & 31: bit 1 is s = -1
__device__ __forceinline__ float spin_of(uint32_t word, int p) {
  return ((word >> (p & 31)) & 1u) ? -1.0f : 1.0f;
}

// sum_p M[k, p] s_p in index order from p = 0, the line's word w at
// line[w * S]; kP > 0 is P at compile time, kP = 0 reads P at run time
template <int kP>
__device__ __forceinline__ float bath_field(const float* mk,
                                            const uint32_t* line, int S,
                                            int P) {
  if constexpr (kP > 0) {
    constexpr int kWords = (kP + 31) / 32;
    uint32_t lw[kWords];
#pragma unroll
    for (int wd = 0; wd < kWords; ++wd) lw[wd] = line[wd * S];
    float bf = mcs::signed_by(mk[0], lw[0], 0);
#pragma unroll
    for (int p = 1; p < kP; ++p)
      bf = __fadd_rn(bf, mcs::signed_by(mk[p], lw[p >> 5], p & 31));
    return bf;
  } else {
    uint32_t word = line[0];
    float bf = mcs::signed_by(mk[0], word, 0);
    for (int p = 1; p < P; ++p) {
      if ((p & 31) == 0) word = line[(p >> 5) * S];
      bf = __fadd_rn(bf, mcs::signed_by(mk[p], word, p & 31));
    }
    return bf;
  }
}

// The colored sweep's bath of slice k from the line's words lw (word wd at
// lw[wd]): sum over even p of M[k, p] s_p in index order, the same over odd
// p, then the two added, as the quarter layout's two (Q, Q) blocks add;
// P even. kP > 0 is P at compile time, kP = 0 reads P at run time.
template <int kP>
__device__ __forceinline__ float bath_field_colored(const float* mk,
                                                    const uint32_t* lw,
                                                    int P) {
  float be = mcs::signed_by(mk[0], lw[0], 0);
  float bo = mcs::signed_by(mk[1], lw[0], 1);
  const int n = kP > 0 ? kP : P;
#pragma unroll
  for (int p = 2; p < n; p += 2) {
    be = __fadd_rn(be, mcs::signed_by(mk[p], lw[p >> 5], p & 31));
    bo = __fadd_rn(bo, mcs::signed_by(mk[p + 1], lw[(p + 1) >> 5],
                                      (p + 1) & 31));
  }
  return __fadd_rn(be, bo);
}

// Words of a line the runtime-P colored kernel copies: a cluster holds the
// (P, P) bath matrix in 227 KB only while P <= 238, 8 words.
constexpr int kMaxRuntimeWords = 8;

// kHw: uniforms from the thread's stream (hw_rng.cuh), not the counter hash;
// kColored: the colored sweep on the quarters (see the header), even P
template <int kP, bool kHw, bool kColored>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
split_qmc_bath_kernel(const float* __restrict__ w,
                      const float* __restrict__ h,
                      const float* __restrict__ b_sched,
                      const float* __restrict__ jp,
                      const float* __restrict__ bath, float teff,
                      float two_teff, const float* __restrict__ a_in,
                      const float* __restrict__ b_in,
                      float* __restrict__ a_out, float* __restrict__ b_out,
                      int P_run, int R, int L, int nslots, int steps,
                      uint32_t seed_term, int global_moves) {
  extern __shared__ uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int P = kP > 0 ? kP : P_run;
  const int words = (P + 31) / 32;
  const int K = L / 2;
  const int nh = L * K;
  const int S = mcs::band_stride(L, R, L / 2);
  // word wd of half A at wd*S, of half B at (words + wd)*S, then M
  const int half_b = words * S;
  float* const m = reinterpret_cast<float*>(smem + 2 * half_b);
  const int chain = blockIdx.x / R;
  const mcs::Band band =
      mcs::make_band(cluster, smem, blockIdx.x % R, R, L, L / 2);
  const size_t base = static_cast<size_t>(chain) * P * nh + band.lo;

  for (int i = threadIdx.x; i < P * P; i += blockDim.x) m[i] = bath[i];
  for (int il = threadIdx.x; il < band.nb; il += blockDim.x) {
    for (int wd = 0; wd < words; ++wd) {
      uint32_t wa = 0, wb = 0;
      for (int p = wd * 32; p < P && p < wd * 32 + 32; ++p) {
        const size_t at = base + static_cast<size_t>(p) * nh + il;
        wa |= static_cast<uint32_t>(a_in[at] < 0.0f) << (p & 31);
        wb |= static_cast<uint32_t>(b_in[at] < 0.0f) << (p & 31);
      }
      smem[wd * S + il] = wa;
      smem[half_b + wd * S + il] = wb;
    }
  }
  cluster.sync();  // every band is loaded before any is read

  // uid = chain*2Nh + half*Nh + site, wrapping as the int32 JAX code does
  const uint32_t uid0 =
      static_cast<uint32_t>(chain) * (2u * static_cast<uint32_t>(nh));
  // the bits of a whole line in word wd (the last word may be partial)
  const uint32_t last_mask = (P & 31) ? (1u << (P & 31)) - 1u : ~0u;
  // with kHw, a site's slices draw in slice order from the thread's stream,
  // then its line moves
  mcs::Uniforms<kHw> rng(seed_term, mcs::thread_stream());
  for (int t = 0; t < steps; ++t) {
    const float bc = -2.0f * b_sched[t];
    const float jpt = jp[t];
    // One Metropolis update of `half` at slice k for band site il; the
    // counter is 2k + half, the bath and Trotter terms read the state as
    // it stands
    auto update = [&](int half, int k, int il, const float (&wv)[7],
                      float hj, const uint32_t (&o)[7]) {
      const int up = k == 0 ? P - 1 : k - 1;
      const int dn = k + 1 == P ? 0 : k + 1;
      const int kw = (k >> 5) * S, kb = k & 31;
      const int own = half ? half_b : 0;
      const int j = band.lo + il;
      const uint32_t* line = smem + own + il;
      const uint32_t wk = line[kw];
      const float sv = spin_of(wk, kb);
      const float f =
          __fadd_rn(mcs::field_of_bit(wv, o, nslots, kb), hj);
      const float tr = __fadd_rn(spin_of(line[(up >> 5) * S], up),
                                 spin_of(line[(dn >> 5) * S], dn));
      // the bath field of the line; each M*s is exact, the adds round as
      // the plain version's do
      const float bf = bath_field<kP>(m + k * P, line, S, P);
      // dE = (bc*s)*f + ((2*s)*jp)*tr + (2teff*s)*bath, left to right: the
      // products with +/-1 and tr are exact, (bc*s)*f and (2teff*s)*bath
      // round, so no FMA may fuse them into the adds
      const float de = __fadd_rn(
          __fadd_rn(__fmul_rn(bc * sv, f),
                    __fmul_rn(__fmul_rn(2.0f * sv, jpt), tr)),
          __fmul_rn(two_teff * sv, bf));
      const uint32_t x =
          (uid0 + static_cast<uint32_t>(half * nh + j)) * mcs::kGolden +
          mcs::counter(seed_term, t, 2 * k + half);
      if (rng.accept(de, teff, x)) smem[own + kw + il] = wk ^ (1u << kb);
    };
    if constexpr (kColored) {
      // the quarter phases xe, xo, ye, yo: half A, B, B, A at slices of
      // parity 0, 1, 0, 1. A phase writes slices of its parity of its own
      // half's lines and reads the other half at those slices, which no
      // update of the phase writes, and its own line as the phase found
      // it (lw), so a thread's copy is all it needs
      constexpr int kLW = kP > 0 ? (kP + 31) / 32 : kMaxRuntimeWords;
      const uint32_t Q = static_cast<uint32_t>(P / 2);
      const uint32_t qnh = Q * static_cast<uint32_t>(nh);
      for (int phase = 0; phase < 4; ++phase) {
        const int half = phase == 1 || phase == 2;
        const int par = phase & 1;
        const int own = half ? half_b : 0;
        const int other = half ? 0 : half_b;
        const uint32_t ctr = mcs::counter(seed_term, t, phase);
        const uint32_t quid0 = static_cast<uint32_t>(chain) * (4u * qnh) +
                               static_cast<uint32_t>(phase) * qnh;
        for (int il = threadIdx.x; il < band.nb; il += blockDim.x) {
          const int j = band.lo + il;
          float wv[7];
          mcs::load_weights(w, half, nh, nslots, j, wv);
          const float hj = __ldg(h + half * nh + j);
          uint32_t lw[kLW], nw[kLW];
#pragma unroll
          for (int wd = 0; wd < kLW; ++wd)
            nw[wd] = lw[wd] = wd < words ? smem[own + wd * S + il] : 0u;
          for (int wd = 0; wd < words; ++wd) {
            uint32_t o[7];
            mcs::load_neighbours(band, other + wd * S, il, K, nslots, o);
            const int end = min(P, 32 * wd + 32);
            for (int k = 32 * wd + par; k < end; k += 2) {
              const int up = k == 0 ? P - 1 : k - 1;
              const int dn = k + 1 == P ? 0 : k + 1;
              const float sv = spin_of(lw[k >> 5], k);
              const float f =
                  __fadd_rn(mcs::field_of_bit(wv, o, nslots, k & 31), hj);
              const float tr = __fadd_rn(spin_of(lw[dn >> 5], dn),
                                         spin_of(lw[up >> 5], up));
              const float bf = bath_field_colored<kP>(m + k * P, lw, P);
              const float de = __fadd_rn(
                  __fadd_rn(__fmul_rn(bc * sv, f),
                            __fmul_rn(__fmul_rn(2.0f * sv, jpt), tr)),
                  __fmul_rn(two_teff * sv, bf));
              const uint32_t x =
                  (quid0 + static_cast<uint32_t>(k >> 1) *
                               static_cast<uint32_t>(nh) +
                   static_cast<uint32_t>(j)) * mcs::kGolden + ctr;
              if (rng.accept(de, teff, x)) nw[k >> 5] ^= 1u << (k & 31);
            }
          }
#pragma unroll
          for (int wd = 0; wd < kLW; ++wd)
            if (wd < words) smem[own + wd * S + il] = nw[wd];
        }
        cluster.sync();
      }
    } else {
    // All slices of half A, then all slices of half B, one barrier between:
    // A of slice k reads B at slice k, which the plain order updates only
    // after it, so every A update of a step reads B as the step found it;
    // B of slice k reads A at slice k, which no later update of the step
    // changes. What else an update reads is its own line, which only its
    // thread writes, in slice order. So each update reads the state the
    // plain version's order gives it, with 2 barriers per step, not 2P.
    // The other half does not change within a phase, so a site's weights
    // and neighbour words are read once for every 32 slices.
    for (int half = 0; half < 2; ++half) {
      const int other = half ? 0 : half_b;
      for (int il = threadIdx.x; il < band.nb; il += blockDim.x) {
        float wv[7];
        mcs::load_weights(w, half, nh, nslots, band.lo + il, wv);
        const float hj = __ldg(h + half * nh + band.lo + il);
        for (int wd = 0; wd < words; ++wd) {
          uint32_t o[7];
          mcs::load_neighbours(band, other + wd * S, il, K, nslots, o);
          const int end = min(P, 32 * wd + 32);
          for (int k = 32 * wd; k < end; ++k)
            update(half, k, il, wv, hj, o);
        }
      }
      cluster.sync();
    }
    }
    if (global_moves) {
      // lines of half A against B, then lines of half B against the
      // flipped A; dE = bc * sum_p s_p (f_p + h), p in index order (the
      // colored template: even p, then odd p, then the two added, at
      // kernel B's counter index 4 + half)
      for (int half = 0; half < 2; ++half) {
        const int own = half ? half_b : 0;
        const int other = half ? 0 : half_b;
        const uint32_t ctr = mcs::counter(
            seed_term, t, kColored ? 4 + half : 2 * P + half);
        for (int il = threadIdx.x; il < band.nb; il += blockDim.x) {
          const int j = band.lo + il;
          const float hj = __ldg(h + half * nh + j);
          float wv[7];
          mcs::load_weights(w, half, nh, nslots, j, wv);
          float sum = 0.0f, odd = 0.0f;
#pragma unroll 1
          for (int wd = 0; wd < words; ++wd) {
            uint32_t o[7];
            mcs::load_neighbours(band, other + wd * S, il, K, nslots, o);
            const uint32_t lw = smem[own + wd * S + il];
            const int nbits = min(32, P - wd * 32);
#pragma unroll 1
            for (int bit = 0; bit < nbits; ++bit) {
              const float x = mcs::signed_by(
                  __fadd_rn(mcs::field_of_bit(wv, o, nslots, bit), hj), lw,
                  bit);
              if (kColored && (bit & 1))
                odd = wd == 0 && bit == 1 ? x : __fadd_rn(odd, x);
              else
                sum = wd == 0 && bit == 0 ? x : __fadd_rn(sum, x);
            }
          }
          if (kColored) sum = __fadd_rn(sum, odd);
          const float de = __fmul_rn(bc, sum);
          const uint32_t x =
              (uid0 + static_cast<uint32_t>(half * nh + j)) * mcs::kGolden +
              ctr;
          if (rng.accept(de, teff, x)) {
            for (int wd = 0; wd < words; ++wd)
              smem[own + wd * S + il] ^= wd + 1 == words ? last_mask : ~0u;
          }
        }
        cluster.sync();  // line B reads the flipped A; slice 0 reads B
      }
    }
  }

  for (int il = threadIdx.x; il < band.nb; il += blockDim.x) {
    for (int p = 0; p < P; ++p) {
      const size_t at = base + static_cast<size_t>(p) * nh + il;
      const int wd = (p >> 5) * S + il;
      a_out[at] = spin_of(smem[wd], p);
      b_out[at] = spin_of(smem[half_b + wd], p);
    }
  }
}

using KernelFn = void (*)(const float*, const float*, const float*,
                          const float*, const float*, float, float,
                          const float*, const float*, float*, float*, int,
                          int, int, int, int, uint32_t, int);

template <int... Ps>
auto kernel_table(std::integer_sequence<int, Ps...>) {
  // P < 2 is refused by the wrapper; those entries take the runtime kernel
  return std::array<KernelFn, sizeof...(Ps)>{
      &split_qmc_bath_kernel<(Ps < 2 ? 0 : Ps), false, false>...};
}

template <int... Ps>
auto colored_table(std::integer_sequence<int, Ps...>) {
  // the colored sweep takes even P only; odd entries are never launched
  // and share the runtime kernel
  return std::array<KernelFn, sizeof...(Ps)>{
      &split_qmc_bath_kernel<(Ps < 2 || Ps % 2 ? 0 : Ps), false, true>...};
}

// The P the generator's instantiations take at compile time: the bench's
// (bench/throughput.py, pallas_bath); any other P takes the runtime-P one,
// so that the build keeps 66 instantiations, not 130 (99 with the colored
// template's even P)
constexpr int kHwStaticP = 40;

KernelFn kernel_for(int P, int hw_rng, int colored = 0) {
  if (colored) {
    static const auto table =
        colored_table(std::make_integer_sequence<int, kMaxStaticP + 1>{});
    return P <= kMaxStaticP ? table[P]
                            : &split_qmc_bath_kernel<0, false, true>;
  }
  if (hw_rng)
    return P == kHwStaticP ? &split_qmc_bath_kernel<kHwStaticP, true, false>
                           : &split_qmc_bath_kernel<0, true, false>;
  static const auto table =
      kernel_table(std::make_integer_sequence<int, kMaxStaticP + 1>{});
  return P <= kMaxStaticP ? table[P]
                          : &split_qmc_bath_kernel<0, false, false>;
}

// Shared memory one CTA takes: its band of both halves' bit planes and the
// bath matrix (ops/split_kernels.py::qmc_bath_smem_bytes counts the same).
size_t smem_bytes(int P, int L, int R) {
  const size_t words = (P + 31) / 32;
  return (2 * words * mcs::band_stride(L, R, L / 2) +
          static_cast<size_t>(P) * P) *
         sizeof(uint32_t);
}

// ---- the per-phase kernels, for chains no cluster holds

constexpr int kThreads = 256;

// Local half-phase of step t: one thread per site j of half `half` (lines
// s, (chains, P, nh) +/-1 floats) of chain blockIdx.x / xblocks, walking
// slices k = 0..P-1 in order against the other half o at slice k, as the
// cluster kernel's phase; only the thread's own line is written. With kHw
// slice k takes draw k of the thread's stream of this launch, number
// `launch`.
template <bool kHw>
__global__ void __launch_bounds__(kThreads)
bath_local_kernel(const float* __restrict__ w, const float* __restrict__ h,
                  const float* __restrict__ b_sched,
                  const float* __restrict__ jp,
                  const float* __restrict__ bath, float teff, float two_teff,
                  float* s, const float* __restrict__ o, int half, int P,
                  int nh, int K, int nslots, int xblocks, int t,
                  uint32_t seed_term, uint32_t launch) {
  const int chain = blockIdx.x / xblocks;
  const int j = (blockIdx.x - chain * xblocks) * blockDim.x + threadIdx.x;
  if (j >= nh) return;
  const size_t base = static_cast<size_t>(chain) * P * nh;
  float* const line = s + base + j;  // slice p at line[p * nh]
  const float bc = -2.0f * b_sched[t];
  const float jpt = jp[t];
  const float hj = __ldg(h + half * nh + j);
  const uint32_t x0 =
      (static_cast<uint32_t>(chain) * (2u * static_cast<uint32_t>(nh)) +
       static_cast<uint32_t>(half * nh + j)) *
      mcs::kGolden;
  mcs::Uniforms<kHw> rng(seed_term, mcs::phase_stream(launch));
  for (int k = 0; k < P; ++k) {
    const int up = k == 0 ? P - 1 : k - 1;
    const int dn = k + 1 == P ? 0 : k + 1;
    const size_t row = static_cast<size_t>(k) * nh;
    const float sv = line[row];
    const float f = __fadd_rn(
        mcs::half_field(o + base + row, w, half, nh, K, nslots, j), hj);
    const float tr = __fadd_rn(line[static_cast<size_t>(up) * nh],
                               line[static_cast<size_t>(dn) * nh]);
    // the bath field sum_p M[k, p] s_p in index order from p = 0; each
    // product with a spin is exact
    const float* mk = bath + static_cast<size_t>(k) * P;
    float bf = __fmul_rn(__ldg(mk), line[0]);
    for (int p = 1; p < P; ++p)
      bf = __fadd_rn(bf, __fmul_rn(__ldg(mk + p),
                                   line[static_cast<size_t>(p) * nh]));
    const float de = __fadd_rn(
        __fadd_rn(__fmul_rn(bc * sv, f),
                  __fmul_rn(__fmul_rn(2.0f * sv, jpt), tr)),
        __fmul_rn(two_teff * sv, bf));
    const uint32_t ctr = mcs::counter(seed_term, t, 2 * k + half);
    if (rng.accept(de, teff, x0 + ctr)) line[row] = -sv;
  }
}

// The colored template's quarter phase `phase` (0..3: xe, xo, ye, yo) of
// step t on half `half` at the slices of parity `par`: one thread per site
// j of the half of chain blockIdx.x / xblocks reads its line from `src` as
// the phase found it and writes the whole line, its updated slices and the
// others, to `dst` (out of place: slices k and k + 2 read each other
// through M), against the other half o at each slice; counter and uids as
// the cluster kernel's colored phases.
__global__ void __launch_bounds__(kThreads)
bath_colored_local_kernel(const float* __restrict__ w,
                          const float* __restrict__ h,
                          const float* __restrict__ b_sched,
                          const float* __restrict__ jp,
                          const float* __restrict__ bath, float teff,
                          float two_teff, const float* __restrict__ src,
                          float* __restrict__ dst,
                          const float* __restrict__ o, int half, int par,
                          int phase, int P, int nh, int K, int nslots,
                          int xblocks, int t, uint32_t seed_term) {
  const int chain = blockIdx.x / xblocks;
  const int j = (blockIdx.x - chain * xblocks) * blockDim.x + threadIdx.x;
  if (j >= nh) return;
  const size_t base = static_cast<size_t>(chain) * P * nh;
  const float* const line = src + base + j;  // slice p at line[p * nh]
  float* const out = dst + base + j;
  const float bc = -2.0f * b_sched[t];
  const float jpt = jp[t];
  const float hj = __ldg(h + half * nh + j);
  const uint32_t qnh = static_cast<uint32_t>(P / 2) *
                       static_cast<uint32_t>(nh);
  const uint32_t x0 = static_cast<uint32_t>(chain) * (4u * qnh) +
                      static_cast<uint32_t>(phase) * qnh +
                      static_cast<uint32_t>(j);
  const uint32_t ctr = mcs::counter(seed_term, t, phase);
  for (int k = 0; k < P; ++k) {
    const size_t row = static_cast<size_t>(k) * nh;
    const float sv = line[row];
    if ((k & 1) != par) {
      out[row] = sv;
      continue;
    }
    const int up = k == 0 ? P - 1 : k - 1;
    const int dn = k + 1 == P ? 0 : k + 1;
    const float f = __fadd_rn(
        mcs::half_field(o + base + row, w, half, nh, K, nslots, j), hj);
    const float tr = __fadd_rn(line[static_cast<size_t>(dn) * nh],
                               line[static_cast<size_t>(up) * nh]);
    // the even slices' bath, then the odd slices', then the two added
    const float* mk = bath + static_cast<size_t>(k) * P;
    float be = __fmul_rn(__ldg(mk), line[0]);
    float bo = __fmul_rn(__ldg(mk + 1), line[nh]);
    for (int p = 2; p < P; p += 2) {
      be = __fadd_rn(be, __fmul_rn(__ldg(mk + p),
                                   line[static_cast<size_t>(p) * nh]));
      bo = __fadd_rn(bo, __fmul_rn(__ldg(mk + p + 1),
                                   line[static_cast<size_t>(p + 1) * nh]));
    }
    const float de = __fadd_rn(
        __fadd_rn(__fmul_rn(bc * sv, f),
                  __fmul_rn(__fmul_rn(2.0f * sv, jpt), tr)),
        __fmul_rn(two_teff * sv, __fadd_rn(be, bo)));
    const uint32_t x =
        (x0 + static_cast<uint32_t>(k >> 1) * static_cast<uint32_t>(nh)) *
            mcs::kGolden + ctr;
    out[row] = mcs::metropolis_accept_hashed(de, teff, x) ? -sv : sv;
  }
}

// Line moves of half `half` at step t: one thread per (chain = blockIdx.x
// / xblocks, site j) flips its whole line with dE = bc * sum_p s_p (f_p +
// h), p in index order, against the other half o; kHw as for
// bath_local_kernel. kColored: the colored template's, the even slices
// summed, then the odd, at kernel B's counter index 4 + half.
template <bool kHw, bool kColored>
__global__ void __launch_bounds__(kThreads)
bath_line_kernel(const float* __restrict__ w, const float* __restrict__ h,
                 const float* __restrict__ b_sched, float teff, float* s,
                 const float* __restrict__ o, int half, int P, int nh, int K,
                 int nslots, int xblocks, int t, uint32_t seed_term,
                 uint32_t launch) {
  const int chain = blockIdx.x / xblocks;
  const int j = (blockIdx.x - chain * xblocks) * blockDim.x + threadIdx.x;
  if (j >= nh) return;
  const size_t base = static_cast<size_t>(chain) * P * nh;
  float* const line = s + base + j;
  const float hj = __ldg(h + half * nh + j);
  float sum = 0.0f, odd = 0.0f;
  for (int p = 0; p < P; ++p) {
    const size_t row = static_cast<size_t>(p) * nh;
    const float f = __fadd_rn(
        mcs::half_field(o + base + row, w, half, nh, K, nslots, j), hj);
    const float x = __fmul_rn(line[row], f);  // exact
    if (kColored && (p & 1))
      odd = p == 1 ? x : __fadd_rn(odd, x);
    else
      sum = p == 0 ? x : __fadd_rn(sum, x);
  }
  if (kColored) sum = __fadd_rn(sum, odd);
  const float de = __fmul_rn(-2.0f * b_sched[t], sum);
  const uint32_t uid =
      static_cast<uint32_t>(chain) * (2u * static_cast<uint32_t>(nh)) +
      static_cast<uint32_t>(half * nh + j);
  const uint32_t ctr =
      mcs::counter(seed_term, t, kColored ? 4 + half : 2 * P + half);
  mcs::Uniforms<kHw> rng(seed_term, mcs::phase_stream(launch));
  if (rng.accept(de, teff, uid * mcs::kGolden + ctr)) {
    for (int p = 0; p < P; ++p) {
      const size_t row = static_cast<size_t>(p) * nh;
      line[row] = -line[row];
    }
  }
}

}  // namespace

// Anneal `chains` Trotter states over `steps` schedule points in one launch,
// each chain over a cluster of R CTAs of `threads` threads. w: (nslots, 2,
// nh), h: (2, nh), b_sched and jp: (steps,), bath: (P, P), halves
// (chains, P, nh) of +/-1 with nh = L*L/2; all float32 device pointers.
// teff and two_teff are T_eff and 2*T_eff rounded to float32; hw_rng != 0
// draws the uniforms from each thread's stream (hw_rng.cuh). Launches on
// `stream` and returns cudaGetLastError().
static int launch_cluster(
    KernelFn kernel, const float* w, const float* h, const float* b_sched,
    const float* jp, const float* bath, float teff, float two_teff,
    const float* a_in, const float* b_in, float* a_out, float* b_out,
    int chains, int P, int R, int threads, int L, int nslots, int steps,
    int seed, int global_moves, void* stream) {
  if (chains == 0 || L == 0) return cudaSuccess;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = mcs::cluster_config(kernel, chains * R, R, threads,
                                      smem_bytes(P, L, R),
                                      static_cast<cudaStream_t>(stream),
                                      &cfg, &attr);
  if (e != cudaSuccess) return e;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  e = cudaLaunchKernelEx(&cfg, kernel, w, h, b_sched, jp, bath, teff,
                         two_teff, a_in, b_in, a_out, b_out, P, R, L, nslots,
                         steps, seed_term, global_moves);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

extern "C" int split_qmc_bath_anneal(
    const float* w, const float* h, const float* b_sched, const float* jp,
    const float* bath, float teff, float two_teff, const float* a_in,
    const float* b_in, float* a_out, float* b_out, int chains, int P, int R,
    int threads, int L, int nslots, int steps, int seed, int global_moves,
    int hw_rng, void* stream) {
  return launch_cluster(kernel_for(P, hw_rng), w, h, b_sched, jp, bath, teff,
                        two_teff, a_in, b_in, a_out, b_out, chains, P, R,
                        threads, L, nslots, steps, seed, global_moves,
                        stream);
}

// The colored template (bath_update="colored", even P) of the same anneal on
// the halves, which hold the quarters' slices in place (xe and yo the even
// and odd slices of a, ye and xo those of b); arguments as for
// split_qmc_bath_anneal, on the counter hash only.
extern "C" int split_qmc_bath_colored_anneal(
    const float* w, const float* h, const float* b_sched, const float* jp,
    const float* bath, float teff, float two_teff, const float* a_in,
    const float* b_in, float* a_out, float* b_out, int chains, int P, int R,
    int threads, int L, int nslots, int steps, int seed, int global_moves,
    void* stream) {
  if (P % 2 || (P + 31) / 32 > kMaxRuntimeWords) return cudaErrorInvalidValue;
  return launch_cluster(kernel_for(P, 0, 1), w, h, b_sched, jp, bath, teff,
                        two_teff, a_in, b_in, a_out, b_out, chains, P, R,
                        threads, L, nslots, steps, seed, global_moves,
                        stream);
}

// Clusters of R CTAs the card holds at once at this P and L (the hash
// instantiation's; the generator's and the colored template's have the
// same register limit and shared memory).
extern "C" int split_qmc_bath_max_active_clusters(int P, int R, int threads,
                                                  int L, int* count) {
  return mcs::max_active_clusters(kernel_for(P, 0), R, threads,
                                  smem_bytes(P, L, R), count);
}

// The same anneal on the per-phase kernels, the state in device memory: the
// halves (chains, P, nh) are copied to a_out, b_out and updated there in
// place, two launches a step (half A, then half B against the new A), four
// with global moves (then the lines of A, then those of B against the
// flipped A); hw_rng as for split_qmc_bath_anneal. Stores the number of
// kernels it launched in *launched (a host pointer); returns the first
// launch error, checked after the first step, or cudaGetLastError() at the
// end.
// With `energies` (a (steps, chains) float32 device buffer; null: none),
// the energy kernel (energy.cuh) writes each chain's best-slice energy after
// every step into row t, one launch a step, counted in *energy_launched (a
// host pointer).
extern "C" int split_qmc_bath_phased_anneal(
    const float* w, const float* h, const float* b_sched, const float* jp,
    const float* bath, float teff, float two_teff, const float* a_in,
    const float* b_in, float* a_out, float* b_out, int chains, int P, int L,
    int nslots, int steps, int seed, int global_moves, int hw_rng,
    float* energies, void* stream, long long* launched,
    long long* energy_launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  *energy_launched = 0;
  const int K = L / 2;
  const int nh = L * K;
  const size_t bytes =
      static_cast<size_t>(chains) * P * nh * sizeof(float);
  cudaError_t e = cudaMemcpyAsync(a_out, a_in, bytes,
                                  cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return e;
  e = cudaMemcpyAsync(b_out, b_in, bytes, cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return e;
  if (chains == 0 || P == 0 || nh == 0) return cudaSuccess;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  const int xblocks = (nh + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(xblocks) * chains);
  float* halves[2] = {a_out, b_out};
  const auto local =
      hw_rng ? bath_local_kernel<true> : bath_local_kernel<false>;
  const auto line = hw_rng ? bath_line_kernel<true, false>
                           : bath_line_kernel<false, false>;
  for (int t = 0; t < steps; ++t) {
    for (int half = 0; half < 2; ++half) {
      local<<<grid, kThreads, 0, st>>>(
          w, h, b_sched, jp, bath, teff, two_teff, halves[half],
          halves[1 - half], half, P, nh, K, nslots, xblocks, t, seed_term,
          static_cast<uint32_t>(*launched));
      *launched += 1;
    }
    if (global_moves) {
      for (int half = 0; half < 2; ++half) {
        line<<<grid, kThreads, 0, st>>>(
            w, h, b_sched, teff, halves[half], halves[1 - half], half, P, nh,
            K, nslots, xblocks, t, seed_term,
            static_cast<uint32_t>(*launched));
        *launched += 1;
      }
    }
    if (energies != nullptr) {
      mcs::launch_halves_energy(w, h, a_out, b_out, chains, P, L, nslots,
                                false, energies + static_cast<size_t>(t) *
                                                      chains, st);
      *energy_launched += 1;
    }
    if (t == 0) {
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  }
  return cudaGetLastError();
}

// The colored template on the per-phase kernels: a_in, b_in copied to
// a_out, b_out, four out-of-place launches a step (xe, xo, ye, yo), each
// from its half's buffer into the other of a_out / a_tmp (b_out / b_tmp),
// so every half is back in a_out, b_out after the step; with global moves
// two more, kernel B's line moves in place; with `energies` the energy
// kernel after each step. a_tmp, b_tmp: scratch of a half's size.
// Arguments and results otherwise as for split_qmc_bath_phased_anneal, on
// the counter hash only.
extern "C" int split_qmc_bath_colored_phased_anneal(
    const float* w, const float* h, const float* b_sched, const float* jp,
    const float* bath, float teff, float two_teff, const float* a_in,
    const float* b_in, float* a_out, float* b_out, float* a_tmp,
    float* b_tmp, int chains, int P, int L, int nslots, int steps, int seed,
    int global_moves, float* energies, void* stream, long long* launched,
    long long* energy_launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  *energy_launched = 0;
  if (P % 2) return cudaErrorInvalidValue;
  const int K = L / 2;
  const int nh = L * K;
  const size_t bytes =
      static_cast<size_t>(chains) * P * nh * sizeof(float);
  cudaError_t e = cudaMemcpyAsync(a_out, a_in, bytes,
                                  cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return e;
  e = cudaMemcpyAsync(b_out, b_in, bytes, cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return e;
  if (chains == 0 || P == 0 || nh == 0) return cudaSuccess;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  const int xblocks = (nh + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(xblocks) * chains);
  float* cur[2] = {a_out, b_out};
  float* nxt[2] = {a_tmp, b_tmp};
  for (int t = 0; t < steps; ++t) {
    for (int phase = 0; phase < 4; ++phase) {
      const int half = phase == 1 || phase == 2;
      bath_colored_local_kernel<<<grid, kThreads, 0, st>>>(
          w, h, b_sched, jp, bath, teff, two_teff, cur[half], nxt[half],
          cur[1 - half], half, phase & 1, phase, P, nh, K, nslots, xblocks,
          t, seed_term);
      float* done = nxt[half];
      nxt[half] = cur[half];
      cur[half] = done;
      *launched += 1;
    }
    if (global_moves) {
      for (int half = 0; half < 2; ++half) {
        bath_line_kernel<false, true><<<grid, kThreads, 0, st>>>(
            w, h, b_sched, teff, cur[half], cur[1 - half], half, P, nh, K,
            nslots, xblocks, t, seed_term, 0u);
        *launched += 1;
      }
    }
    if (energies != nullptr) {
      mcs::launch_halves_energy(w, h, a_out, b_out, chains, P, L, nslots,
                                false, energies + static_cast<size_t>(t) *
                                                      chains, st);
      *energy_launched += 1;
    }
    if (t == 0) {
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  }
  return cudaGetLastError();
}

extern "C" const char* split_qmc_bath_anneal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
