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
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <utility>

#include "cluster.cuh"
#include "counter_hash.cuh"
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

// kHw: uniforms from the thread's stream (hw_rng.cuh), not the counter hash
template <int kP, bool kHw>
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
    if (global_moves) {
      // lines of half A against B, then lines of half B against the
      // flipped A; dE = bc * sum_p s_p (f_p + h), p in index order
      for (int half = 0; half < 2; ++half) {
        const int own = half ? half_b : 0;
        const int other = half ? 0 : half_b;
        const uint32_t ctr = mcs::counter(seed_term, t, 2 * P + half);
        for (int il = threadIdx.x; il < band.nb; il += blockDim.x) {
          const int j = band.lo + il;
          const float hj = __ldg(h + half * nh + j);
          float wv[7];
          mcs::load_weights(w, half, nh, nslots, j, wv);
          float sum = 0.0f;
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
              sum = wd == 0 && bit == 0 ? x : __fadd_rn(sum, x);
            }
          }
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
      &split_qmc_bath_kernel<(Ps < 2 ? 0 : Ps), false>...};
}

// The P the generator's instantiations take at compile time: the bench's
// (bench/throughput.py, pallas_bath); any other P takes the runtime-P one,
// so that the build keeps 66 instantiations, not 130
constexpr int kHwStaticP = 40;

KernelFn kernel_for(int P, int hw_rng) {
  if (hw_rng)
    return P == kHwStaticP ? &split_qmc_bath_kernel<kHwStaticP, true>
                           : &split_qmc_bath_kernel<0, true>;
  static const auto table =
      kernel_table(std::make_integer_sequence<int, kMaxStaticP + 1>{});
  return P <= kMaxStaticP ? table[P] : &split_qmc_bath_kernel<0, false>;
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

// Line moves of half `half` at step t: one thread per (chain = blockIdx.x
// / xblocks, site j) flips its whole line with dE = bc * sum_p s_p (f_p +
// h), p in index order, against the other half o; kHw as for
// bath_local_kernel.
template <bool kHw>
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
  float sum = 0.0f;
  for (int p = 0; p < P; ++p) {
    const size_t row = static_cast<size_t>(p) * nh;
    const float f = __fadd_rn(
        mcs::half_field(o + base + row, w, half, nh, K, nslots, j), hj);
    const float x = __fmul_rn(line[row], f);  // exact
    sum = p == 0 ? x : __fadd_rn(sum, x);
  }
  const float de = __fmul_rn(-2.0f * b_sched[t], sum);
  const uint32_t uid =
      static_cast<uint32_t>(chain) * (2u * static_cast<uint32_t>(nh)) +
      static_cast<uint32_t>(half * nh + j);
  const uint32_t ctr = mcs::counter(seed_term, t, 2 * P + half);
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
extern "C" int split_qmc_bath_anneal(
    const float* w, const float* h, const float* b_sched, const float* jp,
    const float* bath, float teff, float two_teff, const float* a_in,
    const float* b_in, float* a_out, float* b_out, int chains, int P, int R,
    int threads, int L, int nslots, int steps, int seed, int global_moves,
    int hw_rng, void* stream) {
  if (chains == 0 || L == 0) return cudaSuccess;
  const KernelFn kernel = kernel_for(P, hw_rng);
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

// Clusters of R CTAs the card holds at once at this P and L (the hash
// instantiation's; both have the same register limit and shared memory).
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
extern "C" int split_qmc_bath_phased_anneal(
    const float* w, const float* h, const float* b_sched, const float* jp,
    const float* bath, float teff, float two_teff, const float* a_in,
    const float* b_in, float* a_out, float* b_out, int chains, int P, int L,
    int nslots, int steps, int seed, int global_moves, int hw_rng,
    void* stream, long long* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
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
  const auto line = hw_rng ? bath_line_kernel<true> : bath_line_kernel<false>;
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
