// Kernel B: PIQMC local moves at even P, plus optional whole-line moves, on
// the split checkerboard.
//
// Replaces montecarlosolvers_tpu/ops/pallas_split.py::_qmc_split_kernel
// (:431), launched there by _run_qmc_split (:567) under
// anneal_lattice_qmc_split (:607). Plain PyTorch version:
// ops/split_kernels.py::qmc_split_anneal_ref.
//
// What it computes. The Trotter state of a chain is four quarters
// xe, xo, ye, yo, each (Q = P/2, Nh) (ops/split.py:202-214): a space-time
// checkerboard, x = {half a at even slices (xe), half b at odd slices (xo)}
// and y = {half b at even slices (ye), half a at odd slices (yo)}. Per
// schedule step: phase X updates xe and xo against ye and yo, phase Y
// updates ye and yo against the new xe and xo, with
//   dE = -2B s f + 2 s J_perp (Trotter up + Trotter down),
// T_eff = P*T and J_perp = -(T_eff/2) ln tanh(Gamma/T_eff); then, with
// global moves, whole lines of color A (xe, yo) and then of color B
// (ye, xo, against the updated A quarters) flip with dE = -2B sum_q s f.
// Uniforms at counter(seed, step, idx), idx 0..3 for xe, xo, ye, yo with
// uid = chain*4QNh + idx*QNh + q*Nh + site, and 4 + color for the lines
// with uid = chain*2Nh + color*Nh + site (pallas_split.py:483-493).
//
// What bounds it on an H100. The work of a sweep at the main path's 80x80,
// P = 40, 32 chains is 8.19 M site updates and 0.2 M line moves of 20 + 20
// slices each; per update 13 float32 operations and a logarithm, per line
// 5P + 5 and a logarithm (chip_smoke.py::ops_per_sweep). A chain as floats
// is P*Nh*2*4 bytes = 1 MB; the kernel this one replaced kept it in device
// memory and launched four kernels a step, 4000 per solve, streaming the
// state through L2 about three times a step: 0.143 ms a sweep (H100 80GB
// HBM3, 700 W, PERF.md). As sign bits a chain is 32 KB.
//
// What the design does about that (kernel 5's, csrc/split_qmc_bath.cu,
// without the bath and in kernel B's own order).
// - The state as bits in shared memory, in quarter words: bit q of word
//   q/32 of quarter i at site j is the sign of quarter i's slice q (1 for
//   -1), in planes [quarter][word][site], 4*ceil(Q/32) words a site. The
//   kernel reads the float quarters and packs them itself, and unpacks
//   them at the end, so the wrapper keeps the quarters layout. Quarter
//   words and not line words (bit p = slice p): every update of a phase
//   reads its stencil at bit q of the neighbours' words of one other
//   quarter and its Trotter ring at bits q and q -/+ 1 of one more
//   quarter, so the ring partner is aligned with the updated bit by one
//   rotation of that quarter's word per site and phase, and at P <= 64 a
//   quarter is one word; with line words the partners p -/+ 1 are of the
//   other parity, cross a word boundary from P = 33 on, and the neighbour
//   words double there.
// - Each thread owns site j of both halves for the whole anneal. In phase
//   X it updates xe's and xo's bits of its site, reading only y bits: its
//   own for the ring and its neighbours' for the stencil; those do not
//   change within the phase, so no update of a phase waits on another.
//   Phase Y likewise, the line moves of a color read only the other color.
// - One chain over a cluster of R CTAs, each holding a band of rows of all
//   four quarters (csrc/cluster.cuh); a stencil read across a band edge,
//   and the torus wrap, go through distributed shared memory. The whole
//   schedule is one launch: phase X, cluster.sync(), phase Y,
//   cluster.sync(), and with global moves line A, sync, line B, sync, so Y
//   reads the new X and line B the A quarters after line A's flips.
//   ops/split_kernels.py::qmc_geometry chooses R by kernel 5's rules.
// - A J_perp per chain (quantum parallel tempering's Gamma ladder,
//   solvers/pt.py::sample_piqmc): the template argument kPerChain reads
//   jp[t * stride_t + chain * stride_c] once a step (B stays shared, and the
//   line moves read no J_perp). A step offset, step0, folds into the seed
//   term on the host, so a run split into launches draws as one launch.
// - The uniform source is a template argument (csrc/hw_rng.cuh): the
//   counter hash, or with hw_rng the thread's own generator stream, which
//   draws a site's slices in slice order, then its line moves; the hash
//   instantiation is the kernel as it was.
// - A shape no cluster holds (ops/split_kernels.py::qmc_geometry returns
//   None: at P = 40 an even L above 674, at P = 128 above 480) runs on the
//   per-phase kernels below (split_qmc_phased_anneal): the state in device
//   memory, four launches a step, chains along gridDim.x.
//
// Trouble spots, each handled where it bites below: the Trotter ring
// (indices mod Q; at Q = 1 both ring terms are the same element), the FMA
// contraction of dE whenever B != 1, the phase order, and the line sums,
// each in slice order from its first term.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "counter_hash.cuh"
#include "energy.cuh"
#include "hw_rng.cuh"

namespace {

namespace cg = cooperative_groups;

// As kernels A and 5: at most 256 threads a CTA, registers for 5 an SM.
constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 5;
constexpr int kThreads = 256;  // the per-phase kernels

// s of bit b of a word: bit 1 is s = -1
__device__ __forceinline__ float spin_of(uint32_t word, int b) {
  return (word >> b) & 1u ? -1.0f : 1.0f;
}

// Bit `q` (0 <= q < Q) of a quarter at band site il: word q/32 at q/32*S
__device__ __forceinline__ uint32_t quarter_bit(const uint32_t* quarter,
                                                int S, int q) {
  return (quarter[(q >> 5) * S] >> (q & 31)) & 1u;
}

// Word wd of a quarter's Trotter partner, rotated so that bit b holds the
// partner's slice (32wd + b + dir) mod Q, dir = -1 or +1. Bits at or past
// Q - 32wd are not read. `quarter` points at the quarter's word 0 at the
// site; spare bits past Q are 0 in shared memory.
__device__ __forceinline__ uint32_t ring_word(const uint32_t* quarter, int S,
                                             int Q, int wd, int dir) {
  const uint32_t word = quarter[wd * S];
  if (dir < 0)  // bit 0 takes slice 32wd - 1 mod Q
    return (word << 1) | quarter_bit(quarter, S, (32 * wd + Q - 1) % Q);
  // the last bit of the word takes slice 32wd + nbits mod Q
  const int last = min(32, Q - 32 * wd) - 1;
  const uint32_t rest = (word >> 1) & ~(1u << last);
  return rest | (quarter_bit(quarter, S, (32 * wd + last + 1) % Q) << last);
}

// kHw: uniforms from the thread's stream (hw_rng.cuh), not the counter hash;
// kPerChain: J_perp of chain c at step t is jp[t * stride_t + c * stride_c]
// (quantum parallel tempering's Gamma ladder), else jp[t]
template <bool kHw, bool kPerChain>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
split_qmc_kernel(const float* __restrict__ w, const float* __restrict__ h,
                 const float* __restrict__ b_sched,
                 const float* __restrict__ jp, float teff,
                 const float* __restrict__ xe_in,
                 const float* __restrict__ xo_in,
                 const float* __restrict__ ye_in,
                 const float* __restrict__ yo_in, float* __restrict__ xe_out,
                 float* __restrict__ xo_out, float* __restrict__ ye_out,
                 float* __restrict__ yo_out, int Q, int R, int L, int nslots,
                 int steps, uint32_t seed_term, int global_moves,
                 int stride_t, int stride_c) {
  extern __shared__ uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = L / 2;
  const int nh = L * K;
  const int S = mcs::band_stride(L, R, K);
  const int W = (Q + 31) / 32;  // words a quarter holds at a site
  const int chain = blockIdx.x / R;
  const mcs::Band band =
      mcs::make_band(cluster, smem, blockIdx.x % R, R, L, K);
  const size_t base = static_cast<size_t>(chain) * Q * nh + band.lo;
  // quarter i (xe, xo, ye, yo) word wd of band site il: smem[off(i) + wd*S
  // + il]
  auto off = [&](int i) { return i * W * S; };
  const float* const ins[4] = {xe_in, xo_in, ye_in, yo_in};
  float* const outs[4] = {xe_out, xo_out, ye_out, yo_out};

  for (int il = threadIdx.x; il < band.nb; il += blockDim.x) {
    for (int i = 0; i < 4; ++i) {
      for (int wd = 0; wd < W; ++wd) {
        uint32_t word = 0;
        for (int q = 32 * wd; q < Q && q < 32 * wd + 32; ++q)
          word |= static_cast<uint32_t>(
                      ins[i][base + static_cast<size_t>(q) * nh + il] <
                      0.0f) << (q & 31);
        smem[off(i) + wd * S + il] = word;
      }
    }
  }
  cluster.sync();  // every band is loaded before any is read

  const uint32_t qnh = static_cast<uint32_t>(Q) * static_cast<uint32_t>(nh);
  // the hash input uid*kGolden + ctr steps by Nh*kGolden from q to q + 1
  const uint32_t q_step = static_cast<uint32_t>(nh) * mcs::kGolden;
  // with kHw, a site's slices draw in slice order from the thread's stream
  mcs::Uniforms<kHw> rng(seed_term, mcs::thread_stream());
  for (int t = 0; t < steps; ++t) {
    const float bc = -2.0f * b_sched[t];
    const float jpt =
        kPerChain ? __ldg(jp + static_cast<size_t>(t) * stride_t +
                          static_cast<size_t>(chain) * stride_c)
                  : jp[t];
    // One local phase's update of quarter `s` (counter index `idx`, the
    // weights of half `color`) at band site il: stencil over quarter `o`
    // at the same q, Trotter ring over quarter `r` at q and q + dir:
    //   phase X: xe <- ye, yo[q] + yo[q-1]     xo <- yo, ye[q] + ye[q+1]
    //   phase Y: ye <- xe, xo[q] + xo[q-1]     yo <- xo, xe[q] + xe[q+1]
    // (pallas_split.py:514-518). Only quarter s changes, and no update of
    // the phase reads it.
    auto local = [&](int s, int o, int r, int dir, int color, int idx,
                     int il) {
      const int j = band.lo + il;
      float wv[7];
      mcs::load_weights(w, color, nh, nslots, j, wv);
      const float hj = __ldg(h + color * nh + j);
      // uid = chain*4QNh + idx*QNh + q*Nh + site, wrapping as int32
      uint32_t x = (static_cast<uint32_t>(chain) * (4u * qnh) +
                    static_cast<uint32_t>(idx) * qnh +
                    static_cast<uint32_t>(j)) *
                       mcs::kGolden +
                   mcs::counter(seed_term, t, idx);
      for (int wd = 0; wd < W; ++wd) {
        uint32_t nb[7];
        mcs::load_neighbours(band, off(o) + wd * S, il, K, nslots, nb);
        const uint32_t word = smem[off(s) + wd * S + il];
        const uint32_t ring_q = smem[off(r) + wd * S + il];
        const uint32_t ring_d = ring_word(smem + off(r) + il, S, Q, wd, dir);
        const int nbits = min(32, Q - 32 * wd);
        uint32_t flips = 0u;
        for (int b = 0; b < nbits; ++b, x += q_step) {
          const float f =
              __fadd_rn(mcs::field_of_bit(wv, nb, nslots, b), hj);
          const float sv = spin_of(word, b);
          const float tr = __fadd_rn(spin_of(ring_q, b), spin_of(ring_d, b));
          // dE = bc*s*f + 2*s*jp*tr in the plain version's order. bc*s,
          // 2*s*jp and the product with tr (in {-2, 0, 2}) are exact, but
          // (bc*s)*f is rounded whenever B != 1, so an FMA fused into the
          // sum would change dE: __fmul_rn/__fadd_rn keep the two roundings
          const float de = __fadd_rn(__fmul_rn(bc * sv, f),
                                     __fmul_rn(__fmul_rn(2.0f * sv, jpt), tr));
          if (rng.accept(de, teff, x)) flips |= 1u << b;
        }
        smem[off(s) + wd * S + il] = word ^ flips;
      }
    };
    // phase X: xe (half a) and xo (half b) against the y quarters
    for (int il = threadIdx.x; il < band.nb; il += blockDim.x) {
      local(0, 2, 3, -1, 0, 0, il);
      local(1, 3, 2, +1, 1, 1, il);
    }
    cluster.sync();
    // phase Y: ye (half b) and yo (half a) against the new x quarters
    for (int il = threadIdx.x; il < band.nb; il += blockDim.x) {
      local(2, 0, 1, -1, 1, 2, il);
      local(3, 1, 0, +1, 0, 3, il);
    }
    cluster.sync();
    if (!global_moves) continue;
    // Whole-line moves of `color`: the line's sites are quarters s1 (even
    // slices) and s2 (odd slices), their stencils over o1 and o2. dE =
    // bc * (sum_q s1 f1 + sum_q s2 f2), each sum in slice order from its
    // first term (ops/piqmc.py::sum_in_order); J_perp cancels for a
    // whole-line flip (qmc.pyx:405-438).
    for (int color = 0; color < 2; ++color) {
      const int s1 = color ? 2 : 0, o1 = color ? 0 : 2;
      const int s2 = color ? 1 : 3, o2 = color ? 3 : 1;
      const uint32_t ctr = mcs::counter(seed_term, t, 4 + color);
      for (int il = threadIdx.x; il < band.nb; il += blockDim.x) {
        const int j = band.lo + il;
        float wv[7];
        mcs::load_weights(w, color, nh, nslots, j, wv);
        const float hj = __ldg(h + color * nh + j);
        float sums[2];
        for (int part = 0; part < 2; ++part) {
          const int s = part ? s2 : s1, o = part ? o2 : o1;
          // -0.0 + x == x for every x, so the sum starts at its first term
          float sum = -0.0f;
          for (int wd = 0; wd < W; ++wd) {
            uint32_t nb[7];
            mcs::load_neighbours(band, off(o) + wd * S, il, K, nslots, nb);
            const uint32_t word = smem[off(s) + wd * S + il];
            const int nbits = min(32, Q - 32 * wd);
            for (int b = 0; b < nbits; ++b) {
              const float f =
                  __fadd_rn(mcs::field_of_bit(wv, nb, nslots, b), hj);
              sum = __fadd_rn(sum, mcs::signed_by(f, word, b));  // s*f
            }
          }
          sums[part] = sum;
        }
        const float de = __fmul_rn(bc, __fadd_rn(sums[0], sums[1]));
        // uid = chain*2Nh + color*Nh + site, wrapping as int32
        const uint32_t x =
            (static_cast<uint32_t>(chain) * (2u * static_cast<uint32_t>(nh)) +
             static_cast<uint32_t>(color * nh + j)) *
                mcs::kGolden +
            ctr;
        if (rng.accept(de, teff, x)) {
          for (int wd = 0; wd < W; ++wd) {
            const int nbits = min(32, Q - 32 * wd);
            const uint32_t mask = nbits == 32 ? ~0u : (1u << nbits) - 1u;
            smem[off(s1) + wd * S + il] ^= mask;
            smem[off(s2) + wd * S + il] ^= mask;
          }
        }
      }
      cluster.sync();  // line B reads the flipped A; phase X reads B
    }
  }

  for (int il = threadIdx.x; il < band.nb; il += blockDim.x)
    for (int i = 0; i < 4; ++i)
      for (int q = 0; q < Q; ++q)
        outs[i][base + static_cast<size_t>(q) * nh + il] =
            spin_of(smem[off(i) + (q >> 5) * S + il], q & 31);
}

// Shared memory of one CTA: its band of the four quarters as bits
// (ops/split_kernels.py::qmc_smem_bytes counts the same).
size_t smem_bytes(int Q, int L, int R) {
  return 4 * static_cast<size_t>((Q + 31) / 32) *
         mcs::band_stride(L, R, L / 2) * sizeof(uint32_t);
}

// ---- the per-phase kernels, for shapes no cluster holds

// One local phase: blockIdx.y < Q updates quarter s0 (its q = blockIdx.y)
// and blockIdx.y >= Q updates quarter s1, for chain blockIdx.x / xblocks.
// Quarter `which` reads its spatial neighbours in o<which> at the same q,
// and its Trotter neighbours in r<which> at q and at q-1 (which 0) or q+1
// (which 1), as the cluster kernel's `local`. The counter index is idx0 +
// which (0, 1 in phase X; 2, 3 in phase Y); with kHw the uniform is the
// first draw of the thread's stream of this launch, number `launch`;
// kPerChain as for split_qmc_kernel.
template <bool kHw, bool kPerChain>
__global__ void __launch_bounds__(kThreads)
qmc_local_kernel(const float* __restrict__ w, const float* __restrict__ h,
                 const float* __restrict__ b_sched,
                 const float* __restrict__ jp, float teff, float* s0,
                 const float* __restrict__ o0, const float* __restrict__ r0,
                 int color0, float* s1, const float* __restrict__ o1,
                 const float* __restrict__ r1, int color1, int idx0, int Q,
                 int nh, int K, int nslots, int xblocks, int t,
                 uint32_t seed_term, uint32_t launch, int stride_t,
                 int stride_c) {
  const int chain = blockIdx.x / xblocks;
  const int j = (blockIdx.x - chain * xblocks) * blockDim.x + threadIdx.x;
  if (j >= nh) return;
  const int which = blockIdx.y >= Q;
  const int q = blockIdx.y - which * Q;
  float* s = which ? s1 : s0;
  const float* o = which ? o1 : o0;
  const float* r = which ? r1 : r0;
  const int color = which ? color1 : color0;
  // Trotter ring partner, mod Q (at Q = 1 it is q itself)
  const int qn = which ? (q + 1 == Q ? 0 : q + 1) : (q == 0 ? Q - 1 : q - 1);
  const size_t row = (static_cast<size_t>(chain) * Q + q) * nh;
  const size_t row_n = (static_cast<size_t>(chain) * Q + qn) * nh;

  const float sv = s[row + j];
  const float f = __fadd_rn(mcs::half_field(o + row, w, color, nh, K,
                                            nslots, j),
                            __ldg(h + color * nh + j));
  const float tr = __fadd_rn(r[row + j], r[row_n + j]);
  const float bc = -2.0f * b_sched[t];
  const float jpt =
      kPerChain ? __ldg(jp + static_cast<size_t>(t) * stride_t +
                        static_cast<size_t>(chain) * stride_c)
                : jp[t];
  const float de = __fadd_rn(__fmul_rn(bc * sv, f),
                             __fmul_rn(__fmul_rn(2.0f * sv, jpt), tr));
  const int idx = idx0 + which;
  const uint32_t qnh = static_cast<uint32_t>(Q) * static_cast<uint32_t>(nh);
  const uint32_t uid = static_cast<uint32_t>(chain) * (4u * qnh) +
                       static_cast<uint32_t>(idx) * qnh +
                       static_cast<uint32_t>(q) * static_cast<uint32_t>(nh) +
                       static_cast<uint32_t>(j);
  bool acc;
  if constexpr (kHw) {
    mcs::Uniforms<true> rng(seed_term, mcs::phase_stream(launch));
    acc = rng.accept(de, teff, 0u);
  } else {
    acc = mcs::metropolis_accept(
        de, teff, mcs::uniform01(mcs::counter(seed_term, t, idx), uid));
  }
  if (acc) s[row + j] = -sv;
}

// Whole-line moves of `color`, one thread per (chain = blockIdx.x /
// xblocks, site), as the cluster kernel's line moves; kHw as for
// qmc_local_kernel.
template <bool kHw>
__global__ void __launch_bounds__(kThreads)
qmc_line_kernel(const float* __restrict__ w, const float* __restrict__ h,
                const float* __restrict__ b_sched, float teff, float* s1,
                const float* __restrict__ o1, float* s2,
                const float* __restrict__ o2, int color, int Q, int nh, int K,
                int nslots, int xblocks, int t, uint32_t seed_term,
                uint32_t launch) {
  const int chain = blockIdx.x / xblocks;
  const int j = (blockIdx.x - chain * xblocks) * blockDim.x + threadIdx.x;
  if (j >= nh) return;
  const size_t base = static_cast<size_t>(chain) * Q * nh;
  const float hj = __ldg(h + color * nh + j);
  float sum1 = -0.0f;
  for (int q = 0; q < Q; ++q) {
    const size_t row = base + static_cast<size_t>(q) * nh;
    const float f = __fadd_rn(
        mcs::half_field(o1 + row, w, color, nh, K, nslots, j), hj);
    sum1 = __fadd_rn(sum1, __fmul_rn(s1[row + j], f));
  }
  float sum2 = -0.0f;
  for (int q = 0; q < Q; ++q) {
    const size_t row = base + static_cast<size_t>(q) * nh;
    const float f = __fadd_rn(
        mcs::half_field(o2 + row, w, color, nh, K, nslots, j), hj);
    sum2 = __fadd_rn(sum2, __fmul_rn(s2[row + j], f));
  }
  const float de = __fmul_rn(-2.0f * b_sched[t], __fadd_rn(sum1, sum2));
  const int idx = 4 + color;
  const uint32_t uid =
      static_cast<uint32_t>(chain) * (2u * static_cast<uint32_t>(nh)) +
      static_cast<uint32_t>(color) * static_cast<uint32_t>(nh) +
      static_cast<uint32_t>(j);
  bool acc;
  if constexpr (kHw) {
    mcs::Uniforms<true> rng(seed_term, mcs::phase_stream(launch));
    acc = rng.accept(de, teff, 0u);
  } else {
    acc = mcs::metropolis_accept(
        de, teff, mcs::uniform01(mcs::counter(seed_term, t, idx), uid));
  }
  if (acc) {
    for (int q = 0; q < Q; ++q) {
      const size_t row = base + static_cast<size_t>(q) * nh;
      s1[row + j] = -s1[row + j];
      s2[row + j] = -s2[row + j];
    }
  }
}

}  // namespace

// Anneal `chains` Trotter states over `steps` schedule points in one launch,
// each chain over a cluster of R CTAs of `threads` threads. w: (nslots, 2,
// nh), h: (2, nh), b_sched and jp: (steps,), quarters (chains, Q, nh) of
// +/-1 with nh = L*L/2; all float32 device pointers. hw_rng != 0 draws the
// uniforms from each thread's stream (hw_rng.cuh). stride_c != 0 reads a
// J_perp per chain, jp[t * stride_t + chain * stride_c] (the hash only; the
// line moves read no J_perp); step0: the step the hash counts the first step
// as. Launches on `stream` and returns cudaGetLastError().
extern "C" int split_qmc_anneal(const float* w, const float* h,
                                const float* b_sched, const float* jp,
                                float teff, const float* xe_in,
                                const float* xo_in, const float* ye_in,
                                const float* yo_in, float* xe, float* xo,
                                float* ye, float* yo, int chains, int Q,
                                int R, int threads, int L, int nslots,
                                int steps, int seed, int global_moves,
                                int hw_rng, int stride_t, int stride_c,
                                int step0, void* stream) {
  if (chains == 0 || Q == 0 || L == 0) return cudaSuccess;
  if (hw_rng && stride_c != 0) return cudaErrorInvalidValue;
  const auto kernel = hw_rng ? split_qmc_kernel<true, false>
                      : stride_c ? split_qmc_kernel<false, true>
                                 : split_qmc_kernel<false, false>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = mcs::cluster_config(kernel, chains * R, R,
                                      threads, smem_bytes(Q, L, R),
                                      static_cast<cudaStream_t>(stream),
                                      &cfg, &attr);
  if (e != cudaSuccess) return e;
  // step0 folds into the seed term: counter(seed_term, t, i) is then
  // counter(seed, step0 + t, i)
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult +
                             static_cast<uint32_t>(step0) * mcs::kStepMult;
  e = cudaLaunchKernelEx(&cfg, kernel, w, h, b_sched, jp, teff,
                         xe_in, xo_in, ye_in, yo_in, xe, xo, ye, yo, Q, R, L,
                         nslots, steps, seed_term, global_moves, stride_t,
                         stride_c);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Clusters of R CTAs the card holds at once at Q = P/2 and lattice size L
// (the hash instantiation's; both have the same register limit and shared
// memory).
extern "C" int split_qmc_max_active_clusters(int Q, int R, int threads,
                                             int L, int* count) {
  return mcs::max_active_clusters(split_qmc_kernel<false, false>, R, threads,
                                  smem_bytes(Q, L, R), count);
}

// The same anneal on the per-phase kernels, the state in device memory:
// the inputs are copied to the outputs, which are then updated in place,
// four launches a step (two without global moves); hw_rng, stride_t,
// stride_c and step0 as for split_qmc_anneal. Stores the number of kernels it launched in *launched
// (a host pointer); returns the first launch error, checked after the
// first step, or cudaGetLastError() at the end.
// With `energies` (a (steps, chains) float32 device buffer; null: none),
// the energy kernel (energy.cuh) writes each chain's best-slice energy after
// every step into row t, one launch a step, counted in *energy_launched (a
// host pointer).
extern "C" int split_qmc_phased_anneal(const float* w, const float* h,
                                       const float* b_sched,
                                       const float* jp, float teff,
                                       const float* xe_in,
                                       const float* xo_in,
                                       const float* ye_in,
                                       const float* yo_in, float* xe,
                                       float* xo, float* ye, float* yo,
                                       int chains, int Q, int nh, int K,
                                       int nslots, int steps, int seed,
                                       int global_moves, int hw_rng,
                                       int stride_t, int stride_c, int step0,
                                       float* energies, void* stream,
                                       long long* launched,
                                       long long* energy_launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  *energy_launched = 0;
  if (hw_rng && stride_c != 0) return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(chains) * Q * nh * sizeof(float);
  const float* ins[4] = {xe_in, xo_in, ye_in, yo_in};
  float* outs[4] = {xe, xo, ye, yo};
  for (int i = 0; i < 4; ++i) {
    cudaError_t e = cudaMemcpyAsync(outs[i], ins[i], bytes,
                                    cudaMemcpyDeviceToDevice, st);
    if (e != cudaSuccess) return e;
  }
  if (chains == 0 || Q == 0 || nh == 0) return cudaGetLastError();
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult +
                             static_cast<uint32_t>(step0) * mcs::kStepMult;
  const int xblocks = (nh + kThreads - 1) / kThreads;
  const dim3 grid_local(xblocks * chains, 2 * Q);
  const dim3 grid_line(xblocks * chains);
  const auto local = hw_rng ? qmc_local_kernel<true, false>
                     : stride_c ? qmc_local_kernel<false, true>
                                : qmc_local_kernel<false, false>;
  const auto line = hw_rng ? qmc_line_kernel<true> : qmc_line_kernel<false>;
  for (int t = 0; t < steps; ++t) {
    // phase X: xe (color A) and xo (color B) against ye, yo
    local<<<grid_local, kThreads, 0, st>>>(
        w, h, b_sched, jp, teff, xe, ye, yo, 0, xo, yo, ye, 1, 0, Q, nh, K,
        nslots, xblocks, t, seed_term, static_cast<uint32_t>(*launched),
        stride_t, stride_c);
    // phase Y, after X in stream order: ye (B) and yo (A) against new X
    local<<<grid_local, kThreads, 0, st>>>(
        w, h, b_sched, jp, teff, ye, xe, xo, 1, yo, xo, xe, 0, 2, Q, nh, K,
        nslots, xblocks, t, seed_term, static_cast<uint32_t>(*launched + 1),
        stride_t, stride_c);
    *launched += 2;
    if (global_moves) {
      // lines of color A: sites xe + yo, neighbours ye / xo
      line<<<grid_line, kThreads, 0, st>>>(
          w, h, b_sched, teff, xe, ye, yo, xo, 0, Q, nh, K, nslots, xblocks,
          t, seed_term, static_cast<uint32_t>(*launched));
      // lines of color B, against the A quarters line A just updated
      line<<<grid_line, kThreads, 0, st>>>(
          w, h, b_sched, teff, ye, xe, xo, yo, 1, Q, nh, K, nslots, xblocks,
          t, seed_term, static_cast<uint32_t>(*launched + 1));
      *launched += 2;
    }
    if (energies != nullptr) {
      mcs::launch_quarters_energy(
          w, h, xe, xo, ye, yo, chains, Q, nh / K, nslots,
          energies + static_cast<size_t>(t) * chains, st);
      *energy_launched += 1;
    }
    if (t == 0) {
      cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  }
  return cudaGetLastError();
}

extern "C" const char* split_qmc_anneal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
