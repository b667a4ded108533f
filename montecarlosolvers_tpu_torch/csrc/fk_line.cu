// Imaginary-time line clusters of the bath: the line phases of
// bath_cluster_phase (WC2) or sw_full_phase (WC3), on one of three kernels
// chosen by shape alone (ops/cluster_kernels.py::line_geometry).
//
// Replaces no TPU kernel: the JAX package runs this as XLA,
// montecarlosolvers_tpu/ops/cluster.py::bath_cluster_phase (:316) and
// sw_full_phase (:363), which draw an (N, P, P) bond tensor and close it
// by log2(P) batched boolean matrix squarings (_time_closure :281). Plain
// PyTorch version: ops/cluster.py::line_phase_ref, phase after phase.
//
// What it computes. For every spin line i of color class c (the block
// [starts[c], starts[c + 1]) of the packed layout), on the draws of hash
// step `step` at B = b_sched[t], J_perp = jp[t], T_eff:
//   WC2: the line's seed slice (floor(u P)), its bath bonds between slices
//        of the seed's sign (p_pair[a][b], the host's 1 - exp(-2 lut)), the
//        slices the seed reaches along them, and one Metropolis accept of
//        the set-flip energy of the non-bath terms,
//        B sum_k f_k (t_k - s_k) - J_perp sum_k (t_k t_k+1 - s_k s_k+1);
//   WC3: bath bonds between equal spins and Trotter bonds (k, k + 1) with
//        probability p_t[t], symmetrized, closed, and every cluster
//        accepted on its own field energy sum_j in cluster (-2 B f_j s_j)
//        with the uniform of its least slice.
// The spatial neighbours are other classes' and stay fixed in the phase
// (on a packing that is not proper, the phase's start is read).
//
// What bounds it on an H100. A line draws P (P - 1) / 2 bath pairs, P
// Trotter bonds and computes P fields: the pair hashes (19 integer
// operations a uniform) are the floor the bytes-only bound of
// chip_smoke.py leaves out (PERF.md's "Hash" column).
//
// fk_line_cluster_kernel (LAUNCHES["fk_line"], P <= 64), the design for
// the card:
// - Slice-bit words: a line's P spins are one 64-bit word, bit k the sign
//   of slice k (1 for -1). The kernel packs the float (chains, P, N) state
//   as it loads it and writes floats back, as generic_words.cuh does.
// - One chain over a thread-block cluster of R CTAs, on generic PIQMC's
//   slot layout (ops/generic_kernels.py::word_layout): CTA r holds the
//   r-th of R equal chunks of every class's lines, their words in its
//   shared memory (51 KB a chain at n = 6400); a neighbour's word comes
//   from its owner through distributed shared memory (nbr_loc: (CTA << 16)
//   | slot). R is there to fill the SMs at few chains, not to fit the
//   words.
// - One launch an anneal: the steps [t0, t0 + steps) and the classes
//   [c_lo, c_hi) of each, one cluster barrier a class phase (two on a
//   packing that is not proper, whose phase first snapshots the words).
// - A warp a line, 32 warps a CTA (fewer warps lost time in proportion:
//   the phases are latency-bound, PERF.md). The P fields come from the
//   neighbours' words (the slot products in slot order, then h, as
//   packed.cuh adds them). Each bath pair is hashed once, by the lane
//   that owns it: lane L takes the L-th of 32 equal runs of the pairs in
//   row-major order and compares the hash's 24 bits with an integer
//   threshold (threshold24), no float. WC3 links each slice to the first
//   slice of its run of Trotter bonds (bit operations, no union), then
//   unites the ring's last bond and the bath bonds in a per-warp
//   union-find of the P slices in shared memory (fk.cuh::SharedSets, the
//   larger root hooked under the smaller, so a cluster's root is its least
//   slice); each root gathers its members from a warp match, sums their
//   energies in index order and draws its accept. WC2 ORs the directed
//   bonds into per-warp rows and grows the seed's reach across the warp,
//   as the first kernel did.
// - Sums in the plain order: every sum over slices adds its terms in
//   index order. Terms that are exact zeros (a slice outside the cluster,
//   an unflipped slice) are skipped: adding a zero changes at most the
//   sign of a zero sum, which no accept reads (dE <= 0 holds for both). The
//   Trotter part of WC2's dE is a sum of exact even integers, counted from
//   the words' bit changes around the ring.
// - Draws unchanged: each keeps its counter and uid (chain0 included), so
//   the launch equals line_phase_ref phase by phase, bitwise.
//
// fk_line_wide_kernel (P <= 64, LAUNCHES["fk_line_wide"]), the first
// kernel, kept as the route for a chain whose words no cluster of 16 CTAs
// holds: one warp a line, lane k holding slices k and k + 32, the line's
// P x P adjacency as one 64-bit row a slice in registers, reachability by
// OR-ing rows over warp shuffles until nothing changes; one launch a
// color phase; each lane hashes its own rows, so each pair twice.
//
// fk_line_rows_kernel (P > 64, LAUNCHES["fk_line_rows"], one launch a
// color phase): the same warp a line, its rows now W = ceil(P/64) 64-bit
// words each, too many for registers at any P, so the line lives in the warp's
// slice of shared memory: its spins, fields and cluster energies (P
// floats each), its rows twice (the closure reads one copy and writes the
// other, a __syncwarp between rounds) and the seed's reach twice. Lane l
// owns rows l, l + 32, ...; every sum over the slices is taken in index
// order by each lane from shared memory. A warp needs line_wide_bytes(P)
// of shared memory, so one CTA holds a line up to P = 921
// (ops/cluster_kernels.py::LINE_MAX_SLICES); the wrapper passes as many
// warps a CTA as the 227 KB allow (line_warps).
//
// All three draw the same bonds and decide alike: they equal the plain
// version, and each other, bitwise. No fast math.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "counter_hash.cuh"
#include "fk.cuh"
#include "packed.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// value of slice k of a line held as (v0: slice lane, v1: slice lane + 32);
// k may differ from lane to lane
__device__ __forceinline__ float slice_of(float v0, float v1, int k) {
  const float a = __shfl_sync(kFull, v0, k & 31);
  const float b = __shfl_sync(kFull, v1, k & 31);
  return k < 32 ? a : b;
}

__device__ __forceinline__ unsigned long long shfl64(unsigned long long v,
                                                     int src) {
  const unsigned lo = __shfl_sync(kFull, static_cast<unsigned>(v), src);
  const unsigned hi = __shfl_sync(kFull, static_cast<unsigned>(v >> 32), src);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// row of slice k of rows held as (r0: slice lane, r1: slice lane + 32)
__device__ __forceinline__ unsigned long long row_of(unsigned long long r0,
                                                     unsigned long long r1,
                                                     int k) {
  const unsigned long long a = shfl64(r0, k & 31);
  const unsigned long long b = shfl64(r1, k & 31);
  return k < 32 ? a : b;
}

__device__ __forceinline__ unsigned long long warp_or(unsigned long long v) {
  const unsigned lo = __reduce_or_sync(kFull, static_cast<unsigned>(v));
  const unsigned hi = __reduce_or_sync(kFull, static_cast<unsigned>(v >> 32));
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

__device__ __forceinline__ bool bit(unsigned long long r, int k) {
  return (r >> k) & 1ull;
}

// sum over slices 0..P-1 of x (held as x0, x1) in index order; the same
// value on every lane
__device__ __forceinline__ float sum_in_order(float x0, float x1, int P) {
  float acc = slice_of(x0, x1, 0);
  for (int k = 1; k < P; ++k) acc = __fadd_rn(acc, slice_of(x0, x1, k));
  return acc;
}

template <bool kFullSw>
__global__ void fk_line_wide_kernel(const int* __restrict__ nbr_idx,
                               const float* __restrict__ nbr_J,
                               const float* __restrict__ h,
                               const int* __restrict__ perm,
                               const int* __restrict__ starts,
                               const float* __restrict__ b_sched,
                               const float* __restrict__ jp_sched,
                               const float* __restrict__ pt_sched,
                               const float* __restrict__ p_pair, float teff,
                               float* s, int P, int n, int maxnb, int t,
                               int step, int color, int ncls,
                               uint32_t seed_term, uint32_t chain0) {
  const int lane = threadIdx.x & 31;
  const int li = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (li >= ncls) return;  // the whole warp
  // the state of local chain `chain`; every draw keyed by its global index
  // gchain (a chain shard's chains count from chain0)
  const int chain = blockIdx.y;
  const uint32_t gchain = chain0 + static_cast<uint32_t>(chain);
  const int i = __ldg(starts + color) + li;
  const uint32_t idi = static_cast<uint32_t>(__ldg(perm + i));
  float* sc = s + static_cast<size_t>(chain) * P * n;
  const float b = __ldg(b_sched + t), jp = __ldg(jp_sched + t);

  // this lane's slices a0 = lane, a1 = lane + 32, their spins and fields
  const int a0 = lane, a1 = lane + 32;
  const bool h0 = a0 < P, h1 = a1 < P;
  const float s0 = h0 ? sc[static_cast<size_t>(a0) * n + i] : 0.0f;
  const float s1 = h1 ? sc[static_cast<size_t>(a1) * n + i] : 0.0f;
  const float f0 = h0 ? mcs::packed_field(sc + static_cast<size_t>(a0) * n,
                                          nbr_idx, nbr_J, h, i, maxnb)
                      : 0.0f;
  const float f1 = h1 ? mcs::packed_field(sc + static_cast<size_t>(a1) * n,
                                          nbr_idx, nbr_J, h, i, maxnb)
                      : 0.0f;

  const uint32_t c_b = mcs::cluster_counter(seed_term, step, mcs::kBathBond);
  const uint32_t c_acc =
      mcs::cluster_counter(seed_term, step, mcs::kLineAccept);
  const uint32_t line = (gchain * n + idi) * P;
  float kval = 0.0f;
  int seed_slice = 0;
  if (!kFullSw) {
    const uint32_t c_seed =
        mcs::cluster_counter(seed_term, step, mcs::kLineSeed);
    seed_slice = mcs::index_draw(
        mcs::uniform01(c_seed, gchain * n + idi), P);
    kval = slice_of(s0, s1, seed_slice);
  }

  // the bath bonds of rows a0 and a1: pair (lo, hi) draws once
  unsigned long long r0 = 0ull, r1 = 0ull;
  for (int q = 0; q < P; ++q) {
    const float sq = slice_of(s0, s1, q);
    for (int half = 0; half < 2; ++half) {
      const int a = half ? a1 : a0;
      const float sa = half ? s1 : s0;
      if (!(half ? h1 : h0) || a == q) continue;
      const bool gate = kFullSw ? sa == sq : (sa == kval && sq == kval);
      if (!gate) continue;
      const int lo = a < q ? a : q, hi = a < q ? q : a;
      const float u = mcs::uniform01(
          c_b, (line + lo) * static_cast<uint32_t>(P) + hi);
      if (u < __ldg(p_pair + a * P + q)) {
        (half ? r1 : r0) |= 1ull << q;
      }
    }
  }

  if (!kFullSw) {
    // the slices the seed reaches along the (directed) rows
    unsigned long long reach = 1ull << seed_slice;
    for (;;) {
      const unsigned long long mine =
          (bit(reach, a0) ? r0 : 0ull) | (h1 && bit(reach, a1) ? r1 : 0ull);
      const unsigned long long next = reach | warp_or(mine);
      if (next == reach) break;
      reach = next;
    }
    const bool c0 = h0 && bit(reach, a0) && s0 == kval;
    const bool c1 = h1 && bit(reach, a1) && s1 == kval;
    const float t0 = c0 ? -s0 : s0, t1 = c1 ? -s1 : s1;
    // the next slice's t and s (ring), for the Trotter part
    const int n0 = a0 + 1 == P ? 0 : a0 + 1, n1 = a1 + 1 == P ? 0 : a1 + 1;
    const float tn0 = slice_of(t0, t1, n0), tn1 = slice_of(t0, t1, n1);
    const float sn0 = slice_of(s0, s1, n0), sn1 = slice_of(s0, s1, n1);
    const float lin = sum_in_order(__fmul_rn(f0, __fsub_rn(t0, s0)),
                                   __fmul_rn(f1, __fsub_rn(t1, s1)), P);
    const float tro = sum_in_order(
        __fsub_rn(__fmul_rn(t0, tn0), __fmul_rn(s0, sn0)),
        __fsub_rn(__fmul_rn(t1, tn1), __fmul_rn(s1, sn1)), P);
    const float de = __fsub_rn(__fmul_rn(b, lin), __fmul_rn(jp, tro));
    const float u = mcs::uniform01(
        c_acc, gchain * P * n + idi);
    if (mcs::metropolis_accept(de, teff, u)) {
      if (c0) sc[static_cast<size_t>(a0) * n + i] = t0;
      if (c1) sc[static_cast<size_t>(a1) * n + i] = t1;
    }
    return;
  }

  // WC3: the Trotter ring's bonds (a, a + 1), then the symmetrized closure
  const uint32_t c_t =
      mcs::cluster_counter(seed_term, step, mcs::kTrotterBond);
  const float pt = __ldg(pt_sched + t);
  const uint32_t row0 = gchain * P;
  const int n0 = a0 + 1 == P ? 0 : a0 + 1, n1 = a1 + 1 == P ? 0 : a1 + 1;
  const float sn0 = slice_of(s0, s1, n0), sn1 = slice_of(s0, s1, n1);
  if (h0 && s0 == sn0 &&
      mcs::uniform01(c_t, (row0 + a0) * n + idi) < pt) {
    r0 |= 1ull << n0;
  }
  if (h1 && s1 == sn1 &&
      mcs::uniform01(c_t, (row0 + a1) * n + idi) < pt) {
    r1 |= 1ull << n1;
  }
  unsigned long long t0r = r0, t1r = r1;  // adj | adj^T
  for (int q = 0; q < P; ++q) {
    const unsigned long long rq = row_of(r0, r1, q);
    if (h0 && bit(rq, a0)) t0r |= 1ull << q;
    if (h1 && bit(rq, a1)) t1r |= 1ull << q;
  }
  r0 = h0 ? t0r | (1ull << a0) : 0ull;
  r1 = h1 ? t1r | (1ull << a1) : 0ull;
  for (;;) {
    unsigned long long n0r = r0, n1r = r1;
    for (int q = 0; q < P; ++q) {
      const unsigned long long rq = row_of(r0, r1, q);
      if (bit(r0, q)) n0r |= rq;
      if (bit(r1, q)) n1r |= rq;
    }
    const bool changed = n0r != r0 || n1r != r1;
    r0 = n0r;
    r1 = n1r;
    if (!__any_sync(kFull, changed)) break;
  }
  // each slice's cluster energy, its members' -2 B f s in index order
  const float m2b = __fmul_rn(-2.0f, b);
  const float d0 = h0 ? __fmul_rn(__fmul_rn(m2b, f0), s0) : 0.0f;
  const float d1 = h1 ? __fmul_rn(__fmul_rn(m2b, f1), s1) : 0.0f;
  float e0 = 0.0f, e1 = 0.0f;
  for (int q = 0; q < P; ++q) {
    const float dq = slice_of(d0, d1, q);
    const float w0 = bit(r0, q) ? dq : 0.0f, w1 = bit(r1, q) ? dq : 0.0f;
    e0 = q == 0 ? w0 : __fadd_rn(e0, w0);
    e1 = q == 0 ? w1 : __fadd_rn(e1, w1);
  }
  if (h0) {
    const int rep = __ffsll(static_cast<long long>(r0)) - 1;
    if (mcs::metropolis_accept(
            e0, teff, mcs::uniform01(c_acc, (row0 + rep) * n + idi))) {
      sc[static_cast<size_t>(a0) * n + i] = -s0;
    }
  }
  if (h1) {
    const int rep = __ffsll(static_cast<long long>(r1)) - 1;
    if (mcs::metropolis_accept(
            e1, teff, mcs::uniform01(c_acc, (row0 + rep) * n + idi))) {
      sc[static_cast<size_t>(a1) * n + i] = -s1;
    }
  }
}

// Shared memory of one warp of fk_line_rows_kernel: rows (P W) and
// next rows (P W) and the reach and next reach (W each), 64-bit words;
// then spins, fields and cluster energies, P floats each, padded to a
// whole 64-bit word so the next warp's rows stay aligned.
__host__ __device__ __forceinline__ size_t line_wide_bytes(int P) {
  const size_t W = (P + 63) / 64;
  return (2 * P * W + 2 * W + (3 * static_cast<size_t>(P) + 1) / 2) * 8;
}

__device__ __forceinline__ bool bit_of(const unsigned long long* row, int q) {
  return (row[q >> 6] >> (q & 63)) & 1ull;
}

template <bool kFullSw>
__global__ void fk_line_rows_kernel(const int* __restrict__ nbr_idx,
                                    const float* __restrict__ nbr_J,
                                    const float* __restrict__ h,
                                    const int* __restrict__ perm,
                                    const int* __restrict__ starts,
                                    const float* __restrict__ b_sched,
                                    const float* __restrict__ jp_sched,
                                    const float* __restrict__ pt_sched,
                                    const float* __restrict__ p_pair,
                                    float teff, float* s, int P, int n,
                                    int maxnb, int t, int step, int color,
                                    int ncls, uint32_t seed_term,
                                    uint32_t chain0) {
  extern __shared__ unsigned long long line_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int li = blockIdx.x * (blockDim.x >> 5) + warp;
  if (li >= ncls) return;  // the whole warp
  const int W = (P + 63) >> 6;
  // this warp's line: rows, next rows, reach, next reach, then the floats
  unsigned long long* rows =
      line_smem + warp * (line_wide_bytes(P) / 8);
  unsigned long long* nrows = rows + P * W;
  unsigned long long* reach = nrows + P * W;
  unsigned long long* nreach = reach + W;
  float* sv = reinterpret_cast<float*>(nreach + W);
  float* fv = sv + P;
  float* dv = fv + P;
  const int chain = blockIdx.y;
  const uint32_t gchain = chain0 + static_cast<uint32_t>(chain);
  const int i = __ldg(starts + color) + li;
  const uint32_t idi = static_cast<uint32_t>(__ldg(perm + i));
  float* sc = s + static_cast<size_t>(chain) * P * n;
  const float b = __ldg(b_sched + t), jp = __ldg(jp_sched + t);
  for (int a = lane; a < P; a += 32) {
    sv[a] = sc[static_cast<size_t>(a) * n + i];
    fv[a] = mcs::packed_field(sc + static_cast<size_t>(a) * n, nbr_idx,
                              nbr_J, h, i, maxnb);
  }
  for (int x = lane; x < P * W; x += 32) rows[x] = 0ull;
  __syncwarp();

  const uint32_t c_b = mcs::cluster_counter(seed_term, step, mcs::kBathBond);
  const uint32_t c_acc =
      mcs::cluster_counter(seed_term, step, mcs::kLineAccept);
  const uint32_t line = (gchain * n + idi) * P;
  float kval = 0.0f;
  int seed_slice = 0;
  if (!kFullSw) {
    const uint32_t c_seed =
        mcs::cluster_counter(seed_term, step, mcs::kLineSeed);
    seed_slice = mcs::index_draw(mcs::uniform01(c_seed, gchain * n + idi), P);
    kval = sv[seed_slice];
  }
  // the bath bonds of this lane's rows: pair (lo, hi) draws once
  for (int a = lane; a < P; a += 32) {
    const float sa = sv[a];
    unsigned long long* ra = rows + a * W;
    for (int q = 0; q < P; ++q) {
      const float sq = sv[q];
      if (a == q) continue;
      const bool gate = kFullSw ? sa == sq : (sa == kval && sq == kval);
      if (!gate) continue;
      const int lo = a < q ? a : q, hi = a < q ? q : a;
      const float u = mcs::uniform01(
          c_b, (line + lo) * static_cast<uint32_t>(P) + hi);
      if (u < __ldg(p_pair + a * P + q)) ra[q >> 6] |= 1ull << (q & 63);
    }
  }
  __syncwarp();

  if (!kFullSw) {
    // the slices the seed reaches along the (directed) rows
    for (int w = lane; w < W; w += 32)
      reach[w] = w == (seed_slice >> 6) ? 1ull << (seed_slice & 63) : 0ull;
    __syncwarp();
    for (;;) {
      bool changed = false;
      for (int w = 0; w < W; ++w) {
        unsigned long long mine = 0ull;
        for (int a = lane; a < P; a += 32)
          if (bit_of(reach, a)) mine |= rows[a * W + w];
        const unsigned long long next = reach[w] | warp_or(mine);
        changed |= next != reach[w];
        if (lane == 0) nreach[w] = next;
      }
      __syncwarp();
      if (!changed) break;  // the same on every lane
      unsigned long long* tmp = reach;
      reach = nreach;
      nreach = tmp;
    }
    // the set flip t = -s on the reached slices of the seed's sign, and
    // its non-bath energy, each sum in index order
    auto flipped = [&](int a) {
      return bit_of(reach, a) && sv[a] == kval ? -sv[a] : sv[a];
    };
    float lin = 0.0f, tro = 0.0f;
    for (int a = 0; a < P; ++a) {
      const int an = a + 1 == P ? 0 : a + 1;
      const float ta = flipped(a), tn = flipped(an);
      const float l = __fmul_rn(fv[a], __fsub_rn(ta, sv[a]));
      const float r = __fsub_rn(__fmul_rn(ta, tn), __fmul_rn(sv[a], sv[an]));
      lin = a == 0 ? l : __fadd_rn(lin, l);
      tro = a == 0 ? r : __fadd_rn(tro, r);
    }
    const float de = __fsub_rn(__fmul_rn(b, lin), __fmul_rn(jp, tro));
    const float u = mcs::uniform01(c_acc, gchain * P * n + idi);
    if (mcs::metropolis_accept(de, teff, u)) {
      for (int a = lane; a < P; a += 32)
        if (bit_of(reach, a) && sv[a] == kval)
          sc[static_cast<size_t>(a) * n + i] = -sv[a];
    }
    return;
  }

  // WC3: the Trotter ring's bonds (a, a + 1), then the symmetrized closure
  const uint32_t c_t =
      mcs::cluster_counter(seed_term, step, mcs::kTrotterBond);
  const float pt = __ldg(pt_sched + t);
  const uint32_t row0 = gchain * P;
  for (int a = lane; a < P; a += 32) {
    const int an = a + 1 == P ? 0 : a + 1;
    if (sv[a] == sv[an] && mcs::uniform01(c_t, (row0 + a) * n + idi) < pt)
      rows[a * W + (an >> 6)] |= 1ull << (an & 63);
  }
  __syncwarp();
  // adj | adj^T | self into nrows
  for (int a = lane; a < P; a += 32) {
    unsigned long long* na = nrows + a * W;
    for (int w = 0; w < W; ++w) na[w] = rows[a * W + w];
    na[a >> 6] |= 1ull << (a & 63);
    for (int q = 0; q < P; ++q)
      if (bit_of(rows + q * W, a)) na[q >> 6] |= 1ull << (q & 63);
  }
  __syncwarp();
  unsigned long long* cur = nrows;
  unsigned long long* nxt = rows;
  for (;;) {
    bool changed = false;
    for (int a = lane; a < P; a += 32) {
      const unsigned long long* ca = cur + a * W;
      unsigned long long* xa = nxt + a * W;
      for (int w = 0; w < W; ++w) xa[w] = ca[w];
      for (int q = 0; q < P; ++q) {
        if (!bit_of(ca, q)) continue;
        for (int w = 0; w < W; ++w) xa[w] |= cur[q * W + w];
      }
      for (int w = 0; w < W; ++w) changed |= xa[w] != ca[w];
    }
    __syncwarp();
    unsigned long long* tmp = cur;
    cur = nxt;
    nxt = tmp;
    if (!__any_sync(kFull, changed)) break;
  }
  // each slice's cluster energy, its members' -2 B f s in index order
  const float m2b = __fmul_rn(-2.0f, b);
  for (int a = lane; a < P; a += 32)
    dv[a] = __fmul_rn(__fmul_rn(m2b, fv[a]), sv[a]);
  __syncwarp();
  for (int a = lane; a < P; a += 32) {
    const unsigned long long* ra = cur + a * W;
    float e = 0.0f;
    for (int q = 0; q < P; ++q) {
      const float w = bit_of(ra, q) ? dv[q] : 0.0f;
      e = q == 0 ? w : __fadd_rn(e, w);
    }
    int rep = 0;
    for (int w = 0; w < W; ++w) {
      if (ra[w]) {
        rep = 64 * w + __ffsll(static_cast<long long>(ra[w])) - 1;
        break;
      }
    }
    if (mcs::metropolis_accept(
            e, teff, mcs::uniform01(c_acc, (row0 + rep) * n + idi))) {
      sc[static_cast<size_t>(a) * n + i] = -sv[a];
    }
  }
}

// ----------------------------------------------- the cluster kernel, P <= 64

namespace cg = cooperative_groups;

// at most this many threads a CTA (ops/cluster_kernels.py::LINE_THREADS),
// one warp a line; the head of the dynamic shared memory holds the R <= 16
// CTAs' word pointers (LINE_HEAD_BYTES); each warp's scratch
// (LINE_WARP_BYTES): 64 rows (WC2; WC3 the member masks of the second
// half's slices), 64 union-find parents (WC3), 64 floats (the energies d,
// or the fields f), 64 accept bytes
constexpr int kLineThreads = 1024;
constexpr int kLineHeadBytes = 16 * sizeof(unsigned long long*);
constexpr int kLineWarpBytes = 64 * 8 + 64 * 4 + 64 * 4 + 64;

// Shared memory of one CTA: the head, the words of its nr slots (twice on
// a packing that is not proper: the phase's snapshot beside them), the
// warps' scratch, and the bonds' thresholds, P x P uint32
// (ops/cluster_kernels.py::line_smem_bytes)
__host__ __device__ __forceinline__ size_t line_smem_bytes(int P, int nr,
                                                           int warps,
                                                           int improper) {
  return kLineHeadBytes + static_cast<size_t>(nr) * 8 * (improper ? 2 : 1) +
         static_cast<size_t>(warps) * kLineWarpBytes +
         static_cast<size_t>(P) * P * 4;
}

// The threshold of probability p in [0, 1]: uniform24(bits) < p holds
// exactly when bits >> 8 < ceil(p 2^24) (bits >> 8 is an integer, and
// p 2^24 is exact), so a draw compares its integer bits, not a float
__device__ __forceinline__ uint32_t threshold24(float p) {
  return static_cast<uint32_t>(ceilf(p * 16777216.0f));
}

// w * s for the spin s of bit k of a line word (bit set: s = -1): w with
// its sign bit flipped, exactly __fmul_rn(w, s)
__device__ __forceinline__ float signed_by64(float w, unsigned long long x,
                                             int k) {
  return __uint_as_float(__float_as_uint(w) ^
                         (static_cast<uint32_t>((x >> k) & 1ull) << 31));
}

// the spin of bit k
__device__ __forceinline__ float spin64(unsigned long long x, int k) {
  return (x >> k) & 1ull ? -1.0f : 1.0f;
}

// The first slice of slice a's run of Trotter links: links bit q joins
// slices q and q + 1 (the ring's link P - 1 not counted)
__device__ __forceinline__ int run_start(unsigned long long links, int a) {
  const unsigned long long gaps = ~links & ((1ull << a) - 1ull);
  return gaps ? 64 - __clzll(static_cast<long long>(gaps)) : 0;
}

template <bool kFullSw>
__global__ void __launch_bounds__(kLineThreads, 1)
fk_line_cluster_kernel(
    const int* __restrict__ slot_starts, const int* __restrict__ starts,
    const int* __restrict__ nbr_loc, const float* __restrict__ nbr_J,
    const float* __restrict__ h, const int* __restrict__ perm,
    const float* __restrict__ b_sched, const float* __restrict__ jp_sched,
    const float* __restrict__ pt_sched, const float* __restrict__ p_pair,
    float teff, const float* __restrict__ s_in, float* __restrict__ s_out,
    int P, int n, int maxnb, int R, int nr, int t0, int step0, int steps,
    int c_lo, int c_hi, uint32_t seed_term, int improper, uint32_t chain0) {
  extern __shared__ __align__(16) unsigned char line_cl_smem[];
  unsigned long long** const peers =
      reinterpret_cast<unsigned long long**>(line_cl_smem);
  unsigned long long* const words =
      reinterpret_cast<unsigned long long*>(line_cl_smem + kLineHeadBytes);
  unsigned long long* const snap = words + nr;  // only when improper
  unsigned char* const scratch = reinterpret_cast<unsigned char*>(
      words + static_cast<size_t>(nr) * (improper ? 2 : 1));
  const int nwarps = blockDim.x >> 5;
  // the bonds' thresholds (threshold24): WC2 thr[a P + b] the bond a -> b
  // of p_pair[a][b]; WC3 thr[lo P + hi], lo < hi, the pair's bond either
  // way
  uint32_t* const thr = reinterpret_cast<uint32_t*>(
      scratch + static_cast<size_t>(nwarps) * kLineWarpBytes);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // lane L's bath pairs are the L-th of 32 equal runs of the P (P - 1) / 2
  // pairs in row-major order (lo, lo + 1 .. P - 1): its first pair (lo0,
  // hi0) and its count
  const int npairs = P * (P - 1) / 2;
  const int q0 = lane * npairs / 32, nq = (lane + 1) * npairs / 32 - q0;
  int lo0 = 0;
  while ((lo0 + 1) * (2 * P - lo0 - 2) / 2 <= q0) ++lo0;
  const int hi0 = lo0 + 1 + q0 - lo0 * (2 * P - lo0 - 1) / 2;
  unsigned char* const ws =
      scratch + static_cast<size_t>(warp) * kLineWarpBytes;
  unsigned long long* const rows = reinterpret_cast<unsigned long long*>(ws);
  int* const parent = reinterpret_cast<int*>(ws + 64 * 8);
  float* const fd = reinterpret_cast<float*>(ws + 64 * 12);
  unsigned char* const acc = ws + 64 * 16;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = R > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const int chain = static_cast<int>(blockIdx.x) / R;
  const uint32_t gchain = chain0 + static_cast<uint32_t>(chain);
  const size_t base = static_cast<size_t>(chain) * P * n;
  const unsigned long long pmask = P == 64 ? ~0ull : (1ull << P) - 1ull;

  if (static_cast<int>(threadIdx.x) < R)
    peers[threadIdx.x] = R > 1 ? cluster.map_shared_rank(words, threadIdx.x)
                               : words;
  for (int x = threadIdx.x; x < P * P; x += blockDim.x) {
    const int a = x / P, c = x - a * P;
    const float pf = __ldg(p_pair + x);
    // u < p[a][c] || u < p[c][a] is u < max(p[a][c], p[c][a])
    thr[x] = threshold24(kFullSw ? fmaxf(pf, __ldg(p_pair + c * P + a)) : pf);
  }
  // the own slots' words from the float state: slot l of class c is packed
  // site starts[c] + rank * chunk + (l - slot_starts[c])
  {
    int c = 0;
    for (int l = threadIdx.x; l < nr; l += blockDim.x) {
      while (l >= __ldg(slot_starts + c + 1)) ++c;
      const int lo = __ldg(slot_starts + c), chunk =
          __ldg(slot_starts + c + 1) - lo;
      const int i = __ldg(starts + c) + rank * chunk + (l - lo);
      unsigned long long x = 0ull;
      if (i < __ldg(starts + c + 1)) {
        for (int k = 0; k < P; ++k)
          if (s_in[base + static_cast<size_t>(k) * n + i] < 0.0f)
            x |= 1ull << k;
      }
      words[l] = x;
    }
  }
  cluster.sync();  // every CTA's words and head

  const uint32_t row0 = gchain * static_cast<uint32_t>(P);
  for (int tt = 0; tt < steps; ++tt) {
    const int t = t0 + tt, step = step0 + tt;
    const float b = __ldg(b_sched + t), jp = __ldg(jp_sched + t);
    const float pt = kFullSw ? __ldg(pt_sched + t) : 0.0f;
    const float m2b = __fmul_rn(-2.0f, b);
    const uint32_t c_b =
        mcs::cluster_counter(seed_term, step, mcs::kBathBond);
    const uint32_t c_acc =
        mcs::cluster_counter(seed_term, step, mcs::kLineAccept);
    const uint32_t c_t =
        mcs::cluster_counter(seed_term, step, mcs::kTrotterBond);
    const uint32_t c_seed =
        mcs::cluster_counter(seed_term, step, mcs::kLineSeed);
    for (int c = c_lo; c < c_hi; ++c) {
      if (improper) {
        // the last barrier ended every read of the snapshot
        for (int l = threadIdx.x; l < nr; l += blockDim.x) snap[l] = words[l];
        cluster.sync();
      }
      const int slo = __ldg(slot_starts + c);
      const int chunk = __ldg(slot_starts + c + 1) - slo;
      const int s0 = __ldg(starts + c) + rank * chunk;
      const int m = max(0, min(chunk, __ldg(starts + c + 1) - s0));
      const int roff = improper ? nr : 0;  // neighbours from the snapshot
      for (int l = warp; l < m; l += nwarps) {
        const int i = s0 + l;
        const uint32_t idi = static_cast<uint32_t>(__ldg(perm + i));
        const unsigned long long w = words[slo + l];
        // the fields of slices a0 = lane and a1 = lane + 32
        const int a0 = lane, a1 = lane + 32;
        const bool h0 = a0 < P, h1 = a1 < P;
        float f0 = 0.0f, f1 = 0.0f;
        {
          const int* ri = nbr_loc + static_cast<size_t>(i) * maxnb;
          const float* rj = nbr_J + static_cast<size_t>(i) * maxnb;
          for (int k = 0; k < maxnb; ++k) {
            const int loc = __ldg(ri + k);
            const float J = __ldg(rj + k);
            const unsigned long long x = peers[loc >> 16][roff + (loc & 0xffff)];
            const float g0 = signed_by64(J, x, a0 & 63);
            const float g1 = signed_by64(J, x, a1 & 63);
            f0 = k == 0 ? g0 : __fadd_rn(f0, g0);
            f1 = k == 0 ? g1 : __fadd_rn(f1, g1);
          }
          const float hi_ = __ldg(h + i);
          f0 = __fadd_rn(f0, hi_);
          f1 = __fadd_rn(f1, hi_);
        }
        const uint32_t line = (gchain * n + idi) * static_cast<uint32_t>(P);
        // the lane's run of bath pairs, each hashed once at uid (line + lo)
        // P + hi, in order, and `bond` called on the pairs whose slices pass
        // `gate` (a slice mask for each row lo: the slices hi that may bond
        // to it); every lane hashes as many pairs, whichever pass
        auto bath_pairs = [&](auto gate, auto bond) {
          int lo = lo0, hi = hi0;
          uint32_t uid = (line + lo) * static_cast<uint32_t>(P) + hi;
          unsigned long long g = gate(lo);
#pragma unroll 2
          for (int k = 0; k < nq; ++k) {
            const uint32_t bits = mcs::mix32(uid * mcs::kGolden + c_b) >> 8;
            if ((g >> hi) & 1ull) bond(lo, hi, bits);
            ++uid;
            if (++hi == P) {
              ++lo;
              hi = lo + 1;
              uid = (line + lo) * static_cast<uint32_t>(P) + hi;
              g = gate(lo);
            }
          }
        };
        unsigned long long flip = 0ull;
        if (kFullSw) {
          // WC3: the Trotter links (a, a + 1) as bits, each slice's parent
          // the first slice of its run of links (no union), the ring's
          // link P - 1 and the bath bonds united
          bool l0 = false, l1 = false;
          for (int half = 0; half < 2; ++half) {
            const int a = half ? a1 : a0;
            if (!(half ? h1 : h0)) continue;
            const int an = a + 1 == P ? 0 : a + 1;
            const bool link =
                ((w >> a) & 1ull) == ((w >> an) & 1ull) &&
                mcs::uniform01(c_t, (row0 + a) * n + idi) < pt;
            (half ? l1 : l0) = link;
          }
          const unsigned long long links =
              static_cast<unsigned long long>(__ballot_sync(0xffffffffu, l0)) |
              (static_cast<unsigned long long>(__ballot_sync(0xffffffffu, l1))
               << 32);
          // the warp's union-find of the line's slices (fk.cuh)
          const mcs::SharedSets sets{static_cast<uint32_t>(
              __cvta_generic_to_shared(parent))};
          if (h0) {
            parent[a0] = run_start(links, a0);
            fd[a0] = __fmul_rn(__fmul_rn(m2b, f0), spin64(w, a0));
          }
          if (h1) {
            parent[a1] = run_start(links, a1);
            fd[a1] = __fmul_rn(__fmul_rn(m2b, f1), spin64(w, a1));
          }
          __syncwarp();
          if (lane == 0 && ((links >> (P - 1)) & 1ull)) sets.unite(P - 1, 0);
          // a bath pair of equal spins bonds either way
          bath_pairs(
              [&](int lo) { return (w >> lo) & 1ull ? w : ~w; },
              [&](int lo, int hi, uint32_t bits) {
                if (bits < thr[lo * P + hi]) sets.unite(lo, hi);
              });
          __syncwarp();
          // each slice's root, its cluster's least slice, and each root's
          // members: slices lane with root r0 and lane + 32 with root r1
          // match across the warp; a group of the second half whose root
          // lies in the first leaves its lanes for that root's lane
          const int r0 = h0 ? sets.find(a0) : -1;
          const int r1 = h1 ? sets.find(a1) : -1 - lane;
          const unsigned m0 = __match_any_sync(0xffffffffu, r0);
          const unsigned m1 = __match_any_sync(0xffffffffu, r1);
          uint32_t* const upper = reinterpret_cast<uint32_t*>(rows);
          upper[lane] = 0u;
          __syncwarp();
          if (h1 && r1 < 32 && (m1 & ((1u << lane) - 1u)) == 0u)
            upper[r1] = m1;
          __syncwarp();
          // each root's cluster energy, its members' -2 B f s in index
          // order from the root (its least member), then its accept on the
          // uniform of the root
          for (int half = 0; half < 2; ++half) {
            const int a = half ? a1 : a0;
            if ((half ? r1 : r0) != a) continue;
            unsigned long long mem =
                half ? static_cast<unsigned long long>(m1) << 32
                     : m0 | static_cast<unsigned long long>(upper[a]) << 32;
            float e = fd[a];
            mem &= mem - 1ull;
            while (mem) {
              e = __fadd_rn(e, fd[__ffsll(static_cast<long long>(mem)) - 1]);
              mem &= mem - 1ull;
            }
            acc[a] = mcs::metropolis_accept(
                e, teff, mcs::uniform01(c_acc, (row0 + a) * n + idi));
          }
          __syncwarp();
          const unsigned lo32 = __ballot_sync(0xffffffffu, h0 && acc[r0]);
          const unsigned hi32 = __ballot_sync(0xffffffffu, h1 && acc[r1]);
          flip = (static_cast<unsigned long long>(hi32) << 32) | lo32;
        } else {
          // WC2: the seed slice, the bonds between slices of its sign as
          // directed rows, the seed's reach
          const int seed_slice = mcs::index_draw(
              mcs::uniform01(c_seed, gchain * n + idi), P);
          const unsigned long long same =
              ((w >> seed_slice) & 1ull ? w : ~w) & pmask;
          if (h0) {
            rows[a0] = 0ull;
            fd[a0] = f0;
          }
          if (h1) {
            rows[a1] = 0ull;
            fd[a1] = f1;
          }
          __syncwarp();
          // a bath pair of two slices of the seed's sign bonds each way
          // on its own probability
          bath_pairs(
              [&](int lo) { return (same >> lo) & 1ull ? same : 0ull; },
              [&](int lo, int hi, uint32_t bits) {
                if (bits < thr[lo * P + hi]) atomicOr(rows + lo, 1ull << hi);
                if (bits < thr[hi * P + lo]) atomicOr(rows + hi, 1ull << lo);
              });
          __syncwarp();
          const unsigned long long rw0 = h0 ? rows[a0] : 0ull;
          const unsigned long long rw1 = h1 ? rows[a1] : 0ull;
          unsigned long long reach = 1ull << seed_slice;
          for (;;) {
            const unsigned long long mine = (bit(reach, a0 & 63) ? rw0 : 0ull) |
                                            (h1 && bit(reach, a1 & 63) ? rw1
                                                                       : 0ull);
            const unsigned long long next = reach | warp_or(mine);
            if (next == reach) break;
            reach = next;
          }
          const unsigned long long comp = reach & same;
          if (lane == 0) {
            // B sum_k f_k (t_k - s_k) over the flipped slices in index
            // order, J_perp times the ring's exact change 2 (d_s - d_t)
            unsigned long long mem = comp;
            float lin = 0.0f;
            bool first = true;
            while (mem) {
              const int q = __ffsll(static_cast<long long>(mem)) - 1;
              const float sq = spin64(w, q);
              const float term = __fmul_rn(fd[q], __fsub_rn(-sq, sq));
              lin = first ? term : __fadd_rn(lin, term);
              first = false;
              mem &= mem - 1ull;
            }
            const unsigned long long tw = w ^ comp;
            auto ring_changes = [&](unsigned long long x) {
              const unsigned long long rot =
                  ((x >> 1) | ((x & 1ull) << (P - 1))) & pmask;
              return __popcll((x ^ rot) & pmask);
            };
            const float tro =
                static_cast<float>(2 * (ring_changes(w) - ring_changes(tw)));
            const float de = __fsub_rn(__fmul_rn(b, lin), __fmul_rn(jp, tro));
            const float u = mcs::uniform01(c_acc, gchain * P * n + idi);
            acc[0] = mcs::metropolis_accept(de, teff, u);
          }
          __syncwarp();
          flip = acc[0] ? comp : 0ull;
        }
        if (lane == 0) words[slo + l] = w ^ flip;
        __syncwarp();  // the scratch is free for the warp's next line
      }
      cluster.sync();  // the phase's words land before the next reads them
    }
  }

  // the words back to floats
  {
    int c = 0;
    for (int l = threadIdx.x; l < nr; l += blockDim.x) {
      while (l >= __ldg(slot_starts + c + 1)) ++c;
      const int lo = __ldg(slot_starts + c), chunk =
          __ldg(slot_starts + c + 1) - lo;
      const int i = __ldg(starts + c) + rank * chunk + (l - lo);
      if (i >= __ldg(starts + c + 1)) continue;
      const unsigned long long x = words[l];
      for (int k = 0; k < P; ++k)
        s_out[base + static_cast<size_t>(k) * n + i] = spin64(x, k);
    }
  }
}

template <bool kFullSw>
cudaError_t launch_line_cluster(int chains, int R, int threads, size_t smem,
                                cudaStream_t stream,
                                const int* slot_starts, const int* starts,
                                const int* nbr_loc, const float* nbr_J,
                                const float* h, const int* perm,
                                const float* b_sched, const float* jp,
                                const float* p_t, const float* p_pair,
                                float teff, const float* s_in, float* s_out,
                                int P, int n, int maxnb, int nr, int t0,
                                int step0, int steps, int c_lo, int c_hi,
                                uint32_t seed_term, int improper,
                                uint32_t chain0) {
  auto kernel = fk_line_cluster_kernel<kFullSw>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = mcs::cluster_config(kernel, chains * R, R, threads, smem,
                                      stream, &cfg, &attr);
  if (e != cudaSuccess) return e;
  return cudaLaunchKernelEx(&cfg, kernel, slot_starts, starts, nbr_loc,
                            nbr_J, h, perm, b_sched, jp, p_t, p_pair, teff,
                            s_in, s_out, P, n, maxnb, R, nr, t0, step0,
                            steps, c_lo, c_hi, seed_term, improper, chain0);
}

}  // namespace

// One line phase on the per-phase kernels: every line of color class
// `color` (ncls lines from starts[color]) of chains x (P, n) packed spins
// `s`, in place (P <= 64 fk_line_wide_kernel, one warp a line with its
// rows in registers; P > 64 fk_line_rows_kernel, P <= 921), at schedule
// index t (b_sched, jp, p_t) and T_eff `teff`, on the draws of hash step
// `step`; p_pair (P, P) the bath pairs' probabilities;
// per_slice_seeds != 0 for WC3 (sw_full_phase), else WC2
// (bath_cluster_phase); chain0 the global index of the first chain, which
// keys the draws (a chain shard; 0 unsharded). `warps` lines a CTA. All
// device pointers; launches on `stream` and returns cudaGetLastError().
extern "C" int fk_line_phase(const int* nbr_idx, const float* nbr_J,
                             const float* h, const int* perm,
                             const int* starts, const float* b_sched,
                             const float* jp, const float* p_t,
                             const float* p_pair, float teff, float* s,
                             int chains, int P, int n, int maxnb, int t,
                             int step, int color, int ncls, int seed,
                             int per_slice_seeds, int warps, int chain0,
                             void* stream) {
  if (chains == 0 || ncls == 0 || P == 0) return cudaSuccess;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P <= 64) {
    const dim3 grid((ncls + warps - 1) / warps, chains);
    auto kernel = per_slice_seeds ? fk_line_wide_kernel<true>
                                  : fk_line_wide_kernel<false>;
    kernel<<<grid, 32 * warps, 0, st>>>(
        nbr_idx, nbr_J, h, perm, starts, b_sched, jp, p_t, p_pair, teff, s,
        P, n, maxnb, t, step, color, ncls, seed_term,
        static_cast<uint32_t>(chain0));
    return cudaGetLastError();
  }
  // `warps` lines a CTA, each with line_wide_bytes(P) of shared memory
  const size_t smem = line_wide_bytes(P) * warps;
  auto kernel = per_slice_seeds ? fk_line_rows_kernel<true>
                                : fk_line_rows_kernel<false>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((ncls + warps - 1) / warps, chains);
  kernel<<<grid, 32 * warps, smem, st>>>(
      nbr_idx, nbr_J, h, perm, starts, b_sched, jp, p_t, p_pair, teff, s, P,
      n, maxnb, t, step, color, ncls, seed_term,
      static_cast<uint32_t>(chain0));
  return cudaGetLastError();
}

// The cluster kernel (P <= 64): the line phases of classes [c_lo, c_hi)
// of the steps t0 .. t0 + steps - 1 (schedule index t, hash step step0 +
// t - t0) of chains x (P, n) packed spins s_in into s_out, in one launch
// of chains clusters of R CTAs of `threads` threads, on generic PIQMC's
// slot layout (ops/generic_kernels.py::word_layout): slot_starts (ncolors
// + 1), class c's first slot; starts (ncolors + 1), its first packed site;
// nbr_loc (n, maxnb), each neighbour's (CTA << 16) | slot; nr, the slots a
// CTA. nbr_J, h, perm, the schedules, p_pair, teff, seed, per_slice_seeds
// and chain0 as for fk_line_phase; improper != 0 for a packing that is
// not proper (each phase reads the neighbours' words as it began). All
// device pointers; launches on `stream` and returns cudaGetLastError().
extern "C" int fk_line_anneal(const int* slot_starts, const int* starts,
                              const int* nbr_loc, const float* nbr_J,
                              const float* h, const int* perm,
                              const float* b_sched, const float* jp,
                              const float* p_t, const float* p_pair,
                              float teff, const float* s_in, float* s_out,
                              int chains, int P, int n, int maxnb, int R,
                              int nr, int threads, int t0, int step0,
                              int steps, int c_lo, int c_hi, int seed,
                              int per_slice_seeds, int improper, int chain0,
                              void* stream) {
  if (chains == 0 || n == 0 || P == 0) return cudaSuccess;
  if (P < 2 || P > 64 || R < 1 || R > 16 || nr > 65536 ||
      threads > kLineThreads || threads % 32 != 0 || c_lo < 0 ||
      c_hi < c_lo) {
    return cudaErrorInvalidValue;
  }
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  const size_t smem = line_smem_bytes(P, nr, threads / 32, improper);
  auto go = per_slice_seeds ? launch_line_cluster<true>
                            : launch_line_cluster<false>;
  cudaError_t e = go(chains, R, threads, smem,
                     static_cast<cudaStream_t>(stream), slot_starts, starts,
                     nbr_loc, nbr_J, h, perm, b_sched, jp, p_t, p_pair, teff,
                     s_in, s_out, P, n, maxnb, nr, t0, step0, steps, c_lo,
                     c_hi, seed_term, improper, static_cast<uint32_t>(chain0));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Clusters of R CTAs of `threads` threads of the cluster kernel (WC3 with
// per_slice_seeds, else WC2) the card holds at once at P slices and nr
// slots a CTA
extern "C" int fk_line_max_active_clusters(int P, int nr, int R, int threads,
                                           int improper, int per_slice_seeds,
                                           int* count) {
  const size_t smem = line_smem_bytes(P, nr, threads / 32, improper);
  auto kernel = per_slice_seeds ? fk_line_cluster_kernel<true>
                                : fk_line_cluster_kernel<false>;
  return mcs::max_active_clusters(kernel, R, threads, smem, count);
}

extern "C" const char* fk_line_phase_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
