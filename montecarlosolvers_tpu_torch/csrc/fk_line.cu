// Imaginary-time line clusters of the bath: one color phase of
// bath_cluster_phase (WC2) or sw_full_phase (WC3) in one launch.
//
// Replaces no TPU kernel: the JAX package runs this as XLA,
// montecarlosolvers_tpu/ops/cluster.py::bath_cluster_phase (:316) and
// sw_full_phase (:363), which draw an (N, P, P) bond tensor and close it
// by log2(P) batched boolean matrix squarings (_time_closure :281). Plain
// PyTorch version: ops/cluster.py::line_phase_ref.
//
// What it computes. For every spin line i of color class `color` (the
// block [starts[color], starts[color + 1]) of the packed layout), on the
// draws of hash step `step` at B = b_sched[t], J_perp = jp[t], T_eff:
//   WC2: the line's seed slice (floor(u P)), its bath bonds between slices
//        of the seed's sign (p_pair[a][b], the host's 1 - exp(-2 lut)), the
//        slices the seed reaches along them, and one Metropolis accept of
//        the set-flip energy of the non-bath terms,
//        B sum_k f_k (t_k - s_k) - J_perp sum_k (t_k t_k+1 - s_k s_k+1);
//   WC3: bath bonds between equal spins and Trotter bonds (k, k + 1) with
//        probability p_t[t], symmetrized, closed, and every cluster
//        accepted on its own field energy sum_j in cluster (-2 B f_j s_j)
//        with the uniform of its least slice.
// The spatial neighbours are other classes' and stay fixed in the phase.
// The sums over the slices are added in index order, as the plain version
// (piqmc.sum_in_order) and XLA's loop add them.
//
// What bounds it on an H100. A line draws P (P - 1) / 2 bath pairs (each
// lane hashes its own rows, so twice), P Trotter bonds and computes P
// fields; the bound counts the pair draws' comparisons, the fields and the
// accepts (exponentials are the host's table).
//
// What the design does about that, simply (a first kernel): one warp a
// line, lane k holding slices k and k + 32 (P <= 64), the line's P x P
// adjacency as one 64-bit row a slice in registers, reachability by OR-ing
// rows over warp shuffles until nothing changes; one launch a color phase.
// No fast math.
#include <cuda_runtime.h>
#include <stdint.h>

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
__global__ void fk_line_kernel(const int* __restrict__ nbr_idx,
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
                               uint32_t seed_term) {
  const int lane = threadIdx.x & 31;
  const int li = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (li >= ncls) return;  // the whole warp
  const int chain = blockIdx.y;
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
  const uint32_t line = (static_cast<uint32_t>(chain) * n + idi) * P;
  float kval = 0.0f;
  int seed_slice = 0;
  if (!kFullSw) {
    const uint32_t c_seed =
        mcs::cluster_counter(seed_term, step, mcs::kLineSeed);
    seed_slice = mcs::index_draw(
        mcs::uniform01(c_seed, static_cast<uint32_t>(chain) * n + idi), P);
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
        c_acc, static_cast<uint32_t>(chain) * P * n + idi);
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
  const uint32_t row0 = static_cast<uint32_t>(chain) * P;
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

}  // namespace

// One line phase: every line of color class `color` (ncls lines from
// starts[color]) of chains x (P, n) packed spins `s`, in place, P <= 64,
// at schedule index t (b_sched, jp, p_t) and T_eff `teff`, on the draws of
// hash step `step`; p_pair (P, P) the bath pairs' probabilities;
// per_slice_seeds != 0 for WC3 (sw_full_phase), else WC2
// (bath_cluster_phase). `warps` lines a CTA. All device pointers; launches
// on `stream` and returns cudaGetLastError().
extern "C" int fk_line_phase(const int* nbr_idx, const float* nbr_J,
                             const float* h, const int* perm,
                             const int* starts, const float* b_sched,
                             const float* jp, const float* p_t,
                             const float* p_pair, float teff, float* s,
                             int chains, int P, int n, int maxnb, int t,
                             int step, int color, int ncls, int seed,
                             int per_slice_seeds, int warps, void* stream) {
  if (chains == 0 || ncls == 0 || P == 0) return cudaSuccess;
  if (P > 64) return cudaErrorInvalidValue;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  const dim3 grid((ncls + warps - 1) / warps, chains);
  auto kernel = per_slice_seeds ? fk_line_kernel<true>
                                : fk_line_kernel<false>;
  kernel<<<grid, 32 * warps, 0, static_cast<cudaStream_t>(stream)>>>(
      nbr_idx, nbr_J, h, perm, starts, b_sched, jp, p_t, p_pair, teff, s, P,
      n, maxnb, t, step, color, ncls, seed_term);
  return cudaGetLastError();
}

extern "C" const char* fk_line_phase_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
