// The shard kernels of the Trotter-sharded cluster engines
// (parallel/trotter.py::anneal_wolff_sharded, anneal_sw_sharded): S6, a
// round of the Wolff cluster on a rank's rows, and S7, the Swendsen-Wang
// labels of a rank's rows.
//
// Replace no TPU kernel: the JAX package runs these engines as XLA inside
// shard_map, montecarlosolvers_tpu/parallel/trotter.py::
// _wolff_sharded_update (:500-626, a frontier BFS with a ppermute of the
// boundary rows and, with the bath, an all_gather of the frontier each
// iteration) and _spacetime_sw_sharded_sweep (:689-791, a min-label
// relaxation with the same halo each round). Plain PyTorch versions:
// ops/cluster.py::wolff_shard_round_ref, wolff_shard_sums_ref,
// wolff_shard_flip_ref (S6) and sw_shard_init_ref, sw_shard_round_ref,
// sw_shard_flip_ref (S7), on the bonds of wolff_shard_bonds /
// sw_shard_bonds.
//
// What they compute. A rank owns rows k0 .. k0 + Ps - 1 of one (P, n)
// chain of packed spins (packed.cuh), P = R * Ps; `up` and `dn` are rows
// k0 - 1 and k0 + Ps (from the ring exchange; on a ring of one rank, rows
// Ps - 1 and 0 of the block itself), `full` every rank's rows (with a
// bath). Every bond is the single-device kernels' (fk_wolff.cu,
// fk_label.cu): the same probabilities from the same rounding, the same
// counter-hash uniform at the same global uid, chain 0.
// - S6 (fk_shard_wolff_kernel), three modes a launch:
//   round: grow the cluster in the block to its fixed point from this
//     round's frontier: the seed (seed_x >= 0), the last-row sites the next
//     rank reached (in_next), the first-row sites whose Trotter bond to the
//     previous rank's last-row sites visited in its last round (in_prev)
//     holds, and, with a bath, the sites a bath bond pulls from another
//     rank's sites visited in its last round (full_fresh, every rank's
//     fresh bits gathered). A Trotter bond is drawn by the rank that owns
//     its upper slice, whose rule-"full" dE it needs; so the bond of the
//     first row upward is this rank's, and the last row's downward bond
//     the next rank's. Writes the fresh bits, out_up (row k0 - 1's sites
//     the first row reaches, for the previous rank), out_dn (the last
//     row's fresh sites, for the next rank) and `changed` (any message, or
//     with a bath any fresh site: news for another rank), never a message
//     back to where it came from.
//   sums: the field term's per-row sums, h_i s_i over the row's cluster
//     sites in index order (rule "local" with fields).
//   flip: the rows' cluster sites flipped, under rule "local" on a
//     Metropolis accept of -2B times the P gathered row sums added in
//     slice order (0 without fields), fk_wolff.cu's order.
//   A component is the same set whatever order it grows in, so the
//   cluster, and so the state, equals fk_wolff.cu's bitwise.
// - S7, three launches a step, each its own kernel:
//   the draw (fk_shard_draw_kernel): the FK draw of the rows' bonds
//     (spatial from the lower id, the Trotter bond of a row and the next,
//     drawn by the rank of the lower row: the last row's goes to the next
//     rank as bond_dn, the bath pairs of a line), ghost bonds, union-find
//     of the bonds inside the block, and each component's label, its
//     least global node k * n + id (-1 when a ghost bond holds); the bath
//     pairs with another rank's rows are kept as directed bits, bit q of
//     node x where x takes row q's label (a pair of two ranks is drawn by
//     both, from the same hash, each side keeping its own direction,
//     rather than sent). On a table not symmetric in ring distance
//     (`asym`) a bath pair of two block rows bonds both ways only when
//     both directions' draws hold, as in fk_label.cu: only those are
//     united; a one-way pair is a bit of the node it points into, and the
//     block's labels relax along those bits in rounds inside the launch.
//   a round (fk_shard_round_kernel): each component takes the least label
//     across its bonds to the other ranks' rows as they stood after their
//     last round (halo_prev across the previous rank's bond_up, halo_next
//     across bond_dn, full_labels across the bath bits) and, with `asym`,
//     relaxes along the block's one-way bits again; writes `changed`.
//   the flip (fk_shard_flip_kernel): every free component flips on the
//     coin of its label.
//   The least-label fixed point does not depend on the order of the
//   rounds, so the state equals fk_label.cu's bitwise.
//
// What bounds them on an H100. The draws: a hash and (where the bond is
// satisfied) an exp a bond, of the cluster's bonds (S6) or of every bond
// of the rows (S7), over the special-function rate; a round is one launch
// and, between ranks, one flag read on the host, so the round count, not
// the work, sets the time of a cluster that crosses ranks.
//
// S6's design, simply (a first kernel): one CTA of 512 threads a rank's
// block, the state and the queue BFS, which draws a bond when it reaches
// it, in device memory, barriers between phases; any n, P, Ps and maxnb.
//
// S7's design, after fk_label (csrc/fk_label.cu) on the labeling core of
// csrc/fk_nodes.cuh:
// - The draw (fk_shard_draw_kernel): the block's Ps x n nodes over a
//   cluster of R <= 16 CTAs (R from ops/cluster_kernels.py::
//   shard_label_geometry), CTA r owning the r-th chunk of site ids in every
//   row, its union-find in its shared memory while its region fits there,
//   else in device memory (the core's kOnChip = false, as fk_label.cu runs
//   a chain no cluster holds on chip); so a site's Trotter and bath
//   bonds join nodes of one CTA. A site's Trotter line is drawn by one
//   thread as runs of bonded rows (the last row's bond to the row below
//   goes out as bond_dn, and on a ring of one rank closes the ring); each
//   bath pair of two block rows is hashed once, from its lower row, both of
//   its directions decided from the one draw; a pair with another rank's
//   row is drawn by each side for its own direction, as before. The core
//   hooks the larger key k n + id under the smaller, so a component's root
//   is its least node, whose key plus k0 n is S7's label. Each node's
//   packed root, its component's label (at the root) and the bath bits go
//   to device memory for the rounds.
// - The round (fk_shard_round_kernel) and, on a table not symmetric in ring
//   distance, the block's relaxation along its one-way bits run over a
//   cluster of R CTAs, its passes separated by cluster.sync() and its
//   "moved" flag in CTA 0's shared memory; the flip (fk_shard_flip_kernel)
//   over a grid that covers the card, a thread a node. No fast math.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "cluster.cuh"
#include "counter_hash.cuh"
#include "fk.cuh"
#include "fk_nodes.cuh"
#include "packed.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kWolffThreads = 512;
constexpr int kLabelThreads = 1024;
constexpr int kGhostFlag = 0, kFrozenFlag = 1;  // the draw's flag bytes

__device__ __forceinline__ bool claim(unsigned* bits, int x) {
  const unsigned m = 1u << (x & 31);
  return (atomicOr(bits + (x >> 5), m) & m) == 0u;
}

__device__ __forceinline__ bool bit_of(const unsigned* bits, int x) {
  const volatile unsigned* v = bits;
  return (v[x >> 5] >> (x & 31)) & 1u;
}

// A rank's rows: row r in [-1, Ps] of packed site j, rows -1 and Ps the
// halo rows
struct Rows {
  const float* s;
  const float* up;
  const float* dn;
  int Ps, n;
  __device__ __forceinline__ float at(int r, int j) const {
    return r < 0 ? up[j]
                 : (r >= Ps ? dn[j] : s[static_cast<size_t>(r) * n + j]);
  }
};

struct Wolff {
  const int* nbr_idx;
  const float* nbr_J;
  const float* h;
  const int* perm;
  Rows rows;
  int P, k0, maxnb;
  float b, jp, teff, kval;
  uint32_t c_sp, c_t, c_b;
};

// rule "full": the single-flip dE of candidate (r, j), r a block row, with
// the seed sign kval (fk_wolff.cu::site_de)
__device__ __forceinline__ float site_de(const Wolff& w, int r, int j) {
  const float f = mcs::packed_field(
      w.rows.s + static_cast<size_t>(r) * w.rows.n, w.nbr_idx, w.nbr_J, w.h,
      j, w.maxnb);
  return __fadd_rn(
      __fmul_rn(__fmul_rn(__fmul_rn(-2.0f, w.b), w.kval), f),
      __fmul_rn(__fmul_rn(__fmul_rn(2.0f, w.jp), w.kval),
                __fadd_rn(w.rows.at(r - 1, j), w.rows.at(r + 1, j))));
}

__device__ __forceinline__ float sp_uniform(const Wolff& w, int r, int id,
                                            int m) {
  const uint32_t uid =
      ((static_cast<uint32_t>(w.k0 + r)) * w.rows.n + id) *
          static_cast<uint32_t>(w.maxnb) + m;
  return mcs::uniform01(w.c_sp, uid);
}

// Is the spatial pair (i, j) of block row r bonded? (fk_wolff.cu's rule)
template <bool kRuleFull>
__device__ bool spatial_bond(const Wolff& w, int r, int i, int j) {
  const int idi = __ldg(w.perm + i), idj = __ldg(w.perm + j);
  if (!kRuleFull) {
    const int lo = idi < idj ? i : j, hi = idi < idj ? j : i;
    const int idl = idi < idj ? idi : idj;
    const float sl = w.rows.at(r, lo), su = w.rows.at(r, hi);
    const int* rl = w.nbr_idx + static_cast<size_t>(lo) * w.maxnb;
    const float* jl = w.nbr_J + static_cast<size_t>(lo) * w.maxnb;
    for (int m = 0; m < w.maxnb; ++m) {
      if (__ldg(rl + m) != hi) continue;
      const float de = __fmul_rn(
          __fmul_rn(__fmul_rn(__fmul_rn(2.0f, w.b), __ldg(jl + m)), sl), su);
      if (sp_uniform(w, r, idl, m) < mcs::bond_prob(de, w.teff)) return true;
    }
    return false;
  }
  // both ends of the seed's sign (fk_wolff.cu's members always are; a
  // rank's message may name any site)
  if (w.rows.at(r, i) != w.kval || w.rows.at(r, j) != w.kval) return false;
  const float pj = mcs::bond_prob(site_de(w, r, j), w.teff);
  const int* ri = w.nbr_idx + static_cast<size_t>(i) * w.maxnb;
  for (int m = 0; m < w.maxnb; ++m) {
    if (__ldg(ri + m) == j && sp_uniform(w, r, idi, m) < pj) return true;
  }
  const float pi = mcs::bond_prob(site_de(w, r, i), w.teff);
  const int* rj = w.nbr_idx + static_cast<size_t>(j) * w.maxnb;
  for (int m = 0; m < w.maxnb; ++m) {
    if (__ldg(rj + m) == i && sp_uniform(w, r, idj, m) < pi) return true;
  }
  return false;
}

// Is the Trotter bond of block row r and the row above it (global k0 + r
// - 1 mod P, the halo row `up` at r = 0) bonded? This rank owns its upper
// slice and draws it.
template <bool kRuleFull>
__device__ bool up_bond(const Wolff& w, int r, int i) {
  const float s0 = w.rows.at(r - 1, i), s1 = w.rows.at(r, i);
  float de;
  if (kRuleFull) {
    if (s0 != w.kval || s1 != w.kval) return false;
    de = site_de(w, r, i);
  } else {
    de = __fmul_rn(__fmul_rn(__fmul_rn(-2.0f, w.jp), s0), s1);
  }
  const int kb = (w.k0 + r - 1 + w.P) % w.P;
  const uint32_t uid = static_cast<uint32_t>(kb) * w.rows.n +
                       static_cast<uint32_t>(__ldg(w.perm + i));
  return mcs::uniform01(w.c_t, uid) < mcs::bond_prob(de, w.teff);
}

// Does target slice `a` of packed site i pull from source slice q through
// their bath pair? (spins sa, sq; probabilities by ring offset q - a)
template <bool kRuleFull>
__device__ __forceinline__ bool bath_bond(const Wolff& w, const float* p_same,
                                          const float* p_diff, int a, int q,
                                          int i, float sa, float sq) {
  if (kRuleFull && (sa != w.kval || sq != w.kval)) return false;
  const int d = (q - a + w.P) % w.P;
  const float p = sq == sa ? p_same[d] : p_diff[d];
  const int lo = q < a ? q : a, hi = q < a ? a : q;
  const uint32_t line = static_cast<uint32_t>(__ldg(w.perm + i));
  const float u = mcs::uniform01(
      w.c_b, (line * w.P + lo) * static_cast<uint32_t>(w.P) + hi);
  return u < p;
}

template <bool kRuleFull, bool kBath>
__global__ void __launch_bounds__(kWolffThreads)
fk_shard_wolff_kernel(const int* __restrict__ nbr_idx,
                      const float* __restrict__ nbr_J,
                      const float* __restrict__ h,
                      const int* __restrict__ perm,
                      const float* __restrict__ b_sched,
                      const float* __restrict__ jp_sched,
                      const float* __restrict__ lut, float* s,
                      const float* up, const float* dn, const float* full,
                      const float* kval_ptr, unsigned* vis, unsigned* fresh,
                      int* queue, const unsigned char* in_prev,
                      const unsigned char* in_next,
                      const unsigned* full_fresh, unsigned char* out_up,
                      unsigned char* out_dn, int* changed,
                      const float* rows_full, float* rows_out, float teff,
                      int Ps, int n, int maxnb, int P, int k0, int seed_x,
                      int t, uint32_t seed_term, int mode) {
  extern __shared__ float dyn[];  // p_same[P], p_diff[P]
  float* p_same = dyn;
  float* p_diff = dyn + P;
  __shared__ int q_len[2];
  __shared__ int accept_s;
  const int PN = Ps * n;
  const int words = (PN + 31) / 32;
  const bool ring = Ps == P;
  Wolff w{nbr_idx, nbr_J, h, perm, Rows{s, up, dn, Ps, n}, P, k0, maxnb,
          __ldg(b_sched + t), __ldg(jp_sched + t), teff,
          kRuleFull ? *kval_ptr : 0.0f,
          mcs::cluster_counter(seed_term, t, mcs::kSpBond),
          mcs::cluster_counter(seed_term, t, mcs::kTrotterBond),
          mcs::cluster_counter(seed_term, t, mcs::kBathBond)};

  if (mode == 1) {  // the field term's row sums, in index order
    for (int r = threadIdx.x; r < Ps; r += blockDim.x) {
      const float* row = s + static_cast<size_t>(r) * n;
      float acc = 0.0f;
      for (int i = 0; i < n; ++i) {
        const float term = bit_of(vis, r * n + i)
                               ? __fmul_rn(__ldg(h + i), row[i])
                               : 0.0f;
        acc = i == 0 ? term : __fadd_rn(acc, term);
      }
      rows_out[r] = acc;
    }
    return;
  }
  if (mode == 2) {  // the flip
    if (threadIdx.x == 0) {
      bool acc = true;
      if (!kRuleFull && rows_full != nullptr) {
        float tot = rows_full[0];
        for (int k = 1; k < P; ++k) tot = __fadd_rn(tot, rows_full[k]);
        const float de = __fmul_rn(__fmul_rn(-2.0f, w.b), tot);
        const float u = mcs::uniform01(
            mcs::cluster_counter(seed_term, t, mcs::kAccept), 0u);
        acc = mcs::metropolis_accept(de, teff, u);
      }
      accept_s = acc ? 1 : 0;
    }
    __syncthreads();
    if (!accept_s) return;
    for (int wd = threadIdx.x; wd < words; wd += blockDim.x) {
      unsigned m = vis[wd];
      while (m) {
        const int x = wd * 32 + __ffs(m) - 1;
        s[x] = -s[x];
        m &= m - 1u;
      }
    }
    return;
  }

  // mode 0: a round
  for (int wd = threadIdx.x; wd < words; wd += blockDim.x) fresh[wd] = 0u;
  if (kBath) {
    for (int d = 1 + threadIdx.x; d < P; d += blockDim.x)
      mcs::bath_probs(lut, d, teff, p_same + d, p_diff + d);
  }
  if (threadIdx.x == 0) {
    q_len[0] = 0;
    q_len[1] = 0;
  }
  __syncthreads();
  int* q0 = queue;
  auto take = [&](int x, int* q, int which) {
    if (claim(vis, x)) {
      atomicOr(fresh + (x >> 5), 1u << (x & 31));
      q[atomicAdd(&q_len[which], 1)] = x;
    }
  };
  // this round's frontier
  if (threadIdx.x == 0 && seed_x >= 0) take(seed_x, q0, 0);
  if (!ring) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      if (in_next[i]) take((Ps - 1) * n + i, q0, 0);
      if (in_prev[i] && !bit_of(vis, i) && up_bond<kRuleFull>(w, 0, i))
        take(i, q0, 0);
    }
    if (kBath && full_fresh != nullptr) {
      for (int x = threadIdx.x; x < PN; x += blockDim.x) {
        if (bit_of(vis, x)) continue;
        const int r = x / n, i = x - r * n;
        const int a = k0 + r;
        const float sa = s[x];
        for (int q = 0; q < P; ++q) {
          if (q >= k0 && q < k0 + Ps) continue;
          const int xl = (q % Ps) * n + i;
          const unsigned* fw = full_fresh + static_cast<size_t>(q / Ps) * words;
          if (!((fw[xl >> 5] >> (xl & 31)) & 1u)) continue;
          if (bath_bond<kRuleFull>(w, p_same, p_diff, a, q, i, sa,
                                   full[static_cast<size_t>(q) * n + i])) {
            take(x, q0, 0);
            break;
          }
        }
      }
    }
  }
  __syncthreads();

  // the block's fixed point: queue `cur` is this hop's frontier
  int cur = 0;
  for (;;) {
    const int len = q_len[cur];
    if (len == 0) break;
    const int* qin = queue + cur * PN;
    int* qout = queue + (cur ^ 1) * PN;
    for (int e = threadIdx.x; e < len; e += blockDim.x) {
      const int x = qin[e];
      const int r = x / n, i = x - r * n;
      const int* ri = nbr_idx + static_cast<size_t>(i) * maxnb;
      for (int m = 0; m < maxnb; ++m) {
        const int j = __ldg(ri + m);
        if (j == i) continue;
        bool dup = false;
        for (int m0 = 0; m0 < m; ++m0) dup |= __ldg(ri + m0) == j;
        const int y = r * n + j;
        if (dup || bit_of(vis, y)) continue;
        if (spatial_bond<kRuleFull>(w, r, i, j)) take(y, qout, cur ^ 1);
      }
      if (ring || r + 1 < Ps) {  // the bond below, whose upper row is ours
        const int rn = r + 1 == Ps ? 0 : r + 1;
        const int y = rn * n + i;
        if (!bit_of(vis, y) && up_bond<kRuleFull>(w, rn, i))
          take(y, qout, cur ^ 1);
      }
      if (ring || r >= 1) {  // the bond above
        const int rp = r == 0 ? Ps - 1 : r - 1;
        const int y = rp * n + i;
        if (!bit_of(vis, y) && up_bond<kRuleFull>(w, r, i))
          take(y, qout, cur ^ 1);
      }
      if (kBath) {  // the line's pairs inside the block, pushed
        const float sk = s[x];
        for (int ql = 0; ql < Ps; ++ql) {
          const int y = ql * n + i;
          if (ql == r || bit_of(vis, y)) continue;
          if (bath_bond<kRuleFull>(w, p_same, p_diff, k0 + ql, k0 + r, i,
                                   s[y], sk))
            take(y, qout, cur ^ 1);
        }
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) q_len[cur] = 0;
    cur ^= 1;
    __syncthreads();
  }

  // the messages, and whether another rank has news
  int news = 0;
  if (!ring) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const unsigned char dn_msg =
          bit_of(fresh, (Ps - 1) * n + i) && !in_next[i];
      const unsigned char up_msg = bit_of(fresh, i) && !in_prev[i] &&
                                   up_bond<kRuleFull>(w, 0, i);
      out_dn[i] = dn_msg;
      out_up[i] = up_msg;
      news |= dn_msg | up_msg;
    }
    if (kBath) {
      for (int wd = threadIdx.x; wd < words; wd += blockDim.x)
        news |= fresh[wd] != 0u;
    }
  }
  news = __syncthreads_or(news);
  if (threadIdx.x == 0) *changed = news;
}

// One pass of S7's relaxation on a bath table not symmetric in ring
// distance: nodes x = first, first + stride, ... of the block (lab at each
// root) take, at their root, the least label of the block rows their bits
// of ext point at (x takes the label of row q's node of its line), as
// fk_label.cu's asym loop; returns whether it moved a label. Another
// rank's rows wait for the round.
__device__ int relax_pass(const unsigned* ext, const int* root, int* lab,
                          int PN, int n, int pw, int k0, int Ps, int first,
                          int stride) {
  volatile int* vlab = lab;
  int moved = 0;
  for (int x = first; x < PN; x += stride) {
    const int j = x % n;
    const int to = __ldcg(root + x);
    const unsigned* ex = ext + static_cast<size_t>(x) * pw;
    for (int wd = 0; wd < pw; ++wd) {
      unsigned m = __ldcg(ex + wd);
      while (m) {
        const int q = wd * 32 + __ffs(m) - 1;
        m &= m - 1u;
        if (q < k0 || q >= k0 + Ps) continue;  // another rank's row
        const int l = vlab[__ldcg(root + (q - k0) * n + j)];
        if (l < vlab[to]) {
          atomicMin(lab + to, l);
          moved = 1;
        }
      }
    }
  }
  return moved;
}

// The relaxation in rounds over a cluster until one changes nothing:
// `any0` CTA 0's word, which a CTA sets to the round's number (counted in `round` across the launch) when it moved a
// label (fk_nodes.cuh::Core::any)
__device__ void relax_cluster(const cg::cluster_group& cluster,
                              const unsigned* ext, const int* root, int* lab,
                              int PN, int n, int pw, int k0, int Ps,
                              int first, int stride, volatile int* any0,
                              int& round) {
  for (;;) {
    const int moved =
        relax_pass(ext, root, lab, PN, n, pw, k0, Ps, first, stride);
    ++round;
    if (__syncthreads_or(moved) && threadIdx.x == 0) *any0 = round;
    cluster.sync();
    if (*any0 < round) return;
  }
}

// S7's draw over a cluster of R CTAs on the labeling core (see the
// header), the regions in shared memory (kOnChip) or in `regions`: the
// block's roots (root, the packed node of each node's
// component root), its components' labels (lab, at the roots) and each
// node's label, bond_dn, and with a bath the bits of ext.
template <bool kBath, bool kOnChip>
__global__ void __launch_bounds__(kLabelThreads, 1)
fk_shard_draw_kernel(const int* __restrict__ nbr_idx,
                     const float* __restrict__ nbr_J,
                     const float* __restrict__ h,
                     const int* __restrict__ perm,
                     const int* __restrict__ inv_perm,
                     const int* __restrict__ boundary,
                     const float* __restrict__ b_sched,
                     const float* __restrict__ jp_sched,
                     const float* __restrict__ lut, const float* s,
                     const float* dn, const float* full, int* root, int* lab,
                     unsigned* ext, int* labels, unsigned char* bond_dn,
                     char* regions, float teff, int Ps, int n, int maxnb,
                     int P, int k0, int t, int R, uint32_t seed_term,
                     int asym) {
  // the head, p_same[P], p_diff[P], then this CTA's region
  extern __shared__ __align__(16) unsigned char label_smem[];
  float* const p_same =
      reinterpret_cast<float*>(label_smem + mcs::kNodesHeadBytes);
  float* const p_diff = p_same + P;
  cg::cluster_group cluster = cg::this_cluster();
  const bool ring = Ps == P;
  const bool directed = kBath && asym;
  // the bits of ext: another rank's rows, or the block's one-way pairs
  const bool with_ext = kBath && (directed || !ring);
  const int pw = (P + 31) / 32;
  const int PN = Ps * n;
  const size_t off = mcs::kNodesHeadBytes + 2 * P * sizeof(float);
  const mcs::Core<kOnChip> core = mcs::make_core<kOnChip>(
      cluster, label_smem, R, Ps, n, 1, off, regions);
  const int nc = core.nc, slots = core.slots, y0 = core.y0;
  const int id0 = core.rank * nc;
  const int ns = min(nc, n - id0);  // own sites (the last CTA's are fewer)
  // the own sites with a neighbour in another CTA's chunk
  const int* const bsites = boundary + R + 1 + __ldg(boundary + core.rank);
  const int nb = __ldg(boundary + core.rank + 1) - __ldg(boundary + core.rank);
  mcs::FastDiv by_nb;
  by_nb.init(static_cast<uint32_t>(nb > 0 ? nb : 1));
  const float b = __ldg(b_sched + t);
  const float jp = __ldg(jp_sched + t);
  const uint32_t c_sp = mcs::cluster_counter(seed_term, t, mcs::kSpBond);
  const uint32_t c_t = mcs::cluster_counter(seed_term, t, mcs::kTrotterBond);
  const uint32_t c_b = mcs::cluster_counter(seed_term, t, mcs::kBathBond);
  const uint32_t c_h = mcs::cluster_counter(seed_term, t, mcs::kGhost);
  if (kBath) {
    for (int d = 1 + threadIdx.x; d < P; d += blockDim.x)
      mcs::bath_probs(lut, d, teff, p_same + d, p_diff + d);
  }
  const float two_b = __fmul_rn(2.0f, b);
  const float m2jp = __fmul_rn(-2.0f, jp);
  const uint32_t un = static_cast<uint32_t>(n);
  __syncthreads();  // the head's region addresses, before the reset

  // the reset: own slot w is node (k, id0 + lid) of key k n + id; past the
  // last site (the last CTA's short chunk) a slot is empty
  for (int w = threadIdx.x; w < slots; w += blockDim.x) {
    const int y = y0 + w;
    core.set_flag(y, kGhostFlag, 0);
    core.set_flag(y, kFrozenFlag, 0);
    const int k = core.by_nc.div(w);
    const int lid = w - k * nc;
    if (lid >= ns) {
      core.set_parent(y, y);
    } else if (with_ext) {
      unsigned* ex = ext + (static_cast<size_t>(k) * n +
                            __ldg(inv_perm + id0 + lid)) * pw;
      for (int wd = 0; wd < pw; ++wd) ex[wd] = 0u;
    }
  }
  // each own site's Trotter line, a thread a site: bond (k - 1, k) drawn
  // as row k - 1 draws it, each node's parent the least row of its run of
  // bonded rows; the last row's bond to the row below (dn) goes out as
  // bond_dn and, on a ring of one rank, hooks the last run under row 0's
  for (int lid = threadIdx.x; lid < ns; lid += blockDim.x) {
    const int id = id0 + lid;
    const int i = __ldg(inv_perm + id);
    const int first = y0 + lid;
    int run = first;
    core.set_parent(first, first);
    float prev = s[i];
    for (int k = 1; k < Ps; ++k) {
      const int y = first + k * nc;
      const float sk = s[static_cast<size_t>(k) * n + i];
      const float de = __fmul_rn(__fmul_rn(m2jp, prev), sk);
      if (mcs::uniform01(c_t, static_cast<uint32_t>(k0 + k - 1) * un + id) <
          mcs::bond_prob(de, teff)) {
        core.set_parent(y, run);
      } else {
        run = y;
        core.set_parent(y, y);
      }
      prev = sk;
    }
    const float de = __fmul_rn(__fmul_rn(m2jp, prev), dn[i]);
    const bool on =
        mcs::uniform01(c_t, static_cast<uint32_t>(k0 + Ps - 1) * un + id) <
        mcs::bond_prob(de, teff);
    bond_dn[i] = on;
    if (ring && on && run != first) core.set_parent(run, first);
  }
  cluster.sync();  // every region reset (the head, in place)

  // the rest of the draw, united as it is drawn: first the bonds whose
  // other node is this CTA's too (the bath pairs, the spatial bonds inside
  // its sites), then the spatial ones to another CTA's sites, from the
  // boundary sites (none at R = 1)
  for (int pass = 0; pass < (R > 1 ? 2 : 1); ++pass) {
    const int work = pass == 0 ? slots : Ps * nb;
    for (int w = threadIdx.x; w < work; w += blockDim.x) {
      int k, lid;
      if (pass == 0) {
        k = core.by_nc.div(w);
        lid = w - k * nc;
      } else {
        k = by_nb.div(w);
        lid = __ldg(bsites + w - k * nb) - id0;
      }
      const int id = id0 + lid;
      if (lid >= ns) continue;
      const int y = y0 + k * nc + lid;
      const int i = __ldg(inv_perm + id);
      const int kg = k0 + k;
      const uint32_t uid = static_cast<uint32_t>(kg) * un + id;
      const float si = s[static_cast<size_t>(k) * n + i];
      const int* ri = nbr_idx + static_cast<size_t>(i) * maxnb;
      const float* ji = nbr_J + static_cast<size_t>(i) * maxnb;
      for (int m = 0; m < maxnb; ++m) {
        const int j = __ldg(ri + m);
        const int idj = __ldg(perm + j);
        if (id >= idj) continue;  // drawn from the lower id; pads excluded
        const bool inside = idj - id0 < nc;  // idj > id >= id0
        if (inside != (pass == 0)) continue;
        const float de = __fmul_rn(
            __fmul_rn(__fmul_rn(two_b, __ldg(ji + m)), si),
            s[static_cast<size_t>(k) * n + j]);
        if (mcs::uniform01(c_sp, uid * static_cast<uint32_t>(maxnb) + m) <
            mcs::bond_prob(de, teff))
          core.unite(y, inside ? y + idj - id : core.node(k, idj));
      }
      if (pass) continue;
      const float de_h = __fmul_rn(__fmul_rn(two_b, __ldg(h + i)), si);
      if (mcs::uniform01(c_h, uid) < mcs::bond_prob(de_h, teff))
        core.set_flag(y, kGhostFlag, 1);
      if (kBath) {
        // the line's pairs: a pair of two block rows once, from its lower
        // row, both directions from its one draw; another rank's row for
        // this row's direction
        const size_t x = static_cast<size_t>(k) * n + i;
        const uint32_t line = static_cast<uint32_t>(id);
        unsigned word = 0u;
        for (int q = 0; q < P; ++q) {
          const bool own = q >= k0 && q < k0 + Ps;
          if (q != kg && (!own || q > kg)) {
            const float sq = own ? s[static_cast<size_t>(q - k0) * n + i]
                                 : full[static_cast<size_t>(q) * n + i];
            const bool same = sq == si;
            const int lo = q < kg ? q : kg, hi = q < kg ? kg : q;
            // row kg takes q's label at ring offset q - kg, q takes kg's
            // at offset kg - q
            const int d = q > kg ? q - kg : P - kg + q;
            const float u = mcs::uniform01(
                c_b, (line * P + lo) * static_cast<uint32_t>(P) + hi);
            const bool fwd = u < (same ? p_same[d] : p_diff[d]);
            if (!own) {
              if (fwd) word |= 1u << (q & 31);
            } else if (!directed) {
              if (fwd) core.unite(y, y + (q - kg) * nc);
            } else {
              const bool back = u < (same ? p_same[P - d] : p_diff[P - d]);
              if (fwd && back) {
                core.unite(y, y + (q - kg) * nc);
              } else if (fwd) {
                word |= 1u << (q & 31);  // one way: relaxed below
              } else if (back) {
                atomicOr(ext + (static_cast<size_t>(q - k0) * n + i) * pw +
                             (kg >> 5),
                         1u << (kg & 31));
              }
            }
          }
          if (with_ext && ((q & 31) == 31 || q == P - 1)) {
            if (word) atomicOr(ext + x * pw + (q >> 5), word);
            word = 0u;
          }
        }
      }
    }
    cluster.sync();
  }

  // a ghost bond freezes its component: its local top, then the global
  // root of each frozen top whose parent is another CTA's
  for (int w = threadIdx.x; w < slots; w += blockDim.x) {
    const int y = y0 + w;
    if (core.flag(y, kGhostFlag))
      core.set_flag(core.local_top(y), kFrozenFlag, 1);
  }
  __syncthreads();
  for (int w = threadIdx.x; R > 1 && w < slots; w += blockDim.x) {
    const int y = y0 + w;
    const int p = core.parent(y);
    if (!core.mine(p) && core.flag(y, kFrozenFlag))
      core.set_flag(core.find_global(p), kFrozenFlag, 1);
  }
  cluster.sync();
  // each local top with another CTA's parent to its global root g, and
  // g's frozen flag
  for (int w = threadIdx.x; R > 1 && w < slots; w += blockDim.x) {
    const int y = y0 + w;
    const int p = core.parent(y);
    if (core.mine(p)) continue;
    const int g = core.find_global(p);
    core.set_parent(y, g);
    core.set_flag(y, kFrozenFlag, core.flag(g, kFrozenFlag));
  }
  cluster.sync();

  // each own node's root and label (-1 frozen, else the root's key from
  // row k0), the roots' labels
  for (int w = threadIdx.x; w < slots; w += blockDim.x) {
    const int k = core.by_nc.div(w);
    const int lid = w - k * nc;
    if (lid >= ns) continue;
    const int y = y0 + w;
    const int top = core.local_top(y);
    const int g = core.parent(top);  // the top itself at a root
    const int key = core.key(g);
    const int kr = key / n;
    const int xr = kr * n + __ldg(inv_perm + key - kr * n);
    const int label = core.flag(top, kFrozenFlag) ? -1 : key + k0 * n;
    const int x = k * n + __ldg(inv_perm + id0 + lid);
    root[x] = xr;
    labels[x] = label;
    if (g == y) lab[x] = label;
  }
  if (directed) {
    // with asym the components' labels relax along the block's one-way
    // bits, in device memory
    cluster.sync();  // every root and label in place
    const int first = core.rank * blockDim.x + threadIdx.x;
    const int stride = R * blockDim.x;
    int round = 0;
    relax_cluster(cluster, ext, root, lab, PN, n, pw, k0, Ps, first, stride,
                  core.any0, round);
    volatile int* vlab = lab;
    for (int x = first; x < PN; x += stride) labels[x] = vlab[__ldcg(root + x)];
  }
  cluster.sync();  // no CTA leaves while another may read its region
}

// S7's round over a cluster of R CTAs: each node's least label across the
// other ranks' rows at its root (atomicMin on lab), with `directed` the
// block's relaxation along its one-way bits, then each node's label from
// its root; `changed` says whether one moved.
__global__ void __launch_bounds__(kLabelThreads, 1)
fk_shard_round_kernel(const unsigned* ext, const int* root, int* lab,
                      int* labels, const unsigned char* bond_dn,
                      const int* halo_prev, const unsigned char* bond_up,
                      const int* halo_next, const int* full_labels,
                      int* changed, int Ps, int n, int P, int k0,
                      int bath, int directed) {
  __shared__ int flags[2];  // CTA 0's: the relaxation's round, any change
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int R = static_cast<int>(cluster.num_blocks());
  int* const flags0 = rank == 0 ? flags : cluster.map_shared_rank(flags, 0);
  if (rank == 0 && threadIdx.x < 2) flags[threadIdx.x] = 0;
  const int PN = Ps * n;
  const int pw = (P + 31) / 32;
  const bool ring = Ps == P;
  const int first = rank * blockDim.x + threadIdx.x;
  const int stride = R * blockDim.x;
  for (int x = first; x < PN; x += stride) {
    const int r = x / n, j = x - r * n;
    int e = INT_MAX;
    if (!ring) {
      if (r == 0 && bond_up[j]) e = min(e, halo_prev[j]);
      if (r == Ps - 1 && bond_dn[j]) e = min(e, halo_next[j]);
      if (bath && full_labels != nullptr) {
        const unsigned* ex = ext + static_cast<size_t>(x) * pw;
        for (int wd = 0; wd < pw; ++wd) {
          unsigned m = ex[wd];
          while (m) {
            const int q = wd * 32 + __ffs(m) - 1;
            m &= m - 1u;
            if (q >= k0 && q < k0 + Ps) continue;  // the block's own
            e = min(e, full_labels[static_cast<size_t>(q) * n + j]);
          }
        }
      }
    }
    if (e < labels[x]) atomicMin(lab + root[x], e);
  }
  cluster.sync();  // every pull in place (and CTA 0's flags reset)
  if (bath && directed) {
    int round = 0;
    relax_cluster(cluster, ext, root, lab, PN, n, pw, k0, Ps, first, stride,
                  flags0, round);
  }
  volatile int* vlab = lab;
  int moved = 0;
  for (int x = first; x < PN; x += stride) {
    const int v = vlab[root[x]];
    if (v != labels[x]) {
      labels[x] = v;
      moved = 1;
    }
  }
  if (__syncthreads_or(moved) && threadIdx.x == 0) atomicOr(flags0 + 1, 1);
  cluster.sync();  // every CTA's news in CTA 0's word
  if (rank == 0 && threadIdx.x == 0) *changed = flags[1];
}

// S7's flip: every free node flips on the coin of its label, a thread a
// node
__global__ void fk_shard_flip_kernel(const int* __restrict__ labels,
                                     float* s, int PN, int t,
                                     uint32_t seed_term) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= PN) return;
  const uint32_t c_coin = mcs::cluster_counter(seed_term, t, mcs::kCoin);
  const int l = __ldg(labels + x);
  if (l >= 0 && mcs::uniform01(c_coin, static_cast<uint32_t>(l)) < 0.5f)
    s[x] = -s[x];
}

// Shared memory of one CTA of S7's draw: the head, the bath's two rows of
// P floats and, on chip, the CTA's region of Ps ceil(n / R) nodes
// (ops/cluster_kernels.py::shard_label_smem_bytes)
inline size_t shard_draw_smem_bytes(int P, int Ps, int n, int R,
                                    bool on_chip) {
  return mcs::nodes_smem_bytes(Ps, n, R, 1, 2 * P, on_chip);
}

// The instantiation of S7's draw with a bath table (bath) or none, its
// union-find on chip or in device memory
inline auto shard_draw_kernel(bool bath, bool on_chip) {
  return on_chip ? (bath ? fk_shard_draw_kernel<true, true>
                         : fk_shard_draw_kernel<false, true>)
                 : (bath ? fk_shard_draw_kernel<true, false>
                         : fk_shard_draw_kernel<false, false>);
}

template <bool kRuleFull, bool kBath>
void launch_wolff(cudaStream_t st, size_t smem, const int* nbr_idx,
                  const float* nbr_J, const float* h, const int* perm,
                  const float* b_sched, const float* jp, const float* lut,
                  float* s, const float* up, const float* dn,
                  const float* full, const float* kval, unsigned* vis,
                  unsigned* fresh, int* queue, const unsigned char* in_prev,
                  const unsigned char* in_next, const unsigned* full_fresh,
                  unsigned char* out_up, unsigned char* out_dn, int* changed,
                  const float* rows_full, float* rows_out, float teff,
                  int Ps, int n, int maxnb, int P, int k0, int seed_x, int t,
                  uint32_t seed_term, int mode) {
  fk_shard_wolff_kernel<kRuleFull, kBath><<<1, kWolffThreads, smem, st>>>(
      nbr_idx, nbr_J, h, perm, b_sched, jp, lut, s, up, dn, full, kval, vis,
      fresh, queue, in_prev, in_next, full_fresh, out_up, out_dn, changed,
      rows_full, rows_out, teff, Ps, n, maxnb, P, k0, seed_x, t, seed_term,
      mode);
}

}  // namespace

// S6, one launch of mode `mode` (0 a round, 1 the field sums, 2 the flip)
// on a rank's rows s (Ps, n) of a (P, n) chain, rows k0 ..; up, dn (n) the
// halo rows; full (P, n) every rank's rows or null (no bath); kval (1) the
// seed spin (rule "full") or null; vis, fresh (ceil(Ps n / 32)) bits;
// queue (2 Ps n) scratch; in_prev, in_next, out_up, out_dn (n) bytes;
// full_fresh (R ceil(Ps n / 32)) every rank's fresh bits or null;
// changed (1); rows_full (P) the gathered row sums or null; rows_out (Ps);
// the schedules B and J_perp read at step t; lut (P - 1) or null; seed_x
// the seed's index in the block or -1. All device pointers; launches on
// `stream` and returns cudaGetLastError().
extern "C" int fk_shard_wolff(
    const int* nbr_idx, const float* nbr_J, const float* h, const int* perm,
    const float* b_sched, const float* jp, const float* lut, float* s,
    const float* up, const float* dn, const float* full, const float* kval,
    unsigned* vis, unsigned* fresh, int* queue, const unsigned char* in_prev,
    const unsigned char* in_next, const unsigned* full_fresh,
    unsigned char* out_up, unsigned char* out_dn, int* changed,
    const float* rows_full, float* rows_out, float teff, int Ps, int n,
    int maxnb, int P, int k0, int seed_x, int t, int seed, int rule_full,
    int mode, void* stream) {
  if (n == 0 || Ps == 0) return cudaSuccess;
  if (rule_full && kval == nullptr) return cudaErrorInvalidValue;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  const size_t smem = 2 * static_cast<size_t>(P) * sizeof(float);
  auto go = rule_full ? (lut ? launch_wolff<true, true>
                             : launch_wolff<true, false>)
                      : (lut ? launch_wolff<false, true>
                             : launch_wolff<false, false>);
  go(static_cast<cudaStream_t>(stream), smem, nbr_idx, nbr_J, h, perm,
     b_sched, jp, lut, s, up, dn, full, kval, vis, fresh, queue, in_prev,
     in_next, full_fresh, out_up, out_dn, changed, rows_full, rows_out, teff,
     Ps, n, maxnb, P, k0, seed_x, t, seed_term, mode);
  return cudaGetLastError();
}

// S7's draw over a cluster of R CTAs of `threads` threads: a rank's rows s
// (Ps, n) of a (P, n) chain, rows k0 ..; dn (n) the row below the block;
// full (P, n) every rank's rows or null (no bath); lab, root (Ps n) int32,
// kept for the step's rounds; ext (Ps n ceil(P / 32)) the bath bits;
// labels (Ps n) int32; bond_dn (n) bytes; lut (P - 1) or null; asym != 0
// when lut is not symmetric in ring distance; inv_perm (n) and boundary
// (ops/cluster_kernels.py::boundary_sites at R) as fk_label takes them.
// regions: null when each CTA's region of the union-find sits in its
// shared memory, else device scratch of R regions (fk_nodes.cuh::
// region_bytes of Ps ceil(n / R) nodes and one int32 array). All device
// pointers; launches on `stream` and returns the launch's error.
extern "C" int fk_shard_label_draw(
    const int* nbr_idx, const float* nbr_J, const float* h, const int* perm,
    const int* inv_perm, const int* boundary, const float* b_sched,
    const float* jp, const float* lut, const float* s, const float* dn,
    const float* full, int* lab, int* root, unsigned* ext, int* labels,
    unsigned char* bond_dn, char* regions, float teff, int Ps, int n,
    int maxnb, int P, int k0, int t, int seed, int asym, int R, int threads,
    void* stream) {
  if (n == 0 || Ps == 0) return cudaSuccess;
  if (R < 1 || R > mcs::kMaxRanks || R > n || threads > kLabelThreads)
    return cudaErrorInvalidValue;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  const bool on_chip = regions == nullptr;
  auto kernel = shard_draw_kernel(lut != nullptr, on_chip);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = mcs::cluster_config(
      kernel, R, R, threads, shard_draw_smem_bytes(P, Ps, n, R, on_chip),
      static_cast<cudaStream_t>(stream), &cfg, &attr);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, kernel, nbr_idx, nbr_J, h, perm, inv_perm,
                         boundary, b_sched, jp, lut, s, dn, full, root, lab,
                         ext, labels, bond_dn, regions, teff, Ps, n, maxnb,
                         P, k0, t, R, seed_term,
                         static_cast<int>(lut != nullptr && asym));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Clusters of R CTAs of `threads` threads the card holds at once of S7's
// draw at P slices, Ps rows of n sites, with a bath table (bath) or none,
// its union-find on chip (on_chip) or in device memory
extern "C" int fk_shard_label_max_active_clusters(int P, int Ps, int n,
                                                  int R, int bath,
                                                  int on_chip, int threads,
                                                  int* count) {
  return mcs::max_active_clusters(
      shard_draw_kernel(bath != 0, on_chip != 0), R, threads,
      shard_draw_smem_bytes(P, Ps, n, R, on_chip != 0), count);
}

// S7's round over a cluster of R CTAs of `threads` threads on the draw's
// root, lab, ext and labels: halo_prev, halo_next (n)
// int32 and bond_up (n) bytes the ring's rows, bond_dn (n) the draw's;
// full_labels (P n) every rank's labels or null; bath != 0 with a bath
// table, asym != 0 when it is not symmetric in ring distance; changed
// (1) int32 out. Returns the launch's error.
extern "C" int fk_shard_label_round(
    const unsigned* ext, const int* root, int* lab, int* labels,
    const unsigned char* bond_dn, const int* halo_prev,
    const unsigned char* bond_up, const int* halo_next,
    const int* full_labels, int* changed, int Ps, int n, int P, int k0,
    int bath, int asym, int R, int threads, void* stream) {
  if (n == 0 || Ps == 0) return cudaSuccess;
  if (R < 1 || R > mcs::kMaxRanks || threads > kLabelThreads)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = mcs::cluster_config(fk_shard_round_kernel, R, R, threads,
                                      0, static_cast<cudaStream_t>(stream),
                                      &cfg, &attr);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, fk_shard_round_kernel, ext, root, lab,
                         labels, bond_dn, halo_prev, bond_up, halo_next,
                         full_labels, changed, Ps, n, P, k0, bath,
                         static_cast<int>(bath && asym));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// S7's flip of the rows s (Ps, n) in place on labels (Ps n) at step t, a
// thread a node. Returns cudaGetLastError().
extern "C" int fk_shard_label_flip(const int* labels, float* s, int Ps,
                                   int n, int t, int seed, void* stream) {
  const int PN = Ps * n;
  if (PN == 0) return cudaSuccess;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  constexpr int kFlipThreads = 256;
  fk_shard_flip_kernel<<<(PN + kFlipThreads - 1) / kFlipThreads,
                         kFlipThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      labels, s, PN, t, seed_term);
  return cudaGetLastError();
}

extern "C" const char* fk_shard_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
