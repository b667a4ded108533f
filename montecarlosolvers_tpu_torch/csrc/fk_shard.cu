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
// - S7 (fk_shard_label_kernel), three modes a launch:
//   init: the FK draw of the rows' bonds (spatial from the lower id, the
//     Trotter bond of a row and the next, drawn by the rank of the lower
//     row: the last row's goes to the next rank as bond_dn, the bath pairs
//     of a line), ghost bonds, union-find of the bonds inside the block,
//     and each component's label, its least global node k * n + id (-1
//     when a ghost bond holds); the bath pairs with another rank's rows
//     are kept as directed bits, bit q of node x where x takes row q's
//     label (a pair of two ranks is drawn by both, from the same hash,
//     each side keeping its own direction, rather than sent). On a table
//     not symmetric in ring distance (`asym`) a bath pair of two block
//     rows bonds both ways only when both directions' draws hold, as in
//     fk_label.cu: only those are united; a one-way pair is a bit of the
//     node it points into, and the block's labels relax along those bits
//     in rounds inside the launch (`relax_block`).
//   round: each component takes the least label across its bonds to the
//     other ranks' rows as they stood after their last round (halo_prev
//     across the previous rank's bond_up, halo_next across bond_dn,
//     full_labels across the bath bits) and, with `asym`, relaxes along
//     the block's one-way bits again; writes `changed`.
//   flip: every free component flips on the coin of its label.
//   The least-label fixed point does not depend on the order of the
//   rounds, so the state equals fk_label.cu's bitwise.
//
// What bounds them on an H100. The draws: a hash and (where the bond is
// satisfied) an exp a bond, of the cluster's bonds (S6) or of every bond
// of the rows (S7), over the special-function rate; a round is one launch
// and, between ranks, one flag read on the host, so the round count, not
// the work, sets the time of a cluster that crosses ranks.
//
// The design, simply (a first kernel): one CTA a rank's block (512
// threads S6, 1024 S7), the state and the union-find in device memory,
// a queue BFS that draws a bond when it reaches it (S6), barriers between
// phases; any n, P, Ps and maxnb with one design. No fast math.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "counter_hash.cuh"
#include "fk.cuh"
#include "packed.cuh"

namespace {

constexpr int kWolffThreads = 512;
constexpr int kLabelThreads = 1024;

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

// S7 with a bath table not symmetric in ring distance: the block's labels
// (lab at each root) relaxed along its one-way bath edges, the bits of ext
// at the block's own rows (x takes the label of row q's node of its line),
// in rounds until one changes nothing, as fk_label.cu's asym loop
__device__ void relax_block(const unsigned* ext, const int* root, int* lab,
                            int PN, int n, int pw, int k0, int Ps) {
  volatile int* vlab = lab;
  for (;;) {
    int moved = 0;
    for (int x = threadIdx.x; x < PN; x += blockDim.x) {
      const int j = x % n;
      const int to = root[x];
      const unsigned* ex = ext + static_cast<size_t>(x) * pw;
      for (int wd = 0; wd < pw; ++wd) {
        unsigned m = ex[wd];
        while (m) {
          const int q = wd * 32 + __ffs(m) - 1;
          m &= m - 1u;
          if (q < k0 || q >= k0 + Ps) continue;  // another rank's row
          const int l = vlab[root[(q - k0) * n + j]];
          if (l < vlab[to]) {
            atomicMin(lab + to, l);
            moved = 1;
          }
        }
      }
    }
    if (!__syncthreads_or(moved)) return;
  }
}

template <bool kBath>
__global__ void __launch_bounds__(kLabelThreads)
fk_shard_label_kernel(const int* __restrict__ nbr_idx,
                      const float* __restrict__ nbr_J,
                      const float* __restrict__ h,
                      const int* __restrict__ perm,
                      const float* __restrict__ b_sched,
                      const float* __restrict__ jp_sched,
                      const float* __restrict__ lut, float* s,
                      const float* dn, const float* full, int* parent,
                      int* lab, int* root, unsigned* ext, int* labels,
                      unsigned char* bond_dn, const int* halo_prev,
                      const unsigned char* bond_up, const int* halo_next,
                      const int* full_labels, int* changed, float teff,
                      int Ps, int n, int maxnb, int P, int k0, int t,
                      uint32_t seed_term, int mode, int asym) {
  extern __shared__ float dyn[];  // p_same[P], p_diff[P]
  float* p_same = dyn;
  float* p_diff = dyn + P;
  const int PN = Ps * n;
  const int pw = (P + 31) / 32;
  const bool ring = Ps == P;

  if (mode == 2) {  // the flip, on the coin of each free label
    const uint32_t c_coin = mcs::cluster_counter(seed_term, t, mcs::kCoin);
    for (int x = threadIdx.x; x < PN; x += blockDim.x) {
      const int l = labels[x];
      if (l >= 0 && mcs::uniform01(c_coin, static_cast<uint32_t>(l)) < 0.5f)
        s[x] = -s[x];
    }
    return;
  }
  if (mode == 1) {  // a round: the least label across the other ranks
    for (int x = threadIdx.x; x < PN; x += blockDim.x) {
      const int r = x / n, j = x - r * n;
      int e = INT_MAX;
      if (!ring) {
        if (r == 0 && bond_up[j]) e = min(e, halo_prev[j]);
        if (r == Ps - 1 && bond_dn[j]) e = min(e, halo_next[j]);
        if (kBath && full_labels != nullptr) {
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
    __syncthreads();
    if (kBath && asym) relax_block(ext, root, lab, PN, n, pw, k0, Ps);
    int moved = 0;
    for (int x = threadIdx.x; x < PN; x += blockDim.x) {
      const int v = lab[root[x]];
      if (v != labels[x]) {
        labels[x] = v;
        moved = 1;
      }
    }
    moved = __syncthreads_or(moved);
    if (threadIdx.x == 0) *changed = moved;
    return;
  }

  // mode 0: the draw, the block's union-find and its labels
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
  for (int x = threadIdx.x; x < PN; x += blockDim.x) {
    parent[x] = x;
    lab[x] = INT_MAX;
  }
  __syncthreads();
  const float two_b = __fmul_rn(2.0f, b);
  const float m2jp = __fmul_rn(-2.0f, jp);
  for (int x = threadIdx.x; x < PN; x += blockDim.x) {
    const int r = x / n, i = x - r * n;
    const int kg = k0 + r;
    const int idi = __ldg(perm + i);
    const uint32_t uid = static_cast<uint32_t>(kg) * n + idi;
    const float si = s[x];
    const float de_h = __fmul_rn(__fmul_rn(two_b, __ldg(h + i)), si);
    labels[x] = mcs::uniform01(c_h, uid) < mcs::bond_prob(de_h, teff)
                    ? -1
                    : static_cast<int>(uid);
    const int* ri = nbr_idx + static_cast<size_t>(i) * maxnb;
    const float* ji = nbr_J + static_cast<size_t>(i) * maxnb;
    for (int m = 0; m < maxnb; ++m) {
      const int j = __ldg(ri + m);
      if (idi >= __ldg(perm + j)) continue;  // from the lower id; no pads
      const float de = __fmul_rn(
          __fmul_rn(__fmul_rn(two_b, __ldg(ji + m)), si),
          s[static_cast<size_t>(r) * n + j]);
      if (mcs::uniform01(c_sp, uid * static_cast<uint32_t>(maxnb) + m) <
          mcs::bond_prob(de, teff))
        mcs::unite(parent, x, r * n + j);
    }
    {  // the Trotter bond of this row and the next, drawn by this row
      const float sn = r + 1 < Ps ? s[x + n] : dn[i];
      const float de = __fmul_rn(__fmul_rn(m2jp, si), sn);
      const bool on = mcs::uniform01(c_t, uid) < mcs::bond_prob(de, teff);
      if (ring || r + 1 < Ps) {
        if (on) mcs::unite(parent, x, r + 1 < Ps ? x + n : i);
      } else {
        bond_dn[i] = on;
      }
    }
    if (kBath) {
      const uint32_t line = static_cast<uint32_t>(idi);
      unsigned word = 0u;
      for (int q = 0; q < P; ++q) {
        const bool own = q >= k0 && q < k0 + Ps;
        // a pair of two block rows is drawn once, from its lower row, but
        // with asym from both (each keeps its own pull)
        if (q != kg && (!own || q > kg || asym)) {
          const float sq = own ? s[static_cast<size_t>(q - k0) * n + i]
                               : full[static_cast<size_t>(q) * n + i];
          const bool same = sq == si;
          const int lo = q < kg ? q : kg, hi = q < kg ? kg : q;
          // row kg takes q's label at ring offset q - kg, q takes kg's at
          // offset kg - q
          const int d = q > kg ? q - kg : P - kg + q;
          const float u = mcs::uniform01(
              c_b, (line * P + lo) * static_cast<uint32_t>(P) + hi);
          const bool pull = u < (same ? p_same[d] : p_diff[d]);
          if (!own) {
            if (pull) word |= 1u << (q & 31);
          } else if (!asym) {
            if (pull) mcs::unite(parent, x, (q - k0) * n + i);
          } else if (pull) {
            if (u < (same ? p_same[P - d] : p_diff[P - d])) {
              if (q > kg) mcs::unite(parent, x, (q - k0) * n + i);
            } else {
              word |= 1u << (q & 31);  // one way: relaxed in the block
            }
          }
        }
        if ((q & 31) == 31 || q == P - 1) {
          ext[static_cast<size_t>(x) * pw + (q >> 5)] = word;
          word = 0u;
        }
      }
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < PN; x += blockDim.x) {
    const int rt = mcs::find_root(parent, x);
    root[x] = rt;
    atomicMin(lab + rt, labels[x]);
  }
  __syncthreads();
  if (kBath && asym) relax_block(ext, root, lab, PN, n, pw, k0, Ps);
  for (int x = threadIdx.x; x < PN; x += blockDim.x) labels[x] = lab[root[x]];
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

// S7, one launch of mode `mode` (0 the draw and the block's labels, 1 a
// round, 2 the flip) on a rank's rows s (Ps, n) of a (P, n) chain, rows
// k0 ..; dn (n) the row below the block; full (P, n) every rank's rows or
// null (no bath); parent, lab, root (Ps n) int32 scratch kept from mode 0
// to the step's last launch; ext (Ps n ceil(P / 32)) the bath bits to
// other ranks; labels (Ps n) int32; bond_dn (n) bytes (mode 0 writes it);
// halo_prev, halo_next (n) int32 and bond_up (n) bytes the ring's rows;
// full_labels (P n) every rank's labels or null; changed (1); lut (P - 1)
// or null; asym != 0 when lut is not symmetric in ring distance. All
// device pointers; launches on `stream` and returns cudaGetLastError().
extern "C" int fk_shard_label(
    const int* nbr_idx, const float* nbr_J, const float* h, const int* perm,
    const float* b_sched, const float* jp, const float* lut, float* s,
    const float* dn, const float* full, int* parent, int* lab, int* root,
    unsigned* ext, int* labels, unsigned char* bond_dn, const int* halo_prev,
    const unsigned char* bond_up, const int* halo_next,
    const int* full_labels, int* changed, float teff, int Ps, int n,
    int maxnb, int P, int k0, int t, int seed, int mode, int asym,
    void* stream) {
  if (n == 0 || Ps == 0) return cudaSuccess;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  const size_t smem = 2 * static_cast<size_t>(P) * sizeof(float);
  auto kernel = lut ? fk_shard_label_kernel<true>
                    : fk_shard_label_kernel<false>;
  kernel<<<1, kLabelThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      nbr_idx, nbr_J, h, perm, b_sched, jp, lut, s, dn, full, parent, lab,
      root, ext, labels, bond_dn, halo_prev, bond_up, halo_next, full_labels,
      changed, teff, Ps, n, maxnb, P, k0, t, seed_term, mode,
      lut != nullptr && asym);
  return cudaGetLastError();
}

extern "C" const char* fk_shard_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
