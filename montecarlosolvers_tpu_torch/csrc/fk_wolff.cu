// Wolff space-time clusters: one cluster a chain and step, the whole
// schedule in one launch, each chain over a thread-block cluster of R
// CTAs.
//
// Replaces no TPU kernel: the JAX package runs this as XLA,
// montecarlosolvers_tpu/ops/cluster.py::wolff_update (:174), which draws
// every bond of the (P, N) space-time graph and grows the seed's component
// by a frontier BFS over the whole graph in a lax.while_loop
// (_seed_component :124). Plain PyTorch version:
// ops/cluster.py::wolff_anneal_ref (wolff_update on the counter hash).
//
// What it computes. A chain's P slices of N packed spins (+/-1 floats,
// packed.cuh). Step t (hash step step0 + t) at B_t, J_perp_t and T_eff_t:
// the seed (slice, packed position) from two uniforms, then the satisfied-
// bond FK cluster of rule "local" (pair bonds B J_ij, Trotter -J_perp, bath
// -T_eff lut[d-1], p = 1 - exp(dE / T_eff) where dE < 0) or the seed-sign-
// gated heuristic of rule "full" (each bond from the candidate's single-
// flip dE); rule "local" flips the cluster on a Metropolis accept of its
// field term, rule "full" always. A spatial pair is drawn from the row of
// its endpoint with the lower original id (rule "full": from either row,
// with the probability of the slot's candidate), once a slot, so duplicate
// slots of one pair union; self-pointing pad slots never bond. A bath pair
// (a, b), a < b, draws one uniform u: a is reached from b when u < p at
// ring offset b - a, b from a at offset P - (b - a).
//
// The cluster as the seed's component. A component is the same set
// whatever order it grows in, so the kernel draws every bond of the step's
// rule over the whole graph (exactly the draws the plain version's BFS
// reads), unites them (csrc/fk_nodes.cuh, the labeling core of
// fk_label.cu), and the cluster is every node whose root is the seed's.
// On a bath table not symmetric in ring distance (`asym`) a bath pair
// where one direction holds is a directed edge: the two-way pairs are
// united, and the one-way edges are followed from the seed's component in
// rounds (the reached roots flagged) until a round adds nothing in the
// whole cluster, the seed's directed reach, which the plain BFS finds.
//
// The one float sum that decides, the field term sum h_i s_i over the
// cluster, is added as the plain version adds it: each slice's terms in
// packed index order (a non-member's term +0.0, as the plain version's
// where()), one warp a slice (the lanes load, the adds stay in order),
// then the slices in order; with no fields it is 0 and is not summed.
//
// What bounds it on an H100. chip_smoke.py's bound is the cluster's work:
// the exponentials of the bonds drawn from the members (`visited`) over
// the special-function rate. This design draws the whole graph's bonds a
// step, so a small cluster costs as much as a large one, and pays no
// barrier a hop (a frontier BFS on one CTA a chain paid two, 1.20 ms a
// step where this design takes 0.34-0.36). On an H100 80GB HBM3 at 700 W
// (PERF.md §6): 0.36 ms a step at P = 40, one chain, rule "local" on the
// 80x80 torus's generic form (80,644 sites a cluster, 1,852x the bound),
// 1.14 at 16 chains (R = 6, the union-find in device memory), 0.078 at
// P = 1, 64 chains; with fields (random_2d_lattice(80)) 0.39 at one chain
// and 0.115 at 64, P = 1 (a thread a slice, as before: 2.10 and 1.05).
//
// The design. One chain over a cluster of R CTAs (ops/cluster_kernels.py::
// label_geometry), on fk_label.cu's labeling core (csrc/fk_nodes.cuh):
// CTA r owns the r-th chunk of sites in every slice and draws their bonds,
// its parents and two flags a node (the directed reach, the cluster
// member) in its shared memory where they fit, else in a device-memory
// region of the same layout; each site's Trotter line drawn by one thread
// as runs of bonded slices, then the bath and inside spatial bonds, then
// the boundary sites' bonds to other CTAs. Each phase of a step (reset and
// lines; inside bonds; boundary bonds; with `asym` the reach rounds; each
// local top resolved to its global root and marked a member or not; the
// members, counted and flipped, with fields after their row sums) ends
// with one cluster.sync(); no hop of the cluster costs a barrier. No fast
// math.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "counter_hash.cuh"
#include "fk.cuh"
#include "fk_nodes.cuh"
#include "packed.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kReachFlag = 0, kMemberFlag = 1;  // the flag bytes

struct Step {
  const int* nbr_idx;
  const float* nbr_J;
  const float* h;
  const int* perm;
  const float* sc;  // the chain's (P, n) spins
  int P, n, maxnb;
  uint32_t chain;  // the chain's global index
  float b, jp, teff, kval;
  uint32_t c_sp, c_t, c_b;
};

// rule "full": the single-flip dE of candidate (k, j) with the seed sign
// kval: (-2 B kval) f + (2 J_perp kval)(s[k-1] + s[k+1])
__device__ __forceinline__ float site_de(const Step& st, int k, int j) {
  const float* row = st.sc + static_cast<size_t>(k) * st.n;
  const float f = mcs::packed_field(row, st.nbr_idx, st.nbr_J, st.h, j,
                                    st.maxnb);
  const float up = st.sc[static_cast<size_t>((k + st.P - 1) % st.P) * st.n
                         + j];
  const float dn = st.sc[static_cast<size_t>((k + 1) % st.P) * st.n + j];
  return __fadd_rn(
      __fmul_rn(__fmul_rn(__fmul_rn(-2.0f, st.b), st.kval), f),
      __fmul_rn(__fmul_rn(__fmul_rn(2.0f, st.jp), st.kval),
                __fadd_rn(up, dn)));
}

// uniform of spatial slot m of packed row r (original id id_r) at slice k
__device__ __forceinline__ float sp_uniform(const Step& st, int k, int id_r,
                                            int m) {
  const uint32_t uid =
      ((st.chain * st.P + k) * st.n + id_r) *
          static_cast<uint32_t>(st.maxnb) + m;
  return mcs::uniform01(st.c_sp, uid);
}

// The bath pair (k, q), k < q, of packed spin i: its two directions, k
// reached from q (fwd, ring offset q - k) and q from k (back)
template <bool kRuleFull>
__device__ __forceinline__ bool bath_pair(const Step& st,
                                          const float* p_same,
                                          const float* p_diff, int k, int q,
                                          int i, float sk, bool* fwd,
                                          bool* back) {
  const float sq = st.sc[static_cast<size_t>(q) * st.n + i];
  if (kRuleFull && sq != st.kval) return false;
  const uint32_t line = st.chain * st.n + __ldg(st.perm + i);
  const float u = mcs::uniform01(
      st.c_b, (line * st.P + k) * static_cast<uint32_t>(st.P) + q);
  const bool same = sq == sk;
  *fwd = u < (same ? p_same[q - k] : p_diff[q - k]);
  *back = u < (same ? p_same[st.P - q + k] : p_diff[st.P - q + k]);
  return true;
}

template <bool kRuleFull, bool kBath, bool kOnChip>
__global__ void __launch_bounds__(1024, 1)
fk_wolff_kernel(const int* __restrict__ nbr_idx,
                const float* __restrict__ nbr_J, const float* __restrict__ h,
                const int* __restrict__ perm,
                const int* __restrict__ inv_perm,
                const int* __restrict__ boundary,
                const float* __restrict__ b_sched,
                const float* __restrict__ jp_sched,
                const float* __restrict__ teff_sched,
                const float* __restrict__ lut, float* s, char* regions_g,
                float* terms_g, long long* visited, int P, int n, int maxnb,
                int steps, int R, uint32_t seed_term, int asym,
                uint32_t chain0) {
  // the head, p_same[P], p_diff[P] (the bath by ring offset), then (on
  // chip) this CTA's region
  extern __shared__ __align__(16) unsigned char wolff_smem[];
  float* const p_same =
      reinterpret_cast<float*>(wolff_smem + mcs::kNodesHeadBytes);
  float* const p_diff = p_same + P;
  cg::cluster_group cluster = cg::this_cluster();
  const int chain = blockIdx.x / R;
  const uint32_t gchain = chain0 + static_cast<uint32_t>(chain);
  const int PN = P * n;
  const bool directed = kBath && asym;
  const size_t off = mcs::kNodesHeadBytes + 2 * P * sizeof(float);
  const size_t rb = mcs::region_bytes(P * ((n + R - 1) / R), 1);
  const mcs::Core<kOnChip> core = mcs::make_core<kOnChip>(
      cluster, wolff_smem, R, P, n, 1, off,
      kOnChip ? nullptr : regions_g + static_cast<size_t>(chain) * R * rb);
  const int rank = core.rank;
  const int nc = core.nc, slots = core.slots, y0 = core.y0;
  const int id0 = rank * nc;
  const int ns = min(nc, n - id0);  // own sites (the last CTA's are fewer)
  // the own sites with a neighbour in another CTA's chunk
  const int* const bsites = boundary + R + 1 + __ldg(boundary + rank);
  const int nb = __ldg(boundary + rank + 1) - __ldg(boundary + rank);
  mcs::FastDiv by_nb;
  by_nb.init(static_cast<uint32_t>(nb > 0 ? nb : 1));
  mcs::NodesHead* const head = core.head;
  float* sc = s + static_cast<size_t>(chain) * PN;
  // the chain's P n terms of the field sum, then its P row sums
  float* const terms =
      terms_g == nullptr ? nullptr
                         : terms_g + static_cast<size_t>(chain) * (PN + P);
  float* const rows = terms == nullptr ? nullptr : terms + PN;
  __syncthreads();  // the head's region addresses, before the first reset

  Step st{nbr_idx, nbr_J, h, perm, sc, P, n, maxnb, gchain,
          0.0f, 0.0f, 0.0f, 0.0f, 0u, 0u, 0u};
  // with no field the field term is 0 whatever the cluster: not summed
  bool nonzero = false;
  for (int i = threadIdx.x; i < n; i += blockDim.x) nonzero |= h[i] != 0.0f;
  const bool sums = !kRuleFull && __syncthreads_or(nonzero);
  int round = 0;
  for (int t = 0; t < steps; ++t) {
    st.b = __ldg(b_sched + t);
    st.jp = __ldg(jp_sched + t);
    st.teff = __ldg(teff_sched + t);
    st.c_sp = mcs::cluster_counter(seed_term, t, mcs::kSpBond);
    st.c_t = mcs::cluster_counter(seed_term, t, mcs::kTrotterBond);
    st.c_b = mcs::cluster_counter(seed_term, t, mcs::kBathBond);
    const uint32_t c_seed =
        mcs::cluster_counter(seed_term, t, mcs::kWolffSeed);
    const int seed_k = mcs::index_draw(
        mcs::uniform01(c_seed, 2u * gchain + 1u), P);
    const int seed_i =
        mcs::index_draw(mcs::uniform01(c_seed, 2u * gchain), n);
    st.kval = sc[static_cast<size_t>(seed_k) * n + seed_i];
    if (kBath) {
      for (int d = 1 + threadIdx.x; d < P; d += blockDim.x)
        mcs::bath_probs(lut, d, st.teff, p_same + d, p_diff + d);
    }
    if (threadIdx.x == 0) head->count = 0ull;
    const float two_b = __fmul_rn(2.0f, st.b);
    const float m2jp = __fmul_rn(-2.0f, st.jp);
    // own slot w is node (k, id0 + lid); past the last site (the last
    // CTA's short chunk) a slot is empty
    for (int w = threadIdx.x; w < slots; w += blockDim.x) {
      const int y = y0 + w;
      core.set_flag(y, kReachFlag, 0);
      core.set_flag(y, kMemberFlag, 0);
      if (w - core.by_nc.div(w) * nc >= ns) core.set_parent(y, y);
    }
    // each own site's Trotter line, a thread a site: bond (k - 1, k) drawn
    // as slice k - 1 draws it (rule "full": both spins the seed's, with
    // slice k's single-flip dE), each node's parent the least slice of its
    // run of bonded slices, the run through the ring bond (P - 1, 0)
    // hooked under slice 0's
    for (int lid = threadIdx.x; lid < ns; lid += blockDim.x) {
      const int id = id0 + lid;
      const int i = __ldg(inv_perm + id);
      const int first = y0 + lid;
      int run = first;
      core.set_parent(first, first);
      const float s0 = sc[i];
      float prev = s0;
      for (int k = 1; k <= P; ++k) {
        const int kk = k == P ? 0 : k;
        const float sk = k == P ? s0 : sc[static_cast<size_t>(k) * n + i];
        bool on = false;
        if (P > 1 && (!kRuleFull || (prev == st.kval && sk == st.kval))) {
          const float de = kRuleFull ? site_de(st, kk, i)
                                     : __fmul_rn(__fmul_rn(m2jp, prev), sk);
          on = mcs::uniform01(st.c_t, (gchain * P + k - 1) * n + id) <
               mcs::bond_prob(de, st.teff);
        }
        if (k == P) {
          if (on && run != first) core.set_parent(run, first);
        } else if (on) {
          core.set_parent(first + k * nc, run);
        } else {
          run = first + k * nc;
          core.set_parent(run, run);
        }
        prev = sk;
      }
    }
    cluster.sync();  // every region reset (the head, at t = 0, in place)

    // the rest of the bonds of the rule at the own nodes, united: first
    // those whose other node is this CTA's too (the bath bonds, the
    // spatial ones inside its sites), then the spatial ones to another
    // CTA's sites, from the boundary sites (none at R = 1)
    for (int pass = 0; pass < (R > 1 ? 2 : 1); ++pass) {
      const int work = pass == 0 ? slots : P * nb;
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
        const float si = sc[static_cast<size_t>(k) * n + i];
        if (kRuleFull && si != st.kval) continue;  // bonds with nothing
        const int* ri = nbr_idx + static_cast<size_t>(i) * maxnb;
        const float* ji = nbr_J + static_cast<size_t>(i) * maxnb;
        for (int m = 0; m < maxnb; ++m) {
          const int j = __ldg(ri + m);
          const int idj = __ldg(perm + j);
          // rule "full": every slot but a pad; "local": from the lower id
          if (kRuleFull ? j == i : id >= idj) continue;
          const bool inside = static_cast<unsigned>(idj - id0) <
                              static_cast<unsigned>(nc);
          if (inside != (pass == 0)) continue;
          const size_t yj = static_cast<size_t>(k) * n + j;
          float p;
          if (!kRuleFull) {
            p = mcs::bond_prob(
                __fmul_rn(__fmul_rn(__fmul_rn(two_b, __ldg(ji + m)), si),
                          sc[yj]),
                st.teff);
          } else {
            if (sc[yj] != st.kval) continue;
            p = mcs::bond_prob(site_de(st, k, j), st.teff);
          }
          if (sp_uniform(st, k, id, m) < p)
            core.unite(y, inside ? y + idj - id : core.node(k, idj));
        }
        if (pass) continue;
        if (kBath) {
          for (int q = k + 1; q < P; ++q) {
            bool fwd, back;
            if (bath_pair<kRuleFull>(st, p_same, p_diff, k, q, i, si, &fwd,
                                     &back) &&
                fwd && back)
              core.unite(y, y + (q - k) * nc);  // one way: the rounds
          }
        }
      }
      cluster.sync();
    }
    if (threadIdx.x == 0)
      head->root = core.find_global(core.node(seed_k, __ldg(perm + seed_i)));
    __syncthreads();
    const int seed_root = head->root;

    if (directed) {
      // the one-way bath edges, followed from the cluster's roots
      for (;;) {
        int moved = 0;
        for (int w = threadIdx.x; w < slots; w += blockDim.x) {
          const int k = core.by_nc.div(w);
          const int id = id0 + w - k * nc;
          if (id >= n) continue;
          const int y = y0 + w;
          const int i = __ldg(inv_perm + id);
          const float si = sc[static_cast<size_t>(k) * n + i];
          if (kRuleFull && si != st.kval) continue;
          for (int q = k + 1; q < P; ++q) {
            bool fwd, back;
            if (!bath_pair<kRuleFull>(st, p_same, p_diff, k, q, i, si, &fwd,
                                      &back) ||
                fwd == back)
              continue;
            const int yq = y + (q - k) * nc;
            const int from = core.find_root(fwd ? yq : y);
            if (from != seed_root && !core.flag(from, kReachFlag)) continue;
            const int to = core.find_root(fwd ? y : yq);
            if (to != seed_root && !core.flag(to, kReachFlag)) {
              core.set_flag(to, kReachFlag, 1);
              moved = 1;
            }
          }
        }
        if (!core.any(cluster, moved, ++round)) break;
      }
    }

    // each local top to its global root g, and whether g's component is
    // the cluster
    for (int w = threadIdx.x; w < slots; w += blockDim.x) {
      const int y = y0 + w;
      const int p = core.parent(y);
      if (p != y && core.mine(p)) continue;
      const int g = p == y ? y : core.find_global(p);
      if (g != y) core.set_parent(y, g);
      core.set_flag(y, kMemberFlag,
                    g == seed_root ||
                        (directed && core.flag(g, kReachFlag)));
    }
    cluster.sync();

    // the members: counted, and (no field sum to wait for) flipped
    unsigned count = 0u;
    for (int w = threadIdx.x; w < slots; w += blockDim.x) {
      const int k = core.by_nc.div(w);
      const int id = id0 + w - k * nc;
      if (id >= n) continue;
      const bool member =
          core.flag(core.local_top(y0 + w), kMemberFlag);
      count += member;
      const int i = __ldg(inv_perm + id);
      const size_t e = static_cast<size_t>(k) * n + i;
      if (sums) {
        terms[e] = member ? __fmul_rn(__ldg(h + i), sc[e]) : 0.0f;
      } else if (member) {
        // rule "full", or rule "local" with no field: the accept of
        // -2B * 0 holds whatever its uniform
        sc[e] = -sc[e];
      }
    }
    if (sums) {
      cluster.sync();  // every term written
      // a warp a slice: the lanes load 32 terms at once (the next 32
      // while these are added), and every lane adds them in order from
      // -0.0, which leaves the first term as it is (-0 + x == x)
      const int lane = threadIdx.x & 31;
      const int warps = blockDim.x >> 5;
      for (int k = rank + R * (threadIdx.x >> 5); k < P; k += R * warps) {
        const float* row = terms + static_cast<size_t>(k) * n;
        float acc = -0.0f;
        float v = lane < n ? row[lane] : 0.0f;
        for (int i0 = 0; i0 < n; i0 += 32) {
          const int next = i0 + 32 + lane;
          const float ahead = next < n ? row[next] : 0.0f;
          if (i0 + 32 <= n) {
#pragma unroll
            for (int j = 0; j < 32; ++j)
              acc = __fadd_rn(acc, __shfl_sync(kFull, v, j));
          } else {
            for (int j = 0; j < n - i0; ++j)
              acc = __fadd_rn(acc, __shfl_sync(kFull, v, j));
          }
          v = ahead;
        }
        if (lane == 0) rows[k] = acc;
      }
      cluster.sync();  // every row sum written
      if (threadIdx.x == 0) {
        float tot = rows[0];
        for (int k = 1; k < P; ++k) tot = __fadd_rn(tot, rows[k]);
        const float de = __fmul_rn(__fmul_rn(-2.0f, st.b), tot);
        const float u = mcs::uniform01(
            mcs::cluster_counter(seed_term, t, mcs::kAccept), gchain);
        head->accept = mcs::metropolis_accept(de, st.teff, u) ? 1 : 0;
      }
      __syncthreads();
      if (head->accept) {
        for (int w = threadIdx.x; w < slots; w += blockDim.x) {
          const int k = core.by_nc.div(w);
          const int id = id0 + w - k * nc;
          if (id >= n || !core.flag(core.local_top(y0 + w), kMemberFlag))
            continue;
          const size_t e = static_cast<size_t>(k) * n + __ldg(inv_perm + id);
          sc[e] = -sc[e];
        }
      }
    }
    if (visited != nullptr) {
      for (int o = 16; o > 0; o >>= 1)
        count += __shfl_down_sync(kFull, count, o);
      if ((threadIdx.x & 31) == 0)
        atomicAdd(&head->count, static_cast<unsigned long long>(count));
      __syncthreads();
      if (threadIdx.x == 0 && head->count)
        atomicAdd(reinterpret_cast<unsigned long long*>(visited + chain),
                  head->count);
    }
    cluster.sync();  // the flips land before the next step reads them
  }
}

template <bool kRuleFull, bool kBath, bool kOnChip>
cudaError_t launch(int chains, int R, int threads, size_t smem,
                   cudaStream_t stream, const int* nbr_idx,
                   const float* nbr_J, const float* h, const int* perm,
                   const int* inv_perm, const int* boundary,
                   const float* b_sched,
                   const float* jp, const float* teff, const float* lut,
                   float* s, char* regions, float* terms, long long* visited,
                   int P, int n, int maxnb, int steps, uint32_t seed_term,
                   int asym, uint32_t chain0) {
  auto kernel = fk_wolff_kernel<kRuleFull, kBath, kOnChip>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = mcs::cluster_config(kernel, chains * R, R, threads, smem,
                                      stream, &cfg, &attr);
  if (e != cudaSuccess) return e;
  return cudaLaunchKernelEx(&cfg, kernel, nbr_idx, nbr_J, h, perm, inv_perm,
                            boundary, b_sched, jp, teff, lut, s, regions,
                            terms,
                            visited, P, n, maxnb, steps, R, seed_term, asym,
                            chain0);
}

}  // namespace

// One Wolff cluster a chain and step for `steps` steps, in one launch of
// chains clusters of R CTAs of `threads` threads: chains x (P, n) packed
// spins `s` in place, the schedules B, J_perp and T_eff (steps,), the bath
// table lut (P - 1,) or null, asym != 0 when lut is not symmetric in ring
// distance, rule_full != 0 for rule "full". regions: null when each CTA's
// region of the union-find sits in its shared memory, else device scratch
// of chains x R regions (fk_nodes.cuh::region_bytes of P ceil(n / R)
// nodes, one int32 array); inv_perm (n,) the packed position of each
// original site index; boundary: R + 1 offsets, then each CTA's sites with
// a neighbour in another CTA's chunk (ops/cluster_kernels.py::
// boundary_sites); terms (chains, P n + P) float scratch, the field
// sum's terms and row sums under rule "local" (null under rule "full");
// visited (chains,) int64, or null, gains each chain's cluster sizes.
// step0: the hash step of the first step; chain0: the global index of the
// first chain, which keys the draws (a chain shard; 0 unsharded). All
// device pointers; launches on `stream` and returns cudaGetLastError().
extern "C" int fk_wolff_anneal(const int* nbr_idx, const float* nbr_J,
                               const float* h, const int* perm,
                               const int* inv_perm, const int* boundary,
                               const float* b_sched, const float* jp,
                               const float* teff,
                               const float* lut, float* s, char* regions,
                               float* terms, long long* visited, int chains,
                               int P, int n, int maxnb, int steps, int seed,
                               int step0, int rule_full, int R, int asym,
                               int threads, int chain0, void* stream) {
  if (chains == 0 || n == 0 || P == 0 || steps == 0) return cudaSuccess;
  if (R < 1 || R > mcs::kMaxRanks || R > n) return cudaErrorInvalidValue;
  if (!rule_full && terms == nullptr) return cudaErrorInvalidValue;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult +
                             static_cast<uint32_t>(step0) * mcs::kStepMult;
  asym = lut != nullptr && asym;
  const size_t smem =
      mcs::nodes_smem_bytes(P, n, R, 1, 2 * P, regions == nullptr);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using Launch = decltype(&launch<true, true, true>);
  const Launch go[2][2][2] = {
      {{launch<false, false, false>, launch<false, false, true>},
       {launch<false, true, false>, launch<false, true, true>}},
      {{launch<true, false, false>, launch<true, false, true>},
       {launch<true, true, false>, launch<true, true, true>}}};
  cudaError_t e = go[rule_full != 0][lut != nullptr][regions == nullptr](
      chains, R, threads, smem, st, nbr_idx, nbr_J, h, perm, inv_perm,
      boundary, b_sched, jp, teff, lut, s, regions, terms, visited, P, n,
      maxnb, steps, seed_term, asym, static_cast<uint32_t>(chain0));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Clusters of R CTAs of `threads` threads the card holds at once at P
// slices of n sites: the instantiation fk_wolff_anneal launches with
// rule_full, a bath table (bath) or none, and the union-find in shared
// memory (on_chip) or in device memory
extern "C" int fk_wolff_max_active_clusters(int P, int n, int R,
                                            int rule_full, int bath,
                                            int on_chip, int threads,
                                            int* count) {
  const size_t smem = mcs::nodes_smem_bytes(P, n, R, 1, 2 * P, on_chip != 0);
  using Kernel = decltype(&fk_wolff_kernel<true, true, true>);
  const Kernel kernels[2][2][2] = {
      {{fk_wolff_kernel<false, false, false>,
        fk_wolff_kernel<false, false, true>},
       {fk_wolff_kernel<false, true, false>,
        fk_wolff_kernel<false, true, true>}},
      {{fk_wolff_kernel<true, false, false>,
        fk_wolff_kernel<true, false, true>},
       {fk_wolff_kernel<true, true, false>,
        fk_wolff_kernel<true, true, true>}}};
  return mcs::max_active_clusters(
      kernels[rule_full != 0][bath != 0][on_chip != 0], R, threads, smem,
      count);
}

extern "C" const char* fk_wolff_anneal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
