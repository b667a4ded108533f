// Swendsen-Wang sweeps: the FK bond draw, the ghost-spin field bonds, the
// component labels and the coin flips of every cluster, the whole schedule
// in one launch, each chain over a thread-block cluster of R CTAs.
//
// Replaces no TPU kernel: the JAX package runs this as XLA,
// montecarlosolvers_tpu/ops/cluster.py::classical_sw_sweep (:559, P = 1)
// and spacetime_sw_sweep (:874, P slices, optional bath), which label the
// components by min-label relaxation in a lax.while_loop
// (_label_components :487), one round a hop of the largest component's
// diameter. Plain PyTorch version: ops/cluster.py::sw_anneal_ref.
//
// What it computes. A chain's P slices of N packed spins. Step t (hash step
// step0 + t) at B_t, J_perp_t, T_eff_t draws each spatial pair once from
// the row of its lower-id endpoint (duplicate slots each draw, and any of
// them bonds), each Trotter bond (k, k + 1) for P > 1, each bath pair of a
// line and each site's ghost bond, p = 1 - exp(dE / T_eff) where dE < 0. A
// component with a ghost bond is frozen; every other flips on the coin of
// its label, its least node k * N + id (id: the site's original index).
// A bath pair (a, b), a < b, draws one uniform u, and slice a takes b's
// label when u < p[a][b], b takes a's when u < p[b][a], the probabilities
// of ring offsets b - a and P - (b - a) (the plain version's relaxation
// reads active_bath[a][b] so). On a table symmetric in ring distance
// (every table schedules.bath_lookuptable gives) the two are equal and the
// pair is one undirected bond; on any other table (`asym`) a pair where
// only one holds is a directed edge, and a node's label is then the least
// label it reaches: -1 if it reaches a frozen component.
//
// Labeling algorithm (csrc/fk_nodes.cuh). Union-find on the nodes k * N +
// id, hooking the larger root under the smaller, so that once every bond is
// united each component's one root is its least node, the fixed point of
// the plain version's relaxation, whatever order the threads united in.
// The ghost flags then freeze the roots they reach. With `asym`, the
// components' labels (-1 frozen, else the root) then relax along the
// directed bath edges, label[root(a)] = min(label[root(a)],
// label[root(b)]) by atomicMin, in rounds until one changes nothing in the
// whole cluster: the least label each node reaches, the plain version's
// fixed point again. The directed edges are drawn anew each round from the
// same hash.
//
// What bounds it on an H100. The draw: a hash and (where the bond is
// satisfied) an exp for every bond of the graph, maxnb / 2 spatial, one
// Trotter and one ghost a site, and (P - 1) / 2 bath pairs a site, each a
// hash and a comparison against the step's table of 2 (P - 1)
// probabilities; chip_smoke.py's bound is the exponentials over the
// special-function rate, or the state's bytes (which bound it here).
// What holds it back is the unions: a find's dependent shared-memory reads
// a bond. On an H100 80GB HBM3 at 700 W (PERF.md §6): 0.81 ms a step at
// P = 40, 8 chains on the 80x80 torus's generic form (R = 9, 166x the
// bound; one CTA a chain took 9.47-9.51), 1.96 with the bath at alpha =
// 1e-2 (400x), 0.094 at P = 1, 64 chains.
//
// The design. One chain over a cluster of R CTAs (R from ops/
// cluster_kernels.py::label_geometry: from the SM count, then the largest
// whose chains' clusters the card holds at once, at most 16), chains along
// gridDim.x / R, on the
// labeling core of csrc/fk_nodes.cuh: CTA r owns the r-th chunk of sites in
// every slice, their parents, ghost and frozen flags (and with `asym` the
// labels) in its shared memory, where they fit, or in a device-memory
// region of the same layout. A step: the reset, each site's Trotter line
// drawn by one thread as runs of bonded slices; the bath and spatial bonds
// inside the CTA's sites, united; the spatial bonds of its boundary sites
// to other CTAs', united through distributed shared memory; the freeze of
// the ghosts' local tops and their global roots; with `asym` the
// relaxation rounds; the resolve of each local top to its global root; the
// coins and flips. Each phase ends with one cluster.sync(). The spins are
// read as floats from device memory, where a step's 8 chains x 40 x 6400
// floats (8 MB) stay in L2 (a copy as bits in each CTA's shared memory was
// not built: with no bond drawn, every read and hash kept, a step took a
// tenth of its time, PERF.md §6). No fast math.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "counter_hash.cuh"
#include "fk.cuh"
#include "fk_nodes.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kGhostFlag = 0, kFrozenFlag = 1;  // the flag bytes

template <bool kBath, bool kOnChip>
__global__ void __launch_bounds__(1024, 1)
fk_label_kernel(const int* __restrict__ nbr_idx,
                const float* __restrict__ nbr_J, const float* __restrict__ h,
                const int* __restrict__ perm,
                const int* __restrict__ inv_perm,
                const int* __restrict__ boundary,
                const float* __restrict__ b_sched,
                const float* __restrict__ jp_sched,
                const float* __restrict__ teff_sched,
                const float* __restrict__ lut, float* s, char* regions_g,
                int P, int n, int maxnb, int steps, int R,
                uint32_t seed_term, int asym, uint32_t chain0) {
  // the head, p_same[P], p_diff[P], then (on chip) this CTA's region
  extern __shared__ __align__(16) unsigned char label_smem[];
  float* const p_same =
      reinterpret_cast<float*>(label_smem + mcs::kNodesHeadBytes);
  float* const p_diff = p_same + P;
  cg::cluster_group cluster = cg::this_cluster();
  const int chain = blockIdx.x / R;
  const uint32_t gchain = chain0 + static_cast<uint32_t>(chain);
  const int PN = P * n;
  const bool directed = kBath && asym;
  const int ints = directed ? 2 : 1;
  const size_t off = mcs::kNodesHeadBytes + 2 * P * sizeof(float);
  const size_t rb = mcs::region_bytes(P * ((n + R - 1) / R), ints);
  const mcs::Core<kOnChip> core = mcs::make_core<kOnChip>(
      cluster, label_smem, R, P, n, ints, off,
      kOnChip ? nullptr : regions_g + static_cast<size_t>(chain) * R * rb);
  const int nc = core.nc, slots = core.slots, y0 = core.y0;
  const int id0 = core.rank * nc;
  const int ns = min(nc, n - id0);  // own sites (the last CTA's are fewer)
  // the own sites with a neighbour in another CTA's chunk
  const int* const bsites = boundary + R + 1 + __ldg(boundary + core.rank);
  const int nb = __ldg(boundary + core.rank + 1) - __ldg(boundary + core.rank);
  mcs::FastDiv by_nb;
  by_nb.init(static_cast<uint32_t>(nb > 0 ? nb : 1));
  float* sc = s + static_cast<size_t>(chain) * PN;
  const uint32_t row0 = gchain * P;
  int round = 0;
  __syncthreads();  // the head's region addresses, before the first reset

  for (int t = 0; t < steps; ++t) {
    const float b = __ldg(b_sched + t);
    const float jp = __ldg(jp_sched + t);
    const float teff = __ldg(teff_sched + t);
    const uint32_t c_sp = mcs::cluster_counter(seed_term, t, mcs::kSpBond);
    const uint32_t c_t =
        mcs::cluster_counter(seed_term, t, mcs::kTrotterBond);
    const uint32_t c_b = mcs::cluster_counter(seed_term, t, mcs::kBathBond);
    const uint32_t c_h = mcs::cluster_counter(seed_term, t, mcs::kGhost);
    const uint32_t c_coin = mcs::cluster_counter(seed_term, t, mcs::kCoin);
    if (kBath) {
      for (int d = 1 + threadIdx.x; d < P; d += blockDim.x)
        mcs::bath_probs(lut, d, teff, p_same + d, p_diff + d);
    }
    const float two_b = __fmul_rn(2.0f, b);
    const float m2jp = __fmul_rn(-2.0f, jp);
    // own slot w is node (k, id0 + lid) of key k n + id; past the last
    // site (the last CTA's short chunk) a slot is empty
    for (int w = threadIdx.x; w < slots; w += blockDim.x) {
      const int y = y0 + w;
      core.set_flag(y, kGhostFlag, 0);
      core.set_flag(y, kFrozenFlag, 0);
      if (w - core.by_nc.div(w) * nc >= ns) core.set_parent(y, y);
    }
    // each own site's Trotter line, a thread a site: bond (k - 1, k) drawn
    // as slice k - 1 draws it, each node's parent the least slice of its
    // run of bonded slices, the run through the ring bond (P - 1, 0) hooked
    // under slice 0's
    for (int lid = threadIdx.x; lid < ns; lid += blockDim.x) {
      const int id = id0 + lid;
      const int i = __ldg(inv_perm + id);
      const int first = y0 + lid;
      int run = first;
      core.set_parent(first, first);
      const float s0 = sc[i];
      float prev = s0;
      for (int k = 1; k < P; ++k) {
        const int y = first + k * nc;
        const float sk = sc[static_cast<size_t>(k) * n + i];
        const float de = __fmul_rn(__fmul_rn(m2jp, prev), sk);
        if (mcs::uniform01(c_t, (row0 + k - 1) * n + id) <
            mcs::bond_prob(de, teff)) {
          core.set_parent(y, run);
        } else {
          run = y;
          core.set_parent(y, y);
        }
        prev = sk;
      }
      if (P > 1 && run != first &&
          mcs::uniform01(c_t, (row0 + P - 1) * n + id) <
              mcs::bond_prob(__fmul_rn(__fmul_rn(m2jp, prev), s0), teff))
        core.set_parent(run, first);
    }
    cluster.sync();  // every region reset (the head, at t = 0, in place)

    // the rest of the FK draw of the own nodes' bonds, united as they are
    // drawn: first those whose other node is this CTA's too (the bath
    // bonds, the spatial ones inside its sites), then the spatial ones to
    // another CTA's sites, from the boundary sites (none at R = 1)
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
        const uint32_t uid = (row0 + k) * n + id;
        const float si = sc[static_cast<size_t>(k) * n + i];
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
              sc[static_cast<size_t>(k) * n + j]);
          if (mcs::uniform01(c_sp, uid * static_cast<uint32_t>(maxnb) + m) <
              mcs::bond_prob(de, teff))
            core.unite(y, inside ? y + idj - id : core.node(k, idj));
        }
        if (pass) continue;
        const float de_h = __fmul_rn(__fmul_rn(two_b, __ldg(h + i)), si);
        if (mcs::uniform01(c_h, uid) < mcs::bond_prob(de_h, teff))
          core.set_flag(y, kGhostFlag, 1);
        if (kBath) {
          const uint32_t line = (gchain * n + id) * P;
          for (int q = k + 1; q < P; ++q) {
            const float sq = sc[static_cast<size_t>(q) * n + i];
            const float p = sq == si ? p_same[q - k] : p_diff[q - k];
            const float u = mcs::uniform01(
                c_b, (line + k) * static_cast<uint32_t>(P) + q);
            // asym: a bond both ways only; one way waits for the relaxation
            if (u < p && (!asym || u < (sq == si ? p_same[P - q + k]
                                                 : p_diff[P - q + k])))
              core.unite(y, y + (q - k) * nc);
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

    if (directed) {
      // each component's label at its root, then the directed bath edges'
      // pulls
      for (int w = threadIdx.x; w < slots; w += blockDim.x) {
        const int y = y0 + w;
        if (core.parent(y) == y)
          core.set_second(y, core.flag(y, kFrozenFlag) ? -1 : core.key(y));
      }
      cluster.sync();
      for (;;) {
        int moved = 0;
        for (int w = threadIdx.x; w < slots; w += blockDim.x) {
          const int k = core.by_nc.div(w);
          const int id = id0 + w - k * nc;
          if (id >= n) continue;
          const int y = y0 + w;
          const int i = __ldg(inv_perm + id);
          const float si = sc[static_cast<size_t>(k) * n + i];
          const uint32_t line = (gchain * n + id) * P;
          for (int q = k + 1; q < P; ++q) {
            const float sq = sc[static_cast<size_t>(q) * n + i];
            const bool same = sq == si;
            const float u = mcs::uniform01(
                c_b, (line + k) * static_cast<uint32_t>(P) + q);
            const bool fwd = u < (same ? p_same[q - k] : p_diff[q - k]);
            const bool back =
                u < (same ? p_same[P - q + k] : p_diff[P - q + k]);
            if (fwd == back) continue;  // no edge, or a united bond
            // `to` takes the label of `from`
            const int yq = y + (q - k) * nc;
            const int to = core.find_root(fwd ? y : yq);
            const int from = core.find_root(fwd ? yq : y);
            const int l = core.second(from);
            if (l < core.second(to)) {
              core.min_second(to, l);
              moved = 1;
            }
          }
        }
        if (!core.any(cluster, moved, ++round)) break;
      }
    }

    // each local top with another CTA's parent to its global root g, with
    // g's label: -1 frozen, else g's key, or with asym the least label g
    // reaches
    for (int w = threadIdx.x; R > 1 && w < slots; w += blockDim.x) {
      const int y = y0 + w;
      const int p = core.parent(y);
      if (core.mine(p)) continue;
      const int g = core.find_global(p);
      core.set_parent(y, g);
      if (directed)
        core.set_second(y, core.second(g));
      else
        core.set_flag(y, kFrozenFlag, core.flag(g, kFrozenFlag));
    }
    cluster.sync();

    // every free component flips on the coin of its label
    for (int w = threadIdx.x; w < slots; w += blockDim.x) {
      const int k = core.by_nc.div(w);
      const int id = id0 + w - k * nc;
      if (id >= n) continue;
      const int top = core.local_top(y0 + w);
      const int l = directed ? core.second(top)
                             : (core.flag(top, kFrozenFlag)
                                    ? -1
                                    : core.key(core.parent(top)));
      if (l >= 0 && mcs::uniform01(c_coin, gchain * PN + l) < 0.5f) {
        float* si = sc + static_cast<size_t>(k) * n + __ldg(inv_perm + id);
        *si = -*si;
      }
    }
    cluster.sync();  // the flips land before the next draw reads them
  }
}

template <bool kBath, bool kOnChip>
cudaError_t launch_label(int chains, int R, int threads, size_t smem,
                         cudaStream_t stream, const int* nbr_idx,
                         const float* nbr_J, const float* h, const int* perm,
                         const int* inv_perm, const int* boundary,
                         const float* b_sched,
                         const float* jp, const float* teff,
                         const float* lut, float* s, char* regions, int P,
                         int n, int maxnb, int steps, uint32_t seed_term,
                         int asym, uint32_t chain0) {
  auto kernel = fk_label_kernel<kBath, kOnChip>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = mcs::cluster_config(kernel, chains * R, R, threads, smem,
                                      stream, &cfg, &attr);
  if (e != cudaSuccess) return e;
  return cudaLaunchKernelEx(&cfg, kernel, nbr_idx, nbr_J, h, perm, inv_perm,
                            boundary, b_sched, jp, teff, lut, s, regions, P,
                            n, maxnb, steps, R, seed_term, asym, chain0);
}

}  // namespace

// `steps` Swendsen-Wang sweeps of chains x (P, n) packed spins `s` in place,
// in one launch of chains clusters of R CTAs of `threads` threads: the
// schedules B, J_perp, T_eff (steps,), the bath table lut (P - 1,) or null,
// asym != 0 when lut is not symmetric in ring distance, step0 the hash step
// of the first, chain0 the global index of the first chain, which keys the
// draws (a chain shard; 0 unsharded). inv_perm (n,): the packed position
// of each original site index; boundary: R + 1 offsets, then each CTA's
// sites with a neighbour in another CTA's chunk, CTA r's at offsets r ..
// r + 1 (ops/cluster_kernels.py::boundary_sites). regions: null when each
// CTA's region of the union-find sits in its shared memory, else device
// scratch of chains x R regions (fk_nodes.cuh::region_bytes of P ceil(n /
// R) nodes and 1, with asym 2, int32 arrays). All device pointers;
// launches on `stream` and returns cudaGetLastError().
extern "C" int fk_label_anneal(const int* nbr_idx, const float* nbr_J,
                               const float* h, const int* perm,
                               const int* inv_perm, const int* boundary,
                               const float* b_sched, const float* jp,
                               const float* teff, const float* lut, float* s,
                               char* regions, int chains, int P, int n,
                               int maxnb, int steps, int seed, int step0,
                               int R, int asym, int threads, int chain0,
                               void* stream) {
  if (chains == 0 || n == 0 || P == 0 || steps == 0) return cudaSuccess;
  if (R < 1 || R > mcs::kMaxRanks || R > n) return cudaErrorInvalidValue;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult +
                             static_cast<uint32_t>(step0) * mcs::kStepMult;
  asym = lut != nullptr && asym;
  const size_t smem = mcs::nodes_smem_bytes(P, n, R, asym ? 2 : 1, 2 * P,
                                            regions == nullptr);
  auto go = regions == nullptr
                ? (lut ? launch_label<true, true> : launch_label<false, true>)
                : (lut ? launch_label<true, false>
                       : launch_label<false, false>);
  cudaError_t e = go(chains, R, threads, smem,
                     static_cast<cudaStream_t>(stream), nbr_idx, nbr_J, h,
                     perm, inv_perm, boundary, b_sched, jp, teff, lut, s,
                     regions, P, n, maxnb, steps, seed_term, asym,
                     static_cast<uint32_t>(chain0));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Clusters of R CTAs of `threads` threads the card holds at once at P
// slices of n sites: the instantiation fk_label_anneal launches with a
// bath table (bath) or none, asym, and the union-find in shared memory
// (on_chip) or in device memory
extern "C" int fk_label_max_active_clusters(int P, int n, int R, int bath,
                                            int asym, int on_chip,
                                            int threads, int* count) {
  const size_t smem = mcs::nodes_smem_bytes(P, n, R, bath && asym ? 2 : 1,
                                            2 * P, on_chip != 0);
  auto kernel = on_chip ? (bath ? fk_label_kernel<true, true>
                                : fk_label_kernel<false, true>)
                        : (bath ? fk_label_kernel<true, false>
                                : fk_label_kernel<false, false>);
  return mcs::max_active_clusters(kernel, R, threads, smem, count);
}

extern "C" const char* fk_label_anneal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
