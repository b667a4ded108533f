// Swendsen-Wang sweeps: the FK bond draw, the ghost-spin field bonds, the
// component labels and the coin flips of every cluster, the whole schedule
// in one launch.
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
// Labeling algorithm. Union-find on the nodes k * N + id, hooking the
// larger root under the smaller with atomicCAS (a failed hook retries from
// the new root) and halving paths as it finds. A root is hooked only under
// a smaller node of its own component, so the least node is never hooked:
// once every bond is united, each component's one root is its least node,
// the fixed point of the plain version's relaxation, whatever order the
// threads united in. The ghost flags then freeze the roots they reach.
// With `asym`, the components' labels (-1 frozen, else the root) then
// relax along the directed bath edges, label[root(a)] = min(label[root(a)],
// label[root(b)]) by atomicMin, in rounds until one changes nothing: the
// least label each node reaches, the plain version's fixed point again.
// The directed edges are drawn anew each round from the same hash.
// Union-find costs one pass over the bonds and near-constant work a union;
// relaxation costs a pass over the graph per hop of the diameter, which the
// percolating clusters of a cold FK draw make long.
//
// What bounds it on an H100. The draw: a hash and (where the bond is
// satisfied) an exp for every bond of the graph, maxnb / 2 spatial, one
// Trotter, (P - 1) / 2 bath and one ghost a site; chip_smoke.py's bound is
// their exponentials over the special-function rate, or the state's bytes.
//
// What the design does about that, simply (a first kernel): one CTA of 1024
// threads a chain, its threads striding over the sites; the parents and
// flags (and with `asym` the labels) in shared memory where P * N * 6 (10)
// bytes fit (LABEL_SMEM_BYTES in ops/cluster_kernels.py), else in device
// memory. No fast math.
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"
#include "fk.cuh"

namespace {

template <bool kBath>
__global__ void __launch_bounds__(1024)
fk_label_kernel(const int* __restrict__ nbr_idx,
                const float* __restrict__ nbr_J, const float* __restrict__ h,
                const int* __restrict__ perm,
                const float* __restrict__ b_sched,
                const float* __restrict__ jp_sched,
                const float* __restrict__ teff_sched,
                const float* __restrict__ lut, float* s, int* parent_g,
                unsigned char* flags_g, int P, int n, int maxnb, int steps,
                uint32_t seed_term, int use_smem, int asym,
                uint32_t chain0) {
  // p_same[P], p_diff[P], then with use_smem parent[P n] (int), with asym
  // the labels lab[P n] (int), and the ghost and frozen flags (P n bytes
  // each)
  extern __shared__ float dyn[];
  float* p_same = dyn;
  float* p_diff = dyn + P;
  // the state and scratch of local chain `chain`; every draw keyed by its
  // global index gchain (a chain shard's chains count from chain0)
  const int chain = blockIdx.x;
  const uint32_t gchain = chain0 + static_cast<uint32_t>(chain);
  const int PN = P * n;
  const int ints = asym ? 2 : 1;  // parent, and with asym lab
  int* parent;
  unsigned char* ghost;
  if (use_smem) {
    parent = reinterpret_cast<int*>(dyn + 2 * P);
    ghost = reinterpret_cast<unsigned char*>(parent + ints * PN);
  } else {
    parent = parent_g + static_cast<size_t>(chain) * ints * PN;
    ghost = flags_g + static_cast<size_t>(chain) * 2 * PN;
  }
  int* const lab = parent + PN;  // with asym only
  volatile int* const vlab = lab;
  unsigned char* frozen = ghost + PN;
  volatile unsigned char* vfrozen = frozen;
  float* sc = s + static_cast<size_t>(chain) * PN;
  const uint32_t row0 = gchain * P;

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
      for (int d = 1 + threadIdx.x; d < P; d += blockDim.x) {
        mcs::bath_probs(lut, d, teff, p_same + d, p_diff + d);
      }
    }
    for (int x = threadIdx.x; x < PN; x += blockDim.x) {
      parent[x] = x;
      ghost[x] = 0;
      frozen[x] = 0;
    }
    __syncthreads();

    // the FK draw, united as it is drawn
    const float two_b = __fmul_rn(2.0f, b);
    const float m2jp = __fmul_rn(-2.0f, jp);
    for (int e = threadIdx.x; e < PN; e += blockDim.x) {
      const int k = e / n, i = e - k * n;
      const int idi = __ldg(perm + i);
      const int node = k * n + idi;
      const uint32_t uid = (row0 + k) * n + idi;
      const float si = sc[e];
      const float de_h = __fmul_rn(__fmul_rn(two_b, __ldg(h + i)), si);
      if (mcs::uniform01(c_h, uid) < mcs::bond_prob(de_h, teff)) {
        ghost[node] = 1;
      }
      const int* ri = nbr_idx + static_cast<size_t>(i) * maxnb;
      const float* ji = nbr_J + static_cast<size_t>(i) * maxnb;
      for (int m = 0; m < maxnb; ++m) {
        const int j = __ldg(ri + m);
        const int idj = __ldg(perm + j);
        if (idi >= idj) continue;  // drawn from the lower id; pads excluded
        const float de = __fmul_rn(
            __fmul_rn(__fmul_rn(two_b, __ldg(ji + m)), si),
            sc[static_cast<size_t>(k) * n + j]);
        if (mcs::uniform01(c_sp, uid * static_cast<uint32_t>(maxnb) + m) <
            mcs::bond_prob(de, teff)) {
          mcs::unite(parent, node, k * n + idj);
        }
      }
      if (P > 1) {
        const int kp = k + 1 == P ? 0 : k + 1;
        const float de = __fmul_rn(__fmul_rn(m2jp, si),
                                   sc[static_cast<size_t>(kp) * n + i]);
        if (mcs::uniform01(c_t, uid) < mcs::bond_prob(de, teff)) {
          mcs::unite(parent, node, kp * n + idi);
        }
      }
      if (kBath) {
        const uint32_t line = (gchain * n + idi) * P;
        for (int q = k + 1; q < P; ++q) {
          const float sq = sc[static_cast<size_t>(q) * n + i];
          const float p = sq == si ? p_same[q - k] : p_diff[q - k];
          const float u = mcs::uniform01(
              c_b, (line + k) * static_cast<uint32_t>(P) + q);
          // asym: a bond both ways only; one way waits for the relaxation
          if (u < p && (!asym || u < (sq == si ? p_same[P - q + k]
                                               : p_diff[P - q + k])))
            mcs::unite(parent, node, q * n + idi);
        }
      }
    }
    __syncthreads();

    // a ghost bond freezes its component
    for (int x = threadIdx.x; x < PN; x += blockDim.x) {
      if (ghost[x]) vfrozen[mcs::find_root(parent, x)] = 1;
    }
    __syncthreads();

    if (kBath && asym) {
      // each component's label, then the directed bath edges' pulls
      for (int x = threadIdx.x; x < PN; x += blockDim.x) {
        if (parent[x] == x) lab[x] = vfrozen[x] ? -1 : x;
      }
      __syncthreads();
      for (;;) {
        int moved = 0;
        for (int e = threadIdx.x; e < PN; e += blockDim.x) {
          const int k = e / n, i = e - k * n;
          const int idi = __ldg(perm + i);
          const int node = k * n + idi;
          const float si = sc[e];
          const uint32_t line = (gchain * n + idi) * P;
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
            const int to = mcs::find_root(parent, fwd ? node : q * n + idi);
            const int from =
                mcs::find_root(parent, fwd ? q * n + idi : node);
            const int l = vlab[from];
            if (l < vlab[to]) {
              atomicMin(lab + to, l);
              moved = 1;
            }
          }
        }
        if (!__syncthreads_or(moved)) break;
      }
    }

    // every free component flips on the coin of its label: its least node,
    // or with asym the least label it reaches
    for (int e = threadIdx.x; e < PN; e += blockDim.x) {
      const int k = e / n, i = e - k * n;
      const int r = mcs::find_root(parent, k * n + __ldg(perm + i));
      const int l = kBath && asym ? vlab[r] : (vfrozen[r] ? -1 : r);
      if (l >= 0 &&
          mcs::uniform01(c_coin, gchain * PN + l) <
              0.5f) {
        sc[e] = -sc[e];
      }
    }
    __syncthreads();
  }
}

}  // namespace

// `steps` Swendsen-Wang sweeps of chains x (P, n) packed spins `s` in place,
// in one launch: the schedules B, J_perp, T_eff (steps,), the bath table
// lut (P - 1,) or null, asym != 0 when lut is not symmetric in ring
// distance, step0 the hash step of the first, chain0 the global index of
// the first chain, which keys the draws (a chain shard; 0 unsharded). With
// use_smem the union-find lives in shared memory; else parents (chains,
// P n) int32 (2 P n with asym: the labels beside) and flags (chains, 2 P n)
// bytes are device scratch. All device pointers; launches on `stream` and returns
// cudaGetLastError().
extern "C" int fk_label_anneal(const int* nbr_idx, const float* nbr_J,
                               const float* h, const int* perm,
                               const float* b_sched, const float* jp,
                               const float* teff, const float* lut, float* s,
                               int* parents, unsigned char* flags,
                               int chains, int P, int n, int maxnb,
                               int steps, int seed, int step0, int use_smem,
                               int asym, int threads, int chain0,
                               void* stream) {
  if (chains == 0 || n == 0 || P == 0 || steps == 0) return cudaSuccess;
  if (!use_smem && (parents == nullptr || flags == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult +
                             static_cast<uint32_t>(step0) * mcs::kStepMult;
  const size_t PN = static_cast<size_t>(P) * n;
  asym = lut != nullptr && asym;
  const size_t smem =
      2 * static_cast<size_t>(P) * sizeof(float) +
      (use_smem ? PN * ((asym ? 2 : 1) * sizeof(int) + 2) : 0);
  auto kernel = lut ? fk_label_kernel<true> : fk_label_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<chains, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      nbr_idx, nbr_J, h, perm, b_sched, jp, teff, lut, s, parents, flags, P,
      n, maxnb, steps, seed_term, use_smem, asym,
      static_cast<uint32_t>(chain0));
  return cudaGetLastError();
}

extern "C" const char* fk_label_anneal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
