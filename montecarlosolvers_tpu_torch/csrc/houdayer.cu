// Houdayer isoenergetic cluster move between replica pairs: the overlap
// q = s1 s2, the components of its q = -1 domain, and a fair coin a
// component that flips it in both replicas.
//
// Replaces no TPU kernel: the JAX package runs this as XLA,
// montecarlosolvers_tpu/ops/cluster.py::houdayer_sweep (:730) and its grid
// form houdayer_sweep_grid (:704), which label the domain's components by
// min-label relaxation in a lax.while_loop, one round a hop of the largest
// component's diameter; parallel tempering's ICM (solvers/pt.py::
// _icm_impl) calls it every `houdayer_every` sweeps. Plain PyTorch
// versions: ops/cluster.py::houdayer_move_ref (houdayer_sweep on the coins
// of houdayer_coins) and, for the move on the packed engine's state,
// ops/cluster_kernels.py::houdayer_move_packed_ref (unpack, the move,
// repack); wrappers ops/cluster_kernels.py::houdayer_move and
// houdayer_move_packed.
//
// What it computes. For each pair p of (n,) spins s1, s2 (+/-1 floats),
// a bond (i, j) of the neighbour table is active when its coupling is
// nonzero and q_i = q_j = -1. Each component of the active bonds is
// labelled by its least site id (the problem's generic order: a
// LatticeProblem's to_generic() numbers site (r, c) r * L + c, the grid
// form's raveled index), the unique fixed point of the JAX min-label
// relaxation (both JAX forms reach it: the generic from the index, the
// grid form from the index with q = +1 sites at n). Each q = -1 site i
// flips in both replicas when the coin of its label is heads:
// uniform01(counter(seed, step, SAMPLER_INDEX + HOUDAYER), (pair0 + p) * n
// + label) < 0.5, so every member reads one coin. flipped[p] receives the
// count of flipped sites (the numerator of houdayer_flip_frac).
//
// What bounds it on an H100. A pass over the table (n * maxnb slots), the
// two replicas read and written once, a union an active bond, a find and a
// hash a site: about 10 MB for 48 pairs of 6400 spins; the bound is those
// bytes over the memory rate (chip_smoke.py::houdayer_bound).
//
// Two kernels, chosen by shape alone (ops/cluster_kernels.py::
// houdayer_geometry):
//
// houdayer_cluster_kernel (LAUNCHES["houdayer"]), the design for the card:
// - A pair over a thread-block cluster of R CTAs (where there are fewer
//   pairs than SMs a pair spreads over several: R the largest power of
//   two whose pairs x R CTAs fit the SMs, within the card's residency,
//   ops/cluster_kernels.py::houdayer_geometry), on the labeling core of
//   csrc/fk_nodes.cuh with P = 1, its union-find in shared memory: CTA r
//   owns the sites of ids [r nc, (r + 1) nc), their parents and a q flag
//   byte each in its shared memory, and the key of a node is its site id,
//   so each root is its component's least id.
// - q computed once: one pass reads each own site's two spins (an id
//   chunk, near-coalesced through the packing's inverse permutation) and
//   stores q = -1 as the flag byte; the union passes read q from there (a
//   neighbour in another CTA through distributed shared memory), never a
//   float a bond.
// - The unions of the core (hook the root of the larger key under the
//   smaller by CAS, relaxed cluster-scope accesses, path halving), bonds
//   inside a CTA first, then the bonds of its boundary sites; a site then
//   reaches its root through its own CTA's parents and, read only, the
//   others'. The single-CTA `volatile` walks of the first kernel are gone.
// - The engine's state in place: with `ror` the replicas are rows of one
//   (B * 2 * M, n) state in the packed engine's order (solvers/
//   _engines.py::ClassicalEngine, kind "packed"): pair p = b M + m is
//   replica ror[b, 0, m] of ladder 0 and ror[b, 1, m] of ladder 1, site
//   id perm[i] at packed column i. No unpack, gather, stack or repack
//   around the move, no copy of the state.
// - The table once a graph: each site id's row of neighbour ids by a
//   nonzero coupling (ops/cluster_kernels.py::houdayer_table), read ahead
//   into registers, so a bond costs no dependent load of an index, a
//   coupling and a permutation entry.
// - Fewer unions: each site's parent starts as its least active
//   neighbour of a smaller id in the CTA (the initialisation of Jaiganesh
//   and Burtscher's ECL-CC) and is then pointed at its root, so the unions
//   hook few roots and their finds are short; the unions inside a CTA run
//   on plain shared-memory accesses (fk.cuh::SharedSets), and each node
//   again points at its root before the unions across CTAs.
// - Three cluster barriers a move: after the unions inside each CTA,
//   after those across CTAs, and before the CTAs leave; the counts go to
//   flipped[p] by one atomic add a warp (rank 0 zeroes it first).
//
// houdayer_wide_kernel, the first kernel kept as the route for a pair
// whose union-find no cluster of 16 CTAs holds in shared memory (n past
// 619,152 sites; LAUNCHES["houdayer_wide"]): one CTA of 1024 threads a
// pair, its threads striding over the sites, the parents in shared memory
// where they fit, else in device scratch; the union-find of fk.cuh. It
// takes the replicas in site order only.
//
// Both label and flip the same sites on the same coins: they equal each
// other and the plain versions bitwise.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "counter_hash.cuh"
#include "fk.cuh"
#include "fk_nodes.cuh"

namespace {

// counter_rng.SAMPLER_INDEX and the Houdayer coin's stream
constexpr int kSamplerIndex = 24;
constexpr int kHoudayerCoin = 3;

__global__ void __launch_bounds__(1024)
houdayer_wide_kernel(const int* __restrict__ nbr_idx,
                     const float* __restrict__ nbr_J, float* s1, float* s2,
                     int* __restrict__ flipped, int* parent_g, int n,
                     int maxnb, uint32_t seed_term, int step, int use_smem,
                     uint32_t pair0) {
  extern __shared__ int dyn[];
  __shared__ int count;
  const int pair = blockIdx.x;
  int* parent =
      use_smem ? dyn : parent_g + static_cast<size_t>(pair) * n;
  float* a = s1 + static_cast<size_t>(pair) * n;
  float* b = s2 + static_cast<size_t>(pair) * n;
  if (threadIdx.x == 0) count = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) parent[i] = i;
  __syncthreads();

  // unite every active bond; a symmetric table unites each pair twice,
  // which the union-find ignores
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (a[i] * b[i] >= 0.0f) continue;  // q_i = +1
    const int* ri = nbr_idx + static_cast<size_t>(i) * maxnb;
    const float* ji = nbr_J + static_cast<size_t>(i) * maxnb;
    for (int m = 0; m < maxnb; ++m) {
      const int j = __ldg(ri + m);
      if (__ldg(ji + m) == 0.0f || a[j] * b[j] >= 0.0f) continue;
      mcs::unite(parent, i, j);
    }
  }
  __syncthreads();

  // every q = -1 component flips in both replicas on its least id's coin
  const uint32_t ctr =
      mcs::counter(seed_term, step, kSamplerIndex + kHoudayerCoin);
  // uid = pair*n + label, the pair counted from pair0 (the first pair of a
  // rung block of a sharded ladder)
  const uint32_t uid0 =
      (pair0 + static_cast<uint32_t>(pair)) * static_cast<uint32_t>(n);
  int mine = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float ai = a[i], bi = b[i];
    if (ai * bi >= 0.0f) continue;
    const int r = mcs::find_root(parent, i);
    if (mcs::uniform01(ctr, uid0 + static_cast<uint32_t>(r)) < 0.5f) {
      a[i] = -ai;
      b[i] = -bi;
      ++mine;
    }
  }
  if (mine) atomicAdd(&count, mine);
  __syncthreads();
  if (threadIdx.x == 0) flipped[pair] = count;
}

namespace cg = cooperative_groups;

constexpr int kQFlag = 0;  // the flag byte that holds q = -1

// The rows of pair `pair`'s two replicas: with `ror` (B, 2, M) int64 the
// rows of ladder 0's and ladder 1's replica at rung m of ladder pair b,
// pair = b M + m, in a (B * 2 * M, n) state; without, row `pair` of s1 and
// of s2
__device__ __forceinline__ void pair_rows(const long long* __restrict__ ror,
                                          int M, int pair, size_t* r1,
                                          size_t* r2) {
  if (ror == nullptr) {
    *r1 = *r2 = static_cast<size_t>(pair);
    return;
  }
  const int b = pair / M, m = pair - b * M;
  const size_t l0 = static_cast<size_t>(2 * b) * M;
  *r1 = l0 + static_cast<size_t>(__ldg(ror + l0 + m));
  *r2 = l0 + M + static_cast<size_t>(__ldg(ror + l0 + M + m));
}

// slots of a site's row of smaller neighbours (ops/cluster_kernels.py::
// houdayer_table) a thread holds in registers at once
constexpr int kNbrSlots = 8;

__global__ void __launch_bounds__(1024, 1)
houdayer_cluster_kernel(const int* __restrict__ nbr_ids,
                        const int* __restrict__ inv_perm,
                        const int* __restrict__ boundary,
                        const long long* __restrict__ ror, float* s1,
                        float* s2, int* __restrict__ flipped, int n,
                        int maxnb, int M, int R, uint32_t seed_term,
                        int step, uint32_t pair0) {
  // the head, then this CTA's region of the union-find
  extern __shared__ __align__(16) unsigned char houdayer_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int pair = blockIdx.x / R;
  // the head and the region at fk_label's offsets at P = 1 (two unused
  // floats after the head), so that cluster_kernels.label_smem_bytes
  // counts this kernel's shared memory too
  const size_t off = mcs::kNodesHeadBytes + 2 * sizeof(float);
  const mcs::Core<true> core =
      mcs::make_core<true>(cluster, houdayer_smem, R, 1, n, 1, off, nullptr);
  const int nc = core.nc, y0 = core.y0;
  const int id0 = core.rank * nc;
  const int ns = min(nc, n - id0);  // own sites (the last CTA's are fewer)
  const int* const bsites = boundary + R + 1 + __ldg(boundary + core.rank);
  const int nb = __ldg(boundary + core.rank + 1) - __ldg(boundary + core.rank);
  size_t r1, r2;
  pair_rows(ror, M, pair, &r1, &r2);
  float* const a = s1 + r1 * n;
  float* const b = s2 + r2 * n;
  // the own q flags, the core's flag bytes read as a plain shared-memory
  // array (written before the barrier that precedes every read)
  unsigned char* const own_q =
      houdayer_smem + off + 4 * static_cast<size_t>(core.slots);
  auto q_of = [&](int lid) { return static_cast<int>(own_q[lid]); };
  // the ids of own site lid's neighbours of smaller id in the slots m0 ..
  // m0 + kNbrSlots - 1 of its row (-1 for none), loaded at once into
  // registers
  auto row_of = [&](int lid, int m0, int (&ids)[kNbrSlots]) {
    const int* r = nbr_ids + static_cast<size_t>(id0 + lid) * maxnb + m0;
#pragma unroll
    for (int m = 0; m < kNbrSlots; ++m)
      ids[m] = m0 + m < maxnb ? __ldg(r + m) : -1;
  };
  // the unions inside the CTA on its own parents by plain shared
  // accesses (no other CTA reaches them until the barrier after them),
  // node y at its slot y - y0
  const mcs::SharedSets own{core.cta0 - 4u * static_cast<uint32_t>(y0)};
  if (core.rank == 0 && threadIdx.x == 0) flipped[pair] = 0;
  __syncthreads();  // the head's region addresses, before the first node

  // q of every own site, as its flag byte
  for (int w = threadIdx.x; w < nc; w += blockDim.x) {
    int neg = 0;
    if (w < ns) {
      const int i = inv_perm ? __ldg(inv_perm + id0 + w) : id0 + w;
      neg = a[i] * b[i] < 0.0f;
    }
    own_q[w] = static_cast<unsigned char>(neg);
  }
  __syncthreads();
  // each own site's parent: its least active neighbour of a smaller id in
  // the CTA, else itself (a forest whose keys fall toward the roots, so
  // that the unions below hook far fewer roots)
  for (int w = threadIdx.x; w < nc; w += blockDim.x) {
    int p = w;
    for (int m0 = 0; w < ns && q_of(w) && m0 < maxnb; m0 += kNbrSlots) {
      int ids[kNbrSlots];
      row_of(w, m0, ids);
#pragma unroll
      for (int m = 0; m < kNbrSlots; ++m) {
        const int lj = ids[m] - id0;
        if (ids[m] >= 0 && lj >= 0 && lj < p && q_of(lj)) p = lj;
      }
    }
    core.set_parent(y0 + w, y0 + p);
  }
  __syncthreads();
  // every own node straight to its root in the CTA, so that the unions'
  // finds are short
  for (int w = threadIdx.x; w < ns; w += blockDim.x)
    own.set_parent(y0 + w, own.find(y0 + w));
  __syncthreads();

  // unite every active bond, from its larger id: those inside the CTA's
  // ids, then (R > 1) those of its boundary sites to lower CTAs' ids
  for (int pass = 0; pass < (R > 1 ? 2 : 1); ++pass) {
    const int work = pass == 0 ? ns : nb;
    for (int w = threadIdx.x; w < work; w += blockDim.x) {
      const int lid = pass == 0 ? w : __ldg(bsites + w) - id0;
      if (!q_of(lid)) continue;
      const int y = y0 + lid;
      // one slot after another (an unrolled loop would inline a union a
      // slot); the row's first load brings it to L1 for the rest
      const int* row = nbr_ids + static_cast<size_t>(id0 + lid) * maxnb;
      for (int m = 0; m < maxnb; ++m) {
        const int idj = __ldg(row + m);
        if (idj < 0) continue;
        const bool inside = static_cast<unsigned>(idj - id0) <
                            static_cast<unsigned>(nc);
        if (inside != (pass == 0)) continue;
        if (inside) {
          if (q_of(idj - id0)) own.unite(y, y0 + idj - id0);
        } else {
          const int yj = core.node(0, idj);
          if (core.flag(yj, kQFlag)) core.unite(y, yj);
        }
      }
    }
    if (pass == 0) {
      // every own node straight to its root in the CTA
      __syncthreads();
      for (int w = threadIdx.x; w < ns; w += blockDim.x)
        own.set_parent(y0 + w, own.find(y0 + w));
    }
    // the unions land before the next reads
    if (R > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  }

  // every q = -1 component flips in both replicas on its least id's coin,
  // uid = (pair0 + pair) * n + label; a site reaches its root through its
  // own CTA's parents, then (read only) through the others'
  const uint32_t ctr =
      mcs::counter(seed_term, step, kSamplerIndex + kHoudayerCoin);
  const uint32_t uid0 =
      (pair0 + static_cast<uint32_t>(pair)) * static_cast<uint32_t>(n);
  int mine = 0;
  for (int w = threadIdx.x; w < ns; w += blockDim.x) {
    if (!q_of(w)) continue;
    const int top = core.local_top(y0 + w);
    const int p = core.parent(top);
    const int label = core.key(p == top ? top : core.find_global(p));
    if (mcs::uniform01(ctr, uid0 + static_cast<uint32_t>(label)) < 0.5f) {
      const int i = inv_perm ? __ldg(inv_perm + id0 + w) : id0 + w;
      a[i] = -a[i];
      b[i] = -b[i];
      ++mine;
    }
  }
  // the CTA's count, a warp's at a time, into flipped[pair] (rank 0 set
  // it to 0 before the first barrier)
  mine = __reduce_add_sync(0xffffffffu, mine);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(flipped + pair, mine);
  if (R > 1) cluster.sync();  // no CTA leaves while another reads it
}

// The dynamic shared memory each instantiation was last given leave to
// use, a slot a device: cudaFuncSetAttribute once a shape, not each call
template <typename Kernel>
cudaError_t ensure_smem(Kernel kernel, size_t smem, int* set) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (set[dev] >= static_cast<int>(smem)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess) set[dev] = static_cast<int>(smem);
  return e;
}

int g_cluster_smem[64];  // a device's
bool g_cluster_wide[64];  // the non-portable size allowed
int g_first_smem[64];

cudaError_t launch_cluster(int pairs, int R, int threads, size_t smem,
                           cudaStream_t stream, const int* nbr_ids,
                           const int* inv_perm, const int* boundary,
                           const long long* ror, float* s1, float* s2,
                           int* flipped, int n, int maxnb, int M,
                           uint32_t seed_term, int step, uint32_t pair0) {
  auto kernel = houdayer_cluster_kernel;
  cudaError_t e = ensure_smem(kernel, smem, g_cluster_smem);
  if (e != cudaSuccess) return e;
  int dev = 0;
  cudaGetDevice(&dev);
  if (R > 8 && !g_cluster_wide[dev]) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    g_cluster_wide[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(pairs * R);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = R;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, nbr_ids, inv_perm, boundary, ror,
                            s1, s2, flipped, n, maxnb, M, R, seed_term, step,
                            pair0);
}

}  // namespace

// One Houdayer move of `pairs` replica pairs on the cluster kernel, in
// place: nbr_ids (n, maxnb), row id the ids of site id's neighbours by a
// nonzero coupling, -1 in the other slots (ops/cluster_kernels.py::
// houdayer_table); inv_perm (n): the replicas' column of each site id,
// null when the columns are the ids themselves;
// boundary: R + 1 offsets, then each CTA's sites (ids) with a neighbour in
// another CTA's chunk (ops/cluster_kernels.py::boundary_sites); ror: null
// for replicas s1, s2 (pairs, n), else (B, 2, M) int64 replica_of_rung
// and s1 = s2 the (B * 2 * M, n) state (pairs = B M); flipped (pairs,)
// int32 out; each CTA's union-find in its shared memory (ops/
// cluster_kernels.py::houdayer_geometry finds an R that holds it, or
// none). The coins at
// counter(seed, step, SAMPLER_INDEX + HOUDAYER), pair0 the global index of
// the first pair (a rung block of a sharded ladder; 0 unsharded). All
// device pointers; launches on `stream` and returns cudaGetLastError().
extern "C" int houdayer_cluster_move(const int* nbr_ids,
                                     const int* inv_perm,
                                     const int* boundary,
                                     const long long* ror, float* s1,
                                     float* s2, int* flipped, int pairs,
                                     int n, int maxnb, int M,
                                     int seed, int step, int R, int threads,
                                     int pair0, void* stream) {
  if (pairs == 0 || n == 0) return cudaSuccess;
  if (R < 1 || R > mcs::kMaxRanks || R > n || threads > 1024 ||
      threads % 32 != 0 || (ror != nullptr && (M < 1 || pairs % M != 0))) {
    return cudaErrorInvalidValue;
  }
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  const size_t smem = mcs::nodes_smem_bytes(1, n, R, 1, 2, true);
  cudaError_t e = launch_cluster(
      pairs, R, threads, smem, static_cast<cudaStream_t>(stream), nbr_ids,
      inv_perm, boundary, ror, s1, s2, flipped, n, maxnb, M, seed_term, step,
      static_cast<uint32_t>(pair0));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Clusters of R CTAs of `threads` threads of houdayer_cluster_kernel the
// card holds at once at n sites
extern "C" int houdayer_max_active_clusters(int n, int R, int threads,
                                            int* count) {
  const size_t smem = mcs::nodes_smem_bytes(1, n, R, 1, 2, true);
  const cudaError_t e = mcs::max_active_clusters(houdayer_cluster_kernel, R,
                                                 threads, smem, count);
  // the query left the kernel's shared-memory attribute at `smem`: the
  // next launch that needs more sets it again
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess && dev >= 0 && dev < 64)
    g_cluster_smem[dev] = static_cast<int>(smem);
  return e;
}

// One Houdayer move of `pairs` replica pairs s1, s2 (pairs, n) on the
// first kernel, houdayer_wide_kernel, in place: the table nbr_idx / nbr_J
// (n, maxnb) in the problem's generic order, the coins at counter(seed,
// step, SAMPLER_INDEX + HOUDAYER), flipped (pairs,) int32 out. With use_smem the parents live in shared memory (n * 4 bytes);
// else parents (pairs, n) int32 is device scratch. pair0: the global index
// of the first pair, which the coins' uids count from (a rung block of a
// sharded ladder; 0 unsharded). All device pointers; launches on `stream`
// and returns cudaGetLastError().
extern "C" int houdayer_move(const int* nbr_idx, const float* nbr_J,
                             float* s1, float* s2, int* flipped,
                             int* parents, int pairs, int n, int maxnb,
                             int seed, int step, int use_smem, int threads,
                             int pair0, void* stream) {
  if (pairs == 0 || n == 0) return cudaSuccess;
  if (!use_smem && parents == nullptr) return cudaErrorInvalidValue;
  const size_t smem = use_smem ? static_cast<size_t>(n) * sizeof(int) : 0;
  cudaError_t err = ensure_smem(houdayer_wide_kernel, smem, g_first_smem);
  if (err != cudaSuccess) return err;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  houdayer_wide_kernel<<<pairs, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      nbr_idx, nbr_J, s1, s2, flipped, parents, n, maxnb, seed_term, step,
      use_smem, static_cast<uint32_t>(pair0));
  return cudaGetLastError();
}

extern "C" const char* houdayer_move_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
