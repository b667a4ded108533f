// Generic SVMC: class-major rotor sweeps of an IsingProblem graph on carried
// cos / sin caches, uniform or TF proposals, the whole schedule in one
// launch.
//
// Replaces no TPU kernel: the JAX package runs this path as an XLA scan,
// montecarlosolvers_tpu/ops/packed.py::packed_svmc_scan (:298), whose body
// is packed_svmc_sweep_cached (:149) under _svmc_scan (:237). Plain
// PyTorch version: ops/generic_kernels.py::packed_svmc_anneal_ref
// (ops/packed.py::packed_svmc_sweep_cached on the counter hash), which
// equals the masked ops/svmc_ops.py::svmc_sweep_cached bitwise.
//
// What it computes. A chain's N rotor angles theta in [0, pi], in packed
// order (packed.cuh), with cos theta and sin theta carried beside them.
// Step t at (A_t, B_t) visits the C color blocks in order; every site i of
// a block proposes pi*u, or with TF proposals clip(theta + min(A/B, 1) *
// (2 pi u - pi), 0, pi) (svmc.cuh), u = uniform01(counter(seed, t, 0),
// chain * N + perm[i]), and accepts on dE = B (cos' - cos) z + A (sin -
// sin'), z = sum_k J cos_nb + h (packed.cuh::packed_field on the cos
// cache), if dE <= 0 or -T log1p(-u') > dE, u' at svmc_accept_counter(seed,
// t, 0) and the same uid. With `energies`, the classical energy of
// sign(cos theta) after step t goes into energies[t, chain], reduced in
// the kernel.
//
// Noisy anneals (svmc.anneal_noisy): step t reads its tables at nbr_J +
// (t / mcsteps) * j_stride and h + (t / mcsteps) * h_stride, strides 0 for
// the static tables, as csrc/packed_sa.cu does; the JAX package's
// montecarlosolvers_tpu/ops/packed.py::_noisy_svmc_scan (:259) over
// packed_svmc_sweep_cached(nbr_J=, h=) (:149). The uniforms are the static
// kernel's two streams, so equal table rows give the static anneal's
// angles.
//
// What bounds it on an H100. Per update: two hashed uniforms, one sincosf
// of the proposal, log1pf, maxnb gathered cos values and couplings and
// about 12 rounded float operations: issue- and special-function-bound.
// The main path's 256 chains of 6400 rotors keep three floats a site, 19.7
// MB, in L2.
//
// Two kernels, chosen by shape alone in ops/generic_kernels.py::
// packed_svmc_anneal (packed_svmc_geometry), each running the whole
// schedule in one launch.
//
// The first kernel (the first design, kept unchanged): one CTA of 256
// threads a chain, theta and both caches in device memory (any N, any
// color count), a __syncthreads() between blocks. It runs the "_wide"
// route (a graph whose slots no cluster of 16 CTAs holds, or of more than
// 127 classes) and, by a rule of size, a proper packing of small class
// phases, where it beats the cluster route's barrier. Each update is a
// serial chain of loads (nbr_idx, then the neighbour's cos through L1/L2,
// then nbr_J, slot after slot), and 256 CTAs on 132 SMs leave about 16
// warps an SM to hide them: 25x its bound at the main path's shape, 2x
// kernel 4 on the same torus (PERF.md). On a packing that is not proper
// (kImproper) each class phase first copies its block of cos theta into
// the scratch `snap`, one block a chain, and the fields read same-class
// neighbours there, as they stood before the phase, as the plain version
// (vectorised over the class) and packed SA's first kernel read them.
//
// The cluster route (packed_svmc_cluster_kernel): kernel 4's idea
// (csrc/split_svmc.cu: a chain's rotors in shared memory over a cluster
// of CTAs) on generic PIQMC's slot layout (ops/generic_kernels.py::
// word_layout).
// - One chain over a cluster of R CTAs (R of 1, 2, 4, 8, 16). CTA r holds,
//   of every class c, the r-th of R equal chunks, ceil(n_c / R) slots at
//   slot_starts[c]: slot l of class c is packed site starts[c] + r *
//   chunk + (l - slot_starts[c]), computed, not loaded. Each CTA keeps
//   cos theta, theta and sin theta of its nr slots in its shared memory,
//   12 bytes a slot (77 KB a chain of 6400 rotors at R = 1).
// - A neighbour's cos comes from its owner's shared memory: nbr_loc (N,
//   maxnb) holds (CTA << 16) | slot; with R > 1 through distributed shared
//   memory (cluster.map_shared_rank), with R = 1 a plain shared load. A
//   thread loads the first kSlotCache slots' locations and couplings, then
//   their cos, all at once, so the loads overlap (one slot after another
//   ran 1-11 % slower a sweep, PERF.md); the sum keeps the slot order.
// - The classes run in order, one cluster.sync() a class (__syncthreads()
//   at R = 1). On a packing that is not proper (an odd torus's
//   checkerboard) a phase first copies cos into a snapshot (4 more bytes a
//   slot) and reads every neighbour from it after one more barrier, so a
//   same-class neighbour stands as the phase began, as the plain version
//   (vectorised over the class) reads it.
// - The kernel loads the float (chains, N) angles and computes the caches
//   itself, and stores the angles out of place: no launch wraps it.
// - With `energies`, each CTA sums its slots' share of the classical
//   energy of sign(cos theta) in a fixed order (energy.cuh::block_sum) and
//   CTA 0 adds the R shares in rank order: no atomics.
// ops/generic_kernels.py::packed_svmc_geometry takes the largest R whose
// slots fit a CTA and whose clusters the card holds at once for every
// chain (cudaOccupancyMaxActiveClusters, packed_svmc_max_active_clusters).
//
// Both kernels compute the same thing in the same order: the proposal,
// sincosf, log1pf, both hashed uniforms at uid (chain0 + chain) * N +
// perm[i], and the field in slot order with __fmul_rn / __fadd_rn, as in
// svmc.cuh and packed.cuh; on a proper packing they agree bitwise.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "counter_hash.cuh"
#include "energy.cuh"
#include "packed.cuh"
#include "svmc.cuh"

namespace {

namespace cg = cooperative_groups;

template <bool kTF, bool kImproper>
__global__ void __launch_bounds__(mcs::kPackedThreads)
packed_svmc_kernel(const int* __restrict__ nbr_idx,
                   const float* __restrict__ nbr_J,
                   const float* __restrict__ h, const int* __restrict__ perm,
                   const int* __restrict__ starts,
                   const float* __restrict__ a_sched,
                   const float* __restrict__ b_sched, float temp, float* th,
                   float* cs, float* sn, float* snap,
                   float* __restrict__ energies, int chains, int n,
                   int maxnb, int ncolors, int steps, uint32_t seed_term,
                   int j_stride, int h_stride, int mcsteps,
                   uint32_t chain0) {
  __shared__ float red[mcs::kPackedThreads / 32];
  const int chain = blockIdx.x;
  const size_t base = static_cast<size_t>(chain) * n;
  th += base;
  cs += base;
  sn += base;
  float* const ss = kImproper ? snap + base : nullptr;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sincosf(th[i], sn + i, cs + i);
  }
  __syncthreads();
  // uid = chain*n + perm[i], the chain counted from chain0 (the first chain
  // of a chain shard; the acceptance counter is XORed, so the offset is no
  // seed-term offset)
  const uint32_t uid0 = (chain0 + static_cast<uint32_t>(chain)) *
                        static_cast<uint32_t>(n);
  for (int t = 0; t < steps; ++t) {
    const float a = __ldg(a_sched + t);
    const float b = __ldg(b_sched + t);
    const float width = kTF ? mcs::tf_width(a, b) : 0.0f;
    const uint32_t ctr = mcs::counter(seed_term, t, 0);
    const uint32_t ctr_acc = mcs::svmc_accept_counter(seed_term, t, 0);
    const size_t row = static_cast<size_t>(t / mcsteps);
    const float* jt = nbr_J + row * j_stride;
    const float* ht = h + row * h_stride;
    for (int c = 0; c < ncolors; ++c) {
      const int lo = __ldg(starts + c), hi = __ldg(starts + c + 1);
      if (kImproper) {
        // the last __syncthreads() ended every read of the snapshot
        for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) ss[i] = cs[i];
        __syncthreads();
      }
      for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
        const uint32_t uid = uid0 + static_cast<uint32_t>(__ldg(perm + i));
        const float theta = th[i];
        const float prop =
            mcs::propose<kTF>(theta, mcs::uniform01(ctr, uid), width);
        float sin_p, cos_p;
        sincosf(prop, &sin_p, &cos_p);
        const float z =
            kImproper
                ? mcs::field_in_phase(cs, ss, nbr_idx, jt, ht, i, maxnb, lo,
                                      hi)
                : mcs::packed_field(cs, nbr_idx, jt, ht, i, maxnb);
        const float de = mcs::delta_e(b, a, cos_p, cs[i], z, sn[i], sin_p);
        if (mcs::metropolis_accept_hashed(de, temp,
                                          uid * mcs::kGolden + ctr_acc)) {
          th[i] = prop;
          cs[i] = cos_p;
          sn[i] = sin_p;
        }
      }
      __syncthreads();
    }
    if (energies != nullptr) {
      const float e = mcs::packed_block_energy<true>(cs, nbr_idx, jt, ht, n,
                                                     maxnb, red);
      if (threadIdx.x == 0) {
        energies[static_cast<size_t>(t) * chains + chain] = e;
      }
    }
  }
}

// The cluster route: at most this many threads a CTA and registers for
// kSvmcMinBlocks CTAs an SM (ops/generic_kernels.py::SVMC_THREADS,
// SVMC_BLOCKS_PER_SM); the dynamic shared memory starts with a head of
// kSvmcHeadBytes (block_sum's warp sums and the CTA's energy share), then
// cos, theta, sin and, on a packing that is not proper, the snapshot of
// cos, nr floats each (ops/generic_kernels.py::svmc_smem_bytes)
constexpr int kSvmcThreads = 256;
constexpr int kSvmcMinBlocks = 4;
constexpr int kSvmcHeadBytes = 64;
static_assert(kSvmcHeadBytes >= (kSvmcThreads / 32 + 1) * 4,
              "the head holds the warp sums and the share");

// The local field of packed site i, sum_k J[i, k] cos_nb in slot order,
// then h: packed.cuh::packed_field's order on the cluster's shared cos,
// the neighbour at nbr_loc (CTA << 16) | slot
// neighbour slots whose locations, couplings and cos a thread loads
// ahead, all at once; the slots past it are read one after another
constexpr int kSlotCache = 6;

template <bool kCluster>
__device__ __forceinline__ float cluster_field(
    const cg::cluster_group& cluster, float* cos_base,
    const int* __restrict__ nbr_loc, const float* __restrict__ nbr_J,
    const float* __restrict__ h, int i, int maxnb) {
  const int* ri = nbr_loc + static_cast<size_t>(i) * maxnb;
  const float* rj = nbr_J + static_cast<size_t>(i) * maxnb;
  auto read = [&](int loc) {
    if (!kCluster) return cos_base[loc & 0xffff];
    return cluster.map_shared_rank(cos_base, loc >> 16)[loc & 0xffff];
  };
  int loc[kSlotCache];
  float J[kSlotCache], x[kSlotCache];
#pragma unroll
  for (int k = 0; k < kSlotCache; ++k) {
    if (k == 0 || k < maxnb) {
      loc[k] = __ldg(ri + k);
      J[k] = __ldg(rj + k);
    }
  }
#pragma unroll
  for (int k = 0; k < kSlotCache; ++k)
    if (k == 0 || k < maxnb) x[k] = read(loc[k]);
  float f = __fmul_rn(J[0], x[0]);
#pragma unroll
  for (int k = 1; k < kSlotCache; ++k)
    if (k < maxnb) f = __fadd_rn(f, __fmul_rn(J[k], x[k]));
  for (int k = kSlotCache; k < maxnb; ++k) {
    f = __fadd_rn(f, __fmul_rn(__ldg(rj + k), read(__ldg(ri + k))));
  }
  return __fadd_rn(f, __ldg(h + i));
}

// The site range of CTA `rank`'s slots of class c: its slots [lo, hi),
// slot l holding packed site s0 + (l - lo) while that is below `send`
struct ClassSlots {
  int lo, hi, s0, send;
  __device__ __forceinline__ ClassSlots(const int* __restrict__ slot_starts,
                                        const int* __restrict__ starts,
                                        int c, int rank) {
    lo = __ldg(slot_starts + c);
    hi = __ldg(slot_starts + c + 1);
    s0 = __ldg(starts + c) + rank * (hi - lo);
    send = __ldg(starts + c + 1);
  }
  // the slots of this class that hold a site: [lo, lo + count)
  __device__ __forceinline__ int count() const {
    return max(0, min(hi - lo, send - s0));
  }
};

template <bool kTF, bool kCluster>
__global__ void __launch_bounds__(kSvmcThreads, kSvmcMinBlocks)
packed_svmc_cluster_kernel(
    const int* __restrict__ slot_starts, const int* __restrict__ starts,
    const int* __restrict__ nbr_loc, const float* __restrict__ nbr_J,
    const float* __restrict__ h, const int* __restrict__ perm,
    const float* __restrict__ a_sched, const float* __restrict__ b_sched,
    float temp, const float* __restrict__ th_in, float* __restrict__ th_out,
    float* __restrict__ energies, int chains, int n, int maxnb,
    int ncolors, int R, int nr, int steps, uint32_t seed_term, int j_stride,
    int h_stride, int mcsteps, uint32_t chain0, int improper) {
  extern __shared__ __align__(16) unsigned char svmc_smem_raw[];
  float* const red = reinterpret_cast<float*>(svmc_smem_raw);
  float* const part = red + kSvmcThreads / 32;
  float* const cs = reinterpret_cast<float*>(svmc_smem_raw + kSvmcHeadBytes);
  float* const th = cs + nr;
  float* const sn = th + nr;
  float* const snap = sn + nr;  // only on a packing that is not proper
  // the cos the fields read: the live cache, or the phase's snapshot
  float* const rd = improper ? snap : cs;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = kCluster ? static_cast<int>(cluster.block_rank()) : 0;
  const int chain = static_cast<int>(blockIdx.x) / R;
  const size_t base = static_cast<size_t>(chain) * n;
  auto barrier = [&]() {
    if (kCluster) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  };
  for (int c = 0; c < ncolors; ++c) {
    const ClassSlots cl(slot_starts, starts, c, rank);
    const int m = cl.count();
    for (int l = threadIdx.x; l < cl.hi - cl.lo; l += blockDim.x) {
      const int at = cl.lo + l;
      if (l < m) {
        const float x = th_in[base + cl.s0 + l];
        th[at] = x;
        sincosf(x, sn + at, cs + at);
      } else {
        th[at] = 0.0f;
        cs[at] = 0.0f;
        sn[at] = 0.0f;
      }
    }
  }
  barrier();  // every CTA's caches are in place

  // uid = (chain0 + chain) * n + perm[i], as the first kernel counts it
  const uint32_t uid0 = (chain0 + static_cast<uint32_t>(chain)) *
                        static_cast<uint32_t>(n);
  for (int t = 0; t < steps; ++t) {
    const float a = __ldg(a_sched + t);
    const float b = __ldg(b_sched + t);
    const float width = kTF ? mcs::tf_width(a, b) : 0.0f;
    const uint32_t ctr = mcs::counter(seed_term, t, 0);
    const uint32_t ctr_acc = mcs::svmc_accept_counter(seed_term, t, 0);
    const size_t row = static_cast<size_t>(t / mcsteps);
    const float* const jt = nbr_J + row * j_stride;
    const float* const ht = h + row * h_stride;
    for (int c = 0; c < ncolors; ++c) {
      if (improper) {
        // the last barrier ended every read of the snapshot
        for (int l = threadIdx.x; l < nr; l += blockDim.x) snap[l] = cs[l];
        barrier();
      }
      const ClassSlots cl(slot_starts, starts, c, rank);
      const int m = cl.count();
      for (int l = threadIdx.x; l < m; l += blockDim.x) {
        const int at = cl.lo + l;
        const int i = cl.s0 + l;
        const uint32_t uid = uid0 + static_cast<uint32_t>(__ldg(perm + i));
        const float theta = th[at];
        const float prop =
            mcs::propose<kTF>(theta, mcs::uniform01(ctr, uid), width);
        float sin_p, cos_p;
        sincosf(prop, &sin_p, &cos_p);
        const float z = cluster_field<kCluster>(cluster, rd, nbr_loc, jt, ht,
                                                i, maxnb);
        const float de = mcs::delta_e(b, a, cos_p, cs[at], z, sn[at], sin_p);
        if (mcs::metropolis_accept_hashed(de, temp,
                                          uid * mcs::kGolden + ctr_acc)) {
          th[at] = prop;
          cs[at] = cos_p;
          sn[at] = sin_p;
        }
      }
      barrier();  // the next phase reads this one's cos
    }
    if (energies != nullptr) {
      // this CTA's slots' share of 0.5 sum_i s_i (sum_k J s_nb) + sum_i
      // h_i s_i, s = sign(cos theta), class after class in slot order
      float acc = 0.0f;
      for (int c = 0; c < ncolors; ++c) {
        const ClassSlots cl(slot_starts, starts, c, rank);
        const int m = cl.count();
        for (int l = threadIdx.x; l < m; l += blockDim.x) {
          const int i = cl.s0 + l;
          const int* ri = nbr_loc + static_cast<size_t>(i) * maxnb;
          const float* rj = jt + static_cast<size_t>(i) * maxnb;
          auto spin_at = [&](int loc) {
            const float v =
                kCluster ? cluster.map_shared_rank(cs, loc >> 16)[loc & 0xffff]
                         : cs[loc & 0xffff];
            return mcs::spin_of<true>(v);
          };
          float cf = __fmul_rn(__ldg(rj), spin_at(__ldg(ri)));
          for (int k = 1; k < maxnb; ++k)
            cf = __fadd_rn(cf, __fmul_rn(__ldg(rj + k), spin_at(__ldg(ri + k))));
          acc += mcs::spin_of<true>(cs[cl.lo + l]) *
                 (0.5f * cf + __ldg(ht + i));
        }
      }
      const float e = mcs::block_sum(acc, red);
      if (threadIdx.x == 0) *part = e;
      barrier();  // every CTA's share is in place
      if (rank == 0 && threadIdx.x == 0) {
        float total = 0.0f;
        for (int r = 0; r < R; ++r)
          total += kCluster ? *cluster.map_shared_rank(part, r) : *part;
        energies[static_cast<size_t>(t) * chains + chain] = total;
      }
    }
  }

  for (int c = 0; c < ncolors; ++c) {
    const ClassSlots cl(slot_starts, starts, c, rank);
    const int m = cl.count();
    for (int l = threadIdx.x; l < m; l += blockDim.x)
      th_out[base + cl.s0 + l] = th[cl.lo + l];
  }
  if (kCluster) cluster.sync();  // no CTA leaves while another may read it
}

inline size_t svmc_smem_bytes(int nr, bool improper) {
  return kSvmcHeadBytes + (improper ? 4 : 3) * static_cast<size_t>(nr) *
                              sizeof(float);
}

template <bool kTF>
auto cluster_kernel_of(int R) {
  return R > 1 ? packed_svmc_cluster_kernel<kTF, true>
               : packed_svmc_cluster_kernel<kTF, false>;
}

}  // namespace

// The cluster route: anneal `chains` chains of n packed angles th_in
// (chains, n) into th_out, one chain over a cluster of R CTAs of `threads`
// threads (ops/generic_kernels.py::packed_svmc_geometry), on generic
// PIQMC's slot layout (word_layout): slot_starts (ncolors + 1), class c's
// first slot; starts (ncolors + 1), its first packed site; nbr_loc (n,
// maxnb), each neighbour's (CTA << 16) | slot; nr, the slots a CTA. nbr_J,
// h, perm, the schedules, temp, energies, seed, tf, the table strides,
// mcsteps and chain0 as for packed_svmc_anneal; improper != 0 for a
// packing that is not proper (the fields read a snapshot of cos). All
// device pointers; launches on `stream` and returns cudaGetLastError().
extern "C" int packed_svmc_cluster_anneal(
    const int* slot_starts, const int* starts, const int* nbr_loc,
    const float* nbr_J, const float* h, const int* perm,
    const float* a_sched, const float* b_sched, float temp,
    const float* th_in, float* th_out, float* energies, int chains, int n,
    int maxnb, int ncolors, int R, int nr, int threads, int steps, int seed,
    int tf, int j_stride, int h_stride, int mcsteps, int chain0,
    int improper, void* stream) {
  if (chains == 0 || n == 0) return cudaSuccess;
  if (mcsteps < 1 || R < 1 || R > 16 || nr > 65536 ||
      threads > kSvmcThreads || threads % 32 != 0) {
    return cudaErrorInvalidValue;
  }
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  const size_t smem = svmc_smem_bytes(nr, improper != 0);
  auto kernel = tf ? cluster_kernel_of<true>(R) : cluster_kernel_of<false>(R);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e =
      mcs::cluster_config(kernel, chains * R, R, threads, smem,
                          static_cast<cudaStream_t>(stream), &cfg, &attr);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, kernel, slot_starts, starts, nbr_loc, nbr_J,
                         h, perm, a_sched, b_sched, temp, th_in, th_out,
                         energies, chains, n, maxnb, ncolors, R, nr, steps,
                         seed_term, j_stride, h_stride, mcsteps,
                         static_cast<uint32_t>(chain0), improper);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// How many clusters of R CTAs of `threads` threads and `smem` bytes of the
// cluster route's TF instantiation the card holds at once
// (cudaOccupancyMaxActiveClusters), into *count
extern "C" int packed_svmc_max_active_clusters(int R, int threads, int smem,
                                               int* count) {
  return mcs::max_active_clusters(cluster_kernel_of<true>(R), R, threads,
                                  static_cast<size_t>(smem), count);
}

// Anneal `chains` chains of n packed angles `th` (chains, n) in place over
// the (steps,) schedules A and B at temperature `temp`, one CTA of
// `threads` (256) threads a chain, in one launch. scratch: 2 * chains * n
// floats for the cos and sin caches, and with improper != 0 (a packing
// that is not proper) chains * n more for the phases' snapshots of cos;
// the packed layout's nbr_idx / nbr_J (n, maxnb), h (n), perm (n), starts
// (ncolors + 1); tf != 0 selects the TF proposals; energies: a (steps,
// chains) float32 buffer or null; j_stride, h_stride, mcsteps: 0, 0, 1 for
// the static tables (above); chain0: the global index of the first chain,
// which the uids count from (a chain shard; 0 unsharded). All device
// pointers; launches on `stream` and returns cudaGetLastError().
extern "C" int packed_svmc_anneal(const int* nbr_idx, const float* nbr_J,
                                  const float* h, const int* perm,
                                  const int* starts, const float* a_sched,
                                  const float* b_sched, float temp, float* th,
                                  float* scratch, float* energies, int chains,
                                  int n, int maxnb, int ncolors, int steps,
                                  int seed, int tf, int threads,
                                  int j_stride, int h_stride, int mcsteps,
                                  int chain0, int improper, void* stream) {
  if (chains == 0 || n == 0) return cudaSuccess;
  if (mcsteps < 1) return cudaErrorInvalidValue;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  auto kernel = improper ? (tf ? packed_svmc_kernel<true, true>
                               : packed_svmc_kernel<false, true>)
                         : (tf ? packed_svmc_kernel<true, false>
                               : packed_svmc_kernel<false, false>);
  float* cs = scratch;
  float* sn = scratch + static_cast<size_t>(chains) * n;
  float* snap = improper ? sn + static_cast<size_t>(chains) * n : nullptr;
  kernel<<<chains, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      nbr_idx, nbr_J, h, perm, starts, a_sched, b_sched, temp, th, cs, sn,
      snap, energies, chains, n, maxnb, ncolors, steps, seed_term, j_stride,
      h_stride, mcsteps, static_cast<uint32_t>(chain0));
  return cudaGetLastError();
}

extern "C" const char* packed_svmc_anneal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
