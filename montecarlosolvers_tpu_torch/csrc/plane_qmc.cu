// Kernel 3: PIQMC on the full L x L plane at any P, local moves on the
// space-time coloring plus optional whole-line moves.
//
// Replaces montecarlosolvers_tpu/ops/pallas_qmc.py::_qmc_kernel (:70),
// launched there by _run_qmc (:210) under anneal_lattice_qmc (:146). Plain
// PyTorch version: ops/plane_kernels.py::qmc_plane_anneal_ref.
//
// What it computes. The Trotter state of a chain is P planes of L x L
// spins. Per schedule step: m = spacetime_num_phases(2, P) local phases
// (m = 2 at even P, 3 at P = 3 and 5, 4 at P = 7), phase p flipping the
// sites with ((r + c) % 2 + k) % m == p, with
//   dE = -2B s f + 2 s J_perp (s[k-1] + s[k+1])     (Trotter ring mod P)
// and u from ctr(seed, step, p) at uid = chain*P*R*C + k*R*C + r*C + c
// (R = pad8(L), C = pad128(L), the TPU kernel's padded strides,
// pallas_qmc.py:91-97). Then, with global moves, whole lines of color 0 and
// then of color 1 flip with dE = sum_k -2B s f in index order (J_perp
// cancels for a whole line); a line's u is the k = 0 plane's, drawn at the
// line counter ((seed*M + step*40503) ^ 374761393) + color*69069
// (pallas_qmc.py:124-140). Every site of a phase is decided from the state
// as the phase found it. J_perp is computed once per anneal by the wrapper
// (schedules.jperp), so kernel and plain version read the same values.
//
// What bounds it on an H100. The work of a sweep at the main path's 80x80,
// P = 5, 32 chains is 1.02 M slice updates and 0.2 M line moves; per update
// 13 float32 operations and a logarithm (chip_smoke.py::ops_per_sweep), so
// the bound is the 1.23 M logarithms, 0.29 us a sweep. The kernel this one
// replaced kept the state as floats in device memory and launched once per
// phase, m + 2 = 5 launches a sweep and 5000 a solve, each streaming the
// whole state through L2 and copying most sites: 0.0464 ms a sweep (H100
// 80GB HBM3, 700 W, PERF.md). As compiled here (sm_90a SASS at P <= 32,
// tools/sass_counts.py) an update is 95 instructions, the counter hash and
// log1pf over half of them, a line term 21, and a site about 60 more per
// phase; with 5 cluster barriers a step and 400 sites on 256 threads a CTA
// at the main path's R = 16, the kernel issues at under half the card's
// rate (PERF.md gives the measured time).
//
// What the design does about that (kernel B's, csrc/split_qmc.cu, on the
// full plane with the space-time coloring).
// - The state as bits. Bit k % 32 of word k / 32 of site (r, c) is the sign
//   of slice k (1 for -1), W = ceil(P/32) words a site, in planes
//   [word][site]: one word a site at P <= 32. The wrapper packs and unpacks
//   the words with torch ops on the (chains, P, L*L) view
//   (ops/plane_kernels.py::pack_slice_bits), so the CPU tests hold the round
//   trip. The Trotter partners k -/+ 1 are bits of the site's own words, and
//   the stencil reads bit k of the four neighbour words.
// - One chain over a cluster of R <= 16 CTAs, each holding a band of rows
//   (csrc/cluster.cuh with rows of L sites); an up or down read across a
//   band edge, and the row wrap L-1 <-> 0, go through distributed shared
//   memory, the column wrap stays inside a row. Chains run along gridDim.x.
//   ops/plane_kernels.py::plane_qmc_geometry chooses R by kernel B's rules.
// - A ping-pong plane and the whole schedule in one launch. The band is
//   kept twice; every phase reads buffer `src`, writes every site's words
//   into `dst` (word ^ flips: at P >= 2 every site owns slices in every
//   local phase, and a line phase flips or copies), ends with one
//   cluster.sync() and swaps the buffers. So every decision sees the state
//   its phase began with, the odd torus's wrap pairs that share a phase
//   included (ROADMAP.md queue 3), with no special case: m + 2 barriers a
//   step where the kernel it replaced took m + 2 launches.
// - A local phase walks, at each site, only the slices it owns, k = k0,
//   k0 + m, ... with k0 = (p - (r + c) % 2) mod m: one or two at P = 5, no
//   per-bit test. A thread's sites are fixed and ordered by parity
//   (plane.cuh::SlotWalk), so a warp's sites walk the same slices and take
//   the same side of a line phase; their (r, c) are stepped, not divided,
//   from site to site.
// - P <= 32 compiles a one-word instantiation (kOneWord): the Trotter
//   partners are bits of the word in hand, and the word loops go; larger P
//   takes the W-word one. m stays a run-time argument.
// - Metropolis without a branch (counter_hash.cuh::metropolis_accept_hashed).
// - A shape no cluster holds (plane_qmc_geometry returns None: at P <= 32
//   an L above 675, at P <= 64 above 480) runs on the per-phase kernels
//   below (plane_qmc_phased_anneal): the state as floats in device memory,
//   one launch a phase, chains and slices along gridDim.x.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "counter_hash.cuh"
#include "energy.cuh"
#include "plane.cuh"

namespace {

namespace cg = cooperative_groups;

// As kernels A, B, 5 and 6: at most 256 threads a CTA and registers for 5
// CTAs an SM (ops/split_kernels.py::MAX_THREADS is the same number).
constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 5;
constexpr int kThreads = 256;  // the per-phase kernels

// s of bit b of a word: bit 1 is s = -1
__device__ __forceinline__ float spin_of(uint32_t word, int b) {
  return (word >> b) & 1u ? -1.0f : 1.0f;
}

// kOneWord: P <= 32, one word a site, known at compile time
template <bool kOneWord>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
plane_qmc_kernel(const float* __restrict__ w,
                 const float* __restrict__ b_sched,
                 const float* __restrict__ jp, float teff,
                 const uint32_t* __restrict__ s_in,
                 uint32_t* __restrict__ s_out, int P, int m, int R, int L,
                 uint32_t row_stride, uint32_t plane_stride, int steps,
                 uint32_t seed_term, int global_moves, uint32_t chain0) {
  extern __shared__ uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = L * L;
  const int W = kOneWord ? 1 : (P + 31) / 32;  // words a site
  const int S = mcs::band_stride(L, R, L);
  const int other = W * S;  // the buffers sit at 0 and W*S
  const int chain = blockIdx.x / R;
  const mcs::Band band =
      mcs::make_band(cluster, smem, blockIdx.x % R, R, L, L);
  const int row0 = band.lo / L;
  const size_t base = static_cast<size_t>(chain) * W * n + band.lo;
  for (int il = threadIdx.x; il < band.nb; il += blockDim.x)
    for (int wd = 0; wd < W; ++wd)
      smem[wd * S + il] = s_in[base + static_cast<size_t>(wd) * n + il];
  cluster.sync();  // every band is loaded before any is read

  // uid = chain*P*R*C + k*R*C + r*C + c wraps as the int32 JAX code does,
  // the chain counted from chain0 (the first chain of a chain shard); the
  // hash input uid*kGolden + ctr steps by plane_stride*kGolden a slice
  const uint32_t uid_chain = (chain0 + static_cast<uint32_t>(chain)) *
                             static_cast<uint32_t>(P) * plane_stride;
  const uint32_t k_step = plane_stride * mcs::kGolden;
  // the bits of a whole line in its last word
  const uint32_t last_mask = (P & 31) ? (1u << (P & 31)) - 1u : ~0u;
  int src = 0;
  for (int t = 0; t < steps; ++t) {
    const float bc = -2.0f * b_sched[t];
    const float jpt = jp[t];
    // m local phases, then with global moves the lines of color 0 and 1
    const int phases = m + (global_moves ? 2 : 0);
    for (int p = 0; p < phases; ++p) {
      const int dst = other - src;
      const bool line = p >= m;
      const int color = p - m;
      const uint32_t ctr = line ? mcs::line_counter(seed_term, t, color)
                                : mcs::counter(seed_term, t, p);
      for (mcs::SlotWalk s(L, band.nb / L); s.j < 2 * s.nslot; s.next()) {
        const int q = s.q, r = row0 + s.rl;
        const int c = 2 * s.jj + ((r + q) & 1);
        if (c >= L) continue;
        const int il = s.rl * L + c;
        const int i = r * L + c;
        // band-local neighbours: the column wrap stays in the row
        const int il_right = il + (c + 1 == L ? 1 - L : 1);
        const int il_left = il + (c == 0 ? L - 1 : -1);
        const uint32_t x0 =
            (uid_chain + static_cast<uint32_t>(r) * row_stride +
             static_cast<uint32_t>(c)) * mcs::kGolden + ctr;
        if (line && q != color) {  // not this line phase's color: copy
          for (int wd = 0; wd < W; ++wd)
            smem[dst + wd * S + il] = smem[src + wd * S + il];
          continue;
        }
        const float jr = __ldg(w + i);
        const float jl = __ldg(w + n + i);
        const float jd = __ldg(w + 2 * n + i);
        const float ju = __ldg(w + 3 * n + i);
        const float hj = __ldg(w + 4 * n + i);
        // f of slice b of the neighbour words, in plane_field's order: each
        // w*s is exact, so the order alone fixes the float32 sum
        auto field = [&](uint32_t right, uint32_t left, uint32_t down,
                         uint32_t up, int b) {
          float f = mcs::signed_by(jr, right, b);
          f = __fadd_rn(f, mcs::signed_by(jl, left, b));
          f = __fadd_rn(f, mcs::signed_by(jd, down, b));
          f = __fadd_rn(f, mcs::signed_by(ju, up, b));
          return __fadd_rn(f, hj);
        };
        if (line) {
          // sum_k (bc*s_k)*f_k in index order from the k = 0 term: -0.0 + x
          // == x for every x, so the sum starts at its first term
          float de = -0.0f;
          for (int wd = 0; wd < W; ++wd) {
            const int o = src + wd * S;
            const uint32_t right = smem[o + il_right];
            const uint32_t left = smem[o + il_left];
            const uint32_t down = band.read(o, il + L);
            const uint32_t up = band.read(o, il - L);
            const uint32_t word = smem[o + il];
            const int nbits = min(32, P - 32 * wd);
            for (int b = 0; b < nbits; ++b)
              de = __fadd_rn(de, __fmul_rn(bc * spin_of(word, b),
                                           field(right, left, down, up, b)));
          }
          // one decision per line, from the k = 0 plane's uid
          const bool flip = mcs::metropolis_accept_hashed(de, teff, x0);
          for (int wd = 0; wd < W; ++wd) {
            const uint32_t mask = wd + 1 == W ? last_mask : ~0u;
            smem[dst + wd * S + il] =
                smem[src + wd * S + il] ^ (flip ? mask : 0u);
          }
          continue;
        }
        // local phase p: the slices k = k0, k0 + m, ... of this site, the
        // same running k across its words
        int k = p - q;
        if (k < 0) k += m;
        for (int wd = 0; wd < W; ++wd) {
          const int o = src + wd * S;
          const uint32_t right = smem[o + il_right];
          const uint32_t left = smem[o + il_left];
          const uint32_t down = band.read(o, il + L);
          const uint32_t up = band.read(o, il - L);
          const uint32_t word = smem[o + il];
          const int end = min(P, 32 * wd + 32);
          uint32_t flips = 0u;
          for (; k < end; k += m) {
            const int b = k & 31;
            const float sv = spin_of(word, b);
            // Trotter ring partners k-1 and k+1, mod P (at P = 2 the same
            // slice, at P = 1 the slice itself), from the site's own words
            const int ku = k == 0 ? P - 1 : k - 1;
            const int kd = k + 1 == P ? 0 : k + 1;
            const uint32_t wu = kOneWord || (ku >> 5) == wd
                                    ? word
                                    : smem[src + (ku >> 5) * S + il];
            const uint32_t wdn = kOneWord || (kd >> 5) == wd
                                     ? word
                                     : smem[src + (kd >> 5) * S + il];
            const float tr =
                __fadd_rn(spin_of(wu, ku & 31), spin_of(wdn, kd & 31));
            // dE = ((bc*s)*f) + (((2*s)*jp)*tr) in the plain version's
            // order: bc*s, 2*s*jp and the product with tr (in {-2, 0, 2})
            // are exact, but (bc*s)*f is rounded whenever B != 1, so an FMA
            // fused into the sum would change dE; __fmul_rn/__fadd_rn keep
            // the two roundings
            const float de = __fadd_rn(
                __fmul_rn(bc * sv, field(right, left, down, up, b)),
                __fmul_rn(__fmul_rn(2.0f * sv, jpt), tr));
            const uint32_t x = x0 + static_cast<uint32_t>(k) * k_step;
            if (mcs::metropolis_accept_hashed(de, teff, x)) flips |= 1u << b;
          }
          smem[dst + wd * S + il] = word ^ flips;
        }
      }
      cluster.sync();  // the next phase reads this one's writes
      src = dst;
    }
  }

  for (int il = threadIdx.x; il < band.nb; il += blockDim.x)
    for (int wd = 0; wd < W; ++wd)
      s_out[base + static_cast<size_t>(wd) * n + il] =
          smem[src + wd * S + il];
}

// The instantiation for P slices
auto kernel_for(int P) {
  return P <= 32 ? plane_qmc_kernel<true> : plane_qmc_kernel<false>;
}

// Shared memory of one CTA: its band of the plane's words, twice
// (ops/plane_kernels.py::plane_qmc_smem_bytes counts the same).
size_t smem_bytes(int P, int L, int R) {
  return 2 * static_cast<size_t>((P + 31) / 32) *
         mcs::band_stride(L, R, L) * sizeof(uint32_t);
}

// ---- the per-phase kernels, for shapes no cluster holds

// Local phase p of step t: one thread per site i of plane k of chain c,
// blockIdx.x = (c * P + k) * xblocks + site block; reads src, writes dst.
__global__ void __launch_bounds__(kThreads)
qmc_local_kernel(const float* __restrict__ w,
                 const float* __restrict__ b_sched,
                 const float* __restrict__ jp, float teff,
                 const float* __restrict__ src, float* __restrict__ dst,
                 int P, int L, uint32_t row_stride, uint32_t plane_stride,
                 int m, int p, int t, int xblocks, uint32_t seed_term,
                 uint32_t chain0) {
  const int n = L * L;
  const int ck = blockIdx.x / xblocks;  // chain * P + k
  const int i = (blockIdx.x - ck * xblocks) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int chain = ck / P;
  const int k = ck - chain * P;
  const int r = i / L;
  const int c = i - r * L;
  const size_t line0 = static_cast<size_t>(chain) * P * n + i;
  const size_t at = line0 + static_cast<size_t>(k) * n;
  const float sv = src[at];
  if ((((r + c) & 1) + k) % m != p) {
    dst[at] = sv;
    return;
  }
  // Trotter ring partners k-1 and k+1, mod P (at P = 2 the same plane)
  const int ku = k == 0 ? P - 1 : k - 1;
  const int kd = k + 1 == P ? 0 : k + 1;
  const float tr = __fadd_rn(src[line0 + static_cast<size_t>(ku) * n],
                             src[line0 + static_cast<size_t>(kd) * n]);
  const float f = mcs::plane_field(src + (at - i), w, L, r, c);
  const float bc = -2.0f * b_sched[t];
  // dE as in the cluster kernel: two roundings, no FMA
  const float de = __fadd_rn(__fmul_rn(bc * sv, f),
                             __fmul_rn(__fmul_rn(2.0f * sv, jp[t]), tr));
  // uid = chain*P*R*C + k*R*C + r*C + c, wrapping as the int32 JAX code
  const uint32_t chain_stride = static_cast<uint32_t>(P) * plane_stride;
  const uint32_t uid =
      (chain0 + static_cast<uint32_t>(chain)) * chain_stride +
      static_cast<uint32_t>(k) * plane_stride +
      static_cast<uint32_t>(r) * row_stride + static_cast<uint32_t>(c);
  const float u = mcs::uniform01(mcs::counter(seed_term, t, p), uid);
  dst[at] = mcs::metropolis_accept(de, teff, u) ? -sv : sv;
}

// Line phase of `color` at step t: one thread per site i of chain c,
// blockIdx.x = c * xblocks + site block, owning that site's whole line
// over k; reads src, writes dst.
__global__ void __launch_bounds__(kThreads)
qmc_line_kernel(const float* __restrict__ w,
                const float* __restrict__ b_sched, float teff,
                const float* __restrict__ src,
                float* __restrict__ dst, int P, int L, uint32_t row_stride,
                uint32_t plane_stride, int color, int t, int xblocks,
                uint32_t seed_term, uint32_t chain0) {
  const int n = L * L;
  const int chain = blockIdx.x / xblocks;
  const int i = (blockIdx.x - chain * xblocks) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = i / L;
  const int c = i - r * L;
  const size_t plane0 = static_cast<size_t>(chain) * P * n;
  if (((r + c) & 1) != color) {
    for (int k = 0; k < P; ++k) {
      const size_t at = plane0 + static_cast<size_t>(k) * n + i;
      dst[at] = src[at];
    }
    return;
  }
  const float bc = -2.0f * b_sched[t];
  // sum_k (bc*s)*f in index order, from the k = 0 term
  float de = 0.0f;
  for (int k = 0; k < P; ++k) {
    const float* plane = src + plane0 + static_cast<size_t>(k) * n;
    const float term =
        __fmul_rn(bc * plane[i], mcs::plane_field(plane, w, L, r, c));
    de = k == 0 ? term : __fadd_rn(de, term);
  }
  // one decision per line, from the k = 0 plane's uid
  const uint32_t chain_stride = static_cast<uint32_t>(P) * plane_stride;
  const uint32_t uid = (chain0 + static_cast<uint32_t>(chain)) *
                           chain_stride +
                       static_cast<uint32_t>(r) * row_stride +
                       static_cast<uint32_t>(c);
  const float u = mcs::uniform01(mcs::line_counter(seed_term, t, color), uid);
  const float sign = mcs::metropolis_accept(de, teff, u) ? -1.0f : 1.0f;
  for (int k = 0; k < P; ++k) {
    const size_t at = plane0 + static_cast<size_t>(k) * n + i;
    dst[at] = sign * src[at];
  }
}

}  // namespace

// Anneal `chains` Trotter states over `steps` schedule points in one launch,
// each chain over a cluster of R CTAs of `threads` threads. w: (5, L, L)
// float32 planes jr, jl, jd, ju, h; b_sched and jp: (steps,) float32; s_in,
// s_out: (chains, ceil(P/32), L*L) uint32 words, bit k % 32 of word k / 32
// the sign of slice k. row_stride = C and plane_stride = R*C are the uid
// strides, m the number of local phases; chain0: the global index of the
// first chain, which the uids count from (a chain shard; 0 unsharded).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int plane_qmc_anneal(const float* w, const float* b_sched,
                                const float* jp, float teff,
                                const uint32_t* s_in, uint32_t* s_out,
                                int chains, int P, int m, int R, int threads,
                                int L, int row_stride, int plane_stride,
                                int steps, int seed, int global_moves,
                                int chain0, void* stream) {
  if (chains == 0 || P == 0 || L == 0) return cudaSuccess;
  const auto kernel = kernel_for(P);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = mcs::cluster_config(kernel, chains * R, R, threads,
                                      smem_bytes(P, L, R),
                                      static_cast<cudaStream_t>(stream),
                                      &cfg, &attr);
  if (e != cudaSuccess) return e;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  e = cudaLaunchKernelEx(&cfg, kernel, w, b_sched, jp, teff, s_in,
                         s_out, P, m, R, L,
                         static_cast<uint32_t>(row_stride),
                         static_cast<uint32_t>(plane_stride), steps,
                         seed_term, global_moves,
                         static_cast<uint32_t>(chain0));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Clusters of R CTAs the card holds at once at P slices and lattice size L.
extern "C" int plane_qmc_max_active_clusters(int P, int R, int threads,
                                             int L, int* count) {
  return mcs::max_active_clusters(kernel_for(P), R, threads,
                                  smem_bytes(P, L, R), count);
}

// The same anneal on the per-phase kernels, the state as floats (chains, P,
// L, L) in device memory: the phases ping-pong between s_out and scratch,
// ordered so that the last one writes s_out; s_in is only read. Stores the
// number of kernels it launched in *launched (a host pointer); returns the
// first launch error, checked after the first step, or cudaGetLastError()
// at the end; chain0 as for plane_qmc_anneal.
// With `energies` (a (steps, chains) float32 device buffer; null: none),
// the energy kernel (energy.cuh) writes each chain's best-slice energy after
// every step into row t, one launch a step, counted in *energy_launched (a
// host pointer).
extern "C" int plane_qmc_phased_anneal(const float* w, const float* b_sched,
                                       const float* jp, float teff,
                                       const float* s_in, float* s_out,
                                       float* scratch, int chains, int P,
                                       int L, int row_stride,
                                       int plane_stride, int m, int steps,
                                       int seed, int global_moves,
                                       int chain0, float* energies,
                                       void* stream,
                                       long long* launched,
                                       long long* energy_launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = static_cast<size_t>(L) * L;
  *launched = 0;
  *energy_launched = 0;
  if (chains == 0 || P == 0 || n == 0) return cudaSuccess;
  const long long launches =
      static_cast<long long>(steps) * (m + (global_moves ? 2 : 0));
  if (launches == 0) {
    return cudaMemcpyAsync(s_out, s_in,
                           static_cast<size_t>(chains) * P * n * sizeof(float),
                           cudaMemcpyDeviceToDevice, st);
  }
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  const uint32_t rs = static_cast<uint32_t>(row_stride);
  const uint32_t ps = static_cast<uint32_t>(plane_stride);
  const int xblocks = static_cast<int>((n + kThreads - 1) / kThreads);
  const dim3 grid_local(static_cast<unsigned>(xblocks) * chains * P);
  const dim3 grid_line(static_cast<unsigned>(xblocks) * chains);
  const float* src = s_in;
  long long done = 0;
  // launch j writes s_out when launches - 1 - j is even, so the last does
  auto next_dst = [&]() {
    float* d = (launches - 1 - done) % 2 == 0 ? s_out : scratch;
    ++done;
    return d;
  };
  for (int t = 0; t < steps; ++t) {
    for (int p = 0; p < m; ++p) {
      float* dst = next_dst();
      qmc_local_kernel<<<grid_local, kThreads, 0, st>>>(
          w, b_sched, jp, teff, src, dst, P, L, rs, ps, m, p, t, xblocks,
          seed_term, static_cast<uint32_t>(chain0));
      src = dst;
    }
    if (global_moves) {
      for (int color = 0; color < 2; ++color) {
        float* dst = next_dst();
        qmc_line_kernel<<<grid_line, kThreads, 0, st>>>(
            w, b_sched, teff, src, dst, P, L, rs, ps, color, t, xblocks,
            seed_term, static_cast<uint32_t>(chain0));
        src = dst;
      }
    }
    if (energies != nullptr) {
      mcs::launch_plane_energy(w, src, chains, P, L, false,
                               energies + static_cast<size_t>(t) * chains,
                               st);
      *energy_launched += 1;
    }
    if (t == 0) {
      cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  }
  *launched = done;
  return cudaGetLastError();
}

extern "C" const char* plane_qmc_anneal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
