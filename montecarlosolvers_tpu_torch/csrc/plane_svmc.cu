// Kernel 7: spin-vector Monte Carlo (rotor) annealing on the full L x L
// plane, any L.
//
// Replaces montecarlosolvers_tpu/ops/pallas_svmc.py::_svmc_kernel (:56),
// launched there by _run_svmc (:167) under anneal_lattice_svmc (:117), with
// its field helper _zfield (:40). Plain PyTorch version:
// ops/plane_kernels.py::svmc_plane_anneal_ref.
//
// What it computes. The state of a chain is its L x L plane of rotor angles
// in [0, pi]. One schedule step (A_t, B_t) runs two phases, color 0 then
// color 1 (pallas_svmc.py:88-111): every site of the phase's color,
// (r + c) % 2 == color, proposes pi*u, or with TF proposals
// clip(theta + min(A/B, 1)*(2 pi u - pi), 0, pi), with u from the counter
// hash at ctr(seed, step, color), and accepts on
// dE = B (cos' - cos) z + A (sin - sin'), z = jr*cos(right) + jl*cos(left)
// + jd*cos(down) + ju*cos(up) + h (csrc/plane.cuh), if dE <= 0 or
// -T*log1p(-u') > dE, with u' at ctr(seed, step, color) XOR 374761393. Both
// uniforms use uid = chain*R*C + r*C + c, where R = pad8(L), C = pad128(L)
// are the strides of the TPU kernel's padded plane, so the streams equal
// the Pallas kernel's. The whole schedule runs in one launch.
//
// What bounds it on an H100. Per site update: two hashed uniforms (about 38
// integer operations), the sine and cosine of the proposal, log1pf, the
// 4-point stencil of cos with 5 planes (20 B) through the read-only path,
// and about 12 rounded float operations. The transcendentals and the hash
// dominate: the kernel is compute-bound, not bandwidth-bound. The main
// path's 256 chains of 81x81 hold 4 floats a site, 26.9 MB, most of the
// card's 132 x 228 KB of shared memory, so every chain is resident at once
// only with few CTAs a chain; the planes, 5*L*L*4 = 131 KB, are shared by
// every chain and served from L1/L2.
//
// What the design does about that.
// - One chain over a cluster of R CTAs, each holding a band of rows
//   (csrc/cluster.cuh with rows of L sites) of theta and sin theta, which
//   only the site itself reads, and of cos theta twice, a ping-pong plane
//   as kernel 6 keeps its spins (csrc/plane_sa.cu). Phase 0 reads cos from
//   `src` and writes the cos of every color-0 site, accepted or not, into
//   `dst`; phase 1 reads its color-0 neighbours from `dst` and its own cos
//   and its same-colored wrap partners from `src`, and writes color 1 into
//   `dst`, which is then the next step's `src`. So every decision sees the
//   cos plane its phase began with, the odd torus's wrap pairs included
//   (ROADMAP.md queue 3), with one cluster.sync() a phase, no staging pass
//   and no masks. A cos read across a band edge, and across the row wrap
//   L-1 <-> 0, goes through distributed shared memory (Band::read on the
//   float's bits). 4*ceil(L/R)*L floats a CTA: R = 16 takes L <= 480.
// - R from the resident count. ops/plane_kernels.py::plane_svmc_geometry
//   takes the largest R whose band fits a CTA and whose clusters the card
//   holds at once for every chain (cudaOccupancyMaxActiveClusters, by
//   kernel B's rules): at 256 chains on 81x81, R = 2, two CTAs of 256
//   threads a chain, 512 CTAs in one wave.
// - No division. A thread's slots are fixed; their band row and column are
//   stepped from slot to slot (plane.cuh::SlotWalk), not divided out of the
//   slot index.
// - The proposal's cosine and sine from one sincosf, which shares the range
//   reduction; the chip run holds the result bitwise against the plain
//   version's torch.cos / torch.sin. Metropolis without a branch
//   (counter_hash.cuh::metropolis_accept_hashed). The caches hold cosf /
//   sinf of the carried angle exactly, never an increment.
// - A plane no cluster holds (L above 480; plane_svmc_geometry returns
//   None) runs on the per-phase kernels below (plane_svmc_phased_anneal):
//   theta and sin theta in device memory, updated in place (only the site
//   reads them), cos theta twice, each phase reading `src` and writing
//   every site into `dst`; one thread per (chain, site), chains along
//   gridDim.x, one launch to fill the caches and one a phase.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "counter_hash.cuh"
#include "energy.cuh"
#include "plane.cuh"
#include "svmc.cuh"

namespace {

namespace cg = cooperative_groups;

// At most 256 threads a CTA (ops/split_kernels.py::MAX_THREADS is the same
// number) and registers for 4 CTAs an SM: at 256 chains on 81x81 shared
// memory holds 4 half-plane bands an SM, no more.
constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 4;

template <bool kTF>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
plane_svmc_kernel(const float* __restrict__ w,
                  const float* __restrict__ a_sched,
                  const float* __restrict__ b_sched, float temp,
                  const float* __restrict__ th_in, float* __restrict__ th_out,
                  int R, int L, uint32_t row_stride, uint32_t plane_stride,
                  int steps, uint32_t seed_term) {
  extern __shared__ uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = L * L;
  const int S = mcs::band_stride(L, R, L);
  // planes at a common stride S: theta, sin theta, cos theta twice
  float* const th = reinterpret_cast<float*>(smem);
  float* const sn = th + S;
  const int chain = blockIdx.x / R;
  const mcs::Band band =
      mcs::make_band(cluster, smem, blockIdx.x % R, R, L, L);
  const int row0 = band.lo / L;
  const size_t base = static_cast<size_t>(chain) * n + band.lo;
  int src = 2 * S;  // the cos buffers sit at 2S and 3S
  for (int il = threadIdx.x; il < band.nb; il += blockDim.x) {
    const float x = th_in[base + il];
    th[il] = x;
    sn[il] = sinf(x);
    smem[src + il] = __float_as_uint(cosf(x));
  }
  cluster.sync();  // every band is loaded before any is read

  const bool odd = L & 1;  // the wrap neighbours have the site's color
  // uid = chain*R*C + r*C + c, wrapping as the int32 JAX code does
  const uint32_t uid0 = static_cast<uint32_t>(chain) * plane_stride;
  for (int t = 0; t < steps; ++t) {
    const float a = a_sched[t];
    const float b = b_sched[t];
    const float width = kTF ? mcs::tf_width(a, b) : 0.0f;
    const int dst = 5 * S - src;
    for (int color = 0; color < 2; ++color) {
      // the other color's current cos: src before phase 0, dst after it
      const int fresh = color ? dst : src;
      const uint32_t ctr_prop = mcs::counter(seed_term, t, color);
      const uint32_t ctr_acc = mcs::svmc_accept_counter(seed_term, t, color);
      // the sites of this color: the slots of parity 0, read at `color`
      for (mcs::SlotWalk s(L, band.nb / L); s.j < s.nslot; s.next()) {
        const int r = row0 + s.rl;
        const int c = 2 * s.jj + ((r + color) & 1);
        if (c < L) {
          const int il = s.rl * L + c;
          const int i = r * L + c;
          const uint32_t uid = uid0 + static_cast<uint32_t>(r) * row_stride +
                               static_cast<uint32_t>(c);
          const float theta = th[il];
          const float prop = mcs::propose<kTF>(
              theta, mcs::uniform01(ctr_prop, uid), width);
          float sin_p, cos_p;
          sincosf(prop, &sin_p, &cos_p);
          const bool last_c = c + 1 == L, last_r = r + 1 == L;
          // the column wrap stays in the row; an odd L's wrap partner has
          // the site's color and is read as the phase found it
          const int right_at = il + (last_c ? 1 - L : 1);
          const int left_at = il + (c == 0 ? L - 1 : -1);
          const float right = __uint_as_float(
              smem[(odd && last_c ? src : fresh) + right_at]);
          const float left =
              __uint_as_float(smem[(odd && c == 0 ? src : fresh) + left_at]);
          const float down = __uint_as_float(
              band.read(odd && last_r ? src : fresh, il + L));
          const float up =
              __uint_as_float(band.read(odd && r == 0 ? src : fresh, il - L));
          // z in plane_field's order, each product and sum rounded alone
          float z = __fmul_rn(__ldg(w + i), right);
          z = __fadd_rn(z, __fmul_rn(__ldg(w + n + i), left));
          z = __fadd_rn(z, __fmul_rn(__ldg(w + 2 * n + i), down));
          z = __fadd_rn(z, __fmul_rn(__ldg(w + 3 * n + i), up));
          z = __fadd_rn(z, __ldg(w + 4 * n + i));
          const float cos_t = __uint_as_float(smem[src + il]);
          const float sin_t = sn[il];
          const float de = mcs::delta_e(b, a, cos_p, cos_t, z, sin_t, sin_p);
          const bool acc = mcs::metropolis_accept_hashed(
              de, temp, uid * mcs::kGolden + ctr_acc);
          th[il] = acc ? prop : theta;
          sn[il] = acc ? sin_p : sin_t;
          smem[dst + il] = __float_as_uint(acc ? cos_p : cos_t);
        }
      }
      cluster.sync();  // the next phase reads this one's cos
    }
    src = dst;
  }

  for (int il = threadIdx.x; il < band.nb; il += blockDim.x)
    th_out[base + il] = th[il];
}

// Shared memory of one CTA: its band of theta, sin theta and cos theta
// twice (ops/plane_kernels.py::svmc_plane_smem_bytes counts the same).
size_t smem_bytes(int L, int R) {
  return 4 * static_cast<size_t>(mcs::band_stride(L, R, L)) * sizeof(float);
}

// ---- the per-phase kernels, for planes no cluster holds

constexpr int kThreads = 256;

// Copy the angles in to out and fill their caches sin and cos; n = chains
// * L * L elements.
__global__ void __launch_bounds__(kThreads)
svmc_plane_init_kernel(const float* __restrict__ th_in,
                       float* __restrict__ th_out, float* __restrict__ sn,
                       float* __restrict__ cs, size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = th_in[i];
  th_out[i] = x;
  sincosf(x, &sn[i], &cs[i]);
}

// Phase `color` of step t: one thread per site i of chain blockIdx.x /
// xblocks. A site of the phase's color is decided from the cos plane
// `src` as the phase found it; every site's cos is written into `dst`,
// and a site of the color updates its theta and sin in place.
template <bool kTF>
__global__ void __launch_bounds__(kThreads)
svmc_plane_phase_kernel(const float* __restrict__ w,
                        const float* __restrict__ a_sched,
                        const float* __restrict__ b_sched, float temp,
                        float* __restrict__ th, float* __restrict__ sn,
                        const float* __restrict__ src,
                        float* __restrict__ dst, int L, uint32_t row_stride,
                        uint32_t plane_stride, int color, int t, int xblocks,
                        uint32_t seed_term) {
  const int n = L * L;
  const int chain = blockIdx.x / xblocks;
  const int i = (blockIdx.x - chain * xblocks) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = i / L;
  const int c = i - r * L;
  const size_t at = static_cast<size_t>(chain) * n + i;
  const float cos_t = src[at];
  if (((r + c) & 1) != color) {
    dst[at] = cos_t;
    return;
  }
  const float a = a_sched[t];
  const float b = b_sched[t];
  const float width = kTF ? mcs::tf_width(a, b) : 0.0f;
  // uid = chain*R*C + r*C + c, wrapping as the int32 JAX code does
  const uint32_t uid = static_cast<uint32_t>(chain) * plane_stride +
                       static_cast<uint32_t>(r) * row_stride +
                       static_cast<uint32_t>(c);
  const float theta = th[at];
  const float prop = mcs::propose<kTF>(
      theta, mcs::uniform01(mcs::counter(seed_term, t, color), uid), width);
  float sin_p, cos_p;
  sincosf(prop, &sin_p, &cos_p);
  const float z = mcs::plane_field(src + (at - i), w, L, r, c);
  const float sin_t = sn[at];
  const float de = mcs::delta_e(b, a, cos_p, cos_t, z, sin_t, sin_p);
  const uint32_t ctr_acc = mcs::svmc_accept_counter(seed_term, t, color);
  const bool acc =
      mcs::metropolis_accept_hashed(de, temp, uid * mcs::kGolden + ctr_acc);
  th[at] = acc ? prop : theta;
  sn[at] = acc ? sin_p : sin_t;
  dst[at] = acc ? cos_p : cos_t;
}

}  // namespace

// Anneal `chains` L x L planes of angles over the (steps,) schedules A and B
// at temperature `temp` in one launch, each chain over a cluster of R CTAs
// of `threads` threads. w: (5, L, L) planes jr, jl, jd, ju, h; th_in,
// th_out: (chains, L, L); all float32 device pointers. row_stride = C and
// plane_stride = R*C are the uid strides; tf != 0 selects the TF proposals.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int plane_svmc_anneal(const float* w, const float* a_sched,
                                 const float* b_sched, float temp,
                                 const float* th_in, float* th_out,
                                 int chains, int R, int threads, int L,
                                 int row_stride, int plane_stride, int steps,
                                 int seed, int tf, void* stream) {
  if (chains == 0 || L == 0) return cudaSuccess;
  auto kernel = tf ? plane_svmc_kernel<true> : plane_svmc_kernel<false>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = mcs::cluster_config(kernel, chains * R, R, threads,
                                      smem_bytes(L, R),
                                      static_cast<cudaStream_t>(stream),
                                      &cfg, &attr);
  if (e != cudaSuccess) return e;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  e = cudaLaunchKernelEx(&cfg, kernel, w, a_sched, b_sched, temp, th_in,
                         th_out, R, L, static_cast<uint32_t>(row_stride),
                         static_cast<uint32_t>(plane_stride), steps,
                         seed_term);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Clusters of R CTAs the card holds at once at lattice size L (the TF
// instantiation's; the launch bounds give both the same 64 registers a
// thread at most, and the shared memory is the same).
extern "C" int plane_svmc_max_active_clusters(int R, int threads, int L,
                                              int* count) {
  return mcs::max_active_clusters(plane_svmc_kernel<true>, R, threads,
                                  smem_bytes(L, R), count);
}

// The same anneal on the per-phase kernels: th_in is copied to th_out,
// which is then updated in place beside the caches in `scratch` (3 *
// chains * L * L floats: sin theta and cos theta twice), one launch to fill
// them and one a phase. Stores the number of kernels it launched in
// *launched (a host pointer); returns the first launch error, checked after
// the first step, or cudaGetLastError() at the end.
// With `energies` (a (steps, chains) float32 device buffer; null: none),
// the energy kernel (energy.cuh) writes each chain's energy of sign(cos theta) after
// every step into row t, one launch a step, counted in *energy_launched (a
// host pointer).
extern "C" int plane_svmc_phased_anneal(const float* w, const float* a_sched,
                                        const float* b_sched, float temp,
                                        const float* th_in, float* th_out,
                                        float* scratch, int chains, int L,
                                        int row_stride, int plane_stride,
                                        int steps, int seed, int tf,
                                        float* energies, void* stream,
                                        long long* launched,
                                        long long* energy_launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  *energy_launched = 0;
  const size_t plane = static_cast<size_t>(L) * L;
  const size_t n = static_cast<size_t>(chains) * plane;
  if (n == 0) return cudaSuccess;
  float* const sn = scratch;
  float* cs[2] = {scratch + n, scratch + 2 * n};
  svmc_plane_init_kernel<<<static_cast<unsigned>((n + kThreads - 1) /
                                                 kThreads),
                           kThreads, 0, st>>>(th_in, th_out, sn, cs[0], n);
  *launched += 1;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto kernel =
      tf ? svmc_plane_phase_kernel<true> : svmc_plane_phase_kernel<false>;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  const int xblocks = static_cast<int>((plane + kThreads - 1) / kThreads);
  const dim3 grid(static_cast<unsigned>(xblocks) * chains);
  int src = 0;
  for (int t = 0; t < steps; ++t) {
    for (int color = 0; color < 2; ++color) {
      kernel<<<grid, kThreads, 0, st>>>(
          w, a_sched, b_sched, temp, th_out, sn, cs[src], cs[1 - src], L,
          static_cast<uint32_t>(row_stride),
          static_cast<uint32_t>(plane_stride), color, t, xblocks, seed_term);
      *launched += 1;
      src = 1 - src;
    }
    if (energies != nullptr) {
      // cs[src] holds cos theta of every site as the step left it
      mcs::launch_plane_energy(w, cs[src], chains, 1, L, true,
                               energies + static_cast<size_t>(t) * chains,
                               st);
      *energy_launched += 1;
    }
    if (t == 0) {
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  }
  return cudaGetLastError();
}

extern "C" const char* plane_svmc_anneal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
