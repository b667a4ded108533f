// Kernel 4: spin-vector Monte Carlo (rotor) annealing on the split
// checkerboard, any even L.
//
// Replaces montecarlosolvers_tpu/ops/pallas_split.py::_svmc_split_kernel
// (:227), launched there by _run_svmc_split (:313) under
// anneal_lattice_svmc_split (:353). Plain PyTorch version:
// ops/split_kernels.py::svmc_split_anneal_ref.
//
// What it computes. The state of each chain is the rotor angles of the two
// checkerboard halves a, b of an even-L lattice, Nh = L*L/2 sites each, in
// [0, pi]. One schedule step (A_t, B_t) updates all of half a against cos of
// half b, then all of half b against cos of the new half a
// (pallas_split.py:273-303). A site of half c proposes pi*u, or with TF
// proposals clip(theta + min(A/B, 1)*(2 pi u - pi), 0, pi), with u from the
// counter hash at ctr(seed, step, c); it accepts on
// dE = B (cos' - cos) z + A (sin - sin') with z = h plus the 5-slot stencil
// (7 with row wrap) of cos over the other half, if dE <= 0 or
// -T*log1p(-u') > dE, with u' at ctr(seed, step, c + 2). Both uniforms use
// uid = chain*2Nh + c*Nh + site.
//
// What bounds it on an H100. Per site update: two hashed uniforms (about 38
// integer operations), the sine and cosine of the proposal, log1pf, the
// 7-slot stencil (8 weights and the field, 32 B, through the read-only
// path; 7 cos reads from shared memory) and about 12 rounded float
// operations. The transcendentals and the hash dominate: the kernel is
// compute-bound, not bandwidth-bound, and does kernel 7's work per site
// (csrc/plane_svmc.cu). One chain's state is 6*Nh*4 = 77 KB at L = 80
// (angles, cos and sin of both halves); the weights, (nslots*2 + 2)*Nh*4 =
// 205 KB, are shared by every chain and served from L1/L2.
//
// What the design does about that (kernel 7's, on the split halves).
// - One chain over a cluster of R CTAs, each holding a band of rows (rows
//   of K = L/2 sites, csrc/cluster.cuh, as kernels A and 5) of theta, sin
//   theta and cos theta of both halves, 6 floats a half-site at the common
//   stride S. The halves are a proper coloring on every even L, so no plane
//   is kept twice: phase A updates half a against cos of half b, one
//   cluster.sync(), phase B updates half b against the new cos of half a,
//   one cluster.sync(). A phase writes only its own half and reads only
//   the other's cos. A cos read across a band edge, and across the torus
//   wrap, goes through distributed shared memory (Band::read on the
//   float's bits, cluster.cuh's load_neighbours). 6*ceil(L/R)*(L/2) floats
//   a CTA: R = 16 takes even L up to 552, where one block per chain took
//   138.
// - R from the resident count. ops/split_kernels.py::svmc_split_geometry
//   takes the largest R whose band fits a CTA and whose clusters the card
//   holds at once for every chain (cudaOccupancyMaxActiveClusters): at 256
//   chains on 80x80 R = 2, two CTAs of 256 threads a chain, 512 CTAs in one
//   wave (the fastest of R = 1, 2 and 4 on the card, PERF.md).
// - A thread's sites are fixed for the whole anneal (il = threadIdx.x +
//   i*blockDim.x), with no division: the split layout needs no row or
//   column, only the band offset.
// - Few instructions outside the work. The slot count (5, or 7 with the
//   row wrap) is a template argument, so the weight loads and the sum
//   carry no per-slot test, and a site off its band's first and last rows
//   reads its seven neighbours straight from its own CTA's shared memory;
//   only the edge rows go through Band::read's branches. With both as
//   run-time choices an update took about a quarter more instructions and
//   the kernel ran slower than the one-block kernel it replaces (PERF.md).
// - The field in counter_hash.cuh::stencil's slot order, each product and
//   sum rounded alone (__fmul_rn / __fadd_rn). The proposal's cosine and
//   sine from one sincosf, which shares the range reduction and equals the
//   plain version's torch.cos / torch.sin bitwise on the card. Metropolis
//   without a branch (counter_hash.cuh::metropolis_accept_hashed). The
//   caches hold cosf / sinf of the carried angle exactly, never an
//   increment.
// - The uniform source is a template argument (csrc/hw_rng.cuh): the
//   counter hash, or with hw_rng the thread's own generator stream, a
//   site's proposal and then its acceptance; the hash instantiations are
//   the kernel as it was.
// - A lattice no cluster holds (even L above 552; svmc_split_geometry
//   returns None) runs on the per-phase kernels below
//   (split_svmc_phased_anneal): angles, cos and sin in device memory, one
//   thread per (chain, site) of a half, chains along gridDim.x, one launch
//   a half-phase.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "counter_hash.cuh"
#include "hw_rng.cuh"
#include "svmc.cuh"

namespace {

namespace cg = cooperative_groups;

// As kernel 7: at most 256 threads a CTA (ops/split_kernels.py::MAX_THREADS
// is the same number) and registers for 4 CTAs an SM.
constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 4;
constexpr int kThreads = 256;  // the per-phase kernels

// kSlots: the stencil's 5 slots, or 7 with the row wrap, known at compile
// time so that the weight loads and the sum carry no per-slot test; kHw:
// uniforms from the thread's stream (hw_rng.cuh), not the counter hash
template <bool kTF, int kSlots, bool kHw>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
split_svmc_kernel(const float* __restrict__ w, const float* __restrict__ h,
                  const float* __restrict__ a_sched,
                  const float* __restrict__ b_sched, float temp,
                  const float* __restrict__ a_in,
                  const float* __restrict__ b_in, float* __restrict__ a_out,
                  float* __restrict__ b_out, int R, int L, int steps,
                  uint32_t seed_term) {
  extern __shared__ uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = L / 2;
  const int nh = L * K;
  const int S = mcs::band_stride(L, R, K);
  // planes at the common stride S: cos of half c at c*S (the planes the
  // other half reads across bands), theta of half c at (2 + c)*S, sin of
  // half c at (4 + c)*S
  float* const f = reinterpret_cast<float*>(smem);
  const int chain = blockIdx.x / R;
  const mcs::Band band = mcs::make_band(cluster, smem, blockIdx.x % R, R, L, K);
  const size_t base = static_cast<size_t>(chain) * nh + band.lo;
  for (int il = threadIdx.x; il < band.nb; il += blockDim.x) {
    const float x = a_in[base + il];
    const float y = b_in[base + il];
    sincosf(x, &f[4 * S + il], &f[il]);
    sincosf(y, &f[5 * S + il], &f[S + il]);
    f[2 * S + il] = x;
    f[3 * S + il] = y;
  }
  cluster.sync();  // every band is loaded before any is read

  // uid = chain*2Nh + color*Nh + site, wrapping as the int32 JAX code does
  const uint32_t uid0 =
      static_cast<uint32_t>(chain) * (2u * static_cast<uint32_t>(nh));
  // with kHw, a site draws its proposal, then its acceptance, from the
  // thread's stream
  mcs::Uniforms<kHw> rng(seed_term, mcs::thread_stream());
  for (int t = 0; t < steps; ++t) {
    const float a = a_sched[t];
    const float b = b_sched[t];
    const float width = kTF ? mcs::tf_width(a, b) : 0.0f;
    // half a (color 0) against cos of half b, then half b against the new
    // cos of half a
    for (int color = 0; color < 2; ++color) {
      const int cs = color * S;          // own cos
      const int other = (1 - color) * S;  // the other half's cos
      float* const th = f + (2 + color) * S;
      float* const sn = f + (4 + color) * S;
      const uint32_t ctr_prop = mcs::counter(seed_term, t, color);
      const uint32_t ctr_acc = mcs::counter(seed_term, t, color + 2);
      const uint32_t uid_c = uid0 + static_cast<uint32_t>(color * nh);
      for (int il = threadIdx.x; il < band.nb; il += blockDim.x) {
        const int j = band.lo + il;
        const uint32_t uid = uid_c + static_cast<uint32_t>(j);
        const float theta = th[il];
        const float prop = mcs::propose<kTF>(
            theta, rng(uid * mcs::kGolden + ctr_prop), width);
        float sin_p, cos_p;
        sincosf(prop, &sin_p, &cos_p);
        // the other half's cos in counter_hash.cuh::stencil's slot order:
        // j, j+1, j-1, j+K, j-K, j-(K-1), j+(K-1). A site off the band's
        // first and last rows reads them all from its own CTA; one on
        // those rows reads across the band edge, or the torus wrap,
        // through Band::read
        float o[7];
        if (il >= K && il < band.nb - K) {
          const float* c = f + other + il;
          o[0] = c[0];
          o[1] = c[1];
          o[2] = c[-1];
          o[3] = c[K];
          o[4] = c[-K];
          if (kSlots > 5) {
            o[5] = c[1 - K];
            o[6] = c[K - 1];
          }
        } else {
          uint32_t ob[7];
          mcs::load_neighbours(band, other, il, K, kSlots, ob);
#pragma unroll
          for (int s = 0; s < kSlots; ++s) o[s] = __uint_as_float(ob[s]);
        }
        // z in that order, then + h, each product and sum rounded alone
        const float* wc = w + color * nh + j;  // slot s at wc[2 * s * nh]
        float z = __fmul_rn(__ldg(wc), o[0]);
#pragma unroll
        for (int s = 1; s < kSlots; ++s)
          z = __fadd_rn(z, __fmul_rn(__ldg(wc + 2 * s * nh), o[s]));
        z = __fadd_rn(z, __ldg(h + color * nh + j));
        const float cos_t = f[cs + il];
        const float sin_t = sn[il];
        const float de = mcs::delta_e(b, a, cos_p, cos_t, z, sin_t, sin_p);
        const bool acc = rng.accept(de, temp, uid * mcs::kGolden + ctr_acc);
        th[il] = acc ? prop : theta;
        sn[il] = acc ? sin_p : sin_t;
        f[cs + il] = acc ? cos_p : cos_t;
      }
      cluster.sync();  // the next phase reads this half's cos
    }
  }

  for (int il = threadIdx.x; il < band.nb; il += blockDim.x) {
    a_out[base + il] = f[2 * S + il];
    b_out[base + il] = f[3 * S + il];
  }
}

// The instantiation for TF proposals or not, nslots stencil slots and the
// uniform source
template <bool kHw>
auto kernel_for(int tf, int nslots) {
  if (nslots > 5)
    return tf ? split_svmc_kernel<true, 7, kHw>
              : split_svmc_kernel<false, 7, kHw>;
  return tf ? split_svmc_kernel<true, 5, kHw>
            : split_svmc_kernel<false, 5, kHw>;
}

// Shared memory of one CTA: its band of theta, sin theta and cos theta of
// both halves (ops/split_kernels.py::svmc_split_smem_bytes counts the same).
size_t smem_bytes(int L, int R) {
  return 6 * static_cast<size_t>(mcs::band_stride(L, R, L / 2)) *
         sizeof(float);
}

// ---- the per-phase kernels, for lattices no cluster holds

// Copy the angles in to out and fill their cos and sin caches; n = chains
// * Nh elements of each half.
__global__ void __launch_bounds__(kThreads)
svmc_init_kernel(const float* __restrict__ a_in,
                 const float* __restrict__ b_in, float* __restrict__ a_out,
                 float* __restrict__ b_out, float* __restrict__ cs_a,
                 float* __restrict__ cs_b, float* __restrict__ sn_a,
                 float* __restrict__ sn_b, size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = a_in[i];
  const float y = b_in[i];
  a_out[i] = x;
  b_out[i] = y;
  sincosf(x, &sn_a[i], &cs_a[i]);
  sincosf(y, &sn_b[i], &cs_b[i]);
}

// One half-phase of step t: one thread per site j of half `color` of chain
// blockIdx.x / xblocks, against the cos of the other half; only site j's
// angle and caches are written. With kHw the proposal and the acceptance
// are the first two draws of the thread's stream of this launch, number
// `launch`.
template <bool kTF, bool kHw>
__global__ void __launch_bounds__(kThreads)
svmc_phase_kernel(const float* __restrict__ w, const float* __restrict__ h,
                  const float* __restrict__ a_sched,
                  const float* __restrict__ b_sched, float temp, float* th,
                  float* cs, float* sn, const float* __restrict__ cos_other,
                  int color, int nh, int K, int nslots, int xblocks, int t,
                  uint32_t seed_term, uint32_t launch) {
  const int chain = blockIdx.x / xblocks;
  const int j = (blockIdx.x - chain * xblocks) * blockDim.x + threadIdx.x;
  if (j >= nh) return;
  const size_t at = static_cast<size_t>(chain) * nh + j;
  const float a = a_sched[t];
  const float b = b_sched[t];
  const float width = kTF ? mcs::tf_width(a, b) : 0.0f;
  const uint32_t uid =
      static_cast<uint32_t>(chain) * (2u * static_cast<uint32_t>(nh)) +
      static_cast<uint32_t>(color * nh + j);
  const float theta = th[at];
  mcs::Uniforms<kHw> rng(seed_term, mcs::phase_stream(launch));
  const float prop = mcs::propose<kTF>(
      theta, rng(uid * mcs::kGolden + mcs::counter(seed_term, t, color)),
      width);
  float sin_p, cos_p;
  sincosf(prop, &sin_p, &cos_p);
  const float z = __fadd_rn(
      mcs::half_field(cos_other + (at - j), w, color, nh, K, nslots, j),
      __ldg(h + color * nh + j));
  const float cos_t = cs[at];
  const float sin_t = sn[at];
  const float de = mcs::delta_e(b, a, cos_p, cos_t, z, sin_t, sin_p);
  const uint32_t ctr_acc = mcs::counter(seed_term, t, color + 2);
  if (rng.accept(de, temp, uid * mcs::kGolden + ctr_acc)) {
    th[at] = prop;
    cs[at] = cos_p;
    sn[at] = sin_p;
  }
}

}  // namespace

// Anneal `chains` chains over the (steps,) schedules A and B at temperature
// `temp` in one launch, each chain over a cluster of R CTAs of `threads`
// threads. w: (nslots, 2, nh), h: (2, nh), angle halves (chains, nh) with
// nh = L*L/2; all float32 device pointers. tf != 0 selects the TF
// proposals, hw_rng != 0 the uniforms of each thread's stream (hw_rng.cuh).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int split_svmc_anneal(const float* w, const float* h,
                                 const float* a_sched, const float* b_sched,
                                 float temp, const float* a_in,
                                 const float* b_in, float* a_out,
                                 float* b_out, int chains, int R,
                                 int threads, int L, int nslots, int steps,
                                 int seed, int tf, int hw_rng,
                                 void* stream) {
  if (chains == 0 || L == 0) return cudaSuccess;
  const auto kernel =
      hw_rng ? kernel_for<true>(tf, nslots) : kernel_for<false>(tf, nslots);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = mcs::cluster_config(kernel, chains * R, R, threads,
                                      smem_bytes(L, R),
                                      static_cast<cudaStream_t>(stream),
                                      &cfg, &attr);
  if (e != cudaSuccess) return e;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  e = cudaLaunchKernelEx(&cfg, kernel, w, h, a_sched, b_sched, temp, a_in,
                         b_in, a_out, b_out, R, L, steps, seed_term);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Clusters of R CTAs the card holds at once at lattice size L (the TF,
// 7-slot hash instantiation's; the launch bounds give all eight the same
// register limit, and the shared memory is the same).
extern "C" int split_svmc_max_active_clusters(int R, int threads, int L,
                                              int* count) {
  return mcs::max_active_clusters(split_svmc_kernel<true, 7, false>, R,
                                  threads, smem_bytes(L, R), count);
}

// The same anneal on the per-phase kernels, the state in device memory:
// the angles are copied to a_out, b_out and updated there in place beside
// their cos and sin caches in `scratch` (4 * chains * nh floats: cos a,
// cos b, sin a, sin b), one launch to fill them and two a step; tf and
// hw_rng as for split_svmc_anneal. Stores the number of kernels it
// launched in *launched (a host pointer); returns the first launch error,
// checked after the first step, or cudaGetLastError() at the end.
extern "C" int split_svmc_phased_anneal(const float* w, const float* h,
                                        const float* a_sched,
                                        const float* b_sched, float temp,
                                        const float* a_in, const float* b_in,
                                        float* a_out, float* b_out,
                                        float* scratch, int chains, int L,
                                        int nslots, int steps, int seed,
                                        int tf, int hw_rng, void* stream,
                                        long long* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  const int K = L / 2;
  const int nh = L * K;
  const size_t n = static_cast<size_t>(chains) * nh;
  if (n == 0) return cudaSuccess;
  float* cs[2] = {scratch, scratch + n};
  float* sn[2] = {scratch + 2 * n, scratch + 3 * n};
  float* th[2] = {a_out, b_out};
  svmc_init_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                     kThreads, 0, st>>>(a_in, b_in, a_out, b_out, cs[0],
                                        cs[1], sn[0], sn[1], n);
  *launched += 1;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto kernel = hw_rng ? (tf ? svmc_phase_kernel<true, true>
                             : svmc_phase_kernel<false, true>)
                       : (tf ? svmc_phase_kernel<true, false>
                             : svmc_phase_kernel<false, false>);
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  const int xblocks = (nh + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(xblocks) * chains);
  for (int t = 0; t < steps; ++t) {
    // half a against cos of half b, then half b against the new half a
    for (int color = 0; color < 2; ++color) {
      kernel<<<grid, kThreads, 0, st>>>(w, h, a_sched, b_sched, temp,
                                        th[color], cs[color], sn[color],
                                        cs[1 - color], color, nh, K, nslots,
                                        xblocks, t, seed_term,
                                        static_cast<uint32_t>(*launched));
      *launched += 1;
    }
    if (t == 0) {
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  }
  return cudaGetLastError();
}

extern "C" const char* split_svmc_anneal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
