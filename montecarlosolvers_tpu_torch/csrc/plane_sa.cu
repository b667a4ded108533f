// Kernel 6: classical simulated annealing on the full L x L plane, any L.
//
// Replaces montecarlosolvers_tpu/ops/pallas_sa.py::_sa_kernel (:156),
// launched there by _run_pallas (:208) under anneal_lattice (:256). Plain
// PyTorch version: ops/plane_kernels.py::sa_plane_anneal_ref.
//
// What it computes. The state of a chain is its L x L plane of spins. One
// schedule step runs two phases, color 0 then color 1: every site of the
// phase's color, (r + c) % 2 == color, is decided from the state as the
// phase found it, with dE = -2 s f, f = jr*right + jl*left + jd*down +
// ju*up + h (the order of csrc/plane.cuh::plane_field), and the flip
// accepted if dE <= 0 or -T*log1p(-u) > dE; u comes from the counter hash at
// ctr(seed, step, color) and uid = chain*R*C + r*C + c, where R = pad8(L),
// C = pad128(L) are the strides of the TPU kernel's padded plane
// (pallas_sa.py:171-175), so the streams equal the Pallas kernel's. The
// whole schedule runs in one launch.
//
// What bounds it on an H100. The work is 8.4 M updates per sweep at the
// main path's 1280 chains on 81x81; per update it needs 5 float32
// operations of the field and dE, 5 of Metropolis and a logarithm. The
// instructions an update are the same as kernel A's (csrc/split_sa.cu)
// with a 4-slot stencil: the field from bits (4 sign flips of a weight, 4
// adds), the counter hash about 19 integer operations and log1pf about 30;
// PERF.md gives the SASS count. The one-block-per-chain kernel it replaced
// read its 5 planes for every chain and ran one chain of 6561 sites in 512
// threads, 32 blocks at the PIQMC pre-anneal's 32 chains.
//
// What the design does about that.
// - Chains as bits, as kernel A. A CTA anneals a group of C <= 32 chains;
//   bit k of the word of site (r, c) is the sign of chain group*C + k (1 for
//   -1), one word per site (ops/split_kernels.py::pack_chain_bits on the
//   (chains, L*L) view). A thread that owns a site loads its 4 weights and
//   h and its 4 neighbour words once per phase, then updates the C chains
//   in turn; each w*s is a sign flip of w (mcs::signed_by), exact, so the
//   order alone fixes the float32 sum. The hash input steps by
//   R*C*kGolden from chain to chain. A ragged last group updates only its
//   own chains; its spare bits stay 0 and are never read back.
// - A group over a cluster. The R CTAs of a cluster each hold a band of
//   rows (csrc/cluster.cuh with rows of L sites); an up or down read across
//   a band edge, and the row wrap L-1 <-> 0, go through distributed shared
//   memory, and the column wrap stays inside a row. cluster.sync() stands
//   between the phases. ops/plane_kernels.py::plane_sa_geometry chooses
//   (C, R, threads) by kernel A's rules.
// - The wrap pairs. On an odd periodic L the parity is not a proper
//   coloring (ROADMAP.md queue 3): (r, 0) and (r, L-1) share a phase, and
//   so do (0, c) and (L-1, c), and both must be decided from the state the
//   phase found. The plane is kept twice (ping-pong): a step reads buffer
//   `src` and writes every site it updates into `dst`. Phase 0 reads
//   everything from src and writes color 0 into dst; phase 1 reads its
//   color-0 neighbours from dst (phase 0's result) and its own spins and its
//   same-colored wrap neighbours from src, and writes color 1 into dst, so
//   after the step dst holds the whole new plane and becomes the next
//   step's src. No site is copied, no read meets a write of its own phase,
//   and a step keeps kernel A's two cluster barriers. 2*ceil(L/R)*L words a
//   CTA, so R = 16 takes L up to 675.
// - Metropolis without a branch (counter_hash.cuh::metropolis_accept_hashed).
// - A plane no cluster holds (L above 675; plane_sa_geometry returns None)
//   runs on the per-phase kernel below (plane_sa_phased_anneal): the spins
//   as floats in device memory, one thread per (chain, site), chains along
//   gridDim.x, one launch a phase reading `src` and writing every site into
//   `dst`, so the wrap pairs are decided as the cluster kernel decides
//   them.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "counter_hash.cuh"
#include "energy.cuh"
#include "plane.cuh"

namespace {

namespace cg = cooperative_groups;

// As kernel A: at most 256 threads a CTA and registers for 5 CTAs an SM
// (ops/split_kernels.py::MAX_THREADS is the same number).
constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 5;

__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
plane_sa_kernel(const float* __restrict__ w, const float* __restrict__ sched,
                const uint32_t* __restrict__ s_in,
                uint32_t* __restrict__ s_out, int chains, int C, int R,
                int L, uint32_t row_stride, uint32_t plane_stride, int steps,
                uint32_t seed_term) {
  extern __shared__ uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = L * L;
  const int S = mcs::band_stride(L, R, L);  // the second buffer starts at S
  const int group = blockIdx.x / R;
  const mcs::Band band =
      mcs::make_band(cluster, smem, blockIdx.x % R, R, L, L);
  const int row0 = band.lo / L;
  const size_t base = static_cast<size_t>(group) * n + band.lo;
  for (int il = threadIdx.x; il < band.nb; il += blockDim.x)
    smem[il] = s_in[base + il];
  cluster.sync();  // every band is loaded before any is read

  const int cv = min(C, chains - group * C);  // chains of this group
  // uid = chain*R*C + r*C + c wraps as the int32 JAX code does; the hash
  // input uid*kGolden + ctr steps by plane_stride*kGolden between chains
  const uint32_t chain_step = plane_stride * mcs::kGolden;
  const uint32_t uid_group = static_cast<uint32_t>(group) *
                             static_cast<uint32_t>(C) * plane_stride;
  // Slot j of a color in band row rl is column 2 * (j % half) + ((row +
  // color) & 1); slots past the last column are skipped.
  const int half = (L + 1) / 2;
  const int nslot = (band.nb / L) * half;
  const bool odd = L & 1;  // the wrap neighbours have the site's color
  int src = 0;
  for (int t = 0; t < steps; ++t) {
    const float temp = sched[t];
    const int dst = S - src;
    for (int color = 0; color < 2; ++color) {
      // the other color's current state: src before phase 0, dst after it
      const int fresh = color ? dst : src;
      const uint32_t ctr = mcs::counter(seed_term, t, color);
      for (int j = threadIdx.x; j < nslot; j += blockDim.x) {
        const int rl = j / half;
        const int r = row0 + rl;
        const int c = 2 * (j - rl * half) + ((r + color) & 1);
        if (c >= L) continue;
        const int il = rl * L + c;
        const int i = r * L + c;
        const float jr = __ldg(w + i);
        const float jl = __ldg(w + n + i);
        const float jd = __ldg(w + 2 * n + i);
        const float ju = __ldg(w + 3 * n + i);
        const float hj = __ldg(w + 4 * n + i);
        const bool last_c = c + 1 == L, last_r = r + 1 == L;
        const uint32_t right =
            smem[(odd && last_c ? src : fresh) + il + (last_c ? 1 - L : 1)];
        const uint32_t left =
            smem[(odd && c == 0 ? src : fresh) + il + (c == 0 ? L - 1 : -1)];
        const uint32_t down = band.read(odd && last_r ? src : fresh, il + L);
        const uint32_t up = band.read(odd && r == 0 ? src : fresh, il - L);
        const uint32_t word = smem[src + il];
        uint32_t flips = 0u;
        uint32_t x = (uid_group + static_cast<uint32_t>(r) * row_stride +
                      static_cast<uint32_t>(c)) *
                         mcs::kGolden + ctr;
        for (int k = 0; k < cv; ++k, x += chain_step) {
          float f = mcs::signed_by(jr, right, k);
          f = __fadd_rn(f, mcs::signed_by(jl, left, k));
          f = __fadd_rn(f, mcs::signed_by(jd, down, k));
          f = __fadd_rn(f, mcs::signed_by(ju, up, k));
          f = __fadd_rn(f, hj);
          const float s = (word >> k) & 1u ? -1.0f : 1.0f;
          const float de = __fmul_rn(-2.0f * s, f);  // exact
          if (mcs::metropolis_accept_hashed(de, temp, x)) flips |= 1u << k;
        }
        smem[dst + il] = word ^ flips;
      }
      cluster.sync();  // the next phase reads this one's writes
    }
    src = dst;
  }

  for (int il = threadIdx.x; il < band.nb; il += blockDim.x)
    s_out[base + il] = smem[src + il];
}

// Shared memory of one CTA: its band of the plane, twice
// (ops/plane_kernels.py::sa_plane_smem_bytes counts the same).
size_t smem_bytes(int L, int R) {
  return 2 * static_cast<size_t>(mcs::band_stride(L, R, L)) *
         sizeof(uint32_t);
}

// ---- the per-phase kernel, for planes no cluster holds

constexpr int kThreads = 256;

// Phase `color` of step t: one thread per site i of chain blockIdx.x /
// xblocks; a site of the phase's color is decided from `src`, every site
// is written into `dst`.
__global__ void __launch_bounds__(kThreads)
sa_plane_phase_kernel(const float* __restrict__ w,
                      const float* __restrict__ sched,
                      const float* __restrict__ src, float* __restrict__ dst,
                      int L, uint32_t row_stride, uint32_t plane_stride,
                      int color, int t, int xblocks, uint32_t seed_term) {
  const int n = L * L;
  const int chain = blockIdx.x / xblocks;
  const int i = (blockIdx.x - chain * xblocks) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = i / L;
  const int c = i - r * L;
  const size_t at = static_cast<size_t>(chain) * n + i;
  const float sv = src[at];
  if (((r + c) & 1) != color) {
    dst[at] = sv;
    return;
  }
  const float f = mcs::plane_field(src + (at - i), w, L, r, c);
  const float de = __fmul_rn(-2.0f * sv, f);  // exact
  // uid = chain*R*C + r*C + c, wrapping as the int32 JAX code does
  const uint32_t uid = static_cast<uint32_t>(chain) * plane_stride +
                       static_cast<uint32_t>(r) * row_stride +
                       static_cast<uint32_t>(c);
  const uint32_t ctr = mcs::counter(seed_term, t, color);
  dst[at] = mcs::metropolis_accept_hashed(de, sched[t],
                                          uid * mcs::kGolden + ctr)
                ? -sv
                : sv;
}

}  // namespace

// Anneal `chains` L x L planes, packed C to a word, over `steps`
// temperatures. w: (5, L, L) float32 planes jr, jl, jd, ju, h; sched:
// (steps,) float32; s_in, s_out: (ceil(chains/C), L*L) uint32 words, bit k
// of word g the sign of chain g*C + k. row_stride = C and plane_stride =
// R*C are the uid strides of the padded plane. One cluster of R CTAs of
// `threads` threads per group. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int plane_sa_anneal(const float* w, const float* sched,
                               const uint32_t* s_in, uint32_t* s_out,
                               int chains, int C, int R, int threads, int L,
                               int row_stride, int plane_stride, int steps,
                               int seed, void* stream) {
  if (chains == 0 || L == 0) return cudaSuccess;
  const int groups = (chains + C - 1) / C;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = mcs::cluster_config(plane_sa_kernel, groups * R, R,
                                      threads, smem_bytes(L, R),
                                      static_cast<cudaStream_t>(stream),
                                      &cfg, &attr);
  if (e != cudaSuccess) return e;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  e = cudaLaunchKernelEx(&cfg, plane_sa_kernel, w, sched, s_in, s_out,
                         chains, C, R, L, static_cast<uint32_t>(row_stride),
                         static_cast<uint32_t>(plane_stride), steps,
                         seed_term);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Clusters of R CTAs the card holds at once at lattice size L.
extern "C" int plane_sa_max_active_clusters(int R, int threads, int L,
                                            int* count) {
  return mcs::max_active_clusters(plane_sa_kernel, R, threads,
                                  smem_bytes(L, R), count);
}

// The same anneal on the per-phase kernel, the spins as floats (chains, L,
// L) in device memory: the phases ping-pong between s_out and scratch,
// ordered so that the last one writes s_out; s_in is only read. Stores the
// number of kernels it launched in *launched (a host pointer); returns the
// first launch error, checked after the first step, or cudaGetLastError()
// at the end.
// With `energies` (a (steps, chains) float32 device buffer; null: none),
// the energy kernel (energy.cuh) writes each chain's energy after
// every step into row t, one launch a step, counted in *energy_launched (a
// host pointer).
extern "C" int plane_sa_phased_anneal(const float* w, const float* sched,
                                      const float* s_in, float* s_out,
                                      float* scratch, int chains, int L,
                                      int row_stride, int plane_stride,
                                      int steps, int seed,
                                      float* energies, void* stream,
                                      long long* launched,
                                      long long* energy_launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = static_cast<size_t>(L) * L;
  *launched = 0;
  *energy_launched = 0;
  if (chains == 0 || n == 0) return cudaSuccess;
  const long long launches = 2LL * steps;
  if (launches == 0) {
    return cudaMemcpyAsync(s_out, s_in, chains * n * sizeof(float),
                           cudaMemcpyDeviceToDevice, st);
  }
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  const int xblocks = static_cast<int>((n + kThreads - 1) / kThreads);
  const dim3 grid(static_cast<unsigned>(xblocks) * chains);
  const float* src = s_in;
  for (int t = 0; t < steps; ++t) {
    for (int color = 0; color < 2; ++color) {
      // launch j writes s_out when launches - 1 - j is even, so the last does
      float* dst = (launches - 1 - *launched) % 2 == 0 ? s_out : scratch;
      sa_plane_phase_kernel<<<grid, kThreads, 0, st>>>(
          w, sched, src, dst, L, static_cast<uint32_t>(row_stride),
          static_cast<uint32_t>(plane_stride), color, t, xblocks, seed_term);
      *launched += 1;
      src = dst;
    }
    if (energies != nullptr) {
      mcs::launch_plane_energy(w, src, chains, 1, L, false,
                               energies + static_cast<size_t>(t) * chains,
                               st);
      *energy_launched += 1;
    }
    if (t == 0) {
      cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  }
  return cudaGetLastError();
}

extern "C" const char* plane_sa_anneal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
