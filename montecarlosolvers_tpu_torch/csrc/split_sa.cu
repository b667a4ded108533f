// Kernel A: classical simulated annealing on the split checkerboard.
//
// Replaces montecarlosolvers_tpu/ops/pallas_split.py::_split_kernel (:109),
// launched there by _run_split (:175) under anneal_lattice_split (:932).
// Plain PyTorch version: ops/split_kernels.py::sa_split_anneal_ref.
//
// What it computes. The state of each chain is the two checkerboard halves
// a, b of an even-L lattice, Nh = L*L/2 sites each. One schedule step
// updates all of half a from half b, then all of half b from the new half a
// (pallas_split.py:151-164). A site's field is the 5-slot stencil (7 with
// row wrap) of the other half, then + h; dE = -2 s f; the flip is accepted
// if dE <= 0 or -T*log1p(-u) > dE, with u from the counter hash at
// ctr(seed, step, color) and uid = chain*2Nh + color*Nh + site
// (pallas_split.py:137-143). The whole schedule runs in one launch.
//
// What bounds it on an H100. The work is 8.19 M updates per sweep at the
// main path's 1280 chains on 80x80; per update it needs 5 float32
// operations of the field and dE, 5 of Metropolis and a logarithm. As
// compiled (sm_90a SASS, tools/sass_counts.py), the chain loop is 74
// instructions an update, two chains an iteration: the field from bits 21
// (7 x SHF + LOP3 sign flip of the weight, 6 FADD, + h), the counter hash
// 19 integer operations (2 murmur3 rounds, shift, convert, scale), log1pf
// about 30, the spin, dE, compare, flip and loop the rest; the 7 weights, h
// and 7 neighbour words of a site cost a few more per update at 32 chains
// a word. At 1280 chains that is 20 us per sweep at one instruction per
// scheduler and cycle on 132 SMs; measured 0.0375 ms (H100 80GB HBM3,
// 700 W, PERF.md): 320 CTAs put 3 on some SMs where the mean is 2.4, a
// band of 400 sites on 256 threads idles a fifth of the lanes in its
// second pass, and about half the instructions run on the INT32 pipes at
// half the float32 rate. At 32 chains (the PIQMC pre-anneal) a sweep is
// 0.2 M updates, one chain a word, and the two cluster barriers a step and
// the serial latency of an update set the time: 4.0 us.
//
// What the design does about that.
// - Chains as bits. A CTA anneals a group of C <= 32 chains; bit c of the
//   word of site j is the sign of chain group*C + c (1 for -1), one word per
//   site and half in shared memory. A thread that owns site j loads the 7
//   weights and h, computes the neighbour indices and reads the 7 neighbour
//   words once per phase, then updates the C chains in turn: the weight
//   stream from L2 and the index work drop C-fold, and each w*s is a sign
//   flip of w (exact, so the slot order alone fixes the sum, as in
//   counter_hash.cuh::stencil). A ragged last group (chains not a multiple
//   of C) updates only its own chains; the other bits stay 0 and are never
//   read back.
// - A group over a cluster. Each group is spread over a cluster of R CTAs
//   (csrc/cluster.cuh): each holds a band of rows of both halves, a stencil
//   read across a band edge goes to the owning CTA through distributed
//   shared memory, and cluster.sync() stands between the phases for "phase
//   B reads the new half a". The wrapper (ops/split_kernels.py::
//   sa_geometry) takes C = 32 while that leaves 32 groups (else fewer
//   chains a word), and the largest R whose band fits a CTA's 227 KB and
//   whose clusters the card holds at once: at 1280 chains C = 32, R = 8
//   (320 CTAs), at 32 chains C = 1, R = 16 (512 CTAs of 224 threads), where
//   one block per chain used 32 SMs. Both halves are 2*ceil(L/R)*K words a
//   CTA, so R = 16 takes even L up to 960.
// - Metropolis without a branch (counter_hash.cuh::metropolis_accept_hashed):
//   the hash and log1pf run for every chain, so a warp's lanes never split
//   on dE.
// - The uniform source is a template argument (csrc/hw_rng.cuh): the
//   counter hash, or with hw_rng the thread's own generator stream, which
//   draws a site's chains in chain order; the hash instantiation is the
//   kernel as it was.
// - A lattice no cluster holds (even L above 960; sa_geometry returns None)
//   runs on the per-phase kernel below (split_sa_phased_anneal): the halves
//   as floats in device memory, updated in place, one thread per (chain,
//   site) of a half, chains along gridDim.x, two launches a step.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "counter_hash.cuh"
#include "hw_rng.cuh"

namespace {

namespace cg = cooperative_groups;

// At most 256 threads a CTA and registers for 5 such CTAs an SM (<= 51 a
// thread): then 5 CTAs of a 16-CTA cluster share each SM of a GPC, and the
// card holds 35 such clusters at once, more than the main path's 32
// chains (ops/split_kernels.py::MAX_THREADS is the same number). Room for
// 6 (38 registers) made the chain loop slower (PERF.md).
constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 5;

// kHw: uniforms from the thread's stream (hw_rng.cuh), not the counter hash
template <bool kHw>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
split_sa_kernel(const float* __restrict__ w, const float* __restrict__ h,
                const float* __restrict__ sched,
                const uint32_t* __restrict__ a_in,
                const uint32_t* __restrict__ b_in,
                uint32_t* __restrict__ a_out, uint32_t* __restrict__ b_out,
                int chains, int C, int R, int L, int nslots, int steps,
                uint32_t seed_term) {
  extern __shared__ uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = L / 2;
  const int nh = L * K;
  const int S = mcs::band_stride(L, R, L / 2);  // half b's words start at S
  const int group = blockIdx.x / R;
  const mcs::Band band =
      mcs::make_band(cluster, smem, blockIdx.x % R, R, L, L / 2);
  const size_t base = static_cast<size_t>(group) * nh + band.lo;
  for (int il = threadIdx.x; il < band.nb; il += blockDim.x) {
    smem[il] = a_in[base + il];
    smem[S + il] = b_in[base + il];
  }
  cluster.sync();  // every band is loaded before any is read

  const int cv = min(C, chains - group * C);  // chains of this group
  // uid = chain*2Nh + color*Nh + site wraps as the int32 JAX code does; the
  // hash input uid*kGolden + ctr steps by 2Nh*kGolden from chain to chain
  const uint32_t chain_step = 2u * static_cast<uint32_t>(nh) * mcs::kGolden;
  const uint32_t uid_group = static_cast<uint32_t>(group) *
                             static_cast<uint32_t>(C) * 2u *
                             static_cast<uint32_t>(nh);
  // with kHw, a site's C chains draw in chain order from the thread's stream
  mcs::Uniforms<kHw> rng(seed_term, mcs::thread_stream());
  for (int t = 0; t < steps; ++t) {
    const float temp = sched[t];
    // half a (color 0) from half b, then half b from the new half a
    for (int color = 0; color < 2; ++color) {
      const int own = color ? S : 0;
      const int other = color ? 0 : S;
      const uint32_t ctr = mcs::counter(seed_term, t, color);
      for (int il = threadIdx.x; il < band.nb; il += blockDim.x) {
        const int j = band.lo + il;
        float wv[7];
        uint32_t o[7];
        mcs::load_weights(w, color, nh, nslots, j, wv);
        const float hj = __ldg(h + color * nh + j);
        mcs::load_neighbours(band, other, il, K, nslots, o);
        const uint32_t word = smem[own + il];
        uint32_t flips = 0u;
        uint32_t x = (uid_group + static_cast<uint32_t>(color * nh + j)) *
                         mcs::kGolden + ctr;
        for (int c = 0; c < cv; ++c, x += chain_step) {
          const float f =
              __fadd_rn(mcs::field_of_bit(wv, o, nslots, c), hj);
          const float s = (word >> c) & 1u ? -1.0f : 1.0f;
          const float de = __fmul_rn(-2.0f * s, f);  // exact
          if (rng.accept(de, temp, x)) flips |= 1u << c;
        }
        smem[own + il] = word ^ flips;
      }
      cluster.sync();  // the next phase reads this half, also across bands
    }
  }

  for (int il = threadIdx.x; il < band.nb; il += blockDim.x) {
    a_out[base + il] = smem[il];
    b_out[base + il] = smem[S + il];
  }
}

size_t smem_bytes(int L, int R) {
  return 2 * static_cast<size_t>(mcs::band_stride(L, R, L / 2)) *
         sizeof(uint32_t);
}

// ---- the per-phase kernel, for lattices no cluster holds

constexpr int kThreads = 256;

// One half-phase of step t: one thread per site j of half `color` (spins
// s, +/-1 floats) of chain blockIdx.x / xblocks, against the other half o;
// only site j is written. With kHw the uniform is the first draw of the
// thread's stream of this launch, number `launch`.
template <bool kHw>
__global__ void __launch_bounds__(kThreads)
sa_phase_kernel(const float* __restrict__ w, const float* __restrict__ h,
                const float* __restrict__ sched, float* s,
                const float* __restrict__ o, int color, int nh, int K,
                int nslots, int xblocks, int t, uint32_t seed_term,
                uint32_t launch) {
  const int chain = blockIdx.x / xblocks;
  const int j = (blockIdx.x - chain * xblocks) * blockDim.x + threadIdx.x;
  if (j >= nh) return;
  const size_t at = static_cast<size_t>(chain) * nh + j;
  const float sv = s[at];
  const float f = __fadd_rn(
      mcs::half_field(o + (at - j), w, color, nh, K, nslots, j),
      __ldg(h + color * nh + j));
  const float de = __fmul_rn(-2.0f * sv, f);  // exact
  const uint32_t uid =
      static_cast<uint32_t>(chain) * (2u * static_cast<uint32_t>(nh)) +
      static_cast<uint32_t>(color * nh + j);
  const uint32_t ctr = mcs::counter(seed_term, t, color);
  mcs::Uniforms<kHw> rng(seed_term, mcs::phase_stream(launch));
  if (rng.accept(de, sched[t], uid * mcs::kGolden + ctr)) s[at] = -sv;
}

}  // namespace

// Anneal `chains` chains, packed C to a word, over `steps` temperatures.
// w: (nslots, 2, nh) and h: (2, nh) float32, sched: (steps,) float32;
// a_in, b_in, a_out, b_out: (ceil(chains/C), nh) uint32 words, bit c of
// word g the sign of chain g*C + c. One cluster of R CTAs of `threads`
// threads per group of C chains; hw_rng != 0 draws the uniforms from each
// thread's stream (hw_rng.cuh). Launches on `stream` and returns
// cudaGetLastError().
extern "C" int split_sa_anneal(const float* w, const float* h,
                               const float* sched, const uint32_t* a_in,
                               const uint32_t* b_in, uint32_t* a_out,
                               uint32_t* b_out, int chains, int C, int R,
                               int threads, int L, int nslots, int steps,
                               int seed, int hw_rng, void* stream) {
  if (chains == 0 || L == 0) return cudaSuccess;
  const int groups = (chains + C - 1) / C;
  const auto kernel = hw_rng ? split_sa_kernel<true> : split_sa_kernel<false>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = mcs::cluster_config(kernel, groups * R, R,
                                      threads, smem_bytes(L, R),
                                      static_cast<cudaStream_t>(stream),
                                      &cfg, &attr);
  if (e != cudaSuccess) return e;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  e = cudaLaunchKernelEx(&cfg, kernel, w, h, sched, a_in, b_in,
                         a_out, b_out, chains, C, R, L, nslots, steps,
                         seed_term);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Clusters of R CTAs the card holds at once at lattice size L (the hash
// instantiation's; the launch bounds give both the same register limit,
// and the shared memory is the same).
extern "C" int split_sa_max_active_clusters(int R, int threads, int L,
                                            int* count) {
  return mcs::max_active_clusters(split_sa_kernel<false>, R, threads,
                                  smem_bytes(L, R), count);
}

// The same anneal on the per-phase kernel: halves a_in, b_in of (chains,
// nh) float32 +/-1 (nh = L*L/2) are copied to a_out, b_out and updated
// there in place, two launches a step; hw_rng as for split_sa_anneal.
// Stores the number of kernels it launched in *launched (a host pointer);
// returns the first launch error, checked after the first step, or
// cudaGetLastError() at the end.
extern "C" int split_sa_phased_anneal(const float* w, const float* h,
                                      const float* sched, const float* a_in,
                                      const float* b_in, float* a_out,
                                      float* b_out, int chains, int L,
                                      int nslots, int steps, int seed,
                                      int hw_rng, void* stream,
                                      long long* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  const int K = L / 2;
  const int nh = L * K;
  const size_t bytes = static_cast<size_t>(chains) * nh * sizeof(float);
  cudaError_t e = cudaMemcpyAsync(a_out, a_in, bytes,
                                  cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return e;
  e = cudaMemcpyAsync(b_out, b_in, bytes, cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return e;
  if (chains == 0 || nh == 0) return cudaSuccess;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  const int xblocks = (nh + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(xblocks) * chains);
  const auto kernel = hw_rng ? sa_phase_kernel<true> : sa_phase_kernel<false>;
  for (int t = 0; t < steps; ++t) {
    // half a from half b, then half b from the new half a
    kernel<<<grid, kThreads, 0, st>>>(w, h, sched, a_out, b_out, 0, nh, K,
                                      nslots, xblocks, t, seed_term,
                                      static_cast<uint32_t>(*launched));
    kernel<<<grid, kThreads, 0, st>>>(w, h, sched, b_out, a_out, 1, nh, K,
                                      nslots, xblocks, t, seed_term,
                                      static_cast<uint32_t>(*launched + 1));
    *launched += 2;
    if (t == 0) {
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  }
  return cudaGetLastError();
}

extern "C" const char* split_sa_anneal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
