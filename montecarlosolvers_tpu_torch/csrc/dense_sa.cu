// Dense SA: the sequential micro-steps of one block of a blocked-sequential
// Metropolis sweep of a DenseProblem, for every chain, in one launch.
//
// Replaces no TPU kernel: the JAX package runs this path as XLA,
// montecarlosolvers_tpu/ops/dense_sweep.py::dense_metropolis_sweep (:45),
// whose inner lax.fori_loop (:99-121) is what this kernel computes. Plain
// PyTorch version: ops/dense_kernels.py::dense_sa_block_ref (ops/
// dense_sweep.py::block_steps on the counter hash).
//
// What it computes. Spins s (chains, Np) +/-1 floats, padded to whole
// blocks; the block at `start` of B sites; its products pb (chains, B) = s
// @ J[:, start:start+B], which the wrapper's torch.matmul made before the
// launch. The fields are f_k = pb_k + h[start+k], one float32 add (the
// bits of torch.matmul(...) + h). Step j = 0..B-1
// visits site i = start + j: dE = (-2 s_i) f_j; accept if dE <= 0*T or
// -T log1p(-u) > dE, u = uniform01(counter(seed, step, 0), chain * Np +
// i); then s_i' = -s_i or s_i, and every field of the block takes f_k +
// (s_i' - s_i) J[i, start+k]. The difference is 0 or +/-2, so the product
// is exact and the add rounds once, as the plain version's does. T =
// temps[row], or with a temperature per chain (parallel tempering,
// solvers/pt.py; the template argument kPerChain) temps[row * stride_t +
// chain * stride_c]; `step` is the sweep the hash counts (a launch inside
// a longer run passes its own).
//
// What bounds it on an H100. The B steps of a chain are a dependent chain:
// the next decision reads a field the last step updated. Per step a chain
// needs B multiply-adds of the rank-1 update and one compare, and the work
// of the whole sweep is the product's 2 C N^2 float32 operations, which
// torch.matmul does beside this kernel. So the kernel is latency-bound.
// The first design (one warp a chain, eight a CTA, the tile filled by a
// load-then-store loop, three shuffles from the owning lane a step, h added
// by a launch of its own) took 25 us a block at 1024 chains of
// sk_model(2048) for about 0.5 us of arithmetic (PERF.md).
//
// What the design does about that.
// - One warp a chain, `warps` warps a CTA (ops/dense_kernels.py::WARPS).
//   Lane l holds the fields, spins and acceptance thresholds -T log1p(-u)
//   of sites l, l + 32, ... of the block in registers. A step: every lane
//   evaluates the decision of its own column (the owning lane's is the
//   step's), one shuffle broadcasts d in {0, +/-2} from the owning lane,
//   and each lane adds d times its share of the tile row, whose
//   shared-memory loads issue before the decision (a pointer that walks
//   the tile a row a step). Two chains a warp, their decisions, shuffles
//   and updates interleaved, ran 1.3x slower a block at 1024 chains than
//   one chain a warp in eight warps, four 1.8-2.0x (PERF.md): the warps of
//   an SM hide each other's latency as well, with fewer registers.
// - The B x B diagonal tile of J (64 KB at B = 128) comes into shared
//   memory by cp.async, 16 bytes a copy where J's rows allow it, while the
//   lanes load their products, add h, and draw the uniforms and
//   logarithms of all B sites.
// - h is added here, so the sweep queues no elementwise add a block.
// No fast math; the rounding is the plain version's.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"

namespace {

constexpr int kMaxBlock = 128;
constexpr int kPerLane = kMaxBlock / 32;
constexpr int kMaxWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

template <bool kPerChain>
__global__ void __launch_bounds__(kMaxWarps * 32)
dense_sa_block_kernel(const float* __restrict__ J,
                      const float* __restrict__ pb,
                      const float* __restrict__ h,
                      const float* __restrict__ temps, float* s, int chains,
                      int np, int start, int B, int row, int step,
                      uint32_t seed_term, int stride_t, int stride_c,
                      uint32_t chain0, int vec) {
  extern __shared__ __align__(16) float tile[];  // tile[r * B + c] =
                                                 // J[start+r, start+c]
  if (vec) {
    const int q = B >> 2;  // 16-byte pieces a row
    for (int idx = threadIdx.x; idx < B * q; idx += blockDim.x) {
      const int r = idx / q;
      const int c = (idx - r * q) << 2;
      __pipeline_memcpy_async(
          tile + r * B + c,
          J + static_cast<size_t>(start + r) * np + start + c, 16);
    }
  } else {
    for (int idx = threadIdx.x; idx < B * B; idx += blockDim.x) {
      const int r = idx / B;
      const int c = idx - r * B;
      __pipeline_memcpy_async(
          tile + idx, J + static_cast<size_t>(start + r) * np + start + c, 4);
    }
  }
  __pipeline_commit();

  const int lane = threadIdx.x & 31;
  const int chain = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const bool live = chain < chains;
  const float temp =
      !live ? 1.0f
      : kPerChain ? __ldg(temps + static_cast<size_t>(row) * stride_t +
                          static_cast<size_t>(chain) * stride_c)
                  : __ldg(temps + row);
  const uint32_t ctr = mcs::counter(seed_term, step, 0);
  // uid = chain*Np + start + k, the chain counted from chain0 (the first
  // chain of a chain shard)
  const uint32_t uid0 = (chain0 + static_cast<uint32_t>(chain)) *
                            static_cast<uint32_t>(np) +
                        static_cast<uint32_t>(start);
  float f[kPerLane], sp[kPerLane], th[kPerLane];
  bool in_block[kPerLane];
#pragma unroll
  for (int m = 0; m < kPerLane; ++m) {
    const int k = lane + 32 * m;
    in_block[m] = k < B;
    // a warp past the last chain steps on +1 spins, zero fields and
    // thresholds, and is never written back
    f[m] = 0.0f;
    sp[m] = 1.0f;
    th[m] = 0.0f;
    if (live && in_block[m]) {
      const float p = __ldg(pb + static_cast<size_t>(chain) * B + k);
      f[m] = __fadd_rn(p, __ldg(h + start + k));
      sp[m] = s[static_cast<size_t>(chain) * np + start + k];
      const float u = mcs::uniform01(ctr, uid0 + static_cast<uint32_t>(k));
      th[m] = __fmul_rn(-temp, log1pf(-u));
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // every thread's copies are in the tile

#pragma unroll
  for (int m = 0; m < kPerLane; ++m) {
    // this lane's column of tile row j, one row further each step
    const float* trow = tile + 32 * m * B + lane;
    for (int l = 0; l < 32; ++l, trow += B) {
      if (32 * m + l >= B) break;  // the same in every lane: no divergence
      float rv[kPerLane];
#pragma unroll
      for (int mm = 0; mm < kPerLane; ++mm)
        rv[mm] = in_block[mm] ? trow[32 * mm] : 0.0f;
      // every lane decides its own column; lane l's is step j's
      const float de = __fmul_rn(__fmul_rn(-2.0f, sp[m]), f[m]);
      const bool accept = (de <= 0.0f * temp) | (th[m] > de);
      // s' - s: -2 s on a flip (exact), else +0
      const float d = __shfl_sync(
          kFull, accept ? __fsub_rn(-sp[m], sp[m]) : 0.0f, l);
#pragma unroll
      for (int mm = 0; mm < kPerLane; ++mm)
        f[mm] = __fadd_rn(f[mm], __fmul_rn(d, rv[mm]));
      if (lane == l && accept) sp[m] = -sp[m];
    }
  }
  if (live) {
#pragma unroll
    for (int m = 0; m < kPerLane; ++m) {
      if (in_block[m])
        s[static_cast<size_t>(chain) * np + start + lane + 32 * m] = sp[m];
    }
  }
}

}  // namespace

// The micro-steps of the block at `start` (B <= 128 sites) of padded spins
// s (chains, np), in place: J (np, np) the padded couplings, pb (chains, B)
// the block's products s @ J[:, start:start+B], h (np) the padded fields
// added to them in the kernel, temps the schedule, read at `row`
// (stride_c != 0: a temperature per chain,
// temps[row * stride_t + chain * stride_c]); `step` the sweep the hash
// counts; chain0 the global index of the first chain, which the uids count
// from (a chain shard; 0 unsharded). `warps` (1..8) chains a CTA, one a
// warp, B * B floats of dynamic shared memory. All device pointers;
// launches on `stream` and returns cudaGetLastError().
extern "C" int dense_sa_block(const float* J, const float* pb,
                              const float* h, const float* temps, float* s,
                              int chains, int np, int start, int B, int row,
                              int step, int seed, int warps, int stride_t,
                              int stride_c, int chain0, void* stream) {
  if (chains == 0 || B == 0) return cudaSuccess;
  if (B > kMaxBlock || warps < 1 || warps > kMaxWarps)
    return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(B) * B * sizeof(float);
  const auto kernel = stride_c ? dense_sa_block_kernel<true>
                               : dense_sa_block_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  // 16-byte copies need 16-byte aligned rows on both sides
  const int vec = reinterpret_cast<uintptr_t>(J) % 16 == 0 && np % 4 == 0 &&
                  start % 4 == 0 && B % 4 == 0;
  const int grid = (chains + warps - 1) / warps;
  kernel<<<grid, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      J, pb, h, temps, s, chains, np, start, B, row, step, seed_term,
      stride_t, stride_c, static_cast<uint32_t>(chain0), vec);
  return cudaGetLastError();
}

extern "C" const char* dense_sa_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
