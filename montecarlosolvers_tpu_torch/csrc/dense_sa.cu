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
// blocks; the block at `start` of B sites; its fields fb (chains, B), the
// product s @ J[:, start:start+B] + h[start:start+B] that the wrapper's
// torch.matmul made before the launch. Step j = 0..B-1 visits site i =
// start + j: dE = (-2 s_i) f_j; accept if dE <= 0*T or -T log1p(-u) > dE,
// u = uniform01(counter(seed, step, 0), chain * Np + i); then s_i' = -s_i
// or s_i, and every field of the block takes f_k + (s_i' - s_i) J[i,
// start+k]. The difference is 0 or +/-2, so the product is exact and the
// add rounds once, as the plain version's does. T = temps[step].
//
// What bounds it on an H100. The B steps of a chain are a dependent chain:
// the next decision reads a field the last step updated. Per step a chain
// needs B multiply-adds of the rank-1 update and one compare, and the work
// of the whole sweep is the product's 2 C N^2 float32 operations, which
// torch.matmul does beside this kernel. So the kernel is latency-bound:
// one warp walks its chain's B steps, each a few shuffles, a compare and
// B/32 shared-memory loads and adds a lane.
//
// What the design does about that, simply (a first kernel): one warp a
// chain, WARPS warps a CTA sharing the block's B x B diagonal tile of J in
// shared memory (64 KB at B = 128). Lane l holds the fields, spins and
// acceptance thresholds -T log1p(-u) of sites l, l + 32, ... of the block
// in registers; the uniforms and logarithms are computed for all B sites up
// front, spread over the lanes, so a step is three shuffles from the
// owning lane, the same decision in every lane (no divergence) and each
// lane's share of the rank-1 update from the tile. No fast math; the
// rounding is the plain version's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"

namespace {

constexpr int kMaxBlock = 128;
constexpr int kPerLane = kMaxBlock / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(256)
dense_sa_block_kernel(const float* __restrict__ J,
                      const float* __restrict__ fb,
                      const float* __restrict__ temps, float* s, int chains,
                      int np, int start, int B, int step,
                      uint32_t seed_term) {
  extern __shared__ float tile[];  // B x B: tile[r * B + c] = J[start+r,
                                   // start+c]
  for (int idx = threadIdx.x; idx < B * B; idx += blockDim.x) {
    const int r = idx / B;
    const int c = idx - r * B;
    tile[idx] = __ldg(J + static_cast<size_t>(start + r) * np + start + c);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int chain = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (chain >= chains) return;
  const float temp = __ldg(temps + step);
  const uint32_t ctr = mcs::counter(seed_term, step, 0);
  float* sc = s + static_cast<size_t>(chain) * np + start;
  const float* fc = fb + static_cast<size_t>(chain) * B;
  const uint32_t uid0 = static_cast<uint32_t>(chain) *
                            static_cast<uint32_t>(np) +
                        static_cast<uint32_t>(start);
  float f[kPerLane], sp[kPerLane], th[kPerLane];
#pragma unroll
  for (int m = 0; m < kPerLane; ++m) {
    const int k = lane + 32 * m;
    f[m] = 0.0f;
    sp[m] = 0.0f;
    th[m] = 0.0f;
    if (k < B) {
      f[m] = fc[k];
      sp[m] = sc[k];
      const float u = mcs::uniform01(ctr, uid0 + static_cast<uint32_t>(k));
      th[m] = __fmul_rn(-temp, log1pf(-u));
    }
  }
#pragma unroll
  for (int m = 0; m < kPerLane; ++m) {
    for (int l = 0; l < 32; ++l) {
      const int j = 32 * m + l;
      if (j >= B) break;  // the same j in every lane: no divergence
      const float fj = __shfl_sync(kFull, f[m], l);
      const float sj = __shfl_sync(kFull, sp[m], l);
      const float thj = __shfl_sync(kFull, th[m], l);
      const float de = __fmul_rn(__fmul_rn(-2.0f, sj), fj);
      const bool accept = (de <= 0.0f * temp) | (thj > de);
      const float s_new = accept ? -sj : sj;
      const float d = __fsub_rn(s_new, sj);
      const float* row = tile + j * B;
#pragma unroll
      for (int mm = 0; mm < kPerLane; ++mm) {
        const int k = lane + 32 * mm;
        if (k < B) f[mm] = __fadd_rn(f[mm], __fmul_rn(d, row[k]));
      }
      if (lane == l) sp[m] = s_new;
    }
  }
#pragma unroll
  for (int m = 0; m < kPerLane; ++m) {
    const int k = lane + 32 * m;
    if (k < B) sc[k] = sp[m];
  }
}

}  // namespace

// The micro-steps of the block at `start` (B <= 128 sites) of padded spins
// s (chains, np), in place: J (np, np) the padded couplings, fb (chains, B)
// the block's fields, temps the schedule, read at `step`. `warps` chains a
// CTA of warps * 32 threads (<= 256), B * B floats of dynamic shared
// memory. All device pointers; launches on `stream` and returns
// cudaGetLastError().
extern "C" int dense_sa_block(const float* J, const float* fb,
                              const float* temps, float* s, int chains,
                              int np, int start, int B, int step, int seed,
                              int warps, void* stream) {
  if (chains == 0 || B == 0) return cudaSuccess;
  if (B > kMaxBlock || warps < 1 || warps > 8) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(B) * B * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dense_sa_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  const int grid = (chains + warps - 1) / warps;
  dense_sa_block_kernel<<<grid, warps * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      J, fb, temps, s, chains, np, start, B, step, seed_term);
  return cudaGetLastError();
}

extern "C" const char* dense_sa_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
