// Kernel A: classical simulated annealing on the split checkerboard.
//
// Replaces montecarlosolvers_tpu/ops/pallas_split.py::_split_kernel (:109),
// launched there by _run_split (:175) under anneal_lattice_split (:932).
// Plain PyTorch version: ops/split_kernels.py::sa_split_anneal_ref.
//
// What it computes. The state of each chain is the two checkerboard halves
// a, b of an even-L lattice, Nh = L*L/2 sites each. One schedule step
// updates all of half a from half b, then all of half b from the new half a
// (pallas_split.py:151-164). A site's field is h plus the 5-slot stencil
// (7 with row wrap) of the other half; dE = -2 s f; the flip is accepted if
// dE <= 0 or -T*log1p(-u) > dE, with u from the counter hash at
// ctr(seed, step, color) and uid = chain*2Nh + color*Nh + site
// (pallas_split.py:137-143). The whole schedule runs in one launch.
//
// What bounds it on an H100. Per site update: 7 weights + h (32 B) read
// through the read-only path, 8 spin reads from shared memory, about 14
// integer operations of the hash (2 rounds of 3 xor-shifts and 2 multiplies,
// one multiply-add, one shift) plus a log1pf. Per sweep of one chain that is
// 2*Nh*4 = 25.6 KB of state (L = 80), which never leaves shared memory, and
// (nslots*2 + 2)*Nh*4 = 205 KB of weights and fields, shared by every chain
// and so served from L1/L2, not from device memory. At the main path's 1280
// chains the device-memory traffic is the state in and out once per anneal;
// the weight stream from L2 and the hash arithmetic bound a sweep.
//
// What the design does about that. One thread block per chain keeps both
// halves in shared memory for the whole schedule: the TPU kernel's
// sequential grid axis over schedule chunks (`j`, :111) becomes the step
// loop inside the block, and a __syncthreads() between the phases stands
// for the ordering "phase B reads the new half a". Weights are read with
// __ldg. The TPU's lane rules (Nh % 128 == 0, L/2 <= 128, schedule chunks)
// do not apply: any even L whose two halves fit the 227 KB a block may use
// (2*Nh*4 bytes, so L <= 240) is taken; the wrapper raises ValueError
// beyond that, as pallas_split.py:955-959 does for its limits.
// Weight reuse across chains of one block, int8 spins and a persistent grid
// are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
split_sa_kernel(const float* __restrict__ w, const float* __restrict__ h,
                const float* __restrict__ sched,
                const float* __restrict__ a_in,
                const float* __restrict__ b_in, float* __restrict__ a_out,
                float* __restrict__ b_out, int nh, int K, int nslots,
                int steps, uint32_t seed_term) {
  extern __shared__ float smem[];
  float* a = smem;
  float* b = smem + nh;
  const int chain = blockIdx.x;
  const size_t base = static_cast<size_t>(chain) * nh;
  for (int j = threadIdx.x; j < nh; j += blockDim.x) {
    a[j] = a_in[base + j];
    b[j] = b_in[base + j];
  }
  __syncthreads();

  // uid = chain * 2Nh + color * Nh + site, wrapping as the int32 JAX code
  const uint32_t uid_a = static_cast<uint32_t>(chain) *
                         (2u * static_cast<uint32_t>(nh));
  const uint32_t uid_b = uid_a + static_cast<uint32_t>(nh);
  for (int t = 0; t < steps; ++t) {
    const float temp = sched[t];
    // phase A: half a from half b (only a[j] itself is written)
    const uint32_t ctr_a = mcs::counter(seed_term, t, 0);
    for (int j = threadIdx.x; j < nh; j += blockDim.x) {
      const float f = __fadd_rn(mcs::half_field(b, w, 0, nh, K, nslots, j),
                                __ldg(h + j));
      const float s = a[j];
      const float de = __fmul_rn(-2.0f * s, f);  // exact
      const float u = mcs::uniform01(ctr_a, uid_a + j);
      if (mcs::metropolis_accept(de, temp, u)) a[j] = -s;
    }
    __syncthreads();  // phase B reads the new half a
    const uint32_t ctr_b = mcs::counter(seed_term, t, 1);
    for (int j = threadIdx.x; j < nh; j += blockDim.x) {
      const float f = __fadd_rn(mcs::half_field(a, w, 1, nh, K, nslots, j),
                                __ldg(h + nh + j));
      const float s = b[j];
      const float de = __fmul_rn(-2.0f * s, f);
      const float u = mcs::uniform01(ctr_b, uid_b + j);
      if (mcs::metropolis_accept(de, temp, u)) b[j] = -s;
    }
    __syncthreads();  // the next phase A reads the new half b
  }

  for (int j = threadIdx.x; j < nh; j += blockDim.x) {
    a_out[base + j] = a[j];
    b_out[base + j] = b[j];
  }
}

}  // namespace

// Anneal `chains` chains over `steps` temperatures. w: (nslots, 2, nh),
// h: (2, nh), sched: (steps,), halves (chains, nh); all float32 device
// pointers. Launches on `stream` and returns cudaGetLastError().
extern "C" int split_sa_anneal(const float* w, const float* h,
                               const float* sched, const float* a_in,
                               const float* b_in, float* a_out, float* b_out,
                               int chains, int nh, int K, int nslots,
                               int steps, int seed, void* stream) {
  if (chains == 0 || nh == 0) return cudaSuccess;
  const size_t smem = 2 * static_cast<size_t>(nh) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        split_sa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  split_sa_kernel<<<chains, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      w, h, sched, a_in, b_in, a_out, b_out, nh, K, nslots, steps,
      seed_term);
  return cudaGetLastError();
}

extern "C" const char* split_sa_anneal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
