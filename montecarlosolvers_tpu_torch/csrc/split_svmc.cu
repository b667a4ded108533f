// Kernel 4: spin-vector Monte Carlo (rotor) annealing on the split
// checkerboard.
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
// uid = chain*2Nh + c*Nh + site. The whole schedule runs in one launch.
//
// What bounds it on an H100. Per site update: two hashed uniforms (about 28
// integer operations), cosf and sinf of the proposal, log1pf, the 7-slot
// stencil (8 weights and the field, 32 B, through the read-only path; 7
// cos reads from shared memory) and about 12 rounded float operations. The
// transcendentals and the hash dominate: the kernel is compute-bound, not
// bandwidth-bound. One chain's state is 6*Nh*4 = 77 KB at L = 80 (angles,
// cos and sin of both halves) and never leaves shared memory; the weights,
// (nslots*2 + 2)*Nh*4 = 205 KB, are shared by every chain and served from
// L1/L2. Device memory sees the angles in and out once per anneal.
//
// What the design does about that. One block per chain keeps both halves
// and their cos and sin caches in shared memory for the whole schedule (the
// TPU kernel's VMEM scratch, :237-243); the caches cut the transcendentals
// per site and phase from four to two (cos and sin of the proposal), and an
// accepted move writes cosf / sinf of the new angle, never an increment, so
// the cache always equals cos and sin of the carried angle. A
// __syncthreads() between the half-phases stands for "phase B reads the
// new half a". 512 threads a block and two blocks an SM (154 KB of the
// SM's 228 KB) hold the main path's 256 chains in one wave on 132 SMs. Any
// even L whose 6*Nh*4 bytes fit the 227 KB a block may use (L <= 139) is
// taken; the wrapper raises ValueError beyond that. The TPU's lane rules do
// not apply. Sharing the weight reads between chains, fewer transcendentals
// (sincosf once shown bitwise equal) and more chains per SM are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"
#include "svmc.cuh"

namespace {

constexpr int kThreads = 512;

// One half-phase: every site j of half `color` (angles th, caches cs, sn)
// against the cos cache of the other half. Only site j itself is written.
template <bool kTF>
__device__ __forceinline__ void half_phase(
    float* th, float* cs, float* sn, const float* cos_other,
    const float* __restrict__ w, const float* __restrict__ h, int color,
    int nh, int K, int nslots, uint32_t ctr_prop, uint32_t ctr_acc,
    uint32_t uid0, float a, float b, float width, float temp) {
  for (int j = threadIdx.x; j < nh; j += blockDim.x) {
    const uint32_t uid = uid0 + static_cast<uint32_t>(j);
    const float prop =
        mcs::propose<kTF>(th[j], mcs::uniform01(ctr_prop, uid), width);
    const float cos_p = cosf(prop);
    const float sin_p = sinf(prop);
    const float z =
        __fadd_rn(mcs::half_field(cos_other, w, color, nh, K, nslots, j),
                  __ldg(h + color * nh + j));
    const float de = mcs::delta_e(b, a, cos_p, cs[j], z, sn[j], sin_p);
    if (mcs::metropolis_accept(de, temp, mcs::uniform01(ctr_acc, uid))) {
      th[j] = prop;
      cs[j] = cos_p;
      sn[j] = sin_p;
    }
  }
}

template <bool kTF>
__global__ void __launch_bounds__(kThreads)
split_svmc_kernel(const float* __restrict__ w, const float* __restrict__ h,
                  const float* __restrict__ a_sched,
                  const float* __restrict__ b_sched, float temp,
                  const float* __restrict__ a_in,
                  const float* __restrict__ b_in, float* __restrict__ a_out,
                  float* __restrict__ b_out, int nh, int K, int nslots,
                  int steps, uint32_t seed_term) {
  extern __shared__ float smem[];
  float* th_a = smem;
  float* th_b = smem + nh;
  float* cs_a = smem + 2 * nh;
  float* cs_b = smem + 3 * nh;
  float* sn_a = smem + 4 * nh;
  float* sn_b = smem + 5 * nh;
  const int chain = blockIdx.x;
  const size_t base = static_cast<size_t>(chain) * nh;
  for (int j = threadIdx.x; j < nh; j += blockDim.x) {
    const float x = a_in[base + j];
    const float y = b_in[base + j];
    th_a[j] = x;
    cs_a[j] = cosf(x);
    sn_a[j] = sinf(x);
    th_b[j] = y;
    cs_b[j] = cosf(y);
    sn_b[j] = sinf(y);
  }
  __syncthreads();

  // uid = chain * 2Nh + color * Nh + site, wrapping as the int32 JAX code
  const uint32_t uid_a = static_cast<uint32_t>(chain) *
                         (2u * static_cast<uint32_t>(nh));
  const uint32_t uid_b = uid_a + static_cast<uint32_t>(nh);
  for (int t = 0; t < steps; ++t) {
    const float a = a_sched[t];
    const float b = b_sched[t];
    const float width = kTF ? mcs::tf_width(a, b) : 0.0f;
    half_phase<kTF>(th_a, cs_a, sn_a, cs_b, w, h, 0, nh, K, nslots,
                    mcs::counter(seed_term, t, 0),
                    mcs::counter(seed_term, t, 2), uid_a, a, b, width, temp);
    __syncthreads();  // phase B reads cos of the new half a
    half_phase<kTF>(th_b, cs_b, sn_b, cs_a, w, h, 1, nh, K, nslots,
                    mcs::counter(seed_term, t, 1),
                    mcs::counter(seed_term, t, 3), uid_b, a, b, width, temp);
    __syncthreads();  // the next phase A reads cos of the new half b
  }

  for (int j = threadIdx.x; j < nh; j += blockDim.x) {
    a_out[base + j] = th_a[j];
    b_out[base + j] = th_b[j];
  }
}

}  // namespace

// Anneal `chains` chains over the (steps,) schedules A and B at temperature
// `temp`. w: (nslots, 2, nh), h: (2, nh), angle halves (chains, nh); all
// float32 device pointers. tf != 0 selects the TF proposals. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int split_svmc_anneal(const float* w, const float* h,
                                 const float* a_sched, const float* b_sched,
                                 float temp, const float* a_in,
                                 const float* b_in, float* a_out,
                                 float* b_out, int chains, int nh, int K,
                                 int nslots, int steps, int seed, int tf,
                                 void* stream) {
  if (chains == 0 || nh == 0) return cudaSuccess;
  auto kernel = tf ? split_svmc_kernel<true> : split_svmc_kernel<false>;
  const size_t smem = 6 * static_cast<size_t>(nh) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  kernel<<<chains, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      w, h, a_sched, b_sched, temp, a_in, b_in, a_out, b_out, nh, K, nslots,
      steps, seed_term);
  return cudaGetLastError();
}

extern "C" const char* split_svmc_anneal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
