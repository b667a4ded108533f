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
// What bounds it on an H100. Per site update: two hashed uniforms (about 28
// integer operations), cosf and sinf of the proposal, log1pf, the 4-point
// stencil of cos over shared memory with 5 planes (20 B) through the
// read-only path, and about 12 rounded float operations, plus the slot to
// site division. The transcendentals and the hash dominate: the kernel is
// compute-bound, not bandwidth-bound. One chain's state is 4*L*L*4 = 105 KB
// at L = 81 and never leaves shared memory; the planes, 5*L*L*4 = 131 KB,
// are shared by every chain and served from L1/L2.
//
// What the design does about that. One block per chain keeps the angles
// and caches of cos and sin in shared memory for the whole schedule, so a
// phase computes cos and sin of the proposal only (the TPU kernel computes
// cos and sin of the whole plane in every phase, :103-107, and the Pallas
// form with its masks computes every site; each uniform is a pure function
// of its site, so only the phase's own sites are computed here). A phase
// decides all of its sites from the cos plane as the phase found it: on an
// odd periodic L the wrap neighbours (r, 0) and (r, L-1) share a color
// (ROADMAP.md queue 3), and the Pallas kernel decides both from the state
// before the phase. A site writes its own angle and sin at once (no other
// site reads them) and stages its new cos in a fourth plane, marking the
// decision in a 64-bit mask per thread; after a __syncthreads() the marked
// cos values are copied in. The cache holds cosf / sinf of the carried
// angle exactly, never an increment. 512 threads a block and two blocks an
// SM (210 KB of the SM's 228 KB) hold the main path's 256 chains in one
// wave on 132 SMs. Any L whose four planes fit the 227 KB a block may use
// (L <= 120) is taken; the wrapper raises ValueError beyond that. Sharing
// the plane reads between chains, fewer transcendentals and a layout
// without the slot division are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"
#include "plane.cuh"
#include "svmc.cuh"

namespace {

constexpr int kThreads = 512;
// decisions a thread keeps per phase: the bits of its mask
constexpr int kMaxSlots = 64;

template <bool kTF>
__global__ void __launch_bounds__(kThreads)
plane_svmc_kernel(const float* __restrict__ w,
                  const float* __restrict__ a_sched,
                  const float* __restrict__ b_sched, float temp,
                  const float* __restrict__ th_in, float* __restrict__ th_out,
                  int L, uint32_t row_stride, uint32_t plane_stride,
                  int steps, uint32_t seed_term) {
  extern __shared__ float smem[];
  const int n = L * L;
  float* th = smem;            // angles
  float* cs = smem + n;        // cos of the angles, read by the stencil
  float* sn = smem + 2 * n;    // sin of the angles
  float* cs_new = smem + 3 * n;  // cos of accepted proposals, staged
  const int chain = blockIdx.x;
  const size_t base = static_cast<size_t>(chain) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float x = th_in[base + i];
    th[i] = x;
    cs[i] = cosf(x);
    sn[i] = sinf(x);
  }
  __syncthreads();

  // Slot j of a color is row j / half, column 2 * (j % half) + ((row +
  // color) & 1); slots past the last column are skipped.
  const int half = (L + 1) / 2;
  const int nslot = L * half;
  // uid = chain*R*C + r*C + c, wrapping as the int32 JAX code does
  const uint32_t uid0 = static_cast<uint32_t>(chain) * plane_stride;
  for (int t = 0; t < steps; ++t) {
    const float a = a_sched[t];
    const float b = b_sched[t];
    const float width = kTF ? mcs::tf_width(a, b) : 0.0f;
    for (int color = 0; color < 2; ++color) {
      const uint32_t ctr_prop = mcs::counter(seed_term, t, color);
      const uint32_t ctr_acc = mcs::svmc_accept_counter(seed_term, t, color);
      uint64_t accepted = 0;
      int bit = 0;
      for (int j = threadIdx.x; j < nslot; j += blockDim.x, ++bit) {
        const int r = j / half;
        const int c = 2 * (j - r * half) + ((r + color) & 1);
        if (c >= L) continue;
        const int i = r * L + c;
        const uint32_t uid =
            uid0 + static_cast<uint32_t>(r) * row_stride +
            static_cast<uint32_t>(c);
        const float prop =
            mcs::propose<kTF>(th[i], mcs::uniform01(ctr_prop, uid), width);
        const float cos_p = cosf(prop);
        const float sin_p = sinf(prop);
        const float z = mcs::plane_field(cs, w, L, r, c);
        const float de = mcs::delta_e(b, a, cos_p, cs[i], z, sn[i], sin_p);
        if (mcs::metropolis_accept(de, temp, mcs::uniform01(ctr_acc, uid))) {
          th[i] = prop;
          sn[i] = sin_p;
          cs_new[i] = cos_p;
          accepted |= 1ull << bit;
        }
      }
      __syncthreads();  // every decision read the cos plane the phase began with
      bit = 0;
      for (int j = threadIdx.x; accepted != 0; j += blockDim.x, ++bit) {
        if (accepted & (1ull << bit)) {
          const int r = j / half;
          const int i = r * L + 2 * (j - r * half) + ((r + color) & 1);
          cs[i] = cs_new[i];
          accepted &= ~(1ull << bit);
        }
      }
      __syncthreads();  // the next phase reads the updated cos plane
    }
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) th_out[base + i] = th[i];
}

}  // namespace

// Anneal `chains` L x L planes of angles over the (steps,) schedules A and B
// at temperature `temp`. w: (5, L, L) planes jr, jl, jd, ju, h; th_in,
// th_out: (chains, L, L); all float32 device pointers. row_stride = C and
// plane_stride = R*C are the uid strides; tf != 0 selects the TF proposals.
// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue when a phase has more sites than the block's masks
// hold (never within the shared-memory limit the wrapper checks).
extern "C" int plane_svmc_anneal(const float* w, const float* a_sched,
                                 const float* b_sched, float temp,
                                 const float* th_in, float* th_out,
                                 int chains, int L, int row_stride,
                                 int plane_stride, int steps, int seed,
                                 int tf, void* stream) {
  if (chains == 0 || L == 0) return cudaSuccess;
  if (L * ((L + 1) / 2) > kMaxSlots * kThreads) return cudaErrorInvalidValue;
  auto kernel = tf ? plane_svmc_kernel<true> : plane_svmc_kernel<false>;
  const size_t smem = 4 * static_cast<size_t>(L) * L * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  kernel<<<chains, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      w, a_sched, b_sched, temp, th_in, th_out, L,
      static_cast<uint32_t>(row_stride), static_cast<uint32_t>(plane_stride),
      steps, seed_term);
  return cudaGetLastError();
}

extern "C" const char* plane_svmc_anneal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
