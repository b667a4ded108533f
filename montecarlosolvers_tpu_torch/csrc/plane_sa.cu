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
// ju*up + h (csrc/plane.cuh), and the flip accepted if dE <= 0 or
// -T*log1p(-u) > dE; u comes from the counter hash at ctr(seed, step, color)
// and uid = chain*R*C + r*C + c, where R = pad8(L), C = pad128(L) are the
// strides of the TPU kernel's padded plane (pallas_sa.py:171-175), so the
// streams equal the Pallas kernel's. The whole schedule runs in one launch.
//
// What bounds it on an H100. Per site update: 5 planes (20 B) read through
// the read-only path, 5 spin reads from shared memory, about 14 integer
// operations of the hash and a log1pf. One chain's plane is L*L*4 bytes
// (26 KB at L = 81) and never leaves shared memory; the planes, 5*L*L*4 =
// 131 KB at L = 81, are shared by every chain and served from L1/L2. At
// the main path's 1280 chains the device-memory traffic is the state in and
// out once per anneal; the hash arithmetic and the plane reads bound a
// sweep.
//
// What the design does about that. One block per chain keeps the plane in
// shared memory for the whole schedule; the TPU kernel's sequential grid
// axis over schedule chunks becomes the step loop inside the block. A phase
// computes only its own color's sites (the Pallas kernel computes every
// site and masks; each uniform is a pure function of its site, so the
// result is the same). It decides all of them before it writes any: on an
// odd periodic L the wrap neighbours (r, 0) and (r, L-1) share a color
// (ROADMAP.md queue 3), and the Pallas kernel decides both from the state
// before the phase. Each thread keeps its decisions as bits of a 64-bit
// mask, then flips them after a __syncthreads(). The TPU's padding and
// masked wrap rolls do not carry over: the plane is L x L, and any L whose
// plane fits the 227 KB of shared memory a block may use (L <= 241) is
// taken; the wrapper raises ValueError beyond that. Several chains per
// block and int8 spins are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"
#include "plane.cuh"

namespace {

constexpr int kThreads = 512;
// decisions a thread keeps per phase: the bits of its mask
constexpr int kMaxSlots = 64;

__global__ void __launch_bounds__(kThreads)
plane_sa_kernel(const float* __restrict__ w, const float* __restrict__ sched,
                const float* __restrict__ s_in, float* __restrict__ s_out,
                int L, uint32_t row_stride, uint32_t plane_stride, int steps,
                uint32_t seed_term) {
  extern __shared__ float s[];
  const int n = L * L;
  const int chain = blockIdx.x;
  const size_t base = static_cast<size_t>(chain) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = s_in[base + i];
  __syncthreads();

  // Slot j of a color is row j / half, column 2 * (j % half) + ((row +
  // color) & 1); slots past the last column are skipped.
  const int half = (L + 1) / 2;
  const int nslot = L * half;
  // uid = chain*R*C + r*C + c, wrapping as the int32 JAX code does
  const uint32_t uid0 = static_cast<uint32_t>(chain) * plane_stride;
  for (int t = 0; t < steps; ++t) {
    const float temp = sched[t];
    for (int color = 0; color < 2; ++color) {
      const uint32_t ctr = mcs::counter(seed_term, t, color);
      uint64_t flips = 0;
      int bit = 0;
      for (int j = threadIdx.x; j < nslot; j += blockDim.x, ++bit) {
        const int r = j / half;
        const int c = 2 * (j - r * half) + ((r + color) & 1);
        if (c >= L) continue;
        const float sv = s[r * L + c];
        const float de = __fmul_rn(-2.0f * sv,
                                   mcs::plane_field(s, w, L, r, c));  // exact
        const float u = mcs::uniform01(
            ctr, uid0 + static_cast<uint32_t>(r) * row_stride +
                     static_cast<uint32_t>(c));
        if (mcs::metropolis_accept(de, temp, u)) flips |= 1ull << bit;
      }
      __syncthreads();  // every decision read the state the phase began with
      bit = 0;
      for (int j = threadIdx.x; flips != 0; j += blockDim.x, ++bit) {
        if (flips & (1ull << bit)) {
          const int r = j / half;
          const int c = 2 * (j - r * half) + ((r + color) & 1);
          s[r * L + c] = -s[r * L + c];
          flips &= ~(1ull << bit);
        }
      }
      __syncthreads();  // the next phase reads the flipped plane
    }
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) s_out[base + i] = s[i];
}

}  // namespace

// Anneal `chains` L x L planes over `steps` temperatures. w: (5, L, L)
// planes jr, jl, jd, ju, h; sched: (steps,); s_in, s_out: (chains, L, L);
// all float32 device pointers. row_stride = C and plane_stride = R*C are
// the uid strides. Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue when a phase has more sites than the block's masks
// hold (never within the shared-memory limit the wrapper checks).
extern "C" int plane_sa_anneal(const float* w, const float* sched,
                               const float* s_in, float* s_out, int chains,
                               int L, int row_stride, int plane_stride,
                               int steps, int seed, void* stream) {
  if (chains == 0 || L == 0) return cudaSuccess;
  if (L * ((L + 1) / 2) > kMaxSlots * kThreads) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(L) * L * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        plane_sa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  plane_sa_kernel<<<chains, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      w, sched, s_in, s_out, L, static_cast<uint32_t>(row_stride),
      static_cast<uint32_t>(plane_stride), steps, seed_term);
  return cudaGetLastError();
}

extern "C" const char* plane_sa_anneal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
