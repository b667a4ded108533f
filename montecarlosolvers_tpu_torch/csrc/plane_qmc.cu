// Kernel 3: PIQMC on the full L x L plane at any P, local moves on the
// space-time coloring plus optional whole-line moves.
//
// Replaces montecarlosolvers_tpu/ops/pallas_qmc.py::_qmc_kernel (:70),
// launched there by _run_qmc (:210) under anneal_lattice_qmc (:146). Plain
// PyTorch version: ops/plane_kernels.py::qmc_plane_anneal_ref.
//
// What it computes. The Trotter state of a chain is P planes of L x L
// spins. Per schedule step: m = spacetime_num_phases(2, P) local phases
// (m = 2 at even P, 3 at P = 3 and 5, 4 at P = 7), phase p flipping the
// sites with ((r + c) % 2 + k) % m == p, with
//   dE = -2B s f + 2 s J_perp (s[k-1] + s[k+1])     (Trotter ring mod P)
// and u from ctr(seed, step, p) at uid = chain*P*R*C + k*R*C + r*C + c
// (R = pad8(L), C = pad128(L), the TPU kernel's padded strides,
// pallas_qmc.py:91-97). Then, with global moves, whole lines of color 0 and
// then of color 1 flip with dE = sum_k -2B s f in index order (J_perp
// cancels for a whole line); a line's u is the k = 0 plane's, drawn at the
// line counter ((seed*M + step*40503) ^ 374761393) + color*69069
// (pallas_qmc.py:124-140). Every site of a phase is decided from the state
// as the phase found it. J_perp is computed once per anneal by the wrapper
// (schedules.jperp), so kernel and plain version read the same values.
//
// What bounds it on an H100. One chain's state is P*L*L*4 bytes, 128 KB at
// P = 5, L = 80, and the main path's 32 chains hold 4 MB, which the 50 MB
// L2 keeps. Per site and phase: 5 planes (20 B, read-only path), 4
// neighbour and 2 Trotter reads, one read and one write of the state, the
// hash and a log1pf for the m-th of the sites the phase owns. Per step the
// m + 2 launches stream the whole state through L2 m + 2 times, and each
// launch costs a few microseconds of launch latency at this size.
//
// What the design does about that. One launch per phase over (chain, k,
// site) threads, with the state in device memory and two buffers: a phase
// reads one buffer and writes every site to the other (its own sites
// decided, the rest copied), so every decision sees the state the phase
// began with. That is what the Pallas kernel computes, and it matters on an
// odd periodic L, where the wrap neighbours (r, 0) and (r, L-1) share a
// color (ROADMAP.md queue 3). Stream order gives the barriers between
// phases. A line thread loops k = 0..P-1 in index order, as the plain
// version and the JAX code sum. The host loop over steps sits inside the C
// entry point, one ctypes call per anneal. One block per chain with the
// state in shared memory (128 KB at P = 5, L = 80), in-place updates where
// the coloring is proper, and CUDA graphs over the step loop are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"
#include "plane.cuh"

namespace {

constexpr int kThreads = 256;

// Local phase p of step t: one thread per site i of plane k = blockIdx.y of
// chain blockIdx.z; reads src, writes dst.
__global__ void __launch_bounds__(kThreads)
qmc_local_kernel(const float* __restrict__ w,
                 const float* __restrict__ b_sched,
                 const float* __restrict__ jp, float teff,
                 const float* __restrict__ src, float* __restrict__ dst,
                 int P, int L, uint32_t row_stride, uint32_t plane_stride,
                 int m, int p, int t, uint32_t seed_term) {
  const int n = L * L;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int k = blockIdx.y;
  const int chain = blockIdx.z;
  const int r = i / L;
  const int c = i - r * L;
  const size_t line0 = static_cast<size_t>(chain) * P * n + i;
  const size_t at = line0 + static_cast<size_t>(k) * n;
  const float sv = src[at];
  if ((((r + c) & 1) + k) % m != p) {
    dst[at] = sv;
    return;
  }
  // Trotter ring partners k-1 and k+1, mod P (at P = 2 the same plane)
  const int ku = k == 0 ? P - 1 : k - 1;
  const int kd = k + 1 == P ? 0 : k + 1;
  const float tr = __fadd_rn(src[line0 + static_cast<size_t>(ku) * n],
                             src[line0 + static_cast<size_t>(kd) * n]);
  const float f = mcs::plane_field(src + (at - i), w, L, r, c);
  const float bc = -2.0f * b_sched[t];
  // dE = ((bc*s)*f) + (((2*s)*jp)*tr) in the plain version's order: bc*s,
  // 2*s*jp and the product with tr (in {-2, 0, 2}) are exact, but
  // (bc*s)*f is rounded whenever B != 1, so an FMA fused into the sum would
  // change dE; __fmul_rn/__fadd_rn keep the two roundings.
  const float de = __fadd_rn(__fmul_rn(bc * sv, f),
                             __fmul_rn(__fmul_rn(2.0f * sv, jp[t]), tr));
  // uid = chain*P*R*C + k*R*C + r*C + c, wrapping as the int32 JAX code
  const uint32_t chain_stride = static_cast<uint32_t>(P) * plane_stride;
  const uint32_t uid =
      static_cast<uint32_t>(chain) * chain_stride +
      static_cast<uint32_t>(k) * plane_stride +
      static_cast<uint32_t>(r) * row_stride + static_cast<uint32_t>(c);
  const float u = mcs::uniform01(mcs::counter(seed_term, t, p), uid);
  dst[at] = mcs::metropolis_accept(de, teff, u) ? -sv : sv;
}

// Line phase of `color` at step t: one thread per site i of chain
// blockIdx.y, owning that site's whole line over k; reads src, writes dst.
__global__ void __launch_bounds__(kThreads)
qmc_line_kernel(const float* __restrict__ w,
                const float* __restrict__ b_sched, float teff,
                const float* __restrict__ src,
                float* __restrict__ dst, int P, int L, uint32_t row_stride,
                uint32_t plane_stride, int color, int t, uint32_t seed_term) {
  const int n = L * L;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int chain = blockIdx.y;
  const int r = i / L;
  const int c = i - r * L;
  const size_t plane0 = static_cast<size_t>(chain) * P * n;
  if (((r + c) & 1) != color) {
    for (int k = 0; k < P; ++k) {
      const size_t at = plane0 + static_cast<size_t>(k) * n + i;
      dst[at] = src[at];
    }
    return;
  }
  const float bc = -2.0f * b_sched[t];
  // sum_k (bc*s)*f in index order, from the k = 0 term
  float de = 0.0f;
  for (int k = 0; k < P; ++k) {
    const float* plane = src + plane0 + static_cast<size_t>(k) * n;
    const float term =
        __fmul_rn(bc * plane[i], mcs::plane_field(plane, w, L, r, c));
    de = k == 0 ? term : __fadd_rn(de, term);
  }
  // one decision per line, from the k = 0 plane's uid
  const uint32_t chain_stride = static_cast<uint32_t>(P) * plane_stride;
  const uint32_t uid = static_cast<uint32_t>(chain) * chain_stride +
                       static_cast<uint32_t>(r) * row_stride +
                       static_cast<uint32_t>(c);
  const float u = mcs::uniform01(mcs::line_counter(seed_term, t, color), uid);
  const float sign = mcs::metropolis_accept(de, teff, u) ? -1.0f : 1.0f;
  for (int k = 0; k < P; ++k) {
    const size_t at = plane0 + static_cast<size_t>(k) * n + i;
    dst[at] = sign * src[at];
  }
}

}  // namespace

// Anneal `chains` Trotter states (chains, P, L, L) over `steps` schedule
// points. w: (5, L, L) planes jr, jl, jd, ju, h; b_sched and jp: (steps,);
// s_in, s_out, scratch: (chains, P, L, L); all float32 device pointers.
// row_stride = C and plane_stride = R*C are the uid strides, m the number
// of local phases. The phases ping-pong between s_out and scratch, ordered
// so that the last one writes s_out; s_in is only read. Launches on
// `stream` and stores the number of kernels it launched in *launched (a
// host pointer); returns the first launch error, checked after the first
// step, or cudaGetLastError() at the end.
extern "C" int plane_qmc_anneal(const float* w, const float* b_sched,
                                const float* jp, float teff,
                                const float* s_in, float* s_out,
                                float* scratch, int chains, int P, int L,
                                int row_stride, int plane_stride, int m,
                                int steps, int seed, int global_moves,
                                void* stream, long long* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = static_cast<size_t>(L) * L;
  *launched = 0;
  if (chains == 0 || P == 0 || n == 0) return cudaSuccess;
  const long long launches =
      static_cast<long long>(steps) * (m + (global_moves ? 2 : 0));
  if (launches == 0) {
    return cudaMemcpyAsync(s_out, s_in,
                           static_cast<size_t>(chains) * P * n * sizeof(float),
                           cudaMemcpyDeviceToDevice, st);
  }
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  const uint32_t rs = static_cast<uint32_t>(row_stride);
  const uint32_t ps = static_cast<uint32_t>(plane_stride);
  const int xblocks = static_cast<int>((n + kThreads - 1) / kThreads);
  const dim3 grid_local(xblocks, P, chains);
  const dim3 grid_line(xblocks, chains);
  const float* src = s_in;
  long long done = 0;
  // launch j writes s_out when launches - 1 - j is even, so the last does
  auto next_dst = [&]() {
    float* d = (launches - 1 - done) % 2 == 0 ? s_out : scratch;
    ++done;
    return d;
  };
  for (int t = 0; t < steps; ++t) {
    for (int p = 0; p < m; ++p) {
      float* dst = next_dst();
      qmc_local_kernel<<<grid_local, kThreads, 0, st>>>(
          w, b_sched, jp, teff, src, dst, P, L, rs, ps, m, p, t, seed_term);
      src = dst;
    }
    if (global_moves) {
      for (int color = 0; color < 2; ++color) {
        float* dst = next_dst();
        qmc_line_kernel<<<grid_line, kThreads, 0, st>>>(
            w, b_sched, teff, src, dst, P, L, rs, ps, color, t, seed_term);
        src = dst;
      }
    }
    if (t == 0) {
      cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  }
  *launched = done;
  return cudaGetLastError();
}

extern "C" const char* plane_qmc_anneal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
