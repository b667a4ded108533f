// Kernel B: PIQMC local moves at even P, plus optional whole-line moves, on
// the split checkerboard.
//
// Replaces montecarlosolvers_tpu/ops/pallas_split.py::_qmc_split_kernel
// (:431), launched there by _run_qmc_split (:567) under
// anneal_lattice_qmc_split (:607). Plain PyTorch version:
// ops/split_kernels.py::qmc_split_anneal_ref.
//
// What it computes. The Trotter state of a chain is four quarters
// xe, xo, ye, yo, each (Q = P/2, Nh) (ops/split.py:340-354). Per schedule
// step: phase X updates xe and xo against ye and yo, phase Y updates ye and
// yo against the new xe and xo, with
//   dE = -2B s f + 2 s J_perp (Trotter up + Trotter down),
// T_eff = P*T and J_perp = -(T_eff/2) ln tanh(Gamma/T_eff); then, with
// global moves, whole lines of color A (xe, yo) and then of color B
// (ye, xo, against the updated A quarters) flip with dE = -2B sum_q s f.
//
// What bounds it on an H100. One chain's state is P*Nh*2*4 bytes = 1 MB at
// P = 40, N = 6400: more than the 227 KB of shared memory a block can hold,
// so the TPU design, which keeps a block of chains resident in VMEM for the
// whole schedule, does not carry over. The state lives in device memory;
// 32 chains are 32 MB, which the 50 MB L2 mostly holds. Per local site
// update: 5-7 neighbour reads + 2 Trotter reads + 1 read and at most 1 write
// of state, 32 B of weights and field through the read-only path, about 14
// integer operations of the hash and a log1pf. Per step the four phases
// stream the state through L2 about 3 times (2 local phases read half and
// the neighbours of the other half; 2 line phases read it all).
//
// What the design does about that. Per-phase kernels over (chain, q, site)
// with the state in device memory; stream order gives the barriers between
// them. Four launches per step: (1) phase X, (2) phase Y, (3) lines of
// color A, (4) lines of color B. A line thread loops q = 0..Q-1 in index
// order, as the plain version and the JAX oracle sum. J_perp is computed
// once per anneal by the wrapper with the plain version's torch expression,
// so kernel and plain version read the same values. The host loop over
// steps sits inside the C entry point, one ctypes call per anneal. A
// persistent cooperative kernel or a CUDA graph over the step loop, and
// int8 spin storage, are later work.
//
// Trouble spots, each handled where it bites below: the Trotter ring
// (indices mod Q; at Q = 1 both ring terms are the same element), the FMA
// contraction of dE whenever B != 1, and the phase order (Y reads the new X,
// line B reads the A quarters after line A's flips).
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"

namespace {

constexpr int kThreads = 256;

// One local phase: blockIdx.y < Q updates quarter s0 (its q = blockIdx.y)
// and blockIdx.y >= Q updates quarter s1, for chain blockIdx.z. Quarter
// `which` reads its spatial neighbours in o<which> at the same q, and its
// Trotter neighbours in r<which> at q and at q-1 (which 0) or q+1 (which 1):
// pallas_split.py:514-518, _q_roll(x, True) reading x[q-1]:
//   phase X: xe <- ye, yo[q] + yo[q-1]      xo <- yo, ye[q] + ye[q+1]
//   phase Y: ye <- xe, xo[q] + xo[q-1]      yo <- xo, xe[q] + xe[q+1]
// The counter index is idx0 + which (0, 1 in phase X; 2, 3 in phase Y).
__global__ void __launch_bounds__(kThreads)
qmc_local_kernel(const float* __restrict__ w, const float* __restrict__ h,
                 const float* __restrict__ b_sched,
                 const float* __restrict__ jp, float teff, float* s0,
                 const float* __restrict__ o0, const float* __restrict__ r0,
                 int color0, float* s1, const float* __restrict__ o1,
                 const float* __restrict__ r1, int color1, int idx0, int Q,
                 int nh, int K, int nslots, int t, uint32_t seed_term) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nh) return;
  const int which = blockIdx.y >= Q;
  const int q = blockIdx.y - which * Q;
  const int chain = blockIdx.z;
  float* s = which ? s1 : s0;
  const float* o = which ? o1 : o0;
  const float* r = which ? r1 : r0;
  const int color = which ? color1 : color0;
  // Trotter ring partner, mod Q (at Q = 1 it is q itself)
  const int qn = which ? (q + 1 == Q ? 0 : q + 1) : (q == 0 ? Q - 1 : q - 1);
  const size_t row = (static_cast<size_t>(chain) * Q + q) * nh;
  const size_t row_n = (static_cast<size_t>(chain) * Q + qn) * nh;

  const float sv = s[row + j];
  const float f = __fadd_rn(mcs::half_field(o + row, w, color, nh, K,
                                            nslots, j),
                            __ldg(h + color * nh + j));
  const float tr = __fadd_rn(r[row + j], r[row_n + j]);
  const float bc = -2.0f * b_sched[t];
  // dE = bc*s*f + 2*s*jp*tr in the plain version's order. bc*s, 2*s*jp and
  // the product with tr (in {-2, 0, 2}) are exact, but (bc*s)*f is rounded
  // whenever B != 1, so an FMA fused into the sum would change dE:
  // __fmul_rn/__fadd_rn keep the two roundings of the plain version.
  const float de = __fadd_rn(__fmul_rn(bc * sv, f),
                             __fmul_rn(__fmul_rn(2.0f * sv, jp[t]), tr));
  const int idx = idx0 + which;
  // uid = chain*4*Q*Nh + idx*Q*Nh + q*Nh + site (pallas_split.py:483-486),
  // all in uint32_t so it wraps as the int32 JAX code does
  const uint32_t qnh = static_cast<uint32_t>(Q) * static_cast<uint32_t>(nh);
  const uint32_t uid = static_cast<uint32_t>(chain) * (4u * qnh) +
                       static_cast<uint32_t>(idx) * qnh +
                       static_cast<uint32_t>(q) * static_cast<uint32_t>(nh) +
                       static_cast<uint32_t>(j);
  const float u = mcs::uniform01(mcs::counter(seed_term, t, idx), uid);
  if (mcs::metropolis_accept(de, teff, u)) s[row + j] = -sv;
}

// Whole-line moves of `color`, one thread per (chain = blockIdx.y, site):
// the line's sites are s1 (even slices) and s2 (odd slices), their spatial
// neighbours o1 and o2. dE = bc * (sum_q s1 f1 + sum_q s2 f2), each sum in
// index order from q = 0; J_perp cancels for a whole-line flip
// (qmc.pyx:405-438). Counter index 4 + color, uid = chain*2Nh + color*Nh +
// site (pallas_split.py:489-493).
__global__ void __launch_bounds__(kThreads)
qmc_line_kernel(const float* __restrict__ w, const float* __restrict__ h,
                const float* __restrict__ b_sched, float teff, float* s1,
                const float* __restrict__ o1, float* s2,
                const float* __restrict__ o2, int color, int Q, int nh, int K,
                int nslots, int t, uint32_t seed_term) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nh) return;
  const int chain = blockIdx.y;
  const size_t base = static_cast<size_t>(chain) * Q * nh;
  const float hj = __ldg(h + color * nh + j);
  float sum1 = 0.0f;
  for (int q = 0; q < Q; ++q) {
    const size_t row = base + static_cast<size_t>(q) * nh;
    const float f = __fadd_rn(
        mcs::half_field(o1 + row, w, color, nh, K, nslots, j), hj);
    sum1 = __fadd_rn(sum1, __fmul_rn(s1[row + j], f));
  }
  float sum2 = 0.0f;
  for (int q = 0; q < Q; ++q) {
    const size_t row = base + static_cast<size_t>(q) * nh;
    const float f = __fadd_rn(
        mcs::half_field(o2 + row, w, color, nh, K, nslots, j), hj);
    sum2 = __fadd_rn(sum2, __fmul_rn(s2[row + j], f));
  }
  const float de = __fmul_rn(-2.0f * b_sched[t], __fadd_rn(sum1, sum2));
  const int idx = 4 + color;
  const uint32_t uid =
      static_cast<uint32_t>(chain) * (2u * static_cast<uint32_t>(nh)) +
      static_cast<uint32_t>(color) * static_cast<uint32_t>(nh) +
      static_cast<uint32_t>(j);
  const float u = mcs::uniform01(mcs::counter(seed_term, t, idx), uid);
  if (mcs::metropolis_accept(de, teff, u)) {
    for (int q = 0; q < Q; ++q) {
      const size_t row = base + static_cast<size_t>(q) * nh;
      s1[row + j] = -s1[row + j];
      s2[row + j] = -s2[row + j];
    }
  }
}

}  // namespace

// Anneal `chains` Trotter states over `steps` schedule points. w:
// (nslots, 2, nh), h: (2, nh), b_sched and jp: (steps,), quarters
// (chains, Q, nh); all float32 device pointers. The inputs are copied to
// the outputs, which are then updated in place. Launches on `stream`;
// returns the first launch error, checked after the first step, or
// cudaGetLastError() at the end.
extern "C" int split_qmc_anneal(const float* w, const float* h,
                                const float* b_sched, const float* jp,
                                float teff, const float* xe_in,
                                const float* xo_in, const float* ye_in,
                                const float* yo_in, float* xe, float* xo,
                                float* ye, float* yo, int chains, int Q,
                                int nh, int K, int nslots, int steps,
                                int seed, int global_moves, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(chains) * Q * nh * sizeof(float);
  const float* ins[4] = {xe_in, xo_in, ye_in, yo_in};
  float* outs[4] = {xe, xo, ye, yo};
  for (int i = 0; i < 4; ++i) {
    cudaError_t e = cudaMemcpyAsync(outs[i], ins[i], bytes,
                                    cudaMemcpyDeviceToDevice, st);
    if (e != cudaSuccess) return e;
  }
  if (chains == 0 || Q == 0 || nh == 0) return cudaGetLastError();
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  const int xblocks = (nh + kThreads - 1) / kThreads;
  const dim3 grid_local(xblocks, 2 * Q, chains);
  const dim3 grid_line(xblocks, chains);
  for (int t = 0; t < steps; ++t) {
    // phase X: xe (color A) and xo (color B) against ye, yo
    qmc_local_kernel<<<grid_local, kThreads, 0, st>>>(
        w, h, b_sched, jp, teff, xe, ye, yo, 0, xo, yo, ye, 1, 0, Q, nh, K,
        nslots, t, seed_term);
    // phase Y, after X in stream order: ye (B) and yo (A) against new X
    qmc_local_kernel<<<grid_local, kThreads, 0, st>>>(
        w, h, b_sched, jp, teff, ye, xe, xo, 1, yo, xo, xe, 0, 2, Q, nh, K,
        nslots, t, seed_term);
    if (global_moves) {
      // lines of color A: sites xe + yo, neighbours ye / xo
      qmc_line_kernel<<<grid_line, kThreads, 0, st>>>(
          w, h, b_sched, teff, xe, ye, yo, xo, 0, Q, nh, K, nslots, t,
          seed_term);
      // lines of color B, against the A quarters line A just updated
      qmc_line_kernel<<<grid_line, kThreads, 0, st>>>(
          w, h, b_sched, teff, ye, xe, xo, yo, 1, Q, nh, K, nslots, t,
          seed_term);
    }
    if (t == 0) {
      cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  }
  return cudaGetLastError();
}

extern "C" const char* split_qmc_anneal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
