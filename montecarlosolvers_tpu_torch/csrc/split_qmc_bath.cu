// Kernel 5: dissipative PIQMC on the split checkerboard, any P >= 2, with
// optional whole-line moves.
//
// Replaces montecarlosolvers_tpu/ops/pallas_split.py::_qmc_bath_split_kernel
// (:696), launched there by _run_qmc_bath_split (:814) under
// anneal_lattice_qmc_bath_split (:857). Plain PyTorch version:
// ops/split_kernels.py::qmc_bath_split_anneal_ref.
//
// What it computes. The Trotter state of a chain is its per-slice halves
// a, b, each (P, Nh): a spin line lives in one half (ops/split.py:485-492).
// Per schedule step, slices k = 0..P-1 in order: half A of slice k updates,
// then half B of slice k against the new A (pallas_split.py:746-778), with
//   dE = -2B s f + 2 s J_perp (s_up + s_dn) + 2 T_eff s bath,
//   bath = sum_p M[k, p] s_p   (p = 0..P-1 in index order, M[k, k] = 0),
// the Trotter ring up = (k+P-1) mod P, dn = (k+1) mod P, and the uniforms at
// counter(seed, step, 2k + half), uid = chain*2Nh + half*Nh + site. With
// global moves, whole lines of half A and then of half B (against the
// flipped A) flip with dE = -2B sum_p s_p (f_p + h), at counter index
// 2P + half (:782-803); J_perp and the bath cancel for a whole-line flip.
//
// What bounds it on an H100. One site update reads a 5-7 slot stencil at
// slice k, the site's own line at up, dn and all P slices for the bath
// (P - 1 dependent adds in index order, which no reordering may shorten:
// the plain version's rounding fixes the order), hashes a uniform and
// evaluates log1pf. At the main path's 80x80, P = 40, 32 chains a sweep is
// 8.19 M site updates of about 135 float operations (79 of them the bath
// sum): 1.1 GFLOP, 16.5 us at the 67 TFLOP/s float32 peak. The state is
// 32 x 40 x 6400 x 4 B = 32.8 MB, read and written once per anneal: the
// bound is the operations, not the bytes.
//
// What the design does about that. One block per chain runs the whole
// schedule in one launch, as kernel A does, so the 2P + 2 dependent phases
// of a sweep are separated by __syncthreads() and not by launches (one
// launch per phase, as kernel B has, would be 82 launches per sweep at
// P = 40). One chain's float state is P*Nh*2*4 = 1 MB at P = 40, more than
// a block's 227 KB of shared memory, so the state lives in shared memory as
// bits: bit p of word p/32 of site j is the sign of s_p (1 for -1), in
// planes [word][site] so neighbouring threads read neighbouring words, P*N
// bits = 32 KB per chain at P = 40, beside the (P, P) bath matrix. Each
// thread owns fixed sites of both halves for the whole anneal, so the
// Trotter and bath terms of a site read only its own line, which only its
// owner writes, and only the spatial stencil crosses threads; a phase
// writes only its own half. At 32 chains this uses 32 of the 132 SMs:
// spreading one chain over several SMs (a thread-block cluster sharing the
// bit planes) is later work. The bath field is recomputed in index order at
// every update, never carried as a running sum updated on flips, which
// would round differently.
//
// Trouble spots, each handled where it bites below: the FMA contraction of
// dE (B*s*f rounds when B != 1, 2*T_eff*s*bath always rounds), the phase
// order (B reads the new A; line B reads A after line A's flips), the ring
// at P = 2 (up == dn), and the uid, which is the same for every slice of a
// half: only the counter index 2k + half differs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"

namespace {

constexpr int kThreads = 1024;

// s_p of a line word, bit p & 31: bit 1 is s = -1
__device__ __forceinline__ float spin_of(uint32_t word, int p) {
  return ((word >> (p & 31)) & 1u) ? -1.0f : 1.0f;
}

// s at slice p of site j in the bit planes `bits` ([word][site], nh sites)
__device__ __forceinline__ float spin_at(const uint32_t* bits, int nh, int p,
                                         int j) {
  return spin_of(bits[(p >> 5) * nh + j], p);
}

// The stencil of color `color` at site j over slice p of the other half
__device__ __forceinline__ float field_at(const uint32_t* other,
                                          const float* __restrict__ w,
                                          int color, int nh, int K,
                                          int nslots, int p, int j) {
  const uint32_t* plane = other + (p >> 5) * nh;
  return mcs::stencil([plane, p](int i) { return spin_of(plane[i], p); },
                      w, color, nh, K, nslots, j);
}

__global__ void __launch_bounds__(kThreads)
split_qmc_bath_kernel(const float* __restrict__ w,
                      const float* __restrict__ h,
                      const float* __restrict__ b_sched,
                      const float* __restrict__ jp,
                      const float* __restrict__ bath, float teff,
                      float two_teff, const float* __restrict__ a_in,
                      const float* __restrict__ b_in,
                      float* __restrict__ a_out, float* __restrict__ b_out,
                      int P, int nh, int K, int nslots, int steps,
                      uint32_t seed_term, int global_moves) {
  extern __shared__ uint32_t smem[];
  const int words = (P + 31) / 32;
  uint32_t* const bits_a = smem;
  uint32_t* const bits_b = smem + words * nh;
  float* const m = reinterpret_cast<float*>(smem + 2 * words * nh);
  const int chain = blockIdx.x;
  const size_t base = static_cast<size_t>(chain) * P * nh;

  for (int i = threadIdx.x; i < P * P; i += blockDim.x) m[i] = bath[i];
  for (int j = threadIdx.x; j < nh; j += blockDim.x) {
    for (int wd = 0; wd < words; ++wd) {
      uint32_t wa = 0, wb = 0;
      for (int p = wd * 32; p < P && p < wd * 32 + 32; ++p) {
        const size_t at = base + static_cast<size_t>(p) * nh + j;
        wa |= static_cast<uint32_t>(a_in[at] < 0.0f) << (p & 31);
        wb |= static_cast<uint32_t>(b_in[at] < 0.0f) << (p & 31);
      }
      bits_a[wd * nh + j] = wa;
      bits_b[wd * nh + j] = wb;
    }
  }
  __syncthreads();

  // uid = chain*2Nh + half*Nh + site, wrapping as the int32 JAX code does
  const uint32_t uid0 =
      static_cast<uint32_t>(chain) * (2u * static_cast<uint32_t>(nh));
  // the bits of a whole line in word wd (the last word may be partial)
  const uint32_t last_mask = (P & 31) ? (1u << (P & 31)) - 1u : ~0u;
  for (int t = 0; t < steps; ++t) {
    const float bc = -2.0f * b_sched[t];
    const float jpt = jp[t];
    for (int k = 0; k < P; ++k) {
      const int up = k == 0 ? P - 1 : k - 1;
      const int dn = k + 1 == P ? 0 : k + 1;
      const float* mk = m + k * P;
      // half A against B at slice k, then half B against the new A
      for (int half = 0; half < 2; ++half) {
        uint32_t* own = half ? bits_b : bits_a;
        const uint32_t* other = half ? bits_a : bits_b;
        const uint32_t ctr = mcs::counter(seed_term, t, 2 * k + half);
        for (int j = threadIdx.x; j < nh; j += blockDim.x) {
          const float sv = spin_at(own, nh, k, j);
          const float f = __fadd_rn(
              field_at(other, w, half, nh, K, nslots, k, j),
              __ldg(h + half * nh + j));
          const float tr =
              __fadd_rn(spin_at(own, nh, up, j), spin_at(own, nh, dn, j));
          // bath field of the line, p = 0..P-1 in index order; each
          // M*s is exact, the adds round as the plain version's do
          uint32_t word = own[j];
          float bf = __fmul_rn(mk[0], spin_of(word, 0));
          for (int p = 1; p < P; ++p) {
            if ((p & 31) == 0) word = own[(p >> 5) * nh + j];
            bf = __fadd_rn(bf, __fmul_rn(mk[p], spin_of(word, p)));
          }
          // dE = (bc*s)*f + ((2*s)*jp)*tr + (2teff*s)*bath, left to right:
          // the products with +/-1 and tr are exact, (bc*s)*f and
          // (2teff*s)*bath round, so no FMA may fuse them into the adds
          const float de = __fadd_rn(
              __fadd_rn(__fmul_rn(bc * sv, f),
                        __fmul_rn(__fmul_rn(2.0f * sv, jpt), tr)),
              __fmul_rn(two_teff * sv, bf));
          const float u = mcs::uniform01(
              ctr, uid0 + static_cast<uint32_t>(half * nh + j));
          if (mcs::metropolis_accept(de, teff, u))
            own[(k >> 5) * nh + j] ^= 1u << (k & 31);
        }
        __syncthreads();  // the next phase reads this half's slice k
      }
    }
    if (global_moves) {
      // lines of half A against B, then lines of half B against the
      // flipped A; dE = bc * sum_p s_p (f_p + h), p in index order
      for (int half = 0; half < 2; ++half) {
        uint32_t* own = half ? bits_b : bits_a;
        const uint32_t* other = half ? bits_a : bits_b;
        const uint32_t ctr = mcs::counter(seed_term, t, 2 * P + half);
        for (int j = threadIdx.x; j < nh; j += blockDim.x) {
          const float hj = __ldg(h + half * nh + j);
          float sum = 0.0f;
          for (int p = 0; p < P; ++p) {
            const float x = __fmul_rn(
                spin_at(own, nh, p, j),
                __fadd_rn(field_at(other, w, half, nh, K, nslots, p, j),
                          hj));
            sum = p == 0 ? x : __fadd_rn(sum, x);
          }
          const float de = __fmul_rn(bc, sum);
          const float u = mcs::uniform01(
              ctr, uid0 + static_cast<uint32_t>(half * nh + j));
          if (mcs::metropolis_accept(de, teff, u)) {
            for (int wd = 0; wd < words; ++wd)
              own[wd * nh + j] ^= wd + 1 == words ? last_mask : ~0u;
          }
        }
        __syncthreads();  // line B reads the flipped A; slice 0 reads B
      }
    }
  }

  for (int j = threadIdx.x; j < nh; j += blockDim.x) {
    for (int p = 0; p < P; ++p) {
      const size_t at = base + static_cast<size_t>(p) * nh + j;
      a_out[at] = spin_at(bits_a, nh, p, j);
      b_out[at] = spin_at(bits_b, nh, p, j);
    }
  }
}

// Shared memory one block takes: both halves' bit planes and the bath
// matrix (ops/split_kernels.py::qmc_bath_smem_bytes counts the same).
size_t smem_bytes(int P, int nh) {
  const size_t words = (P + 31) / 32;
  return (2 * words * nh + static_cast<size_t>(P) * P) * sizeof(uint32_t);
}

}  // namespace

// Anneal `chains` Trotter states over `steps` schedule points in one launch.
// w: (nslots, 2, nh), h: (2, nh), b_sched and jp: (steps,), bath: (P, P),
// halves (chains, P, nh) of +/-1; all float32 device pointers. teff and
// two_teff are T_eff and 2*T_eff rounded to float32. Launches on `stream`
// and returns cudaGetLastError().
extern "C" int split_qmc_bath_anneal(
    const float* w, const float* h, const float* b_sched, const float* jp,
    const float* bath, float teff, float two_teff, const float* a_in,
    const float* b_in, float* a_out, float* b_out, int chains, int P, int nh,
    int K, int nslots, int steps, int seed, int global_moves, void* stream) {
  if (chains == 0 || nh == 0) return cudaSuccess;
  const size_t smem = smem_bytes(P, nh);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        split_qmc_bath_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  split_qmc_bath_kernel<<<chains, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      w, h, b_sched, jp, bath, teff, two_teff, a_in, b_in, a_out, b_out, P,
      nh, K, nslots, steps, seed_term, global_moves);
  return cudaGetLastError();
}

extern "C" const char* split_qmc_bath_anneal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
