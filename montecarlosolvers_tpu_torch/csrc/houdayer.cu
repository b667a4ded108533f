// Houdayer isoenergetic cluster move between replica pairs: the overlap
// q = s1 s2, the components of its q = -1 domain, and a fair coin a
// component that flips it in both replicas.
//
// Replaces no TPU kernel: the JAX package runs this as XLA,
// montecarlosolvers_tpu/ops/cluster.py::houdayer_sweep (:730) and its grid
// form houdayer_sweep_grid (:704), which label the domain's components by
// min-label relaxation in a lax.while_loop, one round a hop of the largest
// component's diameter; parallel tempering's ICM (solvers/pt.py::
// _icm_impl) calls it every `houdayer_every` sweeps. Plain PyTorch
// version: ops/cluster.py::houdayer_move_ref (houdayer_sweep on the coins
// of houdayer_coins); wrapper ops/cluster_kernels.py::houdayer_move.
//
// What it computes. For each pair p of (n,) spins s1, s2 (+/-1 floats,
// sites in the problem's generic order: a LatticeProblem's to_generic()
// numbers site (r, c) r * L + c, the grid form's raveled index), a bond
// (i, j) of the neighbour table is active when its coupling is nonzero
// and q_i = q_j = -1. Each component of the active bonds is labelled by
// its least site id, the unique fixed point of the JAX min-label
// relaxation (both JAX forms reach it: the generic from the index, the
// grid form from the index with q = +1 sites at n). Each q = -1 site i
// flips in both replicas when the coin of its label is heads:
// uniform01(counter(seed, step, SAMPLER_INDEX + HOUDAYER), p * n + label)
// < 0.5, so every member reads one coin. flipped[p] receives the count of
// flipped sites (the numerator of houdayer_flip_frac).
//
// What bounds it on an H100. A pass over the table (n * maxnb slots, two
// spin reads a slot), a union a bond, a find and a hash a site: a few
// hundred bytes a site for 48 pairs of 6400 spins, about 10 MB in all; the
// bound is those bytes over the memory rate (chip_smoke.py). The union-find
// makes the labelling one pass, where the relaxation takes a pass a hop
// of the percolating overlap domains' diameter (100-160 rounds measured
// in the JAX package's docstring).
//
// What the design does about that, simply (a first kernel): one CTA of
// 1024 threads a pair, its threads striding over the sites; the parents in
// shared memory (n int32, 25.6 KB at n = 6400) where they fit, else in
// device scratch; the union-find of fk.cuh (hook the larger root under the
// smaller with atomicCAS, so each component's root is its least id).
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"
#include "fk.cuh"

namespace {

// counter_rng.SAMPLER_INDEX and the Houdayer coin's stream
constexpr int kSamplerIndex = 24;
constexpr int kHoudayerCoin = 3;

__global__ void __launch_bounds__(1024)
houdayer_kernel(const int* __restrict__ nbr_idx,
                const float* __restrict__ nbr_J, float* s1, float* s2,
                int* __restrict__ flipped, int* parent_g, int n, int maxnb,
                uint32_t seed_term, int step, int use_smem) {
  extern __shared__ int dyn[];
  __shared__ int count;
  const int pair = blockIdx.x;
  int* parent =
      use_smem ? dyn : parent_g + static_cast<size_t>(pair) * n;
  float* a = s1 + static_cast<size_t>(pair) * n;
  float* b = s2 + static_cast<size_t>(pair) * n;
  if (threadIdx.x == 0) count = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) parent[i] = i;
  __syncthreads();

  // unite every active bond; a symmetric table unites each pair twice,
  // which the union-find ignores
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (a[i] * b[i] >= 0.0f) continue;  // q_i = +1
    const int* ri = nbr_idx + static_cast<size_t>(i) * maxnb;
    const float* ji = nbr_J + static_cast<size_t>(i) * maxnb;
    for (int m = 0; m < maxnb; ++m) {
      const int j = __ldg(ri + m);
      if (__ldg(ji + m) == 0.0f || a[j] * b[j] >= 0.0f) continue;
      mcs::unite(parent, i, j);
    }
  }
  __syncthreads();

  // every q = -1 component flips in both replicas on its least id's coin
  const uint32_t ctr =
      mcs::counter(seed_term, step, kSamplerIndex + kHoudayerCoin);
  const uint32_t uid0 = static_cast<uint32_t>(pair) * static_cast<uint32_t>(n);
  int mine = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float ai = a[i], bi = b[i];
    if (ai * bi >= 0.0f) continue;
    const int r = mcs::find_root(parent, i);
    if (mcs::uniform01(ctr, uid0 + static_cast<uint32_t>(r)) < 0.5f) {
      a[i] = -ai;
      b[i] = -bi;
      ++mine;
    }
  }
  if (mine) atomicAdd(&count, mine);
  __syncthreads();
  if (threadIdx.x == 0) flipped[pair] = count;
}

}  // namespace

// One Houdayer move of `pairs` replica pairs s1, s2 (pairs, n), in place:
// the table nbr_idx / nbr_J (n, maxnb) in the problem's generic order, the
// coins at counter(seed, step, SAMPLER_INDEX + HOUDAYER), flipped (pairs,)
// int32 out. With use_smem the parents live in shared memory (n * 4 bytes);
// else parents (pairs, n) int32 is device scratch. All device pointers;
// launches on `stream` and returns cudaGetLastError().
extern "C" int houdayer_move(const int* nbr_idx, const float* nbr_J,
                             float* s1, float* s2, int* flipped,
                             int* parents, int pairs, int n, int maxnb,
                             int seed, int step, int use_smem, int threads,
                             void* stream) {
  if (pairs == 0 || n == 0) return cudaSuccess;
  if (!use_smem && parents == nullptr) return cudaErrorInvalidValue;
  const size_t smem = use_smem ? static_cast<size_t>(n) * sizeof(int) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      houdayer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult;
  houdayer_kernel<<<pairs, threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      nbr_idx, nbr_J, s1, s2, flipped, parents, n, maxnb, seed_term, step,
      use_smem);
  return cudaGetLastError();
}

extern "C" const char* houdayer_move_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
