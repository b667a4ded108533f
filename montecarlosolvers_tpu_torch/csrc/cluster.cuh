// One chain's planes (or a group of chains packed as bits) spread over a
// thread-block cluster.
//
// Shared by kernel A (csrc/split_sa.cu), kernel B (csrc/split_qmc.cu),
// kernel 4 (csrc/split_svmc.cu), kernel 5 (csrc/split_qmc_bath.cu), kernel
// 6 (csrc/plane_sa.cu), kernel 3 (csrc/plane_qmc.cu) and kernel 7
// (csrc/plane_svmc.cu). A plane
// is L rows of `width` sites: a split half has rows of K = L/2 sites (Nh =
// L*K, site j in row j / K), a full plane rows of L sites. The R CTAs of a
// cluster cut the rows into R bands, band r holding rows [floor(r*L/R),
// floor((r+1)*L/R)), and each CTA keeps its band of every plane in its own
// shared memory at a common stride S = ceil(L/R)*width words, so a plane
// sits at the same offset in every CTA. A stencil read reaches at most one
// row away (split: slots 0, +-1, +-K, +-(K-1); plane: +-1, +-L), so it
// lands in the own band or in the first or last row of a neighbouring band,
// which the read takes through the cluster's distributed shared memory
// (cluster.map_shared_rank). With R = 1 both neighbours are the CTA itself,
// and the same reads give the torus wrap j +- d mod (L*width).
// ops/split_kernels.py::band_sites counts S the same way for split halves,
// ops/plane_kernels.py::sa_plane_smem_bytes for full planes.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mcs {

namespace cg = cooperative_groups;

// First row of band r of L rows cut into R bands
__host__ __device__ __forceinline__ int band_row(int r, int L, int R) {
  return static_cast<int>(static_cast<long long>(r) * L / R);
}

// The common stride of a band's planes: ceil(L/R) rows of `width` sites
__host__ __device__ __forceinline__ int band_stride(int L, int R,
                                                    int width) {
  return (L + R - 1) / R * width;
}

struct Band {
  const uint32_t* own;   // this CTA's shared memory
  const uint32_t* prev;  // CTA rank - 1 (mod R), through the cluster window
  const uint32_t* next;  // CTA rank + 1 (mod R)
  int lo;                // global site index of the band's first site
  int nb;                // sites in this band
  int nb_prev;           // sites in the previous band

  // The word of band-local site il, -width <= il < nb + width, of the
  // plane at word offset `off`; outside [0, nb) it is the neighbouring
  // band's.
  __device__ __forceinline__ uint32_t read(int off, int il) const {
    if (il < 0) return prev[off + nb_prev + il];
    if (il >= nb) return next[off + il - nb];
    return own[off + il];
  }
};

__device__ __forceinline__ Band make_band(const cg::cluster_group& cluster,
                                          uint32_t* smem, int rank, int R,
                                          int L, int width) {
  const int pr = rank == 0 ? R - 1 : rank - 1;
  const int nx = rank + 1 == R ? 0 : rank + 1;
  Band b;
  b.own = smem;
  b.prev = cluster.map_shared_rank(smem, pr);
  b.next = cluster.map_shared_rank(smem, nx);
  const int row = band_row(rank, L, R);
  b.lo = row * width;
  b.nb = (band_row(rank + 1, L, R) - row) * width;
  b.nb_prev = (band_row(pr + 1, L, R) - band_row(pr, L, R)) * width;
  return b;
}

// w * s for the spin s = +1 (bit `bit` of `word` clear) or -1 (set): w
// with its sign bit flipped, which is exactly __fmul_rn(w, s).
__device__ __forceinline__ float signed_by(float w, uint32_t word, int bit) {
  return __uint_as_float(__float_as_uint(w) ^
                         ((word << (31 - bit)) & 0x80000000u));
}

// The stencil weights of color `color` at global site j (w laid out
// (nslots, 2, nh)); the two row-wrap slots are 0 on a 5-slot lattice.
__device__ __forceinline__ void load_weights(const float* __restrict__ w,
                                             int color, int nh, int nslots,
                                             int j, float (&wv)[7]) {
  const float* wc = w + color * nh + j;
#pragma unroll
  for (int s = 0; s < 7; ++s)
    wv[s] = s < nslots ? __ldg(wc + s * 2 * nh) : 0.0f;
}

// The neighbour words of band-local site il in the plane at `off`, in the
// slot order of counter_hash.cuh::stencil: j, j+1, j-1, j+K, j-K, j-(K-1),
// j+(K-1).
__device__ __forceinline__ void load_neighbours(const Band& band, int off,
                                                int il, int K, int nslots,
                                                uint32_t (&o)[7]) {
  o[0] = band.read(off, il);
  o[1] = band.read(off, il + 1);
  o[2] = band.read(off, il - 1);
  o[3] = band.read(off, il + K);
  o[4] = band.read(off, il - K);
  o[5] = nslots > 5 ? band.read(off, il - (K - 1)) : 0u;
  o[6] = nslots > 5 ? band.read(off, il + (K - 1)) : 0u;
}

// The stencil over the spins at bit `bit` of the neighbour words, summed
// in slot order as counter_hash.cuh::stencil sums it: each w*s is exact,
// so the order alone fixes the float32 result.
__device__ __forceinline__ float field_of_bit(const float (&wv)[7],
                                              const uint32_t (&o)[7],
                                              int nslots, int bit) {
  float f = signed_by(wv[0], o[0], bit);
  f = __fadd_rn(f, signed_by(wv[1], o[1], bit));
  f = __fadd_rn(f, signed_by(wv[2], o[2], bit));
  f = __fadd_rn(f, signed_by(wv[3], o[3], bit));
  f = __fadd_rn(f, signed_by(wv[4], o[4], bit));
  if (nslots > 5) {
    f = __fadd_rn(f, signed_by(wv[5], o[5], bit));
    f = __fadd_rn(f, signed_by(wv[6], o[6], bit));
  }
  return f;
}

// Set a kernel's shared memory and cluster-size attributes and fill in a
// launch configuration of `grid` CTAs in clusters of R along x.
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, int grid, int R, int threads,
                           size_t smem, cudaStream_t stream,
                           cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  if (R > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(grid);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = R;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// How many clusters of R CTAs of `threads` threads and `smem` bytes of
// `kernel` the card holds at once (cudaOccupancyMaxActiveClusters)
template <typename Kernel>
cudaError_t max_active_clusters(Kernel kernel, int R, int threads,
                                size_t smem, int* count) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e =
      cluster_config(kernel, R, R, threads, smem, nullptr, &cfg, &attr);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
}

}  // namespace mcs
