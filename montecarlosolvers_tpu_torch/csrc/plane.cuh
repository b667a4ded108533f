// Neighbour sum of the full-plane kernels (plane_sa.cu, plane_qmc.cu,
// plane_svmc.cu) and the walk over a band's sites of kernels 3 and 7.
//
// Device form of montecarlosolvers_tpu/ops/pallas_sa.py::_neighbor_sums
// (:136), pallas_qmc.py::_nbsum4 (:54) and pallas_svmc.py::_zfield (:40)
// on the physical L x L plane; the
// plain PyTorch form is montecarlosolvers_tpu_torch/ops/plane.py::
// neighbor_sum. On L x L the wrap neighbours are the plain modular ones,
// and an open boundary has zero wrap couplings, so the TPU's masked
// correction rolls for its padded planes are not needed.
#pragma once

namespace mcs {

// sum_nb J s_nb + h at site (r, c) of the plane `s` (L * L floats,
// row-major); w holds the planes jr, jl, jd, ju, h, L * L floats each. The
// terms are added in the Pallas order jr*right + jl*left + jd*down + ju*up
// + h. For spins each product J*(+/-1) is exact, so the order alone fixes
// the float32 result; for the SVMC kernel's cos plane the products round,
// and __fmul_rn/__fadd_rn keep nvcc from contracting them into FMAs that
// torch's eager operations do not use.
__device__ __forceinline__ float plane_field(const float* s,
                                             const float* __restrict__ w,
                                             int L, int r, int c) {
  const int n = L * L;
  const int i = r * L + c;
  const int right = c + 1 == L ? 0 : c + 1;
  const int left = c == 0 ? L - 1 : c - 1;
  const int down = r + 1 == L ? 0 : r + 1;
  const int up = r == 0 ? L - 1 : r - 1;
  float f = __fmul_rn(__ldg(w + i), s[r * L + right]);
  f = __fadd_rn(f, __fmul_rn(__ldg(w + n + i), s[r * L + left]));
  f = __fadd_rn(f, __fmul_rn(__ldg(w + 2 * n + i), s[down * L + c]));
  f = __fadd_rn(f, __fmul_rn(__ldg(w + 3 * n + i), s[up * L + c]));
  return __fadd_rn(f, __ldg(w + 4 * n + i));
}

// A thread's sites of a band of `rows` rows of L sites, in slots ordered by
// parity: slot j < nslot is a site of parity 0, slot j >= nslot one of
// parity 1 (its slot j - nslot), nslot = rows * half; slot s of a parity is
// band row s / half, column 2 * (s % half) + ((row + parity) & 1), past the
// last column on the short rows of an odd L. A thread takes j = threadIdx.x
// + i * blockDim.x, stepped as (q, rl, jj) with blockDim.x = dq * half +
// dr, so its loop has no division. Kernel 3 walks both parities, so a
// warp's sites share theirs; kernel 7 walks j < nslot and reads the column
// parity from its phase's color.
struct SlotWalk {
  int j, q, rl, jj;  // slot, parity, band row, column pair
  int half, nslot, rows, dq, dr;
  __device__ SlotWalk(int L, int rows_)
      : half((L + 1) / 2), nslot(rows_ * ((L + 1) / 2)), rows(rows_) {
    j = threadIdx.x;
    q = j >= nslot;
    const int s = j - q * nslot;
    rl = s / half;
    jj = s - rl * half;
    dq = blockDim.x / half;
    dr = blockDim.x - dq * half;
  }
  __device__ __forceinline__ void next() {
    j += blockDim.x;
    rl += dq;
    jj += dr;
    if (jj >= half) {
      jj -= half;
      ++rl;
    }
    if (rl >= rows) {  // on into parity 1; past it, j >= 2 * nslot
      rl -= rows;
      ++q;
    }
  }
};

}  // namespace mcs
