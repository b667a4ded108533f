// Neighbour sum of the full-plane kernels (plane_sa.cu, plane_qmc.cu,
// plane_svmc.cu).
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

}  // namespace mcs
