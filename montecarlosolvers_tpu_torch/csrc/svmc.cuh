// Rotor move of the SVMC kernels (split_svmc.cu, plane_svmc.cu).
//
// Device form of the proposal and energy change of
// montecarlosolvers_tpu/ops/pallas_split.py::_svmc_split_kernel
// (:285-294) and ops/pallas_svmc.py::_svmc_kernel (:97-107); the plain
// PyTorch form is montecarlosolvers_tpu_torch/ops/svmc_ops.py and the
// plain versions in ops/split_kernels.py and ops/plane_kernels.py.
//
// Trouble spot: unlike the spin kernels, every product here rounds, and
// nvcc would contract a*b + c into one FMA where torch's eager operations
// round twice. Every multiply and add is therefore written as __fmul_rn,
// __fadd_rn or __fsub_rn, in the plain version's order. cosf, sinf and
// log1pf are the CUDA math library's accurate functions (no fast math in
// the build), which torch's CUDA cos, sin and log1p call for float32.
#pragma once

namespace mcs {

// float32(pi), the value jnp.pi takes against float32 arrays, and
// 2 * float32(pi), which float32 holds exactly
constexpr float kPi = 3.14159274101257324f;
constexpr float kTwoPi = 6.28318548202514648f;

// min(A / B, 1), the TF window's half-width in units of pi; NaN stays NaN,
// as in jnp.minimum and torch.clamp
__device__ __forceinline__ float tf_width(float a, float b) {
  const float r = __fdiv_rn(a, b);
  return r > 1.0f ? 1.0f : r;
}

// The proposal from uniform u: pi * u, or with TF proposals
// clip(theta + width * ((2 pi) u - pi), 0, pi) (svmc.pyx:198-207); the clip
// keeps NaN, as torch.clamp and jnp.clip do
template <bool kTF>
__device__ __forceinline__ float propose(float theta, float u, float width) {
  if (!kTF) return __fmul_rn(kPi, u);
  const float p = __fadd_rn(
      theta, __fmul_rn(width, __fsub_rn(__fmul_rn(kTwoPi, u), kPi)));
  return p < 0.0f ? 0.0f : (p > kPi ? kPi : p);
}

// dE = B (cos' - cos) z + A (sin - sin'), associated as
// ((B * (cos' - cos)) * z) + (A * (sin - sin'))
__device__ __forceinline__ float delta_e(float b, float a, float cos_p,
                                         float cos_t, float z, float sin_t,
                                         float sin_p) {
  return __fadd_rn(__fmul_rn(__fmul_rn(b, __fsub_rn(cos_p, cos_t)), z),
                   __fmul_rn(a, __fsub_rn(sin_t, sin_p)));
}

}  // namespace mcs
