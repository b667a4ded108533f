// Stand-alone entry points of the per-step energy kernel (energy.cuh): one
// launch computes the (best-slice) energy of every chain of a state held
// in one of the per-phase routes' layouts. The collecting anneals launch
// the same kernels from their own host loops; these entry points let the
// wrappers of ops/energy.py hold the kernel against its plain version and
// time it alone.
#include <cuda_runtime.h>

#include "energy.cuh"

// Halves a, b (chains, P, nh) of an even-L lattice, nh = L*L/2; w (nslots,
// 2, nh), h (2, nh); cos_theta != 0 reads the halves as cos theta. Writes
// out (chains,) on `stream` and returns cudaGetLastError().
extern "C" int energy_halves(const float* w, const float* h, const float* a,
                             const float* b, int chains, int P, int L,
                             int nslots, int cos_theta, float* out,
                             void* stream) {
  if (chains == 0) return cudaSuccess;
  mcs::launch_halves_energy(w, h, a, b, chains, P, L, nslots, cos_theta != 0,
                            out, static_cast<cudaStream_t>(stream));
  return cudaGetLastError();
}

// Halves a, b of an even-L lattice as kernel A's chain bits,
// (ceil(chains/C), nh) int32 words each, C chains a word; w, h as for
// energy_halves. Writes out (chains,).
extern "C" int energy_chain_bits(const float* w, const float* h, const int* a,
                                 const int* b, int chains, int C, int L,
                                 int nslots, float* out, void* stream) {
  if (chains == 0) return cudaSuccess;
  if (C < 1 || C > 32) return cudaErrorInvalidValue;
  mcs::launch_chain_bits_energy(w, h, a, b, chains, C, L, nslots, out,
                                static_cast<cudaStream_t>(stream));
  return cudaGetLastError();
}

// PIQMC quarters xe, xo, ye, yo (chains, Q, nh) each; the rest as for
// energy_halves.
extern "C" int energy_quarters(const float* w, const float* h,
                               const float* xe, const float* xo,
                               const float* ye, const float* yo, int chains,
                               int Q, int L, int nslots, float* out,
                               void* stream) {
  if (chains == 0) return cudaSuccess;
  mcs::launch_quarters_energy(w, h, xe, xo, ye, yo, chains, Q, L, nslots,
                              out, static_cast<cudaStream_t>(stream));
  return cudaGetLastError();
}

// Planes s (chains, P, L, L); w (5, L, L) the planes jr, jl, jd, ju, h;
// cos_theta as for energy_halves.
extern "C" int energy_plane(const float* w, const float* s, int chains,
                            int P, int L, int cos_theta, float* out,
                            void* stream) {
  if (chains == 0) return cudaSuccess;
  mcs::launch_plane_energy(w, s, chains, P, L, cos_theta != 0, out,
                           static_cast<cudaStream_t>(stream));
  return cudaGetLastError();
}

extern "C" const char* energy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
