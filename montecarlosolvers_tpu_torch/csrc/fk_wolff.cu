// Wolff space-time clusters: one cluster a chain and step, the whole
// schedule in one launch.
//
// Replaces no TPU kernel: the JAX package runs this as XLA,
// montecarlosolvers_tpu/ops/cluster.py::wolff_update (:174), which draws
// every bond of the (P, N) space-time graph and grows the seed's component
// by a frontier BFS over the whole graph in a lax.while_loop
// (_seed_component :124). Plain PyTorch version:
// ops/cluster.py::wolff_anneal_ref (wolff_update on the counter hash).
//
// What it computes. A chain's P slices of N packed spins (+/-1 floats,
// packed.cuh). Step t (hash step step0 + t) at B_t, J_perp_t and T_eff_t:
// the seed (slice, packed position) from two uniforms, then the satisfied-
// bond FK cluster of rule "local" (pair bonds B J_ij, Trotter -J_perp, bath
// -T_eff lut[d-1], p = 1 - exp(dE / T_eff) where dE < 0) or the seed-sign-
// gated heuristic of rule "full" (each bond from the candidate's single-
// flip dE); rule "local" flips the cluster on a Metropolis accept of its
// field term, rule "full" always. A spatial pair is drawn from the row of
// its endpoint with the lower original id (rule "full": from either row),
// once a slot, so duplicate slots of one pair union; self-pointing pad
// slots never bond.
//
// The one float sum that decides, the field term sum h_i s_i over the
// cluster, is added as the plain version adds it: each slice's members in
// index order (one thread a slice), then the slices in order; with no
// fields it is 0 and is not summed.
//
// What bounds it on an H100. A step does work only on the cluster: each
// member draws its maxnb spatial, 2 Trotter and P - 1 bath bonds (a hash
// and an exp each where the bond is satisfied). chip_smoke.py's bound
// counts the exponentials of the bonds drawn from the members the kernel
// visited (`visited`) over the special-function rate. The BFS is serial in
// its rounds: one __syncthreads a round, one round a hop of the cluster's
// eccentricity.
//
// What the design does about that, simply (a first kernel): one CTA of 512
// threads a chain, the state in device memory, the visited set as a bit
// array and the frontier as a queue in device memory (a bond is drawn only
// when the BFS reaches it, so a step costs the cluster, not the graph);
// any N, P and maxnb with one design. No fast math.
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"
#include "fk.cuh"
#include "packed.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// true when bit x of `bits` was clear and this call set it
__device__ __forceinline__ bool claim(unsigned* bits, int x) {
  const unsigned m = 1u << (x & 31);
  return (atomicOr(bits + (x >> 5), m) & m) == 0u;
}

__device__ __forceinline__ bool visited_bit(const unsigned* bits, int x) {
  const volatile unsigned* v = bits;
  return (v[x >> 5] >> (x & 31)) & 1u;
}

struct Step {
  const int* nbr_idx;
  const float* nbr_J;
  const float* h;
  const int* perm;
  const float* sc;  // the chain's (P, n) spins
  int P, n, maxnb, chain;
  float b, jp, teff, kval;
  uint32_t c_sp, c_t, c_b;
};

// rule "full": the single-flip dE of candidate (k, j) with the seed sign
// kval: (-2 B kval) f + (2 J_perp kval)(s[k-1] + s[k+1])
__device__ __forceinline__ float site_de(const Step& st, int k, int j) {
  const float* row = st.sc + static_cast<size_t>(k) * st.n;
  const float f = mcs::packed_field(row, st.nbr_idx, st.nbr_J, st.h, j,
                                    st.maxnb);
  const float up = st.sc[static_cast<size_t>((k + st.P - 1) % st.P) * st.n
                         + j];
  const float dn = st.sc[static_cast<size_t>((k + 1) % st.P) * st.n + j];
  return __fadd_rn(
      __fmul_rn(__fmul_rn(__fmul_rn(-2.0f, st.b), st.kval), f),
      __fmul_rn(__fmul_rn(__fmul_rn(2.0f, st.jp), st.kval),
                __fadd_rn(up, dn)));
}

// uniform of spatial slot m of packed row r (original id id_r) at slice k
__device__ __forceinline__ float sp_uniform(const Step& st, int k, int id_r,
                                            int m) {
  const uint32_t uid =
      ((static_cast<uint32_t>(st.chain) * st.P + k) * st.n + id_r) *
          static_cast<uint32_t>(st.maxnb) + m;
  return mcs::uniform01(st.c_sp, uid);
}

// Is the spatial pair (i, j) of slice k bonded? Rule "local": any slot of
// the lower-id endpoint's row pointing at the other drew it. Rule "full":
// any slot of either row pointing at the other drew it, with the
// probability of the pointed-at candidate's dE.
template <bool kRuleFull>
__device__ bool spatial_bond(const Step& st, int k, int i, int j) {
  const int idi = __ldg(st.perm + i), idj = __ldg(st.perm + j);
  const size_t base = static_cast<size_t>(k) * st.n;
  if (!kRuleFull) {
    const int lo = idi < idj ? i : j, hi = idi < idj ? j : i;
    const int idl = idi < idj ? idi : idj;
    const float sl = st.sc[base + lo], su = st.sc[base + hi];
    const int* rl = st.nbr_idx + static_cast<size_t>(lo) * st.maxnb;
    const float* jl = st.nbr_J + static_cast<size_t>(lo) * st.maxnb;
    for (int m = 0; m < st.maxnb; ++m) {
      if (__ldg(rl + m) != hi) continue;
      const float de = __fmul_rn(
          __fmul_rn(__fmul_rn(__fmul_rn(2.0f, st.b), __ldg(jl + m)), sl), su);
      if (sp_uniform(st, k, idl, m) < mcs::bond_prob(de, st.teff)) {
        return true;
      }
    }
    return false;
  }
  if (st.sc[base + j] != st.kval) return false;
  const float pj = mcs::bond_prob(site_de(st, k, j), st.teff);
  const int* ri = st.nbr_idx + static_cast<size_t>(i) * st.maxnb;
  for (int m = 0; m < st.maxnb; ++m) {
    if (__ldg(ri + m) == j && sp_uniform(st, k, idi, m) < pj) return true;
  }
  const float pi = mcs::bond_prob(site_de(st, k, i), st.teff);
  const int* rj = st.nbr_idx + static_cast<size_t>(j) * st.maxnb;
  for (int m = 0; m < st.maxnb; ++m) {
    if (__ldg(rj + m) == i && sp_uniform(st, k, idj, m) < pi) return true;
  }
  return false;
}

// Is the Trotter bond (kb, kb + 1 mod P) of packed spin i bonded?
template <bool kRuleFull>
__device__ bool trotter_bond(const Step& st, int kb, int i) {
  const int k1 = (kb + 1) % st.P;
  const float s0 = st.sc[static_cast<size_t>(kb) * st.n + i];
  const float s1 = st.sc[static_cast<size_t>(k1) * st.n + i];
  float de;
  if (kRuleFull) {
    if (s0 != st.kval || s1 != st.kval) return false;
    de = site_de(st, k1, i);
  } else {
    de = __fmul_rn(__fmul_rn(__fmul_rn(-2.0f, st.jp), s0), s1);
  }
  const uint32_t uid =
      (static_cast<uint32_t>(st.chain) * st.P + kb) * st.n +
      __ldg(st.perm + i);
  return mcs::uniform01(st.c_t, uid) < mcs::bond_prob(de, st.teff);
}

template <bool kRuleFull, bool kBath>
__global__ void __launch_bounds__(512)
fk_wolff_kernel(const int* __restrict__ nbr_idx,
                const float* __restrict__ nbr_J, const float* __restrict__ h,
                const int* __restrict__ perm,
                const float* __restrict__ b_sched,
                const float* __restrict__ jp_sched,
                const float* __restrict__ teff_sched,
                const float* __restrict__ lut, float* s, unsigned* bits_all,
                int* queue_all, long long* visited, int P, int n, int maxnb,
                int steps, uint32_t seed_term) {
  // p_same[P], p_diff[P] (the bath by ring offset), rows[P] (field sums)
  extern __shared__ float dyn[];
  float* p_same = dyn;
  float* p_diff = dyn + P;
  float* rows = dyn + 2 * P;
  __shared__ int q_len[2];
  __shared__ float kval_s;
  __shared__ int accept_s;
  __shared__ unsigned long long count_s;

  const int chain = blockIdx.x;
  const int PN = P * n;
  const int words = (PN + 31) / 32;
  float* sc = s + static_cast<size_t>(chain) * PN;
  unsigned* bits = bits_all + static_cast<size_t>(chain) * words;
  int* queue = queue_all + static_cast<size_t>(chain) * 2 * PN;

  Step st{nbr_idx, nbr_J, h, perm, sc, P, n, maxnb, chain,
          0.0f, 0.0f, 0.0f, 0.0f, 0u, 0u, 0u};
  // with no field the field term is 0 whatever the cluster: not summed
  bool nonzero = false;
  for (int i = threadIdx.x; i < n; i += blockDim.x) nonzero |= h[i] != 0.0f;
  const bool has_field = __syncthreads_or(nonzero);
  for (int t = 0; t < steps; ++t) {
    st.b = __ldg(b_sched + t);
    st.jp = __ldg(jp_sched + t);
    st.teff = __ldg(teff_sched + t);
    st.c_sp = mcs::cluster_counter(seed_term, t, mcs::kSpBond);
    st.c_t = mcs::cluster_counter(seed_term, t, mcs::kTrotterBond);
    st.c_b = mcs::cluster_counter(seed_term, t, mcs::kBathBond);
    for (int w = threadIdx.x; w < words; w += blockDim.x) bits[w] = 0u;
    if (kBath) {
      for (int d = 1 + threadIdx.x; d < P; d += blockDim.x) {
        mcs::bath_probs(lut, d, st.teff, p_same + d, p_diff + d);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint32_t c_seed =
          mcs::cluster_counter(seed_term, t, mcs::kWolffSeed);
      const int spin = mcs::index_draw(
          mcs::uniform01(c_seed, 2u * static_cast<uint32_t>(chain)), n);
      const int slice = mcs::index_draw(
          mcs::uniform01(c_seed, 2u * static_cast<uint32_t>(chain) + 1u),
          P);
      const int x0 = slice * n + spin;
      bits[x0 >> 5] = 1u << (x0 & 31);
      queue[0] = x0;
      q_len[0] = 1;
      q_len[1] = 0;
      kval_s = sc[x0];
      count_s = 0ull;
    }
    __syncthreads();
    st.kval = kval_s;

    // BFS: queue `cur` is this round's frontier, the other the next one
    int cur = 0;
    for (;;) {
      const int len = q_len[cur];
      if (len == 0) break;
      const int* qin = queue + cur * PN;
      int* qout = queue + (cur ^ 1) * PN;
      for (int e = threadIdx.x; e < len; e += blockDim.x) {
        const int x = qin[e];
        const int k = x / n, i = x - k * n;
        const int* ri = nbr_idx + static_cast<size_t>(i) * maxnb;
        for (int m = 0; m < maxnb; ++m) {
          const int j = __ldg(ri + m);
          if (j == i) continue;
          bool dup = false;
          for (int m0 = 0; m0 < m; ++m0) dup |= __ldg(ri + m0) == j;
          const int y = k * n + j;
          if (dup || visited_bit(bits, y)) continue;
          if (spatial_bond<kRuleFull>(st, k, i, j) && claim(bits, y)) {
            qout[atomicAdd(&q_len[cur ^ 1], 1)] = y;
          }
        }
        if (P > 1) {
          const int kp = (k + 1) % P, km = (k + P - 1) % P;
          int y = kp * n + i;
          if (!visited_bit(bits, y) && trotter_bond<kRuleFull>(st, k, i) &&
              claim(bits, y)) {
            qout[atomicAdd(&q_len[cur ^ 1], 1)] = y;
          }
          y = km * n + i;
          if (!visited_bit(bits, y) && trotter_bond<kRuleFull>(st, km, i) &&
              claim(bits, y)) {
            qout[atomicAdd(&q_len[cur ^ 1], 1)] = y;
          }
        }
        if (kBath) {
          const float sk = sc[x];
          const uint32_t line =
              static_cast<uint32_t>(chain) * n + __ldg(perm + i);
          for (int q = 0; q < P; ++q) {
            const int y = q * n + i;
            if (q == k || visited_bit(bits, y)) continue;
            const float sq = sc[y];
            if (kRuleFull && sq != st.kval) continue;
            // target q pulls from source k: offset (k - q) mod P
            const int d = (k - q + P) % P;
            const float p = sq == sk ? p_same[d] : p_diff[d];
            const int lo = q < k ? q : k, hi = q < k ? k : q;
            const float u = mcs::uniform01(
                st.c_b, (line * P + lo) * static_cast<uint32_t>(P) + hi);
            if (u < p && claim(bits, y)) {
              qout[atomicAdd(&q_len[cur ^ 1], 1)] = y;
            }
          }
        }
      }
      __syncthreads();
      if (threadIdx.x == 0) q_len[cur] = 0;
      cur ^= 1;
      __syncthreads();
    }

    // the field accept (rule "local"), its sum in the plain version's order
    if (!kRuleFull) {
      if (has_field) {
        for (int k = threadIdx.x; k < P; k += blockDim.x) {
          const float* row = sc + static_cast<size_t>(k) * n;
          float acc = 0.0f;
          for (int i = 0; i < n; ++i) {
            const float term = visited_bit(bits, k * n + i)
                                   ? __fmul_rn(__ldg(h + i), row[i])
                                   : 0.0f;
            acc = i == 0 ? term : __fadd_rn(acc, term);
          }
          rows[k] = acc;
        }
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        float tot = 0.0f;
        if (has_field) {
          tot = rows[0];
          for (int k = 1; k < P; ++k) tot = __fadd_rn(tot, rows[k]);
        }
        const float de = __fmul_rn(__fmul_rn(-2.0f, st.b), tot);
        const float u = mcs::uniform01(
            mcs::cluster_counter(seed_term, t, mcs::kAccept),
            static_cast<uint32_t>(chain));
        accept_s = mcs::metropolis_accept(de, st.teff, u) ? 1 : 0;
      }
      __syncthreads();
    }
    const bool flip = kRuleFull || accept_s;
    unsigned count = 0u;
    for (int w = threadIdx.x; w < words; w += blockDim.x) {
      unsigned m = bits[w];
      count += __popc(m);
      while (flip && m) {
        const int x = w * 32 + __ffs(m) - 1;
        sc[x] = -sc[x];
        m &= m - 1u;
      }
    }
    if (visited != nullptr) {
      for (int off = 16; off > 0; off >>= 1) {
        count += __shfl_down_sync(kFull, count, off);
      }
      if ((threadIdx.x & 31) == 0) {
        atomicAdd(&count_s, static_cast<unsigned long long>(count));
      }
    }
    __syncthreads();
    if (visited != nullptr && threadIdx.x == 0) {
      visited[chain] += static_cast<long long>(count_s);
    }
  }
}

template <bool kRuleFull, bool kBath>
void launch(int chains, int threads, size_t smem, cudaStream_t stream,
            const int* nbr_idx, const float* nbr_J, const float* h,
            const int* perm, const float* b_sched, const float* jp,
            const float* teff, const float* lut, float* s, unsigned* bits,
            int* queue, long long* visited, int P, int n, int maxnb,
            int steps, uint32_t seed_term) {
  fk_wolff_kernel<kRuleFull, kBath><<<chains, threads, smem, stream>>>(
      nbr_idx, nbr_J, h, perm, b_sched, jp, teff, lut, s, bits, queue,
      visited, P, n, maxnb, steps, seed_term);
}

}  // namespace

// One Wolff cluster a chain and step for `steps` steps, in one launch:
// chains x (P, n) packed spins `s` in place, the schedules B, J_perp and
// T_eff (steps,), the bath table lut (P - 1,) or null, rule_full != 0 for
// rule "full". bits (chains,
// ceil(P n / 32)) and queue (chains, 2, P n) are scratch; visited (chains,)
// int64, or null, gains each chain's cluster sizes. step0: the hash step of
// the first step. All device pointers; launches on `stream` and returns
// cudaGetLastError().
extern "C" int fk_wolff_anneal(const int* nbr_idx, const float* nbr_J,
                               const float* h, const int* perm,
                               const float* b_sched, const float* jp,
                               const float* teff, const float* lut, float* s,
                               unsigned* bits, int* queue,
                               long long* visited, int chains, int P, int n,
                               int maxnb, int steps, int seed, int step0,
                               int rule_full, int threads, void* stream) {
  if (chains == 0 || n == 0 || P == 0 || steps == 0) return cudaSuccess;
  const uint32_t seed_term = static_cast<uint32_t>(seed) * mcs::kSeedMult +
                             static_cast<uint32_t>(step0) * mcs::kStepMult;
  const size_t smem = 3 * static_cast<size_t>(P) * sizeof(float);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = rule_full ? (lut ? launch<true, true> : launch<true, false>)
                      : (lut ? launch<false, true> : launch<false, false>);
  go(chains, threads, smem, st, nbr_idx, nbr_J, h, perm, b_sched, jp, teff,
     lut, s, bits, queue, visited, P, n, maxnb, steps, seed_term);
  return cudaGetLastError();
}

extern "C" const char* fk_wolff_anneal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
