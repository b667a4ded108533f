// The labeling core of fk_label.cu and fk_wolff.cu: one chain's P * n
// union-find nodes spread over the R CTAs of a thread-block cluster.
//
// Ownership. CTA r owns the sites id in [r nc, (r + 1) nc), nc = ceil(n /
// R), in every slice: so a site's Trotter and bath bonds join nodes of one
// CTA, and of the spatial bonds only those across a site boundary (few, on
// a graph whose neighbours have near ids, as a lattice's) join two CTAs.
// Node (k, id) of CTA r is its slot k nc + (id - r nc), and the union-find
// names it by y = r S + slot (S = P nc slots a CTA), so that a node's owner
// is y / S. Its key, the node's place in the plain version's order, is
// k n + id: the union-find hooks the root of the larger key under the
// smaller, so each component's root is its least node, fk_label's label.
//
// Regions. Every CTA's region has the same layout: S int32 parents, with
// `ints` = 2 a second int32 array beside them (fk_label's labels with an
// asymmetric bath table), then two byte flags a slot. Region r is CTA r's
// shared memory, reached by the other CTAs at its shared::cluster address
// (mapa) with relaxed cluster-scope loads, stores and atomics, while it
// fits beside the head and the tables (ops/cluster_kernels.py::
// label_geometry); past that every region is a slice of a device-memory
// buffer of the same layout, reached with relaxed gpu-scope ones (kOnChip
// false): generic `volatile` accesses compile to strong system-scope
// loads (LD.E.STRONG.SYS), which the finds cannot afford (PERF.md §6).
//
// A step unites in passes, each ended by cluster.sync(). A site's Trotter
// bonds are drawn by one thread, walking its P slices, which sets each
// node's parent to the least slice of its run of bonded slices (no find:
// a quarter to a third of a space-time chain's bonds). Then every other
// bond whose two nodes a CTA owns (its own shared memory, its local roots
// its own), then the bonds across CTAs (from the sites with a neighbour
// in another CTA's chunk, `boundary` in the kernels' arguments), which
// hook local roots under remote ones. Then each CTA resolves each of its
// "local tops" (a node whose parent is another CTA's, or a root) to its
// global root once
// (`find_global`, reading without writing, while other CTAs read too) and
// points the top at it; every other node reaches its top through its own
// CTA's parents (`local_top`). A component's root is its least node
// whatever the order of the unions, so the result is the plain version's.
//
// The head of every CTA's dynamic shared memory (the kernels have no static
// shared memory): the R region addresses, and in CTA 0 the cluster's "any
// moved" word, which a CTA's thread sets to the round's number when the
// CTA moved something; rounds are numbered across the whole launch, so the
// word never needs resetting (`Core::any`).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mcs {

namespace cgn = cooperative_groups;

// the most CTAs a cluster takes (16 needs the non-portable attribute)
constexpr int kMaxRanks = 16;
// bytes of the head (ops/cluster_kernels.py::LABEL_HEAD_BYTES)
constexpr int kNodesHeadBytes = 256;

struct NodesHead {
  char* global[kMaxRanks];     // the regions in device memory, or
  uint32_t shared[kMaxRanks];  // their shared::cluster addresses
  int any;   // CTA 0's: the last round in which some CTA moved
  int root;  // fk_wolff: the seed's root this step
  int accept;  // fk_wolff: the field accept this step
  unsigned long long count;  // fk_wolff: this CTA's members this step
};
static_assert(sizeof(NodesHead) <= kNodesHeadBytes, "head too large");

// Bytes of one region: `slots` nodes of `ints` int32 and two flag bytes, in
// whole int32 words
__host__ __device__ __forceinline__ size_t region_bytes(int slots, int ints) {
  return (static_cast<size_t>(slots) * (4 * ints + 2) + 3) / 4 * 4;
}

// x / d for 0 <= x < 2^31 and a divisor d >= 1 fixed for a launch, by a
// multiply-high and shifts (Granlund and Montgomery, 1994, figure 4.1)
struct FastDiv {
  uint32_t m;
  int s1, s2;
  __device__ __forceinline__ void init(uint32_t d) {
    int l = 0;
    while ((1ull << l) < d) ++l;
    m = static_cast<uint32_t>(((1ull << 32) * ((1ull << l) - d)) / d + 1);
    s1 = l > 0 ? 1 : 0;
    s2 = l > 0 ? l - 1 : 0;
  }
  __device__ __forceinline__ int div(int x) const {
    const uint32_t u = static_cast<uint32_t>(x);
    const uint32_t t = __umulhi(u, m);
    return static_cast<int>((t + ((u - t) >> s1)) >> s2);
  }
};

// Relaxed accesses: cluster scope on a shared::cluster address, gpu scope
// on a device-memory one
template <bool kOnChip>
struct Mem;

template <>
struct Mem<true> {
  using Addr = uint32_t;
  __device__ __forceinline__ static int ld(Addr a) {
    int v;
    asm volatile("ld.relaxed.cluster.shared::cluster.s32 %0, [%1];"
                 : "=r"(v) : "r"(a) : "memory");
    return v;
  }
  __device__ __forceinline__ static void st(Addr a, int v) {
    asm volatile("st.relaxed.cluster.shared::cluster.s32 [%0], %1;"
                 :: "r"(a), "r"(v) : "memory");
  }
  __device__ __forceinline__ static int cas(Addr a, int cmp, int v) {
    int old;
    asm volatile(
        "atom.relaxed.cluster.shared::cluster.cas.b32 %0, [%1], %2, %3;"
        : "=r"(old) : "r"(a), "r"(cmp), "r"(v) : "memory");
    return old;
  }
  __device__ __forceinline__ static void min(Addr a, int v) {
    asm volatile("red.relaxed.cluster.shared::cluster.min.s32 [%0], %1;"
                 :: "r"(a), "r"(v) : "memory");
  }
  __device__ __forceinline__ static int ld8(Addr a) {
    uint32_t v;
    asm volatile("ld.relaxed.cluster.shared::cluster.u8 %0, [%1];"
                 : "=r"(v) : "r"(a) : "memory");
    return static_cast<int>(v);
  }
  __device__ __forceinline__ static void st8(Addr a, int v) {
    asm volatile("st.relaxed.cluster.shared::cluster.u8 [%0], %1;"
                 :: "r"(a), "r"(static_cast<uint32_t>(v)) : "memory");
  }
};

template <>
struct Mem<false> {
  using Addr = uint64_t;
  __device__ __forceinline__ static int ld(Addr a) {
    int v;
    asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];"
                 : "=r"(v) : "l"(a) : "memory");
    return v;
  }
  __device__ __forceinline__ static void st(Addr a, int v) {
    asm volatile("st.relaxed.gpu.global.s32 [%0], %1;"
                 :: "l"(a), "r"(v) : "memory");
  }
  __device__ __forceinline__ static int cas(Addr a, int cmp, int v) {
    int old;
    asm volatile("atom.relaxed.gpu.global.cas.b32 %0, [%1], %2, %3;"
                 : "=r"(old) : "l"(a), "r"(cmp), "r"(v) : "memory");
    return old;
  }
  __device__ __forceinline__ static void min(Addr a, int v) {
    asm volatile("red.relaxed.gpu.global.min.s32 [%0], %1;"
                 :: "l"(a), "r"(v) : "memory");
  }
  __device__ __forceinline__ static int ld8(Addr a) {
    uint32_t v;
    asm volatile("ld.relaxed.gpu.global.u8 %0, [%1];"
                 : "=r"(v) : "l"(a) : "memory");
    return static_cast<int>(v);
  }
  __device__ __forceinline__ static void st8(Addr a, int v) {
    asm volatile("st.relaxed.gpu.global.u8 [%0], %1;"
                 :: "l"(a), "r"(static_cast<uint32_t>(v)) : "memory");
  }
};

// Relaxed cluster-scope accesses to this CTA's own region at its
// shared::cta address (the CTA's own shared memory path; the other CTAs
// reach the same words at cluster scope)
struct MemCta {
  __device__ __forceinline__ static int ld(uint32_t a) {
    int v;
    asm volatile("ld.relaxed.cluster.shared::cta.s32 %0, [%1];"
                 : "=r"(v) : "r"(a) : "memory");
    return v;
  }
  __device__ __forceinline__ static void st(uint32_t a, int v) {
    asm volatile("st.relaxed.cluster.shared::cta.s32 [%0], %1;"
                 :: "r"(a), "r"(v) : "memory");
  }
  __device__ __forceinline__ static int cas(uint32_t a, int cmp, int v) {
    int old;
    asm volatile("atom.relaxed.cluster.shared::cta.cas.b32 %0, [%1], %2, %3;"
                 : "=r"(old) : "r"(a), "r"(cmp), "r"(v) : "memory");
    return old;
  }
};

template <bool kOnChip>
struct Core {
  using M = Mem<kOnChip>;
  using Addr = typename M::Addr;
  NodesHead* head;  // this CTA's
  volatile int* any0;  // CTA 0's `any`
  int n, nc, slots, ints, rank, y0;  // y0 = rank * slots
  uint32_t cta0;  // the own region's shared::cta address (on chip)
  FastDiv by_nc, by_slots;

  __device__ __forceinline__ Addr base(int r) const {
    if constexpr (kOnChip) {
      return head->shared[r];
    } else {
      return reinterpret_cast<Addr>(head->global[r]);
    }
  }
  // the byte address of word `word` (parents 0, the second array 1) or of
  // flag byte `word` - 2 of node y
  __device__ __forceinline__ Addr at(int y, int word) const {
    const int r = by_slots.div(y);
    const int s = y - r * slots;
    if (word < 2) return base(r) + 4 * (word * slots + s);
    return base(r) + 4 * ints * slots + (word - 2) * slots + s;
  }
  __device__ __forceinline__ bool mine(int y) const {
    return static_cast<unsigned>(y - y0) < static_cast<unsigned>(slots);
  }
  // node y of own slot w is y0 + w; node (k, id) of any CTA
  __device__ __forceinline__ int node(int k, int id) const {
    const int r = by_nc.div(id);
    return r * slots + k * nc + id - r * nc;
  }
  // the key k n + id of node y
  __device__ __forceinline__ int key(int y) const {
    const int r = by_slots.div(y);
    const int s = y - r * slots;
    const int k = by_nc.div(s);
    return k * n + r * nc + s - k * nc;
  }

  // parents, an own node's through shared::cta on chip
  __device__ __forceinline__ int parent(int y) const {
    if constexpr (kOnChip) {
      if (mine(y)) return MemCta::ld(cta0 + 4 * (y - y0));
    }
    return M::ld(at(y, 0));
  }
  __device__ __forceinline__ void set_parent(int y, int p) const {
    if constexpr (kOnChip) {
      if (mine(y)) {
        MemCta::st(cta0 + 4 * (y - y0), p);
        return;
      }
    }
    M::st(at(y, 0), p);
  }
  __device__ __forceinline__ int cas_parent(int y, int cmp, int v) const {
    if constexpr (kOnChip) {
      if (mine(y)) return MemCta::cas(cta0 + 4 * (y - y0), cmp, v);
    }
    return M::cas(at(y, 0), cmp, v);
  }
  __device__ __forceinline__ int second(int y) const {
    return M::ld(at(y, 1));
  }
  __device__ __forceinline__ void set_second(int y, int v) const {
    M::st(at(y, 1), v);
  }
  __device__ __forceinline__ void min_second(int y, int v) const {
    M::min(at(y, 1), v);
  }
  __device__ __forceinline__ int flag(int y, int f) const {
    return M::ld8(at(y, 2 + f));
  }
  __device__ __forceinline__ void set_flag(int y, int f, int v) const {
    M::st8(at(y, 2 + f), v);
  }

  // The root of y, halving the path as it goes (parent[y] = y at a root):
  // for the unions, where every thread that writes a parent writes an
  // ancestor
  __device__ __forceinline__ int find_root(int y) const {
    for (;;) {
      const int p = parent(y);
      if (p == y) return y;
      const int gp = parent(p);
      if (gp != p) set_parent(y, gp);  // path halving: an ancestor of y
      y = p;
    }
  }

  // The root of y, reading only
  __device__ __forceinline__ int find_global(int y) const {
    for (;;) {
      const int p = parent(y);
      if (p == y) return y;
      y = p;
    }
  }

  // The local top of own node y: the first node on its path whose parent
  // is another CTA's, or a root; reading only
  __device__ __forceinline__ int local_top(int y) const {
    for (;;) {
      const int p = parent(y);
      if (p == y || !mine(p)) return y;
      y = p;
    }
  }

  // Unite the sets of a and b, hooking the root of the larger key under
  // the smaller; two nodes with one parent are in one set already (in a
  // percolating cluster most bonds are, and the early return spares the
  // root's word the reads)
  __device__ __forceinline__ void unite(int a, int b) const {
    if (parent(a) == parent(b)) return;
    for (;;) {
      a = find_root(a);
      b = find_root(b);
      if (a == b) return;
      if (key(a) > key(b)) {
        const int t = a;
        a = b;
        b = t;
      }
      const int old = cas_parent(b, b, a);
      if (old == b) return;
      b = old;
    }
  }

  // The end of relaxation round `round` (numbered from 1 across the
  // launch): true when any CTA of the cluster moved something in it. Every
  // thread of every CTA calls it; it holds one cluster.sync(). A CTA that
  // reads the word after a faster CTA has already set it for round + 1
  // reads a larger number, and round + 1 is reached only when round moved.
  __device__ __forceinline__ bool any(const cgn::cluster_group& cluster,
                                      int moved, int round) const {
    if (__syncthreads_or(moved) && threadIdx.x == 0) *any0 = round;
    cluster.sync();
    return *any0 >= round;
  }
};

// Set up the head of this CTA (the region addresses: CTA r's shared memory
// after `off` bytes, or slice r of `global`, the chain's regions in device
// memory) and return the core of a P x n chain over R CTAs; the caller
// holds a __syncthreads() before any node is reached and a cluster.sync()
// before any other CTA's.
template <bool kOnChip>
__device__ __forceinline__ Core<kOnChip> make_core(
    const cgn::cluster_group& cluster, unsigned char* smem, int R, int P,
    int n, int ints, size_t off, char* global) {
  Core<kOnChip> c;
  c.head = reinterpret_cast<NodesHead*>(smem);
  c.n = n;
  c.nc = (n + R - 1) / R;
  c.slots = P * c.nc;
  c.ints = ints;
  c.by_nc.init(static_cast<uint32_t>(c.nc));
  c.by_slots.init(static_cast<uint32_t>(c.slots));
  c.rank = static_cast<int>(cluster.block_rank());
  c.y0 = c.rank * c.slots;
  c.cta0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem + off));
  if (static_cast<int>(threadIdx.x) < R) {
    const int r = threadIdx.x;
    if (kOnChip) {
      const uint32_t own = static_cast<uint32_t>(
          __cvta_generic_to_shared(smem + off));
      uint32_t remote;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                   : "=r"(remote) : "r"(own), "r"(r));
      c.head->shared[r] = remote;
    } else {
      c.head->global[r] = global + region_bytes(c.slots, ints) * r;
    }
  }
  if (threadIdx.x == 0 && c.rank == 0) c.head->any = 0;
  NodesHead* h0 =
      c.rank == 0 ? c.head : cluster.map_shared_rank(c.head, 0);
  c.any0 = &h0->any;
  return c;
}

// Shared memory of one CTA: the head, `floats` floats of tables, and with
// `on_chip` its region (ops/cluster_kernels.py::label_smem_bytes counts the
// same)
inline size_t nodes_smem_bytes(int P, int n, int R, int ints, int floats,
                               bool on_chip) {
  const int nc = (n + R - 1) / R;
  return kNodesHeadBytes + static_cast<size_t>(floats) * sizeof(float) +
         (on_chip ? region_bytes(P * nc, ints) : 0);
}

}  // namespace mcs
