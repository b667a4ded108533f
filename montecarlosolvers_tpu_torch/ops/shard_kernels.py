"""The shard kernels of the Trotter-sharded PIQMC engines
(`parallel/trotter.py`): plain versions and kernel wrappers.

No Pallas kernel covers this path: the JAX package runs its sharded
engines as XLA inside `shard_map` (montecarlosolvers_tpu/parallel/
trotter.py). Per shard these kernels do what kernel B (csrc/split_qmc.cu)
and csrc/generic_qmc.cu do on a whole state, one update phase a launch,
on a rank's slab of the Trotter axis:

  S1 `shard_phase`        one local phase (two quarter updates) of the
                          split engine (`_split_sharded_sweep` :358);
  S2 `shard_line_part`,   the split engine's line moves of one color: the
     `shard_line_accept`  slab's part of the line sums, then, after the
                          ranks' parts are summed, the accept
                          (`_split_sharded_global` :386);
  S3 `generic_shard_phase`  one space-time color phase of the generic
                          engine (`_sharded_local_sweep` :115);
  S4 `generic_shard_line_part`, `generic_shard_line_accept`  the generic
                          line moves of one spatial color
                          (`_sharded_global_moves` :233);
  S5 `generic_shard_bath_slice`  one local slice step of the sharded bath:
                          a slice of the slab through the color classes
                          in order, its Trotter and bath terms read from
                          the gathered state (`updated_slice` of
                          `_sharded_dissipative_sweep` :170-192).

The Trotter partners past a slab's edges come from halo rows that the ring
exchange filled (`parallel/_collectives.py::ring_halo`), and every uid
counts from the global chain and row, so a slab draws the single-device
engine's uniforms: without line moves a sharded anneal equals the
single-device one bitwise. S1 and S2 are kernel B's per-phase kernels
(csrc/split_qmc.cu::qmc_local_kernel, qmc_line_kernel), whose unsharded
route is the one-rank case; S3 and S4 are in csrc/generic_qmc.cu, S5 in
csrc/generic_qmc_bath.cu. The sharded Wolff and Swendsen-Wang rounds (S6,
S7) are in `ops/cluster_kernels.py`.

Each wrapper takes its plain version on a CPU tensor and launches its
kernel on a CUDA tensor (LAUNCHES["shard_phase"], ["shard_line_part"],
["shard_line_accept"], ["generic_shard_phase"], ["generic_shard_line_part"],
["generic_shard_line_accept"], ["generic_shard_bath_slice"], one a
launch); nothing falls back. S5 runs each chain's slice over a
thread-block cluster (`shard_bath_geometry`), and a slice no cluster holds
on the file's first S5 kernel (["generic_shard_bath_slice_wide"]). A plain
version takes its uniforms from the counter hash, or from `draws=`, which
the tests fill with the JAX engines' own `jax.random` draws.
"""

from __future__ import annotations

import ctypes

import torch

from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import counter_rng as cr
from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
from montecarlosolvers_tpu_torch.ops import piqmc as piqmc_ops
from montecarlosolvers_tpu_torch.ops import split as split_ops
from montecarlosolvers_tpu_torch.ops.generic_kernels import _check_graph
from montecarlosolvers_tpu_torch.ops.metropolis import metropolis_accept
from montecarlosolvers_tpu_torch.ops.piqmc import sum_in_order

# The two local phases of a step, X then Y, in kernel B's order
# (pallas_split.py:514-518), each two quarter updates (updated quarter,
# stencil quarter, ring quarter, ring direction, weights half); quarters xe,
# xo, ye, yo = 0..3, and the counter index of an update is its updated
# quarter's. No update of a phase writes what the other reads.
PHASES = (((0, 2, 3, -1, 0), (1, 3, 2, +1, 1)),
          ((2, 0, 1, -1, 1), (3, 1, 0, +1, 0)))
# The lines of color A are quarters xe, yo against ye, xo; those of color B
# quarters ye, xo against xe, yo: (s1, o1, s2, o2) of each color.
LINE_QUARTERS = ((0, 2, 3, 1), (2, 0, 1, 3))


# S5's cluster route (csrc/generic_qmc_bath.cu::
# generic_shard_bath_slice_cluster_kernel): the head of a CTA's dynamic
# shared memory (16 spin-buffer pointers; the kernel has no static shared
# memory), and at most gk.WORD_THREADS threads a CTA, registers for two
# CTAs an SM
SHARD_HEAD_BYTES = 16 * 8


def _teff32(teff, like):
    return torch.tensor(teff, dtype=torch.float32, device=like.device)


def halo_rows(quarters, phase):
    """(last, first): the rows the ring exchange of `phase` sends, the last
    row of its first update's ring quarter (to the next rank, whose q - 1
    partner it is) and the first row of its second's (to the previous
    rank, q + 1). The exchange returns the halo rows of `shard_phase`."""
    (_, _, r0, _, _), (_, _, r1, _, _) = PHASES[phase]
    return quarters[r0][:, -1], quarters[r1][:, 0]


def _partner(r, halo, direction):
    """Row q + direction of the ring quarter `r` (chains, Qs, nh), the
    slab's edge reading `halo` (chains, nh)."""
    if direction < 0:
        return torch.cat([halo[:, None], r[:, :-1]], dim=1)
    return torch.cat([r[:, 1:], halo[:, None]], dim=1)


# ------------------------------------------------------------ plain versions


def shard_phase_ref(sl, b_sched, jp, teff, quarters, halos, phase, t, seed,
                    chain0=0, q0=0, q_total=None, draws=None):
    """Plain form of S1: the quarters (xe, xo, ye, yo), each (chains, Qs,
    nh), after local phase `phase` (0: X, 1: Y) of step t. Each update of
    the phase takes quarter s against the stencil quarter o and the ring
    quarter r at rows q and q + direction, the row past the slab's edge its
    halo row (halos: the pair the phase's ring exchange returned, (chains,
    nh) each), with the weights of half `color`:

        dE = (-2B s) f + (2 s J_perp)(r[q] + r[q + direction]),

    as `split_kernels.qmc_split_anneal_ref`'s update. b_sched, jp: float32
    (steps,) tensors; teff: P*T, a Python float. Uniforms: `draws` (a pair,
    each of a quarter's shape), else the hash at counter(seed, t, s) and
    the quarter uids of rows q0 .. q0 + Qs - 1 of a q_total-row state
    (default Qs) from chain chain0. Returns a new list of the quarters."""
    out = list(quarters)
    chains, qs, nh = quarters[0].shape
    bc = -2.0 * b_sched[t]
    for i, (s, o, r, direction, color) in enumerate(PHASES[phase]):
        x = quarters[s]
        f = (split_ops.spatial_field(sl.w_ab[:, color], quarters[o], sl.K)
             + sl.h_ab[color])
        ring = quarters[r]
        tr = ring + _partner(ring, halos[i], direction)
        de = bc * x * f + 2.0 * x * jp[t] * tr
        u = (cr.uniform01(cr.counter(seed, t, s),
                          cr.quarter_uids(chains, qs, nh, s, x.device,
                                          chain0, q0, q_total))
             if draws is None else draws[i])
        out[s] = torch.where(metropolis_accept(de, _teff32(teff, x), u), -x,
                             x)
    return out


def shard_line_part_ref(sl, quarters, color):
    """Plain form of S2's first half: the slab's part (chains, nh) of the
    line sums of `color` on the quarters (xe, xo, ye, yo), sum_q s1 f1 +
    sum_q s2 f2, each over the slab's rows in order
    (`split_kernels.quarter_line_moves`' sums)."""
    s1, o1, s2, o2 = (quarters[i] for i in LINE_QUARTERS[color])
    w, h = sl.w_ab[:, color], sl.h_ab[color]
    f1 = split_ops.spatial_field(w, o1, sl.K) + h
    f2 = split_ops.spatial_field(w, o2, sl.K) + h
    return sum_in_order(s1 * f1) + sum_in_order(s2 * f2)


def shard_line_accept_ref(b_sched, teff, total, quarters, color, t, seed,
                          chain0=0, draws=None):
    """Plain form of S2's second half: the lines of `color` accept on dE =
    -2B * total (the ranks' summed parts, (chains, nh)) and flip their two
    quarters of (xe, xo, ye, yo). Uniforms: `draws` (chains, nh), else
    kernel B's line uniforms, counter(seed, t, 4 + color) at the SA uids of
    half `color` from chain chain0. Returns a new list of the quarters."""
    chains, nh = total.shape
    de = -2.0 * b_sched[t] * total
    if draws is None:
        draws = cr.uniform01(cr.counter(seed, t, 4 + color),
                             cr.sa_uids(chains, nh, color, total.device,
                                        chain0))
    acc = metropolis_accept(de, _teff32(teff, total), draws)
    m = torch.where(acc, -1.0, 1.0)[:, None, :]
    out = list(quarters)
    s1, _, s2, _ = LINE_QUARTERS[color]
    out[s1], out[s2] = quarters[s1] * m, quarters[s2] * m
    return out


def generic_shard_phase_ref(pg, b_sched, jp, teff, s, halo_up, halo_dn, p,
                            m, t, seed, chain0=0, k0=0, p_total=None,
                            draws=None):
    """Plain form of S3: the packed slab `s` (chains, Ps, N) after local
    phase p of m at step t (`piqmc.local_sweep`'s phase): a site i of
    slice k (global k0 + k) flips when (class(i) + k0 + k) mod m == p and
    Metropolis accepts

        dE = (-2B s) f + (2 s J_perp)(s[k-1] + s[k+1]),

    the partners past the slab's edges the halo rows halo_up (slice k0 -
    1) and halo_dn (slice k0 + Ps), (chains, N). Uniforms: `draws` (s's
    shape, packed order), else counter(seed, t, 0) at the generic
    uids of slices k0 .. of a p_total-slice state (default Ps) from chain
    chain0."""
    chains, ps, n = s.shape
    prob = pg.as_problem()
    k = torch.arange(k0, k0 + ps, device=s.device)[:, None]
    stc = (prob.colors.long()[None, :] + k) % m
    if draws is None:
        draws = cr.uniform01(
            cr.counter(seed, t, 0),
            cr.generic_uids(chains, pg.perm, n, slices=ps, chain0=chain0,
                            k0=k0, p_total=p_total))
    up = torch.cat([halo_up[:, None], s[:, :-1]], dim=1)
    dn = torch.cat([s[:, 1:], halo_dn[:, None]], dim=1)
    de = (-2.0 * b_sched[t]) * s * prob.local_fields(s) \
        + 2.0 * s * jp[t] * (up + dn)
    flip = metropolis_accept(de, _teff32(teff, s), draws) & (stc == p)
    return torch.where(flip, -s, s)


def generic_shard_line_part_ref(pg, b_sched, s, c, t):
    """Plain form of S4's first half: the slab's part (chains, nc) of the
    line dE of class c's lines (packed block c), sum_k (-2B s_k) f_k over
    the slab's slices in order (`piqmc.global_line_moves`' sum)."""
    lo, hi = pg.starts[c], pg.starts[c + 1]
    field = pg.as_problem().local_fields(s)
    return sum_in_order((-2.0 * b_sched[t]) * s * field, dim=-2)[:, lo:hi]


def generic_shard_line_accept_ref(pg, teff, total, s, c, t, seed, chain0=0,
                                  p_total=None, draws=None):
    """Plain form of S4's second half: class c's lines accept on `total`
    (chains, nc), the ranks' summed parts, and flip the slab's slices of
    their sites. Uniforms: `draws` (chains, nc), else line_counter(seed,
    t, 0) at the slice-0 generic uids of a p_total-slice state
    from chain chain0. Returns the new slab."""
    lo, hi = pg.starts[c], pg.starts[c + 1]
    chains, ps, n = s.shape
    if draws is None:
        ids = cr.generic_uids(chains, pg.perm[lo:hi], n, slices=1,
                              chain0=chain0, p_total=p_total or ps)[:, 0]
        draws = cr.uniform01(cr.line_counter(seed, t, 0), ids)
    acc = metropolis_accept(total, _teff32(teff, s), draws)
    out = s.clone()
    out[:, :, lo:hi] = torch.where(acc[:, None, :], -s[:, :, lo:hi],
                                   s[:, :, lo:hi])
    return out


def generic_shard_bath_slice_ref(pg, b_sched, jp, teff, bath, s, full, kloc,
                                 kglob, t, seed, chain0=0, draws=None):
    """Plain form of S5: the packed slab `s` (chains, Ps, N) after one local
    slice step of the sharded bath at step t: its slice kloc (global slice
    kglob of the P in `full`) goes through the color classes in order, a
    site of class c flipping when Metropolis accepts

        dE = (-2B s) f + (2 s J_perp)(full[kglob-1] + full[kglob+1])
             + (2 T_eff s) sum_p M[kglob, p] full[p],

    added left to right, the bath sum in index order from p = 0 (M the
    (P, P) `bath` matrix, zero diagonal), the field f of the slice as it
    stands at the start of the class's phase (`piqmc.
    dissipative_local_sweep`'s slice). full: (chains, P, N), the state of
    every rank gathered at the step's start; at one rank it may be `s`
    itself, whose slice kglob the bath reads only through M[kglob, kglob]
    = 0. teff: P*T, a Python float. Uniforms: `draws` (one (chains, N) a
    class, packed order), else counter(seed, t, 0) at the generic uids of
    slice kglob from chain chain0, one a site for every class, as
    csrc/generic_qmc_bath.cu draws them. Returns the new slab."""
    chains, _, n = s.shape
    P = full.shape[1]
    prob = pg.as_problem()
    t32, two_teff, bc = piqmc_ops._bath_terms(s, teff, b_sched[t])
    s_k = s[:, kloc]
    tr = full[:, (kglob - 1) % P] + full[:, (kglob + 1) % P]
    bath_f = sum_in_order(bath[kglob][:, None] * full, dim=-2)
    if draws is None:
        u = cr.uniform01(cr.counter(seed, t, 0), cr.generic_uids(
            chains, pg.perm, n, slices=1, chain0=chain0, k0=kglob,
            p_total=P))[:, 0]
        draws = [u] * prob.num_colors
    for c in range(prob.num_colors):
        de = (bc * s_k * prob.local_fields(s_k) + 2.0 * s_k * jp[t] * tr
              + two_teff * s_k * bath_f)
        accept = metropolis_accept(de, t32, draws[c]) & prob.color_masks[c]
        s_k = torch.where(accept, -s_k, s_k)
    out = s.clone()
    out[:, kloc] = s_k
    return out


# ----------------------------------------- S5's cluster route, its geometry


def shard_bath_smem_bytes(P, slots):
    """Shared memory of one CTA of S5's cluster route, all of it dynamic
    (csrc/generic_qmc_bath.cu::shard_bath_smem_bytes): the head, both
    buffers of its `slots` slots' spins (a word a slot), the slots' line
    words (ceil(P/32) a slot, P slices of the gathered state) and the bath
    row, P floats."""
    return SHARD_HEAD_BYTES + (2 + -(-P // 32)) * slots * 4 + 4 * P


def shard_bath_geometry(chains, n, P, colors=1, sms=gk.NUM_SMS,
                        resident=None):
    """(R, threads) of S5's cluster route for `chains` chains' slice of an
    n-site graph of `colors` classes at P slices: each chain's slice over a
    cluster of R CTAs on `gk.word_layout`, R first the smallest of
    CLUSTER_SIZES (R <= n) whose chains x R CTAs cover the card's `sms`
    SMs and whose CTA holds its slots' spins, line words and the bath row
    in shared memory (`shard_bath_smem_bytes` of `gk.word_slots`), else the
    largest that holds them. Then, with `resident(R, threads)` (the wrapper
    passes the card's cudaOccupancyMaxActiveClusters; None: any number), R
    goes down to the largest whose chains' clusters all run at once; if
    none does, the first R stays. `gk.word_threads` threads. 32 chains of
    the 80x80 torus at P = 40 on an H100 SXM: R = 8, 512 threads. None when
    no cluster of 16 CTAs holds the slice (with two classes at P = 40 an n
    above 232,144) or the graph has more than 127 classes (`word_layout`):
    the wrapper then runs the first kernel
    (LAUNCHES["generic_shard_bath_slice_wide"])."""
    if colors > 127:
        return None
    fits = [r for r in gk.CLUSTER_SIZES
            if r <= max(n, 1) and shard_bath_smem_bytes(
                P, gk.word_slots(n, r, colors)) <= _build.SMEM_LIMIT_BYTES]
    if not fits:
        return None
    first = next((r for r in fits if chains * r >= sms), fits[-1])
    if resident is not None:
        for r in reversed([r for r in fits if r <= first]):
            shape = (r, gk.word_threads(n, r, colors))
            if resident(*shape) >= max(chains, 1):
                return shape
    return first, gk.word_threads(n, first, colors)


def card_shard_bath_geometry(pg, chains, P, device, full_int8):
    """`shard_bath_geometry` of `chains` chains of PackedGraph `pg` at P
    slices on the CUDA card `device`: its SMs, and how many clusters of
    each shape the card holds at once (`generic_qmc_bath_shard_max_active_
    clusters`, for `full` float32 or int8). Cached per shape: the sharded
    bath asks it every local slice step."""
    n, colors = pg.nspins, pg.num_colors
    shape = (str(device), n, colors, chains, P, bool(full_int8))
    if shape in _S5_GEOMETRY:
        return _S5_GEOMETRY[shape]

    def resident(R, threads):
        nr = gk.word_slots(n, R, colors)
        key = (str(device), P, nr, R, threads, bool(full_int8))
        if key not in _S5_RESIDENT:
            lib = _build.library("generic_qmc_bath")
            count = ctypes.c_int(0)
            rc = lib.generic_qmc_bath_shard_max_active_clusters(
                P, nr, R, threads, int(bool(full_int8)), ctypes.byref(count))
            _build.raise_on_error(
                lib, "generic_qmc_bath_shard_max_active_clusters", rc,
                error_fn="generic_qmc_bath_anneal_error_string")
            _S5_RESIDENT[key] = count.value
        return _S5_RESIDENT[key]
    _S5_GEOMETRY[shape] = shard_bath_geometry(
        chains, n, P, colors, sms=gk.card_sms(device), resident=resident)
    return _S5_GEOMETRY[shape]


_S5_RESIDENT, _S5_GEOMETRY = {}, {}


# ------------------------------------------------------------ kernel wrappers


def _check_quarters(sl, dev, quarters):
    chains, qs, _ = quarters[0].shape
    for q, name in zip(quarters, ("xe", "xo", "ye", "yo")):
        _build.check_arg(q, name, (chains, qs, sl.nh), dev)
    _build.check_arg(sl.w_ab, "w_ab", (sl.nslots, 2, sl.nh), dev)
    _build.check_arg(sl.h_ab, "h_ab", (2, sl.nh), dev)
    return chains, qs


def _halo_stride(halos, shape, dev):
    """The chain stride of the two halo rows `halos`: (chains, n) float32
    tensors on `dev` whose sites lie next to each other and whose chains
    lie one stride apart, rows of their own or rows of the slab itself (the
    ring of one rank)."""
    for i, x in enumerate(halos):
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"halo row {i} must be float32 on {dev}")
        if tuple(x.shape) != tuple(shape) or x.stride(1) != 1:
            raise ValueError(f"halo row {i} must be {tuple(shape)} with unit "
                             f"site stride, got {tuple(x.shape)} "
                             f"{x.stride()}")
    if halos[0].stride(0) != halos[1].stride(0):
        raise ValueError("the two halo rows must share one chain stride")
    return halos[0].stride(0)


def _step_arg(x, name, t, dev):
    if x.dim() != 1 or t >= x.shape[0]:
        raise ValueError(f"{name} must be a (steps,) schedule with step {t}")
    _build.check_arg(x, name, tuple(x.shape), dev)


def shard_phase(sl, b_sched, jp, teff, quarters, halos, phase, t, seed,
                chain0=0, q0=0, q_total=None):
    """S1 on CUDA tensors (csrc/split_qmc.cu::qmc_local_kernel with halo
    rows, one launch, the phase's two quarters updated in place),
    `shard_phase_ref` on CPU tensors; arguments as for the plain version
    (no `draws`). Returns the list of the quarters."""
    if _build.route(quarters[0].device, "shard") == "cpu":
        return shard_phase_ref(sl, b_sched, jp, teff, quarters, halos, phase,
                               t, seed, chain0, q0, q_total)
    dev = quarters[0].device
    chains, qs = _check_quarters(sl, dev, quarters)
    stride = _halo_stride(halos, (chains, sl.nh), dev)
    _step_arg(b_sched, "b_sched", t, dev)
    _step_arg(jp, "jp", t, dev)
    lib = _build.library("split_qmc")
    rc = lib.split_qmc_shard_phase(
        *map(_build.ptr, (sl.w_ab, sl.h_ab, b_sched, jp)),
        ctypes.c_float(teff), *map(_build.ptr, (*quarters, *halos)), stride,
        int(phase), chains, qs, sl.nh, sl.K, sl.nslots, int(t),
        cr.wrap_int32(seed), int(chain0), int(q0),
        int(qs if q_total is None else q_total), _build.stream_of(dev))
    _build.raise_on_error(lib, "split_qmc_shard_phase", rc,
                          error_fn="split_qmc_anneal_error_string")
    _build.LAUNCHES["shard_phase"] += 1
    return list(quarters)


def _shard_line(sl, b_sched, teff, quarters, part, total, color, t, seed,
                chain0):
    """One launch of csrc/split_qmc.cu::qmc_line_kernel on the slab:
    writing `part` (b_sched None: the part reads no step), or accepting on
    `total` (the other None)."""
    dev = quarters[0].device
    chains, qs = _check_quarters(sl, dev, quarters)
    _build.check_arg(part if total is None else total,
                     "part" if total is None else "total", (chains, sl.nh),
                     dev)
    if b_sched is not None:
        _step_arg(b_sched, "b_sched", t, dev)
    lib = _build.library("split_qmc")
    rc = lib.split_qmc_shard_line(
        _build.ptr(sl.w_ab), _build.ptr(sl.h_ab),
        None if b_sched is None else _build.ptr(b_sched),
        ctypes.c_float(teff),
        *map(_build.ptr, quarters),
        None if part is None else _build.ptr(part),
        None if total is None else _build.ptr(total), int(color), chains,
        qs, sl.nh, sl.K, sl.nslots, int(t), cr.wrap_int32(seed), int(chain0),
        _build.stream_of(dev))
    _build.raise_on_error(lib, "split_qmc_shard_line", rc,
                          error_fn="split_qmc_anneal_error_string")


def shard_line_part(sl, quarters, color):
    """S2's first half on CUDA tensors (csrc/split_qmc.cu::qmc_line_kernel
    writing the part, one launch), `shard_line_part_ref` on CPU tensors.
    Returns the part, (chains, nh) float32."""
    if _build.route(quarters[0].device, "shard") == "cpu":
        return shard_line_part_ref(sl, quarters, color)
    part = torch.empty((quarters[0].shape[0], sl.nh), dtype=torch.float32,
                       device=quarters[0].device)
    _shard_line(sl, None, 1.0, quarters, part, None, color, 0, 0, 0)
    _build.LAUNCHES["shard_line_part"] += 1
    return part


def shard_line_accept(sl, b_sched, teff, total, quarters, color, t, seed,
                      chain0=0):
    """S2's second half on CUDA tensors (csrc/split_qmc.cu::qmc_line_kernel
    on the summed `total`, one launch, the color's two quarters flipped in
    place), `shard_line_accept_ref` on CPU tensors. Returns the list of the
    quarters."""
    if _build.route(quarters[0].device, "shard") == "cpu":
        return shard_line_accept_ref(b_sched, teff, total, quarters, color, t,
                                     seed, chain0)
    _shard_line(sl, b_sched, teff, quarters, None, total, color, t, seed,
                chain0)
    _build.LAUNCHES["shard_line_accept"] += 1
    return list(quarters)


def generic_shard_phase(pg, b_sched, jp, teff, s, halo_up, halo_dn, p, m,
                        t, seed, chain0=0, k0=0, p_total=None):
    """S3 on CUDA tensors (csrc/generic_qmc.cu::generic_shard_phase_kernel,
    one launch, out of place), `generic_shard_phase_ref` on CPU tensors;
    arguments as for the plain version. Returns the new slab."""
    if _build.route(s.device, "shard") == "cpu":
        return generic_shard_phase_ref(pg, b_sched, jp, teff, s, halo_up,
                                       halo_dn, p, m, t, seed, chain0, k0,
                                       p_total)
    chains, ps, n = s.shape
    dev = s.device
    graph = _check_graph(pg, dev)
    _build.check_arg(s, "s", (chains, ps, pg.nspins), dev)
    stride = _halo_stride((halo_up, halo_dn), (chains, n), dev)
    _step_arg(b_sched, "b_sched", t, dev)
    _step_arg(jp, "jp", t, dev)
    out = torch.empty_like(s)
    lib = _build.library("generic_qmc")
    rc = lib.generic_qmc_shard_phase(
        *graph, _build.ptr(b_sched), _build.ptr(jp), ctypes.c_float(teff),
        *map(_build.ptr, (s, out, halo_up, halo_dn)), stride, chains, ps,
        n, pg.nbr_idx.shape[1], pg.num_colors, int(m), int(p), int(t),
        cr.wrap_int32(seed), int(chain0), int(k0),
        int(ps if p_total is None else p_total), _build.stream_of(dev))
    _build.raise_on_error(lib, "generic_qmc_shard_phase", rc,
                          error_fn="generic_qmc_anneal_error_string")
    _build.LAUNCHES["generic_shard_phase"] += 1
    return out


def generic_shard_line_part(pg, b_sched, s, c, t):
    """S4's first half on CUDA tensors (csrc/generic_qmc.cu::
    generic_shard_line_part_kernel, one launch),
    `generic_shard_line_part_ref` on CPU tensors. Returns the part,
    (chains, nc) float32."""
    if _build.route(s.device, "shard") == "cpu":
        return generic_shard_line_part_ref(pg, b_sched, s, c, t)
    chains, ps, n = s.shape
    dev = s.device
    _check_graph(pg, dev)
    _build.check_arg(s, "s", (chains, ps, pg.nspins), dev)
    _step_arg(b_sched, "b_sched", t, dev)
    lo, hi = pg.starts[c], pg.starts[c + 1]
    part = torch.empty((chains, hi - lo), dtype=torch.float32, device=dev)
    lib = _build.library("generic_qmc")
    rc = lib.generic_qmc_shard_line_part(
        *map(_build.ptr, (pg.nbr_idx, pg.nbr_J, pg.h, b_sched, s, part)),
        chains, ps, n, pg.nbr_idx.shape[1], lo, hi - lo, int(t),
        _build.stream_of(dev))
    _build.raise_on_error(lib, "generic_qmc_shard_line_part", rc,
                          error_fn="generic_qmc_anneal_error_string")
    _build.LAUNCHES["generic_shard_line_part"] += 1
    return part


def generic_shard_line_accept(pg, teff, total, s, c, t, seed, chain0=0,
                              p_total=None):
    """S4's second half on CUDA tensors (csrc/generic_qmc.cu::
    generic_shard_line_accept_kernel, one launch, the slab flipped in
    place), `generic_shard_line_accept_ref` on CPU tensors. Returns the new
    slab."""
    if _build.route(s.device, "shard") == "cpu":
        return generic_shard_line_accept_ref(pg, teff, total, s, c, t, seed,
                                             chain0, p_total)
    chains, ps, n = s.shape
    dev = s.device
    _check_graph(pg, dev)
    _build.check_arg(s, "s", (chains, ps, pg.nspins), dev)
    lo, hi = pg.starts[c], pg.starts[c + 1]
    _build.check_arg(total, "total", (chains, hi - lo), dev)
    lib = _build.library("generic_qmc")
    rc = lib.generic_qmc_shard_line_accept(
        _build.ptr(pg.perm), ctypes.c_float(teff), _build.ptr(total),
        _build.ptr(s), chains, ps, n, lo, hi - lo, int(t),
        cr.wrap_int32(seed), int(chain0),
        int(ps if p_total is None else p_total), _build.stream_of(dev))
    _build.raise_on_error(lib, "generic_qmc_shard_line_accept", rc,
                          error_fn="generic_qmc_anneal_error_string")
    _build.LAUNCHES["generic_shard_line_accept"] += 1
    return s


def generic_shard_bath_slice(pg, b_sched, jp, teff, bath, s, full, kloc,
                             kglob, t, seed, chain0=0):
    """S5 on CUDA tensors (csrc/generic_qmc_bath.cu, one launch, slice kloc
    of the slab updated in place), `generic_shard_bath_slice_ref` on CPU
    tensors; arguments as for the plain version (no `draws`; `full`
    contiguous float32, the slab itself at one rank, or the int8 the
    gather sends). Returns the slab.

    Two hand-written kernels share the work, chosen by shape alone: where
    `card_shard_bath_geometry` finds a cluster, the cluster route, each
    chain's slice over R CTAs, `full` read as it comes
    (LAUNCHES["generic_shard_bath_slice"]); else the file's first S5
    kernel, one CTA a chain, on `full` as float32
    (LAUNCHES["generic_shard_bath_slice_wide"]). Both equal the plain
    version bitwise; neither is a fallback from a failure of the other."""
    if _build.route(s.device, "shard") == "cpu":
        return generic_shard_bath_slice_ref(
            pg, b_sched, jp, teff, bath, s, full.to(torch.float32), kloc,
            kglob, t, seed, chain0)
    chains, ps, n = s.shape
    P = full.shape[1]
    dev = s.device
    graph = _check_graph(pg, dev)
    _build.check_arg(s, "s", (chains, ps, pg.nspins), dev)
    int8 = full.dtype == torch.int8
    _build.check_arg(full, "full", (chains, P, pg.nspins), dev,
                     torch.int8 if int8 else torch.float32)
    _build.check_arg(bath, "bath", (P, P), dev)
    _step_arg(b_sched, "b_sched", t, dev)
    _step_arg(jp, "jp", t, dev)
    if not (0 <= kloc < ps and 0 <= kglob < P):
        raise ValueError(f"slice {kloc} (global {kglob}) is not in a slab "
                         f"of {ps} of {P}")
    lib = _build.library("generic_qmc_bath")
    geometry = card_shard_bath_geometry(pg, chains, P, dev, int8)
    if geometry is not None:
        R, threads = geometry
        slot_site, slot_starts, nbr_loc, nr = gk.word_layout(pg, R)
        rc = lib.generic_qmc_bath_shard_slice_cluster(
            *map(_build.ptr, (slot_site, slot_starts, nbr_loc, pg.nbr_J,
                              pg.h, pg.perm, b_sched, jp, bath)),
            ctypes.c_float(teff), ctypes.c_float(2.0 * teff), _build.ptr(s),
            _build.ptr(full), int(int8), chains, ps, n, pg.nbr_idx.shape[1],
            pg.num_colors, int(kloc), int(kglob), P, int(t),
            cr.wrap_int32(seed), R, nr, threads, int(chain0),
            _build.stream_of(dev))
        _build.raise_on_error(lib, "generic_qmc_bath_shard_slice_cluster", rc,
                              error_fn="generic_qmc_bath_anneal_error_string")
        _build.LAUNCHES["generic_shard_bath_slice"] += 1
        return s
    if int8:
        full = full.to(torch.float32)
    snap = None if pg.proper else torch.empty((chains, n),
                                              dtype=torch.float32,
                                              device=dev)
    rc = lib.generic_qmc_bath_shard_slice(
        *graph, _build.ptr(b_sched), _build.ptr(jp), _build.ptr(bath),
        ctypes.c_float(teff), ctypes.c_float(2.0 * teff), _build.ptr(s),
        _build.ptr(full), None if snap is None else _build.ptr(snap), chains,
        ps, n, pg.nbr_idx.shape[1], pg.num_colors, int(kloc), int(kglob), P,
        int(t), cr.wrap_int32(seed), int(pg.proper), int(chain0),
        _build.stream_of(dev))
    _build.raise_on_error(lib, "generic_qmc_bath_shard_slice", rc,
                          error_fn="generic_qmc_bath_anneal_error_string")
    _build.LAUNCHES["generic_shard_bath_slice_wide"] += 1
    return s
