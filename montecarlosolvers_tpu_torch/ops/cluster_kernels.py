"""The cluster updates on the card: kernel wrappers and the problem-level
anneals of `solvers/sa.py` and `solvers/qmc.py`'s cluster solvers.

No Pallas kernel covers this path: the JAX package runs it as XLA,
frontier BFS and min-label relaxation inside `lax.while_loop` and the
boolean closure by einsum (montecarlosolvers_tpu/ops/cluster.py). The port
gives its three hot loops hand-written CUDA kernels, all on the
class-major packed layout of `ops/packed.py` (the site's original index
`perm` keys every draw, `counter_rng`'s cluster streams):

  csrc/fk_wolff.cu  one Wolff cluster a chain and step (`wolff_update`,
                    rules "local" and "full", with or without a bath): the
                    seed's component of the whole graph's draw, on the
                    labeling core of fk_label; LAUNCHES["fk_wolff"]
  csrc/fk_label.cu  Swendsen-Wang (`classical_sw_sweep`, P = 1, and
                    `spacetime_sw_sweep`, any P, optional bath): union-find
                    labels; LAUNCHES["fk_label"]
                    Both spread each chain over a thread-block cluster of R
                    CTAs (`label_geometry`; csrc/fk_nodes.cuh): CTA r owns
                    the union-find nodes of the r-th chunk of ceil(N / R)
                    sites in every slice, in its shared memory while they
                    fit, else in device memory. On an H100 80GB HBM3 at
                    700 W (PERF.md §6): fk_label 0.81 ms a step at P = 40,
                    8 chains (R = 9; the one-CTA kernel before it 9.47-9.51
                    in the same call), fk_wolff 0.35 at P = 40, one chain
                    (1.19-1.20), 0.078 at P = 1, 64 chains (0.19-0.20)
  csrc/fk_line.cu   the imaginary-time line clusters (`bath_cluster_phase`,
                    `sw_full_phase`): at P <= 64 the whole anneal in one
                    launch, a line's slices as the bits of a 64-bit word,
                    a chain's words over a thread-block cluster of R CTAs
                    (`line_geometry`), a warp a line; LAUNCHES["fk_line"].
                    A chain no cluster holds: the first kernel, one warp
                    a line, one launch a color phase (LAUNCHES
                    ["fk_line_wide"]); P > 64: rows of ceil(P/64) words in
                    a warp's shared memory up to LINE_MAX_SLICES, one
                    launch a color phase (LAUNCHES["fk_line_rows"])
  csrc/houdayer.cu  the Houdayer move of ICM (`houdayer_sweep`): each pair
                    over a thread-block cluster of R CTAs on the labeling
                    core (`houdayer_geometry`, its union-find in shared
                    memory), on replicas in site order
                    (`houdayer_move`) or in place on the packed engine's
                    state (`houdayer_move_packed`); LAUNCHES["houdayer"].
                    A pair no cluster holds: the first kernel, one CTA a
                    pair (LAUNCHES["houdayer_wide"])

Their plain versions are `ops/cluster.py`'s `wolff_anneal_ref`,
`sw_anneal_ref`, `line_phase_ref` (phase after phase: `line_anneal_ref`)
and `houdayer_move_ref` (on the packed state: `houdayer_move_packed_ref`).
A wrapper
given CPU tensors runs the plain version; given CUDA tensors it launches
the kernel or raises.

Launch pattern. fk_wolff and fk_label run a whole schedule in one launch
when no local sweep is interleaved (qmc.anneal_wolff; anneal_sw and
sa.anneal_wolff with local_sweeps=False). With local sweeps, each step is
one launch of the local kernel (csrc/packed_sa.cu, csrc/generic_qmc.cu
without line moves, or csrc/generic_qmc_bath.cu) and one of the cluster
kernel, each told its step (`step0`), so that every step draws its own
uniforms. qmc.anneal_sw_bath launches fk_line once an anneal at P <= 64
(WC3, and WC2 without local sweeps), or once a step after the step's
local launch (WC2 with local sweeps); past a cluster or past P = 64, once
a color phase.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from montecarlosolvers_tpu_torch import schedules
from montecarlosolvers_tpu_torch.models.lattice import LatticeProblem
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import cluster as cl
from montecarlosolvers_tpu_torch.ops import counter_rng as cr
from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
from montecarlosolvers_tpu_torch.ops import packed as packed_ops
from montecarlosolvers_tpu_torch.ops import piqmc as piqmc_ops

# the most threads a CTA of fk_wolff and fk_label, and the warps a CTA of
# fk_line (one line a warp)
LABEL_THREADS, LINE_WARPS = 1024, 8
# the head of a fk_label / fk_wolff CTA's shared memory (csrc/fk_nodes.cuh::
# kNodesHeadBytes: the cluster's region pointers and a few words); the two
# kernels have no static shared memory
LABEL_HEAD_BYTES = 256
# the card's SMs where no card is asked (an H100 SXM's), and the most CTAs
# a cluster of fk_label / fk_wolff takes (csrc/fk_nodes.cuh::kMaxRanks)
NUM_SMS, CLUSTER_MAX = gk.NUM_SMS, 16
# shared memory of one H100 SM (228 KB), which the CTAs resident on it share
SM_SMEM_BYTES = 233472
# the most slices fk_line takes: past P = 64 a line's P x P bonds are P
# rows of ceil(P/64) 64-bit words, twice, beside its spins, fields and
# energies in one warp's shared memory (`line_wide_bytes`), and at P = 922
# one warp's needs pass a CTA's 227 KB
LINE_MAX_SLICES = 921
# the Houdayer move's first kernel keeps a pair's union-find parents
# (int32) in shared memory up to this many bytes, else in device memory
# (1024 threads a pair)
HOUDAYER_SMEM_BYTES = 200 * 1024
HOUDAYER_THREADS = 1024
# fk_line's cluster kernel (csrc/fk_line.cu::fk_line_cluster_kernel): at
# most LINE_THREADS threads a CTA (a warp a line), a head of
# LINE_HEAD_BYTES (16 word pointers), LINE_WARP_BYTES of scratch a warp
# (64 rows, parents, floats and accept bytes); it takes P <= 64
LINE_THREADS, LINE_HEAD_BYTES, LINE_WARP_BYTES = 1024, 128, 1088
LINE_WORD_SLICES = 64


def _check_graph(pg, device):
    """The pointers nbr_idx, nbr_J, h and perm of the packed layout, checked
    as the generic kernels check them (their starts too)."""
    return gk._check_graph(pg, device)[:4]


def _check_schedules(steps, device, **scheds):
    for name, x in scheds.items():
        _build.check_arg(x, name, (steps,), device)
    return tuple(_build.ptr(x) for x in scheds.values())


def _check_lut(lookuptable, P, device):
    if lookuptable is None:
        return None
    _build.check_arg(lookuptable, "lookuptable", (P - 1,), device)
    return _build.ptr(lookuptable)


# ------------------------------------------------------------ kernel wrappers


def wolff_anneal(pg, b_sched, jp, teff, confs, seed, rule="local",
                 lookuptable=None, step0=0, visited=None, chain0=0):
    """csrc/fk_wolff.cu on CUDA tensors, `cluster.wolff_anneal_ref` on CPU
    tensors; arguments as for the plain version (teff a float32 (steps,)
    tensor; lookuptable None or a contiguous float32 (P-1,) tensor, any
    table: on one not symmetric in ring distance the cluster is the seed's
    directed reach, as the plain BFS's; chain0 the global index of the
    first chain, a chain shard's). Returns the new configurations. One
    launch (LAUNCHES["fk_wolff"]), each chain over the cluster of
    `card_label_geometry`."""
    if rule not in ("local", "full"):
        raise ValueError(f"rule must be 'local' or 'full', got {rule!r}")
    if _build.route(confs.device, "cluster") == "cpu":
        return cl.wolff_anneal_ref(pg, b_sched, jp, teff, confs, seed, rule,
                                   lookuptable, step0, visited, chain0)
    chains, P, n = confs.shape
    dev = confs.device
    steps = int(b_sched.shape[0])
    graph = _check_graph(pg, dev)
    sched = _check_schedules(steps, dev, b_sched=b_sched, jp=jp, teff=teff)
    lut = _check_lut(lookuptable, P, dev)
    _build.check_arg(confs, "confs", (chains, P, pg.nspins), dev)
    if visited is not None:
        _build.check_arg(visited, "visited", (chains,), dev, torch.int64)
    out = confs.clone()
    R, threads, on_chip = card_label_geometry(
        "fk_wolff", chains, P, n, dev, lookuptable is not None,
        rule_full=rule == "full")
    regions = _regions(chains, P, n, R, 1, on_chip, dev)
    terms = (None if rule == "full" else
             torch.empty((chains, P * n + P), dtype=torch.float32,
                         device=dev))
    lib = _build.library("fk_wolff")
    rc = lib.fk_wolff_anneal(
        *graph, _build.ptr(inv_perm(pg)), _build.ptr(boundary_sites(pg, R)),
        *sched, lut, _build.ptr(out), _opt(regions), _opt(terms),
        _opt(visited), chains, P, n, pg.nbr_idx.shape[1], steps,
        cr.wrap_int32(seed), int(step0), int(rule == "full"), R,
        int(ring_asymmetric(lookuptable)), threads, int(chain0),
        _build.stream_of(dev))
    _build.raise_on_error(lib, "fk_wolff_anneal", rc)
    _build.LAUNCHES["fk_wolff"] += 1
    return out


def region_bytes(P, n, R, ints):
    """Bytes of one CTA's region of the labeling core (csrc/fk_nodes.cuh::
    region_bytes): P ceil(n / R) nodes (its sites in every slice) of `ints`
    int32 and two flag bytes, in whole int32 words."""
    slots = P * -(-n // R)
    return -(-slots * (4 * ints + 2) // 4) * 4


def inv_perm(pg):
    """(n,) int32 on pg's device: the packed position of each original
    site index (the inverse of pg.perm), which fk_label and fk_wolff walk
    their own sites by. Cached per graph."""
    hit = _INV_PERM.get(id(pg))
    if hit is not None and hit[0]() is pg:
        return hit[1]
    inv = torch.empty_like(pg.perm, dtype=torch.int32)
    inv[pg.perm.long()] = torch.arange(pg.nspins, dtype=torch.int32,
                                       device=pg.perm.device)
    for k in [k for k, (ref, _) in _INV_PERM.items() if ref() is None]:
        del _INV_PERM[k]
    _INV_PERM[id(pg)] = (weakref.ref(pg), inv)
    return inv


def boundary_sites(pg, R):
    """(R + 1 + m,) int32 on pg's device: R + 1 offsets, then, CTA by CTA,
    the sites (original indices) of CTA r's chunk [r nc, (r + 1) nc), nc =
    ceil(n / R), with a neighbour outside it, CTA r's at offsets r .. r +
    1: the sites whose spatial bonds fk_label, fk_wolff and the Houdayer
    move unite across CTAs (none at R = 1). pg: a PackedGraph, or an
    IsingProblem whose columns are the site ids. Cached per graph and
    R."""
    key = (id(pg), R)
    hit = _BOUNDARY.get(key)
    if hit is not None and hit[0]() is pg:
        return hit[1]
    n = pg.nspins
    nc = -(-n // R)
    # an IsingProblem in site order: its columns are the ids themselves
    perm = (pg.perm.cpu().numpy().astype(np.int64)
            if hasattr(pg, "perm") else np.arange(n))
    nbr = pg.nbr_idx.cpu().numpy().astype(np.int64)
    ids = np.broadcast_to(perm[:, None], nbr.shape)
    pad = nbr == np.arange(n)[:, None]
    cross = ((perm[nbr] // nc != ids // nc) & ~pad).any(axis=1)
    sites = np.sort(perm[cross])
    offsets = np.searchsorted(sites, np.arange(R + 1) * nc)
    out = torch.as_tensor(np.concatenate([offsets, sites]).astype(np.int32),
                          device=pg.nbr_idx.device)
    for k in [k for k, (ref, _) in _BOUNDARY.items() if ref() is None]:
        del _BOUNDARY[k]
    _BOUNDARY[key] = (weakref.ref(pg), out)
    return out


_INV_PERM, _BOUNDARY = {}, {}


def label_smem_bytes(P, n, R, asym=False, on_chip=True):
    """Shared memory of one CTA of fk_label / fk_wolff (csrc/fk_nodes.cuh::
    nodes_smem_bytes): the head, the bath's two probability rows (P floats
    each), and with `on_chip` the CTA's region of the union-find, P ceil(n
    / R) nodes (fk_label with `asym` two int32 a node, else one)."""
    return (LABEL_HEAD_BYTES + 8 * P
            + (region_bytes(P, n, R, 2 if asym else 1) if on_chip else 0))


def label_geometry(chains, P, n, asym=False, sms=NUM_SMS, resident=None):
    """(R, threads, on_chip) of fk_label and fk_wolff for `chains` chains of
    P slices of an n-site graph: each chain over a cluster of R CTAs. R is
    first the largest whose chains x R CTAs fit the card's `sms` SMs, one
    an SM, unless that leaves more than a quarter of them idle, then one
    more (the smallest that covers them); at most 16 and at most n. (At 64
    chains on 132 SMs, R = 2 ran fk_label 1.3x and fk_wolff 1.2x faster
    than R = 3, whose 192 CTAs need two waves or two CTAs an SM: PERF.md
    §6.) Then, with `resident(R, threads, on_chip)`, the number of such
    clusters the card holds at once (the wrappers pass `card_resident`;
    None: any number), R goes down to the largest whose chains all run at
    once, since a cluster's CTAs share one GPC: an H100 SXM holds 7
    clusters of 16 CTAs of 1024 threads and 15 of 8, so 8 chains at P = 40
    take R = 9 (0.81 ms a step against 0.92 at R = 16: PERF.md §6); if no
    R holds them all, the first R stays. The wrappers call it through
    `card_label_geometry`. CTA r owns the r-th
    chunk of ceil(n / R) sites in every slice; each CTA
    `threads` threads (one a node of its P ceil(n / R), in whole warps, at
    most LABEL_THREADS); on_chip when each CTA's region of the union-find
    fits its shared memory beside the head and the tables
    (`label_smem_bytes`, every byte counted: the kernels have no static
    shared memory), else the regions live in device memory and the chain
    is still spread over R CTAs. `asym`: fk_label on a bath table not
    symmetric in ring distance (its labels beside the parents); fk_wolff
    passes False."""
    chains = max(chains, 1)
    R = max(1, sms // chains)
    if chains * R * 4 < 3 * sms:
        R += 1
    R = min(R, CLUSTER_MAX, max(n, 1))
    if resident is not None:
        for r in range(R, 0, -1):
            shape = label_shape(r, P, n, asym, chains, sms)
            if resident(*shape) >= chains:
                return shape
    return label_shape(R, P, n, asym, chains, sms)


def card_resident(kernel, P, n, dev, bath=False, asym=False,
                  rule_full=False):
    """The `resident(R, threads, on_chip)` of kernel "fk_label" or
    "fk_wolff" on the card `dev`, in the instantiation its wrapper launches
    (a bath table or none; fk_label's `asym`, fk_wolff's rule "full"): how
    many clusters of that shape the card holds at once
    (cudaOccupancyMaxActiveClusters; 0 when a CTA does not fit). Cached per
    shape."""
    flags = ((int(bath), int(asym)) if kernel == "fk_label"
             else (int(rule_full), int(bath)))

    def resident(R, threads, on_chip):
        key = (kernel, str(dev), P, n, R, threads, on_chip, flags)
        if key not in _RESIDENT:
            lib = _build.library(kernel)
            count = ctypes.c_int(0)
            rc = getattr(lib, f"{kernel}_max_active_clusters")(
                P, n, R, *flags, int(on_chip), threads, ctypes.byref(count))
            _build.raise_on_error(lib, f"{kernel}_max_active_clusters", rc,
                                  error_fn=f"{kernel}_anneal_error_string")
            _RESIDENT[key] = count.value
        return _RESIDENT[key]
    return resident


_RESIDENT = {}


def card_label_geometry(kernel, chains, P, n, dev, bath=False, asym=False,
                        rule_full=False):
    """`label_geometry` of kernel "fk_label" or "fk_wolff" on the card
    `dev` (its SMs and `card_resident`), with a bath table or none,
    fk_label's `asym` (`ring_asymmetric` of the table) and fk_wolff's rule
    "full": the shape its wrapper launches."""
    asym = kernel == "fk_label" and asym
    return label_geometry(
        chains, P, n, asym, gk.card_sms(dev),
        resident=card_resident(kernel, P, n, dev, bath, asym, rule_full))


def label_shape(R, P, n, asym=False, chains=1, sms=NUM_SMS):
    """(R, threads, on_chip) of `chains` chains of P x n over R CTAs each:
    the threads and the place of the union-find that `label_geometry`
    gives with its R (the timing tools force an R through it). Threads: one
    a node, in whole warps, at most LABEL_THREADS, halved when the chains'
    CTAs outnumber the SMs and two CTAs' shared memory fit an SM
    (SM_SMEM_BYTES, a 1 KB reserve a CTA), so that they run at once (each
    kernel holds 64 registers a thread)."""
    nodes = max(P * -(-n // R), 1)
    threads = min(LABEL_THREADS, -(-nodes // 32) * 32)
    smem = label_smem_bytes(P, n, R, asym)
    on_chip = smem <= _build.SMEM_LIMIT_BYTES
    if chains * R > sms and 2 * ((smem if on_chip else
                                  label_smem_bytes(P, n, R, asym, False))
                                 + 1024) <= SM_SMEM_BYTES:
        threads = min(threads, LABEL_THREADS // 2)
    return R, threads, on_chip


def _regions(chains, P, n, R, ints, on_chip, dev):
    """The device-memory regions of the labeling core, or None on chip."""
    if on_chip:
        return None
    return torch.empty(chains * R * region_bytes(P, n, R, ints),
                       dtype=torch.uint8, device=dev)


def line_wide_bytes(P):
    """Shared memory of one warp (one line) of fk_line past P = 64
    (csrc/fk_line.cu::line_wide_bytes): its rows and next rows, P words of
    ceil(P/64) 64-bit words each, the seed's reach twice, and its spins,
    fields and cluster energies, P floats each, in whole 64-bit words."""
    W = -(-P // 64)
    return (2 * P * W + 2 * W + (3 * P + 1) // 2) * 8


def line_warps(P):
    """Warps (lines) a CTA of fk_line: LINE_WARPS up to P = 64, past it
    as many as SMEM_LIMIT_BYTES holds at `line_wide_bytes(P)` each, at most
    LINE_WARPS (0 past LINE_MAX_SLICES)."""
    if P <= 64:
        return LINE_WARPS
    return min(LINE_WARPS, _build.SMEM_LIMIT_BYTES // line_wide_bytes(P))


def ring_asymmetric(lookuptable):
    """True when the bath table `lookuptable` (P - 1,) differs from its
    reverse, lut[d - 1] != lut[P - 1 - d] somewhere: its bath pairs are
    then directed edges where one direction's bond holds
    (csrc/fk_label.cu). Every table of `schedules.bath_lookuptable` is
    symmetric."""
    return lookuptable is not None and not bool(
        (lookuptable == lookuptable.flip(0)).all())


def sw_anneal(pg, b_sched, jp, teff, confs, seed, lookuptable=None, step0=0,
              classical=False, chain0=0):
    """csrc/fk_label.cu on CUDA tensors, `cluster.sw_anneal_ref` on CPU
    tensors; arguments as for the plain version (chain0 the global index of
    the first chain, a chain shard's). Any bath table: where lut[d-1] !=
    lut[P-1-d] a bath pair may bond one way only, and the kernel relaxes
    the labels along those directed edges as the plain version's
    relaxation does. Returns the new configurations. One launch
    (LAUNCHES["fk_label"]), each chain over the cluster of
    `card_label_geometry`."""
    if _build.route(confs.device, "cluster") == "cpu":
        return cl.sw_anneal_ref(pg, b_sched, jp, teff, confs, seed,
                                lookuptable, step0, classical, chain0)
    chains, P, n = confs.shape
    dev = confs.device
    if classical and P != 1:
        raise ValueError("the classical Swendsen-Wang sweep takes P = 1")
    steps = int(b_sched.shape[0])
    graph = _check_graph(pg, dev)
    sched = _check_schedules(steps, dev, b_sched=b_sched, jp=jp, teff=teff)
    lut = _check_lut(lookuptable, P, dev)
    asym = ring_asymmetric(lookuptable)
    _build.check_arg(confs, "confs", (chains, P, pg.nspins), dev)
    out = confs.clone()
    R, threads, on_chip = card_label_geometry(
        "fk_label", chains, P, n, dev, lookuptable is not None, asym)
    regions = _regions(chains, P, n, R, 2 if asym else 1, on_chip, dev)
    lib = _build.library("fk_label")
    rc = lib.fk_label_anneal(
        *graph, _build.ptr(inv_perm(pg)), _build.ptr(boundary_sites(pg, R)),
        *sched, lut, _build.ptr(out), _opt(regions), chains, P, n,
        pg.nbr_idx.shape[1], steps, cr.wrap_int32(seed), int(step0), R,
        int(asym), threads, int(chain0), _build.stream_of(dev))
    _build.raise_on_error(lib, "fk_label_anneal", rc)
    _build.LAUNCHES["fk_label"] += 1
    return out


def houdayer_geometry(pairs, n, sms=NUM_SMS, resident=None):
    """(R, threads) of the Houdayer move's cluster kernel (csrc/
    houdayer.cu::houdayer_cluster_kernel, its union-find in shared memory)
    for `pairs` pairs of n sites: R the largest of CLUSTER_SIZES whose
    pairs x R CTAs the card's `sms` SMs hold one an SM (the bonds across
    CTAs cost more than the SMs they add: fk_label's R, which covers every
    SM, ran the move slower at 24 and 48 pairs on an H100; PERF.md §6),
    then down to the largest whose clusters `resident(R, threads)` holds
    all at once, then up to the smallest whose CTA holds its union-find in
    shared memory; `label_shape`'s threads at P = 1. None when no cluster
    of CLUSTER_MAX CTAs holds it (n past 619,152 sites): the wrappers then
    run the first kernel, one CTA a pair (LAUNCHES["houdayer_wide"])."""
    def shape(r):
        return label_shape(r, 1, n, chains=pairs, sms=sms)

    sizes = [r for r in gk.CLUSTER_SIZES if r <= max(n, 1)]
    held = [r for r in sizes if shape(r)[2]]
    if not held:
        return None
    fit = [r for r in sizes if max(pairs, 1) * r <= sms] or sizes[:1]
    R = fit[-1]
    if resident is not None:
        for r in reversed(fit):
            if r >= held[0] and resident(*shape(r)[:2]) >= pairs:
                R = r
                break
    return shape(max(R, held[0]))[:2]


def card_houdayer_geometry(pairs, n, dev):
    """`houdayer_geometry` on the card `dev`: its SMs and the clusters of
    each shape it holds at once (cudaOccupancyMaxActiveClusters, cached
    per shape)."""
    def resident(R, threads):
        key = ("houdayer", str(dev), n, R, threads)
        if key not in _RESIDENT:
            lib = _build.library("houdayer")
            count = ctypes.c_int(0)
            rc = lib.houdayer_max_active_clusters(n, R, threads,
                                                  ctypes.byref(count))
            _build.raise_on_error(lib, "houdayer_max_active_clusters", rc,
                                  error_fn="houdayer_move_error_string")
            _RESIDENT[key] = count.value
        return _RESIDENT[key]
    return houdayer_geometry(pairs, n, gk.card_sms(dev), resident)


def houdayer_table(graph):
    """(n, k) int32 on the graph's device: row id the ids of site id's
    neighbours of smaller id by a nonzero coupling in either endpoint's row
    (each once), -1 in its other slots; k the most a site has. The Houdayer
    move's cluster kernel unites each bond once, from its larger id, and
    reads no index, coupling or permutation of a slot. graph: a
    PackedGraph, or an IsingProblem whose columns are the site ids. Cached
    per graph."""
    hit = _TABLES.get(id(graph))
    if hit is not None and hit[0]() is graph:
        return hit[1]
    nbr = graph.nbr_idx.cpu().numpy().astype(np.int64)
    J = graph.nbr_J.cpu().numpy()
    n = nbr.shape[0]
    perm = (graph.perm.cpu().numpy().astype(np.int64)
            if hasattr(graph, "perm") else np.arange(n))
    a = np.broadcast_to(perm[:, None], nbr.shape)[J != 0.0]
    b = perm[nbr][J != 0.0]
    bonds = np.unique(np.stack([np.maximum(a, b), np.minimum(a, b)], 1)
                      [a != b], axis=0).reshape(-1, 2)
    # bonds sorted by their larger id: each site's row in turn
    count = np.bincount(bonds[:, 0], minlength=n)
    k = max(int(count.max(initial=0)), 1)
    col = np.arange(len(bonds)) - np.repeat(np.cumsum(count) - count, count)
    rows = np.full((n, k), -1, dtype=np.int64)
    rows[bonds[:, 0], col] = bonds[:, 1]
    out = torch.as_tensor(rows.astype(np.int32), device=graph.nbr_idx.device)
    for k in [k for k, (ref, _) in _TABLES.items() if ref() is None]:
        del _TABLES[k]
    _TABLES[id(graph)] = (weakref.ref(graph), out)
    return out


_TABLES = {}


def _houdayer_cluster(graph, inv, ror, s1, s2, flipped, pairs, n, M, seed,
                      step, geometry, pair0):
    """One launch of the Houdayer move's cluster kernel (csrc/houdayer.cu::
    houdayer_cluster_move) in place, on `graph`'s `houdayer_table` and
    `boundary_sites`; LAUNCHES["houdayer"]."""
    R, threads = geometry
    table = houdayer_table(graph)
    lib = _build.library("houdayer")
    rc = lib.houdayer_cluster_move(
        _build.ptr(table), _opt(inv), _build.ptr(boundary_sites(graph, R)),
        _opt(ror), _build.ptr(s1), _build.ptr(s2), _build.ptr(flipped),
        pairs, n, table.shape[1], M, cr.wrap_int32(seed), int(step), R,
        threads, int(pair0), _build.stream_of(s1.device))
    _build.raise_on_error(lib, "houdayer_cluster_move", rc,
                          error_fn="houdayer_move_error_string")
    _build.LAUNCHES["houdayer"] += 1


def houdayer_move(problem, s1, s2, seed, step, pair0=0):
    """csrc/houdayer.cu on CUDA tensors, `cluster.houdayer_move_ref` on CPU
    tensors: one Houdayer move of the (pairs, N) replicas s1, s2 (sites in
    the IsingProblem's own order; a lattice's to_generic()) on the coins of
    the HOUDAYER stream at `step`, the pairs counted from pair0 (a rung
    block of a sharded ladder moves the whole ladder's pairs of its
    rungs). Returns (s1', s2', flipped (pairs,) int32), new tensors. One
    launch: the cluster kernel over `card_houdayer_geometry`'s R CTAs a
    pair (LAUNCHES["houdayer"]), or where no cluster holds a pair the
    first kernel, one CTA a pair (LAUNCHES["houdayer_wide"])."""
    if _build.route(s1.device, "cluster") == "cpu":
        return cl.houdayer_move_ref(problem, s1, s2, seed, step, pair0)
    pairs, n = s1.shape
    dev = s1.device
    maxnb = problem.nbr_idx.shape[1]
    _build.check_arg(problem.nbr_idx, "nbr_idx", (n, maxnb), dev,
                     torch.int32)
    _build.check_arg(problem.nbr_J, "nbr_J", (n, maxnb), dev)
    a, b = s1.clone(), s2.clone()
    _build.check_arg(a, "s1", (pairs, problem.nspins), dev)
    _build.check_arg(b, "s2", (pairs, problem.nspins), dev)
    flipped = torch.empty(pairs, dtype=torch.int32, device=dev)
    geometry = card_houdayer_geometry(pairs, n, dev)
    if geometry is not None:
        _houdayer_cluster(problem, None, None, a, b, flipped, pairs, n, 1,
                          seed, step, geometry, pair0)
        return a, b, flipped
    smem = n * 4 <= HOUDAYER_SMEM_BYTES
    parent = None if smem else torch.empty((pairs, n), dtype=torch.int32,
                                           device=dev)
    lib = _build.library("houdayer")
    rc = lib.houdayer_move(
        _build.ptr(problem.nbr_idx), _build.ptr(problem.nbr_J),
        _build.ptr(a), _build.ptr(b), _build.ptr(flipped),
        None if parent is None else _build.ptr(parent), pairs, n, maxnb,
        cr.wrap_int32(seed), int(step), int(smem), HOUDAYER_THREADS,
        int(pair0), _build.stream_of(dev))
    _build.raise_on_error(lib, "houdayer_move", rc)
    _build.LAUNCHES["houdayer_wide"] += 1
    return a, b, flipped


def rung_labels(ror):
    """(..., M) replica_of_rung -> rung_of_replica, its inverse."""
    M = ror.shape[-1]
    lab = torch.empty_like(ror)
    lab.scatter_(-1, ror, torch.arange(M, device=ror.device).expand_as(ror))
    return lab


def rung_ordered(x, ror):
    """x (..., M, ...) by replica -> by rung: out[..., m] = x[..., ror[m]]."""
    idx = ror.reshape(ror.shape + (1,) * (x.dim() - ror.dim()))
    return torch.gather(x, ror.dim() - 1, idx.expand(ror.shape + x.shape[
        ror.dim():]))


def houdayer_rungs(move, full, ror):
    """The Houdayer move's rung layout on replicas in site order: full (B *
    2 * M, n) by replica, B ladder pairs of two ladders of M replicas, ror
    (B, 2, M) replica_of_rung; pair b M + m is (ladder 0's replica at rung
    m, ladder 1's). `move(s1, s2)` moves the (B M, n) pairs and returns
    (s1', s2', flipped). Returns (the moved replicas (B * 2 * M, n) by
    replica, flipped)."""
    batch = tuple(ror.shape[:-2])
    M = ror.shape[-1]
    n = full.shape[-1]
    r = rung_ordered(full.reshape(batch + (2, M, n)), ror)
    a, b, flipped = move(r[..., 0, :, :].reshape(-1, n).contiguous(),
                         r[..., 1, :, :].reshape(-1, n).contiguous())
    new = torch.stack([a.reshape(batch + (M, n)), b.reshape(batch + (M, n))],
                      dim=-3)
    return rung_ordered(new, rung_labels(ror)).reshape(-1, n), flipped


def _move_unpacked(move, problem, pg, state, ror, seed, step, pair0):
    """The packed engine's state unpacked to site order, `move`
    (houdayer_move or its plain version) on `problem` by `houdayer_rungs`,
    the state repacked."""
    full, flipped = houdayer_rungs(
        lambda s1, s2: move(problem, s1, s2, seed, step, pair0),
        packed_ops.unpack_state(pg, state), ror)
    return packed_ops.pack_state(pg, full).contiguous(), flipped


def houdayer_move_packed_ref(problem, pg, state, ror, seed, step, pair0=0):
    """`houdayer_move_packed`'s plain version, on any device: the state
    unpacked to site order, `cluster.houdayer_move_ref` on `problem` (the
    site-order IsingProblem pg packs), the state repacked, as ICM moved
    the packed engine's replicas before the move ran in place. Returns
    (the new state, flipped (pairs,) int32)."""
    return _move_unpacked(cl.houdayer_move_ref, problem, pg, state, ror,
                          seed, step, pair0)


def houdayer_move_packed(problem, pg, state, ror, seed, step, pair0=0):
    """One Houdayer move of every rung-aligned pair on the packed engine's
    state (solvers/_engines.py::ClassicalEngine, kind "packed"): state
    (B * 2 * M, N) float32 in PackedGraph pg's column order, B ladder
    pairs of two ladders of M replicas; ror (B, 2, M) replica_of_rung;
    pair b M + m is ladder 0's replica ror[b, 0, m] and ladder 1's ror[b,
    1, m]; `problem` the site-order IsingProblem pg packs (the coins and
    labels count site ids, pg.perm's). On CUDA tensors the cluster kernel
    moves the state in place through ror and pg.perm, no unpack or repack
    (LAUNCHES["houdayer"]); where no cluster holds a pair, the first kernel
    on the unpacked replicas (LAUNCHES["houdayer_wide"]); on CPU tensors
    `houdayer_move_packed_ref`. Returns (state, flipped (pairs,) int32),
    bitwise the plain version's."""
    if _build.route(state.device, "cluster") == "cpu":
        return houdayer_move_packed_ref(problem, pg, state, ror, seed, step,
                                        pair0)
    chains, n = state.shape
    dev = state.device
    M = ror.shape[-1]
    pairs = ror.numel() // 2
    if ror.shape[-2] != 2 or chains != 2 * pairs:
        raise ValueError(f"ror {tuple(ror.shape)} does not pair the "
                         f"{chains} chains of the state")
    ror = ror.contiguous()
    _build.check_arg(ror, "ror", tuple(ror.shape), dev, torch.int64)
    _build.check_arg(state, "state", (chains, pg.nspins), dev)
    _check_graph(pg, dev)
    geometry = card_houdayer_geometry(pairs, n, dev)
    if geometry is None:
        # the first kernel takes replicas in site order
        return _move_unpacked(houdayer_move, problem, pg, state, ror, seed,
                              step, pair0)
    flipped = torch.empty(pairs, dtype=torch.int32, device=dev)
    _houdayer_cluster(pg, inv_perm(pg), ror, state, state, flipped, pairs, n,
                      M, seed, step, geometry, pair0)
    return state, flipped


def line_tables(lookuptable, jp, teff, P, device):
    """(p_pair (P, P), p_t (steps,)): the bath pairs' and the Trotter
    bonds' FK probabilities (`cluster.pair_prob`, `trotter_prob`), computed
    once an anneal and read by fk_line as its plain version computes
    them."""
    return (cl.pair_prob(lookuptable, P, device).contiguous(),
            cl.trotter_prob(jp, teff).contiguous())


def line_smem_bytes(P, nr, warps, improper=False):
    """Shared memory of one CTA of fk_line's cluster kernel (csrc/
    fk_line.cu::line_smem_bytes): the head, its nr slots' 64-bit words
    (twice on a packing that is not proper: the phase's snapshot), each
    warp's scratch, and the bonds' thresholds, P x P uint32."""
    return (LINE_HEAD_BYTES + 8 * nr * (2 if improper else 1)
            + warps * LINE_WARP_BYTES + 4 * P * P)


def line_slots(sizes, R):
    """(nr, threads) of fk_line's cluster kernel over R CTAs on classes of
    `sizes` lines: nr = sum_c ceil(n_c / R) slots a CTA (`gk.word_layout`),
    a warp a line of the largest class chunk, at most LINE_THREADS."""
    chunks = [-(-int(c) // R) for c in sizes]
    return sum(chunks), min(LINE_THREADS, 32 * max(max(chunks, default=1), 1))


def line_geometry(chains, P, sizes, sms=NUM_SMS, resident=None,
                  improper=False):
    """(R, threads) of fk_line's cluster kernel for `chains` chains of P
    slices on color classes of `sizes` lines (improper: a packing that is
    not proper, whose CTAs also hold the phase's snapshot): each chain over
    a cluster of R CTAs, R first by fk_label's rule of the card's `sms` SMs
    (`label_geometry`: 8 chains on 132 SMs take 16), raised to the smallest
    whose CTA holds its words (`line_smem_bytes`), then down to the largest
    whose clusters `resident(R, threads)` holds all at once (the wrapper
    passes the card's cudaOccupancyMaxActiveClusters); `line_slots`
    threads. None for P past LINE_WORD_SLICES (a line is one 64-bit word)
    and where no cluster of CLUSTER_MAX CTAs holds a chain's words (two
    classes: n past 382,208 lines at P = 40, 362,240 at P = 64), or a CTA
    more than 65,535 slots: `line_anneal` then runs `line_phase`, one
    launch a color phase."""
    n = int(sum(sizes))
    if not 2 <= P <= LINE_WORD_SLICES or n == 0:
        return None

    def fits(r):
        nr, threads = line_slots(sizes, r)
        return nr < 65536 and line_smem_bytes(
            P, nr, threads // 32, improper) <= _build.SMEM_LIMIT_BYTES

    chains = max(chains, 1)
    top = min(CLUSTER_MAX, n)
    R = max(1, sms // chains)
    if chains * R * 4 < 3 * sms:
        R += 1
    R = min(R, top)
    while R <= top and not fits(R):
        R += 1
    if R > top:
        return None
    if resident is not None:
        for r in range(R, 0, -1):
            if fits(r) and resident(r, line_slots(sizes, r)[1]) >= chains:
                return r, line_slots(sizes, r)[1]
    return R, line_slots(sizes, R)[1]


def card_line_geometry(pg, chains, P, dev, per_slice_seeds):
    """`line_geometry` of PackedGraph pg on the card `dev`: its SMs and
    the clusters of the instantiation (WC3 or WC2) it holds at once.
    Cached per shape."""
    sizes = np.diff(pg.starts)
    improper = not pg.proper

    def resident(R, threads):
        nr = line_slots(sizes, R)[0]
        key = ("fk_line", str(dev), P, nr, R, threads, improper,
               bool(per_slice_seeds))
        if key not in _RESIDENT:
            lib = _build.library("fk_line")
            count = ctypes.c_int(0)
            rc = lib.fk_line_max_active_clusters(
                P, nr, R, threads, int(improper), int(bool(per_slice_seeds)),
                ctypes.byref(count))
            _build.raise_on_error(lib, "fk_line_max_active_clusters", rc,
                                  error_fn="fk_line_phase_error_string")
            _RESIDENT[key] = count.value
        return _RESIDENT[key]
    return line_geometry(chains, P, sizes, gk.card_sms(dev), resident,
                         improper)


def line_anneal_ref(pg, b_sched, jp, p_t, teff, lookuptable, p_pair, confs,
                    seed, per_slice_seeds, t0=0, steps=None, colors=None,
                    step0=None, chain0=0):
    """`line_anneal`'s plain version: `cluster.line_phase_ref` phase after
    phase, the classes `colors` (default every class) of each step t = t0
    .. t0 + steps - 1 at schedule index t (B_t, J_perp_t) on the draws of
    hash step step0 + t - t0 (step0 default t0)."""
    steps = int(b_sched.shape[0]) - t0 if steps is None else steps
    colors = range(pg.num_colors) if colors is None else colors
    step0 = t0 if step0 is None else step0
    for t in range(t0, t0 + steps):
        for color in colors:
            confs = cl.line_phase_ref(pg, b_sched[t], jp[t], teff,
                                      lookuptable, confs, seed,
                                      step0 + t - t0, color, per_slice_seeds,
                                      p_pair, chain0)
    return confs


def line_anneal(pg, b_sched, jp, p_t, teff, lookuptable, p_pair, confs,
                seed, per_slice_seeds, t0=0, steps=None, colors=None,
                step0=None, chain0=0):
    """The line phases of the classes `colors` (a range; default every
    class) of the steps t0 .. t0 + steps - 1 (default to the schedules'
    end), schedule index t, hash step step0 + t - t0 (step0 default t0), of
    packed confs (chains, P, N): csrc/fk_line.cu on CUDA tensors,
    `line_anneal_ref` on CPU tensors; the other arguments as for
    `line_phase`. Returns the new configurations. At P <= 64, where
    `card_line_geometry` finds a cluster, one launch (LAUNCHES["fk_line"]):
    the chain's words in the cluster's shared memory from the first phase
    to the last; elsewhere (P > 64, or a chain no cluster holds) one
    `line_phase` launch a phase."""
    if _build.route(confs.device, "cluster") == "cpu":
        return line_anneal_ref(pg, b_sched, jp, p_t, teff, lookuptable,
                               p_pair, confs, seed, per_slice_seeds, t0,
                               steps, colors, step0, chain0)
    steps = int(b_sched.shape[0]) - t0 if steps is None else steps
    colors = range(pg.num_colors) if colors is None else colors
    step0 = t0 if step0 is None else step0
    chains, P, n = confs.shape
    dev = confs.device
    geometry = card_line_geometry(pg, chains, P, dev, per_slice_seeds)
    if geometry is None:
        for t in range(t0, t0 + steps):
            for color in colors:
                confs = line_phase(pg, b_sched, jp, p_t, t, teff,
                                   lookuptable, p_pair, confs, seed,
                                   step0 + t - t0, color, per_slice_seeds,
                                   chain0)
        return confs
    if not 0 <= t0 <= t0 + steps <= int(b_sched.shape[0]) or \
            not (len(colors) == 0 or
                 0 <= colors.start <= colors.stop <= pg.num_colors) or \
            colors.step != 1:
        raise ValueError(f"steps {t0} .. {t0 + steps} and classes {colors} "
                         f"must lie in the schedules and the "
                         f"{pg.num_colors} classes")
    R, threads = geometry
    nbr_idx, nbr_J, h, perm, starts = gk._check_graph(pg, dev)
    sched = _check_schedules(int(b_sched.shape[0]), dev, b_sched=b_sched,
                             jp=jp, p_t=p_t)
    _build.check_arg(p_pair, "p_pair", (P, P), dev)
    _build.check_arg(confs, "confs", (chains, P, pg.nspins), dev)
    _, slot_starts, nbr_loc, nr = gk.word_layout(pg, R)
    out = torch.empty_like(confs)
    lib = _build.library("fk_line")
    rc = lib.fk_line_anneal(
        _build.ptr(slot_starts), starts, _build.ptr(nbr_loc), nbr_J, h, perm,
        *sched, _build.ptr(p_pair), ctypes.c_float(teff), _build.ptr(confs),
        _build.ptr(out), chains, P, n, pg.nbr_idx.shape[1], R, nr, threads,
        int(t0), int(step0), int(steps), colors.start, colors.stop,
        cr.wrap_int32(seed), int(bool(per_slice_seeds)), int(not pg.proper),
        int(chain0), _build.stream_of(dev))
    _build.raise_on_error(lib, "fk_line_anneal", rc,
                          error_fn="fk_line_phase_error_string")
    _build.LAUNCHES["fk_line"] += 1
    return out


def line_phase(pg, b_sched, jp, p_t, t, teff, lookuptable, p_pair, confs,
               seed, step, color, per_slice_seeds, chain0=0):
    """csrc/fk_line.cu's per-phase kernels on CUDA tensors,
    `cluster.line_phase_ref` on CPU tensors: the line phase of class
    `color` at schedule index t (B_t, J_perp_t and the Trotter probability
    p_t[t]) on the draws of `step`, T_eff = `teff` (a Python float), the
    chains counted from chain0 (a chain shard's first). Returns the new
    configurations. One launch: at P <= 64 the first kernel, one warp a
    line (LAUNCHES["fk_line_wide"]), past P = 64 the kernel whose rows sit
    in shared memory (LAUNCHES["fk_line_rows"]); P <= LINE_MAX_SLICES on
    the card (ValueError beyond). `line_anneal` calls it where its cluster
    kernel takes no shape."""
    if _build.route(confs.device, "cluster") == "cpu":
        return cl.line_phase_ref(pg, b_sched[t], jp[t], teff, lookuptable,
                                 confs, seed, step, color, per_slice_seeds,
                                 p_pair, chain0)
    chains, P, n = confs.shape
    dev = confs.device
    if P > LINE_MAX_SLICES:
        raise ValueError(f"fk_line takes P <= {LINE_MAX_SLICES} (one line's "
                         f"bond rows in a CTA's shared memory), got {P}")
    steps = int(b_sched.shape[0])
    graph = gk._check_graph(pg, dev)  # with the class starts
    sched = _check_schedules(steps, dev, b_sched=b_sched, jp=jp, p_t=p_t)
    _build.check_arg(p_pair, "p_pair", (P, P), dev)
    _build.check_arg(confs, "confs", (chains, P, pg.nspins), dev)
    out = confs.clone()
    lib = _build.library("fk_line")
    rc = lib.fk_line_phase(
        *graph, *sched, _build.ptr(p_pair),
        ctypes.c_float(teff), _build.ptr(out), chains, P, n,
        pg.nbr_idx.shape[1], int(t), int(step), int(color),
        pg.starts[color + 1] - pg.starts[color], cr.wrap_int32(seed),
        int(bool(per_slice_seeds)), line_warps(P), int(chain0),
        _build.stream_of(dev))
    _build.raise_on_error(lib, "fk_line_phase", rc)
    _build.LAUNCHES["fk_line_wide" if P <= LINE_WORD_SLICES
                    else "fk_line_rows"] += 1
    return out


# ------------------------------------------------------ problem-level anneals


def generic_form(problem):
    """An IsingProblem for the cluster engines: a LatticeProblem's
    to_generic(), as the JAX solvers convert it; an IsingProblem as it
    is. Raises ValueError on anything else."""
    if isinstance(problem, LatticeProblem):
        return problem.to_generic()
    if not packed_ops.supports_packed(problem):
        raise ValueError("the cluster engines take an IsingProblem or a "
                         "LatticeProblem")
    return problem


def _packed_lines(pg, confs, P):
    """(..., P, N) confs as contiguous float32 (rows, P, N) packed; P = 1
    takes (..., N) spins."""
    return packed_ops.pack_state(
        pg, confs.to(torch.float32).reshape(-1, P, pg.nspins)).contiguous()


def _unpacked(pg, c, shape):
    return packed_ops.unpack_state(pg, c).reshape(shape)


def classical_anneal(problem, sched, spins, seed, mcsteps=1, kind="wolff",
                     local_sweeps=True, chain0=0):
    """Classical cluster anneal of an IsingProblem (JAX sa.anneal_wolff /
    anneal_sw): kind "wolff" one Wolff cluster a chain and step (P = 1, J_perp
    = 0: Gamma = inf, B = 1, T_eff = T), "sw" one Swendsen-Wang sweep; with
    `local_sweeps` a colored Metropolis sweep (csrc/packed_sa.cu) before
    each. sched: (steps,) temperatures; spins: (..., N) float32 +/-1 on the
    problem's device; chain0: the global index of the first chain (a chain
    shard), which every launch's draws count from. Returns the annealed
    spins."""
    pg = gk._graph_of(problem, spins, "spins")
    temps = schedules.expand_mcsteps(sched, mcsteps, problem.device)
    ones = torch.ones_like(temps)
    zeros = torch.zeros_like(temps)
    c = _packed_lines(pg, spins, 1)
    chains = c.shape[0]

    def cluster(c, sl, step0):
        if kind == "wolff":
            return wolff_anneal(pg, ones[sl], zeros[sl], temps[sl], c, seed,
                                step0=step0, chain0=chain0)
        return sw_anneal(pg, ones[sl], zeros[sl], temps[sl], c, seed,
                         step0=step0, classical=True, chain0=chain0)

    if not local_sweeps:
        c = cluster(c, slice(None), 0)
    else:
        for t in range(temps.shape[0]):
            s = gk.packed_sa_anneal(pg, temps[t:t + 1], c.view(chains, -1),
                                    seed, step0=t, chain0=chain0)
            c = cluster(s.view(chains, 1, -1), slice(t, t + 1), t)
    return _unpacked(pg, c, spins.shape)


def qmc_cluster_anneal(problem, a_sched, b_sched, temp, confs, seed,
                       mcsteps=1, kind="wolff", rule="local",
                       lookuptable=None, local_sweeps=False, chain0=0):
    """PIQMC cluster anneal of an IsingProblem (JAX qmc.anneal_wolff /
    anneal_sw): kind "wolff" one cluster a chain and step (rule "local" or
    "full"), "sw" one space-time Swendsen-Wang sweep, optional bath bonds
    from `lookuptable`; with `local_sweeps` (kind "sw") a space-time local
    sweep (csrc/generic_qmc.cu, no line moves) before each. confs: (...,
    P, N) float32 +/-1 on the problem's device; chain0: the global index of
    the first chain (a chain shard). Returns the annealed
    configurations."""
    pg = gk._graph_of(problem, confs, "confs")
    P = confs.shape[-2]
    b, jp, teff = schedules.qmc_terms(a_sched, b_sched, temp, P, mcsteps,
                                      problem.device)
    teffs = torch.full_like(b, teff)
    lut = None if lookuptable is None else torch.as_tensor(
        lookuptable, dtype=torch.float32, device=problem.device).contiguous()
    c = _packed_lines(pg, confs, P)

    def cluster(c, sl, step0):
        if kind == "wolff":
            return wolff_anneal(pg, b[sl], jp[sl], teffs[sl], c, seed, rule,
                                lut, step0, chain0=chain0)
        return sw_anneal(pg, b[sl], jp[sl], teffs[sl], c, seed, lut, step0,
                         chain0=chain0)

    if not local_sweeps:
        c = cluster(c, slice(None), 0)
    else:
        for t in range(b.shape[0]):
            c = gk.generic_qmc_anneal(pg, b[t:t + 1], jp[t:t + 1], teff, c,
                                      seed, False, step0=t, chain0=chain0)
            c = cluster(c, slice(t, t + 1), t)
    return _unpacked(pg, c, confs.shape)


def sw_bath_anneal(problem, a_sched, b_sched, temp, lookuptable, confs, seed,
                   mcsteps=1, per_slice_seeds=True, local_sweeps=True,
                   chain0=0):
    """Dissipative anneal with bath-bond line clusters (JAX
    qmc.anneal_sw_bath, WC2 / WC3) of an IsingProblem: each step, with
    `local_sweeps` and not `per_slice_seeds`, a dissipative local sweep
    (csrc/generic_qmc_bath.cu, sequential, no line moves), then the line
    phase of each color class (`line_anneal`: every step's in one launch
    where no local sweep interleaves, else the step's). confs: (..., P,
    N), P >= 2; chain0: the global index of the first chain (a chain
    shard). Returns the annealed configurations."""
    pg = gk._graph_of(problem, confs, "confs")
    P = confs.shape[-2]
    dev = problem.device
    bath = piqmc_ops.bath_matrix_of(lookuptable, P, dev)
    lut = torch.as_tensor(lookuptable, dtype=torch.float32,
                          device=dev).contiguous()
    b, jp, teff = schedules.qmc_terms(a_sched, b_sched, temp, P, mcsteps,
                                      dev)
    p_pair, p_t = line_tables(lut, jp, teff, P, dev)
    c = _packed_lines(pg, confs, P)
    if not (local_sweeps and not per_slice_seeds):
        c = line_anneal(pg, b, jp, p_t, teff, lut, p_pair, c, seed,
                        per_slice_seeds, chain0=chain0)
        return _unpacked(pg, c, confs.shape)
    for t in range(b.shape[0]):
        c = gk.generic_qmc_bath_anneal(pg, b[t:t + 1], jp[t:t + 1], teff,
                                       bath, c, seed, False, step0=t,
                                       chain0=chain0)
        c = line_anneal(pg, b, jp, p_t, teff, lut, p_pair, c, seed,
                        per_slice_seeds, t0=t, steps=1, chain0=chain0)
    return _unpacked(pg, c, confs.shape)


# ------------------------------------ the Trotter-sharded rounds (S6, S7)


class ShardStep:
    """One step of one rank of the Trotter-sharded cluster engines
    (parallel/trotter.py): what every launch of the step reads, and the
    scratch kept from its first launch to its last.

    pg: the PackedGraph; s (Ps, N) float32 +/-1, the rank's rows k0 .. k0
    + Ps - 1 of a (P, N) chain in packed order (flipped in place by the
    card's flip); up, dn (N,), rows k0 - 1 and k0 + Ps (the ring's halo
    rows; on a ring of one rank the block's last and first rows
    themselves); full (P, N), every rank's rows, with a bath, else None;
    b_sched, jp: float32 (steps,) schedules, read at step t; teff: P*T, a
    Python float; seed: the hash seed; lookuptable: a contiguous float32
    (P-1,) tensor or None; rule: the Wolff rule; kval: the seed spin, a
    float32 (1,) tensor (rule "full"); asym: the table is not symmetric in
    ring distance (`ring_asymmetric`, asked once an anneal), so S7 keeps
    its one-way bath pairs as directed edges."""

    def __init__(self, pg, s, up, dn, full, k0, slices, b_sched, jp, teff, t,
                 seed, lookuptable=None, rule="local", kval=None,
                 asym=False):
        self.pg, self.s, self.up, self.dn, self.full = pg, s, up, dn, full
        self.k0, self.slices, self.b_sched, self.jp = k0, slices, b_sched, jp
        self.teff, self.t, self.seed = teff, t, seed
        self.lut, self.rule, self.kval = lookuptable, rule, kval
        self.asym = bool(asym) and lookuptable is not None
        self.bonds = None  # the plain version's bonds, drawn once a step
        self.scratch = None  # the kernel's buffers
        self.cpu = _build.route(s.device, "shard") == "cpu"
        self.words = -(-s.numel() // 32)


def shard_label_smem_bytes(P, Ps, n, R, on_chip=True):
    """Shared memory of one CTA of S7's draw over a cluster (csrc/
    fk_shard.cu::shard_draw_smem_bytes): the head, the bath's two rows of
    P floats (P the chain's slices), and with `on_chip` the CTA's region
    of the union-find, Ps ceil(n / R) nodes of the block's Ps rows, 6
    bytes a node (a parent and two flag bytes) in whole words."""
    return (LABEL_HEAD_BYTES + 8 * P
            + (region_bytes(Ps, n, R, 1) if on_chip else 0))


def shard_label_threads(Ps, n, R):
    """Threads a CTA of S7's draw and rounds: one a node of its Ps ceil(n /
    R), in whole warps, at most LABEL_THREADS."""
    return min(LABEL_THREADS, -(-max(Ps * -(-n // R), 1) // 32) * 32)


def shard_label_shape(P, Ps, n, R):
    """(R, threads, on_chip) of S7's draw over R CTAs: on_chip while a
    CTA's region of the union-find fits SMEM_LIMIT_BYTES beside the head
    and the bath's rows (`shard_label_smem_bytes`: at P = 40 and R = 16
    an n up to 15,456 at one rank, 154,576 on a slab of 4 rows), else the
    regions live in device memory and the block is still spread over R
    CTAs."""
    return (R, shard_label_threads(Ps, n, R),
            shard_label_smem_bytes(P, Ps, n, R) <= _build.SMEM_LIMIT_BYTES)


def shard_label_geometry(P, Ps, n, sms=NUM_SMS, resident=None):
    """(R, threads, on_chip) of S7's draw (csrc/fk_shard.cu::
    fk_shard_draw_kernel) on a rank's block of Ps rows of n sites of a
    P-slice chain: the block over a cluster of R CTAs, CTA r owning the
    r-th chunk of ceil(n / R) sites in every row (`shard_label_shape`).
    R is `label_geometry`'s for the one chain: the most CTAs, at most 16
    and at most n; then, with `resident(R, threads, on_chip)` (the wrapper
    passes the card's cudaOccupancyMaxActiveClusters; None: any number),
    down to the largest the card holds, or, if none is held, the first.
    The rounds run over the same R."""
    top = min(CLUSTER_MAX, max(n, 1), max(sms, 1))
    if resident is not None:
        for r in range(top, 0, -1):
            shape = shard_label_shape(P, Ps, n, r)
            if resident(*shape) >= 1:
                return shape
    return shard_label_shape(P, Ps, n, top)


def card_shard_label_geometry(P, Ps, n, dev, bath):
    """`shard_label_geometry` on the card `dev`: its SMs, and how many
    clusters of each shape of the draw (with a bath table or none) it
    holds at once (`fk_shard_label_max_active_clusters`). Cached per
    shape."""
    def resident(R, threads, on_chip):
        key = ("fk_shard", str(dev), P, Ps, n, R, threads, on_chip,
               bool(bath))
        if key not in _RESIDENT:
            lib = _build.library("fk_shard")
            count = ctypes.c_int(0)
            rc = lib.fk_shard_label_max_active_clusters(
                P, Ps, n, R, int(bool(bath)), int(on_chip), threads,
                ctypes.byref(count))
            _fk_shard(lib, "fk_shard_label_max_active_clusters", rc)
            _RESIDENT[key] = count.value
        return _RESIDENT[key]
    return shard_label_geometry(P, Ps, n, gk.card_sms(dev), resident)


def _fk_shard(lib, fn, rc):
    _build.raise_on_error(lib, fn, rc, error_fn="fk_shard_error_string")


def _shard_args(st):
    """The launch's common pointers, once they are checked."""
    dev = st.s.device
    ps, n = st.s.shape
    graph = _check_graph(st.pg, dev)
    _build.check_arg(st.s, "s", (ps, st.pg.nspins), dev)
    for name, x in (("up", st.up), ("dn", st.dn)):
        if x.device != dev or x.dtype != torch.float32 or \
                tuple(x.shape) != (n,) or x.stride(0) != 1:
            raise ValueError(f"halo row {name} must be a float32 ({n},) row "
                             f"with unit stride on {dev}")
    if st.full is not None:
        _build.check_arg(st.full, "full", (st.slices, n), dev)
    for name, x in (("b_sched", st.b_sched), ("jp", st.jp)):
        if x.dim() != 1 or st.t >= x.shape[0]:
            raise ValueError(f"{name} must be a (steps,) schedule with step "
                             f"{st.t}")
        _build.check_arg(x, name, tuple(x.shape), dev)
    lut = _check_lut(st.lut, st.slices, dev)
    return graph, lut


def _opt(x):
    return None if x is None else _build.ptr(x)


def shard_wolff_round_ref(st, visited, in_prev, in_next, full_fresh,
                          seed_x=-1):
    """`shard_wolff_round`'s plain version, on any device: `cluster.
    wolff_shard_round_ref` on the bonds of `cluster.wolff_shard_bonds`
    (drawn at the step's first round), the bits packed as the kernel's."""
    ps, n = st.s.shape
    prob = st.pg.as_problem()
    if st.bonds is None:
        st.bonds = cl.wolff_shard_bonds(
            prob, st.s, st.up, st.dn, st.full, st.kval, st.k0, st.slices,
            st.b_sched[st.t], st.jp[st.t], st.teff, st.rule, st.lut,
            st.seed, st.t, st.pg.perm)
    ff = None
    if full_fresh is not None:
        ff = cl.unpack_bits(full_fresh.reshape(-1, st.words),
                            ps * n).reshape(st.slices, n)
    vis, fresh, up, dn, changed = cl.wolff_shard_round_ref(
        prob, st.bonds, cl.unpack_bits(visited, ps * n).reshape(ps, n),
        in_prev.bool(), in_next.bool(), ff, st.k0, st.slices, seed_x)
    return (cl.pack_bits(vis.reshape(-1)), cl.pack_bits(fresh.reshape(-1)),
            up.to(torch.uint8), dn.to(torch.uint8),
            torch.tensor([int(changed)], dtype=torch.int32,
                         device=st.s.device))


def shard_wolff_round(st, visited, in_prev, in_next, full_fresh, seed_x=-1):
    """S6's round on CUDA tensors (csrc/fk_shard.cu::fk_shard_wolff, mode
    0, one launch, `visited` updated in place), `shard_wolff_round_ref` on
    CPU tensors. visited: (W,) int32 bits of the block's Ps * N sites;
    in_prev, in_next: (N,) uint8; full_fresh: (R * W,) int32, every rank's
    fresh bits in rank order, or None. Returns (visited, fresh (W,) int32,
    out_up (N,) uint8, out_dn (N,) uint8, changed (1,) int32).
    LAUNCHES["shard_wolff"]."""
    ps, n = st.s.shape
    if st.cpu:
        return shard_wolff_round_ref(st, visited, in_prev, in_next,
                                     full_fresh, seed_x)
    dev = st.s.device
    graph, lut = _shard_args(st)
    _build.check_arg(visited, "visited", (st.words,), dev, torch.int32)
    for name, x in (("in_prev", in_prev), ("in_next", in_next)):
        _build.check_arg(x, name, (n,), dev, torch.uint8)
    if full_fresh is not None:
        _build.check_arg(full_fresh, "full_fresh",
                         (st.slices // ps * st.words,), dev, torch.int32)
    if st.rule == "full":
        _build.check_arg(st.kval, "kval", (1,), dev)
    if st.scratch is None:
        st.scratch = torch.empty(2 * ps * n, dtype=torch.int32, device=dev)
    fresh = torch.empty(st.words, dtype=torch.int32, device=dev)
    out_up = torch.zeros(n, dtype=torch.uint8, device=dev)
    out_dn = torch.zeros(n, dtype=torch.uint8, device=dev)
    changed = torch.empty(1, dtype=torch.int32, device=dev)
    _launch_wolff(st, graph, lut, 0, visited, fresh, st.scratch, in_prev,
                  in_next, full_fresh, out_up, out_dn, changed, None, None,
                  seed_x)
    return visited, fresh, out_up, out_dn, changed


def _launch_wolff(st, graph, lut, mode, visited, fresh, queue, in_prev,
                  in_next, full_fresh, out_up, out_dn, changed, rows_full,
                  rows_out, seed_x=-1):
    ps, n = st.s.shape
    lib = _build.library("fk_shard")
    rc = lib.fk_shard_wolff(
        *graph, _build.ptr(st.b_sched), _build.ptr(st.jp), lut,
        _build.ptr(st.s), _build.ptr(st.up), _build.ptr(st.dn),
        _opt(st.full), _opt(st.kval if st.rule == "full" else None),
        _build.ptr(visited), *map(_opt, (
            fresh, queue, in_prev, in_next, full_fresh, out_up, out_dn,
            changed, rows_full, rows_out)),
        ctypes.c_float(st.teff), ps, n, st.pg.nbr_idx.shape[1], st.slices,
        int(st.k0), int(seed_x), int(st.t), cr.wrap_int32(st.seed),
        int(st.rule == "full"), int(mode), _build.stream_of(st.s.device))
    _fk_shard(lib, "fk_shard_wolff", rc)
    _build.LAUNCHES["shard_wolff"] += 1


def shard_wolff_sums_ref(st, visited):
    """`shard_wolff_sums`' plain version, on any device."""
    ps, n = st.s.shape
    return cl.wolff_shard_sums_ref(
        st.pg.as_problem(), st.s,
        cl.unpack_bits(visited, ps * n).reshape(ps, n))


def shard_wolff_sums(st, visited):
    """S6's field sums on CUDA tensors (fk_shard_wolff mode 1, one
    launch), `cluster.wolff_shard_sums_ref` on CPU tensors: (Ps,) float32,
    each row's h_i s_i over its cluster sites in index order."""
    if st.cpu:
        return shard_wolff_sums_ref(st, visited)
    ps = st.s.shape[0]
    graph, lut = _shard_args(st)
    rows = torch.empty(ps, dtype=torch.float32, device=st.s.device)
    _launch_wolff(st, graph, lut, 1, visited, None, None, None, None, None,
                  None, None, None, None, rows)
    return rows


def shard_wolff_flip_ref(st, visited, rows_full):
    """`shard_wolff_flip`'s plain version, on any device (a new tensor)."""
    ps, n = st.s.shape
    return cl.wolff_shard_flip_ref(
        st.s, cl.unpack_bits(visited, ps * n).reshape(ps, n), rows_full,
        st.b_sched[st.t], st.teff, st.seed, st.t, st.rule)


def shard_wolff_flip(st, visited, rows_full):
    """S6's flip on CUDA tensors (fk_shard_wolff mode 2, one launch, the
    rows flipped in place), `cluster.wolff_shard_flip_ref` on CPU tensors:
    rows_full (P,) float32, every rank's `shard_wolff_sums` in slice order,
    or None (no field term). Returns the rows."""
    if st.cpu:
        return shard_wolff_flip_ref(st, visited, rows_full)
    graph, lut = _shard_args(st)
    if rows_full is not None:
        _build.check_arg(rows_full, "rows_full", (st.slices,), st.s.device)
    _launch_wolff(st, graph, lut, 2, visited, None, None, None, None, None,
                  None, None, None, rows_full, None)
    return st.s


def shard_label_init_ref(st):
    """`shard_label_init`'s plain version, on any device."""
    prob = st.pg.as_problem()
    st.bonds = cl.sw_shard_bonds(
        prob, st.s, st.dn, st.full, st.k0, st.slices, st.b_sched[st.t],
        st.jp[st.t], st.teff, st.lut, st.seed, st.t, st.pg.perm)
    labels = cl.sw_shard_init_ref(prob, st.bonds, st.k0, st.slices)
    return labels.to(torch.int32), st.bonds[1][-1].to(torch.uint8)


def shard_label_init(st):
    """S7's first launch of a step on CUDA tensors (the draw, the block's
    union-find and labels), `cluster.sw_shard_bonds` and
    `sw_shard_init_ref` on CPU tensors. Returns (labels (Ps, N) int32,
    bond_dn (N,) uint8: the last row's Trotter bonds to the next rank's
    first row). On the card one launch of the draw over R CTAs
    (csrc/fk_shard.cu::fk_shard_draw_kernel, R, threads and the place of
    its union-find from `card_shard_label_geometry`,
    LAUNCHES["shard_label"]), which leaves the roots, labels and bath bits
    the step's rounds and flip read."""
    ps, n = st.s.shape
    if st.cpu:
        return shard_label_init_ref(st)
    dev = st.s.device
    graph, lut = _shard_args(st)
    pw = -(-st.slices // 32)
    lab, root = (torch.empty(ps * n, dtype=torch.int32, device=dev)
                 for _ in range(2))
    ext = torch.empty(ps * n * pw if st.lut is not None else 1,
                      dtype=torch.int32, device=dev)
    labels = torch.empty((ps, n), dtype=torch.int32, device=dev)
    bond_dn = torch.zeros(n, dtype=torch.uint8, device=dev)
    R, threads, on_chip = card_shard_label_geometry(
        st.slices, ps, n, dev, st.lut is not None)
    regions = _regions(1, ps, n, R, 1, on_chip, dev)
    lib = _build.library("fk_shard")
    rc = lib.fk_shard_label_draw(
        *graph, _build.ptr(inv_perm(st.pg)),
        _build.ptr(boundary_sites(st.pg, R)), _build.ptr(st.b_sched),
        _build.ptr(st.jp), lut, _build.ptr(st.s), _build.ptr(st.dn),
        _opt(st.full), *map(_build.ptr, (lab, root, ext, labels, bond_dn)),
        _opt(regions), ctypes.c_float(st.teff), ps, n,
        st.pg.nbr_idx.shape[1], st.slices, int(st.k0), int(st.t),
        cr.wrap_int32(st.seed), int(st.asym), R, threads,
        _build.stream_of(dev))
    _fk_shard(lib, "fk_shard_label_draw", rc)
    _build.LAUNCHES["shard_label"] += 1
    # the rounds' cluster: the draw's R
    st.scratch = {"lab": lab, "root": root, "ext": ext, "R": R,
                  "threads": threads}
    return labels, bond_dn


def shard_label_round_ref(st, labels, bond_dn, halo_prev, bond_up,
                          halo_next, full_labels):
    """`shard_label_round`'s plain version, on any device (the last row's
    bonds are the plain draw's own, `bond_dn` is not read)."""
    new, changed = cl.sw_shard_round_ref(
        st.pg.as_problem(), st.bonds, labels.long(), halo_prev,
        bond_up.bool(), halo_next, full_labels, st.k0, st.slices)
    return (new.to(torch.int32),
            torch.tensor([int(changed)], dtype=torch.int32,
                         device=st.s.device))


def shard_label_round(st, labels, bond_dn, halo_prev, bond_up, halo_next,
                      full_labels):
    """S7's round on CUDA tensors (csrc/fk_shard.cu::fk_shard_round_kernel
    over a cluster of the draw's R CTAs, one launch, `labels` updated in
    place), `cluster.sw_shard_round_ref` on CPU tensors: halo_prev,
    halo_next (N,) int32, the previous rank's last and the next rank's
    first row of labels; bond_up (N,) uint8, the previous rank's bond_dn;
    full_labels (P, N) int32 or None. Returns (labels, changed (1,)
    int32). LAUNCHES["shard_label"]."""
    ps, n = st.s.shape
    if st.cpu:
        return shard_label_round_ref(st, labels, bond_dn, halo_prev, bond_up,
                                     halo_next, full_labels)
    dev = st.s.device
    _shard_args(st)
    _build.check_arg(labels, "labels", (ps, n), dev, torch.int32)
    for name, x, dt in (("bond_dn", bond_dn, torch.uint8),
                        ("halo_prev", halo_prev, torch.int32),
                        ("bond_up", bond_up, torch.uint8),
                        ("halo_next", halo_next, torch.int32)):
        _build.check_arg(x, name, (n,), dev, dt)
    if full_labels is not None:
        _build.check_arg(full_labels, "full_labels", (st.slices, n), dev,
                         torch.int32)
    changed = torch.empty(1, dtype=torch.int32, device=dev)
    sc = st.scratch
    lib = _build.library("fk_shard")
    rc = lib.fk_shard_label_round(
        *map(_build.ptr, (sc["ext"], sc["root"], sc["lab"], labels, bond_dn,
                          halo_prev, bond_up, halo_next)),
        _opt(full_labels), _build.ptr(changed), ps, n, st.slices,
        int(st.k0), int(st.lut is not None), int(st.asym), sc["R"],
        sc["threads"], _build.stream_of(dev))
    _fk_shard(lib, "fk_shard_label_round", rc)
    _build.LAUNCHES["shard_label"] += 1
    return labels, changed


def shard_label_flip_ref(st, labels):
    """`shard_label_flip`'s plain version, on any device (a new tensor)."""
    return cl.sw_shard_flip_ref(st.s, labels.long(), st.seed, st.t)


def shard_label_flip(st, labels):
    """S7's flip on CUDA tensors (csrc/fk_shard.cu::fk_shard_flip_kernel, a
    thread a node over a grid that covers the block, one launch, the rows
    flipped in place), `cluster.sw_shard_flip_ref` on CPU tensors. Returns
    the rows. LAUNCHES["shard_label"]."""
    if st.cpu:
        return shard_label_flip_ref(st, labels)
    ps, n = st.s.shape
    _shard_args(st)
    _build.check_arg(labels, "labels", tuple(st.s.shape), st.s.device,
                     torch.int32)
    lib = _build.library("fk_shard")
    rc = lib.fk_shard_label_flip(_build.ptr(labels), _build.ptr(st.s), ps,
                                 n, int(st.t), cr.wrap_int32(st.seed),
                                 _build.stream_of(st.s.device))
    _fk_shard(lib, "fk_shard_label_flip", rc)
    _build.LAUNCHES["shard_label"] += 1
    return st.s
