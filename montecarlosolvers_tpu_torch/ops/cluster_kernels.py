"""The cluster updates on the card: kernel wrappers and the problem-level
anneals of `solvers/sa.py` and `solvers/qmc.py`'s cluster solvers.

No Pallas kernel covers this path: the JAX package runs it as XLA,
frontier BFS and min-label relaxation inside `lax.while_loop` and the
boolean closure by einsum (montecarlosolvers_tpu/ops/cluster.py). The port
gives its three hot loops hand-written CUDA kernels, all on the
class-major packed layout of `ops/packed.py` (the site's original index
`perm` keys every draw, `counter_rng`'s cluster streams):

  csrc/fk_wolff.cu  one Wolff cluster a chain and step (`wolff_update`,
                    rules "local" and "full", with or without a bath): one
                    CTA a chain, a queue BFS that draws a bond when it
                    reaches it; LAUNCHES["fk_wolff"]
  csrc/fk_label.cu  Swendsen-Wang (`classical_sw_sweep`, P = 1, and
                    `spacetime_sw_sweep`, any P, optional bath): one CTA a
                    chain, union-find labels; LAUNCHES["fk_label"]
  csrc/fk_line.cu   one color phase of the imaginary-time line clusters
                    (`bath_cluster_phase`, `sw_full_phase`): one warp a
                    line, P <= 64; LAUNCHES["fk_line"]
  csrc/houdayer.cu  the Houdayer move of ICM (`houdayer_sweep`) on replica
                    pairs in the problem's generic order: one CTA a pair,
                    union-find labels; LAUNCHES["houdayer"]

Their plain versions are `ops/cluster.py`'s `wolff_anneal_ref`,
`sw_anneal_ref`, `line_phase_ref` and `houdayer_move_ref`. A wrapper given CPU tensors runs the
plain version; given CUDA tensors it launches the kernel or raises.

Launch pattern. fk_wolff and fk_label run a whole schedule in one launch
when no local sweep is interleaved (qmc.anneal_wolff; anneal_sw and
sa.anneal_wolff with local_sweeps=False). With local sweeps, each step is
one launch of the local kernel (csrc/packed_sa.cu, csrc/generic_qmc.cu
without line moves, or csrc/generic_qmc_bath.cu) and one of the cluster
kernel, each told its step (`step0`), so that every step draws its own
uniforms. qmc.anneal_sw_bath launches fk_line once a color phase: steps x
colors launches, plus one local launch a step for WC2 with local sweeps.
"""

from __future__ import annotations

import ctypes

import torch

from montecarlosolvers_tpu_torch import schedules
from montecarlosolvers_tpu_torch.models.lattice import LatticeProblem
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import cluster as cl
from montecarlosolvers_tpu_torch.ops import counter_rng as cr
from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
from montecarlosolvers_tpu_torch.ops import packed as packed_ops
from montecarlosolvers_tpu_torch.ops import piqmc as piqmc_ops

# threads of the one CTA a chain of fk_wolff and fk_label, and the warps a
# CTA of fk_line (one line a warp)
WOLFF_THREADS, LABEL_THREADS, LINE_WARPS = 512, 1024, 8
# the most slices fk_line takes: a line's P x P bonds are P rows of one
# 64-bit word
LINE_MAX_SLICES = 64
# fk_label keeps its union-find parents (int32) and two flag bytes a site
# in shared memory up to this many bytes, else in device memory; so does
# the Houdayer kernel its parents (1024 threads a pair)
LABEL_SMEM_BYTES = 200 * 1024
HOUDAYER_THREADS = 1024


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
                 lookuptable=None, step0=0, visited=None):
    """csrc/fk_wolff.cu on CUDA tensors, `cluster.wolff_anneal_ref` on CPU
    tensors; arguments as for the plain version (teff a float32 (steps,)
    tensor; lookuptable None or a contiguous float32 (P-1,) tensor).
    Returns the new configurations. One launch (LAUNCHES["fk_wolff"])."""
    if rule not in ("local", "full"):
        raise ValueError(f"rule must be 'local' or 'full', got {rule!r}")
    if _build.route(confs.device, "cluster") == "cpu":
        return cl.wolff_anneal_ref(pg, b_sched, jp, teff, confs, seed, rule,
                                   lookuptable, step0, visited)
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
    words = -(-P * n // 32)
    bits = torch.empty((chains, words), dtype=torch.int32, device=dev)
    queue = torch.empty((chains, 2, P * n), dtype=torch.int32, device=dev)
    lib = _build.library("fk_wolff")
    rc = lib.fk_wolff_anneal(
        *graph, *sched, lut, _build.ptr(out), _build.ptr(bits),
        _build.ptr(queue), None if visited is None else _build.ptr(visited),
        chains, P, n, pg.nbr_idx.shape[1], steps, cr.wrap_int32(seed),
        int(step0), int(rule == "full"), WOLFF_THREADS,
        _build.stream_of(dev))
    _build.raise_on_error(lib, "fk_wolff_anneal", rc)
    _build.LAUNCHES["fk_wolff"] += 1
    return out


def label_smem(P, n):
    """True when fk_label holds a chain's P * N union-find sites in shared
    memory (LABEL_SMEM_BYTES)."""
    return P * n * 6 <= LABEL_SMEM_BYTES


def sw_anneal(pg, b_sched, jp, teff, confs, seed, lookuptable=None, step0=0,
              classical=False):
    """csrc/fk_label.cu on CUDA tensors, `cluster.sw_anneal_ref` on CPU
    tensors; arguments as for the plain version. Raises ValueError on the
    card for a bath table that is not symmetric in ring distance: the
    kernel unions undirected bonds, and the JAX relaxation's bath edges
    are directed where lut[d-1] != lut[P-1-d] (schedules.bath_lookuptable
    is symmetric). Returns the new configurations. One launch
    (LAUNCHES["fk_label"])."""
    if _build.route(confs.device, "cluster") == "cpu":
        return cl.sw_anneal_ref(pg, b_sched, jp, teff, confs, seed,
                                lookuptable, step0, classical)
    chains, P, n = confs.shape
    dev = confs.device
    if classical and P != 1:
        raise ValueError("the classical Swendsen-Wang sweep takes P = 1")
    steps = int(b_sched.shape[0])
    graph = _check_graph(pg, dev)
    sched = _check_schedules(steps, dev, b_sched=b_sched, jp=jp, teff=teff)
    lut = _check_lut(lookuptable, P, dev)
    if lookuptable is not None and not bool(
            (lookuptable == lookuptable.flip(0)).all()):
        raise ValueError("fk_label takes a bath table symmetric in ring "
                         "distance")
    _build.check_arg(confs, "confs", (chains, P, pg.nspins), dev)
    out = confs.clone()
    smem = label_smem(P, n)
    parent = flags = None
    if not smem:
        parent = torch.empty((chains, P * n), dtype=torch.int32, device=dev)
        flags = torch.empty((chains, 2 * P * n), dtype=torch.uint8,
                            device=dev)
    lib = _build.library("fk_label")
    rc = lib.fk_label_anneal(
        *graph, *sched, lut, _build.ptr(out),
        None if parent is None else _build.ptr(parent),
        None if flags is None else _build.ptr(flags), chains, P, n,
        pg.nbr_idx.shape[1], steps, cr.wrap_int32(seed), int(step0),
        int(smem), LABEL_THREADS, _build.stream_of(dev))
    _build.raise_on_error(lib, "fk_label_anneal", rc)
    _build.LAUNCHES["fk_label"] += 1
    return out


def houdayer_move(problem, s1, s2, seed, step):
    """csrc/houdayer.cu on CUDA tensors, `cluster.houdayer_move_ref` on CPU
    tensors: one Houdayer move of the (pairs, N) replicas s1, s2 (sites in
    the IsingProblem's own order; a lattice's to_generic()) on the coins of
    the HOUDAYER stream at `step`. Returns (s1', s2', flipped (pairs,)
    int32). One launch (LAUNCHES["houdayer"])."""
    if _build.route(s1.device, "cluster") == "cpu":
        return cl.houdayer_move_ref(problem, s1, s2, seed, step)
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
    smem = n * 4 <= LABEL_SMEM_BYTES
    parent = None if smem else torch.empty((pairs, n), dtype=torch.int32,
                                           device=dev)
    lib = _build.library("houdayer")
    rc = lib.houdayer_move(
        _build.ptr(problem.nbr_idx), _build.ptr(problem.nbr_J),
        _build.ptr(a), _build.ptr(b), _build.ptr(flipped),
        None if parent is None else _build.ptr(parent), pairs, n, maxnb,
        cr.wrap_int32(seed), int(step), int(smem), HOUDAYER_THREADS,
        _build.stream_of(dev))
    _build.raise_on_error(lib, "houdayer_move", rc)
    _build.LAUNCHES["houdayer"] += 1
    return a, b, flipped


def line_tables(lookuptable, jp, teff, P, device):
    """(p_pair (P, P), p_t (steps,)): the bath pairs' and the Trotter
    bonds' FK probabilities (`cluster.pair_prob`, `trotter_prob`), computed
    once an anneal and read by fk_line as its plain version computes
    them."""
    return (cl.pair_prob(lookuptable, P, device).contiguous(),
            cl.trotter_prob(jp, teff).contiguous())


def line_phase(pg, b_sched, jp, p_t, t, teff, lookuptable, p_pair, confs,
               seed, step, color, per_slice_seeds):
    """csrc/fk_line.cu on CUDA tensors, `cluster.line_phase_ref` on CPU
    tensors: the line phase of class `color` at schedule index t (B_t,
    J_perp_t and the Trotter probability p_t[t]) on the draws of `step`,
    T_eff = `teff` (a Python float). Returns the new configurations. One
    launch (LAUNCHES["fk_line"]); P <= LINE_MAX_SLICES on the card."""
    if _build.route(confs.device, "cluster") == "cpu":
        return cl.line_phase_ref(pg, b_sched[t], jp[t], teff, lookuptable,
                                 confs, seed, step, color, per_slice_seeds,
                                 p_pair)
    chains, P, n = confs.shape
    dev = confs.device
    if P > LINE_MAX_SLICES:
        raise ValueError(f"fk_line takes P <= {LINE_MAX_SLICES}, got {P}")
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
        int(bool(per_slice_seeds)), LINE_WARPS, _build.stream_of(dev))
    _build.raise_on_error(lib, "fk_line_phase", rc)
    _build.LAUNCHES["fk_line"] += 1
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
                     local_sweeps=True):
    """Classical cluster anneal of an IsingProblem (JAX sa.anneal_wolff /
    anneal_sw): kind "wolff" one Wolff cluster a chain and step (P = 1, J_perp
    = 0: Gamma = inf, B = 1, T_eff = T), "sw" one Swendsen-Wang sweep; with
    `local_sweeps` a colored Metropolis sweep (csrc/packed_sa.cu) before
    each. sched: (steps,) temperatures; spins: (..., N) float32 +/-1 on the
    problem's device. Returns the annealed spins."""
    pg = gk._graph_of(problem, spins, "spins")
    temps = schedules.expand_mcsteps(sched, mcsteps, problem.device)
    ones = torch.ones_like(temps)
    zeros = torch.zeros_like(temps)
    c = _packed_lines(pg, spins, 1)
    chains = c.shape[0]

    def cluster(c, sl, step0):
        if kind == "wolff":
            return wolff_anneal(pg, ones[sl], zeros[sl], temps[sl], c, seed,
                                step0=step0)
        return sw_anneal(pg, ones[sl], zeros[sl], temps[sl], c, seed,
                         step0=step0, classical=True)

    if not local_sweeps:
        c = cluster(c, slice(None), 0)
    else:
        for t in range(temps.shape[0]):
            s = gk.packed_sa_anneal(pg, temps[t:t + 1], c.view(chains, -1),
                                    seed, step0=t)
            c = cluster(s.view(chains, 1, -1), slice(t, t + 1), t)
    return _unpacked(pg, c, spins.shape)


def qmc_cluster_anneal(problem, a_sched, b_sched, temp, confs, seed,
                       mcsteps=1, kind="wolff", rule="local",
                       lookuptable=None, local_sweeps=False):
    """PIQMC cluster anneal of an IsingProblem (JAX qmc.anneal_wolff /
    anneal_sw): kind "wolff" one cluster a chain and step (rule "local" or
    "full"), "sw" one space-time Swendsen-Wang sweep, optional bath bonds
    from `lookuptable`; with `local_sweeps` (kind "sw") a space-time local
    sweep (csrc/generic_qmc.cu, no line moves) before each. confs: (...,
    P, N) float32 +/-1 on the problem's device. Returns the annealed
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
                                lut, step0)
        return sw_anneal(pg, b[sl], jp[sl], teffs[sl], c, seed, lut, step0)

    if not local_sweeps:
        c = cluster(c, slice(None), 0)
    else:
        for t in range(b.shape[0]):
            c = gk.generic_qmc_anneal(pg, b[t:t + 1], jp[t:t + 1], teff, c,
                                      seed, False, step0=t)
            c = cluster(c, slice(t, t + 1), t)
    return _unpacked(pg, c, confs.shape)


def sw_bath_anneal(problem, a_sched, b_sched, temp, lookuptable, confs, seed,
                   mcsteps=1, per_slice_seeds=True, local_sweeps=True):
    """Dissipative anneal with bath-bond line clusters (JAX
    qmc.anneal_sw_bath, WC2 / WC3) of an IsingProblem: each step, with
    `local_sweeps` and not `per_slice_seeds`, a dissipative local sweep
    (csrc/generic_qmc_bath.cu, sequential, no line moves), then one
    fk_line phase a color class. confs: (..., P, N), P >= 2. Returns the
    annealed configurations."""
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
    for t in range(b.shape[0]):
        if local_sweeps and not per_slice_seeds:
            c = gk.generic_qmc_bath_anneal(pg, b[t:t + 1], jp[t:t + 1], teff,
                                           bath, c, seed, False, step0=t)
        for color in range(pg.num_colors):
            c = line_phase(pg, b, jp, p_t, t, teff, lut, p_pair, c, seed, t,
                           color, per_slice_seeds)
    return _unpacked(pg, c, confs.shape)
