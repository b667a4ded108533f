"""Trotter-axis sharding: PIQMC with the imaginary-time ring spread over the
"replica" axis of a device mesh (counterpart of
montecarlosolvers_tpu/parallel/trotter.py).

Each rank owns a contiguous block of the Trotter axis. The periodic
nearest-slice coupling is a halo exchange of one boundary row a direction
(`_collectives.ring_halo`, for the JAX `lax.ppermute`), and whole-line
moves sum each rank's part of a line's dE (`_collectives.axis_sum`, for
`lax.psum`). On a rank the work runs on the shard kernels of
`ops/shard_kernels.py`, one update phase a launch.

The engines, as in the JAX package:

  * `anneal_sharded_split` — the split-checkerboard quarter layout (kernel
    B's, `ops/split_kernels.py`) with the half-Trotter row axis q sharded:
    each quarter update reads one boundary half-slice of another quarter
    from a neighbour rank; a phase's two updates share one exchange (both
    directions in one batch_isend_irecv) and one launch, since no update
    of a phase writes what the other reads.
  * `anneal_sharded` — the generic space-time engine on the packed layout
    (`csrc/generic_qmc.cu`'s) of an IsingProblem, or of a LatticeProblem on
    its own checkerboard (`ops/packed.py::packed_from_lattice`). The halo
    exchange runs once per color phase ON PURPOSE: boundary slices hold
    sites of every spatial color, so the remote Trotter neighbours they
    provide change every phase (the JAX docstring, trotter.py:33-38).
    With `lookuptable=`, the sharded bath: the ranks step through their
    local slices in lockstep, each step after a gather of every rank's
    slab, on S5 (JAX `_sharded_dissipative_sweep`, :142).
  * `anneal_wolff_sharded`, `anneal_sw_sharded` — one Wolff cluster or one
    space-time Swendsen-Wang sweep a step of one unbatched chain, grown or
    labelled in rounds of S6 / S7 (`ops/cluster_kernels.py`), each round
    to its block's fixed point, the ranks exchanging their boundary rows'
    news (and with a bath their fresh sites or labels) between rounds,
    until the global "any" flag (`_collectives.any_flag`) says no rank has
    news (JAX :500, :689).

Randomness. Every uniform is the counter hash's at the global chain, slice
and site, so a rank draws exactly its rows of the single-device run's
uniforms with nothing drawn twice: without line moves both engines equal
the single-device engine bitwise at every replica count. The JAX package
gets that only with rng="replicated" (each shard draws the full state's
uniforms, trotter.py:335-356); here "sharded" and "replicated" read the
same hash and give the same result. Line moves add the ranks' parts of
dE in another order than one kernel adds its slices, so with
global_moves=True the result is held in distribution and to the ground
state (tests/test_torch_parallel.py), as the JAX package holds its own.

The cluster engines draw every bond and seed on the single-device
kernels' (fk_wolff.cu, fk_label.cu) counter hash at the global slice and
site, and a cluster or a least-label component is the same set whatever
order it grows in: they equal `qmc.anneal_wolff` / `anneal_sw` bitwise at
every replica count, fields and bath included. The sharded bath draws the
sequential bath kernel's uniforms: at one rank it equals
`generic_kernels.generic_qmc_bath_anneal` bitwise; at more, the slices
that update together read a snapshot taken at their local step's start,
as in JAX (:18-28), and it equals the same lockstep order run in one
process (`anneal_sharded_bath_ref`) bitwise and the sequential bath in
distribution (tests/test_torch_parallel.py).

Departures from the JAX signatures: the key is a torch.Generator (every
rank passes the same state, as JAX replicates its key), from which one
hash seed is drawn; `state_dtype` is accepted and changes nothing, since
the kernels hold spins as bits or floats of +/-1; the result is a DTensor
sharded on "replica" along the slice axis (and on "chains" along the chain
axis with chains_sharded=True); the cluster engines take `stats=`, a dict
that gains the rounds of each step and the host seconds of the
collectives.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from montecarlosolvers_tpu_torch import _roadmap, schedules
from montecarlosolvers_tpu_torch.models.ising import IsingProblem
from montecarlosolvers_tpu_torch.models.lattice import LatticeProblem
from montecarlosolvers_tpu_torch.ops import cluster as cl_ops
from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck
from montecarlosolvers_tpu_torch.ops import packed as packed_ops
from montecarlosolvers_tpu_torch.ops import piqmc as piqmc_ops
from montecarlosolvers_tpu_torch.ops import shard_kernels as shk
from montecarlosolvers_tpu_torch.ops import split as split_ops
from montecarlosolvers_tpu_torch.ops.piqmc import spacetime_num_phases
from montecarlosolvers_tpu_torch.parallel import _collectives as coll
from montecarlosolvers_tpu_torch.parallel import mesh as pmesh
from montecarlosolvers_tpu_torch.solvers.sa import draw_seed

RNGS = ("sharded", "replicated")


def _local_state(confs, mesh, chains_sharded):
    """This rank's block of confs (..., P, N), a full tensor or a DTensor,
    with the slice axis split over "replica" and, with chains_sharded, the
    chain axis over "chains" (`mesh.local_of`: a DTensor already so placed,
    as the engines' own output is, gives its local tensor with no message);
    with the tensor dims that split."""
    if "replica" not in mesh.mesh_dim_names:
        raise ValueError("the Trotter-sharded engines need a mesh with a "
                         "'replica' axis (parallel.make_mesh(replica=...))")
    if chains_sharded and "chains" not in mesh.mesh_dim_names:
        raise ValueError("chains_sharded=True needs a 'chains' mesh axis")
    if confs.ndim < 2:
        raise ValueError("confs must be (..., P, N)")
    if chains_sharded and confs.ndim != 3:
        raise ValueError("chains_sharded=True takes confs (chains, P, N)")
    dims = {confs.ndim - 2: "replica"}
    if chains_sharded:
        dims[0] = "chains"
    return pmesh.local_of(confs, mesh, dims), dims


def _offsets(mesh, dims, local):
    """(chain0, row0): the global index of this rank's first chain and of
    its first row of the sharded axis, `local` its (chains, rows, sites)
    block."""
    chain0 = (pmesh.axis_rank(mesh, "chains") * local.shape[0]
              if dims.get(0) == "chains" else 0)
    return chain0, pmesh.axis_rank(mesh, "replica") * local.shape[1]


def anneal_sharded_split(problem, a_sched, b_sched, temp, confs, generator,
                         mesh, mcsteps=1, global_moves=False,
                         chains_sharded=False, rng="sharded",
                         state_dtype=None):
    """PIQMC anneal on the split-checkerboard engine with the half-Trotter
    row axis q sharded over mesh axis "replica" (and the chain batch over
    "chains" with chains_sharded) (JAX trotter.py:432).

    problem: an even-L LatticeProblem. confs: (..., P, N) float32 +/-1, a
    tensor every rank passes whole, or a DTensor, at even P with P/2
    divisible by the replica axis size. generator: torch.Generator, the
    same state on every rank. a_sched, b_sched, temp, mcsteps,
    global_moves: as for `solvers.qmc.anneal`. rng: "sharded" or
    "replicated", validated as in the JAX package; both read the global
    hash (module docstring). state_dtype: accepted, inert.

    A step is two S1 launches, one a local phase, each after a ring
    exchange, and with global moves, per line color, S2's part, a sum over
    "replica" and S2's accept. Returns a DTensor of confs' shape sharded on
    "replica" along the slice axis (and on "chains" with
    chains_sharded)."""
    if rng not in RNGS:
        raise ValueError(f"rng must be 'sharded' or 'replicated', got {rng!r}")
    _roadmap.require_problem(problem, "trotter.anneal_sharded_split")
    slices = confs.shape[-2]
    if not split_ops.supports_split(problem, slices):
        raise ValueError("anneal_sharded_split takes an even-L "
                         "LatticeProblem at even P")
    q_total = slices // 2
    replicas = pmesh.axis_size(mesh, "replica")
    if q_total % replicas:
        raise ValueError(f"P/2 = {q_total} must divide by the replica axis "
                         f"size {replicas}")
    block, dims = _local_state(confs, mesh, chains_sharded)
    dev = problem.device
    if block.device != dev:
        raise ValueError(f"confs are on {block.device}, problem on {dev}")
    sl = split_ops.build_split(problem)
    b, jp, teff = schedules.qmc_terms(a_sched, b_sched, temp, slices,
                                      mcsteps, dev)
    seed = draw_seed(generator)
    local = block.reshape((-1,) + tuple(block.shape[-2:]))
    quarters = list(split_ops.pack_qmc(sl, local.to(torch.float32)))
    chain0, q0 = _offsets(mesh, dims, quarters[0])
    group = mesh.get_group("replica")
    for t in range(b.shape[0]):
        for phase in (0, 1):
            halos = coll.ring_halo(*shk.halo_rows(quarters, phase), group)
            quarters = shk.shard_phase(sl, b, jp, teff, quarters, halos,
                                       phase, t, seed, chain0, q0, q_total)
        if global_moves:
            for color in (0, 1):
                part = shk.shard_line_part(sl, quarters, color)
                quarters = shk.shard_line_accept(
                    sl, b, teff, coll.axis_sum(part, group), quarters, color,
                    t, seed, chain0)
    out = split_ops.unpack_qmc(sl, *quarters)
    return pmesh.as_dtensor(out.reshape(block.shape), mesh, dims,
                            tuple(confs.shape))


def _packed_of(problem):
    """The PackedGraph the generic engine runs `problem` on: an
    IsingProblem's classes, a LatticeProblem's own checkerboard."""
    if isinstance(problem, IsingProblem):
        return packed_ops.build_packed(problem)
    if isinstance(problem, LatticeProblem):
        return packed_ops.packed_from_lattice(problem)
    raise ValueError("anneal_sharded takes an IsingProblem or a "
                     "LatticeProblem")


def _gathered(s, group, as_float=True):
    """Every rank's slab of `group` gathered along the slice axis (dim 1),
    sent as int8: the +/-1 state rounds to nothing, and a quarter of the
    bytes crosses (gloo stages them through host memory). Returned as
    float32, or with as_float=False as the int8 itself, which S5 reads."""
    out = coll.gather(s.to(torch.int8), group, 1)
    return out.to(torch.float32) if as_float else out


def _ring_colour(replicas, me):
    """(colours, this rank's colour) of the device ring at one slice a rank
    (JAX trotter.py:194-216): 2 on an even ring; on an odd ring 3, the last
    rank coloured 2, so that no two neighbours update together."""
    if replicas % 2 == 0:
        return 2, me % 2
    return 3, 2 if me == replicas - 1 else me % 2


def anneal_sharded(problem, a_sched, b_sched, temp, confs, generator, mesh,
                   mcsteps=1, global_moves=False, lookuptable=None,
                   chains_sharded=False):
    """PIQMC anneal on the generic space-time engine with the Trotter axis
    sharded over mesh axis "replica" (and the chain batch over "chains"
    with chains_sharded) (JAX trotter.py:257).

    problem: IsingProblem, or a LatticeProblem on its own checkerboard
    classes. confs: (..., P, N) float32 +/-1, a tensor every rank passes
    whole, or a DTensor, with P divisible by the replica axis size.
    generator: torch.Generator, the same state on every rank. The other
    arguments as for `solvers.qmc.anneal`.

    A step is one ring exchange and one S3 launch a space-time phase
    (phase(i, k) = (color(i) + k) mod m, k global), and with global moves,
    per spatial color, S4's part, a sum over "replica" and S4's accept.
    Without global moves it equals `generic_kernels.generic_qmc_anneal` on
    the same packing bitwise.

    With `lookuptable=` (the sharded bath, JAX `_sharded_dissipative_sweep`
    :142): the ranks step through their local slices in lockstep; each
    local step gathers every rank's slab (`_gathered`; at one rank the
    slab itself) and runs S5 on one slice of it, whose Trotter and bath
    terms read the gathered state. At one slice a rank the device ring is
    coloured instead (`_ring_colour`), a fresh gather each colour, so that
    no two neighbouring slices update together. Line moves are S4's: J_perp
    and the bath cancel on a whole-line flip. At one rank this equals
    `generic_kernels.generic_qmc_bath_anneal` (sequential) bitwise; at more,
    the slices that update together read a snapshot, as in JAX, and it
    equals `anneal_sharded_bath_ref` run with as many ranks bitwise.

    Returns a DTensor of confs' shape sharded on "replica" along the slice
    axis (and on "chains" with chains_sharded)."""
    _roadmap.require_problem(problem, "trotter.anneal_sharded")
    pg = _packed_of(problem)
    slices = confs.shape[-2]
    replicas = pmesh.axis_size(mesh, "replica")
    if slices % replicas:
        raise ValueError(f"P = {slices} must divide by the replica axis "
                         f"size {replicas}")
    block, dims = _local_state(confs, mesh, chains_sharded)
    dev = problem.device
    if block.device != dev:
        raise ValueError(f"confs are on {block.device}, problem on {dev}")
    bath = (None if lookuptable is None
            else piqmc_ops.bath_matrix_of(lookuptable, slices, dev))
    m = spacetime_num_phases(pg.num_colors, slices)
    b, jp, teff = schedules.qmc_terms(a_sched, b_sched, temp, slices,
                                      mcsteps, dev)
    seed = draw_seed(generator)
    local = block.reshape((-1,) + tuple(block.shape[-2:]))
    s = packed_ops.pack_state(pg, local.to(torch.float32)).contiguous()
    chain0, k0 = _offsets(mesh, dims, s)
    ps = s.shape[1]
    group = mesh.get_group("replica")
    me = pmesh.axis_rank(mesh, "replica")
    for t in range(b.shape[0]):
        if bath is None:
            for p in range(m):
                up, dn = coll.ring_halo(s[:, -1], s[:, 0], group)
                s = shk.generic_shard_phase(pg, b, jp, teff, s, up, dn, p, m,
                                            t, seed, chain0, k0, slices)
        elif ps == 1 and replicas > 1:
            colours, mine = _ring_colour(replicas, me)
            for colour in range(colours):
                full = _gathered(s, group, as_float=False)
                if colour == mine:
                    s = shk.generic_shard_bath_slice(
                        pg, b, jp, teff, bath, s, full, 0, k0, t, seed,
                        chain0)
        else:
            for kloc in range(ps):
                full = (s if replicas == 1
                        else _gathered(s, group, as_float=False))
                s = shk.generic_shard_bath_slice(
                    pg, b, jp, teff, bath, s, full, kloc, k0 + kloc, t, seed,
                    chain0)
        if global_moves:
            for c in range(pg.num_colors):
                part = shk.generic_shard_line_part(pg, b, s, c, t)
                s = shk.generic_shard_line_accept(
                    pg, teff, coll.axis_sum(part, group), s, c, t, seed,
                    chain0, slices)
    out = packed_ops.unpack_state(pg, s)
    return pmesh.as_dtensor(out.reshape(block.shape), mesh, dims,
                            tuple(confs.shape))


def anneal_sharded_bath_ref(problem, a_sched, b_sched, temp, lookuptable,
                            confs, seed, ranks, mcsteps=1,
                            global_moves=False):
    """The sharded bath's `ranks` ranks run in lockstep in one process, on
    the plain versions (S5's and S4's): the plain version the gloo runs of
    `anneal_sharded(lookuptable=)` are held to. confs: (chains, P, N), P
    divisible by `ranks`; seed: the hash seed (`sa.draw_seed` of the
    generator the sharded run takes). Each local step every rank's slice
    reads the state as it stood after the last local step (at one slice a
    rank, after the last ring colour); the line moves add the ranks' parts
    in rank order. Returns the (chains, P, N) confs."""
    pg = _packed_of(problem)
    dev = problem.device
    slices = confs.shape[-2]
    if slices % ranks:
        raise ValueError(f"P = {slices} must divide by {ranks} ranks")
    ps = slices // ranks
    bath = piqmc_ops.bath_matrix_of(lookuptable, slices, dev)
    b, jp, teff = schedules.qmc_terms(a_sched, b_sched, temp, slices,
                                      mcsteps, dev)
    s = packed_ops.pack_state(pg, confs.to(torch.float32)).contiguous()

    def slab(x, r):
        return x[:, r * ps:(r + 1) * ps]

    def step(x, owners, kloc):
        full = x.clone()
        parts = [shk.generic_shard_bath_slice_ref(
            pg, b, jp, teff, bath, slab(x, r), full, kloc, r * ps + kloc, t,
            seed) if r in owners else slab(x, r) for r in range(ranks)]
        return torch.cat(parts, dim=1)

    for t in range(b.shape[0]):
        if ps == 1 and ranks > 1:
            colours = _ring_colour(ranks, 0)[0]
            for colour in range(colours):
                s = step(s, [r for r in range(ranks)
                             if _ring_colour(ranks, r)[1] == colour], 0)
        else:
            for kloc in range(ps):
                s = step(s, range(ranks), kloc)
        if global_moves:
            for c in range(pg.num_colors):
                parts = [shk.generic_shard_line_part_ref(pg, b, slab(s, r),
                                                         c, t)
                         for r in range(ranks)]
                total = parts[0]
                for part in parts[1:]:
                    total = total + part
                s = shk.generic_shard_line_accept_ref(pg, teff, total, s, c,
                                                      t, seed, 0, slices)
    return packed_ops.unpack_state(pg, s).reshape(confs.shape)


# ------------------------------------------ the sharded cluster engines


def _cluster_setup(problem, confs, mesh, lookuptable, what):
    """(pg, slab (Ps, N) packed float32, dims, lut tensor or None, replica
    group, rank, replicas) of a Trotter-sharded cluster engine."""
    _roadmap.require_problem(problem, what)
    if isinstance(problem, LatticeProblem):
        problem = problem.to_generic()
    if not isinstance(problem, IsingProblem):
        raise ValueError(f"{what} takes an IsingProblem or a LatticeProblem")
    if confs.ndim != 2:
        raise ValueError(f"{what} takes one unbatched (P, N) chain, as the "
                         "JAX engine does")
    slices = confs.shape[0]
    replicas = pmesh.axis_size(mesh, "replica")
    if slices % replicas:
        raise ValueError(f"P = {slices} must divide by the replica axis "
                         f"size {replicas}")
    block, dims = _local_state(confs, mesh, False)
    dev = problem.device
    if block.device != dev:
        raise ValueError(f"confs are on {block.device}, problem on {dev}")
    pg = packed_ops.build_packed(problem)
    lut = None
    if lookuptable is not None:
        lut = torch.as_tensor(np.array(lookuptable, dtype=np.float32)
                              if not torch.is_tensor(lookuptable)
                              else lookuptable, dtype=torch.float32,
                              device=dev).contiguous()
        if tuple(lut.shape) != (slices - 1,):
            raise ValueError(f"lookuptable has shape {tuple(lut.shape)}, "
                             f"expected ({slices - 1},)")
    s = packed_ops.pack_state(pg, block.to(torch.float32)[None])[0]
    return (pg, s.contiguous(), dims, lut, mesh.get_group("replica"),
            pmesh.axis_rank(mesh, "replica"), replicas)


class _Clock:
    """Host seconds spent in the collectives of a run, into `stats`."""

    def __init__(self, stats):
        self.stats = stats
        if stats is not None:
            stats.setdefault("rounds", [])
            stats.setdefault("exchange_seconds", 0.0)

    def __enter__(self):
        self.t0 = time.perf_counter() if self.stats is not None else 0.0

    def __exit__(self, *exc):
        if self.stats is not None:
            self.stats["exchange_seconds"] += time.perf_counter() - self.t0


def anneal_wolff_sharded(problem, a_sched, b_sched, temp, confs, generator,
                         mesh, mcsteps=1, rule="local", lookuptable=None,
                         stats=None):
    """PIQMC anneal with one Wolff cluster a step, the Trotter axis sharded
    over mesh axis "replica" (JAX trotter.py:629).

    problem: an IsingProblem, or a LatticeProblem taken `to_generic()`, as
    the JAX engine takes it. confs: one unbatched (P, N) chain, float32
    +/-1, a tensor every rank passes whole or a DTensor, P divisible by the
    replica axis size. generator: torch.Generator, the same state on every
    rank. rule "local" or "full", lookuptable (P-1,) bath bonds or None:
    as `solvers.qmc.anneal_wolff`. stats: None, or a dict that gains
    "rounds" (a list, each step's rounds) and "exchange_seconds" (host
    seconds in the collectives and flag reads).

    A step on a rank: the seed's owner broadcasts the seed spin (rule
    "full"), one ring exchange of the boundary rows, with a bath a gather
    of every rank's rows; then rounds of S6 (`cluster_kernels.
    shard_wolff_round`), each followed by one ring exchange of its
    messages, with a bath a gather of its fresh bits, and the global "any"
    flag, until no rank sends news; then, rule "local" with fields, S6's
    row sums gathered and added in slice order, and S6's flip. Every draw
    is fk_wolff.cu's, at the global slice and site, and a cluster is the
    same set whatever order it grows in: the result equals
    `qmc.anneal_wolff`'s (csrc/fk_wolff.cu) bitwise at every replica
    count, fields too. Returns a DTensor of confs' shape sharded on
    "replica" along the slice axis."""
    if rule not in ("local", "full"):
        raise ValueError(f"rule must be 'local' or 'full', got {rule!r}")
    pg, s, dims, lut, group, me, replicas = _cluster_setup(
        problem, confs, mesh, lookuptable, "trotter.anneal_wolff_sharded")
    slices, n = confs.shape
    ps = s.shape[0]
    k0 = me * ps
    dev = s.device
    b, jp, teff = schedules.qmc_terms(a_sched, b_sched, temp, slices,
                                      mcsteps, dev)
    seed = draw_seed(generator)
    has_field = bool((pg.h != 0).any())
    clock = _Clock(stats)
    no_news = torch.zeros(n, dtype=torch.uint8, device=dev)
    for t in range(b.shape[0]):
        seed_slice, seed_spin = cl_ops.wolff_seed_draw(seed, t, slices, n,
                                                  torch.device("cpu"))
        owner = seed_slice // ps
        seed_x = (seed_slice - k0) * n + seed_spin if owner == me else -1
        with clock:
            kval = None
            if rule == "full":
                kval = (s.reshape(-1)[seed_x:seed_x + 1].clone()
                        if seed_x >= 0 else torch.zeros(1, device=dev))
                kval = coll.broadcast(kval, owner, group)
            up, dn = coll.ring_halo(s[-1], s[0], group)
            full = None
            if lut is not None:
                full = s if replicas == 1 else _gathered(s[None], group)[0]
        st = ck.ShardStep(pg, s, up, dn, full, k0, slices, b, jp, teff, t,
                          seed, lut, rule, kval)
        visited = torch.zeros(st.words, dtype=torch.int32, device=dev)
        in_prev = in_next = no_news
        full_fresh = None
        rounds = 0
        while True:
            visited, fresh, out_up, out_dn, changed = ck.shard_wolff_round(
                st, visited, in_prev, in_next, full_fresh, seed_x)
            seed_x = -1
            rounds += 1
            if replicas == 1:
                break  # a ring of one rank is whole after one round
            with clock:
                if not coll.any_flag(changed, group):
                    break
                in_prev, in_next = coll.ring_halo(out_dn, out_up, group)
                if lut is not None:
                    full_fresh = coll.gather(fresh, group, 0)
        if stats is not None:
            stats["rounds"].append(rounds)
        rows_full = None
        if rule == "local" and has_field:
            rows = ck.shard_wolff_sums(st, visited)
            with clock:
                rows_full = rows if replicas == 1 else coll.gather(
                    rows, group, 0)
        s = ck.shard_wolff_flip(st, visited, rows_full)
    out = packed_ops.unpack_state(pg, s[None])[0]
    return pmesh.as_dtensor(out, mesh, dims, tuple(confs.shape))


def anneal_sw_sharded(problem, a_sched, b_sched, temp, confs, generator,
                      mesh, mcsteps=1, lookuptable=None, stats=None):
    """PIQMC anneal with one full space-time Swendsen-Wang sweep a step,
    the Trotter axis sharded over mesh axis "replica" (JAX
    trotter.py:794). Arguments as for `anneal_wolff_sharded`; any bath
    table, as JAX's: on one not symmetric in ring distance a bath pair
    where only one direction's bond holds is a directed edge, which S7
    relaxes inside a block and keeps as a directed bit across ranks
    (csrc/fk_shard.cu), as fk_label relaxes it on one device.

    A step on a rank: one ring exchange of the boundary rows, with a bath a
    gather of every rank's rows; S7's draw and the block's own labels
    (`cluster_kernels.shard_label_init`); one exchange of the last row's
    Trotter bonds to the next rank; then, with more than one rank, rounds
    of the ring exchange of the boundary labels (with a bath a gather of
    the labels), S7's round and the global "any" flag, until no label
    changes; then S7's flip, each free component on the hash's coin of
    its label, computed where it is needed. The least-label fixed point
    does not depend on the order of the rounds: the result equals
    `qmc.anneal_sw`'s (csrc/fk_label.cu) bitwise at every replica count,
    with fields and with the bath. Returns a DTensor of confs' shape
    sharded on "replica" along the slice axis."""
    pg, s, dims, lut, group, me, replicas = _cluster_setup(
        problem, confs, mesh, lookuptable, "trotter.anneal_sw_sharded")
    asym = ck.ring_asymmetric(lut)
    slices, n = confs.shape
    ps = s.shape[0]
    k0 = me * ps
    dev = s.device
    b, jp, teff = schedules.qmc_terms(a_sched, b_sched, temp, slices,
                                      mcsteps, dev)
    seed = draw_seed(generator)
    clock = _Clock(stats)
    for t in range(b.shape[0]):
        with clock:
            up, dn = coll.ring_halo(s[-1], s[0], group)
            full = None
            if lut is not None:
                full = s if replicas == 1 else _gathered(s[None], group)[0]
        st = ck.ShardStep(pg, s, up, dn, full, k0, slices, b, jp, teff, t,
                          seed, lut, asym=asym)
        labels, bond_dn = ck.shard_label_init(st)
        rounds = 0
        if replicas > 1:
            with clock:
                bond_up, _ = coll.ring_halo(bond_dn, bond_dn, group)
            while True:
                with clock:
                    halo_prev, halo_next = coll.ring_halo(
                        labels[-1], labels[0], group)
                    full_labels = (coll.gather(labels, group, 0)
                                   if lut is not None else None)
                labels, changed = ck.shard_label_round(
                    st, labels, bond_dn, halo_prev, bond_up, halo_next,
                    full_labels)
                rounds += 1
                with clock:
                    if not coll.any_flag(changed, group):
                        break
        if stats is not None:
            stats["rounds"].append(rounds)
        s = ck.shard_label_flip(st, labels)
    out = packed_ops.unpack_state(pg, s[None])[0]
    return pmesh.as_dtensor(out, mesh, dims, tuple(confs.shape))


def _cluster_ref_setup(problem, a_sched, b_sched, temp, confs, mcsteps,
                       lookuptable, ranks):
    if isinstance(problem, LatticeProblem):
        problem = problem.to_generic()
    pg = packed_ops.build_packed(problem)
    slices = confs.shape[0]
    if slices % ranks:
        raise ValueError(f"P = {slices} must divide by {ranks} ranks")
    dev = problem.device
    b, jp, teff = schedules.qmc_terms(a_sched, b_sched, temp, slices,
                                      mcsteps, dev)
    lut = None if lookuptable is None else torch.as_tensor(
        np.array(lookuptable, dtype=np.float32) if not torch.is_tensor(
            lookuptable) else lookuptable, dtype=torch.float32, device=dev)
    s = packed_ops.pack_state(pg, confs.to(torch.float32)[None])[0]
    return pg, s, b, jp, teff, lut


def anneal_wolff_sharded_ref(problem, a_sched, b_sched, temp, confs, seed,
                             ranks, mcsteps=1, rule="local",
                             lookuptable=None, rounds=None):
    """`anneal_wolff_sharded`'s `ranks` ranks run in lockstep in one
    process on the plain versions (`cluster.wolff_sharded_steps_ref`): the
    plain version its gloo runs are held to. confs: (P, N); seed: the hash
    seed (`sa.draw_seed` of the generator the sharded run takes); rounds: a
    list that gains each step's rounds. Returns the (P, N) chain."""
    pg, s, b, jp, teff, lut = _cluster_ref_setup(
        problem, a_sched, b_sched, temp, confs, mcsteps, lookuptable, ranks)
    out = cl_ops.wolff_sharded_steps_ref(
        pg.as_problem(), s, b, jp, teff, seed, ranks, rule, lut, pg.perm,
        rounds=rounds)
    return packed_ops.unpack_state(pg, out[None])[0]


def anneal_sw_sharded_ref(problem, a_sched, b_sched, temp, confs, seed,
                          ranks, mcsteps=1, lookuptable=None, rounds=None):
    """`anneal_sw_sharded`'s `ranks` ranks run in lockstep in one process
    on the plain versions (`cluster.sw_sharded_steps_ref`); arguments as
    for `anneal_wolff_sharded_ref`."""
    pg, s, b, jp, teff, lut = _cluster_ref_setup(
        problem, a_sched, b_sched, temp, confs, mcsteps, lookuptable, ranks)
    out = cl_ops.sw_sharded_steps_ref(
        pg.as_problem(), s, b, jp, teff, seed, ranks, lut, pg.perm,
        rounds=rounds)
    return packed_ops.unpack_state(pg, out[None])[0]
