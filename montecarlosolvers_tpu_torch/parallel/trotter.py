"""Trotter-axis sharding: PIQMC with the imaginary-time ring spread over the
"replica" axis of a device mesh (counterpart of
montecarlosolvers_tpu/parallel/trotter.py).

Each rank owns a contiguous block of the Trotter axis. The periodic
nearest-slice coupling is a halo exchange of one boundary row a direction
(`_collectives.ring_halo`, for the JAX `lax.ppermute`), and whole-line
moves sum each rank's part of a line's dE (`_collectives.axis_sum`, for
`lax.psum`). On a rank the work runs on the shard kernels of
`ops/shard_kernels.py`, one update phase a launch.

Two engines, as in the JAX package:

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

Departures from the JAX signatures: the key is a torch.Generator (every
rank passes the same state, as JAX replicates its key), from which one
hash seed is drawn; `state_dtype` is accepted and changes nothing, since
the kernels hold spins as bits or floats of +/-1; the result is a DTensor
sharded on "replica" along the slice axis (and on "chains" along the chain
axis with chains_sharded=True). The sharded bath (`lookuptable=`) and the
sharded cluster engines are queued at ROADMAP.md queue 1, item 4.
"""

from __future__ import annotations

import torch

from montecarlosolvers_tpu_torch import _roadmap, schedules
from montecarlosolvers_tpu_torch.models.ising import IsingProblem
from montecarlosolvers_tpu_torch.models.lattice import LatticeProblem
from montecarlosolvers_tpu_torch.ops import packed as packed_ops
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
    arguments as for `solvers.qmc.anneal`; `lookuptable=` (the sharded
    bath) is queued at ROADMAP.md queue 1, item 4.

    A step is one ring exchange and one S3 launch a space-time phase
    (phase(i, k) = (color(i) + k) mod m, k global), and with global moves,
    per spatial color, S4's part, a sum over "replica" and S4's accept.
    Without global moves it equals `generic_kernels.generic_qmc_anneal` on
    the same packing bitwise. Returns a DTensor of confs' shape sharded on
    "replica" along the slice axis (and on "chains" with
    chains_sharded)."""
    if lookuptable is not None:
        raise _roadmap.not_ported("trotter.anneal_sharded(lookuptable=), "
                                  "the sharded bath", _roadmap.SHARDED)
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
    m = spacetime_num_phases(pg.num_colors, slices)
    b, jp, teff = schedules.qmc_terms(a_sched, b_sched, temp, slices,
                                      mcsteps, dev)
    seed = draw_seed(generator)
    local = block.reshape((-1,) + tuple(block.shape[-2:]))
    s = packed_ops.pack_state(pg, local.to(torch.float32)).contiguous()
    chain0, k0 = _offsets(mesh, dims, s)
    group = mesh.get_group("replica")
    for t in range(b.shape[0]):
        for p in range(m):
            up, dn = coll.ring_halo(s[:, -1], s[:, 0], group)
            s = shk.generic_shard_phase(pg, b, jp, teff, s, up, dn, p, m, t,
                                        seed, chain0, k0, slices)
        if global_moves:
            for c in range(pg.num_colors):
                part = shk.generic_shard_line_part(pg, b, s, c, t)
                s = shk.generic_shard_line_accept(
                    pg, teff, coll.axis_sum(part, group), s, c, t, seed,
                    chain0, slices)
    out = packed_ops.unpack_state(pg, s)
    return pmesh.as_dtensor(out.reshape(block.shape), mesh, dims,
                            tuple(confs.shape))


def anneal_wolff_sharded(*args, **kwargs):
    """The Trotter-sharded Wolff engine (JAX trotter.py:629) is queued at
    ROADMAP.md queue 1, item 4; this refusal says where it went."""
    raise _roadmap.not_ported("trotter.anneal_wolff_sharded",
                              _roadmap.SHARDED)


def anneal_sw_sharded(*args, **kwargs):
    """The Trotter-sharded Swendsen-Wang engine (JAX trotter.py:794) is
    queued at ROADMAP.md queue 1, item 4; this refusal says where it
    went."""
    raise _roadmap.not_ported("trotter.anneal_sw_sharded", _roadmap.SHARDED)
