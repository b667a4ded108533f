"""Disorder realizations spread over hosts (counterpart of
montecarlosolvers_tpu/parallel/multihost.py).

Disorder is embarrassingly parallel: once the realizations are sharded no
rank talks to another, so the disorder axis belongs across hosts and the
chain axis within each host's ranks, as the JAX package puts disorder on
the slow cross-pod links and chains on ICI.

  * `initialize` — an idempotent `torch.distributed.init_process_group`:
    env:// (the variables torchrun sets) or the arguments passed through;
    with neither, a one-rank group, as `mesh.make_mesh` makes one.
  * `dcn_mesh` — a ("disorder", "chains") DeviceMesh whose disorder rows
    each hold one host's ranks, the torch counterpart of JAX's hybrid
    mesh. The host grouping is read from LOCAL_WORLD_SIZE, the ranks a
    host as torchrun sets it (ranks numbered host by host, as torchrun
    numbers them): rank r lies on host r // LOCAL_WORLD_SIZE. Without it
    every rank counts as one host's.
  * `run_disorder_sharded` — each rank runs its (disorder, chains) block
    through `disorder.vmap_disorder`'s engine with the block's first chain
    as chain0 and its realizations' generators, with no communication, so
    the result is the unsharded `vmap_disorder` run bitwise.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from montecarlosolvers_tpu_torch.parallel import mesh as pmesh
from montecarlosolvers_tpu_torch.parallel.disorder import (
    StackedProblem,
    _run,
    stack_problems,
)

# what torchrun sets on every rank (init_method="env://" reads the first four)
_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize(**kwargs):
    """Idempotent `torch.distributed.init_process_group` (JAX `initialize`).
    Pass its arguments (init_method, world_size, rank, backend, ...), or
    none where torchrun set MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE
    (env://). With neither, a one-rank group (NCCL with a card, else gloo).
    The backend defaults to NCCL with a card, else gloo. A group that
    exists is kept. Returns (rank, world size)."""
    if not dist.is_initialized():
        cuda = torch.cuda.is_available()
        if kwargs or all(k in os.environ for k in _ENV):
            kwargs.setdefault("backend", "nccl" if cuda else "gloo")
            if "store" not in kwargs:
                kwargs.setdefault("init_method", "env://")
            dist.init_process_group(**kwargs)
        else:
            pmesh._default_group("cuda" if cuda else "cpu")
    return dist.get_rank(), dist.get_world_size()


def _hosts(world):
    """(hosts, ranks a host) of a group of `world` ranks, from
    LOCAL_WORLD_SIZE (one host when it is not set)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local < 1 or world % local:
        raise ValueError(f"LOCAL_WORLD_SIZE={local} does not divide the "
                         f"{world} ranks into hosts")
    return world // local, local


def dcn_mesh(disorder=None, chains=None, device_type="cuda"):
    """A ("disorder", "chains") DeviceMesh over every rank of the default
    process group (JAX `dcn_mesh`; with no group, a one-rank one).

    One host: the ranks in a (disorder, chains) grid, disorder = all ranks
    by default, or ranks // chains when `chains` is given, and chains =
    ranks // disorder. Several hosts (LOCAL_WORLD_SIZE, module docstring):
    `disorder` must be a multiple of the host count (default: the host
    count, one realization group a host) and chains defaults to ranks //
    disorder; each disorder row then holds ranks of one host only, so the
    rows never talk across hosts. Raises ValueError when the sizes do not
    multiply to the world size. device_type: "cuda" (the card) or "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh

    pmesh._default_group(device_type)
    world = dist.get_world_size()
    hosts, _ = _hosts(world)
    if hosts > 1:
        if disorder is None:
            disorder = hosts
        if chains is None:
            chains = world // disorder
        if disorder % hosts:
            raise ValueError(
                f"disorder={disorder} must be a multiple of the host count "
                f"{hosts} so each realization group stays on one host")
    else:
        if disorder is None:
            disorder = world if chains is None else world // chains
        if chains is None:
            chains = world // disorder
    if disorder < 1 or chains < 1 or disorder * chains != world:
        raise ValueError(f"a ({disorder}, {chains}) disorder x chains mesh "
                         f"needs {disorder * chains} ranks; the process "
                         f"group has {world}")
    return init_device_mesh(device_type, (disorder, chains),
                            mesh_dim_names=("disorder", "chains"))


def shard_disorder_problem(stacked, mesh):
    """The stacked problem with its per-realization tables (nbr_J, h) as
    DTensors sharded on the "disorder" axis of `mesh` (replicated on
    "chains"): each rank keeps its realizations' tables; the topology stays
    whole on every rank (JAX `shard_disorder_problem`). Every rank passes
    the same stacked problem."""
    def put(x):
        return pmesh.as_dtensor(
            pmesh.local_block(x, mesh, {0: "disorder"}), mesh,
            {0: "disorder"}, tuple(x.shape))
    return dataclasses.replace(stacked, nbr_J=put(stacked.nbr_J),
                               h=put(stacked.h))


def run_disorder_sharded(solver_fn, problems, sched, states, generators,
                         mesh, extra_args=()):
    """Run solver_fn(problem, sched, *extra_args, state, generator) over a
    disorder batch sharded (disorder, chains) over `mesh` (JAX
    `run_disorder_sharded`).

    problems: the same-topology IsingProblems, one a realization; sched: a
    schedule every realization shares; extra_args: further shared
    arguments between the schedule and the state; states: (D, C, ..., N),
    disorder-major, then the chain batch; generators: D torch.Generators,
    one stream a realization (JAX's (D,) keys). Every rank passes the same
    arguments, generators in the same state. Each rank runs its block of
    realizations and chains through `vmap_disorder`'s engine (`sa.anneal`:
    one packed SA launch) with the block's first chain as chain0 and its
    realizations' generators, with no communication.

    Returns a DTensor of the solver's (D, C, ...) output sharded (Shard(0),
    Shard(1)) on (disorder, chains) (a tuple of them for a tuple output),
    bitwise the unsharded `vmap_disorder` run."""
    stacked, _ = stack_problems(problems)
    sharded = shard_disorder_problem(stacked, mesh)
    local = StackedProblem(stacked.problem, sharded.nbr_J.to_local(),
                           sharded.h.to_local())
    d, c = int(states.shape[0]), int(states.shape[1])
    if len(generators) != d:
        raise ValueError(f"{len(generators)} generators for {d} "
                         "realizations")
    block = pmesh.local_of(states, mesh, {0: "disorder", 1: "chains"})
    d_loc, c_loc = int(block.shape[0]), int(block.shape[1])
    d0 = pmesh.axis_rank(mesh, "disorder") * d_loc
    chain0 = pmesh.axis_rank(mesh, "chains") * c_loc
    chains = mesh["chains"] if pmesh.axis_size(mesh, "chains") > 1 else None
    out = _run(solver_fn, local, sched, tuple(extra_args),
               (None,) * len(extra_args), block,
               list(generators)[d0:d0 + d_loc], chain0, chains)

    def placed(x):
        return pmesh.as_dtensor(x, mesh, {0: "disorder", 1: "chains"},
                                (d, c) + tuple(x.shape[2:]))
    return tuple(map(placed, out)) if isinstance(out, tuple) else placed(out)
