"""Device meshes on torch.distributed (counterpart of
montecarlosolvers_tpu/parallel/mesh.py).

Axes, as in the JAX package:
  "chains"   — independent annealing trajectories (data parallel);
  "replica"  — Trotter slices (model parallel, a ring: parallel/trotter.py);
  "disorder" — coupling realizations of one topology, no communication
               (parallel/disorder.py, its mesh parallel/multihost.py).

A `DeviceMesh` stands in for `jax.sharding.Mesh`, and a DTensor whose
placements put `Shard(0)` on "chains" and `Replicate()` elsewhere for a
`NamedSharding` of the chain axis. The solvers run a chain-sharded state
block by block with no communication: each rank anneals its own chains,
whose counter-hash uids count from the block's global first chain, so the
result equals the unsharded run bitwise (tests/test_torch_parallel.py).
Every rank passes the same full state, as JAX replicates its key, and the
same generator state.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

AXES = ("chains", "replica", "disorder")


def _default_group(device_type):
    """Initialise a one-rank default process group when none exists (a
    single process asking for a mesh, as a JAX program on one device
    does): NCCL for the card, gloo for the CPU, on an in-memory store."""
    if dist.is_initialized():
        return
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise RuntimeError(
            "WORLD_SIZE > 1 but no process group is initialised: call "
            "torch.distributed.init_process_group on every rank first")
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_mesh(chains=None, replica=None, device_type="cuda"):
    """A DeviceMesh with dims "chains" and/or "replica" over all ranks of
    the default process group (JAX mesh.py:19). With neither size given
    every rank lies on "chains"; with one given, the mesh is that axis
    alone; with both, (chains, replica), replica varying fastest, and
    their product must be the world size. With no process group, a one-rank
    group is made (NCCL on the card, gloo on the CPU). device_type:
    "cuda" (the default, the card) or "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh

    _default_group(device_type)
    world = dist.get_world_size()
    if chains is None and replica is None:
        chains = world
    sizes = [(n, s) for n, s in zip(("chains", "replica"), (chains, replica))
             if s is not None]
    if any(s < 1 for _, s in sizes):
        raise ValueError(f"mesh axis sizes must be >= 1, got {dict(sizes)}")
    if math.prod(s for _, s in sizes) != world:
        raise ValueError(f"a mesh of {dict(sizes)} needs "
                         f"{math.prod(s for _, s in sizes)} ranks; the "
                         f"process group has {world}")
    return init_device_mesh(device_type, tuple(s for _, s in sizes),
                            mesh_dim_names=tuple(n for n, _ in sizes))


def chain_sharding(mesh, ndim):
    """The placements (one a mesh dim) that put the leading (chain) axis of
    an `ndim`-dimensional state on "chains" and replicate it elsewhere
    (JAX mesh.py:35)."""
    from torch.distributed.tensor import Replicate, Shard

    if ndim < 2:
        raise ValueError("a chain-sharded state has a leading chain axis "
                         f"and at least one more; got ndim = {ndim}")
    if "chains" not in mesh.mesh_dim_names:
        raise ValueError("the mesh has no 'chains' axis")
    return [Shard(0) if name == "chains" else Replicate()
            for name in mesh.mesh_dim_names]


def axis_size(mesh, name):
    """The size of mesh axis `name`, 1 if the mesh lacks it."""
    if name not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_rank(mesh, name):
    """This rank's coordinate on mesh axis `name`, 0 if the mesh lacks it."""
    if name not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(name)


def local_block(full, mesh, dims):
    """This rank's block of the full tensor `full`: dims = {tensor dim:
    mesh axis name}, each dim split evenly over its axis (ValueError if the
    axis does not divide it)."""
    block = full
    for dim, name in dims.items():
        n, size = full.shape[dim], axis_size(mesh, name)
        if n % size:
            raise ValueError(f"{n} along dim {dim} does not divide by the "
                             f"{name!r} axis size {size}")
        step = n // size
        block = block.narrow(dim, axis_rank(mesh, name) * step, step)
    return block.contiguous()


def as_dtensor(local, mesh, dims, shape):
    """A DTensor of global `shape` from this rank's block `local`, sharded
    as dims = {tensor dim: mesh axis name} and replicated on the other mesh
    axes."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    by_axis = {name: dim for dim, name in dims.items()}
    placements = [Shard(by_axis[name]) if name in by_axis else Replicate()
                  for name in mesh.mesh_dim_names]
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def shard_chains(state, mesh):
    """Shard a (chains, ...) state over the "chains" mesh axis (JAX
    mesh.py:42): a DTensor, Shard(0) on "chains", replicated elsewhere.
    Every rank passes the same full state and keeps its own block. A chain
    count the axis does not divide raises ValueError."""
    chain_sharding(mesh, state.ndim)  # validates ndim and the axis
    return as_dtensor(local_block(state, mesh, {0: "chains"}), mesh,
                      {0: "chains"}, tuple(state.shape))


def chain_block(state, dim=0):
    """(local, chain0, mesh) of a DTensor `state` sharded Shard(dim) on the
    mesh's "chains" axis and replicated elsewhere: this rank's block, the
    global index of its first chain along `dim`, and the mesh. A state
    placed any other way raises ValueError."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = state.device_mesh
    if state.ndim < dim + 2:
        raise ValueError(f"a state sharded on dim {dim} needs a chain axis "
                         "there and at least one more")
    for name, pl in zip(mesh.mesh_dim_names, state.placements):
        want = Shard(dim) if name == "chains" else Replicate()
        if pl != want:
            raise ValueError(
                f"the solvers take a state sharded Shard({dim}) on 'chains' "
                f"and replicated elsewhere (parallel.shard_chains); got "
                f"{list(state.placements)} on {mesh.mesh_dim_names}; a "
                "Trotter-sharded state runs on parallel.trotter")
    size = axis_size(mesh, "chains")
    chain0 = axis_rank(mesh, "chains") * -(-state.shape[dim] // size)
    return state.to_local(), chain0, mesh


def run_chain_sharded(state, fn):
    """Run a solver on a chain-sharded DTensor `state` block by block:
    fn(local, chain0) -> out or (out, energies) on this rank's chains, with
    chain0 the global index of its first chain, whose hash uids the block
    then draws. Returns DTensors of the same placements: the state's, and
    energies (steps, chains, ...) sharded on their chain axis, dim 1.
    A state sharded any other way raises ValueError (`chain_block`)."""
    local, chain0, mesh = chain_block(state)
    out = fn(local, chain0)
    energies = None
    if isinstance(out, tuple):
        out, energies = out
    shape = tuple(state.shape)
    res = as_dtensor(out, mesh, {0: "chains"}, shape)
    if energies is None:
        return res
    eshape = list(energies.shape)
    eshape[1] = shape[0]
    return res, as_dtensor(energies, mesh, {1: "chains"}, eshape)


def full_tensor(x):
    """The full tensor of a DTensor `x` on every rank (a plain tensor is
    returned as it is): each mesh axis that shards it gathers its blocks,
    the last mesh axis first, as DTensor nests them
    (`_collectives.gather`, staged through host memory under gloo for a
    tensor on the card, where DTensor's own redistribution would hand
    gloo a device tensor)."""
    from torch.distributed.tensor import Replicate, Shard

    from montecarlosolvers_tpu_torch import _roadmap
    from montecarlosolvers_tpu_torch.parallel import _collectives

    if not _roadmap.is_sharded(x):
        return x
    out = x.to_local()
    mesh = x.device_mesh
    for name, pl in reversed(list(zip(mesh.mesh_dim_names, x.placements))):
        if isinstance(pl, Shard):
            out = _collectives.gather(out, mesh.get_group(name), pl.dim)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"cannot gather a {pl} placement")
    return out


def local_of(x, mesh, dims):
    """This rank's block of `x` split as dims = {tensor dim: mesh axis
    name} over `mesh` and replicated on its other axes, each split dim
    divided evenly (ValueError if not). Of a tensor every rank passes
    whole: its block (`local_block`). Of a DTensor on `mesh` that is so
    placed, or replicated where dims splits it: its local tensor, cut where
    it is replicated, with no message. Of any other DTensor: the block of
    its full tensor (`full_tensor`, which gathers it)."""
    from torch.distributed.tensor import Replicate, Shard

    from montecarlosolvers_tpu_torch import _roadmap

    if not _roadmap.is_sharded(x):
        return local_block(x, mesh, dims)
    for dim, name in dims.items():
        if x.shape[dim] % axis_size(mesh, name):
            raise ValueError(f"{x.shape[dim]} along dim {dim} does not "
                             f"divide by the {name!r} axis size "
                             f"{axis_size(mesh, name)}")
    by_axis = {name: dim for dim, name in dims.items()}
    names = mesh.mesh_dim_names
    want = [Shard(by_axis[n]) if n in by_axis else Replicate() for n in names]
    if x.device_mesh == mesh and all(
            p == w or (p == Replicate() and isinstance(w, Shard))
            for p, w in zip(x.placements, want)):
        cut = {w.dim: n for n, p, w in zip(names, x.placements, want)
               if p != w}
        return local_block(x.to_local(), mesh, cut)
    return local_block(full_tensor(x), mesh, dims)
