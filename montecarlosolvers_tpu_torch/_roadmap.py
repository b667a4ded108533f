"""The port's refusals: a problem that is not one of the port's types
(`require_problem`), and the error a part of the JAX package not ported
yet raises, naming its ROADMAP.md item (`not_ported`; after ROADMAP.md
queue 1 no call of the port raises it). `is_sharded` tells a DTensor
state from a plain one."""

from __future__ import annotations


def require_problem(problem, sparse_only=None):
    """Raise NotImplementedError unless `problem` is one of the port's own
    problem types, a LatticeProblem, an IsingProblem or a DenseProblem (a
    problem of the JAX package must cross through `convert.py` first).
    With `sparse_only`, the name of a call the JAX package does not run on
    a DenseProblem (it runs only SA, PT and PA there), a DenseProblem is
    refused too."""
    from montecarlosolvers_tpu_torch.models.dense import DenseProblem
    from montecarlosolvers_tpu_torch.models.ising import IsingProblem
    from montecarlosolvers_tpu_torch.models.lattice import LatticeProblem

    if not isinstance(problem, (LatticeProblem, IsingProblem, DenseProblem)):
        raise NotImplementedError(
            f"{type(problem).__module__}.{type(problem).__name__} is not a "
            "problem of the port: build a LatticeProblem, an IsingProblem "
            "or a DenseProblem (convert.lattice_from_arrays, "
            "convert.ising_from_arrays and convert.dense_from_arrays carry "
            "the JAX package's across)"
        )
    if sparse_only is not None and isinstance(problem, DenseProblem):
        raise NotImplementedError(
            f"{sparse_only} does not run on a DenseProblem, in the port as "
            "in the JAX package: sa.anneal and solve(method='sa') do")


def not_ported(what, item):
    """The NotImplementedError the port raises for `what`, queued at
    ROADMAP.md `item`."""
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet: ROADMAP.md {item}"
    )


def is_sharded(x):
    """True when `x` is a DTensor (a state placed on a device mesh by
    `parallel.shard_chains` or returned by a sharded engine)."""
    import torch.distributed as dist

    if not dist.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)

