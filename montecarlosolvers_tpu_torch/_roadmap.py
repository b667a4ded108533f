"""Where each part of the JAX package that the port does not cover yet is
queued: every refusal in the port names its ROADMAP.md item through here."""

from __future__ import annotations

PARALLEL = "queue 1, item 3 (parallel layer)"


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
