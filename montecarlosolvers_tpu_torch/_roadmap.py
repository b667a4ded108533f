"""Where each part of the JAX package that the port does not cover yet is
queued: every refusal in the port names its ROADMAP.md item through here."""

from __future__ import annotations

GENERIC_GRAPHS = ("queue 1, item 2 (generic graphs: DenseProblem, "
                  "anneal_noisy, the packed noisy scans)")
CLUSTER = "queue 1, item 3 (cluster updates)"
SAMPLERS = "queue 1, item 4 (samplers and API)"
PARALLEL = "queue 1, item 5 (parallel layer)"


def require_problem(problem):
    """Raise NotImplementedError unless `problem` is one of the port's own
    problem types, a LatticeProblem or an IsingProblem (a problem of the
    JAX package must cross through `convert.py` first)."""
    from montecarlosolvers_tpu_torch.models.ising import IsingProblem
    from montecarlosolvers_tpu_torch.models.lattice import LatticeProblem

    if not isinstance(problem, (LatticeProblem, IsingProblem)):
        raise NotImplementedError(
            f"{type(problem).__module__}.{type(problem).__name__} is not a "
            "problem of the port: build a LatticeProblem or an IsingProblem "
            "(convert.lattice_from_arrays / convert.ising_from_arrays carry "
            "the JAX package's across)"
        )


def not_ported(what, item):
    """The NotImplementedError the port raises for `what`, queued at
    ROADMAP.md `item`."""
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet: ROADMAP.md {item}"
    )
