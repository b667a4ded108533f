"""Where each part of the JAX package that the port does not cover yet is
queued: every refusal in the port names its ROADMAP.md item through here."""

from __future__ import annotations

GENERIC_PROBLEM = ("queue 1, item 2 (generic IsingProblem and instances, "
                   "the generic ops/piqmc.py sweeps)")
BATH = ("queue 1, item 3 (what is left of dissipative PIQMC: odd-L "
        "lattices, bath_update='colored')")
GENERIC_GRAPHS = "queue 1, item 4 (generic graphs, anneal_noisy)"
CLUSTER = "queue 1, item 5 (cluster updates)"
SAMPLERS = "queue 1, item 6 (samplers and API)"


def require_lattice(problem):
    """Raise NotImplementedError unless `problem` is a LatticeProblem, the
    only problem the port takes yet (any L, open or periodic)."""
    from montecarlosolvers_tpu_torch.models.lattice import LatticeProblem

    if not isinstance(problem, LatticeProblem):
        raise not_ported("a problem other than a LatticeProblem",
                         GENERIC_PROBLEM)


def not_ported(what, item):
    """The NotImplementedError the port raises for `what`, queued at
    ROADMAP.md `item`."""
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet: ROADMAP.md {item}"
    )
