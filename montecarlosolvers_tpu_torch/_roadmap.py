"""Where each part of the JAX package that the port does not cover yet is
queued: every refusal in the port names its ROADMAP.md item through here."""

from __future__ import annotations

ODD_P = "queue 1, item 1 (odd-P PIQMC, the generic ops/piqmc.py path)"
GENERIC_PROBLEM = "queue 1, item 3 (generic IsingProblem and instances)"
SVMC = "queue 1, item 4 (SVMC)"
BATH = "queue 1, item 5 (dissipative PIQMC, lookuptable=)"
GENERIC_GRAPHS = "queue 1, item 6 (generic graphs, odd L, anneal_noisy)"
CLUSTER = "queue 1, item 7 (cluster updates)"
SAMPLERS = "queue 1, item 8 (samplers and API)"


def not_ported(what, item):
    """The NotImplementedError the port raises for `what`, queued at
    ROADMAP.md `item`."""
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet: ROADMAP.md {item}"
    )
