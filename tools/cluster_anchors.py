#!/usr/bin/env python3
"""JAX CPU anchors of chip_smoke.py's cluster solves: the JAX package's own
solve() with the five cluster methods on the seeded 80x80 Gaussian torus's
generic form, at the same reads, sweeps, P and bath strength as the chip
run, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/cluster_anchors.py \
        sa_wolff|sa_sw|piqmc_wolff|piqmc_sw|piqmc_sw_full [READS] [SWEEPS]

sa_wolff, sa_sw:  solve(method, READS reads (64), SWEEPS sweeps (200)),
                  T 3 -> 0.05 with a colored sweep before each cluster move.
piqmc_wolff:      solve("piqmc_wolff", READS (8), SWEEPS (50), slices=40):
                  the pre-anneal, then one Wolff cluster a chain and sweep.
piqmc_sw:         solve("piqmc_sw", ..., slices=40, alpha=1e-2): WC3, the
                  full Swendsen-Wang line decomposition a color phase.
piqmc_sw_full:    solve("piqmc_sw_full", ..., slices=40): a local sweep and
                  a space-time Swendsen-Wang sweep a step.

The torus is LatticeProblem.from_planes of two (80, 80) standard normals
of default_rng(0), right then down (the port's gaussian_torus(80, 0)),
taken to_generic(); the solve's seed is 0. Prints one JSON line: the
reads, the mean, sd and least of the energy per spin over the reads, and
the seconds the run took. The JAX package draws from jax.random, the port
from the counter hash, so chip_smoke.py holds the port's means to these
within a range (its RANGES), not bitwise. Needs the JAX package; it is a
measuring tool, not a part of the port.
"""

import json
import sys
import time

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

from montecarlosolvers_tpu.models.lattice import LatticeProblem  # noqa: E402
from montecarlosolvers_tpu.solvers.api import solve  # noqa: E402

L, SLICES, ALPHA = 80, 40, 1e-2
# method -> (reads, sweeps, solve options) of chip_smoke.py's cluster solves
CASES = {
    "sa_wolff": (64, 200, {}),
    "sa_sw": (64, 200, {}),
    "piqmc_wolff": (8, 50, {"slices": SLICES}),
    "piqmc_sw": (8, 50, {"slices": SLICES, "alpha": ALPHA}),
    "piqmc_sw_full": (8, 50, {"slices": SLICES}),
}


def torus_generic():
    r = np.random.default_rng(0)
    return LatticeProblem.from_planes(r.normal(size=(L, L)),
                                      r.normal(size=(L, L))).to_generic()


def main(argv):
    which = argv[0]
    if which not in CASES:
        raise SystemExit(f"unknown case {which!r}: {', '.join(CASES)}")
    reads, sweeps, kw = CASES[which]
    reads = int(argv[1]) if len(argv) > 1 else reads
    sweeps = int(argv[2]) if len(argv) > 2 else sweeps
    t0 = time.time()
    prob = torus_generic()
    ss = solve(prob, which, num_reads=reads, sweeps=sweeps, seed=0, **kw)
    e = np.asarray(ss.energies) / prob.nspins
    print(json.dumps({"case": which, "reads": reads, "sweeps": sweeps,
                      "options": kw, "mean": float(e.mean()),
                      "sd": float(e.std(ddof=1)), "min": float(e.min()),
                      "seconds": time.time() - t0}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
