#!/usr/bin/env python3
"""JAX CPU anchors of chip_smoke.py's generic main-path solves: the JAX
package's own solve() on the same IsingProblem graphs at the same reads,
sweeps and P, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/generic_anchors.py sa3d
    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/generic_anchors.py chimera \
        [SWEEPS] [SLICES]

sa3d:    solve("sa", 32 reads, 2000 sweeps) on random_3d_lattice(16,
         rng=0), seeds 0 and 1 (64 reads).
chimera: solve("piqmc", 32 reads, SWEEPS sweeps (1000), SLICES slices
         (20)) on chimera_graph(16, rng=0), seed 0; the JAX solve's
         pre-anneal and global moves.

Prints one JSON line: the reads, the mean, sd and least of the energy per
spin over the reads, and the seconds the run took. The JAX package's
solvers draw from jax.random, the port's from the counter hash, so the
port's means are held to these within a range (chip_smoke.py RANGES), not
bitwise. Needs the JAX package; it is a measuring tool, not a part of the
port.
"""

import json
import sys
import time

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

from montecarlosolvers_tpu.models import instances  # noqa: E402
from montecarlosolvers_tpu.solvers.api import solve  # noqa: E402


def main(argv):
    which = argv[0]
    t0 = time.time()
    if which == "sa3d":
        prob, _ = instances.random_3d_lattice(16, rng=0)
        runs = [solve(prob, "sa", num_reads=32, sweeps=2000, seed=seed)
                for seed in (0, 1)]
    elif which == "chimera":
        sweeps = int(argv[1]) if len(argv) > 1 else 1000
        slices = int(argv[2]) if len(argv) > 2 else 20
        prob, _ = instances.chimera_graph(16, rng=0)
        runs = [solve(prob, "piqmc", num_reads=32, sweeps=sweeps, seed=0,
                      slices=slices)]
    else:
        raise SystemExit(f"unknown case {which!r}: sa3d or chimera")
    e = np.concatenate([np.asarray(ss.energies) for ss in runs])
    e = e / prob.nspins
    print(json.dumps({"case": which, "argv": argv, "reads": int(e.size),
                      "mean": float(e.mean()), "sd": float(e.std(ddof=1)),
                      "min": float(e.min()),
                      "seconds": time.time() - t0}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
