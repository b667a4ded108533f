"""The JAX package's anchor for the port's dissipative main path.

Runs the open-system protocol of examples/dissipative_qa.py with the JAX
package on the seeded 80x80 torus (`instances.gaussian_torus(80, 0)` in the
port; the same planes here): sa.random_state -> sa.anneal(pre-anneal
3 -> 1, mcsteps=5) -> qmc.replicate(P) -> qmc.anneal(Gamma: 3 -> 1e-8 over
tau, B = 1, T = 1/P, lookuptable=bath_lookuptable(P, alpha), global
moves). Prints one JSON line with the mean, sd and best of the chains'
best-slice energy per spin: the value chip_smoke.py's range for
`piqmc_bath_p40` is anchored on (PERF.md section 2).

    JAX_PLATFORMS=cpu python tools/jax_bath_anchor.py --tau 1000 --chains 32

takes about 10 minutes on 4 CPU cores.
"""

import argparse
import json
import time

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from montecarlosolvers_tpu import schedules  # noqa: E402
from montecarlosolvers_tpu.models.lattice import LatticeProblem  # noqa: E402
from montecarlosolvers_tpu.solvers import qmc, sa  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tau", type=int, default=1000)
    ap.add_argument("--chains", type=int, default=32)
    ap.add_argument("--slices", type=int, default=40)
    ap.add_argument("--alpha", type=float, default=1e-2)
    args = ap.parse_args()

    P = args.slices
    r = np.random.default_rng(0)
    problem = LatticeProblem.from_planes(r.normal(size=(80, 80)),
                                         r.normal(size=(80, 80)))
    k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
    t0 = time.time()
    s = sa.random_state(k1, problem.nspins, batch=(args.chains,))
    s = sa.anneal(problem, schedules.pre_anneal_schedule(3.0, 1.0), s, k2,
                  mcsteps=5)
    a = schedules.transverse_field(3.0, 1e-8, args.tau)
    confs = qmc.anneal(problem, a, jnp.ones_like(a), 1.0 / P,
                       qmc.replicate(s, P), k3, global_moves=True,
                       lookuptable=schedules.bath_lookuptable(P, args.alpha))
    es = np.asarray(qmc.best_slice_energy(problem, confs)) / problem.nspins
    print(json.dumps({"tau": args.tau, "chains": args.chains, "slices": P,
                      "alpha": args.alpha, "seconds": time.time() - t0,
                      "mean": float(es.mean()), "sd": float(es.std()),
                      "best": float(es.min())}))


if __name__ == "__main__":
    main()
