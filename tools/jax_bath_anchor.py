"""The JAX package's anchors for the port's dissipative main-path solves.

Runs the open-system protocol of examples/dissipative_qa.py with the JAX
package on the CPU: sa.random_state -> sa.anneal(pre-anneal 3 -> 1,
mcsteps=5) -> qmc.replicate(P) -> qmc.anneal(Gamma: 3 -> 1e-8 over tau,
B = 1, T = 1/P, lookuptable=bath_lookuptable(P, alpha), global moves,
bath_update). The problem (--problem):

  torus     the seeded L x L Gaussian torus as a LatticeProblem
            (`instances.gaussian_torus(L, 0)` in the port; the same planes
            here): the split bath engine at even L (at odd P and
            bath_update="colored", the masked sweep), the masked sweep at
            odd L;
  nbtable   the same torus as compat.DissipativeQuantumAnneal builds it,
            IsingProblem.from_neighbor_table of its reference-format
            (N, 4, 2) table (each site's right, then down bond, in
            row-major order): the masked sweep;
  chimera   instances.chimera_graph(16, rng=0): the masked sweep.

Prints one JSON line with the mean, sd and best of the chains'
best-slice energy per spin: the values chip_smoke.py's ranges for the bath
solves are anchored on (PERF.md section 2).

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/jax_bath_anchor.py \
        --problem torus --L 80 --tau 1000 --chains 32

took 578 s on 4 CPU cores at tau = 1000 (P = 40); the masked sweeps take
longer a sweep than the split engine.
"""

import argparse
import json
import time

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from montecarlosolvers_tpu import schedules  # noqa: E402
from montecarlosolvers_tpu.models import instances  # noqa: E402
from montecarlosolvers_tpu.models.ising import (  # noqa: E402
    IsingProblem, build_neighbor_table)
from montecarlosolvers_tpu.models.lattice import LatticeProblem  # noqa: E402
from montecarlosolvers_tpu.solvers import qmc, sa  # noqa: E402


def torus_planes(L):
    r = np.random.default_rng(0)
    return r.normal(size=(L, L)), r.normal(size=(L, L))


def neighbor_table(L):
    """The reference-format (N, 4, 2) table of the seeded L x L torus:
    each site's right, then down bond, sites in row-major order."""
    jr, jd = torus_planes(L)
    rows, cols, vals = [], [], []
    for i in range(L * L):
        y, x = divmod(i, L)
        rows += [i, i]
        cols += [y * L + (x + 1) % L, ((y + 1) % L) * L + x]
        vals += [jr[y, x], jd[y, x]]
    return build_neighbor_table(L * L, rows, cols, vals, 4)


def problem_of(args):
    if args.problem == "torus":
        return LatticeProblem.from_planes(*torus_planes(args.L))
    if args.problem == "nbtable":
        return IsingProblem.from_neighbor_table(neighbor_table(args.L))
    return instances.chimera_graph(16, rng=0)[0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", choices=("torus", "nbtable", "chimera"),
                    default="torus")
    ap.add_argument("--L", type=int, default=80)
    ap.add_argument("--tau", type=int, default=1000)
    ap.add_argument("--chains", type=int, default=32)
    ap.add_argument("--slices", type=int, default=40)
    ap.add_argument("--alpha", type=float, default=1e-2)
    ap.add_argument("--bath-update", default="sequential",
                    choices=("sequential", "colored"))
    args = ap.parse_args()

    P = args.slices
    problem = problem_of(args)
    k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
    t0 = time.time()
    s = sa.random_state(k1, problem.nspins, batch=(args.chains,))
    s = sa.anneal(problem, schedules.pre_anneal_schedule(3.0, 1.0), s, k2,
                  mcsteps=5)
    a = schedules.transverse_field(3.0, 1e-8, args.tau)
    confs = qmc.anneal(problem, a, jnp.ones_like(a), 1.0 / P,
                       qmc.replicate(s, P), k3, global_moves=True,
                       lookuptable=schedules.bath_lookuptable(P, args.alpha),
                       bath_update=args.bath_update)
    es = np.asarray(qmc.best_slice_energy(problem, confs)) / problem.nspins
    print(json.dumps({"problem": args.problem, "L": args.L, "tau": args.tau,
                      "chains": args.chains, "slices": P,
                      "alpha": args.alpha, "bath_update": args.bath_update,
                      "seconds": time.time() - t0, "mean": float(es.mean()),
                      "sd": float(es.std()), "best": float(es.min())}))


if __name__ == "__main__":
    main()
