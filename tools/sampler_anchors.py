#!/usr/bin/env python3
"""JAX CPU anchors of chip_smoke.py's sampler solves: the JAX package's own
pt.sample and solve() with the methods "pt", "icm", "pa" and "paq", at the
problems, ladders, sweeps and options of the chip run, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/sampler_anchors.py \
        pt_sample|qpt_sample|qpt_generic|pt|pt_dense|icm|pa|pa_adaptive|paq \
        [READS] [SWEEPS] [SEED]

pt_sample    pt.sample on the seeded 80x80 Gaussian torus (the port's
             gaussian_torus(80, 0)), bench/pt_value.py's ladder (48 rungs,
             geometric T 0.5 -> 2.5), 2000 sweeps, swap_every=2,
             collect_energy: the cold rung's energy per spin averaged over
             the second half of the run, and the swap rate. READS is
             ignored (one ladder).
qpt_sample   pt.sample_piqmc on the torus, bench/pt_value.py's quantum
             ladder (48 rungs, geometric Gamma 1.5 -> 0.3, P = 20, T =
             1/P), 500 sweeps, swap_every=2, line moves, from random
             paths: the lowest-Gamma rung's mean slice energy per spin at
             the end, and the swap rate.
qpt_generic  the same on random_3d_lattice(12, rng=0), 16 rungs, P = 8,
             300 sweeps (the generic PIQMC engine).
pt           solve("pt", READS (8; the chip runs 64), SWEEPS (500)) on the
             torus: the auto ladder (110 rungs at N = 6400), each read's
             coldest rung.
pt_dense     solve("pt", READS (8; the chip 16), SWEEPS (200)) on
             sk_model(2048, rng=0) (the dense engine; 63 rungs).
icm          solve("icm", READS (8; the chip 32), SWEEPS (1000),
             ladder=24, bench/icm_value.py's RUNGS) on the 3-D +/-J glass
             random_3d_lattice(12, rng=0).
pa           solve("pa", READS (1024, bench/pa_value.py's REPLICAS),
             SWEEPS (500)) on the torus: the beta-linear grid to
             beta_end = 10; log_z and min_ess_frac.
pa_adaptive  solve("pa", READS (1024), SWEEPS (2000 = max_steps),
             adaptive=True, beta_end=2.0: bench/pa_value.py's sampling
             target T = 0.5) on the torus: n_steps, reached, log_z.
paq          solve("paq", READS (8; the chip 32), SWEEPS (500), slices=20)
             on the torus: min_ess_frac, families.

Prints one JSON line: the reads, the mean, sd and least of the energy per
spin over the reads, the solve's info and the seconds the run took. The
JAX package draws from jax.random, the port from the counter hash, so
chip_smoke.py holds the port's values to these within a range (its
RANGES), not bitwise. Needs the JAX package; it is a measuring tool, not a
part of the port.
"""

import json
import sys
import time

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from montecarlosolvers_tpu.models import instances  # noqa: E402
from montecarlosolvers_tpu.models.lattice import LatticeProblem  # noqa: E402
from montecarlosolvers_tpu.solvers import pt, sa  # noqa: E402
from montecarlosolvers_tpu.solvers.api import solve  # noqa: E402

L = 80
PT_RUNGS, PT_SWEEPS, PT_COLD, PT_HOT, PT_SWAP = 48, 2000, 0.5, 2.5, 2
# case -> (problem, reads, sweeps, solve method, solve options)
CASES = {
    "pt_sample": ("torus", 1, PT_SWEEPS, None, {}),
    "qpt_sample": ("torus", 1, 500, None, {"rungs": 48, "slices": 20}),
    "qpt_generic": ("glass3d", 1, 300, None, {"rungs": 16, "slices": 8}),
    "pt_dense": ("sk", 8, 200, "pt", {}),
    "pt": ("torus", 8, 500, "pt", {}),
    "icm": ("glass3d", 8, 1000, "icm", {"ladder": 24}),
    "pa": ("torus", 1024, 500, "pa", {}),
    "pa_adaptive": ("torus", 1024, 2000, "pa", {"adaptive": True,
                                                "beta_end": 2.0}),
    "paq": ("torus", 8, 500, "paq", {"slices": 20}),
}


def problem_of(name):
    if name == "torus":
        r = np.random.default_rng(0)
        return LatticeProblem.from_planes(r.normal(size=(L, L)),
                                          r.normal(size=(L, L)))
    if name == "sk":
        return instances.sk_model(2048, rng=0)[0]
    return instances.random_3d_lattice(12, rng=0)[0]


def pt_sample(prob, sweeps, seed):
    """bench/pt_value.py's PT arm: the cold rung's time-averaged energy."""
    k_init, k_run = jax.random.split(jax.random.key(seed))
    s0 = sa.random_state(k_init, prob.nspins, batch=(PT_RUNGS,))
    temps = pt.geometric_ladder(PT_COLD, PT_HOT, PT_RUNGS)
    _, rate, es = pt.sample(prob, temps, s0, k_run, sweeps,
                            swap_every=PT_SWAP, collect_energy=True)
    es = np.asarray(es) / prob.nspins  # (sweeps, M), rung 0 the coldest
    return {"cold_mean": float(es[sweeps // 2:, 0].mean()),
            "swap_rate": float(rate)}


def qpt_sample(prob, sweeps, seed, rungs, slices):
    """bench/pt_value.py's quantum PT arm, from random paths: the lowest
    Gamma rung's mean slice energy at the end."""
    k_init, k_run = jax.random.split(jax.random.key(seed))
    confs = jnp.where(jax.random.bernoulli(
        k_init, 0.5, (rungs, slices, prob.nspins)), 1.0, -1.0)
    gammas = jnp.geomspace(1.5, 0.3, rungs).astype(jnp.float32)
    confs, rate = pt.sample_piqmc(prob, gammas, 1.0 / slices, confs, k_run,
                                  sweeps, swap_every=2, global_moves=True)
    e = np.asarray(prob.energy(confs[-1])) / prob.nspins  # (P,)
    return {"low_gamma_mean": float(e.mean()), "swap_rate": float(rate)}


def main(argv):
    which = argv[0]
    if which not in CASES:
        raise SystemExit(f"unknown case {which!r}: {', '.join(CASES)}")
    pname, reads, sweeps, method, kw = CASES[which]
    reads = int(argv[1]) if len(argv) > 1 else reads
    sweeps = int(argv[2]) if len(argv) > 2 else sweeps
    seed = int(argv[3]) if len(argv) > 3 else 0
    t0 = time.time()
    prob = problem_of(pname)
    rec = {"case": which, "problem": pname, "reads": reads,
           "sweeps": sweeps, "seed": seed, "options": kw}
    if which == "pt_sample":
        rec.update(pt_sample(prob, sweeps, seed))
    elif method is None:
        rec.update(qpt_sample(prob, sweeps, seed, **kw))
    else:
        ss = solve(prob, method, num_reads=reads, sweeps=sweeps, seed=seed,
                   **kw)
        e = np.asarray(ss.energies) / prob.nspins
        rec.update({"mean": float(e.mean()), "sd": float(e.std(ddof=1)),
                    "min": float(e.min()),
                    "info": {k: (float(v) if isinstance(
                        v, (np.floating, jnp.ndarray)) else v)
                        for k, v in ss.info.items()}})
    rec["seconds"] = time.time() - t0
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
