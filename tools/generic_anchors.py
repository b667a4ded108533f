#!/usr/bin/env python3
"""JAX CPU anchors of chip_smoke.py's generic main-path solves: the JAX
package's own solve() on the same IsingProblem graphs at the same reads,
sweeps and P, on the CPU; and of its dense and noisy solves.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/generic_anchors.py sa3d
    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/generic_anchors.py chimera \
        [SWEEPS] [SLICES]
    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/generic_anchors.py sk [READS]
    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/generic_anchors.py \
        noisy_sa|noisy_svmc [READS]

sa3d:    solve("sa", 32 reads, 2000 sweeps) on random_3d_lattice(16,
         rng=0), seeds 0 and 1 (64 reads).
chimera: solve("piqmc", 32 reads, SWEEPS sweeps (1000), SLICES slices
         (20)) on chimera_graph(16, rng=0), seed 0; the JAX solve's
         pre-anneal and global moves.
sk:      solve("sa", READS reads (64), 1000 sweeps) on sk_model(2048,
         rng=0), the dense engine, seed 0.
noisy_sa / noisy_svmc: sa.anneal_noisy (T 3 -> 0) or svmc.anneal_noisy
         (TF, A 3 -> 1e-8, B = 1, T = 0.05) over NOISY_STEPS steps on the
         seeded 80x80 Gaussian torus's to_generic(), READS chains (64), key
         0, on the per-step tables of `noisy_tables` (chip_smoke.py builds
         the same); the energy is the static problem's, of the spins or of
         the z-projection.

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

import jax.numpy as jnp  # noqa: E402

from montecarlosolvers_tpu import schedules  # noqa: E402
from montecarlosolvers_tpu.models import instances  # noqa: E402
from montecarlosolvers_tpu.models.lattice import LatticeProblem  # noqa: E402
from montecarlosolvers_tpu.solvers import sa, svmc  # noqa: E402
from montecarlosolvers_tpu.solvers.api import solve  # noqa: E402

NOISY_L, NOISY_STEPS, NOISY_SEED, NOISY_SCALE = 80, 1000, 0, 0.1


def noisy_tables(nbr_J, h, steps=NOISY_STEPS, seed=NOISY_SEED):
    """Per-step tables nbr_J_t = nbr_J * (1 + 0.1 xi_t), h_t = h, xi a
    float32 standard normal of shape (steps,) + nbr_J.shape from
    default_rng(seed); float32 throughout (chip_smoke.py::noisy_tables)."""
    xi = np.random.default_rng(seed).standard_normal(
        (steps,) + nbr_J.shape, dtype=np.float32)
    tables = nbr_J * (np.float32(1.0) + np.float32(NOISY_SCALE) * xi)
    return tables, np.broadcast_to(h, (steps,) + h.shape)


def noisy_run(which, reads):
    r = np.random.default_rng(0)
    lat = LatticeProblem.from_planes(r.normal(size=(NOISY_L, NOISY_L)),
                                     r.normal(size=(NOISY_L, NOISY_L)))
    prob = lat.to_generic()
    jt, ht = noisy_tables(np.asarray(prob.nbr_J), np.asarray(prob.h))
    jt, ht = jnp.asarray(jt), jnp.asarray(ht)
    k_init, k_run = jax.random.split(jax.random.key(0))
    if which == "noisy_sa":
        s0 = sa.random_state(k_init, prob.nspins, batch=(reads,))
        out = sa.anneal_noisy(prob, schedules.linear(3.0, 0.0, NOISY_STEPS),
                              jt, ht, s0, k_run)
    else:
        th = svmc.random_state(k_init, prob.nspins, batch=(reads,))
        a = schedules.linear(3.0, 1e-8, NOISY_STEPS)
        out = svmc.z_projection(svmc.anneal_noisy(
            prob, a, jnp.ones_like(a), 0.05, jt, ht, th, k_run, tf=True))
    return prob, np.asarray(prob.energy(out))


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
    elif which == "sk":
        reads = int(argv[1]) if len(argv) > 1 else 64
        prob, _ = instances.sk_model(2048, rng=0)
        runs = [solve(prob, "sa", num_reads=reads, sweeps=1000, seed=0)]
    elif which in ("noisy_sa", "noisy_svmc"):
        prob, e = noisy_run(which, int(argv[1]) if len(argv) > 1 else 64)
        runs = []
    else:
        raise SystemExit(f"unknown case {which!r}: sa3d, chimera, sk, "
                         "noisy_sa or noisy_svmc")
    if runs:
        e = np.concatenate([np.asarray(ss.energies) for ss in runs])
    e = e / prob.nspins
    print(json.dumps({"case": which, "argv": argv, "reads": int(e.size),
                      "mean": float(e.mean()), "sd": float(e.std(ddof=1)),
                      "min": float(e.min()),
                      "seconds": time.time() - t0}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
