#!/usr/bin/env python3
"""JAX CPU anchors of chip_smoke.py's phases `api_surface` and `studies`:
the JAX package's own compat shims, value studies and examples at the
shapes of the chip run, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/compat_anchors.py CASE \
        [SEEDS]

The problem is the seeded 80x80 Gaussian torus (the port's
gaussian_torus(80, 0): LatticeProblem.from_planes of two (80, 80) standard
normals of default_rng(0), right then down), or its reference-format
(6400, 4, 2) neighbor table (each site's right, then down bond, in
row-major order) for the shims. The studies take e_gs = -sum |J_ij|, a
certified lower bound of the energy.

Shim cases (compat.<name>, one JAX seed a run unless said):
  anneal          Anneal, 64 reads (svec (64, 6400)), T 3 -> 0 over 2000
                  steps, from default_rng(seed) +/-1 spins.
  qmc_global      QuantumAnnealGlobal, one chain (confs (6400, 40)), A 3 ->
                  1e-8 over 500 steps, B 1, T 1/40, from one tiled random
                  spin vector; SEEDS runs (8).
  bath_global     DissipativeQuantumAnnealGlobal, the same at 200 steps with
                  bath_lookuptable(40, 1e-2); SEEDS runs (8).
  wc3             DissipativeQuantumAnnealWC3, the same at 20 steps; SEEDS
                  runs (8).
  svmc_tf         SpinVectorMonteCarloTFCompact, 32 reads (the chip runs
                  256), A 3 -> 1e-8 over 2000 steps, B 1, T 0.05, from
                  uniform [0, pi] angles.
  noisy_anneal    NoisyAnneal, 64 reads, 200 steps of T 3 -> 0 on the table
                  with J_t = J (1 + 0.1 xi_t), xi default_rng(0) normals.
  noisy_svmc      NoisySVMCTF, 64 reads, 200 steps of A 3 -> 1e-8, T 0.05,
                  on the same tables.
Each prints the mean, sd (of one read, or of one run's value) and least
energy per spin: SA the state's, PIQMC the mean over slices, SVMC the
z-projection's.

Study cases (records of the JAX study functions at the chip's constants;
SEEDS keys, 3 unless said):
  pt_value        sampling, optimization, quantum and ICM arms: RUNGS 48,
                  SWEEPS 200, Q_RUNGS 48, Q_SLICES 20, Q_SWEEPS 50.
  pa_value        sampling and optimization arms: REPLICAS 1024, SWEEPS 50.
  icm_value       run_instance(12, seed 0): RUNGS 24, SEG 500, 2 segments,
                  one rep, cadences 2, 8, 32 (SEEDS keys, 2).
  cluster_value   baseline_arm and mixed_arm at CHAINS 8 (the chip runs
                  32), P 40, tau 200, n_cl 10, with and without the bath.
  crossover       run_arm at L 32, P 4, 16 chains, Gamma 0.1, T_c, 2048
                  sweeps after 256 (wolff_every 0, 1, 4), and
                  run_classical_arm at L 32, T_c, each move: the mean m^2,
                  tau_int and (run_arm) the Wolff flip fraction (SEEDS
                  keys, 8).
  ladder          ladder_calibration._measure on random_2d_lattice(80,
                  rng=80): the swap rate (SEEDS keys, 8).
Example cases:
  migration       examples/compat_migration.py's body at L 16, seeds (s, s
                  + 1, s + 2) for s in 0..SEEDS-1 (8): SA and PIQMC energy
                  per spin.
  cluster_and_pt  examples/cluster_and_pt.py's main on the torus's generic
                  form with e_gs = -sum |J|: --tau 200 --chains 8 --rungs
                  48 --pt-sweeps 100 --slices 8, SEEDS runs (3) with the
                  example's key offset by the run.

Prints one JSON line a case. The JAX package draws from jax.random, the
port from the counter hash, so chip_smoke.py holds the port's values to
these within a range (its RANGES), not bitwise. Needs the JAX package; it
is a measuring tool, not a part of the port.
"""

import contextlib
import io
import json
import sys
import time

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

from montecarlosolvers_tpu import compat  # noqa: E402
from montecarlosolvers_tpu.models.ising import (  # noqa: E402
    build_neighbor_table)
from montecarlosolvers_tpu.models.lattice import LatticeProblem  # noqa: E402

L = 80
N = L * L
SHIM_P, SHIM_ALPHA = 40, 1e-2
NOISY_STEPS, NOISY_SCALE = 200, 0.1


def torus():
    r = np.random.default_rng(0)
    jr, jd = r.normal(size=(L, L)), r.normal(size=(L, L))
    return LatticeProblem.from_planes(jr, jd), jr, jd


def bound(jr, jd):
    return -float(np.abs(jr).sum() + np.abs(jd).sum())


def torus_table(jr, jd):
    i = np.arange(N)
    y, x = np.divmod(i, L)
    rows = np.repeat(i, 2)
    cols = np.stack([y * L + (x + 1) % L, ((y + 1) % L) * L + x], 1).ravel()
    vals = np.stack([jr[y, x], jd[y, x]], 1).ravel()
    return build_neighbor_table(N, rows, cols, vals, 4)


def noisy_table(nbs):
    xi = np.random.default_rng(0).normal(size=(NOISY_STEPS,) + nbs.shape[:2])
    t = np.broadcast_to(nbs, (NOISY_STEPS,) + nbs.shape).copy()
    t[..., 1] *= 1.0 + NOISY_SCALE * xi
    return t


def table_energy(nbs, s):
    """Energy of (..., N) spins on a reference table (no fields here)."""
    idx = nbs[:, :, 0].astype(np.int64)
    val = nbs[:, :, 1]
    s = np.asarray(s, np.float64)
    return 0.5 * np.sum(s * np.sum(val * s[..., idx], axis=-1), axis=-1)


def stats(values):
    v = np.asarray(values, np.float64)
    return {"mean": float(v.mean()),
            "sd": float(v.std(ddof=1)) if v.size > 1 else 0.0,
            "min": float(v.min()), "n": int(v.size)}


def z_of(theta):
    return np.where(np.cos(theta) >= 0, 1.0, -1.0)


def shim_case(which, seeds):
    _, jr, jd = torus()
    nbs = torus_table(jr, jd)
    lut = np.asarray(0.0)
    if which in ("bath_global", "wc3"):
        from montecarlosolvers_tpu import schedules
        lut = np.asarray(schedules.bath_lookuptable(SHIM_P, SHIM_ALPHA))
    if which == "anneal":
        s = np.random.default_rng(0).choice([-1.0, 1.0], size=(64, N))
        compat.Anneal(np.linspace(3.0, 0.0, 2000), 1, s, nbs, seed=0)
        return stats(table_energy(nbs, s) / N)
    if which == "svmc_tf":
        th = np.random.default_rng(0).uniform(0, np.pi, size=(32, N))
        a = np.linspace(3.0, 1e-8, 2000)
        compat.SpinVectorMonteCarloTFCompact(a, np.ones_like(a), 1, 0.05, th,
                                             nbs, seed=0)
        return stats(table_energy(nbs, z_of(th)) / N)
    if which == "noisy_anneal":
        s = np.random.default_rng(0).choice([-1.0, 1.0], size=(64, N))
        compat.NoisyAnneal(np.linspace(3.0, 0.0, NOISY_STEPS), 1, s,
                           noisy_table(nbs), seed=0)
        return stats(table_energy(nbs, s) / N)
    if which == "noisy_svmc":
        th = np.random.default_rng(0).uniform(0, np.pi, size=(64, N))
        a = np.linspace(3.0, 1e-8, NOISY_STEPS)
        compat.NoisySVMCTF(a, np.ones_like(a), 1, 0.05, th, noisy_table(nbs),
                           seed=0)
        return stats(table_energy(nbs, z_of(th)) / N)
    steps = {"qmc_global": 500, "bath_global": 200, "wc3": 20}[which]
    vals = []
    for seed in range(seeds):
        s = np.random.default_rng(seed).choice([-1.0, 1.0], size=N)
        confs = np.tile(s, (SHIM_P, 1)).T.copy()
        a = np.linspace(3.0, 1e-8, steps)
        b = np.ones_like(a)
        if which == "qmc_global":
            compat.QuantumAnnealGlobal(a, b, 1, 1.0 / SHIM_P, confs, nbs,
                                       seed=seed)
        elif which == "bath_global":
            compat.DissipativeQuantumAnnealGlobal(a, b, 1, 1.0 / SHIM_P, lut,
                                                  confs, nbs, seed=seed)
        else:
            compat.DissipativeQuantumAnnealWC3(a, b, 1, 1.0 / SHIM_P, lut,
                                               confs, nbs, seed=seed)
        vals.append(float(table_energy(nbs, confs.T).mean()) / N)
    return stats(vals)


def recorder():
    rec = {}

    def record(name, fn):
        out = fn()
        rec[name] = out
        return out

    return rec, record


def study_case(which, seeds):
    problem, jr, jd = torus()
    e_gs = bound(jr, jd)
    runs = []
    for seed in range(seeds):
        key = jax.random.key(seed)
        rec, record = recorder()
        if which == "pt_value":
            from montecarlosolvers_tpu.bench import pt_value as m
            m.RUNGS, m.SWEEPS = 48, 200
            m.Q_RUNGS, m.Q_SLICES, m.Q_SWEEPS = 48, 20, 50
            k1, k2, k3, k4 = jax.random.split(key, 4)
            m.sampling_arms(problem, e_gs, k1, rec, record)
            m.optimization_arms(problem, e_gs, k2, rec, record)
            m.quantum_arms(problem, e_gs, k3, rec, record)
            m.icm_arms(problem, e_gs, k4, rec, record)
        elif which == "pa_value":
            from montecarlosolvers_tpu.bench import pa_value as m
            m.REPLICAS, m.SWEEPS = 1024, 50
            k1, k2 = jax.random.split(key, 2)
            m.sampling_arms(problem, e_gs, k1, rec, record)
            m.optimization_arms(problem, e_gs, k2, rec, record)
        elif which == "icm_value":
            from montecarlosolvers_tpu.bench import icm_value as m
            m.RUNGS, m.SEG = 24, 500
            m.ICM_SEGS, m.REPS = {12: 2}, {12: 1}
            m.CADENCES_BY_L = {12: (2, 8, 32)}
            m.run_instance(12, 0, key, record)
        elif which == "cluster_value":
            from montecarlosolvers_tpu import schedules
            from montecarlosolvers_tpu.bench import cluster_value as m
            confs0 = m._pre_annealed(problem, key, chains=8)
            lut = schedules.bath_lookuptable(m.P, 1e-2)
            kp = jax.random.fold_in(key, 200)
            for name, fn in (
                    ("baseline_tau200", lambda: m.baseline_arm(
                        problem, e_gs, 200, kp, confs0)),
                    ("mixed_wcl_tau200", lambda: m.mixed_arm(
                        problem, e_gs, 200, kp, confs0)),
                    ("bath_baseline_tau200", lambda: m.baseline_arm(
                        problem, e_gs, 200, kp, confs0, lookuptable=lut)),
                    ("bath_mixed_sw_tau200", lambda: m.mixed_arm(
                        problem, e_gs, 200, kp, confs0, lookuptable=lut))):
                rec[name] = {"eps": fn()[0]}
        else:
            raise SystemExit(f"unknown study {which!r}")
        runs.append(rec)
    return {"runs": runs}


def crossover_case(seeds):
    from montecarlosolvers_tpu.bench import cluster_crossover as m
    out = {}
    prob = m.fm_lattice(32)
    for seed in range(seeds):
        key = jax.random.key(seed)
        for arm, we in (("localglobal", 0), ("wolff1", 1), ("wolff4", 4)):
            r = m.run_arm(prob, m.T_C, 0.1, 16, 2048,
                          jax.random.fold_in(key, we), wolff_every=we, P=4,
                          chunk=512, burn=256)
            for name, v in (("mean_m2", r[2]), ("tau_int", r[0]),
                            ("flip_frac", r[3])):
                out.setdefault(f"critical_{arm}_L32.{name}", []).append(v)
        for move in ("local", "wolff", "sw", "sw+local"):
            r = m.run_classical_arm(prob, m.T_C, 16, 2048,
                                    jax.random.fold_in(key, 10 + len(move)),
                                    move=move, chunk=512, burn=256)
            for name, v in (("mean_m2", r[2]), ("tau_int", r[0])):
                out.setdefault(f"cl_critical_{move}_L32.{name}",
                               []).append(v)
    return {k: stats(v) for k, v in out.items()}


def ladder_case(seeds):
    from montecarlosolvers_tpu.bench import ladder_calibration as m
    from montecarlosolvers_tpu.models import instances
    problem, _ = instances.random_2d_lattice(80, rng=80, lattice=True)
    rates = [m._measure(problem, N, jax.random.key(s))["swap_rate"]
             for s in range(seeds)]
    return stats(rates)


def migration_case(seeds):
    """examples/compat_migration.py's body, its seeds shifted by s."""
    sa_e, q_e = [], []
    for s in range(seeds):
        rng = np.random.RandomState(42)
        Ls = 16
        n = Ls * Ls
        J = {}
        for r in range(Ls):
            for c in range(Ls):
                i = r * Ls + c
                if c + 1 < Ls:
                    J[(i, i + 1)] = rng.randn()
                if r + 1 < Ls:
                    J[(i, i + Ls)] = rng.randn()
        nbs = compat.GenerateNeighbors(n, J, 4)
        svec = (2 * rng.randint(2, size=n) - 1).astype(np.float64)
        compat.Anneal(np.linspace(3.0, 0.0, 1000), 1, svec, nbs, seed=s)
        Jd = np.zeros((n, n))
        for (a, b), v in J.items():
            Jd[a, b] = v
        sa_e.append(compat.ClassicalIsingEnergy(svec, Jd) / n)
        P, pt = 8, 1.0
        pre = np.linspace(3.0, pt, int((3.0 - pt) / 0.05) + 1)
        state = (2 * rng.randint(2, size=n) - 1).astype(np.float64)
        compat.Anneal(pre, 10, state, nbs, seed=s + 1)
        confs = np.tile(state, (P, 1)).T
        A = np.linspace(3.0, 1e-8, 1000)
        compat.QuantumAnnealGlobal(A, np.ones_like(A), 1, pt / P, confs, nbs,
                                   seed=s + 2)
        q_e.append(min(compat.ClassicalIsingEnergy(confs[:, k], Jd)
                       for k in range(P)) / n)
    return {"sa_energy": stats(sa_e), "piqmc_best_energy": stats(q_e)}


def cluster_and_pt_case(seeds):
    """examples/cluster_and_pt.py's main on the torus's generic form; its
    printed eps_res values, one list a demo."""
    import importlib.util
    import pathlib
    import re

    problem, jr, jd = torus()
    gen_form = problem.to_generic()
    e_gs = bound(jr, jd)
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "cluster_and_pt.py"
    spec = importlib.util.spec_from_file_location("cluster_and_pt", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    orig_key = jax.random.key
    names = ("sa", "sa_wolff", "sa_sw", "piqmc_sw", "pt", "icm",
             "quantum_pt", "pa")
    out = {k: [] for k in names}
    for s in range(seeds):
        mod.jax.random.key = lambda x, s=s: orig_key(x + s)
        instances_orig = mod.instances.santoro_80x80
        mod.instances.santoro_80x80 = lambda: (gen_form, e_gs)
        argv = sys.argv
        sys.argv = ["cluster_and_pt", "--tau", "200", "--chains", "8",
                    "--rungs", "48", "--pt-sweeps", "100", "--slices", "8"]
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                mod.main()
        finally:
            sys.argv = argv
            mod.instances.santoro_80x80 = instances_orig
            mod.jax.random.key = orig_key
        vals = [float(v) for v in re.findall(r"eps_res = (-?[0-9.]+)",
                                             buf.getvalue())]
        for k, v in zip(names, vals):
            out[k].append(v)
    return {k: stats(v) for k, v in out.items()}


SHIMS = ("anneal", "qmc_global", "bath_global", "wc3", "svmc_tf",
         "noisy_anneal", "noisy_svmc")
STUDIES = ("pt_value", "pa_value", "icm_value", "cluster_value")
DEFAULT_SEEDS = {"qmc_global": 8, "bath_global": 8, "wc3": 8,
                 "pt_value": 3, "pa_value": 3, "cluster_value": 3,
                 "icm_value": 2, "crossover": 8, "ladder": 8,
                 "migration": 8, "cluster_and_pt": 3}


def main(argv):
    which = argv[0]
    seeds = int(argv[1]) if len(argv) > 1 else DEFAULT_SEEDS.get(which, 1)
    t0 = time.time()
    if which in SHIMS:
        rec = shim_case(which, seeds)
    elif which in STUDIES:
        rec = study_case(which, seeds)
    elif which == "crossover":
        rec = crossover_case(seeds)
    elif which == "ladder":
        rec = ladder_case(seeds)
    elif which == "migration":
        rec = migration_case(seeds)
    elif which == "cluster_and_pt":
        rec = cluster_and_pt_case(seeds)
    else:
        raise SystemExit(f"unknown case {which!r}")
    print(json.dumps({"case": which, "seeds": seeds, **rec,
                      "seconds": time.time() - t0}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
