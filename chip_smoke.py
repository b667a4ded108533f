#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (montecarlosolvers_tpu_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printed as one JSON line:
  device              nvidia-smi's name and power limit of the card
  build               nvcc builds kernels A and B from csrc/ (seconds)
  sa_kernel_vs_plain  kernel A against its plain PyTorch version on the card,
                      80x80 periodic Gaussian lattice at the main path's
                      1280 chains, 200 steps of T: 3 -> 0.1
  qmc_kernel_vs_plain kernel B against its plain version at the main path's
                      P = 40 and 32 chains, 40 steps, B in {1, 0.7} x global
                      moves on / off
  main_path           solve("sa", 1280 reads, 2000 sweeps) and
                      solve("piqmc", 32 reads, P = 40, 1000 sweeps) on the
                      santoro instance when MCS_TPU_INSTANCE_DIR holds it,
                      else on the seeded 80x80 Gaussian torus; energies per
                      spin checked against fixed ranges; kernel launch
                      counts read around the two solves
  timing              slope-timed flip attempts/s of each kernel and of its
                      plain version at the main path's shapes
then a line {"kernels": [...]}, and last {"ok": true, "device": {...}}.
Any failed check raises, so the script exits non-zero without the last line;
it also fails when torch sees no CUDA device or the package is missing.
The script imports no JAX.
"""

import json
import subprocess
import time

import numpy as np
import torch

L = 80
SA_READS, SA_SWEEPS = 1280, 2000
QMC_READS, QMC_SLICES, QMC_SWEEPS = 32, 40, 1000
# Energy-per-spin ranges on the seeded torus (JAX package on the CPU: SA
# tau=2000 mean -1.2784; PIQMC P=20 tau=500 mean -1.2884; SA tau=20000 best
# -1.2959), widened by about 0.01 per spin for the port's other RNG stream.
SA_RANGE = (-1.29, -1.268)
QMC_RANGE = (-1.31, -1.278)
# residual energy per spin ranges on the certified santoro instance
SA_EPS_RANGE = (0.0, 0.1)
QMC_EPS_RANGE = (0.0, 0.05)


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out


def mismatches(xs, ys):
    """(number of differing elements, max |x - y|) over paired tensors."""
    n = sum(int((x != y).sum()) for x, y in zip(xs, ys))
    err = max(float((x - y).abs().max()) for x, y in zip(xs, ys))
    return n, err


def slope_ms(run, taus, trials):
    """Median pairwise slope of the best-of-`trials` wall time of run(tau)
    (ending in a synchronize) over the tau points, in ms per sweep;
    fixed overhead cancels in the slope (bench.py::_measure_rate)."""
    best = {}
    for tau in taus:
        run(tau)  # warm
        times = []
        for _ in range(trials):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(tau)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        best[tau] = min(times)
    ts = sorted(best)
    slopes = [(best[b] - best[a]) / (b - a)
              for i, a in enumerate(ts) for b in ts[i + 1:]]
    return 1e3 * float(np.median(slopes)), best


def main():
    check(torch.cuda.is_available(), "torch.cuda.is_available()")
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.ops import split as split_ops
    from montecarlosolvers_tpu_torch.ops import split_kernels as sk
    from montecarlosolvers_tpu_torch.solvers.api import solve

    dev = torch.device("cuda", 0)

    # ---- device
    smi = nvidia_smi()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": name})

    # ---- build
    t0 = time.perf_counter()
    seconds = _build.build(verbose=True)
    emit({"phase": "build", "nvcc_seconds": seconds,
          "total_seconds": time.perf_counter() - t0})

    torus = instances.gaussian_torus(L, seed=0, device=dev)
    sl = split_ops.build_split(torus)
    rng = np.random.default_rng(1)
    results = {}

    # ---- kernel A against its plain version
    spins = torch.as_tensor(
        rng.choice([-1.0, 1.0], size=(SA_READS, L * L)).astype(np.float32),
        device=dev)
    a, b = (x.contiguous() for x in split_ops.pack_classical(sl, spins))
    sched = schedules.linear(3.0, 0.1, 200, device=dev)
    ka = sk.sa_split_anneal(sl, sched, a, b, seed=12345)
    ra = sk.sa_split_anneal_ref(sl, sched, a, b, seed=12345)
    torch.cuda.synchronize()
    n_bad, err = mismatches(ka, ra)
    emit({"phase": "sa_kernel_vs_plain", "chains": SA_READS, "steps": 200,
          "nslots": sl.nslots, "mismatched_spins": n_bad, "max_abs_err": err,
          "flipped_fraction": float((ka[0] != a).float().mean())})
    check(n_bad == 0, "kernel A equals its plain version")
    results["split_sa"] = {"max_abs_err": err}

    # ---- kernel B against its plain version
    confs = torch.as_tensor(
        rng.choice([-1.0, 1.0], size=(QMC_READS, QMC_SLICES, L * L))
        .astype(np.float32), device=dev)
    quarters = split_ops.pack_qmc(sl, confs)
    gamma = schedules.transverse_field(3.0, 1e-8, 40, device=dev)
    teff = (1.0 / QMC_SLICES) * QMC_SLICES
    jp = schedules.jperp(gamma, teff).contiguous()
    err_b = 0.0
    for bscale in (1.0, 0.7):
        bs = torch.full_like(gamma, bscale)
        for gm in (True, False):
            kq = sk.qmc_split_anneal(sl, bs, jp, teff, quarters, 777, gm)
            rq = sk.qmc_split_anneal_ref(sl, bs, jp, teff, quarters, 777, gm)
            torch.cuda.synchronize()
            n_bad, err = mismatches(kq, rq)
            err_b = max(err_b, err)
            emit({"phase": "qmc_kernel_vs_plain", "chains": QMC_READS,
                  "slices": QMC_SLICES, "steps": 40, "B": bscale,
                  "global_moves": gm, "mismatched_spins": n_bad,
                  "max_abs_err": err})
            check(n_bad == 0, f"kernel B equals its plain version "
                              f"(B={bscale}, global_moves={gm})")
    results["split_qmc"] = {"max_abs_err": err_b}

    # ---- main path through solve()
    try:
        problem, e_gs = instances.santoro_80x80(lattice=True, device=dev)
        lattice = "santoro_80x80"
    except FileNotFoundError:
        problem, e_gs = torus, None
        lattice = "gaussian_torus(80, seed=0)"
    n = problem.nspins
    jr = problem.j_right.double().cpu().numpy()
    jd = problem.j_down.double().cpu().numpy()
    hp = problem.h_plane.double().cpu().numpy()

    def energy64(states):
        s = states.astype(np.float64).reshape(-1, L, L)
        return ((jr * s * np.roll(s, -1, axis=-1)).sum(axis=(1, 2))
                + (jd * s * np.roll(s, -1, axis=-2)).sum(axis=(1, 2))
                + (hp * s).sum(axis=(1, 2)))

    sk.reset_launches()
    runs = {}
    t0 = time.perf_counter()
    runs["sa"] = solve(problem, "sa", num_reads=SA_READS, sweeps=SA_SWEEPS,
                       seed=0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    runs["piqmc"] = solve(problem, "piqmc", num_reads=QMC_READS,
                          slices=QMC_SLICES, sweeps=QMC_SWEEPS, seed=0)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(sk.LAUNCHES)
    for key, ss, reads, secs in (("sa", runs["sa"], SA_READS, t1 - t0),
                                 ("piqmc", runs["piqmc"], QMC_READS, t2 - t1)):
        check(ss.samples.shape == (reads, n), f"{key} sample shape")
        check(set(np.unique(ss.samples)) <= {-1.0, 1.0}, f"{key} spins +/-1")
        check(bool(np.all(np.isfinite(ss.energies))), f"{key} finite")
        e64 = energy64(ss.samples)
        check(np.allclose(ss.energies, e64, rtol=1e-5, atol=1e-3),
              f"{key} energies equal a float64 recomputation")
        per_spin = ss.energies / n
        rec = {"phase": "main_path", "method": key, "lattice": lattice,
               "reads": reads, "seconds": secs,
               "mean_energy_per_spin": float(per_spin.mean()),
               "best_energy_per_spin": float(per_spin.min())}
        if e_gs is not None:
            eps = (ss.energies - e_gs) / n
            rec["eps_res_mean"] = float(eps.mean())
            rec["eps_res_best"] = float(eps.min())
        emit(rec)
        lo, hi = (
            (SA_EPS_RANGE if key == "sa" else QMC_EPS_RANGE)
            if e_gs is not None else (SA_RANGE if key == "sa" else QMC_RANGE)
        )
        val = rec["eps_res_mean"] if e_gs is not None \
            else rec["mean_energy_per_spin"]
        check(lo <= val <= hi, f"{key} mean {val} inside [{lo}, {hi}]")
    emit({"phase": "main_path", "launches": launches})
    check(launches["sa_split"] > 0, "kernel A ran on the main path")
    check(launches["qmc_split"] > 0, "kernel B ran on the main path")

    # ---- timing: slope ms per sweep, kernel and plain version
    def sa_runner(fn, chains):
        s = torch.as_tensor(
            rng.choice([-1.0, 1.0], size=(chains, L * L)).astype(np.float32),
            device=dev)
        ha, hb = (x.contiguous() for x in split_ops.pack_classical(sl, s))
        return lambda tau: fn(sl, schedules.linear(3.0, 0.0, tau, device=dev),
                              ha, hb, 7)

    def qmc_runner(fn, chains):
        c = torch.as_tensor(
            rng.choice([-1.0, 1.0], size=(chains, QMC_SLICES, L * L))
            .astype(np.float32), device=dev)
        qs = split_ops.pack_qmc(sl, c)

        def run(tau):
            g = schedules.transverse_field(3.0, 1e-8, tau, device=dev)
            return fn(sl, torch.ones_like(g), schedules.jperp(g, teff)
                      .contiguous(), teff, qs, 7, True)
        return run

    power = smi.split(",")[-1].strip() if "," in smi else smi
    timings = (
        ("split_sa", "cuda", sa_runner(sk.sa_split_anneal, SA_READS),
         (500, 2000), 3, SA_READS, 1),
        ("split_sa", "plain", sa_runner(sk.sa_split_anneal_ref, SA_READS),
         (10, 40), 2, SA_READS, 1),
        ("split_qmc", "cuda", qmc_runner(sk.qmc_split_anneal, QMC_READS),
         (100, 400), 3, QMC_READS, QMC_SLICES),
        ("split_qmc", "plain", qmc_runner(sk.qmc_split_anneal_ref, QMC_READS),
         (4, 12), 2, QMC_READS, QMC_SLICES),
    )
    for kname, route, run, taus, trials, chains, slices in timings:
        ms, best = slope_ms(run, taus, trials)
        rate = n * slices * chains / (ms * 1e-3) if ms > 0 else float("nan")
        emit({"phase": "timing", "kernel": kname, "route": route,
              "chains": chains, "slices": slices,
              "global_moves": kname == "split_qmc", "taus": list(taus),
              "best_seconds": {str(k): v for k, v in best.items()},
              "ms_per_sweep": ms, "attempts_per_s": rate,
              "gpu": name, "power_limit": power})
        check(ms > 0, f"{kname} {route} slope is positive")
        results[kname]["ms" if route == "cuda" else "plain_ms"] = ms

    sources = {
        "split_sa": ("montecarlosolvers_tpu_torch/csrc/split_sa.cu",
                     "montecarlosolvers_tpu/ops/pallas_split.py:109"),
        "split_qmc": ("montecarlosolvers_tpu_torch/csrc/split_qmc.cu",
                      "montecarlosolvers_tpu/ops/pallas_split.py:431"),
    }
    launch_key = {"split_sa": "sa_split", "split_qmc": "qmc_split"}
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": sources[k][0],
         "replaces": sources[k][1], "launches": launches[launch_key[k]],
         "max_abs_err": results[k]["max_abs_err"], "ms": results[k]["ms"],
         "plain_ms": results[k]["plain_ms"]}
        for k in ("split_sa", "split_qmc")
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
