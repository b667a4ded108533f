"""Where the time of a solve goes on the card: torch.profiler over the
main-path solves of chip_smoke.py.

Run from the repository root on a CUDA machine:

    python -m montecarlosolvers_tpu_torch.profiling [--paths KEY ...]

For each solve it prints one JSON line: the host wall time of the traced
solve, the device busy time (the union of the device intervals) and its
share of the wall, the eight kernels with the most device time (summed
over their launches, with the launch count the trace saw) and the kernel
launches `ops/_build.py::LAUNCHES` counted in the same solve. Each solve
is traced after an untraced warm-up solve, so the kernels are built and
the caching allocator is warm. The dissipative paths run through
`solvers/dissipative.py::dissipative_qa`: kernel 5 on the lattice, its
colored template, and the generic bath kernel on the odd torus and on the
80x80 torus's generic form (tau = 200, as chip_smoke.py runs them). The
dense engine runs solve("sa") on sk_model(2048, rng=0) at 1024 reads, 1000
sweeps; the noisy anneals run sa.anneal_noisy (1280 chains) and
svmc.anneal_noisy (256 chains, TF) over 1000 steps of per-step tables
nbr_J (1 + 0.1 xi) on the 80x80 torus's generic form, xi drawn on the card
(chip_smoke.py draws its tables with numpy instead, for its JAX anchors).
The cluster methods run as chip_smoke.py runs them on the 80x80 torus's
generic form: solve("sa_wolff") and solve("sa_sw") at 64 reads, 200
sweeps; solve("piqmc_wolff"), solve("piqmc_sw", alpha = 1e-2) and
solve("piqmc_sw_full") at 8 reads, 50 sweeps, P = 40. The samplers run as
chip_smoke.py's sampler_solves run them: solve("pt") at 64 reads, 500
sweeps on the 80x80 torus (the auto ladder, 110 rungs), solve("icm") at 32
reads, 1000 sweeps, ladder 24, on random_3d_lattice(12, rng=0),
solve("pa") at 1024 reads, 500 steps, and adaptive to beta = 2, and
solve("paq") at 32 reads, 500 steps, P = 20. `--paths` traces only the
solves of those keys.
"""

from __future__ import annotations

import argparse
import json
import time
from functools import partial

import torch

from montecarlosolvers_tpu_torch import schedules
from montecarlosolvers_tpu_torch.models import instances
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.solvers import sa, svmc
from montecarlosolvers_tpu_torch.solvers.api import solve
from montecarlosolvers_tpu_torch.solvers.dissipative import dissipative_qa


def profile_run(run):
    """Device time per kernel and device busy share of `run()`, a solve on
    the card, traced after an untraced warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    _build.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    per, spans = {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        total, count = per.get(e.name, (0.0, 0))
        per[e.name] = (total + us, count + 1)
        spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, None
    for a, b in sorted(spans):  # union of the device intervals, in us
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_ms": 1e3 * wall, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / 1e6 / wall,
            "kernels": [{"name": k[:80], "ms": v[0] / 1e3, "count": v[1]}
                        for k, v in top],
            "launches": launches}


def noisy_run(kind, problem, chains, steps, dev):
    """sa.anneal_noisy (T 3 -> 0) or svmc.anneal_noisy (TF, A 3 -> 1e-8,
    B = 1, T = 0.05) of `chains` chains over `steps` per-step tables
    nbr_J (1 + 0.1 xi), h, xi drawn on the card: a function of no
    arguments."""
    gen = torch.Generator(device=dev).manual_seed(0)
    xi = torch.randn((steps,) + tuple(problem.nbr_J.shape), generator=gen,
                     device=dev)
    jt = problem.nbr_J * (1.0 + 0.1 * xi)
    ht = problem.h.expand(steps, -1)

    def run():
        g = torch.Generator().manual_seed(1)
        if kind == "sa":
            s0 = sa.random_state(g, problem.nspins, batch=(chains,),
                                 device=dev)
            return sa.anneal_noisy(problem, schedules.linear(
                3.0, 0.0, steps, device=dev), jt, ht, s0, g)
        th = svmc.random_state(g, problem.nspins, batch=(chains,),
                               device=dev)
        a = schedules.linear(3.0, 1e-8, steps, device=dev)
        return svmc.anneal_noisy(problem, a, torch.ones_like(a), 0.05, jt,
                                 ht, th, g, tf=True)
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paths", nargs="+", default=None,
                    help="trace only these solves (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch sees no CUDA device")
    dev = torch.device("cuda", 0)
    try:
        problem, _ = instances.santoro_80x80(lattice=True, device=dev)
        lattice = "santoro_80x80"
    except FileNotFoundError:
        problem = instances.gaussian_torus(80, seed=0, device=dev)
        lattice = "gaussian_torus(80, seed=0)"
    odd = instances.gaussian_torus(81, seed=0, device=dev)
    sa_kw = dict(method="sa", num_reads=1280, sweeps=2000)
    qmc_kw = dict(method="piqmc", num_reads=32, sweeps=1000)
    svmc_kw = dict(method="svmc", num_reads=256, sweeps=2000)
    odd_name = "gaussian_torus(81, seed=0)"
    generic_name = "gaussian_torus(80, seed=0), generic"
    generic = instances.gaussian_torus(80, seed=0, device=dev).to_generic()
    runs = (
        ("sa", lattice, partial(solve, problem, seed=1, **sa_kw)),
        ("piqmc_p40", lattice,
         partial(solve, problem, seed=1, slices=40, **qmc_kw)),
        ("piqmc_p5", lattice,
         partial(solve, problem, seed=1, slices=5, **qmc_kw)),
        ("sa_l81", odd_name, partial(solve, odd, seed=1, **sa_kw)),
        ("piqmc_p5_l81", odd_name,
         partial(solve, odd, seed=1, slices=5, **qmc_kw)),
        ("svmc", lattice, partial(solve, problem, seed=1, **svmc_kw)),
        ("svmc_l81", odd_name, partial(solve, odd, seed=1, **svmc_kw)),
        # 32 chains, P = 40, alpha = 1e-2: bench.py::_piqmc_bath_arm
        ("piqmc_bath_p40", lattice,
         partial(dissipative_qa, problem, 32, 1000, 40, 1e-2, seed=1)),
        ("piqmc_bath_colored_p40", lattice,
         partial(dissipative_qa, problem, 32, 200, 40, 1e-2, seed=1,
                 bath_update="colored")),
        ("piqmc_bath_l81_p40", odd_name,
         partial(dissipative_qa, odd, 32, 200, 40, 1e-2, seed=1)),
        ("piqmc_bath_generic_p40", f"{lattice}, generic",
         partial(dissipative_qa, problem.to_generic(), 32, 200, 40, 1e-2,
                 seed=1)),
        ("sa_dense", "sk_model(2048, rng=0)",
         partial(solve, instances.sk_model(2048, rng=0, device=dev)[0],
                 method="sa", num_reads=1024, sweeps=1000, seed=1)),
        ("sa_noisy", f"{generic_name}, noisy tables",
         noisy_run("sa", generic, 1280, 1000, dev)),
        ("svmc_noisy", f"{generic_name}, noisy tables",
         noisy_run("svmc", generic, 256, 1000, dev)),
    )
    cluster = dict(num_reads=8, sweeps=50, seed=1, slices=40)
    runs += (
        ("sa_wolff", generic_name, partial(solve, generic, "sa_wolff",
                                           num_reads=64, sweeps=200,
                                           seed=1)),
        ("sa_sw", generic_name, partial(solve, generic, "sa_sw",
                                        num_reads=64, sweeps=200, seed=1)),
        ("piqmc_wolff_p40", generic_name,
         partial(solve, generic, "piqmc_wolff", **cluster)),
        ("piqmc_sw_p40", generic_name,
         partial(solve, generic, "piqmc_sw", alpha=1e-2, **cluster)),
        ("piqmc_sw_full_p40", generic_name,
         partial(solve, generic, "piqmc_sw_full", **cluster)),
    )
    glass = instances.random_3d_lattice(12, rng=0, device=dev)[0]
    torus = instances.gaussian_torus(80, seed=0, device=dev)
    tname = "gaussian_torus(80, seed=0)"
    runs += (
        ("pt", tname, partial(solve, torus, "pt", num_reads=64, sweeps=500,
                              seed=1)),
        ("icm", "random_3d_lattice(12, rng=0)",
         partial(solve, glass, "icm", num_reads=32, sweeps=1000, ladder=24,
                 seed=1)),
        ("pa", tname, partial(solve, torus, "pa", num_reads=1024,
                              sweeps=500, seed=1)),
        ("pa_adaptive", tname,
         partial(solve, torus, "pa", num_reads=1024, sweeps=2000,
                 adaptive=True, beta_end=2.0, seed=1)),
        ("paq", tname, partial(solve, torus, "paq", num_reads=32,
                               sweeps=500, slices=20, seed=1)),
    )
    for key, lname, run in runs:
        if args.paths is not None and key not in args.paths:
            continue
        print(json.dumps({"phase": "profile", "path": key, "lattice": lname,
                          "gpu": torch.cuda.get_device_name(0),
                          **profile_run(run)}), flush=True)


if __name__ == "__main__":
    main()
