"""Where the time of a solve goes on the card: torch.profiler over the
main-path solves of chip_smoke.py.

Run from the repository root on a CUDA machine:

    python -m montecarlosolvers_tpu_torch.profiling

For each solve it prints one JSON line: the host wall time of the traced
solve, the device busy time (the union of the device intervals) and its
share of the wall, the eight kernels with the most device time (summed
over their launches, with the launch count the trace saw) and the kernel
launches `ops/_build.py::LAUNCHES` counted in the same solve. Each solve
is traced after an untraced warm-up solve, so the kernels are built and
the caching allocator is warm. The dissipative paths run through
`solvers/dissipative.py::dissipative_qa`: kernel 5 on the lattice, its
colored template, and the generic bath kernel on the odd torus and on the
80x80 torus's generic form (tau = 200, as chip_smoke.py runs them).
"""

from __future__ import annotations

import json
import time
from functools import partial

import torch

from montecarlosolvers_tpu_torch.models import instances
from montecarlosolvers_tpu_torch.ops import _build
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


def main():
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
    )
    for key, lname, run in runs:
        print(json.dumps({"phase": "profile", "path": key, "lattice": lname,
                          "gpu": torch.cuda.get_device_name(0),
                          **profile_run(run)}), flush=True)


if __name__ == "__main__":
    main()
