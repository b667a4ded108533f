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
the caching allocator is warm.
"""

from __future__ import annotations

import json
import time

import torch

from montecarlosolvers_tpu_torch.models import instances
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.solvers.api import solve


def profile_solve(problem, **kw):
    """Device time per kernel and device busy share of one
    `solve(problem, seed=1, **kw)` on a CUDA problem, after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    solve(problem, seed=1, **kw)
    torch.cuda.synchronize()
    _build.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve(problem, seed=1, **kw)
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
    sa = dict(method="sa", num_reads=1280, sweeps=2000)
    qmc = dict(method="piqmc", num_reads=32, sweeps=1000)
    svmc = dict(method="svmc", num_reads=256, sweeps=2000)
    for key, lname, prob, kw in (
        ("sa", lattice, problem, sa),
        ("piqmc_p40", lattice, problem, dict(qmc, slices=40)),
        ("piqmc_p5", lattice, problem, dict(qmc, slices=5)),
        ("sa_l81", "gaussian_torus(81, seed=0)", odd, sa),
        ("piqmc_p5_l81", "gaussian_torus(81, seed=0)", odd,
         dict(qmc, slices=5)),
        ("svmc", lattice, problem, svmc),
        ("svmc_l81", "gaussian_torus(81, seed=0)", odd, svmc),
    ):
        print(json.dumps({"phase": "profile", "path": key, "lattice": lname,
                          "gpu": torch.cuda.get_device_name(0),
                          **profile_solve(prob, **kw)}), flush=True)


if __name__ == "__main__":
    main()
