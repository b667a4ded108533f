#!/usr/bin/env python3
"""Wall times of the sampler solves of the montecarlosolvers_tpu_torch found
on the import path, on one CUDA card, at chip_smoke.py's sampler_solves
shapes on the seeded 80x80 Gaussian torus.

    PYTHONPATH=<checkout> python tools/time_samplers.py [--label NAME]
        [--paths pt pa ...] [--reps 3]

pt   solve("pt", num_reads=64, sweeps=500): the auto ladder, 110 rungs,
     7040 chains, a kernel-A launch and an exchange a sweep.
pa   solve("pa", num_reads=1024, sweeps=500): a kernel-A launch, a
     reweight and a resample a step.

Each path runs once to warm up (the kernels' build and first launch), then
`--reps` times; one JSON line a path with every run's wall in ms (the
solve, synchronized, from the call to its return), their median, the
launches of the last run, the card's name and power limit. It calls only
`solve` with arguments every version of the port since the samplers
shares, so the same script times an older checkout (unpacked with `git
archive`) beside the current one in one run.
"""

import argparse
import json
import statistics
import subprocess
import time

import torch

CASES = {
    "pt": dict(method="pt", num_reads=64, sweeps=500),
    "pa": dict(method="pa", num_reads=1024, sweeps=500),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--paths", nargs="*", default=sorted(CASES))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")

    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.solvers.api import solve

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    torus = instances.gaussian_torus(80, seed=0, device=dev)
    for path in args.paths:
        kw = CASES[path]
        solve(torus, seed=0, **kw)  # warm
        walls = []
        for _ in range(args.reps):
            _build.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve(torus, seed=0, **kw)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        print(json.dumps({
            "label": args.label, "path": path, **kw, "wall_ms": walls,
            "median_ms": statistics.median(walls),
            "launches": {k: v for k, v in _build.LAUNCHES.items() if v},
            "gpu": smi}), flush=True)


if __name__ == "__main__":
    main()
