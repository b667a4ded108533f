#!/usr/bin/env python3
"""Profile some main-path cells of the montecarlosolvers_tpu_torch found on
the import path, on one CUDA card, with torch.profiler and once untraced.

    PYTHONPATH=<checkout> python tools/profile_cells.py LABEL PATH ...

PATH is one of svmc_generic (solve("svmc") on the 80x80 torus's generic
form, 256 reads, 2000 sweeps: generic SVMC), svmc_noisy
(svmc.anneal_noisy, 256 chains, 1000 steps of tables), pt (solve("pt"),
64 reads, 500 sweeps: the energy kernel on chain-bit words at 7040
chains), pa (solve("pa"), 1024 reads, 500 steps), icm (solve("icm"), 32
reads, 1000 sweeps, on random_3d_lattice(12, rng=0): the Houdayer move
every second sweep) and piqmc_sw (solve("piqmc_sw"), 8 reads, 50 sweeps,
P = 40, alpha = 1e-2, on the torus's generic form: the line clusters), as
`montecarlosolvers_tpu_torch/profiling.py` runs them, on the seeded 80x80
torus. Each prints one JSON line: `profiling.profile_run`'s record (the
traced wall after an untraced warm-up, device busy time and share, the
eight kernels with the most device time, the launches) and the wall of
one more untraced run, ending in a synchronize. It calls only
`profiling.profile_run` and `profiling.noisy_run`, which every checkout
since their slice has, so a `git archive` of the parent is profiled
beside the tree in one call (parent, change, change, parent).
"""

import json
import sys
import time
from functools import partial

import torch

from montecarlosolvers_tpu_torch import profiling
from montecarlosolvers_tpu_torch.models import instances
from montecarlosolvers_tpu_torch.solvers.api import solve


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    label, paths = argv[0], argv[1:]
    dev = torch.device("cuda", 0)
    torus = instances.gaussian_torus(80, seed=0, device=dev)
    generic = torus.to_generic()
    runs = {
        "svmc_generic": partial(solve, generic, "svmc", num_reads=256,
                                sweeps=2000, seed=1),
        "svmc_noisy": profiling.noisy_run("svmc", generic, 256, 1000, dev),
        "pt": partial(solve, torus, "pt", num_reads=64, sweeps=500, seed=1),
        "pa": partial(solve, torus, "pa", num_reads=1024, sweeps=500,
                      seed=1),
        "icm": partial(solve, instances.random_3d_lattice(12, rng=0,
                                                          device=dev)[0],
                       "icm", num_reads=32, sweeps=1000, seed=0),
        "piqmc_sw": partial(solve, generic, "piqmc_sw", num_reads=8,
                            sweeps=50, slices=40, alpha=1e-2, seed=0),
    }
    for key in paths:
        run = runs[key]
        rec = profiling.profile_run(run)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        print(json.dumps({"label": label, "path": key,
                          "untraced_wall_ms":
                              1e3 * (time.perf_counter() - t0),
                          "gpu": torch.cuda.get_device_name(0), **rec}),
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
