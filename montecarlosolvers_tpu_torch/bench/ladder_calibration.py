"""_auto_ladder calibration across N (counterpart of
montecarlosolvers_tpu/bench/ladder_calibration.py).

solvers/api._auto_ladder sizes PT ladders from the 1/sqrt(N) overlap rule
with a constant c = 2.5. This driver measures the realized swap rate of
the auto-sized ladder at N in {256, 1024, 6400, 16384} on 2D Gaussian
lattices and N in {256, 1024, 2048} on SK (the dense engine), so that the
constant rests on a measured table.

Writes results/h100/ladder_calibration/summary.json: per configuration the
rung count the rule chose, the measured swap rate, and (outside the 20-60 %
band) the c that WOULD have centered it, c_to_center. The JAX study
computes that field inverted (2.5 ln(rate) / ln(0.4)); the port computes
it from the rule's first-order model (`_measure`).
"""

from __future__ import annotations

import json
import os

import numpy as np

from montecarlosolvers_tpu_torch import _device
from montecarlosolvers_tpu_torch.bench._common import generator, make_recorder
from montecarlosolvers_tpu_torch.models import instances
from montecarlosolvers_tpu_torch.solvers import pt, sa
from montecarlosolvers_tpu_torch.solvers.api import _auto_ladder

T_MIN, T_MAX = 0.5, 2.5
SWEEPS = 300


def c_to_center(rate, c=2.5):
    """The rule constant that moves a measured swap `rate` to 0.4: to
    first order the swap rate is exp(-k * spacing) with spacing
    proportional to c, so c scales by ln(0.4) / ln(rate). A rate below 0.4
    gives a smaller c, a denser ladder."""
    return round(c * np.log(0.4) / np.log(rate), 2)


def _measure(problem, n, generator, sweeps=SWEEPS):
    dev = problem.device
    m = _auto_ladder(n, T_MIN, T_MAX)
    temps = pt.geometric_ladder(T_MIN, T_MAX, m, device=dev)
    s0 = sa.random_state(generator, n, batch=(m,), device=dev)
    _, rate, pair = pt.sample(
        problem, temps, s0, generator, sweeps, swap_every=2,
        per_pair_rates=True
    )
    rate = float(rate)
    out = dict(
        nspins=n, rungs=m, swap_rate=round(rate, 4),
        pair_rate_min=round(float(pair.min()), 4),
        in_band=bool(0.2 <= rate <= 0.6),
    )
    if not out["in_band"] and 0.0 < rate < 1.0:
        out["c_to_center"] = c_to_center(rate)
    return out


def main(outdir="results/h100/ladder_calibration", budget_s=1200,
         device=None):
    dev = _device.resolve(device)
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "summary.json")
    done = {}
    if os.path.exists(path):
        with open(path) as f:
            done = json.load(f)
    record = make_recorder(path, done, budget_s=budget_s)

    for L in (16, 32, 80, 128):
        def arm(L=L):
            problem, _ = instances.random_2d_lattice(L, rng=L, lattice=True,
                                                     device=dev)
            return _measure(problem, L * L, generator(dev, 21, L))

        record(f"lattice_N{L * L}", arm)

    for n in (256, 1024, 2048):
        def arm(n=n):
            problem, _ = instances.sk_model(n, rng=n, device=dev)
            return _measure(problem, n, generator(dev, 21, 10 * n))

        record(f"sk_N{n}", arm)

    print(json.dumps(done, indent=2))
    return done


if __name__ == "__main__":
    main()
