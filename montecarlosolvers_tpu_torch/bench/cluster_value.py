"""Cluster-update value experiment (counterpart of
montecarlosolvers_tpu/bench/cluster_value.py): does mixing cluster moves
into the flagship anneal improve residual energy at EQUAL WALL-CLOCK on
the card?

Protocol (santoro 80x80, P = 40, PT = 1, the benchmark configuration):
  * baseline(tau): MST-style PIQMC local+global anneal, tau steps (kernel
    B on the lattice).
  * mixed(tau, n_cl): the same anneal cut into n_cl segments with one WCL
    Wolff cluster update a chain between segments (at the segment
    boundary's Gamma; csrc/fk_wolff.cu). The mean flipped fraction is
    recorded.
  * equal-wall baseline: the baseline re-run at the tau' whose measured
    wall matches the mixed arm's.
  * dissipative variant: the same design with the bath engine (alpha =
    1e-2 lookuptable; kernel 5) and the full-SW line-decomposition sweep
    (qmc.anneal_sw_bath, per_slice_seeds=True; csrc/fk_line.cu) as the
    cluster move.

The cluster moves run on the lattice's generic form, built once an arm
(the cluster solvers take to_generic() of a LatticeProblem themselves;
the spins are the same). Each `key` of the JAX arms is a torch.Generator
here. Writes results/h100/cluster_value/summary.json (resume-cached by arm
name); `main` raises FileNotFoundError without the santoro instance.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from montecarlosolvers_tpu_torch import _device, schedules
from montecarlosolvers_tpu_torch.bench._common import (generator,
                                                       make_recorder, split,
                                                       sync)
from montecarlosolvers_tpu_torch.models import instances
from montecarlosolvers_tpu_torch.models.lattice import LatticeProblem
from montecarlosolvers_tpu_torch.solvers import qmc, sa

CHAINS = 32
P = 40
PT = 1.0
N_CL = 10
# the keys of each arm family's record (`_common.by_family`)
RECORD_KEYS = {"baseline": {"eps", "wall_s"},
               "mixed_wcl": {"eps", "wall_s", "flip_frac"},
               "bath_baseline": {"eps", "wall_s"},
               "bath_mixed_sw": {"eps", "wall_s", "flip_frac"}}


def _pre_annealed(problem, generator_, chains=CHAINS):
    dev = problem.device
    k1, k2 = split(generator_, 2)
    s0 = sa.random_state(generator(dev, k1), problem.nspins, batch=(chains,),
                         device=dev)
    s0 = sa.anneal(problem, schedules.pre_anneal_schedule(3.0, PT,
                                                          device=dev),
                   s0, generator(dev, k2), mcsteps=100)
    return qmc.replicate(s0, P)


def _eps(problem, e_gs, confs):
    es = qmc.best_slice_energy(problem, confs).cpu().numpy()
    return float((es.mean() - e_gs) / problem.nspins)


def _schedule(tau, dev):
    return schedules.linear(3.0, 1e-8, int(tau), device=dev)


def baseline_arm(problem, e_gs, tau, generator_, confs0, lookuptable=None):
    """tau local(+global, or bath) sweeps; returns (eps, wall_s): the eps
    of the first timed run, the smaller wall of two after a warm-up."""
    dev = problem.device
    a = _schedule(tau, dev)
    kw = (dict(lookuptable=lookuptable) if lookuptable is not None
          else dict(global_moves=True))
    base = split(generator_, 1)[0]
    sync(qmc.anneal(problem, a, torch.ones_like(a), PT / P, confs0,
                    generator(dev, base, 0), **kw))
    eps, wall = None, np.inf
    for t in (1, 2):
        t0 = time.perf_counter()
        out = qmc.anneal(problem, a, torch.ones_like(a), PT / P, confs0,
                         generator(dev, base, t), **kw)
        e = _eps(problem, e_gs, out)  # the fetch doubles as the sync
        wall = min(wall, time.perf_counter() - t0)
        if eps is None:
            eps = e
    return eps, wall


def mixed_arm(problem, e_gs, tau, generator_, confs0, n_cl=N_CL,
              lookuptable=None):
    """tau sweeps in n_cl segments + one cluster move at each boundary.

    Non-dissipative: a WCL Wolff cluster a chain (anneal_wolff, rule
    "local"). Dissipative: one full-SW line-decomposition sweep
    (anneal_sw_bath, per_slice_seeds=True). Returns (eps, wall_s,
    mean_flip_fraction)."""
    dev = problem.device
    a_all = _schedule(tau, dev)
    seg = int(tau) // n_cl
    kw = (dict(lookuptable=lookuptable) if lookuptable is not None
          else dict(global_moves=True))
    gp = (problem.to_generic() if isinstance(problem, LatticeProblem)
          else problem)
    one_b = torch.ones(1, device=dev)
    base = split(generator_, 1)[0]

    def run(confs, tag, sync_flips):
        flip_frac = []
        for i in range(n_cl):
            # the LAST segment takes the remainder too, so that no
            # low-Gamma step is dropped for tau % n_cl != 0
            hi = (i + 1) * seg if i < n_cl - 1 else a_all.shape[0]
            a = a_all[i * seg:hi]
            confs = qmc.anneal(problem, a, torch.ones_like(a), PT / P, confs,
                               generator(dev, base, tag, i), **kw)
            # the cluster move at the true final Gamma of the segment
            one = a_all[hi - 1:hi]
            kc = generator(dev, base, tag, 1000 + i)
            if lookuptable is None:
                new = qmc.anneal_wolff(gp, one, one_b, PT / P, confs, kc,
                                       rule="local")
            else:
                new = qmc.anneal_sw_bath(gp, one, one_b, PT / P, lookuptable,
                                         confs, kc, per_slice_seeds=True)
            if sync_flips:
                flip_frac.append(float((new != confs).float().mean()))
            confs = new
        return confs, flip_frac

    sync(run(confs0, 0, False)[0])  # warm
    eps, wall = None, np.inf
    for t in (7, 8):  # best-of-2 (see baseline_arm)
        t0 = time.perf_counter()
        out, _ = run(confs0, t, False)
        e = _eps(problem, e_gs, out)
        wall = min(wall, time.perf_counter() - t0)
        if eps is None:
            eps = e
    # flip sizes measured outside the timed runs (a sync a segment)
    _, flip_frac = run(confs0, 7, True)
    return eps, wall, float(np.mean(flip_frac))


def arms(problem, e_gs, generator_, record, taus=(2000, 6000), n_cl=N_CL):
    """The study's arms on `problem`: for each tau the baseline, the mixed
    arm and the equal-wall baseline; at taus[0] the same three with the
    bath, all from one pre-annealed (CHAINS, P, N) start."""
    dev = problem.device
    k_pre, k_run = split(generator_, 2)
    confs0 = _pre_annealed(problem, generator(dev, k_pre))
    lut = schedules.bath_lookuptable(P, 1e-2, device=dev)

    for tau in taus:
        kp = generator(dev, k_run, tau)
        b = record(
            f"baseline_tau{tau}",
            lambda: dict(zip(("eps", "wall_s"),
                             baseline_arm(problem, e_gs, tau, kp, confs0))),
        )
        m = record(
            f"mixed_wcl_tau{tau}",
            lambda: dict(zip(("eps", "wall_s", "flip_frac"),
                             mixed_arm(problem, e_gs, tau, kp, confs0,
                                       n_cl))),
        )
        if b and m:
            # equal-wall baseline: tau scaled by the measured wall ratio
            tau_eq = int(tau * m["wall_s"] / max(b["wall_s"], 1e-9))
            record(
                f"baseline_equalwall_tau{tau_eq}_for{tau}",
                lambda: dict(zip(("eps", "wall_s"),
                                 baseline_arm(problem, e_gs, tau_eq, kp,
                                              confs0))),
            )

    # the dissipative variant at one tau
    tau = taus[0]
    kp = generator(dev, k_run, 90000 + tau)
    b = record(
        f"bath_baseline_tau{tau}",
        lambda: dict(zip(("eps", "wall_s"),
                         baseline_arm(problem, e_gs, tau, kp, confs0,
                                      lookuptable=lut))),
    )
    m = record(
        f"bath_mixed_sw_tau{tau}",
        lambda: dict(zip(("eps", "wall_s", "flip_frac"),
                         mixed_arm(problem, e_gs, tau, kp, confs0, n_cl,
                                   lookuptable=lut))),
    )
    if b and m:
        tau_eq = int(tau * m["wall_s"] / max(b["wall_s"], 1e-9))
        record(
            f"bath_baseline_equalwall_tau{tau_eq}_for{tau}",
            lambda: dict(zip(("eps", "wall_s"),
                             baseline_arm(problem, e_gs, tau_eq, kp, confs0,
                                          lookuptable=lut))),
        )


def main(outdir="results/h100/cluster_value", taus=(2000, 6000),
         budget_s=1500, device=None):
    dev = _device.resolve(device)
    problem, e_gs = instances.santoro_80x80(lattice=True, device=dev)
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "summary.json")
    done = {}
    if os.path.exists(path):
        with open(path) as f:
            done = json.load(f)
    record = make_recorder(path, done, budget_s=budget_s)
    arms(problem, e_gs, generator(dev, 0), record, taus)
    print(json.dumps(done, indent=2))
    return done


if __name__ == "__main__":
    main()
