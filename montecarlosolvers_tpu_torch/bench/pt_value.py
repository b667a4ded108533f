"""Parallel-tempering value experiment (counterpart of
montecarlosolvers_tpu/bench/pt_value.py): does PT earn its rungs on the
certified santoro 80x80 instance, on the card, at equal budget?

1. SAMPLING: equilibrium at a low temperature. M quenched chains run local
   colored Metropolis at T_cold for S sweeps; the PT arm spends the same
   M x S sweep budget across a tuned ladder whose coldest rung is T_cold.
   Metric: mean energy of the T_cold ensemble over the second half of the
   run. The quench gets an equal-wall rematch.

2. OPTIMIZATION at equal wall-clock: best residual energy found. PT (M
   rungs x S sweeps, min over rungs) against SA restarts (M chains, linear
   3 -> 0) re-run at the tau' whose measured wall matches PT's. A quantum
   variant races transverse-field-ladder PT (pt.sample_piqmc) against a
   plain PIQMC local+global anneal at equal wall, and ICM (two ladders
   with Houdayer moves, pt.sample_icm) runs at the PT arms' sweep budget.

Each arm keeps the JAX study's record keys; each `key` of the JAX arms is
a torch.Generator here (`_common.split` / `generator` for its splits and
folds). Writes results/h100/pt_value/summary.json (resume-cached by arm
name); `main` raises FileNotFoundError without the santoro instance.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from montecarlosolvers_tpu_torch import _device, schedules
from montecarlosolvers_tpu_torch.bench._common import (generator,
                                                       make_recorder, split,
                                                       timed)
from montecarlosolvers_tpu_torch.models import instances
from montecarlosolvers_tpu_torch.solvers import pt, qmc, sa

RUNGS = 48
SWEEPS = 2000
T_COLD = 0.5
T_HOT = 2.5
# quantum-PT arm sizes: adjacent-rung K-overlap needs dense rungs at
# N=6400 (the JAX study measured: 16 rungs over Gamma 2.5->0.05 gave swap
# rate 0.001; 48 rungs over 1.5->0.3 give about 0.3)
Q_RUNGS, Q_SLICES, Q_SWEEPS = 48, 20, 500
Q_GAMMA_HI, Q_GAMMA_LO = 1.5, 0.3
# ladder tuning: sweeps a round (the JAX study's 3 rounds of 200; the
# quantum ladder 2 rounds of 100)
TUNE_SWEEPS, Q_TUNE_SWEEPS = 200, 100
# the keys of each arm family's record (`_common.by_family`)
RECORD_KEYS = {
    "sampling_pt": {"eps_cold", "swap_rate", "pair_rate_min", "wall_s",
                    "total_sweeps"},
    "sampling_quench": {"eps_cold", "wall_s", "total_sweeps"},
    "opt_pt": {"eps_best", "swap_rate", "wall_s"},
    "opt_sa": {"eps_best", "wall_s", "tau"},
    "quantum_pt": {"eps_best", "swap_rate", "wall_s"},
    "quantum_piqmc": {"eps_best", "wall_s", "tau"},
    "sampling_icm": {"eps_cold", "swap_rate", "houdayer_flip_frac", "wall_s",
                     "total_sweeps"},
    "opt_icm": {"eps_best", "swap_rate", "houdayer_flip_frac", "wall_s"},
}


def _eps(e, e_gs, n):
    return float((e - e_gs) / n)


def _tuned(problem, t_lo, generator):
    temps0 = pt.geometric_ladder(t_lo, T_HOT, RUNGS, device=problem.device)
    return pt.tune_ladder(problem, temps0, generator, rounds=3,
                          sweeps_per_round=TUNE_SWEEPS)


def sampling_arms(problem, e_gs, generator_, done, record):
    """PT vs quenched local dynamics at T_cold, equal sweep budget."""
    dev, n = problem.device, problem.nspins
    k_init, k_tune, k_pt, k_q = split(generator_, 4)
    s0 = sa.random_state(generator(dev, k_init), n, batch=(RUNGS,),
                         device=dev)
    temps, pair_rates = _tuned(problem, T_COLD, generator(dev, k_tune))

    def arm_pt():
        def run(seed):
            return pt.sample(problem, temps, s0, generator(dev, k_pt, seed),
                             SWEEPS, swap_every=2, collect_energy=True)

        (states, rate, es), wall = timed(run)
        es = es.cpu().numpy()  # (SWEEPS, M); rung 0 is T_cold (ascending)
        return dict(
            eps_cold=_eps(float(es[SWEEPS // 2:, 0].mean()), e_gs, n),
            swap_rate=float(rate),
            pair_rate_min=float(np.min(pair_rates)),
            wall_s=wall,
            total_sweeps=RUNGS * SWEEPS,
        )

    def quench_arm(sweeps, tag_seed):
        sched = torch.full((sweeps,), T_COLD, dtype=torch.float32,
                           device=dev)

        def run(seed):
            return sa.anneal(problem, sched, s0,
                             generator(dev, k_q, tag_seed + seed),
                             collect_energy=True)

        (_, es), wall = timed(run)
        es = es.cpu().numpy()  # (sweeps, M)
        return dict(
            eps_cold=_eps(float(es[sweeps // 2:].mean()), e_gs, n),
            wall_s=wall,
            total_sweeps=RUNGS * sweeps,
        )

    p = record("sampling_pt", arm_pt)
    q = record("sampling_quench", lambda: quench_arm(SWEEPS, 0))
    if p and q:
        # equal-wall quench: the PT arm pays for its swap phases; give the
        # quench the same wall
        sweeps_eq = int(SWEEPS * p["wall_s"] / max(q["wall_s"], 1e-9))
        record(f"sampling_quench_equalwall_s{sweeps_eq}",
               lambda: quench_arm(sweeps_eq, 100))


def icm_arms(problem, e_gs, generator_, done, record):
    """Isoenergetic cluster moves (Houdayer + PT, pt.sample_icm) at the
    same total sweep budget as the PT arms: 2 ladders x RUNGS rungs x
    SWEEPS/2 sweeps, plus one Houdayer phase every 2 sweeps."""
    dev, n = problem.device, problem.nspins
    S = SWEEPS // 2
    k_init, k_tune, k_s, k_o = split(generator_, 4)
    s0 = sa.random_state(generator(dev, k_init), n, batch=(2, RUNGS),
                         device=dev)
    temps, _ = _tuned(problem, T_COLD, generator(dev, k_tune))

    def arm_sampling():
        def run(seed):
            return pt.sample_icm(problem, temps, s0,
                                 generator(dev, k_s, seed), S, swap_every=2,
                                 houdayer_every=2, collect_energy=True)

        (_, rate, hfrac, es), wall = timed(run)
        es = es.cpu().numpy()  # (S, 2, M); rung 0 is T_cold
        return dict(
            eps_cold=_eps(float(es[S // 2:, :, 0].mean()), e_gs, n),
            swap_rate=float(rate),
            houdayer_flip_frac=float(hfrac),
            wall_s=wall,
            total_sweeps=2 * RUNGS * S,
        )

    temps_o, _ = _tuned(problem, 0.3, generator(dev, k_tune, 1))

    def arm_opt():
        def run(seed):
            return pt.sample_icm(problem, temps_o, s0,
                                 generator(dev, k_o, seed), S, swap_every=2,
                                 houdayer_every=2)

        (states, rate, hfrac), wall = timed(run)
        e_min = float(problem.energy(states).min())
        return dict(
            eps_best=_eps(e_min, e_gs, n),
            swap_rate=float(rate),
            houdayer_flip_frac=float(hfrac),
            wall_s=wall,
        )

    record("sampling_icm", arm_sampling)
    record("opt_icm", arm_opt)


def optimization_arms(problem, e_gs, generator_, done, record):
    """Best energy found: PT vs SA restarts at equal wall-clock."""
    dev, n = problem.device, problem.nspins
    k_init, k_tune, k_pt, k_sa = split(generator_, 4)
    s0 = sa.random_state(generator(dev, k_init), n, batch=(RUNGS,),
                         device=dev)
    temps, _ = _tuned(problem, 0.3, generator(dev, k_tune))

    def arm_pt():
        def run(seed):
            return pt.sample(problem, temps, s0, generator(dev, k_pt, seed),
                             SWEEPS, swap_every=2)

        (states, rate), wall = timed(run)
        e_min = float(problem.energy(states).min())
        return dict(eps_best=_eps(e_min, e_gs, n), swap_rate=float(rate),
                    wall_s=wall)

    def sa_arm(tau):
        sched = schedules.linear(3.0, 0.0, tau, device=dev)

        def run(seed):
            return sa.anneal(problem, sched, s0, generator(dev, k_sa, seed))

        states, wall = timed(run)
        e_min = float(problem.energy(states).min())
        return dict(eps_best=_eps(e_min, e_gs, n), wall_s=wall,
                    tau=int(tau))

    p = record("opt_pt", arm_pt)
    b = record(f"opt_sa_tau{SWEEPS}", lambda: sa_arm(SWEEPS))
    if p and b:
        tau_eq = int(SWEEPS * p["wall_s"] / max(b["wall_s"], 1e-9))
        record(f"opt_sa_equalwall_tau{tau_eq}", lambda: sa_arm(tau_eq))


def quantum_arms(problem, e_gs, generator_, done, record):
    """Gamma-ladder PT vs plain PIQMC local+global anneal, equal wall."""
    dev, n = problem.device, problem.nspins
    M, P, S = Q_RUNGS, Q_SLICES, Q_SWEEPS
    pt_temp = 1.0 / P  # PT=1 benchmark convention: T = PT/P
    k_init, k_tune, k_pt, k_q = split(generator_, 4)
    s0 = sa.random_state(generator(dev, k_init), n, batch=(M,), device=dev)
    s0 = sa.anneal(problem, schedules.pre_anneal_schedule(3.0, 1.0,
                                                          device=dev),
                   s0, generator(dev, k_init, 1), mcsteps=100)
    confs0 = qmc.replicate(s0, P)  # (M, P, N)

    gammas0 = schedules.geometric(Q_GAMMA_HI, Q_GAMMA_LO, M, device=dev)
    gammas, _ = pt.tune_ladder_piqmc(
        problem, gammas0, pt_temp, generator(dev, k_tune),
        rounds=2, sweeps_per_round=Q_TUNE_SWEEPS,
        global_moves=True, confs=confs0)

    # PT rungs live at Gamma >= Q_GAMMA_LO while the anneal baseline ends
    # near Gamma = 0; quench the PT output classical (inside its timed
    # wall) so that both arms are read out in the same limit
    a_qnch = torch.as_tensor(
        np.geomspace(Q_GAMMA_LO, 1e-8, 100).astype(np.float32), device=dev)

    def arm_qpt():
        def run(seed):
            confs, rate = pt.sample_piqmc(
                problem, gammas, pt_temp, confs0,
                generator(dev, k_pt, seed), S, swap_every=2,
                global_moves=True)
            confs = qmc.anneal(problem, a_qnch, torch.ones_like(a_qnch),
                               pt_temp, confs,
                               generator(dev, k_pt, 500 + seed),
                               global_moves=True)
            return confs, rate

        (confs, rate), wall = timed(run)
        e_min = float(qmc.best_slice_energy(problem, confs).min())
        return dict(eps_best=_eps(e_min, e_gs, n), swap_rate=float(rate),
                    wall_s=wall)

    def piqmc_arm(tau):
        a = schedules.linear(2.5, 1e-8, int(tau), device=dev)

        def run(seed):
            return qmc.anneal(problem, a, torch.ones_like(a), pt_temp, confs0,
                              generator(dev, k_q, seed), global_moves=True)

        confs, wall = timed(run)
        e_min = float(qmc.best_slice_energy(problem, confs).min())
        return dict(eps_best=_eps(e_min, e_gs, n), wall_s=wall,
                    tau=int(tau))

    p = record("quantum_pt", arm_qpt)
    b = record(f"quantum_piqmc_tau{S}", lambda: piqmc_arm(S))
    if p and b:
        tau_eq = int(S * p["wall_s"] / max(b["wall_s"], 1e-9))
        record(f"quantum_piqmc_equalwall_tau{tau_eq}",
               lambda: piqmc_arm(tau_eq))


def main(outdir="results/h100/pt_value", budget_s=1500, device=None):
    dev = _device.resolve(device)
    problem, e_gs = instances.santoro_80x80(lattice=True, device=dev)
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "summary.json")
    done = {}
    if os.path.exists(path):
        with open(path) as f:
            done = json.load(f)
    record = make_recorder(path, done, budget_s=budget_s)

    k1, k2, k3, k4 = split(generator(dev, 11), 4)
    sampling_arms(problem, e_gs, generator(dev, k1), done, record)
    optimization_arms(problem, e_gs, generator(dev, k2), done, record)
    quantum_arms(problem, e_gs, generator(dev, k3), done, record)
    icm_arms(problem, e_gs, generator(dev, k4), done, record)
    print(json.dumps(done, indent=2))
    return done


if __name__ == "__main__":
    main()
