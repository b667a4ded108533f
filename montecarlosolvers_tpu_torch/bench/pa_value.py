"""Population-annealing value experiment (counterpart of
montecarlosolvers_tpu/bench/pa_value.py): does PA's resampling earn its
cost on the certified santoro 80x80 instance, on the card, at equal
budget, against the baselines pt_value uses, at the same cold temperature?

1. SAMPLING at T_cold = 0.5 (pt_value's target): R quenched chains run
   local dynamics at T_cold for S sweeps (the trapped baseline); the PA
   arm spends S beta-linear steps from beta = 0 to 1/T_cold, one sweep a
   step, resampling every step. Metric: mean energy of the T_cold
   ensemble (PA: the final population; the quench: the second half of its
   trace). The quench gets an equal-wall rematch, and PT a matched-resource
   arm (R // 48 ladders of 48 rungs). PA also reports ln Z(beta) / N.

2. OPTIMIZATION at equal wall-clock: best residual energy found. PA (beta
   0 -> 1/T_OPT over S steps, min over the final population) against SA
   restarts (R chains, linear 3 -> 0) re-run at the tau' matching PA's
   measured wall, and matched PT.

3. The round-5 arms (`v2_arms`): adaptive-step PA, weighted combining of K
   runs, and PA over the PIQMC extended ensemble, fixed and adaptive, each
   against equal-wall baselines.

Each `key` of the JAX arms is a torch.Generator here (`_common.split` /
`generator`); the JAX vmap over PT ladders is pt.sample's leading ladder
axis. The adaptive arms read min_ess_frac 1.0 when no step ran (the JAX
study raises there, as `solve("pa", adaptive=True)` did before the port
fixed it). Writes results/h100/pa_value/summary.json (resume-cached by arm
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
                                                       sync, timed)
from montecarlosolvers_tpu_torch.models import instances
from montecarlosolvers_tpu_torch.solvers import pa, pt, qmc, sa

REPLICAS = 1024
SWEEPS = 4000
T_COLD = 0.5   # pt_value's sampling target: eps cross-comparable
T_OPT = 0.1    # optimization arm's final temperature (beta_end = 10)
MCSTEPS = 1
# matched-resource PT: its ladders tuned over 3 rounds of TUNE_SWEEPS
# sweeps (the JAX study's 200)
TUNE_SWEEPS = 200
# v2_arms: runs combined, and the quantum PA population, slices, steps and
# adaptive step cap (the JAX study's local 8, 256, 20, 1000 and 4096)
COMBINE_RUNS = 8
Q_REPLICAS, Q_SLICES, Q_STEPS, Q_MAX_STEPS = 256, 20, 1000, 4096
# the keys of each record family of sampling_arms and optimization_arms
# (`_common.by_family`)
RECORD_KEYS = {
    "sampling_pa": {"eps_cold", "log_z_per_spin", "min_ess_frac", "wall_s",
                    "total_sweeps"},
    "sampling_quench": {"eps_cold", "wall_s", "total_sweeps"},
    "sampling_pt_matched": {"eps_cold", "swap_rate", "wall_s",
                            "total_sweeps", "replicas"},
    "opt_pa": {"eps_best", "eps_mean", "min_ess_frac", "wall_s"},
    "opt_sa": {"eps_best", "eps_mean", "wall_s", "tau"},
    "opt_pt_matched": {"eps_best", "eps_mean", "swap_rate", "wall_s",
                       "replicas"},
}


def _eps(e, e_gs, n):
    return float((e - e_gs) / n)


def _min_ess_frac(stats, r):
    """The least ESS over the live steps as a fraction of the population;
    1.0 when no step ran."""
    ess = np.asarray(stats["ess"].cpu() if torch.is_tensor(stats["ess"])
                     else stats["ess"])
    return float(ess.min()) / r if ess.size else 1.0


def _random_paths(generator_, r, slices, n, dev):
    bits = torch.randint(0, 2, (r, slices, n), generator=generator_,
                         device=generator_.device)
    return (bits.to(torch.float32) * 2.0 - 1.0).to(dev)


def _timed_twice(run):
    """Wall of the second of two identical calls (the adaptive arms choose
    their grid from their own draws, so they are not seed-replayable
    through `timed`'s best-of-2)."""
    out = run()
    sync(out)
    t0 = time.perf_counter()
    out = run()
    sync(out)
    return out, time.perf_counter() - t0


def _matched_pt(problem, t_lo, generator_, with_energy, ladders, rungs):
    """PT with PA's replica and sweep count: `ladders` tuned ladders of
    `rungs` rungs side by side (pt.sample's leading ladder axis)."""
    dev, n = problem.device, problem.nspins
    k_tune, k_run = split(generator_, 2)
    temps0 = pt.geometric_ladder(t_lo, 2.5, rungs, device=dev)
    temps, _ = pt.tune_ladder(problem, temps0, generator(dev, k_tune),
                              rounds=3, sweeps_per_round=TUNE_SWEEPS)
    states = sa.random_state(generator(dev, k_run), n,
                             batch=(ladders, rungs), device=dev)

    def run(seed):
        return pt.sample(problem, temps, states, generator(dev, k_run, seed),
                         SWEEPS, swap_every=2, collect_energy=with_energy)

    return timed(run)


def sampling_arms(problem, e_gs, generator_, done, record):
    """PA vs quenched local dynamics at T_cold, equal step budget then
    equal wall, and matched PT."""
    dev, n = problem.device, problem.nspins
    k_init, k_pa, k_q, k_pt = split(generator_, 4)
    s0 = sa.random_state(generator(dev, k_init), n, batch=(REPLICAS,),
                         device=dev)
    temps_pa = pa.beta_linear(1.0 / T_COLD, SWEEPS, beta_start=0.0,
                              device=dev)

    def arm_pa():
        def run(seed):
            return pa.sample(problem, temps_pa, s0,
                             generator(dev, k_pa, seed), mcsteps=MCSTEPS,
                             beta0=0.0, collect_stats=True)

        (states, log_z, stats), wall = timed(run)
        es = problem.energy(states).cpu().numpy()
        return dict(
            eps_cold=_eps(es.mean(), e_gs, n),
            log_z_per_spin=float(log_z) / n + float(np.log(2.0)),
            min_ess_frac=_min_ess_frac(stats, REPLICAS),
            wall_s=wall,
            total_sweeps=REPLICAS * SWEEPS * MCSTEPS,
        )

    def quench_arm(sweeps, tag_seed):
        sched = torch.full((sweeps,), T_COLD, dtype=torch.float32,
                           device=dev)

        def run(seed):
            return sa.anneal(problem, sched, s0,
                             generator(dev, k_q, tag_seed + seed),
                             collect_energy=True)

        (_, es), wall = timed(run)
        es = es.cpu().numpy()  # (sweeps, R)
        return dict(
            eps_cold=_eps(float(es[sweeps // 2:].mean()), e_gs, n),
            wall_s=wall,
            total_sweeps=REPLICAS * sweeps,
        )

    p = record("sampling_pa", arm_pa)
    q = record("sampling_quench", lambda: quench_arm(SWEEPS, 0))
    if p and q:
        # equal-wall quench rematch: PA pays for its per-step energy
        # readout and resample; give the quench the same measured wall
        sweeps_eq = int(SWEEPS * p["wall_s"] / max(q["wall_s"], 1e-9))
        record(f"sampling_quench_equalwall_s{sweeps_eq}",
               lambda: quench_arm(sweeps_eq, 100))

    # matched-resource PT: pt_value's 48-rung ladder, REPLICAS // 48 of it
    rungs = 48
    ladders = max(1, REPLICAS // rungs)

    def arm_pt_matched():
        (_, rates, es), wall = _matched_pt(
            problem, T_COLD, generator(dev, k_pt), True, ladders, rungs)
        es = es.cpu().numpy()  # (SWEEPS, ladders, rungs); rung 0 = T_cold
        return dict(
            eps_cold=_eps(float(es[SWEEPS // 2:, :, 0].mean()), e_gs, n),
            swap_rate=float(rates.mean()),
            wall_s=wall,
            total_sweeps=ladders * rungs * SWEEPS,
            replicas=ladders * rungs,
        )

    record(f"sampling_pt_matched_{ladders}x{rungs}", arm_pt_matched)


def optimization_arms(problem, e_gs, generator_, done, record):
    """Best energy found: PA vs SA restarts at equal wall-clock, and
    matched PT."""
    dev, n = problem.device, problem.nspins
    k_init, k_pa, k_sa, k_pt = split(generator_, 4)
    s0 = sa.random_state(generator(dev, k_init), n, batch=(REPLICAS,),
                         device=dev)
    temps_pa = pa.beta_linear(1.0 / T_OPT, SWEEPS, beta_start=0.0,
                              device=dev)

    def arm_pa():
        def run(seed):
            return pa.sample(problem, temps_pa, s0,
                             generator(dev, k_pa, seed), mcsteps=MCSTEPS,
                             beta0=0.0, collect_stats=True)

        (states, log_z, stats), wall = timed(run)
        es = problem.energy(states).cpu().numpy()
        return dict(
            eps_best=_eps(es.min(), e_gs, n),
            eps_mean=_eps(es.mean(), e_gs, n),
            min_ess_frac=_min_ess_frac(stats, REPLICAS),
            wall_s=wall,
        )

    def sa_arm(tau, tag_seed):
        sched = schedules.linear(3.0, 0.0, tau, device=dev)

        def run(seed):
            return sa.anneal(problem, sched, s0,
                             generator(dev, k_sa, tag_seed + seed))

        states, wall = timed(run)
        es = problem.energy(states).cpu().numpy()
        return dict(eps_best=_eps(es.min(), e_gs, n),
                    eps_mean=_eps(es.mean(), e_gs, n), wall_s=wall,
                    tau=int(tau))

    p = record("opt_pa", arm_pa)
    b = record(f"opt_sa_tau{SWEEPS}", lambda: sa_arm(SWEEPS, 0))
    if p and b:
        tau_eq = int(SWEEPS * p["wall_s"] / max(b["wall_s"], 1e-9))
        record(f"opt_sa_equalwall_tau{tau_eq}", lambda: sa_arm(tau_eq, 100))

    rungs = 48
    ladders = max(1, REPLICAS // rungs)

    def arm_pt_matched():
        (states_out, rates), wall = _matched_pt(
            problem, T_OPT, generator(dev, k_pt), False, ladders, rungs)
        es = problem.energy(states_out.reshape(-1, n)).cpu().numpy()
        return dict(
            eps_best=_eps(es.min(), e_gs, n),
            eps_mean=_eps(es.mean(), e_gs, n),
            swap_rate=float(rates.mean()),
            wall_s=wall,
            replicas=ladders * rungs,
        )

    record(f"opt_pt_matched_{ladders}x{rungs}", arm_pt_matched)


def v2_arms(problem, e_gs, generator_, done, record):
    """Adaptive-step PA, weighted multi-run combining, and PA over the
    PIQMC extended ensemble."""
    dev, n = problem.device, problem.nspins
    k_init, k_ad, k_comb, k_q = split(generator_, 4)
    s0 = sa.random_state(generator(dev, k_init), n, batch=(REPLICAS,),
                         device=dev)

    # --- adaptive dbeta (ESS-targeted) vs the fixed beta-linear grid ----
    def adaptive_run(beta_end, m, tag):
        def run():
            return pa.sample_adaptive(
                problem, beta_end, s0, generator(dev, k_ad, tag),
                target_frac=0.9, mcsteps=m, max_steps=2 * SWEEPS)

        (states, log_z, stats), wall = _timed_twice(run)
        es = problem.energy(states).cpu().numpy()
        return es, log_z, stats, wall

    def arm_adaptive(beta_end):
        es, log_z, stats, wall = adaptive_run(beta_end, MCSTEPS, 0)
        return dict(
            eps_cold=_eps(es.mean(), e_gs, n),
            eps_best=_eps(es.min(), e_gs, n),
            log_z_per_spin=float(log_z) / n + float(np.log(2.0)),
            n_steps=stats["n_steps"],
            reached=stats["reached"],
            families=stats["families"],
            min_ess_frac=_min_ess_frac(stats, REPLICAS),
            wall_s=round(wall, 3),
        )

    a_cold = record("sampling_pa_adaptive",
                    lambda: arm_adaptive(1.0 / T_COLD))
    a_opt = record("opt_pa_adaptive", lambda: arm_adaptive(1.0 / T_OPT))

    # The arms above run mcsteps=1 an adaptive step, an order fewer sweeps
    # than the fixed grid's SWEEPS; the fair comparison scales mcsteps so
    # that the total sweeps match
    def arm_adaptive_eq(beta_end, n_steps):
        m = max(1, SWEEPS // max(n_steps, 1))
        es, log_z, stats, wall = adaptive_run(beta_end, m, 1)
        return dict(
            eps_cold=_eps(es.mean(), e_gs, n),
            eps_best=_eps(es.min(), e_gs, n),
            log_z_per_spin=float(log_z) / n + float(np.log(2.0)),
            n_steps=stats["n_steps"],
            mcsteps=m,
            total_sweeps=REPLICAS * stats["n_steps"] * m,
            families=stats["families"],
            wall_s=round(wall, 3),
        )

    if a_cold:
        record("sampling_pa_adaptive_eqsweeps",
               lambda: arm_adaptive_eq(1.0 / T_COLD, a_cold["n_steps"]))
    ae = None
    if a_opt:
        ae = record("opt_pa_adaptive_eqsweeps",
                    lambda: arm_adaptive_eq(1.0 / T_OPT, a_opt["n_steps"]))

    # SA restarts rematched to the adaptive arm's measured wall
    if ae:
        def arm_sa_eq():
            base = done.get(f"opt_sa_tau{SWEEPS}")
            w_per_tau = (base["wall_s"] / base["tau"]) if base else None
            tau = (int(ae["wall_s"] / w_per_tau) if w_per_tau
                   else 3 * SWEEPS)

            def run(seed):
                return sa.anneal(problem,
                                 schedules.linear(3.0, 0.0, tau, device=dev),
                                 s0, generator(dev, k_ad, 200 + seed))

            states, wall = timed(run)
            es = problem.energy(states).cpu().numpy()
            return dict(eps_best=_eps(es.min(), e_gs, n),
                        eps_mean=_eps(es.mean(), e_gs, n), wall_s=wall,
                        tau=int(tau))

        record("opt_sa_equalwall_for_adaptive", arm_sa_eq)

    # --- weighted combining of K independent runs -----------------------
    def arm_combined(K=COMBINE_RUNS):
        temps_pa = pa.beta_linear(1.0 / T_COLD, SWEEPS, beta_start=0.0,
                                  device=dev)
        lzs, fams, means = [], [], []
        for k in range(K):
            sk = sa.random_state(generator(dev, k_comb, k), n,
                                 batch=(REPLICAS,), device=dev)
            states, lz, stats = pa.sample(
                problem, temps_pa, sk, generator(dev, k_comb, 100 + k),
                mcsteps=MCSTEPS, beta0=0.0, collect_stats=True)
            es = problem.energy(states).cpu().numpy()
            lzs.append(float(lz))
            fams.append(stats["families"])
            means.append(float(es.mean()))
        comb = pa.combine_runs(lzs, observables=means)
        return dict(
            runs=K,
            eps_cold_combined=_eps(comb["observable"], e_gs, n),
            eps_cold_per_run=[round((m - e_gs) / n, 6) for m in means],
            log_z_per_spin=comb["log_z"] / n + float(np.log(2.0)),
            run_ess=round(comb["run_ess"], 2),
            families_per_run=fams,
            families_combined=int(np.sum(fams)),
        )

    record(f"sampling_pa_combined_k{COMBINE_RUNS}", arm_combined)

    # --- PA x PIQMC: resampling over the extended ensemble --------------
    R_Q, P_Q, S_Q = Q_REPLICAS, Q_SLICES, Q_STEPS
    pt_temp = 1.0 / P_Q  # PT=1 benchmark convention

    def paths():
        return _random_paths(generator(dev, k_q), R_Q, P_Q, n, dev)

    def arm_paq():
        confs = paths()
        gammas = schedules.transverse_field(2.5, 1e-8, S_Q, device=dev)

        def run(seed):
            return pa.sample_piqmc(problem, gammas, pt_temp, confs,
                                   generator(dev, k_q, seed),
                                   mcsteps=MCSTEPS, global_moves=True,
                                   collect_stats=True)

        (out, log_z, stats), wall = timed(run)
        es = qmc.best_slice_energy(problem, out).cpu().numpy()
        return dict(
            eps_best=_eps(es.min(), e_gs, n),
            eps_mean=_eps(es.mean(), e_gs, n),
            families=stats["families"],
            min_ess_frac=_min_ess_frac(stats, R_Q),
            resample_frac=float(stats["resampled"].float().mean()),
            wall_s=wall,
            replicas=R_Q, slices=P_Q, steps=S_Q,
        )

    p = record("opt_paq", arm_paq)

    # the adaptive Gamma grid (sample_piqmc_adaptive): its step count
    # measures how expensive exact extended-ensemble tracking is
    def arm_paq_adaptive():
        confs = paths()

        def run():
            return pa.sample_piqmc_adaptive(
                problem, 2.5, 1e-3, pt_temp, confs, generator(dev, k_q, 9),
                target_frac=0.8, mcsteps=1, max_steps=Q_MAX_STEPS,
                global_moves=True)

        (out, log_z, stats), wall = _timed_twice(run)
        es = qmc.best_slice_energy(problem, out).cpu().numpy()
        return dict(
            eps_best=_eps(es.min(), e_gs, n),
            eps_mean=_eps(es.mean(), e_gs, n),
            n_steps=stats["n_steps"],
            reached=stats["reached"],
            families=stats["families"],
            min_ess_frac=(_min_ess_frac(stats, R_Q) if stats["n_steps"]
                          else None),
            wall_s=round(wall, 3),
            replicas=R_Q, slices=P_Q,
        )

    pa_ad = record("opt_paq_adaptive", arm_paq_adaptive)

    # equal-wall plain PIQMC rematches (same population, no resampling)
    def arm_piqmc_eq(target_wall):
        confs = paths()

        def run(tau, seed):
            a = schedules.transverse_field(2.5, 1e-8, tau, device=dev)
            return qmc.anneal(problem, a, torch.ones_like(a), pt_temp, confs,
                              generator(dev, k_q, 500 + seed),
                              global_moves=True)

        # the per-step wall first, then the PA arm's wall matched
        out, w0 = timed(run, S_Q)
        tau_eq = max(S_Q, int(S_Q * target_wall / max(w0, 1e-9)))
        if tau_eq > S_Q:
            out, _ = timed(run, tau_eq)
        es = qmc.best_slice_energy(problem, out).cpu().numpy()
        return dict(
            eps_best=_eps(es.min(), e_gs, n),
            eps_mean=_eps(es.mean(), e_gs, n),
            tau=int(tau_eq),
            wall_baseline_s=w0,
        )

    if p:
        record("opt_piqmc_equalwall_for_paq",
               lambda: arm_piqmc_eq(p["wall_s"]))
    if pa_ad:
        record("opt_piqmc_equalwall_for_paq_adaptive",
               lambda: arm_piqmc_eq(pa_ad["wall_s"]))


def main(outdir="results/h100/pa_value", budget_s=1200, device=None):
    dev = _device.resolve(device)
    problem, e_gs = instances.santoro_80x80(lattice=True, device=dev)
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "summary.json")
    done = {}
    if os.path.exists(path):
        with open(path) as f:
            done = json.load(f)
    record = make_recorder(path, done, budget_s=budget_s)

    k1, k2, k3 = split(generator(dev, 23), 3)
    sampling_arms(problem, e_gs, generator(dev, k1), done, record)
    optimization_arms(problem, e_gs, generator(dev, k2), done, record)
    v2_arms(problem, e_gs, generator(dev, k3), done, record)
    print(json.dumps(done, indent=2))
    return done


if __name__ == "__main__":
    main()
