"""Cluster updates and parallel tempering on the card (counterpart of
examples/cluster_and_pt.py): the solver families beyond the reference,
each against a plain-SA baseline at small budgets, on the certified 80x80
instance (its generic IsingProblem):

  * classical Wolff / Swendsen-Wang annealing (sa.anneal_wolff /
    sa.anneal_sw),
  * full space-time Swendsen-Wang for PIQMC (qmc.anneal_sw),
  * classical parallel tempering with ladder tuning (pt.sample /
    pt.tune_ladder) and ICM (pt.sample_icm),
  * quantum parallel tempering along the transverse-field ladder
    (pt.sample_piqmc),
  * population annealing with its free energy (pa.sample).

Usage, from the repository root on a machine with a CUDA card and the
instance file in the directory MCS_TPU_INSTANCE_DIR names:

    python -m montecarlosolvers_tpu_torch.examples.cluster_and_pt \\
        [--tau 1000] [--chains 8] [--rungs 48] [--pt-sweeps 600] \\
        [--slices 8]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from montecarlosolvers_tpu_torch import schedules
from montecarlosolvers_tpu_torch.bench._common import generator, split
from montecarlosolvers_tpu_torch.models import instances
from montecarlosolvers_tpu_torch.solvers import pa, pt, qmc, sa


def eps_of(problem, e_gs, states):
    return float((problem.energy(states).mean() - e_gs) / problem.nspins)


def run(problem, e_gs, tau=1000, chains=8, rungs=48, pt_sweeps=600,
        slices=8, seed=7, verbose=True):
    """Every demo on `problem` against the ground-state energy (or a lower
    bound) `e_gs`. Returns {demo: eps_res, or a dict of the demo's
    readouts}."""
    dev, n = problem.device, problem.nspins
    k_sa, k_w, k_sw, k_qsw, k_tune, k_pt, k_qpt, k_icm, k_pa = split(
        generator(dev, seed), 9)
    out = {}

    def say(line):
        if verbose:
            print(line, flush=True)

    sched = schedules.linear(3.0, 0.0, tau, device=dev)
    s0 = sa.random_state(generator(dev, seed, 0), n, batch=(chains,),
                         device=dev)

    # --- classical: local vs local+Wolff vs SW at equal schedule --------
    s_loc = sa.anneal(problem, sched, s0, generator(dev, k_sa))
    out["sa"] = eps_of(problem, e_gs, s_loc)
    say(f"SA local only        tau={tau}: eps_res = {out['sa']:.4f}")
    s_w = sa.anneal_wolff(problem, sched, s0, generator(dev, k_w))
    out["sa_wolff"] = eps_of(problem, e_gs, s_w)
    say(f"SA + Wolff clusters  tau={tau}: eps_res = {out['sa_wolff']:.4f}")
    s_sw = sa.anneal_sw(problem, sched, s0, generator(dev, k_sw),
                        local_sweeps=True)
    out["sa_sw"] = eps_of(problem, e_gs, s_sw)
    say(f"SA + Swendsen-Wang   tau={tau}: eps_res = {out['sa_sw']:.4f}")

    # --- quantum: full space-time SW on one chain -----------------------
    confs = qmc.replicate(s_loc[0], slices)
    a = schedules.transverse_field(2.5, 1e-8, max(tau // 10, 20), device=dev)
    q = qmc.anneal_sw(problem, a, torch.ones_like(a), 1.0 / slices, confs,
                      generator(dev, k_qsw))
    e_best = float(qmc.best_slice_energy(problem, q[None]).mean())
    out["piqmc_sw"] = (e_best - e_gs) / n
    say(f"PIQMC space-time SW  P={slices}: best-slice "
        f"eps_res = {out['piqmc_sw']:.4f}")

    # --- classical PT: tuned ladder --------------------------------------
    temps0 = pt.geometric_ladder(0.3, 2.5, rungs, device=dev)
    temps, pair_rates = pt.tune_ladder(problem, temps0, generator(dev, k_tune),
                                       rounds=3, sweeps_per_round=200)
    states = sa.random_state(generator(dev, k_pt), n, batch=(rungs,),
                             device=dev)
    states, swap_rate = pt.sample(problem, temps, states,
                                  generator(dev, k_pt, 1), pt_sweeps,
                                  swap_every=2)
    e_cold = float(problem.energy(states).min())
    out["pt"] = dict(eps_res=(e_cold - e_gs) / n, swap_rate=float(swap_rate),
                     pair_rate_min=float(np.min(pair_rates)),
                     pair_rate_max=float(np.max(pair_rates)))
    say(f"PT {rungs} rungs, {pt_sweeps} sweeps: swap rate "
        f"{float(swap_rate):.2f} (tuned pair rates "
        f"{np.min(pair_rates):.2f}..{np.max(pair_rates):.2f}), coldest "
        f"eps_res = {out['pt']['eps_res']:.4f}")

    # --- ICM: PT + Houdayer overlap-domain cluster moves -----------------
    pair0 = sa.random_state(generator(dev, k_icm), n, batch=(2, rungs),
                            device=dev)
    pair, icm_rate, hfrac = pt.sample_icm(
        problem, temps, pair0, generator(dev, k_icm, 1), pt_sweeps // 2,
        swap_every=2, houdayer_every=2)
    e_icm = float(problem.energy(pair).min())
    out["icm"] = dict(eps_res=(e_icm - e_gs) / n, swap_rate=float(icm_rate),
                      flip_frac=float(hfrac))
    say(f"ICM (2 ladders + Houdayer): swap rate {float(icm_rate):.2f}, "
        f"flip frac {float(hfrac):.2f}, coldest "
        f"eps_res = {out['icm']['eps_res']:.4f}")

    # --- quantum PT along the Gamma ladder at fixed T --------------------
    gammas = schedules.linear(1.5, 0.3, rungs, device=dev)
    qconfs = qmc.replicate(s_loc[:1], slices).expand(
        rungs, slices, n).contiguous()
    qconfs, qswap = pt.sample_piqmc(problem, gammas, 1.0 / slices, qconfs,
                                    generator(dev, k_qpt), pt_sweeps // 4,
                                    global_moves=True)
    e_q = float(qmc.best_slice_energy(problem, qconfs).min())
    out["quantum_pt"] = dict(eps_res=(e_q - e_gs) / n,
                             swap_rate=float(qswap))
    say(f"Quantum PT (Gamma ladder): swap rate {float(qswap):.2f}, "
        f"best-slice eps_res = {out['quantum_pt']['eps_res']:.4f}")

    # --- population annealing: weighted ensemble + free energy -----------
    pop = sa.random_state(generator(dev, k_pa), n,
                          batch=(max(256, chains),), device=dev)
    temps_pa = pa.beta_linear(3.0, tau, beta_start=0.0, device=dev)
    pop, log_z, stats = pa.sample(problem, temps_pa, pop,
                                  generator(dev, k_pa, 1), beta0=0.0,
                                  collect_stats=True)
    f_per_spin = (float(log_z) + pa.uniform_log_z(n)) / n
    out["pa"] = dict(eps_res=eps_of(problem, e_gs, pop),
                     log_z_per_spin=f_per_spin,
                     min_ess_frac=float(stats["ess"].min()) / pop.shape[0])
    say(f"PA {pop.shape[0]} replicas, {tau} beta steps: "
        f"eps_res = {out['pa']['eps_res']:.4f}, ln Z / N = "
        f"{f_per_spin:.4f} (free energy), min ESS "
        f"{out['pa']['min_ess_frac']:.2f}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tau", type=int, default=1000)
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--rungs", type=int, default=48,
                    help="PT ladder size; adjacent-rung overlap needs the "
                         "rung ratio - 1 ~ 1/sqrt(N), so N=6400 wants "
                         "dozens of rungs (see pt.geometric_ladder)")
    ap.add_argument("--pt-sweeps", type=int, default=600)
    ap.add_argument("--slices", type=int, default=8,
                    help="Trotter slices for the quantum demos")
    args = ap.parse_args(argv)
    problem, e_gs = instances.santoro_80x80()
    run(problem, e_gs, tau=args.tau, chains=args.chains, rungs=args.rungs,
        pt_sweeps=args.pt_sweeps, slices=args.slices)


if __name__ == "__main__":
    main()
