"""Cluster-update crossover experiment: where Wolff clusters DO win
(counterpart of montecarlosolvers_tpu/bench/cluster_crossover.py).

Companion to cluster_value.py (the spin-glass equal-wall comparison). This
measures the textbook setting, the 2D ferromagnetic critical point, where
single-site dynamics suffers critical slowing-down (z ~ 2.2) and Wolff
clusters nearly remove it (z ~ 0.25).

Setup: L x L periodic ferromagnet (J = -1 under H = sum_ij J s_i s_j),
PIQMC representation at small Gamma and per-slice temperature temp = T:
J_perp = -(T_eff/2) ln tanh(Gamma/T_eff) locks the Trotter slices, and a
locked line flips with exp(-P dE_cl / T_eff) = exp(-dE_cl / T), so both
arms sample the classical model at T:

  * local+global: space-time colored sweeps + global line moves (one
    launch of csrc/generic_qmc.cu a sweep, `step0` the sweep's index);
  * +wolff: the same, plus one WCL cluster a chain every `wolff_every`
    sweeps (one launch of csrc/fk_wolff.cu, the same `step0`).

Metric: integrated autocorrelation time tau_int of m^2 (m the space-time
magnetization), Sokal's self-consistent window, averaged over chains,
beside the measured wall a sweep. m^2 stays on the device a sweep and is
stacked and fetched once a chunk. Points: T = T_c and 1.5 T_c.

`main_classical` adds the classical track on (chains, N) states: colored
Metropolis (csrc/packed_sa.cu), classical Wolff (fk_wolff.cu at P = 1)
and classical Swendsen-Wang (csrc/fk_label.cu), alone or after a local
sweep. The JAX study also runs SW on the LatticeProblem's segmented-scan
labeler ("swlat" arms); the port's union-find labels any graph in one
pass, so such an arm would run the "sw" arm's kernel on the same graph,
and the port has no "swlat" arms.

Each `key` of the JAX arms is a torch.Generator here, from which the arm
draws its random start and its counter-hash seed. Writes
results/h100/cluster_value/crossover.json; resumes by arm name.
"""

from __future__ import annotations

import json
import os
import time
import zlib

import numpy as np
import torch

from montecarlosolvers_tpu_torch import _device, schedules
from montecarlosolvers_tpu_torch.bench._common import generator, make_recorder
from montecarlosolvers_tpu_torch.models.ising import IsingProblem
from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck
from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
from montecarlosolvers_tpu_torch.ops import packed as packed_ops
from montecarlosolvers_tpu_torch.solvers.sa import draw_seed

T_C = 2.0 / np.log(1.0 + np.sqrt(2.0))  # 2.269185 (Onsager)
MOVES = ("local", "wolff", "sw", "sw+local")


def fm_lattice(L, device=None):
    """Periodic L x L ferromagnet: J = -1 on every bond (H = sum J s s),
    as an IsingProblem on `device` (None: the card)."""
    rows, cols = [], []
    for r in range(L):
        for c in range(L):
            i = r * L + c
            rows.append(i)
            cols.append(r * L + (c + 1) % L)
            rows.append(i)
            cols.append(((r + 1) % L) * L + c)
    vals = -np.ones(len(rows))
    return IsingProblem.from_edges(L * L, rows, cols, vals, maxnb=4,
                                   device=device)


def tau_int(x, c=6.0):
    """Integrated autocorrelation time of a 1-D series, Sokal window: the
    smallest W with W >= c * tau_int(W)."""
    x = np.asarray(x, dtype=np.float64)
    x = x - x.mean()
    n = x.shape[0]
    f = np.fft.rfft(x, 2 * n)
    acf = np.fft.irfft(f * np.conj(f))[:n].real
    if acf[0] <= 0:
        return 0.5
    acf = acf / acf[0]
    tau = 0.5
    for w in range(1, n // 2):
        tau += acf[w]
        if w >= c * tau:
            break
    return max(tau, 0.5)


def _start(problem, generator_, shape):
    """The packed graph of `problem`'s generic form and random +/-1 states
    of `shape` (rows, P, N) in packed order, and the hash seed."""
    pg = packed_ops.build_packed(ck.generic_form(problem))
    bits = torch.randint(0, 2, shape, generator=generator_,
                         device=generator_.device)
    s = (bits.to(torch.float32) * 2.0 - 1.0).to(problem.device)
    return pg, packed_ops.pack_state(pg, s).contiguous(), \
        draw_seed(generator_)


def _chunks(step, state, burn, nsweeps, chunk):
    """Burn `burn` sweeps, then run `nsweeps` in chunks; step(state, i) ->
    (state, m2 (chains,), flipped fraction). Returns (m2 (nsweeps,
    chains) numpy, the flipped fractions, the smallest wall a sweep of a
    chunk). A chunk's m2 stays on the device until its end."""
    i = 0
    for _ in range(burn):
        state, _, _ = step(state, i)
        i += 1
    m2s, fracs, walls = [], [], []
    for _ in range(-(-nsweeps // chunk)):
        t0 = time.perf_counter()
        rows, fr = [], []
        for _ in range(chunk):
            state, m2, frac = step(state, i)
            rows.append(m2)
            fr.append(frac)
            i += 1
        m2s.append(torch.stack(rows).cpu().numpy())  # the fetch syncs
        walls.append((time.perf_counter() - t0) / chunk)
        fracs.append(torch.stack(fr).cpu().numpy())
    return np.concatenate(m2s, axis=0), np.concatenate(fracs), min(walls)


def run_arm(problem, temp, gamma, chains, nsweeps, generator_,
            wolff_every=0, chunk=2048, P=4, b=1.0, burn=2048):
    """Returns (tau_int sweeps, wall per sweep s, mean m^2, flip_frac)."""
    dev = problem.device
    pg, c, seed = _start(problem, generator_, (chains, P, problem.nspins))
    g = torch.full((1,), gamma, dtype=torch.float32, device=dev)
    bs, jp, teff = schedules.qmc_terms(g, torch.full_like(g, b), temp, P, 1,
                                       dev)
    teffs = torch.full_like(bs, teff)
    zero = torch.zeros((), device=dev)

    def step(c, i):
        c = gk.generic_qmc_anneal(pg, bs, jp, teff, c, seed, True, step0=i)
        frac = zero
        if wolff_every and i % wolff_every == 0:
            new = ck.wolff_anneal(pg, bs, jp, teffs, c, seed, "local",
                                  step0=i)
            frac = (new != c).float().mean()
            c = new
        m = c.mean(dim=(-1, -2))
        return c, m * m, frac

    m2, fracs, wall = _chunks(step, c, burn, nsweeps, chunk)
    taus = [tau_int(m2[:, k]) for k in range(chains)]
    return (float(np.mean(taus)), float(wall), float(m2.mean()),
            float(fracs.mean()))


def run_classical_arm(problem, temp, chains, nsweeps, generator_,
                      move="local", chunk=2048, burn=2048):
    """Classical arms on (chains, N) states: move in MOVES, "local" a
    colored Metropolis sweep, "wolff" one cluster a step, "sw" a full
    Swendsen-Wang sweep a step, "sw+local" a local sweep then SW. Returns
    (tau_int sweeps, wall per sweep s, mean m^2)."""
    if move not in MOVES:
        raise ValueError(f"move must be one of {MOVES}, got {move!r}")
    dev = problem.device
    pg, c, seed = _start(problem, generator_, (chains, 1, problem.nspins))
    t = torch.full((1,), temp, dtype=torch.float32, device=dev)
    ones, zeros = torch.ones_like(t), torch.zeros_like(t)
    zero = torch.zeros((), device=dev)

    def step(c, i):
        if move in ("local", "sw+local"):
            c = gk.packed_sa_anneal(pg, t, c.view(chains, -1), seed,
                                    step0=i).view(chains, 1, -1)
        if move == "wolff":
            c = ck.wolff_anneal(pg, ones, zeros, t, c, seed, step0=i)
        elif move in ("sw", "sw+local"):
            c = ck.sw_anneal(pg, ones, zeros, t, c, seed, step0=i,
                             classical=True)
        m = c.mean(dim=(-1, -2))
        return c, m * m, zero

    m2, _, wall = _chunks(step, c, burn, nsweeps, chunk)
    taus = [tau_int(m2[:, k]) for k in range(chains)]
    return float(np.mean(taus)), float(wall), float(m2.mean())


def _load(outdir):
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "crossover.json")
    done = {}
    if os.path.exists(path):
        with open(path) as f:
            done = json.load(f)
    return path, done


def _arm_seed(name):
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


def main(outdir="results/h100/cluster_value", Ls=(32,), P=4, gamma=0.1,
         chains=16, nsweeps=16384, critical_only_above=32, device=None):
    dev = _device.resolve(device)
    path, done = _load(outdir)
    record = make_recorder(path, done)

    for L in Ls:
        problem = fm_lattice(L, device=dev)
        temps = [("critical", T_C), ("offcritical", 1.5 * T_C)]
        if L > critical_only_above:
            temps = temps[:1]  # the off-critical control needs one size
        for tag, T in temps:
            for arm, we in (("localglobal", 0), ("wolff1", 1), ("wolff4", 4)):
                name = f"{tag}_{arm}_L{L}"
                # cluster arms decorrelate in a few sweeps: a quarter trace
                # estimates their tau as well as the full trace the local
                # arm's
                if we == 0:
                    ns, bn = nsweeps, 2048
                elif L <= 64:
                    ns, bn = max(nsweeps // 4, 8192), 2048
                else:
                    ns, bn = 2048, 512
                ck_ = 2048 if (we == 0 or L <= 32) else (
                    256 if L <= 64 else 64)
                gen = generator(dev, 0, _arm_seed(name))
                record(name, lambda we=we, T=T, gen=gen, ns=ns, ck_=ck_,
                       bn=bn, problem=problem: dict(zip(
                           ("tau_int_sweeps", "wall_per_sweep_s", "mean_m2",
                            "flip_frac"),
                           run_arm(problem, T, gamma, chains, ns, gen,
                                   wolff_every=we, P=P, chunk=ck_,
                                   burn=bn))))

    _summary(done)
    return done


def main_classical(outdir="results/h100/cluster_value", Ls=(32, 64, 128),
                   chains=16, nsweeps=32768, wolff_max_L=64, device=None):
    """Classical track: colored Metropolis vs classical Wolff vs classical
    Swendsen-Wang on the FM lattice at T_c and 1.5 T_c."""
    dev = _device.resolve(device)
    path, done = _load(outdir)
    record = make_recorder(path, done)

    for L in Ls:
        problem = fm_lattice(L, device=dev)
        temps = [("critical", T_C)] + (
            [("offcritical", 1.5 * T_C)] if L == Ls[0] else [])
        for tag, T in temps:
            moves = ["local", "sw", "sw+local"]
            if L <= wolff_max_L:
                moves.insert(1, "wolff")
            for move in moves:
                name = f"cl_{tag}_{move}_L{L}"
                ns = nsweeps if move == "local" else max(nsweeps // 4, 8192)
                ck_ = 2048 if move == "local" else (
                    512 if move != "wolff" else 256)
                gen = generator(dev, 42, _arm_seed(name))
                record(name, lambda move=move, T=T, gen=gen, ns=ns, ck_=ck_,
                       problem=problem: dict(zip(
                           ("tau_int_sweeps", "wall_per_sweep_s", "mean_m2"),
                           run_classical_arm(problem, T, chains, ns, gen,
                                             move=move, chunk=ck_))))
    _summary(done)
    return done


def main_L256(outdir="results/h100/cluster_value", chains=16, device=None):
    """The L = 256 critical point, where the measured scalings put the
    local / SW crossover; Wolff is skipped (one cluster costs a full SW
    sweep's labeling and updates less)."""
    dev = _device.resolve(device)
    path, done = _load(outdir)
    problem = fm_lattice(256, device=dev)
    record = make_recorder(path, done)
    record("cl_critical_local_L256", lambda: dict(zip(
        ("tau_int_sweeps", "wall_per_sweep_s", "mean_m2"),
        run_classical_arm(problem, T_C, chains, 98304,
                          generator(dev, 7, 1), move="local",
                          chunk=2048, burn=16384))))
    record("cl_critical_sw_L256", lambda: dict(zip(
        ("tau_int_sweeps", "wall_per_sweep_s", "mean_m2"),
        run_classical_arm(problem, T_C, chains, 2048,
                          generator(dev, 7, 2), move="sw",
                          chunk=64, burn=256))))
    _summary(done)
    return done


def _summary(done):
    """Print the wall-clock cost of an independent m^2 sample of each
    arm."""
    print("\n== wall per independent sample (tau_int * wall/sweep) ==")
    for name, r in done.items():
        cost = 2.0 * r["tau_int_sweeps"] * r["wall_per_sweep_s"]
        print(f"{name}: tau={r['tau_int_sweeps']:.1f} sweeps, "
              f"{1e3 * r['wall_per_sweep_s']:.3f} ms/sweep, "
              f"cost={1e3 * cost:.1f} ms/sample, m2={r['mean_m2']:.4f}")
    return done


if __name__ == "__main__":
    main()
