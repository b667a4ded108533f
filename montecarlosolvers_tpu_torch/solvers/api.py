"""High-level one-call solving API (counterpart of
montecarlosolvers_tpu/solvers/api.py).

`solve` runs on the problem's device and returns a `SampleSet` of numpy
arrays, samples sorted by energy. The port covers the methods "sa",
"piqmc" (at any P) and "svmc" on any LatticeProblem (any L, open or
periodic) and on any IsingProblem (the generic kernels of
`ops/generic_kernels.py`), "sa" on a DenseProblem (the dense engine,
`ops/dense_kernels.py`), the cluster methods "sa_wolff", "sa_sw",
"piqmc_wolff", "piqmc_sw" and "piqmc_sw_full" on a LatticeProblem (taken
to_generic()) or an IsingProblem (`ops/cluster_kernels.py`), and the
samplers "pt" and "pa" on every problem, "icm" and "paq" on a
LatticeProblem or an IsingProblem (`solvers/pt.py`, `solvers/pa.py`). A
problem of the JAX package is refused (`convert.py` carries one across).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from montecarlosolvers_tpu_torch import _roadmap
from montecarlosolvers_tpu_torch import schedules
from montecarlosolvers_tpu_torch.solvers import pa as pa_mod
from montecarlosolvers_tpu_torch.solvers import pt as pt_mod
from montecarlosolvers_tpu_torch.solvers import qmc as qmc_mod
from montecarlosolvers_tpu_torch.solvers import sa as sa_mod
from montecarlosolvers_tpu_torch.solvers import svmc as svmc_mod


@dataclasses.dataclass(frozen=True)
class SampleSet:
    """Solve result: states sorted by energy (ascending)."""

    samples: np.ndarray   # (num_reads, N) +/-1
    energies: np.ndarray  # (num_reads,)
    info: dict

    @property
    def best(self):
        return self.samples[0]

    @property
    def best_energy(self):
        return float(self.energies[0])

    def __len__(self):
        return self.samples.shape[0]


def _finalize(problem, states, info, energies=None):
    if energies is None:
        energies = problem.energy(states)
    states = states.cpu().numpy()
    energies = np.asarray(energies.cpu().numpy() if torch.is_tensor(energies)
                          else energies)
    order = np.argsort(energies)
    return SampleSet(states[order], energies[order], info)


_METHOD_KW = {
    "sa": {"t_start", "t_end"},
    "sa_wolff": {"t_start", "t_end", "local_sweeps"},
    "sa_sw": {"t_start", "t_end", "local_sweeps"},
    "piqmc": {"slices", "pt", "field_start", "pre_anneal"},
    "piqmc_wolff": {"slices", "pt", "field_start", "pre_anneal", "rule",
                    "alpha"},
    "piqmc_sw": {"slices", "pt", "field_start", "pre_anneal", "alpha",
                 "per_slice_seeds"},
    "piqmc_sw_full": {"slices", "pt", "field_start", "pre_anneal", "alpha",
                      "local_sweeps"},
    "svmc": {"field_start", "temp"},
    "pt": {"t_min", "t_max", "ladder"},
    "icm": {"t_min", "t_max", "ladder", "houdayer_every"},
    "pa": {"beta_end", "mcsteps", "ess_threshold", "adaptive",
           "target_frac"},
    "paq": {"beta_end", "slices", "pt", "field_start", "mcsteps",
            "ess_threshold"},
}


def _auto_ladder(n, t_min, t_max):
    """Rung count so adjacent rungs' energy distributions overlap (JAX
    `_auto_ladder`, api.py:75): rung ratio - 1 ~ 2.5 / sqrt(N), the JAX
    package's calibration for a 20-60 % swap rate."""
    return max(4, int(np.ceil(
        np.log(t_max / t_min) * np.sqrt(n) / 2.5
    )) + 1)


def solve(problem, method="sa", num_reads=64, sweeps=1000, seed=0, **kw):
    """Anneal `num_reads` independent trajectories on the problem's device
    and return a SampleSet.

    method:
      "sa"    — classical simulated annealing; kw: t_start=3.0, t_end=0.0.
      "piqmc" — MST path-integral QMC with global moves; kw: slices=20,
                pt=1.0, field_start=3.0, pre_anneal=True (the MST driver's
                pre-anneal: T from 3.0 to pt in steps of 0.05, 100 sweeps
                each, examples/santoro80.py:284-285, through whichever SA
                engine the problem takes). Each read returns its best
                slice.
      "sa_wolff" — classical annealing with one Wolff cluster a sweep;
                kw: t_start=3.0, t_end=0.05 (cluster bonds degenerate at
                T = 0), local_sweeps=True (a colored sweep before each).
      "sa_sw" — classical Swendsen-Wang, every cluster a sweep; kw as
                sa_wolff.
      "piqmc_wolff" — PIQMC with one space-time Wolff cluster a sweep; kw:
                piqmc's + rule="local" | "full", alpha (bath bonds when
                given).
      "piqmc_sw" — dissipative PIQMC with SW bath line clusters
                (qmc.anneal_sw_bath); kw: piqmc's + alpha=1e-3,
                per_slice_seeds=True.
      "piqmc_sw_full" — PIQMC with full space-time Swendsen-Wang sweeps
                (qmc.anneal_sw); kw: piqmc's + alpha (optional bath
                bonds), local_sweeps=True.
      "svmc"  — spin-vector MC with TF proposals; kw: field_start=3.0,
                temp=0.05. A: field_start -> 1e-8 over `sweeps`, B = 1;
                each read returns the z-projection of its angles.
      "pt"    — parallel tempering; kw: t_min=0.1, t_max=3.0, ladder=None
                (auto-sized, `_auto_ladder`; an int overrides). num_reads
                ladders run as one batch of reads x rungs chains; each
                returns its coldest rung.
      "icm"   — PT with Houdayer moves between paired ladders
                (pt.sample_icm, swap_every=2); kw: pt's + houdayer_every=2.
                ceil(reads / 2) pairs; each ladder returns its coldest rung.
      "pa"    — population annealing of num_reads replicas; kw:
                beta_end=10.0, mcsteps=1, ess_threshold=1.0 (the
                beta-linear grid of `sweeps` steps from beta = 0), or
                adaptive=True with target_frac=0.9 (at most `sweeps`
                steps; ess_threshold is then refused, since the adaptive
                sampler resamples every step). info: log_z (absolute),
                min_ess_frac (1.0 when no step ran), and with adaptive
                n_steps, reached and families.
      "paq"   — quantum PA with line moves; kw: slices=20, pt=1.0,
                field_start=2.5, mcsteps=1, ess_threshold=1.0 (beta_end
                is accepted and unused, as in the JAX solve). Each read
                returns its best slice. info: families, min_ess_frac.

    `seed` seeds the torch.Generator that draws the initial states and the
    counter-hash seeds.
    """
    if method not in _METHOD_KW:
        raise ValueError(f"unknown method: {method}")
    unknown = set(kw) - _METHOD_KW[method]
    if unknown:
        raise TypeError(
            f"solve(method={method!r}) got unexpected options "
            f"{sorted(unknown)}; accepted: {sorted(_METHOD_KW[method])}"
        )
    if method == "pa" and kw.get("adaptive") and "ess_threshold" in kw:
        raise TypeError("solve(method='pa', adaptive=True) resamples every "
                        "step: ess_threshold applies to the fixed grid only")
    _roadmap.require_problem(
        problem, None if method in ("sa", "pt", "pa", "icm")
        else f"solve(method={method!r})")

    dev = problem.device
    gen = torch.Generator().manual_seed(seed)
    n = problem.nspins
    info = dict(method=method, num_reads=num_reads, sweeps=sweeps, seed=seed)

    if method in ("sa", "sa_wolff", "sa_sw"):
        # cluster bond probabilities degenerate at T = 0 (every satisfied
        # bond activates), so the cluster anneals stop at a small floor
        sched = schedules.linear(
            kw.get("t_start", 3.0),
            kw.get("t_end", 0.0 if method == "sa" else 0.05), sweeps,
            device=dev)
        s0 = sa_mod.random_state(gen, n, batch=(num_reads,), device=dev)
        if method == "sa":
            out = sa_mod.anneal(problem, sched, s0, gen)
        else:
            run = (sa_mod.anneal_wolff if method == "sa_wolff"
                   else sa_mod.anneal_sw)
            out = run(problem, sched, s0, gen,
                      local_sweeps=kw.get("local_sweeps", True))
        return _finalize(problem, out, info)

    if method == "svmc":
        a = schedules.linear(kw.get("field_start", 3.0), 1e-8, sweeps,
                             device=dev)
        th = svmc_mod.random_state(gen, n, batch=(num_reads,), device=dev)
        out = svmc_mod.anneal(problem, a, torch.ones_like(a),
                              kw.get("temp", 0.05), th, gen, tf=True)
        return _finalize(problem, svmc_mod.z_projection(out), info)

    if method == "pa":
        return _solve_pa(problem, num_reads, sweeps, gen, info, kw)
    if method == "paq":
        return _solve_paq(problem, num_reads, sweeps, gen, info, kw)
    if method in ("pt", "icm"):
        return _solve_pt(problem, method, num_reads, sweeps, gen, info, kw)

    # the PIQMC methods
    slices = kw.get("slices", 20)
    pt = kw.get("pt", 1.0)
    s0 = sa_mod.random_state(gen, n, batch=(num_reads,), device=dev)
    if kw.get("pre_anneal", True):
        pre = schedules.pre_anneal_schedule(3.0, pt, device=dev)
        s0 = sa_mod.anneal(problem, pre, s0, gen, mcsteps=100)
    confs = qmc_mod.replicate(s0, slices)
    a = schedules.transverse_field(kw.get("field_start", 3.0), 1e-8, sweeps,
                                   device=dev)
    b = torch.ones_like(a)
    lut = (schedules.bath_lookuptable(slices, kw["alpha"], device=dev)
           if "alpha" in kw else None)
    if method == "piqmc":
        confs = qmc_mod.anneal(problem, a, b, pt / slices, confs, gen,
                               global_moves=True)
    elif method == "piqmc_wolff":
        confs = qmc_mod.anneal_wolff(problem, a, b, pt / slices, confs, gen,
                                     rule=kw.get("rule", "local"),
                                     lookuptable=lut)
    elif method == "piqmc_sw":
        lut = schedules.bath_lookuptable(slices, kw.get("alpha", 1e-3),
                                         device=dev)
        confs = qmc_mod.anneal_sw_bath(
            problem, a, b, pt / slices, lut, confs, gen,
            per_slice_seeds=kw.get("per_slice_seeds", True))
    else:  # piqmc_sw_full: the global space-time SW decomposition
        confs = qmc_mod.anneal_sw(problem, a, b, pt / slices, confs, gen,
                                  lookuptable=lut,
                                  local_sweeps=kw.get("local_sweeps", True))
    # best slice per read, chosen on the host as the JAX solve chooses it
    es = problem.energy(confs).cpu().numpy()  # (reads, P)
    best_k = es.argmin(axis=-1)
    rows = np.arange(num_reads)
    states = confs[torch.as_tensor(rows, device=dev),
                   torch.as_tensor(best_k, device=dev)]
    return _finalize(problem, states, info, energies=es[rows, best_k])


def _solve_pa(problem, num_reads, sweeps, gen, info, kw):
    """solve("pa") (JAX api.py:229-257)."""
    dev, n = problem.device, problem.nspins
    states = sa_mod.random_state(gen, n, batch=(num_reads,), device=dev)
    if kw.get("adaptive"):
        out, log_z, stats = pa_mod.sample_adaptive(
            problem, kw.get("beta_end", 10.0), states, gen,
            target_frac=kw.get("target_frac", 0.9),
            mcsteps=kw.get("mcsteps", 1), max_steps=sweeps)
        info["n_steps"] = stats["n_steps"]
        info["reached"] = stats["reached"]
        info["families"] = stats["families"]
        ess = stats["ess"]
    else:
        temps = pa_mod.beta_linear(kw.get("beta_end", 10.0), sweeps,
                                   beta_start=0.0, device=dev)
        out, log_z, stats = pa_mod.sample(
            problem, temps, states, gen, mcsteps=kw.get("mcsteps", 1),
            beta0=0.0, ess_threshold=kw.get("ess_threshold", 1.0),
            collect_stats=True)
        ess = stats["ess"].cpu().numpy()
    info["log_z"] = float(log_z) + pa_mod.uniform_log_z(n)
    # no live step (an adaptive run with beta_end <= 0): nothing was lost
    info["min_ess_frac"] = (float(np.min(ess)) / num_reads if len(ess)
                            else 1.0)
    return _finalize(problem, out, info)


def _solve_paq(problem, num_reads, sweeps, gen, info, kw):
    """solve("paq") (JAX api.py:259-290): random paths, the Gamma schedule
    field_start -> 1e-8, line moves on, each read's best slice."""
    dev, n = problem.device, problem.nspins
    slices = kw.get("slices", 20)
    bits = torch.randint(0, 2, (num_reads, slices, n), generator=gen,
                         device=gen.device)
    confs = (bits.to(torch.float32) * 2.0 - 1.0).to(dev)
    gammas = schedules.transverse_field(kw.get("field_start", 2.5), 1e-8,
                                        sweeps, device=dev)
    confs, log_z, stats = pa_mod.sample_piqmc(
        problem, gammas, kw.get("pt", 1.0) / slices, confs, gen,
        mcsteps=kw.get("mcsteps", 1),
        ess_threshold=kw.get("ess_threshold", 1.0), global_moves=True,
        collect_stats=True)
    info["families"] = stats["families"]
    info["min_ess_frac"] = float(stats["ess"].min()) / num_reads
    es = problem.energy(confs)  # (reads, P)
    best = torch.argmin(es, dim=-1)
    rows = torch.arange(num_reads, device=dev)
    return _finalize(problem, confs[rows, best], info,
                     energies=es[rows, best])


def _solve_pt(problem, method, num_reads, sweeps, gen, info, kw):
    """solve("pt") and solve("icm") (JAX api.py:292-319): the ladders of
    all reads (or pairs) as one batch of chains."""
    dev, n = problem.device, problem.nspins
    t_min, t_max = kw.get("t_min", 0.1), kw.get("t_max", 3.0)
    ladder = kw.get("ladder")
    if ladder is None:
        ladder = _auto_ladder(n, t_min, t_max)
        info["ladder"] = ladder
    temps = pt_mod.geometric_ladder(t_min, t_max, ladder, device=dev)
    if method == "icm":
        pairs = (num_reads + 1) // 2
        states = sa_mod.random_state(gen, n, batch=(pairs, 2, ladder),
                                     device=dev)
        outs, rates, hfracs = pt_mod.sample_icm(
            problem, temps, states, gen, sweeps, swap_every=2,
            houdayer_every=kw.get("houdayer_every", 2))
        info["mean_swap_rate"] = float(rates.mean())
        info["houdayer_flip_frac"] = float(hfracs.mean())
        cold = outs[:, :, 0].reshape(2 * pairs, n)
        return _finalize(problem, cold[:num_reads], info)
    states = sa_mod.random_state(gen, n, batch=(num_reads, ladder),
                                 device=dev)
    outs, rates = pt_mod.sample(problem, temps, states, gen, sweeps)
    info["mean_swap_rate"] = float(rates.mean())
    return _finalize(problem, outs[:, 0], info)
