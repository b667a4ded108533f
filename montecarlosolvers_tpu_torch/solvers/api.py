"""High-level one-call solving API (counterpart of
montecarlosolvers_tpu/solvers/api.py).

`solve` runs on the problem's device and returns a `SampleSet` of numpy
arrays, samples sorted by energy. The port covers the methods "sa",
"piqmc" (at any P) and "svmc" on any LatticeProblem (any L, open or
periodic) and on any IsingProblem (the generic kernels of
`ops/generic_kernels.py`), and "sa" on a DenseProblem (the dense engine,
`ops/dense_kernels.py`); the JAX package's other methods raise
NotImplementedError naming their ROADMAP.md item, and a problem of the JAX
package is refused (`convert.py` carries one across).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from montecarlosolvers_tpu_torch import _roadmap
from montecarlosolvers_tpu_torch import schedules
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
    "piqmc": {"slices", "pt", "field_start", "pre_anneal"},
    "svmc": {"field_start", "temp"},
}

# the JAX package's other methods, and where the port queues them
_NOT_PORTED = {
    "sa_wolff": _roadmap.CLUSTER,
    "sa_sw": _roadmap.CLUSTER,
    "piqmc_wolff": _roadmap.CLUSTER,
    "piqmc_sw": _roadmap.CLUSTER,
    "piqmc_sw_full": _roadmap.CLUSTER,
    "pt": _roadmap.SAMPLERS,
    "icm": _roadmap.SAMPLERS,
    "pa": _roadmap.SAMPLERS,
    "paq": _roadmap.SAMPLERS,
}


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
      "svmc"  — spin-vector MC with TF proposals; kw: field_start=3.0,
                temp=0.05. A: field_start -> 1e-8 over `sweeps`, B = 1;
                each read returns the z-projection of its angles.

    `seed` seeds the torch.Generator that draws the initial states and the
    counter-hash seeds.
    """
    if method in _NOT_PORTED:
        raise _roadmap.not_ported(f"solve(method={method!r})",
                                  _NOT_PORTED[method])
    if method not in _METHOD_KW:
        raise ValueError(f"unknown method: {method}")
    unknown = set(kw) - _METHOD_KW[method]
    if unknown:
        raise TypeError(
            f"solve(method={method!r}) got unexpected options "
            f"{sorted(unknown)}; accepted: {sorted(_METHOD_KW[method])}"
        )
    _roadmap.require_problem(
        problem, None if method == "sa" else f"solve(method={method!r})")

    dev = problem.device
    gen = torch.Generator().manual_seed(seed)
    n = problem.nspins
    info = dict(method=method, num_reads=num_reads, sweeps=sweeps, seed=seed)

    if method == "sa":
        sched = schedules.linear(kw.get("t_start", 3.0), kw.get("t_end", 0.0),
                                 sweeps, device=dev)
        s0 = sa_mod.random_state(gen, n, batch=(num_reads,), device=dev)
        out = sa_mod.anneal(problem, sched, s0, gen)
        return _finalize(problem, out, info)

    if method == "svmc":
        a = schedules.linear(kw.get("field_start", 3.0), 1e-8, sweeps,
                             device=dev)
        th = svmc_mod.random_state(gen, n, batch=(num_reads,), device=dev)
        out = svmc_mod.anneal(problem, a, torch.ones_like(a),
                              kw.get("temp", 0.05), th, gen, tf=True)
        return _finalize(problem, svmc_mod.z_projection(out), info)

    # method == "piqmc"
    slices = kw.get("slices", 20)
    pt = kw.get("pt", 1.0)
    s0 = sa_mod.random_state(gen, n, batch=(num_reads,), device=dev)
    if kw.get("pre_anneal", True):
        pre = schedules.pre_anneal_schedule(3.0, pt, device=dev)
        s0 = sa_mod.anneal(problem, pre, s0, gen, mcsteps=100)
    confs = qmc_mod.replicate(s0, slices)
    a = schedules.transverse_field(kw.get("field_start", 3.0), 1e-8, sweeps,
                                   device=dev)
    confs = qmc_mod.anneal(problem, a, torch.ones_like(a), pt / slices, confs,
                           gen, global_moves=True)
    # best slice per read, chosen on the host as the JAX solve chooses it
    es = problem.energy(confs).cpu().numpy()  # (reads, P)
    best_k = es.argmin(axis=-1)
    rows = np.arange(num_reads)
    states = confs[torch.as_tensor(rows, device=dev),
                   torch.as_tensor(best_k, device=dev)]
    return _finalize(problem, states, info, energies=es[rows, best_k])
