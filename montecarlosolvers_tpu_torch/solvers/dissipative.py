"""The open-system annealing protocol of examples/dissipative_qa.py:51-67
(dissipative PIQMC: an Ohmic bath on each spin's imaginary-time line),
through the solvers' public entry points. The JAX package has no `solve`
method for it; `chip_smoke.py` and `profiling.py` drive it from here.
"""

from __future__ import annotations

import numpy as np
import torch

from montecarlosolvers_tpu_torch import schedules
from montecarlosolvers_tpu_torch.solvers import qmc, sa


def dissipative_qa(problem, reads, sweeps, slices, alpha, seed,
                   bath_update="sequential"):
    """sa.random_state -> sa.anneal(pre-anneal 3 -> 1, mcsteps=5) ->
    qmc.replicate -> qmc.anneal(Gamma: 3 -> 1e-8 over `sweeps`, B = 1,
    T = 1/P, lookuptable=bath_lookuptable(P, alpha), global moves,
    bath_update) on the problem's device, any problem qmc.anneal takes,
    with the best slice of each chain read out as solve("piqmc") reads it.
    bath_update: "sequential" (the JAX example's) or "colored". Returns
    (states (reads, N), energies) as numpy arrays."""
    dev = problem.device
    gen = torch.Generator().manual_seed(seed)
    s = sa.random_state(gen, problem.nspins, batch=(reads,), device=dev)
    s = sa.anneal(problem, schedules.pre_anneal_schedule(3.0, 1.0,
                                                         device=dev),
                  s, gen, mcsteps=5)
    a = schedules.transverse_field(3.0, 1e-8, sweeps, device=dev)
    confs = qmc.anneal(problem, a, torch.ones_like(a), 1.0 / slices,
                       qmc.replicate(s, slices), gen, global_moves=True,
                       lookuptable=schedules.bath_lookuptable(
                           slices, alpha, device=dev),
                       bath_update=bath_update)
    es = problem.energy(confs).cpu().numpy()  # (reads, P)
    best = es.argmin(axis=-1)
    rows = np.arange(reads)
    return confs.cpu().numpy()[rows, best], es[rows, best]
