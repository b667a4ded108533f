"""Path-integral quantum Monte Carlo annealing (counterpart of
montecarlosolvers_tpu/solvers/qmc.py).

State layout is slices-major, confs (..., P, N), as in the JAX package.
`anneal` runs on an even-L LatticeProblem at even P through the
split-checkerboard engine (`ops/split_kernels.py`): kernel B on a CUDA
device, its plain version on the CPU, both on the counter hash.
"""

from __future__ import annotations

import torch

from montecarlosolvers_tpu_torch import _roadmap
from montecarlosolvers_tpu_torch.ops import split_kernels
from montecarlosolvers_tpu_torch.solvers.sa import draw_seed


def replicate(spins, slices):
    """Tile a classical state into P Trotter replicas: (..., N) -> (..., P, N)
    (examples/santoro80.py:286, transposed to slices-major)."""
    shape = spins.shape[:-1] + (slices, spins.shape[-1])
    return spins[..., None, :].expand(shape).contiguous()


def best_slice_energy(problem, confs):
    """min over slices of the classical energy — the benchmark readout
    (examples/santoro80.py:290-296)."""
    return torch.min(problem.energy(confs), dim=-1).values


def anneal(problem, a_sched, b_sched, temp, confs, generator, mcsteps=1,
           global_moves=False, lookuptable=None):
    """PIQMC anneal over the transverse-field schedule.

    problem: LatticeProblem with even L. a_sched: (steps,) Gamma (end > 0,
    e.g. 1e-8, to keep J_perp finite). b_sched: (steps,) longitudinal scale
    B. temp: ambient T; T_eff = P*T (qmc.pyx:85). confs: (chains, P, N) or
    (P, N) float32 +/-1 with even P, on the problem's device. generator:
    torch.Generator the counter-hash seed is drawn from. global_moves:
    whole-line flips after each sweep (QuantumAnnealGlobal,
    qmc.pyx:405-438). Returns the annealed configurations."""
    if lookuptable is not None:
        raise _roadmap.not_ported("qmc.anneal(lookuptable=...)",
                                  _roadmap.BATH)
    return split_kernels.anneal_lattice_qmc_split(
        problem, a_sched, b_sched, temp, confs, draw_seed(generator),
        mcsteps=mcsteps, global_moves=global_moves,
    )


def anneal_wolff(*args, **kwargs):
    """PIQMC with Wolff cluster updates: not ported yet."""
    raise _roadmap.not_ported("qmc.anneal_wolff", _roadmap.CLUSTER)


def anneal_sw(*args, **kwargs):
    """PIQMC with space-time Swendsen-Wang sweeps: not ported yet."""
    raise _roadmap.not_ported("qmc.anneal_sw", _roadmap.CLUSTER)


def anneal_sw_bath(*args, **kwargs):
    """Dissipative PIQMC with bath-bond clusters: not ported yet."""
    raise _roadmap.not_ported("qmc.anneal_sw_bath", _roadmap.CLUSTER)
