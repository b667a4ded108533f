"""Spin-vector Monte Carlo annealing (counterpart of
montecarlosolvers_tpu/solvers/svmc.py).

`anneal` runs on any LatticeProblem, routed as `sa.anneal` routes: an even
L takes the split-checkerboard engine (`ops/split_kernels.py`, kernel 4),
any other L the full-plane engine (`ops/plane_kernels.py`, kernel 7); each
runs its CUDA kernel on a CUDA device and its plain version on the CPU. An
IsingProblem takes the packed engine
(`ops/generic_kernels.py::anneal_packed_svmc`, csrc/packed_svmc.cu), as
the JAX solver sends concrete graphs to `ops/packed.py::packed_svmc_scan`
(solvers/svmc.py:107).

The JAX solver draws its uniforms from `jax.random`, and for an odd L its
masked engine draws one (proposal, acceptance) pair per site and sweep,
shared by both color phases (ops/svmc_ops.py:58-63). The port draws every
uniform from the counter hash of the Pallas kernels, taking the hash's
integer seed from its `torch.Generator`: kernel 4's stream on even L,
kernel 7's per-color stream on odd L. `collect_energy=True` returns the
classical energy of the z-projection after each sweep beside the angles,
as `sa.anneal` does (there: how the card computes it). The JAX solver's
`segment=` is not ported: it only bounds a TPU dispatch (ROADMAP.md, "Not
to port").
"""

from __future__ import annotations

import torch

from montecarlosolvers_tpu_torch import _device, _roadmap
from montecarlosolvers_tpu_torch.models.ising import IsingProblem
from montecarlosolvers_tpu_torch.ops import generic_kernels
from montecarlosolvers_tpu_torch.ops import plane_kernels
from montecarlosolvers_tpu_torch.ops import split as split_ops
from montecarlosolvers_tpu_torch.ops import split_kernels
from montecarlosolvers_tpu_torch.ops import svmc_ops
from montecarlosolvers_tpu_torch.solvers.sa import draw_seed


def anneal(problem, a_sched, b_sched, temp, theta, generator, mcsteps=1,
           tf=False, collect_energy=False):
    """SVMC anneal over the (A, B) schedules at fixed temperature.

    problem: LatticeProblem (any L) or IsingProblem. a_sched / b_sched:
    (steps,) transverse scale A and longitudinal scale B. theta: (chains,
    N) or (N,) float32 rotor angles in [0, pi] on the problem's device.
    generator: torch.Generator the counter-hash seed is drawn from. tf: TF
    proposals (svmc.pyx:198-207). mcsteps: sweeps per schedule step.
    collect_energy: also return the classical energy of `z_projection`
    (sign(cos theta), +1 at cos theta = 0) after each sweep, float32 of
    shape (steps * mcsteps,) + batch on the problem's device. Returns the
    annealed angles, or (theta, energies); project with `z_projection`."""
    _roadmap.require_problem(problem)
    if isinstance(problem, IsingProblem):
        return generic_kernels.anneal_packed_svmc(
            problem, a_sched, b_sched, temp, theta, draw_seed(generator),
            mcsteps=mcsteps, tf=tf, collect_energy=collect_energy)
    engine = (split_kernels.anneal_lattice_svmc_split
              if split_ops.supports_split(problem)
              else plane_kernels.anneal_lattice_svmc)
    return engine(problem, a_sched, b_sched, temp, theta,
                  draw_seed(generator), mcsteps=mcsteps, tf=tf,
                  collect_energy=collect_energy)


def anneal_noisy(*args, **kwargs):
    """SVMC anneal with time-dependent couplings: not ported yet."""
    raise _roadmap.not_ported("svmc.anneal_noisy", _roadmap.GENERIC_GRAPHS)


def random_state(generator, nspins, batch=(), device=None):
    """Random float32 angles uniform in [0, pi] of shape batch + (nspins,),
    drawn on the generator's device and placed on `device` (None: the CUDA
    device)."""
    shape = tuple(batch) + (nspins,)
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (u * svmc_ops.PI).to(_device.resolve(device))


z_projection = svmc_ops.z_projection
