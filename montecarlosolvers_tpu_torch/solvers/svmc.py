"""Spin-vector Monte Carlo annealing (counterpart of
montecarlosolvers_tpu/solvers/svmc.py).

`anneal` runs on any LatticeProblem, routed as `sa.anneal` routes: an even
L takes the split-checkerboard engine (`ops/split_kernels.py`, kernel 4),
any other L the full-plane engine (`ops/plane_kernels.py`, kernel 7); each
runs its CUDA kernel on a CUDA device and its plain version on the CPU. An
IsingProblem takes the packed engine
(`ops/generic_kernels.py::anneal_packed_svmc`, csrc/packed_svmc.cu), as
the JAX solver sends concrete graphs to `ops/packed.py::packed_svmc_scan`
(solvers/svmc.py:107). `anneal_noisy` anneals an IsingProblem on
per-step coupling tables (NoisySVMC / NoisySVMCTF, svmc.pyx:236-448)
through the packed kernel's table variant, one launch an anneal.

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

A chain-sharded state (a DTensor from `parallel.shard_chains`) runs on
`anneal` and `anneal_noisy` block by block, each rank its own chains with
their global uids (the kernels' `chain0`), and equals the unsharded run
bitwise; the noisy anneal's tables are every chain's, replicated.
"""

from __future__ import annotations

import torch

from montecarlosolvers_tpu_torch import _device, _roadmap, schedules
from montecarlosolvers_tpu_torch.models.ising import IsingProblem
from montecarlosolvers_tpu_torch.ops import generic_kernels
from montecarlosolvers_tpu_torch.ops import plane_kernels
from montecarlosolvers_tpu_torch.ops import split as split_ops
from montecarlosolvers_tpu_torch.ops import split_kernels
from montecarlosolvers_tpu_torch.ops import svmc_ops
from montecarlosolvers_tpu_torch.solvers.sa import chain_sharded, draw_seed


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
    annealed angles, or (theta, energies); project with `z_projection`.
    theta may be a chain-sharded DTensor (module docstring); the angles
    (and the energies, sharded on their chain axis) come back so sharded."""
    _roadmap.require_problem(problem, "svmc.anneal")
    if isinstance(problem, IsingProblem):
        engine = generic_kernels.anneal_packed_svmc
    elif split_ops.supports_split(problem):
        engine = split_kernels.anneal_lattice_svmc_split
    else:
        engine = plane_kernels.anneal_lattice_svmc
    seed = draw_seed(generator)
    return chain_sharded(theta, lambda th, chain0=0: engine(
        problem, a_sched, b_sched, temp, th, seed, mcsteps=mcsteps, tf=tf,
        collect_energy=collect_energy, chain0=chain0))


def anneal_noisy(problem, a_sched, b_sched, temp, nbr_J_sched, h_sched,
                 theta, generator, mcsteps=1, tf=False):
    """SVMC anneal with per-step couplings (NoisySVMC / NoisySVMCTF,
    svmc.pyx:236-448; JAX `anneal_noisy`, solvers/svmc.py:126): as
    `anneal` on an IsingProblem, with nbr_J_sched (steps, N, maxnb) and
    h_sched (steps, N) replacing its couplings step by step (see
    `sa.anneal_noisy`). Returns the annealed angles. theta may be a
    chain-sharded DTensor (module docstring)."""
    _roadmap.require_problem(problem, "svmc.anneal_noisy")
    a_s, b_s = (schedules.expand_mcsteps(x, mcsteps, problem.device)
                for x in (a_sched, b_sched))
    seed = draw_seed(generator)
    return chain_sharded(theta, lambda th, chain0=0: (
        generic_kernels.packed_noisy_svmc_scan(
            problem, a_s, b_s, temp, nbr_J_sched, h_sched, th, seed, tf=tf,
            mcsteps=mcsteps, chain0=chain0)))


def random_state(generator, nspins, batch=(), device=None):
    """Random float32 angles uniform in [0, pi] of shape batch + (nspins,),
    drawn on the generator's device and placed on `device` (None: the CUDA
    device)."""
    shape = tuple(batch) + (nspins,)
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (u * svmc_ops.PI).to(_device.resolve(device))


z_projection = svmc_ops.z_projection
