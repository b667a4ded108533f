"""Classical simulated annealing (counterpart of montecarlosolvers_tpu/solvers/sa.py).

`anneal` runs on an even-L LatticeProblem through the split-checkerboard
engine (`ops/split_kernels.py`): kernel A on a CUDA device, its plain
version on the CPU. Unlike the JAX solver, which draws from `jax.random`,
the port draws every uniform from the counter hash of the Pallas kernels;
the solver takes the hash's integer seed from its `torch.Generator`.
"""

from __future__ import annotations

import torch

from montecarlosolvers_tpu_torch import _roadmap
from montecarlosolvers_tpu_torch.ops import split_kernels


def draw_seed(generator):
    """The next counter-hash seed, a non-negative int32, from `generator`."""
    return int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                             device=generator.device).item())


def random_state(generator, nspins, batch=(), device=None):
    """Random +/-1 float32 configuration(s) of shape batch + (nspins,)
    (examples/santoro80.py:259), drawn on the generator's device and placed
    on `device`."""
    shape = tuple(batch) + (nspins,)
    bits = torch.randint(0, 2, shape, generator=generator,
                         device=generator.device)
    return (bits.to(torch.float32) * 2.0 - 1.0).to(device)


def anneal(problem, sched, spins, generator, mcsteps=1):
    """Thermal anneal over the temperature schedule `sched`.

    problem: LatticeProblem with even L. sched: (steps,) temperatures
    (e.g. schedules.linear(3.0, 0.0, tau)). spins: (chains, N) or (N,)
    float32 +/-1 on the problem's device. generator: torch.Generator the
    counter-hash seed is drawn from. mcsteps: sweeps per schedule step
    (sa.pyx:68). Returns the annealed spins."""
    return split_kernels.anneal_lattice_split(
        problem, sched, spins, draw_seed(generator), mcsteps=mcsteps
    )


def anneal_noisy(*args, **kwargs):
    """Anneal with time-dependent couplings: not ported yet."""
    raise _roadmap.not_ported("sa.anneal_noisy", _roadmap.GENERIC_GRAPHS)


def anneal_wolff(*args, **kwargs):
    """Classical Wolff cluster anneal: not ported yet."""
    raise _roadmap.not_ported("sa.anneal_wolff", _roadmap.CLUSTER)


def anneal_sw(*args, **kwargs):
    """Classical Swendsen-Wang anneal: not ported yet."""
    raise _roadmap.not_ported("sa.anneal_sw", _roadmap.CLUSTER)
