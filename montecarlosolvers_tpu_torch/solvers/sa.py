"""Classical simulated annealing (counterpart of montecarlosolvers_tpu/solvers/sa.py).

`anneal` runs on any LatticeProblem, routed as the JAX solver routes
lattices (solvers/sa.py:106-121): an even L takes the split-checkerboard
engine (`ops/split_kernels.py`, kernel A), any other L the full-plane
engine (`ops/plane_kernels.py`, kernel 6). An IsingProblem takes the
class-major packed engine (`ops/generic_kernels.py`, csrc/packed_sa.cu),
as the JAX solver sends concrete graphs to `ops/packed.py`; engine="masked"
there runs the masked engine, which gives the same spins bitwise and so
runs the same kernel on the card. Each engine runs its CUDA kernel on a
CUDA device and its plain version on the CPU. Unlike the JAX solver, which
draws from `jax.random`,
the port draws every uniform from the counter hash of the Pallas kernels;
the solver takes the hash's integer seed from its `torch.Generator`.

`collect_energy=True` returns the energies after each sweep beside the
state, as the JAX solver does. On a CUDA device it takes each engine's
per-phase kernels, which keep the state in device memory, and the energy
kernel (csrc/energy.cuh) launched after every sweep from the same loop;
the cluster kernels run the whole schedule in one launch and read out no
energies. The generic kernel reduces the energies itself, in its one
launch. The states are those of the same call without it.
"""

from __future__ import annotations

import torch

from montecarlosolvers_tpu_torch import _device, _roadmap
from montecarlosolvers_tpu_torch.models.ising import IsingProblem
from montecarlosolvers_tpu_torch.ops import generic_kernels
from montecarlosolvers_tpu_torch.ops import plane_kernels
from montecarlosolvers_tpu_torch.ops import split as split_ops
from montecarlosolvers_tpu_torch.ops import split_kernels


def draw_seed(generator):
    """The next counter-hash seed, a non-negative int32, from `generator`."""
    return int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                             device=generator.device).item())


def random_state(generator, nspins, batch=(), device=None):
    """Random +/-1 float32 configuration(s) of shape batch + (nspins,)
    (examples/santoro80.py:259), drawn on the generator's device and placed
    on `device` (None: the CUDA device)."""
    shape = tuple(batch) + (nspins,)
    bits = torch.randint(0, 2, shape, generator=generator,
                         device=generator.device)
    return (bits.to(torch.float32) * 2.0 - 1.0).to(_device.resolve(device))


ENGINES = ("auto", "masked")


def anneal(problem, sched, spins, generator, mcsteps=1,
           collect_energy=False, engine="auto"):
    """Thermal anneal over the temperature schedule `sched`.

    problem: LatticeProblem (any L) or IsingProblem. sched: (steps,)
    temperatures (e.g. schedules.linear(3.0, 0.0, tau)). spins: (chains, N)
    or (N,) float32 +/-1 on the problem's device. generator:
    torch.Generator the counter-hash seed is drawn from. mcsteps: sweeps
    per schedule step (sa.pyx:68). collect_energy: also return the
    classical energy after each sweep, float32 of shape (steps * mcsteps,)
    + batch on the problem's device. engine: "auto", or "masked" for the
    masked colored engine on an IsingProblem (the same spins as "auto";
    on a LatticeProblem the JAX package's masked engine serves vmapped
    disorder, which waits for the parallel layer). Returns the annealed
    spins, or (spins, energies)."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be 'auto' or 'masked', got "
                         f"{engine!r}")
    _roadmap.require_problem(problem)
    if isinstance(problem, IsingProblem):
        run = (generic_kernels.anneal_masked if engine == "masked"
               else generic_kernels.anneal_packed)
        return run(problem, sched, spins, draw_seed(generator),
                   mcsteps=mcsteps, collect_energy=collect_energy)
    if engine == "masked":
        raise _roadmap.not_ported("sa.anneal(engine='masked') on a "
                                  "LatticeProblem", _roadmap.PARALLEL)
    engine = (split_kernels.anneal_lattice_split
              if split_ops.supports_split(problem)
              else plane_kernels.anneal_lattice)
    return engine(problem, sched, spins, draw_seed(generator),
                  mcsteps=mcsteps, collect_energy=collect_energy)


def anneal_noisy(*args, **kwargs):
    """Anneal with time-dependent couplings: not ported yet."""
    raise _roadmap.not_ported("sa.anneal_noisy", _roadmap.GENERIC_GRAPHS)


def anneal_wolff(*args, **kwargs):
    """Classical Wolff cluster anneal: not ported yet."""
    raise _roadmap.not_ported("sa.anneal_wolff", _roadmap.CLUSTER)


def anneal_sw(*args, **kwargs):
    """Classical Swendsen-Wang anneal: not ported yet."""
    raise _roadmap.not_ported("sa.anneal_sw", _roadmap.CLUSTER)
