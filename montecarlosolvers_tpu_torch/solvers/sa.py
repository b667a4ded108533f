"""Classical simulated annealing (counterpart of montecarlosolvers_tpu/solvers/sa.py).

`anneal` runs on any LatticeProblem, routed as the JAX solver routes
lattices (solvers/sa.py:106-121): an even L takes the split-checkerboard
engine (`ops/split_kernels.py`, kernel A), any other L the full-plane
engine (`ops/plane_kernels.py`, kernel 6). A DenseProblem takes the dense
engine (`ops/dense_kernels.py`: block fields by torch.matmul, the
sequential in-block steps on csrc/dense_sa.cu), as the JAX solver routes
it (solvers/sa.py:94-101). An IsingProblem takes the
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
launch; the dense engine computes them with a matmul after each sweep.
The states are those of the same call without it.

`anneal_noisy` anneals an IsingProblem on per-step coupling tables
(sa.NoisyAnneal, sa.pyx:291-378) through the packed kernel's table
variant, one launch an anneal.

`anneal_wolff` and `anneal_sw` are the classical cluster anneals on the
cluster kernels of `ops/cluster_kernels.py` (a LatticeProblem taken
to_generic(), as the JAX solvers take it).
"""

from __future__ import annotations

import torch

from montecarlosolvers_tpu_torch import _device, _roadmap, schedules
from montecarlosolvers_tpu_torch.models.dense import DenseProblem
from montecarlosolvers_tpu_torch.models.ising import IsingProblem
from montecarlosolvers_tpu_torch.ops import cluster_kernels
from montecarlosolvers_tpu_torch.ops import dense_kernels
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

    problem: LatticeProblem (any L), IsingProblem or DenseProblem. sched:
    (steps,)
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
    if isinstance(problem, DenseProblem):
        # the JAX solver sends a DenseProblem to the dense engine whatever
        # the engine argument (solvers/sa.py:94-101)
        return dense_kernels.dense_anneal(
            problem, sched, spins, draw_seed(generator), mcsteps=mcsteps,
            collect_energy=collect_energy)
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


def anneal_noisy(problem, sched, nbr_J_sched, h_sched, spins, generator,
                 mcsteps=1):
    """Thermal anneal with time-dependent couplings (sa.NoisyAnneal,
    sa.pyx:291-378; JAX `anneal_noisy`, solvers/sa.py:142).

    problem: IsingProblem (its neighbor indices and coloring; the tables
    replace its couplings). sched: (steps,) temperatures. nbr_J_sched:
    (steps, N, maxnb) per-step couplings in the problem's slot layout;
    h_sched: (steps, N) per-step fields (numpy or tensors; the reference's
    4-D nbs array, sa.pyx:308-311, maps to these two). spins: (chains, N)
    or (N,) float32 +/-1 on the problem's device. generator:
    torch.Generator the counter-hash seed is drawn from. mcsteps: sweeps
    per step, each reading its step's row (the JAX solver repeats the
    rows: the same sweeps). Returns the annealed spins."""
    _roadmap.require_problem(problem, "sa.anneal_noisy")
    temps = schedules.expand_mcsteps(sched, mcsteps, problem.device)
    return generic_kernels.packed_noisy_scan(
        problem, temps, nbr_J_sched, h_sched, spins, draw_seed(generator),
        mcsteps=mcsteps)


def anneal_wolff(problem, sched, spins, generator, mcsteps=1,
                 local_sweeps=True):
    """Classical annealing or sampling with Wolff cluster updates (JAX
    `anneal_wolff`, solvers/sa.py:162): one cluster a chain and schedule
    step, the space-time engine at P = 1 and Gamma = inf (J_perp = 0: the
    satisfied-bond draw holds spatial bonds only, with the Metropolis field
    correction); local_sweeps=True precedes each cluster with a colored
    Metropolis sweep.

    problem: IsingProblem, or a LatticeProblem (taken to_generic(), as the
    JAX solver takes it). sched: (steps,) temperatures (a constant one
    samples at fixed T). spins: (..., N) float32 +/-1 on the problem's
    device. On the card: csrc/fk_wolff.cu, one launch an anneal, or with
    local sweeps one launch of it and one of csrc/packed_sa.cu a step
    (`ops/cluster_kernels.py`). Returns the annealed spins."""
    _roadmap.require_problem(problem, "sa.anneal_wolff")
    return cluster_kernels.classical_anneal(
        cluster_kernels.generic_form(problem), sched, spins,
        draw_seed(generator), mcsteps, "wolff", local_sweeps)


def anneal_sw(problem, sched, spins, generator, mcsteps=1,
              local_sweeps=False):
    """Classical Swendsen-Wang annealing or sampling (JAX `anneal_sw`,
    solvers/sa.py:216): every FK cluster of the problem flips on a fair
    coin each step, fields by ghost-spin bonds; local_sweeps=True
    interleaves a colored Metropolis sweep before each SW sweep. Arguments
    as for `anneal_wolff`. On the card: csrc/fk_label.cu, one launch an
    anneal, or with local sweeps one of it and one of csrc/packed_sa.cu a
    step. Returns the annealed spins."""
    _roadmap.require_problem(problem, "sa.anneal_sw")
    return cluster_kernels.classical_anneal(
        cluster_kernels.generic_form(problem), sched, spins,
        draw_seed(generator), mcsteps, "sw", local_sweeps)
