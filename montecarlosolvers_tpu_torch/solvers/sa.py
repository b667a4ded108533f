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
runs the same kernel on the card. engine="masked" on a LatticeProblem runs
the masked sweep over the lattice's checkerboard, as the JAX solver does;
on the card that is the same kernel on the checkerboard's packing
(`ops/packed.py::packed_from_lattice`). Each engine runs its CUDA kernel on a
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

A chain-sharded state (a DTensor from `parallel.shard_chains`) runs on
every solver here block by block, each rank its own chains with their
global uids, and equals the unsharded run bitwise (on a DenseProblem: in
distribution, ROADMAP.md queue 3, since a rank's block products are
library matmuls of another row count). `parallel.disorder.vmap_disorder`
runs `anneal` over a batch of coupling realizations in one launch.
"""

from __future__ import annotations

import torch

from montecarlosolvers_tpu_torch import _device, _roadmap, schedules
from montecarlosolvers_tpu_torch.models.dense import DenseProblem
from montecarlosolvers_tpu_torch.models.lattice import LatticeProblem
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


def chain_sharded(state, run):
    """run(state) on a plain tensor; on a chain-sharded DTensor (`parallel.
    shard_chains`), run(block, chain0) on this rank's block, whose uids
    count from its global first chain, the result placed as the state
    (`parallel.mesh.run_chain_sharded`). `run` takes chain0 as its second
    argument, 0 by default."""
    if _roadmap.is_sharded(state):
        from montecarlosolvers_tpu_torch.parallel import mesh

        return mesh.run_chain_sharded(state, run)
    return run(state)


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
    masked colored engine: on an IsingProblem the same spins as "auto"; on
    a LatticeProblem the masked sweep over its checkerboard (the JAX
    package's engine for vmapped disorder), on the card the packed kernel
    on the checkerboard's packing, one launch (LAUNCHES["packed_sa"]).
    Returns the annealed spins, or (spins, energies).

    spins may be a chain-sharded DTensor (`parallel.shard_chains`): each
    rank anneals its block of chains, whose hash uids count from the
    block's global first chain, and the result (and the energies, sharded
    on their chain axis) comes back as a DTensor of the same placements,
    bitwise the unsharded run's. On a DenseProblem the block's fields are
    torch.matmul products of its own row count, whose sum order the BLAS
    may choose by that count: there the sharded run equals the unsharded
    one in distribution (ROADMAP.md queue 3). Every rank must pass the
    same generator state, as the JAX package replicates its key."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be 'auto' or 'masked', got "
                         f"{engine!r}")
    _roadmap.require_problem(problem)
    if isinstance(problem, DenseProblem):
        # the JAX solver sends a DenseProblem to the dense engine whatever
        # the engine argument (solvers/sa.py:94-101)
        run = dense_kernels.dense_anneal
    elif engine == "masked":
        run = generic_kernels.anneal_masked
    elif not isinstance(problem, LatticeProblem):
        run = generic_kernels.anneal_packed
    else:
        run = (split_kernels.anneal_lattice_split
               if split_ops.supports_split(problem)
               else plane_kernels.anneal_lattice)
    seed = draw_seed(generator)
    return chain_sharded(spins, lambda s, chain0=0: run(
        problem, sched, s, seed, mcsteps=mcsteps,
        collect_energy=collect_energy, chain0=chain0))


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
    rows: the same sweeps). Returns the annealed spins. spins may
    be a chain-sharded DTensor, as for `anneal`; the tables are every
    chain's, replicated."""
    _roadmap.require_problem(problem, "sa.anneal_noisy")
    temps = schedules.expand_mcsteps(sched, mcsteps, problem.device)
    seed = draw_seed(generator)
    return chain_sharded(spins, lambda s, chain0=0: (
        generic_kernels.packed_noisy_scan(problem, temps, nbr_J_sched,
                                          h_sched, s, seed, mcsteps=mcsteps,
                                          chain0=chain0)))


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
    device, or a chain-sharded DTensor of (chains, N), as for `anneal`.
    On the card: csrc/fk_wolff.cu, one launch an anneal, or with local
    sweeps one launch of it and one of csrc/packed_sa.cu a step
    (`ops/cluster_kernels.py`). Returns the annealed spins."""
    return _cluster(problem, sched, spins, generator, mcsteps, "wolff",
                    local_sweeps, "sa.anneal_wolff")


def anneal_sw(problem, sched, spins, generator, mcsteps=1,
              local_sweeps=False):
    """Classical Swendsen-Wang annealing or sampling (JAX `anneal_sw`,
    solvers/sa.py:216): every FK cluster of the problem flips on a fair
    coin each step, fields by ghost-spin bonds; local_sweeps=True
    interleaves a colored Metropolis sweep before each SW sweep. Arguments
    as for `anneal_wolff`. On the card: csrc/fk_label.cu, one launch an
    anneal, or with local sweeps one of it and one of csrc/packed_sa.cu a
    step. Returns the annealed spins."""
    return _cluster(problem, sched, spins, generator, mcsteps, "sw",
                    local_sweeps, "sa.anneal_sw")


def _cluster(problem, sched, spins, generator, mcsteps, kind, local_sweeps,
             what):
    """The classical cluster anneal `kind` (`cluster_kernels.
    classical_anneal`), chain-sharded as `anneal` is."""
    _roadmap.require_problem(problem, what)
    generic = cluster_kernels.generic_form(problem)
    seed = draw_seed(generator)
    return chain_sharded(spins, lambda s, chain0=0: (
        cluster_kernels.classical_anneal(generic, sched, s, seed, mcsteps,
                                         kind, local_sweeps, chain0)))
