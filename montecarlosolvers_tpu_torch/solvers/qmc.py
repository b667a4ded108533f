"""Path-integral quantum Monte Carlo annealing (counterpart of
montecarlosolvers_tpu/solvers/qmc.py).

State layout is slices-major, confs (..., P, N), as in the JAX package.
`anneal` runs on any LatticeProblem at any P, routed as the JAX solver
routes (solvers/qmc.py:132): even L and even P take the split-checkerboard
engine (`ops/split_kernels.py`, kernel B), everything else the full-plane
engine (`ops/plane_kernels.py`, kernel 3); each runs its CUDA kernel on a
CUDA device and its plain version on the CPU, both on the counter hash.

Where the JAX solver sends odd P to `ops/piqmc.py::local_sweep` and
`global_line_moves` on `jax.random`, the port sends it to the fused form of
that sweep, the Pallas kernel `pallas_qmc._qmc_kernel`, whose counter hash
lets the port be held bitwise against the Pallas interpreter.

With a bath `lookuptable` (dissipative PIQMC, qmc.pyx:149-278 and
444-609), the routes follow the JAX solver's (solvers/qmc.py:125-182):
- an even-L lattice with the sequential sweep takes the split bath engine
  (`split_kernels.anneal_lattice_qmc_bath_split`, kernel 5) at every P >= 2.
  The JAX solver sends odd P there to the masked
  `piqmc.dissipative_local_sweep` on `jax.random`; the port takes the
  Pallas kernel's own form of the same slice-sequential sweep
  (`pallas_split._qmc_bath_split_kernel`), which accepts any P;
- an even-L lattice at even P with bath_update="colored" takes kernel 5's
  colored template on the quarters (JAX `split.qmc_bath_split_colored_sweep`
  and `qmc_split_global`);
- everything else, an IsingProblem, an odd-L lattice, or the colored sweep
  at odd P, takes the masked sweeps `piqmc.dissipative_local_sweep` /
  `dissipative_colored_sweep` with `global_line_moves` on the packed layout
  (`ops/generic_kernels.py::anneal_generic_qmc_bath`,
  csrc/generic_qmc_bath.cu): an IsingProblem on its greedy colors, a
  lattice on its own checkerboard (`packed.packed_from_lattice`), which
  the masked sweep runs on and which on an odd torus is not a proper
  coloring (ROADMAP.md queue 3).

An IsingProblem at any P without a bath takes the generic space-time
engine (`ops/generic_kernels.py::anneal_generic_qmc`, csrc/generic_qmc.cu),
the JAX solver's masked `local_sweep` + `global_line_moves` (solvers/qmc.py:
152-180) on the packed layout.

`collect_energy=True` returns the best-slice energy after each sweep beside
the state, on every route, as `sa.anneal` does (there: how the card
computes it).

The cluster solvers `anneal_wolff`, `anneal_sw` and `anneal_sw_bath` run
an IsingProblem (a LatticeProblem taken to_generic()) on the cluster
kernels of `ops/cluster_kernels.py`.
"""

from __future__ import annotations

import math

import torch

from montecarlosolvers_tpu_torch import _roadmap
from montecarlosolvers_tpu_torch.models.ising import IsingProblem
from montecarlosolvers_tpu_torch.ops import cluster_kernels
from montecarlosolvers_tpu_torch.ops import generic_kernels
from montecarlosolvers_tpu_torch.ops import plane_kernels
from montecarlosolvers_tpu_torch.ops import split as split_ops
from montecarlosolvers_tpu_torch.ops import split_kernels
from montecarlosolvers_tpu_torch.solvers.sa import draw_seed

BATH_UPDATES = ("sequential", "colored")


def replicate(spins, slices):
    """Tile a classical state into P Trotter replicas: (..., N) -> (..., P, N)
    (examples/santoro80.py:286, transposed to slices-major)."""
    shape = spins.shape[:-1] + (slices, spins.shape[-1])
    return spins[..., None, :].expand(shape).contiguous()


def slice_energies(problem, confs):
    """Classical Ising energy of every Trotter slice: (..., P, N) ->
    (..., P) (JAX `slice_energies`, solvers/qmc.py:48)."""
    return problem.energy(confs)


def best_slice_energy(problem, confs):
    """min over slices of the classical energy — the benchmark readout
    (examples/santoro80.py:290-296)."""
    return torch.min(problem.energy(confs), dim=-1).values


def anneal(problem, a_sched, b_sched, temp, confs, generator, mcsteps=1,
           global_moves=False, lookuptable=None, bath_update="sequential",
           collect_energy=False):
    """PIQMC anneal over the transverse-field schedule.

    problem: LatticeProblem (any L) or IsingProblem. a_sched: (steps,)
    Gamma (end > 0, e.g. 1e-8, to keep J_perp finite). b_sched: (steps,)
    longitudinal scale B. temp: ambient T; T_eff = P*T (qmc.pyx:85). confs:
    (chains, P, N) or (P, N) float32 +/-1, any P, on the problem's device.
    generator: torch.Generator the counter-hash seed is drawn from.
    global_moves: whole-line flips after each sweep (QuantumAnnealGlobal,
    qmc.pyx:405-438). lookuptable: optional (P-1,) system-bath couplings
    (`schedules.bath_lookuptable`), numpy or a tensor, taken as float32 on
    the problem's device: switches to the dissipative sweep
    (DissipativeQuantumAnneal[Global]) at any P >= 2, on every problem.
    bath_update: "sequential", the reference's exact slice-sequential
    sweep, or "colored", the approximate space-time colored sweep with a
    snapshot bath (JAX `piqmc.dissipative_colored_sweep`). collect_energy:
    also return the best-slice energy (`best_slice_energy`) after each
    sweep and its line moves, float32 of shape (steps * mcsteps,) + batch
    on the problem's device. Returns the annealed configurations, or
    (confs, energies)."""
    if bath_update not in BATH_UPDATES:
        raise ValueError(f"bath_update must be 'sequential' or 'colored', "
                         f"got {bath_update!r}")
    _roadmap.require_problem(problem, "qmc.anneal")
    slices = confs.shape[-2]
    if lookuptable is not None:
        colored = bath_update == "colored"
        kw = dict(mcsteps=mcsteps, global_moves=global_moves,
                  collect_energy=collect_energy)
        if split_ops.supports_split(problem, slices if colored else None):
            return split_kernels.anneal_lattice_qmc_bath_split(
                problem, a_sched, b_sched, temp, lookuptable, confs,
                draw_seed(generator), colored=colored, **kw)
        return generic_kernels.anneal_generic_qmc_bath(
            problem, a_sched, b_sched, temp, lookuptable, confs,
            draw_seed(generator), colored=colored, **kw)
    if isinstance(problem, IsingProblem):
        return generic_kernels.anneal_generic_qmc(
            problem, a_sched, b_sched, temp, confs, draw_seed(generator),
            mcsteps=mcsteps, global_moves=global_moves,
            collect_energy=collect_energy)
    engine = (split_kernels.anneal_lattice_qmc_split
              if split_ops.supports_split(problem, slices)
              else plane_kernels.anneal_lattice_qmc)
    return engine(problem, a_sched, b_sched, temp, confs,
                  draw_seed(generator), mcsteps=mcsteps,
                  global_moves=global_moves, collect_energy=collect_energy)


def _bath_guard(problem, confs, what):
    """The JAX solvers' memory guard (solvers/qmc.py:200-214): their bath
    bond draw holds about three (chains, N, P, P) float32 tensors, and more
    than 8 GiB of them is refused. The kernels here draw a bath bond only
    when they reach it, but the contract is the reference's."""
    chains = math.prod(confs.shape[:-2])
    slices = confs.shape[-2]
    est = 3 * 4 * chains * problem.nspins * slices * slices
    if est > 8 << 30:
        raise ValueError(
            f"{what} bath draw needs ~{est / 2**30:.1f} GiB of (chains="
            f"{chains}, N={problem.nspins}, P={slices}) imaginary-time bond "
            "tensors: reduce the chain batch (e.g. <= 8 chains at N=6400, "
            "P=40) or split the chains across calls")


def anneal_wolff(problem, a_sched, b_sched, temp, confs, generator,
                 mcsteps=1, rule="local", lookuptable=None):
    """PIQMC anneal with Wolff cluster updates, one cluster a chain and
    step (JAX `anneal_wolff`, solvers/qmc.py:185; QuantumAnnealWCL with
    rule="local", QuantumAnnealWC with rule="full", and with a
    `lookuptable` the bath bonds of DissaptiveQuantumAnnealWCL).

    problem: IsingProblem, or a LatticeProblem (taken to_generic()).
    confs: (..., P, N) float32 +/-1 on the problem's device; the other
    arguments as for `anneal`. On the card csrc/fk_wolff.cu runs the
    whole schedule in one launch. Returns the annealed configurations."""
    _roadmap.require_problem(problem, "qmc.anneal_wolff")
    problem = cluster_kernels.generic_form(problem)
    if lookuptable is not None:
        _bath_guard(problem, confs, "dissipative Wolff")
    return cluster_kernels.qmc_cluster_anneal(
        problem, a_sched, b_sched, temp, confs, draw_seed(generator),
        mcsteps, "wolff", rule, lookuptable)


def anneal_sw(problem, a_sched, b_sched, temp, confs, generator, mcsteps=1,
              lookuptable=None, local_sweeps=False):
    """PIQMC anneal with full space-time Swendsen-Wang sweeps (JAX
    `anneal_sw`, solvers/qmc.py:247): every FK cluster of the (P, N)
    system (spatial, Trotter and optional bath bonds) flips on a fair coin
    each step; local_sweeps=True interleaves a space-time local sweep
    before each. Arguments as for `anneal_wolff`. On the card
    csrc/fk_label.cu, one launch an anneal, or with local sweeps one of it
    and one of csrc/generic_qmc.cu a step. Returns the annealed
    configurations."""
    _roadmap.require_problem(problem, "qmc.anneal_sw")
    problem = cluster_kernels.generic_form(problem)
    if lookuptable is not None:
        _bath_guard(problem, confs, "space-time SW")
    return cluster_kernels.qmc_cluster_anneal(
        problem, a_sched, b_sched, temp, confs, draw_seed(generator),
        mcsteps, "sw", lookuptable=lookuptable, local_sweeps=local_sweeps)


def anneal_sw_bath(problem, a_sched, b_sched, temp, lookuptable, confs,
                   generator, mcsteps=1, per_slice_seeds=True,
                   local_sweeps=True):
    """Dissipative anneal with Swendsen-Wang-style bath-bond clusters along
    imaginary time (JAX `anneal_sw_bath`, solvers/qmc.py:313; the WC2 / WC3
    family, qmc.pyx:1231-1621).

    per_slice_seeds=True (WC3): every line of a color class decomposes into
    clusters over its bath and Trotter bonds, each accepted on its own
    field energy (`ops/cluster.py::sw_full_phase`). per_slice_seeds=False
    (WC2): one random seed slice a line, its bath cluster accepted on the
    non-bath set-flip energy (`bath_cluster_phase`), after a dissipative
    local sweep when `local_sweeps`. lookuptable: the (P-1,) bath
    couplings, P >= 2. problem: IsingProblem, or a LatticeProblem (taken
    to_generic(), as the other cluster solvers take it). On the card
    csrc/fk_line.cu once a color phase (P <= 64), and
    csrc/generic_qmc_bath.cu once a step for WC2's local sweeps. Returns
    the annealed configurations."""
    _roadmap.require_problem(problem, "qmc.anneal_sw_bath")
    return cluster_kernels.sw_bath_anneal(
        cluster_kernels.generic_form(problem), a_sched, b_sched, temp,
        lookuptable, confs, draw_seed(generator), mcsteps, per_slice_seeds,
        local_sweeps)
