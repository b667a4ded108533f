"""The sweep engines the samplers drive (solvers/pt.py, solvers/pa.py): one
object a run, holding the chains' state in the engine's own layout from
launch to launch.

The JAX samplers dispatch their sweeps per problem (solvers/pt.py:88-125,
:209-255, solvers/pa.py:83-124, :446-487); the engines here follow that
dispatch onto the port's kernels, each a chain axis of every chain of the
run (reads x rungs, pairs x 2 x rungs, or the population):

  classical   even-L LatticeProblem   kernel A (csrc/split_sa.cu): on the
                                      card the halves as kernel A's chain-
                                      bit words from launch to launch, its
                                      energies by the energy kernel on the
                                      words (`split_kernels.words_energy`);
                                      float halves (a, b) on the CPU and
                                      past the cluster (L > 960)
              odd-L LatticeProblem    csrc/packed_sa.cu on the lattice's own
                                      checkerboard (`packed.
                                      packed_from_lattice`: the JAX masked
                                      sweep's colors and field order, its
                                      odd-torus wrap pairs included)
              IsingProblem            csrc/packed_sa.cu on `packed.
                                      build_packed` (the masked sweep's
                                      spins, bitwise)
              DenseProblem            csrc/dense_sa.cu beside the block
                                      products (`ops/dense_kernels.py`)
  quantum     even-L lattice, even P  the quarters, kernel B
                                      (csrc/split_qmc.cu)
              any other lattice or    csrc/generic_qmc.cu on the packing
              an IsingProblem         above
              DenseProblem            refused, as in the JAX package

`sweep` takes either one temperature (or J_perp) a chain, a (chains,)
tensor that the kernels read as a (steps, chains) table repeating one row,
or one shared value for every chain (PA), and `step0`, the step the hash
counts the launch's first sweep as: the sweeps draw counter(seed, step0 +
t, ...) at the chain-keyed uids of `counter_rng`, so a run split into
launches draws as one anneal, and a chain's stream does not follow the
rung it holds. The packed and dense engines read energies with the
problem's own formula (`packed.packed_energy`, `DenseProblem.energy`),
which has no kernel of its own.
"""

from __future__ import annotations

import torch

from montecarlosolvers_tpu_torch import _roadmap
from montecarlosolvers_tpu_torch.models.dense import DenseProblem
from montecarlosolvers_tpu_torch.models.lattice import LatticeProblem
from montecarlosolvers_tpu_torch.ops import dense_kernels
from montecarlosolvers_tpu_torch.ops import energy as energy_ops
from montecarlosolvers_tpu_torch.ops import generic_kernels
from montecarlosolvers_tpu_torch.ops import packed as packed_ops
from montecarlosolvers_tpu_torch.ops import split as split_ops
from montecarlosolvers_tpu_torch.ops import split_kernels


def _table(values, steps):
    """A sweep launch's schedule: a (chains,) tensor of per-chain values as
    a (steps, chains) table repeating one row; a 0-d or 1-element tensor as
    a contiguous (steps,) schedule shared by every chain."""
    values = values.to(torch.float32)
    if values.dim() == 1 and values.numel() > 1:
        return values.contiguous()[None, :].expand(steps, -1)
    return values.reshape(1).expand(steps).contiguous()


def _packing(problem):
    """The packed layout the generic kernels sweep: a lattice's own
    checkerboard, an IsingProblem's greedy classes."""
    if isinstance(problem, LatticeProblem):
        return packed_ops.packed_from_lattice(problem)
    return packed_ops.build_packed(problem)


class ClassicalEngine:
    """Classical Metropolis sweeps of (chains, N) states on the problem's
    engine (module docstring); `state` holds them in its layout."""

    def __init__(self, problem, states):
        _roadmap.require_problem(problem)
        self.problem = problem
        self.n = problem.nspins
        states = states.to(torch.float32)
        if isinstance(problem, DenseProblem):
            self.kind = "dense"
            self.state = states.contiguous()
        elif split_ops.supports_split(problem):
            self.sl = split_ops.build_split(problem)
            self.chains = states.shape[0]
            self.geometry = split_kernels.words_geometry(
                self.sl, self.chains, states.device)
            self.kind = "split" if self.geometry is None else "words"
            self.set_full(states)
        else:
            self.kind = "packed"
            self.pg = _packing(problem)
            self.state = packed_ops.pack_state(self.pg, states).contiguous()

    def sweep(self, temps, seed, step0, steps):
        """`steps` sweeps at `temps` ((chains,) or shared), the hash counting
        the first as step `step0`: one kernel launch (the dense engine: one
        a block and sweep)."""
        table = _table(temps, steps)
        if self.kind == "words":
            self.state = split_kernels.sa_split_words_anneal(
                self.sl, table, *self.state, self.chains, self.geometry,
                seed, step0=step0)
        elif self.kind == "split":
            self.state = split_kernels.sa_split_anneal(
                self.sl, table, *self.state, seed, step0=step0)
        elif self.kind == "packed":
            self.state = generic_kernels.packed_sa_anneal(
                self.pg, table, self.state, seed, step0=step0)
        else:
            self.state = dense_kernels.dense_sa_anneal(
                self.problem, table, self.state, seed, step0=step0)

    def energy(self):
        """(chains,) float32 classical energies."""
        if self.kind == "words":
            return split_kernels.words_energy(self.sl, *self.state,
                                              self.chains, self.geometry[0])
        if self.kind == "split":
            return energy_ops.halves_energy(self.sl, *self.state)
        if self.kind == "packed":
            return packed_ops.packed_energy(self.pg, self.state)
        return self.problem.energy(self.state)

    def full(self):
        """The (chains, N) states in the problem's site order."""
        if self.kind == "words":
            return split_ops.unpack_classical(self.sl, *(
                split_kernels.unpack_chain_bits(w, self.chains,
                                                self.geometry[0])
                for w in self.state))
        if self.kind == "split":
            return split_ops.unpack_classical(self.sl, *self.state)
        if self.kind == "packed":
            return packed_ops.unpack_state(self.pg, self.state)
        return self.state

    def set_full(self, states):
        """Replace the state by (chains, N) states in site order."""
        if self.kind == "words":
            self.state = tuple(
                split_kernels.pack_chain_bits(x, self.geometry[0])
                for x in split_ops.pack_classical(self.sl, states))
        elif self.kind == "split":
            self.state = split_ops.pack_classical(self.sl, states)
        elif self.kind == "packed":
            self.state = packed_ops.pack_state(self.pg, states).contiguous()
        else:
            self.state = states.contiguous()

    def permute(self, idx):
        """Gather the chains: chain i takes chain idx[i]'s state."""
        if self.kind == "words":
            self.state = tuple(
                split_kernels.gather_chain_bits(w, idx, self.geometry[0])
                for w in self.state)
        elif self.kind == "split":
            self.state = tuple(x[idx] for x in self.state)
        else:
            self.state = self.state[idx]


class QuantumEngine:
    """Space-time PIQMC sweeps of (chains, P, N) configurations at
    per-slice temperature `temp`, B = `b`, with or without line moves, on
    the problem's engine (module docstring)."""

    def __init__(self, problem, confs, temp, b=1.0, global_moves=False,
                 what="the quantum samplers"):
        _roadmap.require_problem(problem, what)
        self.problem = problem
        self.slices = confs.shape[-2]
        self.teff = float(temp) * self.slices
        self.b = float(b)
        self.global_moves = bool(global_moves)
        confs = confs.to(torch.float32)
        if split_ops.supports_split(problem, self.slices):
            self.kind = "split"
            self.sl = split_ops.build_split(problem)
            self.state = split_ops.pack_qmc(self.sl, confs)
        else:
            self.kind = "packed"
            self.pg = _packing(problem)
            self.state = packed_ops.pack_state(self.pg, confs).contiguous()

    def sweep(self, jp, seed, step0, steps):
        """`steps` local sweeps (and line moves) at J_perp `jp` ((chains,)
        or shared), the hash counting the first as step `step0`: one kernel
        launch."""
        table = _table(jp, steps)
        dev = table.device
        b_sched = torch.full((steps,), self.b, dtype=torch.float32,
                             device=dev)
        if self.kind == "split":
            self.state = split_kernels.qmc_split_anneal(
                self.sl, b_sched, table, self.teff, self.state, seed,
                self.global_moves, step0=step0)
        else:
            self.state = generic_kernels.generic_qmc_anneal(
                self.pg, b_sched, table, self.teff, self.state, seed,
                self.global_moves, step0=step0)

    def kinetic(self):
        """(chains,) float32 Trotter kinetic terms K = sum s^k s^(k+1),
        exact integers (`split.qmc_split_kinetic`)."""
        if self.kind == "split":
            return split_ops.qmc_split_kinetic(self.sl, *self.state)
        c = self.state
        return torch.sum(c * torch.roll(c, -1, dims=-2), dim=(-1, -2))

    def full(self):
        """The (chains, P, N) configurations in the problem's site order."""
        if self.kind == "split":
            return split_ops.unpack_qmc(self.sl, *self.state)
        return packed_ops.unpack_state(self.pg, self.state)

    def permute(self, idx):
        """Gather the chains: chain i takes chain idx[i]'s configuration."""
        if self.kind == "split":
            self.state = tuple(x[idx] for x in self.state)
        else:
            self.state = self.state[idx]
