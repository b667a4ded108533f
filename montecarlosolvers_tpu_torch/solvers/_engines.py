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

import math

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


def _table(values, steps, per_chain=None):
    """A sweep launch's schedule: a (chains,) tensor of per-chain values as
    a (steps, chains) table repeating one row; a 0-d or 1-element tensor as
    a contiguous (steps,) schedule shared by every chain. per_chain=True
    takes a 1-element tensor as one chain's value (a chain shard of one
    chain of a per-chain run)."""
    values = values.to(torch.float32)
    if per_chain is None:
        per_chain = values.dim() == 1 and values.numel() > 1
    if per_chain:
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
    engine (module docstring); `state` holds them in its layout. chain0:
    the global index of the first chain, which the kernels' uids count from
    (one block of a chain-sharded run, `ShardedEngine`; 0 unsharded)."""

    def __init__(self, problem, states, chain0=0):
        _roadmap.require_problem(problem)
        self.problem = problem
        self.n = problem.nspins
        self.chain0 = int(chain0)
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

    def sweep(self, temps, seed, step0, steps, per_chain=None):
        """`steps` sweeps at `temps` ((chains,) or shared; per_chain as for
        `_table`), the hash counting the first as step `step0`: one kernel
        launch (the dense engine: one a block and sweep)."""
        table = _table(temps, steps, per_chain)
        c0 = self.chain0
        if self.kind == "words":
            self.state = split_kernels.sa_split_words_anneal(
                self.sl, table, *self.state, self.chains, self.geometry,
                seed, step0=step0, chain0=c0)
        elif self.kind == "split":
            self.state = split_kernels.sa_split_anneal(
                self.sl, table, *self.state, seed, step0=step0, chain0=c0)
        elif self.kind == "packed":
            self.state = generic_kernels.packed_sa_anneal(
                self.pg, table, self.state, seed, step0=step0, chain0=c0)
        else:
            self.state = dense_kernels.dense_sa_anneal(
                self.problem, table, self.state, seed, step0=step0,
                chain0=c0)

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
    the problem's engine (module docstring); chain0 as for
    `ClassicalEngine`."""

    def __init__(self, problem, confs, temp, b=1.0, global_moves=False,
                 what="the quantum samplers", chain0=0):
        _roadmap.require_problem(problem, what)
        self.problem = problem
        self.chain0 = int(chain0)
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

    def sweep(self, jp, seed, step0, steps, per_chain=None):
        """`steps` local sweeps (and line moves) at J_perp `jp` ((chains,)
        or shared; per_chain as for `_table`), the hash counting the first
        as step `step0`: one kernel launch."""
        table = _table(jp, steps, per_chain)
        dev = table.device
        b_sched = torch.full((steps,), self.b, dtype=torch.float32,
                             device=dev)
        if self.kind == "split":
            self.state = split_kernels.qmc_split_anneal(
                self.sl, b_sched, table, self.teff, self.state, seed,
                self.global_moves, step0=step0, chain0=self.chain0)
        else:
            self.state = generic_kernels.generic_qmc_anneal(
                self.pg, b_sched, table, self.teff, self.state, seed,
                self.global_moves, step0=step0, chain0=self.chain0)

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

    def set_full(self, confs):
        """Replace the state by (chains, P, N) configurations in site
        order."""
        confs = confs.to(torch.float32)
        if self.kind == "split":
            self.state = split_ops.pack_qmc(self.sl, confs)
        else:
            self.state = packed_ops.pack_state(self.pg, confs).contiguous()

    def permute(self, idx):
        """Gather the chains: chain i takes chain idx[i]'s configuration."""
        if self.kind == "split":
            self.state = tuple(x[idx] for x in self.state)
        else:
            self.state = self.state[idx]


class ShardedEngine:
    """One rank's share of a sampler run on a chain-sharded DTensor state:
    the state (M, ...) sharded Shard(0) on the mesh's "chains" axis, or (G,
    M, ...) sharded Shard(1) (ICM's two ladders, G = 2), replicated on any
    other mesh axis. In the run's flat chain order (g * M + m) a rank's
    chains are G runs of k = M / ranks consecutive chains; each run sweeps
    on an engine of its own, made by make(states, chain0) with the run's
    global first chain, so that its uids, and so its spins, are the
    unsharded run's.

    The interface is the engines': `sweep` takes the whole run's
    (chains,) values (or one shared value) and hands each run its slice;
    `energy()`, `kinetic()` and `full()` return the gathered (chains, ...)
    values in flat order, the same on every rank (`_collectives.gather`,
    the states as int8, `gather_spins`); `set_full` keeps the rank's runs
    of the whole state it is given; `permute(idx)` takes global indices.
    Every rank must call each of them as often as every other: each
    gathers."""

    sharded = True

    def __init__(self, make, state, dim=0):
        from montecarlosolvers_tpu_torch.parallel import mesh as pmesh

        local, _, self.mesh = pmesh.chain_block(state, dim)
        if "chains" not in self.mesh.mesh_dim_names:
            raise ValueError("a sharded sampler state needs a 'chains' mesh "
                             "axis (parallel.shard_chains)")
        self.group = self.mesh.get_group("chains")
        self.dim = dim
        self.shape = tuple(state.shape)
        ranks = pmesh.axis_size(self.mesh, "chains")
        me = pmesh.axis_rank(self.mesh, "chains")
        g, m = math.prod(self.shape[:dim]), self.shape[dim]
        if m % ranks:
            raise ValueError(f"{m} along dim {dim} does not divide by the "
                             f"'chains' axis size {ranks}")
        self.k = m // ranks
        local = local.reshape((g * self.k,) + self.shape[dim + 1:])
        self.starts = [l * m + me * self.k for l in range(g)]
        self.engines = [make(local[i * self.k:(i + 1) * self.k], s)
                        for i, s in enumerate(self.starts)]
        # the gathered rows are rank after rank, each rank's runs in order
        order = torch.cat([torch.arange(l * m + r * self.k,
                                        l * m + (r + 1) * self.k)
                           for r in range(ranks) for l in range(g)])
        self.inverse = (None if g == 1 else
                        torch.argsort(order).to(local.device))

    @property
    def teff(self):
        return self.engines[0].teff

    def _gather(self, t, spins=False):
        from montecarlosolvers_tpu_torch.parallel import _collectives as coll

        out = (coll.gather_spins if spins else coll.gather)(t, self.group, 0)
        return out if self.inverse is None else out[self.inverse]

    def sweep(self, values, seed, step0, steps):
        per_chain = values.dim() == 1 and values.numel() > 1
        for e, s in zip(self.engines, self.starts):
            e.sweep(values[s:s + self.k] if per_chain else values, seed,
                    step0, steps, per_chain)

    def energy(self):
        return self._gather(torch.cat([e.energy() for e in self.engines]))

    def kinetic(self):
        return self._gather(torch.cat([e.kinetic() for e in self.engines]))

    def local_full(self):
        """This rank's chains in site order, its runs in order."""
        return torch.cat([e.full() for e in self.engines])

    def full(self):
        return self._gather(self.local_full(), spins=True)

    def set_full(self, states):
        for e, s in zip(self.engines, self.starts):
            e.set_full(states[s:s + self.k])

    def permute(self, idx):
        self.set_full(self.full()[idx])

    def placed(self, full, dim=None):
        """The whole tensor `full`, the same on every rank, as a DTensor
        sharded as the state was along its dim `dim` (default the state's
        chain dim): this rank's block, with no message."""
        from montecarlosolvers_tpu_torch.parallel import mesh as pmesh

        dim = self.dim if dim is None else dim
        return pmesh.as_dtensor(
            pmesh.local_block(full, self.mesh, {dim: "chains"}), self.mesh,
            {dim: "chains"}, tuple(full.shape))

    def placed_local(self, local):
        """This rank's block `local` of a tensor of the state's shape as a
        DTensor of the state's placements."""
        from montecarlosolvers_tpu_torch.parallel import mesh as pmesh

        return pmesh.as_dtensor(local, self.mesh, {self.dim: "chains"},
                                self.shape)


def sharded_state(state, ndim, dim, what):
    """Raise ValueError unless the DTensor `state` has `ndim` dims (the JAX
    sampler's shape: no leading ladder axes) to be sharded along `dim`."""
    if state.ndim != ndim:
        raise ValueError(
            f"{what} takes a chain-sharded state of {ndim} dims, sharded "
            f"on dim {dim} (the JAX sampler's shape), got {tuple(state.shape)}")
