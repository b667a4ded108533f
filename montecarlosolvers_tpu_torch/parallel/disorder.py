"""Disorder batching: anneal many coupling realizations of one graph
topology at once (counterpart of montecarlosolvers_tpu/parallel/disorder.py).

The JAX package vmaps a solver over the stacked coupling leaves of an
IsingProblem, the topology (neighbor indices, colors) shared. The port
writes the batch axis out:

  * `stack_problems` checks the topology, recolors it on the topology alone
    and stacks the couplings into a `StackedProblem`;
  * `vmap_disorder(sa.anneal, axes)` runs the whole batch in ONE launch of
    csrc/packed_sa.cu with its disorder stride (realization r = chain // C
    reads its own tables, its own hash seed and the uids of a solo call:
    `generic_kernels.packed_sa_anneal(disorder=)`, LAUNCHES["packed_sa"]);
  * any other solver function runs realization by realization on
    `StackedProblem.realization(d)`, its results the solo calls'.

JAX's (D,) keys become D `torch.Generator`s, one a realization: the solver
draws realization d's hash seed from generators[d], as a solo call with
that generator does, so realization d of a batch equals the solo call
`sa.anneal(p_d, sched, states[d], generators[d], engine="masked")` bitwise.

Recoloring caveat (as in the JAX package): the batch sweeps the classes of
the topology-only coloring. A realization whose own greedy coloring
differs from it (one with a zero coupling, whose slot its own coloring
ignores) sweeps other classes alone than in the batch: the same
distribution, other spins. Realizations with every coupling nonzero
(Gaussian ones) color alike and match bitwise.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from montecarlosolvers_tpu_torch import _roadmap, schedules
from montecarlosolvers_tpu_torch.models.coloring import greedy_coloring
from montecarlosolvers_tpu_torch.models.ising import IsingProblem
from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
from montecarlosolvers_tpu_torch.ops import packed as packed_ops
from montecarlosolvers_tpu_torch.parallel import mesh as pmesh
from montecarlosolvers_tpu_torch.solvers import sa

# The fields of a StackedProblem that carry the disorder axis (0) and those
# every realization shares (None): JAX's in_axes of the stacked problem.
STACKED_AXES = {"nbr_J": 0, "h": 0, "nbr_idx": None, "colors": None}


@dataclasses.dataclass(frozen=True)
class StackedProblem:
    """D coupling realizations of one topology.

    problem: the IsingProblem of the shared topology (its neighbor indices
      and the topology-only coloring; its tables realization 0's).
    nbr_J: (D, N, maxnb) float32 and h: (D, N) float32, each realization's
      tables in the problem's slot layout.
    """

    problem: IsingProblem
    nbr_J: torch.Tensor
    h: torch.Tensor

    @property
    def realizations(self):
        return int(self.nbr_J.shape[0])

    @property
    def nspins(self):
        return self.problem.nspins

    @property
    def device(self):
        return self.problem.device

    def realization(self, d):
        """Realization d as an IsingProblem on the shared coloring."""
        p = self.problem
        return IsingProblem(p.nbr_idx, self.nbr_J[d], self.h[d], p.colors,
                            p.num_colors)

    @functools.cached_property
    def packed(self):
        """(PackedGraph of the shared coloring, nbr_J (D, N, maxnb), h (D,
        N)): the layout and every realization's tables in packed row
        order, what the disorder stride of csrc/packed_sa.cu reads."""
        pg = packed_ops.build_packed(self.problem)
        perm = pg.perm.long()
        return (pg, self.nbr_J.index_select(1, perm).contiguous(),
                self.h.index_select(1, perm).contiguous())

    def energy(self, spins):
        """H(s) of a (D, ..., N) batch, realization d on spins[d]: (D, ...)
        float32, each realization's as its IsingProblem.energy sums it."""
        s = spins.to(torch.float32)
        lead = (self.realizations,) + (1,) * (s.dim() - 2)
        nbr_j = self.nbr_J.reshape(lead + tuple(self.nbr_J.shape[1:]))
        xj = s[..., self.problem.nbr_idx]  # (D, ..., N, maxnb)
        quad = nbr_j[..., 0] * xj[..., 0]
        for k in range(1, self.problem.maxnb):
            quad = quad + nbr_j[..., k] * xj[..., k]
        h = self.h.reshape(lead + (self.nspins,))
        return 0.5 * torch.sum(quad * s, dim=-1) + torch.sum(h * s, dim=-1)


def stack_problems(problems):
    """Stack same-topology IsingProblems along a leading disorder axis (JAX
    `stack_problems`). Returns (stacked, axes): a `StackedProblem`, its
    topology recolored with every non-self slot an edge (a slot that is
    zero in one realization and not in another must still separate its
    endpoints), and `STACKED_AXES`, the fields the disorder axis maps.
    Raises ValueError when the problems differ in nspins, maxnb or neighbor
    structure, or one is not an IsingProblem."""
    p0 = problems[0]
    if not all(isinstance(p, IsingProblem) for p in problems):
        raise ValueError("stack_problems takes IsingProblems")
    idx0 = p0.nbr_idx.cpu().numpy()
    for p in problems[1:]:
        if p.nspins != p0.nspins or p.maxnb != p0.maxnb:
            raise ValueError("problems must share topology")
        if not np.array_equal(p.nbr_idx.cpu().numpy(), idx0):
            raise ValueError("problems must share the neighbor structure")
    colors, num_colors = greedy_coloring(idx0, None)
    dev = p0.device
    shared = IsingProblem(p0.nbr_idx, p0.nbr_J, p0.h,
                          torch.as_tensor(colors, device=dev), num_colors)
    stacked = StackedProblem(
        shared, torch.stack([p.nbr_J.to(dev) for p in problems]),
        torch.stack([p.h.to(dev) for p in problems]))
    return stacked, dict(STACKED_AXES)


def vmap_disorder(solver_fn, stacked_axes, state_axis=0, key_axis=0,
                  extra_axes=()):
    """The solver mapped over the disorder axis (JAX `vmap_disorder`).

    solver_fn(problem, sched, *extra, state, generator): the returned
    run(stacked, sched, *extra, states, generators) takes the
    `StackedProblem`, a schedule every realization shares, the extra
    arguments (mapped on the axis `extra_axes` gives each, or shared where
    it gives None), states with the disorder axis at `state_axis` ((D, C,
    N) for `sa.anneal`) and a sequence of D torch.Generators (the port's
    stand-in for JAX's (D,) keys; `key_axis` must be 0). It returns the
    results stacked on a leading disorder axis.

    `sa.anneal` with no extra arguments runs as ONE launch of the packed SA
    kernel with its disorder stride (each realization's seed drawn from
    its generator); every other solver function runs realization by
    realization. Either way realization d equals the solo call on
    `stacked.realization(d)` with generators[d], bitwise.

    >>> stacked, axes = stack_problems(list_of_problems)
    >>> run = vmap_disorder(sa.anneal, axes)
    >>> out = run(stacked, sched, states, generators)   # states (D, C, N)
    """
    if dict(stacked_axes) != STACKED_AXES:
        raise ValueError(f"stacked_axes must be stack_problems' "
                         f"{STACKED_AXES}, got {stacked_axes}")
    if key_axis != 0:
        raise ValueError("the generators are a sequence: key_axis must be 0")
    extra_axes = tuple(extra_axes)

    def run(stacked, sched, *rest):
        *extra, states, generators = rest
        if len(extra) != len(extra_axes):
            raise ValueError(f"{len(extra)} extra arguments for "
                             f"{len(extra_axes)} extra_axes")
        return _run(solver_fn, stacked, sched, extra, extra_axes,
                    states.movedim(state_axis, 0), generators)
    return run


def _run(solver_fn, stacked, sched, extra, extra_axes, states, generators,
         chain0=0, chains=None):
    """vmap_disorder's run on states (D, ...) with the disorder axis first:
    a block of chains from chain0 of a (D, chains, ...) batch whose chain
    axis is sharded over the 1-D mesh `chains` (None: the whole batch)."""
    d = stacked.realizations
    if states.shape[0] != d or len(generators) != d:
        raise ValueError(f"{d} realizations, states of {states.shape[0]} "
                         f"and {len(generators)} generators")
    if solver_fn is sa.anneal and not extra:
        return _anneal_batch(stacked, sched, states, generators, chain0)
    outs = []
    for r in range(d):
        args = [x if ax is None else x.select(ax, r)
                for x, ax in zip(extra, extra_axes)]
        state = states[r]
        if chains is not None:  # this rank's block of a sharded chain axis
            state = pmesh.as_dtensor(
                state, chains, {0: "chains"},
                (state.shape[0] * pmesh.axis_size(chains, "chains"),)
                + tuple(state.shape[1:]))
        out = solver_fn(stacked.realization(r), sched, *args, state,
                        generators[r])
        outs.append(tuple(map(_local, out)) if isinstance(out, tuple)
                    else _local(out))
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(xs) for xs in zip(*outs))
    return torch.stack(outs)


def _local(x):
    """This rank's block of a DTensor, a plain tensor as it is."""
    return x.to_local() if _roadmap.is_sharded(x) else x


def _anneal_batch(stacked, sched, states, generators, chain0=0):
    """`sa.anneal` over the batch: states (D, ..., N), one launch of
    csrc/packed_sa.cu with the disorder stride on the shared coloring's
    packing, realization d on the seed drawn from generators[d] and the
    chains of each realization counted from chain0."""
    pg, nbr_j, h = stacked.packed
    if states.device != stacked.device:
        raise ValueError(f"states are on {states.device}, the problems on "
                         f"{stacked.device}")
    seeds = [sa.draw_seed(g) for g in generators]
    temps = schedules.expand_mcsteps(sched, 1, stacked.device)
    n = stacked.nspins
    flat = packed_ops.pack_state(
        pg, states.to(torch.float32).reshape(-1, n)).contiguous()
    out = gk.packed_sa_anneal(pg, temps, flat, seeds[0], chain0=chain0,
                              disorder=(nbr_j, h, seeds))
    return packed_ops.unpack_state(pg, out).reshape(states.shape)
