"""Color-packed maskless sweeps for arbitrary graphs: plain versions.

Counterpart of `montecarlosolvers_tpu/ops/packed.py`. The masked engine
(`ops/metropolis.py`) computes every site's field in every color phase and
masks out the inactive colors; this layout permutes the state class-major
once per anneal, so each phase updates one contiguous block with no masks
and a sweep does the work of N sites, not C*N. The CUDA kernels of this
layout (`csrc/packed_sa.cu`, `csrc/packed_svmc.cu`, `csrc/generic_qmc.cu`)
and their wrappers are in `ops/generic_kernels.py`.

The sweeps take their uniforms as an argument, in packed order: one per
site and sweep (two for SVMC, proposal and acceptance). The anneals of
`ops/generic_kernels.py` draw them from the counter hash keyed by each
site's original index, so that the masked engine consumes the same
uniform at the same site; the tests feed the same `jax.random` draws to
these functions and to the JAX package's.

The JAX package's `MAX_PACKED_COLORS` is not ported: it bounds the size of
an unrolled TPU program, and the kernels here loop over the color blocks
at run time, so any color count takes this layout. The noisy scans
(per-step coupling tables) wait for `anneal_noisy` (ROADMAP.md queue 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from montecarlosolvers_tpu_torch.models.ising import IsingProblem, slot_sum
from montecarlosolvers_tpu_torch.ops import svmc_ops
from montecarlosolvers_tpu_torch.ops.metropolis import metropolis_accept


@dataclasses.dataclass(frozen=True)
class PackedGraph:
    """Class-major permutation of an IsingProblem, on its device.

    nbr_idx / nbr_J: (N, maxnb) int32 / float32 neighbor tables with both
      rows and index targets in packed order (padding self-slots stay
      self-referential with J = 0).
    h: (N,) float32 fields in packed order.
    perm: (N,) int32, packed position i holds original site perm[i].
    inv: (N,) int64, the inverse permutation (original site -> position).
    starts: the C + 1 block boundaries as Python ints; block k =
      packed[starts[k]:starts[k+1]] is color class k, an independent set.
    starts_dev: the same boundaries as an int32 tensor, for the kernels.
    proper: False when some coupling joins two sites of one class (an odd
      periodic lattice's checkerboard, `packed_from_lattice`): a block is
      then not an independent set, and a sweep must read a same-class
      neighbour as it stood before the class's phase.
    """

    nbr_idx: torch.Tensor
    nbr_J: torch.Tensor
    h: torch.Tensor
    perm: torch.Tensor
    inv: torch.Tensor
    starts: tuple
    starts_dev: torch.Tensor
    proper: bool = True

    @property
    def nspins(self):
        return int(self.h.shape[0])

    @property
    def num_colors(self):
        return len(self.starts) - 1

    def as_problem(self):
        """The problem in packed order, its color classes the blocks: the
        masked engines on it are the packed engines."""
        colors = torch.repeat_interleave(
            torch.arange(self.num_colors, dtype=torch.int32),
            torch.tensor(np.diff(self.starts))).to(self.h.device)
        return IsingProblem(self.nbr_idx, self.nbr_J, self.h, colors,
                            self.num_colors)


def supports_packed(problem):
    """True for the port's IsingProblem, whatever its color count (the
    JAX package's MAX_PACKED_COLORS is a TPU program-size rule)."""
    return type(problem) is IsingProblem


def _packed_graph(nbr_idx, nbr_J, h, colors, num_colors, device):
    """The PackedGraph of numpy tables in original order (nbr_idx (N,
    maxnb), nbr_J, h, colors (N,)): sites sorted by color, stably."""
    perm = np.argsort(colors, kind="stable")
    inv = np.argsort(perm)
    counts = np.bincount(colors, minlength=num_colors)
    starts = np.concatenate([[0], np.cumsum(counts)])
    own = np.arange(len(colors))[:, None]
    same = (colors[nbr_idx] == colors[:, None]) & (nbr_idx != own)
    return PackedGraph(
        nbr_idx=torch.as_tensor(inv[nbr_idx[perm]].astype(np.int32),
                                device=device),
        nbr_J=torch.as_tensor(nbr_J[perm].astype(np.float32), device=device),
        h=torch.as_tensor(h[perm].astype(np.float32), device=device),
        perm=torch.as_tensor(perm.astype(np.int32), device=device),
        inv=torch.as_tensor(inv, device=device),
        starts=tuple(int(x) for x in starts),
        starts_dev=torch.as_tensor(starts.astype(np.int32), device=device),
        proper=not bool((same & (nbr_J != 0.0)).any()),
    )


def build_packed(problem):
    """The PackedGraph of IsingProblem `problem`, on its device."""
    return _packed_graph(*(x.cpu().numpy() for x in (
        problem.nbr_idx, problem.nbr_J, problem.h, problem.colors)),
        problem.num_colors, problem.device)


def packed_from_lattice(problem):
    """The PackedGraph of LatticeProblem `problem` with the lattice's own
    checkerboard colors (`models/lattice.py::checkerboard_masks`: class c
    the sites of parity (r + c) % 2 == c) and its slots in the order
    `LatticeProblem.local_fields` adds them, right, left, down, up (the
    JAX `LatticeProblem.local_fields`, models/lattice.py:136-144), then h:
    the packed engines on it compute the masked lattice sweeps' fields
    bitwise, phase for phase (an open boundary's slots keep J = 0). Not
    `to_generic()`, whose greedy colors and slot order are another
    problem's. On an odd periodic lattice the wrap pairs share a parity,
    so the packing is not `proper` (ROADMAP.md queue 3)."""
    L = problem.L
    jr, jd, hp = (x.cpu().numpy() for x in (problem.j_right, problem.j_down,
                                            problem.h_plane))
    r, c = np.divmod(np.arange(L * L), L)
    nbr_idx = np.stack([r * L + (c + 1) % L, r * L + (c - 1) % L,
                        ((r + 1) % L) * L + c, ((r - 1) % L) * L + c], axis=1)
    nbr_J = np.stack([jr[r, c], jr[r, (c - 1) % L], jd[r, c],
                      jd[(r - 1) % L, c]], axis=1)
    colors = ((r + c) % 2).astype(np.int32)
    return _packed_graph(nbr_idx, nbr_J, hp.reshape(-1), colors, 2,
                         problem.device)


def pack_state(pg, spins):
    """(..., N) state in original order -> packed order."""
    return spins[..., pg.perm.long()]


def unpack_state(pg, spins):
    """(..., N) state in packed order -> original order."""
    return spins[..., pg.inv]


def packed_energy(pg, spins):
    """Classical energy of (..., N) packed spins: each bond appears in both
    endpoints' rows, hence the half on the coupling part."""
    coupling_field = slot_sum(pg.nbr_idx, pg.nbr_J, spins)
    return (0.5 * torch.sum(spins * coupling_field, dim=-1)
            + torch.sum(pg.h * spins, dim=-1))


def _blocks(pg):
    for k in range(pg.num_colors):
        lo, hi = pg.starts[k], pg.starts[k + 1]
        if lo < hi:
            yield lo, hi


def block_fields(pg, x, lo, hi):
    """sum_k J x_nb + h of the sites lo:hi of packed (..., N) values x, the
    slots in index order, then h."""
    return slot_sum(pg.nbr_idx[lo:hi], pg.nbr_J[lo:hi], x) + pg.h[lo:hi]


def packed_sweep(pg, spins, u, temp, b_coeff=-2.0):
    """One maskless Metropolis sweep over the class blocks, in block order.

    spins: (..., N) float32 +/-1 in packed order; u: uniforms of the same
    shape (one per site); temp: float32 tensor; b_coeff: dE = b_coeff * s *
    field (-2 for SA; -2B for a PIQMC slice). Returns the new spins."""
    spins = spins.clone()
    for lo, hi in _blocks(pg):
        s_blk = spins[..., lo:hi]
        de = b_coeff * s_blk * block_fields(pg, spins, lo, hi)
        acc = metropolis_accept(de, temp, u[..., lo:hi])
        spins[..., lo:hi] = torch.where(acc, -s_blk, s_blk)
    return spins


def packed_svmc_sweep_cached(pg, state, u_prop, u_acc, temp, a_coeff,
                             b_coeff, tf=False):
    """One maskless SVMC sweep over the class blocks (rotor dE of
    svmc.pyx:96-110) on carried trig caches: state = (theta, cos theta,
    sin theta), each (..., N) in packed order; u_prop / u_acc: the
    proposal and acceptance uniforms, same shape; temp, a_coeff, b_coeff:
    float32 tensors. Returns the new state; the caches hold cos and sin of
    the accepted angles, never an increment."""
    theta, cos_all, sin_all = (x.clone() for x in state)
    for lo, hi in _blocks(pg):
        th_blk = theta[..., lo:hi]
        up = u_prop[..., lo:hi]
        prop = (svmc_ops.propose_tf(th_blk, up, a_coeff, b_coeff)
                if tf else svmc_ops.propose_uniform(up))
        zfield = block_fields(pg, cos_all, lo, hi)
        cos_prop = torch.cos(prop)
        sin_prop = torch.sin(prop)
        de = b_coeff * (cos_prop - cos_all[..., lo:hi]) * zfield
        de = de + a_coeff * (sin_all[..., lo:hi] - sin_prop)
        acc = metropolis_accept(de, temp, u_acc[..., lo:hi])
        theta[..., lo:hi] = torch.where(acc, prop, th_blk)
        cos_all[..., lo:hi] = torch.where(acc, cos_prop, cos_all[..., lo:hi])
        sin_all[..., lo:hi] = torch.where(acc, sin_prop, sin_all[..., lo:hi])
    return theta, cos_all, sin_all


def packed_svmc_sweep(pg, theta, u_prop, u_acc, temp, a_coeff, b_coeff,
                      tf=False):
    """Single-sweep form of `packed_svmc_sweep_cached` (builds and drops
    the trig caches)."""
    theta, _, _ = packed_svmc_sweep_cached(
        pg, (theta, torch.cos(theta), torch.sin(theta)), u_prop, u_acc,
        temp, a_coeff, b_coeff, tf=tf)
    return theta
