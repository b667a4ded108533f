"""The generic Ising problem: a padded neighbor table and its coloring.

Counterpart of `montecarlosolvers_tpu/models/ising.py`. The reference's
neighbor-table format (tools.pyx:28-96, `GenerateNeighbors`) becomes a
padded (N, maxnb) gather; the diagonal entries (neighbor index equal to
the own index, the local fields of sa.pyx:89-91) are split out into a
field vector `h` when the problem is built. Energy convention
(tools.pyx:99-118, sa.pyx:84-94):

    H(s) = sum_{stored pairs (i,j)} J_ij s_i s_j + sum_i h_i s_i
    dE_i(flip) = -2 s_i ( sum_{j in nb(i)} J_ij s_j + h_i )

Each stored pair appears once in H; the table lists it in both endpoints'
rows so dE is local. The table is compiled on the host with numpy, as the
JAX package compiles it (its native C++ compiler, `native/neighbors.cpp`,
gives the same table and is host code, not a kernel); the problem's
tensors then live on `device` (None: the CUDA device, `_device.resolve`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from montecarlosolvers_tpu_torch import _device
from montecarlosolvers_tpu_torch.models.coloring import greedy_coloring


def bits2spins(vec):
    """Bit (0/1) -> spin (+1/-1) convention of tools.pyx:20-22 (1 maps to
    -1)."""
    vec = torch.as_tensor(vec)
    return torch.where(vec == 1, -1, 1)


def spins2bits(vec):
    """Spin (+1/-1) -> bit (0/1) convention of tools.pyx:24-26 (+1 maps to
    0)."""
    vec = torch.as_tensor(vec)
    return torch.where(vec == 1, 0, 1)


def _coo_from_any(J, nspins):
    """COO triplets (rows, cols, vals) from a scipy sparse matrix, a dict
    {(i, j): val} or a dense (N, N) array."""
    if hasattr(J, "tocoo"):  # scipy sparse
        coo = J.tocoo()
        return (np.asarray(coo.row, dtype=np.int64),
                np.asarray(coo.col, dtype=np.int64),
                np.asarray(coo.data, dtype=np.float64))
    if isinstance(J, dict):
        keys = np.array(list(J.keys()), dtype=np.int64).reshape(-1, 2)
        vals = np.array(list(J.values()), dtype=np.float64)
        return keys[:, 0], keys[:, 1], vals
    J = np.asarray(J)
    if J.ndim == 2 and J.shape == (nspins, nspins):
        rows, cols = np.nonzero(J)
        return (rows.astype(np.int64), cols.astype(np.int64),
                J[rows, cols].astype(np.float64))
    raise TypeError(f"Unsupported coupling container: {type(J)}")


def build_neighbor_table(nspins, rows, cols, vals, maxnb):
    """The (nspins, maxnb, 2) float64 neighbor table of COO triplets, with
    the semantics of tools.pyx:28-96: each stored pair (a, b) adds b to a's
    row and a to b's row, a diagonal entry lands once in its own row (a
    local field); [:, :, 0] is the neighbor index, [:, :, 1] the value, and
    unused slots stay (0, 0.0). Linear in the number of triplets. Raises
    ValueError when a spin has more than `maxnb` entries."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    nbs = np.zeros((nspins, maxnb, 2), dtype=np.float64)
    fill = np.zeros(nspins, dtype=np.int64)

    def _push(i, j, v):
        k = fill[i]
        if k >= maxnb:
            raise ValueError(
                f"spin {i} has more than maxnb={maxnb} neighbors; raise maxnb"
            )
        nbs[i, k, 0] = j
        nbs[i, k, 1] = v
        fill[i] = k + 1

    for a, b, v in zip(rows, cols, vals):
        if a == b:
            _push(a, a, v)
        else:
            _push(a, b, v)
            _push(b, a, v)
    return nbs


def generate_neighbors(nspins, J, maxnb, savepath=None):
    """Analog of tools.GenerateNeighbors (tools.pyx:28-96).

    J: a scipy sparse matrix, a dict {(i, j): val} or a dense (N, N) array,
    diagonal entries being local fields; maxnb: the most entries a spin
    has (a field counts as one); savepath: optional .npy path the table is
    also saved to (tools.pyx:94-95). Returns the (nspins, maxnb, 2) float64
    table of `build_neighbor_table`."""
    rows, cols, vals = _coo_from_any(J, nspins)
    nbs = build_neighbor_table(nspins, rows, cols, vals, maxnb)
    if savepath is not None:
        np.save(savepath, nbs)
    return nbs


def slot_sum(nbr_idx, nbr_J, x):
    """sum_k nbr_J[i, k] x[..., nbr_idx[i, k]] over the slots k of every
    row i, added in index order from slot 0."""
    xj = x[..., nbr_idx]  # (..., N, maxnb)
    f = nbr_J[:, 0] * xj[..., 0]
    for k in range(1, nbr_idx.shape[1]):
        f = f + nbr_J[:, k] * xj[..., k]
    return f


class IsingProblem(nn.Module):
    """Compiled Ising problem, an `nn.Module` whose tensors are buffers.

    nbr_idx:     (N, maxnb) int32, neighbor index per slot (self for
                 padding and for field slots).
    nbr_J:       (N, maxnb) float32, coupling per slot; zero for padding
                 and field slots (those are folded into h).
    h:           (N,) float32 local fields (the diagonal of J).
    colors:      (N,) int32 greedy color of each spin (`greedy_coloring`).
    color_masks: (num_colors, N) bool, colors[i] == c: a partition of the
                 spins into independent sets, the parallel stand-in for the
                 reference's sequential order (sa.pyx:71-79).
    nspins, maxnb, num_colors: Python ints.
    """

    def __init__(self, nbr_idx, nbr_J, h, colors, num_colors):
        super().__init__()
        self.register_buffer("nbr_idx", nbr_idx)
        self.register_buffer("nbr_J", nbr_J)
        self.register_buffer("h", h)
        self.register_buffer("colors", colors)
        self.register_buffer(
            "color_masks",
            colors[None, :] == torch.arange(num_colors, dtype=torch.int32,
                                            device=colors.device)[:, None])
        self.nspins, self.maxnb = (int(x) for x in nbr_idx.shape)
        self.num_colors = int(num_colors)

    # ---------------------------------------------------------- constructors
    @classmethod
    def from_neighbor_table(cls, nbs, device=None):
        """Build from a reference-format (N, maxnb, 2) neighbor table on
        `device` (None: the CUDA device)."""
        dev = _device.resolve(device)
        nbs = np.asarray(nbs)
        nspins = nbs.shape[0]
        idx = nbs[:, :, 0].astype(np.int64)
        val = nbs[:, :, 1].astype(np.float64)
        own = np.arange(nspins)[:, None]
        is_self = idx == own
        # padding slots are (0, 0.0): route them to "self" so the gathers
        # stay in the row
        is_pad = (val == 0.0) & (idx == 0) & (own != 0)
        h = np.where(is_self, val, 0.0).sum(axis=1)
        quad_val = np.where(is_self | is_pad, 0.0, val)
        quad_idx = np.where(is_self | is_pad, own, idx)
        colors, num_colors = greedy_coloring(quad_idx, quad_val)
        return cls(
            torch.as_tensor(quad_idx.astype(np.int32), device=dev),
            torch.as_tensor(quad_val.astype(np.float32), device=dev),
            torch.as_tensor(h.astype(np.float32), device=dev),
            torch.as_tensor(colors, device=dev),
            num_colors,
        )

    @classmethod
    def from_couplings(cls, nspins, J, maxnb, device=None):
        """Build straight from a sparse, dict or dense coupling container."""
        return cls.from_neighbor_table(generate_neighbors(nspins, J, maxnb),
                                       device=device)

    @classmethod
    def from_qubo(cls, Q, maxnb=None, device=None):
        """Build from a QUBO, minimize x^T Q x over x in {0,1}^n, with the
        bit <-> spin convention of tools.pyx:20-26 (bit 1 <-> spin -1),
        x = (1 - s) / 2. Returns (problem, offset) with
        x Q x = H(s) + offset."""
        Q = np.asarray(Q, dtype=np.float64)
        n = Q.shape[0]
        Q = (Q + Q.T) / 2.0  # symmetrize; off-diagonal pairs merge below
        rows_l, cols_l, vals_l = [], [], []
        h = np.zeros(n)
        offset = 0.0
        for i in range(n):
            qii = Q[i, i]
            # x_i = (1 - s_i)/2 -> qii x_i = qii/2 - (qii/2) s_i
            h[i] += -qii / 2.0
            offset += qii / 2.0
            for j in range(i + 1, n):
                qij = 2.0 * Q[i, j]  # symmetrized pair weight
                if qij == 0.0:
                    continue
                # qij x_i x_j = qij/4 (1 - s_i - s_j + s_i s_j)
                rows_l.append(i)
                cols_l.append(j)
                vals_l.append(qij / 4.0)
                h[i] += -qij / 4.0
                h[j] += -qij / 4.0
                offset += qij / 4.0
        for i in range(n):
            if h[i] != 0.0:
                rows_l.append(i)
                cols_l.append(i)
                vals_l.append(h[i])
        problem = cls.from_edges(
            n, np.array(rows_l, dtype=np.int64),
            np.array(cols_l, dtype=np.int64), np.array(vals_l), maxnb=maxnb,
            device=device,
        )
        return problem, float(offset)

    @classmethod
    def from_edges(cls, nspins, rows, cols, vals, maxnb=None, device=None):
        """Build from COO triplets (diagonal entries are local fields);
        maxnb=None takes the largest number of entries of a spin."""
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        if maxnb is None:
            deg = np.zeros(nspins, dtype=np.int64)
            off = rows != cols
            np.add.at(deg, rows[off], 1)
            np.add.at(deg, cols[off], 1)
            np.add.at(deg, rows[~off], 1)
            maxnb = int(deg.max()) if deg.size else 1
        return cls.from_neighbor_table(
            build_neighbor_table(nspins, rows, cols, vals, maxnb),
            device=device,
        )

    # ------------------------------------------------------------- energetics
    @property
    def device(self):
        return self.nbr_J.device

    def coupling_fields(self, spins):
        """sum_j J_ij s_j of every spin of (..., N) float spins, the slots
        summed in index order, as the kernels (csrc/packed.cuh) and the JAX
        package sum them."""
        return slot_sum(self.nbr_idx, self.nbr_J, spins.to(torch.float32))

    def local_fields(self, spins):
        """sum_j J_ij s_j + h_i of every spin of (..., N) float spins."""
        return self.coupling_fields(spins) + self.h

    def energy(self, spins):
        """H(s), batched over the leading dims of (..., N) spins."""
        s = spins.to(torch.float32)
        quad = self.coupling_fields(s)  # counts each edge twice
        return 0.5 * torch.sum(quad * s, dim=-1) + torch.sum(self.h * s,
                                                              dim=-1)

    def delta_e(self, spins):
        """dE of flipping each spin: -2 s_i (sum_j J_ij s_j + h_i)
        (sa.pyx:91-94)."""
        s = spins.to(torch.float32)
        return -2.0 * s * self.local_fields(s)


def classical_ising_energy(spins, J):
    """Analog of tools.ClassicalIsingEnergy (tools.pyx:99-118), in float64
    numpy: J may be scipy sparse or dense; off-diagonal stored entries
    count once, diagonal entries are local fields."""
    if hasattr(J, "todense"):
        J = np.asarray(J.todense())
    J = np.asarray(J, dtype=np.float64)
    s = np.asarray(spins, dtype=np.float64)
    d = np.diag(J).copy()
    Joff = J.copy()
    np.fill_diagonal(Joff, 0.0)
    return float(s @ (Joff @ s) + np.sum(d * s))
