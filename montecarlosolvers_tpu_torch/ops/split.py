"""Split-checkerboard state layout: weights, packing and energies.

Counterpart of `montecarlosolvers_tpu/ops/split.py` (the module docstring
there derives the layout). The state of an even-L lattice is stored as its
two checkerboard halves, each flattened to Nh = L*L/2 sites; one Metropolis
phase updates one entire half from the other with no masks. Site j of one
color has its four lattice neighbours at flat offsets {0, +1, -1, +K, -K}
(K = L/2) of the opposite half, weighted per slot; periodic rows add two
row-wrap slots at +/-(K-1).

For PIQMC at even P the state is four quarter arrays, each (..., P/2, Nh):

    xe[q] = slice 2q,   color A        ye[q] = slice 2q,   color B
    xo[q] = slice 2q+1, color B        yo[q] = slice 2q+1, color A

The sweeps themselves live in `ops/split_kernels.py`, beside their CUDA
kernels.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from montecarlosolvers_tpu_torch import _roadmap


def require_split(problem):
    """Raise NotImplementedError unless `problem` is an even-L lattice, the
    only problem the split-checkerboard engine (and the port) takes yet."""
    from montecarlosolvers_tpu_torch.models.lattice import LatticeProblem

    if not (isinstance(problem, LatticeProblem) and problem.L % 2 == 0):
        raise _roadmap.not_ported(
            "a problem other than a LatticeProblem with even L",
            _roadmap.GENERIC_GRAPHS,
        )


@dataclasses.dataclass(frozen=True)
class SplitLattice:
    """Split-layout weights of one LatticeProblem, on the problem's device.

    w_ab: (5 or 7, 2, Nh) float32 weights; axis 0 is the offset slot
      (see `spatial_field`), axis 1 the site color (0 = A = parity 0,
      1 = B).
    h_ab: (2, Nh) float32 local fields per color.
    idx_a / idx_b: (Nh,) int64 flat lattice indices of each color's sites.
    inv_perm: (N,) int64 permutation that unpacks cat([a, b]).
    """

    w_ab: torch.Tensor
    h_ab: torch.Tensor
    idx_a: torch.Tensor
    idx_b: torch.Tensor
    inv_perm: torch.Tensor
    L: int
    col_wrap: bool

    @property
    def K(self):
        return self.L // 2

    @property
    def nh(self):
        return self.L * self.L // 2

    @property
    def nslots(self):
        return int(self.w_ab.shape[0])


def _color_indices(L):
    """(idx, cols) for both colors: idx[c] is the (L, K) flat lattice index
    plane of color c sites, cols[c] the matching column plane."""
    K = L // 2
    rows = np.arange(L)[:, None]
    ks = np.arange(K)[None, :]
    out_idx, out_cols = [], []
    for color in (0, 1):
        cols = 2 * ks + (rows + color) % 2  # (L, K)
        out_idx.append(rows * L + cols)
        out_cols.append(cols)
    return out_idx, out_cols


def build_split(problem):
    """Build the SplitLattice of a LatticeProblem (same slot values as the
    JAX `build_split`, exactly: every weight is a copied coupling or 0)."""
    L = problem.L
    if L % 2:
        raise ValueError("split layout requires even L")
    dev = problem.device
    idxs, colss = _color_indices(L)
    rows = torch.arange(L, device=dev)[:, None]

    def at(plane, r, c):
        return plane[r, torch.as_tensor(c, device=dev)]

    ws, hs = [], []
    for color in (0, 1):
        cols = colss[color]
        even = torch.as_tensor(cols % 2 == 0, device=dev)
        jr_right = at(problem.j_right, rows, cols)  # bond to (r, col+1)
        jr_left = at(problem.j_right, rows, (cols - 1) % L)  # to (r, col-1)
        # even col: right neighbour shares the flat index (offset 0), left
        # neighbour is at -1; odd col: right at +1, left at offset 0
        w0 = torch.where(even, jr_right, jr_left)
        wp = torch.where(even, 0.0, jr_right)
        wm = torch.where(even, jr_left, 0.0)
        wd = at(problem.j_down, rows, cols)
        wu = at(problem.j_down, (rows - 1) % L, cols)
        slots = [w0, wp, wm, wd, wu]
        if problem.col_wrap:
            # the flat +/-1 rolls graze the row boundary at col L-1 / 0;
            # those row-wrap bonds move to the +/-(K-1) correction slots
            graze_p = torch.as_tensor(cols == L - 1, device=dev)
            graze_m = torch.as_tensor(cols == 0, device=dev)
            slots = [
                w0,
                torch.where(graze_p, 0.0, wp),
                torch.where(graze_m, 0.0, wm),
                wd,
                wu,
                torch.where(graze_p, wp, 0.0),
                torch.where(graze_m, wm, 0.0),
            ]
        ws.append(torch.stack([w.reshape(-1) for w in slots]))
        hs.append(at(problem.h_plane, rows, cols).reshape(-1))

    idx_a = idxs[0].reshape(-1)
    idx_b = idxs[1].reshape(-1)
    inv = np.argsort(np.concatenate([idx_a, idx_b]))
    return SplitLattice(
        w_ab=torch.stack(ws, dim=1).to(torch.float32).contiguous(),
        h_ab=torch.stack(hs).to(torch.float32).contiguous(),
        idx_a=torch.as_tensor(idx_a, device=dev),
        idx_b=torch.as_tensor(idx_b, device=dev),
        inv_perm=torch.as_tensor(inv, device=dev),
        L=L,
        col_wrap=problem.col_wrap,
    )


def spatial_field(w, o, K):
    """Weighted neighbour sum over the opposite half `o` (..., Nh); `w` is
    (5|7, Nh) for one color. Slot k reads o at these flat offsets, mod Nh:

        slot 0: o[j]       slot 1: o[j+1]      slot 2: o[j-1]
        slot 3: o[j+K]     slot 4: o[j-K]
        slot 5: o[j-(K-1)] slot 6: o[j+(K-1)]   (row wrap, col_wrap only)

    (`torch.roll(o, s)[j] = o[j-s]`.) The slots are summed in this order,
    as `_spatial_field` (ops/split.py:161) sums them: every product w*(+/-1)
    is exact, so the order alone fixes the float32 result, and the CUDA
    kernels sum in the same order."""
    f = (
        w[0] * o
        + w[1] * torch.roll(o, -1, dims=-1)
        + w[2] * torch.roll(o, 1, dims=-1)
        + w[3] * torch.roll(o, -K, dims=-1)
        + w[4] * torch.roll(o, K, dims=-1)
    )
    if w.shape[0] > 5:
        f = f + w[5] * torch.roll(o, K - 1, dims=-1)
        f = f + w[6] * torch.roll(o, -(K - 1), dims=-1)
    return f


# --------------------------------------------------------------- classical SA


def pack_classical(sl, spins):
    """(..., N) -> (a, b) halves (..., Nh), contiguous."""
    return spins[..., sl.idx_a], spins[..., sl.idx_b]


def unpack_classical(sl, a, b):
    """Inverse of `pack_classical`."""
    return torch.cat([a, b], dim=-1)[..., sl.inv_perm]


def classical_energy_split(sl, a, b):
    """H = sum_bonds J s s + sum h s on split halves. Every lattice bond
    joins opposite colors, so sum_A s_A * spatial_field_A counts each bond
    exactly once."""
    f = spatial_field(sl.w_ab[:, 0], b, sl.K)
    return (
        torch.sum(a * f, dim=-1)
        + torch.sum(sl.h_ab[0] * a, dim=-1)
        + torch.sum(sl.h_ab[1] * b, dim=-1)
    )


# --------------------------------------------------------------------- PIQMC


def pack_qmc(sl, confs):
    """(..., P, N) -> (xe, xo, ye, yo), each (..., P/2, Nh), contiguous."""
    slices = confs.shape[-2]
    if slices % 2:
        raise ValueError("split PIQMC layout requires even P")
    a = confs[..., sl.idx_a]  # (..., P, Nh)
    b = confs[..., sl.idx_b]
    return (
        a[..., 0::2, :].contiguous(),  # xe: A at even slices
        b[..., 1::2, :].contiguous(),  # xo: B at odd slices
        b[..., 0::2, :].contiguous(),  # ye
        a[..., 1::2, :].contiguous(),  # yo
    )


def unpack_qmc(sl, xe, xo, ye, yo):
    """Inverse of `pack_qmc`: (..., P, N)."""
    half = xe.shape[-2]
    shape = xe.shape[:-2] + (2 * half, sl.nh)
    na = torch.stack([xe, yo], dim=-2).reshape(shape)
    nb = torch.stack([ye, xo], dim=-2).reshape(shape)
    return torch.cat([na, nb], dim=-1)[..., sl.inv_perm]


def qmc_slice_energies_split(sl, xe, xo, ye, yo):
    """Classical energy of every Trotter slice, (..., P), from the split
    state (the benchmark readout, examples/santoro80.py:290-296)."""
    wa = sl.w_ab[:, 0]
    ha, hb = sl.h_ab[0], sl.h_ab[1]
    e_even = (
        torch.sum(xe * spatial_field(wa, ye, sl.K), dim=-1)
        + torch.sum(ha * xe, dim=-1)
        + torch.sum(hb * ye, dim=-1)
    )
    e_odd = (
        torch.sum(yo * spatial_field(wa, xo, sl.K), dim=-1)
        + torch.sum(ha * yo, dim=-1)
        + torch.sum(hb * xo, dim=-1)
    )
    e = torch.stack([e_even, e_odd], dim=-1)  # (..., P/2, 2)
    return e.reshape(e.shape[:-2] + (e.shape[-2] * 2,))
