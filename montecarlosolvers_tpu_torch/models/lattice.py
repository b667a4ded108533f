"""2D lattice Ising problems with per-direction coupling planes.

Counterpart of `montecarlosolvers_tpu/models/lattice.py::LatticeProblem`.
Here the problem is an `nn.Module` whose coupling planes are buffers, so
`problem.to(device)` moves it. Spin index i = r*L + c, as in the triplet
files (examples/santoro80.py:242-244); states are flat (..., L*L) float32
tensors of +/-1.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from montecarlosolvers_tpu_torch import _device


def _plane(x, device):
    """A float32 tensor of a plane; numpy input is copied (it may be a
    read-only view of a JAX array)."""
    if not torch.is_tensor(x):
        x = np.array(x, dtype=np.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def checkerboard_masks(L):
    """(2, L*L) bool numpy checkerboard, (r + c) % 2 == color: the lattice's
    two color classes (a proper coloring on open and even lattices; see
    ROADMAP.md queue 3 for an odd torus)."""
    r = np.arange(L)[:, None]
    c = np.arange(L)[None, :]
    par = ((r + c) % 2).reshape(-1)
    return np.stack([par == 0, par == 1])


class LatticeProblem(nn.Module):
    """2D lattice Ising problem, H(s) = sum_bonds J s s + sum_i h_i s_i.

    Buffers (float32, (L, L)):
      j_right[r, c]: coupling between (r, c) and (r, c+1 mod L); the wrap
        column is zero for open boundaries.
      j_down[r, c]:  coupling between (r, c) and (r+1 mod L, c).
      h_plane[r, c]: local field.
    col_wrap: True iff any horizontal wrap coupling j_right[:, -1] is
      nonzero; the split-checkerboard engine then needs its two row-wrap
      stencil slots.
    colors / color_masks / num_colors: the checkerboard, the IsingProblem
      interface of the masked sweeps (JAX `LatticeProblem.color_masks`).
    """

    num_colors = 2

    def __init__(self, j_right, j_down, h_plane, col_wrap):
        super().__init__()
        self.register_buffer("j_right", j_right)
        self.register_buffer("j_down", j_down)
        self.register_buffer("h_plane", h_plane)
        self.L = int(j_right.shape[0])
        self.col_wrap = bool(col_wrap)

    @classmethod
    def from_planes(cls, j_right, j_down, h=None, col_wrap=None, device=None):
        """Build from (L, L) coupling planes (numpy arrays or tensors) on
        `device` (None: the CUDA device). col_wrap is detected from the wrap
        column when not given."""
        j_right = _plane(j_right, _device.resolve(device))
        j_down = _plane(j_down, j_right.device)
        L = j_right.shape[0]
        if h is None:
            h = torch.zeros((L, L), dtype=torch.float32, device=j_right.device)
        h = _plane(h, j_right.device)
        if col_wrap is None:
            col_wrap = bool((j_right[:, -1] != 0.0).any())
        return cls(j_right, j_down, h, col_wrap)

    @classmethod
    def from_edges(cls, L, rows, cols, vals, device=None):
        """Build from COO triplets over row-major spin indices, on `device`
        (None: the CUDA device). Raises if an edge is not a lattice
        right/down/wrap/field bond."""
        jr = np.zeros((L, L))
        jd = np.zeros((L, L))
        h = np.zeros((L, L))
        for a, b, v in zip(np.asarray(rows), np.asarray(cols), np.asarray(vals)):
            a, b = int(a), int(b)
            lo, hi = min(a, b), max(a, b)
            r, c = divmod(lo, L)
            if a == b:
                h[r, c] += v
            elif hi - lo == 1 and c + 1 < L:
                jr[r, c] += v
            elif hi - lo == L:
                jd[r, c] += v
            elif hi - lo == L - 1 and divmod(hi, L)[0] == r:
                jr[r, L - 1] += v  # periodic wrap in the row
            elif hi - lo == L * (L - 1):
                jd[L - 1, c] += v  # periodic wrap in the column
            else:
                raise ValueError(f"edge ({a},{b}) is not a 2D-lattice bond")
        return cls.from_planes(jr, jd, h, device=device)

    # ------------------------------------------------------------ interface
    @property
    def nspins(self):
        return self.L * self.L

    @property
    def device(self):
        return self.j_right.device

    @property
    def color_masks(self):
        """(2, L*L) bool checkerboard on the lattice's device."""
        return torch.as_tensor(checkerboard_masks(self.L), device=self.device)

    @property
    def colors(self):
        """(L*L,) int32 parity (r + c) % 2 of each site."""
        return self.color_masks[1].to(torch.int32)

    def _planes(self, s):
        return s.to(torch.float32).reshape(s.shape[:-1] + (self.L, self.L))

    def local_fields(self, s):
        """sum_nb J s_nb + h for flat spins s: (..., L*L)."""
        sp = self._planes(s)
        j_left = torch.roll(self.j_right, 1, dims=-1)
        j_up = torch.roll(self.j_down, 1, dims=-2)
        f = self.j_right * torch.roll(sp, -1, dims=-1)
        f = f + j_left * torch.roll(sp, 1, dims=-1)
        f = f + self.j_down * torch.roll(sp, -1, dims=-2)
        f = f + j_up * torch.roll(sp, 1, dims=-2)
        f = f + self.h_plane
        return f.reshape(s.shape)

    def energy(self, s):
        """H(s) over flat (..., L*L) states; returns (...,) float32."""
        sp = self._planes(s)
        e = torch.sum(self.j_right * sp * torch.roll(sp, -1, dims=-1),
                      dim=(-1, -2))
        e = e + torch.sum(self.j_down * sp * torch.roll(sp, -1, dims=-2),
                          dim=(-1, -2))
        return e + torch.sum(self.h_plane * sp, dim=(-1, -2))

    def delta_e(self, s):
        """dE of flipping each spin of flat (..., L*L) states:
        -2 s (J s + h)."""
        s = s.to(torch.float32)
        return -2.0 * s * self.local_fields(s)

    def to_generic(self, maxnb=None):
        """The same problem as a padded-gather IsingProblem on the
        lattice's device (JAX `LatticeProblem.to_generic`): every nonzero
        right, down and field entry in row-major order, maxnb 5 unless
        given, greedy-colored."""
        from montecarlosolvers_tpu_torch.models.ising import IsingProblem

        L = self.L
        jr, jd, h = (x.cpu().numpy() for x in (self.j_right, self.j_down,
                                               self.h_plane))
        rows, cols, vals = [], [], []
        for r in range(L):
            for c in range(L):
                i = r * L + c
                if jr[r, c] != 0.0:
                    rows.append(i)
                    cols.append(r * L + (c + 1) % L)
                    vals.append(jr[r, c])
                if jd[r, c] != 0.0:
                    rows.append(i)
                    cols.append(((r + 1) % L) * L + c)
                    vals.append(jd[r, c])
                if h[r, c] != 0.0:
                    rows.append(i)
                    cols.append(i)
                    vals.append(h[r, c])
        return IsingProblem.from_edges(
            L * L, np.array(rows), np.array(cols), np.array(vals),
            maxnb=maxnb if maxnb is not None else 5, device=self.device,
        )
