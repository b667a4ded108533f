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


def _plane(x, device):
    """A float32 tensor of a plane; numpy input is copied (it may be a
    read-only view of a JAX array)."""
    if not torch.is_tensor(x):
        x = np.array(x, dtype=np.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


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
    """

    def __init__(self, j_right, j_down, h_plane, col_wrap):
        super().__init__()
        self.register_buffer("j_right", j_right)
        self.register_buffer("j_down", j_down)
        self.register_buffer("h_plane", h_plane)
        self.L = int(j_right.shape[0])
        self.col_wrap = bool(col_wrap)

    @classmethod
    def from_planes(cls, j_right, j_down, h=None, col_wrap=None, device=None):
        """Build from (L, L) coupling planes (numpy arrays or tensors).
        col_wrap is detected from the wrap column when not given."""
        j_right = _plane(j_right, device)
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
        """Build from COO triplets over row-major spin indices. Raises if an
        edge is not a lattice right/down/wrap/field bond."""
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
