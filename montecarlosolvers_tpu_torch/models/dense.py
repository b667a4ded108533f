"""Dense (fully-connected) Ising problems.

Counterpart of `montecarlosolvers_tpu/models/dense.py`. For a dense
coupling matrix (Sherrington-Kirkpatrick-class) the padded neighbor table
degenerates (maxnb = N - 1), and so does the coloring (a complete graph
needs N colors, a fully sequential sweep). The engine for it is another
one: the fields of a block of B spins are one (chains, N) x (N, B) matrix
product, and the block's B spins then update one at a time with rank-1
delayed updates of the remaining in-block fields (`ops/dense_sweep.py`,
`ops/dense_kernels.py`): the reference's sequential Metropolis sweep in
systematic-scan order (sa.pyx:81-99).

The field and energy products here are `torch.matmul`, as the JAX package
leaves its `jnp.einsum` to XLA: no kernel of the port computes them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from montecarlosolvers_tpu_torch import _device


@dataclasses.dataclass(frozen=True, eq=False)
class DenseProblem:
    """Fully-connected Ising problem.

    J: (N, N) float32, symmetric with a zero diagonal: each undirected
       coupling is stored in BOTH halves, so H(s) = 1/2 s J s + h s counts
       each pair once (IsingProblem's convention).
    h: (N,) float32 local fields.
    """

    J: torch.Tensor
    h: torch.Tensor

    @property
    def nspins(self):
        return int(self.h.shape[0])

    @property
    def device(self):
        return self.J.device

    @classmethod
    def _of(cls, J, h, device):
        dev = _device.resolve(device)
        return cls(J=torch.as_tensor(np.asarray(J, np.float32), device=dev),
                   h=torch.as_tensor(np.asarray(h, np.float32), device=dev))

    @classmethod
    def from_couplings(cls, J, h=None, device=None):
        """Build from a dense matrix in either storage convention:

        * an already-symmetric J (both halves stored, pair weight J_ij) is
          kept as it is;
        * otherwise (upper-triangular or any full storage) each stored
          entry counts once: J_sym = J + J^T.

        The diagonal always moves into h. On `device` (None: the CUDA
        device)."""
        J = np.asarray(J, dtype=np.float64)
        n = J.shape[0]
        d = np.diag(J).copy()
        Joff = J.copy()
        np.fill_diagonal(Joff, 0.0)
        Js = Joff if np.allclose(Joff, Joff.T) else Joff + Joff.T
        hv = d + (np.zeros(n) if h is None else np.asarray(h, np.float64))
        return cls._of(Js, hv, device)

    @classmethod
    def from_edges(cls, nspins, rows, cols, vals, device=None):
        """Build from COO triplets: an off-diagonal entry lands in both
        halves, a diagonal one in h; repeated entries add."""
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals, dtype=np.float64)
        J = np.zeros((nspins, nspins))
        h = np.zeros(nspins)
        off = rows != cols
        np.add.at(J, (rows[off], cols[off]), vals[off])
        np.add.at(J, (cols[off], rows[off]), vals[off])
        np.add.at(h, rows[~off], vals[~off])
        return cls._of(J, h, device)

    # ------------------------------------------------------------ interface
    def coupling_fields(self, spins):
        """sum_j J_ij s_j of (..., N) spins, one matrix product."""
        return torch.matmul(spins.to(torch.float32), self.J)

    def local_fields(self, spins):
        """sum_j J_ij s_j + h_i of (..., N) spins."""
        return self.coupling_fields(spins) + self.h

    def energy(self, spins):
        """H(s), batched over the leading dims of (..., N) spins."""
        s = spins.to(torch.float32)
        f = self.coupling_fields(s)
        return 0.5 * torch.sum(f * s, dim=-1) + torch.sum(self.h * s, dim=-1)

    def delta_e(self, spins):
        """dE of flipping each spin: -2 s_i (sum_j J_ij s_j + h_i)."""
        s = spins.to(torch.float32)
        return -2.0 * s * self.local_fields(s)
