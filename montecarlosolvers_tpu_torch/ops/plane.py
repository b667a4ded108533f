"""Full-plane lattice layout: coupling planes and the neighbour sum.

Counterpart of `montecarlosolvers_tpu/ops/pallas_sa.py::padded_planes`
(:80) and `_neighbor_sums` (:136), and of `pallas_qmc.py::_nbsum4` (:54).
The state is the lattice itself, (..., L, L) float32 +/-1, and a phase
updates the sites of one color of the whole plane. The Pallas kernels pad
each plane to (pad8(L), pad128(L)) for the TPU's tiles and patch the
toroidal wrap bonds back in with masked correction rolls (`row_wrap`,
`col_wrap`). On the L x L plane `torch.roll` wraps by itself, and an open
boundary has zero wrap couplings, so neither the padding nor the
correction rolls are needed; only the site ids keep the padded strides
(`counter_rng.plane_uids`).

The sweeps live in `ops/plane_kernels.py`, beside their CUDA kernels.
"""

from __future__ import annotations

import dataclasses

import torch

from montecarlosolvers_tpu_torch.ops import counter_rng as cr


@dataclasses.dataclass(frozen=True)
class PlaneLattice:
    """Coupling planes of one LatticeProblem, on the problem's device.

    w: (5, L, L) float32, contiguous, the planes jr, jl, jd, ju, h:
      jr[r, c] couples (r, c) to its right neighbour (r, c+1 mod L),
      jl[r, c] = jr[r, c-1 mod L] to its left one, jd / ju likewise down
      and up, h the local field (pallas_sa.py:99-106).
    """

    w: torch.Tensor

    @property
    def L(self):
        return int(self.w.shape[-1])

    @property
    def strides(self):
        """(R, C) of the Pallas kernels' padded planes, for the site ids."""
        return cr.plane_strides(self.L)


def build_plane(problem):
    """The PlaneLattice of a LatticeProblem (any L, open or periodic); every
    plane is a copy of the problem's couplings, so no value changes."""
    jr, jd = problem.j_right, problem.j_down
    jl = torch.roll(jr, 1, dims=1)
    ju = torch.roll(jd, 1, dims=0)
    w = torch.stack([jr, jl, jd, ju, problem.h_plane]).to(torch.float32)
    return PlaneLattice(w=w.contiguous())


def parity(L, device):
    """(L, L) int64 checkerboard color (r + c) % 2 of each site."""
    r = torch.arange(L, device=device)
    return (r[:, None] + r[None, :]) % 2


def neighbor_sum(pl, s):
    """sum_nb J s_nb + h on (..., L, L) states (spins, or cos of rotor
    angles), added in the Pallas order jr*right + jl*left + jd*down +
    ju*up + h (pallas_sa.py:153, pallas_svmc.py:53). The CUDA kernels add
    in the same order with every product and sum rounded on its own. On
    spins every product J*(+/-1) is exact, so the order alone fixes the
    float32 result; on cos values the products round too."""
    jr, jl, jd, ju, h = pl.w
    return (jr * torch.roll(s, -1, dims=-1)
            + jl * torch.roll(s, 1, dims=-1)
            + jd * torch.roll(s, -1, dims=-2)
            + ju * torch.roll(s, 1, dims=-2)
            + h)


def plane_energy(pl, s):
    """H(s) = sum_bonds J s s + sum h s of (..., L, L) spin planes, (...,)
    float32: the plane form of `LatticeProblem.energy`, summed in its
    order. Each site adds its right and down bonds (jr, jd; the wrap bonds
    of a torus included, so an odd torus counts each once) and its field."""
    jr, _, jd, _, h = pl.w
    e = torch.sum(jr * s * torch.roll(s, -1, dims=-1), dim=(-1, -2))
    e = e + torch.sum(jd * s * torch.roll(s, -1, dims=-2), dim=(-1, -2))
    return e + torch.sum(h * s, dim=(-1, -2))
