"""PIQMC helpers shared by the engines (counterpart of
montecarlosolvers_tpu/ops/piqmc.py).

Ported so far: `spacetime_num_phases`, with which the full-plane PIQMC
engine (`ops/plane_kernels.py`) colors space-time, `sum_in_order`, the
line-move and bath sum over the Trotter axis of the PIQMC engines, and
`bath_matrix`, the dissipative engine's slice couplings. The generic
`local_sweep` / `global_line_moves` / `dissipative_local_sweep` on an
`IsingProblem` wait for the generic problem model (ROADMAP.md queue 1).
"""

from __future__ import annotations

import torch


def spacetime_num_phases(num_colors, slices):
    """Phase count m of the space-time coloring
    phase(i, k) = (spatial_color(i) + k) mod m (ops/piqmc.py:46).

    Spatial neighbours at one slice keep distinct colors mod m for
    m >= num_colors, Trotter neighbours (k, k+1) differ by 1 mod m, and the
    ring's wrap pair (P-1, 0) differs unless m divides P-1. With 2 spatial
    colors: m = 2 at even P, 3 at P = 3 and 5, 4 at P = 7."""
    m = max(2, num_colors)
    if slices > 1:
        while (slices - 1) % m == 0:
            m += 1
    return m


def sum_in_order(x, dim=-2):
    """Sum over the Trotter axis `dim` in index order. torch.sum would use
    its cascade order from 16 terms on; the kernels and the JAX code add
    the slices one after the other."""
    acc = x.select(dim, 0)
    for q in range(1, x.shape[dim]):
        acc = acc + x.select(dim, q)
    return acc


def bath_matrix(lookuptable, slices):
    """(P, P) float32 bath couplings on the table's device:
    M[k, k'] = lut[(k' - k) mod P - 1], zero diagonal (ops/piqmc.py:64).
    The offset is directed, as the reference indexes it (qmc.pyx:271); the
    tables of `schedules.bath_lookuptable` are symmetric in ring distance,
    but M is built exactly, not as a symmetric table. The bath field of
    slice k is sum_p M[k, p] s_p."""
    lut = torch.as_tensor(lookuptable, dtype=torch.float32)
    k = torch.arange(slices, device=lut.device)
    off = (k[None, :] - k[:, None]) % slices
    return torch.where(off > 0, lut[(off - 1).clamp(min=0)],
                       torch.zeros((), dtype=torch.float32,
                                   device=lut.device))
