"""PIQMC helpers shared by the engines (counterpart of
montecarlosolvers_tpu/ops/piqmc.py).

Ported: `spacetime_num_phases`, with which the full-plane and generic
PIQMC engines color space-time, `slice_color_masks`, `sum_in_order`, the
line-move and bath sum over the Trotter axis of the PIQMC engines,
`bath_matrix`, the dissipative engine's slice couplings, and the generic
`local_sweep` / `global_line_moves` on an IsingProblem as plain PyTorch
(the plain version of `csrc/generic_qmc.cu`, run on the packed problem by
`ops/generic_kernels.py`). They take their uniforms as an argument and
J_perp precomputed (`schedules.jperp`), as the kernels take them.
`dissipative_local_sweep` / `dissipative_colored_sweep` on an IsingProblem
wait for the bath item (ROADMAP.md queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

from montecarlosolvers_tpu_torch.models.coloring import ring_coloring
from montecarlosolvers_tpu_torch.ops.metropolis import metropolis_accept


def slice_color_masks(slices):
    """(num_ring_colors, P) bool numpy masks of the Trotter ring's
    coloring, and their count."""
    colors, n = ring_coloring(slices)
    return np.arange(n)[:, None] == colors[None, :], n


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


def _teff32(teff, like):
    return torch.tensor(teff, dtype=torch.float32, device=like.device)


def local_sweep(problem, confs, u, teff, jp, b, num_phases=None):
    """One space-time colored local sweep (JAX `local_sweep`,
    ops/piqmc.py:79): phase p flips the accepted sites with
    (color(i) + k) mod m == p, m = spacetime_num_phases(C, P), on

        dE = (-2B s) f + (2 s J_perp)(s[k-1] + s[k+1])   (ring mod P).

    confs: (..., P, N) float32 +/-1; u: uniforms of the same shape (the
    phases partition the sites); teff: T_eff = P*T, a Python float; jp:
    J_perp (`schedules.jperp`) and b: B, float32 tensors."""
    slices = confs.shape[-2]
    t32 = _teff32(teff, confs)
    b_coeff = -2.0 * b
    m = num_phases or spacetime_num_phases(problem.num_colors, slices)
    k = torch.arange(slices, device=confs.device)[:, None]
    stc = (problem.colors[None, :] + k) % m  # (P, N)
    for p in range(m):
        field = problem.local_fields(confs)
        s_up = torch.roll(confs, 1, dims=-2)
        s_dn = torch.roll(confs, -1, dims=-2)
        de = b_coeff * confs * field + 2.0 * confs * jp * (s_up + s_dn)
        accept = metropolis_accept(de, t32, u) & (stc == p)
        confs = torch.where(accept, -confs, confs)
    return confs


def global_line_moves(problem, confs, u, teff, b):
    """Whole-line flips, one color class of lines at a time (JAX
    `global_line_moves`, ops/piqmc.py:193): a line's dE is
    sum_k (-2B s_k) f_k in slice order (the J_perp terms cancel).

    confs: (..., P, N); u: (..., N) uniforms, one per line; teff: Python
    float; b: float32 tensor."""
    t32 = _teff32(teff, confs)
    b_coeff = -2.0 * b
    for c in range(problem.num_colors):
        field = problem.local_fields(confs)
        de = sum_in_order(b_coeff * confs * field, dim=-2)
        accept = metropolis_accept(de, t32, u) & problem.color_masks[c]
        confs = torch.where(accept[..., None, :], -confs, confs)
    return confs
