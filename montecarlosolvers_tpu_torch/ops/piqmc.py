"""PIQMC helpers shared by the engines (counterpart of
montecarlosolvers_tpu/ops/piqmc.py).

Ported: `spacetime_num_phases`, with which the full-plane and generic
PIQMC engines color space-time, `slice_color_masks`, `sum_in_order`, the
line-move and bath sum over the Trotter axis of the PIQMC engines,
`bath_matrix`, the dissipative engine's slice couplings, and the generic
`local_sweep` / `global_line_moves` on an IsingProblem as plain PyTorch
(the plain version of `csrc/generic_qmc.cu`, run on the packed problem by
`ops/generic_kernels.py`), and the dissipative `dissipative_local_sweep` /
`dissipative_colored_sweep` with `bath_fields` (the plain versions of
`csrc/generic_qmc_bath.cu`) on an IsingProblem or a LatticeProblem. They
take their uniforms as an argument and J_perp precomputed
(`schedules.jperp`), as the kernels take them.

The bath field of slice k is sum_p M[k, p] s_p added in index order from
p = 0, as kernel 5 and the JAX slice-sequential sweep add it. The JAX
colored sweep contracts the whole (P, P) matrix in one einsum, which XLA's
CPU dot adds in another order from P = 4 on (ROADMAP.md queue 3); the port
keeps the index order there too.
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


def bath_matrix_of(lookuptable, slices, device):
    """The contiguous (P, P) `bath_matrix` of a (P-1,) `lookuptable` (numpy
    or a tensor, taken as float32 on `device`), once the table is known to
    fit P = `slices` >= 2; raises ValueError otherwise."""
    if slices < 2:
        raise ValueError(f"the bath engine takes P >= 2 slices, got {slices}")
    if not torch.is_tensor(lookuptable):  # a copy: it may be read-only
        lookuptable = np.array(lookuptable, dtype=np.float32)
    lut = torch.as_tensor(lookuptable, dtype=torch.float32, device=device)
    if tuple(lut.shape) != (slices - 1,):
        raise ValueError(f"lookuptable has shape {tuple(lut.shape)}, "
                         f"expected ({slices - 1},) at P = {slices}")
    return bath_matrix(lut, slices).contiguous()


def bath_fields(bath_mat, confs):
    """(..., P, N) bath fields of every slice of (..., P, N) confs:
    sum_p M[k, p] s_p, p added in index order from 0. Each product with a
    spin is exact, so the order alone fixes the float32 result."""
    acc = bath_mat[:, 0, None] * confs[..., 0:1, :]
    for p in range(1, confs.shape[-2]):
        acc = acc + bath_mat[:, p, None] * confs[..., p:p + 1, :]
    return acc


def _bath_terms(confs, teff, b):
    """(T_eff, 2 T_eff as float32 tensors, -2B): what the dissipative dE
    reads. 2 * T_eff is a Python double rounded to float32, as the JAX code
    rounds it where it meets the spins."""
    two_teff = torch.tensor(2.0 * teff, dtype=torch.float32,
                            device=confs.device)
    return _teff32(teff, confs), two_teff, -2.0 * b


def dissipative_local_sweep(problem, confs, u, teff, jp, b, bath_mat):
    """The slice-sequential dissipative sweep (JAX `dissipative_local_sweep`,
    ops/piqmc.py:110; qmc.pyx:149-278): slices k = 0..P-1 in order; at the
    start of slice k its bath field (`bath_mat` row k against the state as
    it stands) and Trotter sums are taken, then each color class c of the
    slice flips its accepted sites on

        dE = (-2B s) f + (2 s J_perp)(s[k-1] + s[k+1]) + (2 T_eff s) bath,

    added left to right, the field f of the slice as it stands at the start
    of the class's phase.

    confs: (..., P, N) float32 +/-1, P >= 2; u: uniforms of the same shape
    (the classes partition each slice); teff: T_eff = P*T, a Python float;
    jp, b: float32 tensors; bath_mat: the (P, P) `bath_matrix`. Returns the
    new confs."""
    slices = confs.shape[-2]
    t32, two_teff, b_coeff = _bath_terms(confs, teff, b)
    confs = confs.clone()  # slices are written in place below
    for k in range(slices):
        s_k = confs[..., k, :]
        tr = confs[..., (k - 1) % slices, :] + confs[..., (k + 1) % slices, :]
        bath = sum_in_order(bath_mat[k][:, None] * confs, dim=-2)
        for c in range(problem.num_colors):
            de = (b_coeff * s_k * problem.local_fields(s_k)
                  + 2.0 * s_k * jp * tr + two_teff * s_k * bath)
            accept = (metropolis_accept(de, t32, u[..., k, :])
                      & problem.color_masks[c])
            s_k = torch.where(accept, -s_k, s_k)
        confs[..., k, :] = s_k
    return confs


def dissipative_colored_sweep(problem, confs, u, teff, jp, b, bath_mat):
    """The space-time colored dissipative sweep (JAX
    `dissipative_colored_sweep`, ops/piqmc.py:152), the fast approximate
    form: phase p flips the accepted sites with (color(i) + k) mod m == p,
    m = spacetime_num_phases(C, P), every field, Trotter sum and bath field
    (`bath_fields`) of the phase taken from the state at its start; dE as
    in `dissipative_local_sweep`. Arguments as there."""
    slices = confs.shape[-2]
    t32, two_teff, b_coeff = _bath_terms(confs, teff, b)
    m = spacetime_num_phases(problem.num_colors, slices)
    k = torch.arange(slices, device=confs.device)[:, None]
    stc = (problem.colors[None, :] + k) % m  # (P, N)
    for p in range(m):
        tr = torch.roll(confs, 1, dims=-2) + torch.roll(confs, -1, dims=-2)
        de = (b_coeff * confs * problem.local_fields(confs)
              + 2.0 * confs * jp * tr
              + two_teff * confs * bath_fields(bath_mat, confs))
        accept = metropolis_accept(de, t32, u) & (stc == p)
        confs = torch.where(accept, -confs, confs)
    return confs
