"""Carry the JAX package's problems and states across into the port.

Each function takes numpy arrays (for example `np.asarray(jax_lat.j_right)`)
and returns the port's objects on `device` (None: the CUDA device), so the
two packages compute on the same inputs. States, spins or SVMC rotor angles alike, are
plain arrays and cross as numpy through `state_from_numpy`, so SVMC needs
no converter of its own; a bath lookuptable crosses through
`lookuptable_from_numpy`, the JAX package's generic IsingProblem
through `ising_from_arrays` and its DenseProblem through
`dense_from_arrays`.
"""

from __future__ import annotations

import numpy as np
import torch

from montecarlosolvers_tpu_torch import _device
from montecarlosolvers_tpu_torch.models.dense import DenseProblem
from montecarlosolvers_tpu_torch.models.ising import IsingProblem
from montecarlosolvers_tpu_torch.models.lattice import LatticeProblem


def lattice_from_arrays(j_right, j_down, h_plane, col_wrap=None, device=None):
    """The port's LatticeProblem from the JAX LatticeProblem's planes.
    Pass the JAX problem's `col_wrap` to keep its stencil slot count."""
    return LatticeProblem.from_planes(
        np.asarray(j_right, dtype=np.float32),
        np.asarray(j_down, dtype=np.float32),
        np.asarray(h_plane, dtype=np.float32),
        col_wrap=col_wrap,
        device=device,
    )


def ising_from_arrays(nbr_idx, nbr_J, h, color_masks, device=None):
    """The port's IsingProblem from the JAX IsingProblem's arrays (as
    numpy: `np.asarray(jax_problem.nbr_idx)` and so on), on `device` (None:
    the CUDA device). The table, the fields and the coloring cross as they
    are, so both packages compute on the same problem, class for class."""
    dev = _device.resolve(device)
    masks = np.asarray(color_masks, dtype=bool)
    if not (masks.sum(axis=0) == 1).all():
        raise ValueError("color_masks must put every spin in one class")
    colors = np.argmax(masks, axis=0).astype(np.int32)
    return IsingProblem(
        torch.as_tensor(np.array(nbr_idx, dtype=np.int32), device=dev),
        torch.as_tensor(np.array(nbr_J, dtype=np.float32), device=dev),
        torch.as_tensor(np.array(h, dtype=np.float32), device=dev),
        torch.as_tensor(colors, device=dev),
        masks.shape[0],
    )


def dense_from_arrays(J, h, device=None):
    """The port's DenseProblem from the JAX DenseProblem's arrays
    (`np.asarray(jax_problem.J)`, `np.asarray(jax_problem.h)`), on
    `device` (None: the CUDA device): the float32 matrix and fields cross
    bitwise, in the storage convention they already have (both halves,
    zero diagonal), so `DenseProblem.from_couplings` is not applied."""
    dev = _device.resolve(device)
    return DenseProblem(
        J=torch.as_tensor(np.array(J, dtype=np.float32), device=dev),
        h=torch.as_tensor(np.array(h, dtype=np.float32), device=dev))


def lookuptable_from_numpy(lut, device=None):
    """A bath lookuptable (P-1,), for example the JAX package's
    `schedules.bath_lookuptable(P, alpha)`, as a float32 tensor; a float32
    table crosses bitwise."""
    return torch.as_tensor(np.array(lut, dtype=np.float32),
                           device=_device.resolve(device))


def state_from_numpy(spins, device=None):
    """Spins, rotor angles or Trotter configurations as a float32 tensor,
    keeping the JAX package's layout: (chains, N), or slices-major
    (chains, P, N)."""
    return torch.as_tensor(
        np.ascontiguousarray(np.asarray(spins, dtype=np.float32)),
        device=_device.resolve(device),
    )
