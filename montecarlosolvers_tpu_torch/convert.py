"""Carry the JAX package's problems and states across into the port.

Both functions take numpy arrays (for example `np.asarray(jax_lat.j_right)`)
and return the port's objects on `device`, so the two packages compute on
the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

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


def state_from_numpy(spins, device=None):
    """Spins or Trotter configurations as a float32 tensor, keeping the JAX
    package's layout: (chains, N), or slices-major (chains, P, N)."""
    return torch.as_tensor(
        np.ascontiguousarray(np.asarray(spins, dtype=np.float32)),
        device=device,
    )
