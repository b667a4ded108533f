"""Spin-vector Monte Carlo proposals and readout (counterpart of
montecarlosolvers_tpu/ops/svmc_ops.py).

Spins are rotor angles theta in [0, pi]; a move proposes a new angle and
Metropolis-accepts it on

    dE = B (cos th' - cos th) z + A (sin th - sin th')

with z = sum_j J_ij cos th_j + h_i (svmc.pyx:96-110). The sweeps live in
`ops/split_kernels.py` and `ops/plane_kernels.py`, beside their CUDA
kernels; the generic `svmc_sweep` / `noisy_svmc_sweep` on an IsingProblem
are not ported yet (ROADMAP.md queue 1).

Every function here rounds in float32 as the JAX package does: `PI` is
float32(pi) = 3.14159274..., the value `jnp.pi` takes against a float32
array, not `math.pi`.
"""

from __future__ import annotations

import numpy as np
import torch

PI = float(np.float32(np.pi))


def propose_uniform(u):
    """theta' = pi * u (svmc.pyx:95)."""
    return PI * u


def propose_tf(theta, u, a_coeff, b_coeff):
    """Transverse-field-informed proposal (SVMC-TF, svmc.pyx:198-207): a
    window of width min(1, A/B) * 2 pi around the current angle, clipped to
    [0, pi]. A and B are float32 tensors; rounded in the kernels' order:
    ((2 pi) u - pi), times the width, plus theta."""
    width = torch.clamp(a_coeff / b_coeff, max=1.0)
    return torch.clamp(theta + width * (2.0 * PI * u - PI), 0.0, PI)


def z_projection_from_cos(cos_theta):
    """z_projection on an already-computed cos theta."""
    return torch.where(cos_theta >= 0.0, 1.0, -1.0).to(torch.float32)


def z_projection(theta):
    """Project rotor angles to Ising spins: sign(cos theta), +1 at the
    boundary, the standard readout for SVMC states."""
    return z_projection_from_cos(torch.cos(theta))
