"""Spin-vector Monte Carlo proposals and readout (counterpart of
montecarlosolvers_tpu/ops/svmc_ops.py).

Spins are rotor angles theta in [0, pi]; a move proposes a new angle and
Metropolis-accepts it on

    dE = B (cos th' - cos th) z + A (sin th - sin th')

with z = sum_j J_ij cos th_j + h_i (svmc.pyx:96-110). The lattice sweeps live
in `ops/split_kernels.py` and `ops/plane_kernels.py`, beside their CUDA
kernels; the masked `svmc_sweep` on an IsingProblem is here, the packed
one in `ops/packed.py`. The noisy sweeps wait for `anneal_noisy`
(ROADMAP.md queue 1).

Every function here rounds in float32 as the JAX package does: `PI` is
float32(pi) = 3.14159274..., the value `jnp.pi` takes against a float32
array, not `math.pi`.
"""

from __future__ import annotations

import numpy as np
import torch

from montecarlosolvers_tpu_torch.ops.metropolis import metropolis_accept

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


def _delta_e(problem, theta, theta_prop, a_coeff, b_coeff):
    """dE of moving each rotor from theta to theta_prop:
    B (cos th' - cos th) z + A (sin th - sin th'), z the problem's field
    of the z-projections cos theta."""
    cos_t = torch.cos(theta)
    zmagdiff = torch.cos(theta_prop) - cos_t
    de = b_coeff * zmagdiff * problem.local_fields(cos_t)
    return de + a_coeff * (torch.sin(theta) - torch.sin(theta_prop))


def svmc_sweep_cached(problem, state, u_prop, u_acc, temp, a_coeff,
                      b_coeff, tf=False):
    """One masked colored SVMC sweep on carried trig caches (JAX
    `svmc_sweep_cached`, ops/svmc_ops.py:52): state = (theta, cos theta,
    sin theta), each (..., N); u_prop / u_acc: the proposal and acceptance
    uniforms, one pair per site and sweep (the colors partition the
    sites); temp, a_coeff, b_coeff: float32 tensors."""
    theta, cos_t, sin_t = state
    for c in range(problem.num_colors):
        prop = (propose_tf(theta, u_prop, a_coeff, b_coeff) if tf
                else propose_uniform(u_prop))
        cos_p = torch.cos(prop)
        sin_p = torch.sin(prop)
        zfield = problem.local_fields(cos_t)
        de = b_coeff * (cos_p - cos_t) * zfield + a_coeff * (sin_t - sin_p)
        accept = metropolis_accept(de, temp, u_acc) & problem.color_masks[c]
        theta = torch.where(accept, prop, theta)
        cos_t = torch.where(accept, cos_p, cos_t)
        sin_t = torch.where(accept, sin_p, sin_t)
    return theta, cos_t, sin_t


def svmc_sweep(problem, theta, u_prop, u_acc, temp, a_coeff, b_coeff,
               tf=False):
    """One masked colored SVMC sweep of (..., N) angles in [0, pi]: the
    single-sweep form of `svmc_sweep_cached`."""
    theta, _, _ = svmc_sweep_cached(
        problem, (theta, torch.cos(theta), torch.sin(theta)), u_prop, u_acc,
        temp, a_coeff, b_coeff, tf=tf)
    return theta
