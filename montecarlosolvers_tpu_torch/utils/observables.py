"""Observables (counterpart of montecarlosolvers_tpu/utils/observables.py):
per-state and per-trajectory metrics computed from states or collected
energies, on tensors, with the JAX functions' reductions and axes. The
last two, `success_probability` and `time_to_solution`, take and return
host numbers, as in JAX."""

from __future__ import annotations

import numpy as np
import torch


def magnetization(spins):
    """Mean magnetization per spin, batched over leading dims."""
    return torch.mean(spins, dim=-1)


def energy_per_spin(problem, spins):
    return problem.energy(spins) / problem.nspins


def residual_energy(problem, spins, e_gs):
    """eps_res = (E - E_gs) / N, the MST success metric
    (examples/santoro80.py:298,310)."""
    return (problem.energy(spins) - e_gs) / problem.nspins


def overlap(s_a, s_b):
    """Spin-glass overlap q = (1/N) sum_i s^a_i s^b_i between two
    replicas."""
    return torch.mean(s_a * s_b, dim=-1)


def replica_overlap_matrix(states):
    """(R, R) overlap matrix across a batch of replicas (R, N)."""
    s = states.to(torch.float32)
    n = s.shape[-1]
    return s @ s.T / n


def acceptance_fraction(before, after):
    """Fraction of spins that differ between two states (a sweep-level
    acceptance-rate proxy), batched over leading dims."""
    return torch.mean((before != after).to(torch.float32), dim=-1)


def binder_cumulant(mags):
    """Binder cumulant U4 = 1 - <m^4> / (3 <m^2>^2) over a sample of
    magnetizations."""
    m2 = torch.mean(mags ** 2)
    m4 = torch.mean(mags ** 4)
    return 1.0 - m4 / (3.0 * m2 ** 2)


def best_energy_so_far(energies):
    """Running minimum along the leading (time) axis of collected
    energies: time-to-solution curves."""
    return torch.cummin(energies, dim=0).values


def success_probability(energies, e_target, atol=1e-6):
    """Fraction of chains whose energy reached e_target (per-chain energies
    along the last axis), a host float."""
    e = np.asarray(energies.cpu() if torch.is_tensor(energies) else energies)
    return float(np.mean(e <= e_target + atol))


def time_to_solution(tau, p_succ, target_confidence=0.99):
    """Standard annealer TTS metric: expected total anneal length to reach
    the target at the given confidence,

        TTS(tau) = tau * ln(1 - confidence) / ln(1 - p_succ).

    Returns inf when p_succ == 0 and tau when p_succ >= 1."""
    p = float(p_succ)
    if p <= 0.0:
        return float("inf")
    if p >= 1.0:
        return float(tau)
    return float(tau * np.log(1.0 - target_confidence) / np.log(1.0 - p))
