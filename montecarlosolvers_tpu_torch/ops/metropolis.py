"""Metropolis acceptance (counterpart of montecarlosolvers_tpu/ops/metropolis.py)."""

from __future__ import annotations

import torch


def metropolis_accept(de, temp, u):
    """Accept iff dE <= 0, else with probability exp(-dE/T), in the log form
    `-T * log1p(-u) > dE` on a uniform u in [0, 1) — the form of
    `metropolis_accept` (ops/metropolis.py:20), which has no float32
    acceptance floor.

    The downhill branch compares against `0.0 * temp`, which equals 0.0 for
    every finite temperature and is NaN for a NaN temperature: a NaN schedule
    step then rejects both branches and is an exact no-op, as in the JAX
    package. `temp` is a float32 tensor (0-d or broadcastable) so that the
    product `-temp * log1p(-u)` is rounded in float32, as the kernels and the
    JAX code round it."""
    return (de <= 0.0 * temp) | (-temp * torch.log1p(-u) > de)
