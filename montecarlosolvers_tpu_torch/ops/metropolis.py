"""Metropolis acceptance and the masked colored sweep (counterpart of
montecarlosolvers_tpu/ops/metropolis.py).

`colored_metropolis_sweep` and `sweep_scan` are the masked engine on an
IsingProblem: every color phase computes every site's field and flips the
accepted sites of its color. They are plain PyTorch; `sweep_scan` draws
each sweep's uniforms from the counter hash at the sites' original indices
(`counter_rng.generic_uids`), the same uniforms the packed engine
(`ops/packed.py`, `ops/generic_kernels.py`) draws, so the two give the same
spins bitwise, and `solvers/sa.py` sends engine="masked" on the card to
the packed kernel. `noisy_colored_sweep` is the masked sweep on per-step
tables, the plain form that `sa.anneal_noisy`'s packed engine is held to.
"""

from __future__ import annotations

import torch

from montecarlosolvers_tpu_torch.models.ising import slot_sum
from montecarlosolvers_tpu_torch.ops import counter_rng as cr


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


def colored_metropolis_sweep(problem, spins, u, temp, b_coeff=None,
                             fields=None):
    """One sweep of single-spin Metropolis updates over all spins, color
    by color (JAX `colored_metropolis_sweep`, ops/metropolis.py:60).

    spins: (..., N) float32 +/-1; u: uniforms of the same shape, one per
    site (the color classes partition the sites); temp: float32 tensor;
    b_coeff: dE = b_coeff * s * field, None meaning -2 (classical SA;
    PIQMC slices pass -2B); fields: the field function of the spins,
    problem.local_fields by default. Returns the new spins."""
    if b_coeff is None:
        b_coeff = -2.0
    fields = problem.local_fields if fields is None else fields
    for c in range(problem.num_colors):
        de = b_coeff * spins * fields(spins)
        accept = metropolis_accept(de, temp, u) & problem.color_masks[c]
        spins = torch.where(accept, -spins, spins)
    return spins


def noisy_colored_sweep(problem, nbr_J_t, h_t, spins, u, temp):
    """The masked colored sweep on this step's couplings (JAX
    `noisy_colored_sweep`, ops/metropolis.py:125; NoisyAnneal,
    sa.pyx:291-378): nbr_J_t (N, maxnb) and h_t (N,) replace the problem's
    static tables, which keep only their neighbor indices and colors.
    spins, u: (..., N); temp: float32 tensor. Returns the new spins."""
    return colored_metropolis_sweep(
        problem, spins, u, temp,
        fields=lambda s: slot_sum(problem.nbr_idx, nbr_J_t, s) + h_t)


def sweep_scan(problem, spins, seed, temps, collect_energy=False):
    """A whole schedule of masked SA sweeps (JAX `sweep_scan`,
    ops/metropolis.py:90, without its `b_coeffs`, which no caller of the
    port passes): sweep t at temps[t] on the uniforms of counter(seed, t,
    0) at the original site ids.

    spins: (chains, N) float32 +/-1 on the problem's device; temps: float32
    (steps,) tensor. Returns (spins, energies) with energies (steps,
    chains) after each sweep, or None."""
    chains, n = spins.shape
    sites = torch.arange(n, dtype=torch.int32, device=spins.device)
    hu = cr.hashed_uid(cr.generic_uids(chains, sites, n))
    es = [] if collect_energy else None
    for t in range(temps.shape[0]):
        u = cr.uniform01_hashed(cr.counter(seed, t, 0), hu)
        spins = colored_metropolis_sweep(problem, spins, u, temps[t])
        if collect_energy:
            es.append(problem.energy(spins))
    return spins, None if es is None else torch.stack(es)
