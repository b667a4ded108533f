"""Exact Gibbs weights of one bonded pair, and samplers that hold the split
engines' uniform source to them.

A uniform source that is not the counter hash (`hw_rng=True`: the
kernels' generator streams, csrc/hw_rng.cuh, or the plain versions'
`torch.Generator`, `ops/split_kernels.py::hw_uniforms`) cannot be held to
anything bitwise, so it is held to exact distributions. The lattice is an
open L x L lattice with one bond J between sites 0 and 1, fields h0 and h1
on them, and every other coupling and field 0 (`pair_lattice`, the
lattice of tests/test_torch_svmc.py::test_svmc_samples_rotor_gibbs). The
other sites are free, so the pair's marginal is exactly:

- SA at temperature T: Boltzmann over the 4 states of (s0, s1);
- PIQMC at P slices: the extended Gibbs weights over the 2^(2P) states of
  the pair's two lines, E = B sum_k E_pair(k) - J_perp sum_k (s0_k s0_k+1
  + s1_k s1_k+1) - (T_eff / 2) sum_n s_n M s_n with the bath matrix M
  (zero without a bath), at T_eff = P*T (tests/test_qmc.py::
  extended_energy);
- SVMC with uniform proposals: the Gibbs density on [0, pi]^2 of
  E = B (J cos t0 cos t1 + h0 cos t0 + h1 cos t1) - A (sin t0 + sin t1),
  by quadrature.

The weights are written out here from their formulas in float64 numpy
(`jperp`, `bath_matrix`), sharing no code with the engines they check;
tests/test_torch_hw_rng.py holds the two formulas to the JAX package's.

The samplers (`sample_sa`, `sample_qmc`, `sample_bath`, `sample_svmc`) take
the engine to run: a wrapper of `ops/split_kernels.py` (the kernel on a
CUDA tensor, the plain version on a CPU one) or its plain version
(`*_ref`, on either device). They run it on many chains, one call of
`every` sweeps per sample with seed `seed + i`, and return per-chain
frequencies of the pair's states (or per-chain means of its observables).
Chains are independent, so the spread of the per-chain values gives each
mean its standard error (`z_scores`, `z_between`), whatever the
correlation between the samples of one chain. `phased_route` sends the
wrappers through the per-phase kernels at any shape.

Used by tests/test_torch_hw_rng.py, tests/test_torch_gpu.py and
chip_smoke.py; not a part of the package.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from montecarlosolvers_tpu_torch import convert, schedules
from montecarlosolvers_tpu_torch.ops import piqmc as piqmc_ops
from montecarlosolvers_tpu_torch.ops import split as split_ops
from montecarlosolvers_tpu_torch.ops import split_kernels as sk

J, H0, H1 = 0.8, 0.3, -0.4


def pair_lattice(L, device):
    """Open L x L lattice: bond J between sites 0 and 1, fields H0 and H1
    on them, nothing else."""
    jr, jd, hp = (np.zeros((L, L)) for _ in range(3))
    jr[0, 0], hp[0, 0], hp[0, 1] = J, H0, H1
    return convert.lattice_from_arrays(jr, jd, hp, device=device)


def _normalised(energy, temp):
    w = np.exp(-(energy - energy.min()) / temp)
    return w / w.sum()


def jperp(gamma, P, temp):
    """J_perp = -(T_eff / 2) ln tanh(Gamma / T_eff) at T_eff = P*T, in
    float64 (qmc.pyx:95)."""
    teff = P * temp
    return -0.5 * teff * np.log(np.tanh(gamma / teff))


def bath_matrix(P, alpha):
    """(P, P) float64 bath couplings: alpha (pi / (P sin(pi d / P)))^2 at
    the ring distance d = (k' - k) mod P of slices k and k', zero on the
    diagonal (qmc.pyx:162-163, 271)."""
    k = np.arange(P)
    d = (k[None, :] - k[:, None]) % P
    with np.errstate(divide="ignore"):
        m = alpha * (np.pi / (P * np.sin(np.pi * d / P))) ** 2
    return np.where(d > 0, m, 0.0)


def sa_weights(temp):
    """Boltzmann weights of the 4 pair states at T; state index bit 0 is
    s0 = -1, bit 1 s1 = -1 (`pair_codes`)."""
    code = np.arange(4)
    s0, s1 = 1.0 - 2.0 * (code & 1), 1.0 - 2.0 * (code >> 1 & 1)
    return _normalised(J * s0 * s1 + H0 * s0 + H1 * s1, temp)


def qmc_weights(P, temp, jp, b=1.0, bath=None):
    """Extended Gibbs weights of the 2^(2P) states of the pair's lines at
    T_eff = P*T, J_perp `jp` and bath matrix `bath` ((P, P) array or None);
    state index bit k is s0 at slice k = -1, bit P + k s1 at slice k
    (`line_codes`)."""
    n = 2 * P
    bits = (np.arange(2 ** n)[:, None] >> np.arange(n)[None, :]) & 1
    s = (1.0 - 2.0 * bits).reshape(-1, 2, P)  # (states, site, slice)
    s0, s1 = s[:, 0], s[:, 1]
    e = b * (J * s0 * s1 + H0 * s0 + H1 * s1).sum(axis=1)
    e -= jp * (s * np.roll(s, -1, axis=2)).sum(axis=(1, 2))
    teff = P * temp
    if bath is not None:
        e -= 0.5 * teff * np.einsum("snp,pq,snq->s", s, bath, s)
    return _normalised(e, teff)


def rotor_moments(a, b, temp, points=601):
    """Exact <E_pair> and <cos t0> of the rotor pair at A = a, B = b, T,
    by quadrature on a `points` x `points` grid of [0, pi]^2."""
    g = np.linspace(0, np.pi, points)
    t0, t1 = np.meshgrid(g, g, indexing="ij")
    e = rotor_energy(t0, t1, a, b)
    w = np.exp((e.min() - e) / temp)
    return float((w * e).sum() / w.sum()), float((w * np.cos(t0)).sum()
                                                / w.sum())


def rotor_energy(t0, t1, a, b):
    return (b * (J * np.cos(t0) * np.cos(t1) + H0 * np.cos(t0)
                 + H1 * np.cos(t1)) - a * (np.sin(t0) + np.sin(t1)))


def pair_codes(spins):
    """(chains,) state index of (s0, s1) from (chains, N) spins."""
    return ((spins[:, 0] < 0).long() + 2 * (spins[:, 1] < 0).long())


def line_codes(confs):
    """(chains,) state index of the pair's lines from (chains, P, N)."""
    P = confs.shape[1]
    w = 1 << torch.arange(2 * P, device=confs.device)
    bits = torch.cat([confs[:, :, 0] < 0, confs[:, :, 1] < 0], dim=1)
    return (bits.long() * w).sum(dim=1)


# ------------------------------------- the engines on (chains, ...) states
# Each runs `engine` (a wrapper of ops/split_kernels.py or its `*_ref`) on
# a problem's states as the lattice-level function of split_kernels.py
# (anneal_lattice_split, ...) runs its wrapper.


def anneal_sa(engine, lat, temps, spins, seed, hw_rng=True):
    """(chains, N) spins after `engine` (sa_split_anneal or its _ref) at
    the (steps,) temperatures `temps`."""
    sl = split_ops.build_split(lat)
    a, b = split_ops.pack_classical(sl, spins)
    return split_ops.unpack_classical(sl, *engine(
        sl, temps, a.contiguous(), b.contiguous(), seed, hw_rng))


def anneal_qmc(engine, lat, gamma, temp, confs, seed, global_moves=True,
               hw_rng=True):
    """(chains, P, N) confs after `engine` (qmc_split_anneal or its _ref)
    at the (steps,) Gamma `gamma`, B = 1 and T."""
    sl = split_ops.build_split(lat)
    b, jp, teff = schedules.qmc_terms(gamma, torch.ones_like(gamma), temp,
                                      confs.shape[1], 1, lat.device)
    quarters = engine(sl, b, jp, teff, split_ops.pack_qmc(sl, confs), seed,
                      global_moves, hw_rng)
    return split_ops.unpack_qmc(sl, *quarters)


def anneal_bath(engine, lat, gamma, temp, alpha, confs, seed,
                global_moves=True, hw_rng=True):
    """(chains, P, N) confs after `engine` (qmc_bath_split_anneal or its
    _ref) at the (steps,) Gamma `gamma`, B = 1, T and bath strength
    alpha."""
    P = confs.shape[1]
    sl = split_ops.build_split(lat)
    b, jp, teff = schedules.qmc_terms(gamma, torch.ones_like(gamma), temp,
                                      P, 1, lat.device)
    bath = piqmc_ops.bath_matrix(schedules.bath_lookuptable(
        P, alpha, device=lat.device), P).contiguous()
    a, b_half = split_ops.pack_classical(sl, confs)
    return split_ops.unpack_classical(sl, *engine(
        sl, b, jp, teff, bath, a.contiguous(), b_half.contiguous(), seed,
        global_moves, hw_rng))


def anneal_svmc(engine, lat, a_sched, b_sched, temp, theta, seed, tf=False,
                hw_rng=True):
    """(chains, N) angles after `engine` (svmc_split_anneal or its _ref)
    at the (steps,) A and B schedules and T."""
    sl = split_ops.build_split(lat)
    a, b = split_ops.pack_classical(sl, theta)
    return split_ops.unpack_classical(sl, *engine(
        sl, a_sched, b_sched, temp, a.contiguous(), b.contiguous(), seed,
        tf, hw_rng))


# ----------------------------------------------------------------- samplers


def _frequencies(step, state, codes, nstates, burn, samples, every, seed):
    """Per-chain frequencies (chains, nstates) of codes(state) over
    `samples` calls of step(state, steps, seed) after a burn-in call."""
    state = step(state, burn, seed)
    counts = None
    for i in range(samples):
        state = step(state, every, seed + 1 + i)
        c = torch.nn.functional.one_hot(codes(state), nstates)
        counts = c if counts is None else counts + c
    return counts.double().cpu().numpy() / samples


# sweeps of burn-in, samples a chain, sweeps between samples: the rare
# line states of the bath at P = 3 relax within about 100 sweeps
BURN, SAMPLES, EVERY = 100, 60, 3


def sample_sa(engine, lat, chains, temp, seed, burn=BURN, samples=SAMPLES,
              every=EVERY):
    """Per-chain frequencies of the 4 pair states under `engine`
    (sa_split_anneal or its _ref) with hw_rng at T on `pair_lattice`."""
    dev = lat.device
    gen = torch.Generator(device="cpu").manual_seed(seed)
    s = (torch.randint(0, 2, (chains, lat.nspins), generator=gen)
         .float() * 2 - 1).to(dev)

    def step(s, n, sd):
        return anneal_sa(engine, lat, torch.full((n,), temp, device=dev), s,
                         sd)
    return _frequencies(step, s, pair_codes, 4, burn, samples, every, seed)


def _confs(lat, chains, P, seed):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.randint(0, 2, (chains, P, lat.nspins), generator=gen)
            .float() * 2 - 1).to(lat.device)


def sample_qmc(engine, lat, chains, P, temp, gamma, seed, global_moves=True,
               burn=BURN, samples=SAMPLES, every=EVERY):
    """Per-chain frequencies of the 2^(2P) line states under `engine`
    (qmc_split_anneal or its _ref) with hw_rng at fixed Gamma, B = 1 and
    T."""
    dev = lat.device

    def step(c, n, sd):
        return anneal_qmc(engine, lat, torch.full((n,), gamma, device=dev),
                          temp, c, sd, global_moves)
    return _frequencies(step, _confs(lat, chains, P, seed), line_codes,
                        4 ** P, burn, samples, every, seed)


def sample_bath(engine, lat, chains, P, temp, gamma, alpha, seed,
                global_moves=True, burn=BURN, samples=SAMPLES, every=EVERY):
    """Per-chain frequencies of the 2^(2P) line states under `engine`
    (qmc_bath_split_anneal or its _ref) with hw_rng at fixed Gamma, B = 1,
    T and bath strength alpha."""
    dev = lat.device

    def step(c, n, sd):
        return anneal_bath(engine, lat, torch.full((n,), gamma, device=dev),
                           temp, alpha, c, sd, global_moves)
    return _frequencies(step, _confs(lat, chains, P, seed), line_codes,
                        4 ** P, burn, samples, every, seed)


def sample_svmc(engine, lat, chains, a, b, temp, seed, burn=BURN,
                samples=SAMPLES, every=EVERY):
    """(chains, 2) per-chain means of E_pair and cos t0 under `engine`
    (svmc_split_anneal or its _ref) with hw_rng and uniform proposals at
    A, B, T."""
    dev = lat.device
    gen = torch.Generator(device="cpu").manual_seed(seed)
    th = (torch.rand((chains, lat.nspins), generator=gen) * np.pi).to(dev)

    def step(th, n, sd):
        return anneal_svmc(engine, lat, torch.full((n,), a, device=dev),
                           torch.full((n,), b, device=dev), temp, th, sd)
    th = step(th, burn, seed)
    obs = np.zeros((chains, 2))
    for i in range(samples):
        th = step(th, every, seed + 1 + i)
        t = th[:, :2].double().cpu().numpy()
        obs += np.stack([rotor_energy(t[:, 0], t[:, 1], a, b),
                         np.cos(t[:, 0])], axis=1)
    return obs / samples


# The four exact-weight cases: name -> (sample(engine, lat, chains), the
# exact weights or moments, samples a chain for `z_scores` (None for
# moments), what is sampled). `engine` is the wrapper of the case's kernel
# or its `*_ref`.
CASES = {
    "split_sa": (
        lambda eng, lat, n: sample_sa(eng, lat, n, 1.0, 11),
        sa_weights(1.0), SAMPLES, "4 states of (s0, s1), T = 1"),
    "split_qmc": (
        lambda eng, lat, n: sample_qmc(eng, lat, n, 4, 0.45, 0.6, 12),
        qmc_weights(4, 0.45, jperp(0.6, 4, 0.45)), SAMPLES,
        "256 states of the pair's lines, P = 4, T = 0.45, Gamma = 0.6, "
        "global moves"),
    "split_qmc_bath": (
        lambda eng, lat, n: sample_bath(eng, lat, n, 3, 0.45, 0.6, 0.1, 13),
        qmc_weights(3, 0.45, jperp(0.6, 3, 0.45), bath=bath_matrix(3, 0.1)),
        SAMPLES, "64 states of the pair's lines, P = 3, T = 0.45, "
        "Gamma = 0.6, alpha = 0.1, global moves"),
    "split_svmc": (
        lambda eng, lat, n: sample_svmc(eng, lat, n, 0.6, 1.0, 0.7, 14),
        np.array(rotor_moments(0.6, 1.0, 0.7)), None,
        "<E_pair> and <cos t0>, uniform proposals, A = 0.6, B = 1, "
        "T = 0.7"),
}
# name -> (the wrapper, its plain version)
ENGINES = {
    "split_sa": (sk.sa_split_anneal, sk.sa_split_anneal_ref),
    "split_qmc": (sk.qmc_split_anneal, sk.qmc_split_anneal_ref),
    "split_qmc_bath": (sk.qmc_bath_split_anneal,
                       sk.qmc_bath_split_anneal_ref),
    "split_svmc": (sk.svmc_split_anneal, sk.svmc_split_anneal_ref),
}


# -------------------------------------------------------------- statistics


def _se(per_chain, samples, p):
    """Standard errors of the chain means of `per_chain` (chains, k), not
    below sqrt(p (1 - p) / (chains * samples)), their value were all
    samples independent: a rare state that few chains visited has a chain
    spread near 0 that would understate it. p: the states' probabilities
    (None for means of observables, which take no floor)."""
    chains = per_chain.shape[0]
    se = per_chain.std(axis=0, ddof=1) / np.sqrt(chains)
    if p is None:
        return se
    return np.maximum(se, np.sqrt(p * (1.0 - p) / (chains * samples)))


def z_scores(per_chain, exact, samples=None):
    """(max over states, or observables, of |mean over chains - exact| in
    standard errors (`_se`), max |mean - exact|). `samples`: the samples
    per chain of state frequencies; None for means of observables."""
    mean = per_chain.mean(axis=0)
    d = np.abs(mean - exact)
    se = _se(per_chain, samples, None if samples is None else exact)
    return float((d / se).max()), float(d.max())


def z_between(per_chain_a, per_chain_b, samples=None):
    """As `z_scores`, between two samplers' chain means, with their
    standard errors combined (the floor at their mean frequency)."""
    ma, mb = per_chain_a.mean(axis=0), per_chain_b.mean(axis=0)
    p = None if samples is None else np.clip(0.5 * (ma + mb), 1e-12, 1.0)
    se = np.hypot(_se(per_chain_a, samples, p), _se(per_chain_b, samples, p))
    d = np.abs(ma - mb)
    return float((d / se).max()), float(d.max())


@contextlib.contextmanager
def phased_route():
    """Within the block, the wrappers of kernels A, B, 4 and 5 take their
    per-phase kernels at every shape (the geometry functions say no
    cluster holds it), so the per-phase kernels can be held to the exact
    weights on a small lattice. A monkeypatch of split_kernels for checks
    run one at a time; the package has no such switch."""
    names = ("sa_geometry", "qmc_geometry", "qmc_bath_geometry",
             "svmc_split_geometry")
    saved = {n: getattr(sk, n) for n in names}
    try:
        for n in names:
            setattr(sk, n, lambda *args, **kw: None)
        yield
    finally:
        for n, fn in saved.items():
            setattr(sk, n, fn)
