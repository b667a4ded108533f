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

`collect_case` builds the collecting route (`energies=`, collect_energy=)
of any of the seven kernels beside its plain version on the same inputs,
with the launches the route must make and the tolerance of its energies.

The generic section at the end does the same for an IsingProblem: exact
Boltzmann and extended-Gibbs weights over every state of a small graph
(`generic_sa_weights`, `generic_qmc_weights`, from the problem's tables in
float64 numpy), the rotor pair as an IsingProblem (`rotor_pair_problem`,
whose moments are `rotor_moments`'s), samplers that take a problem-level
engine of ops/generic_kernels.py (`sample_generic_sa`,
`sample_generic_qmc`, `sample_generic_svmc`), and `generic_case`, the
inputs of each generic kernel beside its plain version. `generic_case`
also builds the generic bath kernel's inputs, on an IsingProblem or on a
lattice's checkerboard packing, and `bath_colored_case` those of kernel
5's colored template.

The cluster section holds the cluster solvers' engines
(`ops/cluster_kernels.py`) to the same weights: `two_spin_problem` (the
pair of tests/test_cluster_exact.py) and the samplers `sample_cluster_sa`
and `sample_cluster_qmc`.

Used by tests/test_torch_hw_rng.py, tests/test_torch_packed.py,
tests/test_torch_cluster_solvers.py,
tests/test_torch_gpu.py and chip_smoke.py; not a part of the package.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from montecarlosolvers_tpu_torch import convert, schedules
from montecarlosolvers_tpu_torch.models.ising import IsingProblem
from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
from montecarlosolvers_tpu_torch.ops import packed as packed_ops
from montecarlosolvers_tpu_torch.ops import piqmc as piqmc_ops
from montecarlosolvers_tpu_torch.ops import plane as plane_ops
from montecarlosolvers_tpu_torch.ops import plane_kernels as pk
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


@contextlib.contextmanager
def plain_route():
    """Within the block, every kernel wrapper of the port takes its plain
    version on any device (`_build.route` answers "cpu"), so a sampler run
    on CUDA tensors with the plain versions can be held bitwise to the same
    run on the kernels: the torch arithmetic around the sweeps (energies
    of the packed and dense forms, exchanges, reweights, resamples) then
    runs on one device in both. A monkeypatch for checks run one at a
    time; the package has no such switch."""
    from montecarlosolvers_tpu_torch.ops import _build

    saved = _build.route
    try:
        _build.route = lambda device, engine: "cpu"
        yield
    finally:
        _build.route = saved


# ------------------------------------------- collect_energy=: the routes

# kernel -> (wrapper, plain version, LAUNCHES key)
COLLECTING = {
    "split_sa": (sk.sa_split_anneal, sk.sa_split_anneal_ref, "sa_split"),
    "split_qmc": (sk.qmc_split_anneal, sk.qmc_split_anneal_ref,
                  "qmc_split"),
    "split_qmc_bath": (sk.qmc_bath_split_anneal,
                       sk.qmc_bath_split_anneal_ref, "qmc_bath_split"),
    "split_svmc": (sk.svmc_split_anneal, sk.svmc_split_anneal_ref,
                   "svmc_split"),
    "plane_sa": (pk.sa_plane_anneal, pk.sa_plane_anneal_ref, "sa_plane"),
    "plane_qmc": (pk.qmc_plane_anneal, pk.qmc_plane_anneal_ref,
                  "qmc_plane"),
    "plane_svmc": (pk.svmc_plane_anneal, pk.svmc_plane_anneal_ref,
                   "svmc_plane"),
}
# the energies of a collecting route may differ from the plain version's by
# this much per unit of sum |J| + sum |h| (float32 sums in another order)
ENERGY_RTOL = 1e-5


def collect_launches(kernel, steps, slices=None, global_moves=True):
    """The LAUNCHES a collecting call of kernel `kernel`'s wrapper must
    make over `steps` steps: its per-phase kernels (a step's phases, and
    the SVMC caches' fill) and one energy launch a step."""
    if kernel.endswith("svmc"):
        phased = 1 + 2 * steps
    elif kernel == "plane_qmc":
        phased = (piqmc_ops.spacetime_num_phases(2, slices)
                  + (2 if global_moves else 0)) * steps
    elif "qmc" in kernel:
        phased = (4 if global_moves else 2) * steps
    else:
        phased = 2 * steps
    key = COLLECTING[kernel][2]
    return {f"{key}_phased": phased, f"{key}_energy": steps}


def collect_case(kernel, lat, chains, steps, slices=None, tf=True,
                 global_moves=True, seed=0, alpha=1e-2):
    """Kernel `kernel`'s route and inputs on lattice `lat` (its device):
    `chains` chains (of `slices` slices for PIQMC) of random spins or
    angles from numpy's `seed`, `steps` steps of its schedule (T: 3 -> 0.1;
    Gamma: 3 -> 1e-8 with B = 1, T = 1/P, global moves; SVMC A: 3 -> 1e-8,
    B = 1, T = 0.05, TF proposals; the bath at `alpha`).

    Returns a dict: run(fn, energies) calls the wrapper or the plain
    version `fn` and returns its state tuple; start, the input state tuple;
    launches, the LAUNCHES a collecting wrapper call must make (the
    per-phase kernels and one energy launch a step); scale, sum |J| +
    sum |h| of the lattice (the energies' tolerance is ENERGY_RTOL times
    it); angles, whether the state is SVMC angles."""
    dev = lat.device
    rng = np.random.default_rng(seed)
    L = lat.L

    def spins(*shape):
        return torch.as_tensor(rng.choice([-1.0, 1.0], size=shape).astype(
            np.float32), device=dev)

    def angles(*shape):
        return torch.as_tensor((rng.random(shape) * np.pi).astype(
            np.float32), device=dev)

    P = slices
    teff = (1.0 / P) * P if P else None
    gamma = schedules.transverse_field(3.0, 1e-8, steps, device=dev)
    ones = torch.ones_like(gamma)
    jp = schedules.jperp(gamma, teff).contiguous() if P else None
    sched = schedules.linear(3.0, 0.1, steps, device=dev)
    split = kernel.startswith("split")
    sl = split_ops.build_split(lat) if split else None
    pl = None if split else plane_ops.build_plane(lat)
    if kernel == "split_sa":
        start = tuple(x.contiguous() for x in split_ops.pack_classical(
            sl, spins(chains, L * L)))
        call = lambda fn, es: fn(sl, sched, *start, 11, energies=es)
    elif kernel == "split_qmc":
        start = split_ops.pack_qmc(sl, spins(chains, P, L * L))
        call = lambda fn, es: fn(sl, ones, jp, teff, start, 11,
                                 global_moves, energies=es)
    elif kernel == "split_qmc_bath":
        start = tuple(x.contiguous() for x in split_ops.pack_classical(
            sl, spins(chains, P, L * L)))
        bath = piqmc_ops.bath_matrix(schedules.bath_lookuptable(
            P, alpha, device=dev), P).contiguous()
        call = lambda fn, es: fn(sl, ones, jp, teff, bath, *start, 11,
                                 global_moves, energies=es)
    elif kernel == "split_svmc":
        start = tuple(x.contiguous() for x in split_ops.pack_classical(
            sl, angles(chains, L * L)))
        call = lambda fn, es: fn(sl, gamma, ones, 0.05, *start, 11, tf,
                                 energies=es)
    elif kernel == "plane_sa":
        start = (spins(chains, L, L),)
        call = lambda fn, es: (fn(pl, sched, *start, 11, energies=es),)
    elif kernel == "plane_qmc":
        start = (spins(chains, P, L, L),)
        call = lambda fn, es: (fn(pl, ones, jp, teff, *start, 11,
                                  global_moves, energies=es),)
    else:
        start = (angles(chains, L, L),)
        call = lambda fn, es: (fn(pl, gamma, ones, 0.05, *start, 11, tf,
                                  energies=es),)
    return {"run": call, "start": start, "scale": energy_scale(lat),
            "angles": kernel.endswith("svmc"),
            "launches": collect_launches(kernel, steps, P, global_moves)}


def energy_scale(lat):
    """sum |J| + sum |h| of lattice `lat`: collected energies may differ
    from their plain versions' by ENERGY_RTOL times it."""
    return float(lat.j_right.abs().sum() + lat.j_down.abs().sum()
                 + lat.h_plane.abs().sum())


# ------------------------------------------------- generic (IsingProblem)


def generic_energies(problem, states):
    """float64 energies of (S, N) +/-1 numpy states, from the problem's
    tables: 0.5 sum_i s_i sum_k J_ik s_nb + sum_i h_i s_i."""
    idx = problem.nbr_idx.cpu().numpy()
    jv = problem.nbr_J.cpu().double().numpy()
    h = problem.h.cpu().double().numpy()
    quad = (jv[None] * states[:, idx]).sum(axis=-1)
    return 0.5 * (quad * states).sum(axis=-1) + (h * states).sum(axis=-1)


def all_states(n):
    """(2^n, n) float64 +/-1 states; bit i of the index is s_i = -1
    (`spin_codes`)."""
    bits = (np.arange(2 ** n)[:, None] >> np.arange(n)[None, :]) & 1
    return 1.0 - 2.0 * bits


def spin_codes(spins):
    """(chains,) state index of (chains, ...) spins, flattened: bit i is
    spin i = -1."""
    flat = spins.reshape(spins.shape[0], -1)
    w = 1 << torch.arange(flat.shape[1], device=spins.device)
    return ((flat < 0).long() * w).sum(dim=1)


def generic_sa_weights(problem, temp):
    """Boltzmann weights at T of every state of a small IsingProblem."""
    return _normalised(generic_energies(problem, all_states(problem.nspins)),
                       temp)


def generic_qmc_weights(problem, P, temp, jp, b=1.0, bath=None):
    """Extended Gibbs weights at T_eff = P*T of every (P, N) state of a
    small IsingProblem, index bit k*N + i the spin i of slice k = -1:
    E = B sum_k E(s_k) - J_perp sum_k s_k . s_{k+1} (ring)
    - (T_eff / 2) sum_i s_i M s_i with the bath matrix `bath` ((P, P) or
    None)."""
    n = problem.nspins
    s = all_states(n * P).reshape(-1, P, n)
    e = b * generic_energies(problem, s.reshape(-1, n)).reshape(-1, P).sum(1)
    e -= jp * (s * np.roll(s, -1, axis=1)).sum(axis=(1, 2))
    if bath is not None:
        e -= 0.5 * P * temp * np.einsum("spn,pq,sqn->s", s, bath, s)
    return _normalised(e, P * temp)


def rotor_pair_problem(device):
    """The rotor pair of `rotor_moments` as an IsingProblem: bond J, fields
    H0 and H1 (tests/test_packed.py's two-rotor case)."""
    return IsingProblem.from_edges(2, [0, 0, 1], [1, 0, 1], [J, H0, H1],
                                   maxnb=2, device=device)


def _random_spins(shape, seed, device):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.randint(0, 2, shape, generator=gen).float() * 2
            - 1).to(device)


def sample_generic_sa(engine, problem, chains, temp, seed, burn=BURN,
                      samples=SAMPLES, every=EVERY):
    """Per-chain frequencies of the 2^N states under `engine`
    (generic_kernels.anneal_packed or anneal_masked) at T."""
    dev = problem.device

    def step(s, n, sd):
        return engine(problem, torch.full((n,), temp, device=dev), s, sd)
    return _frequencies(step, _random_spins((chains, problem.nspins), seed,
                                            dev),
                        spin_codes, 2 ** problem.nspins, burn, samples,
                        every, seed)


def sample_generic_qmc(problem, chains, P, temp, gamma, seed,
                       global_moves=True, burn=BURN, samples=SAMPLES,
                       every=EVERY):
    """Per-chain frequencies of the 2^(P N) states under
    generic_kernels.anneal_generic_qmc at fixed Gamma, B = 1 and T."""
    dev = problem.device

    def step(c, n, sd):
        g = torch.full((n,), gamma, device=dev)
        return gk.anneal_generic_qmc(problem, g, torch.ones_like(g), temp, c,
                                     sd, global_moves=global_moves)
    return _frequencies(step, _random_spins((chains, P, problem.nspins),
                                            seed, dev),
                        spin_codes, 2 ** (P * problem.nspins), burn,
                        samples, every, seed)


def sample_generic_bath(problem, chains, P, temp, gamma, alpha, seed, codes,
                        nstates, global_moves=True, colored=False,
                        burn=BURN, samples=SAMPLES, every=EVERY):
    """Per-chain frequencies of `codes` (spin_codes for a whole small
    problem, line_codes for `pair_lattice`'s pair) under
    generic_kernels.anneal_generic_qmc_bath (an IsingProblem, or a
    LatticeProblem on its checkerboard packing) at fixed Gamma, B = 1, T
    and bath strength alpha, sequential or `colored`."""
    dev = problem.device
    lut = schedules.bath_lookuptable(P, alpha, device=dev)

    def step(c, n, sd):
        g = torch.full((n,), gamma, device=dev)
        return gk.anneal_generic_qmc_bath(
            problem, g, torch.ones_like(g), temp, lut, c, sd,
            global_moves=global_moves, colored=colored)
    return _frequencies(step, _random_spins((chains, P, problem.nspins),
                                            seed, dev),
                        codes, nstates, burn, samples, every, seed)


def sample_generic_svmc(problem, chains, a, b, temp, seed, burn=BURN,
                        samples=SAMPLES, every=EVERY):
    """(chains, 2) per-chain means of E_pair and cos t0 of the rotor pair
    (`rotor_pair_problem`) under generic_kernels.anneal_packed_svmc with
    uniform proposals at A, B, T."""
    dev = problem.device
    gen = torch.Generator(device="cpu").manual_seed(seed)
    th = (torch.rand((chains, 2), generator=gen) * np.pi).to(dev)

    def step(th, n, sd):
        return gk.anneal_packed_svmc(problem, torch.full((n,), a, device=dev),
                                     torch.full((n,), b, device=dev), temp,
                                     th, sd)
    th = step(th, burn, seed)
    obs = np.zeros((chains, 2))
    for i in range(samples):
        th = step(th, every, seed + 1 + i)
        t = th.double().cpu().numpy()
        obs += np.stack([rotor_energy(t[:, 0], t[:, 1], a, b),
                         np.cos(t[:, 0])], axis=1)
    return obs / samples


# kernel -> (wrapper, plain version, LAUNCHES key)
GENERIC = {
    "packed_sa": (gk.packed_sa_anneal, gk.packed_sa_anneal_ref, "packed_sa"),
    "generic_qmc": (gk.generic_qmc_anneal, gk.generic_qmc_anneal_ref,
                    "generic_qmc"),
    "packed_svmc": (gk.packed_svmc_anneal, gk.packed_svmc_anneal_ref,
                    "packed_svmc"),
    "generic_qmc_bath": (gk.generic_qmc_bath_anneal,
                         gk.generic_qmc_bath_anneal_ref, "generic_qmc_bath"),
}


def packed_of(problem):
    """The PackedGraph the generic engines take for `problem`: an
    IsingProblem's own, or a LatticeProblem's checkerboard packing."""
    if packed_ops.supports_packed(problem):
        return packed_ops.build_packed(problem)
    return packed_ops.packed_from_lattice(problem)


def problem_scale(problem):
    """sum |J| + sum |h| of an IsingProblem or a LatticeProblem."""
    if packed_ops.supports_packed(problem):
        return float(problem.nbr_J.abs().sum() / 2 + problem.h.abs().sum())
    return energy_scale(problem)


def generic_case(kernel, problem, chains, steps, slices=None, tf=True,
                 global_moves=True, seed=0, bscale=1.0, colored=False,
                 alpha=0.01):
    """Generic kernel `kernel`'s inputs on IsingProblem `problem` (its
    device), packed (for "generic_qmc_bath" also a LatticeProblem, on its
    checkerboard packing): `chains` chains (of `slices` slices for PIQMC)
    of random spins or angles from numpy's `seed`, `steps` steps of its
    schedule (T: 3 -> 0.1; Gamma: 3 -> 1e-8 with B = bscale, T = 1/P, and
    for the bath the sweep `colored` or not at bath strength `alpha`;
    SVMC A: 3 -> 1e-8, B = bscale, T = 0.05, TF proposals `tf`).

    Returns a dict: run(fn, energies) calls the wrapper or the plain
    version `fn` and returns its state; start, the packed input state;
    pg, the PackedGraph; scale, sum |J| + sum |h| (the energies'
    tolerance is ENERGY_RTOL times it); angles, whether the state is
    SVMC angles."""
    dev = problem.device
    rng = np.random.default_rng(seed)
    pg = packed_of(problem)
    n = problem.nspins
    gamma = schedules.transverse_field(3.0, 1e-8, steps, device=dev)
    bs = torch.full_like(gamma, bscale)
    if kernel == "packed_sa":
        start = rng.choice([-1.0, 1.0], size=(chains, n))
        sched = schedules.linear(3.0, 0.1, steps, device=dev)
        call = lambda fn, es: fn(pg, sched, st, 11, energies=es)
    elif kernel == "generic_qmc":
        start = rng.choice([-1.0, 1.0], size=(chains, slices, n))
        teff = (1.0 / slices) * slices
        jp = schedules.jperp(gamma, teff).contiguous()
        call = lambda fn, es: fn(pg, bs, jp, teff, st, 11, global_moves,
                                 energies=es)
    elif kernel == "generic_qmc_bath":
        start = rng.choice([-1.0, 1.0], size=(chains, slices, n))
        teff = (1.0 / slices) * slices
        jp = schedules.jperp(gamma, teff).contiguous()
        bath = piqmc_ops.bath_matrix(schedules.bath_lookuptable(
            slices, alpha, device=dev), slices).contiguous()
        call = lambda fn, es: fn(pg, bs, jp, teff, bath, st, 11,
                                 global_moves, colored=colored, energies=es)
    else:
        start = rng.random((chains, n)) * np.pi
        call = lambda fn, es: fn(pg, gamma, bs, 0.05, st, 11, tf,
                                 energies=es)
    st = torch.as_tensor(start.astype(np.float32), device=dev)
    return {"run": call, "start": st, "pg": pg,
            "scale": problem_scale(problem),
            "angles": kernel == "packed_svmc"}


def bath_colored_case(lat, chains, steps, slices, global_moves=True,
                      seed=0, bscale=1.0, alpha=0.01):
    """Kernel 5's colored template's inputs on even-L lattice `lat` at even
    P = `slices`: `chains` chains of random spins from numpy's `seed`, in
    quarters, `steps` steps of Gamma: 3 -> 1e-8 with B = bscale, T = 1/P,
    bath strength `alpha`. Returns a dict as `generic_case`'s, run(fn,
    energies) giving fn's (chains, P, N) state for fn
    qmc_bath_split_colored_anneal or its _ref, and the LAUNCHES its
    collecting route makes (`launches`)."""
    dev = lat.device
    rng = np.random.default_rng(seed)
    sl = split_ops.build_split(lat)
    start = torch.as_tensor(rng.choice(
        [-1.0, 1.0], size=(chains, slices, lat.nspins)).astype(np.float32),
        device=dev)
    gamma = schedules.transverse_field(3.0, 1e-8, steps, device=dev)
    teff = (1.0 / slices) * slices
    jp = schedules.jperp(gamma, teff).contiguous()
    bath = piqmc_ops.bath_matrix(schedules.bath_lookuptable(
        slices, alpha, device=dev), slices).contiguous()
    quarters = split_ops.pack_qmc(sl, start)

    def call(fn, es):
        return split_ops.unpack_qmc(sl, *fn(
            sl, torch.full_like(gamma, bscale), jp, teff, bath, quarters,
            11, global_moves, energies=es))
    return {"run": call, "start": start, "scale": energy_scale(lat),
            "angles": False,
            "launches": {"qmc_bath_split_colored_phased":
                         (6 if global_moves else 4) * steps,
                         "qmc_bath_split_colored_energy": steps}}


# ------------------------------------------------------- the cluster updates


def two_spin_problem(j, h, device):
    """Two spins with bond j and fields h = (h0, h1), an IsingProblem
    (tests/test_cluster_exact.py::_two_spin_problem)."""
    rows, cols, vals = [0], [1], [j]
    for i, hv in enumerate(h):
        if hv != 0.0:
            rows.append(i)
            cols.append(i)
            vals.append(hv)
    return IsingProblem.from_edges(2, rows, cols, vals, maxnb=2,
                                   device=device)


def sample_cluster_sa(kind, problem, chains, temp, seed, local_sweeps,
                      burn=BURN, samples=SAMPLES, every=EVERY):
    """Per-chain frequencies of the 2^N states under
    cluster_kernels.classical_anneal (kind "wolff" or "sw", the engine of
    sa.anneal_wolff / anneal_sw) at T."""
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck

    dev = problem.device

    def step(s, n, sd):
        return ck.classical_anneal(problem, torch.full((n,), temp,
                                                       device=dev), s, sd,
                                   kind=kind, local_sweeps=local_sweeps)
    return _frequencies(step, _random_spins((chains, problem.nspins), seed,
                                            dev),
                        spin_codes, 2 ** problem.nspins, burn, samples,
                        every, seed)


def sample_cluster_qmc(kind, problem, chains, P, temp, gamma, seed,
                       alpha=None, rule="local", local_sweeps=False,
                       per_slice_seeds=None, burn=BURN, samples=SAMPLES,
                       every=EVERY):
    """Per-chain frequencies of the 2^(P N) states at fixed Gamma, B = 1
    and T under cluster_kernels.qmc_cluster_anneal (kind "wolff" or "sw",
    the engine of qmc.anneal_wolff / anneal_sw, a bath of strength `alpha`
    if given) or, with kind "line", sw_bath_anneal (qmc.anneal_sw_bath)."""
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck

    dev = problem.device
    lut = (None if alpha is None
           else schedules.bath_lookuptable(P, alpha, device=dev))

    def step(c, n, sd):
        g = torch.full((n,), gamma, device=dev)
        if kind == "line":
            return ck.sw_bath_anneal(problem, g, torch.ones_like(g), temp,
                                     lut, c, sd,
                                     per_slice_seeds=per_slice_seeds,
                                     local_sweeps=local_sweeps)
        return ck.qmc_cluster_anneal(problem, g, torch.ones_like(g), temp, c,
                                     sd, kind=kind, rule=rule,
                                     lookuptable=lut,
                                     local_sweeps=local_sweeps)
    return _frequencies(step, _random_spins((chains, P, problem.nspins),
                                            seed, dev),
                        spin_codes, 2 ** (P * problem.nspins), burn,
                        samples, every, seed)
