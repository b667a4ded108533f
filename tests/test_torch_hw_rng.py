"""The `hw_rng` option of the port's split engines (kernels A, B, 4 and 5)
against the JAX package and against exact weights, on the CPU.

With `hw_rng=False` (the default) the four public functions stay bitwise
equal to the JAX oracles of tests/test_pallas_split.py. With
`hw_rng=True` the plain versions draw from a `torch.Generator`
(`ops/split_kernels.py::hw_uniforms`), a stream that equals neither the
kernels' on the card nor the TPU's, so they are held in distribution: the
bonded pair of tests/gibbs_check.py samples its exact
Boltzmann (SA), extended-Gibbs (PIQMC, with and without a bath) and rotor
Gibbs (SVMC) weights; a seed reproduces its result and another seed
differs; chains (and slices) started alike end apart. Against the JAX
`hw_rng=True` path, which its own tests run in the Pallas interpreter
with a stubbed generator (tests/test_pallas_split.py:115, :368), the
check is a smoke check: both return valid states of the same shape. No
stream is compared there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gibbs_check as gibbs
from test_pallas_split import (oracle_anneal, oracle_qmc, oracle_qmc_bath,
                               oracle_svmc)
from montecarlosolvers_tpu import schedules as jsched
from montecarlosolvers_tpu.models.lattice import LatticeProblem as JLattice
from montecarlosolvers_tpu.ops import pallas_split
from montecarlosolvers_tpu.ops import piqmc as jpiqmc
from montecarlosolvers_tpu_torch import convert
from montecarlosolvers_tpu_torch import schedules as tsched
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import split_kernels as sk

torch.set_num_threads(1)

# the exact-weight checks: chains, and the largest z (gibbs.z_scores) a
# state may show; runs read at most 3.6 over the 256 states of P = 4
CHAINS, Z = 1024, 5.0


def periodic(L, seed):
    r = np.random.default_rng(seed)
    return JLattice.from_planes(r.normal(size=(L, L)), r.normal(size=(L, L)))


def port_of(lat):
    return convert.lattice_from_arrays(
        np.asarray(lat.j_right), np.asarray(lat.j_down),
        np.asarray(lat.h_plane), col_wrap=lat.col_wrap, device="cpu")


def _spins(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.choice([-1.0, 1.0], size=shape).astype(np.float32)


def _engines(lat, hw_rng, seed):
    """name -> (run(seed) of the port with `hw_rng`, the JAX oracle's
    result at that seed), on the lattice `lat` (JAX) at L = 16."""
    tl = port_of(lat)
    L = lat.L
    s0 = _spins((2, L * L), 1)
    confs = _spins((2, 4, L * L), 2)
    theta = (np.random.default_rng(3).random((2, L * L)) * np.pi).astype(
        np.float32)
    sched = np.linspace(3.0, 0.1, 12).astype(np.float32)
    a = np.linspace(2.5, 1e-8, 8).astype(np.float32)
    b = np.ones_like(a)
    lut = np.asarray(jsched.bath_lookuptable(4, 0.1), dtype=np.float32)
    t = torch.from_numpy
    return {
        "sa": (lambda sd: sk.anneal_lattice_split(
            tl, t(sched), t(s0), sd, hw_rng=hw_rng),
            lambda sd: oracle_anneal(lat, sched, jnp.asarray(s0), sd)),
        "qmc": (lambda sd: sk.anneal_lattice_qmc_split(
            tl, t(a), t(b), 0.25, t(confs), sd, global_moves=True,
            hw_rng=hw_rng),
            lambda sd: oracle_qmc(lat, a, b, 0.25, jnp.asarray(confs), sd,
                                  True)),
        "bath": (lambda sd: sk.anneal_lattice_qmc_bath_split(
            tl, t(a), t(b), 0.25, lut, t(confs), sd, global_moves=True,
            hw_rng=hw_rng),
            lambda sd: oracle_qmc_bath(lat, a, b, 0.25, lut,
                                       jnp.asarray(confs), sd, True)),
        "svmc": (lambda sd: sk.anneal_lattice_svmc_split(
            tl, t(a), t(b), 0.05, t(theta), sd, tf=True, hw_rng=hw_rng),
            lambda sd: oracle_svmc(lat, a, b, 0.05, jnp.asarray(theta), sd,
                                   True)),
    }


@pytest.mark.parametrize("engine", ["sa", "qmc", "bath", "svmc"])
def test_hw_rng_false_equals_the_oracles(engine):
    """hw_rng=False, passed explicitly, is the counter-hash path: bitwise
    equal to the oracle (SVMC angles to 2e-5, XLA's FMA contraction of the
    TF proposal; ROADMAP.md queue 3)."""
    run, oracle = _engines(periodic(16, 5), False, 7)[engine]
    out, ref = run(7).numpy(), np.asarray(oracle(7))
    if engine == "svmc":
        np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)
    else:
        assert np.array_equal(out, ref)


@pytest.mark.parametrize("engine", ["sa", "qmc", "bath", "svmc"])
def test_hw_rng_seed_reproduces_and_differs(engine):
    run, oracle = _engines(periodic(16, 5), True, 7)[engine]
    out = run(7)
    assert torch.equal(out, run(7))
    assert not torch.equal(out, run(8))
    # and it is not the hash's stream
    assert not np.array_equal(out.numpy(), np.asarray(oracle(7)))


def test_hw_uniforms_are_24_bit_and_uniform():
    u = sk.hw_uniforms(3, torch.device("cpu"))((1 << 16,))
    assert u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert torch.equal(u * (1 << 24), torch.round(u * (1 << 24)))
    # mean 1/2 and variance 1/12 to 5 standard errors of 65536 draws
    assert abs(float(u.mean()) - 0.5) < 5 * (1 / 12) ** 0.5 / 256
    assert abs(float(u.var()) - 1 / 12) < 5 * 0.0745 / 256


@pytest.mark.parametrize("engine", ["sa", "qmc", "bath", "svmc"])
def test_hw_rng_plain_samples_exact_weights(engine):
    """The plain versions with hw_rng=True, through the wrappers on CPU
    tensors, on the bonded pair of an open 4 x 4 lattice (gibbs_check.py):
    SA at T = 1 over the 4 pair states, PIQMC at P = 4, T = 0.45,
    Gamma = 0.6 over the pair's 256 line states, the bath
    at P = 3 (64 states, alpha = 0.1), SVMC with uniform proposals at
    A = 0.6, B = 1, T = 0.7 (<E_pair> and <cos t0> against quadrature).
    Every state's frequency within Z standard errors of the chain means
    (floored at the independent-sample error) of its exact weight, with
    global moves on for the PIQMC engines."""
    name = {"sa": "split_sa", "qmc": "split_qmc", "bath": "split_qmc_bath",
            "svmc": "split_svmc"}[engine]
    sample, exact, S, _ = gibbs.CASES[name]
    f = sample(gibbs.ENGINES[name][0], gibbs.pair_lattice(4, "cpu"), CHAINS)
    z, d = gibbs.z_scores(f, exact, S)
    assert z < Z, (z, d)


def test_exact_weights_separate_the_models():
    """The checks have power: the bath, J_perp and T each move the exact
    weights by far more than the samplers' standard errors (about 0.001
    for the largest weights at CHAINS chains)."""
    jp = gibbs.jperp(0.6, 3, 0.45)
    with_bath = gibbs.qmc_weights(3, 0.45, jp,
                                  bath=gibbs.bath_matrix(3, 0.1))
    assert np.abs(with_bath - gibbs.qmc_weights(3, 0.45, jp)).max() > 0.01
    assert np.abs(gibbs.qmc_weights(4, 0.45, jp)
                  - gibbs.qmc_weights(4, 0.45, 0.5 * jp)).max() > 0.01
    assert np.abs(gibbs.sa_weights(1.0) - gibbs.sa_weights(1.2)).max() > 0.01


@pytest.mark.parametrize("P", [3, 4, 40])
def test_exact_weights_formulas_equal_the_jax_package(P):
    """The exact weights' J_perp and bath matrix, written out in
    gibbs_check.py from their formulas in float64, equal the JAX package's
    `schedules.jperp` and `ops/piqmc.py::bath_matrix` (of its
    `bath_lookuptable`) to float32 rounding, so the reference the samplers
    are held to shares no code with the port's engines. J_perp to 1e-4:
    the JAX function takes ln of a float32 tanh near 1 at small Gamma /
    T_eff, which keeps about 5 digits."""
    for gamma, temp in ((0.6, 0.45), (3.0, 1.0 / P)):
        want = float(jsched.jperp(jnp.float32(gamma), jnp.float32(P * temp)))
        assert gibbs.jperp(gamma, P, temp) == pytest.approx(want, rel=1e-4)
    for alpha in (0.1, 1e-2):
        want = np.asarray(jpiqmc.bath_matrix(
            jsched.bath_lookuptable(P, alpha), P))
        np.testing.assert_allclose(gibbs.bath_matrix(P, alpha), want,
                                   rtol=1e-6, atol=0)


def test_hw_rng_streams_independent():
    """Chains started alike end apart, and so do the slices of a chain:
    no two share their draws."""
    tl = port_of(periodic(16, 5))
    one = torch.from_numpy(_spins((256,), 4))
    out = sk.anneal_lattice_split(tl, tsched.linear(3.0, 0.5, 10,
                                                    device="cpu"),
                                  one.expand(64, 256).contiguous(), 3,
                                  hw_rng=True)
    assert torch.unique(out, dim=0).shape[0] == 64
    g = torch.full((2,), 3.0)
    for fn, extra in ((sk.anneal_lattice_qmc_split, ()),
                      (sk.anneal_lattice_qmc_bath_split,
                       (tsched.bath_lookuptable(8, 0.01, device="cpu"),))):
        lines = one.expand(4, 8, 256).contiguous()
        out = fn(tl, g, torch.ones_like(g), 1.0 / 8, *extra, lines, 3,
                 global_moves=True, hw_rng=True)
        assert torch.unique(out.reshape(4, -1), dim=0).shape[0] == 4
        assert all(torch.unique(c, dim=0).shape[0] == 8 for c in out)


@pytest.mark.parametrize("engine", ["sa", "qmc", "bath", "svmc"])
def test_hw_rng_on_the_cpu_launches_nothing(engine):
    """A CPU tensor takes the plain version with hw_rng too."""
    run, _ = _engines(periodic(16, 5), True, 7)[engine]
    _build.reset_launches()
    assert run(1).device.type == "cpu"
    assert not any(_build.LAUNCHES.values())


@pytest.mark.parametrize("engine", ["sa", "qmc", "bath", "svmc"])
def test_jax_hw_rng_and_port_return_valid_states(engine):
    """Smoke check, not a stream comparison: at the shapes of the JAX
    interpreter tests (L = 16, 2 chains), the JAX hw_rng=True path in the
    Pallas interpreter (a stubbed generator) and the port's hw_rng=True
    path return valid states of the same shape."""
    lat = periodic(16, 5)
    tl = port_of(lat)
    rng = np.random.default_rng(2)
    a = np.linspace(2.0, 1e-8, 6).astype(np.float32)
    b = np.ones_like(a)
    if engine == "sa":
        s0 = _spins((2, 256), 3)
        sched = np.linspace(2.0, 0.0, 6).astype(np.float32)
        ref = pallas_split.anneal_lattice_split(
            lat, sched, jnp.asarray(s0), seed=1, interpret=True, hw_rng=True)
        out = sk.anneal_lattice_split(tl, torch.from_numpy(sched),
                                      torch.from_numpy(s0), 1, hw_rng=True)
    elif engine in ("qmc", "bath"):
        confs = rng.choice([-1.0, 1.0], size=(2, 4, 256)).astype(np.float32)
        if engine == "qmc":
            ref = pallas_split.anneal_lattice_qmc_split(
                lat, a, b, 0.25, jnp.asarray(confs), seed=1,
                global_moves=True, interpret=True, hw_rng=True)
            out = sk.anneal_lattice_qmc_split(
                tl, torch.from_numpy(a), torch.from_numpy(b), 0.25,
                torch.from_numpy(confs), 1, global_moves=True, hw_rng=True)
        else:
            lut = np.asarray(jsched.bath_lookuptable(4, 1e-2), np.float32)
            ref = pallas_split.anneal_lattice_qmc_bath_split(
                lat, a, b, 0.25, lut, jnp.asarray(confs), seed=1,
                interpret=True, hw_rng=True)
            out = sk.anneal_lattice_qmc_bath_split(
                tl, torch.from_numpy(a), torch.from_numpy(b), 0.25, lut,
                torch.from_numpy(confs), 1, hw_rng=True)
    else:
        theta = (rng.random((2, 256)) * np.pi).astype(np.float32)
        ref = pallas_split.anneal_lattice_svmc_split(
            lat, a, b, 0.05, jnp.asarray(theta), seed=1, tf=True,
            interpret=True, hw_rng=True)
        out = sk.anneal_lattice_svmc_split(
            tl, torch.from_numpy(a), torch.from_numpy(b), 0.05,
            torch.from_numpy(theta), 1, tf=True, hw_rng=True)
    ref, out = np.asarray(ref), out.numpy()
    assert ref.shape == out.shape
    for x in (ref, out):
        if engine == "svmc":
            assert np.all((x >= 0.0) & (x <= np.float32(np.pi)))
        else:
            assert set(np.unique(x)) <= {-1.0, 1.0}
