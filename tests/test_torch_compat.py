"""The port's compat layer (montecarlosolvers_tpu_torch/compat.py) against
the JAX package's (montecarlosolvers_tpu/compat.py), on the CPU.

- the 13 cases of tests/test_compat.py on the port (device="cpu"): the
  reference's exact API surface, reference-format tables, in-place
  mutation, the (N, P) confs layout;
- bitwise against JAX on the same numpy input: GenerateNeighbors,
  ClassicalIsingEnergy, bits2spins, spins2bits, `_split_noisy`'s problem
  tables and per-step j_t / h_t, and `_problem(nbs)`'s coloring and
  packed tables;
- each shim equal, bitwise, to the port's solver called directly with the
  generator the shim derives from its seed (`compat._key`): the layout and
  the in-place write;
- in distribution: Anneal, QuantumAnnealGlobal, DissipativeQuantumAnneal-
  WC3 and SpinVectorMonteCarloTF give a mean final energy within 5
  combined standard errors of the JAX shim's, over 64 seeds a side, on
  tests/test_compat.py's 4x4 instance. The port's shims draw from a
  torch.Generator and the JAX shims from jax.random, so the two agree
  only in distribution;
- the package's public names cover the JAX package's.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import montecarlosolvers_tpu as jtop
import montecarlosolvers_tpu_torch as ttop
from montecarlosolvers_tpu import compat as jcompat
from montecarlosolvers_tpu.models import instances as jinst
from montecarlosolvers_tpu.ops import packed as jpk
from montecarlosolvers_tpu_torch import compat
from montecarlosolvers_tpu_torch.models import instances
from montecarlosolvers_tpu_torch.ops import packed as tpk
from montecarlosolvers_tpu_torch.solvers import qmc, sa, svmc

torch.set_num_threads(1)
CPU = dict(device="cpu")
Z = 5.0  # combined standard errors two means may differ by
SEEDS = 64


@pytest.fixture
def small(rng):
    prob, (rows, cols, vals) = instances.random_2d_lattice(4, rng=rng,
                                                           device="cpu")
    J = instances.dense_matrix(16, rows, cols, vals)
    nbs = compat.GenerateNeighbors(16, J, 4)
    return nbs, J


def _lut(P, alpha=0.01):
    return np.asarray(
        alpha * (np.pi / (P * np.sin(np.pi * np.arange(1, P) / P))) ** 2)


# ------------------------------------------ tests/test_compat.py's cases


class TestTools:
    def test_generate_neighbors_format(self, small):
        nbs, J = small
        assert nbs.shape == (16, 4, 2)

    def test_classical_ising_energy(self, small, rng):
        nbs, J = small
        s = rng.choice([-1.0, 1.0], size=16)
        e = compat.ClassicalIsingEnergy(s, J)
        assert np.isfinite(e)

    def test_bits_spins(self):
        assert list(np.asarray(compat.bits2spins(np.array([0, 1])))) == [1, -1]


class TestSA:
    def test_anneal_in_place(self, small, rng):
        nbs, J = small
        svec = rng.choice([-1, 1], size=16).astype(np.float64)
        before = svec.copy()
        sched = np.linspace(3.0, 0.0, 200)
        compat.Anneal(sched, 1, svec, nbs, seed=0, **CPU)
        assert not np.array_equal(svec, before)
        assert set(np.unique(svec)) <= {-1.0, 1.0}
        e_before = compat.ClassicalIsingEnergy(before, J)
        e_after = compat.ClassicalIsingEnergy(svec, J)
        assert e_after < e_before

    def test_aliases(self, small, rng):
        nbs, _ = small
        sched = np.linspace(2.0, 0.1, 30)
        for fn in (compat.AnnealMA, compat.Anneal_parallel):
            svec = rng.choice([-1, 1], size=16).astype(np.float64)
            fn(sched, 1, svec, nbs, seed=1, **CPU)
            assert set(np.unique(svec)) <= {-1.0, 1.0}

    def test_noisy_anneal(self, small, rng):
        nbs, _ = small
        steps = 20
        nbs4d = np.broadcast_to(nbs, (steps,) + nbs.shape).copy()
        svec = rng.choice([-1, 1], size=16).astype(np.float64)
        compat.NoisyAnneal(np.linspace(2.0, 0.1, steps), 1, svec, nbs4d,
                           seed=2, **CPU)
        assert set(np.unique(svec)) <= {-1.0, 1.0}


class TestQMC:
    def test_quantum_anneal_layout_and_inplace(self, small, rng):
        nbs, J = small
        P = 6
        confs = np.tile(rng.choice([-1, 1], size=16),
                        (P, 1)).T.astype(np.float64)
        assert confs.shape == (16, P)  # reference layout (qmc.pyx:69)
        A = np.linspace(2.5, 1e-8, 60)
        B = np.ones_like(A)
        compat.QuantumAnnealGlobal(A, B, 1, 1.0 / P, confs, nbs, seed=3,
                                   **CPU)
        assert confs.shape == (16, P)
        assert set(np.unique(confs)) <= {-1.0, 1.0}
        best = min(compat.ClassicalIsingEnergy(confs[:, k], J)
                   for k in range(P))
        assert np.isfinite(best)

    def test_all_qmc_variants_run(self, small, rng):
        nbs, _ = small
        P = 4
        A = np.linspace(2.0, 1e-8, 8)
        B = np.ones_like(A)
        lut = _lut(P)
        kw = dict(seed=4, **CPU)
        variants = [
            lambda c: compat.QuantumAnneal(A, B, 1, 0.25, c, nbs, **kw),
            lambda c: compat.DissipativeQuantumAnneal(A, B, 1, 0.25, lut, c,
                                                      nbs, **kw),
            lambda c: compat.DissipativeQuantumAnnealGlobal(
                A, B, 1, 0.25, lut, c, nbs, **kw),
            lambda c: compat.QuantumAnnealWCL(A, B, 1, 0.25, c, nbs, **kw),
            lambda c: compat.DissaptiveQuantumAnnealWCL(A, B, 1, 0.25, lut,
                                                        c, nbs, **kw),
            lambda c: compat.QuantumAnnealWC(A, B, 1, 0.25, c, nbs, **kw),
            lambda c: compat.DissipativeQuantumAnnealWC2(A, B, 1, 0.25, lut,
                                                         c, nbs, **kw),
            lambda c: compat.DissipativeQuantumAnnealWC3(A, B, 1, 0.25, lut,
                                                         c, nbs, **kw),
        ]
        for fn in variants:
            confs = np.tile(rng.choice([-1, 1], size=16),
                            (P, 1)).T.astype(np.float64)
            fn(confs)
            assert set(np.unique(confs)) <= {-1.0, 1.0}, fn


class TestSVMC:
    def test_svmc_variants(self, small, rng):
        nbs, _ = small
        A = np.linspace(2.0, 1e-8, 30)
        B = np.ones_like(A)
        for fn in (compat.SpinVectorMonteCarlo,
                   compat.SpinVectorMonteCarloTF):
            svec = rng.uniform(0, np.pi, size=16)
            fn(A, B, 1, 0.1, svec, nbs, seed=5, **CPU)
            assert svec.min() >= 0 and svec.max() <= np.pi + 1e-6

    def test_compact_batched(self, small, rng):
        nbs, _ = small
        A = np.linspace(2.0, 1e-8, 20)
        B = np.ones_like(A)
        svec = rng.uniform(0, np.pi, size=(5, 16))
        compat.SpinVectorMonteCarloTFCompact(A, B, 1, 0.1, svec, nbs, seed=6,
                                             **CPU)
        assert svec.shape == (5, 16)
        assert svec.min() >= 0 and svec.max() <= np.pi + 1e-6

    def test_noisy_svmc(self, small, rng):
        nbs, _ = small
        steps = 15
        nbs4d = np.broadcast_to(nbs, (steps,) + nbs.shape).copy()
        A = np.linspace(2.0, 1e-8, steps)
        svec = rng.uniform(0, np.pi, size=16)
        compat.NoisySVMCTF(A, np.ones_like(A), 1, 0.1, svec, nbs4d, seed=7,
                           **CPU)
        assert svec.min() >= 0 and svec.max() <= np.pi + 1e-6


class TestDeterminism:
    def test_same_seed_reproduces(self, small, rng):
        nbs, _ = small
        sched = np.full(30, 2.5)
        base = rng.choice([-1, 1], size=16).astype(np.float64)
        a = base.copy()
        compat.Anneal(sched, 1, a, nbs, seed=11, **CPU)
        b = base.copy()
        compat.Anneal(sched, 1, b, nbs, seed=11, **CPU)
        c = base.copy()
        compat.Anneal(sched, 1, c, nbs, seed=12, **CPU)
        assert np.array_equal(a, b)
        assert not np.array_equal(a, c)

    def test_rng_object_accepted(self, small, rng):
        nbs, _ = small
        sched = np.linspace(2.0, 0.1, 20)
        svec = rng.choice([-1, 1], size=16).astype(np.float64)
        compat.Anneal(sched, 1, svec, nbs, seed=np.random.RandomState(3),
                      **CPU)
        compat.Anneal(sched, 1, svec, nbs, seed=np.random.default_rng(3),
                      **CPU)
        assert set(np.unique(svec)) <= {-1.0, 1.0}


# ------------------------------------------------------ bitwise with JAX


def test_tools_equal_jax(rng):
    _, (rows, cols, vals) = jinst.random_2d_lattice(5, rng=1,
                                                    with_fields=True)
    J = jinst.dense_matrix(25, rows, cols, vals)
    for src in (J, {(int(a), int(b)): float(v)
                    for a, b, v in zip(rows, cols, vals)}):
        want = jcompat.GenerateNeighbors(25, src, 5)
        got = compat.GenerateNeighbors(25, src, 5)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    s = rng.choice([-1.0, 1.0], size=25)
    assert compat.ClassicalIsingEnergy(s, J) == \
        jcompat.ClassicalIsingEnergy(s, J)
    bits = rng.integers(0, 2, size=30)
    assert np.array_equal(np.asarray(compat.bits2spins(bits)),
                          np.asarray(jcompat.bits2spins(jnp.asarray(bits))))
    spins = rng.choice([-1, 1], size=30)
    assert np.array_equal(np.asarray(compat.spins2bits(spins)),
                          np.asarray(jcompat.spins2bits(jnp.asarray(spins))))


def _same_problem(port, jprob):
    for name in ("nbr_idx", "nbr_J", "h", "color_masks"):
        assert np.array_equal(getattr(port, name).numpy(),
                              np.asarray(getattr(jprob, name))), name
    jpg, tpg = jpk.build_packed(jprob), tpk.build_packed(port)
    assert tuple(tpg.perm.tolist()) == jpg.perm
    assert tpg.starts == jpg.starts
    for name in ("nbr_idx", "nbr_J", "h"):
        assert np.array_equal(getattr(tpg, name).numpy(),
                              np.asarray(getattr(jpg, name))), name


@pytest.mark.parametrize("case", ["lattice", "fields", "chimera"])
def test_problem_of_a_table_equals_jax(case):
    """compat._problem(nbs): the same tables, coloring and class-major
    packing as the JAX shim's IsingProblem.from_neighbor_table, and one
    cached problem a table and device."""
    if case == "chimera":
        _, (rows, cols, vals) = jinst.chimera_graph(2, rng=0)
        n, maxnb = 32, 6
    else:
        _, (rows, cols, vals) = jinst.random_2d_lattice(
            5, rng=2, with_fields=case == "fields")
        n, maxnb = 25, 5
    nbs = jcompat.GenerateNeighbors(
        n, jinst.dense_matrix(n, rows, cols, vals), maxnb)
    port = compat._problem(nbs, "cpu")
    _same_problem(port, jcompat._problem(nbs))
    assert compat._problem(nbs.copy(), "cpu") is port


def test_split_noisy_equals_jax(rng):
    """The topology union over time, the problem and the per-step tables:
    a coupling zero at step 0 still colors as an edge."""
    _, (rows, cols, vals) = jinst.random_2d_lattice(4, rng=3,
                                                    with_fields=True)
    nbs = jcompat.GenerateNeighbors(
        16, jinst.dense_matrix(16, rows, cols, vals), 5)
    steps = 6
    nbs4d = np.broadcast_to(nbs, (steps,) + nbs.shape).copy()
    nbs4d[..., 1] *= 1.0 + 0.1 * rng.normal(size=nbs4d.shape[:-1])
    nbs4d[:3, 0, 0, 1] = 0.0  # an edge that switches on at step 3
    jprob, jj, jh = jcompat._split_noisy(nbs4d)
    prob, tj, th = compat._split_noisy(nbs4d, "cpu")
    _same_problem(prob, jprob)
    assert tj.dtype == th.dtype == torch.float32
    assert np.array_equal(tj.numpy(), np.asarray(jj))
    assert np.array_equal(th.numpy(), np.asarray(jh))


# ------------------------------------- each shim is its solver, bitwise


def _table(rng):
    _, (rows, cols, vals) = instances.random_2d_lattice(4, rng=rng,
                                                         device="cpu")
    J = instances.dense_matrix(16, rows, cols, vals)
    return compat.GenerateNeighbors(16, J, 4)


def test_key_derives_the_generator():
    draw = [torch.randint(0, 2**31 - 1, (3,), generator=compat._key(s, "cpu"))
            for s in (5, 5, 6)]
    assert torch.equal(draw[0], draw[1]) and not torch.equal(draw[0],
                                                             draw[2])
    a = compat._key(np.random.default_rng(4), "cpu").initial_seed()
    assert a == int(np.random.default_rng(4).integers(2 ** 63))
    b = compat._key(np.random.RandomState(4), "cpu").initial_seed()
    assert b == int(np.random.RandomState(4).randint(2 ** 31))
    assert compat._key(None, "cpu").initial_seed() != \
        compat._key(None, "cpu").initial_seed()


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64])
def test_sa_shims_are_their_solver(rng, dtype):
    nbs = _table(rng)
    prob = compat._problem(nbs, "cpu")
    sched = np.linspace(2.5, 0.1, 25)
    s0 = rng.choice([-1, 1], size=(3, 16)).astype(dtype)
    svec = s0.copy()
    compat.Anneal(sched, 2, svec, nbs, seed=9, **CPU)
    want = sa.anneal(prob, torch.as_tensor(sched.astype(np.float32)),
                     torch.as_tensor(s0.astype(np.float32)),
                     compat._key(9, "cpu"), mcsteps=2)
    assert svec.dtype == dtype
    assert np.array_equal(svec, want.numpy().astype(dtype))
    for fn in (compat.AnnealMA, compat.Anneal_parallel):
        other = s0.copy()
        fn(sched, 2, other, nbs, seed=9, **CPU)
        assert np.array_equal(other, svec)
    # NoisyAnneal: sa.anneal_noisy on _split_noisy's tables
    nbs4d = np.broadcast_to(nbs, (25,) + nbs.shape).copy()
    nbs4d[..., 1] *= 1.0 + 0.1 * rng.normal(size=nbs4d.shape[:-1])
    svec = s0.copy()
    compat.NoisyAnneal(sched, 1, svec, nbs4d, seed=9, **CPU)
    p4, jt, ht = compat._split_noisy(nbs4d, "cpu")
    want = sa.anneal_noisy(p4, torch.as_tensor(sched.astype(np.float32)),
                           jt, ht, torch.as_tensor(s0.astype(np.float32)),
                           compat._key(9, "cpu"))
    assert np.array_equal(svec, want.numpy().astype(dtype))


QMC_SHIMS = {
    "QuantumAnneal": (qmc.anneal, {}, False),
    "DissipativeQuantumAnneal": (qmc.anneal, {}, True),
    "QuantumAnnealGlobal": (qmc.anneal, {"global_moves": True}, False),
    "DissipativeQuantumAnnealGlobal": (qmc.anneal, {"global_moves": True},
                                       True),
    "QuantumAnnealWCL": (qmc.anneal_wolff, {"rule": "local"}, False),
    "DissaptiveQuantumAnnealWCL": (qmc.anneal_wolff, {"rule": "local"},
                                   True),
    "QuantumAnnealWC": (qmc.anneal_wolff, {"rule": "full"}, False),
    "DissipativeQuantumAnnealWC2": (qmc.anneal_sw_bath,
                                    {"per_slice_seeds": False}, True),
    "DissipativeQuantumAnnealWC3": (qmc.anneal_sw_bath,
                                    {"per_slice_seeds": True}, True),
}


@pytest.mark.parametrize("name", list(QMC_SHIMS))
def test_qmc_shims_are_their_solver(rng, name):
    """(N, P) confs in, (P, N) to the solver, (N, P) written back in
    place in the caller's dtype."""
    nbs = _table(rng)
    prob = compat._problem(nbs, "cpu")
    fn, kw, bath = QMC_SHIMS[name]
    P = 4
    A, B = np.linspace(2.0, 1e-8, 6), np.full(6, 0.9)
    lut = _lut(P)
    c0 = np.tile(rng.choice([-1, 1], size=16), (P, 1)).T.astype(np.float64)
    c0[rng.random(c0.shape) < 0.2] *= -1
    confs = c0.copy()
    args = (A, B, 1, 0.25) + ((lut,) if bath else ()) + (confs, nbs)
    getattr(compat, name)(*args, seed=13, **CPU)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))  # noqa: E731
    c = f32(c0.T)
    gen = compat._key(13, "cpu")
    if fn is qmc.anneal_sw_bath:
        want = fn(prob, f32(A), f32(B), 0.25, f32(lut), c, gen, **kw)
    else:
        want = fn(prob, f32(A), f32(B), 0.25, c, gen,
                  lookuptable=f32(lut) if bath else None, **kw)
    assert confs.shape == (16, P)
    assert np.array_equal(confs, want.numpy().T.astype(np.float64))


@pytest.mark.parametrize("tf", [False, True])
def test_svmc_shims_are_their_solver(rng, tf):
    nbs = _table(rng)
    prob = compat._problem(nbs, "cpu")
    A, B = np.linspace(2.0, 1e-8, 12), np.ones(12)
    th0 = rng.uniform(0, np.pi, size=(4, 16))
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))  # noqa: E731
    plain, compact = ((compat.SpinVectorMonteCarloTF,
                       compat.SpinVectorMonteCarloTFCompact) if tf else
                      (compat.SpinVectorMonteCarlo,
                       compat.SpinVectorMonteCarloCompact))
    want = svmc.anneal(prob, f32(A), f32(B), 0.1, f32(th0),
                       compat._key(21, "cpu"), tf=tf).numpy()
    for fn in (plain, compact):
        th = th0.copy()
        fn(A, B, 1, 0.1, th, nbs, seed=21, **CPU)
        assert np.array_equal(th, want.astype(np.float64))
    nbs4d = np.broadcast_to(nbs, (12,) + nbs.shape).copy()
    nbs4d[..., 1] *= 1.0 + 0.1 * rng.normal(size=nbs4d.shape[:-1])
    p4, jt, ht = compat._split_noisy(nbs4d, "cpu")
    want = svmc.anneal_noisy(p4, f32(A), f32(B), 0.1, jt, ht, f32(th0),
                             compat._key(21, "cpu"), tf=tf).numpy()
    th = th0.copy()
    (compat.NoisySVMCTF if tf else compat.NoisySVMC)(
        A, B, 1, 0.1, th, nbs4d, seed=21, **CPU)
    assert np.array_equal(th, want.astype(np.float64))


# --------------------------------------------------- in distribution


def _energies(mod, name, nbs, J, seeds, device_kw):
    """Final energy of shim `name` of module `mod` from seed s's start, for
    each seed s: SA and SVMC the state's (SVMC its z-projection), PIQMC the
    mean over slices."""
    P = 4
    out = []
    for s in seeds:
        r = np.random.default_rng(1000 + s)
        if name == "Anneal":
            x = r.choice([-1.0, 1.0], size=16)
            mod.Anneal(np.linspace(3.0, 0.2, 40), 1, x, nbs, seed=s,
                       **device_kw)
            out.append(mod.ClassicalIsingEnergy(x, J))
        elif name == "SpinVectorMonteCarloTF":
            x = r.uniform(0, np.pi, size=16)
            A = np.linspace(2.0, 1e-8, 40)
            mod.SpinVectorMonteCarloTF(A, np.ones_like(A), 1, 0.1, x, nbs,
                                       seed=s, **device_kw)
            z = np.where(np.cos(x) >= 0, 1.0, -1.0)
            out.append(mod.ClassicalIsingEnergy(z, J))
        else:
            c = np.tile(r.choice([-1.0, 1.0], size=16), (P, 1)).T.copy()
            A = np.linspace(2.0, 1e-8, 20)
            B = np.ones_like(A)
            if name == "QuantumAnnealGlobal":
                mod.QuantumAnnealGlobal(A, B, 1, 0.25, c, nbs, seed=s,
                                        **device_kw)
            else:
                mod.DissipativeQuantumAnnealWC3(A, B, 1, 0.25, _lut(P, 0.1),
                                                c, nbs, seed=s, **device_kw)
            out.append(np.mean([mod.ClassicalIsingEnergy(c[:, k], J)
                                for k in range(P)]))
    return np.asarray(out)


@pytest.mark.parametrize("name", ["Anneal", "QuantumAnnealGlobal",
                                  "DissipativeQuantumAnnealWC3",
                                  "SpinVectorMonteCarloTF"])
def test_shims_match_jax_in_distribution(name):
    _, (rows, cols, vals) = instances.random_2d_lattice(
        4, rng=np.random.default_rng(0), device="cpu")
    J = instances.dense_matrix(16, rows, cols, vals)
    nbs = compat.GenerateNeighbors(16, J, 4)
    seeds = range(SEEDS)
    ours = _energies(compat, name, nbs, J, seeds, CPU)
    theirs = _energies(jcompat, name, nbs, J, seeds, {})
    se = np.sqrt(ours.var(ddof=1) / len(ours)
                 + theirs.var(ddof=1) / len(theirs))
    assert abs(ours.mean() - theirs.mean()) <= Z * se + 1e-9, (
        ours.mean(), theirs.mean(), se)


# ------------------------------------------------------- public names


def test_public_names_cover_jax():
    assert list(compat.__all__) == list(jcompat.__all__)
    for name in compat.__all__:
        assert callable(getattr(compat, name)), name
    assert set(jtop.__all__) <= set(ttop.__all__)
    for name in ("generate_neighbors", "classical_ising_energy",
                 "bits2spins", "spins2bits"):
        assert getattr(ttop, name) is getattr(
            __import__("montecarlosolvers_tpu_torch.models.ising",
                       fromlist=[name]), name)
