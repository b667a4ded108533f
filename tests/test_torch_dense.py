"""The port's dense engine on a DenseProblem against the JAX package's.

The problem (energies, fields, storage conventions, `sk_model`) against
the JAX DenseProblem; one plain sweep (`ops/dense_sweep.py`) against the
JAX `dense_metropolis_sweep` on the JAX sweep's own `jax.random` uniforms
and permutation: bitwise on +/-1 couplings, whose sums are exact in any
order, and with 0 mismatched spins on Gaussian couplings at these sizes
(XLA's and torch's CPU products may add in other orders; a mismatch would
be traced to that and recorded in ROADMAP.md queue 3). The counter-hash
anneals of `ops/dense_kernels.py` sample the exact Gibbs weights of a
3-spin problem (tests/test_dense.py's cases), and `sa.anneal` / `solve`
route a DenseProblem to them. The kernel (csrc/dense_sa.cu) is held to
its plain version in tests/test_torch_gpu.py and chip_smoke.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from montecarlosolvers_tpu.models import instances as jinst
from montecarlosolvers_tpu.models.dense import DenseProblem as JDense
from montecarlosolvers_tpu.ops import dense_sweep as jds
from montecarlosolvers_tpu_torch import convert
from montecarlosolvers_tpu_torch import schedules as tsched
from montecarlosolvers_tpu_torch.models import instances as tinst
from montecarlosolvers_tpu_torch.models.dense import DenseProblem
from montecarlosolvers_tpu_torch.models.ising import IsingProblem
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import dense_kernels as dk
from montecarlosolvers_tpu_torch.ops import dense_sweep as ds
from montecarlosolvers_tpu_torch.solvers import api, qmc, sa, svmc

torch.set_num_threads(1)

# tests/test_dense.py's 3-spin problem with fields, upper-triangular storage
GIBBS_J = np.array([[0.3, 1.0, 0.5], [0.0, -0.2, -0.7], [0.0, 0.0, 0.4]])
GIBBS_T = 1.5
STATES3 = (((np.arange(8)[:, None] >> np.arange(3)) & 1) * 2 - 1).astype(
    np.float32)


def both(J, h=None):
    """(the port's DenseProblem, the JAX one) of the same matrix."""
    return (DenseProblem.from_couplings(J, h, device="cpu"),
            JDense.from_couplings(J, h))


def spins(shape, seed):
    return np.random.default_rng(seed).choice([-1.0, 1.0], size=shape).astype(
        np.float32)


def t32(x):
    return torch.tensor(x, dtype=torch.float32)


# ------------------------------------------------------------ the problem


@pytest.mark.parametrize("storage", ["full", "upper", "symmetric"])
def test_problem_equals_jax(storage):
    rng = np.random.default_rng(1)
    n = 11
    raw = rng.normal(size=(n, n))
    J = {"full": raw, "upper": np.triu(raw),
         "symmetric": raw + raw.T}[storage]
    port, jdp = both(J, rng.normal(size=n))
    assert np.array_equal(port.J.numpy(), np.asarray(jdp.J))
    assert np.array_equal(port.h.numpy(), np.asarray(jdp.h))
    assert port.nspins == jdp.nspins == n
    s = spins((4, n), 2)
    for name in ("local_fields", "energy", "delta_e"):
        got = getattr(port, name)(torch.as_tensor(s)).numpy()
        want = np.asarray(getattr(jdp, name)(jnp.asarray(s)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    carried = convert.dense_from_arrays(np.asarray(jdp.J), np.asarray(jdp.h),
                                        device="cpu")
    assert torch.equal(carried.J, port.J) and torch.equal(carried.h, port.h)


def test_energy_matches_generic():
    """tests/test_dense.py:24 on the port: the dense energies and fields
    equal the generic IsingProblem's of the symmetrized pairs."""
    rng = np.random.default_rng(0)
    n = 10
    raw = rng.normal(size=(n, n))
    dp = DenseProblem.from_couplings(raw, device="cpu")
    Js = raw + raw.T
    rows, cols, vals = [], [], []
    for i in range(n):
        rows.append(i), cols.append(i), vals.append(raw[i, i])
        for j in range(i + 1, n):
            rows.append(i), cols.append(j), vals.append(Js[i, j])
    gen = IsingProblem.from_edges(n, rows, cols, vals, maxnb=n, device="cpu")
    s = torch.as_tensor(spins((5, n), 3))
    torch.testing.assert_close(dp.energy(s), gen.energy(s), rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(dp.local_fields(s), gen.local_fields(s),
                               rtol=1e-4, atol=1e-4)


def test_delta_e_matches_flip():
    dp = DenseProblem.from_couplings(
        np.random.default_rng(4).normal(size=(8, 8)) / np.sqrt(8),
        device="cpu")
    s = torch.as_tensor(spins(8, 5))
    de = dp.delta_e(s)
    for i in range(8):
        s2 = s.clone()
        s2[i] = -s2[i]
        assert abs(float(dp.energy(s2) - dp.energy(s)) - float(de[i])) < 1e-4


def test_symmetric_input_not_doubled():
    """tests/test_dense.py:311 on the port."""
    J = np.array([[0.0, 1.0], [1.0, 0.0]])
    s = torch.ones(2)
    dp = DenseProblem.from_couplings(J, device="cpu")
    assert float(dp.energy(s)) == 1.0
    again = DenseProblem.from_couplings(dp.J.numpy(), device="cpu")
    assert float(again.energy(s)) == float(dp.energy(s))
    assert float(DenseProblem.from_couplings(np.triu(J), device="cpu")
                 .energy(s)) == 1.0


def test_from_edges_and_sk_model_equal_jax():
    port, (r, c, v) = tinst.sk_model(40, rng=3, device="cpu")
    jdp, (jr, jc, jv) = jinst.sk_model(40, rng=3)
    assert isinstance(port, DenseProblem)
    assert np.array_equal(v, jv) and np.array_equal(r, jr)
    assert np.array_equal(port.J.numpy(), np.asarray(jdp.J))
    assert np.array_equal(port.h.numpy(), np.asarray(jdp.h))
    diag = np.array([0, 5, 7])
    edges = (np.r_[r[:30], diag], np.r_[c[:30], diag],
             np.r_[v[:30], 0.5, 1, 2])
    port = DenseProblem.from_edges(40, *edges, device="cpu")
    jdp = JDense.from_edges(40, *edges)
    assert np.array_equal(port.J.numpy(), np.asarray(jdp.J))
    assert np.array_equal(port.h.numpy(), np.asarray(jdp.h))
    sparse = tinst.sk_model(6, rng=3, dense=False, device="cpu")[0]
    assert isinstance(sparse, IsingProblem) and sparse.maxnb == 5


# ------------------------------------------- one sweep, JAX's uniforms


def jax_sweep_inputs(key, C, N, block, shuffle):
    """The uniforms and visit order the JAX sweep draws from `key`
    (ops/dense_sweep.py:73-87)."""
    B = min(block, N)
    Np = -(-N // B) * B
    perm = None
    if shuffle:
        kperm, key = jax.random.split(key)
        perm = np.array(jax.random.permutation(kperm, N))
    return np.array(jax.random.uniform(key, (C, Np))), perm


def sweep_pair(J, N, C, block, shuffle, temp, seed, matmul_dtype=None):
    port, jdp = both(J)
    s = spins((C, N), seed)
    key = jax.random.key(seed)
    u, perm = jax_sweep_inputs(key, C, N, block, shuffle)
    want = np.asarray(jds.dense_metropolis_sweep(
        jdp, jnp.asarray(s), key, np.float32(temp), block=block,
        shuffle=shuffle,
        matmul_dtype=None if matmul_dtype is None else jnp.bfloat16))
    got = ds.dense_metropolis_sweep(
        port, torch.as_tensor(s), torch.as_tensor(u), t32(temp), block=block,
        perm=perm, matmul_dtype=matmul_dtype).numpy()
    return got, want, s


@pytest.mark.parametrize("block", [2, 4, 7, 128])
@pytest.mark.parametrize("shuffle", [False, True])
def test_sweep_equals_jax_on_pm1_couplings(block, shuffle):
    N = 23  # a multiple of none of the blocks; 128 takes B = N
    J = np.triu(np.random.default_rng(block).choice([-1.0, 1.0],
                                                      size=(N, N)), k=1)
    got, want, s = sweep_pair(J, N, 6, block, shuffle, 2.5, block)
    assert np.array_equal(got, want)
    assert 0.05 < (want != s).mean() < 0.95


@pytest.mark.parametrize("N,block,shuffle", [(40, 16, False), (37, 8, True),
                                             (130, 128, False)])
def test_sweep_on_gaussian_couplings_mismatches_no_spin(N, block, shuffle):
    J = np.random.default_rng(N).normal(size=(N, N)) / np.sqrt(N)
    got, want, s = sweep_pair(J, N, 5, block, shuffle, 0.8, N)
    assert int((got != want).sum()) == 0
    assert (want != s).any()


def test_bf16_sweep_equals_jax_and_float32_on_pm1_couplings():
    """tests/test_dense.py:180: +/-1 couplings are exact in bfloat16, so
    the bf16 sweep is float32's bitwise, in both packages; and the port's
    bf16 anneal is its float32 anneal bitwise."""
    N = 24
    J = np.triu(np.random.default_rng(6).choice([-1.0, 1.0], size=(N, N)),
                k=1)
    got, want, _ = sweep_pair(J, N, 8, 8, False, 1.5, 6, torch.bfloat16)
    f32, _, _ = sweep_pair(J, N, 8, 8, False, 1.5, 6)
    assert np.array_equal(got, want) and np.array_equal(got, f32)
    dp = DenseProblem.from_couplings(J, device="cpu")
    s0 = torch.as_tensor(spins((8, N), 7))
    temps = tsched.linear(3.0, 0.2, 60, device="cpu")
    a = dk.dense_sa_anneal(dp, temps, s0, 11, block=8)
    b = dk.dense_sa_anneal(dp, temps, s0, 11, block=8,
                           matmul_dtype=torch.bfloat16)
    assert torch.equal(a, b) and not torch.equal(a, s0)


def test_bf16_rounds_the_couplings():
    """On Gaussian couplings the bf16 sweep is the float32 sweep of the
    rounded problem (h unrounded), bitwise."""
    N = 20
    J = np.random.default_rng(8).normal(size=(N, N))
    dp = DenseProblem.from_couplings(J, device="cpu")
    rounded = DenseProblem(J=dp.J.to(torch.bfloat16).float(), h=dp.h)
    s0 = torch.as_tensor(spins((4, N), 9))
    temps = tsched.linear(2.0, 0.1, 10, device="cpu")
    a = dk.dense_sa_anneal(dp, temps, s0, 5, block=6,
                           matmul_dtype=torch.bfloat16)
    assert torch.equal(a, dk.dense_sa_anneal(rounded, temps, s0, 5, block=6))


# ------------------------------------- the counter-hash anneal's streams


def test_visit_order_is_a_seeded_permutation():
    a = dk.visit_order(3, 0, 50, torch.device("cpu"))
    assert sorted(a.tolist()) == list(range(50))
    assert torch.equal(a, dk.visit_order(3, 0, 50, torch.device("cpu")))
    assert not torch.equal(a, dk.visit_order(3, 1, 50, torch.device("cpu")))
    assert not torch.equal(a, dk.visit_order(4, 0, 50, torch.device("cpu")))


@pytest.mark.parametrize("shuffle", [False, True])
def test_anneal_is_sweep_by_sweep_the_plain_sweep(shuffle):
    """dense_sa_anneal's sweep t is `dense_metropolis_sweep` on the hash's
    uniforms (padded positions included) and visit order."""
    N, C, block, seed = 19, 3, 8, 21
    dp = DenseProblem.from_couplings(
        np.random.default_rng(2).normal(size=(N, N)), device="cpu")
    s = torch.as_tensor(spins((C, N), 1))
    temps = tsched.linear(2.0, 0.3, 4, device="cpu")
    got = dk.dense_sa_anneal(dp, temps, s, seed, block=block, shuffle=shuffle)
    want = s
    for t in range(4):
        u = torch.cat([dk.block_uniforms(seed, t, C, 24, start, 8,
                                         torch.device("cpu"))
                       for start in (0, 8, 16)], dim=1)
        perm = (dk.visit_order(seed, t, N, torch.device("cpu")) if shuffle
                else None)
        want = ds.dense_metropolis_sweep(dp, want, u, temps[t], block=block,
                                         perm=perm)
    assert torch.equal(got, want)


# ----------------------------------------------------- Gibbs weights


def gibbs_run(shuffle=False, matmul_dtype=None, chains=64, sweeps=1500,
              burn=100):
    """State frequencies of the 3-spin problem at GIBBS_T, sweep by sweep
    on the counter hash (one seed a sweep), against its exact weights."""
    dp = DenseProblem.from_couplings(GIBBS_J, device="cpu")
    target = dp if matmul_dtype is None else DenseProblem(
        J=dp.J.to(matmul_dtype).float(), h=dp.h)
    es = target.energy(torch.as_tensor(STATES3)).double().numpy()
    w = np.exp(-es / GIBBS_T)
    temps = torch.full((1,), GIBBS_T, dtype=torch.float32)
    s = torch.as_tensor(spins((chains, 3), 0))
    counts = np.zeros(8)
    for t in range(sweeps):
        s = dk.dense_sa_anneal_ref(dp, temps, s, 1000 + t, block=2,
                                   shuffle=shuffle, matmul_dtype=matmul_dtype)
        if t >= burn:
            idx = ((s > 0).long() * torch.tensor([1, 2, 4])).sum(-1)
            counts += np.bincount(idx.numpy(), minlength=8)
    return counts / counts.sum(), w / w.sum()


@pytest.mark.parametrize("case", ["systematic", "shuffled", "bf16"])
def test_anneal_samples_exact_gibbs(case):
    """tests/test_dense.py:56, :116 and :194 on the port's plain anneal:
    the systematic and shuffled scans sample the exact Boltzmann weights,
    and bf16 products the weights of the bf16-rounded problem."""
    p_emp, p_exact = gibbs_run(
        shuffle=case == "shuffled",
        matmul_dtype=torch.bfloat16 if case == "bf16" else None)
    assert np.max(np.abs(p_emp - p_exact)) < 0.01, (p_emp, p_exact)


# ---------------------------------------------------- solvers and API


def test_sa_anneal_routes_dense_problems():
    dp = DenseProblem.from_couplings(
        np.random.default_rng(0).normal(size=(8, 8)), device="cpu")
    gen = torch.Generator().manual_seed(0)
    s0 = sa.random_state(gen, 8, batch=(2, 3), device="cpu")
    sched = tsched.linear(2.0, 0.1, 20, device="cpu")
    _build.reset_launches()
    out = sa.anneal(dp, sched, s0, torch.Generator().manual_seed(1))
    assert out.shape == (2, 3, 8)
    out2, es = sa.anneal(dp, sched, s0, torch.Generator().manual_seed(1),
                         collect_energy=True, mcsteps=2)
    assert es.shape == (40, 2, 3) and out2.shape == (2, 3, 8)
    torch.testing.assert_close(es[-1], dp.energy(out2))
    single = sa.anneal(dp, sched, s0[0, 0], torch.Generator().manual_seed(1))
    assert single.shape == (8,)
    # engine= is ignored on a DenseProblem, as in the JAX solver
    masked = sa.anneal(dp, sched, s0, torch.Generator().manual_seed(1),
                       engine="masked")
    assert torch.equal(masked, out)
    seed = sa.draw_seed(torch.Generator().manual_seed(1))
    ref = dk.dense_sa_anneal_ref(dp, sched, s0.reshape(6, 8), seed)
    assert torch.equal(out, ref.reshape(2, 3, 8))
    assert not any(_build.LAUNCHES.values())


def test_anneal_finds_ground_state():
    """tests/test_dense.py:233 on the port."""
    dp = DenseProblem.from_couplings(
        np.random.default_rng(5).normal(size=(12, 12)) / np.sqrt(12),
        device="cpu")
    states = torch.as_tensor(
        (((np.arange(2 ** 12)[:, None] >> np.arange(12)) & 1) * 2 - 1)
        .astype(np.float32))
    e_gs = float(dp.energy(states).min())
    gen = torch.Generator().manual_seed(0)
    s0 = sa.random_state(gen, 12, batch=(16,), device="cpu")
    out = sa.anneal(dp, tsched.linear(2.0, 0.0, 300, device="cpu"), s0, gen)
    assert abs(float(dp.energy(out).min()) - e_gs) < 1e-3


def test_solve_on_an_sk_model():
    sk = tinst.sk_model(10, rng=0, device="cpu")[0]
    res = api.solve(sk, "sa", num_reads=8, sweeps=150, seed=0)
    assert res.samples.shape == (8, 10)
    assert set(np.unique(res.samples)) <= {-1.0, 1.0}
    np.testing.assert_allclose(
        res.energies, sk.energy(torch.as_tensor(res.samples)).numpy(),
        rtol=1e-6)
    assert np.all(np.diff(res.energies) >= 0)


def test_dense_refusals():
    """solve refuses unknown keywords (tests/test_dense.py:324); the calls
    the JAX package does not run on a DenseProblem stay refused."""
    sk = tinst.sk_model(6, rng=0, device="cpu")[0]
    with pytest.raises(TypeError):
        api.solve(sk, method="sa", num_reads=2, sweeps=10, t_stop=0.5)
    for method in ("piqmc", "svmc"):
        with pytest.raises(NotImplementedError, match="DenseProblem"):
            api.solve(sk, method=method, num_reads=2, sweeps=3)
    gen = torch.Generator().manual_seed(0)
    s = sa.random_state(gen, 6, batch=(2,), device="cpu")
    sched = tsched.linear(1.0, 0.1, 3, device="cpu")
    with pytest.raises(NotImplementedError, match="qmc.anneal"):
        qmc.anneal(sk, sched, torch.ones_like(sched), 0.1,
                   qmc.replicate(s, 2), gen)
    with pytest.raises(NotImplementedError, match="svmc.anneal"):
        svmc.anneal(sk, sched, torch.ones_like(sched), 0.1, s, gen)
    with pytest.raises(ValueError, match="problem on cpu"):
        dk.dense_anneal(sk, sched, s.to("meta"), 0)
    with pytest.raises(ValueError, match="no dense engine"):
        dk.dense_sa_block(s.to("meta"), s.to("meta"), sk.J, 0, sched, 0, 0)
