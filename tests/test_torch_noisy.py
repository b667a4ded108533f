"""The port's noisy anneals (per-step coupling tables, sa.anneal_noisy and
svmc.anneal_noisy) against the JAX package's.

One sweep of the plain versions (`ops/metropolis.py::noisy_colored_sweep`,
`ops/svmc_ops.py::noisy_svmc_sweep`, `ops/packed.py::packed_sweep` and
`packed_svmc_sweep` with `nbr_J=` / `h=`) against the JAX sweeps on the
same tables and `jax.random` uniforms: spins bitwise, SVMC angles within
the recorded last-ulp FMA difference of XLA's TF proposal (2e-5;
ROADMAP.md queue 3). The counter-hash anneals of `ops/generic_kernels.py`
(`packed_noisy_scan`, `packed_noisy_svmc_scan`) equal the masked sweeps on
the same uniforms, the static anneals when every table row is the static
table, and the repeated tables at mcsteps = 1 when they read a row for
mcsteps sweeps. The kernels' table variant is held to these in
tests/test_torch_gpu.py and chip_smoke.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from montecarlosolvers_tpu.models import instances as jinst
from montecarlosolvers_tpu.ops import metropolis as jmet
from montecarlosolvers_tpu.ops import packed as jpk
from montecarlosolvers_tpu.ops import svmc_ops as jsv
from montecarlosolvers_tpu_torch import schedules as tsched
from montecarlosolvers_tpu_torch.models import instances as tinst
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import counter_rng as cr
from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
from montecarlosolvers_tpu_torch.ops import metropolis as tmet
from montecarlosolvers_tpu_torch.ops import packed as tpk
from montecarlosolvers_tpu_torch.ops import svmc_ops as tsv
from montecarlosolvers_tpu_torch.solvers import sa, svmc

torch.set_num_threads(1)

ANGLE_ATOL = 2e-5

GRAPHS = {
    "rg_fields": (lambda: tinst.random_graph(24, 60, rng=3, with_fields=True,
                                             device="cpu")[0],
                  lambda: jinst.random_graph(24, 60, rng=3,
                                             with_fields=True)[0]),
    "rg9": (lambda: tinst.random_graph(30, 220, rng=1, device="cpu")[0],
            lambda: jinst.random_graph(30, 220, rng=1)[0]),
}


def graphs(name):
    port, jax_fn = GRAPHS[name]
    return port(), jax_fn()


def noisy_tables(problem, steps, seed, scale=0.1):
    """numpy float32 (steps, N, maxnb) and (steps, N): nbr_J (1 + scale xi)
    and h (1 + scale eta), xi and eta standard normals (zero slots stay
    zero)."""
    r = np.random.default_rng(seed)
    nbr_J, h = problem.nbr_J.numpy(), problem.h.numpy()
    jt = nbr_J * (1 + scale * r.standard_normal(
        (steps,) + nbr_J.shape, dtype=np.float32))
    ht = h * (1 + scale * r.standard_normal((steps,) + h.shape,
                                            dtype=np.float32))
    return jt.astype(np.float32), ht.astype(np.float32)


def spins(shape, seed):
    return np.random.default_rng(seed).choice([-1.0, 1.0], size=shape).astype(
        np.float32)


def angles(shape, seed):
    return (np.random.default_rng(seed).random(shape) * np.pi).astype(
        np.float32)


def t32(x):
    return torch.tensor(x, dtype=torch.float32)


# -------------------------------------------- one sweep, JAX's uniforms


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("temp", [0.6, 2.0])
def test_noisy_sa_sweeps_equal_jax(name, temp):
    port, jprob = graphs(name)
    jt, ht = (x[0] for x in noisy_tables(port, 1, 7))
    s = spins((5, port.nspins), 2)
    key = jax.random.key(11)
    u = np.array(jax.random.uniform(key, s.shape))
    T = np.float32(temp)
    want = np.asarray(jmet.noisy_colored_sweep(
        jprob, jnp.asarray(jt), jnp.asarray(ht), jnp.asarray(s), key, T))
    got = tmet.noisy_colored_sweep(port, torch.as_tensor(jt),
                                   torch.as_tensor(ht), torch.as_tensor(s),
                                   torch.as_tensor(u), t32(T))
    assert np.array_equal(got.numpy(), want)
    assert 0.1 < (want != s).mean() < 0.9
    # the packed sweep on the row-permuted tables
    jpg, tpg = jpk.build_packed(jprob), tpk.build_packed(port)
    perm = np.asarray(jpg.perm)
    sp = np.array(jpk.pack_state(jpg, jnp.asarray(s)))
    want = np.asarray(jpk.packed_sweep(jpg, jnp.asarray(sp), key, T,
                                       nbr_J=jnp.asarray(jt[perm]),
                                       h=jnp.asarray(ht[perm])))
    got = tpk.packed_sweep(tpg, torch.as_tensor(sp), torch.as_tensor(u),
                           t32(T), nbr_J=torch.as_tensor(jt[perm]),
                           h=torch.as_tensor(ht[perm]))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("tf", [True, False])
def test_noisy_svmc_sweeps_equal_jax(name, tf):
    port, jprob = graphs(name)
    jt, ht = (x[0] for x in noisy_tables(port, 1, 8))
    th = angles((5, port.nspins), 3)
    key = jax.random.key(12)
    ku, ka = jax.random.split(key)
    up = np.array(jax.random.uniform(ku, th.shape))
    ua = np.array(jax.random.uniform(ka, th.shape))
    A, B, T = np.float32(0.6), np.float32(1.0), np.float32(0.3)
    args = (t32(T), t32(A), t32(B))
    want = np.asarray(jsv.noisy_svmc_sweep(
        jprob, jnp.asarray(jt), jnp.asarray(ht), jnp.asarray(th), key, T, A,
        B, tf=tf))
    got = tsv.noisy_svmc_sweep(port, torch.as_tensor(jt), torch.as_tensor(ht),
                               torch.as_tensor(th), torch.as_tensor(up),
                               torch.as_tensor(ua), *args, tf=tf).numpy()
    assert np.abs(got - want).max() <= ANGLE_ATOL
    assert (np.abs(want - th) > 1e-3).mean() > 0.2
    jpg, tpg = jpk.build_packed(jprob), tpk.build_packed(port)
    perm = np.asarray(jpg.perm)
    thp = np.array(jpk.pack_state(jpg, jnp.asarray(th)))
    want = np.asarray(jpk.packed_svmc_sweep(
        jpg, jnp.asarray(thp), key, T, A, B, tf=tf,
        nbr_J=jnp.asarray(jt[perm]), h=jnp.asarray(ht[perm])))
    got = tpk.packed_svmc_sweep(
        tpg, torch.as_tensor(thp), torch.as_tensor(up), torch.as_tensor(ua),
        *args, tf=tf, nbr_J=torch.as_tensor(jt[perm]),
        h=torch.as_tensor(ht[perm])).numpy()
    assert np.abs(got - want).max() <= ANGLE_ATOL


# ------------------------------------------ the anneals on the counter hash


def masked_noisy_sa(problem, temps, jt, ht, spins_, seed):
    """The masked noisy sweep in ORIGINAL order on the uniforms the packed
    engine draws (counter_rng.generic_uids at sites 0..N-1)."""
    chains, n = spins_.shape
    hu = cr.hashed_uid(cr.generic_uids(chains, torch.arange(
        n, dtype=torch.int32), n))
    s = spins_
    for t in range(temps.shape[0]):
        u = cr.uniform01_hashed(cr.counter(seed, t, 0), hu)
        s = tmet.noisy_colored_sweep(problem, jt[t], ht[t], s, u, temps[t])
    return s


def masked_noisy_svmc(problem, a, b, temp, jt, ht, theta, seed, tf):
    chains, n = theta.shape
    hu = cr.hashed_uid(cr.generic_uids(chains, torch.arange(
        n, dtype=torch.int32), n))
    state = (theta, torch.cos(theta), torch.sin(theta))
    for t in range(a.shape[0]):
        up = cr.uniform01_hashed(cr.counter(seed, t, 0), hu)
        ua = cr.uniform01_hashed(cr.svmc_accept_counter(seed, t, 0), hu)
        state = tsv.noisy_svmc_sweep_cached(problem, jt[t], ht[t], state, up,
                                            ua, t32(temp), a[t], b[t], tf=tf)
    return state[0]


@pytest.mark.parametrize("name", list(GRAPHS))
def test_noisy_sa_anneal_equals_the_masked_sweeps(name):
    port = graphs(name)[0]
    steps = 12
    jt, ht = (torch.as_tensor(x) for x in noisy_tables(port, steps, 4))
    s0 = torch.as_tensor(spins((4, port.nspins), 5))
    temps = tsched.linear(3.0, 0.05, steps, device="cpu")
    got = gk.packed_noisy_scan(port, temps, jt, ht, s0, 61)
    assert torch.equal(got, masked_noisy_sa(port, temps, jt, ht, s0, 61))
    assert not torch.equal(got, s0)
    static = gk.anneal_packed(port, temps, s0, 61)
    assert not torch.equal(got, static)


@pytest.mark.parametrize("name,tf", [("rg_fields", True), ("rg9", False)])
def test_noisy_svmc_anneal_equals_the_masked_sweeps(name, tf):
    port = graphs(name)[0]
    steps = 10
    jt, ht = (torch.as_tensor(x) for x in noisy_tables(port, steps, 6))
    th = torch.as_tensor(angles((4, port.nspins), 7))
    a = tsched.linear(3.0, 1e-8, steps, device="cpu")
    b = torch.ones_like(a)
    got = gk.packed_noisy_svmc_scan(port, a, b, 0.1, jt, ht, th, 33, tf=tf)
    want = masked_noisy_svmc(port, a, b, 0.1, jt, ht, th, 33, tf)
    assert torch.equal(got, want)


def static_tables(problem, rows):
    return (problem.nbr_J.expand((rows,) + tuple(problem.nbr_J.shape)),
            problem.h.expand(rows, problem.nspins))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_equal_rows_give_the_static_anneals(name):
    """Noisy anneals whose every row is the static table are the static
    anneals bitwise: the same uniform streams, the same fields."""
    port = graphs(name)[0]
    steps = 15
    jt, ht = static_tables(port, steps)
    gen = torch.Generator().manual_seed(3)
    s0 = sa.random_state(gen, port.nspins, batch=(3,), device="cpu")
    temps = tsched.linear(2.0, 0.1, steps, device="cpu")
    assert torch.equal(gk.packed_noisy_scan(port, temps, jt, ht, s0, 9),
                       gk.anneal_packed(port, temps, s0, 9))
    th = svmc.random_state(gen, port.nspins, batch=(3,), device="cpu")
    for tf in (True, False):
        got = gk.packed_noisy_svmc_scan(port, temps, torch.ones_like(temps),
                                        0.2, jt, ht, th, 9, tf=tf)
        want = gk.anneal_packed_svmc(port, temps, torch.ones_like(temps), 0.2,
                                     th, 9, tf=tf)
        assert torch.equal(got, want)


def test_mcsteps_read_each_row_for_mcsteps_sweeps():
    """mcsteps = 3 reads row t // 3; the JAX solver repeats every row
    three times instead (solvers/sa.py:150-151): the same sweeps."""
    port = graphs("rg9")[0]
    steps, m = 6, 3
    jt, ht = (torch.as_tensor(x) for x in noisy_tables(port, steps, 9))
    sched = tsched.linear(2.5, 0.1, steps, device="cpu")
    gen = torch.Generator().manual_seed(4)
    s0 = sa.random_state(gen, port.nspins, batch=(3,), device="cpu")
    got = sa.anneal_noisy(port, sched, jt, ht, s0,
                          torch.Generator().manual_seed(8), mcsteps=m)
    temps = tsched.expand_mcsteps(sched, m, torch.device("cpu"))
    seed = sa.draw_seed(torch.Generator().manual_seed(8))
    want = gk.packed_noisy_scan(port, temps, jt.repeat_interleave(m, 0),
                                ht.repeat_interleave(m, 0), s0, seed)
    assert torch.equal(got, want)
    th = svmc.random_state(gen, port.nspins, batch=(3,), device="cpu")
    got = svmc.anneal_noisy(port, sched, torch.ones_like(sched), 0.1, jt, ht,
                            th, torch.Generator().manual_seed(8), mcsteps=m,
                            tf=True)
    want = gk.packed_noisy_svmc_scan(
        port, temps, torch.ones_like(temps), 0.1, jt.repeat_interleave(m, 0),
        ht.repeat_interleave(m, 0), th, seed, tf=True)
    assert torch.equal(got, want)


# ------------------------------------------------------ solvers


def test_noisy_anneal_finds_ground_state():
    """tests/test_packed.py:217 on the port: with constant tables the
    noisy anneal behaves as a plain anneal."""
    import gibbs_check as gc

    port = tinst.random_graph(12, 20, rng=0, device="cpu")[0]
    e_gs = float(gc.generic_energies(port, gc.all_states(12)).min())
    steps = 400
    jt, ht = static_tables(port, steps)
    gen = torch.Generator().manual_seed(10)
    s0 = sa.random_state(gen, 12, batch=(16,), device="cpu")
    out = sa.anneal_noisy(port, tsched.linear(3.0, 0.0, steps, device="cpu"),
                          jt, ht, s0, gen)
    assert abs(float(port.energy(out).min()) - e_gs) < 1e-3


def test_noisy_solvers_route_on_the_cpu():
    port = graphs("rg_fields")[0]
    steps = 5
    jt, ht = noisy_tables(port, steps, 3)  # numpy tables are taken too
    gen = torch.Generator().manual_seed(0)
    s0 = sa.random_state(gen, port.nspins, batch=(2,), device="cpu")
    sched = tsched.linear(2.0, 0.1, steps, device="cpu")
    _build.reset_launches()
    out = sa.anneal_noisy(port, sched, jt, ht, s0, gen)
    assert out.shape == s0.shape and set(out.unique().tolist()) <= {-1, 1}
    one = sa.anneal_noisy(port, sched, jt, ht, s0[0], gen)
    assert one.shape == (port.nspins,)
    th = svmc.random_state(gen, port.nspins, batch=(2,), device="cpu")
    for tf in (False, True):
        ang = svmc.anneal_noisy(port, sched, torch.ones_like(sched), 0.1, jt,
                                ht, th, gen, tf=tf)
        assert ang.shape == th.shape
        assert 0.0 <= float(ang.min()) and float(ang.max()) <= tsv.PI
    assert not any(_build.LAUNCHES.values())


def test_noisy_refusals():
    port = graphs("rg_fields")[0]
    gen = torch.Generator().manual_seed(0)
    s0 = sa.random_state(gen, port.nspins, batch=(2,), device="cpu")
    sched = tsched.linear(2.0, 0.1, 4, device="cpu")
    jt, ht = noisy_tables(port, 4, 1)
    with pytest.raises(ValueError, match="do not fit"):
        sa.anneal_noisy(port, sched, jt[:3], ht[:3], s0, gen)
    with pytest.raises(ValueError, match="do not fit"):
        sa.anneal_noisy(port, sched, jt[:, :, :2], ht, s0, gen)
    with pytest.raises(ValueError, match="take an IsingProblem"):
        sa.anneal_noisy(tinst.gaussian_torus(4, device="cpu"), sched, jt, ht,
                        s0[:, :16], gen)
    sk = tinst.sk_model(6, rng=0, device="cpu")[0]
    with pytest.raises(NotImplementedError, match="DenseProblem"):
        svmc.anneal_noisy(sk, sched, sched, 0.1, jt, ht, s0[:, :6], gen)
    pg = tpk.build_packed(port)
    tables = gk.packed_tables(pg, jt, ht, 1, 4, torch.device("cpu"))
    with pytest.raises(ValueError, match="no packed engine"):
        gk.packed_sa_anneal(pg, sched, s0.to("meta"), 0, tables=tables)
