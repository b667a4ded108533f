"""The port's generic sweeps and solvers on an IsingProblem: one sweep
against the JAX package's on the same `jax.random` uniforms, the masked
and packed engines against each other on the counter hash, exact-weight
histograms, and the solvers end to end.

Spins must agree bitwise. SVMC angles may differ by the known last-ulp
FMA contraction of XLA's TF proposal (2e-5; ROADMAP.md queue 3).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gibbs_check as gc
from montecarlosolvers_tpu.models import instances as jinst
from montecarlosolvers_tpu.ops import metropolis as jmet
from montecarlosolvers_tpu.ops import packed as jpk
from montecarlosolvers_tpu.ops import piqmc as jpq
from montecarlosolvers_tpu.ops import svmc_ops as jsv
from montecarlosolvers_tpu_torch import schedules as tsched
from montecarlosolvers_tpu_torch.models import instances as tinst
from montecarlosolvers_tpu_torch.models.ising import IsingProblem
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import counter_rng as cr
from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
from montecarlosolvers_tpu_torch.ops import metropolis as tmet
from montecarlosolvers_tpu_torch.ops import packed as tpk
from montecarlosolvers_tpu_torch.ops import piqmc as tpq
from montecarlosolvers_tpu_torch.ops import svmc_ops as tsv
from montecarlosolvers_tpu_torch.solvers import api, qmc, sa, svmc

torch.set_num_threads(1)

ANGLE_ATOL = 2e-5

# graph -> (the port's problem, the JAX one); "rg9" has 9 colors, more
# than the JAX package's MAX_PACKED_COLORS of 8
GRAPHS = {
    "rg_fields": (lambda: tinst.random_graph(24, 60, rng=3, with_fields=True,
                                             device="cpu")[0],
                  lambda: jinst.random_graph(24, 60, rng=3,
                                             with_fields=True)[0]),
    "chimera": (lambda: tinst.chimera_graph(2, rng=1, dist="gauss",
                                            device="cpu")[0],
                lambda: jinst.chimera_graph(2, rng=1, dist="gauss")[0]),
    "rg9": (lambda: tinst.random_graph(30, 220, rng=1, device="cpu")[0],
            lambda: jinst.random_graph(30, 220, rng=1)[0]),
}


def graphs(name):
    port, jax_fn = GRAPHS[name]
    return port(), jax_fn()


def test_the_nine_color_graph_has_nine_colors():
    assert graphs("rg9")[0].num_colors == 9


def spins(shape, seed):
    return np.random.default_rng(seed).choice([-1.0, 1.0], size=shape).astype(
        np.float32)


def t32(x):
    return torch.tensor(x, dtype=torch.float32)


# -------------------------------------------- one sweep, JAX's uniforms


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("temp", [0.7, 2.5])
def test_sa_sweeps_equal_jax(name, temp):
    port, jprob = graphs(name)
    s = spins((6, port.nspins), 1)
    key = jax.random.key(3)
    u = np.asarray(jax.random.uniform(key, s.shape))
    T = np.float32(temp)
    want = np.asarray(jmet.colored_metropolis_sweep(jprob, jnp.asarray(s),
                                                    key, T))
    got = tmet.colored_metropolis_sweep(port, torch.as_tensor(s),
                                        torch.as_tensor(u), t32(T))
    assert np.array_equal(got.numpy(), want)
    assert 0.1 < (want != s).mean() < 0.9
    jpg, tpg = jpk.build_packed(jprob), tpk.build_packed(port)
    sp = np.asarray(jpk.pack_state(jpg, jnp.asarray(s)))
    want = np.asarray(jpk.packed_sweep(jpg, jnp.asarray(sp), key, T))
    got = tpk.packed_sweep(tpg, torch.as_tensor(sp), torch.as_tensor(u),
                           t32(T))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["rg_fields", "rg9"])
@pytest.mark.parametrize("P", [4, 5])
def test_qmc_sweeps_equal_jax(name, P):
    port, jprob = graphs(name)
    temp, gamma, b = 0.45, np.float32(0.7), np.float32(0.8)
    teff = temp * P
    c = spins((3, P, port.nspins), P)
    key = jax.random.key(P)
    u = np.asarray(jax.random.uniform(key, c.shape))
    want = np.asarray(jpq.local_sweep(jprob, jnp.asarray(c), key, temp,
                                      jnp.float32(gamma), jnp.float32(b)))
    jp = tsched.jperp(torch.tensor([gamma]), teff)[0]
    got = tpq.local_sweep(port, torch.as_tensor(c), torch.as_tensor(u), teff,
                          jp, t32(b))
    assert np.array_equal(got.numpy(), want)
    assert (want != c).mean() > 0.1
    ul = np.asarray(jax.random.uniform(key, (3, port.nspins)))
    want2 = np.asarray(jpq.global_line_moves(jprob, jnp.asarray(want), key,
                                             temp, jnp.float32(b)))
    got2 = tpq.global_line_moves(port, torch.as_tensor(want),
                                 torch.as_tensor(ul), teff, t32(b))
    assert np.array_equal(got2.numpy(), want2)
    assert (want2 != want).any()


@pytest.mark.parametrize("name", ["rg_fields", "rg9"])
@pytest.mark.parametrize("tf", [True, False])
def test_svmc_sweeps_equal_jax(name, tf):
    port, jprob = graphs(name)
    th = (np.random.default_rng(2).random((6, port.nspins))
          * np.pi).astype(np.float32)
    key = jax.random.key(9)
    ku, ka = jax.random.split(key)
    up = np.asarray(jax.random.uniform(ku, th.shape))
    ua = np.asarray(jax.random.uniform(ka, th.shape))
    A, B, T = np.float32(0.6), np.float32(1.0), np.float32(0.3)
    args = (t32(T), t32(A), t32(B))
    want = np.asarray(jsv.svmc_sweep(jprob, jnp.asarray(th), key, T, A, B,
                                     tf=tf))
    got = tsv.svmc_sweep(port, torch.as_tensor(th), torch.as_tensor(up),
                         torch.as_tensor(ua), *args, tf=tf).numpy()
    assert np.abs(got - want).max() <= ANGLE_ATOL
    assert (np.abs(want - th) > 1e-3).mean() > 0.2
    jpg, tpg = jpk.build_packed(jprob), tpk.build_packed(port)
    thp = np.asarray(jpk.pack_state(jpg, jnp.asarray(th)))
    want = np.asarray(jpk.packed_svmc_sweep(jpg, jnp.asarray(thp), key, T, A,
                                            B, tf=tf))
    got = tpk.packed_svmc_sweep(tpg, torch.as_tensor(thp),
                                torch.as_tensor(up), torch.as_tensor(ua),
                                *args, tf=tf).numpy()
    assert np.abs(got - want).max() <= ANGLE_ATOL


# ------------------------------- masked and packed on the counter hash


def masked_qmc_anneal(problem, b, jp, teff, confs, seed, global_moves):
    """The masked space-time sweep on the ORIGINAL order, on the uniforms
    the generic engine draws (counter_rng.generic_uids at sites 0..N-1)."""
    chains, P, n = confs.shape
    sites = torch.arange(n, dtype=torch.int32)
    hu = cr.hashed_uid(cr.generic_uids(chains, sites, n, slices=P))
    c = confs
    for t in range(b.shape[0]):
        u = cr.uniform01_hashed(cr.counter(seed, t, 0), hu)
        c = tpq.local_sweep(problem, c, u, teff, jp[t], b[t])
        if global_moves:
            ul = cr.uniform01_hashed(cr.line_counter(seed, t, 0), hu[:, 0])
            c = tpq.global_line_moves(problem, c, ul, teff, b[t])
    return c


def masked_svmc_anneal(problem, a, b, temp, theta, seed, tf):
    chains, n = theta.shape
    hu = cr.hashed_uid(cr.generic_uids(chains, torch.arange(
        n, dtype=torch.int32), n))
    state = (theta, torch.cos(theta), torch.sin(theta))
    for t in range(a.shape[0]):
        up = cr.uniform01_hashed(cr.counter(seed, t, 0), hu)
        ua = cr.uniform01_hashed(cr.svmc_accept_counter(seed, t, 0), hu)
        state = tsv.svmc_sweep_cached(problem, state, up, ua, t32(temp),
                                      a[t], b[t], tf=tf)
    return state[0]


@pytest.mark.parametrize("name", ["rg_fields", "rg9"])
def test_masked_equals_packed_sa(name):
    port = graphs(name)[0]
    s0 = torch.as_tensor(spins((5, port.nspins), 4))
    sched = tsched.linear(3.0, 0.05, 25, device="cpu")
    a, ea = gk.anneal_packed(port, sched, s0, 77, collect_energy=True)
    b, eb = gk.anneal_masked(port, sched, s0, 77, collect_energy=True)
    assert torch.equal(a, b)
    assert not torch.equal(a, s0)
    scale = float(port.nbr_J.abs().sum() / 2 + port.h.abs().sum())
    assert (ea - eb).abs().max() <= gc.ENERGY_RTOL * scale
    assert torch.allclose(ea[-1], port.energy(a), atol=1e-5 * scale)


@pytest.mark.parametrize("name,P,gm", [("rg_fields", 4, True),
                                       ("rg9", 5, True), ("rg9", 3, False)])
def test_masked_equals_packed_qmc(name, P, gm):
    port = graphs(name)[0]
    c0 = torch.as_tensor(spins((3, P, port.nspins), 5))
    g = tsched.transverse_field(3.0, 1e-8, 12, device="cpu")
    b, jp, teff = tsched.qmc_terms(g, torch.full_like(g, 0.9), 0.3, P, 1,
                                   torch.device("cpu"))
    got = gk.anneal_generic_qmc(port, g, torch.full_like(g, 0.9), 0.3, c0, 91,
                                global_moves=gm)
    want = masked_qmc_anneal(port, b, jp, teff, c0, 91, gm)
    assert torch.equal(got, want)
    assert not torch.equal(got, c0)


@pytest.mark.parametrize("name,tf", [("rg_fields", True), ("rg9", False)])
def test_masked_equals_packed_svmc(name, tf):
    port = graphs(name)[0]
    th = torch.as_tensor((np.random.default_rng(6).random((4, port.nspins))
                          * np.pi).astype(np.float32))
    a = tsched.linear(3.0, 1e-8, 15, device="cpu")
    got = gk.anneal_packed_svmc(port, a, torch.ones_like(a), 0.1, th, 33,
                                tf=tf)
    want = masked_svmc_anneal(port, a, torch.ones_like(a), 0.1, th, 33, tf)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kernel", list(gc.GENERIC))
def test_plain_versions_collect_energies(kernel):
    """The plain versions' energies (what the kernels' in-kernel reductions
    are held to on the card) are those of the states after each sweep, and
    collecting changes no state."""
    port = graphs("rg9")[0]
    case = gc.generic_case(kernel, port, 3, 6, slices=3)
    _, plain, _ = gc.GENERIC[kernel]
    es = torch.empty((6, 3), dtype=torch.float32)
    out = case["run"](plain, es)
    assert torch.equal(out, case["run"](plain, None))
    last = (tsv.z_projection_from_cos(torch.cos(out)) if case["angles"]
            else out)
    e = tpk.packed_energy(case["pg"], last)
    if kernel in ("generic_qmc", "generic_qmc_bath"):
        e = e.min(dim=-1).values
    assert torch.allclose(es[-1], e, atol=1e-6 * case["scale"])


# ----------------------------------------------------- distributions


def _sa_graph():
    """tests/test_packed.py's irregular 4-spin graph with fields, 3
    colors."""
    return IsingProblem.from_edges(4, [0, 0, 0, 1, 2, 0, 2],
                                   [1, 2, 3, 2, 3, 0, 2],
                                   [0.8, -0.5, 0.3, 0.7, -0.9, 0.2, -0.4],
                                   maxnb=4, device="cpu")


@pytest.mark.parametrize("engine", ["packed", "masked"])
def test_sa_samples_exact_boltzmann(engine):
    prob = _sa_graph()
    assert prob.num_colors == 3
    run = gk.anneal_packed if engine == "packed" else gk.anneal_masked
    per_chain = gc.sample_generic_sa(run, prob, 1024, 1.1, 21)
    z, d = gc.z_scores(per_chain, gc.generic_sa_weights(prob, 1.1),
                       gc.SAMPLES)
    assert z < 5.0, (z, d)


@pytest.mark.parametrize("global_moves", [False, True])
def test_qmc_samples_extended_gibbs(global_moves):
    """tests/test_qmc.py's extended-Gibbs case: N = 2, P = 2, J = 0.9,
    T = 0.8, Gamma = 0.7 (16 states)."""
    prob = IsingProblem.from_edges(2, [0], [1], [0.9], maxnb=1, device="cpu")
    P, temp, gamma = 2, 0.8, 0.7
    jp = gc.jperp(gamma, P, temp)
    per_chain = gc.sample_generic_qmc(prob, 1024, P, temp, gamma, 22,
                                      global_moves=global_moves)
    z, d = gc.z_scores(per_chain, gc.generic_qmc_weights(prob, P, temp, jp),
                       gc.SAMPLES)
    assert z < 5.0, (z, d)


def test_svmc_samples_rotor_gibbs():
    """tests/test_packed.py's two-rotor case: J = 0.8, h = (0.3, -0.4),
    A = 0.6, B = 1, T = 0.7, uniform proposals."""
    prob = gc.rotor_pair_problem("cpu")
    per_chain = gc.sample_generic_svmc(prob, 512, 0.6, 1.0, 0.7, 23)
    z, d = gc.z_scores(per_chain, np.array(gc.rotor_moments(0.6, 1.0, 0.7)))
    assert z < 5.0, (z, d)


# ------------------------------------------------------ end to end


def brute_force_ground(prob):
    states = gc.all_states(prob.nspins)
    return float(gc.generic_energies(prob, states).min())


@pytest.mark.parametrize("method", ["sa", "piqmc", "svmc"])
def test_solve_finds_the_chimera_ground_state(method):
    """tests/test_packed.py:119 on the port: a C(2, 2, t=2) chimera (16
    spins), every method through solve()."""
    prob, _ = tinst.chimera_graph(2, 2, t=2, rng=1, device="cpu")
    e_gs = brute_force_ground(prob)
    kw = {"slices": 4, "pt": 2.0} if method == "piqmc" else {}
    ss = api.solve(prob, method, num_reads=16, sweeps=400, seed=1, **kw)
    assert ss.samples.shape == (16, 16)
    assert set(np.unique(ss.samples)) <= {-1.0, 1.0}
    assert abs(ss.best_energy - e_gs) < 1e-3, (ss.best_energy, e_gs)
    np.testing.assert_allclose(
        ss.energies, gc.generic_energies(prob, ss.samples.astype(np.float64)),
        atol=1e-4)


def test_solve_on_a_converted_jax_problem():
    from montecarlosolvers_tpu_torch import convert

    jprob = jinst.chimera_graph(2, 2, t=2, rng=1)[0]
    port = convert.ising_from_arrays(
        np.asarray(jprob.nbr_idx), np.asarray(jprob.nbr_J),
        np.asarray(jprob.h), np.asarray(jprob.color_masks), device="cpu")
    ss = api.solve(port, "sa", num_reads=8, sweeps=300, seed=2)
    e = np.asarray(jprob.energy(jnp.asarray(ss.samples)))
    np.testing.assert_allclose(ss.energies, e, atol=1e-4)
    with pytest.raises(NotImplementedError, match="not a problem of the port"):
        api.solve(jprob, "sa", num_reads=2, sweeps=3)


def test_solvers_route_ising_problems_on_the_cpu():
    prob = graphs("rg9")[0]
    gen = torch.Generator().manual_seed(0)
    s0 = sa.random_state(gen, prob.nspins, batch=(3,), device="cpu")
    sched = tsched.linear(2.0, 0.1, 10, device="cpu")
    _build.reset_launches()
    out, es = sa.anneal(prob, sched, s0, torch.Generator().manual_seed(1),
                        mcsteps=2, collect_energy=True)
    assert es.shape == (20, 3) and out.shape == s0.shape
    masked = sa.anneal(prob, sched, s0, torch.Generator().manual_seed(1),
                       mcsteps=2, engine="masked")
    assert torch.equal(out, masked)
    single = sa.anneal(prob, sched, s0[0], torch.Generator().manual_seed(1))
    assert single.shape == (prob.nspins,)
    c = qmc.replicate(s0, 3)
    g = tsched.transverse_field(3.0, 1e-8, 6, device="cpu")
    confs, eq = qmc.anneal(prob, g, torch.ones_like(g), 0.2, c, gen,
                           global_moves=True, collect_energy=True)
    assert confs.shape == c.shape and eq.shape == (6, 3)
    assert torch.allclose(eq[-1], qmc.best_slice_energy(prob, confs),
                          atol=1e-4)
    one = qmc.anneal(prob, g, torch.ones_like(g), 0.2, c[0], gen)
    assert one.shape == c[0].shape
    th = svmc.random_state(gen, prob.nspins, batch=(3,), device="cpu")
    ang, ev = svmc.anneal(prob, g, torch.ones_like(g), 0.05, th, gen,
                          tf=True, collect_energy=True)
    assert ang.shape == th.shape and ev.shape == (6, 3)
    assert torch.allclose(ev[-1], prob.energy(svmc.z_projection(ang)),
                          atol=1e-4)
    # the CPU runs the plain versions: no kernel was launched
    assert not any(_build.LAUNCHES.values())


def test_generic_refusals():
    prob = graphs("rg_fields")[0]
    gen = torch.Generator().manual_seed(0)
    sched = tsched.linear(1.0, 0.0, 3, device="cpu")
    s = sa.random_state(gen, prob.nspins, batch=(2,), device="cpu")
    with pytest.raises(ValueError, match="engine must be"):
        sa.anneal(prob, sched, s, gen, engine="split")
    lat = tinst.gaussian_torus(4, device="cpu")
    with pytest.raises(NotImplementedError, match="item 3 .parallel"):
        sa.anneal(lat, sched, s[:, :16], gen, engine="masked")
    c = qmc.replicate(s, 4)
    # the bath on an IsingProblem runs on the generic bath engine
    # (tests/test_torch_dissipative.py) and gives its plain version's spins
    out = qmc.anneal(prob, sched, torch.ones_like(sched), 0.3, c,
                     torch.Generator().manual_seed(5), lookuptable=np.ones(3))
    pg = tpk.build_packed(prob)
    b, jp, teff = tsched.qmc_terms(sched, torch.ones_like(sched), 0.3, 4, 1,
                                   torch.device("cpu"))
    ref = gk.generic_qmc_bath_anneal_ref(
        pg, b, jp, teff, tpq.bath_matrix(torch.ones(3), 4),
        tpk.pack_state(pg, c), sa.draw_seed(torch.Generator().manual_seed(5)),
        False)
    assert torch.equal(out, tpk.unpack_state(pg, ref))
    with pytest.raises(ValueError, match="problem on cpu"):
        gk.anneal_packed(prob, sched, s.to("meta"), 0)
    with pytest.raises(ValueError, match="take an IsingProblem"):
        gk.anneal_packed(lat, sched, s, 0)
    pg = tpk.build_packed(prob)
    with pytest.raises(ValueError, match="no packed engine"):
        gk.packed_sa_anneal(pg, sched, s.to("meta"), 0)
