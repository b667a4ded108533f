"""The port's SVMC engines and `solve("svmc")` against the JAX package.

`svmc_split_anneal_ref` and `svmc_plane_anneal_ref` are the plain forms of
the CUDA kernels 4 and 7, and on a CPU tensor the kernel wrappers run them.
They are held against `oracle_svmc` (tests/test_pallas_split.py) and the
Pallas interpreters of `_svmc_split_kernel` and `_svmc_kernel` on the same
angles, schedules and counter seed. Rotor angles are continuous: torch's
and XLA's cos and sin may differ in the last ulp, so the angles are held to
atol = 2e-5 (as tests/test_pallas_split.py holds the interpreter against
the oracle); a diverged accept decision would differ by O(1) and fail.
The interpreter works on padded planes, so these cases keep to L <= 16 and
16 steps.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_pallas_split import oracle_svmc
from montecarlosolvers_tpu.models import instances as jinst
from montecarlosolvers_tpu.models.lattice import LatticeProblem as JLattice
from montecarlosolvers_tpu.ops import pallas_split, pallas_svmc
from montecarlosolvers_tpu.ops import svmc_ops as jsvmc_ops
from montecarlosolvers_tpu.ops.pallas_sa import _uniform01
from montecarlosolvers_tpu.solvers import api as japi
from montecarlosolvers_tpu_torch import convert
from montecarlosolvers_tpu_torch import schedules as tsched
from montecarlosolvers_tpu_torch.models import instances as tinst
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import counter_rng as cr
from montecarlosolvers_tpu_torch.ops import plane as plane_ops
from montecarlosolvers_tpu_torch.ops import plane_kernels as pk
from montecarlosolvers_tpu_torch.ops import split as split_ops
from montecarlosolvers_tpu_torch.ops import split_kernels as sk
from montecarlosolvers_tpu_torch.ops import svmc_ops
from montecarlosolvers_tpu_torch.solvers import api, sa, svmc

torch.set_num_threads(1)

SEED_MULT = 2654435761 - (1 << 32)
ATOL = 2e-5


def periodic(L, seed, fields=False):
    r = np.random.default_rng(seed)
    h = r.normal(size=(L, L)) * 0.1 if fields else None
    return JLattice.from_planes(r.normal(size=(L, L)), r.normal(size=(L, L)),
                                h)


def open_lattice(L, seed, fields=False):
    return jinst.random_2d_lattice(L, rng=seed, with_fields=fields,
                                   lattice=True)[0]


def port_of(lat):
    return convert.lattice_from_arrays(
        np.asarray(lat.j_right), np.asarray(lat.j_down),
        np.asarray(lat.h_plane), col_wrap=lat.col_wrap, device="cpu")


def angles(seed, *shape):
    return (np.random.default_rng(seed).random(shape) * np.pi) \
        .astype(np.float32)


def sched(steps=16):
    a = np.linspace(2.5, 1e-8, steps).astype(np.float32)
    return a, np.ones_like(a)


def assert_angles_close(out, ref):
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    assert out.min() >= 0.0 and out.max() <= np.float32(np.pi)


# ------------------------------------------------------------ counters, ops


@pytest.mark.parametrize("seed", [0, 13, 2**31 - 1, -(2**31), -7])
def test_svmc_counters_bitwise(seed):
    """Kernel 7: the acceptance counter is (base + color * M) ^ 374761393
    (`+` before `^`, pallas_svmc.py:93-96), not line_counter. Kernel 4:
    index 0 / 1 draws the proposal of half A / B and index + 2 the
    acceptance, at uid chain * 2Nh + (idx % 2) * Nh + site
    (pallas_split.py:257-271), which counter() and sa_uids() give."""
    sd = jnp.int32(seed)
    chains, nh = 3, 50
    chain = jnp.arange(chains, dtype=jnp.int32)[:, None]
    flat = jnp.arange(nh, dtype=jnp.int32)[None, :]
    ids = cr.plane_uids(2, 7, "cpu")
    for t in (0, 1, 999, 2**31 - 1):
        base = sd * jnp.int32(SEED_MULT) + jnp.int32(t) * jnp.int32(40503)
        for color in (0, 1):
            ref = base + jnp.int32(color * 1013904223) ^ jnp.int32(374761393)
            assert cr.svmc_accept_counter(seed, t, color) == int(ref)
            if color:  # line_counter adds color * 69069 after the XOR
                assert cr.svmc_accept_counter(seed, t, color) != \
                    cr.line_counter(seed, t, color)
            got = cr.uniform01(cr.svmc_accept_counter(seed, t, color), ids)
            assert np.array_equal(got.numpy(), np.asarray(
                _uniform01(ref, jnp.asarray(ids.numpy()))))
        for idx in range(4):
            ctr = base + jnp.int32(idx) * jnp.int32(1013904223)
            uid = chain * jnp.int32(2 * nh) + jnp.int32((idx % 2) * nh) + flat
            got = cr.uniform01(cr.counter(seed, t, idx),
                               cr.sa_uids(chains, nh, idx % 2, "cpu"))
            assert np.array_equal(got.numpy(),
                                  np.asarray(_uniform01(ctr, uid)))


def test_svmc_ops_match_jax():
    assert svmc_ops.PI == float(np.float32(np.pi)) == float(
        jnp.asarray(np.pi, jnp.float32))
    r = np.random.default_rng(0)
    u = r.random(4096).astype(np.float32)
    th = angles(1, 4096)
    th[:3] = [0.0, np.float32(np.pi), np.float32(np.pi / 2)]
    np.testing.assert_array_equal(
        svmc_ops.propose_uniform(torch.from_numpy(u)).numpy(),
        np.asarray(jsvmc_ops.propose_uniform(jnp.asarray(u))))
    for ac, bc in ((2.5, 1.0), (0.3, 1.0), (0.7, 0.9), (1e-8, 1.0)):
        a32, b32 = np.float32(ac), np.float32(bc)
        got = svmc_ops.propose_tf(torch.from_numpy(th), torch.from_numpy(u),
                                  torch.tensor(a32), torch.tensor(b32))
        ref = jsvmc_ops.propose_tf(jnp.asarray(th), jnp.asarray(u), a32, b32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert got.min() >= 0.0 and got.max() <= svmc_ops.PI
    c = np.cos(th).astype(np.float32)
    c[:2] = [0.0, -0.0]
    np.testing.assert_array_equal(
        svmc_ops.z_projection_from_cos(torch.from_numpy(c)).numpy(),
        np.asarray(jsvmc_ops.z_projection_from_cos(jnp.asarray(c))))
    np.testing.assert_array_equal(
        svmc_ops.z_projection(torch.from_numpy(th)).numpy(),
        np.asarray(jsvmc_ops.z_projection(jnp.asarray(th))))


def test_random_state():
    gen = torch.Generator().manual_seed(0)
    th = svmc.random_state(gen, 100, batch=(3,), device="cpu")
    assert th.shape == (3, 100) and th.dtype == torch.float32
    assert th.min() >= 0.0 and th.max() <= svmc_ops.PI
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(th, svmc.random_state(g2, 100, batch=(3,),
                                             device="cpu"))
    assert not torch.equal(th, svmc.random_state(g2, 100, batch=(3,),
                                                 device="cpu"))


# ------------------------------------------------- kernel 4's plain version


@pytest.mark.parametrize("tf", [False, True], ids=["uniform", "tf"])
@pytest.mark.parametrize("lat_fn", [
    lambda: periodic(16, 1, fields=True),
    lambda: open_lattice(6, 2, fields=True),
], ids=["L16-periodic", "L6-open"])
def test_split_plain_matches_oracle(lat_fn, tf):
    lat = lat_fn()
    th = angles(lat.L, 3, lat.L * lat.L)
    a, b = sched()
    ref = np.asarray(oracle_svmc(lat, a, b, 0.2, jnp.asarray(th), 13, tf))
    out = sk.anneal_lattice_svmc_split(
        port_of(lat), torch.from_numpy(a), torch.from_numpy(b), 0.2,
        torch.from_numpy(th), 13, tf=tf).numpy()
    assert out.dtype == np.float32 and out.shape == th.shape
    assert_angles_close(out, ref)
    assert (np.abs(out - th) > 1e-3).mean() > 0.3  # most rotors moved


@pytest.mark.parametrize("tf", [False, True], ids=["uniform", "tf"])
def test_split_plain_matches_pallas_interpreter(tf):
    """L = 16 (Nh = 128, the smallest the interpreter's lane rule takes),
    periodic, so the 7-slot stencil's row-wrap slots are live."""
    lat = periodic(16, 3, fields=True)
    th = angles(4, 2, 256)
    a, b = sched()
    ref = np.asarray(pallas_split.anneal_lattice_svmc_split(
        lat, a, b, 0.05, th, seed=21, tf=tf, interpret=True))
    out = sk.anneal_lattice_svmc_split(
        port_of(lat), torch.from_numpy(a), torch.from_numpy(b), 0.05,
        torch.from_numpy(th), 21, tf=tf).numpy()
    assert_angles_close(out, ref)


# ------------------------------------------------- kernel 7's plain version


@pytest.mark.parametrize("tf", [False, True], ids=["uniform", "tf"])
@pytest.mark.parametrize("lat_fn", [
    lambda: periodic(5, 0, fields=True),
    lambda: open_lattice(5, 1, fields=True),
    lambda: open_lattice(4, 2),
], ids=["L5-periodic", "L5-open", "L4-open"])
def test_plane_plain_matches_pallas_interpreter(lat_fn, tf):
    """Also shows that the cos stencil on L x L with torch.roll equals the
    Pallas kernel's padded plane with its masked correction rolls, and that
    on the odd torus the wrap pairs, which share a color, are decided from
    the same snapshot (ROADMAP.md queue 3)."""
    lat = lat_fn()
    th = angles(lat.L + 10, 3, lat.L * lat.L)
    a, b = sched()
    ref = np.asarray(pallas_svmc.anneal_lattice_svmc(
        lat, a, b, 0.2, jnp.asarray(th), seed=7, tf=tf, interpret=True))
    out = pk.anneal_lattice_svmc(
        port_of(lat), torch.from_numpy(a), torch.from_numpy(b), 0.2,
        torch.from_numpy(th), 7, tf=tf).numpy()
    assert out.dtype == np.float32 and out.shape == th.shape
    assert_angles_close(out, ref)
    assert (np.abs(out - th) > 1e-3).mean() > 0.3


def test_mcsteps_and_unbatched_state():
    lat = port_of(periodic(5, 4))
    th = torch.from_numpy(angles(0, 25))
    a = torch.tensor([2.0, 1.0, 0.5])
    b = torch.ones(3)
    rep = torch.repeat_interleave(a, 2)
    for engine, prob in ((pk.anneal_lattice_svmc, lat),
                         (sk.anneal_lattice_svmc_split,
                          port_of(periodic(4, 5)))):
        x = th[:prob.nspins]
        once = engine(prob, rep, torch.ones(6), 0.1, x, 3, tf=True)
        twice = engine(prob, a, b, 0.1, x, 3, mcsteps=2, tf=True)
        assert once.shape == x.shape
        assert torch.equal(once, twice)


# ------------------------------------------------------- the whole slice


@pytest.mark.parametrize("L", [16, 5], ids=["L16-split", "L5-plane"])
def test_svmc_slice_equals_jax_composition(L):
    """solve("svmc") (random angles, A: 3 -> 1e-8 over `sweeps` with
    B = 1, T = 0.05, TF proposals, z-projection, sort by energy) against
    the same chain in JAX: the port's initial angles and counter seed, the
    port's A schedule (jnp.linspace rounds differently, ROADMAP.md queue
    3), the Pallas interpreter of the engine the lattice takes, then
    z_projection and the sort. Signs must agree wherever |cos theta| >
    1e-4 (an angle may differ by an ulp of cos / sin) and the sorted
    energies must be equal."""
    reads, sweeps, seed = 4, 16, 3
    jlat = periodic(L, L + 20, fields=True)
    ss = api.solve(port_of(jlat), "svmc", num_reads=reads, sweeps=sweeps,
                   seed=seed)

    gen = torch.Generator().manual_seed(seed)
    th0 = svmc.random_state(gen, L * L, batch=(reads,), device="cpu").numpy()
    hseed = sa.draw_seed(gen)
    a = tsched.linear(3.0, 1e-8, sweeps, device="cpu").numpy()
    if L % 2 == 0:
        th = pallas_split.anneal_lattice_svmc_split(
            jlat, a, np.ones_like(a), 0.05, th0, hseed, tf=True,
            interpret=True)
    else:
        th = pallas_svmc.anneal_lattice_svmc(
            jlat, a, np.ones_like(a), 0.05, jnp.asarray(th0), hseed,
            tf=True, interpret=True)
    states = np.asarray(jsvmc_ops.z_projection(th))
    energies = np.asarray(jlat.energy(jnp.asarray(states)))
    order = np.argsort(energies)
    sure = np.abs(np.cos(np.asarray(th)))[order] > 1e-4
    assert ss.samples.shape == (reads, L * L)
    assert np.array_equal(ss.samples[sure], states[order][sure])
    np.testing.assert_allclose(ss.energies, energies[order], rtol=1e-6)


@pytest.mark.parametrize("make", [
    lambda: periodic(16, 7), lambda: open_lattice(15, 8),
], ids=["L16-torus", "L15-open"])
def test_svmc_distribution_matches_jax_solver(make):
    """Mean final energy of solve("svmc"), 256 reads, tau = 200, within 4
    combined standard errors of the JAX solver's (which draws from
    jax.random, and on odd L one uniform pair per site and sweep)."""
    jlat = make()
    port = api.solve(port_of(jlat), "svmc", num_reads=256, sweeps=200,
                     seed=1)
    ref = japi.solve(jlat, "svmc", num_reads=256, sweeps=200, seed=1)
    se = np.hypot(port.energies.std(ddof=1), ref.energies.std(ddof=1)) / 16
    assert abs(port.energies.mean() - ref.energies.mean()) < 4 * se


# ------------------------------------------------- exact rotor Gibbs check


@pytest.mark.parametrize("L", [4, 5], ids=["L4-split", "L5-plane"])
def test_svmc_samples_rotor_gibbs(L):
    """The lattice form of tests/test_svmc.py::test_svmc_samples_rotor_gibbs:
    one bond J = 0.8 between sites 0 and 1 of an open L x L lattice, fields
    0.3 and -0.4 on them, every other coupling and field 0; A = 0.6, B = 1,
    T = 0.7, uniform proposals. The pair must sample the Gibbs density on
    [0, pi]^2 (flat base measure): mean pair energy and <cos theta_0>
    against 2-D quadrature, within 0.03, which is at least 4 standard errors
    of the per-chain means."""
    J, h0, h1, A, B, temp = 0.8, 0.3, -0.4, 0.6, 1.0, 0.7
    jr, jd, hp = (np.zeros((L, L)) for _ in range(3))
    jr[0, 0], hp[0, 0], hp[0, 1] = J, h0, h1
    lat = convert.lattice_from_arrays(jr, jd, hp, device="cpu")
    assert split_ops.supports_split(lat) == (L % 2 == 0)

    def energy(t0, t1):
        return (B * (J * np.cos(t0) * np.cos(t1) + h0 * np.cos(t0)
                     + h1 * np.cos(t1)) - A * (np.sin(t0) + np.sin(t1)))

    g = np.linspace(0, np.pi, 601)
    T0, T1 = np.meshgrid(g, g, indexing="ij")
    E = energy(T0, T1)
    W = np.exp((E.min() - E) / temp)
    e_exact = float((W * E).sum() / W.sum())
    c_exact = float((W * np.cos(T0)).sum() / W.sum())

    chains, burn, samples, every = 1024, 40, 80, 2
    gen = torch.Generator().manual_seed(L)
    th = svmc.random_state(gen, L * L, batch=(chains,), device="cpu")
    a_c, b_c = torch.full((burn,), A), torch.full((burn,), B)
    th = svmc.anneal(lat, a_c, b_c, temp, th, gen)
    es, cs = [], []
    for _ in range(samples):
        th = svmc.anneal(lat, a_c[:every], b_c[:every], temp, th, gen)
        t = th[:, :2].double().numpy()
        es.append(energy(t[:, 0], t[:, 1]))
        cs.append(np.cos(t[:, 0]))
    for obs, exact in ((np.mean(es, axis=0), e_exact),
                       (np.mean(cs, axis=0), c_exact)):
        se = obs.std(ddof=1) / np.sqrt(chains)
        assert 4 * se <= 0.03, se
        assert abs(obs.mean() - exact) < 0.03, (obs.mean(), exact, se)


# ------------------------------------------------------- routes, refusals


def test_svmc_wrappers_route_by_device():
    lat = port_of(periodic(4, 6))
    sl = split_ops.build_split(lat)
    pl = plane_ops.build_plane(port_of(periodic(5, 6)))
    a = tsched.linear(1.0, 0.1, 3, device="cpu")
    b = torch.ones(3)
    h = torch.ones((2, 8))
    th = torch.ones((2, 5, 5))
    # a CPU tensor runs the plain version and launches nothing
    _build.reset_launches()
    for x, y in zip(sk.svmc_split_anneal(sl, a, b, 0.1, h, h, 0, True),
                    sk.svmc_split_anneal_ref(sl, a, b, 0.1, h, h, 0, True)):
        assert torch.equal(x, y)
    assert torch.equal(pk.svmc_plane_anneal(pl, a, b, 0.1, th, 0, False),
                       pk.svmc_plane_anneal_ref(pl, a, b, 0.1, th, 0, False))
    assert not any(_build.LAUNCHES.values())
    # a device with neither form raises instead of falling back
    with pytest.raises(ValueError, match="no split engine"):
        sk.svmc_split_anneal(sl, a, b, 0.1, h.to("meta"), h.to("meta"), 0,
                             True)
    with pytest.raises(ValueError, match="no plane engine"):
        pk.svmc_plane_anneal(pl, a, b, 0.1, th.to("meta"), 0, True)


def test_svmc_refusals():
    gen = torch.Generator().manual_seed(0)
    lat = tinst.gaussian_torus(6, seed=0, device="cpu")
    a = tsched.linear(1.0, 1e-8, 3, device="cpu")
    th = svmc.random_state(gen, 36, batch=(2,), device="cpu")
    with pytest.raises(NotImplementedError, match="item 2 .generic graphs"):
        svmc.anneal_noisy(lat, a, torch.ones_like(a), 0.1, None, None, th,
                          gen)
    # a problem of the JAX package is refused; the port's own generic
    # IsingProblem runs (tests/test_torch_packed.py)
    generic = jinst.random_2d_lattice(4, rng=0)[0]
    with pytest.raises(NotImplementedError, match="not a problem of the"):
        svmc.anneal(generic, a, torch.ones_like(a), 0.1, th[:, :16], gen)
    with pytest.raises(NotImplementedError, match="not a problem of the"):
        api.solve(generic, "svmc", num_reads=2, sweeps=3)
    port_generic = tinst.random_2d_lattice(4, rng=0, device="cpu")[0]
    out = svmc.anneal(port_generic, a, torch.ones_like(a), 0.1, th[:, :16],
                      gen)
    assert out.shape == (2, 16)
    with pytest.raises(TypeError, match="unexpected options"):
        api.solve(lat, "svmc", slices=4)
    with pytest.raises(ValueError, match="problem on cpu"):
        svmc.anneal(lat, a, torch.ones_like(a), 0.1,
                    torch.ones((2, 36), device="meta"), gen)
    with pytest.raises(ValueError, match="problem on cpu"):
        svmc.anneal(tinst.gaussian_torus(5, seed=0, device="cpu"), a,
                    torch.ones_like(a), 0.1,
                    torch.ones((2, 25), device="meta"), gen)


def test_solve_svmc_options_and_readout():
    lat = tinst.gaussian_torus(6, seed=2, device="cpu")
    x = api.solve(lat, "svmc", num_reads=8, sweeps=40, seed=5)
    y = api.solve(lat, "svmc", num_reads=8, sweeps=40, seed=5)
    z = api.solve(lat, "svmc", num_reads=8, sweeps=40, seed=5,
                  field_start=1.0, temp=0.5)
    assert set(np.unique(x.samples)) <= {-1.0, 1.0}
    assert x.samples.shape == (8, 36) and x.info["method"] == "svmc"
    assert np.array_equal(x.samples, y.samples)
    assert not np.array_equal(x.samples, z.samples)
    assert np.all(np.diff(x.energies) >= 0)
    np.testing.assert_allclose(
        x.energies, lat.energy(torch.from_numpy(x.samples)).numpy())
