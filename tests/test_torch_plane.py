"""The port's full-plane SA and PIQMC engines against the JAX package.

`sa_plane_anneal_ref` and `qmc_plane_anneal_ref` are the plain forms of the
CUDA kernels 6 and 3, and on a CPU tensor the kernel wrappers run them.
They must equal the Pallas kernels `pallas_sa._sa_kernel` and
`pallas_qmc._qmc_kernel`, run in the Pallas interpreter as
tests/test_pallas.py and tests/test_pallas_qmc.py run them, BITWISE on the
spins. The interpreter works on the padded (pad8(L), pad128(L)) plane, so
these tests keep to L <= 6 (L = 16 for the whole slice), few chains and few
steps.

J_perp is computed by torch in the port and by XLA inside the Pallas
kernel; the two may differ in the last ulp of tanh or log (ROADMAP.md
queue 3), which could flip a decision whose dE lies within that ulp of its
threshold. None of the cases below meets one.
"""

import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.stats
import torch

from test_pallas_split import oracle_anneal
from montecarlosolvers_tpu.models import instances as jinst
from montecarlosolvers_tpu.models.lattice import LatticeProblem as JLattice
from montecarlosolvers_tpu.ops import pallas_qmc, pallas_sa
from montecarlosolvers_tpu.ops import piqmc as jpiqmc
from montecarlosolvers_tpu.solvers import api as japi
from montecarlosolvers_tpu.solvers import qmc as jqmc
from montecarlosolvers_tpu_torch import convert
from montecarlosolvers_tpu_torch import schedules as tsched
from montecarlosolvers_tpu_torch.models import instances as tinst
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import piqmc as tpiqmc
from montecarlosolvers_tpu_torch.ops import plane as plane_ops
from montecarlosolvers_tpu_torch.ops import plane_kernels as pk
from montecarlosolvers_tpu_torch.solvers import api, qmc, sa

torch.set_num_threads(1)


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


def spins(rng, *shape):
    return rng.choice([-1.0, 1.0], size=shape).astype(np.float32)


@pytest.mark.parametrize("lat_fn", [
    lambda: periodic(5, 0, fields=True),
    lambda: open_lattice(5, 1, fields=True),
    lambda: open_lattice(6, 2),
], ids=["L5-periodic", "L5-open", "L6-open"])
def test_sa_plain_equals_pallas_interpreter(lat_fn):
    """Also shows that torch.roll on L x L equals the Pallas kernel's padded
    plane with its masked correction rolls, on periodic and open L."""
    lat = lat_fn()
    s0 = spins(np.random.default_rng(lat.L), 3, lat.L * lat.L)
    sched = np.linspace(3.0, 0.1, 30).astype(np.float32)
    ref = np.asarray(pallas_sa.anneal_lattice(lat, sched, jnp.asarray(s0),
                                              seed=7, interpret=True))
    out = pk.anneal_lattice(port_of(lat), torch.from_numpy(sched),
                            torch.from_numpy(s0), 7)
    assert out.dtype == torch.float32 and out.shape == s0.shape
    assert np.array_equal(ref, out.numpy())
    assert not np.array_equal(s0, ref)


@pytest.mark.parametrize("gm", [True, False], ids=["global", "local"])
@pytest.mark.parametrize("bscale", [1.0, 0.7])
@pytest.mark.parametrize("lat_fn,P", [
    (lambda: periodic(4, 3, fields=True), 3),
    (lambda: periodic(4, 4), 5),
    (lambda: periodic(5, 5), 4),
], ids=["L4-P3", "L4-P5", "L5-P4"])
def test_qmc_plain_equals_pallas_interpreter(lat_fn, P, bscale, gm):
    lat = lat_fn()
    confs = spins(np.random.default_rng(P), 3, P, lat.L * lat.L)
    a = np.linspace(2.5, 1e-8, 24).astype(np.float32)
    b = np.full_like(a, bscale)
    ref = np.asarray(pallas_qmc.anneal_lattice_qmc(
        lat, a, b, 1.0 / P, jnp.asarray(confs), seed=9, global_moves=gm,
        interpret=True))
    out = pk.anneal_lattice_qmc(
        port_of(lat), torch.from_numpy(a), torch.from_numpy(b), 1.0 / P,
        torch.from_numpy(confs), 9, global_moves=gm).numpy()
    assert np.array_equal(ref, out), f"{(ref != out).sum()} spins differ"
    assert not np.array_equal(confs, ref)


def test_mst_piqmc_p5_slice_equals_jax_composition():
    """solve("piqmc", slices=5) at L = 16 (pre-anneal through kernel A's
    plain version, replication, PIQMC at odd P through kernel 3's plain
    version with global moves, best-slice readout) against the same chain
    in JAX: oracle_anneal -> qmc.replicate -> the Pallas interpreter of
    _qmc_kernel -> best slice. pt = 2.95 keeps the pre-anneal to one
    temperature (100 sweeps); seeds and initial states are the ones the
    port's generator draws."""
    L, P, reads, sweeps, pt, seed = 16, 5, 4, 30, 2.95, 3
    r = np.random.default_rng(13)
    jlat = JLattice.from_planes(r.normal(size=(L, L)), r.normal(size=(L, L)))
    ss = api.solve(port_of(jlat), "piqmc", num_reads=reads, sweeps=sweeps,
                   slices=P, pt=pt, seed=seed)

    gen = torch.Generator().manual_seed(seed)
    s0 = sa.random_state(gen, L * L, batch=(reads,), device="cpu").numpy()
    seed_pre, seed_qmc = sa.draw_seed(gen), sa.draw_seed(gen)
    pre = np.repeat(
        tsched.pre_anneal_schedule(3.0, pt, device="cpu").numpy(), 100)
    gamma = tsched.transverse_field(3.0, 1e-8, sweeps, device="cpu").numpy()
    s1 = oracle_anneal(jlat, pre, jnp.asarray(s0), seed_pre)
    confs = pallas_qmc.anneal_lattice_qmc(
        jlat, gamma, np.ones_like(gamma), pt / P, jqmc.replicate(s1, P),
        seed_qmc, global_moves=True, interpret=True)
    es = np.asarray(jlat.energy(confs))  # (reads, P)
    best = es.argmin(axis=-1)
    states = np.asarray(confs)[np.arange(reads), best]
    energies = es[np.arange(reads), best]
    order = np.argsort(energies)
    assert np.array_equal(ss.samples, states[order])
    np.testing.assert_allclose(ss.energies, energies[order], rtol=1e-6)


def _extended_gibbs_exact(lat, P, temp, jp):
    """Exact extended-Gibbs probabilities of all 2^(P*N) Trotter states,
    E = sum_k E_k - J_perp sum_k s_k . s_{k+1} (ring), weight exp(-E/PT);
    state index = sum over (k, i) of bit(s[k, i] > 0) << (k*N + i)."""
    n = lat.nspins
    bits = np.arange(2 ** (P * n))[:, None] >> np.arange(P * n)[None, :] & 1
    states = (2.0 * bits - 1.0).reshape(-1, P, n)
    e_slices = lat.energy(torch.from_numpy(states).float()).double().numpy()
    ring = (states * np.roll(states, -1, axis=1)).sum(axis=(1, 2))
    e = e_slices.sum(axis=1) - jp * ring
    w = np.exp(-(e - e.min()) / (temp * P))
    return w / w.sum()


@pytest.mark.parametrize("gm", [False, True], ids=["local", "global"])
def test_extended_gibbs_p3(gm):
    """Fixed (Gamma, T) at P = 3 on a 2 x 2 lattice (even L; odd P sends it
    to the full-plane engine): qmc.anneal must sample the exact
    extended-Gibbs distribution over the 2^12 Trotter states, as
    tests/test_pallas_qmc.py::test_extended_gibbs checks for the JAX
    kernel. Chi-square over the states, the rare ones pooled so every bin
    expects at least 10 samples."""
    L, P, temp, gamma, chains, steps = 2, 3, 0.8, 0.7, 16384, 60
    jr = np.zeros((L, L))
    jr[0, 0] = 0.9
    jd = np.zeros((L, L))
    jd[0, 0], jd[0, 1] = 0.5, -0.7
    h = np.array([[0.2, 0.0], [-0.3, 0.1]])
    lat = convert.lattice_from_arrays(jr, jd, h, device="cpu")
    a = torch.full((steps,), gamma)
    jp = float(tsched.jperp(a[:1], temp * P)[0])
    p_exact = _extended_gibbs_exact(lat, P, temp, jp)

    gen = torch.Generator().manual_seed(4)
    confs = sa.random_state(gen, P * L * L, batch=(chains,), device="cpu")
    out = qmc.anneal(lat, a, torch.ones_like(a), temp,
                     confs.reshape(chains, P, L * L), gen, global_moves=gm)
    idx = (out.reshape(chains, -1).numpy() > 0).astype(np.int64) \
        @ (1 << np.arange(P * L * L))
    counts = np.bincount(idx, minlength=p_exact.size)
    expect = p_exact * chains
    order = np.argsort(expect)
    rare = np.cumsum(expect[order]) < 10.0
    obs = np.append(counts[order][~rare], counts[order][rare].sum())
    exp = np.append(expect[order][~rare], expect[order][rare].sum())
    stat = ((obs - exp) ** 2 / exp).sum()
    pval = scipy.stats.chi2.sf(stat, obs.size - 1)
    assert pval > 1e-4, (stat, obs.size, pval)


def test_sa_distribution_on_open_odd_lattice():
    """Mean final energy of solve("sa") on an open 15 x 15 lattice, 256
    reads, tau = 200, within 4 combined standard errors of the JAX
    solver's."""
    jlat = open_lattice(15, 8)
    port = api.solve(port_of(jlat), "sa", num_reads=256, sweeps=200, seed=1)
    ref = japi.solve(jlat, "sa", num_reads=256, sweeps=200, seed=1)
    se = np.hypot(port.energies.std(ddof=1), ref.energies.std(ddof=1)) / 16
    assert abs(port.energies.mean() - ref.energies.mean()) < 4 * se


@pytest.mark.parametrize("L,periodic_", [(5, False), (7, False), (6, True)])
def test_ferromagnets_reach_ground_state_any_l(L, periodic_):
    """J = -1 on every bond: SA and PIQMC at P = 5 reach E_gs = -(number
    of bonds), through the full-plane engines on odd L (and at odd P on
    even L). An odd torus does not: see the next test."""
    jr, jd = -np.ones((L, L)), -np.ones((L, L))
    if not periodic_:
        jr[:, -1] = 0.0
        jd[-1, :] = 0.0
    ferro = convert.lattice_from_arrays(jr, jd, np.zeros((L, L)), device="cpu")
    e_gs = float(jr.sum() + jd.sum())
    assert api.solve(ferro, "sa", num_reads=4, sweeps=200,
                     seed=2).best_energy == e_gs
    ss = api.solve(ferro, "piqmc", num_reads=2, sweeps=100, slices=5,
                   pt=2.9, seed=2)
    assert ss.best_energy == e_gs


def test_odd_torus_wrap_pair_shares_a_phase():
    """A fault of the reference, copied by the port (ROADMAP.md queue 3):
    on an odd periodic L the two-color parity is not a proper coloring.
    (r, 0) and (r, L-1) are wrap neighbours of the same parity, so the
    Pallas kernel and the port update both in one phase from the same
    state. With a single ferromagnetic wrap bond and the pair anti-aligned,
    both flip at once at T = 0, every step, and the pair never aligns."""
    L = 5
    jr = np.zeros((L, L), np.float32)
    jr[0, L - 1] = -1.0  # the wrap bond (0, L-1) -- (0, 0)
    lat = JLattice.from_planes(jr, np.zeros((L, L), np.float32))
    assert (0 + 0) % 2 == (0 + L - 1) % 2  # one color
    s0 = np.ones((1, L * L), np.float32)
    s0[0, L - 1] = -1.0
    sched = np.zeros(7, np.float32)
    ref = np.asarray(pallas_sa.anneal_lattice(lat, sched, jnp.asarray(s0),
                                              seed=1, interpret=True))
    out = pk.anneal_lattice(port_of(lat), torch.from_numpy(sched),
                            torch.from_numpy(s0), 1).numpy()
    assert np.array_equal(ref, out)
    # 7 steps, one joint flip each: the pair is flipped and still opposed
    assert out[0, 0] == -1.0 and out[0, L - 1] == 1.0
    assert float(lat.energy(jnp.asarray(out))[0]) == 1.0  # E_gs is -1
    # What it costs: on the 7 x 7 ferromagnetic torus (E_gs = -98) every
    # read of solve("sa") ends far above the ground state, in the port as
    # in the JAX package's solve, masked engine and Pallas kernel.
    ferro = convert.lattice_from_arrays(-np.ones((7, 7)), -np.ones((7, 7)),
                                        np.zeros((7, 7)), device="cpu")
    ss = api.solve(ferro, "sa", num_reads=4, sweeps=200, seed=2)
    assert ss.energies.min() > -98.0


@pytest.mark.parametrize("lat_fn", [
    lambda: periodic(5, 1, fields=True),
    lambda: open_lattice(7, 2, fields=True),
    lambda: open_lattice(6, 3),
], ids=["L5-periodic", "L7-open", "L6-open"])
def test_convert_carries_odd_and_open_lattices(lat_fn):
    lat = lat_fn()
    port = port_of(lat)
    assert port.L == lat.L and port.col_wrap == lat.col_wrap
    s = spins(np.random.default_rng(0), 6, lat.L * lat.L)
    np.testing.assert_array_equal(
        port.local_fields(torch.from_numpy(s)).numpy(),
        np.asarray(lat.local_fields(jnp.asarray(s))))
    np.testing.assert_allclose(port.energy(torch.from_numpy(s)).numpy(),
                               np.asarray(lat.energy(jnp.asarray(s))),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("L", [5, 7])
def test_instances_odd_l_match_jax(L):
    tor = tinst.gaussian_torus(L, seed=L, device="cpu")
    ref = periodic(L, L)
    lat, (rows, cols, vals) = tinst.random_2d_lattice(L, rng=L,
                                                      with_fields=True,
                                                      lattice=True,
                                                      device="cpu")
    jlat, (jrows, jcols, jvals) = jinst.random_2d_lattice(
        L, rng=L, with_fields=True, lattice=True)
    for port, jax_lat in ((tor, ref), (lat, jlat)):
        for name in ("j_right", "j_down", "h_plane"):
            np.testing.assert_array_equal(getattr(port, name).numpy(),
                                          np.asarray(getattr(jax_lat, name)))
        assert port.col_wrap == jax_lat.col_wrap
    for x, y in ((rows, jrows), (cols, jcols), (vals, jvals)):
        np.testing.assert_array_equal(x, y)


def test_plane_layout_matches_padded_planes():
    for lat in (periodic(5, 2, fields=True), open_lattice(7, 4)):
        pl = plane_ops.build_plane(port_of(lat))
        planes, R, C, _, _ = pallas_sa.padded_planes(lat)
        assert (R, C) == pl.strides
        for got, want in zip(pl.w, planes):
            np.testing.assert_array_equal(got.numpy(),
                                          want[:lat.L, :lat.L])
        s = spins(np.random.default_rng(1), 2, lat.L, lat.L)
        np.testing.assert_array_equal(
            plane_ops.neighbor_sum(pl, torch.from_numpy(s)).numpy(),
            np.asarray(lat.local_fields(jnp.asarray(s.reshape(2, -1))))
            .reshape(s.shape))


def test_spacetime_num_phases_matches_jax():
    for colors, P in itertools.product((2, 3, 4), range(1, 13)):
        assert tpiqmc.spacetime_num_phases(colors, P) == \
            jpiqmc.spacetime_num_phases(colors, P)
    assert [tpiqmc.spacetime_num_phases(2, P) for P in (3, 4, 5, 7)] == \
        [3, 2, 3, 4]


def test_plane_wrappers_route_by_device():
    lat = port_of(periodic(5, 6))
    pl = plane_ops.build_plane(lat)
    sched = tsched.linear(1.0, 0.0, 3, device="cpu")
    s = torch.ones((2, 5, 5))
    c = torch.ones((2, 3, 5, 5))
    # a CPU tensor runs the plain version and launches nothing
    _build.reset_launches()
    assert torch.equal(pk.sa_plane_anneal(pl, sched, s, 0),
                       pk.sa_plane_anneal_ref(pl, sched, s, 0))
    jp = tsched.jperp(sched, 1.0)
    assert torch.equal(
        pk.qmc_plane_anneal(pl, sched, jp, 1.0, c, 0, True),
        pk.qmc_plane_anneal_ref(pl, sched, jp, 1.0, c, 0, True))
    assert not any(_build.LAUNCHES.values())
    # a device with neither form raises instead of falling back
    with pytest.raises(ValueError, match="no plane engine"):
        pk.sa_plane_anneal(pl, sched, s.to("meta"), 0)
    with pytest.raises(ValueError, match="no plane engine"):
        pk.qmc_plane_anneal(pl, sched, jp, 1.0, c.to("meta"), 0, True)
