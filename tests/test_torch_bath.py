"""The port's dissipative PIQMC (`qmc.anneal(lookuptable=...)`) against the
JAX package.

`qmc_bath_split_anneal_ref` is the plain form of the CUDA kernel 5, and on
a CPU tensor the kernel wrapper runs it. Through the engine
`anneal_lattice_qmc_bath_split` it is held BITWISE against the Pallas
interpreter of `_qmc_bath_split_kernel` and against `oracle_qmc_bath`
(tests/test_pallas_split.py), on the same configurations, schedules, bath
table and counter seed. The oracle takes the bath field through
`jnp.einsum`, whose summation order could differ from the kernel's index
order at large P; the P = 40 case reports the first diverging step if it
ever does. The slice as a whole (pre-anneal, replicate, bath anneal) is held
against its JAX composition, and the plain engine's stationary histogram
against the exact Gibbs distribution of the bath-extended Hamiltonian.
"""

import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_pallas_split import oracle_qmc_bath
from test_qmc import extended_energy
from montecarlosolvers_tpu import schedules as jsched
from montecarlosolvers_tpu.models import instances as jinst
from montecarlosolvers_tpu.models.lattice import LatticeProblem as JLattice
from montecarlosolvers_tpu.ops import pallas_split
from montecarlosolvers_tpu.ops import piqmc as jpiqmc
from montecarlosolvers_tpu.solvers import qmc as jqmc
from montecarlosolvers_tpu_torch import convert
from montecarlosolvers_tpu_torch import schedules as tsched
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
from montecarlosolvers_tpu_torch.ops import packed as packed_ops
from montecarlosolvers_tpu_torch.ops import piqmc as tpiqmc
from montecarlosolvers_tpu_torch.ops import split as split_ops
from montecarlosolvers_tpu_torch.ops import split_kernels as sk
from montecarlosolvers_tpu_torch.solvers import qmc, sa
from montecarlosolvers_tpu_torch.solvers.dissipative import dissipative_qa

torch.set_num_threads(1)


def periodic(L, seed):
    r = np.random.default_rng(seed)
    return JLattice.from_planes(r.normal(size=(L, L)), r.normal(size=(L, L)))


def open_fields(L, seed):
    return jinst.random_2d_lattice(L, rng=seed, with_fields=True,
                                   lattice=True)[0]


def port_of(lat):
    return convert.lattice_from_arrays(
        np.asarray(lat.j_right), np.asarray(lat.j_down),
        np.asarray(lat.h_plane), col_wrap=lat.col_wrap, device="cpu")


def run_port(lat, a, b, P, lut, confs, seed, gm):
    return sk.anneal_lattice_qmc_bath_split(
        port_of(lat), torch.from_numpy(a), torch.from_numpy(b), 1.0 / P,
        convert.lookuptable_from_numpy(lut, device="cpu"),
        torch.from_numpy(confs), seed, global_moves=gm).numpy()


# ------------------------------------------------------------ bath tables


@pytest.mark.parametrize("P,alpha", list(itertools.product(
    (2, 3, 5, 40), (1e-3, 1e-2, 0.5))))
def test_lookuptable_and_matrix_equal_jax(P, alpha):
    jl = jsched.bath_lookuptable(P, alpha)
    tl = tsched.bath_lookuptable(P, alpha, device="cpu")
    assert tl.dtype == torch.float32 and tl.shape == (P - 1,)
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    assert np.array_equal(
        convert.lookuptable_from_numpy(np.asarray(jl), device="cpu").numpy(),
        np.asarray(jl))
    tm = tpiqmc.bath_matrix(tl, P)
    assert tm.dtype == torch.float32
    assert np.array_equal(tm.numpy(), np.asarray(jpiqmc.bath_matrix(jl, P)))
    # the directed offset: M[k, k'] = lut[(k' - k) mod P - 1], zero diagonal
    ramp = torch.arange(1, P, dtype=torch.float32)
    m = tpiqmc.bath_matrix(ramp, P)
    for k, kk in itertools.product(range(P), repeat=2):
        assert float(m[k, kk]) == (0.0 if k == kk else (kk - k) % P)


# ------------------------------------------ plain engine vs Pallas and oracle


@pytest.mark.parametrize(
    "lat_fn,L,P,bscale,gm",
    [
        (lambda: periodic(16, 1), 16, 2, 1.0, False),  # ring up == dn
        (lambda: periodic(16, 1), 16, 3, 0.7, True),
        (lambda: periodic(16, 2), 16, 4, 1.0, True),
        (lambda: periodic(16, 3), 16, 8, 0.7, False),
        (lambda: open_fields(32, 2), 32, 2, 0.7, True),
        (lambda: open_fields(32, 2), 32, 3, 1.0, False),
        (lambda: open_fields(32, 4), 32, 4, 0.7, False),
        (lambda: open_fields(32, 4), 32, 8, 1.0, True),
    ],
)
def test_bath_plain_equals_pallas_interpreter(lat_fn, L, P, bscale, gm):
    lat = lat_fn()
    rng = np.random.default_rng(L + P)
    confs = rng.choice([-1.0, 1.0], size=(2, P, L * L)).astype(np.float32)
    a = np.linspace(2.5, 1e-8, 10).astype(np.float32)
    b = np.full_like(a, bscale)
    lut = np.asarray(jsched.bath_lookuptable(P, 0.05))
    ref = np.asarray(pallas_split.anneal_lattice_qmc_bath_split(
        lat, a, b, 1.0 / P, lut, confs, seed=9, global_moves=gm,
        interpret=True))
    out = run_port(lat, a, b, P, lut, confs, 9, gm)
    assert np.array_equal(ref, out), f"{(ref != out).sum()} spins differ"
    assert (out != confs).mean() > 0.1  # the anneal did move spins


def first_divergence(lat, a, b, P, lut, confs, seed, gm):
    for k in range(1, len(a) + 1):
        ref = np.asarray(oracle_qmc_bath(lat, a[:k], b[:k], 1.0 / P, lut,
                                         confs, seed, gm))
        if not np.array_equal(ref, run_port(lat, a[:k], b[:k], P, lut,
                                            confs, seed, gm)):
            return k - 1
    return None


@pytest.mark.parametrize(
    "lat_fn,L,P,alpha,gm,steps",
    [
        (lambda: periodic(16, 1), 16, 4, 0.05, False, 10),
        (lambda: open_fields(16, 0), 16, 3, 0.05, True, 10),
        (lambda: open_fields(32, 2), 32, 4, 0.05, True, 10),
        (lambda: periodic(16, 4), 16, 40, 1e-2, True, 4),
        (lambda: periodic(16, 4), 16, 40, 0.5, True, 4),
    ],
)
def test_bath_plain_equals_oracle(lat_fn, L, P, alpha, gm, steps):
    lat = lat_fn()
    rng = np.random.default_rng(0)
    confs = rng.choice([-1.0, 1.0], size=(2, P, L * L)).astype(np.float32)
    a = np.linspace(2.5, 1e-8, steps).astype(np.float32)
    b = np.ones_like(a)
    lut = np.asarray(jsched.bath_lookuptable(P, alpha))
    ref = np.asarray(oracle_qmc_bath(lat, a, b, 1.0 / P, lut, confs, 3, gm))
    out = run_port(lat, a, b, P, lut, confs, 3, gm)
    if not np.array_equal(ref, out):
        pytest.fail(f"{(ref != out).sum()} spins differ; first diverging "
                    f"step {first_divergence(lat, a, b, P, lut, confs, 3, gm)}"
                    " (an einsum-order difference of the oracle's bath sum "
                    "shows as a divergence in an otherwise equal run)")


def test_zero_bath_orders_ferromagnet():
    # lut = 0: pure PIQMC on the slice-sequential sweep; J = -1 everywhere
    # (H = sum J s s), so the torus orders to E = -2 L^2
    L, P = 16, 4
    ferro = convert.lattice_from_arrays(-np.ones((L, L)), -np.ones((L, L)),
                                        np.zeros((L, L)), device="cpu")
    rng = np.random.default_rng(1)
    confs = torch.from_numpy(rng.choice([-1.0, 1.0], size=(2, P, L * L))
                             .astype(np.float32))
    a = tsched.transverse_field(3.0, 1e-8, 150, device="cpu")
    out = sk.anneal_lattice_qmc_bath_split(
        ferro, a, torch.ones_like(a), 1.0 / P, torch.zeros(P - 1), confs, 5,
        global_moves=True)
    assert float(ferro.energy(out).min()) == -2.0 * L * L


# ---------------------------------------------------- the slice as a whole


@pytest.mark.parametrize("seed,gm", [(0, True), (5, False)])
def test_bath_slice_equals_jax_composition(seed, gm):
    """The open-system protocol of examples/dissipative_qa.py at L = 16,
    P = 4: sa.random_state -> sa.anneal(pre-anneal, mcsteps=5) ->
    qmc.replicate -> qmc.anneal(lookuptable=...), against the same chain in
    JAX: the Pallas interpreters of `_split_kernel` and
    `_qmc_bath_split_kernel` around `qmc.replicate`, with the initial states
    and counter seeds the port's generator draws. pt = 2.9 keeps the
    pre-anneal to 3 temperatures."""
    L, P, reads, sweeps, pt, alpha = 16, 4, 2, 10, 2.9, 0.05
    jlat = periodic(L, seed + 20)
    lat = port_of(jlat)
    gen = torch.Generator().manual_seed(seed)
    s0 = sa.random_state(gen, L * L, batch=(reads,), device="cpu")
    pre = tsched.pre_anneal_schedule(3.0, pt, device="cpu")
    s1 = sa.anneal(lat, pre, s0, gen, mcsteps=5)
    gamma = tsched.transverse_field(3.0, 1e-8, sweeps, device="cpu")
    lut = tsched.bath_lookuptable(P, alpha, device="cpu")
    out = qmc.anneal(lat, gamma, torch.ones_like(gamma), pt / P,
                     qmc.replicate(s1, P), gen, global_moves=gm,
                     lookuptable=lut.numpy())

    gen = torch.Generator().manual_seed(seed)
    s0 = sa.random_state(gen, L * L, batch=(reads,), device="cpu").numpy()
    seed_pre, seed_bath = sa.draw_seed(gen), sa.draw_seed(gen)
    j1 = pallas_split.anneal_lattice_split(
        jlat, pre.numpy(), jnp.asarray(s0), seed=seed_pre, mcsteps=5,
        interpret=True)
    g = gamma.numpy()
    ref = pallas_split.anneal_lattice_qmc_bath_split(
        jlat, g, np.ones_like(g), pt / P, jsched.bath_lookuptable(P, alpha),
        jqmc.replicate(j1, P), seed=seed_bath, global_moves=gm,
        interpret=True)
    assert np.array_equal(s1.numpy(), np.asarray(j1))
    assert np.array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_allclose(
        qmc.best_slice_energy(lat, out).numpy(),
        np.asarray(jqmc.best_slice_energy(jlat, ref)), rtol=1e-6)


def test_dissipative_qa_runs_the_example_protocol():
    """`solvers/dissipative.py::dissipative_qa`, which chip_smoke.py and
    profiling.py drive, is examples/dissipative_qa.py:51-67 (pre-anneal
    3 -> 1 with mcsteps = 5, replicate, the bath anneal at B = 1, T = 1/P
    with global moves) and reads out each chain's best slice."""
    L, P, reads, sweeps, alpha, seed = 8, 4, 3, 6, 0.05, 2
    lat = port_of(periodic(L, 7))
    states, energies = dissipative_qa(lat, reads, sweeps, P, alpha, seed)

    gen = torch.Generator().manual_seed(seed)
    s = sa.random_state(gen, L * L, batch=(reads,), device="cpu")
    s = sa.anneal(lat, tsched.pre_anneal_schedule(3.0, 1.0, device="cpu"),
                  s, gen, mcsteps=5)
    a = tsched.transverse_field(3.0, 1e-8, sweeps, device="cpu")
    confs = qmc.anneal(lat, a, torch.ones_like(a), 1.0 / P,
                       qmc.replicate(s, P), gen, global_moves=True,
                       lookuptable=tsched.bath_lookuptable(P, alpha,
                                                           device="cpu"))
    es = lat.energy(confs)
    best = es.argmin(dim=-1)
    rows = torch.arange(reads)
    assert states.shape == (reads, L * L)
    assert np.array_equal(states, confs[rows, best].numpy())
    assert np.array_equal(energies, es.min(dim=-1).values.numpy())
    np.testing.assert_allclose(
        energies, lat.energy(torch.as_tensor(states)).numpy(), rtol=1e-6)


# ------------------------------------------- exact bath-extended Gibbs check


@pytest.mark.parametrize("P,gm", [(2, False), (2, True), (3, False),
                                  (3, True)])
def test_bath_samples_extended_gibbs(P, gm):
    """The lattice form of tests/test_qmc.py::TestDissipativeGibbs on the
    smallest lattice the split engine takes: an open 2 x 2 lattice with
    Gaussian couplings and fields, P = 2 (256 states) and P = 3 (4096),
    T = 0.45, Gamma = 0.6, B = 1, alpha = 0.1. The histogram of the plain
    engine's states (8192 chains x 80 samples 2 sweeps apart, after 30
    sweeps) must match the exact Boltzmann weights of `extended_energy` at
    T_eff = P*T to 0.004 in every state (7 standard errors of the largest
    weight, about 0.2, were the samples independent; runs read 0.0004 to
    0.0013) and to 0.03 in total variation (runs read 0.004 to 0.011).
    The bath moves the exact distribution by 0.055 in some state and by
    0.16 to 0.2 in total variation, so a sweep that dropped or misplaced
    the bath term would fail both."""
    L, temp, gamma, alpha = 2, 0.45, 0.6, 0.1
    jlat = open_fields(L, 7)
    lat = port_of(jlat)
    n = P * L * L
    lut = jsched.bath_lookuptable(P, alpha)
    bits = (np.arange(2 ** n)[:, None] >> np.arange(n)[None, :]) & 1
    states = (1.0 - 2.0 * bits).reshape(-1, P, L * L).astype(np.float32)
    es = np.asarray(extended_energy(jlat, jnp.asarray(states), temp,
                                    jnp.float32(gamma), lookuptable=lut),
                    dtype=np.float64)
    w = np.exp(-(es - es.min()) / (P * temp))
    p_exact = w / w.sum()

    chains, burn, samples, every = 8192, 30, 80, 2
    gen = torch.Generator().manual_seed(P)
    confs = sa.random_state(gen, n, batch=(chains,),
                            device="cpu").reshape(chains, P, L * L)
    a_c = torch.full((burn,), gamma)
    b_c = torch.ones(burn)
    confs = qmc.anneal(lat, a_c, b_c, temp, confs, gen, global_moves=gm,
                       lookuptable=np.asarray(lut))
    counts = np.zeros(2 ** n)
    for _ in range(samples):
        confs = qmc.anneal(lat, a_c[:every], b_c[:every], temp, confs, gen,
                           global_moves=gm, lookuptable=np.asarray(lut))
        b = (confs.reshape(chains, n) < 0).numpy().astype(np.int64)
        counts += np.bincount(b @ (1 << np.arange(n)), minlength=2 ** n)
    p_emp = counts / counts.sum()
    p_max = p_exact.max()
    assert 7 * np.sqrt(p_max * (1 - p_max) / (chains * samples)) <= 0.004
    assert np.abs(p_emp - p_exact).max() < 0.004, \
        (np.abs(p_emp - p_exact).max(), p_exact.max())
    assert 0.5 * np.abs(p_emp - p_exact).sum() < 0.03


# ------------------------------------------------------- routes, refusals


def test_bath_wrapper_routes_by_device():
    lat = port_of(periodic(8, 5))
    sl = split_ops.build_split(lat)
    P = 3
    h = torch.ones((2, P, sl.nh))
    sched = tsched.linear(1.0, 0.5, 3, device="cpu")
    bath = tpiqmc.bath_matrix(tsched.bath_lookuptable(P, 0.1, device="cpu"),
                              P)
    # a CPU tensor runs the plain version and launches nothing
    _build.reset_launches()
    out = sk.qmc_bath_split_anneal(sl, sched, sched, 1.0, bath, h, -h, 4,
                                   True)
    ref = sk.qmc_bath_split_anneal_ref(sl, sched, sched, 1.0, bath, h, -h, 4,
                                       True)
    assert all(torch.equal(x, y) for x, y in zip(out, ref))
    assert not any(_build.LAUNCHES.values())
    # a device with neither form raises instead of falling back
    meta = torch.ones((2, P, sl.nh), device="meta")
    with pytest.raises(ValueError, match="no split engine"):
        sk.qmc_bath_split_anneal(sl, sched, sched, 1.0, bath, meta, meta, 0,
                                 True)


def h100_resident(R, threads):
    """A stand-in for the card's cudaOccupancyMaxActiveClusters: clusters
    of R CTAs, 5 CTAs an SM, on 7 GPCs of 16 SMs (an H100 SXM holds 35
    clusters of 16 CTAs of 224 threads; PERF.md)."""
    assert threads <= sk.MAX_THREADS and threads % 32 == 0
    return 7 * (16 * 5 // R)


# (L, P) -> (R at the main path's 32 chains, R at 1280 chains): the largest
# cluster whose band fits 227 KB and whose clusters the card holds at once,
# else the smallest that fits
@pytest.mark.parametrize("L,P,r_32,r_1280", [
    (80, 40, 16, 1), (168, 40, 16, 1), (176, 40, 16, 2), (256, 40, 16, 4),
    (256, 64, 16, 4), (256, 128, 16, 8)])
def test_bath_cluster_geometry(L, P, r_32, r_1280):
    """Kernel 5 spreads a chain over a cluster of R CTAs, each holding a
    band of rows of both halves' bit planes and the bath matrix; every even
    L up to 256 fits at P <= 128 (README.md and ROADMAP.md state it)."""
    for chains, want in ((32, r_32), (1280, r_1280)):
        R, threads = sk.qmc_bath_geometry(chains, L, P, h100_resident)
        assert R == want
        assert sk.qmc_bath_smem_bytes(P, L, R) <= _build.SMEM_LIMIT_BYTES
        assert R == 1 or sk.qmc_bath_smem_bytes(P, L, R // 2) \
            > _build.SMEM_LIMIT_BYTES or h100_resident(R, threads) >= chains
        band = sk.band_sites(L, R)
        assert threads == min(sk.MAX_THREADS, -(-band // 32) * 32)
        assert band * R >= L * L // 2
    # without a count of resident clusters, the largest cluster that fits
    assert sk.qmc_bath_geometry(32, L, P)[0] == 16


def test_bath_cluster_geometry_refuses_what_no_cluster_holds():
    # P = 128 at L = 1024: a band of 1024 / 16 rows is 1.1 MB; the first
    # even L no cluster of 16 CTAs holds is 402 at P = 128 and 674 at
    # P = 40, and the per-phase kernels run there
    assert sk.qmc_bath_geometry(32, 1024, 128) is None
    assert sk.qmc_bath_geometry(32, 256, 128) is not None
    for L, P in ((402, 128), (674, 40)):
        assert sk.qmc_bath_geometry(1, L - 2, P)[0] == 16
        assert sk.qmc_bath_geometry(1, L, P) is None
        assert sk.qmc_bath_smem_bytes(P, L, 16) > _build.SMEM_LIMIT_BYTES


def test_bath_refusals():
    gen = torch.Generator().manual_seed(0)
    even = port_of(periodic(6, 0))
    odd = port_of(periodic(5, 0))
    a = tsched.linear(1.0, 0.5, 3, device="cpu")
    b = torch.ones_like(a)
    c = qmc.replicate(sa.random_state(gen, 36, batch=(2,), device="cpu"), 3)
    lut = tsched.bath_lookuptable(3, 0.1, device="cpu")
    # an odd L, and the colored sweep at odd P, run on the generic bath
    # engine, the lattice's checkerboard packed (tests/
    # test_torch_dissipative.py), and give its plain version's spins
    c5 = qmc.replicate(sa.random_state(gen, 25, batch=(2,), device="cpu"), 3)
    for lat, confs, bath_update in ((odd, c5, "sequential"),
                                    (even, c, "colored")):
        out = qmc.anneal(lat, a, b, 0.3, confs,
                         torch.Generator().manual_seed(7), lookuptable=lut,
                         bath_update=bath_update)
        pg = packed_ops.packed_from_lattice(lat)
        bq, jp, teff = tsched.qmc_terms(a, b, 0.3, 3, 1, torch.device("cpu"))
        ref = gk.generic_qmc_bath_anneal_ref(
            pg, bq, jp, teff, tpiqmc.bath_matrix(lut, 3),
            packed_ops.pack_state(pg, confs),
            sa.draw_seed(torch.Generator().manual_seed(7)), False,
            colored=bath_update == "colored")
        assert torch.equal(out, packed_ops.unpack_state(pg, ref))
        assert not torch.equal(out, confs)
    with pytest.raises(ValueError, match="even-L"):
        sk.anneal_lattice_qmc_bath_split(odd, a, b, 0.3, lut,
                                         torch.ones((2, 3, 25)), 0)
    with pytest.raises(ValueError, match="P >= 2"):
        qmc.anneal(even, a, b, 0.3, c[:, :1], gen,
                   lookuptable=torch.zeros(0))
    with pytest.raises(ValueError, match=r"expected \(2,\)"):
        qmc.anneal(even, a, b, 0.3, c, gen, lookuptable=lut[:1])
    with pytest.raises(ValueError, match=r"expected \(2,\)"):
        qmc.anneal(even, a, b, 0.3, c, gen,
                   lookuptable=tsched.bath_lookuptable(4, 0.1, device="cpu"))
    # the colored sweep at even P runs on kernel 5's colored template
    c4 = qmc.replicate(sa.random_state(gen, 36, batch=(2,), device="cpu"), 4)
    lut4 = tsched.bath_lookuptable(4, 0.1, device="cpu")
    out = qmc.anneal(even, a, b, 0.3, c4, torch.Generator().manual_seed(7),
                     lookuptable=lut4, bath_update="colored")
    sl = split_ops.build_split(even)
    bq, jp, teff = tsched.qmc_terms(a, b, 0.3, 4, 1, torch.device("cpu"))
    ref = sk.qmc_bath_split_colored_anneal_ref(
        sl, bq, jp, teff, tpiqmc.bath_matrix(lut4, 4),
        split_ops.pack_qmc(sl, c4),
        sa.draw_seed(torch.Generator().manual_seed(7)), False)
    assert torch.equal(out, split_ops.unpack_qmc(sl, *ref))
    with pytest.raises(ValueError, match="bath_update"):
        qmc.anneal(even, a, b, 0.3, c, gen, lookuptable=lut,
                   bath_update="nope")
    # without a lookuptable, bath_update is checked and otherwise ignored,
    # as in the JAX solver
    out = qmc.anneal(even, a, b, 0.3, c, gen, bath_update="colored")
    assert out.shape == c.shape
