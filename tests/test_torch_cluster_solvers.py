"""The port's cluster solvers on the CPU: the exact-Gibbs histograms of
tests/test_cluster_exact.py re-run on their engines through
tests/gibbs_check.py (the largest |mean - exact| over the states within
5 standard errors of the chain means, the bound of the other samplers),
and the API: sa.anneal_wolff / anneal_sw, qmc.anneal_wolff / anneal_sw /
anneal_sw_bath and the five cluster methods of solve(): shapes,
determinism, the options refused, a DenseProblem refused."""

import numpy as np
import pytest
import torch

import gibbs_check as gc
from montecarlosolvers_tpu.models import instances as jinst
from montecarlosolvers_tpu_torch import schedules
from montecarlosolvers_tpu_torch.models import instances as tinst
from montecarlosolvers_tpu_torch.models.ising import IsingProblem
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.solvers import api, qmc, sa

torch.set_num_threads(1)

CHAINS, Z = 128, 5.0


def _check(per_chain, exact):
    z, d = gc.z_scores(per_chain, exact, gc.SAMPLES)
    assert z < Z, (z, d)


# -------------------------------------------------- classical Wolff and SW


@pytest.mark.parametrize("kind,j,h,local_sweeps", [
    ("wolff", 0.9, (0.0, 0.0), False), ("wolff", -0.8, (0.0, 0.0), False),
    ("wolff", 0.9, (0.4, -0.3), True), ("wolff", 0.9, (0.4, -0.3), False),
    ("sw", 0.9, (0.0, 0.0), False), ("sw", -0.8, (0.0, 0.0), False),
    ("sw", 0.9, (0.4, -0.3), False), ("sw", -0.7, (0.5, 0.2), True)])
def test_classical_cluster_two_spins(kind, j, h, local_sweeps):
    prob = gc.two_spin_problem(j, h, "cpu")
    f = gc.sample_cluster_sa(kind, prob, CHAINS, 1.3, 30, local_sweeps)
    _check(f, gc.generic_sa_weights(prob, 1.3))


def test_classical_wolff_triangle_with_field():
    prob = IsingProblem.from_edges(3, [0, 0, 1, 0], [1, 2, 2, 0],
                                   [0.8, 0.8, 0.8, 0.25], maxnb=3,
                                   device="cpu")
    f = gc.sample_cluster_sa("wolff", prob, CHAINS, 1.1, 31, True)
    _check(f, gc.generic_sa_weights(prob, 1.1))


def test_classical_sw_four_spin_ring_with_fields():
    prob = IsingProblem.from_edges(4, [0, 1, 2, 3, 0, 1], [1, 2, 3, 0, 0, 1],
                                   [0.8, -0.6, 0.9, 0.7, 0.35, -0.2],
                                   maxnb=4, device="cpu")
    f = gc.sample_cluster_sa("sw", prob, CHAINS, 1.2, 32, False)
    _check(f, gc.generic_sa_weights(prob, 1.2))


# ---------------------------------------- PIQMC clusters: extended Gibbs


@pytest.mark.parametrize("kind,j,h,gamma", [
    ("wolff", 0.9, (0.0, 0.0), 0.7), ("wolff", -0.8, (0.0, 0.0), 0.7),
    ("wolff", 0.9, (0.4, -0.3), 0.6), ("sw", 0.9, (0.0, 0.0), 0.7),
    ("sw", -0.8, (0.0, 0.0), 0.7), ("sw", 0.9, (0.4, -0.3), 0.6)])
def test_spacetime_clusters_two_spins(kind, j, h, gamma):
    prob = gc.two_spin_problem(j, h, "cpu")
    P, temp = 2, 0.8
    f = gc.sample_cluster_qmc(kind, prob, CHAINS, P, temp, gamma, 33)
    _check(f, gc.generic_qmc_weights(prob, P, temp, gc.jperp(gamma, P,
                                                             temp)))


@pytest.mark.parametrize("kind,P,alpha,local_sweeps", [
    ("wolff", 2, 0.3, False), ("sw", 2, 0.3, False), ("sw", 3, 0.3, False),
    ("wolff", 4, 0.2, False)])
def test_spacetime_clusters_with_bath(kind, P, alpha, local_sweeps):
    """The bath bonds in the FK draw. anneal_sw's local sweeps carry no
    bath term (JAX solvers/qmc.py:299-301, piqmc.local_sweep), so with a
    bath they would not keep this measure: the clusters run alone here."""
    prob = gc.two_spin_problem(0.8, (0.0, 0.0), "cpu")
    temp, gamma = 0.9 * 2 / P, 0.6
    f = gc.sample_cluster_qmc(kind, prob, CHAINS, P, temp, gamma, 34,
                              alpha=alpha, local_sweeps=local_sweeps)
    _check(f, gc.generic_qmc_weights(prob, P, temp, gc.jperp(gamma, P, temp),
                                     bath=gc.bath_matrix(P, alpha)))


@pytest.mark.parametrize("P,per_slice_seeds,local_sweeps", [
    (2, False, False), (2, True, False), (3, False, True), (4, True, False)])
def test_sw_bath_lines_with_bath(P, per_slice_seeds, local_sweeps):
    """WC2 and WC3 (tests/test_cluster_exact.py::TestSWBathExactGibbs),
    extended to P = 3 with the dissipative local sweeps and P = 4."""
    prob = gc.two_spin_problem(0.7, (0.2, 0.0), "cpu")
    temp, gamma, alpha = 0.9 * 2 / P, 0.6, 0.4
    f = gc.sample_cluster_qmc("line", prob, CHAINS, P, temp, gamma, 35,
                              alpha=alpha, per_slice_seeds=per_slice_seeds,
                              local_sweeps=local_sweeps)
    _check(f, gc.generic_qmc_weights(prob, P, temp, gc.jperp(gamma, P, temp),
                                     bath=gc.bath_matrix(P, alpha)))


# ------------------------------------------------------------------ the API


def _lattice():
    return tinst.random_2d_lattice(4, rng=5, lattice=True, device="cpu")[0]


def _qmc_args(P=4, chains=3):
    gen = torch.Generator().manual_seed(2)
    a = schedules.transverse_field(2.0, 0.5, 6, device="cpu")
    confs = qmc.replicate(sa.random_state(gen, 16, batch=(chains,),
                                          device="cpu"), P)
    return a, torch.ones_like(a), 0.25, confs


QMC_SOLVERS = {
    "wolff_local": lambda p, a, b, t, c, g: qmc.anneal_wolff(p, a, b, t, c,
                                                             g),
    "wolff_full": lambda p, a, b, t, c, g: qmc.anneal_wolff(p, a, b, t, c, g,
                                                            rule="full"),
    "wolff_bath": lambda p, a, b, t, c, g: qmc.anneal_wolff(
        p, a, b, t, c, g, lookuptable=schedules.bath_lookuptable(
            c.shape[-2], 0.01, device="cpu")),
    "sw": lambda p, a, b, t, c, g: qmc.anneal_sw(p, a, b, t, c, g,
                                                 local_sweeps=True),
    "sw_bath": lambda p, a, b, t, c, g: qmc.anneal_sw(
        p, a, b, t, c, g, lookuptable=np.asarray(schedules.bath_lookuptable(
            c.shape[-2], 0.01, device="cpu"))),
    "wc2": lambda p, a, b, t, c, g: qmc.anneal_sw_bath(
        p, a, b, t, schedules.bath_lookuptable(c.shape[-2], 0.01,
                                               device="cpu"), c, g,
        per_slice_seeds=False),
    "wc3": lambda p, a, b, t, c, g: qmc.anneal_sw_bath(
        p, a, b, t, schedules.bath_lookuptable(c.shape[-2], 0.01,
                                               device="cpu"), c, g),
}


@pytest.mark.parametrize("name", sorted(QMC_SOLVERS))
def test_qmc_cluster_solvers_shapes_and_determinism(name):
    lat = _lattice()
    a, b, temp, confs = _qmc_args()
    run = QMC_SOLVERS[name]
    out = run(lat, a, b, temp, confs, torch.Generator().manual_seed(4))
    assert out.shape == confs.shape and out.dtype == torch.float32
    assert set(torch.unique(out).tolist()) <= {-1.0, 1.0}
    again = run(lat, a, b, temp, confs, torch.Generator().manual_seed(4))
    assert torch.equal(out, again)
    other = run(lat, a, b, temp, confs, torch.Generator().manual_seed(5))
    assert not torch.equal(out, other)
    # the lattice runs as its generic form, unbatched too
    gen = lat.to_generic()
    assert torch.equal(out, run(gen, a, b, temp, confs,
                                torch.Generator().manual_seed(4)))
    one = run(lat, a, b, temp, confs[0], torch.Generator().manual_seed(4))
    assert one.shape == confs.shape[1:]


@pytest.mark.parametrize("fn", ["anneal_wolff", "anneal_sw"])
def test_classical_cluster_solvers_shapes_and_determinism(fn):
    lat = _lattice()
    gen = torch.Generator().manual_seed(0)
    s0 = sa.random_state(gen, 16, batch=(2, 3), device="cpu")
    sched = schedules.linear(2.0, 0.5, 5, device="cpu")
    run = getattr(sa, fn)
    for local in (True, False):
        out = run(lat, sched, s0, torch.Generator().manual_seed(1),
                  local_sweeps=local)
        assert out.shape == (2, 3, 16)
        assert set(torch.unique(out).tolist()) <= {-1.0, 1.0}
        assert torch.equal(out, run(lat, sched, s0,
                                    torch.Generator().manual_seed(1),
                                    local_sweeps=local))


@pytest.mark.parametrize("method,kw", [
    ("sa_wolff", {}), ("sa_sw", {"local_sweeps": False}),
    ("piqmc_wolff", {"rule": "full", "slices": 3}),
    ("piqmc_wolff", {"alpha": 0.01, "slices": 4}),
    ("piqmc_sw", {"slices": 4}),
    ("piqmc_sw", {"slices": 3, "per_slice_seeds": False, "alpha": 0.01}),
    ("piqmc_sw_full", {"slices": 4}),
    ("piqmc_sw_full", {"slices": 2, "alpha": 0.01, "local_sweeps": False})])
def test_solve_cluster_methods(method, kw):
    prob = tinst.gaussian_torus(4, seed=0, device="cpu").to_generic()
    kw = dict(kw)
    if method.startswith("piqmc"):
        kw["pre_anneal"] = False
    ss = api.solve(prob, method, num_reads=3, sweeps=4, seed=1, **kw)
    assert ss.samples.shape == (3, 16) and len(ss) == 3
    assert np.all(np.diff(ss.energies) >= 0)
    assert np.allclose(ss.energies, gc.generic_energies(
        prob, ss.samples.astype(np.float64)), atol=1e-4)
    again = api.solve(prob, method, num_reads=3, sweeps=4, seed=1, **kw)
    assert np.array_equal(ss.samples, again.samples)


def test_solve_cluster_quality_on_a_ferromagnet():
    """A ferromagnetic ring anneals to its ground state through every
    cluster method."""
    n = 12
    prob = IsingProblem.from_edges(n, np.arange(n), (np.arange(n) + 1) % n,
                                   -np.ones(n), device="cpu")
    for method in ("sa_wolff", "sa_sw", "piqmc_wolff", "piqmc_sw",
                   "piqmc_sw_full"):
        kw = {"slices": 4, "pre_anneal": False} if "piqmc" in method else {}
        ss = api.solve(prob, method, num_reads=4, sweeps=60, seed=2, **kw)
        assert ss.best_energy == -n, method


def test_cluster_refusals():
    lat = _lattice()
    a, b, temp, confs = _qmc_args()
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="rule must be"):
        qmc.anneal_wolff(lat, a, b, temp, confs, gen, rule="greedy")
    with pytest.raises(TypeError, match="unexpected options"):
        api.solve(lat, "sa_wolff", rule="local")
    with pytest.raises(TypeError, match="unexpected options"):
        api.solve(lat, "piqmc_sw", local_sweeps=True)
    dense = tinst.sk_model(8, rng=0, device="cpu")[0]
    for call in (lambda: sa.anneal_wolff(dense, a, torch.ones(2, 8), gen),
                 lambda: sa.anneal_sw(dense, a, torch.ones(2, 8), gen),
                 lambda: qmc.anneal_sw_bath(dense, a, b, temp, np.ones(3),
                                            torch.ones(2, 4, 8), gen),
                 lambda: api.solve(dense, "piqmc_sw_full", slices=4)):
        with pytest.raises(NotImplementedError, match="DenseProblem"):
            call()
    jprob = jinst.random_2d_lattice(4, rng=0)[0]
    with pytest.raises(NotImplementedError, match="not a problem of the"):
        qmc.anneal_sw(jprob, a, b, temp, confs, gen)
    with pytest.raises(ValueError, match="problem on cpu"):
        sa.anneal_sw(lat, a, torch.ones((2, 16), device="meta"), gen)
    with pytest.raises(ValueError, match="P >= 2"):
        qmc.anneal_sw_bath(lat, a, b, temp, np.ones(0), confs[:, :1], gen)
    # the reference's memory guard: (chains, N, P, P) bond tensors > 8 GiB
    big = torch.ones((1, 40, 16)).expand(32768, 40, 16)
    for call in (lambda: qmc.anneal_wolff(
            lat, a, b, temp, big, gen, lookuptable=np.ones(39)),
                 lambda: qmc.anneal_sw(lat, a, b, temp, big, gen,
                                       lookuptable=np.ones(39))):
        with pytest.raises(ValueError, match="GiB"):
            call()
    assert not any(_build.LAUNCHES.values())
