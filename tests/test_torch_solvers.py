"""The port's solver entry points: the MST slice as a whole, distributions,
an exact Boltzmann check, determinism and refusals.

The port's solvers draw from the Pallas counter hash, so they equal JAX
compositions of the pure-JAX oracles bitwise, but only in distribution the
JAX solvers, which draw from threefry.
"""

import ast
import itertools
import pathlib
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_pallas_split import oracle_anneal, oracle_qmc
from montecarlosolvers_tpu.models import instances as jinst
from montecarlosolvers_tpu.models.lattice import LatticeProblem as JLattice
from montecarlosolvers_tpu.solvers import api as japi
from montecarlosolvers_tpu.solvers import qmc as jqmc
from montecarlosolvers_tpu_torch import convert
from montecarlosolvers_tpu_torch import schedules as tsched
from montecarlosolvers_tpu_torch.models import instances as tinst
from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
from montecarlosolvers_tpu_torch.ops import packed as tpk
from montecarlosolvers_tpu_torch.ops import piqmc as tpq
from montecarlosolvers_tpu_torch.solvers import api, qmc, sa

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def jax_torus(L, seed):
    r = np.random.default_rng(seed)
    return JLattice.from_planes(r.normal(size=(L, L)), r.normal(size=(L, L)))


def port_of(lat):
    return convert.lattice_from_arrays(
        np.asarray(lat.j_right), np.asarray(lat.j_down),
        np.asarray(lat.h_plane), col_wrap=lat.col_wrap, device="cpu")


@pytest.mark.parametrize("seed", [0, 5])
def test_mst_piqmc_slice_equals_jax_composition(seed):
    """solve("piqmc") at L = 16, P = 4 (pre-anneal with mcsteps = 100,
    replication, PIQMC with global moves, best-slice readout) against the
    same chain in JAX: oracle_anneal -> qmc.replicate -> oracle_qmc ->
    best slice. pt = 2.9 keeps the pre-anneal to 3 temperatures (300
    sweeps) for the oracle's sake; the seeds and initial states are the ones
    the port's generator draws."""
    L, P, reads, sweeps, pt = 16, 4, 4, 30, 2.9
    jlat = jax_torus(L, seed + 10)
    ss = api.solve(port_of(jlat), "piqmc", num_reads=reads, sweeps=sweeps,
                   slices=P, pt=pt, seed=seed)

    gen = torch.Generator().manual_seed(seed)
    s0 = sa.random_state(gen, L * L, batch=(reads,), device="cpu").numpy()
    seed_pre, seed_qmc = sa.draw_seed(gen), sa.draw_seed(gen)
    pre = np.repeat(
        tsched.pre_anneal_schedule(3.0, pt, device="cpu").numpy(), 100)
    gamma = tsched.transverse_field(3.0, 1e-8, sweeps, device="cpu").numpy()
    s1 = oracle_anneal(jlat, pre, jnp.asarray(s0), seed_pre)
    confs = oracle_qmc(jlat, gamma, np.ones_like(gamma), pt / P,
                       jqmc.replicate(s1, P), seed_qmc, global_moves=True)
    es = np.asarray(jlat.energy(confs))  # (reads, P)
    best = es.argmin(axis=-1)
    states = np.asarray(confs)[np.arange(reads), best]
    energies = es[np.arange(reads), best]
    order = np.argsort(energies)
    assert np.array_equal(ss.samples, states[order])
    np.testing.assert_allclose(ss.energies, energies[order], rtol=1e-6)
    np.testing.assert_allclose(
        ss.energies.min(),
        float(jnp.min(jqmc.best_slice_energy(jlat, confs))), rtol=1e-6)


def test_sa_distribution_matches_jax_solver():
    """Mean final energy of solve("sa") at L = 16, 256 reads, tau = 200,
    within 4 combined standard errors of the JAX solver's."""
    jlat = jax_torus(16, 7)
    port = api.solve(port_of(jlat), "sa", num_reads=256, sweeps=200, seed=1)
    ref = japi.solve(jlat, "sa", num_reads=256, sweeps=200, seed=1)
    se = np.hypot(port.energies.std(ddof=1), ref.energies.std(ddof=1)) / 16
    assert abs(port.energies.mean() - ref.energies.mean()) < 4 * se


def test_sa_samples_exact_boltzmann_mean():
    """4 x 4 torus at constant T = 1.5: the time-averaged energy of
    sa.anneal against the exact mean over all 2^16 states, within 4
    standard errors of the per-chain (batch) means."""
    L, temp, chains = 4, 1.5, 256
    lat = tinst.gaussian_torus(L, seed=3, device="cpu")
    jr, jd = lat.j_right.double().numpy(), lat.j_down.double().numpy()
    states = np.array(list(itertools.product((-1.0, 1.0), repeat=L * L)))
    sp = states.reshape(-1, L, L)
    e_all = ((jr * sp * np.roll(sp, -1, axis=-1)).sum(axis=(1, 2))
             + (jd * sp * np.roll(sp, -1, axis=-2)).sum(axis=(1, 2)))
    w = np.exp(-(e_all - e_all.min()) / temp)
    exact = float((w * e_all).sum() / w.sum())

    gen = torch.Generator().manual_seed(0)
    s = sa.random_state(gen, L * L, batch=(chains,), device="cpu")
    s = sa.anneal(lat, torch.full((100,), temp), s, gen)  # burn-in
    samples = []
    for _ in range(150):
        s = sa.anneal(lat, torch.full((2,), temp), s, gen)
        samples.append(lat.energy(s).double().numpy())
    chain_means = np.mean(samples, axis=0)
    se = chain_means.std(ddof=1) / np.sqrt(chains)
    assert abs(chain_means.mean() - exact) < 4 * se, (chain_means.mean(),
                                                      exact, se)


def test_ferromagnet_ground_states_through_solve():
    L = 16
    ferro = convert.lattice_from_arrays(-np.ones((L, L)), -np.ones((L, L)),
                                        np.zeros((L, L)), device="cpu")
    assert api.solve(ferro, "sa", num_reads=4, sweeps=200,
                     seed=2).best_energy == -2.0 * L * L
    ss = api.solve(ferro, "piqmc", num_reads=2, sweeps=100, slices=4,
                   pt=2.9, seed=2)
    assert ss.best_energy == -2.0 * L * L


def test_determinism_and_valid_spins():
    lat = tinst.gaussian_torus(10, seed=1, device="cpu")
    x = api.solve(lat, "sa", num_reads=8, sweeps=50, seed=3)
    y = api.solve(lat, "sa", num_reads=8, sweeps=50, seed=3)
    z = api.solve(lat, "sa", num_reads=8, sweeps=50, seed=4)
    assert set(np.unique(x.samples)) <= {-1.0, 1.0}
    assert x.samples.shape == (8, 100) and len(x) == 8
    assert np.array_equal(x.samples, y.samples)
    assert not np.array_equal(x.samples, z.samples)
    assert np.all(np.diff(x.energies) >= 0)
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    c = qmc.replicate(sa.random_state(g1, 100, batch=(2,), device="cpu"), 4)
    sa.random_state(g2, 100, batch=(2,), device="cpu")
    a = tsched.transverse_field(3.0, 1e-8, 20, device="cpu")
    out1 = qmc.anneal(lat, a, torch.ones_like(a), 0.25, c, g1,
                      global_moves=True)
    out2 = qmc.anneal(lat, a, torch.ones_like(a), 0.25, c, g2,
                      global_moves=True)
    assert torch.equal(out1, out2)
    assert set(torch.unique(out1).tolist()) <= {-1.0, 1.0}
    assert torch.equal(qmc.best_slice_energy(lat, out1),
                       lat.energy(out1).min(dim=-1).values)


def plain_generic_bath(problem, gamma, temp, lut, confs, gen_seed,
                       bath_update):
    """The generic bath engine's plain version on `problem` packed as
    qmc.anneal packs it, B = 1, no line moves, at the counter seed a
    generator seeded `gen_seed` draws first."""
    pg = (tpk.build_packed(problem) if tpk.supports_packed(problem)
          else tpk.packed_from_lattice(problem))
    P = confs.shape[-2]
    b, jp, teff = tsched.qmc_terms(gamma, torch.ones_like(gamma), temp, P, 1,
                                   torch.device("cpu"))
    bath = tpq.bath_matrix(torch.as_tensor(lut, dtype=torch.float32), P)
    out = gk.generic_qmc_bath_anneal_ref(
        pg, b, jp, teff, bath, tpk.pack_state(pg, confs),
        sa.draw_seed(torch.Generator().manual_seed(gen_seed)), False,
        colored=bath_update == "colored")
    return tpk.unpack_state(pg, out)


def test_refusals():
    gen = torch.Generator().manual_seed(0)
    lat = tinst.gaussian_torus(6, seed=0, device="cpu")
    sched = tsched.linear(1.0, 0.0, 3, device="cpu")
    c = qmc.replicate(sa.random_state(gen, 36, batch=(2,), device="cpu"), 3)
    # dissipative PIQMC runs on every problem now, odd L and
    # bath_update="colored" included, and gives the plain version's spins
    # (tests/test_torch_dissipative.py)
    odd = tinst.gaussian_torus(5, seed=0, device="cpu")
    c5 = qmc.replicate(sa.random_state(gen, 25, batch=(2,), device="cpu"), 3)
    for prob, confs, bath_update in ((odd, c5, "sequential"),
                                     (lat, c, "colored")):
        out = qmc.anneal(prob, sched, torch.ones_like(sched), 0.3, confs,
                         torch.Generator().manual_seed(3),
                         lookuptable=np.ones(2), bath_update=bath_update)
        assert torch.equal(out, plain_generic_bath(
            prob, sched, 0.3, np.ones(2), confs, 3, bath_update))
    # odd P and odd L run now (tests/test_torch_plane.py), and so does the
    # port's own generic IsingProblem (tests/test_torch_packed.py); a
    # problem of the JAX package, such as its generic IsingProblem, is
    # still refused by every entry point
    generic = jinst.random_2d_lattice(4, rng=0)[0]
    with pytest.raises(NotImplementedError, match="not a problem of the"):
        qmc.anneal(generic, sched, torch.ones_like(sched), 0.3, c, gen)
    with pytest.raises(NotImplementedError, match="not a problem of the"):
        sa.anneal(generic, sched, sa.random_state(gen, 16, device="cpu"),
                  gen)
    with pytest.raises(NotImplementedError, match="not a problem of the"):
        api.solve(generic, "piqmc", num_reads=2, sweeps=3, slices=5)
    port_generic = tinst.random_2d_lattice(4, rng=0, lattice=False,
                                           device="cpu")[0]
    ss = api.solve(port_generic, "piqmc", num_reads=2, sweeps=3, slices=5,
                   pre_anneal=False)
    assert ss.samples.shape == (2, 16)
    # and so does the bath on an IsingProblem
    out = qmc.anneal(port_generic, sched, torch.ones_like(sched), 0.3,
                     c[:, :, :16], torch.Generator().manual_seed(3),
                     lookuptable=np.ones(2))
    assert torch.equal(out, plain_generic_bath(
        port_generic, sched, 0.3, np.ones(2), c[:, :, :16], 3,
        "sequential"))
    for fn in (sa.anneal_wolff, sa.anneal_sw, qmc.anneal_wolff, qmc.anneal_sw,
               qmc.anneal_sw_bath):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            fn(lat, sched, c, gen)
    # the noisy anneal runs on an IsingProblem (tests/test_torch_noisy.py);
    # a lattice has no neighbor table for its per-step couplings
    with pytest.raises(ValueError, match="take an IsingProblem"):
        sa.anneal_noisy(lat, sched, None, None, c[:, 0], gen)
    with pytest.raises(ValueError, match="unknown method"):
        api.solve(lat, "nope")
    with pytest.raises(TypeError, match="unexpected options"):
        api.solve(lat, "sa", slices=4)
    # the state must live where the problem lives: nothing is moved
    with pytest.raises(ValueError, match="problem on cpu"):
        sa.anneal(lat, sched, torch.ones((2, 36), device="meta"), gen)
    # no CUDA device here: a CUDA state cannot even be made
    with pytest.raises((RuntimeError, AssertionError)):
        sa.random_state(gen, 36, batch=(2,), device="cuda")


@pytest.mark.parametrize("method", sorted(api._NOT_PORTED))
def test_other_solve_methods_raise(method):
    lat = tinst.gaussian_torus(4, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        api.solve(lat, method)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "montecarlosolvers_tpu_torch").rglob("*.py"))
    # chip_smoke.py and the two helpers it loads from the checkout
    files += [REPO / "chip_smoke.py", REPO / "tests" / "gibbs_check.py",
              REPO / "tools" / "sass_counts.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "montecarlosolvers_tpu"), \
                f"{f.relative_to(REPO)} imports {mod}"
    code = ("import sys, montecarlosolvers_tpu_torch as m; "
            "from montecarlosolvers_tpu_torch.ops import split_kernels, "
            "plane_kernels; "
            "import montecarlosolvers_tpu_torch.convert; "
            "from montecarlosolvers_tpu_torch.ops import energy; "
            "from montecarlosolvers_tpu_torch.bench import mst; "
            "from montecarlosolvers_tpu_torch.examples import santoro_mst, "
            "dissipative_qa; "
            "from montecarlosolvers_tpu_torch.ops import generic_kernels; "
            "from montecarlosolvers_tpu_torch.models import instances, "
            "ising, coloring; "
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'montecarlosolvers_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=120)
