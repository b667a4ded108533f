"""The rest of dissipative PIQMC in the port: the bath on an IsingProblem,
on odd-L lattices and with bath_update="colored", against the JAX package.

- The plain sweeps (`ops/piqmc.py::dissipative_local_sweep`,
  `dissipative_colored_sweep`, then `global_line_moves`; `ops/split.py::
  qmc_bath_split_colored_sweep`, then kernel B's line moves) against the
  JAX functions on the same `jax.random` uniforms: 0 mismatched spins, and
  energies within 1e-6 of sum |J| + sum |h|. The JAX colored sweep
  contracts the (P, P) bath matrix in one einsum, which XLA's CPU dot adds
  in four lanes from P = 4 on where the port adds in index order
  (ROADMAP.md queue 3); the bath fields then differ in the last ulp, and
  no spin here differs.
- The masked sweeps on the original order against the packed engine
  (`ops/generic_kernels.py::anneal_generic_qmc_bath`, the plain version of
  csrc/generic_qmc_bath.cu), bitwise on the counter hash, the odd torus's
  improper checkerboard included.
- Exact distributions: the sequential sweep samples the bath-extended
  Gibbs weights (tests/test_qmc.py::TestDissipativeGibbs's case, and the
  bonded pair of tests/gibbs_check.py on an odd lattice), within 5
  standard errors of the chain means; the colored forms sit within the
  total variation bound of tests/test_split.py (0.03).
- The slice as a whole: examples/dissipative_qa.py's protocol on a small
  neighbor-table problem, the port's sweeps composed on the JAX scan's
  keys against the JAX solver.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gibbs_check as gc
from test_qmc import extended_energy
from montecarlosolvers_tpu import schedules as jsched
from montecarlosolvers_tpu.models import instances as jinst
from montecarlosolvers_tpu.models.ising import IsingProblem as JIsing
from montecarlosolvers_tpu.models.lattice import LatticeProblem as JLattice
from montecarlosolvers_tpu.ops import piqmc as jpq
from montecarlosolvers_tpu.ops import split as jsp
from montecarlosolvers_tpu.solvers import qmc as jqmc
from montecarlosolvers_tpu.solvers import sa as jsa
from montecarlosolvers_tpu_torch import convert
from montecarlosolvers_tpu_torch import schedules as tsched
from montecarlosolvers_tpu_torch.models import instances as tinst
from montecarlosolvers_tpu_torch.models.ising import (IsingProblem,
                                                      build_neighbor_table)
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import counter_rng as cr
from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
from montecarlosolvers_tpu_torch.ops import packed as tpk
from montecarlosolvers_tpu_torch.ops import piqmc as tpq
from montecarlosolvers_tpu_torch.ops import split as tsp
from montecarlosolvers_tpu_torch.ops import split_kernels as sk
from montecarlosolvers_tpu_torch.solvers import qmc, sa
from montecarlosolvers_tpu_torch.solvers.dissipative import dissipative_qa

torch.set_num_threads(1)

ENERGY_RTOL = 1e-6


def _lattice(L, periodic, seed):
    r = np.random.default_rng(seed)
    jr, jd = r.normal(size=(L, L)), r.normal(size=(L, L))
    h = 0.3 * r.normal(size=(L, L))
    if not periodic:
        jr[:, -1] = 0.0
        jd[-1, :] = 0.0
    jlat = JLattice.from_planes(jr, jd, h)
    return convert.lattice_from_arrays(jr, jd, h, device="cpu"), jlat


# name -> () -> (the port's problem, the JAX one)
PROBLEMS = {
    # 3 colors, with fields
    "rg_fields3": lambda: (
        tinst.random_graph(24, 36, rng=2, with_fields=True, device="cpu")[0],
        jinst.random_graph(24, 36, rng=2, with_fields=True)[0]),
    # 9 colors
    "rg9": lambda: (tinst.random_graph(2000, 12000, rng=0, device="cpu")[0],
                    jinst.random_graph(2000, 12000, rng=0)[0]),
    # the wrap pairs share a color
    "odd_torus": lambda: _lattice(5, True, 1),
    "odd_open": lambda: _lattice(5, False, 2),
    # even L, taken at odd P
    "even_torus": lambda: _lattice(6, True, 3),
}


def spins(shape, seed):
    return np.random.default_rng(seed).choice([-1.0, 1.0], size=shape) \
        .astype(np.float32)


def t32(x):
    return torch.tensor(x, dtype=torch.float32)


def scale_of(problem):
    return gc.problem_scale(problem)


# ------------------------------------------ one sweep, JAX's uniforms


@pytest.mark.parametrize("colored", [False, True])
@pytest.mark.parametrize("name,P", [
    ("rg_fields3", 4), ("rg_fields3", 40), ("rg9", 3), ("odd_torus", 5),
    ("odd_torus", 16), ("odd_open", 4), ("even_torus", 3)])
def test_plain_sweeps_equal_jax(name, P, colored):
    port, jprob = PROBLEMS[name]()
    n = port.nspins
    temp, gamma, b = 0.45, np.float32(0.7), np.float32(0.8)
    teff = temp * P
    c = spins((3, P, n), P)
    key = jax.random.key(P)
    u = np.array(jax.random.uniform(key, c.shape))
    lut = jsched.bath_lookuptable(P, 0.3)
    bath = jpq.bath_matrix(lut, P)
    jfn, tfn = ((jpq.dissipative_colored_sweep, tpq.dissipative_colored_sweep)
                if colored else (jpq.dissipative_local_sweep,
                                 tpq.dissipative_local_sweep))
    want = np.asarray(jfn(jprob, jnp.asarray(c), key, temp,
                          jnp.float32(gamma), jnp.float32(b), bath))
    jp = torch.as_tensor(np.array(jsched.jperp(jnp.float32(gamma), teff)))
    got = tfn(port, torch.as_tensor(c), torch.as_tensor(u), teff, jp, t32(b),
              torch.as_tensor(np.array(bath)))
    assert np.array_equal(got.numpy(), want)
    assert (want != c).mean() > 0.1
    # then the line moves, on JAX's line uniforms
    ul = np.array(jax.random.uniform(key, (3, n)))
    want2 = np.asarray(jpq.global_line_moves(jprob, jnp.asarray(want), key,
                                             temp, jnp.float32(b)))
    got2 = tpq.global_line_moves(port, torch.as_tensor(want),
                                 torch.as_tensor(ul), teff, t32(b))
    assert np.array_equal(got2.numpy(), want2)
    assert (want2 != want).any()
    np.testing.assert_allclose(
        port.energy(got2).numpy(), np.asarray(jprob.energy(want2)), rtol=0,
        atol=ENERGY_RTOL * scale_of(port))


@pytest.mark.parametrize("L,periodic,P", [(6, True, 2), (6, True, 4),
                                          (4, False, 8), (6, True, 40)])
def test_colored_quarter_sweep_equals_jax(L, periodic, P):
    """`split.qmc_bath_split_colored_sweep` and kernel B's line moves
    (`split_kernels.quarter_line_moves`) against JAX's
    `qmc_bath_split_colored_sweep` and `qmc_split_global`."""
    port, jlat = _lattice(L, periodic, L + P)
    tsl, jsl = tsp.build_split(port), jsp.build_split(jlat)
    temp, gamma, b = 0.45, np.float32(0.7), np.float32(0.8)
    teff = temp * P
    c = spins((3, P, L * L), P)
    jq = jsp.pack_qmc(jsl, jnp.asarray(c))
    key = jax.random.key(P)
    us = [torch.as_tensor(np.array(jax.random.uniform(k, q.shape)))
          for k, q in zip(jax.random.split(key, 4), jq)]
    bath = jpq.bath_matrix(jsched.bath_lookuptable(P, 0.3), P)
    want = jsp.qmc_bath_split_colored_sweep(
        jsl, *jq, key, temp, jnp.float32(gamma), jnp.float32(b), bath)
    jp = torch.as_tensor(np.array(jsched.jperp(jnp.float32(gamma), teff)))
    got = tsp.qmc_bath_split_colored_sweep(
        tsl, tsp.pack_qmc(tsl, torch.as_tensor(c)), us, teff, jp, t32(b),
        torch.as_tensor(np.array(bath)))
    w = np.asarray(jsp.unpack_qmc(jsl, *want))
    assert np.array_equal(tsp.unpack_qmc(tsl, *got).numpy(), w)
    assert (w != c).mean() > 0.1
    want2 = jsp.qmc_split_global(jsl, *want, key, temp, jnp.float32(b))
    ka, kb = jax.random.split(key)
    ul = {0: torch.as_tensor(np.array(jax.random.uniform(ka, (3, L * L // 2)))),
          1: torch.as_tensor(np.array(jax.random.uniform(kb, (3, L * L // 2))))}
    got2 = sk.quarter_line_moves(tsl, got, -2.0 * t32(b), t32(teff),
                                 lambda color, shape: ul[color])
    w2 = np.asarray(jsp.unpack_qmc(jsl, *want2))
    assert np.array_equal(tsp.unpack_qmc(tsl, *got2).numpy(), w2)
    assert (w2 != w).any()


# ------------------------------------------ the checkerboard packing


@pytest.mark.parametrize("name,proper", [("odd_torus", False),
                                         ("odd_open", True),
                                         ("even_torus", True)])
def test_checkerboard_packing_is_the_lattice(name, proper):
    """`packed_from_lattice`: the checkerboard's blocks, the slots in
    local_fields' order (so the packed fields equal the lattice's
    bitwise), and the flag of a coloring that is not proper."""
    lat = PROBLEMS[name]()[0]
    pg = tpk.packed_from_lattice(lat)
    assert pg.proper is proper
    assert pg.num_colors == 2
    assert torch.equal(pg.as_problem().colors[pg.inv], lat.colors)
    s = torch.as_tensor(spins((4, lat.nspins), 0))
    packed = tpk.block_fields(pg, tpk.pack_state(pg, s), 0, lat.nspins)
    assert torch.equal(tpk.unpack_state(pg, packed), lat.local_fields(s))


# ------------------------------- masked and packed on the counter hash


def masked_bath_anneal(problem, b, jp, teff, bath, confs, seed, gm, colored):
    """The masked dissipative sweeps on the ORIGINAL order, on the uniforms
    the generic bath engine draws (counter_rng.generic_uids at sites
    0..N-1), with the best-slice energy after each step."""
    chains, P, n = confs.shape
    hu = cr.hashed_uid(cr.generic_uids(
        chains, torch.arange(n, dtype=torch.int32), n, slices=P))
    sweep = (tpq.dissipative_colored_sweep if colored
             else tpq.dissipative_local_sweep)
    c, es = confs, []
    for t in range(b.shape[0]):
        u = cr.uniform01_hashed(cr.counter(seed, t, 0), hu)
        c = sweep(problem, c, u, teff, jp[t], b[t], bath)
        if gm:
            ul = cr.uniform01_hashed(cr.line_counter(seed, t, 0), hu[:, 0])
            c = tpq.global_line_moves(problem, c, ul, teff, b[t])
        es.append(problem.energy(c).min(dim=-1).values)
    return c, torch.stack(es)


@pytest.mark.parametrize("name,P,colored,gm", [
    ("rg_fields3", 4, False, True), ("rg_fields3", 4, True, True),
    ("rg9", 3, False, False), ("rg9", 3, True, True),
    ("odd_torus", 4, False, True), ("odd_torus", 5, True, True),
    ("odd_open", 3, False, True), ("even_torus", 5, True, False)])
def test_masked_equals_packed(name, P, colored, gm):
    port = PROBLEMS[name]()[0]
    c0 = torch.as_tensor(spins((3, P, port.nspins), 5))
    g = tsched.transverse_field(3.0, 1e-8, 8, device="cpu")
    bsched = torch.full_like(g, 0.9)
    lut = tsched.bath_lookuptable(P, 0.2, device="cpu")
    got, es = gk.anneal_generic_qmc_bath(
        port, g, bsched, 0.3, lut, c0, 91, global_moves=gm, colored=colored,
        collect_energy=True)
    b, jp, teff = tsched.qmc_terms(g, bsched, 0.3, P, 1, torch.device("cpu"))
    want, es_want = masked_bath_anneal(port, b, jp, teff,
                                       tpq.bath_matrix(lut, P), c0, 91, gm,
                                       colored)
    assert torch.equal(got, want)
    assert not torch.equal(got, c0)
    assert (es - es_want).abs().max() <= gc.ENERGY_RTOL * scale_of(port)


# ----------------------------------------------------- distributions


@pytest.mark.parametrize("case", ["ising", "odd_lattice"])
@pytest.mark.parametrize("gm", [False, True])
def test_sequential_sweep_samples_extended_gibbs(case, gm):
    """The generic bath engine's sequential sweep, its plain version on the
    CPU, samples the bath-extended Gibbs weights: tests/test_qmc.py::
    TestDissipativeGibbs's case (N = 2, J = 0.8, P = 2, T = 0.9, Gamma =
    0.6, alpha = 0.05, 16 states) on an IsingProblem, and the bonded pair
    of tests/gibbs_check.py on an open 3 x 3 lattice, the checkerboard
    packing (P = 3, T = 0.45, Gamma = 0.6, alpha = 0.1, 64 line states):
    every state within 5 standard errors of the chain means."""
    if case == "ising":
        prob = IsingProblem.from_edges(2, [0], [1], [0.8], maxnb=1,
                                       device="cpu")
        P, temp, gamma, alpha = 2, 0.9, 0.6, 0.05
        exact = gc.generic_qmc_weights(prob, P, temp,
                                       gc.jperp(gamma, P, temp),
                                       bath=gc.bath_matrix(P, alpha))
        codes, nstates = gc.spin_codes, 2 ** (P * prob.nspins)
    else:
        prob = gc.pair_lattice(3, "cpu")
        P, temp, gamma, alpha = 3, 0.45, 0.6, 0.1
        exact = gc.qmc_weights(P, temp, gc.jperp(gamma, P, temp),
                               bath=gc.bath_matrix(P, alpha))
        codes, nstates = gc.line_codes, 4 ** P
    per_chain = gc.sample_generic_bath(prob, 2048, P, temp, gamma, alpha,
                                       40 + gm, codes, nstates,
                                       global_moves=gm)
    z, d = gc.z_scores(per_chain, exact, gc.SAMPLES)
    assert z < 5.0, (z, d)


@pytest.mark.parametrize("form", ["quarters", "masked"])
def test_colored_sweep_near_extended_gibbs(form):
    """The colored forms against the exact bath-extended Gibbs weights on
    a 2 x 2 lattice at P = 2 (256 states; T = 0.9, Gamma = 0.7, alpha =
    0.05), with the bound of tests/test_split.py:332 and :389, total
    variation < 0.03: kernel 5's colored template on the quarters (the
    lattice of test_split.py's `_lat(2, rng 11)`), and the generic colored
    sweep on the IsingProblem `random_2d_lattice(2, rng=11)`, each through
    qmc.anneal(bath_update="colored"), the plain versions on the CPU."""
    if form == "quarters":
        prob = tinst.random_2d_lattice(2, rng=np.random.default_rng(11),
                                       lattice=True, device="cpu")[0]
        generic = prob.to_generic()
    else:
        prob = tinst.random_2d_lattice(2, rng=11, device="cpu")[0]
        generic = prob
    P, temp, gamma, alpha = 2, 0.9, 0.7, 0.05
    exact = gc.generic_qmc_weights(generic, P, temp, gc.jperp(gamma, P, temp),
                                   bath=gc.bath_matrix(P, alpha))
    chains, burn, samples, every = 4096, 30, 60, 2
    gen = torch.Generator().manual_seed(9)
    confs = sa.random_state(gen, P * 4, batch=(chains,),
                            device="cpu").reshape(chains, P, 4)
    lut = tsched.bath_lookuptable(P, alpha, device="cpu")
    counts = np.zeros(256)
    for i in range(samples + 1):
        n = burn if i == 0 else every
        g = torch.full((n,), gamma)
        confs = qmc.anneal(prob, g, torch.ones_like(g), temp, confs, gen,
                           lookuptable=lut, bath_update="colored")
        if i:
            counts += np.bincount(gc.spin_codes(confs).numpy(),
                                  minlength=256)
    tv = 0.5 * np.abs(counts / counts.sum() - exact).sum()
    assert tv < 0.03, tv


# ---------------------------------------------------- the slice as a whole


def _neighbor_table(L, seed):
    """The reference-format (N, 4, 2) neighbor table of a seeded L x L
    Gaussian torus (tools.pyx::GenerateNeighbors's layout)."""
    r = np.random.default_rng(seed)
    jr, jd = r.normal(size=(L, L)), r.normal(size=(L, L))
    rows, cols, vals = [], [], []
    for i in range(L * L):
        y, x = divmod(i, L)
        rows += [i, i]
        cols += [y * L + (x + 1) % L, ((y + 1) % L) * L + x]
        vals += [jr[y, x], jd[y, x]]
    return build_neighbor_table(L * L, rows, cols, vals, 4)


@pytest.mark.parametrize("bath_update,P", [("sequential", 4),
                                           ("colored", 3)])
def test_dissipative_slice_equals_jax_composition(bath_update, P):
    """examples/dissipative_qa.py's protocol on a 4 x 4 neighbor-table
    problem, as compat.DissipativeQuantumAnneal builds it: the JAX solver's
    pre-annealed states, replicated, through the JAX qmc.anneal with a
    bath and global moves, against the port's plain sweeps composed on the
    JAX scan body's keys (solvers/qmc.py:152-180). Bitwise; the best-slice
    energies within 1e-6 of sum |J|."""
    nbs = _neighbor_table(4, 5)
    jprob, port = JIsing.from_neighbor_table(nbs), \
        IsingProblem.from_neighbor_table(nbs, device="cpu")
    reads, sweeps, pt, alpha = 3, 12, 2.0, 0.05
    k1, k2, k3 = jax.random.split(jax.random.key(P), 3)
    s = jsa.random_state(k1, jprob.nspins, batch=(reads,))
    s = jsa.anneal(jprob, jsched.pre_anneal_schedule(3.0, pt), s, k2,
                   mcsteps=5)
    confs = jqmc.replicate(s, P)
    a = jsched.transverse_field(3.0, 1e-8, sweeps)
    lut = jsched.bath_lookuptable(P, alpha)
    want = np.asarray(jqmc.anneal(jprob, a, jnp.ones_like(a), pt / P, confs,
                                  k3, global_moves=True, lookuptable=lut,
                                  bath_update=bath_update))
    # the JAX scan's T_eff = float32(T) * P and J_perp, on its keys
    teff32 = np.float32(np.float32(pt / P) * np.float32(P))
    jps = torch.as_tensor(np.array(jsched.jperp(a, jnp.float32(teff32))))
    bath = torch.as_tensor(np.array(jpq.bath_matrix(lut, P)))
    sweep = (tpq.dissipative_colored_sweep if bath_update == "colored"
             else tpq.dissipative_local_sweep)
    c = torch.as_tensor(np.array(confs))
    for t, k in enumerate(jax.random.split(k3, sweeps)):
        ka, kb = jax.random.split(k)
        u = torch.as_tensor(np.array(jax.random.uniform(ka, c.shape)))
        c = sweep(port, c, u, float(teff32), jps[t], t32(1.0), bath)
        ul = torch.as_tensor(np.array(jax.random.uniform(
            kb, (reads, port.nspins))))
        c = tpq.global_line_moves(port, c, ul, float(teff32), t32(1.0))
    assert np.array_equal(c.numpy(), want)
    assert not np.array_equal(want, np.asarray(confs))
    np.testing.assert_allclose(
        qmc.best_slice_energy(port, c).numpy(),
        np.asarray(jqmc.best_slice_energy(jprob, jnp.asarray(want))),
        rtol=0, atol=ENERGY_RTOL * scale_of(port))


@pytest.mark.parametrize("name,bath_update", [
    ("nbtable", "sequential"), ("nbtable", "colored"),
    ("odd_torus", "sequential"), ("even_torus", "colored")])
def test_dissipative_qa_takes_every_problem(name, bath_update):
    """solvers/dissipative.py's protocol on the problems this slice adds,
    on the CPU: the states' best-slice energies are those it returns, and
    the CPU runs the plain versions (no kernel launch)."""
    prob = (IsingProblem.from_neighbor_table(_neighbor_table(4, 1),
                                             device="cpu")
            if name == "nbtable" else PROBLEMS[name]()[0])
    _build.reset_launches()
    states, es = dissipative_qa(prob, 2, 6, 4, 0.05, seed=1,
                                bath_update=bath_update)
    assert states.shape == (2, prob.nspins)
    assert set(np.unique(states)) <= {-1.0, 1.0}
    np.testing.assert_allclose(es, prob.energy(torch.as_tensor(states))
                               .numpy(), rtol=0, atol=1e-5)
    assert not any(_build.LAUNCHES.values())


@pytest.mark.parametrize("name,P,bath_update", [
    ("rg_fields3", 3, "sequential"), ("odd_torus", 4, "colored"),
    ("even_torus", 4, "colored")])
def test_new_routes_collect_energy(name, P, bath_update):
    """collect_energy= on the new routes (the generic bath engine, kernel
    5's colored template at even P on even L): the collecting run's states
    are the plain run's, and its last row is the best-slice energy."""
    prob = PROBLEMS[name]()[0]
    c = torch.as_tensor(spins((3, P, prob.nspins), 3))
    g = tsched.transverse_field(3.0, 1e-8, 5, device="cpu")
    lut = tsched.bath_lookuptable(P, 0.1, device="cpu")
    kw = dict(global_moves=True, lookuptable=lut, bath_update=bath_update)
    out, es = qmc.anneal(prob, g, torch.ones_like(g), 0.3, c,
                         torch.Generator().manual_seed(2),
                         collect_energy=True, **kw)
    plain = qmc.anneal(prob, g, torch.ones_like(g), 0.3, c,
                       torch.Generator().manual_seed(2), **kw)
    assert torch.equal(out, plain)
    assert es.shape == (5, 3)
    assert torch.allclose(es[-1], qmc.best_slice_energy(prob, out),
                          rtol=0, atol=gc.ENERGY_RTOL * scale_of(prob))


def test_colored_extended_energy_matches_the_weights():
    """The exact weights the colored check holds against
    (gibbs_check.generic_qmc_weights with a bath) are those of the JAX
    tests' `extended_energy` on the same lattice."""
    P, temp, gamma, alpha = 2, 0.9, 0.7, 0.05
    jlat = jinst.random_2d_lattice(2, rng=np.random.default_rng(11),
                                   lattice=True)[0]
    lat = tinst.random_2d_lattice(2, rng=np.random.default_rng(11),
                                  lattice=True, device="cpu")[0]
    states = gc.all_states(P * 4).reshape(-1, P, 4).astype(np.float32)
    lut = jsched.bath_lookuptable(P, alpha)
    es = np.asarray(extended_energy(jlat, jnp.asarray(states), temp,
                                    jnp.float32(gamma), lookuptable=lut),
                    dtype=np.float64)
    w = np.exp(-(es - es.min()) / (P * temp))
    np.testing.assert_allclose(
        gc.generic_qmc_weights(lat.to_generic(), P, temp,
                               gc.jperp(gamma, P, temp),
                               bath=gc.bath_matrix(P, alpha)),
        w / w.sum(), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("P", [4, 5, 8, 16, 40])
def test_jax_colored_bath_einsum_order(P):
    """The sum order behind ROADMAP.md queue 3's note on the colored bath:
    XLA's CPU dot adds the colored sweeps' (P, P) bath einsum
    (ops/piqmc.py:181) in four lanes, p mod 4 each in index order, joined
    as ((0 + 1) + (2 + 3)), then the P mod 4 last terms one by one; the
    port adds in index order (`piqmc.bath_fields`), as the slice-
    sequential sweep's row einsum (:133) does. Some fields differ in the
    last ulp; no spin of the tests above differs."""
    bath = np.asarray(jpq.bath_matrix(jsched.bath_lookuptable(P, 0.01), P))
    s = spins((3, P, 300), P)
    full = np.asarray(jax.jit(lambda m, x: jnp.einsum(
        "kp,...pn->...kn", m, x))(bath, s))
    terms = bath[None, :, :, None] * s[:, None, :, :]  # (3, k, p, n), exact
    head = P - P % 4
    lanes = []
    for j in range(4):
        acc = terms[:, :, j]
        for p in range(j + 4, head, 4):
            acc = (acc + terms[:, :, p]).astype(np.float32)
        lanes.append(acc)
    four = ((lanes[0] + lanes[1]).astype(np.float32)
            + (lanes[2] + lanes[3]).astype(np.float32)).astype(np.float32)
    for p in range(head, P):
        four = (four + terms[:, :, p]).astype(np.float32)
    assert np.array_equal(full, four)
    index = tpq.bath_fields(torch.as_tensor(bath),
                            torch.as_tensor(s)).numpy()
    assert (index != full).any()
    for k in range(P):
        row = np.asarray(jnp.einsum("p,...pn->...n", bath[k], s))
        assert np.array_equal(row, index[:, k])
