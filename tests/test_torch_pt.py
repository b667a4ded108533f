"""Parallel tempering, quantum PT and ICM of the port
(montecarlosolvers_tpu_torch/solvers/pt.py) against the JAX package's
(montecarlosolvers_tpu/solvers/pt.py), and the per-chain schedules of the
plain versions of the five kernels the samplers sweep on.

Three kinds of check, each with its tolerance:
- bitwise, on JAX's own jax.random draws: `_exchange_perm`,
  `qmc_split_kinetic` (P = 2 to 40) and one PT iteration (a sweep at a
  per-chain temperature, then the exchange) for the split, masked
  (IsingProblem and an odd lattice's checkerboard) and dense forms. The
  problems there have +/-1 couplings, where every energy is an exact
  integer, so the energies of the two packages agree whatever order they
  add in;
- bitwise, port against port: each plain version with a (steps, chains)
  table equals, chain by chain, the same plain version run with that
  chain's column as the shared schedule, and `step0` splits a run;
- in distribution, the port's own counter-hash samplers against exact
  enumeration (the JAX package's exact tests of tests/test_pt.py): many
  independent ladders in one batch, each a sample of its time-averaged
  energy, and every rung's mean within Z = 5 standard errors of the
  ladder means of the exact Gibbs (or extended-Gibbs) mean.

Every problem is built by the JAX package and carried across by
montecarlosolvers_tpu_torch/convert.py from its numpy arrays. The solve
slice at L = 8 holds the port's mean energy per spin to the JAX solve's
with the same arguments within max(0.02, 5 combined standard errors).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from montecarlosolvers_tpu.models import instances as jinst
from montecarlosolvers_tpu.models import lattice as jlattice
from montecarlosolvers_tpu.models.dense import DenseProblem as JDense
from montecarlosolvers_tpu.models.ising import IsingProblem as JIsing
from montecarlosolvers_tpu.ops import dense_sweep as jds
from montecarlosolvers_tpu.ops import metropolis as jmet
from montecarlosolvers_tpu.ops import split as jsplit
from montecarlosolvers_tpu.solvers import api as japi
from montecarlosolvers_tpu.solvers import pt as jpt
from montecarlosolvers_tpu_torch import convert, schedules
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import dense_kernels as dk
from montecarlosolvers_tpu_torch.ops import dense_sweep as ds
from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
from montecarlosolvers_tpu_torch.ops import packed as tpk
from montecarlosolvers_tpu_torch.ops import split as tsplit
from montecarlosolvers_tpu_torch.ops import split_kernels as sk
from montecarlosolvers_tpu_torch.solvers import api
from montecarlosolvers_tpu_torch.solvers import pa, pt
from tests.test_qmc import extended_energy

torch.set_num_threads(1)

Z = 5.0  # standard errors of the ladder means a rung's mean may stray


def _t(x):
    return torch.as_tensor(np.array(x))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _lattice(jlat):
    return convert.lattice_from_arrays(jlat.j_right, jlat.j_down,
                                       jlat.h_plane, jlat.col_wrap,
                                       device="cpu")


def _ising(jprob):
    return convert.ising_from_arrays(
        *(np.asarray(getattr(jprob, a))
          for a in ("nbr_idx", "nbr_J", "h", "color_masks")), device="cpu")


def _dense(jprob):
    return convert.dense_from_arrays(np.asarray(jprob.J),
                                     np.asarray(jprob.h), device="cpu")


def _states(seed, shape):
    r = np.random.default_rng(seed)
    return r.choice([-1.0, 1.0], size=shape).astype(np.float32)


def _enumerate(n):
    return (((np.arange(2 ** n)[:, None] >> np.arange(n)) & 1) * 2 - 1
            ).astype(np.float32)


def _exact_mean_energy(jprob, temp):
    es = np.asarray(jprob.energy(jnp.asarray(_enumerate(jprob.nspins))),
                    dtype=np.float64)
    w = np.exp(-(es - es.min()) / temp)
    return float((w * es).sum() / w.sum())


def _three_spins():
    rows = np.array([0, 1, 0, 0, 2])
    cols = np.array([1, 2, 2, 0, 2])
    vals = np.array([1.0, -0.8, 0.6, 0.4, -0.3])
    return JIsing.from_edges(3, rows, cols, vals, maxnb=4)


def _ladder_means(x):
    """x (T, B, ...): the time average of each of the B ladders, and the
    mean over ladders with its standard error."""
    per = x.mean(axis=0)
    return per.mean(axis=0), per.std(axis=0, ddof=1) / np.sqrt(per.shape[0])


# ------------------------------------------------------ bitwise, on JAX draws


@pytest.mark.parametrize("parity", (0, 1))
@pytest.mark.parametrize("temp", (1.0, 2.6))
def test_exchange_perm_matches_jax(parity, temp):
    M = 9
    r = np.random.default_rng(parity)
    de = (r.normal(size=M) * 3.0).astype(np.float32)
    key = jax.random.key(7 + parity)
    perm, acc = jpt._exchange_perm(key, parity, jnp.asarray(de), temp)
    u = jax.random.uniform(key, (M,))
    got_perm, got_acc = pt._exchange_perm(_t(u), parity, _t(de), temp)
    assert np.array_equal(got_perm.numpy(), np.asarray(perm))
    assert np.array_equal(got_acc.numpy(), np.asarray(acc))
    assert got_acc.any() and not got_acc.all()


@pytest.mark.parametrize("P", (2, 4, 10, 40))
def test_qmc_split_kinetic_matches_jax(P):
    jlat = jinst.random_2d_lattice(4, rng=P, lattice=True)[0]
    lat = _lattice(jlat)
    confs = _states(P, (3, P, 16))
    want = jsplit.qmc_split_kinetic(
        jsplit.build_split(jlat),
        *jsplit.pack_qmc(jsplit.build_split(jlat), jnp.asarray(confs)))
    sl = tsplit.build_split(lat)
    got = tsplit.qmc_split_kinetic(sl, *tsplit.pack_qmc(sl, _t(confs)))
    assert np.array_equal(got.numpy(), np.asarray(want))
    generic = (confs * np.roll(confs, -1, axis=-2)).sum(axis=(-1, -2))
    assert np.array_equal(got.numpy(), generic)


def _pm1_torus(L, seed):
    r = np.random.default_rng(seed)
    return jlattice.LatticeProblem.from_planes(
        r.choice([-1.0, 1.0], size=(L, L)), r.choice([-1.0, 1.0],
                                                     size=(L, L)))


def _pm1_dense(n, seed):
    r = np.random.default_rng(seed)
    return JDense.from_couplings(np.triu(r.choice([-1.0, 1.0],
                                                  size=(n, n)), 1))


@pytest.mark.parametrize("form", ("split", "masked_ising",
                                  "masked_odd_lattice", "dense"))
def test_one_pt_iteration_matches_jax(form):
    """pt.sample's loop body (pt.py:135-168): a sweep at temps[labels], the
    energies in rung order, the exchange; labels start permuted."""
    M = 6
    temps = jnp.geomspace(0.4, 3.0, M).astype(jnp.float32)
    ror = np.array([2, 0, 5, 1, 4, 3])
    labels = np.argsort(ror)
    t_rep = temps[labels]
    key = jax.random.key(11)
    k1, k2, _ = jax.random.split(key, 3)
    if form == "split":
        jp = jinst.random_2d_lattice(6, rng=3, dist="pm1", lattice=True)[0]
        port = _lattice(jp)
    elif form == "masked_ising":
        jp = jinst.random_3d_lattice(3, rng=4)[0]
        port = _ising(jp)
    elif form == "masked_odd_lattice":
        jp = _pm1_torus(5, 5)
        port = _lattice(jp)
    else:
        jp = _pm1_dense(12, 6)
        port = _dense(jp)
    n = jp.nspins
    s = _states(12, (M, n))
    temp_col = _t(t_rep)[:, None]
    if form == "split":
        jsl = jsplit.build_split(jp)
        a, b = jsplit.sa_split_sweep(jsl, *jsplit.pack_classical(
            jsl, jnp.asarray(s)), k1, t_rep[:, None])
        want_s = jsplit.unpack_classical(jsl, a, b)
        ka, kb = jax.random.split(k1)
        sl = tsplit.build_split(port)
        ta, tb = tsplit.pack_classical(sl, _t(s))
        ga, gb = tsplit.sa_split_sweep(
            sl, ta, tb, _t(jax.random.uniform(ka, ta.shape)),
            _t(jax.random.uniform(kb, tb.shape)), temp_col)
        got_s = tsplit.unpack_classical(sl, ga, gb)
        e = tsplit.classical_energy_split(sl, ga, gb)
    elif form == "dense":
        want_s = jds.dense_metropolis_sweep(jp, jnp.asarray(s), k1, t_rep)
        np_ = ds.padded_size(n, ds.block_size(128, n))
        u = jax.random.uniform(k1, (M, np_))
        got_s = ds.dense_metropolis_sweep(port, _t(s), _t(u), _t(t_rep))
        e = port.energy(got_s)
    else:
        want_s = jmet.colored_metropolis_sweep(jp, jnp.asarray(s), k1,
                                               t_rep[:, None])
        u = _t(jax.random.uniform(k1, s.shape))
        pg = (tpk.packed_from_lattice(port) if form == "masked_odd_lattice"
              else tpk.build_packed(port))
        assert pg.proper == (form == "masked_ising")
        got_s = tpk.unpack_state(pg, tpk.packed_sweep(
            pg, tpk.pack_state(pg, _t(s)), tpk.pack_state(pg, u), temp_col))
        e = tpk.packed_energy(pg, tpk.pack_state(pg, got_s))
    assert np.array_equal(got_s.numpy(), np.asarray(want_s))
    # the exchange, as pt.py:149-155 computes it
    je = jp.energy(want_s)[ror]
    beta = 1.0 / temps
    nxt = np.clip(np.arange(M) + 1, 0, M - 1)
    delta = (beta - beta[nxt]) * (je - je[nxt])
    want_perm, want_acc = jpt._exchange_perm(k2, 1, -delta, 1.0)
    ge = e[torch.as_tensor(ror)]
    tbeta = 1.0 / _t(temps)
    gdelta = (tbeta - tbeta[nxt]) * (ge - ge[nxt])
    assert np.array_equal(ge.numpy(), np.asarray(je))
    perm, acc = pt._exchange_perm(_t(jax.random.uniform(k2, (M,))), 1,
                                  -gdelta, 1.0)
    assert np.array_equal(perm.numpy(), np.asarray(want_perm))
    assert np.array_equal(acc.numpy(), np.asarray(want_acc))


# --------------------------------------- per-chain tables, the step offset


def _ref_runs():
    """kernel -> (state, run(table, state, step0)) of each plain version
    on a small problem, 5 chains."""
    jlat = jinst.random_2d_lattice(4, rng=1, lattice=True)[0]
    lat = _lattice(jlat)
    sl = tsplit.build_split(lat)
    pg = tpk.build_packed(_ising(jinst.random_3d_lattice(3, rng=2,
                                                         dist="gauss")[0]))
    dp = _dense(JDense.from_couplings(np.triu(np.random.default_rng(3)
                                              .normal(size=(20, 20)), 1)))
    halves = tuple(tsplit.pack_classical(sl, _t(_states(1, (5, 16)))))
    quarters = tsplit.pack_qmc(sl, _t(_states(2, (5, 4, 16))))
    packed = _t(_states(3, (5, pg.nspins)))
    confs = _t(_states(4, (5, 3, pg.nspins)))
    dense = _t(_states(5, (5, 20)))

    def ones(tab):
        return torch.ones(tab.shape[0])
    return {
        "split_sa": (halves, lambda tab, st, t0: sk.sa_split_anneal_ref(
            sl, tab, *st, 5, step0=t0)),
        "split_qmc": (quarters, lambda tab, st, t0: sk.qmc_split_anneal_ref(
            sl, ones(tab), tab, 2.0, st, 6, True, step0=t0)),
        "packed_sa": (packed, lambda tab, st, t0: gk.packed_sa_anneal_ref(
            pg, tab, st, 7, step0=t0)),
        "generic_qmc": (confs, lambda tab, st, t0:
                        gk.generic_qmc_anneal_ref(pg, ones(tab), tab, 1.5,
                                                  st, 8, True, step0=t0)),
        "dense_sa": (dense, lambda tab, st, t0: dk.dense_sa_anneal_ref(
            dp, tab, st, 9, block=8, step0=t0)),
    }


KERNELS = ("split_sa", "split_qmc", "packed_sa", "generic_qmc", "dense_sa")


def _parts(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("kernel", KERNELS)
def test_per_chain_table_equals_each_chains_shared_run(kernel):
    start, run = _ref_runs()[kernel]
    steps = 4
    table = torch.linspace(0.4, 2.5, 5)[None, :] * torch.linspace(
        1.0, 0.6, steps)[:, None]
    out = _parts(run(table, start, 0))
    for c in range(5):
        alone = _parts(run(table[:, c].contiguous(), start, 0))
        assert all(torch.equal(x[c], y[c]) for x, y in zip(out, alone)), c


@pytest.mark.parametrize("kernel", KERNELS)
def test_step0_splits_a_run(kernel):
    start, run = _ref_runs()[kernel]
    table = torch.linspace(0.4, 2.5, 5)[None, :].expand(4, -1)
    whole = _parts(run(table, start, 0))
    half = run(table[:2], start, 0)
    split = _parts(run(table[2:], half, 2))
    again = _parts(run(table[2:], half, 0))
    assert all(torch.equal(x, y) for x, y in zip(whole, split))
    assert not all(torch.equal(x, y) for x, y in zip(whole, again))


def test_schedule_strides():
    dev = torch.device("cpu")
    assert _build.schedule_strides(torch.ones(4), "s", 4, 3, dev) == (1, 0)
    row = torch.ones(3)[None, :].expand(4, -1)
    assert _build.schedule_strides(row, "s", 4, 3, dev) == (0, 1)
    assert _build.schedule_strides(torch.ones(4, 3), "s", 4, 3, dev) == (3, 1)
    for bad in (torch.ones(4, 3).t(), torch.ones(4, 2),
                torch.ones(4, 3, dtype=torch.float64)):
        with pytest.raises(ValueError):
            _build.schedule_strides(bad, "s", 4, 3, dev)


# ------------------------------------------ in distribution: exact Gibbs


def test_marginals_match_gibbs():
    jp = _three_spins()
    prob = _ising(jp)
    temps = [0.7, 1.4, 3.0]
    B, sweeps, burn = 64, 500, 100
    out, rate, es = pt.sample(prob, temps, _t(_states(0, (B, 3, 3))),
                              _gen(0), sweeps, swap_every=2,
                              collect_energy=True)
    assert out.shape == (B, 3, 3) and es.shape == (sweeps, B, 3)
    assert float(rate.mean()) > 0.05, "no replica exchange happening"
    mean, se = _ladder_means(es[burn:].numpy().astype(np.float64))
    for k, t in enumerate(temps):
        exact = _exact_mean_energy(jp, t)
        assert abs(mean[k] - exact) < Z * se[k], (k, t, mean[k], exact)


def test_split_engine_marginals_match_gibbs():
    jp = jinst.random_2d_lattice(4, rng=5, lattice=True)[0]
    prob = _lattice(jp)
    assert tsplit.supports_split(prob)
    temps = [0.8, 1.6, 3.2]
    B, sweeps, burn = 32, 400, 100
    out, rate, es = pt.sample(prob, temps, _t(_states(1, (B, 3, 16))),
                              _gen(1), sweeps, swap_every=2,
                              collect_energy=True)
    assert set(np.unique(out.numpy())) <= {-1.0, 1.0}
    assert float(rate.mean()) > 0.05
    mean, se = _ladder_means(es[burn:].numpy().astype(np.float64))
    for k, t in enumerate(temps):
        exact = _exact_mean_energy(jp.to_generic(), t)
        assert abs(mean[k] - exact) < Z * se[k], (k, t, mean[k], exact)


def test_gamma_ladder_marginals_match_extended_gibbs():
    jp = JIsing.from_edges(2, [0], [1], [0.9], maxnb=1)
    prob = _ising(jp)
    slices, temp = 2, 0.8
    teff = temp * slices
    gammas = [0.4, 0.9, 1.8]
    states = jnp.asarray(_enumerate(4).reshape(-1, 2, 2))
    exact = []
    for g in gammas:
        es = np.asarray(extended_energy(jp, states, temp, g), np.float64)
        w = np.exp(-(es - es.min()) / teff)
        exact.append(float((w * es).sum() / w.sum()))
    B, chunks, chunk = 128, 24, 8
    confs = _t(_states(2, (B, 3, slices, 2)))
    gen = _gen(2)
    samples = []
    for c in range(chunks):
        confs, rate = pt.sample_piqmc(prob, gammas, temp, confs, gen, chunk,
                                      swap_every=2)
        if c >= 4:
            samples.append(np.stack([np.asarray(extended_energy(
                jp, jnp.asarray(confs[:, m].numpy()), temp, g))
                for m, g in enumerate(gammas)], axis=-1))
    assert float(rate.mean()) > 0.05, "no gamma exchange happening"
    mean, se = _ladder_means(np.asarray(samples, dtype=np.float64))
    for m in range(3):
        assert abs(mean[m] - exact[m]) < Z * se[m], (m, mean[m], exact[m])


def test_icm_marginals_match_gibbs():
    jp = _three_spins()
    prob = _ising(jp)
    temps = [0.7, 1.4, 3.0]
    B, sweeps, burn = 32, 500, 100
    out, rate, hfrac, es = pt.sample_icm(
        prob, temps, _t(_states(3, (B, 2, 3, 3))), _gen(3), sweeps,
        swap_every=2, houdayer_every=2, collect_energy=True)
    assert es.shape == (sweeps, B, 2, 3)
    assert float(rate.mean()) > 0.05
    assert 0.0 < float(hfrac.mean()) < 1.0, "no Houdayer flips happening"
    mean, se = _ladder_means(es[burn:].numpy().astype(np.float64))
    for ladder in range(2):
        for k, t in enumerate(temps):
            exact = _exact_mean_energy(jp, t)
            assert abs(mean[ladder, k] - exact) < Z * se[ladder, k], (
                ladder, k, t, mean[ladder, k], exact)


def test_icm_odd_torus_sweeps_the_generic_form():
    """On a 3x3 torus ICM sweeps the IsingProblem's proper coloring (JAX
    pt.py:393-399), not the checkerboard pt.sample sweeps on an odd L: the
    run equals, bitwise, the same run on to_generic(), and every rung's
    mean energy lies within Z standard errors of the exact Gibbs mean."""
    jp = _pm1_torus(3, 8)
    prob = _lattice(jp)
    assert prob.col_wrap and not tsplit.supports_split(prob)
    temps = [0.8, 1.6, 3.2]
    B, sweeps, burn = 32, 400, 100
    s = _t(_states(6, (B, 2, 3, 9)))
    out = pt.sample_icm(prob, temps, s, _gen(6), sweeps, swap_every=2,
                        collect_energy=True)
    ref = pt.sample_icm(prob.to_generic(), temps, s, _gen(6), sweeps,
                        swap_every=2, collect_energy=True)
    for got, want in zip(out, ref):
        assert torch.equal(got, want)
    assert 0.0 < float(out[2].mean()) < 1.0, "no Houdayer flips happening"
    mean, se = _ladder_means(out[3][burn:].numpy().astype(np.float64))
    for ladder in range(2):
        for k, t in enumerate(temps):
            exact = _exact_mean_energy(jp, t)
            assert abs(mean[ladder, k] - exact) < Z * se[ladder, k], (
                ladder, k, t, mean[ladder, k], exact)


def _flat(out):
    if isinstance(out, dict):
        return [v for k in sorted(out) for v in _flat(out[k])]
    if isinstance(out, (tuple, list)):
        return [v for x in out for v in _flat(x)]
    return [torch.as_tensor(out)]


@pytest.mark.parametrize("sampler", ("pt", "icm", "pa"))
def test_chain_bit_engine_equals_the_float_engine(sampler, monkeypatch):
    """On the card the split engine keeps kernel A's chain-bit words from
    launch to launch (`split_kernels.words_geometry`). Its bookkeeping
    (sweeps and energies on the words, the unpacking and repacking around
    a Houdayer move, PA's gathers) runs here on the words' plain route at
    C = 7 chains a word, so every last word is ragged; each sampler equals,
    bitwise, its run on float halves."""
    jp = jinst.random_2d_lattice(4, rng=9, lattice=True)[0]
    prob = _lattice(jp)
    temps = schedules.geometric(0.4, 2.5, 5, device="cpu")
    runs = {
        "pt": lambda: pt.sample(prob, temps, _t(_states(7, (2, 5, 16))),
                                _gen(7), 20, swap_every=2,
                                collect_energy=True, per_pair_rates=True),
        "icm": lambda: pt.sample_icm(prob, temps,
                                     _t(_states(8, (2, 2, 5, 16))), _gen(8),
                                     20, collect_energy=True),
        "pa": lambda: pa.sample(prob, pa.beta_linear(2.0, 12, device="cpu"),
                                _t(_states(9, (30, 16))), _gen(9),
                                beta0=0.0, collect_stats=True),
    }
    floats = _flat(runs[sampler]())
    monkeypatch.setattr(sk, "words_geometry",
                        lambda sl, chains, device: (7, 1, 32))
    words = _flat(runs[sampler]())
    assert len(words) == len(floats)
    for got, want in zip(words, floats):
        assert torch.equal(got, want)


def test_icm_without_moves_is_the_pt_baseline():
    """houdayer_every=0 takes PT's code path: the pairs of ladders run as
    plain PT, bitwise the same run as pt.sample on the ladders."""
    jp = jinst.random_2d_lattice(4, rng=6, lattice=True)[0]
    prob = _lattice(jp)
    temps = schedules.geometric(0.3, 2.0, 5, device="cpu")
    s = _t(_states(4, (3, 2, 5, 16)))
    out, rate, hfrac = pt.sample_icm(prob, temps, s, _gen(4), 30,
                                     swap_every=2, houdayer_every=0)
    ref, ref_rate = pt.sample(prob, temps, s.reshape(6, 5, 16), _gen(4), 30,
                              swap_every=2)
    assert torch.equal(out.reshape(6, 5, 16), ref)
    assert torch.equal(rate, ref_rate.reshape(3, 2).mean(-1))
    assert float(hfrac.abs().sum()) == 0.0


def test_icm_split_engine_finds_ground_state():
    jp = jinst.random_2d_lattice(4, rng=7, lattice=True)[0]
    prob = _lattice(jp)
    es = np.asarray(jp.to_generic().energy(jnp.asarray(_enumerate(16))))
    temps = schedules.geometric(0.1, 3.0, 8, device="cpu")
    out, rate, hfrac = pt.sample_icm(prob, temps, _t(_states(5, (2, 8, 16))),
                                     _gen(5), 400, houdayer_every=4)
    assert out.shape == (2, 8, 16)
    assert float(prob.energy(out).min()) == pytest.approx(float(es.min()),
                                                          abs=1e-4)


def test_dense_problems_are_refused_where_jax_refuses():
    dp = _dense(_pm1_dense(8, 1))
    with pytest.raises(ValueError, match="sparse/lattice"):
        pt.sample_icm(dp, [1.0, 2.0], torch.ones(2, 2, 8), _gen(0), 2)
    with pytest.raises(NotImplementedError, match="DenseProblem"):
        pt.sample_piqmc(dp, [1.0, 2.0], 0.5, torch.ones(2, 2, 8), _gen(0), 2)
    # PT itself runs there, on the dense kernel's per-chain form
    out, rate = pt.sample(dp, [0.5, 1.0, 2.0], torch.ones(3, 8), _gen(0), 4)
    assert out.shape == (3, 8)


def test_tune_ladder_equalizes_pair_rates():
    prob = _ising(jinst.random_2d_lattice(4, rng=8)[0])
    temps0 = schedules.geometric(0.15, 3.0, 10, device="cpu")
    _, _, pr0 = pt.sample(prob, temps0, _t(_states(6, (10, 16))), _gen(6),
                          400, per_pair_rates=True)
    temps, pr = pt.tune_ladder(prob, temps0, _gen(7), rounds=4,
                               sweeps_per_round=400)
    pr0 = pr0.numpy()
    assert float(temps[0]) == pytest.approx(float(temps0[0]), rel=1e-5)
    assert float(temps[-1]) == pytest.approx(float(temps0[-1]), rel=1e-5)
    assert bool((torch.diff(temps) > 0).all())
    assert pr.std() < pr0.std(), (pr0, pr)
    assert pr.min() > pr0.min() - 0.02


def test_tune_ladder_piqmc_equalizes_pair_rates():
    prob = _ising(jinst.random_2d_lattice(3, rng=9)[0])
    g0 = schedules.geometric(0.2, 4.0, 8, device="cpu")
    confs0 = _t(_states(8, (8, 4, 9)))
    _, _, pr0 = pt.sample_piqmc(prob, g0, 0.5, confs0, _gen(8), 400,
                                per_pair_rates=True)
    gammas, pr = pt.tune_ladder_piqmc(prob, g0, 0.5, _gen(9), rounds=4,
                                      sweeps_per_round=400, slices=4)
    assert float(gammas[0]) == pytest.approx(float(g0[0]), rel=1e-5)
    assert float(gammas[-1]) == pytest.approx(float(g0[-1]), rel=1e-5)
    assert bool((torch.diff(gammas) > 0).all())
    assert pr.std() <= pr0.numpy().std() + 0.02, (pr0, pr)


# ------------------------------------------------------------------ slice


def _torus8():
    r = np.random.default_rng(0)
    jlat = jlattice.LatticeProblem.from_planes(r.normal(size=(8, 8)),
                                               r.normal(size=(8, 8)))
    return jlat, _lattice(jlat)


def _agree(port, jax_set, n):
    a = port.energies / n
    b = np.asarray(jax_set.energies) / n
    se = np.sqrt(a.var(ddof=1) / a.size + b.var(ddof=1) / b.size)
    assert abs(a.mean() - b.mean()) < max(0.02, 5 * se), (a.mean(),
                                                           b.mean(), se)


@pytest.mark.parametrize("method,kw", (("pt", {}),
                                       ("icm", {"houdayer_every": 2})))
def test_solve_matches_jax_solve(method, kw):
    jlat, lat = _torus8()
    got = api.solve(lat, method, num_reads=8, sweeps=150, seed=0, **kw)
    want = japi.solve(jlat, method, num_reads=8, sweeps=150, seed=0, **kw)
    assert got.samples.shape == (8, 64)
    assert got.info["ladder"] == want.info["ladder"]
    assert 0.05 < got.info["mean_swap_rate"] < 1.0
    if method == "icm":
        assert 0.0 < got.info["houdayer_flip_frac"] < 1.0
    _agree(got, want, 64)
