"""Population annealing of the port (montecarlosolvers_tpu_torch/solvers/
pa.py) against the JAX package's (montecarlosolvers_tpu/solvers/pa.py)
and against exact enumeration.

- Bitwise on JAX's own draws: `beta_linear`, `_systematic_indices` (on
  weights whose cumulative sums are exact, and on Gaussian log-weights,
  where torch's and XLA's cumsum may differ in the last ulp; none of the
  comb points of these draws lies that close to a boundary), `combine_runs`
  (the same float64 numpy) and `merge_populations` (its run draw and
  replica draw as the JAX function takes them). `_ess_of` agrees to rtol
  2e-6: torch's and XLA's exp and log differ in the last ulp; so
  `_solve_dbeta`'s 40 bisections, whose last halvings bracket dbeta finer
  than the float32 ESS resolves, agree to 1e-5 of the range.
- The port's own counter-hash samplers against exact enumeration of ln Z
  and of the mean energy, with the JAX tests' bounds (tests/test_pa.py):
  TestFreeEnergy, TestEnsemble, TestAdaptive, TestCombine, TestQuantumPA.
- The three ADVICE.md defects of the JAX sampler, which the port fixes,
  each pinned.
- solve("pa" | "paq") at L = 8: the mean energy per spin within max(0.02,
  5 combined standard errors) of the JAX solve with the same arguments.

Every problem is built by the JAX package and carried across by
montecarlosolvers_tpu_torch/convert.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from montecarlosolvers_tpu import schedules as jsched
from montecarlosolvers_tpu.models import instances as jinst
from montecarlosolvers_tpu.models import lattice as jlattice
from montecarlosolvers_tpu.models.ising import IsingProblem as JIsing
from montecarlosolvers_tpu.solvers import api as japi
from montecarlosolvers_tpu.solvers import pa as jpa
from montecarlosolvers_tpu_torch import convert
from montecarlosolvers_tpu_torch.solvers import api, pa, qmc, sa

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _ising(jprob):
    return convert.ising_from_arrays(
        *(np.asarray(getattr(jprob, a))
          for a in ("nbr_idx", "nbr_J", "h", "color_masks")), device="cpu")


def _random(n, r, seed):
    return sa.random_state(_gen(seed), n, batch=(r,), device="cpu")


def _small():
    rows = np.array([0, 1, 2, 3, 0, 1, 0, 4, 5])
    cols = np.array([1, 2, 3, 0, 2, 3, 3, 5, 0])
    vals = np.array([1.0, -0.8, 0.6, 0.4, -0.3, 0.9, -0.5, 0.7, -0.6])
    jp = JIsing.from_edges(6, rows, cols, vals, maxnb=6)
    return jp, _ising(jp)


def _enumerate(n):
    return (((np.arange(2 ** n)[:, None] >> np.arange(n)) & 1) * 2 - 1
            ).astype(np.float32)


def _energies(jprob):
    return np.asarray(jprob.energy(jnp.asarray(_enumerate(jprob.nspins))),
                      dtype=np.float64)


def _exact_log_z(jprob, beta):
    x = -beta * _energies(jprob)
    return float(x.max() + np.log(np.exp(x - x.max()).sum()))


def _exact_mean_energy(jprob, temp):
    es = _energies(jprob)
    w = np.exp(-(es - es.min()) / temp)
    return float((w * es).sum() / w.sum())


# ------------------------------------------------------ bitwise, on JAX draws


def test_beta_linear_matches_jax():
    for args in ((1.5, 60, 0.0), (1.2, 50, 0.4)):
        got = pa.beta_linear(*args, device="cpu")
        assert np.array_equal(got.numpy(), np.asarray(jpa.beta_linear(*args)))
    assert pa.uniform_log_z(6) == jpa.uniform_log_z(6)


@pytest.mark.parametrize("weights", ("dyadic", "gaussian"))
def test_systematic_indices_match_jax(weights):
    r = np.random.default_rng(1)
    R = 64
    for seed in range(5):
        if weights == "dyadic":
            k = r.multinomial(4096 - R, np.ones(R) / R) + 1
            w = (k / 4096.0).astype(np.float32)  # partial sums exact
        else:
            lw = r.normal(size=R) * 2.0
            w = np.exp(lw - lw.max())
            w = (w / w.sum()).astype(np.float32)
        key = jax.random.key(seed)
        want = jpa._systematic_indices(key, jnp.asarray(w))
        u = jax.random.uniform(key, (), dtype=jnp.float32)
        got = pa._systematic_indices(_t(u), _t(w))
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_systematic_equal_weights_is_identity_and_counts_match():
    w = torch.full((16,), 1.0 / 16)
    for u in (0.01, 0.3, 0.999):
        idx = pa._systematic_indices(torch.tensor(u), w)
        assert torch.equal(idx, torch.arange(16))
    w = torch.tensor([0.5, 0.25, 0.125, 0.125])
    counts = np.zeros(4)
    for u in np.linspace(0.0, 1.0, 200, endpoint=False):
        i = pa._systematic_indices(torch.tensor(u, dtype=torch.float32), w)
        counts += np.bincount(i.numpy(), minlength=4)
    np.testing.assert_allclose(counts / counts.sum(), w.numpy(), atol=0.02)


def test_ess_of_and_solve_dbeta_match_jax():
    r = np.random.default_rng(2)
    for seed in range(8):
        logw = (r.normal(size=256) * 0.3).astype(np.float32)
        e = (r.normal(size=256) * 4.0).astype(np.float32)
        want = float(jpa._ess_of(jnp.asarray(logw)))
        got = float(pa._ess_of(_t(logw)))
        assert got == pytest.approx(want, rel=2e-6)
        target = np.float32(0.9 * 256)
        remaining = np.float32(0.8)
        want = jpa._solve_dbeta(jnp.asarray(logw), jnp.asarray(e),
                                jnp.float32(remaining), jnp.float32(target))
        got = pa._solve_dbeta(_t(logw), _t(e), torch.tensor(remaining),
                              torch.tensor(target))
        # the last halvings bracket dbeta finer than the float32 ESS can
        # resolve, so there the two frameworks' last-ulp ESS differences
        # decide the steps: the results agree to 1e-5 of the range
        assert abs(float(got) - float(want)) <= 1e-5 * remaining, seed
        assert float(pa._ess_of(_t(logw) - got * _t(e))) >= target
    # the whole range when it keeps the ESS
    got = pa._solve_dbeta(torch.zeros(8), torch.zeros(8), torch.tensor(0.5),
                          torch.tensor(7.0))
    assert float(got) == 0.5


def test_combine_runs_matches_jax():
    for lzs, obs in (([1.0, 2.0, 0.5], None), ([0.0, 20.0], [1.0, 3.0]),
                     ([3.0, 3.5, 2.0, 3.1], [[1.0, 2.0], [0.0, 1.0],
                                             [2.0, 2.0], [1.0, 0.0]])):
        want = jpa.combine_runs(lzs, obs)
        got = pa.combine_runs(torch.tensor(lzs, dtype=torch.float64), obs)
        assert got["log_z"] == want["log_z"]
        assert got["run_ess"] == want["run_ess"]
        assert np.array_equal(got["weights"], want["weights"])
        if obs is not None:
            assert got["observable"] == want["observable"]


def test_merge_populations_matches_jax():
    r = np.random.default_rng(3)
    K, R, n, r_out = 3, 32, 5, 48
    states = [r.choice([-1.0, 1.0], size=(R, n)).astype(np.float32)
              for _ in range(K)]
    lzs = [0.3, 1.1, 0.8]
    key = jax.random.key(4)
    want, want_run = jpa.merge_populations([jnp.asarray(s) for s in states],
                                           lzs, key, r_out)
    k_run, k_rep = jax.random.split(key)
    u_run = jax.random.uniform(k_run, (r_out,), dtype=jnp.float32)
    rep_of = jax.random.randint(k_rep, (r_out,), 0, R)
    got, run_of = pa.merge_populations([_t(s) for s in states], lzs, None,
                                       r_out, draws=(u_run, rep_of))
    assert np.array_equal(run_of.numpy(), np.asarray(want_run))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.unique(run_of.numpy()).size > 1
    # the counter hash's own draws
    got, run_of = pa.merge_populations([_t(s) for s in states], lzs, _gen(0))
    assert got.shape == (R, n) and run_of.dtype == torch.int32


# ------------------------------------------------- free energy, exact ln Z


class TestFreeEnergy:
    def test_log_z_matches_exact_enumeration(self):
        jp, prob = _small()
        temps = pa.beta_linear(1.5, 60, device="cpu")
        out, log_z = pa.sample(prob, temps, _random(6, 4096, 0), _gen(1),
                               mcsteps=2, beta0=0.0)
        est = float(log_z) + pa.uniform_log_z(6)
        assert abs(est - _exact_log_z(jp, 1.5)) < 0.05

    def test_log_z_relative_default_beta0(self):
        jp, prob = _small()
        b0, b1 = 0.4, 1.2
        temps = pa.beta_linear(b1, 50, beta_start=b0, device="cpu")
        states = sa.anneal(prob, torch.full((300,), 1.0 / b0),
                           _random(6, 4096, 2), _gen(3))
        out, log_z = pa.sample(prob, temps, states, _gen(4), mcsteps=2)
        exact = _exact_log_z(jp, b1) - _exact_log_z(jp, b0)
        assert abs(float(log_z) - exact) < 0.05

    def test_ess_threshold_accumulation_still_unbiased(self):
        jp, prob = _small()
        temps = pa.beta_linear(2.0, 16, device="cpu")
        out, log_z, stats = pa.sample(prob, temps, _random(6, 4096, 5),
                                      _gen(6), mcsteps=2, beta0=0.0,
                                      ess_threshold=0.7, collect_stats=True)
        rs = stats["resampled"].numpy()
        assert 0 < rs.sum() < rs.size
        est = float(log_z) + pa.uniform_log_z(6)
        assert abs(est - _exact_log_z(jp, 2.0)) < 0.15


class TestEnsemble:
    def test_population_tracks_gibbs_mean_energy(self):
        jp, prob = _small()
        r = 4096
        out, log_z, stats = pa.sample(
            prob, pa.beta_linear(1.25, 60, device="cpu"), _random(6, r, 7),
            _gen(8), mcsteps=2, beta0=0.0, collect_stats=True)
        es = prob.energy(out).numpy().astype(np.float64)
        exact = _exact_mean_energy(jp, 1.0 / 1.25)
        tol = max(4.0 * 4.0 * es.std() / np.sqrt(r), 0.03)
        assert abs(es.mean() - exact) < tol
        assert float(stats["ess"].min()) > 0.2 * r

    def test_split_engine_lattice_ground_state_occupancy(self):
        jlat = jinst.random_2d_lattice(4, rng=9, lattice=True)[0]
        lat = convert.lattice_from_arrays(jlat.j_right, jlat.j_down,
                                          jlat.h_plane, jlat.col_wrap,
                                          device="cpu")
        out, _ = pa.sample(lat, pa.beta_linear(4.0, 120, device="cpu"),
                           _random(16, 512, 10), _gen(11), mcsteps=2,
                           beta0=0.0)
        es = lat.energy(out).numpy()
        all_es = _energies(jlat.to_generic())
        e_gs = all_es.min()
        assert np.isclose(es.min(), e_gs, atol=1e-3)
        w = np.exp(-4.0 * (all_es - e_gs))
        p_exact = w[np.isclose(all_es, e_gs, atol=1e-3)].sum() / w.sum()
        p_emp = np.isclose(es, e_gs, atol=1e-3).mean()
        tol = max(8.0 * np.sqrt(p_exact * (1 - p_exact) / es.size), 0.05)
        assert abs(p_emp - p_exact) < tol

    def test_deterministic_given_seed(self):
        _, prob = _small()
        temps = pa.beta_linear(1.0, 20, device="cpu")
        s = _random(6, 64, 12)
        a1, z1 = pa.sample(prob, temps, s, _gen(13), beta0=0.0)
        a2, z2 = pa.sample(prob, temps, s, _gen(13), beta0=0.0)
        assert torch.equal(a1, a2) and float(z1) == float(z2)

    def test_multinomial_resampling(self):
        jp, prob = _small()
        out, log_z = pa.sample(prob, pa.beta_linear(1.0, 40, device="cpu"),
                               _random(6, 2048, 14), _gen(15), beta0=0.0,
                               resample="multinomial")
        est = float(log_z) + pa.uniform_log_z(6)
        assert abs(est - _exact_log_z(jp, 1.0)) < 0.1
        with pytest.raises(ValueError, match="resample"):
            pa.sample(prob, pa.beta_linear(1.0, 4, device="cpu"),
                      _random(6, 8, 0), _gen(0), resample="stratified")

    def test_family_count_diagnostic(self):
        _, prob = _small()
        s = _random(6, 128, 16)
        _, _, stats = pa.sample(prob, pa.beta_linear(0.5, 30, device="cpu"),
                                s, _gen(17), beta0=0.0, collect_stats=True)
        assert 1 <= stats["families"] <= 128
        _, _, hard = pa.sample(prob, pa.beta_linear(8.0, 2, device="cpu"), s,
                               _gen(18), beta0=0.0, collect_stats=True)
        assert hard["families"] < stats["families"]


class TestAdaptive:
    def test_log_z_matches_exact_enumeration(self):
        jp, prob = _small()
        out, log_z, stats = pa.sample_adaptive(prob, 1.5, _random(6, 4096, 20),
                                               _gen(21), target_frac=0.9,
                                               mcsteps=2)
        assert stats["reached"]
        est = float(log_z) + pa.uniform_log_z(6)
        assert abs(est - _exact_log_z(jp, 1.5)) < 0.05

    def test_ess_stays_on_target_and_betas_monotone(self):
        _, prob = _small()
        r, target = 2048, 0.9
        _, _, stats = pa.sample_adaptive(prob, 2.0, _random(6, r, 22),
                                         _gen(23), target_frac=target)
        betas = stats["betas"]
        assert stats["reached"] and stats["n_steps"] >= 3
        assert np.all(np.diff(betas) > 0)
        assert np.isclose(betas[-1], 2.0, atol=1e-4)
        assert np.all(stats["ess"][:-1] >= target * r * 0.97)

    def test_adaptive_beats_fixed_grid_at_equal_steps(self):
        jp, prob = _small()
        s = _random(6, 1024, 24)
        _, lz_a, stats = pa.sample_adaptive(prob, 3.0, s, _gen(25),
                                            target_frac=0.85)
        temps = pa.beta_linear(3.0, stats["n_steps"], device="cpu")
        _, lz_f = pa.sample(prob, temps, s, _gen(25), beta0=0.0)
        exact = _exact_log_z(jp, 3.0) - pa.uniform_log_z(6)
        assert abs(float(lz_a) - exact) <= abs(float(lz_f) - exact) + 0.05

    def test_reached_when_the_run_ends_on_its_last_step(self):
        """ADVICE.md, pa.py:380: the JAX sampler reports reached=False for a
        run that crosses beta_end on step max_steps; the port reports the
        final beta."""
        _, prob = _small()
        s = _random(6, 256, 26)
        _, _, free = pa.sample_adaptive(prob, 1.0, s, _gen(27))
        n = free["n_steps"]
        _, _, capped = pa.sample_adaptive(prob, 1.0, s, _gen(27),
                                          max_steps=n)
        assert capped["n_steps"] == n and capped["reached"]
        _, _, short = pa.sample_adaptive(prob, 1.0, s, _gen(27),
                                         max_steps=n - 1)
        assert not short["reached"]


class TestCombine:
    def test_combined_log_z_is_mean_in_z_space(self):
        lzs = [1.0, 2.0, 0.5]
        out = pa.combine_runs(lzs)
        assert np.isclose(out["log_z"], np.log(np.exp(lzs).mean()))
        assert np.isclose(out["weights"].sum(), 1.0)
        assert np.isclose(pa.combine_runs([1.0] * 4)["run_ess"], 4.0)
        assert pa.combine_runs([0.0, 20.0])["run_ess"] < 1.01

    def test_weighted_observable(self):
        out = pa.combine_runs([0.0, 0.0], observables=[1.0, 3.0])
        assert np.isclose(out["observable"], 2.0)

    def test_combining_tightens_collapsed_runs(self):
        jp, prob = _small()
        temps = pa.beta_linear(2.5, 40, device="cpu")
        K, r = 8, 256
        lzs, outs = [], []
        for k in range(K):
            out, lz = pa.sample(prob, temps, _random(6, r, 100 + k),
                                _gen(200 + k), beta0=0.0)
            lzs.append(float(lz))
            outs.append(out)
        exact = _exact_log_z(jp, 2.5) - pa.uniform_log_z(6)
        comb = pa.combine_runs(lzs)
        err_med = np.median([abs(lz - exact) for lz in lzs])
        assert abs(comb["log_z"] - exact) <= err_med + 0.02
        merged, run_of = pa.merge_populations(outs, lzs, _gen(300))
        assert merged.shape == (r, 6)
        if comb["run_ess"] > 1.5:
            assert np.unique(run_of.numpy()).size > 1


class TestQuantumPA:
    def _tiny(self):
        jp = JIsing.from_edges(3, np.array([0, 1, 2]), np.array([1, 2, 0]),
                               np.array([1.0, -0.7, 0.5]), maxnb=2)
        return jp, _ising(jp)

    def _exact_ext_log_z(self, jp, gamma, temp, slices):
        n = jp.nspins
        teff = temp * slices
        jp_ = float(jsched.jperp(jnp.float32(gamma), teff))
        sts = jnp.asarray(_enumerate(n * slices).reshape(-1, slices, n))
        e = np.asarray(jnp.sum(jp.energy(sts), axis=-1), dtype=np.float64)
        kin = np.asarray(jnp.sum(sts * jnp.roll(sts, -1, axis=-2),
                                 axis=(-1, -2)), dtype=np.float64)
        x = -(e - jp_ * kin) / teff
        return float(x.max() + np.log(np.exp(x - x.max()).sum()))

    def _equilibrated(self, prob, P, temp, g_hi, r, seed):
        confs = qmc.replicate(_random(3, r, seed), P)
        confs = (torch.rand(confs.shape, generator=_gen(seed)) < 0.5
                 ).float() * 2 - 1
        a = torch.full((60,), g_hi)
        return qmc.anneal(prob, a, torch.ones_like(a), temp, confs,
                          _gen(seed + 1))

    def test_log_z_matches_exact_extended_enumeration(self):
        jp, prob = self._tiny()
        P, temp, g_hi, g_lo = 3, 0.6, 2.0, 0.6
        confs = self._equilibrated(prob, P, temp, g_hi, 4096, 30)
        out, log_z = pa.sample_piqmc(prob, torch.linspace(g_hi, g_lo, 50),
                                     temp, confs, _gen(32), mcsteps=2)
        exact = (self._exact_ext_log_z(jp, g_lo, temp, P)
                 - self._exact_ext_log_z(jp, g_hi, temp, P))
        assert abs(float(log_z) - exact) < 0.05

    def test_split_engine_and_stats(self):
        jlat = jinst.random_2d_lattice(4, rng=33, lattice=True)[0]
        lat = convert.lattice_from_arrays(jlat.j_right, jlat.j_down,
                                          jlat.h_plane, jlat.col_wrap,
                                          device="cpu")
        e_gs = _energies(jlat.to_generic()).min()
        P, r = 4, 64
        confs = (torch.rand((r, P, 16), generator=_gen(33)) < 0.5
                 ).float() * 2 - 1
        out, log_z, stats = pa.sample_piqmc(
            lat, torch.linspace(2.5, 1e-4, 120), 0.25, confs, _gen(34),
            global_moves=True, collect_stats=True)
        assert out.shape == (r, P, 16)
        e_min = float(qmc.best_slice_energy(lat, out).min())
        assert np.isclose(e_min, e_gs, atol=1e-3)
        assert 1 <= stats["families"] <= r
        assert stats["ess"].shape == (120,)

    def test_adaptive_quantum_log_z_matches_exact(self):
        jp, prob = self._tiny()
        P, temp, g_hi, g_lo = 3, 0.6, 2.0, 0.6
        r = 4096
        confs = self._equilibrated(prob, P, temp, g_hi, r, 40)
        out, log_z, stats = pa.sample_piqmc_adaptive(
            prob, g_hi, g_lo, temp, confs, _gen(42), target_frac=0.9,
            mcsteps=2, max_steps=200)
        assert stats["reached"]
        assert np.all(np.diff(stats["jps"]) >= 0)
        assert np.all(stats["ess"][:-1] >= 0.9 * r * 0.97)
        exact = (self._exact_ext_log_z(jp, g_lo, temp, P)
                 - self._exact_ext_log_z(jp, g_hi, temp, P))
        assert abs(float(log_z) - exact) < 0.05

    def test_adaptive_quantum_rejects_wrong_direction(self):
        _, prob = self._tiny()
        with pytest.raises(ValueError, match="direction"):
            pa.sample_piqmc_adaptive(prob, 0.5, 2.0, 0.6,
                                     torch.ones(8, 3, 3), _gen(0))


# ------------------------------------------------------------------ slice


def _torus8():
    r = np.random.default_rng(0)
    jlat = jlattice.LatticeProblem.from_planes(r.normal(size=(8, 8)),
                                               r.normal(size=(8, 8)))
    return jlat, convert.lattice_from_arrays(jlat.j_right, jlat.j_down,
                                             jlat.h_plane, jlat.col_wrap,
                                             device="cpu")


@pytest.mark.parametrize("method,kw", (
    ("pa", {}), ("pa", {"adaptive": True, "beta_end": 3.0}),
    ("paq", {"slices": 4})))
def test_solve_matches_jax_solve(method, kw):
    jlat, lat = _torus8()
    reads = 8 if method == "paq" else 64
    got = api.solve(lat, method, num_reads=reads, sweeps=100, seed=0, **kw)
    want = japi.solve(jlat, method, num_reads=reads, sweeps=100, seed=0,
                      **kw)
    a, b = got.energies / 64, np.asarray(want.energies) / 64
    se = np.sqrt(a.var(ddof=1) / a.size + b.var(ddof=1) / b.size)
    assert abs(a.mean() - b.mean()) < max(0.02, 5 * se), (a.mean(),
                                                           b.mean())
    for k in ("families", "min_ess_frac", "log_z", "n_steps", "reached"):
        assert (k in got.info) == (k in want.info), k
    if method == "pa":
        # an absolute ln Z of the same problem, its error is the anneal's
        assert got.info["log_z"] == pytest.approx(want.info["log_z"],
                                                  rel=0.01)


def test_solve_pa_adaptive_edges():
    """ADVICE.md, api.py:253: an adaptive run with no live step reports
    min_ess_frac 1.0 (the JAX solve takes the min of an empty array); and
    ess_threshold, which the adaptive sampler never reads, is refused."""
    _, lat = _torus8()
    got = api.solve(lat, "pa", num_reads=16, sweeps=10, adaptive=True,
                    beta_end=0.0)
    assert got.info["n_steps"] == 0 and got.info["min_ess_frac"] == 1.0
    assert got.info["reached"]
    with pytest.raises(TypeError, match="ess_threshold"):
        api.solve(lat, "pa", num_reads=16, sweeps=10, adaptive=True,
                  ess_threshold=0.5)
