"""The port's value studies (montecarlosolvers_tpu_torch/bench/) and the
pieces of the public surface they need, on the CPU at tiny sizes:

- the machinery cases of tests/test_pt_value.py, test_pa_value.py,
  test_icm_value.py and test_bench_common.py on the port's studies (every
  arm runs end to end and returns well-formed records);
- machinery at tiny sizes for cluster_value, cluster_crossover (whose
  `tau_int` and `fm_lattice` equal the JAX study's exactly) and
  ladder_calibration;
- the two ADVICE.md defects of the JAX studies, fixed in the port, each
  in a test that names it: ladder_calibration's inverted c_to_center, and
  icm_value's PT trace, which the port cuts at the paired ICM arm's wall;
  otherwise `icm_value.summarize` equals the JAX study's;
- `pt.sample_icm(grid_bonds=)`: taken, checked, and bitwise without
  effect; icm_value passes it as the JAX study does;
- `qmc.slice_energies` equal to the JAX function (rtol 1e-6) on the three
  problem types;
- the examples cluster_and_pt and compat_migration at tiny sizes.
"""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import montecarlosolvers_tpu_torch.bench.cluster_crossover as tcc
import montecarlosolvers_tpu_torch.bench.cluster_value as tcv
import montecarlosolvers_tpu_torch.bench.icm_value as tiv
import montecarlosolvers_tpu_torch.bench.ladder_calibration as tlc
import montecarlosolvers_tpu_torch.bench.pa_value as pav
import montecarlosolvers_tpu_torch.bench.pt_value as pv
from montecarlosolvers_tpu.bench import cluster_crossover as jcc
from montecarlosolvers_tpu.bench import icm_value as jiv
from montecarlosolvers_tpu.models import instances as jinst
from montecarlosolvers_tpu.models.dense import DenseProblem as JDense
from montecarlosolvers_tpu.models.lattice import LatticeProblem as JLattice
from montecarlosolvers_tpu.solvers import qmc as jqmc
from montecarlosolvers_tpu_torch import convert
from montecarlosolvers_tpu_torch.bench import _common
from montecarlosolvers_tpu_torch.bench._common import by_family, generator
from montecarlosolvers_tpu_torch.examples import cluster_and_pt
from montecarlosolvers_tpu_torch.examples import compat_migration
from montecarlosolvers_tpu_torch.models import instances
from montecarlosolvers_tpu_torch.models.lattice import LatticeProblem
from montecarlosolvers_tpu_torch.ops.cluster import grid_bonds_from_edges
from montecarlosolvers_tpu_torch.solvers import pt, qmc, sa

torch.set_num_threads(1)


def _pm1_lattice(L=6):
    rng = np.random.default_rng(0)
    jr = rng.choice([-1.0, 1.0], (L, L)).astype(np.float32)
    jd = rng.choice([-1.0, 1.0], (L, L)).astype(np.float32)
    # any certified lower bound works: the arms only need finite eps
    return LatticeProblem.from_planes(jr, jd, device="cpu"), -2.0 * L * L


def _recorder():
    rec = {}

    def record(name, fn):
        out = fn()
        rec[name] = out
        return out

    return rec, record


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _keys_match(mod, rec):
    """Every record's keys are those its family has in mod.RECORD_KEYS."""
    for name, arm in rec.items():
        assert set(arm) == by_family(mod.RECORD_KEYS, name), name


# ------------------------------------------------------------- pt_value


@pytest.fixture()
def pt_tiny(monkeypatch):
    monkeypatch.setattr(pv, "RUNGS", 6)
    monkeypatch.setattr(pv, "SWEEPS", 30)
    monkeypatch.setattr(pv, "Q_RUNGS", 4)
    monkeypatch.setattr(pv, "Q_SLICES", 4)
    monkeypatch.setattr(pv, "Q_SWEEPS", 20)
    monkeypatch.setattr(pv, "TUNE_SWEEPS", 50)
    monkeypatch.setattr(pv, "Q_TUNE_SWEEPS", 25)
    return _pm1_lattice()


def test_pt_sampling_arms_record_shape(pt_tiny):
    problem, e_gs = pt_tiny
    rec, record = _recorder()
    pv.sampling_arms(problem, e_gs, _gen(1), rec, record)
    pt_arm, q_arm = rec["sampling_pt"], rec["sampling_quench"]
    assert 0.0 < pt_arm["swap_rate"] <= 1.0
    assert pt_arm["total_sweeps"] == q_arm["total_sweeps"] == 6 * 30
    for arm in (pt_arm, q_arm):
        assert np.isfinite(arm["eps_cold"]) and arm["eps_cold"] > 0
        assert arm["wall_s"] > 0
    assert any(k.startswith("sampling_quench_equalwall_s") for k in rec)
    _keys_match(pv, rec)


def test_pt_optimization_arms_equal_wall_scaling(pt_tiny):
    problem, e_gs = pt_tiny
    rec, record = _recorder()
    pv.optimization_arms(problem, e_gs, _gen(2), rec, record)
    assert "opt_pt" in rec and "opt_sa_tau30" in rec
    eq = [k for k in rec if k.startswith("opt_sa_equalwall_tau")]
    assert len(eq) == 1
    # the equal-wall tau derives from the measured wall ratio
    assert rec[eq[0]]["tau"] >= 1
    for arm in rec.values():
        assert np.isfinite(arm["eps_best"])
    _keys_match(pv, rec)


def test_pt_quantum_arms_run(pt_tiny):
    problem, e_gs = pt_tiny
    rec, record = _recorder()
    pv.quantum_arms(problem, e_gs, _gen(3), rec, record)
    assert 0.0 <= rec["quantum_pt"]["swap_rate"] <= 1.0
    assert any(k.startswith("quantum_piqmc_equalwall") for k in rec)
    for arm in rec.values():
        assert np.isfinite(arm["eps_best"])
    _keys_match(pv, rec)


def test_pt_icm_arms_record_shape(pt_tiny):
    problem, e_gs = pt_tiny
    rec, record = _recorder()
    pv.icm_arms(problem, e_gs, _gen(4), rec, record)
    for name in ("sampling_icm", "opt_icm"):
        arm = rec[name]
        assert 0.0 <= arm["houdayer_flip_frac"] <= 1.0
        assert 0.0 <= arm["swap_rate"] <= 1.0
        assert arm["wall_s"] > 0
    assert np.isfinite(rec["sampling_icm"]["eps_cold"])
    assert np.isfinite(rec["opt_icm"]["eps_best"])
    _keys_match(pv, rec)


def test_pt_value_main_needs_the_instance(monkeypatch, tmp_path):
    """Without the santoro instance the mains raise FileNotFoundError, as
    the JAX studies' do, and write nothing."""
    from montecarlosolvers_tpu_torch.bench import cluster_value

    monkeypatch.delenv("MCS_TPU_INSTANCE_DIR", raising=False)
    for mod in (pv, pav, cluster_value):
        with pytest.raises(FileNotFoundError):
            mod.main(outdir=str(tmp_path / mod.__name__), device="cpu")
    assert not any(tmp_path.iterdir())


# ------------------------------------------------------------- pa_value


@pytest.fixture()
def pa_tiny(monkeypatch):
    monkeypatch.setattr(pav, "REPLICAS", 32)
    monkeypatch.setattr(pav, "SWEEPS", 40)
    monkeypatch.setattr(pav, "TUNE_SWEEPS", 50)
    return _pm1_lattice()


def test_pa_sampling_arms_record_shape(pa_tiny):
    problem, e_gs = pa_tiny
    rec, record = _recorder()
    pav.sampling_arms(problem, e_gs, _gen(1), rec, record)
    pa_arm, q_arm = rec["sampling_pa"], rec["sampling_quench"]
    assert pa_arm["total_sweeps"] == q_arm["total_sweeps"] == 32 * 40
    assert 0.0 < pa_arm["min_ess_frac"] <= 1.0
    assert np.isfinite(pa_arm["log_z_per_spin"])
    eq = [k for k in rec if k.startswith("sampling_quench_equalwall_s")]
    assert len(eq) == 1
    pt_arm = [k for k in rec if k.startswith("sampling_pt_matched_")]
    assert len(pt_arm) == 1 and rec[pt_arm[0]]["replicas"] >= 32
    for arm in rec.values():
        assert np.isfinite(arm["eps_cold"]) and arm["eps_cold"] > 0
        assert arm["wall_s"] > 0
    _keys_match(pav, rec)


def test_pa_optimization_arms_equal_wall_scaling(pa_tiny):
    problem, e_gs = pa_tiny
    rec, record = _recorder()
    pav.optimization_arms(problem, e_gs, _gen(2), rec, record)
    assert "opt_pa" in rec and "opt_sa_tau40" in rec
    eq = [k for k in rec if k.startswith("opt_sa_equalwall_tau")]
    assert len(eq) == 1
    assert rec[eq[0]]["tau"] >= 1
    assert any(k.startswith("opt_pt_matched_") for k in rec)
    for arm in rec.values():
        assert np.isfinite(arm["eps_best"])
        assert arm["eps_best"] <= arm["eps_mean"]
    _keys_match(pav, rec)


def test_pa_v2_arms_record_shape(pa_tiny, monkeypatch):
    monkeypatch.setattr(pav, "COMBINE_RUNS", 2)
    monkeypatch.setattr(pav, "Q_REPLICAS", 8)
    monkeypatch.setattr(pav, "Q_SLICES", 4)
    monkeypatch.setattr(pav, "Q_STEPS", 10)
    monkeypatch.setattr(pav, "Q_MAX_STEPS", 40)
    problem, e_gs = pa_tiny
    rec, record = _recorder()
    pav.v2_arms(problem, e_gs, _gen(3), rec, record)
    for name in ("sampling_pa_adaptive", "opt_pa_adaptive"):
        arm = rec[name]
        assert arm["n_steps"] >= 1 and arm["reached"]
        assert 0.0 < arm["min_ess_frac"] <= 1.0
    assert rec["opt_pa_adaptive_eqsweeps"]["mcsteps"] >= 1
    assert rec["sampling_pa_combined_k2"]["runs"] == 2
    assert rec["opt_paq"]["replicas"] == 8
    for name in ("opt_piqmc_equalwall_for_paq",
                 "opt_piqmc_equalwall_for_paq_adaptive"):
        assert rec[name]["tau"] >= 10
    for arm in rec.values():
        for k in ("eps_best", "eps_cold", "eps_cold_combined"):
            if k in arm:
                assert np.isfinite(arm[k]) and arm[k] > 0


# ------------------------------------------------------------ icm_value


def _segs(walls, bests):
    return {"segments": [
        dict(wall_s=w, sweeps=(i + 1) * 500, e_best=b, e_cold=b,
             swap_rate=0.5, h_frac=0.25)
        for i, (w, b) in enumerate(zip(walls, bests))
    ]}


def test_icm_summarize_pairing_and_winners():
    """tests/test_icm_value.py's case on the port. Rep 0 (icm hits at wall
    1.0, pt at 2.0) is an icm win in both; rep 1 differs as the ADVICE.md
    fix (icm_value.py:227) says: cut at icm's final wall 1.0, pt has not
    hit either and both bests are -9, a tie, where the JAX study credits
    pt with the hit it made at wall 2.0."""
    L, seed = tiv.L_SIZES[0], 0
    h = tiv.CADENCES_BY_L[L][0]
    done = {
        f"icm_h{h}_L{L}_s{seed}": _segs([0.5, 1.0], [-9.0, -10.0]),
        f"pt_L{L}_s{seed}": _segs([1.0, 2.0], [-9.0, -10.0]),
        f"icm_h{h}_L{L}_s{seed}_r1": _segs([0.5, 1.0], [-9.0, -9.0]),
        f"pt_L{L}_s{seed}_r1": _segs([1.0, 2.0], [-9.0, -10.0]),
    }
    v = tiv.summarize(done)[f"L{L}_h{h}"]
    assert v["pairs"] == 2
    assert v["icm_wins"] == 1 and v["pt_wins"] == 0 and v["ties"] == 1
    assert v["icm_hit_frac"] == 0.5 and v["pt_hit_frac"] == 0.0
    assert v["icm_median_ttr"] == 1.0 and v["pt_median_ttr"] is None
    j = jiv.summarize(done)[f"L{L}_h{h}"]
    assert j["pt_wins"] == 1 and j["pt_hit_frac"] == 1.0


def test_icm_summarize_e_ref_spans_all_cadences():
    L = tiv.L_SIZES[0]
    hs = tiv.CADENCES_BY_L[L]
    done = {
        f"icm_h{hs[0]}_L{L}_s0": _segs([1.0], [-8.0]),
        f"icm_h{hs[1]}_L{L}_s0": _segs([1.0], [-12.0]),  # sets e_ref
        f"pt_L{L}_s0": _segs([1.0], [-8.0]),
    }
    v0 = tiv.summarize(done)[f"L{L}_h{hs[0]}"]
    assert v0["icm_hit_frac"] == 0.0 and v0["pt_hit_frac"] == 0.0
    assert v0["ties"] == 1
    assert tiv.summarize({}) == {}


def _icm_done(rng, pt_longer):
    """A done dict over every (L, cadence, seed, rep) of the JAX study's
    tables with random segment traces; pt_longer: PT's walls run past the
    ICM walls (as in a study), else they stay inside them."""
    done = {}
    for L in jiv.L_SIZES:
        for seed in jiv.SEEDS_BY_L[L][:2]:
            for rep in range(jiv.REPS[L]):
                suffix = f"_r{rep}" if rep else ""
                for h in jiv.CADENCES_BY_L[L]:
                    walls = np.cumsum(rng.uniform(0.5, 1.0, 4))
                    bests = np.minimum.accumulate(
                        -rng.integers(8, 12, 4).astype(float))
                    done[f"icm_h{h}_L{L}_s{seed}{suffix}"] = _segs(
                        walls.round(3).tolist(), bests.tolist())
                scale = 2.0 if pt_longer else 0.5
                walls = np.cumsum(rng.uniform(0.5, 1.0, 4)) * scale
                bests = np.minimum.accumulate(
                    -rng.integers(8, 12, 4).astype(float))
                done[f"pt_L{L}_s{seed}{suffix}"] = _segs(
                    walls.round(3).tolist(), bests.tolist())
    return done


def test_icm_summarize_equals_jax_inside_the_wall():
    """Where every PT trace ends inside its paired ICM arm's wall, the
    fix cuts nothing and the port's verdicts equal the JAX study's."""
    done = _icm_done(np.random.default_rng(0), pt_longer=False)
    assert tiv.summarize(done) == jiv.summarize(done)


def test_icm_summarize_cuts_pt_at_the_icm_wall():
    """ADVICE.md, icm_value.py:227: each of the port's verdicts equals the
    JAX summarize of the same dict with each PT trace cut at its paired
    ICM arm's final wall (the JAX study compares the whole PT trace). The
    uncut traces stay in the dict under keys the pairing never reads, so
    the instance reference energy is the same."""
    done = _icm_done(np.random.default_rng(1), pt_longer=True)
    port = tiv.summarize(done)
    for L in jiv.L_SIZES:
        for h in jiv.CADENCES_BY_L[L]:
            cut = {f"ref_{k}": v for k, v in done.items()
                   if k.startswith("pt_")}
            cut.update(done)
            for seed in jiv.SEEDS_BY_L[L]:
                pairs = zip(jiv._arm_keys(done, f"icm_h{h}_L{L}_s{seed}"),
                            jiv._arm_keys(done, f"pt_L{L}_s{seed}"))
                for ik, pk in pairs:
                    wall = done[ik]["segments"][-1]["wall_s"]
                    segs = tiv.within_wall(done[pk]["segments"], wall)
                    assert segs, "every test trace starts inside the wall"
                    cut[pk] = {"segments": segs}
            key = f"L{L}_h{h}"
            assert port[key] == jiv.summarize(cut)[key], key
    assert port != jiv.summarize(done)


def test_icm_run_instance_passes_grid_bonds(monkeypatch):
    """icm_value's arms at L = 4: the tuning, ICM and PT records, every
    sample_icm call with the instance's grid bonds, as the JAX study's
    (icm_value.py:90, :144, :148)."""
    L = 4
    monkeypatch.setattr(tiv, "CADENCES_BY_L", {L: (2,)})
    monkeypatch.setattr(tiv, "REPS", {L: 1})
    monkeypatch.setattr(tiv, "ICM_SEGS", {L: 2})
    monkeypatch.setattr(tiv, "SEEDS_BY_L", {L: (0,)})
    monkeypatch.setattr(tiv, "L_SIZES", (L,))
    monkeypatch.setattr(tiv, "RUNGS", 4)
    monkeypatch.setattr(tiv, "SEG", 10)
    monkeypatch.setattr(tiv, "PT_MAX_SEGS", 3)
    monkeypatch.setattr(tiv, "TUNE_SWEEPS", 20)
    seen = []
    real = pt.sample_icm

    def spy(*a, **kw):
        seen.append(kw.get("grid_bonds"))
        return real(*a, **kw)

    monkeypatch.setattr(tiv.pt, "sample_icm", spy)
    rec, record = _recorder()
    tiv.run_instance(L, 0, generator("cpu", 5), record)
    assert set(rec) == {"tune_L4_s0", "icm_h2_L4_s0", "pt_L4_s0"}
    assert len(rec["icm_h2_L4_s0"]["segments"]) == 2
    _keys_match(tiv, rec)
    assert all(set(s) == tiv.SEGMENT_KEYS for k in ("icm_h2_L4_s0",
                                                     "pt_L4_s0")
               for s in rec[k]["segments"])
    assert 1 <= len(rec["pt_L4_s0"]["segments"]) <= 3
    icm_calls = [g for g in seen if g is not None]
    assert len(icm_calls) == 3  # the warm segment and two measured
    assert all(len(g) == 3 and tuple(g[0].shape) == (L, L, L)
               for g in icm_calls)
    assert tiv.summarize(rec)["L4_h2"]["pairs"] == 1


def test_sample_icm_takes_grid_bonds_without_effect():
    """The repair of ROADMAP.md queue 3: sample_icm accepts grid_bonds,
    checks their shape, and a run with them equals the run without,
    bitwise."""
    L = 4
    problem, (rows, cols, vals) = instances.random_3d_lattice(
        L, rng=0, device="cpu")
    gb = grid_bonds_from_edges((L, L, L), rows, cols, vals, device="cpu")
    temps = pt.geometric_ladder(0.5, 2.0, 4, device="cpu")
    s0 = sa.random_state(_gen(0), problem.nspins, batch=(2, 4), device="cpu")
    a = pt.sample_icm(problem, temps, s0, _gen(1), 20, swap_every=2,
                      collect_energy=True, grid_bonds=gb)
    b = pt.sample_icm(problem, temps, s0, _gen(1), 20, swap_every=2,
                      collect_energy=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    lat = instances.gaussian_torus(4, 0, device="cpu")
    grid = tuple(x != 0 for x in (lat.j_down, lat.j_right))
    c = pt.sample_icm(lat, temps, s0[..., :16], _gen(2), 10,
                      grid_bonds=grid)
    d = pt.sample_icm(lat, temps, s0[..., :16], _gen(2), 10)
    assert all(torch.equal(x, y) for x, y in zip(c, d))
    with pytest.raises(ValueError, match="grid_bonds"):
        pt.sample_icm(problem, temps, s0, _gen(1), 2, grid_bonds=gb[:2])
    with pytest.raises(ValueError, match="grid_bonds"):
        pt.sample_icm(lat, temps, s0[..., :16], _gen(1), 2, grid_bonds=gb)


# ------------------------------------------------ cluster_value, crossover


def test_cluster_value_arms_record_shape(monkeypatch):
    monkeypatch.setattr(tcv, "CHAINS", 3)
    monkeypatch.setattr(tcv, "P", 4)
    problem = instances.gaussian_torus(6, 0, device="cpu")
    e_gs = -float(problem.j_right.abs().sum() + problem.j_down.abs().sum())
    rec, record = _recorder()
    tcv.arms(problem, e_gs, _gen(0), record, taus=(12,), n_cl=2)
    names = set(rec)
    assert {"baseline_tau12", "mixed_wcl_tau12", "bath_baseline_tau12",
            "bath_mixed_sw_tau12"} <= names
    assert any(k.startswith("baseline_equalwall_tau") for k in names)
    assert any(k.startswith("bath_baseline_equalwall_tau") for k in names)
    for k, arm in rec.items():
        assert np.isfinite(arm["eps"]) and arm["eps"] > 0, k
        assert arm["wall_s"] > 0
        if "mixed" in k:
            assert 0.0 <= arm["flip_frac"] <= 1.0
    _keys_match(tcv, rec)


def test_cluster_value_mixed_arm_takes_the_remainder(monkeypatch):
    """tau % n_cl != 0: the last segment runs the remainder, and the last
    cluster move sees the schedule's final Gamma."""
    monkeypatch.setattr(tcv, "P", 2)
    problem = instances.gaussian_torus(4, 0, device="cpu")
    confs0 = tcv._pre_annealed(problem, _gen(0), chains=2)
    seen = []
    real = qmc.anneal

    def spy(prob, a, *args, **kw):
        seen.append(a.shape[0])
        return real(prob, a, *args, **kw)

    monkeypatch.setattr(tcv.qmc, "anneal", spy)
    tcv.mixed_arm(problem, -100.0, 11, _gen(1), confs0, n_cl=3)
    assert seen[:3] == [3, 3, 5]


def test_crossover_fm_lattice_and_tau_int_equal_jax():
    for L in (4, 5):
        t = tcc.fm_lattice(L, device="cpu")
        j = jcc.fm_lattice(L)
        for name in ("nbr_idx", "nbr_J", "h", "color_masks"):
            assert np.array_equal(getattr(t, name).numpy(),
                                  np.asarray(getattr(j, name))), name
    rng = np.random.default_rng(0)
    for x in (rng.normal(size=300),
              np.cumsum(rng.normal(size=500)),  # long correlations
              np.ones(64)):
        assert tcc.tau_int(x) == jcc.tau_int(x)


def test_crossover_arms_run_and_are_seeded():
    problem = tcc.fm_lattice(4, device="cpu")
    a = tcc.run_arm(problem, tcc.T_C, 0.1, 2, 32, generator("cpu", 1),
                    wolff_every=2, chunk=16, P=2, burn=8)
    b = tcc.run_arm(problem, tcc.T_C, 0.1, 2, 32, generator("cpu", 1),
                    wolff_every=2, chunk=16, P=2, burn=8)
    assert a[0] == b[0] and a[2:] == b[2:]  # all but the wall
    tau, wall, m2, frac = a
    assert tau >= 0.5 and wall > 0 and 0.0 <= m2 <= 1.0
    assert 0.0 < frac <= 1.0
    for move in tcc.MOVES:
        tau, wall, m2 = tcc.run_classical_arm(
            problem, 1.5 * tcc.T_C, 2, 32, generator("cpu", 2), move=move,
            chunk=16, burn=8)
        assert tau >= 0.5 and wall > 0 and 0.0 <= m2 <= 1.0


def test_crossover_mains_record_every_arm(tmp_path, monkeypatch):
    """main and main_classical: the JAX study's arm names, trace lengths
    and chunks, and the records saved (the arms themselves spied)."""
    calls = []
    monkeypatch.setattr(tcc, "run_arm", lambda *a, **kw: (
        calls.append(("q", a[4], kw)) or (1.0, 1e-3, 0.5, 0.25)))
    monkeypatch.setattr(tcc, "run_classical_arm", lambda *a, **kw: (
        calls.append(("c", a[3], kw)) or (1.0, 1e-3, 0.5)))
    done = tcc.main(outdir=str(tmp_path), Ls=(4,), device="cpu")
    assert set(done) == {f"{t}_{a}_L4" for t in ("critical", "offcritical")
                         for a in ("localglobal", "wolff1", "wolff4")}
    assert [(c[1], c[2]["wolff_every"], c[2]["burn"]) for c in calls[:3]] \
        == [(16384, 0, 2048), (8192, 1, 2048), (8192, 4, 2048)]
    calls.clear()
    done = tcc.main_classical(outdir=str(tmp_path), Ls=(4, 8),
                              device="cpu")
    assert "cl_offcritical_sw+local_L4" in done
    assert not any("swlat" in k for k in done)
    assert "cl_critical_wolff_L8" in done
    assert "cl_offcritical_local_L8" not in done
    assert {c[2]["move"] for c in calls} == set(tcc.MOVES)
    saved = json.loads((tmp_path / "crossover.json").read_text())
    assert saved == done and len(done) == 6 + 8 + 4


# --------------------------------------------------- ladder_calibration


def test_ladder_calibration_measure():
    problem, _ = instances.random_2d_lattice(4, rng=4, lattice=True,
                                             device="cpu")
    out = tlc._measure(problem, 16, _gen(0), sweeps=40)
    assert out["nspins"] == 16 and out["rungs"] >= 4
    assert 0.0 <= out["swap_rate"] <= 1.0
    assert out["in_band"] == (0.2 <= out["swap_rate"] <= 0.6)


def test_ladder_calibration_c_to_center_is_not_inverted():
    """ADVICE.md, ladder_calibration.py:51: a swap rate below 0.4 needs a
    denser ladder, a smaller c (the JAX study's formula gives a larger
    one); a rate above 0.4 a larger c; 0.4 keeps c."""
    assert tlc.c_to_center(0.2) < 2.5 < tlc.c_to_center(0.7)
    assert tlc.c_to_center(0.4) == 2.5
    assert tlc.c_to_center(0.2) == round(2.5 * np.log(0.4) / np.log(0.2), 2)
    jax_c = round(2.5 * np.log(0.2) / np.log(0.4), 2)  # the JAX line 51
    assert jax_c > 2.5


# ------------------------------------------------------------ bench._common


def test_recorder_runs_persists_and_caches(tmp_path):
    path = tmp_path / "summary.json"
    done = {}
    record = _common.make_recorder(str(path), done)
    calls = []
    out = record("arm_a", lambda: calls.append("a") or {"eps": 0.02})
    assert out == {"eps": 0.02}
    assert calls == ["a"]
    assert json.loads(path.read_text()) == {"arm_a": {"eps": 0.02}}
    assert record("arm_a", lambda: calls.append("again")) == {"eps": 0.02}
    assert calls == ["a"]


def test_recorder_resumes_from_preloaded_done(tmp_path):
    path = tmp_path / "summary.json"
    done = {"arm_a": 1.5}
    record = _common.make_recorder(str(path), done)
    assert record("arm_a",
                  lambda: (_ for _ in ()).throw(AssertionError)) == 1.5
    record("arm_b", lambda: 2.5)
    assert json.loads(path.read_text()) == {"arm_a": 1.5, "arm_b": 2.5}


def test_recorder_budget_skips_but_keeps_cache_hits(tmp_path, monkeypatch):
    t = [1000.0]
    monkeypatch.setattr(_common.time, "time", lambda: t[0])
    path = tmp_path / "summary.json"
    done = {"cached": 7}
    record = _common.make_recorder(str(path), done, budget_s=60.0)
    t[0] += 120.0  # budget exhausted
    assert record("fresh", lambda: 9) is None
    assert "fresh" not in done and not path.exists()
    assert record("cached", lambda: 9) == 7


def test_timed_is_best_of_two_after_a_warm_run(monkeypatch):
    clock = iter([0.0, 5.0, 10.0, 12.0])
    monkeypatch.setattr(_common.time, "perf_counter", lambda: next(clock))
    calls = []
    out, wall = _common.timed(lambda t: calls.append(t) or torch.ones(1) * t)
    assert calls == [0, 1, 2]
    assert wall == 2.0 and float(out) == 2.0


def test_generators_are_seeded_by_their_words():
    a = _common.generator("cpu", 1, 2)
    b = _common.generator("cpu", 1, 2)
    c = _common.generator("cpu", 2, 1)
    draw = [torch.rand(4, generator=g) for g in (a, b, c)]
    assert torch.equal(draw[0], draw[1])
    assert not torch.equal(draw[0], draw[2])
    s1 = _common.split(_gen(3), 4)
    assert s1 == _common.split(_gen(3), 4) and len(set(s1)) == 4


# --------------------------------------------------------- slice_energies


def test_slice_energies_equal_jax():
    rng = np.random.default_rng(0)
    jl = JLattice.from_planes(rng.normal(size=(6, 6)).astype(np.float32),
                              rng.normal(size=(6, 6)).astype(np.float32))
    jg = jinst.random_3d_lattice(3, rng=0, dist="gauss")[0]
    jd = JDense.from_couplings(rng.normal(size=(20, 20)))
    ports = (
        convert.lattice_from_arrays(jl.j_right, jl.j_down, jl.h_plane,
                                    col_wrap=jl.col_wrap, device="cpu"),
        convert.ising_from_arrays(jg.nbr_idx, jg.nbr_J, jg.h, jg.color_masks,
                                  device="cpu"),
        convert.dense_from_arrays(jd.J, jd.h, device="cpu"))
    for jprob, prob in zip((jl, jg, jd), ports):
        confs = rng.choice([-1.0, 1.0], size=(2, 3, prob.nspins)).astype(
            np.float32)
        want = np.asarray(jqmc.slice_energies(jprob, jnp.asarray(confs)))
        got = qmc.slice_energies(prob, torch.as_tensor(confs)).numpy()
        assert got.shape == (2, 3)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


# --------------------------------------------------------------- examples


def test_compat_migration_example():
    out = compat_migration.run(L=4, sweeps=60, slices=4, device="cpu",
                               verbose=False)
    assert out["nspins"] == 16
    for k in ("sa_energy", "piqmc_best_energy"):
        assert out["bound"] <= out[k] < 0


def test_cluster_and_pt_example():
    problem = instances.gaussian_torus(4, 0, device="cpu").to_generic()
    bound = -float(problem.nbr_J.abs().sum()) / 2
    out = cluster_and_pt.run(problem, bound, tau=20, chains=2, rungs=4,
                             pt_sweeps=20, slices=2, verbose=False)
    assert set(out) == {"sa", "sa_wolff", "sa_sw", "piqmc_sw", "pt", "icm",
                        "quantum_pt", "pa"}
    for k, v in out.items():
        eps = v["eps_res"] if isinstance(v, dict) else v
        assert np.isfinite(eps) and eps >= 0, k
    assert 0.0 <= out["icm"]["flip_frac"] <= 1.0
    assert np.isfinite(out["pa"]["log_z_per_spin"])
