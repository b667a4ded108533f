"""The port's throughput bench (`montecarlosolvers_tpu_torch/bench/
throughput.py`) on the CPU: `measure_rate` under a fake clock (the
counterparts of tests/test_bench.py:29, :44 and :60), and every arm of
bench.py on a 16 x 16 torus with tiny tau through `main`, one parseable
JSON line each."""

import json

import numpy as np
import pytest
import torch

from montecarlosolvers_tpu_torch.bench import throughput

torch.set_num_threads(1)


class FakeClock:
    def __init__(self, t0=1000.0):
        self.now = t0

    def __call__(self):
        return self.now


def test_measure_rate_cancels_fixed_overhead():
    clock = FakeClock()
    per_step, overhead, work = 1e-4, 0.3, 6400.0

    def run(tau, seed):
        clock.now += overhead + per_step * tau

    rate, info = throughput.measure_rate(run, (1000, 3000, 5000), work,
                                         clock=clock)
    # the slope recovers work / per_step exactly despite the fixed 0.3 s
    assert np.isclose(rate, work / per_step, rtol=1e-6)
    assert not info["degraded"]
    assert info["points"] == 3
    assert info["slope_spread"] < 1e-9


def test_measure_rate_degrades_on_wild_slope():
    clock = FakeClock()
    work = 6400.0
    # a large-tau call faster than the small-tau one: a negative slope
    times = {100: 5.0, 300: 1.0}

    def run(tau, seed):
        clock.now += times[tau]

    rate, info = throughput.measure_rate(run, (100, 300), work, clock=clock)
    assert info["degraded"]
    # the fallback is the single-shot rate at the largest tau
    assert np.isclose(rate, work * 300 / times[300], rtol=1e-6)


def test_measure_rate_two_points_suffice():
    clock = FakeClock()
    per_step, work = 1e-3, 100.0
    seeds = []

    def run(tau, seed):
        seeds.append(seed)
        clock.now += 0.1 + per_step * tau

    rate, info = throughput.measure_rate(run, (1000, 2000), work, trials=2,
                                         clock=clock)
    assert info["points"] == 2 and not info["degraded"]
    assert np.isclose(rate, work / per_step, rtol=1e-6)
    # a warm run (seed 0), then the trials, at each tau
    assert seeds == [0, 1, 2, 0, 1, 2]


def test_every_arm_prints_a_line_on_the_cpu(capsys):
    throughput.main(["--device", "cpu", "--L", "16", "--taus", "2", "4",
                     "--light"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["arm"] for r in lines] == list(throughput.ARMS)
    for r in lines:
        chains, slices = throughput.ARMS[r["arm"]][:2]
        assert r["chains"] == chains and r["slices"] == slices
        assert r["sites"] == 256 and r["taus"] == [2, 4]
        assert np.isfinite(r["attempts_per_s"]) and r["attempts_per_s"] > 0
        assert r["points"] == 2 and isinstance(r["degraded"], bool)
        # the CPU runs the plain versions: no kernel is launched
        assert r["launches"] == {} and r["device"] == "cpu"
        assert r["lattice"] == "random_2d_lattice(16, rng=0, lattice=True)"
        assert "nvidia_smi" in r
    for r in lines[:2]:  # sa and piqmc read out quality
        assert r["quality_tau"] == 4
        assert -2.0 < r["best_energy_per_spin"] <= r["mean_energy_per_spin"]
        assert r["mean_energy_per_spin"] < 0


@pytest.mark.parametrize("side", [16, 80])
def test_fallback_lattice_is_bench_py_s(side, monkeypatch):
    """problem_of's fallback is bench.py::_problem's, the seeded open
    lattice random_2d_lattice(side, rng=0, lattice=True): the same coupling
    planes as the JAX instance, exactly (tol = 0), and no wrap column, so
    the split engines take the 5-slot stencil."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from montecarlosolvers_tpu.models import instances as jax_instances

    monkeypatch.setenv("MCS_TPU_INSTANCE_DIR", "/nonexistent")
    problem, e_gs, name = throughput.problem_of("cpu", side)
    assert e_gs is None
    assert name == f"random_2d_lattice({side}, rng=0, lattice=True)"
    want, _ = jax_instances.random_2d_lattice(side, rng=0, lattice=True)
    for key in ("j_right", "j_down", "h_plane"):
        got = getattr(problem, key).numpy()
        ref = np.asarray(getattr(want, key))
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    assert not problem.col_wrap and not want.col_wrap


def test_arms_keep_bench_py_shapes():
    """bench.py's chain counts, slices and tau grids (light too)."""
    want = {"sa": (1280, 1, (2000, 6000, 10000), (500, 1500)),
            "piqmc": (32, 40, (1000, 3000, 5000), (300, 900)),
            "svmc": (256, 1, (1000, 3000), (300, 900)),
            "piqmc_bath": (32, 40, (800, 2400, 4800), (400, 1200)),
            "pallas": (256, 1, (16384, 65536), (4096, 16384)),
            "pallas_qmc": (16, 40, (2048, 8192), (512, 2048)),
            "pallas_svmc": (128, 1, (8192, 32768), (2048, 8192)),
            "pallas_bath": (8, 40, (1536, 6144), (512, 2048))}
    assert {k: v[:4] for k, v in throughput.ARMS.items()} == want


def test_no_card_means_no_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=None means the CUDA"):
        throughput.main(["--arms", "sa", "--L", "16", "--taus", "2", "4"])


def test_time_steps_slope_and_degraded_flag():
    clock = FakeClock()

    def run(tau, seed):
        clock.now += 0.2 + 1e-3 * tau

    ms, degraded = throughput.time_steps(run, (30, 90), clock=clock)
    assert np.isclose(ms, 1.0) and not degraded
    times = {10: 3.0, 30: 1.0}  # a negative slope: the single shot

    def wild(tau, seed):
        clock.now += times[tau]

    ms, degraded = throughput.time_steps(wild, (10, 30), clock=clock)
    assert degraded and np.isclose(ms, 1e3 * 1.0 / 30)


def test_cluster_arm_prints_bench_r05_keys_on_the_cpu(capsys):
    throughput.main(["--device", "cpu", "--L", "8", "--taus", "1", "2",
                     "--cluster"])
    (rec,) = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert rec["arm"] == "cluster" and rec["slices"] == 40
    assert rec["sites"] == 64 and rec["wolff_cluster_chains"] == 16
    for key in ("wolff_cluster_ms", "wolff_cluster_ms_per_chain",
                "sw_bath_sweep_ms", "sw_full_sweep_ms"):
        assert np.isfinite(rec[key]) and rec[key] > 0, key
    # the plain versions on the CPU launch no kernel
    assert rec["launches"] == {} and rec["nvidia_smi"] is None
