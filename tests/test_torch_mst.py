"""The port's MST driver (montecarlosolvers_tpu_torch/bench/mst.py) on the
CPU: resume after a budget stop, bitwise; the file layout the JAX driver's
`summarize_dir` reads; cached points and chunks.

An 8x8 Gaussian torus, taus (4, 16), arms CA, PT=2.5_P=2 and PT=2.5_P=5,
3 reps in chunks of 2. PT = 2.5 keeps each PIQMC chunk's pre-anneal (T
from 3.0 down to PT in steps of 0.05, 100 sweeps each) at 1100 sweeps, a
quarter of PT = 1's: on the CPU that pre-anneal, not tau or the reps, is
what a chunk costs. A stop is made deterministic by a stand-in clock that
advances one second at every reading, so a budget of k seconds stops the
run at the k-th reading of the clock, between points or between PIQMC
chunks.
"""

import json

import numpy as np
import pytest
import torch

from montecarlosolvers_tpu.bench import mst as jmst
from montecarlosolvers_tpu_torch.bench import mst
from montecarlosolvers_tpu_torch.models import instances

torch.set_num_threads(1)

TAUS, EXPS, REPS, CHUNK = (4, 16), ((2.5, 2), (2.5, 5)), 3, 2
ARMS = ("CA",) + tuple(f"PT={pt}_P={p}" for pt, p in EXPS)
POINTS = [f"{name}_tau{tau}" for name in ARMS for tau in TAUS]


def run(outdir, **kw):
    """The matrix in `outdir`, at chunks of CHUNK chains."""
    problem = instances.gaussian_torus(8, seed=0, device="cpu")
    kw = dict(dict(taus=TAUS, reps=REPS, exps=EXPS, verbose=False), **kw)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(mst, "PIQMC_CHUNK", CHUNK)
        return mst.mst_benchmark(problem, 0.0, outdir=str(outdir), **kw)


def energies(outdir):
    return {p: np.load(outdir / f"{p}.npz")["energies"] for p in POINTS}


@pytest.fixture(scope="module")
def unbroken(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("unbroken")
    results, complete = run(outdir)
    assert complete
    return outdir, results


class SteppingClock:
    """time.time() that returns 0, 1, 2, ... at successive readings."""

    def __init__(self):
        self.now = -1.0

    def time(self):
        self.now += 1.0
        return self.now


@pytest.mark.parametrize("budget", [2, 9, 14])
def test_resume_after_budget_stop_is_bitwise(unbroken, tmp_path,
                                             monkeypatch, budget):
    """A run stopped by its budget (between points or between the chunks of
    a PIQMC point) and run again without one writes bitwise the energies
    of an unbroken run in another directory, and the same summary."""
    outdir, results = unbroken
    with monkeypatch.context() as m:
        m.setattr(mst, "time", SteppingClock())
        _, complete = run(tmp_path, budget_s=budget)
    assert not complete
    done = sorted(p.name for p in tmp_path.glob("*.npz"))
    assert len([d for d in done if ".chunk" not in d]) < len(POINTS)
    resumed, complete = run(tmp_path)
    assert complete
    want, got = energies(outdir), energies(tmp_path)
    for p in POINTS:
        assert np.array_equal(got[p], want[p]), p
    assert not list(tmp_path.glob("*.chunk*.npz"))
    for name, v in results.items():
        assert np.array_equal(resumed[name]["eps"], v["eps"])


def test_budget_stop_leaves_chunks_that_resume(tmp_path, monkeypatch,
                                               unbroken):
    """A stop inside a PIQMC point keeps its finished chunks, named by
    their first rep, and the resumed point reads them rather than
    recomputing them."""
    with monkeypatch.context() as m:
        m.setattr(mst, "time", SteppingClock())
        _, complete = run(tmp_path, budget_s=9)
    assert not complete
    chunks = sorted(p.name for p in tmp_path.glob("*.chunk*.npz"))
    assert chunks and all(c.endswith(".chunk0.npz") for c in chunks)
    calls = []
    real = mst.point_generator

    def counted(*key):
        calls.append(key)
        return real(*key)

    monkeypatch.setattr(mst, "point_generator", counted)
    run(tmp_path)
    prefix = chunks[0].split(".chunk")[0]
    crc = mst.point_key(0, *prefix.rsplit("_tau", 1))[1]
    assert (0, crc, 0) not in calls and (0, crc, CHUNK) in calls
    assert np.array_equal(energies(tmp_path)[prefix],
                          energies(unbroken[0])[prefix])


def test_second_run_finds_every_point_cached(unbroken, monkeypatch):
    """A run over a finished directory computes nothing."""
    outdir, results = unbroken

    def refuse(*args, **kwargs):
        raise AssertionError("a cached point was computed again")

    monkeypatch.setattr(mst, "sa_arm", refuse)
    monkeypatch.setattr(mst, "piqmc_arm", refuse)
    again, complete = run(outdir)
    assert complete
    for name, v in results.items():
        assert np.array_equal(again[name]["eps"], v["eps"])


def test_jax_summarize_dir_reads_the_port_directory(unbroken):
    """The JAX driver's summarize_dir on the port's directory returns the
    port's summary, and both write the same summary.json."""
    outdir, results = unbroken
    port = json.loads((outdir / "summary.json").read_text())
    got = jmst.summarize_dir(str(outdir), 64, 0.0, exps=EXPS)
    assert set(got) == set(results) == set(ARMS)
    for name, v in results.items():
        for k in ("tau", "total_sweeps", "eps"):
            assert np.array_equal(got[name][k], v[k]), (name, k)
    assert json.loads((outdir / "summary.json").read_text()) == port
    for p in POINTS:
        d = np.load(outdir / f"{p}.npz")
        assert set(d.files) == {"energies", "eps"}
        assert d["energies"].shape == (REPS,)


def test_points_depend_on_the_seed_and_not_on_the_order(unbroken, tmp_path):
    """A point's energies come from (seed, name, tau) alone: one point run
    alone equals it inside the matrix; another seed gives others."""
    outdir, _ = unbroken
    problem = instances.gaussian_torus(8, seed=0, device="cpu")
    (pt, p), name, tau = EXPS[1], ARMS[2], TAUS[1]
    alone = mst.piqmc_arm(problem, tau, REPS, mst.point_key(0, name, tau),
                          pt=pt, slices=p, chunk=CHUNK)
    assert np.array_equal(alone, energies(outdir)[f"{name}_tau{tau}"])
    other = mst.piqmc_arm(problem, tau, REPS, mst.point_key(1, name, tau),
                          pt=pt, slices=p, chunk=CHUNK)
    assert not np.array_equal(alone, other)
    tau = TAUS[0]
    sa_alone = mst.sa_arm(problem, tau, REPS, mst.point_key(0, "CA", tau))
    assert np.array_equal(sa_alone, energies(outdir)[f"CA_tau{tau}"])


def test_cached_chunk_of_another_size_is_refused(tmp_path):
    problem = instances.gaussian_torus(8, seed=0, device="cpu")
    prefix = str(tmp_path / "PT=1_P=2_tau8")
    np.savez(f"{prefix}.chunk0.npz", energies=np.zeros(3))
    with pytest.raises(ValueError, match="chunk size"):
        mst.piqmc_arm(problem, 8, REPS, mst.point_key(0, "PT=1_P=2", 8),
                      slices=2, chunk=CHUNK, cache_prefix=prefix)


def test_default_grid_is_the_references():
    """The default tau grid is the reference's 14 points, 1.02e7 sweeps an
    arm, and the arms are P = 5, 10, 20, 40 at PT = 1."""
    assert np.array_equal(mst.DEFAULT_TAUS, jmst.DEFAULT_TAUS)
    assert len(mst.DEFAULT_TAUS) == 14
    assert 1.02e7 <= int(mst.DEFAULT_TAUS.sum()) < 1.03e7
    assert mst.DEFAULT_EXPS == jmst.DEFAULT_EXPS


def test_max_tau_cuts_the_grid(tmp_path):
    """max_tau drops the taus above it, here all but the first."""
    results, complete = run(tmp_path, max_tau=10, exps=())
    assert complete and list(results) == ["CA"]
    assert list(results["CA"]["tau"]) == [TAUS[0]]


def test_plot_needs_matplotlib_only_when_called(unbroken, tmp_path):
    """plot_results imports matplotlib inside the function: the module
    imports without it."""
    pytest.importorskip("matplotlib")
    _, results = unbroken
    mst.plot_results(results, path=str(tmp_path / "p.png"), x="tau")
    assert (tmp_path / "p.png").is_file()

