"""The port's drivers (montecarlosolvers_tpu_torch/examples/) on the CPU at
L = 8: `run()` of santoro_mst and dissipative_qa on a seeded torus, and
their command lines with the instance loader pointed at it."""

import numpy as np
import pytest
import torch

from montecarlosolvers_tpu_torch import schedules
from montecarlosolvers_tpu_torch.bench import mst
from montecarlosolvers_tpu_torch.examples import dissipative_qa, santoro_mst
from montecarlosolvers_tpu_torch.models import instances
from montecarlosolvers_tpu_torch.solvers import qmc, sa

torch.set_num_threads(1)


def torus():
    return instances.gaussian_torus(8, seed=0, device="cpu")


def test_dissipative_qa_run_shares_start_and_seed():
    """Every alpha starts from the same pre-annealed replicas with the same
    hash seed: alpha = 0 equals qmc.anneal without a lookuptable from that
    start (kernel B's route), alpha > 0 the bath engine's anneal with
    bath_lookuptable(P, alpha)."""
    problem = torus()
    rows = dissipative_qa.run(problem, 0.0, tau=12, slices=4, chains=3,
                              alphas=(0.0, 0.05), verbose=False)
    assert [r["alpha"] for r in rows] == [0.0, 0.05]
    gen = torch.Generator().manual_seed(0)
    s0 = sa.random_state(gen, 64, batch=(3,), device="cpu")
    s0 = sa.anneal(problem, schedules.pre_anneal_schedule(3.0, 1.0,
                                                          device="cpu"),
                   s0, gen, mcsteps=5)
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen))
    a = schedules.transverse_field(3.0, 1e-8, 12, device="cpu")
    for row, lut in ((rows[0], None),
                     (rows[1], schedules.bath_lookuptable(4, 0.05,
                                                          device="cpu"))):
        confs = qmc.anneal(problem, a, torch.ones_like(a), 0.25,
                           qmc.replicate(s0, 4),
                           torch.Generator().manual_seed(seed),
                           global_moves=True, lookuptable=lut)
        want = qmc.best_slice_energy(problem, confs).numpy()
        assert np.array_equal(row["energies"], want)
        assert row["eps_res"] == pytest.approx(float(want.mean()) / 64)
        assert row["eps_best"] == pytest.approx(float(want.min()) / 64)
    assert not np.array_equal(rows[0]["energies"], rows[1]["energies"])


def test_dissipative_qa_command_line(monkeypatch, capsys):
    monkeypatch.setattr(instances, "santoro_80x80",
                        lambda lattice=True: (torus(), -100.0))
    dissipative_qa.main(["--tau", "6", "--slices", "2", "--chains", "2",
                         "--alphas", "0", "0.01"])
    out = capsys.readouterr().out
    assert "P=2, tau=6, chains=2" in out
    assert out.count("eps_res=") == 2


def test_santoro_mst_run_writes_the_matrix(tmp_path):
    """run() is mst_benchmark on the given problem: every point on disk,
    complete, the summary of the directory."""
    results, complete = santoro_mst.run(
        torus(), 0.0, outdir=str(tmp_path), reps=2, taus=(8,),
        exps=((1, 2),), verbose=False)
    assert complete
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == [
        "CA_tau8.npz", "PT=1_P=2_tau8.npz"]
    summary = mst.summarize_dir(str(tmp_path), 64, 0.0, exps=((1, 2),))
    for name in ("CA", "PT=1_P=2"):
        assert np.array_equal(results[name]["eps"], summary[name]["eps"])


def test_santoro_mst_command_line_exits_3_while_work_remains(
        monkeypatch, tmp_path):
    """--budget 0 stops before the first point: exit code 3, nothing
    written; the same command without a budget finishes (the default taus
    and arms narrowed and capped by --max-tau, so the check stays
    small)."""
    monkeypatch.setattr(instances, "santoro_80x80",
                        lambda lattice=True: (torus(), 0.0))
    monkeypatch.setattr(mst, "DEFAULT_EXPS", ((1, 2),))
    monkeypatch.setattr(mst, "DEFAULT_TAUS", np.array([8, 32]))
    argv = ["--max-tau", "8", "--reps", "2", "--outdir", str(tmp_path)]
    with pytest.raises(SystemExit) as stop:
        santoro_mst.main(argv + ["--budget", "0"])
    assert stop.value.code == 3
    assert not list(tmp_path.glob("*.npz"))
    santoro_mst.main(argv)
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == [
        "CA_tau8.npz", "PT=1_P=2_tau8.npz"]
