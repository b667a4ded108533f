"""The port's command line (montecarlosolvers_tpu_torch/__main__.py) on
the CPU: its method list against the port's solve() table and the JAX
CLI's, `solve` on a triplet file against the port's solve() with the same
seed, its --out npz, --lattice and --negate, and `bench` handing its own
arguments to bench/throughput.py."""

import json

import numpy as np
import pytest
import torch

from montecarlosolvers_tpu.__main__ import SOLVE_METHODS as JAX_METHODS
from montecarlosolvers_tpu_torch.__main__ import SOLVE_METHODS, main
from montecarlosolvers_tpu_torch.models import instances
from montecarlosolvers_tpu_torch.models.ising import IsingProblem
from montecarlosolvers_tpu_torch.models.lattice import LatticeProblem
from montecarlosolvers_tpu_torch.solvers.api import _METHOD_KW, solve

torch.set_num_threads(1)


def _json_line(out):
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


def test_cli_methods_match_solve_table_and_jax():
    assert set(SOLVE_METHODS) == set(_METHOD_KW)
    assert tuple(SOLVE_METHODS) == tuple(JAX_METHODS)


@pytest.fixture
def ring(tmp_path):
    # 4-spin ferromagnetic ring, 1-indexed triplets, ground state -4
    inst = tmp_path / "ring.txt"
    inst.write_text("1 2 -1\n2 3 -1\n3 4 -1\n4 1 -1\n")
    return inst


def test_cli_solve_smoke(ring, tmp_path, capsys):
    out = tmp_path / "samples.npz"
    rc = main(["solve", str(ring), "--method", "sa", "--num-reads", "8",
               "--sweeps", "50", "--out", str(out), "--device", "cpu"])
    assert rc == 0
    res = _json_line(capsys.readouterr().out)
    assert res["best_energy"] == -4.0
    data = np.load(out)
    assert data["samples"].shape == (8, 4)
    assert data["energies"].min() == -4.0


@pytest.mark.parametrize("method,extra", [
    ("sa", []), ("piqmc", ["--slices", "4"]), ("pt", [])])
def test_cli_solve_equals_solve(tmp_path, capsys, method, extra):
    """The JSON's best and mean energy and the npz are solve()'s on the
    same problem with the same seed; --negate flips the couplings."""
    _, (rows, cols, vals) = instances.random_2d_lattice(3, rng=1,
                                                        device="cpu")
    inst = tmp_path / "glass.txt"
    instances.save_triplets(str(inst), rows, cols, vals)
    out = tmp_path / "o.npz"
    rc = main(["solve", str(inst), "--method", method, "--num-reads", "6",
               "--sweeps", "40", "--seed", "3", "--negate", "--out",
               str(out), "--device", "cpu"] + extra)
    assert rc == 0
    res = _json_line(capsys.readouterr().out)
    prob = IsingProblem.from_edges(9, rows, cols, -vals, device="cpu")
    kw = {"slices": 4} if method == "piqmc" else {}
    want = solve(prob, method=method, num_reads=6, sweeps=40, seed=3, **kw)
    assert res["best_energy"] == want.best_energy
    assert res["mean_energy"] == float(want.energies.mean())
    assert res["num_reads"] == len(want)
    data = np.load(out)
    assert np.array_equal(data["samples"], want.samples)
    assert np.array_equal(data["energies"], want.energies)


def test_cli_solve_lattice(tmp_path, capsys):
    """--lattice L builds the LatticeProblem (the split engines)."""
    lat = instances.gaussian_torus(4, 0, device="cpu")
    g = lat.to_generic()
    J = np.zeros((16, 16))
    idx, val = g.nbr_idx.numpy(), g.nbr_J.numpy()
    for i in range(16):
        for k in range(idx.shape[1]):
            if idx[i, k] > i and val[i, k] != 0:
                J[i, idx[i, k]] = val[i, k]
    rows, cols = np.nonzero(J)
    inst = tmp_path / "torus.txt"
    instances.save_triplets(str(inst), rows, cols, J[rows, cols])
    rc = main(["solve", str(inst), "--lattice", "4", "--num-reads", "4",
               "--sweeps", "30", "--device", "cpu"])
    assert rc == 0
    res = _json_line(capsys.readouterr().out)
    prob = LatticeProblem.from_edges(4, rows, cols, J[rows, cols],
                                     device="cpu")
    want = solve(prob, num_reads=4, sweeps=30, seed=0)
    assert res["best_energy"] == want.best_energy


def test_cli_bench_help_and_arguments(capsys, monkeypatch):
    """`bench --help` is the bench's own help; `bench` passes the
    arguments after it to bench/throughput.py, never sys.argv."""
    with pytest.raises(SystemExit) as e:
        main(["bench", "--help"])
    assert e.value.code == 0
    assert "--arms" in capsys.readouterr().out
    from montecarlosolvers_tpu_torch.bench import throughput

    seen = []
    monkeypatch.setattr(throughput, "main", seen.append)
    monkeypatch.setattr("sys.argv", ["x", "solve", "inst.txt"])
    assert main(["bench", "--light", "--device", "cpu"]) == 0
    assert seen == [["--light", "--device", "cpu"]]
    assert main(["bench"]) == 0 and seen[-1] == []


def test_cli_rejects_unknown_arguments(ring):
    with pytest.raises(SystemExit) as e:
        main(["solve", str(ring), "--bogus"])
    assert e.value.code == 2
