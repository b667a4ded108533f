"""The port's utils (montecarlosolvers_tpu_torch/utils/) against the JAX
package's (montecarlosolvers_tpu/utils/), on the CPU.

- TestObservables, TestCheckpointedAnneal, TestFlipCounter and
  TestValidateState of tests/test_utils.py (its TestMstHarness is
  tests/test_torch_mst.py) and TestTTS of tests/test_observables_tts.py
  on the port (TestSuggestChains is not ported, with its function);
- every observable equal to JAX's on the same inputs, to rtol 1e-6;
- a resumed checkpointed anneal equal to the unbroken one bitwise, and
  the port resuming from a .npz that the JAX CheckpointedAnneal wrote;
- the profiling helpers: the counter, the timed region and a
  torch.profiler trace written to disk.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from montecarlosolvers_tpu.models import instances as jinst
from montecarlosolvers_tpu.solvers import sa as jsa
from montecarlosolvers_tpu.utils import checkpoint as jck
from montecarlosolvers_tpu.utils import observables as jobs
from montecarlosolvers_tpu_torch import convert, schedules, utils
from montecarlosolvers_tpu_torch.models import instances
from montecarlosolvers_tpu_torch.solvers import sa
from montecarlosolvers_tpu_torch.utils import observables as obs
from montecarlosolvers_tpu_torch.utils.checkpoint import (
    CheckpointedAnneal, generator, validate_state)
from montecarlosolvers_tpu_torch.utils.profiling import (FlipCounter, timed,
                                                         trace)

torch.set_num_threads(1)


class TestObservables:
    def test_magnetization_and_overlap(self, rng):
        s = torch.as_tensor(rng.choice([-1.0, 1.0], size=(4, 10)))
        m = obs.magnetization(s)
        assert m.shape == (4,)
        assert np.allclose(m.numpy(), s.numpy().mean(-1))
        q = obs.overlap(s[0], s[0])
        assert np.isclose(float(q), 1.0)
        Q = obs.replica_overlap_matrix(s)
        assert np.allclose(np.diag(Q.numpy()), 1.0)

    def test_residual_energy(self, rng):
        prob, _ = instances.random_2d_lattice(3, rng=rng, device="cpu")
        s = torch.ones(9)
        e = float(prob.energy(s))
        r = float(obs.residual_energy(prob, s, e - 9.0))
        assert np.isclose(r, 1.0)

    def test_acceptance_and_best(self, rng):
        a = torch.tensor([[1.0, 1.0, -1.0]])
        b = torch.tensor([[1.0, -1.0, -1.0]])
        assert np.isclose(float(obs.acceptance_fraction(a, b)[0]), 1 / 3)
        es = torch.tensor([[3.0], [1.0], [2.0]])
        best = obs.best_energy_so_far(es)
        assert list(best[:, 0].numpy()) == [3.0, 1.0, 1.0]


class TestTTS:
    def test_success_probability(self):
        es = np.array([-10.0, -9.0, -10.0, -8.0])
        assert obs.success_probability(es, -10.0) == 0.5
        assert obs.success_probability(torch.as_tensor(es), -10.0) == 0.5

    def test_tts_limits(self):
        assert obs.time_to_solution(100, 0.0) == float("inf")
        assert obs.time_to_solution(100, 1.0) == 100.0

    def test_tts_formula(self):
        tts = obs.time_to_solution(100, 0.5)
        assert np.isclose(tts, 100 * np.log(0.01) / np.log(0.5))
        assert obs.time_to_solution(100, 0.9) < tts


def _obs_cases(rng):
    jprob, _ = jinst.random_2d_lattice(4, rng=0)
    prob = convert.ising_from_arrays(jprob.nbr_idx, jprob.nbr_J, jprob.h,
                                     jprob.color_masks, device="cpu")
    s = rng.choice([-1.0, 1.0], size=(5, 16)).astype(np.float32)
    s2 = rng.choice([-1.0, 1.0], size=(5, 16)).astype(np.float32)
    mags = rng.uniform(-1, 1, size=50).astype(np.float32)
    es = rng.normal(size=(7, 5)).astype(np.float32)
    t = torch.as_tensor
    j = jnp.asarray
    return {
        "magnetization": ((t(s),), (j(s),)),
        "energy_per_spin": ((prob, t(s)), (jprob, j(s))),
        "residual_energy": ((prob, t(s), -20.0), (jprob, j(s), -20.0)),
        "overlap": ((t(s), t(s2)), (j(s), j(s2))),
        "replica_overlap_matrix": ((t(s),), (j(s),)),
        "acceptance_fraction": ((t(s), t(s2)), (j(s), j(s2))),
        "binder_cumulant": ((t(mags),), (j(mags),)),
        "best_energy_so_far": ((t(es),), (j(es),)),
        "success_probability": ((t(es[-1]), float(es[-1].min()) + 0.5),
                                (np.asarray(es[-1]),
                                 float(es[-1].min()) + 0.5)),
        "time_to_solution": ((100, 0.3), (100, 0.3)),
    }


@pytest.mark.parametrize("name", [
    "magnetization", "energy_per_spin", "residual_energy", "overlap",
    "replica_overlap_matrix", "acceptance_fraction", "binder_cumulant",
    "best_energy_so_far", "success_probability", "time_to_solution"])
def test_observable_equals_jax(rng, name):
    ours, theirs = _obs_cases(rng)[name]
    got = getattr(obs, name)(*ours)
    want = getattr(jobs, name)(*theirs)
    got = got.numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)
    assert np.shape(got) == np.shape(want)


def _lattice(rng):
    prob, _ = instances.random_2d_lattice(4, rng=rng, device="cpu")
    return prob


class TestCheckpointedAnneal:
    def test_resume_is_bit_identical(self, rng, tmp_path):
        prob = _lattice(rng)
        s0 = sa.random_state(torch.Generator().manual_seed(0), 16,
                             batch=(3,), device="cpu")
        sched = schedules.linear(2.0, 0.1, 100, device="cpu")

        def solver(seg, state, gen):
            return sa.anneal(prob, seg, state, gen)

        # uninterrupted run
        ck1 = CheckpointedAnneal(str(tmp_path / "a.npz"), segment=30)
        full = ck1.run(solver, sched, s0, seed=0)

        # interrupted run: stop after 2 segments, then resume
        ck2 = CheckpointedAnneal(str(tmp_path / "b.npz"), segment=30)
        state = s0
        for i in range(2):
            state = solver(sched[i * 30:(i + 1) * 30], state,
                           generator("cpu", 0, i))
            ck2._save(i + 1, state)
        resumed = ck2.run(solver, sched, s0, seed=0)
        assert torch.equal(full, resumed)
        # segments draw their own streams: another seed, another result
        other = CheckpointedAnneal(str(tmp_path / "c.npz"), segment=30).run(
            solver, sched, s0, seed=1)
        assert not torch.equal(full, other)

    def test_clear(self, tmp_path):
        ck = CheckpointedAnneal(str(tmp_path / "c.npz"))
        ck._save(1, np.zeros(3))
        assert os.path.exists(ck.path)
        ck.clear()
        assert not os.path.exists(ck.path)

    def test_validate_refuses_a_bad_segment(self, tmp_path):
        ck = CheckpointedAnneal(str(tmp_path / "v.npz"), segment=2,
                                validate="ising")
        with pytest.raises(ValueError):
            ck.run(lambda seg, s, g: s * 0.5, np.ones(4),
                   torch.ones(3), seed=0)
        assert not os.path.exists(ck.path)


def test_resumes_from_a_state_file_jax_wrote(tmp_path):
    """The JAX CheckpointedAnneal runs two of four segments and stops; the
    port's resumes from its .npz (same keys), runs segments 2 and 3 on
    its own generators, and equals the port's own solver applied to the
    JAX state."""
    jprob, _ = jinst.random_2d_lattice(4, rng=7)
    prob = convert.ising_from_arrays(jprob.nbr_idx, jprob.nbr_J, jprob.h,
                                     jprob.color_masks, device="cpu")
    sched = np.linspace(2.0, 0.1, 40).astype(np.float32)
    path = str(tmp_path / "run.npz")
    key = jax.random.key(3)
    s0 = jsa.random_state(key, 16, batch=(4,))
    jck_run = jck.CheckpointedAnneal(path, segment=10)
    state = s0
    for i in range(2):
        state = jsa.anneal(jprob, jnp.asarray(sched[i * 10:(i + 1) * 10]),
                           state, jax.random.fold_in(key, i))
        jck_run._save(i + 1, state)
    jax_state = np.array(state)

    def solver(seg, s, gen):
        return sa.anneal(prob, seg, s, gen)

    out = CheckpointedAnneal(path, segment=10).run(
        solver, sched, torch.zeros(4, 16), seed=5)
    want = torch.as_tensor(jax_state, dtype=torch.float32)
    for i in (2, 3):
        want = solver(torch.as_tensor(sched[i * 10:(i + 1) * 10]), want,
                      generator("cpu", 5, i))
    assert torch.equal(out, want)
    d = np.load(path)
    assert int(d["seg_idx"]) == 4 and np.array_equal(d["state"],
                                                     out.numpy())


class TestFlipCounter:
    def test_counts(self):
        fc = FlipCounter().start()
        fc.add_sweeps(10, 100, chains=4)
        fc.stop(torch.ones(2))
        assert fc.attempts == 4000
        assert fc.rate > 0


def test_timed_and_trace(tmp_path, capsys):
    with timed("region", fetch=torch.ones(3)) as box:
        torch.ones(8).sum()
    assert box["elapsed"] >= 0 and "region:" in capsys.readouterr().out
    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(64).cumsum(0)
    assert os.path.exists(tmp_path / "tr" / "trace.json")
    assert len(prof.key_averages()) > 0


class TestValidateState:
    def test_accepts_valid(self):
        validate_state(np.array([1.0, -1.0, 1.0]), "ising")
        validate_state(np.array([0.0, 1.5, np.pi]), "angles")
        validate_state(torch.tensor([1.0, -1.0]), "ising")

    def test_rejects_corruption(self):
        with pytest.raises(FloatingPointError):
            validate_state(np.array([1.0, np.nan]), "ising")
        with pytest.raises(ValueError):
            validate_state(np.array([1.0, 0.5]), "ising")
        with pytest.raises(ValueError):
            validate_state(np.array([4.0]), "angles")


def test_neighbor_table_cache_and_names(tmp_path):
    nbs = np.random.default_rng(0).normal(size=(5, 3, 2))
    utils.save_neighbor_table(str(tmp_path / "t.npy"), nbs)
    assert np.array_equal(utils.load_neighbor_table(str(tmp_path / "t.npy")),
                          nbs)
    from montecarlosolvers_tpu import utils as jutils

    assert set(utils.__all__) == set(jutils.__all__)
