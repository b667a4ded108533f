"""The port's plain split-checkerboard engines against the JAX oracles.

`sa_split_anneal_ref` and `qmc_split_anneal_ref` are the plain forms of
the CUDA kernels A and B, and on a CPU tensor the kernel wrappers run them.
They must equal `oracle_anneal` / `oracle_qmc` (tests/test_pallas_split.py)
BITWISE on the spins. Torch and XLA round some float32 transcendentals
differently in the last ulp, which flips an accept decision only when dE
lies inside that ulp of the threshold; on a mismatch the assertion reports
the first diverging step and the smallest threshold margin there, so such
a case can be told from a fault.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_pallas_split import oracle_anneal, oracle_qmc
from montecarlosolvers_tpu.models import instances as jinst
from montecarlosolvers_tpu.models.lattice import LatticeProblem as JLattice
from montecarlosolvers_tpu.ops import pallas_split
from montecarlosolvers_tpu_torch import convert
from montecarlosolvers_tpu_torch import schedules as tsched
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import counter_rng as cr
from montecarlosolvers_tpu_torch.ops import split as tsplit
from montecarlosolvers_tpu_torch.ops import split_kernels as sk

torch.set_num_threads(1)


def periodic(L, seed):
    r = np.random.default_rng(seed)
    return JLattice.from_planes(r.normal(size=(L, L)), r.normal(size=(L, L)))


def open_lattice(L, seed):
    return jinst.random_2d_lattice(L, rng=seed, lattice=True)[0]


def port_of(lat):
    return convert.lattice_from_arrays(
        np.asarray(lat.j_right), np.asarray(lat.j_down),
        np.asarray(lat.h_plane), col_wrap=lat.col_wrap, device="cpu")


def sa_divergence(lat, sched, s0, seed):
    """First step whose prefix anneal differs from the oracle's, and the
    smallest |-T log1p(-u) - dE| over that step's sites (port state)."""
    for k in range(1, len(sched) + 1):
        ref = np.asarray(oracle_anneal(lat, sched[:k], jnp.asarray(s0), seed))
        out = sk.anneal_lattice_split(port_of(lat), torch.from_numpy(sched[:k]),
                                      torch.from_numpy(s0), seed).numpy()
        if not np.array_equal(ref, out):
            break
    else:
        return "no divergence"
    tl = port_of(lat)
    sl = tsplit.build_split(tl)
    prev = sk.anneal_lattice_split(tl, torch.from_numpy(sched[:k - 1]),
                                   torch.from_numpy(s0), seed)
    a, _ = tsplit.pack_classical(sl, prev)
    de = -2.0 * a * (tsplit.spatial_field(sl.w_ab[:, 0], _, sl.K)
                     + sl.h_ab[0])
    u = cr.uniform01(cr.counter(seed, k - 1, 0),
                     cr.sa_uids(a.shape[0], sl.nh, 0, "cpu"))
    margin = (-torch.tensor(sched[k - 1]) * torch.log1p(-u) - de).abs()
    return (f"first diverging step {k - 1}: {(ref != out).sum()} spins; "
            f"smallest phase-A margin {float(margin.min()):.3g}")


@pytest.mark.parametrize(
    "lat_fn,L,chains,steps",
    [
        (lambda: open_lattice(16, 0), 16, 2, 24),
        (lambda: periodic(16, 1), 16, 2, 64),
        (lambda: open_lattice(32, 2), 32, 4, 32),
        (lambda: periodic(32, 3), 32, 4, 24),
        # Nh = 50: the TPU kernel rejects it (Nh % 128), the port takes it
        (lambda: periodic(10, 4), 10, 3, 48),
    ],
)
def test_sa_plain_equals_oracle(lat_fn, L, chains, steps):
    lat = lat_fn()
    rng = np.random.default_rng(L + chains)
    s0 = rng.choice([-1.0, 1.0], size=(chains, L * L)).astype(np.float32)
    sched = np.linspace(3.0, 0.1, steps).astype(np.float32)
    ref = np.asarray(oracle_anneal(lat, sched, jnp.asarray(s0), seed=11))
    out = sk.anneal_lattice_split(port_of(lat), torch.from_numpy(sched),
                                  torch.from_numpy(s0), 11)
    assert out.dtype == torch.float32
    out = out.numpy()
    assert np.array_equal(ref, out), sa_divergence(lat, sched, s0, 11)


def test_sa_plain_equals_pallas_interpreter():
    lat = periodic(16, 1)
    rng = np.random.default_rng(0)
    s0 = rng.choice([-1.0, 1.0], size=(2, 256)).astype(np.float32)
    sched = np.linspace(3.0, 0.1, 24).astype(np.float32)
    ref = np.asarray(pallas_split.anneal_lattice_split(
        lat, sched, jnp.asarray(s0), seed=11, interpret=True))
    out = sk.anneal_lattice_split(port_of(lat), torch.from_numpy(sched),
                                  torch.from_numpy(s0), 11).numpy()
    assert np.array_equal(ref, out)


@pytest.mark.parametrize(
    "lat_fn,L,P,gm,bscale",
    [
        (lambda: periodic(16, 1), 16, 4, True, 1.0),
        (lambda: open_lattice(16, 0), 16, 4, False, 1.0),
        (lambda: open_lattice(32, 2), 32, 6, True, 1.0),  # odd Q = 3
        (lambda: periodic(16, 2), 16, 4, True, 0.7),  # rounded B*s*f
        (lambda: periodic(10, 3), 10, 2, True, 1.0),  # Q = 1
    ],
)
def test_qmc_plain_equals_oracle(lat_fn, L, P, gm, bscale):
    lat = lat_fn()
    rng = np.random.default_rng(0)
    confs = rng.choice([-1.0, 1.0], size=(2, P, L * L)).astype(np.float32)
    a = np.linspace(2.5, 1e-8, 12).astype(np.float32)
    b = np.full_like(a, bscale)
    ref = np.asarray(oracle_qmc(lat, a, b, 1.0 / P, jnp.asarray(confs),
                                seed=9, global_moves=gm))
    out = sk.anneal_lattice_qmc_split(
        port_of(lat), torch.from_numpy(a), torch.from_numpy(b), 1.0 / P,
        torch.from_numpy(confs), 9, global_moves=gm).numpy()
    if not np.array_equal(ref, out):
        first = next(k for k in range(1, len(a) + 1) if not np.array_equal(
            np.asarray(oracle_qmc(lat, a[:k], b[:k], 1.0 / P,
                                  jnp.asarray(confs), 9, gm)),
            sk.anneal_lattice_qmc_split(
                port_of(lat), torch.from_numpy(a[:k]),
                torch.from_numpy(b[:k]), 1.0 / P, torch.from_numpy(confs),
                9, global_moves=gm).numpy()))
        pytest.fail(f"{(ref != out).sum()} spins differ; first diverging "
                    f"step {first - 1}")


def test_wrappers_route_by_device():
    lat = port_of(periodic(16, 5))
    sl = tsplit.build_split(lat)
    a = torch.ones((2, sl.nh))
    sched = tsched.linear(1.0, 0.0, 3, device="cpu")
    # a CPU tensor runs the plain version and launches nothing
    _build.reset_launches()
    out = sk.sa_split_anneal(sl, sched, a, a, 0)
    ref = sk.sa_split_anneal_ref(sl, sched, a, a, 0)
    assert all(torch.equal(x, y) for x, y in zip(out, ref))
    assert not any(_build.LAUNCHES.values())
    # a device with neither form raises instead of falling back
    meta = torch.ones((2, sl.nh), device="meta")
    with pytest.raises(ValueError, match="no split engine"):
        sk.sa_split_anneal(sl, sched, meta, meta, 0)
    q = torch.ones((2, 2, sl.nh), device="meta")
    with pytest.raises(ValueError, match="no split engine"):
        sk.qmc_split_anneal(sl, sched, sched, 1.0, (q, q, q, q), 0, True)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from torch.utils import cpp_extension

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").iterdir())


def test_ferromagnets_reach_ground_state():
    # J = -1 everywhere (H = sum J s s): E_gs = -2 L^2 on the torus
    L, P = 16, 4
    ferro = convert.lattice_from_arrays(-np.ones((L, L)), -np.ones((L, L)),
                                        np.zeros((L, L)), device="cpu")
    rng = np.random.default_rng(2)
    s0 = torch.from_numpy(rng.choice([-1.0, 1.0], size=(4, L * L))
                          .astype(np.float32))
    out = sk.anneal_lattice_split(
        ferro, tsched.linear(3.0, 0.0, 200, device="cpu"), s0, 7)
    assert float(ferro.energy(out).min()) == -2.0 * L * L
    confs = torch.from_numpy(rng.choice([-1.0, 1.0], size=(2, P, L * L))
                             .astype(np.float32))
    a = tsched.transverse_field(3.0, 1e-8, 150, device="cpu")
    out = sk.anneal_lattice_qmc_split(ferro, a, torch.ones_like(a), 1.0 / P,
                                      confs, 5, global_moves=True)
    assert float(ferro.energy(out).min()) == -2.0 * L * L
