"""The port's lattice, schedules and split layout against the JAX package.

Weights, packing and fields are copies of couplings or exact sums of
products with +/-1, so they must match EXACTLY. Energies are float32 sums
of 2N terms taken in another order than XLA's, so they match within
rtol 1e-6 plus an absolute 1e-6 times the sum of the terms' magnitudes
(the float32 error bound of a reordered sum).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from montecarlosolvers_tpu import schedules as jsched
from montecarlosolvers_tpu.models import instances as jinst
from montecarlosolvers_tpu.models.lattice import LatticeProblem as JLattice
from montecarlosolvers_tpu.ops import split as jsplit
from montecarlosolvers_tpu_torch import convert
from montecarlosolvers_tpu_torch import schedules as tsched
from montecarlosolvers_tpu_torch.models import instances as tinst
from montecarlosolvers_tpu_torch.ops import split as tsplit
from montecarlosolvers_tpu_torch.solvers import sa as tsa
from montecarlosolvers_tpu_torch.solvers import svmc as tsvmc

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)


def jax_lattice(L, periodic, seed):
    if periodic:
        r = np.random.default_rng(seed)
        return JLattice.from_planes(r.normal(size=(L, L)),
                                    r.normal(size=(L, L)),
                                    r.normal(size=(L, L)) * 0.1)
    return jinst.random_2d_lattice(L, rng=seed, with_fields=True,
                                   lattice=True)[0]


def port_of(lat):
    return convert.lattice_from_arrays(
        np.asarray(lat.j_right), np.asarray(lat.j_down),
        np.asarray(lat.h_plane), col_wrap=lat.col_wrap, device="cpu")


def spins(shape, seed):
    r = np.random.default_rng(seed)
    return r.choice([-1.0, 1.0], size=shape).astype(np.float32)


def energy_tol(lat):
    """1e-6 of the L1 mass of the energy's terms: every bond and field."""
    return 1e-6 * float(np.abs(np.asarray(lat.j_right)).sum()
                        + np.abs(np.asarray(lat.j_down)).sum()
                        + np.abs(np.asarray(lat.h_plane)).sum())


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("L", [4, 10, 16, 32])
def test_build_split_exact(L, periodic):
    lat = jax_lattice(L, periodic, seed=L)
    js = jsplit.build_split(lat)
    ts = tsplit.build_split(port_of(lat))
    assert ts.nslots == js.w_ab.shape[0] == (7 if periodic else 5)
    assert np.array_equal(ts.w_ab.numpy(), np.asarray(js.w_ab))
    assert np.array_equal(ts.h_ab.numpy(), np.asarray(js.h_ab))
    assert tuple(ts.idx_a.tolist()) == js.idx_a
    assert tuple(ts.idx_b.tolist()) == js.idx_b


@pytest.mark.parametrize("L,periodic", [(10, True), (16, False)])
def test_pack_unpack(L, periodic):
    lat = jax_lattice(L, periodic, seed=1)
    js = jsplit.build_split(lat)
    ts = tsplit.build_split(port_of(lat))
    s = spins((3, L * L), 2)
    a, b = tsplit.pack_classical(ts, torch.from_numpy(s))
    ja, jb = jsplit.pack_classical(js, jnp.asarray(s))
    assert np.array_equal(a.numpy(), np.asarray(ja))
    assert np.array_equal(b.numpy(), np.asarray(jb))
    assert np.array_equal(tsplit.unpack_classical(ts, a, b).numpy(), s)
    c = spins((2, 6, L * L), 3)
    qs = tsplit.pack_qmc(ts, torch.from_numpy(c))
    for q, jq in zip(qs, jsplit.pack_qmc(js, jnp.asarray(c))):
        assert q.is_contiguous()
        assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(tsplit.unpack_qmc(ts, *qs).numpy(), c)


@pytest.mark.parametrize("L,periodic", [(10, True), (16, False), (32, True)])
def test_energies_match_jax(L, periodic):
    lat = jax_lattice(L, periodic, seed=5)
    tl = port_of(lat)
    tol = energy_tol(lat)
    s = spins((4, L * L), 6)
    ref = np.asarray(lat.energy(jnp.asarray(s)))
    np.testing.assert_allclose(tl.energy(torch.from_numpy(s)).numpy(), ref,
                               rtol=1e-6, atol=tol)
    # local fields: 4 products with +/-1 plus h, summed in the same order
    assert np.array_equal(tl.local_fields(torch.from_numpy(s)).numpy(),
                          np.asarray(lat.local_fields(jnp.asarray(s))))
    js, ts = jsplit.build_split(lat), tsplit.build_split(tl)
    a, b = tsplit.pack_classical(ts, torch.from_numpy(s))
    np.testing.assert_allclose(
        tsplit.classical_energy_split(ts, a, b).numpy(),
        np.asarray(jsplit.classical_energy_split(
            js, *jsplit.pack_classical(js, jnp.asarray(s)))),
        rtol=1e-6, atol=tol)
    np.testing.assert_allclose(
        tsplit.classical_energy_split(ts, a, b).numpy(), ref,
        rtol=1e-6, atol=tol)
    c = spins((2, 4, L * L), 7)
    qs = tsplit.pack_qmc(ts, torch.from_numpy(c))
    np.testing.assert_allclose(
        tsplit.qmc_slice_energies_split(ts, *qs).numpy(),
        np.asarray(jsplit.qmc_slice_energies_split(
            js, *jsplit.pack_qmc(js, jnp.asarray(c)))),
        rtol=1e-6, atol=tol)


def test_from_edges_and_instances_match_jax():
    jl, (rows, cols, vals) = jinst.random_2d_lattice(12, rng=4,
                                                     with_fields=True,
                                                     lattice=True)
    tl, (trows, tcols, tvals) = tinst.random_2d_lattice(12, rng=4,
                                                        with_fields=True,
                                                        lattice=True,
                                                        device="cpu")
    assert np.array_equal(vals, tvals)
    for name in ("j_right", "j_down", "h_plane"):
        assert np.array_equal(getattr(tl, name).numpy(),
                              np.asarray(getattr(jl, name)))
    assert tl.col_wrap == jl.col_wrap is False
    # a periodic wrap bond in the row and in the column
    L = 4
    lat = tinst.LatticeProblem.from_edges(L, [3, 12], [0, 0], [0.5, -0.25],
                                          device="cpu")
    assert lat.col_wrap
    assert float(lat.j_right[0, L - 1]) == 0.5
    assert float(lat.j_down[L - 1, 0]) == -0.25
    with pytest.raises(ValueError, match="not a 2D-lattice bond"):
        tinst.LatticeProblem.from_edges(L, [0], [5], [1.0], device="cpu")
    # the seeded torus is the JAX tests' periodic_lattice
    r = np.random.default_rng(0)
    torus = tinst.gaussian_torus(8, seed=0, device="cpu")
    assert np.array_equal(torus.j_right.numpy(),
                          r.normal(size=(8, 8)).astype(np.float32))
    assert np.array_equal(torus.j_down.numpy(),
                          r.normal(size=(8, 8)).astype(np.float32))


def test_santoro_lookup_and_triplets(tmp_path, monkeypatch):
    monkeypatch.setenv("MCS_TPU_INSTANCE_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tinst.santoro_80x80(device="cpu")
    # an 80x80 open lattice in the reference's 1-indexed triplet format;
    # the loader negates couplings like the JAX one
    _, (rows, cols, vals) = jinst.random_2d_lattice(80, rng=0)
    path = tmp_path / "santoro_80x80.txt"
    np.savetxt(path, np.stack([rows + 1, cols + 1, vals], axis=1))
    tl, e_gs = tinst.santoro_80x80(lattice=True, device="cpu")
    jl, je_gs = jinst.santoro_80x80(lattice=True)
    assert e_gs == je_gs
    for name in ("j_right", "j_down", "h_plane"):
        assert np.array_equal(getattr(tl, name).numpy(),
                              np.asarray(getattr(jl, name)))


_GEN = torch.Generator().manual_seed(0)
_PLANE = np.zeros((4, 4))


@pytest.mark.parametrize("build", [
    lambda: tinst.gaussian_torus(4),
    lambda: tinst.random_2d_lattice(4, rng=0),
    lambda: tinst.LatticeProblem.from_planes(_PLANE, _PLANE),
    lambda: tinst.LatticeProblem.from_edges(4, [0], [1], [1.0]),
    lambda: convert.lattice_from_arrays(_PLANE, _PLANE, _PLANE),
    lambda: convert.state_from_numpy(_PLANE),
    lambda: convert.lookuptable_from_numpy(np.ones(3)),
    lambda: tsched.linear(1.0, 0.0, 3),
    lambda: tsched.transverse_field(3.0, 1e-8, 3),
    lambda: tsched.pre_anneal_schedule(3.0, 2.9),
    lambda: tsched.bath_lookuptable(4, 0.1),
    lambda: tsa.random_state(_GEN, 16),
    lambda: tsvmc.random_state(_GEN, 16),
], ids=["gaussian_torus", "random_2d_lattice", "from_planes", "from_edges",
        "lattice_from_arrays", "state_from_numpy", "lookuptable_from_numpy",
        "linear", "transverse_field", "pre_anneal_schedule",
        "bath_lookuptable", "sa.random_state", "svmc.random_state"])
def test_device_none_means_the_card(monkeypatch, build):
    """With no device given, the port builds on the CUDA card; on a host
    without one it raises rather than carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()


def test_state_from_numpy_keeps_layout():
    c = spins((2, 4, 36), 1)
    t = convert.state_from_numpy(c, device="cpu")
    assert t.dtype == torch.float32 and t.shape == (2, 4, 36)
    assert np.array_equal(t.numpy(), c)
    assert convert.state_from_numpy(c[:, 0].astype(np.float64),
                                    device="cpu").dtype == torch.float32


def test_schedules_match_jax():
    # within one float32 rounding of the schedule's scale: the port rounds
    # each point once from float64, XLA's linspace rounds several times
    for start, stop, num in ((3.0, 0.0, 2000), (3.0, 1e-8, 1000),
                             (3.0, 0.1, 200), (2.5, 1e-8, 12)):
        scale = max(abs(start), abs(stop))
        np.testing.assert_allclose(
            tsched.linear(start, stop, num, device="cpu").numpy(),
            np.asarray(jsched.linear(start, stop, num)),
            rtol=0, atol=2 * EPS32 * scale)
        assert tsched.linear(start, stop, num, device="cpu")[-1] \
            == np.float32(stop)
    np.testing.assert_allclose(
        tsched.transverse_field(3.0, 1e-8, 100, device="cpu").numpy(),
        np.asarray(jsched.transverse_field(3.0, 1e-8, 100)),
        rtol=0, atol=6 * EPS32)
    for pt in (1.0, 2.5, 2.9):
        assert tsched.pre_anneal_schedule(3.0, pt, device="cpu").shape \
            == jsched.pre_anneal_schedule(3.0, pt).shape
    x = tsched.linear(1.0, 0.0, 5, device="cpu")
    assert np.array_equal(tsched.expand_mcsteps(x, 3, "cpu").numpy(),
                          np.asarray(jsched.expand_mcsteps(x.numpy(), 3)))
    # J_perp: log(tanh) near tanh = 1 magnifies the last-ulp difference of
    # torch's and XLA's tanh; bound it by a few ulps of T_eff / 2
    g = tsched.transverse_field(3.0, 1e-8, 1000, device="cpu")
    for teff in (1.0, 0.3, 2.9):
        np.testing.assert_allclose(
            tsched.jperp(g, teff).numpy(),
            np.asarray(jsched.jperp(jnp.asarray(g.numpy()), teff)),
            rtol=1e-6, atol=4 * EPS32 * teff)
