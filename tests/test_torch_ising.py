"""The port's generic problem model against the JAX package's: neighbor
tables, greedy coloring, the class-major packed layout, the instance
generators and the energetics of `IsingProblem`.

The tables, fields, colors and layouts are built on the host in numpy by
both packages, so they must be equal exactly; energies, fields and dE are
float32 sums in another order, held to 1e-6 relative.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse
import torch

from montecarlosolvers_tpu import schedules as jsched
from montecarlosolvers_tpu.models import coloring as jcol
from montecarlosolvers_tpu.models import instances as jinst
from montecarlosolvers_tpu.models import ising as jising
from montecarlosolvers_tpu.models import lattice as jlattice
from montecarlosolvers_tpu.ops import packed as jpk
from montecarlosolvers_tpu.ops import piqmc as jpq
from montecarlosolvers_tpu_torch import convert
from montecarlosolvers_tpu_torch import schedules as tsched
from montecarlosolvers_tpu_torch.models import coloring as tcol
from montecarlosolvers_tpu_torch.models import instances as tinst
from montecarlosolvers_tpu_torch.models import ising as tising
from montecarlosolvers_tpu_torch.models import lattice as tlattice
from montecarlosolvers_tpu_torch.ops import packed as tpk
from montecarlosolvers_tpu_torch.ops import piqmc as tpq

torch.set_num_threads(1)


def assert_same_problem(port, jax_problem):
    """Tables, fields and coloring equal exactly, and the packed layout."""
    assert port.nspins == jax_problem.nspins
    assert port.maxnb == jax_problem.maxnb
    assert port.num_colors == jax_problem.num_colors
    for name in ("nbr_idx", "nbr_J", "h", "color_masks"):
        got = getattr(port, name).numpy()
        want = np.asarray(getattr(jax_problem, name))
        assert got.dtype == want.dtype, name
        assert np.array_equal(got, want), name
    assert np.array_equal(port.colors.numpy(),
                          np.argmax(np.asarray(jax_problem.color_masks),
                                    axis=0))
    tpg, jpg = tpk.build_packed(port), jpk.build_packed(jax_problem)
    assert tuple(tpg.perm.tolist()) == jpg.perm
    assert tpg.starts == jpg.starts
    assert tuple(tpg.starts_dev.tolist()) == jpg.starts
    for name in ("nbr_idx", "nbr_J", "h"):
        assert np.array_equal(getattr(tpg, name).numpy(),
                              np.asarray(getattr(jpg, name))), name


def _coo(seed, n=12, m=24):
    r = np.random.default_rng(seed)
    rows, cols, seen = [], [], set()
    while len(rows) < m:
        a, b = (int(x) for x in r.integers(0, n, size=2))
        if a != b and (min(a, b), max(a, b)) not in seen:
            seen.add((min(a, b), max(a, b)))
            rows.append(a)
            cols.append(b)
    diag = r.choice(n, size=5, replace=False)
    rows = np.array(rows + list(diag))
    cols = np.array(cols + list(diag))
    return n, rows, cols, r.normal(size=rows.shape)


@pytest.mark.parametrize("seed,maxnb", [(0, None), (1, 12), (2, None)])
def test_from_edges_matches_jax(seed, maxnb):
    n, rows, cols, vals = _coo(seed)
    port = tising.IsingProblem.from_edges(n, rows, cols, vals, maxnb=maxnb,
                                          device="cpu")
    assert_same_problem(port, jising.IsingProblem.from_edges(
        n, rows, cols, vals, maxnb=maxnb))


@pytest.mark.parametrize("container", ["dense", "dict", "scipy"])
def test_from_couplings_matches_jax(container):
    n, rows, cols, vals = _coo(3)
    J = np.zeros((n, n))
    J[rows, cols] = vals
    if container == "dict":
        J = {(int(a), int(b)): float(v) for a, b, v in zip(rows, cols, vals)}
    elif container == "scipy":
        J = scipy.sparse.coo_matrix(J)
    port = tising.IsingProblem.from_couplings(n, J, 12, device="cpu")
    assert_same_problem(port, jising.IsingProblem.from_couplings(n, J, 12))
    with pytest.raises(TypeError, match="Unsupported"):
        tising.generate_neighbors(n, [1.0, 2.0], 12)


def test_from_qubo_matches_jax_with_offset():
    r = np.random.default_rng(4)
    Q = r.normal(size=(6, 6))
    Q[r.random((6, 6)) < 0.4] = 0.0
    port, off = tising.IsingProblem.from_qubo(Q, device="cpu")
    jprob, joff = jising.IsingProblem.from_qubo(Q)
    assert off == joff
    assert_same_problem(port, jprob)
    # x Q x = H(s) + offset on every state, x = (1 - s) / 2
    bits = (np.arange(64)[:, None] >> np.arange(6)) & 1
    s = 1.0 - 2.0 * bits
    xqx = np.einsum("si,ij,sj->s", bits, Q, bits)
    h_s = port.energy(torch.as_tensor(s, dtype=torch.float32)).double()
    np.testing.assert_allclose(h_s.numpy() + off, xqx, atol=1e-5)


def test_from_neighbor_table_matches_jax():
    n, rows, cols, vals = _coo(5)
    nbs = tising.build_neighbor_table(n, rows, cols, vals, 12)
    assert np.array_equal(nbs, jising.build_neighbor_table(n, rows, cols,
                                                           vals, 12))
    assert_same_problem(tising.IsingProblem.from_neighbor_table(nbs,
                                                                device="cpu"),
                        jising.IsingProblem.from_neighbor_table(nbs))


def test_build_neighbor_table_overflow_raises():
    rows, cols = [0, 0, 0], [1, 2, 3]
    with pytest.raises(ValueError, match="more than maxnb=2"):
        tising.build_neighbor_table(4, rows, cols, [1.0, 1.0, 1.0], 2)
    with pytest.raises(ValueError, match="more than maxnb=2"):
        tising.IsingProblem.from_edges(4, rows, cols, [1.0] * 3, maxnb=2,
                                       device="cpu")


def test_generate_neighbors_savepath_roundtrip(tmp_path):
    n, rows, cols, vals = _coo(6)
    J = np.zeros((n, n))
    J[rows, cols] = vals
    path = tmp_path / "nbs.npy"
    nbs = tising.generate_neighbors(n, J, 12, savepath=str(path))
    assert np.array_equal(np.load(path), nbs)
    assert np.array_equal(nbs, jising.generate_neighbors(n, J, 12))


def test_bits_spins_and_classical_energy():
    bits = np.array([0, 1, 1, 0])
    assert tising.bits2spins(bits).tolist() == np.asarray(
        jising.bits2spins(bits)).tolist() == [1, -1, -1, 1]
    spins = np.array([1, -1, -1, 1])
    assert tising.spins2bits(spins).tolist() == np.asarray(
        jising.spins2bits(spins)).tolist() == [0, 1, 1, 0]
    n, rows, cols, vals = _coo(7)
    J = tinst.dense_matrix(n, rows, cols, vals)
    assert np.array_equal(J, jinst.dense_matrix(n, rows, cols, vals))
    s = np.random.default_rng(0).choice([-1.0, 1.0], size=n)
    e = tising.classical_ising_energy(s, scipy.sparse.csr_matrix(J))
    assert e == jising.classical_ising_energy(s, J)
    prob = tising.IsingProblem.from_edges(n, rows, cols, vals, device="cpu")
    assert abs(float(prob.energy(torch.as_tensor(s))) - e) < 1e-4


def test_coloring_matches_jax():
    n, rows, cols, vals = _coo(8, n=30, m=90)
    nbs = tising.build_neighbor_table(n, rows, cols, vals, 30)
    idx, val = nbs[:, :, 0].astype(np.int64), nbs[:, :, 1]
    for args in ((idx,), (idx, val)):
        got, k = tcol.greedy_coloring(*args)
        want, kj = jcol.greedy_coloring(*args)
        assert k == kj and got.dtype == np.int32
        assert np.array_equal(got, want)
    for length in (1, 2, 5, 8):
        got, k = tcol.ring_coloring(length)
        want, kj = jcol.ring_coloring(length)
        assert k == kj and np.array_equal(got, want)
        masks, km = tpq.slice_color_masks(length)
        jmasks, jkm = jpq.slice_color_masks(length)
        assert km == jkm and np.array_equal(masks, jmasks)


@pytest.mark.parametrize("L,kind,maxnb", [(6, "torus", None),
                                          (5, "torus", None),
                                          (6, "open_fields", None),
                                          (4, "torus", 7)])
def test_to_generic_matches_jax(L, kind, maxnb):
    if kind == "torus":
        r = np.random.default_rng(L)
        jr, jd = r.normal(size=(L, L)), r.normal(size=(L, L))
        jlat = jlattice.LatticeProblem.from_planes(jr, jd)
    else:
        jlat = jinst.random_2d_lattice(L, rng=L, with_fields=True,
                                       lattice=True)[0]
    lat = convert.lattice_from_arrays(
        np.asarray(jlat.j_right), np.asarray(jlat.j_down),
        np.asarray(jlat.h_plane), device="cpu")
    port = lat.to_generic(maxnb)
    assert_same_problem(port, jlat.to_generic(maxnb))
    s = np.random.default_rng(1).choice([-1.0, 1.0], size=(3, L * L))
    st = torch.as_tensor(s, dtype=torch.float32)
    np.testing.assert_allclose(port.energy(st).numpy(), lat.energy(st).numpy(),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(lat.delta_e(st).numpy(), np.asarray(
        jlat.delta_e(jnp.asarray(s, dtype=jnp.float32))))
    assert np.array_equal(tlattice.checkerboard_masks(L),
                          jlattice.checkerboard_masks(L))


def test_santoro_generic_and_lattice_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("MCS_TPU_INSTANCE_DIR", str(tmp_path))
    _, (rows, cols, vals) = jinst.random_2d_lattice(80, rng=2)
    tinst.save_triplets(tmp_path / "santoro_80x80.txt", rows, cols, vals)
    port, e_gs = tinst.santoro_80x80(device="cpu")
    jprob, je_gs = jinst.santoro_80x80()
    assert e_gs == je_gs and port.maxnb == 4
    assert_same_problem(port, jprob)
    port5 = tinst.santoro_80x80(maxnb=5, device="cpu")[0]
    assert_same_problem(port5, jinst.santoro_80x80(maxnb=5)[0])
    lat = tinst.santoro_80x80(lattice=True, device="cpu")[0]
    assert isinstance(lat, tinst.LatticeProblem)


# name -> build(module, extra kwargs): the same call on the port's
# instances module (with device="cpu") and on the JAX package's
_GENERATORS = {
    "random_2d_lattice": lambda m, d: m.random_2d_lattice(5, rng=1, **d),
    "random_2d_lattice_fields_pm1": lambda m, d: m.random_2d_lattice(
        4, rng=2, dist="pm1", with_fields=True, **d),
    "random_2d_lattice_maxnb": lambda m, d: m.random_2d_lattice(
        4, rng=3, maxnb=6, **d),
    "random_3d_lattice": lambda m, d: m.random_3d_lattice(4, rng=0, **d),
    "random_3d_lattice_open_gauss": lambda m, d: m.random_3d_lattice(
        3, rng=1, dist="gauss", periodic=False, **d),
    "random_graph": lambda m, d: m.random_graph(30, 70, rng=4, **d),
    "random_graph_fields": lambda m, d: m.random_graph(
        20, 60, rng=5, with_fields=True, **d),
    "chimera_graph": lambda m, d: m.chimera_graph(2, rng=0, **d),
    "chimera_graph_gauss": lambda m, d: m.chimera_graph(
        3, 2, t=2, rng=1, dist="gauss", **d),
    "sk_model_sparse": lambda m, d: m.sk_model(7, rng=2, dense=False, **d),
}


@pytest.mark.parametrize("name", list(_GENERATORS))
def test_instance_generators_match_jax(name):
    build = _GENERATORS[name]
    port, (rows, cols, vals) = build(tinst, {"device": "cpu"})
    jprob, (jrows, jcols, jvals) = build(jinst, {})
    for got, want in ((rows, jrows), (cols, jcols), (vals, jvals)):
        assert np.array_equal(np.asarray(got), np.asarray(want))
    assert isinstance(port, tising.IsingProblem)
    assert_same_problem(port, jprob)


def test_instance_sizes_and_refusals():
    assert tinst.chimera_graph(16, rng=0, device="cpu")[0].num_colors == 3
    # sk_model's default is the DenseProblem (tests/test_torch_dense.py)
    dense = tinst.sk_model(8, rng=0, device="cpu")[0]
    assert type(dense).__name__ == "DenseProblem" and dense.nspins == 8
    with pytest.raises(ValueError):
        tinst.random_3d_lattice(2, dist="cauchy", device="cpu")


def test_save_triplets_roundtrip(tmp_path):
    n, rows, cols, vals = _coo(9)
    tinst.save_triplets(tmp_path / "t.txt", rows, cols, vals)
    jinst.save_triplets(tmp_path / "j.txt", rows, cols, vals)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    r, c, v = tinst.load_triplets(tmp_path / "t.txt")
    assert np.array_equal(r, rows) and np.array_equal(c, cols)
    np.testing.assert_allclose(v, vals, rtol=1e-9)


@pytest.mark.parametrize("graph", ["random_graph_fields", "chimera_graph",
                                   "random_3d_lattice"])
def test_energetics_match_jax(graph):
    build = _GENERATORS[graph]
    port, _ = build(tinst, {"device": "cpu"})
    jprob, _ = build(jinst, {})
    s = np.random.default_rng(3).choice([-1.0, 1.0], size=(2, 3, port.nspins))
    s = s.astype(np.float32)
    st, sj = torch.as_tensor(s), jnp.asarray(s)
    scale = float(np.abs(np.asarray(jprob.nbr_J)).sum()
                  + np.abs(np.asarray(jprob.h)).sum())
    for fn in ("energy", "local_fields", "delta_e"):
        np.testing.assert_allclose(
            getattr(port, fn)(st).numpy(), np.asarray(getattr(jprob, fn)(sj)),
            rtol=1e-6, atol=1e-6 * scale, err_msg=fn)
    # the packed energy of the packed state is the same energy
    tpg, jpg = tpk.build_packed(port), jpk.build_packed(jprob)
    ps = tpk.pack_state(tpg, st)
    assert torch.equal(tpk.unpack_state(tpg, ps), st)
    np.testing.assert_allclose(
        tpk.packed_energy(tpg, ps).numpy(),
        np.asarray(jpk.packed_energy(jpg, jpk.pack_state(jpg, sj))),
        rtol=1e-6, atol=1e-6 * scale)


def test_blocks_are_independent_sets():
    prob = tinst.random_graph(2000, 12000, rng=0, device="cpu")[0]
    assert prob.num_colors == 9  # more than the JAX MAX_PACKED_COLORS
    assert tpk.supports_packed(prob)
    assert not tpk.supports_packed(tinst.gaussian_torus(4, device="cpu"))
    pg = tpk.build_packed(prob)
    nbr = pg.nbr_idx.numpy()
    own = np.arange(prob.nspins)[:, None]
    block = np.searchsorted(np.array(pg.starts), np.arange(prob.nspins),
                            side="right") - 1
    same = (block[nbr] == block[:, None]) & (nbr != own)
    assert not same.any()
    assert np.array_equal(pg.as_problem().colors.numpy(), block)


def test_ising_from_arrays_crosses_bitwise():
    jprob = jinst.chimera_graph(2, rng=3)[0]
    port = convert.ising_from_arrays(
        np.asarray(jprob.nbr_idx), np.asarray(jprob.nbr_J),
        np.asarray(jprob.h), np.asarray(jprob.color_masks), device="cpu")
    assert_same_problem(port, jprob)
    with pytest.raises(ValueError, match="one class"):
        convert.ising_from_arrays(np.zeros((2, 1)), np.zeros((2, 1)),
                                  np.zeros(2), np.ones((2, 2), dtype=bool),
                                  device="cpu")


def test_geometric_schedule():
    got = tsched.geometric(3.0, 0.01, 17, device="cpu")
    want = np.asarray(jsched.geometric(3.0, 0.01, 17))
    assert got.dtype == torch.float32 and got.shape == (17,)
    np.testing.assert_allclose(got.numpy(), want, rtol=4e-7)


@pytest.mark.parametrize("build", [
    lambda: tinst.random_graph(10, 12, rng=0),
    lambda: tinst.chimera_graph(1, rng=0),
    lambda: tinst.random_3d_lattice(2, rng=0),
    lambda: tising.IsingProblem.from_edges(2, [0], [1], [1.0]),
    lambda: convert.ising_from_arrays(np.zeros((2, 1)), np.zeros((2, 1)),
                                      np.zeros(2), np.eye(2, dtype=bool)),
    lambda: tsched.geometric(1.0, 0.1, 3),
], ids=["random_graph", "chimera_graph", "random_3d_lattice", "from_edges",
        "ising_from_arrays", "geometric"])
def test_device_none_means_the_card(monkeypatch, build):
    """With no device given, the generic problem is built on the CUDA card;
    on a host without one that raises rather than carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
