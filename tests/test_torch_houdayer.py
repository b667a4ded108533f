"""The port's Houdayer move and lattice labelers (montecarlosolvers_tpu_torch/
ops/cluster.py) against the JAX package's (montecarlosolvers_tpu/ops/
cluster.py) on the JAX functions' own draws, and the plain version of
csrc/houdayer.cu (`houdayer_move_ref`) against its invariants; the plain
version of the move on the packed engine's state (`houdayer_move_packed_ref`)
against the unpack, move and repack it stands for, and the cluster kernel's
table of bonds (`houdayer_table`) against the problem's couplings.

Each problem is built by the JAX package and carried across by
montecarlosolvers_tpu_torch/convert.py from its numpy arrays. Every
comparison with JAX is bitwise: the spins, the flip masks and the labels
are exact, since the labelling is integer work and the moves flip signs.
The energy invariant of a move (E1 + E2 kept) is checked in float64 to
1e-9 of the couplings' scale.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from montecarlosolvers_tpu.models import instances as jinst
from montecarlosolvers_tpu.models import lattice as jlattice
from montecarlosolvers_tpu.ops import cluster as jc
from montecarlosolvers_tpu_torch import convert
from montecarlosolvers_tpu_torch.models import instances as tinst
from montecarlosolvers_tpu_torch.models.lattice import LatticeProblem
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import cluster as tc
from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck
from montecarlosolvers_tpu_torch.ops import counter_rng as cr
from montecarlosolvers_tpu_torch.ops import packed as tpk

torch.set_num_threads(1)

PAIRS = 5


def _t(x):
    return torch.as_tensor(np.array(x))


def _ising(jprob):
    return convert.ising_from_arrays(
        *(np.asarray(getattr(jprob, a))
          for a in ("nbr_idx", "nbr_J", "h", "color_masks")), device="cpu")


def _torus_edges(L, rng):
    """A periodic L x L Gaussian torus as the JAX LatticeProblem and its
    (rows, cols, vals) edges, each wrap bond once."""
    r = np.random.default_rng(rng)
    jr, jd = r.normal(size=(L, L)), r.normal(size=(L, L))
    lat = jlattice.LatticeProblem.from_planes(jr, jd)
    rows, cols, vals = [], [], []
    for y in range(L):
        for x in range(L):
            rows += [y * L + x, y * L + x]
            cols += [y * L + (x + 1) % L, ((y + 1) % L) * L + x]
            vals += [jr[y, x], jd[y, x]]
    return lat, (np.array(rows), np.array(cols), np.array(vals))


# name -> (JAX generic problem, grid shape, its edges)
def _case(name):
    if name == "2d_open":
        jp, edges = jinst.random_2d_lattice(6, rng=1)
        return jp, (6, 6), edges
    if name == "2d_periodic":
        lat, edges = _torus_edges(6, 2)
        return lat.to_generic(), (6, 6), edges
    if name == "3d_periodic":
        jp, edges = jinst.random_3d_lattice(4, rng=3)
        return jp, (4, 4, 4), edges
    jp, edges = jinst.random_3d_lattice(4, rng=4, periodic=False)
    return jp, (4, 4, 4), edges


CASES = ("2d_open", "2d_periodic", "3d_periodic", "3d_open")


def _replicas(n, seed):
    r = np.random.default_rng(seed)
    return (r.choice([-1.0, 1.0], size=(PAIRS, n)).astype(np.float32),
            r.choice([-1.0, 1.0], size=(PAIRS, n)).astype(np.float32))


@pytest.mark.parametrize("name", CASES)
def test_houdayer_sweep_matches_jax(name):
    jp, _, _ = _case(name)
    port = _ising(jp)
    n = jp.nspins
    s1, s2 = _replicas(n, 10)
    keys = jax.random.split(jax.random.key(5), PAIRS)
    o1, o2, flip = jax.vmap(lambda a, b, k: jc.houdayer_sweep(jp, a, b, k))(
        jnp.asarray(s1), jnp.asarray(s2), keys)
    coins = jax.vmap(lambda k: jax.random.bernoulli(k, 0.5, (n,)))(keys)
    g1, g2, gflip = tc.houdayer_sweep(port, _t(s1), _t(s2), _t(coins))
    for got, want in ((g1, o1), (g2, o2), (gflip, flip)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert gflip.any()


@pytest.mark.parametrize("name", CASES)
def test_grid_bonds_and_grid_sweep_match_jax(name):
    _, shape, (rows, cols, vals) = _case(name)
    jm = jc.grid_bonds_from_edges(shape, rows, cols, vals)
    tm = tc.grid_bonds_from_edges(shape, rows, cols, vals, device="cpu")
    assert all(np.array_equal(t.numpy(), np.asarray(j))
               for t, j in zip(tm, jm))
    n = int(np.prod(shape))
    s1, s2 = _replicas(n, 11)
    keys = jax.random.split(jax.random.key(6), PAIRS)
    o1, o2, flip = jax.vmap(
        lambda a, b, k: jc.houdayer_sweep_grid(jm, a, b, k))(
        jnp.asarray(s1), jnp.asarray(s2), keys)
    coins = jax.vmap(lambda k: jax.random.bernoulli(k, 0.5, (n + 1,)))(keys)
    g1, g2, gflip = tc.houdayer_sweep_grid(tm, _t(s1), _t(s2), _t(coins))
    for got, want in ((g1, o1), (g2, o2), (gflip, flip)):
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_grid_bonds_refuse_a_non_grid_edge():
    with pytest.raises(ValueError, match="not a unit grid step"):
        tc.grid_bonds_from_edges((4, 4), [0], [5], [1.0], device="cpu")


@pytest.mark.parametrize("name", CASES)
def test_grid_and_generic_forms_label_alike(name):
    """Both forms label each q = -1 component by its least flat index: the
    grid relaxation and the neighbour-table relaxation agree on every q =
    -1 site, so one coin array moves both alike."""
    jp, shape, (rows, cols, vals) = _case(name)
    port = _ising(jp)
    masks = tc.grid_bonds_from_edges(shape, rows, cols, vals, device="cpu")
    n = port.nspins
    s1, s2 = (_t(x) for x in _replicas(n, 12))
    q_neg = (s1 * s2) < 0
    nbr = port.nbr_idx.long()
    active = (port.nbr_J != 0) & q_neg[..., None] & q_neg[..., nbr]
    generic = tc.label_components(active, nbr)
    qg = q_neg.reshape((PAIRS,) + shape)
    act = tuple(m & qg & torch.roll(qg, -1, 1 + ax)
                for ax, m in enumerate(masks))
    init = torch.where(qg, torch.arange(n).reshape(shape), n)
    grid = tc._label_components_grid(act, init).reshape(PAIRS, n)
    assert torch.equal(grid[q_neg], generic[q_neg])
    coins = torch.rand((PAIRS, n + 1), generator=torch.Generator().manual_seed(
        0)) < 0.5
    a = tc.houdayer_sweep(port, s1, s2, coins[:, :n])
    b = tc.houdayer_sweep_grid(masks, s1, s2, coins)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_lattice_generic_ids_are_the_raveled_grid_index():
    """A LatticeProblem's to_generic() numbers site (r, c) r * L + c, so the
    Houdayer kernel on it equals JAX's grid form on the lattice's planes
    (pt.py:339-346 builds the masks from j_down and j_right)."""
    lat, _ = _torus_edges(6, 7)
    port = convert.lattice_from_arrays(lat.j_right, lat.j_down, lat.h_plane,
                                       lat.col_wrap, device="cpu")
    g = port.to_generic()
    masks = (port.j_down != 0, port.j_right != 0)
    s1, s2 = (_t(x) for x in _replicas(36, 13))
    a1, a2, flipped = tc.houdayer_move_ref(g, s1, s2, 9, 3)
    coins = tc.houdayer_coins(9, 3, PAIRS, 36, "cpu")
    coins = torch.cat([coins, torch.zeros((PAIRS, 1), dtype=torch.bool)], 1)
    b1, b2, flip = tc.houdayer_sweep_grid(masks, s1, s2, coins)
    assert torch.equal(a1, b1) and torch.equal(a2, b2)
    assert torch.equal(flipped, flip.sum(-1, dtype=torch.int32))
    # the energies of the generic form are the lattice's, site for site
    s = _t(_replicas(36, 14)[0])
    assert torch.allclose(g.energy(s), port.energy(s), atol=1e-5)


@pytest.mark.parametrize("name", ("2d_periodic", "3d_periodic"))
def test_houdayer_move_keeps_overlap_and_pair_energy(name):
    jp, _, _ = _case(name)
    port = _ising(jp)
    n = port.nspins
    s1, s2 = (_t(x) for x in _replicas(n, 15))
    a, b, flipped = tc.houdayer_move_ref(port, s1, s2, 21, 4)
    assert torch.equal(a * b, s1 * s2)
    assert bool((flipped > 0).any())
    assert torch.equal(flipped, (a != s1).sum(-1, dtype=torch.int32))

    def e64(s):
        J = np.zeros((n, n))
        nbr, nJ = port.nbr_idx.numpy(), port.nbr_J.numpy().astype(np.float64)
        for i in range(n):
            for m in range(nbr.shape[1]):
                J[i, nbr[i, m]] += nJ[i, m]
        x = s.numpy().astype(np.float64)
        return 0.5 * np.einsum("pi,ij,pj->p", x, J, x) + x @ port.h.numpy()

    scale = float(port.nbr_J.abs().sum() + port.h.abs().sum())
    assert np.abs(e64(a) + e64(b) - e64(s1) - e64(s2)).max() <= 1e-9 * scale


def test_houdayer_coins_are_the_sampler_stream():
    coins = tc.houdayer_coins(7, 5, 3, 10, "cpu")
    uid = torch.arange(30, dtype=torch.int32)
    u = cr.uniform01(cr.counter(7, 5, cr.SAMPLER_INDEX + cr.HOUDAYER), uid)
    assert torch.equal(coins.reshape(-1), u < 0.5)
    # the kernel's wrapper takes the plain version on CPU tensors and
    # counts no launch
    jp, _, _ = _case("3d_periodic")
    port = _ising(jp)
    s1, s2 = (_t(x) for x in _replicas(port.nspins, 16))
    _build.reset_launches()
    got = ck.houdayer_move(port, s1, s2, 7, 5)
    want = tc.houdayer_move_ref(port, s1, s2, 7, 5)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert _build.LAUNCHES["houdayer"] == 0


@pytest.mark.parametrize("axis", (-1, -2))
def test_seg_min_scan_matches_jax(axis):
    r = np.random.default_rng(20 + axis)
    vals = r.integers(0, 100, size=(3, 7, 7)).astype(np.int32)
    links = r.random((3, 7, 7)) < 0.6
    links[0] = True  # a full ring
    want = jc._seg_min_scan(jnp.asarray(vals), jnp.asarray(links), axis)
    got = tc._seg_min_scan(_t(vals), _t(links), axis)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_label_components_lattice_and_grid_match_jax():
    r = np.random.default_rng(30)
    L = 8
    left = r.random((4, L, L)) < 0.55
    up = r.random((4, L, L)) < 0.55
    init = np.where(r.random((4, L, L)) < 0.1, -1,
                    np.arange(L * L).reshape(L, L)).astype(np.int32)
    want = jc._label_components_lattice(jnp.asarray(left), jnp.asarray(up),
                                        jnp.asarray(init))
    got = tc._label_components_lattice(_t(left), _t(up), _t(init))
    assert np.array_equal(got.numpy(), np.asarray(want))
    masks = tuple(r.random((5, 6)) < 0.6 for _ in range(2))
    init = np.arange(30, dtype=np.int32).reshape(5, 6)
    want = jc._label_components_grid(tuple(jnp.asarray(m) for m in masks),
                                     jnp.asarray(init))
    got = tc._label_components_grid(tuple(_t(m) for m in masks), _t(init))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("periodic", (True, False))
def test_classical_sw_sweep_lattice_matches_jax(periodic):
    L = 6
    if periodic:
        jlat = _torus_edges(L, 40)[0]
    else:
        jlat = jinst.random_2d_lattice(L, rng=41, with_fields=True,
                                       lattice=True)[0]
    port = convert.lattice_from_arrays(jlat.j_right, jlat.j_down,
                                       jlat.h_plane, jlat.col_wrap,
                                       device="cpu")
    s = np.random.default_rng(42).choice([-1.0, 1.0], size=(PAIRS, L * L)
                                         ).astype(np.float32)
    keys = jax.random.split(jax.random.key(43), PAIRS)
    temp = 1.3
    want = jax.vmap(lambda x, k: jc.classical_sw_sweep_lattice(
        jlat, x, k, temp))(jnp.asarray(s), keys)

    def draws(k):
        k_sp, k_h, k_coin = jax.random.split(k, 3)
        return (jax.random.uniform(k_sp, (2, L, L)),
                jax.random.uniform(k_h, (L, L)),
                jax.random.bernoulli(k_coin, 0.5, (L * L,)))
    u_sp, u_h, coins = (_t(x) for x in jax.vmap(draws)(keys))
    got = tc.classical_sw_sweep_lattice(port, _t(s), u_sp, u_h, coins, temp)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # classical_sw_sweep routes a LatticeProblem here, as the JAX one does
    assert isinstance(port, LatticeProblem)
    again = tc.classical_sw_sweep(port, _t(s), u_sp, u_h, coins, temp)
    assert torch.equal(again, got)


def _icm_state(prob, batch, M, seed):
    """A packed engine's ICM state: (batch * 2 * M, N) spins in the
    packing's column order, and a permuted (batch, 2, M) replica_of_rung."""
    r = np.random.default_rng(seed)
    pg = tpk.build_packed(prob)
    full = torch.as_tensor(r.choice([-1.0, 1.0], size=(
        batch * 2 * M, prob.nspins)).astype(np.float32))
    ror = torch.as_tensor(np.stack([np.stack([r.permutation(M)
                                              for _ in range(2)])
                                    for _ in range(batch)]))
    return pg, tpk.pack_state(pg, full).contiguous(), ror


@pytest.mark.parametrize("graph,batch,M,pair0", [
    ("glass", 1, 6, 0), ("glass", 2, 4, 7), ("chimera", 1, 5, 100003),
    ("chimera", 3, 3, 2)])
def test_in_place_move_is_the_unpacked_move(graph, batch, M, pair0):
    """houdayer_move_packed's plain version (the route that moves the
    packed engine's state in place on the card) is the composition ICM ran
    before it: the state unpacked to site order, the rung-aligned pairs
    gathered through ror, houdayer_move_ref, the replicas put back and the
    state repacked; bitwise, with a permuted ror and pair0 != 0."""
    prob = (tinst.random_3d_lattice(4, rng=11, device="cpu")[0]
            if graph == "glass"
            else tinst.chimera_graph(2, rng=3, dist="gauss", device="cpu")[0])
    pg, state, ror = _icm_state(prob, batch, M, 17)
    n = prob.nspins
    got, flipped = ck.houdayer_move_packed_ref(prob, pg, state, ror, 29, 6,
                                               pair0)
    full = tpk.unpack_state(pg, state).reshape(batch, 2, M, n)
    s1 = torch.stack([full[b, 0, ror[b, 0]] for b in range(batch)])
    s2 = torch.stack([full[b, 1, ror[b, 1]] for b in range(batch)])
    a, c, want_f = tc.houdayer_move_ref(prob, s1.reshape(-1, n),
                                        s2.reshape(-1, n), 29, 6, pair0)
    a, c = a.reshape(batch, M, n), c.reshape(batch, M, n)
    for b in range(batch):
        full[b, 0, ror[b, 0]] = a[b]
        full[b, 1, ror[b, 1]] = c[b]
    want = tpk.pack_state(pg, full.reshape(-1, n))
    assert torch.equal(got, want) and torch.equal(flipped, want_f)
    assert int(flipped.sum()) > 0 and not torch.equal(got, state)
    # the wrapper takes the plain version on CPU tensors
    _build.reset_launches()
    moved, f2 = ck.houdayer_move_packed(prob, pg, state, ror, 29, 6, pair0)
    assert torch.equal(moved, got) and torch.equal(f2, flipped)
    assert not any(_build.LAUNCHES.values())


@pytest.mark.parametrize("graph", ("glass", "chimera", "torus"))
def test_houdayer_table_holds_each_bond_once(graph):
    """houdayer_table: row id the smaller-id neighbours of site id by a
    nonzero coupling, each undirected bond once, from its larger id, the
    same from the site-order problem and from its packing."""
    prob = {"glass": lambda: tinst.random_3d_lattice(4, rng=2,
                                                     device="cpu")[0],
            "chimera": lambda: tinst.chimera_graph(2, rng=1, device="cpu")[0],
            "torus": lambda: tinst.gaussian_torus(5, 1, device="cpu")
            .to_generic()}[graph]()
    table = ck.houdayer_table(prob)
    assert torch.equal(table, ck.houdayer_table(tpk.build_packed(prob)))
    nbr, J = prob.nbr_idx.numpy(), prob.nbr_J.numpy()
    want = {(max(i, int(j)), min(i, int(j)))
            for i in range(prob.nspins) for j, x in zip(nbr[i], J[i])
            if x != 0.0 and j != i}
    got = [(i, int(j)) for i, row in enumerate(table.numpy()) for j in row
           if j >= 0]
    assert len(got) == len(set(got)) and set(got) == want
