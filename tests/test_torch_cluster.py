"""The port's cluster updates (montecarlosolvers_tpu_torch/ops/cluster.py)
against the JAX package's (montecarlosolvers_tpu/ops/cluster.py) on the
same draws, and the counter-hash plain anneals (the plain versions of the
cluster kernels) against loops of the plain functions.

Every function gets the JAX function's inputs and the uniforms, ints and
coins the JAX function draws, split from its key exactly as it splits
them; the spins must agree bitwise and the labels exactly. One jitted JAX
call serves all chains of a case (a vmap over chains, each with its key).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from montecarlosolvers_tpu import schedules as jsched
from montecarlosolvers_tpu.models import instances as jinst
from montecarlosolvers_tpu.models import lattice as jlattice
from montecarlosolvers_tpu.models.ising import IsingProblem as JIsing
from montecarlosolvers_tpu.ops import cluster as jc
from montecarlosolvers_tpu_torch import schedules as tsched
from montecarlosolvers_tpu_torch.models import instances as tinst
from montecarlosolvers_tpu_torch.models.ising import IsingProblem
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import cluster as tc
from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck
from montecarlosolvers_tpu_torch.ops import counter_rng as cr
from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
from montecarlosolvers_tpu_torch.ops import packed as tpk
from montecarlosolvers_tpu_torch.ops import piqmc as tpq

torch.set_num_threads(1)

CHAINS = 6


def _torus6():
    """The 80x80 benchmark torus's generic form, cut to L = 6."""
    lat = tinst.gaussian_torus(6, seed=0, device="cpu")
    jlat = jlattice.LatticeProblem.from_planes(lat.j_right.numpy(),
                                               lat.j_down.numpy())
    return lat.to_generic(), jlat.to_generic()


def _dup():
    """A dense symmetric J: every pair lands in two slots of each row."""
    r = np.random.default_rng(5)
    J = np.triu(r.normal(size=(6, 6)) * (r.random((6, 6)) < 0.6), 1)
    J = J + J.T
    return (IsingProblem.from_couplings(6, J, maxnb=10, device="cpu"),
            JIsing.from_couplings(6, J, maxnb=10))


GRAPHS = {
    "torus6": _torus6,
    "rg_fields": lambda: (
        tinst.random_graph(12, 24, rng=3, with_fields=True, device="cpu")[0],
        jinst.random_graph(12, 24, rng=3, with_fields=True)[0]),
    "chimera": lambda: (
        tinst.chimera_graph(1, rng=1, dist="gauss", device="cpu")[0],
        jinst.chimera_graph(1, rng=1, dist="gauss")[0]),
    "dup": _dup,
}
_CACHE = {}


def graphs(name):
    if name not in _CACHE:
        port, jprob = GRAPHS[name]()
        for a in ("nbr_idx", "nbr_J", "h", "color_masks"):
            assert np.array_equal(getattr(port, a).numpy(),
                                  np.asarray(getattr(jprob, a))), (name, a)
        _CACHE[name] = port, jprob
    return _CACHE[name]


def test_the_duplicate_table_has_duplicate_slots():
    nbr = graphs("dup")[0].nbr_idx.numpy()
    own = np.arange(nbr.shape[0])[:, None]
    real = np.where(nbr != own, nbr, -1)
    assert any(np.unique(r[r >= 0], return_counts=True)[1].max() == 2
               for r in real)


def _spins(shape, seed):
    return np.random.default_rng(seed).choice(
        [-1.0, 1.0], size=shape).astype(np.float32)


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ------------------------------------------------------------- Wolff cluster


WOLFF_CASES = [
    ("torus6", 1, "local", False), ("torus6", 2, "local", True),
    ("torus6", 3, "full", False), ("torus6", 8, "local", True),
    ("torus6", 8, "full", True), ("rg_fields", 1, "local", False),
    ("rg_fields", 3, "local", True), ("rg_fields", 2, "full", False),
    ("chimera", 8, "local", False), ("dup", 1, "local", False),
    ("dup", 2, "local", True), ("dup", 3, "full", False),
    ("torus6", 8, "local", "asym"), ("rg_fields", 5, "local", "asym"),
    ("torus6", 8, "full", "asym"), ("dup", 4, "local", "asym"),
]


@pytest.mark.parametrize("graph,P,rule,bath", WOLFF_CASES)
def test_wolff_update_matches_jax(graph, P, rule, bath):
    """wolff_update on the JAX package's draws; "asym" takes a bath table
    not symmetric in ring distance, where a pair may bond one way only:
    both BFS's then grow the seed's directed reach."""
    port, jprob = graphs(graph)
    n, maxnb = port.nspins, port.maxnb
    temp, gamma, b = 0.6, 0.9, 0.8
    teff = temp * P
    lut = (asymmetric_table(P, 0.4) if bath == "asym"
           else jsched.bath_lookuptable(P, 0.4) if bath else None)
    confs = _spins((CHAINS, P, n), P)
    keys = jax.random.split(jax.random.key(7 + P), CHAINS)
    out = jax.jit(jax.vmap(lambda c, k: jc.wolff_update(
        jprob, c, k, temp, gamma, b, rule=rule, lookuptable=lut)))(
            jnp.asarray(confs), keys)

    def draws(k):
        k_seed, k_sp, k_t, k_site, k_bath, k_acc = jax.random.split(k, 6)
        return (jax.random.randint(k_site, (), 0, P),
                jax.random.randint(k_seed, (), 0, n),
                jax.random.uniform(k_sp, (P, n, maxnb)),
                jax.random.uniform(k_t, (P, n)),
                jax.random.uniform(k_bath, (n, P, P)),
                jax.random.uniform(k_acc, ()))
    d = [_t(x) for x in jax.vmap(draws)(keys)]
    jp = np.float32(jsched.jperp(gamma, teff))
    got = tc.wolff_update(port, _t(confs), d[0], d[1], d[2], d[3],
                          d[4] if bath else None, d[5], teff, jp, b, rule,
                          None if lut is None else _t(lut))
    assert np.array_equal(got.numpy(), np.asarray(out))
    assert (got.numpy() != confs).any()


def test_classical_wolff_has_no_trotter_bonds():
    """Gamma = inf: J_perp is exactly 0 (of either sign), so the Trotter
    bond of P = 1 has probability 0 and the cluster is spatial."""
    jp = tsched.jperp(torch.tensor([float("inf")]), 1.3)
    assert float(jp) == 0.0 and float(jsched.jperp(jnp.inf, 1.3)) == 0.0
    s = torch.tensor([[[1.0, -1.0]]])
    de_t = -2.0 * jp * s * s
    assert not bool((tc.bond_prob(de_t, 1.3) > 0).any())


class TestSeedComponent:
    """tests/test_cluster_exact.py::TestSeedComponentSymmetry on the port."""

    def test_single_directed_activation_connects_both_endpoints(self):
        prob = IsingProblem.from_edges(2, [0], [1], [0.9], maxnb=2,
                                       device="cpu")
        active_sp = torch.zeros((2, 2, 2), dtype=torch.bool)
        slot = int(np.argmax(prob.nbr_idx[0].numpy() == 1))
        active_sp[0, 0, slot] = True
        for seed_spin in (0, 1):
            comp = tc.seed_component(0, seed_spin, active_sp, prob.nbr_idx,
                                     torch.zeros((2, 2), dtype=torch.bool))
            assert comp[0, 0] and comp[0, 1] and not comp[1].any()

    def test_temporal_ring_and_bath_edges_merge(self):
        prob = IsingProblem.from_edges(2, [0], [1], [0.9], maxnb=2,
                                       device="cpu")
        active_sp = torch.zeros((4, 2, 2), dtype=torch.bool)
        active_up = torch.zeros((4, 2), dtype=torch.bool)
        active_up[1, 1] = True
        active_bath = torch.zeros((2, 4, 4), dtype=torch.bool)
        active_bath[0, 0, 3] = active_bath[0, 3, 0] = True
        comp = tc.seed_component(1, 1, active_sp, prob.nbr_idx, active_up,
                                 active_bath)
        assert comp[1, 1] and comp[2, 1] and int(comp.sum()) == 2
        comp = tc.seed_component(3, 0, active_sp, prob.nbr_idx, active_up,
                                 active_bath)
        assert comp[0, 0] and comp[3, 0] and int(comp.sum()) == 2

    def test_duplicate_neighbor_slots_keep_endpoints_connected(self):
        J = np.array([[0.0, 0.45], [0.45, 0.0]])
        prob = IsingProblem.from_couplings(2, J, maxnb=2, device="cpu")
        assert int((prob.nbr_idx[0] == 1).sum()) == 2
        for slot in range(2):
            active_sp = torch.zeros((2, 2, 2), dtype=torch.bool)
            active_sp[0, 0, slot] = True
            for seed_spin in (0, 1):
                comp = tc.seed_component(
                    0, seed_spin, active_sp, prob.nbr_idx,
                    torch.zeros((2, 2), dtype=torch.bool))
                assert comp[0, 0] and comp[0, 1], (slot, seed_spin)

    @pytest.mark.parametrize("graph", ["dup", "chimera"])
    def test_symmetrize_spatial_matches_jax(self, graph):
        port, jprob = graphs(graph)
        r = np.random.default_rng(1)
        act = r.random((3,) + tuple(port.nbr_idx.shape)) < 0.3
        want = jc._symmetrize_spatial(jnp.asarray(act), jprob.nbr_idx)
        got = tc.symmetrize_spatial(torch.as_tensor(act), port.nbr_idx)
        assert np.array_equal(got.numpy(), np.asarray(want))


# -------------------------------------------------------------- line phases


# P = 65 and 128: past fk_line's one-word rows (P <= 64), where the card
# now follows line_phase_ref with rows of several words
SW_BATH_CASES = [("torus6", 2, True), ("torus6", 2, False),
                 ("torus6", 3, True), ("torus6", 8, False),
                 ("torus6", 8, True), ("rg_fields", 3, False),
                 ("rg_fields", 3, True), ("dup", 2, True),
                 ("torus6", 65, True), ("torus6", 128, False)]


@pytest.mark.parametrize("graph,P,per_slice_seeds", SW_BATH_CASES)
def test_sw_bath_sweep_matches_jax(graph, P, per_slice_seeds):
    """sw_bath_sweep (bath_cluster_phase or sw_full_phase a color) on the
    JAX package's per-phase keys; P = 2 doubles the ring bond of
    sw_full_phase."""
    port, jprob = graphs(graph)
    n = port.nspins
    temp, gamma, b = 0.5, 0.7, 0.9
    teff = temp * P
    lut = jsched.bath_lookuptable(P, 0.3)
    confs = _spins((CHAINS, P, n), 10 + P)
    keys = jax.random.split(jax.random.key(P), CHAINS)
    out = jax.jit(jax.vmap(lambda c, k: jc.sw_bath_sweep(
        jprob, c, k, temp, gamma, b, lut,
        per_slice_seeds=per_slice_seeds)))(jnp.asarray(confs), keys)

    def draws(key):
        seeds = None
        if not per_slice_seeds:
            key, kseed = jax.random.split(key)
            seeds = jax.random.randint(kseed, (n,), 0, P)
        phases = []
        for _ in range(port.num_colors):
            key, sub = jax.random.split(key)
            if per_slice_seeds:
                k_bath, k_t, k_acc = jax.random.split(sub, 3)
                phases.append((jax.random.uniform(k_bath, (n, P, P)),
                               jax.random.uniform(k_t, (P, n)),
                               jax.random.uniform(k_acc, (P, n))))
            else:
                k_bond, k_acc = jax.random.split(sub)
                phases.append((jax.random.uniform(k_bond, (n, P, P)),
                               jax.random.uniform(k_acc, (n,))))
        return phases, seeds
    phases, seeds = jax.vmap(draws)(keys)
    phases = [tuple(_t(x) for x in ph) for ph in phases]
    jp = np.float32(jsched.jperp(gamma, teff))
    got = tc.sw_bath_sweep(port, _t(confs), phases, teff, jp, b, _t(lut),
                           per_slice_seeds,
                           None if seeds is None else _t(seeds))
    assert np.array_equal(got.numpy(), np.asarray(out))
    assert (got.numpy() != confs).any()


def test_time_closure_is_reachability():
    r = np.random.default_rng(3)
    adj = r.random((5, 7, 7)) < 0.15
    got = tc.time_closure(torch.as_tensor(adj)).numpy()
    want = np.asarray(jc._time_closure(jnp.asarray(adj)))
    assert np.array_equal(got, want)
    for a in range(5):  # Floyd-Warshall on the host
        reach = adj[a] | np.eye(7, dtype=bool)
        for k in range(7):
            reach = reach | (reach[:, k:k + 1] & reach[k:k + 1, :])
        assert np.array_equal(got[a], reach)


def test_line_set_flip_de_matches_jax():
    port, jprob = graphs("rg_fields")
    confs = _spins((4, 12), 2)
    mask = np.random.default_rng(3).random((4, 12)) < 0.5
    field = np.asarray(jprob.local_fields(jnp.asarray(confs)))
    want = jc._line_set_flip_de(jprob, jnp.asarray(confs),
                                jnp.asarray(field), jnp.asarray(mask), 0.8,
                                0.35)
    got = tc.line_set_flip_de(_t(confs), _t(field), _t(mask),
                              torch.tensor(0.8), torch.tensor(0.35))
    assert np.array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ Swendsen-Wang


@pytest.mark.parametrize("jump_every", [0, 2])
def test_label_components_matches_jax(jump_every):
    port, jprob = graphs("rg_fields")
    r = np.random.default_rng(4 + jump_every)
    act = tc.symmetrize_spatial(
        torch.as_tensor(r.random((3, 12, port.maxnb)) < 0.4), port.nbr_idx)
    init = np.where(r.random((3, 12)) < 0.15, -1, np.arange(12))
    want = jax.vmap(lambda a, i: jc._label_components(
        a, jprob.nbr_idx, i, jump_every=jump_every))(
            jnp.asarray(act.numpy()), jnp.asarray(init, dtype=jnp.int32))
    got = tc.label_components(act, port.nbr_idx, torch.as_tensor(init),
                              jump_every)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # the fixed point: each component's least label, -1 absorbing
    assert np.array_equal(tc.label_components(act, port.nbr_idx,
                                              torch.as_tensor(init)).numpy(),
                          got.numpy())


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_classical_sw_sweep_matches_jax(graph):
    port, jprob = graphs(graph)
    n, maxnb = port.nspins, port.maxnb
    temp = 1.1
    s = _spins((CHAINS, n), 3)
    keys = jax.random.split(jax.random.key(11), CHAINS)
    out = jax.jit(jax.vmap(lambda x, k: jc.classical_sw_sweep(
        jprob, x, k, temp)))(jnp.asarray(s), keys)

    def draws(k):
        k_sp, k_h, k_coin = jax.random.split(k, 3)
        return (jax.random.uniform(k_sp, (n, maxnb)),
                jax.random.uniform(k_h, (n,)),
                jax.random.bernoulli(k_coin, 0.5, (n,)))
    d = [_t(x) for x in jax.vmap(draws)(keys)]
    got = tc.classical_sw_sweep(port, _t(s), *d, temp)
    assert np.array_equal(got.numpy(), np.asarray(out))
    assert (got.numpy() != s).any()


def asymmetric_table(P, alpha):
    """bath_lookuptable(P, alpha) with the couplings of ring offsets d <
    P / 2 scaled by 1.5: lut[d - 1] != lut[P - 1 - d], so a bath pair's
    two directions bond with different probabilities (a pair a < b reads
    lut[b - a - 1] from a and lut[P - 1 - (b - a)] from b)."""
    lut = np.asarray(jsched.bath_lookuptable(P, alpha), dtype=np.float32)
    d = np.arange(1, P)
    return np.where(2 * d < P, lut * np.float32(1.5), lut).astype(np.float32)


@pytest.mark.parametrize("graph,P,bath", [
    ("torus6", 1, False), ("torus6", 2, True), ("torus6", 3, False),
    ("torus6", 8, True), ("rg_fields", 2, False), ("rg_fields", 3, True),
    ("chimera", 8, False), ("dup", 3, True), ("torus6", 8, "asym"),
    ("rg_fields", 5, "asym")])
def test_spacetime_sw_sweep_matches_jax(graph, P, bath):
    """spacetime_sw_sweep on the JAX package's draws; "asym" takes a bath
    table not symmetric in ring distance, whose one-way bath pairs both
    relaxations read as directed edges."""
    port, jprob = graphs(graph)
    n, maxnb = port.nspins, port.maxnb
    temp, gamma, b = 0.5, 0.8, 0.9
    teff = temp * P
    lut = (asymmetric_table(P, 0.3) if bath == "asym"
           else jsched.bath_lookuptable(P, 0.3) if bath else None)
    confs = _spins((CHAINS, P, n), 20 + P)
    keys = jax.random.split(jax.random.key(13), CHAINS)
    out = jax.jit(jax.vmap(lambda c, k: jc.spacetime_sw_sweep(
        jprob, c, k, temp, gamma, b, lookuptable=lut)))(
            jnp.asarray(confs), keys)

    def draws(k):
        k_sp, k_t, k_bath, k_h, k_coin = jax.random.split(k, 5)
        return (jax.random.uniform(k_sp, (P, n, maxnb)),
                jax.random.uniform(k_t, (P, n)),
                jax.random.uniform(k_bath, (n, P, P)),
                jax.random.uniform(k_h, (P, n)),
                jax.random.bernoulli(k_coin, 0.5, (P * n,)))
    d = [_t(x) for x in jax.vmap(draws)(keys)]
    jp = np.float32(jsched.jperp(gamma, teff))
    got = tc.spacetime_sw_sweep(port, _t(confs), d[0], d[1],
                                d[2] if bath else None, d[3], d[4], teff,
                                jp, b, None if lut is None else _t(lut))
    assert np.array_equal(got.numpy(), np.asarray(out))
    assert (got.numpy() != confs).any()


def test_classical_sw_on_a_lattice_is_queued():
    """On a LatticeProblem classical_sw_sweep runs
    classical_sw_sweep_lattice (its draws on the coupling planes;
    tests/test_torch_houdayer.py holds it to the JAX function bitwise), as
    the JAX classical_sw_sweep routes a lattice."""
    lat = tinst.gaussian_torus(4, device="cpu")
    s = torch.ones((2, 16))
    g = torch.Generator().manual_seed(0)
    u_sp, u_h = torch.rand((2, 2, 4, 4), generator=g), torch.rand(
        (2, 4, 4), generator=g)
    coins = torch.ones((2, 16), dtype=torch.bool)
    got = tc.classical_sw_sweep(lat, s, u_sp, u_h, coins, 1.0)
    want = tc.classical_sw_sweep_lattice(lat, s, u_sp, u_h, coins, 1.0)
    assert torch.equal(got, want) and got.shape == s.shape


# ------------------------------------------- counter-hash streams and refs


def test_cluster_counters_never_meet_the_local_counter():
    """No cluster index differs from another used index by a d with
    d * INDEX_MULT = dt * STEP_MULT (mod 2**32) for |dt| < 2**26."""
    m = 1 << 32
    inv = pow(cr.STEP_MULT, -1, m)
    used = list(range(4)) + [cr.CLUSTER_INDEX + s for s in range(9)]
    for d in {abs(a - b) for a in used for b in used if a != b}:
        dt = d * cr.INDEX_MULT * inv % m
        assert min(dt, m - dt) >= 1 << 26, d
    assert len(set(cr.cluster_counter(5, 3, s) for s in range(9))
               | {cr.counter(5, 3, 0)}) == 10


def _uid(*parts):
    """Mixed-radix uid: parts (value, radix) from the outermost."""
    acc = parts[0]
    for v, r in parts[1:]:
        acc = acc * r + v
    return torch.as_tensor(acc, dtype=torch.int32)


def test_wolff_draws_follow_the_stream_layout():
    """wolff_draws against uniforms hashed from the docstring's table."""
    pg = tpk.build_packed(graphs("rg_fields")[0])
    ids, P, C, n, m = pg.perm.long(), 3, 2, 12, graphs("rg_fields")[0].maxnb
    d = tc.wolff_draws(9, 4, C, P, pg.perm, m, True)

    def u(stream, uid):
        return float(cr.uniform01(cr.cluster_counter(9, 4, stream),
                                  torch.as_tensor(uid, dtype=torch.int32)))
    c, k, i, mm, lo, hi = 1, 2, 5, 1, 0, 2
    assert float(d[2][c, k, i, mm]) == u(
        cr.SP_BOND, ((c * P + k) * n + int(ids[i])) * m + mm)
    assert float(d[3][c, k, i]) == u(cr.TROTTER_BOND,
                                     (c * P + k) * n + int(ids[i]))
    assert float(d[4][c, i, lo, hi]) == u(
        cr.BATH_BOND, ((c * n + int(ids[i])) * P + lo) * P + hi)
    assert int(d[1][c]) == min(int(u(cr.WOLFF_SEED, 2 * c) * n), n - 1)
    assert int(d[0][c]) == min(int(u(cr.WOLFF_SEED, 2 * c + 1) * P), P - 1)
    assert float(d[5][c]) == u(cr.ACCEPT, c)


def _packed_case(graph, P, chains=3, seed=0):
    port = graphs(graph)[0]
    pg = tpk.build_packed(port)
    confs = torch.as_tensor(_spins((chains, P, port.nspins), seed))
    return port, pg, confs


@pytest.mark.parametrize("rule,bath", [("local", False), ("local", True),
                                       ("full", True)])
def test_wolff_anneal_ref_is_a_loop_of_wolff_update(rule, bath):
    port, pg, confs = _packed_case("rg_fields", 3)
    steps = 4
    b = torch.linspace(0.5, 1.0, steps)
    jp = tsched.jperp(torch.linspace(2.0, 0.3, steps), 1.2)
    teff = torch.full((steps,), 1.2)
    lut = tsched.bath_lookuptable(3, 0.3, device="cpu") if bath else None
    visited = torch.zeros(3, dtype=torch.int64)
    got = tc.wolff_anneal_ref(pg, b, jp, teff, confs, 21, rule, lut,
                              step0=5, visited=visited)
    prob = pg.as_problem()
    c, sizes = confs, torch.zeros(3, dtype=torch.int64)
    for t in range(steps):
        d = tc.wolff_draws(21, 5 + t, 3, 3, pg.perm, prob.maxnb, bath)
        c = tc.wolff_update(prob, c, *d, teff[t], jp[t], b[t], rule, lut,
                            pg.perm)
    assert torch.equal(got, c)
    assert int(visited.min()) >= steps
    # step0 composes: four one-step calls are the four-step call
    c = confs
    for t in range(steps):
        c = ck.wolff_anneal(pg, b[t:t + 1], jp[t:t + 1], teff[t:t + 1], c,
                            21, rule, lut, step0=5 + t)
    assert torch.equal(got, c)


@pytest.mark.parametrize("P,bath,classical", [(1, False, True),
                                              (3, True, False),
                                              (2, False, False)])
def test_sw_anneal_ref_is_a_loop_of_sweeps(P, bath, classical):
    port, pg, confs = _packed_case("torus6", P, seed=P)
    steps = 3
    b = torch.ones(steps) if classical else torch.linspace(0.6, 1.0, steps)
    jp = (torch.zeros(steps) if classical
          else tsched.jperp(torch.linspace(2.0, 0.3, steps), 0.5 * P))
    teff = torch.linspace(2.0, 1.0, steps)
    lut = tsched.bath_lookuptable(P, 0.3, device="cpu") if bath else None
    got = tc.sw_anneal_ref(pg, b, jp, teff, confs, 8, lut, step0=2,
                           classical=classical)
    prob = pg.as_problem()
    c = confs
    for t in range(steps):
        d = tc.sw_draws(8, 2 + t, 3, P, pg.perm, prob.maxnb, bath)
        c = tc.spacetime_sw_sweep(prob, c, *d, teff[t], jp[t], b[t], lut,
                                  pg.perm)
    # at P = 1 and B = 1 the space-time sweep is the classical one
    assert torch.equal(got, c)
    c = confs
    for t in range(steps):
        c = ck.sw_anneal(pg, b[t:t + 1], jp[t:t + 1], teff[t:t + 1], c, 8,
                         lut, step0=2 + t, classical=classical)
    assert torch.equal(got, c)


@pytest.mark.parametrize("per_slice_seeds", [True, False])
def test_line_phases_are_sw_bath_sweeps(per_slice_seeds):
    port, pg, confs = _packed_case("torus6", 4, seed=7)
    prob = pg.as_problem()
    lut = tsched.bath_lookuptable(4, 0.3, device="cpu")
    b, jp, teff = torch.tensor([0.8]), torch.tensor([0.6]), 2.0
    c = confs
    for color in range(pg.num_colors):
        c = tc.line_phase_ref(pg, b[0], jp[0], teff, lut, c, 17, 3, color,
                              per_slice_seeds)
    d = tc.line_draws(17, 3, 3, 4, pg.perm, per_slice_seeds)
    draws = [d if per_slice_seeds else d[0]] * pg.num_colors
    want = tc.sw_bath_sweep(prob, confs, draws, teff, jp[0], b[0], lut,
                            per_slice_seeds,
                            None if per_slice_seeds else d[1])
    assert torch.equal(c, want) and not torch.equal(c, confs)


@pytest.mark.parametrize("kernel", ["packed_sa", "generic_qmc",
                                    "generic_qmc_bath"])
def test_local_kernels_take_a_step_offset(kernel):
    """A one-step call at step0 = t draws step t's uniforms: T one-step
    calls equal one T-step call, and two calls at the same step0 repeat
    the same uniforms (so a solver must pass each step its own)."""
    port = graphs("rg_fields")[0]
    pg = tpk.build_packed(port)
    steps, P = 4, 3
    if kernel == "packed_sa":
        start = torch.as_tensor(_spins((3, 12), 1))
        temps = torch.linspace(2.0, 0.5, steps)

        def run(sl, x, step0):
            return gk.packed_sa_anneal(pg, temps[sl], x, 5, step0=step0)
    else:
        start = torch.as_tensor(_spins((3, P, 12), 1))
        b = torch.linspace(0.5, 1.0, steps)
        jp = tsched.jperp(torch.linspace(2.0, 0.3, steps), 1.2)
        bath = tpq.bath_matrix(tsched.bath_lookuptable(P, 0.3, device="cpu"),
                               P)

        def run(sl, x, step0):
            if kernel == "generic_qmc":
                return gk.generic_qmc_anneal(pg, b[sl], jp[sl], 1.2, x, 5,
                                             False, step0=step0)
            return gk.generic_qmc_bath_anneal(pg, b[sl], jp[sl], 1.2, bath,
                                              x, 5, False, step0=step0)
    whole = run(slice(None), start, 0)
    x = start
    for t in range(steps):
        x = run(slice(t, t + 1), x, t)
    assert torch.equal(whole, x)
    x = start
    for t in range(steps):
        x = run(slice(t, t + 1), x, 0)
    assert not torch.equal(whole, x)


def test_wrappers_refuse():
    port, pg, confs = _packed_case("torus6", 2)
    one = torch.ones(1)
    with pytest.raises(ValueError, match="rule must be"):
        ck.wolff_anneal(pg, one, one, one, confs, 0, rule="greedy")
    with pytest.raises(ValueError, match="rule must be"):
        tc.wolff_update(port, confs, 0, 0, None, None, None, None, 1.0, 0.1,
                        1.0, rule="greedy")
    with pytest.raises(ValueError):
        ck.wolff_anneal(pg, one, one, one, confs.to("meta"), 0)
    assert not any(_build.LAUNCHES[k] for k in ("fk_wolff", "fk_label",
                                                "fk_line"))


# The line phases of a whole anneal in one launch (csrc/fk_line.cu's
# cluster kernel, `cluster_kernels.line_anneal`): its plain route is
# `line_phase_ref` phase after phase, the classes of each step in order,
# and `sw_bath_anneal` is the loop of per-phase launches it replaced
@pytest.mark.parametrize("P,per_slice_seeds,chain0", [
    (2, True, 0), (5, False, 3), (40, True, 100003), (40, False, 0),
    (64, True, 0), (64, False, 100003)])
def test_line_anneal_is_line_phases_phase_by_phase(P, per_slice_seeds,
                                                   chain0):
    port, pg, confs = _packed_case("torus6", P, seed=P)
    steps = 3
    b = torch.linspace(0.7, 1.0, steps)
    jp = tsched.jperp(torch.linspace(2.0, 0.2, steps), 0.6 * P)
    teff = 0.6 * P
    lut = tsched.bath_lookuptable(P, 0.3, device="cpu")
    p_pair, p_t = ck.line_tables(lut, jp, teff, P, "cpu")
    got = ck.line_anneal(pg, b, jp, p_t, teff, lut, p_pair, confs, 19,
                         per_slice_seeds, chain0=chain0)
    c = confs
    for t in range(steps):
        for color in range(pg.num_colors):
            c = tc.line_phase_ref(pg, b[t], jp[t], teff, lut, c, 19, t,
                                  color, per_slice_seeds, p_pair, chain0)
    assert torch.equal(got, c) and not torch.equal(got, confs)
    # a window of steps and classes at a shifted hash step: the same
    # phases, each on its own draws
    part = ck.line_anneal(pg, b, jp, p_t, teff, lut, p_pair, confs, 19,
                          per_slice_seeds, t0=1, steps=2,
                          colors=range(1, pg.num_colors), step0=7,
                          chain0=chain0)
    c = confs
    for t in (1, 2):
        for color in range(1, pg.num_colors):
            c = tc.line_phase_ref(pg, b[t], jp[t], teff, lut, c, 19, t + 6,
                                  color, per_slice_seeds, p_pair, chain0)
    assert torch.equal(part, c)


@pytest.mark.parametrize("per_slice_seeds,local_sweeps,chain0", [
    (True, True, 0), (False, True, 0), (False, False, 5), (False, True, 5)])
def test_sw_bath_anneal_is_the_per_phase_loop(per_slice_seeds, local_sweeps,
                                              chain0):
    """WC3, and WC2 with and without local sweeps: the anneal equals the
    per-step loop it launches phase by phase (a local sweep, then each
    class's line phase), bitwise."""
    port = graphs("torus6")[0]
    P, steps = 5, 4
    confs = torch.as_tensor(_spins((3, P, port.nspins), 31))
    sched = torch.linspace(2.0, 0.3, steps)
    lut = tsched.bath_lookuptable(P, 0.2, device="cpu")
    got = ck.sw_bath_anneal(port, sched, torch.ones_like(sched), 0.3, lut,
                            confs, 23, per_slice_seeds=per_slice_seeds,
                            local_sweeps=local_sweeps, chain0=chain0)
    pg = tpk.build_packed(port)
    b, jp, teff = tsched.qmc_terms(sched, torch.ones_like(sched), 0.3, P, 1,
                                   "cpu")
    p_pair, p_t = ck.line_tables(lut, jp, teff, P, "cpu")
    bath = tpq.bath_matrix_of(lut, P, "cpu")
    c = tpk.pack_state(pg, confs)
    for t in range(steps):
        if local_sweeps and not per_slice_seeds:
            c = gk.generic_qmc_bath_anneal(pg, b[t:t + 1], jp[t:t + 1], teff,
                                           bath, c, 23, False, step0=t,
                                           chain0=chain0)
        for color in range(pg.num_colors):
            c = tc.line_phase_ref(pg, b[t], jp[t], teff, lut, c, 23, t,
                                  color, per_slice_seeds, p_pair, chain0)
    assert torch.equal(got, tpk.unpack_state(pg, c))
