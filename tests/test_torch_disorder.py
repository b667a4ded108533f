"""The port's disorder axis (montecarlosolvers_tpu_torch/parallel/disorder.py,
`multihost.initialize`) and the masked lattice engine (sa.anneal(engine=
"masked") on a LatticeProblem), on the CPU.

Held against the JAX package (tests/test_disorder.py): the stacked tables,
colors and energies bitwise or to rtol 1e-5, the topology check, and the
batched anneal's and the masked lattice engine's energies in distribution
(the two draw from different random streams). Held bitwise against the
port's own solo runs: each realization of a batch, in one launch of the
packed plain version's disorder stride or realization by realization, and
the masked lattice engine against the packed engine on the lattice's
checkerboard packing. The sharded runs are tests/test_torch_parallel.py's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import gibbs_check as gc
from montecarlosolvers_tpu import schedules as jsched
from montecarlosolvers_tpu.models import instances as jinst
from montecarlosolvers_tpu.models.lattice import LatticeProblem as JLattice
from montecarlosolvers_tpu.parallel import disorder as jdis
from montecarlosolvers_tpu.solvers import sa as jsa
from montecarlosolvers_tpu_torch import schedules
from montecarlosolvers_tpu_torch.models import instances
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
from montecarlosolvers_tpu_torch.ops import packed as packed_ops
from montecarlosolvers_tpu_torch.parallel import disorder, multihost
from montecarlosolvers_tpu_torch.parallel import mesh as pmesh
from montecarlosolvers_tpu_torch.solvers import qmc, sa

CPU = torch.device("cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _realizations(n=3):
    """tests/test_disorder.py's realizations in both packages:
    random_2d_lattice(4) on default_rng(1234 + d)."""
    return ([jinst.random_2d_lattice(4, rng=np.random.default_rng(1234 + d))[0]
             for d in range(n)],
            [instances.random_2d_lattice(4, rng=1234 + d, device=CPU)[0]
             for d in range(n)])


# ------------------------------------------------------- stack_problems


def test_stack_matches_jax():
    """The stacked tables, the topology-only colors and their count equal
    JAX's stack_problems bitwise, and the mapped fields are the
    couplings."""
    jprobs, probs = _realizations()
    jst, jaxes = jdis.stack_problems(jprobs)
    st, axes = disorder.stack_problems(probs)
    assert st.realizations == 3 and st.nspins == 16
    np.testing.assert_array_equal(st.nbr_J.numpy(), np.asarray(jst.nbr_J))
    np.testing.assert_array_equal(st.h.numpy(), np.asarray(jst.h))
    np.testing.assert_array_equal(st.problem.nbr_idx.numpy(),
                                  np.asarray(jst.nbr_idx))
    np.testing.assert_array_equal(st.problem.color_masks.numpy(),
                                  np.asarray(jst.color_masks))
    assert st.problem.num_colors == jst.num_colors
    assert {k for k, v in axes.items() if v == 0} == {"nbr_J", "h"}
    assert jaxes.nbr_J == 0 and jaxes.h == 0


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_rejects_mismatched_topology(package):
    if package == "jax":
        a, _ = jinst.random_2d_lattice(4, rng=np.random.default_rng(0))
        b, _ = jinst.random_graph(16, 20, rng=np.random.default_rng(1))
        with pytest.raises(ValueError):
            jdis.stack_problems([a, b])
        return
    a, _ = instances.random_2d_lattice(4, rng=0, device=CPU)
    b, _ = instances.random_graph(16, 20, rng=1, device=CPU)
    with pytest.raises(ValueError):
        disorder.stack_problems([a, b])
    # the same shapes, another neighbor structure
    c, _ = instances.random_2d_lattice(4, rng=0, device=CPU)
    c.nbr_idx[0, 0] = 5
    with pytest.raises(ValueError, match="neighbor structure"):
        disorder.stack_problems([a, c])
    with pytest.raises(ValueError, match="IsingProblems"):
        disorder.stack_problems([a, instances.gaussian_torus(4, device=CPU)])


def test_stacked_energy_batch():
    """The (D, ..., N) energy batch equals JAX's vmapped energies to rtol
    1e-5, and each realization's own IsingProblem energy bitwise."""
    jprobs, probs = _realizations()
    jst, jaxes = jdis.stack_problems(jprobs)
    st, _ = disorder.stack_problems(probs)
    s = np.random.default_rng(5).choice([-1.0, 1.0], size=(3, 5, 16)).astype(
        np.float32)
    want = jax.vmap(lambda p, x: p.energy(x), in_axes=(jaxes, 0))(
        jst, jnp.asarray(s))
    got = st.energy(torch.as_tensor(s))
    assert got.shape == (3, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    for d, p in enumerate(probs):
        assert torch.equal(got[d], p.energy(torch.as_tensor(s[d])))


# ------------------------------------------------------- vmap_disorder


SOLVERS = {
    # one launch of the packed plain version with its disorder stride
    "sa.anneal": sa.anneal,
    # any other solver function: realization by realization
    "masked": lambda p, sched, s, g: sa.anneal(p, sched, s, g,
                                               engine="masked"),
}


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_batch_equals_solo_runs(solver):
    """Realization d of a batch equals the solo masked anneal of problem
    d with generator d bitwise (tests/test_disorder.py:28), through the
    one-launch route and the realization-by-realization one; the state
    axis may sit elsewhere."""
    _, probs = _realizations()
    st, axes = disorder.stack_problems(probs)
    states = sa.random_state(_gen(0), 16, batch=(3, 4), device=CPU)
    sched = schedules.linear(2.0, 0.1, 40, device=CPU)
    batched = disorder.vmap_disorder(SOLVERS[solver], axes)(
        st, sched, states, [_gen(10 + d) for d in range(3)])
    assert batched.shape == states.shape
    for d, p in enumerate(probs):
        solo = sa.anneal(p, sched, states[d], _gen(10 + d), engine="masked")
        assert torch.equal(batched[d], solo), d
    moved = disorder.vmap_disorder(SOLVERS[solver], axes, state_axis=1)(
        st, sched, states.movedim(0, 1), [_gen(10 + d) for d in range(3)])
    assert torch.equal(moved, batched)


def test_extra_arguments_map_or_broadcast():
    """extra_axes maps an argument between the schedule and the state on
    its axis, or shares it (None): a PIQMC batch with B shared and Gamma
    mapped equals the solo anneals."""
    _, probs = _realizations(2)
    st, axes = disorder.stack_problems(probs)
    confs = qmc.replicate(sa.random_state(_gen(1), 16, batch=(2, 3),
                                          device=CPU), 4)
    gammas = torch.stack([schedules.transverse_field(g, 1e-8, 6, device=CPU)
                          for g in (2.0, 3.0)], dim=1)  # (steps, D)
    b = torch.ones(6)

    def piqmc(p, b_sched, a_sched, c, g):
        return qmc.anneal(p, a_sched, b_sched, 0.25, c, g, global_moves=True)
    run = disorder.vmap_disorder(piqmc, axes, extra_axes=(1,))
    out = run(st, b, gammas, confs, [_gen(20), _gen(21)])
    for d in range(2):
        solo = qmc.anneal(st.realization(d), gammas[:, d], b, 0.25, confs[d],
                          _gen(20 + d), global_moves=True)
        assert torch.equal(out[d], solo)


def test_disorder_stride_plain_version():
    """The plain version of packed SA's disorder stride: block r of a D x C
    launch equals a solo launch of realization r's tables with its seed,
    also from chain0; per-step tables beside a disorder batch raise."""
    _, probs = _realizations()
    st, _ = disorder.stack_problems(probs)
    pg, nbr_j, h = st.packed
    flat = packed_ops.pack_state(pg, sa.random_state(_gen(2), 16,
                                                     batch=(12,), device=CPU))
    temps = schedules.linear(2.0, 0.1, 10, device=CPU)
    seeds = [11, 2**31 - 2, 7]
    out = gk.packed_sa_anneal(pg, temps, flat, 0, chain0=3,
                              disorder=(nbr_j, h, seeds))
    for r in range(3):
        solo_pg = packed_ops.build_packed(probs[r])
        solo = gk.packed_sa_anneal(solo_pg, temps, flat[4 * r:4 * r + 4],
                                   seeds[r], chain0=3)
        assert torch.equal(out[4 * r:4 * r + 4], solo), r
    tables = (nbr_j, h, 1)
    with pytest.raises(ValueError, match="per-step tables"):
        gk.packed_sa_anneal(pg, temps[:3], flat, 0, tables=tables,
                            disorder=(nbr_j, h, seeds))
    with pytest.raises(ValueError, match="do not divide"):
        gk.packed_sa_anneal(pg, temps, flat[:10], 0,
                            disorder=(nbr_j, h, seeds))
    assert not any(_build.LAUNCHES.values())


def test_vmap_disorder_checks_its_arguments():
    _, probs = _realizations(2)
    st, axes = disorder.stack_problems(probs)
    states = sa.random_state(_gen(0), 16, batch=(2, 2), device=CPU)
    sched = schedules.linear(1.0, 0.1, 2, device=CPU)
    with pytest.raises(ValueError, match="key_axis"):
        disorder.vmap_disorder(sa.anneal, axes, key_axis=1)
    with pytest.raises(ValueError, match="stacked_axes"):
        disorder.vmap_disorder(sa.anneal, {**axes, "nbr_J": None})
    run = disorder.vmap_disorder(sa.anneal, axes)
    with pytest.raises(ValueError, match="generators"):
        run(st, sched, states, [_gen(0)])
    with pytest.raises(ValueError, match="extra"):
        run(st, sched, sched, states, [_gen(0), _gen(1)])


def _exact_mean(problem, temp):
    e = gc.generic_energies(problem, gc.all_states(problem.nspins))
    return float((gc.generic_sa_weights(problem, temp) * e).sum())


def test_batched_anneal_in_distribution():
    """At fixed T = 1 each realization's mean energy over 512 chains lies
    within 4 standard errors of its exact Boltzmann mean (enumeration of
    the 2^16 states), for the port's vmap_disorder(sa.anneal) and JAX's."""
    jprobs, probs = _realizations()
    chains, steps, temp = 512, 200, 1.0
    st, axes = disorder.stack_problems(probs)
    states0 = np.random.default_rng(9).choice(
        [-1.0, 1.0], size=(3, chains, 16)).astype(np.float32)
    sched = torch.full((steps,), temp)
    port = disorder.vmap_disorder(sa.anneal, axes)(
        st, sched, torch.as_tensor(states0), [_gen(30 + d) for d in range(3)])
    jst, jaxes = jdis.stack_problems(jprobs)
    keys = jax.random.split(jax.random.key(3), 3)
    jout = jdis.vmap_disorder(jsa.anneal, jaxes)(
        jst, jnp.full((steps,), temp, dtype=jnp.float32),
        jnp.asarray(states0), keys)
    e_port = st.energy(port).double().numpy()
    e_jax = np.asarray(jax.vmap(lambda p, x: p.energy(x), in_axes=(jaxes, 0))(
        jst, jout), dtype=np.float64)
    for d, p in enumerate(probs):
        exact = _exact_mean(p, temp)
        for e in (e_port[d], e_jax[d]):
            se = e.std(ddof=1) / np.sqrt(chains)
            assert abs(e.mean() - exact) <= 4 * se, (d, e.mean(), exact, se)


# ------------------------------------------------------- multihost


def test_initialize_makes_a_one_rank_group(monkeypatch):
    """initialize() in one process with no torchrun variables makes a
    one-rank group, (0, 1), and keeps it when called again; dcn_mesh on it
    is (1, 1)."""
    for name in multihost._ENV + ("LOCAL_WORLD_SIZE",):
        monkeypatch.delenv(name, raising=False)
    assert not dist.is_initialized()
    try:
        assert multihost.initialize() == (0, 1)
        assert dist.get_backend() == "gloo"
        assert multihost.initialize() == (0, 1)
        mesh = multihost.dcn_mesh(device_type="cpu")
        assert tuple(mesh.mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("disorder", "chains")
        assert "disorder" in pmesh.AXES
    finally:
        dist.destroy_process_group()


# ------------------------------------------------ the masked lattice engine


LATTICES = {
    "even_torus": lambda: instances.gaussian_torus(4, device=CPU),
    "odd_torus": lambda: instances.gaussian_torus(5, device=CPU),
    "open": lambda: instances.random_2d_lattice(6, rng=2, lattice=True,
                                                with_fields=True,
                                                device=CPU)[0],
}


@pytest.mark.parametrize("name", sorted(LATTICES))
def test_masked_lattice_is_the_packed_route(name):
    """sa.anneal(lattice, engine="masked") (the masked sweep over the
    checkerboard, on the CPU) equals the packed plain version on the
    lattice's checkerboard packing bitwise, which the card runs (an odd
    torus: the improper packing, same-class neighbours read as the phase
    found them), also on a block of chains from chain0."""
    lat = LATTICES[name]()
    s = sa.random_state(_gen(4), lat.nspins, batch=(6,), device=CPU)
    sched = schedules.linear(2.5, 0.1, 12, device=CPU)
    out = sa.anneal(lat, sched, s, _gen(5), engine="masked")
    pg = packed_ops.packed_from_lattice(lat)
    assert pg.proper == (name != "odd_torus")
    seed = sa.draw_seed(_gen(5))
    ref = gk.packed_sa_anneal_ref(pg, sched, packed_ops.pack_state(pg, s),
                                  seed)
    assert torch.equal(out, packed_ops.unpack_state(pg, ref))
    block = gk.anneal_masked(lat, sched, s[2:5], seed, chain0=2)
    assert torch.equal(block, out[2:5])
    spins, es = sa.anneal(lat, sched, s, _gen(5), engine="masked",
                          collect_energy=True)
    assert torch.equal(spins, out) and es.shape == (12, 6)
    assert torch.equal(es[-1], lat.energy(out))


def test_masked_lattice_samples_exact_boltzmann():
    """The masked lattice engine at fixed T on a 3 x 3 open lattice with
    fields samples the exact Boltzmann weights of its 512 states."""
    lat = instances.random_2d_lattice(3, rng=3, lattice=True,
                                      with_fields=True, device=CPU)[0]
    temp = 1.2
    per_chain = gc.sample_generic_sa(gk.anneal_masked, lat, 1024, temp, 23)
    z, d = gc.z_scores(per_chain,
                       gc.generic_sa_weights(lat.to_generic(), temp),
                       gc.SAMPLES)
    assert z < 5.0, (z, d)


def test_masked_lattice_matches_jax_in_distribution():
    """sa.anneal(engine="masked") on the 8 x 8 Gaussian torus: the port's
    mean final energy over 256 chains lies within 4 combined standard
    errors of JAX's masked engine's."""
    L, chains, tau = 8, 256, 60
    r = np.random.default_rng(0)
    jr, jd = r.normal(size=(L, L)), r.normal(size=(L, L))
    jlat = JLattice.from_planes(jnp.asarray(jr, dtype=jnp.float32),
                                jnp.asarray(jd, dtype=jnp.float32))
    lat = instances.gaussian_torus(L, 0, device=CPU)
    np.testing.assert_array_equal(lat.j_right.numpy(),
                                  np.asarray(jlat.j_right))
    s0 = np.random.default_rng(1).choice([-1.0, 1.0], size=(chains, L * L))
    s0 = s0.astype(np.float32)
    port = sa.anneal(lat, schedules.linear(3.0, 0.1, tau, device=CPU),
                     torch.as_tensor(s0), _gen(6), engine="masked")
    jout = jsa.anneal(jlat, jsched.linear(3.0, 0.1, tau), jnp.asarray(s0),
                      jax.random.key(6), engine="masked")
    e_port = lat.energy(port).double().numpy()
    e_jax = np.asarray(jlat.energy(jout), dtype=np.float64)
    se = np.hypot(e_port.std(ddof=1), e_jax.std(ddof=1)) / np.sqrt(chains)
    assert abs(e_port.mean() - e_jax.mean()) <= 4 * se, (
        e_port.mean(), e_jax.mean(), se)
