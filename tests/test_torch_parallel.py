"""The port's parallel layer (montecarlosolvers_tpu_torch/parallel/) on
gloo ranks on the CPU.

Pools of 4, 3, 2 and 1 ranks are spawned once for the module
(tests/torch_parallel_worker.py, which imports no JAX), and take the cases
in turn. Held bitwise against the port's unsharded runs in this process:
chain sharding of every engine of `sa.anneal` and `qmc.anneal` on a
chains mesh of 4 and 2 ranks and on a 2 x 2 chains x replica mesh; the
Trotter-sharded engines without line moves at replica 2 and 4. Held
bitwise against the JAX package's sharded engines on the 8-device virtual
CPU mesh, fed JAX's own draws: the shard functions of the split and
generic engines. The physics bars of tests/test_parallel.py run on the
port: the ground state with line moves, T -> 0 monotonicity, the exact
equilibrium of N = 2 at P = 8, and the split engine against the
unsharded one within 4 standard errors. The indivisible axes are
checked, the calls that once refused a sharded state run, and the dry run
runs. The disorder axis: run_disorder_sharded on (disorder, chains)
meshes of one and two hosts equals vmap_disorder bitwise, and dcn_mesh
takes JAX's sizes and errors.
"""

from __future__ import annotations

import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gibbs_check as gibbs
import torch_parallel_worker as W
from montecarlosolvers_tpu_torch import schedules
from montecarlosolvers_tpu_torch.models import instances
from montecarlosolvers_tpu_torch.ops import cluster as cl
from montecarlosolvers_tpu_torch.ops import counter_rng as cr
from montecarlosolvers_tpu_torch.ops import dense_kernels as dense
from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
from montecarlosolvers_tpu_torch.ops import packed as packed_ops
from montecarlosolvers_tpu_torch.ops.piqmc import spacetime_num_phases
from montecarlosolvers_tpu_torch.ops import plane_kernels as pk
from montecarlosolvers_tpu_torch.ops import shard_kernels as shk
from montecarlosolvers_tpu_torch.ops import split as split_ops
from montecarlosolvers_tpu_torch.ops import split_kernels as sk
from montecarlosolvers_tpu_torch.parallel import disorder, dryrun, trotter
from montecarlosolvers_tpu_torch.solvers import qmc, sa

CPU = torch.device("cpu")


class RankPool:
    """n gloo ranks (`torch_parallel_worker.serve`) taking cases in turn."""

    def __init__(self, n):
        ctx = mp.get_context("spawn")
        self.n = n
        self.inboxes = [ctx.Queue() for _ in range(n)]
        self.outbox = ctx.Queue()
        port = dryrun.free_port()
        self.procs = [ctx.Process(target=W.serve, args=(
            r, n, port, self.inboxes[r], self.outbox), daemon=True)
            for r in range(n)]
        for p in self.procs:
            p.start()

    def run(self, case, **kwargs):
        """Rank 0's result of `case`; AssertionError with the tracebacks of
        the ranks that failed."""
        for box in self.inboxes:
            box.put((case, kwargs))
        got, errors = None, []
        for _ in range(self.n):
            rank, ok, payload = self.outbox.get(timeout=600)
            if not ok:
                errors.append(f"rank {rank}:\n{payload}")
            elif rank == 0:
                got = payload
        assert not errors, "\n".join(errors)
        return got

    def close(self):
        for box in self.inboxes:
            box.put(None)
        for p in self.procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()


@pytest.fixture(scope="module")
def pools():
    made = {4: RankPool(4), 2: RankPool(2), 3: RankPool(3), 1: RankPool(1)}
    yield made
    for pool in made.values():
        pool.close()


def _unsharded(engine):
    state, run = W.ENGINES[engine]()
    return W.numpy_of(run(state))


def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a.shape == b.shape
        assert np.array_equal(a, b)


# ------------------------------------------------------------ chain sharding


@pytest.mark.parametrize("ranks,mesh_kind", [(4, "chains"),
                                             (4, "chains_x_replica"),
                                             (2, "chains")])
@pytest.mark.parametrize("engine", sorted(W.ENGINES))
def test_chain_sharding_is_bitwise(pools, engine, ranks, mesh_kind):
    """Every engine of sa.anneal and qmc.anneal on a chain-sharded DTensor
    equals the unsharded run bitwise, and comes back with the state's
    placements (energies sharded on their chain axis, dim 1)."""
    out, placements = pools[ranks].run("chain_sharded", engine=engine,
                                       mesh_kind=mesh_kind)
    _equal(out, _unsharded(engine))
    rest = ", Replicate()" if mesh_kind == "chains_x_replica" else ""
    assert placements[0] == f"[Shard(dim=0){rest}]"
    if len(placements) > 1:
        assert placements[1] == f"[Shard(dim=1){rest}]"


def _wrapped(x):
    """int64 -> the int32 it wraps to."""
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


@pytest.mark.parametrize("chain0", [0, 3, 2**26 + 5])
def test_offset_uids_are_the_unsharded_rows(chain0):
    """The uid helpers' offsets: a block of chains from chain0, and of
    rows from q0 / k0 of a longer axis, holds the whole state's uids of
    those chains and rows (int64 formulas here), wrapping as int32 as the
    kernels' uint32 uids do."""
    c = torch.arange(chain0, chain0 + 2, dtype=torch.int64)
    site = torch.arange(10, dtype=torch.int64)
    assert torch.equal(cr.sa_uids(2, 10, 1, CPU, chain0),
                       _wrapped(c[:, None] * 20 + 10 + site))
    q = torch.arange(3, 6, dtype=torch.int64)
    want = (c[:, None, None] * 4 * 6 * 10 + 2 * 6 * 10
            + q[None, :, None] * 10 + site)
    assert torch.equal(cr.quarter_uids(2, 3, 10, 2, CPU, chain0, 3, 6),
                       _wrapped(want))
    full = cr.plane_uids(4, 5, CPU, slices=3).long()
    stride = full[1, 0, 0, 0] - full[0, 0, 0, 0]
    assert torch.equal(cr.plane_uids(2, 5, CPU, slices=3, chain0=chain0),
                       _wrapped(full[:2] + chain0 * stride))
    sites = torch.arange(7, dtype=torch.int32)
    k = torch.arange(4, 6, dtype=torch.int64)
    want = (c[:, None, None] * 8 + k[None, :, None]) * 7 + sites.long()
    assert torch.equal(cr.generic_uids(2, sites, 7, slices=2, chain0=chain0,
                                       k0=4, p_total=8), _wrapped(want))


def _block_case(kind):
    """(full run, block run) of a plain version on chains 0..5 and on the
    block 2..4 with chain0 = 2."""
    lat4, lat5 = W.lattice(4), W.lattice(5)
    g = torch.Generator().manual_seed(3)
    temps = torch.linspace(2.0, 0.1, 6)
    b = torch.ones(6)
    jp = schedules.jperp(torch.linspace(2.0, 0.1, 6), 1.2)
    if kind == "split_sa":
        sl = split_ops.build_split(lat4)
        a, bb = (torch.randint(0, 2, (6, 8), generator=g).float() * 2 - 1
                 for _ in range(2))
        return (lambda c0, s: sk.sa_split_anneal_ref(sl, temps, *s, 5,
                                                     chain0=c0), (a, bb))
    if kind == "split_qmc":
        sl = split_ops.build_split(lat4)
        q = tuple(torch.randint(0, 2, (6, 2, 8), generator=g).float() * 2 - 1
                  for _ in range(4))
        return (lambda c0, s: sk.qmc_split_anneal_ref(
            sl, b, jp, 1.2, s, 5, True, chain0=c0), q)
    if kind == "plane_qmc":
        pl = pk._planes_of(lat5, torch.zeros(1, 25), "s")
        c = torch.randint(0, 2, (6, 3, 5, 5), generator=g).float() * 2 - 1
        return (lambda c0, s: pk.qmc_plane_anneal_ref(
            pl, b, jp, 1.2, s[0], 5, True, chain0=c0), (c,))
    c = torch.randint(0, 2, (6, 4, 16), generator=g).float() * 2 - 1
    if kind == "generic_qmc":
        pg = packed_ops.build_packed(W.ising4())
        return (lambda c0, s: gk.generic_qmc_anneal_ref(
            pg, b, jp, 1.2, s[0], 5, True, chain0=c0), (c,))
    # the cluster kernels' plain versions, fields and bath bonds on
    pg = packed_ops.build_packed(W.ising4f())
    teff = torch.full((6,), 1.2)
    lut = schedules.bath_lookuptable(4, 0.2, device=CPU)
    if kind.startswith("wolff"):
        rule = kind.split("_")[1]
        return (lambda c0, s: cl.wolff_anneal_ref(
            pg, b, jp, teff, s[0], 5, rule, lut, chain0=c0), (c,))
    if kind == "sw":
        return (lambda c0, s: cl.sw_anneal_ref(
            pg, b, jp, teff, s[0], 5, lut, chain0=c0), (c,))
    per_slice_seeds = kind == "line_wc3"
    p_pair = cl.pair_prob(lut, 4, CPU)

    def line(c0, s):
        x = s[0]
        for t in range(3):
            for color in range(pg.num_colors):
                x = cl.line_phase_ref(pg, b[t], jp[t], 1.2, lut, x, 5, t,
                                      color, per_slice_seeds, p_pair,
                                      chain0=c0)
        return x
    return line, (c,)


@pytest.mark.parametrize("kind", ["split_sa", "split_qmc", "plane_qmc",
                                  "generic_qmc", "wolff_local", "wolff_full",
                                  "sw", "line_wc2", "line_wc3"])
def test_plain_versions_take_the_chain_offset(kind):
    run, state = _block_case(kind)
    full = run(0, state)
    block = run(2, tuple(x[2:5] for x in state))
    full = full if isinstance(full, tuple) else (full,)
    block = block if isinstance(block, tuple) else (block,)
    for f, b in zip(full, block):
        assert torch.equal(f[2:5], b)


def _offset_case(kind):
    """(run(chain0, state) -> tuple, state tuple) of a plain version of
    the five kernels whose chain (or pair) offset the sharded samplers
    and SVMC, noisy and dense anneals use, on chains 0..5."""
    lat4, lat5, prob = W.lattice(4), W.lattice(5), W.ising4()
    g = torch.Generator().manual_seed(4)
    a = schedules.transverse_field(2.0, 1e-3, 5, device=CPU)
    b = torch.ones_like(a)

    def angles(*shape):
        return torch.rand(shape, generator=g) * 3.1415927

    if kind == "split_svmc":
        sl = split_ops.build_split(lat4)
        return (lambda c0, s: sk.svmc_split_anneal_ref(
            sl, a, b, 0.2, *s, 5, True, chain0=c0), (angles(6, 8),
                                                      angles(6, 8)))
    if kind == "plane_svmc":
        pl = pk._planes_of(lat5, torch.zeros(1, 25), "s")
        return (lambda c0, s: pk.svmc_plane_anneal_ref(
            pl, a, b, 0.2, s[0], 5, True, chain0=c0), (angles(6, 5, 5),))
    if kind in ("packed_svmc", "packed_svmc_tables"):
        pg = packed_ops.build_packed(prob)
        tables = None
        if kind == "packed_svmc_tables":
            nbr_J, h = W.noisy_tables(prob, 5)
            tables = gk.packed_tables(pg, nbr_J, h, 1, 5, CPU)
        return (lambda c0, s: gk.packed_svmc_anneal_ref(
            pg, a, b, 0.2, s[0], 5, False, tables=tables, chain0=c0),
            (angles(6, 16),))
    if kind == "dense_block":
        dp = instances.sk_model(40, rng=0, device=CPU)[0]
        J = dp.J.contiguous()
        s = torch.randint(0, 2, (6, 40), generator=g).float() * 2 - 1
        temps = torch.linspace(2.0, 0.5, 3)
        fb = torch.matmul(s, J[:, 8:40])  # one set of products for both

        def run(c0, st):
            rows = slice(c0, c0 + st[0].shape[0])
            return dense.dense_sa_block_ref(st[0].clone(), fb[rows], dp.h, J,
                                            8, temps, 1, 5, chain0=c0)
        return run, (s,)
    problem = W.lattice(4).to_generic()
    s1, s2 = (torch.randint(0, 2, (6, 16), generator=g).float() * 2 - 1
              for _ in range(2))
    return (lambda c0, st: cl.houdayer_move_ref(problem, *st, 5, 3,
                                                pair0=c0), (s1, s2))


@pytest.mark.parametrize("kind", ["split_svmc", "plane_svmc", "packed_svmc",
                                  "packed_svmc_tables", "dense_block",
                                  "houdayer"])
def test_plain_versions_take_the_sampler_offsets(kind):
    """The plain versions of kernels 4 and 7, packed SVMC (static tables
    and per-step ones), the dense in-block kernel and the Houdayer move
    (pair0) run a block of chains (pairs) 2..4 with its offset and equal
    those rows of the whole batch's run, and at offset 0 move something."""
    run, state = _offset_case(kind)
    full = run(0, state)
    block = run(2, tuple(x[2:5] for x in state))
    full = full if isinstance(full, tuple) else (full,)
    block = block if isinstance(block, tuple) else (block,)
    for f, b in zip(full, block):
        assert torch.equal(f[2:5], b)
    assert not torch.equal(full[0], state[0])


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("sampler", sorted(W.SAMPLERS))
def test_sharded_samplers_are_bitwise(pools, sampler, ranks):
    """Every sampler (pt.sample, sample_piqmc, sample_icm; pa.sample,
    sample_adaptive, sample_piqmc, sample_piqmc_adaptive) and every
    non-cluster engine that takes a sharded state (svmc.anneal on kernels 4, 7 and
    packed SVMC, both noisy anneals) on a chain-sharded DTensor equals its
    unsharded call bitwise at 2 and 4 ranks: states, rates, log_z, stats
    and energies; the states and energies come back sharded on their chain
    (rung) axis."""
    got, placements = pools[ranks].run("sampler_sharded", sampler=sampler)
    state, dim, run = W.SAMPLERS[sampler]()
    _equal(got, W.flat(run(state)))
    assert placements[0] == f"[Shard(dim={dim})]"
    for p in placements[1:]:  # energies: (steps, ...) then the state's axes
        assert p == f"[Shard(dim={dim + 1})]"


@pytest.mark.parametrize("sampler", ["pt_split", "icm_split", "pa_split",
                                     "paq_adaptive"])
def test_sharded_samplers_on_chains_x_replica(pools, sampler):
    """On a 2 x 2 chains x replica mesh (the state replicated on
    'replica') the samplers equal the unsharded call bitwise too."""
    got, placements = pools[4].run("sampler_sharded", sampler=sampler,
                                   mesh_kind="chains_x_replica")
    state, dim, run = W.SAMPLERS[sampler]()
    _equal(got, W.flat(run(state)))
    assert placements[0] == f"[Shard(dim={dim}), Replicate()]"


def test_population_gathers_energies_and_int8_states(pools):
    """A population-sharded pa.sample gathers its (R,) energies once a step
    (4 bytes a replica) and, on a step that resamples, the population as
    int8 (N bytes a replica): each of 4 ranks sends k = R / 4 replicas'
    worth, and nothing on a step that does not resample."""
    sent = pools[4].run("sampler_gathers", sampler="pa_odd_lattice")
    state, _, run = W.SAMPLERS["pa_odd_lattice"]()
    _, _, stats = run(state)
    k, n = state.shape[0] // 4, state.shape[1]
    steps, resampled = len(stats["ess"]), int(stats["resampled"].sum())
    assert 0 < resampled < steps
    assert sorted(sent) == sorted([4 * k] * steps + [k * n] * resampled)


def test_dense_sharded_anneal_in_distribution(pools):
    """sa.anneal on a DenseProblem at 4 ranks (ROADMAP.md queue 3: a
    rank's block products are matmuls of its own row count): the mean
    final energy within 4 standard errors of the unsharded run's, and the
    mismatched spins counted."""
    problem, state, run = W.dense_case()
    got = torch.as_tensor(pools[4].run("dense_sharded"))
    want = run(state)
    e_sh, e_1 = problem.energy(got).numpy(), problem.energy(want).numpy()
    se = np.sqrt(e_sh.var() / len(e_sh) + e_1.var() / len(e_1))
    assert abs(e_sh.mean() - e_1.mean()) < 4.0 * se + 1e-6, (
        e_sh.mean(), e_1.mean(), se, int((got != want).sum()))
    assert bool(((got == 1) | (got == -1)).all())


def test_sharded_pa_and_jax_pa_reach_exact_log_z(pools):
    """One bar on the JAX package for the sharded samplers as a whole: on
    the random 4 x 4 lattice (16 spins, ln Z at beta = 1 by enumeration of its 65536
    states), JAX's pa.sample and the port's pa.sample on 2 ranks, each 512
    replicas from beta = 0, come within LOG_Z_TOL of the exact ln Z."""
    from montecarlosolvers_tpu.models import instances as jinst
    from montecarlosolvers_tpu.solvers import pa as jpa
    from montecarlosolvers_tpu.solvers import sa as jsa

    exact = W.exact_log_z(W.lattice(4), W.LOG_Z_BETA)
    jprob = jinst.random_2d_lattice(4, rng=0, lattice=True)[0]
    key = jax.random.key(3)
    temps = jpa.beta_linear(W.LOG_Z_BETA, W.LOG_Z_STEPS, beta_start=0.0)
    _, z_jax = jpa.sample(jprob, temps, jsa.random_state(
        key, 16, batch=(W.LOG_Z_READS,)), key, mcsteps=W.LOG_Z_MCSTEPS,
        beta0=0.0)
    z_port = pools[2].run("log_z")
    z_jax = float(z_jax) + jpa.uniform_log_z(16)
    assert abs(z_jax - exact) < W.LOG_Z_TOL, (z_jax, exact)
    assert abs(z_port - exact) < W.LOG_Z_TOL, (z_port, exact)


# ------------------------------------------------------------ Trotter axis


def _trotter_reference(kind, slices=8, runs=1, global_moves=False):
    """The single-device engine's state after `runs` anneals of
    `torch_parallel_worker.trotter_case`, each from the last's state."""
    engine, problem = W.TROTTER_PROBLEMS[kind]
    problem = problem()
    confs, a, b, temp, _ = W.trotter_case(engine, problem, slices, chains=4)
    for _ in range(runs):
        if kind == "generic_lattice":
            pg = packed_ops.packed_from_lattice(problem)
            bb, jp, teff = schedules.qmc_terms(a, b, temp, slices, 1, CPU)
            seed = sa.draw_seed(W.gen(2))
            out = gk.generic_qmc_anneal(pg, bb, jp, teff,
                                        packed_ops.pack_state(
                                            pg, confs).contiguous(), seed,
                                        global_moves)
            confs = packed_ops.unpack_state(pg, out)
        else:
            confs = qmc.anneal(problem, a, b, temp, confs, W.gen(2),
                               global_moves=global_moves)
    return confs.numpy()


@pytest.mark.parametrize("ranks,mesh_kind,dtensor", [
    (2, "replica", False), (4, "replica", False),
    (4, "chains_x_replica", False), (4, "chains_x_replica", True)])
@pytest.mark.parametrize("kind", ["split", "generic", "generic_lattice"])
def test_trotter_sharding_is_bitwise(pools, kind, ranks, mesh_kind,
                                     dtensor):
    """Without line moves the Trotter-sharded engines equal the
    single-device engine bitwise at replica 2 and 4, with the chains
    sharded too on a 2 x 2 mesh, from a full or a chain-sharded state;
    the result is sharded on 'replica' along the slice axis."""
    out, placements = pools[ranks].run("trotter", kind=kind,
                                       mesh_kind=mesh_kind, dtensor=dtensor)
    assert np.array_equal(out, _trotter_reference(kind))
    want = ("[Shard(dim=0), Shard(dim=1)]" if mesh_kind == "chains_x_replica"
            else "[Shard(dim=1)]")
    assert placements == want


@pytest.mark.parametrize("global_moves", [False, True])
@pytest.mark.parametrize("kind", ["split", "generic", "generic_lattice"])
def test_one_rank_ring_is_the_single_device_engine(pools, kind,
                                                   global_moves):
    """On a replica axis of one rank (2 chains x 1 replica) the ring hands
    back the rows themselves and the line sum the part itself, with no
    copy, and the engines equal the single-device engine bitwise, line
    moves too (one rank adds a line's dE in the single-device order)."""
    no_copy, out = pools[2].run("one_rank_ring", kind=kind,
                                global_moves=global_moves)
    assert no_copy
    assert np.array_equal(out, _trotter_reference(
        kind, global_moves=global_moves))


@pytest.mark.parametrize("mesh_kind", ["replica", "chains_x_replica"])
@pytest.mark.parametrize("kind", ["split", "generic"])
def test_trotter_output_feeds_the_next_call_in_place(pools, kind,
                                                      mesh_kind):
    """One call's DTensor fed straight into a second call: the rank takes
    its local block with no gather (the state never becomes whole on a
    rank), and the two calls equal two single-device runs bitwise."""
    out, gathers = pools[4].run("trotter_chained", kind=kind,
                                mesh_kind=mesh_kind)
    assert gathers == 0
    assert np.array_equal(out, _trotter_reference(kind, runs=2))


@pytest.mark.parametrize("kind", ["generic", "split"])
def test_global_moves_reach_the_ground_state(pools, kind):
    """tests/test_parallel.py:153 (generic, P = 8) and :354 (split, P =
    16) at replica 4, line moves summed over the ranks."""
    best, e_gs, values_ok = pools[4].run("ground_state", kind=kind)
    assert values_ok
    assert best <= e_gs + 0.1 * abs(e_gs), (best, e_gs)


def _extended_energy(problem, confs, temp, gamma, lookuptable=None):
    """E = sum_k E(s_k) - J_perp sum_k s_k . s_{k+1} (ring), float64, at
    T_eff = P*T (tests/test_qmc.py::extended_energy); with a (P-1,)
    `lookuptable`, plus the bath term -T_eff/2 sum_i sum_{k != k'}
    M[k, k'] s_k s_k' of the bath matrix M."""
    c = np.asarray(confs, dtype=np.float64)
    slices = c.shape[-2]
    teff = temp * slices
    jp = gibbs.jperp(gamma, slices, temp)
    e = gibbs.generic_energies(problem, c.reshape(-1, c.shape[-1]))
    e = e.reshape(c.shape[:-1]).sum(-1)
    assert teff > 0
    e = e - jp * (c * np.roll(c, -1, axis=-2)).sum(axis=(-1, -2))
    if lookuptable is not None:
        lut = np.asarray(lookuptable, dtype=np.float64)
        k = np.arange(slices)
        off = (k[None, :] - k[:, None]) % slices
        m = np.where(off > 0, lut[np.maximum(off - 1, 0)], 0.0)
        e = e - 0.5 * teff * np.einsum("...kn,kq,...qn->...", c, m, c)
    return e


def test_energy_does_not_increase_at_zero_temperature(pools):
    """tests/test_parallel.py:172 on the port."""
    before, after = pools[4].run("zero_temperature")
    problem = instances.random_2d_lattice(3, rng=0, device=CPU)[0]
    e0 = _extended_energy(problem, before, 1e-6, 1.0)
    e1 = _extended_energy(problem, after, 1e-6, 1.0)
    assert e1 <= e0 + 1e-3, (e0, e1)


def test_equilibrium_matches_exact(pools):
    """tests/test_parallel.py:279: the sharded sweep's mean extended energy
    over 192 chains against the exact Gibbs mean of N = 2, P = 8 (65536
    states, tests/gibbs_check.py's weights)."""
    out = pools[4].run("equilibrium")
    problem = W.equilibrium_problem()
    slices, temp, gamma = 8, 0.8, 8.0
    w = gibbs.generic_qmc_weights(problem, slices, temp,
                                  gibbs.jperp(gamma, slices, temp))
    states = gibbs.all_states(2 * slices).reshape(-1, slices, 2)
    e_exact = float((w * _extended_energy(problem, states, temp,
                                          gamma)).sum())
    e_emp = float(_extended_energy(problem, out, temp, gamma).mean())
    assert abs(e_emp - e_exact) < 0.35, (e_emp, e_exact)


def test_split_sharded_matches_unsharded_in_distribution(pools):
    """tests/test_parallel.py:397: the sharded split engine, line moves on,
    against the single-device one from another seed, mean extended energy
    within 4 standard errors (2 x 2 lattice, P = 16, 128 chains)."""
    out, ref = pools[4].run("split_statistics")
    generic = W.lattice(2).to_generic()
    e_sh = _extended_energy(generic, out, 0.8, 6.0)
    e_ref = _extended_energy(generic, ref, 0.8, 6.0)
    se = np.sqrt(e_sh.var() / len(e_sh) + e_ref.var() / len(e_ref))
    assert abs(e_sh.mean() - e_ref.mean()) < 4.0 * se, (
        e_sh.mean(), e_ref.mean(), se)


@pytest.mark.parametrize("ranks", [2, 4])
def test_refusals(pools, ranks):
    """Indivisible axes raise ValueError naming the division, the sharded
    bath, Wolff and SW engines' too; a sampler's sharded state with the
    port's leading ladder axes, or ICM's sharded on its ladder axis, raises
    ValueError; the calls that refused a sharded state until the rest of
    the parallel layer was ported (the five cluster entry points, the
    masked lattice engine) run, and no call refuses one."""
    msgs = pools[ranks].run("refusals")
    indivisible = ("shard_indivisible", "split_indivisible",
                   "generic_indivisible", "bath_indivisible",
                   "wolff_indivisible", "sw_indivisible")
    for key in indivisible:
        assert msgs[key].startswith("ValueError") and "divide" in msgs[key]
    assert msgs["rng"].startswith("ValueError: rng must be")
    assert msgs["trotter_state_to_qmc"].startswith("ValueError")
    for key in ("pt_ladders", "pa_piqmc_ladders"):
        assert msgs[key].startswith("ValueError") and "JAX sampler's shape" \
            in msgs[key], (key, msgs[key])
    assert msgs["icm_on_dim0"].startswith("ValueError") and \
        "Shard(1)" in msgs["icm_on_dim0"]
    values = indivisible + ("rng", "trotter_state_to_qmc", "pt_ladders",
                            "pa_piqmc_ladders", "icm_on_dim0")
    refused = {key for key in msgs if key not in values
               and msgs[key] != "no error"}
    assert refused == set(), {key: msgs[key] for key in refused}
    assert {key for key in msgs if key not in values} == {
        "sa_wolff", "sa_sw", "qmc_wolff", "qmc_sw", "qmc_sw_bath",
        "masked_lattice"}


# ------------------------------------------ the rest of the Trotter axis


def _bath_seed():
    return sa.draw_seed(W.gen(13))


@pytest.mark.parametrize("global_moves", [False, True])
@pytest.mark.parametrize("kind", sorted(W.BATH_PROBLEMS))
def test_sharded_bath_at_one_rank_is_the_sequential_bath(pools, kind,
                                                          global_moves):
    """anneal_sharded(lookuptable=) on a replica axis of one rank (2 chains
    x 1 replica) equals the generic bath engine's sequential sweep
    (generic_qmc_bath_anneal_ref) bitwise, line moves on and off, on an
    IsingProblem, an odd torus (its improper checkerboard) and an even
    lattice."""
    out, placements = pools[2].run("bath_sharded", kind=kind, slices=8,
                                   global_moves=global_moves,
                                   mesh_kind="chains_x_replica")
    problem, confs, a, b, temp, lut = W.bath_case(kind, 8)
    want = gk.anneal_generic_qmc_bath(problem, a, b, temp, lut, confs,
                                      _bath_seed(),
                                      global_moves=global_moves)
    assert np.array_equal(out, want.numpy())
    assert placements == "[Shard(dim=0), Shard(dim=1)]"
    assert (out != confs.numpy()).mean() > 0.1


@pytest.mark.parametrize("ranks,slices,kind,global_moves", [
    (2, 8, "ising", True), (2, 2, "odd_lattice", False),
    (4, 8, "odd_lattice", True), (4, 4, "ising", False),
    (4, 4, "even_lattice", True), (3, 3, "ising", True),
    (3, 6, "odd_lattice", False)])
def test_sharded_bath_is_the_lockstep_plain_version(pools, ranks, slices,
                                                    kind, global_moves):
    """At 2, 3 and 4 ranks the sharded bath equals its ranks run in
    lockstep in one process (trotter.anneal_sharded_bath_ref) bitwise: p_local
    >= 2, and one slice a rank, where the device ring is coloured (2
    colours on an even ring, 3 on the odd ring of 3)."""
    out, placements = pools[ranks].run("bath_sharded", kind=kind,
                                       slices=slices,
                                       global_moves=global_moves)
    problem, confs, a, b, temp, lut = W.bath_case(kind, slices)
    want = trotter.anneal_sharded_bath_ref(problem, a, b, temp, lut, confs,
                                           _bath_seed(), ranks,
                                           global_moves=global_moves)
    assert np.array_equal(out, want.numpy())
    assert placements == "[Shard(dim=1)]"


@pytest.mark.parametrize("kind", sorted(W.BATH_PROBLEMS))
def test_bath_slice_takes_the_int8_gather(kind):
    """S5 reads the gathered state as the int8 the collective sends
    (`trotter._gathered(..., as_float=False)`): its wrapper given the int8
    state equals the plain version on the float32 one, every local slice
    of rank 1's slab of 4 at chain0 = 3, on an IsingProblem, an odd torus's
    improper checkerboard and an even lattice."""
    from montecarlosolvers_tpu_torch.ops import piqmc as piqmc_ops

    problem, confs, a, b, temp, lut = W.bath_case(kind, 8)
    pg = trotter._packed_of(problem)
    bath = piqmc_ops.bath_matrix_of(lut, 8, confs.device)
    bq, jp, teff = schedules.qmc_terms(a, b, temp, 8, 1, confs.device)
    full = packed_ops.pack_state(pg, confs).contiguous()
    gathered = full.to(torch.int8)
    assert gathered.dtype == torch.int8
    assert torch.equal(gathered.to(torch.float32), full)
    slab = full[:, 2:4].contiguous()
    for kloc in range(2):
        want = shk.generic_shard_bath_slice_ref(
            pg, bq, jp, teff, bath, slab, full, kloc, 2 + kloc, 1, 19, 3)
        got = shk.generic_shard_bath_slice(
            pg, bq, jp, teff, bath, slab.clone(), gathered, kloc, 2 + kloc, 1,
            19, 3)
        assert torch.equal(got, want)
        slab = want
    assert (slab != full[:, 2:4]).any()


def test_sharded_bath_energy_does_not_increase_at_zero_temperature(pools):
    """tests/test_parallel.py:215 on the port (P = 8 on 4 ranks)."""
    before, after = pools[4].run("bath_zero_temperature")
    problem = instances.random_2d_lattice(3, rng=0, device=CPU)[0]
    lut = schedules.bath_lookuptable(8, 1e-2, device=CPU).numpy()
    e0 = _extended_energy(problem, before, 1e-6, 0.9, lut)
    e1 = _extended_energy(problem, after, 1e-6, 0.9, lut)
    assert e1 <= e0 + 1e-3, (e0, e1)
    assert not np.array_equal(before, after)


def test_sharded_bath_equilibrium_matches_sequential(pools):
    """tests/test_parallel.py:234 on the port, at one slice a rank (P = 4
    on 4 ranks, the ring coloured: the stalest snapshot): the stationary
    extended energy of the sharded bath within 3 standard errors of the
    sequential bath engine's (tests/test_reference_equivalence.py::
    _assert_equilibrium_match)."""
    from tests.test_reference_equivalence import _assert_equilibrium_match

    tails_sh = pools[4].run("bath_equilibrium")
    tails_sq = W.bath_equilibrium_run(
        lambda problem, a, b, temp, confs, g, lut: qmc.anneal(
            problem, a, b, temp, confs, g, lookuptable=lut), 4)
    c = W.BATH_EQUILIBRIUM
    problem = instances.random_2d_lattice(3, rng=0, device=CPU)[0]
    lut = schedules.bath_lookuptable(4, c["alpha"], device=CPU).numpy()

    def energies(tails):
        return _extended_energy(problem, tails.reshape(
            -1, 4, problem.nspins), c["temp"], c["gamma"], lut)
    _assert_equilibrium_match(energies(tails_sh), energies(tails_sq),
                              label="sharded-bath")


CLUSTER_CASES = [
    ("wolff", 4, {"rule": "local"}), ("wolff", 2, {"rule": "full"}),
    ("wolff", 4, {"rule": "local", "bath": True}),
    ("wolff", 2, {"rule": "full", "bath": True}),
    ("wolff", 4, {"rule": "local", "with_fields": True}),
    ("wolff", 3, {"rule": "local", "with_fields": True, "bath": True,
                  "slices": 6}),
    ("sw", 4, {}), ("sw", 2, {"with_fields": True}),
    ("sw", 4, {"bath": True}),
    ("sw", 3, {"with_fields": True, "bath": True, "slices": 6}),
    ("sw", 1, {"bath": "asym"}), ("sw", 2, {"bath": "asym"}),
    ("sw", 4, {"bath": "asym"}),
    ("sw", 1, {"with_fields": True, "bath": "asym"}),
    ("sw", 2, {"with_fields": True, "bath": "asym"}),
    ("sw", 4, {"with_fields": True, "bath": "asym"})]


@pytest.mark.parametrize("kind,ranks,kw", CLUSTER_CASES)
def test_sharded_cluster_engines_equal_single_device(pools, kind, ranks, kw):
    """tests/test_parallel.py:448-532 on the port: the sharded Wolff
    (rules "local" and "full") and SW engines equal the single-device
    qmc.anneal_wolff / anneal_sw bitwise, with bath bonds and with fields
    (the Wolff field term added in slice order, as fk_wolff.cu adds it),
    at 2, 3 and 4 ranks; SW also on a bath table not symmetric in ring
    distance (bath "asym") at 1, 2 and 4 ranks. Their rounds a step end
    when no rank has news (SW on one rank has none: its block is the
    ring)."""
    out, placements, rounds = pools[ranks].run("cluster_sharded", kind=kind,
                                               **kw)
    problem, confs, a, kwargs = W.cluster_case(kind, **kw)
    single = qmc.anneal_wolff if kind == "wolff" else qmc.anneal_sw
    want = single(problem, a, torch.ones_like(a), 1.0 / confs.shape[0],
                  confs, W.gen(9), **kwargs)
    assert np.array_equal(out, want.numpy())
    assert placements == "[Shard(dim=0)]"
    assert len(rounds) == a.shape[0]
    assert min(rounds) >= (1 if ranks > 1 or kind == "wolff" else 0)
    assert (out != confs.numpy()).any()


@pytest.mark.parametrize("kind", ["wolff", "sw"])
def test_sharded_cluster_lockstep_plain_versions(kind):
    """The one-process lockstep plain versions (anneal_wolff_sharded_ref,
    anneal_sw_sharded_ref), which chip_smoke.py holds the card's gloo runs
    to, equal the single-device plain engines at 1 to 4 ranks, bath bonds
    and fields on, and count more rounds as the ranks grow."""
    problem, confs, a, kwargs = W.cluster_case(kind, with_fields=True,
                                               bath=True)
    b = torch.ones_like(a)
    seed = sa.draw_seed(W.gen(9))
    single = qmc.anneal_wolff if kind == "wolff" else qmc.anneal_sw
    want = single(problem, a, b, 1.0 / 8, confs, W.gen(9), **kwargs)
    ref = (trotter.anneal_wolff_sharded_ref if kind == "wolff"
           else trotter.anneal_sw_sharded_ref)
    totals = []
    for ranks in (1, 2, 4):
        rounds = []
        got = ref(problem, a, b, 1.0 / 8, confs, seed, ranks,
                  rounds=rounds, **kwargs)
        assert torch.equal(got, want), ranks
        totals.append(sum(rounds))
    assert totals[0] <= totals[1] <= totals[2]


@pytest.mark.parametrize("with_fields", [False, True])
def test_sw_shard_block_relaxes_one_way_bath_pulls(with_fields):
    """S7's plain version on a block that is the whole ring (one rank), on
    a bath table not symmetric in ring distance: some bath pairs of its
    bonds (`sw_shard_bonds`) hold one way only, and its relaxation
    (`sw_shard_init_ref`) then the flip equal the single-device plain
    fk_label (`sw_anneal_ref`) step by step, bitwise; reading those pairs
    as undirected bonds would not."""
    problem, confs, a, kw = W.cluster_case("sw", with_fields=with_fields,
                                           bath="asym")
    slices = confs.shape[0]
    pg, s, b, jp, teff, lut = trotter._cluster_ref_setup(
        problem, a, torch.ones_like(a), 1.0 / slices, confs, 1,
        kw["lookuptable"], 1)
    prob = pg.as_problem()
    teffs = torch.full_like(b, teff)
    one_way = undirected_differs = 0
    for t in range(b.shape[0]):
        bonds = cl.sw_shard_bonds(prob, s, s[0], s, 0, slices, b[t], jp[t],
                                  teff, lut, 5, t, pg.perm)
        bath = bonds[2]  # (N, P, P): row a takes slice b's label
        one_way += int((bath != bath.transpose(-1, -2)).sum())
        got = cl.sw_shard_flip_ref(
            s, cl.sw_shard_init_ref(prob, bonds, 0, slices), 5, t)
        want = cl.sw_anneal_ref(pg, b[t:t + 1], jp[t:t + 1],
                                teffs[t:t + 1], s[None], 5, lut, t)[0]
        assert torch.equal(got, want), t
        both = bath | bath.transpose(-1, -2)
        flat = cl.sw_shard_flip_ref(s, cl.sw_shard_init_ref(
            prob, bonds[:2] + (both,) + bonds[3:], 0, slices), 5, t)
        undirected_differs += int(not torch.equal(flat, want))
        s = got
    assert one_way > 0 and undirected_differs > 0


def test_bit_packing_round_trips():
    g = torch.Generator().manual_seed(1)
    for m in (1, 31, 32, 33, 100):
        mask = torch.randint(0, 2, (3, m), generator=g).bool()
        words = cl.pack_bits(mask)
        assert words.dtype == torch.int32 and words.shape == (3, -(-m // 32))
        assert torch.equal(cl.unpack_bits(words, m), mask)


# ------------------------------------------------------------ against JAX


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def _jax_lattice(L):
    from montecarlosolvers_tpu.models import instances as jinst

    return jinst.random_2d_lattice(L, rng=0, lattice=True)[0]


def test_split_shards_match_jax_on_its_draws(eight_devices):
    """The port's S1 plain version, run shard by shard at replica 8 with
    the ring's halo rows, a local phase at a time, on the uniforms JAX's
    anneal_sharded_split (rng="replicated", test_parallel.py:324) draws:
    bitwise its result."""
    from montecarlosolvers_tpu import schedules as jsched
    from montecarlosolvers_tpu.parallel import make_mesh as jmesh
    from montecarlosolvers_tpu.parallel import trotter as jtrotter
    from montecarlosolvers_tpu.solvers import qmc as jqmc
    from montecarlosolvers_tpu.solvers import sa as jsa

    jprob = _jax_lattice(4)
    replicas, slices, steps = 8, 16, 6
    key = jax.random.key(21)
    confs = jqmc.replicate(jsa.random_state(key, 16, batch=(3,)), slices)
    a = jsched.transverse_field(2.5, 1e-8, steps)
    want = np.asarray(jtrotter.anneal_sharded_split(
        jprob, a, jnp.ones_like(a), 1.0 / slices, confs, key,
        jmesh(replica=replicas), rng="replicated"))

    sl = split_ops.build_split(W.lattice(4))  # the same draws of rng 0
    b, jp, teff = schedules.qmc_terms(np.asarray(a), np.ones(steps),
                                      1.0 / slices, slices, 1, CPU)
    quarters = list(split_ops.pack_qmc(sl, torch.as_tensor(
        np.asarray(confs))))
    rows = slices // 2 // replicas
    keys = jax.random.split(key, steps)
    for t in range(steps):
        qkeys = jax.random.split(jax.random.split(keys[t])[0], 4)
        u = [torch.as_tensor(np.asarray(jax.random.uniform(
            qkeys[s], quarters[s].shape))) for s in range(4)]
        for phase, updates in enumerate(shk.PHASES):
            shards = []
            for k in range(replicas):
                blk = slice(k * rows, (k + 1) * rows)
                # the previous rank's last row and the next rank's first
                halos = [quarters[r][:, (k * rows - 1) % (slices // 2)
                                     if direction < 0
                                     else ((k + 1) * rows) % (slices // 2)]
                         for _, _, r, direction, _ in updates]
                shards.append(shk.shard_phase_ref(
                    sl, b, jp, teff, [x[:, blk] for x in quarters], halos,
                    phase, t, 0, draws=[u[s][:, blk] for s, *_ in updates]))
            quarters = [torch.cat([sh[i] for sh in shards], dim=1)
                        for i in range(4)]
    got = split_ops.unpack_qmc(sl, *quarters).numpy()
    assert np.array_equal(got, want)


def test_generic_shards_match_jax_on_its_draws(eight_devices):
    """The port's S3 plain version, shard by shard at replica 4, on each
    shard's fold_in(fold_in(k, replica), chains) draws of JAX's
    anneal_sharded (global moves off): bitwise its result."""
    from montecarlosolvers_tpu import schedules as jsched
    from montecarlosolvers_tpu.models import instances as jinst
    from montecarlosolvers_tpu.parallel import make_mesh as jmesh
    from montecarlosolvers_tpu.parallel import trotter as jtrotter
    from montecarlosolvers_tpu.solvers import qmc as jqmc
    from montecarlosolvers_tpu.solvers import sa as jsa

    jprob = jinst.random_2d_lattice(4, rng=0)[0]
    replicas, slices, steps = 4, 8, 5
    key = jax.random.key(4)
    confs = jqmc.replicate(jsa.random_state(key, 16, batch=(3,)), slices)
    confs = confs.at[:, 2, :5].multiply(-1.0)
    a = jsched.transverse_field(2.0, 1e-8, steps)
    want = np.asarray(jtrotter.anneal_sharded(
        jprob, a, jnp.ones_like(a), 1.0 / slices, confs, key,
        jmesh(replica=replicas)))

    pg = packed_ops.build_packed(W.ising4())  # the same draws of rng 0
    m = spacetime_num_phases(pg.num_colors, slices)
    b, jp, teff = schedules.qmc_terms(np.asarray(a), np.ones(steps),
                                      1.0 / slices, slices, 1, CPU)
    s = packed_ops.pack_state(pg, torch.as_tensor(np.asarray(confs)))
    rows = slices // replicas
    perm = pg.perm.long()
    keys = jax.random.split(key, steps)
    for t in range(steps):
        k1 = jax.random.split(keys[t])[0]
        draws = [torch.as_tensor(np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.fold_in(k1, r), 0),
            (3, rows, 16))))[..., perm] for r in range(replicas)]
        for p in range(m):
            shards = []
            for r in range(replicas):
                blk = slice(r * rows, (r + 1) * rows)
                shards.append(shk.generic_shard_phase_ref(
                    pg, b, jp, teff, s[:, blk], s[:, (r * rows - 1) % slices],
                    s[:, ((r + 1) * rows) % slices], p, m, t, 0, k0=r * rows,
                    p_total=slices, draws=draws[r]))
            s = torch.cat(shards, dim=1)
    assert np.array_equal(packed_ops.unpack_state(pg, s).numpy(), want)


def _jax_steps(steps):
    from montecarlosolvers_tpu import schedules as jsched

    a = jsched.transverse_field(2.5, 1e-8, steps)
    return a, jnp.ones_like(a)


@pytest.mark.parametrize("replicas", [4, 8])
def test_bath_shards_match_jax_on_its_draws(eight_devices, replicas):
    """S5's plain version, shard by shard in lockstep at replica 4 (two
    slices a rank) and 8 (one: the ring coloured), on each shard's
    fold_in(fold_in(fold_in(k1, replica), chains), slice) per-class draws
    of JAX's sharded bath (_sharded_dissipative_sweep): bitwise its
    result."""
    from montecarlosolvers_tpu import schedules as jsched
    from montecarlosolvers_tpu.models import instances as jinst
    from montecarlosolvers_tpu.parallel import make_mesh as jmesh
    from montecarlosolvers_tpu.parallel import trotter as jtrotter
    from montecarlosolvers_tpu.solvers import qmc as jqmc
    from montecarlosolvers_tpu.solvers import sa as jsa
    from montecarlosolvers_tpu_torch.ops import piqmc as tpq

    jprob = jinst.random_2d_lattice(4, rng=0)[0]
    slices, steps, temp = 8, 4, 0.3
    key = jax.random.key(6)
    confs = jqmc.replicate(jsa.random_state(key, 16, batch=(3,)), slices)
    confs = confs.at[:, 2, :5].multiply(-1.0)
    a, b_j = _jax_steps(steps)
    lut = jsched.bath_lookuptable(slices, 0.3)
    want = np.asarray(jtrotter.anneal_sharded(
        jprob, a, b_j, temp, confs, key, jmesh(replica=replicas),
        lookuptable=lut))

    pg = packed_ops.build_packed(W.ising4())
    perm = pg.perm.long()
    bath = tpq.bath_matrix_of(np.asarray(lut), slices, CPU)
    b, jp, teff = schedules.qmc_terms(np.asarray(a), np.ones(steps), temp,
                                      slices, 1, CPU)
    s = packed_ops.pack_state(pg, torch.as_tensor(np.asarray(confs)))
    ps = slices // replicas
    keys = jax.random.split(key, steps)
    for t in range(steps):
        k1 = jax.random.split(keys[t])[0]

        def draws(r, kloc):
            kk = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
                k1, r), 0), kloc)
            return [torch.as_tensor(np.asarray(jax.random.uniform(
                jax.random.fold_in(kk, c), (3, 16))))[:, perm]
                for c in range(pg.num_colors)]

        def step(x, owners, kloc):
            full = x.clone()
            return torch.cat([shk.generic_shard_bath_slice_ref(
                pg, b, jp, teff, bath, x[:, r * ps:(r + 1) * ps], full, kloc,
                r * ps + kloc, t, 0, draws=draws(r, kloc)) if r in owners
                else x[:, r * ps:(r + 1) * ps] for r in range(replicas)],
                dim=1)
        if ps == 1:
            for colour in range(2):
                s = step(s, [r for r in range(replicas) if r % 2 == colour],
                         0)
        else:
            for kloc in range(ps):
                s = step(s, range(replicas), kloc)
    assert np.array_equal(packed_ops.unpack_state(pg, s).numpy(), want)


def _jax_cluster_setup(with_fields, bath):
    from montecarlosolvers_tpu import schedules as jsched
    from montecarlosolvers_tpu.models import instances as jinst
    from montecarlosolvers_tpu.solvers import qmc as jqmc
    from montecarlosolvers_tpu.solvers import sa as jsa

    jprob = jinst.random_2d_lattice(4, rng=0, with_fields=with_fields)[0]
    port = instances.random_2d_lattice(4, rng=0, with_fields=with_fields,
                                       device=CPU)[0]
    slices, steps = 8, 6
    key = jax.random.key(9)
    confs = jqmc.replicate(jsa.random_state(key, 16), slices)
    a, b_j = _jax_steps(steps)
    lut = jsched.bath_lookuptable(slices, 0.2) if bath else None
    if bath == "asym":
        lut = W.asymmetric_table(slices, 0.2).numpy()
    b, jp, teff = schedules.qmc_terms(np.asarray(a), np.ones(steps),
                                      1.0 / slices, slices, 1, CPU)
    return (jprob, port, confs, a, b_j, key, lut, b, jp, teff, slices,
            jax.random.split(key, steps))


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("replicas,rule,bath", [
    (4, "local", True), (8, "full", False), (4, "full", True),
    (8, "local", False)])
def test_wolff_shards_match_jax_on_its_draws(eight_devices, replicas, rule,
                                             bath):
    """S6's plain versions, the ranks in lockstep (cluster.
    wolff_sharded_steps_ref) at replica 4 and 8, on the draws of JAX's
    _wolff_sharded_update (its seed, bond and accept uniforms of the full
    state, each rank taking its rows): bitwise JAX's anneal_wolff_sharded,
    rules "local" and "full", with and without bath bonds."""
    from montecarlosolvers_tpu.parallel import make_mesh as jmesh
    from montecarlosolvers_tpu.parallel import trotter as jtrotter

    (jprob, port, confs, a, b_j, key, lut, b, jp, teff, slices,
     keys) = _jax_cluster_setup(False, bath)
    want = np.asarray(jtrotter.anneal_wolff_sharded(
        jprob, a, b_j, 1.0 / slices, confs, key, jmesh(replica=replicas),
        rule=rule, lookuptable=lut))
    maxnb = port.nbr_idx.shape[1]

    def draws(t):
        k_seed, k_sp, k_t, k_site, k_bath, k_acc = jax.random.split(keys[t],
                                                                    6)
        return (int(jax.random.randint(k_site, (), 0, slices)),
                int(jax.random.randint(k_seed, (), 0, 16)),
                _t(jax.random.uniform(k_sp, (slices, 16, maxnb))),
                _t(jax.random.uniform(k_t, (slices, 16))),
                _t(jax.random.uniform(k_bath, (16, slices, slices)))
                if bath else None, _t(jax.random.uniform(k_acc, ())))
    got = cl.wolff_sharded_steps_ref(
        port, _t(confs), b, jp, teff, 0, replicas, rule,
        None if lut is None else _t(lut), draws=draws)
    assert np.array_equal(got.numpy(), want)
    assert (want != np.asarray(confs)).any()


@pytest.mark.parametrize("replicas,with_fields,bath", [
    (8, True, False), (4, False, True), (4, True, True), (1, False, "asym"),
    (2, True, "asym"), (4, False, "asym")])
def test_sw_shards_match_jax_on_its_draws(eight_devices, replicas,
                                          with_fields, bath):
    """S7's plain versions, the ranks in lockstep (cluster.
    sw_sharded_steps_ref) at replica 4 and 8, on the draws of JAX's
    _spacetime_sw_sharded_sweep (bond, ghost and coin draws of the full
    state): bitwise JAX's anneal_sw_sharded, with fields and with the
    bath; and at 1, 2 and 4 on a bath table not symmetric in ring distance
    (bath "asym"), whose one-way pairs both read as directed pulls."""
    from montecarlosolvers_tpu.parallel import make_mesh as jmesh
    from montecarlosolvers_tpu.parallel import trotter as jtrotter

    (jprob, port, confs, a, b_j, key, lut, b, jp, teff, slices,
     keys) = _jax_cluster_setup(with_fields, bath)
    want = np.asarray(jtrotter.anneal_sw_sharded(
        jprob, a, b_j, 1.0 / slices, confs, key, jmesh(replica=replicas),
        lookuptable=lut))
    maxnb = port.nbr_idx.shape[1]

    def draws(t):
        k2 = jax.random.split(keys[t])[1]
        k_sp, k_t, k_bath, k_h, k_coin = jax.random.split(k2, 5)
        return (_t(jax.random.uniform(k_sp, (slices, 16, maxnb))),
                _t(jax.random.uniform(k_t, (slices, 16))),
                _t(jax.random.uniform(k_bath, (16, slices, slices)))
                if bath else None,
                _t(jax.random.uniform(k_h, (slices, 16))),
                _t(jax.random.bernoulli(k_coin, 0.5, (slices * 16,))))
    got = cl.sw_sharded_steps_ref(port, _t(confs), b, jp, teff, 0, replicas,
                                  None if lut is None else _t(lut),
                                  draws=draws)
    assert np.array_equal(got.numpy(), want)
    assert (want != np.asarray(confs)).any()


# ------------------------------------------------ disorder and multihost


@pytest.mark.parametrize("ranks,disorder_axis,hosts", [
    (2, 2, 1), (2, 1, 1), (2, 2, 2), (4, 2, 1), (4, 4, 1), (4, 2, 2),
    (4, 4, 2)])
@pytest.mark.parametrize("solver", sorted(W.DISORDER_SOLVERS))
def test_disorder_sharded_is_vmap_disorder(pools, solver, ranks,
                                           disorder_axis, hosts):
    """run_disorder_sharded on a (disorder, chains) dcn_mesh of 2 and 4
    ranks, on one host and on two, equals the unsharded vmap_disorder run
    bitwise: sa.anneal as one packed launch a rank's block, another solver
    realization by realization on its chain-sharded block. The result is
    sharded (Shard(0), Shard(1)), each rank holding its block."""
    out, placements, block = pools[ranks].run(
        "disorder_sharded", solver=solver, disorder_axis=disorder_axis,
        hosts=hosts)
    probs, sched, states, gens = W.disorder_case()
    stacked, axes = disorder.stack_problems(probs)
    want = disorder.vmap_disorder(W.DISORDER_SOLVERS[solver], axes)(
        stacked, sched, states, gens)
    assert np.array_equal(out, want.numpy())
    assert placements == "[Shard(dim=0), Shard(dim=1)]"
    assert block == (4 // disorder_axis, 8 * disorder_axis // ranks, 16)
    assert (out != states.numpy()).any()


@pytest.mark.parametrize("ranks", [2, 4])
def test_dcn_mesh_sizes_and_hosts(pools, ranks):
    """dcn_mesh with JAX's defaults and errors: one host puts every rank on
    "disorder" by default, chains=2 gives disorder = ranks / 2, sizes that
    do not multiply to the ranks raise ValueError; on two hosts
    (LOCAL_WORLD_SIZE = ranks / 2) disorder defaults to the host count and
    must be a multiple of it, and each disorder row holds one host's ranks.
    initialize() keeps the group that exists."""
    out = pools[ranks].run("dcn_mesh")
    names = ("disorder", "chains")
    half = ranks // 2
    assert out["initialize"] == (0, ranks)
    assert out["default"] == ((ranks, 1), [[r] for r in range(ranks)],
                              names)
    assert out["given"][0] == (2, half)
    assert out["chains_2"][0] == (half, 2)
    assert out["too_many"].startswith("ValueError")
    shape, rows, _ = out["two_hosts"]
    assert shape == (2, half)
    assert all(len({r // half for r in row}) == 1 for row in rows)
    assert out["two_hosts_rows_1"][0] == (ranks, 1)
    assert out["not_a_multiple"].startswith("ValueError") and \
        "host count" in out["not_a_multiple"]


# ------------------------------------------------------------ the dry run


DRYRUN_LEGS = {"chain_sharded_split_gs", "trotter_sharded_gs",
               "trotter_sharded_split_gs", "trotter_sharded_wolff",
               "trotter_sharded_sw", "trotter_sharded_bath_spins",
               "rung_sharded_pt", "rung_sharded_quantum_pt",
               "rung_sharded_icm", "population_sharded_pa",
               "population_sharded_quantum_pa", "multihost_disorder"}


def _legs_hold(out):
    """The ground-state legs within 10% of the ground; the sharded Wolff
    and SW legs (3c, 3d) with 0 mismatched spins, the sharded bath's (4)
    with 0 values other than +/-1, the sharded samplers' (5, 5b, 6, 6b)
    with 0 mismatched values, rates and log_z among them."""
    assert set(out) == DRYRUN_LEGS
    for leg, value in out.items():
        if leg.endswith("_gs"):
            best, e_gs = value
            assert best <= e_gs + 0.1 * abs(e_gs), leg
        else:
            assert value == 0, leg


def test_dry_run_legs_on_four_ranks(pools):
    """Every leg of the port's dry run (parallel/dryrun.py::legs) on the
    4-rank pool, the chains x replica mesh among them, and JAX's legs 3c,
    3d and 4: the sharded Wolff and SW engines with bath bonds, the
    sharded bath; 5, 5b, 6, 6b: rung-sharded PT, quantum PT and ICM,
    population-sharded PA and quantum PA, bitwise; and 7: the disorder
    batch on a 2-host x 2 dcn_mesh, each row on one host, bitwise."""
    _legs_hold(pools[4].run("dryrun_legs"))


def test_dryrun_multichip_spawns_its_ranks():
    _legs_hold(dryrun.dryrun_multichip(2, device_type="cpu"))


def test_entry_takes_one_split_step():
    step, args = dryrun.entry(device="cpu")
    out = step(*args)
    assert len(out) == 4
    for q in out:
        assert q.shape == (1, 10, 3200)
        assert bool(((q == 1) | (q == -1)).all())
