"""The port's dry run of the parallel layer (counterpart of the JAX
package's `__graft_entry__.py`): a one-step check of the PIQMC split
engine, and a multi-rank run of every leg of the JAX `_dryrun_impl` that
the port carries.

`dryrun_multichip(n)` spawns n ranks (torch.multiprocessing, start method
spawn; the ranks run this module, which imports no JAX) joined by a
process group of their own: NCCL when the machine has a card for every
rank, else gloo, which runs several ranks on one card with the halo rows
and sums staged through host memory. The kernels are built in the parent
before any rank starts, so that no two nvcc builds race in one build
directory. Every rank ends with a barrier before it leaves the group.
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from montecarlosolvers_tpu_torch import _device, schedules
from montecarlosolvers_tpu_torch.models import instances
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import split as split_ops
from montecarlosolvers_tpu_torch.ops import split_kernels
from montecarlosolvers_tpu_torch.parallel import mesh as pmesh
from montecarlosolvers_tpu_torch.parallel import trotter
from montecarlosolvers_tpu_torch.solvers import pa, pt, qmc, sa

def entry(device=None):
    """(fn, example_args): one PIQMC step of the split-checkerboard engine
    (kernel B: the local sweep and the line moves) on the 80 x 80 random
    lattice at P = 20, the JAX `entry()` on the port. fn(quarters, seed,
    gamma, b) returns the new quarters; device None is the card."""
    dev = _device.resolve(device)
    problem, _ = instances.random_2d_lattice(80, rng=0, lattice=True,
                                             device=dev)
    slices = 20
    temp = 1.0 / slices
    sl = split_ops.build_split(problem)

    def step(quarters, seed, gamma, b):
        b_t, jp, teff = schedules.qmc_terms([gamma], [b], temp, slices, 1,
                                            dev)
        return split_kernels.qmc_split_anneal(sl, b_t, jp, teff, quarters,
                                              seed, True)

    gen = torch.Generator().manual_seed(0)
    confs = (torch.randint(0, 2, (1, slices, problem.nspins), generator=gen)
             .float() * 2 - 1).to(dev)
    return step, (split_ops.pack_qmc(sl, confs), 0, 1.5, 1.0)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def brute_force_ground(problem):
    """Exact ground energy of a small problem (N <= 20) by enumeration."""
    n = problem.nspins
    assert n <= 20, "brute force limited to tiny instances"
    bits = (np.arange(1 << n)[:, None] >> np.arange(n)) & 1
    states = torch.as_tensor(bits * 2 - 1, dtype=torch.float32,
                             device=problem.device)
    return float(problem.energy(states).min())


def _best(problem, confs):
    return float(qmc.best_slice_energy(problem, confs).min())


def legs(n_ranks, device_type):
    """Every leg of the JAX `_dryrun_impl` that the port carries, on the
    ranks of the default process group (n_ranks of them), each leg
    asserting its bar: chain sharding bitwise on SA and PIQMC (generic),
    split SA, split PIQMC and the split bath (sequential and colored); the
    chain-sharded split engine reaching the brute-force ground state; the
    Trotter-sharded generic anneal with global moves on a chains x replica
    mesh reaching it; the Trotter-sharded split anneal bitwise equal to the
    single-device split engine without global moves and reaching the
    ground state with them; the Trotter-sharded Wolff and Swendsen-Wang
    engines with bath bonds bitwise equal to the single-device ones (JAX
    legs 3c, 3d); the sharded bath on the mesh of the generic leg giving
    +/-1 states (leg 4); rung-sharded PT and quantum PT (leg 5), ICM (5b),
    population-sharded PA (6) and quantum PA (6b) bitwise equal to the
    single-device samplers, their rates, Houdayer fractions and log_z equal
    too (where JAX holds its sharded log_z to allclose); the disorder batch
    sharded over a (disorder, chains) mesh of the hosts LOCAL_WORLD_SIZE
    makes (7, `multihost_leg`). Returns {leg:
    (best, ground)} of the ground-state legs and {leg: count} of the others
    (mismatched or non-spin values, and differing rates or log_z, 0)."""
    dev = torch.device(device_type) if device_type == "cpu" else \
        torch.device("cuda", torch.cuda.current_device())
    full = pmesh.full_tensor
    problem, _ = instances.random_2d_lattice(4, rng=0, device=dev)
    lat, _ = instances.random_2d_lattice(4, rng=0, lattice=True, device=dev)
    chain_mesh = pmesh.make_mesh(chains=n_ranks, device_type=device_type)
    sched = schedules.linear(2.0, 0.0, 20, device=dev)
    a = schedules.transverse_field(2.0, 1e-8, 10, device=dev)
    b = torch.ones_like(a)

    def chain_bitwise(name, run, state):
        ref = run(state)
        out = full(run(pmesh.shard_chains(state, chain_mesh)))
        assert torch.equal(ref, out), f"chain-sharded {name} diverged"

    s0 = sa.random_state(_gen(0), 16, batch=(2 * n_ranks,), device=dev)
    confs = qmc.replicate(sa.random_state(_gen(0), 16, batch=(n_ranks,),
                                          device=dev), 4)
    lut = schedules.bath_lookuptable(4, 1e-2, device=dev)
    chain_bitwise("SA", lambda s: sa.anneal(problem, sched, s, _gen(0)), s0)
    chain_bitwise("PIQMC", lambda c: qmc.anneal(
        problem, a, b, 0.25, c, _gen(0), global_moves=True), confs)
    chain_bitwise("split SA", lambda s: sa.anneal(lat, sched, s, _gen(0)),
                  s0)
    chain_bitwise("split PIQMC", lambda c: qmc.anneal(
        lat, a, b, 0.25, c, _gen(0), global_moves=True), confs)
    for bath_update in ("sequential", "colored"):
        chain_bitwise(f"split bath ({bath_update})", lambda c: qmc.anneal(
            lat, a, b, 0.25, c, _gen(0), lookuptable=lut,
            bath_update=bath_update), confs)

    out = {}
    e_lat = brute_force_ground(lat)
    s0q = sa.anneal(lat, schedules.pre_anneal_schedule(3.0, 1.0, device=dev),
                    sa.random_state(_gen(3), 16, batch=(n_ranks,),
                                    device=dev), _gen(4), mcsteps=5)
    a_gs = schedules.transverse_field(3.0, 1e-8, 300, device=dev)
    b_gs = torch.ones_like(a_gs)
    got = full(qmc.anneal(lat, a_gs, b_gs, 0.25, pmesh.shard_chains(
        qmc.replicate(s0q, 4), chain_mesh), _gen(5), global_moves=True))
    out["chain_sharded_split_gs"] = (_best(lat, got), e_lat)
    assert out["chain_sharded_split_gs"][0] <= e_lat + 0.1 * abs(e_lat), out

    # the Trotter-sharded generic anneal on a chains x replica mesh
    if n_ranks >= 4 and n_ranks % 2 == 0:
        chains_ax, replica_ax, chains_sharded = 2, n_ranks // 2, True
    else:
        chains_ax, replica_ax, chains_sharded = None, n_ranks, False
    mesh = pmesh.make_mesh(chains=chains_ax, replica=replica_ax,
                           device_type=device_type)
    slices = 2 * replica_ax
    e_gs = brute_force_ground(problem)
    s1 = sa.anneal(problem, schedules.pre_anneal_schedule(3.0, 1.0,
                                                          device=dev),
                   sa.random_state(_gen(1), 16, batch=(4,), device=dev),
                   _gen(2), mcsteps=5)
    got = full(trotter.anneal_sharded(
        problem, a_gs, b_gs, 1.0 / slices, qmc.replicate(s1, slices),
        _gen(6), mesh, global_moves=True, chains_sharded=chains_sharded))
    assert got.shape == (4, slices, 16)
    assert bool(((got == 1) | (got == -1)).all()), "non-spin values"
    out["trotter_sharded_gs"] = (_best(problem, got), e_gs)
    assert out["trotter_sharded_gs"][0] <= e_gs + 0.1 * abs(e_gs), out

    # the Trotter-sharded split engine: bitwise without line moves, the
    # ground state with them
    mesh_r = pmesh.make_mesh(replica=n_ranks, device_type=device_type)
    p_split = 2 * n_ranks
    confs_sp = qmc.replicate(sa.random_state(_gen(0), 16, batch=(2,),
                                             device=dev), p_split)
    a_sp = schedules.transverse_field(2.5, 1e-8, 20, device=dev)
    ref = qmc.anneal(lat, a_sp, torch.ones_like(a_sp), 1.0 / p_split,
                     confs_sp, _gen(0))
    got = full(trotter.anneal_sharded_split(
        lat, a_sp, torch.ones_like(a_sp), 1.0 / p_split, confs_sp, _gen(0),
        mesh_r, rng="replicated"))
    assert torch.equal(ref, got), "Trotter-sharded split engine diverged"
    got = full(trotter.anneal_sharded_split(
        lat, a_gs, b_gs, 1.0 / p_split, qmc.replicate(s0q, p_split), _gen(5),
        mesh_r, global_moves=True))
    out["trotter_sharded_split_gs"] = (_best(lat, got), e_lat)
    assert out["trotter_sharded_split_gs"][0] <= e_lat + 0.1 * abs(e_lat), \
        out

    # 3c, 3d: the Trotter-sharded Wolff and Swendsen-Wang engines, bath
    # bonds on, bitwise the single-device ones (qmc.anneal_wolff,
    # qmc.anneal_sw)
    confs_w = qmc.replicate(sa.random_state(_gen(7), 16, device=dev),
                            p_split)
    lut_w = schedules.bath_lookuptable(p_split, 0.2, device=dev)
    a_w = torch.ones_like(a_sp)
    for leg, single, sharded, kw in (
            ("trotter_sharded_wolff", qmc.anneal_wolff,
             trotter.anneal_wolff_sharded, {"rule": "local"}),
            ("trotter_sharded_sw", qmc.anneal_sw, trotter.anneal_sw_sharded,
             {})):
        ref = single(lat, a_sp, a_w, 1.0 / p_split, confs_w, _gen(8),
                     lookuptable=lut_w, **kw)
        got = full(sharded(lat, a_sp, a_w, 1.0 / p_split, confs_w, _gen(8),
                           mesh_r, lookuptable=lut_w, **kw))
        out[leg] = int((ref != got).sum())
        assert out[leg] == 0, f"{leg} diverged from the single-device engine"

    # 4: the sharded bath runs on the chains x replica mesh: +/-1 states
    lut = schedules.bath_lookuptable(slices, 1e-2, device=dev)
    a_d = schedules.transverse_field(2.0, 1e-8, 5, device=dev)
    got = full(trotter.anneal_sharded(
        problem, a_d, torch.ones_like(a_d), 1.0 / slices,
        qmc.replicate(s1, slices), _gen(9), mesh, lookuptable=lut,
        chains_sharded=chains_sharded))
    assert got.shape == (4, slices, 16)
    out["trotter_sharded_bath_spins"] = int(
        ((got != 1) & (got != -1)).sum())
    assert out["trotter_sharded_bath_spins"] == 0, "non-spin values"
    out.update(sampler_legs(n_ranks, lat, chain_mesh, dev))
    out.update(multihost_leg(n_ranks, dev))
    return out


def multihost_leg(n_ranks, dev):
    """JAX's leg 7 (__graft_entry__.py:476-515, tests/multihost_worker.py)
    on the ranks of the default group, LOCAL_WORLD_SIZE of them a host
    (`dryrun_multichip` makes two hosts): `multihost.dcn_mesh` with one
    disorder row a host, each row's ranks on one host; `run_disorder_
    sharded(sa.anneal)` on 2 realizations a row of random_2d_lattice(4), 8
    chains each; every rank's block bitwise the full `vmap_disorder` run
    it computes alone. Returns {"multihost_disorder": mismatched spins},
    asserted 0."""
    from montecarlosolvers_tpu_torch.parallel import disorder, multihost

    hosts = multihost._hosts(n_ranks)[0]
    mesh = multihost.dcn_mesh(disorder=hosts, chains=n_ranks // hosts,
                              device_type=dev.type)
    local = n_ranks // hosts
    for row in mesh.mesh.tolist():
        assert len({r // local for r in row}) == 1, (
            f"disorder row {row} spans hosts of {local} ranks")
    d, c = 2 * hosts, 8
    probs = [instances.random_2d_lattice(4, rng=1000 + i, device=dev)[0]
             for i in range(d)]
    states = sa.random_state(_gen(7), 16, batch=(d, c), device=dev)
    sched = schedules.linear(2.0, 0.1, 30, device=dev)
    out = multihost.run_disorder_sharded(
        sa.anneal, probs, sched, states, [_gen(70 + i) for i in range(d)],
        mesh)
    stacked, axes = disorder.stack_problems(probs)
    ref = disorder.vmap_disorder(sa.anneal, axes)(
        stacked, sched, states, [_gen(70 + i) for i in range(d)])
    block = pmesh.local_of(ref, mesh, {0: "disorder", 1: "chains"})
    bad = int((out.to_local() != block).sum())
    assert bad == 0, "the disorder-sharded run diverged from vmap_disorder"
    return {"multihost_disorder": bad}


def sampler_legs(n_ranks, lat, chain_mesh, dev):
    """JAX's legs 5, 5b, 6 and 6b (__graft_entry__.py:366-463) on the
    split lattice `lat`: each sampler on a state sharded over
    `chain_mesh`'s ranks against the same call unsharded, bitwise. Returns
    {leg: mismatched values + differing scalars}, each asserted 0."""
    full = pmesh.full_tensor

    def differ(ref, got):
        return sum(int((torch.as_tensor(r) != full(g)).sum())
                   for r, g in zip(ref, got))

    def shard(x, dim=0):
        return pmesh.as_dtensor(pmesh.local_block(x, chain_mesh,
                                                  {dim: "chains"}),
                                chain_mesh, {dim: "chains"}, tuple(x.shape))

    out = {}
    temps = pt.geometric_ladder(0.5, 3.0, 2 * n_ranks, device=dev)
    s0 = sa.random_state(_gen(10), 16, batch=(2 * n_ranks,), device=dev)
    out["rung_sharded_pt"] = differ(
        pt.sample(lat, temps, s0, _gen(11), 30, swap_every=2),
        pt.sample(lat, temps, shard(s0), _gen(11), 30, swap_every=2))
    gammas = torch.tensor(np.geomspace(2.0, 0.3, 2 * n_ranks),
                          dtype=torch.float32, device=dev)
    confs = qmc.replicate(s0, 4)
    out["rung_sharded_quantum_pt"] = differ(
        pt.sample_piqmc(lat, gammas, 0.5, confs, _gen(12), 20, swap_every=2,
                        global_moves=True),
        pt.sample_piqmc(lat, gammas, 0.5, shard(confs), _gen(12), 20,
                        swap_every=2, global_moves=True))
    temps_icm = pt.geometric_ladder(0.5, 3.0, n_ranks, device=dev)
    s_icm = sa.random_state(_gen(13), 16, batch=(2, n_ranks), device=dev)
    out["rung_sharded_icm"] = differ(
        pt.sample_icm(lat, temps_icm, s_icm, _gen(14), 20, houdayer_every=2),
        pt.sample_icm(lat, temps_icm, shard(s_icm, 1), _gen(14), 20,
                      houdayer_every=2))
    temps_pa = pa.beta_linear(3.0, 16, beta_start=0.0, device=dev)
    out["population_sharded_pa"] = differ(
        pa.sample(lat, temps_pa, s0, _gen(15), mcsteps=2, beta0=0.0),
        pa.sample(lat, temps_pa, shard(s0), _gen(15), mcsteps=2, beta0=0.0))
    gam_pa = torch.linspace(2.0, 0.5, 12, device=dev)
    out["population_sharded_quantum_pa"] = differ(
        pa.sample_piqmc(lat, gam_pa, 0.5, confs, _gen(16)),
        pa.sample_piqmc(lat, gam_pa, 0.5, shard(confs), _gen(16)))
    for leg, bad in out.items():
        assert bad == 0, f"{leg} diverged from the single-device sampler"
    return out


def free_port():
    """A free TCP port on localhost for a process group's store."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backend_for(device_type, n_ranks):
    """NCCL when every rank has a card of its own, else gloo."""
    if device_type == "cuda" and torch.cuda.device_count() >= n_ranks:
        return "nccl"
    return "gloo"


def init_rank(rank, n_ranks, port, device_type, backend=None):
    """Join rank `rank` of n_ranks to a process group on localhost:port
    (the card rank % cards on the card; on the CPU one thread a rank, so
    that the ranks do not oversubscribe the host's cores)."""
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend or backend_for(device_type, n_ranks),
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n_ranks, rank=rank,
                            timeout=datetime.timedelta(seconds=300))


def _rank_main(fn, rank, n_ranks, port, device_type, args, results, env):
    try:
        os.environ.update(env)
        init_rank(rank, n_ranks, port, device_type)
        out = fn(n_ranks, device_type, *args)
        results.put((rank, None, out))
    except BaseException:  # the parent reports it
        results.put((rank, traceback.format_exc(), None))
        raise
    dist.barrier()
    dist.destroy_process_group()


# seconds the ranks of `run_ranks` may take to report
RANK_TIMEOUT = 900


def run_ranks(fn, n_ranks, device_type="cuda", args=(), env=None):
    """Spawn n_ranks ranks, each joined to a process group of its own
    (`init_rank`) running fn(n_ranks, device_type, *args), with the
    variables of `env` set in each (say, LOCAL_WORLD_SIZE, the ranks a
    host, for `multihost.dcn_mesh`); returns their
    results in rank order (picklable: host tensors or numpy). `fn` must be
    importable from its module, which each rank imports afresh. On the
    card the kernels are built here first. Raises RuntimeError with the
    first failing rank's traceback, and then stops every rank."""
    if device_type == "cuda":
        _device.resolve(None)  # raises without a card
        _build.build()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, n_ranks, port, device_type, tuple(args), results,
        dict(env or {})))
        for r in range(n_ranks)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        while len(got) < n_ranks:
            try:
                rank, err, out = results.get(timeout=5)
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"ranks exited with {dead} before "
                                       "reporting") from None
                if time.monotonic() > deadline:
                    raise RuntimeError("ranks gave no result in "
                                       f"{RANK_TIMEOUT} s") from None
                continue
            if err is not None:
                raise RuntimeError(f"rank {rank} failed:\n{err}")
            got[rank] = out
    except BaseException:
        for p in procs:
            p.kill()
        raise
    for p in procs:
        p.join(timeout=60)
        if p.is_alive():
            p.kill()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}")
    return [got[r] for r in range(n_ranks)]


def dryrun_multichip(n_ranks, device_type="cuda"):
    """Run `legs` on n_ranks spawned ranks (`run_ranks`), as two "hosts"
    of n_ranks // 2 ranks (LOCAL_WORLD_SIZE) for leg 7 where n_ranks is
    even; raises RuntimeError with the first failing rank's traceback.
    device_type: "cuda" (the default: the ranks share the machine's cards,
    gloo when there are fewer cards than ranks) or "cpu" (gloo). Returns
    rank 0's legs (`legs`' values)."""
    env = {"LOCAL_WORLD_SIZE": str(n_ranks // 2)} if n_ranks % 2 == 0 \
        else None
    return run_ranks(legs, n_ranks, device_type, env=env)[0]
