"""Rank body of the parallel-layer tests (tests/test_torch_parallel.py).

A pool of gloo ranks on the CPU, spawned once per test module, takes the
cases one at a time: the test process puts (case, kwargs) into every
rank's queue, each rank runs `CASES[case](**kwargs)` on its process group
(the same program on every rank, as `shard_map` runs it), and rank 0's
result comes back as numpy arrays. The module imports no JAX: a spawned
rank imports it afresh.

The engine registry `ENGINES` builds each chain-sharded run from a seed
alone, so that the test process can run the same engine unsharded and
hold the ranks' result to it bitwise.
"""

from __future__ import annotations

import datetime
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from montecarlosolvers_tpu_torch import schedules
from montecarlosolvers_tpu_torch.models import instances
from montecarlosolvers_tpu_torch.models.ising import IsingProblem
from montecarlosolvers_tpu_torch.parallel import make_mesh, shard_chains
from montecarlosolvers_tpu_torch.parallel import _collectives, dryrun, trotter
from montecarlosolvers_tpu_torch.parallel import multihost
from montecarlosolvers_tpu_torch.parallel import mesh as pmesh
from montecarlosolvers_tpu_torch.solvers import pa, pt, qmc, sa, svmc

CPU = torch.device("cpu")
CHAINS = 8


def gen(seed):
    return torch.Generator().manual_seed(seed)


def ising4():
    return instances.random_2d_lattice(4, rng=0, device=CPU)[0]


def lattice(L):
    """An even L takes the split engines, an odd L the full-plane ones."""
    if L % 2:
        return instances.gaussian_torus(L, 0, device=CPU)
    return instances.random_2d_lattice(L, rng=0, lattice=True, device=CPU)[0]


def _sa(problem, **kw):
    sched = schedules.linear(2.0, 0.0, 12, device=CPU)
    state = sa.random_state(gen(1), problem.nspins, batch=(CHAINS,),
                            device=CPU)
    return state, lambda s: sa.anneal(problem, sched, s, gen(2), **kw)


def _qmc(problem, slices=4, **kw):
    a = schedules.transverse_field(2.0, 1e-8, 8, device=CPU)
    confs = sa.random_state(gen(1), slices * problem.nspins, batch=(CHAINS,),
                            device=CPU).reshape(CHAINS, slices, -1)
    return confs, lambda c: qmc.anneal(problem, a, torch.ones_like(a), 0.3,
                                       c, gen(2), **kw)


def _lut(slices=4):
    return schedules.bath_lookuptable(slices, 1e-2, device=CPU)


def ising4f():
    """The random 4 x 4 lattice's generic form with fields."""
    return instances.random_2d_lattice(4, rng=0, with_fields=True,
                                       device=CPU)[0]


def _sa_cluster(solver, problem, **kw):
    sched = schedules.linear(2.0, 0.1, 6, device=CPU)
    state = sa.random_state(gen(1), problem.nspins, batch=(CHAINS,),
                            device=CPU)
    return state, lambda s: solver(problem, sched, s, gen(2), **kw)


def _qmc_cluster(solver, problem, slices=4, bath=False, **kw):
    a = schedules.transverse_field(2.0, 1e-8, 5, device=CPU)
    confs = sa.random_state(gen(1), slices * problem.nspins, batch=(CHAINS,),
                            device=CPU).reshape(CHAINS, slices, -1)
    args = (_lut(slices),) if solver is qmc.anneal_sw_bath else ()
    if bath:
        kw["lookuptable"] = _lut(slices)
    return confs, lambda c: solver(problem, a, torch.ones_like(a), 0.3,
                                   *args, c, gen(2), **kw)


# engine -> () -> (state, run): run(state) anneals a full or a
# chain-sharded state; one engine of modules 2 and 4 of the slice each
ENGINES = {
    "sa_packed": lambda: _sa(ising4()),
    "sa_masked": lambda: _sa(ising4(), engine="masked"),
    "sa_split": lambda: _sa(lattice(4)),
    "sa_plane": lambda: _sa(lattice(5)),
    "sa_split_energies": lambda: _sa(lattice(4), collect_energy=True),
    "qmc_generic": lambda: _qmc(ising4(), global_moves=True),
    "qmc_split": lambda: _qmc(lattice(4), global_moves=True),
    "qmc_plane": lambda: _qmc(lattice(5), slices=3, global_moves=True),
    "qmc_split_energies": lambda: _qmc(lattice(4), global_moves=True,
                                       collect_energy=True),
    "bath_split_sequential": lambda: _qmc(lattice(4), lookuptable=_lut(),
                                          global_moves=True),
    "bath_split_colored": lambda: _qmc(lattice(4), lookuptable=_lut(),
                                       global_moves=True,
                                       bath_update="colored"),
    "bath_generic_sequential": lambda: _qmc(ising4(), lookuptable=_lut(),
                                            global_moves=True),
    "bath_generic_colored": lambda: _qmc(ising4(), lookuptable=_lut(),
                                         bath_update="colored"),
    "bath_odd_lattice": lambda: _qmc(lattice(5), lookuptable=_lut()),
    # the masked lattice engine (an odd torus: its improper checkerboard)
    "sa_masked_lattice": lambda: _sa(lattice(4), engine="masked"),
    "sa_masked_odd_lattice": lambda: _sa(lattice(5), engine="masked",
                                         collect_energy=True),
    # the five cluster entry points: fields, both Wolff rules, bath bonds,
    # local sweeps, WC2 and WC3
    "sa_wolff": lambda: _sa_cluster(sa.anneal_wolff, ising4f()),
    "sa_wolff_no_local": lambda: _sa_cluster(sa.anneal_wolff, ising4(),
                                             local_sweeps=False),
    "sa_sw": lambda: _sa_cluster(sa.anneal_sw, ising4f()),
    "sa_sw_local": lambda: _sa_cluster(sa.anneal_sw, lattice(4),
                                       local_sweeps=True),
    "qmc_wolff_local": lambda: _qmc_cluster(qmc.anneal_wolff, ising4f()),
    "qmc_wolff_full_bath": lambda: _qmc_cluster(qmc.anneal_wolff, ising4(),
                                                bath=True, rule="full"),
    "qmc_wolff_local_bath": lambda: _qmc_cluster(qmc.anneal_wolff,
                                                 ising4f(), bath=True),
    "qmc_sw_bath_bonds": lambda: _qmc_cluster(qmc.anneal_sw, ising4f(),
                                              bath=True),
    "qmc_sw_local": lambda: _qmc_cluster(qmc.anneal_sw, ising4(),
                                         local_sweeps=True),
    "qmc_sw_bath_wc3": lambda: _qmc_cluster(qmc.anneal_sw_bath, ising4f()),
    "qmc_sw_bath_wc2": lambda: _qmc_cluster(qmc.anneal_sw_bath, ising4f(),
                                            per_slice_seeds=False),
}


def _numpy(x):
    if isinstance(x, tuple):
        return tuple(_numpy(y) for y in x)
    return pmesh.full_tensor(x).numpy()


def _mesh(kind):
    """'chains': every rank on the chain axis; 'chains_x_replica': (2,
    world / 2); 'replica': every rank on the replica axis."""
    world = dist.get_world_size()
    if kind == "chains":
        return make_mesh(chains=world, device_type="cpu")
    if kind == "replica":
        return make_mesh(replica=world, device_type="cpu")
    return make_mesh(chains=2, replica=world // 2, device_type="cpu")


def case_chain_sharded(engine, mesh_kind):
    """The engine's run on its state chain-sharded over `mesh_kind`, with
    the placements of what came back."""
    state, run = ENGINES[engine]()
    out = run(shard_chains(state, _mesh(mesh_kind)))
    outs = out if isinstance(out, tuple) else (out,)
    return _numpy(out), [str(list(x.placements)) for x in outs]


def trotter_case(kind, problem, slices, chains=3, steps=10, seed=2):
    """(confs, a, b, temp, run) of a Trotter-sharded run: kind "split" or
    "generic"; run(confs, mesh, **kw) -> DTensor."""
    a = schedules.transverse_field(2.5, 1e-8, steps, device=CPU)
    confs = sa.random_state(gen(7), slices * problem.nspins, batch=(chains,),
                            device=CPU).reshape(chains, slices, -1)
    engine = (trotter.anneal_sharded_split if kind == "split"
              else trotter.anneal_sharded)

    def run(c, mesh, **kw):
        return engine(problem, a, torch.ones_like(a), 1.0 / slices, c,
                      gen(seed), mesh, **kw)
    return confs, a, torch.ones_like(a), 1.0 / slices, run


# kind -> (engine, problem): the split engine on an even lattice, the
# generic one on an IsingProblem and on an odd torus's checkerboard
TROTTER_PROBLEMS = {"split": ("split", lambda: lattice(4)),
                    "generic": ("generic", ising4),
                    "generic_lattice": ("generic", lambda: lattice(5))}


def case_trotter(kind, mesh_kind, slices=8, dtensor=False, **kw):
    """A Trotter-sharded run without line moves on `mesh_kind`; with
    dtensor, confs go in chain-sharded."""
    mesh = _mesh(mesh_kind)
    engine, problem = TROTTER_PROBLEMS[kind]
    confs, *_, run = trotter_case(engine, problem(), slices, chains=4)
    chains_sharded = mesh_kind == "chains_x_replica"
    if dtensor:
        confs = shard_chains(confs, mesh)
    out = run(confs, mesh, chains_sharded=chains_sharded, **kw)
    return _numpy(out), str(list(out.placements))


def case_one_rank_ring(kind, global_moves):
    """A Trotter-sharded run on a (chains, replica = 1) mesh, each rank's
    ring its own: whether the one-rank exchange handed back the rows
    themselves and the one-rank sum the tensor itself (no copy), and the
    run."""
    mesh = _mesh("chains_x_replica")
    group = mesh.get_group("replica")
    rows, part = torch.zeros(2, 3, 4), torch.zeros(2, 4)
    halos = _collectives.ring_halo(rows[:, -1], rows[:, 0], group)
    no_copy = (halos[0].data_ptr() == rows[:, -1].data_ptr()
               and halos[1].data_ptr() == rows[:, 0].data_ptr()
               and _collectives.axis_sum(part, group) is part)
    engine, problem = TROTTER_PROBLEMS[kind]
    confs, *_, run = trotter_case(engine, problem(), 8, chains=4)
    out = run(confs, mesh, chains_sharded=True, global_moves=global_moves)
    return no_copy, _numpy(out)


def case_trotter_chained(kind, mesh_kind):
    """Two Trotter-sharded runs without line moves, the second on the
    first's DTensor as it came back, with the number of gathers the second
    call made (none: the state is already placed as the engine wants)."""
    mesh = _mesh(mesh_kind)
    engine, problem = TROTTER_PROBLEMS[kind]
    confs, *_, run = trotter_case(engine, problem(), 8, chains=4)
    chains_sharded = mesh_kind == "chains_x_replica"
    first = run(confs, mesh, chains_sharded=chains_sharded)
    gathers = []
    gather = _collectives.gather
    _collectives.gather = lambda *a, **k: gathers.append(1) or gather(*a,
                                                                     **k)
    try:
        out = run(first, mesh, chains_sharded=chains_sharded)
    finally:
        _collectives.gather = gather
    return _numpy(out), len(gathers)


def case_ground_state(kind):
    """The Trotter-sharded anneal with global moves on the replica mesh
    (JAX test_parallel.py:153 and :354): (best slice energy, brute-force
    ground energy)."""
    mesh = _mesh("replica")
    if kind == "split":
        problem, slices = lattice(4), 16
    else:
        problem, slices = ising4(), 8
    s0 = sa.anneal(problem, schedules.pre_anneal_schedule(3.0, 1.0,
                                                          device=CPU),
                   sa.random_state(gen(1), problem.nspins, batch=(4,),
                                   device=CPU), gen(2), mcsteps=5)
    a = schedules.transverse_field(3.0, 1e-8, 300, device=CPU)
    engine = (trotter.anneal_sharded_split if kind == "split"
              else trotter.anneal_sharded)
    out = pmesh.full_tensor(engine(problem, a, torch.ones_like(a),
                                   1.0 / slices, qmc.replicate(s0, slices),
                                   gen(3), mesh, global_moves=True))
    values_ok = bool(((out == 1) | (out == -1)).all())
    return (float(qmc.best_slice_energy(problem, out).min()),
            dryrun.brute_force_ground(problem), values_ok)


def case_zero_temperature():
    """JAX test_parallel.py:172: at T -> 0 the sharded generic sweep takes
    only downhill moves. Returns (confs before, confs after)."""
    problem = instances.random_2d_lattice(3, rng=0, device=CPU)[0]
    slices = 8
    confs = qmc.replicate(sa.random_state(gen(2), problem.nspins,
                                          device=CPU), slices)
    confs[3, :4] *= -1.0
    a = torch.full((4,), 1.0)
    out = trotter.anneal_sharded(problem, a, torch.ones(4), 1e-6, confs,
                                 gen(2), _mesh("replica"))
    return confs.numpy(), _numpy(out)


def equilibrium_problem():
    return IsingProblem.from_edges(2, [0], [1], [0.8], maxnb=1, device=CPU)


def case_equilibrium(chains=192, steps=250):
    """JAX test_parallel.py:279: N = 2, P = 8, weak Trotter coupling, the
    sharded sweep from random states; returns the final confs."""
    slices, temp, gamma = 8, 0.8, 8.0
    g = gen(9)
    confs = (torch.randint(0, 2, (chains, slices, 2), generator=g).float()
             * 2 - 1)
    a = torch.full((steps,), gamma)
    out = trotter.anneal_sharded(equilibrium_problem(), a, torch.ones_like(a),
                                 temp, confs, gen(9), _mesh("replica"))
    return _numpy(out)


def case_split_statistics(chains=128, steps=250):
    """JAX test_parallel.py:397 on a 2 x 2 lattice at P = 16: the sharded
    split engine with line moves (seed 31) beside the single-device one
    (seed 33); returns both final states."""
    problem = lattice(2)
    slices, temp, gamma = 16, 0.8, 6.0
    confs = qmc.replicate(sa.random_state(gen(31), problem.nspins,
                                          batch=(chains,), device=CPU),
                          slices)
    a = torch.full((steps,), gamma)
    b = torch.ones_like(a)
    out = trotter.anneal_sharded_split(problem, a, b, temp, confs, gen(31),
                                       _mesh("replica"), global_moves=True)
    ref = qmc.anneal(problem, a, b, temp, confs, gen(33), global_moves=True)
    return _numpy(out), ref.numpy()


# ------------------------------------------ the rest of the Trotter axis


# kind -> the problem of the sharded bath: an IsingProblem, an odd torus and
# an even lattice on their own checkerboards
BATH_PROBLEMS = {"ising": ising4, "odd_lattice": lambda: lattice(5),
                 "even_lattice": lambda: lattice(4)}


def bath_case(kind, slices, chains=4, steps=5):
    """(problem, confs, a, b, temp, lookuptable) of a sharded bath run."""
    problem = BATH_PROBLEMS[kind]()
    g = gen(11)
    confs = (torch.randint(0, 2, (chains, slices, problem.nspins),
                           generator=g).float() * 2 - 1)
    a = schedules.transverse_field(2.0, 0.2, steps, device=CPU)
    return (problem, confs, a, torch.ones_like(a), 0.4,
            schedules.bath_lookuptable(slices, 0.3, device=CPU))


def case_bath_sharded(kind, slices, global_moves, mesh_kind="replica"):
    """anneal_sharded(lookuptable=) on `mesh_kind` (chains x replica: one
    rank on the replica axis), generator seed 13."""
    problem, confs, a, b, temp, lut = bath_case(kind, slices)
    out = trotter.anneal_sharded(
        problem, a, b, temp, confs, gen(13), _mesh(mesh_kind),
        global_moves=global_moves, lookuptable=lut,
        chains_sharded=mesh_kind == "chains_x_replica")
    return _numpy(out), str(list(out.placements))


def asymmetric_table(slices, alpha):
    """bath_lookuptable(slices, alpha) with the couplings of ring offsets
    d < P / 2 scaled by 1.5 (tests/test_torch_cluster.py::asymmetric_table):
    not symmetric in ring distance, so a bath pair may bond one way only."""
    lut = schedules.bath_lookuptable(slices, alpha, device=CPU)
    d = torch.arange(1, slices)
    return torch.where(2 * d < slices, lut * 1.5, lut).contiguous()


def cluster_case(kind, slices=8, with_fields=False, bath=False,
                 rule="local", steps=20):
    """(problem, confs, a, kwargs) of a sharded cluster run (JAX
    test_parallel.py:448-532's setups): the random 4 x 4 lattice's
    generic form, one replicated chain, Gamma: 2.5 -> 1e-8; bath "asym"
    takes `asymmetric_table`."""
    problem = instances.random_2d_lattice(4, rng=0, with_fields=with_fields,
                                          device=CPU)[0]
    confs = qmc.replicate(sa.random_state(gen(7), problem.nspins,
                                          device=CPU), slices)
    a = schedules.transverse_field(2.5, 1e-8, steps, device=CPU)
    kw = {"lookuptable": (asymmetric_table(slices, 0.2) if bath == "asym"
                          else schedules.bath_lookuptable(
                              slices, 0.2, device=CPU) if bath else None)}
    if kind == "wolff":
        kw["rule"] = rule
    return problem, confs, a, kw


def case_cluster_sharded(kind, **kw):
    """anneal_wolff_sharded / anneal_sw_sharded on the replica mesh,
    generator seed 9: (state, placements, rounds a step)."""
    problem, confs, a, kwargs = cluster_case(kind, **kw)
    engine = (trotter.anneal_wolff_sharded if kind == "wolff"
              else trotter.anneal_sw_sharded)
    stats = {}
    out = engine(problem, a, torch.ones_like(a), 1.0 / confs.shape[0], confs,
                 gen(9), _mesh("replica"), stats=stats, **kwargs)
    return _numpy(out), str(list(out.placements)), stats["rounds"]


def case_bath_zero_temperature():
    """JAX test_parallel.py:215: at T -> 0 the sharded bath takes only
    downhill moves (P = 8, replica = world). Returns (before, after)."""
    problem = instances.random_2d_lattice(3, rng=0, device=CPU)[0]
    slices = 8
    confs = qmc.replicate(sa.random_state(gen(5), problem.nspins,
                                          device=CPU), slices)
    confs[2, :3] *= -1.0
    lut = schedules.bath_lookuptable(slices, 1e-2, device=CPU)
    a = torch.full((3,), 0.9)
    out = trotter.anneal_sharded(problem, a, torch.ones(3), 1e-6, confs,
                                 gen(5), _mesh("replica"), lookuptable=lut)
    return confs.numpy(), _numpy(out)


# JAX test_parallel.py:234's equilibrium run but for P, which the port
# takes as the world size (one slice a rank, the ring coloured)
BATH_EQUILIBRIUM = dict(temp=0.7, gamma=1.2, alpha=2e-2, chains=48, burn=25,
                        tail=50, seg=2)


def bath_equilibrium_run(step, slices):
    """JAX test_parallel.py:234's collection at P = `slices`: 48 random
    chains of the random 3 x 3 lattice, `burn` segments of `seg` sweeps,
    then the confs after each of `tail` more, every segment from its own
    generator. step(problem, a, b, temp, confs, generator, lut) -> confs."""
    c = BATH_EQUILIBRIUM
    problem = instances.random_2d_lattice(3, rng=0, device=CPU)[0]
    confs = (torch.randint(0, 2, (c["chains"], slices, problem.nspins),
                           generator=gen(17)).float() * 2 - 1)
    a = torch.full((c["seg"],), c["gamma"])
    lut = schedules.bath_lookuptable(slices, c["alpha"], device=CPU)
    tails = []
    for t in range(c["burn"] + c["tail"]):
        confs = step(problem, a, torch.ones_like(a), c["temp"], confs,
                     gen(1000 + t), lut)
        if t >= c["burn"]:
            tails.append(confs.numpy())
    return np.stack(tails)


def case_bath_equilibrium():
    """The sharded bath's equilibrium run at one slice a rank."""
    mesh = _mesh("replica")

    def step(problem, a, b, temp, confs, g, lut):
        return pmesh.full_tensor(trotter.anneal_sharded(
            problem, a, b, temp, confs, g, mesh, lookuptable=lut))
    return bath_equilibrium_run(step, dist.get_world_size())


def _message(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def case_refusals():
    """The messages of every call the port refuses on a sharded state, an
    indivisible axis, or a sharded sampler state not of the JAX sampler's
    shape."""
    mesh = _mesh("replica")
    cmesh = _mesh("chains")
    lat, prob = lattice(4), ising4()
    world = dist.get_world_size()
    slices = 2 * world - 2  # P/2 = world - 1: no replica axis divides it
    a = schedules.transverse_field(2.0, 1e-8, 2, device=CPU)
    b = torch.ones_like(a)
    c = qmc.replicate(sa.random_state(gen(0), 16, batch=(world,),
                                      device=CPU), slices)
    s = shard_chains(sa.random_state(gen(0), 16, batch=(world,),
                                     device=CPU), cmesh)
    cs = shard_chains(qmc.replicate(sa.random_state(
        gen(0), 16, batch=(world,), device=CPU), 4), cmesh)
    sched = schedules.linear(1.0, 0.1, 2, device=CPU)
    # a sampler's sharded state with the port's leading ladder axes, and
    # ICM's state sharded on its ladder axis
    temps = pt.geometric_ladder(0.5, 3.0, world, device=CPU)
    ladders = shard_chains(sa.random_state(gen(0), 16, batch=(world, 2,
                                                               world),
                                           device=CPU), cmesh)
    icm0 = shard_chains(sa.random_state(gen(0), 16, batch=(2 * world, world),
                                        device=CPU), cmesh)
    return {
        "shard_indivisible": _message(lambda: shard_chains(sa.random_state(
            gen(0), 16, batch=(world + 1,), device=CPU), cmesh)),
        "split_indivisible": _message(lambda: trotter.anneal_sharded_split(
            lat, a, b, 0.3, c, gen(0), mesh)),
        "generic_indivisible": _message(lambda: trotter.anneal_sharded(
            prob, a, b, 0.3, c[:, :world - 1], gen(0), mesh)),
        "rng": _message(lambda: trotter.anneal_sharded_split(
            lat, a, b, 0.3, c, gen(0), mesh, rng="fast")),
        "bath_indivisible": _message(lambda: trotter.anneal_sharded(
            prob, a, b, 0.3, c[:, :world - 1], gen(0), mesh,
            lookuptable=_lut(4))),
        "wolff_indivisible": _message(lambda: trotter.anneal_wolff_sharded(
            prob, a, b, 0.3, c[0, :world - 1], gen(0), mesh)),
        "sw_indivisible": _message(lambda: trotter.anneal_sw_sharded(
            prob, a, b, 0.3, c[0, :world - 1], gen(0), mesh)),
        "sa_wolff": _message(lambda: sa.anneal_wolff(prob, sched, s,
                                                     gen(0))),
        "sa_sw": _message(lambda: sa.anneal_sw(prob, sched, s, gen(0))),
        "qmc_wolff": _message(lambda: qmc.anneal_wolff(prob, a, b, 0.3, cs,
                                                       gen(0))),
        "qmc_sw": _message(lambda: qmc.anneal_sw(prob, a, b, 0.3, cs,
                                                 gen(0))),
        "qmc_sw_bath": _message(lambda: qmc.anneal_sw_bath(
            prob, a, b, 0.3, _lut(), cs, gen(0))),
        "pt_ladders": _message(lambda: pt.sample(prob, temps, ladders, gen(0),
                                                 2)),
        "icm_on_dim0": _message(lambda: pt.sample_icm(prob, temps, icm0,
                                                      gen(0), 2)),
        "pa_piqmc_ladders": _message(lambda: pa.sample_piqmc(
            prob, a, 0.3, shard_chains(qmc.replicate(ladders.full_tensor(),
                                                     4), cmesh), gen(0))),
        "masked_lattice": _message(lambda: sa.anneal(lat, sched, s, gen(0),
                                                     engine="masked")),
        "trotter_state_to_qmc": _message(lambda: qmc.anneal(
            lat, a, b, 0.3, trotter.anneal_sharded_split(
                lat, a, b, 0.3, qmc.replicate(sa.random_state(
                    gen(0), 16, batch=(2,), device=CPU), 2 * world),
                gen(0), mesh), gen(0))),
    }


def case_dryrun_legs():
    """The dry run's legs on this pool's ranks, as two hosts of half the
    ranks each (leg 7's LOCAL_WORLD_SIZE, as dryrun_multichip sets it)."""
    world = dist.get_world_size()
    os.environ["LOCAL_WORLD_SIZE"] = str(world // 2)
    try:
        return dryrun.legs(world, "cpu")
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]


# ------------------------------------------------ disorder and multihost


def disorder_case(realizations=4, chains=8, steps=30):
    """(problems, sched, states, generators) of a disorder batch of
    random_2d_lattice(4) realizations (tests/multihost_worker.py's), from
    seeds alone: the same on every rank and in the test process."""
    probs = [instances.random_2d_lattice(4, rng=1000 + i, device=CPU)[0]
             for i in range(realizations)]
    states = sa.random_state(gen(7), 16, batch=(realizations, chains),
                             device=CPU)
    sched = schedules.linear(2.0, 0.1, steps, device=CPU)
    return probs, sched, states, [gen(70 + i) for i in range(realizations)]


DISORDER_SOLVERS = {
    "sa": sa.anneal,
    # a solver other than sa.anneal runs realization by realization, each
    # on its block of a chain-sharded state
    "sa_wolff": sa.anneal_wolff,
}


def case_disorder_sharded(solver, disorder_axis, hosts=1):
    """run_disorder_sharded on a (disorder_axis, world / disorder_axis)
    dcn_mesh of `hosts` hosts: (the full result, its placements, this
    rank's block shape)."""
    world = dist.get_world_size()
    os.environ["LOCAL_WORLD_SIZE"] = str(world // hosts)
    try:
        mesh = multihost.dcn_mesh(disorder=disorder_axis,
                                  device_type="cpu")
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    probs, sched, states, gens = disorder_case()
    out = multihost.run_disorder_sharded(DISORDER_SOLVERS[solver], probs,
                                         sched, states, gens, mesh)
    return (_numpy(out), str(list(out.placements)),
            tuple(out.to_local().shape))


def case_dcn_mesh():
    """dcn_mesh's shapes and rows on this pool's ranks, on one host and on
    two (LOCAL_WORLD_SIZE = world / 2), the errors of sizes that do not
    fit, and initialize() on the group that exists."""
    world = dist.get_world_size()
    out = {"initialize": multihost.initialize()}

    def shape(**kw):
        m = multihost.dcn_mesh(device_type="cpu", **kw)
        return tuple(m.mesh.shape), m.mesh.tolist(), m.mesh_dim_names
    out["default"] = shape()
    out["given"] = shape(disorder=2, chains=world // 2)
    out["chains_2"] = shape(chains=2)
    out["too_many"] = _message(lambda: shape(disorder=world, chains=2))
    os.environ["LOCAL_WORLD_SIZE"] = str(world // 2)
    try:
        out["two_hosts"] = shape()
        out["two_hosts_rows_1"] = shape(disorder=world, chains=1)
        out["not_a_multiple"] = _message(lambda: shape(disorder=1))
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    return out


def numpy_of(x):
    """A result of the test process's own unsharded runs as numpy."""
    if isinstance(x, tuple):
        return tuple(numpy_of(y) for y in x)
    return np.asarray(x.cpu())


# ------------------------------------------------ the samplers, sharded


def ising3():
    """The random 3 x 3 lattice's generic form (odd L: JAX's generic
    engine case, tests/test_parallel.py:564)."""
    return instances.random_2d_lattice(3, rng=0, device=CPU)[0]


def _pt(problem, rungs=8, sweeps=40, **kw):
    temps = pt.geometric_ladder(0.5, 3.0, rungs, device=CPU)
    state = sa.random_state(gen(8), problem.nspins, batch=(rungs,),
                            device=CPU)
    return state, 0, lambda s: pt.sample(problem, temps, s, gen(8), sweeps,
                                         swap_every=2, **kw)


def _qpt(problem, rungs=8, slices=4, sweeps=30, **kw):
    gammas = torch.tensor(np.geomspace(2.0, 0.3, rungs), dtype=torch.float32)
    confs = (torch.randint(0, 2, (rungs, slices, problem.nspins),
                           generator=gen(10)).float() * 2 - 1)
    return confs, 0, lambda c: pt.sample_piqmc(
        problem, gammas, 0.5, c, gen(10), sweeps, swap_every=2, **kw)


def _icm(problem, rungs=8, sweeps=30, **kw):
    temps = pt.geometric_ladder(0.5, 3.0, rungs, device=CPU)
    state = sa.random_state(gen(2), problem.nspins, batch=(2, rungs),
                            device=CPU)
    return state, 1, lambda s: pt.sample_icm(problem, temps, s, gen(2),
                                             sweeps, houdayer_every=2, **kw)


def _pa(problem, reads=8, **kw):
    temps = pa.beta_linear(3.0, 16, beta_start=0.0, device=CPU)
    state = sa.random_state(gen(4), problem.nspins, batch=(reads,),
                            device=CPU)
    return state, 0, lambda s: pa.sample(problem, temps, s, gen(4),
                                         mcsteps=2, beta0=0.0,
                                         collect_stats=True, **kw)


def _pa_adaptive(problem, reads=8):
    state = sa.random_state(gen(5), problem.nspins, batch=(reads,),
                            device=CPU)
    return state, 0, lambda s: pa.sample_adaptive(problem, 2.0, s, gen(5),
                                                  mcsteps=2, max_steps=30)


def _paq(problem, reads=8, slices=4, **kw):
    gammas = torch.linspace(2.0, 0.5, 12)
    confs = qmc.replicate(sa.random_state(gen(6), problem.nspins,
                                          batch=(reads,), device=CPU),
                          slices)
    return confs, 0, lambda c: pa.sample_piqmc(
        problem, gammas, 0.5, c, gen(6), collect_stats=True, **kw)


def _paq_adaptive(problem, reads=8, slices=4):
    confs = qmc.replicate(sa.random_state(gen(7), problem.nspins,
                                          batch=(reads,), device=CPU),
                          slices)
    return confs, 0, lambda c: pa.sample_piqmc_adaptive(
        problem, 2.0, 0.3, 0.5, c, gen(7), target_frac=0.99, max_steps=20,
        global_moves=True)


def _svmc(problem, **kw):
    a = schedules.transverse_field(2.0, 1e-3, 10, device=CPU)
    theta = svmc.random_state(gen(3), problem.nspins, batch=(CHAINS,),
                              device=CPU)
    return theta, 0, lambda th: svmc.anneal(problem, a, torch.ones_like(a),
                                            0.2, th, gen(3), **kw)


def noisy_tables(problem, steps, seed=0):
    """Per-step tables nbr_J (1 + 0.1 xi), h (1 + 0.1 xi) of `problem`,
    xi standard normals from numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    nbr_J = problem.nbr_J.numpy()[None] * (
        1.0 + 0.1 * rng.standard_normal((steps,) + problem.nbr_J.shape))
    h = problem.h.numpy()[None] * (
        1.0 + 0.1 * rng.standard_normal((steps, problem.nspins)))
    return nbr_J.astype(np.float32), h.astype(np.float32)


def _sa_noisy(problem, steps=8):
    nbr_J, h = noisy_tables(problem, steps)
    sched = schedules.linear(2.0, 0.1, steps, device=CPU)
    state = sa.random_state(gen(11), problem.nspins, batch=(CHAINS,),
                            device=CPU)
    return state, 0, lambda s: sa.anneal_noisy(problem, sched, nbr_J, h, s,
                                               gen(11), mcsteps=2)


def _svmc_noisy(problem, steps=8):
    nbr_J, h = noisy_tables(problem, steps)
    a = schedules.transverse_field(2.0, 1e-3, steps, device=CPU)
    theta = svmc.random_state(gen(12), problem.nspins, batch=(CHAINS,),
                              device=CPU)
    return theta, 0, lambda th: svmc.anneal_noisy(
        problem, a, torch.ones_like(a), 0.2, nbr_J, h, th, gen(12),
        tf=True)


# sampler -> () -> (state, sharded dim, run): run(state) is one entry
# point that takes a sharded state, on a full or a chain-sharded state (JAX's test shapes,
# tests/test_parallel.py:539-598 and tests/test_pt.py:316-337, and an odd
# lattice); each output is compared whole
SAMPLERS = {
    "pt_split": lambda: _pt(lattice(4), sweeps=60, collect_energy=True,
                            per_pair_rates=True),
    "pt_generic": lambda: _pt(ising3()),
    "pt_odd_lattice": lambda: _pt(lattice(5), per_pair_rates=True),
    "qpt_split": lambda: _qpt(lattice(4), global_moves=True),
    "qpt_generic": lambda: _qpt(ising4(), slices=3, per_pair_rates=True),
    "qpt_odd_lattice": lambda: _qpt(lattice(5), global_moves=True),
    "icm_split": lambda: _icm(lattice(4), collect_energy=True,
                              per_pair_rates=True),
    "icm_generic": lambda: _icm(ising3()),
    "icm_odd_lattice": lambda: _icm(lattice(5)),
    "pa_split": lambda: _pa(lattice(4)),
    "pa_generic": lambda: _pa(ising4(), ess_threshold=0.5,
                              resample="multinomial"),
    "pa_odd_lattice": lambda: _pa(lattice(5), ess_threshold=0.7),
    "pa_adaptive": lambda: _pa_adaptive(lattice(4)),
    "pa_adaptive_generic": lambda: _pa_adaptive(ising3()),
    "paq_split": lambda: _paq(lattice(4), global_moves=True),
    "paq_generic": lambda: _paq(ising4(), slices=3, ess_threshold=0.6),
    "paq_adaptive": lambda: _paq_adaptive(lattice(4)),
    "paq_adaptive_generic": lambda: _paq_adaptive(ising3(), slices=3),
    "svmc_split": lambda: _svmc(lattice(4), tf=True, collect_energy=True),
    "svmc_plane": lambda: _svmc(lattice(5), tf=True),
    "svmc_packed": lambda: _svmc(ising4(), collect_energy=True),
    "svmc_noisy": lambda: _svmc_noisy(ising4()),
    "sa_noisy": lambda: _sa_noisy(ising4()),
}


def flat(out):
    """A sampler's outputs as a tuple of numpy arrays, in order: DTensors
    gathered, a stats dict by sorted key, numbers as 0-d arrays."""
    if isinstance(out, tuple):
        return sum((flat(x) for x in out), ())
    if isinstance(out, dict):
        return sum((flat(out[k]) for k in sorted(out)), ())
    if torch.is_tensor(out):
        return (pmesh.full_tensor(out).numpy(),)
    return (np.asarray(out),)


def placements(out):
    """The placements of every DTensor among the outputs, in order."""
    outs = out if isinstance(out, tuple) else (out,)
    return [str(list(x.placements)) for x in outs
            if hasattr(x, "placements")]


def case_sampler_sharded(sampler, mesh_kind="chains"):
    """The sampler's run on its state sharded along its chain dim over
    `mesh_kind`: (outputs, placements of the DTensors among them)."""
    state, dim, run = SAMPLERS[sampler]()
    mesh = _mesh(mesh_kind)
    out = run(pmesh.as_dtensor(pmesh.local_block(state, mesh,
                                                 {dim: "chains"}),
                               mesh, {dim: "chains"}, tuple(state.shape)))
    return flat(out), placements(out)


def case_sampler_gathers(sampler):
    """The gathers a rung- or population-sharded run makes and the bytes
    each rank sends in them (`_collectives.gather`'s tensors)."""
    state, dim, run = SAMPLERS[sampler]()
    mesh = _mesh("chains")
    sent = []
    gather = _collectives.gather

    def counting(t, group, d):
        sent.append(t.numel() * t.element_size())
        return gather(t, group, d)
    _collectives.gather = counting
    try:
        run(pmesh.as_dtensor(pmesh.local_block(state, mesh, {dim: "chains"}),
                             mesh, {dim: "chains"}, tuple(state.shape)))
    finally:
        _collectives.gather = gather
    return sent


def dense_case(chains=64, n=64, steps=30):
    """(problem, state, run) of a dense anneal: sk_model(n), T 3 -> 0.05."""
    problem = instances.sk_model(n, rng=0, device=CPU)[0]
    sched = schedules.linear(3.0, 0.05, steps, device=CPU)
    state = sa.random_state(gen(14), n, batch=(chains,), device=CPU)
    return problem, state, lambda s: sa.anneal(problem, sched, s, gen(14))


def case_dense_sharded():
    """sa.anneal on a DenseProblem, chain-sharded: the gathered spins."""
    _, state, run = dense_case()
    return _numpy(run(shard_chains(state, _mesh("chains"))))


# the sharded samplers' bar on the JAX package: ln Z at beta LOG_Z_BETA of the random
# 4 x 4 lattice by PA from beta = 0 (LOG_Z_READS replicas, LOG_Z_STEPS
# steps of LOG_Z_MCSTEPS sweeps), within LOG_Z_TOL of enumeration
LOG_Z_BETA, LOG_Z_READS, LOG_Z_STEPS, LOG_Z_MCSTEPS = 1.0, 512, 32, 4
LOG_Z_TOL = 0.1


def exact_log_z(problem, beta):
    """ln Z(beta) of a problem of at most 20 spins by enumeration, float64
    (the energies float32, as the problem computes them)."""
    n = problem.nspins
    bits = (np.arange(1 << n)[:, None] >> np.arange(n)) & 1
    e = problem.energy(torch.as_tensor(bits * 2 - 1, dtype=torch.float32))
    x = -beta * e.double().numpy()
    return float(x.max() + np.log(np.exp(x - x.max()).sum()))


def log_z_run(state):
    """The port's ln Z estimate of the LOG_Z run on `state` (full or
    population-sharded), seed 3."""
    problem = lattice(4)
    temps = pa.beta_linear(LOG_Z_BETA, LOG_Z_STEPS, beta_start=0.0,
                           device=CPU)
    _, log_z = pa.sample(problem, temps, state, gen(3),
                         mcsteps=LOG_Z_MCSTEPS, beta0=0.0)
    return float(log_z) + pa.uniform_log_z(problem.nspins)


def case_log_z():
    """log_z_run on LOG_Z_READS replicas sharded over the ranks."""
    state = sa.random_state(gen(3), 16, batch=(LOG_Z_READS,), device=CPU)
    return log_z_run(shard_chains(state, _mesh("chains")))


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def serve(rank, world, port, inbox, outbox):
    """A rank of the pool: join the gloo group, then run cases from
    `inbox` until it yields None; each result, or the traceback, goes to
    `outbox` as (rank, ok, payload), the payload of ranks > 0 None."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    while True:
        item = inbox.get()
        if item is None:
            break
        name, kwargs = item
        try:
            out = CASES[name](**kwargs)
            outbox.put((rank, True, out if rank == 0 else None))
        except BaseException:
            outbox.put((rank, False, traceback.format_exc()))
    dist.barrier()
    dist.destroy_process_group()
