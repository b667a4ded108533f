"""Parallel tempering (replica exchange), quantum parallel tempering and
ICM (counterpart of montecarlosolvers_tpu/solvers/pt.py).

The JAX design is kept: exchanges permute the (M,) replica_of_rung labels
and the state arrays never move (pt.py:127-133). Between two exchanges the
chains therefore sweep at a fixed temperature each, temps[labels], and one
kernel launch runs all the sweeps up to the next exchange with that
per-chain vector (the per-chain instantiations of kernels A and B, of the
packed SA, generic PIQMC and dense kernels: `solvers/_engines.py`); the
state stays in the engine's layout from launch to launch. Batch axes of
the states (reads x rungs in solve("pt"), pairs x 2 x rungs in "icm")
flatten into the kernels' chain axis, each chain with its own value.

Draws. The port draws from the counter hash, not `jax.random`: one seed
from the caller's torch.Generator, the sweeps at counter(seed, i, ...) for
sweep i of the run (a launch starting at sweep i passes step0 = i), the
exchange uniforms of the sweep after which they happen on the sampler
stream EXCHANGE, uid ladder * M + rung, and ICM's Houdayer coins on the
stream HOUDAYER (ops/counter_rng.py). So the samplers agree with the JAX
ones in distribution (the exact-Gibbs tests of tests/test_torch_pt.py),
and their pieces bitwise on the same draws: `_exchange_perm` takes its
uniforms as an argument.

The exchange arithmetic on the (M,) vectors stays torch on the chains'
device; energies come from the engine (on the card the split engine's
energy kernel), kinetic terms from `split.qmc_split_kinetic` or its packed
form.

Rung sharding (the JAX samplers shard the ladder by GSPMD annotation,
pt.py:7-10, :132-133, :259). A chain-sharded DTensor state (parallel.
shard_chains: (M, N) or (M, P, N) sharded on the rungs, ICM's (2, M, N) on
dim 1) runs on a `ShardedEngine`: each rank sweeps its rungs' replicas with
their global uids, and every rank computes every exchange from the
gathered energies (or kinetic terms) and the same hash draws, so the label
map, the swap rate and the pair rates come out equal on every rank with no
broadcast, and bitwise the unsharded run's. The rung-ordered states (and
energies) come back as DTensors sharded on the rung axis; the rates are
plain tensors. A sharded state with leading ladder axes raises
ValueError.
"""

from __future__ import annotations

import numpy as np
import torch

from montecarlosolvers_tpu_torch import _roadmap, schedules
from montecarlosolvers_tpu_torch.models.dense import DenseProblem
from montecarlosolvers_tpu_torch.models.lattice import LatticeProblem
from montecarlosolvers_tpu_torch.ops import cluster_kernels
from montecarlosolvers_tpu_torch.ops.cluster_kernels import (rung_labels,
                                                             rung_ordered)
from montecarlosolvers_tpu_torch.ops import counter_rng as cr
from montecarlosolvers_tpu_torch.ops import split as split_ops
from montecarlosolvers_tpu_torch.ops.metropolis import metropolis_accept
from montecarlosolvers_tpu_torch.solvers._engines import (ClassicalEngine,
                                                          QuantumEngine,
                                                          ShardedEngine,
                                                          sharded_state)
from montecarlosolvers_tpu_torch.solvers.sa import draw_seed


def _exchange_perm(u, parity, de_pair, temp):
    """Masked adjacent-pair exchange (JAX `_exchange_perm`, pt.py:46):
    de_pair[..., k] is the Metropolis energy of swapping rungs (k, k + 1)
    at temperature `temp` (a Python float, or a float32 0-d tensor on
    de_pair's device, which the samplers make once a run so that an
    exchange copies nothing from the host); anchors are rungs with k % 2
    == parity and k + 1 < M, accepted on uniforms u (..., M) in the log
    form of `metropolis_accept`. Returns (perm (..., M), accept_anchor
    (..., M))."""
    M = de_pair.shape[-1]
    idx = torch.arange(M, device=de_pair.device)
    is_anchor = (idx % 2 == parity) & (idx + 1 < M)
    partner = torch.where(is_anchor, idx + 1, torch.where(
        (idx % 2 != parity) & (idx > 0), idx - 1, idx))
    t32 = torch.as_tensor(temp, dtype=torch.float32, device=de_pair.device)
    accept_anchor = is_anchor & metropolis_accept(de_pair, t32, u)
    # an index takes part in a swap if it is an accepted anchor or the
    # partner of one
    accept = accept_anchor | torch.roll(accept_anchor, 1, dims=-1)
    return torch.where(accept, partner, idx), accept_anchor


def geometric_ladder(t_min, t_max, num, device=None):
    """Geometric temperature ladder (JAX `geometric_ladder`, pt.py:565),
    float32 on `device` (None: the card): `schedules.geometric`, within a
    float32 ulp of jnp.geomspace. Swap acceptance needs the rung ratio - 1
    to scale like 1/sqrt(N)."""
    return schedules.geometric(t_min, t_max, num, device=device)


def _exchange(values, coef, ror, seed, step, parity, sign, temp):
    """One exchange round of every ladder: values (..., M) per replica
    (energies, or kinetic terms), coef (M,) per rung (beta, or J_perp);
    delta_k = (coef_k - coef_k+1)(v_k - v_k+1) on rung order, the pairs
    accepted on `_exchange_perm` of sign * delta at `temp` (a float32 0-d
    tensor): -delta at T = 1 classically (pt.py:150-153), +delta at T_eff
    for the Gamma ladder (:260-262). Returns the new ror and the accepted
    anchors (..., M)."""
    M = ror.shape[-1]
    nxt = torch.clamp(torch.arange(M, device=ror.device) + 1, max=M - 1)
    v = torch.gather(values, -1, ror)  # rung-ordered
    delta = (coef - coef[nxt]) * (v - v[..., nxt])
    u = cr.sampler_uniforms(seed, step, cr.EXCHANGE, ror.numel(),
                            ror.device).reshape(ror.shape)
    perm, acc = _exchange_perm(u, parity, -delta if sign < 0 else delta,
                               temp)
    return torch.gather(ror, -1, perm), acc


def _events(nsweeps, cadences):
    """The sweep launches of a run: (first sweep, sweeps) up to and
    including each sweep i after which some event of `cadences` fires (i %
    c == 0 for a cadence c > 0), then the rest."""
    out, start = [], 0
    for i in range(nsweeps):
        if any(c and i % c == 0 for c in cadences) or i == nsweeps - 1:
            out.append((start, i + 1 - start))
            start = i + 1
    return out


class _Ladders:
    """Exchange bookkeeping of B ladders of M rungs: replica_of_rung, the
    accepted anchors and the attempts (pt.py:135-172)."""

    def __init__(self, batch, M, device):
        self.ror = torch.arange(M, device=device).expand(
            batch + (M,)).contiguous()
        self.nacc = torch.zeros(batch + (M,), dtype=torch.int32,
                                device=device)
        self.natt = torch.zeros(M, dtype=torch.int32, device=device)
        self.idx = torch.arange(M, device=device)

    def attempt(self, parity):
        M = self.idx.shape[0]
        self.natt += ((self.idx % 2 == parity) & (self.idx + 1 < M)).to(
            torch.int32)

    def swap_rate(self, ladders=1):
        """Per ladder: accepted / attempted anchors (a 0-d tensor for one
        ladder, as the JAX sampler returns)."""
        den = torch.clamp(ladders * self.natt.sum(), min=1)
        return self.nacc.sum(-1).to(torch.float32) / den.to(torch.float32)

    def pair_rates(self, nacc, ladders=1):
        den = torch.clamp(ladders * self.natt, min=1).to(torch.float32)
        return (nacc.to(torch.float32) / den)[..., :-1]


def sample(problem, temps, states, generator, nsweeps, swap_every=1,
           collect_energy=False, per_pair_rates=False):
    """Run parallel tempering (JAX `sample`, pt.py:67).

    problem: LatticeProblem, IsingProblem or DenseProblem. temps: (M,)
    temperature ladder (ascending or descending). states: (..., M, N)
    float32 +/-1, one configuration a rung of each ladder (the JAX sampler
    takes one ladder; leading axes here are independent ladders on one
    seed, each its own chains). generator: torch.Generator the hash seed is
    drawn from. nsweeps: sweeps a replica; swap_every: exchange cadence;
    per_pair_rates: also return the (..., M-1) per-pair acceptance rates.

    Returns (states rung-ordered, swap_rate (a tensor of the batch shape)
    [, energies (nsweeps, ..., M) rung-ordered][, pair_rates]).

    states may be an (M, N) DTensor sharded on the rungs (module
    docstring): the states and energies then come back sharded on the rung
    axis, bitwise the unsharded run's."""
    _roadmap.require_problem(problem)
    dev = problem.device
    temps = torch.as_tensor(temps, dtype=torch.float32, device=dev)
    M = temps.shape[0]
    batch = states.shape[:-2]
    n = states.shape[-1]
    seed = draw_seed(generator)
    sharded = _roadmap.is_sharded(states)
    if sharded:
        sharded_state(states, 2, 0, "pt.sample")
        eng = ShardedEngine(lambda s, c0: ClassicalEngine(problem, s, c0),
                            states)
    else:
        eng = ClassicalEngine(problem, states.reshape(-1, n))
    lad = _Ladders(batch, M, dev)
    beta = 1.0 / temps
    one = torch.ones((), device=dev)
    es = []
    cadence = 1 if collect_energy else swap_every
    for start, steps in _events(int(nsweeps), (cadence,)):
        eng.sweep(temps[rung_labels(lad.ror)].reshape(-1), seed, start, steps)
        i = start + steps - 1
        e = None
        if i % swap_every == 0:
            parity = (i // swap_every) % 2
            e = eng.energy().reshape(batch + (M,))
            lad.ror, acc = _exchange(e, beta, lad.ror, seed, i, parity, -1,
                                     one)
            lad.nacc += acc.to(torch.int32)
            lad.attempt(parity)
        if collect_energy:  # the exchange moved labels, not states
            if e is None:
                e = eng.energy().reshape(batch + (M,))
            es.append(torch.gather(e, -1, lad.ror))
    out_states = rung_ordered(eng.full().reshape(batch + (M, n)), lad.ror)
    out = (eng.placed(out_states) if sharded else out_states,
           lad.swap_rate())
    if collect_energy:
        es = torch.stack(es)
        out = out + (eng.placed(es, 1) if sharded else es,)
    if per_pair_rates:
        out = out + (lad.pair_rates(lad.nacc),)
    return out


def sample_piqmc(problem, gammas, temp, confs, generator, nsweeps, b=1.0,
                 swap_every=1, global_moves=False, per_pair_rates=False):
    """Quantum parallel tempering along a transverse-field ladder at fixed
    temperature (JAX `sample_piqmc`, pt.py:184): rung m sweeps at Gamma =
    gammas[m] (J_perp per chain on kernel B or the generic PIQMC kernel);
    adjacent rungs exchange Gamma labels with
    p = min(1, exp(-(J_perp_i - J_perp_j)(K_i - K_j) / T_eff)).

    confs: (..., M, P, N); temp: per-slice temperature (T_eff = P temp).
    A DenseProblem is refused, as in the JAX package. Returns (confs
    rung-ordered, swap_rate[, pair_rates]). confs may be an (M, P, N)
    DTensor sharded on the rungs, as `sample` takes its states."""
    dev = problem.device
    gammas = torch.as_tensor(gammas, dtype=torch.float32, device=dev)
    M = gammas.shape[0]
    batch = confs.shape[:-3]
    slices, n = confs.shape[-2:]
    sharded = _roadmap.is_sharded(confs)
    if sharded:
        sharded_state(confs, 3, 0, "pt.sample_piqmc")
        eng = ShardedEngine(lambda c, c0: QuantumEngine(
            problem, c, temp, b, global_moves, "pt.sample_piqmc", c0), confs)
    else:
        eng = QuantumEngine(problem, confs.reshape(-1, slices, n), temp, b,
                            global_moves, "pt.sample_piqmc")
    jps = schedules.jperp(gammas, eng.teff)
    teff = torch.tensor(eng.teff, dtype=torch.float32, device=dev)
    seed = draw_seed(generator)
    lad = _Ladders(batch, M, dev)
    for start, steps in _events(int(nsweeps), (swap_every,)):
        eng.sweep(jps[rung_labels(lad.ror)].reshape(-1), seed, start, steps)
        i = start + steps - 1
        if i % swap_every == 0:
            parity = (i // swap_every) % 2
            kk = eng.kinetic().reshape(batch + (M,))
            lad.ror, acc = _exchange(kk, jps, lad.ror, seed, i, parity, 1,
                                     teff)
            lad.nacc += acc.to(torch.int32)
            lad.attempt(parity)
    out_confs = rung_ordered(eng.full().reshape(batch + (M, slices, n)),
                              lad.ror)
    out = (eng.placed(out_confs) if sharded else out_confs, lad.swap_rate())
    if per_pair_rates:
        out = out + (lad.pair_rates(lad.nacc),)
    return out


def _check_grid_bonds(grid_bonds, nspins):
    """Raise ValueError unless `grid_bonds` is a tuple of k same-shape bond
    masks over a k-D grid of `nspins` sites (`cluster.grid_bonds_from_edges`
    on the problem's edges)."""
    shapes = [tuple(np.shape(m)) for m in grid_bonds]
    if (not shapes or any(s != shapes[0] for s in shapes)
            or len(shapes[0]) != len(shapes)
            or int(np.prod(shapes[0])) != nspins):
        raise ValueError(
            f"grid_bonds must be one mask an axis of a grid of {nspins} "
            f"sites, got shapes {shapes}")


def sample_icm(problem, temps, states, generator, nsweeps, swap_every=1,
               houdayer_every=2, collect_energy=False, per_pair_rates=False,
               grid_bonds=None):
    """Isoenergetic cluster moves + parallel tempering (JAX `sample_icm` /
    `_icm_impl`, pt.py:302-481): two PT ladders side by side, and every
    `houdayer_every` sweeps each same-rung replica pair exchanges energy by
    a Houdayer move (every q = -1 overlap component coin-flipped in both
    replicas; csrc/houdayer.cu on the card). houdayer_every=0 runs the two
    ladders as PT through the same code path with no move, the honest
    baseline.

    problem: LatticeProblem or IsingProblem (a DenseProblem raises
    ValueError, as in the JAX package). states: (..., 2, M, N), the leading
    axes independent pairs of ladders. The move runs on the problem's
    generic form in site order (a lattice's to_generic(), whose site ids
    are the grid's raveled index, the order of JAX's grid form). An even-L
    lattice sweeps on the split engine, whose state is unpacked to that
    order and repacked around each move, as the JAX sampler unpacks its
    halves (pt.py:435-444); any other problem sweeps on the generic form
    itself (pt.py:393-399: an odd-L lattice on its IsingProblem's proper
    coloring, not the masked checkerboard `sample` sweeps).

    grid_bonds: the JAX option (pt.py:302-304), per-axis bond masks of a
    grid instance (`ops/cluster.py::grid_bonds_from_edges`). It is taken
    and its shape checked against the problem (ValueError), and nothing
    else: in JAX it picks a faster labeler of the same components (the
    grid form labels as the generic one, tests/test_torch_houdayer.py),
    and the port's union-find labels any graph in one pass, so a run with
    the masks equals the same run without them bitwise.

    Returns (states (..., 2, M, N) rung-ordered, swap_rate, houdayer_flip_
    frac[, energies (nsweeps, ..., 2, M)][, pair_rates (..., M-1), the
    mean of the two ladders]).

    states may be a (2, M, N) DTensor sharded on the rungs, dim 1 (JAX's
    tests/test_pt.py:330): each ladder's run of a rank's rungs sweeps on an
    engine of its own (two launches a sweep), and each rank moves the
    pairs of its rungs (the whole ladder's pair uids, `pair0`) and gathers
    them back; states and energies come back sharded on the rung axis."""
    if isinstance(problem, DenseProblem):
        raise ValueError("sample_icm needs a sparse/lattice problem")
    _roadmap.require_problem(problem)
    if grid_bonds is not None:
        _check_grid_bonds(grid_bonds, problem.nspins)
    dev = problem.device
    temps = torch.as_tensor(temps, dtype=torch.float32, device=dev)
    M = temps.shape[0]
    batch = states.shape[:-3]
    n = states.shape[-1]
    gp = (problem.to_generic() if isinstance(problem, LatticeProblem)
          else problem)
    seed = draw_seed(generator)
    sweep_problem = problem if split_ops.supports_split(problem) else gp
    sharded = _roadmap.is_sharded(states)
    if sharded:
        sharded_state(states, 3, 1, "pt.sample_icm")
        eng = ShardedEngine(lambda s, c0: ClassicalEngine(sweep_problem, s,
                                                          c0), states, dim=1)
    else:
        eng = ClassicalEngine(sweep_problem, states.reshape(-1, n))
    lad = _Ladders(batch + (2,), M, dev)
    beta = 1.0 / temps
    one = torch.ones((), device=dev)
    es = []
    h_sum = torch.zeros(batch, dtype=torch.float32, device=dev)
    h_cnt = 0
    cadences = (1 if collect_energy else swap_every, houdayer_every)
    for start, steps in _events(int(nsweeps), cadences):
        eng.sweep(temps[rung_labels(lad.ror)].reshape(-1), seed, start, steps)
        i = start + steps - 1
        if i % swap_every == 0:
            parity = (i // swap_every) % 2
            e = eng.energy().reshape(batch + (2, M))
            lad.ror, acc = _exchange(e, beta, lad.ror, seed, i, parity, -1,
                                     one)
            lad.nacc += acc.to(torch.int32)
            lad.attempt(parity)
        if houdayer_every and i % houdayer_every == 0:
            h_sum = h_sum + _houdayer_phase(eng, gp, lad.ror, batch, M, n,
                                            seed, i)
            h_cnt += 1
        if collect_energy:
            es.append(torch.gather(eng.energy().reshape(batch + (2, M)), -1,
                                   lad.ror))
    full = rung_ordered(eng.full().reshape(batch + (2, M, n)), lad.ror)
    out = (eng.placed(full) if sharded else full, lad.swap_rate(2).sum(-1),
           h_sum / max(h_cnt, 1))
    if collect_energy:
        es = torch.stack(es)
        out = out + (eng.placed(es, 2) if sharded else es,)
    if per_pair_rates:
        out = out + (lad.pair_rates(lad.nacc.sum(-2), 2),)
    return out


def _houdayer_phase(eng, gp, ror, batch, M, n, seed, step):
    """One Houdayer move of every rung-aligned pair (pt.py:435-444), pair
    (read, rung) = (ladder 0's replica at the rung, ladder 1's). On the
    packed engine (every IsingProblem, every odd-L lattice) the move runs
    in place on the engine's state, through `ror` and the packing's site
    ids (`cluster_kernels.houdayer_move_packed`); the split engine of an
    even-L lattice and a rung-sharded state are unpacked to site order,
    moved and repacked. Returns the flipped fraction of the phase of each
    pair of ladders, float32 of the batch shape."""
    if not getattr(eng, "sharded", False) and eng.kind == "packed":
        eng.state, flipped = cluster_kernels.houdayer_move_packed(
            gp, eng.pg, eng.state, ror, seed, step)
        return (flipped.reshape(batch + (M,)).sum(-1).to(torch.float32)
                / float(M * n))
    if getattr(eng, "sharded", False):
        # the pairs of this rank's rungs, at their global pair uids, then
        # every rank's moved pairs in rung order
        from montecarlosolvers_tpu_torch.parallel import _collectives as coll

        m0, k = eng.starts[0], eng.k

        def move(s1, s2):
            a, b, flipped = cluster_kernels.houdayer_move(
                gp, s1[m0:m0 + k].contiguous(), s2[m0:m0 + k].contiguous(),
                seed, step, pair0=m0)
            return (coll.gather_spins(a, eng.group, 0),
                    coll.gather_spins(b, eng.group, 0),
                    coll.gather(flipped, eng.group, 0))
    else:
        def move(s1, s2):
            return cluster_kernels.houdayer_move(gp, s1, s2, seed, step)
    full, flipped = cluster_kernels.houdayer_rungs(move, eng.full(), ror)
    eng.set_full(full)
    return (flipped.reshape(batch + (M,)).sum(-1).to(torch.float32)
            / float(M * n))


def _tune(ladder, rates, floor):
    """Redistribute rungs along the cumulative -log(rate) resistance, in
    log space, endpoints fixed (pt.py:504-513), in float64."""
    M = ladder.shape[0]
    r = np.clip(np.asarray(rates, dtype=np.float64), floor, 1.0 - floor)
    c = np.concatenate([[0.0], np.cumsum(-np.log(r))])
    targets = np.linspace(0.0, c[-1], M)
    return np.exp(np.interp(targets, c, np.log(ladder)))


def tune_ladder(problem, temps, generator, rounds=4, sweeps_per_round=200,
                floor=0.02):
    """Equalize adjacent-rung swap rates by redistributing rungs along the
    measured cumulative swap resistance, endpoints fixed (JAX
    `tune_ladder`, pt.py:484). Random initial states from `generator`.
    Returns (temps float32 on the problem's device, pair_rates numpy) of
    the last round."""
    dev = problem.device
    temps = np.asarray(torch.as_tensor(temps).cpu(), dtype=np.float64)
    asc = temps[0] < temps[-1]
    if not asc:
        temps = temps[::-1].copy()
    M = temps.shape[0]
    bits = torch.randint(0, 2, (M, problem.nspins), generator=generator,
                         device=generator.device)
    states = (bits.to(torch.float32) * 2.0 - 1.0).to(dev)
    pair_rates = None
    for _ in range(rounds):
        states, _, pair_rates = sample(
            problem, torch.tensor(temps, dtype=torch.float32), states,
            generator, sweeps_per_round, per_pair_rates=True)
        pair_rates = pair_rates.cpu().numpy()
        temps = _tune(temps, pair_rates, floor)
    if not asc:
        temps = temps[::-1]
    return (torch.tensor(temps.copy(), dtype=torch.float32, device=dev),
            pair_rates)


def tune_ladder_piqmc(problem, gammas, temp, generator, rounds=4,
                      sweeps_per_round=200, floor=0.02, global_moves=False,
                      slices=None, confs=None):
    """The transverse-field analog of `tune_ladder` (JAX
    `tune_ladder_piqmc`, pt.py:525): `sample_piqmc`'s per-pair rates as
    the resistance, rungs redistributed in log(Gamma). Pass `confs` ((M, P,
    N)) or `slices` (random initial configurations from `generator`).
    Returns (gammas float32, pair_rates numpy) of the last round."""
    dev = problem.device
    gammas = np.asarray(torch.as_tensor(gammas).cpu(), dtype=np.float64)
    asc = gammas[0] < gammas[-1]
    if not asc:
        gammas = gammas[::-1].copy()
    M = gammas.shape[0]
    if confs is None:
        if slices is None:
            raise ValueError("pass confs or slices")
        bits = torch.randint(0, 2, (M, slices, problem.nspins),
                             generator=generator, device=generator.device)
        confs = (bits.to(torch.float32) * 2.0 - 1.0).to(dev)
    pair_rates = None
    for _ in range(rounds):
        confs, _, pair_rates = sample_piqmc(
            problem, torch.tensor(gammas, dtype=torch.float32), temp, confs,
            generator, sweeps_per_round, global_moves=global_moves,
            per_pair_rates=True)
        pair_rates = pair_rates.cpu().numpy()
        gammas = _tune(gammas, pair_rates, floor)
    if not asc:
        gammas = gammas[::-1]
    return (torch.tensor(gammas.copy(), dtype=torch.float32, device=dev),
            pair_rates)
