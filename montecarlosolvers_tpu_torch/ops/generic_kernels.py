"""Generic SA, PIQMC, dissipative PIQMC and SVMC engines on an
IsingProblem: plain versions, kernel wrappers, problem-level anneals.

No Pallas kernel covers this path: the JAX package runs it as XLA scans,
`ops/packed.py::packed_sweep_scan` (:282), `packed_svmc_scan` (:298) and the
masked space-time sweep of `solvers/qmc.py` (:152-180) on
`ops/piqmc.py::local_sweep` (:79) and `global_line_moves` (:193). In plain
PyTorch each of those sweeps is about ten launches per color phase, so the
port gives each a hand-written CUDA kernel that runs the whole schedule in
one launch: `csrc/packed_sa.cu`, `csrc/packed_svmc.cu` and
`csrc/generic_qmc.cu`, all on the class-major packed layout
(`ops/packed.py`, `csrc/packed.cuh`), one CTA of THREADS threads a chain,
the state in device memory. The dissipative sweeps of the JAX solver's
masked path (`ops/piqmc.py::dissipative_local_sweep` :110 and
`dissipative_colored_sweep` :152) are `csrc/generic_qmc_bath.cu`, which
also runs the bath on every lattice the split bath engines do not take (an
odd L, or bath_update="colored" at odd P), on the lattice's checkerboard
packing (`ops/packed.py::packed_from_lattice`).

Beside each wrapper sits its plain version (`packed_sa_anneal_ref`,
`packed_svmc_anneal_ref`, `generic_qmc_anneal_ref`,
`generic_qmc_bath_anneal_ref`), which runs the port's
plain sweeps (`ops/packed.py::packed_sweep` and
`packed_svmc_sweep_cached`; `ops/piqmc.py::local_sweep`, the dissipative
sweeps and `global_line_moves` on the packed problem) on the counter hash:
one uniform
per site and sweep at counter(seed, t, 0), keyed by the site's ORIGINAL
index (`counter_rng.generic_uids`), the PIQMC line moves at
line_counter(seed, t, 0), the SVMC acceptances at svmc_accept_counter(seed,
t, 0). Because the key is the original index, the masked engine
(`ops/metropolis.py::sweep_scan`) consumes the same uniforms and gives the
same spins bitwise. The JAX engines draw from `jax.random`; the tests hold
the plain sweeps to them on the same `jax.random` draws.

The wrappers dispatch on the device of the state: a CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises — nothing falls
back. `_build.LAUNCHES` counts one launch an anneal under "packed_sa",
"packed_svmc", "generic_qmc" and "generic_qmc_bath", and the noisy
anneals (`packed_noisy_scan`, `packed_noisy_svmc_scan`: per-step coupling
tables, the same two kernels with table strides) under "packed_sa_noisy"
and "packed_svmc_noisy". With an `energies`
buffer
(collect_energy=) the same single launch reduces each chain's energy (the
best slice's, for PIQMC) after every sweep into it, in a fixed order.
"""

from __future__ import annotations

import ctypes

import torch

from montecarlosolvers_tpu_torch import schedules
from montecarlosolvers_tpu_torch.models.lattice import LatticeProblem
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import counter_rng as cr
from montecarlosolvers_tpu_torch.ops import packed as packed_ops
from montecarlosolvers_tpu_torch.ops import piqmc as piqmc_ops
from montecarlosolvers_tpu_torch.ops import svmc_ops
from montecarlosolvers_tpu_torch.ops.metropolis import sweep_scan
from montecarlosolvers_tpu_torch.ops.split_kernels import (energy_buffer,
                                                           step_values,
                                                           with_energies)

# threads of the one CTA a chain (csrc/packed.cuh::kPackedThreads)
THREADS = 256


# ------------------------------------------------------------ plain versions


def _step_tables(tables, t):
    """{nbr_J, h} of step t of `tables` = (nbr_J (rows, N, maxnb), h (rows,
    N), mcsteps), row t // mcsteps; {} for the static tables (None)."""
    if tables is None:
        return {}
    row = t // tables[2]
    return {"nbr_J": tables[0][row], "h": tables[1][row]}


def packed_sa_anneal_ref(pg, temps, spins, seed, energies=None,
                         tables=None, step0=0):
    """Plain form of csrc/packed_sa.cu: anneal packed spins (chains, N)
    over the float32 temperatures `temps` ((steps,), or (steps, chains): a
    temperature a chain and step), sweep t by
    `packed_sweep` on the uniforms of counter(seed, t, 0). With `energies`,
    a (steps, chains) float32 buffer, row t receives each chain's
    `packed_energy` after sweep t. With `tables` = (nbr_J (rows, N,
    maxnb), h (rows, N), mcsteps), per-step couplings in packed row order,
    sweep t reads row t // mcsteps (the noisy anneal; no energies). step0:
    the step the hash counts sweep 0 as (a one-sweep call inside a longer
    anneal, as the cluster solvers make)."""
    hu = cr.hashed_uid(cr.generic_uids(spins.shape[0], pg.perm, pg.nspins))
    s = spins
    for t in range(temps.shape[0]):
        u = cr.uniform01_hashed(cr.counter(seed, step0 + t, 0), hu)
        s = packed_ops.packed_sweep(pg, s, u, step_values(temps, t),
                                    **_step_tables(tables, t))
        if energies is not None:
            energies[t] = packed_ops.packed_energy(pg, s)
    return s


def packed_svmc_anneal_ref(pg, a_sched, b_sched, temp, theta, seed, tf,
                           energies=None, tables=None):
    """Plain form of csrc/packed_svmc.cu: anneal packed angles (chains, N)
    over the float32 (steps,) schedules A and B at the Python-float
    temperature `temp`, sweep t by `packed_svmc_sweep_cached` on the
    proposal uniforms of counter(seed, t, 0) and the acceptance uniforms
    of svmc_accept_counter(seed, t, 0). With `energies`, row t receives
    each chain's energy of sign(cos theta) after sweep t; `tables` as for
    `packed_sa_anneal_ref`."""
    temp32 = torch.tensor(temp, dtype=torch.float32, device=theta.device)
    hu = cr.hashed_uid(cr.generic_uids(theta.shape[0], pg.perm, pg.nspins))
    state = (theta, torch.cos(theta), torch.sin(theta))
    for t in range(a_sched.shape[0]):
        u_prop = cr.uniform01_hashed(cr.counter(seed, t, 0), hu)
        u_acc = cr.uniform01_hashed(cr.svmc_accept_counter(seed, t, 0), hu)
        state = packed_ops.packed_svmc_sweep_cached(
            pg, state, u_prop, u_acc, temp32, a_sched[t], b_sched[t], tf=tf,
            **_step_tables(tables, t))
        if energies is not None:
            energies[t] = packed_ops.packed_energy(
                pg, svmc_ops.z_projection_from_cos(state[1]))
    return state[0]


def generic_qmc_anneal_ref(pg, b_sched, jp, teff, confs, seed, global_moves,
                           energies=None, step0=0):
    """Plain form of csrc/generic_qmc.cu on packed confs (chains, P, N):
    sweep t is `piqmc.local_sweep` on the packed problem with B_t, J_perp_t
    (float32 (steps,) tensors; `jp` may be a (steps, chains) table, a
    J_perp a chain and step) at T_eff = `teff` (a Python float), on the
    uniforms of counter(seed, t, 0) at the (chain, slice, original site)
    ids, then, with `global_moves`, `piqmc.global_line_moves` on those of
    line_counter(seed, t, 0) at the slice-0 ids. With `energies`, row t
    receives each chain's least slice energy after step t. step0: the step
    the hash counts sweep 0 as."""
    prob = pg.as_problem()
    chains, P, n = confs.shape
    hu = cr.hashed_uid(cr.generic_uids(chains, pg.perm, n, slices=P))
    hu0 = hu[:, 0]
    c = confs
    for t in range(b_sched.shape[0]):
        u = cr.uniform01_hashed(cr.counter(seed, step0 + t, 0), hu)
        jpt = jp[t] if jp.dim() == 1 else jp[t][:, None, None]
        c = piqmc_ops.local_sweep(prob, c, u, teff, jpt, b_sched[t])
        if global_moves:
            ul = cr.uniform01_hashed(cr.line_counter(seed, step0 + t, 0),
                                     hu0)
            c = piqmc_ops.global_line_moves(prob, c, ul, teff, b_sched[t])
        if energies is not None:
            energies[t] = torch.min(packed_ops.packed_energy(pg, c),
                                    dim=-1).values
    return c


def generic_qmc_bath_anneal_ref(pg, b_sched, jp, teff, bath, confs, seed,
                                global_moves, colored=False, energies=None,
                                step0=0):
    """Plain form of csrc/generic_qmc_bath.cu on packed confs (chains, P,
    N), P >= 2: sweep t is `piqmc.dissipative_local_sweep` (with `colored`,
    `dissipative_colored_sweep`) on the packed problem with B_t, J_perp_t
    and the (P, P) `bath` matrix, then the line moves, uniforms and
    energies and step0 all as in `generic_qmc_anneal_ref`. On a packing
    that is not
    `proper` the masked sweeps read a same-class neighbour as it stood at
    the start of its class's phase, which is what the kernel must match."""
    prob = pg.as_problem()
    sweep = (piqmc_ops.dissipative_colored_sweep if colored
             else piqmc_ops.dissipative_local_sweep)
    chains, P, n = confs.shape
    hu = cr.hashed_uid(cr.generic_uids(chains, pg.perm, n, slices=P))
    c = confs
    for t in range(b_sched.shape[0]):
        u = cr.uniform01_hashed(cr.counter(seed, step0 + t, 0), hu)
        c = sweep(prob, c, u, teff, jp[t], b_sched[t], bath)
        if global_moves:
            ul = cr.uniform01_hashed(cr.line_counter(seed, step0 + t, 0),
                                     hu[:, 0])
            c = piqmc_ops.global_line_moves(prob, c, ul, teff, b_sched[t])
        if energies is not None:
            energies[t] = torch.min(packed_ops.packed_energy(pg, c),
                                    dim=-1).values
    return c


# ------------------------------------------------------------ kernel wrappers


def _check_graph(pg, device):
    n, maxnb = pg.nbr_idx.shape
    _build.check_arg(pg.nbr_idx, "nbr_idx", (n, maxnb), device, torch.int32)
    _build.check_arg(pg.nbr_J, "nbr_J", (n, maxnb), device)
    _build.check_arg(pg.h, "h", (n,), device)
    _build.check_arg(pg.perm, "perm", (n,), device, torch.int32)
    _build.check_arg(pg.starts_dev, "starts", (pg.num_colors + 1,), device,
                     torch.int32)
    return (*map(_build.ptr, (pg.nbr_idx, pg.nbr_J, pg.h, pg.perm,
                              pg.starts_dev)),)


def _check_tables(pg, tables, steps, energies, device):
    """(graph pointers, j_stride, h_stride, mcsteps) of a packed kernel's
    launch: the static tables, or the per-step `tables` once they are
    contiguous float32 (rows, N, maxnb) and (rows, N) stacks on `device`
    whose rows cover the `steps` sweeps. Raises ValueError on anything
    else, or on tables with `energies` (the noisy anneals collect none)."""
    graph = _check_graph(pg, device)
    if tables is None:
        return graph, 0, 0, 1
    if energies is not None:
        raise ValueError("the noisy anneals collect no energies")
    nbr_J, h, mcsteps = tables
    n, maxnb = pg.nbr_J.shape
    rows = int(nbr_J.shape[0])
    _build.check_arg(nbr_J, "nbr_J_sched", (rows, n, maxnb), device)
    _build.check_arg(h, "h_sched", (rows, n), device)
    if mcsteps < 1 or rows * mcsteps != steps:
        raise ValueError(f"{rows} table rows x mcsteps {mcsteps} do not "
                         f"cover {steps} sweeps")
    return ((graph[0], _build.ptr(nbr_J), _build.ptr(h)) + graph[3:],
            n * maxnb, n, int(mcsteps))


def _snap(pg, state):
    """The scratch a packed kernel reads same-class neighbours from on a
    packing that is not proper (`PackedGraph.proper`, an odd periodic
    lattice's checkerboard): a tensor of the state's size; None on a
    proper one. Freed after the launch, its memory is reused only by work
    queued after it on the stream."""
    return None if pg.proper else torch.empty_like(state)


def packed_sa_anneal(pg, temps, spins, seed, energies=None, tables=None,
                     step0=0):
    """csrc/packed_sa.cu on CUDA tensors, `packed_sa_anneal_ref` on CPU
    tensors; arguments as for the plain version. Returns the new spins
    (a copy: the kernel anneals it in place). One launch
    (LAUNCHES["packed_sa"], energies or not; with `tables`,
    LAUNCHES["packed_sa_noisy"]; with a (steps, chains) `temps`, the
    per-chain instantiation, LAUNCHES["packed_sa_chain"], whose table may
    repeat one row: `_build.schedule_strides`)."""
    if _build.route(spins.device, "packed") == "cpu":
        return packed_sa_anneal_ref(pg, temps, spins, seed, energies, tables,
                                    step0)
    chains, n = spins.shape
    dev = spins.device
    steps = int(temps.shape[0])
    graph, j_stride, h_stride, mcsteps = _check_tables(pg, tables, steps,
                                                       energies, dev)
    _build.check_arg(spins, "spins", (chains, pg.nspins), dev)
    strides = _build.schedule_strides(temps, "temps", steps, chains, dev)
    if strides[1] and tables is not None:
        raise ValueError("the noisy anneal takes one shared schedule")
    out = spins.clone()
    snap = _snap(pg, out)
    lib = _build.library("packed_sa")
    rc = lib.packed_sa_anneal(
        *graph, _build.ptr(temps), _build.ptr(out),
        None if snap is None else _build.ptr(snap),
        _build.energies_ptr(energies, steps, chains, dev), chains, n,
        pg.nbr_idx.shape[1], pg.num_colors, steps, cr.wrap_int32(seed),
        int(step0), THREADS, j_stride, h_stride, mcsteps, *strides,
        _build.stream_of(dev))
    _build.raise_on_error(lib, "packed_sa_anneal", rc)
    _build.LAUNCHES["packed_sa_noisy" if tables is not None
                    else "packed_sa_chain" if strides[1]
                    else "packed_sa"] += 1
    return out


def packed_svmc_anneal(pg, a_sched, b_sched, temp, theta, seed, tf,
                       energies=None, tables=None):
    """csrc/packed_svmc.cu on CUDA tensors, `packed_svmc_anneal_ref` on CPU
    tensors; arguments as for the plain version. Returns the new angles.
    One launch (LAUNCHES["packed_svmc"], energies or not; with `tables`,
    LAUNCHES["packed_svmc_noisy"])."""
    if _build.route(theta.device, "packed") == "cpu":
        return packed_svmc_anneal_ref(pg, a_sched, b_sched, temp, theta,
                                      seed, tf, energies, tables)
    chains, n = theta.shape
    dev = theta.device
    steps = int(a_sched.shape[0])
    graph, j_stride, h_stride, mcsteps = _check_tables(pg, tables, steps,
                                                       energies, dev)
    _build.check_arg(theta, "theta", (chains, pg.nspins), dev)
    _build.check_arg(a_sched, "a_sched", (steps,), dev)
    _build.check_arg(b_sched, "b_sched", (steps,), dev)
    out = theta.clone()
    scratch = torch.empty((2, chains, n), dtype=torch.float32, device=dev)
    lib = _build.library("packed_svmc")
    rc = lib.packed_svmc_anneal(
        *graph, _build.ptr(a_sched), _build.ptr(b_sched),
        ctypes.c_float(temp), _build.ptr(out), _build.ptr(scratch),
        _build.energies_ptr(energies, steps, chains, dev), chains, n,
        pg.nbr_idx.shape[1], pg.num_colors, steps, cr.wrap_int32(seed),
        int(bool(tf)), THREADS, j_stride, h_stride, mcsteps,
        _build.stream_of(dev))
    _build.raise_on_error(lib, "packed_svmc_anneal", rc)
    _build.LAUNCHES["packed_svmc" if tables is None
                    else "packed_svmc_noisy"] += 1
    return out


def generic_qmc_anneal(pg, b_sched, jp, teff, confs, seed, global_moves,
                       energies=None, step0=0):
    """csrc/generic_qmc.cu on CUDA tensors, `generic_qmc_anneal_ref` on
    CPU tensors; arguments as for the plain version. Returns the new
    configurations. One launch (LAUNCHES["generic_qmc"]), energies or
    not; with a (steps, chains) `jp`, the per-chain instantiation
    (LAUNCHES["generic_qmc_chain"])."""
    if _build.route(confs.device, "packed") == "cpu":
        return generic_qmc_anneal_ref(pg, b_sched, jp, teff, confs, seed,
                                      global_moves, energies, step0)
    chains, P, n = confs.shape
    dev = confs.device
    graph = _check_graph(pg, dev)
    _build.check_arg(confs, "confs", (chains, P, pg.nspins), dev)
    steps = int(b_sched.shape[0])
    _build.check_arg(b_sched, "b_sched", (steps,), dev)
    strides = _build.schedule_strides(jp, "jp", steps, chains, dev)
    out = confs.clone()
    snap = _snap(pg, out)
    lib = _build.library("generic_qmc")
    rc = lib.generic_qmc_anneal(
        *graph, _build.ptr(b_sched), _build.ptr(jp), ctypes.c_float(teff),
        _build.ptr(out), None if snap is None else _build.ptr(snap),
        _build.energies_ptr(energies, steps, chains, dev),
        chains, P, n, pg.nbr_idx.shape[1], pg.num_colors,
        piqmc_ops.spacetime_num_phases(pg.num_colors, P), steps,
        cr.wrap_int32(seed), int(step0), int(bool(global_moves)), THREADS,
        *strides, _build.stream_of(dev))
    _build.raise_on_error(lib, "generic_qmc_anneal", rc)
    _build.LAUNCHES["generic_qmc_chain" if strides[1]
                    else "generic_qmc"] += 1
    return out


def generic_qmc_bath_anneal(pg, b_sched, jp, teff, bath, confs, seed,
                            global_moves, colored=False, energies=None,
                            step0=0):
    """csrc/generic_qmc_bath.cu on CUDA tensors, `generic_qmc_bath_anneal_ref`
    on CPU tensors; arguments as for the plain version. Returns the new
    configurations. One launch (LAUNCHES["generic_qmc_bath"]), sequential
    or colored, energies or not."""
    if _build.route(confs.device, "packed") == "cpu":
        return generic_qmc_bath_anneal_ref(pg, b_sched, jp, teff, bath,
                                           confs, seed, global_moves,
                                           colored, energies, step0)
    chains, P, n = confs.shape
    dev = confs.device
    graph = _check_graph(pg, dev)
    _build.check_arg(confs, "confs", (chains, P, pg.nspins), dev)
    _build.check_arg(bath, "bath", (P, P), dev)
    steps = int(b_sched.shape[0])
    _build.check_arg(b_sched, "b_sched", (steps,), dev)
    _build.check_arg(jp, "jp", (steps,), dev)
    out = confs.clone()
    snap = (torch.empty_like(confs) if colored or not pg.proper else None)
    lib = _build.library("generic_qmc_bath")
    rc = lib.generic_qmc_bath_anneal(
        *graph, _build.ptr(b_sched), _build.ptr(jp), _build.ptr(bath),
        ctypes.c_float(teff), ctypes.c_float(2.0 * teff), _build.ptr(out),
        None if snap is None else _build.ptr(snap),
        _build.energies_ptr(energies, steps, chains, dev), chains, P, n,
        pg.nbr_idx.shape[1], pg.num_colors,
        piqmc_ops.spacetime_num_phases(pg.num_colors, P), steps,
        cr.wrap_int32(seed), int(step0), int(bool(colored)),
        int(bool(global_moves)),
        int(pg.proper), THREADS, _build.stream_of(dev))
    _build.raise_on_error(lib, "generic_qmc_bath_anneal", rc)
    _build.LAUNCHES["generic_qmc_bath"] += 1
    return out


# ------------------------------------------------------ problem-level engines


def _check_problem(problem, state, name):
    """Raise ValueError unless `problem` is an IsingProblem and `state`
    (the `name` argument) lies on its device."""
    if not packed_ops.supports_packed(problem):
        raise ValueError("the generic engines take an IsingProblem")
    if state.device != problem.device:
        raise ValueError(f"{name} is on {state.device}, problem on "
                         f"{problem.device}")


def _graph_of(problem, state, name):
    """The PackedGraph of `problem`, once `_check_problem` holds."""
    _check_problem(problem, state, name)
    return packed_ops.build_packed(problem)


def _packed(pg, state, n):
    """`state`, (..., N), as a contiguous float32 (rows, N) in packed
    order."""
    return packed_ops.pack_state(
        pg, state.to(torch.float32).reshape(-1, n)).contiguous()


def anneal_packed(problem, sched, spins, seed, mcsteps=1,
                  collect_energy=False):
    """SA anneal of an IsingProblem on the packed layout (counterpart of
    `ops/packed.py::packed_sweep_scan`, the JAX solver's engine for
    IsingProblem graphs).

    sched: (steps,) temperatures; spins: (chains, N) or (N,) float32 +/-1
    on the problem's device; seed: int counter-hash seed; collect_energy:
    also return the energy after each sweep, (steps * mcsteps,) + batch.
    Returns the annealed spins, same shape, or (spins, energies)."""
    pg = _graph_of(problem, spins, "spins")
    temps = schedules.expand_mcsteps(sched, mcsteps, problem.device)
    batch = spins.shape[:-1]
    es = energy_buffer(collect_energy, temps.shape[0], batch, problem.device)
    out = packed_sa_anneal(pg, temps, _packed(pg, spins, pg.nspins), seed, es)
    return with_energies(packed_ops.unpack_state(pg, out).reshape(
        spins.shape), es, batch)


def anneal_masked(problem, sched, spins, seed, mcsteps=1,
                  collect_energy=False):
    """SA anneal of an IsingProblem on the masked engine
    (`ops/metropolis.py::sweep_scan`, the JAX solver's engine="masked"),
    arguments and result as for `anneal_packed`. The masked and packed
    engines draw the same uniforms at the same sites and give the same
    spins bitwise (their energies round alike to float32 sums), so on a
    CUDA device this runs the packed kernel (`anneal_packed`); the masked
    plain version runs on the CPU."""
    if _build.route(spins.device, "packed") == "cuda":
        return anneal_packed(problem, sched, spins, seed, mcsteps,
                             collect_energy)
    _check_problem(problem, spins, "spins")
    temps = schedules.expand_mcsteps(sched, mcsteps, problem.device)
    batch = spins.shape[:-1]
    s = spins.to(torch.float32).reshape(-1, problem.nspins)
    out, es = sweep_scan(problem, s, seed, temps,
                         collect_energy=collect_energy)
    out = out.reshape(spins.shape)
    if es is None:
        return out
    return out, es.reshape((es.shape[0],) + tuple(batch))


def anneal_generic_qmc(problem, a_sched, b_sched, temp, confs, seed,
                       mcsteps=1, global_moves=True, collect_energy=False):
    """PIQMC anneal of an IsingProblem at any P (counterpart of the masked
    space-time sweep of the JAX `solvers/qmc.py`, :152-180).

    a_sched / b_sched: (steps,) Gamma and B; temp: ambient T, T_eff = P*T;
    confs: (chains, P, N) or (P, N) float32 +/-1 slices-major on the
    problem's device; collect_energy: also return the best-slice energy
    after each sweep (line moves included), (steps * mcsteps,) + batch.
    Returns the annealed configurations, same shape, or (confs,
    energies)."""
    pg = _graph_of(problem, confs, "confs")
    P, n = confs.shape[-2], pg.nspins
    b, jp, teff = schedules.qmc_terms(a_sched, b_sched, temp, P, mcsteps,
                                      problem.device)
    batch = confs.shape[:-2]
    es = energy_buffer(collect_energy, b.shape[0], batch, problem.device)
    c = packed_ops.pack_state(
        pg, confs.to(torch.float32).reshape(-1, P, n)).contiguous()
    out = generic_qmc_anneal(pg, b, jp, teff, c, seed, global_moves, es)
    return with_energies(packed_ops.unpack_state(pg, out).reshape(
        confs.shape), es, batch)


def anneal_generic_qmc_bath(problem, a_sched, b_sched, temp, lookuptable,
                            confs, seed, mcsteps=1, global_moves=False,
                            colored=False, collect_energy=False):
    """Dissipative PIQMC anneal at any P >= 2 on the packed layout
    (counterpart of the JAX solver's masked bath path, solvers/qmc.py:
    152-180, with `dissipative_local_sweep` or, with `colored`,
    `dissipative_colored_sweep`): of an IsingProblem on its greedy colors
    (`build_packed`), or of a LatticeProblem on its own checkerboard
    (`packed_from_lattice`), the lattices the split bath engines do not
    take.

    a_sched / b_sched: (steps,) Gamma and B; temp: ambient T, T_eff = P*T;
    lookuptable: (P-1,) bath couplings (`schedules.bath_lookuptable`),
    numpy or a tensor; confs: (chains, P, N) or (P, N) float32 +/-1
    slices-major on the problem's device; collect_energy: also return the
    best-slice energy after each sweep (line moves included), (steps *
    mcsteps,) + batch. Returns the annealed configurations, same shape, or
    (confs, energies)."""
    if packed_ops.supports_packed(problem):
        pg = _graph_of(problem, confs, "confs")
    else:
        if not isinstance(problem, LatticeProblem):
            raise ValueError("the generic bath engine takes an IsingProblem "
                             "or a LatticeProblem")
        if confs.device != problem.device:
            raise ValueError(f"confs is on {confs.device}, problem on "
                             f"{problem.device}")
        pg = packed_ops.packed_from_lattice(problem)
    P, n = confs.shape[-2], pg.nspins
    bath = piqmc_ops.bath_matrix_of(lookuptable, P, problem.device)
    b, jp, teff = schedules.qmc_terms(a_sched, b_sched, temp, P, mcsteps,
                                      problem.device)
    batch = confs.shape[:-2]
    es = energy_buffer(collect_energy, b.shape[0], batch, problem.device)
    c = packed_ops.pack_state(
        pg, confs.to(torch.float32).reshape(-1, P, n)).contiguous()
    out = generic_qmc_bath_anneal(pg, b, jp, teff, bath, c, seed,
                                  global_moves, colored, es)
    return with_energies(packed_ops.unpack_state(pg, out).reshape(
        confs.shape), es, batch)


def anneal_packed_svmc(problem, a_sched, b_sched, temp, theta, seed,
                       mcsteps=1, tf=False, collect_energy=False):
    """SVMC anneal of an IsingProblem on the packed layout (counterpart of
    `ops/packed.py::packed_svmc_scan`).

    a_sched / b_sched: (steps,) A and B; temp: the fixed temperature;
    theta: (chains, N) or (N,) float32 angles in [0, pi] on the problem's
    device; tf: TF proposals; collect_energy: also return the energy of
    sign(cos theta) after each sweep, (steps * mcsteps,) + batch. Returns
    the annealed angles, same shape, or (theta, energies)."""
    pg = _graph_of(problem, theta, "theta")
    a_s, b_s = (schedules.expand_mcsteps(x, mcsteps, problem.device)
                for x in (a_sched, b_sched))
    batch = theta.shape[:-1]
    es = energy_buffer(collect_energy, a_s.shape[0], batch, problem.device)
    out = packed_svmc_anneal(pg, a_s, b_s, float(temp),
                             _packed(pg, theta, pg.nspins), seed, tf, es)
    return with_energies(packed_ops.unpack_state(pg, out).reshape(
        theta.shape), es, batch)


# ------------------------------------------------------------ noisy anneals


def packed_tables(pg, nbr_J_sched, h_sched, mcsteps, steps, device):
    """The per-step tables (rows, N, maxnb) and (rows, N), numpy or
    tensors in original row order, as contiguous float32 stacks in packed
    row order on `device`, permuted there once; with `mcsteps`, what the
    kernels and plain versions take as `tables`. Raises ValueError unless
    they are of the problem's shape and rows * mcsteps == steps."""
    perm = pg.perm.long()
    jt, ht = (torch.as_tensor(x, dtype=torch.float32, device=device)
              .index_select(1, perm).contiguous()
              for x in (nbr_J_sched, h_sched))
    rows = jt.shape[0]
    if (tuple(jt.shape[1:]) != tuple(pg.nbr_J.shape)
            or tuple(ht.shape) != (rows, pg.nspins)
            or mcsteps < 1 or rows * mcsteps != steps):
        raise ValueError(
            f"tables {tuple(jt.shape)} and {tuple(ht.shape)} at mcsteps "
            f"{mcsteps} do not fit {steps} sweeps of a problem with tables "
            f"{tuple(pg.nbr_J.shape)}")
    return jt, ht, int(mcsteps)


def packed_noisy_scan(problem, temps, nbr_J_sched, h_sched, spins, seed,
                      mcsteps=1):
    """Noisy SA anneal of an IsingProblem on the packed layout (JAX
    `packed_noisy_scan`, ops/packed.py:290, and `_noisy_scan` :221; the
    engine of sa.anneal_noisy): the per-step tables are permuted into
    packed row order once, on the device, and the whole anneal is one
    launch of csrc/packed_sa.cu (LAUNCHES["packed_sa_noisy"]).

    temps: float32 (rows * mcsteps,) temperatures, one a sweep;
    nbr_J_sched (rows, N, maxnb) and h_sched (rows, N): the couplings of
    each schedule step in the problem's slot layout, sweep t reading row t
    // mcsteps (the JAX solver repeats each row mcsteps times: the same
    sweeps); spins: (chains, N) or (N,) float32 +/-1 on the problem's
    device; seed: int counter-hash seed. Returns the annealed spins."""
    pg = _graph_of(problem, spins, "spins")
    tables = packed_tables(pg, nbr_J_sched, h_sched, mcsteps,
                           temps.shape[0], problem.device)
    out = packed_sa_anneal(pg, temps, _packed(pg, spins, pg.nspins), seed,
                           tables=tables)
    return packed_ops.unpack_state(pg, out).reshape(spins.shape)


def packed_noisy_svmc_scan(problem, a_sched, b_sched, temp, nbr_J_sched,
                           h_sched, theta, seed, tf=False, mcsteps=1):
    """Noisy SVMC anneal of an IsingProblem on the packed layout (JAX
    `packed_noisy_svmc_scan`, ops/packed.py:308, and `_noisy_svmc_scan`
    :259; NoisySVMC / NoisySVMCTF, svmc.pyx:236-448): one launch of
    csrc/packed_svmc.cu (LAUNCHES["packed_svmc_noisy"]) on the static
    kernel's two uniform streams.

    a_sched / b_sched: float32 (rows * mcsteps,) A and B, one a sweep;
    temp: the fixed temperature; tables, mcsteps and theta ((chains, N) or
    (N,) angles) as for `packed_noisy_scan`; tf: TF proposals. Returns the
    annealed angles."""
    pg = _graph_of(problem, theta, "theta")
    tables = packed_tables(pg, nbr_J_sched, h_sched, mcsteps,
                           a_sched.shape[0], problem.device)
    out = packed_svmc_anneal(pg, a_sched, b_sched, float(temp),
                             _packed(pg, theta, pg.nspins), seed, tf,
                             tables=tables)
    return packed_ops.unpack_state(pg, out).reshape(theta.shape)
