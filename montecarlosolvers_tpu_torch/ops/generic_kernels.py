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
(`ops/packed.py`, `csrc/packed.cuh`). The dissipative sweeps of the JAX
solver's masked path (`ops/piqmc.py::dissipative_local_sweep` :110 and
`dissipative_colored_sweep` :152) are `csrc/generic_qmc_bath.cu`, which
also runs the bath on every lattice the split bath engines do not take (an
odd L, or bath_update="colored" at odd P), on the lattice's checkerboard
packing (`ops/packed.py::packed_from_lattice`). Packed SVMC runs a
chain's rotors in the shared memory of a thread-block cluster of R CTAs
on the same slot layout (`packed_svmc_geometry`, `word_layout`; the
file's cluster route), or on a graph of small class phases
(`packed_svmc_one_cta`) its first kernel, one CTA a chain. Generic
PIQMC and
the generic bath run a chain's slices as bits of each site's words over a
thread-block cluster (`csrc/generic_words.cuh`; R and the threads by
`generic_qmc_geometry`, the slots by `word_layout`), and packed SA a
group of up to 32 chains as the bits of each site's word on the same
layout (the header's SA mode; C, R and the threads by
`packed_sa_geometry`), but on a graph of small class phases
(`packed_sa_one_cta`) its file's first kernel, one CTA a chain, under the
same keys; for a chain or group no cluster holds, each file's first
kernel runs, one CTA a chain, the state in device memory, counted under
"<key>_wide".

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
"packed_svmc", "generic_qmc" and "generic_qmc_bath" (and the "_wide"
routes of each), and the noisy
anneals (`packed_noisy_scan`, `packed_noisy_svmc_scan`: per-step coupling
tables, the same two kernels with table strides) under "packed_sa_noisy"
and "packed_svmc_noisy". With an `energies`
buffer
(collect_energy=) the same single launch reduces each chain's energy (the
best slice's, for PIQMC) after every sweep into it, in a fixed order.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref

import numpy as np
import torch

from montecarlosolvers_tpu_torch import schedules
from montecarlosolvers_tpu_torch.models.lattice import LatticeProblem
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import counter_rng as cr
from montecarlosolvers_tpu_torch.ops import packed as packed_ops
from montecarlosolvers_tpu_torch.ops import piqmc as piqmc_ops
from montecarlosolvers_tpu_torch.ops import svmc_ops
from montecarlosolvers_tpu_torch.ops.metropolis import sweep_scan
from montecarlosolvers_tpu_torch.ops.split_kernels import (CLUSTER_SIZES,
                                                           chain_word_bits,
                                                           energy_buffer,
                                                           step_values,
                                                           with_energies)

# threads of the one CTA a chain of the files' first kernels
# (csrc/packed.cuh::kPackedThreads)
THREADS = 256
# the cluster route of generic PIQMC and the generic bath
# (csrc/generic_words.cuh): at most this many threads a CTA, and the SMs of
# an H100 SXM, which the rule of shape covers with chains x R CTAs where the
# wrapper does not pass the card's own count
WORD_THREADS, NUM_SMS = 512, 132
# the head of a cluster-route CTA's shared memory (generic_words.cuh::
# kHeadBytes): 16 buffer pointers and a float for each of WORD_THREADS / 32
# warps; the kernel has no static shared memory
WORD_HEAD_BYTES = 16 * 8 + WORD_THREADS // 32 * 4
# generic SA's cluster route (generic_words.cuh's SA mode): at most
# SA_THREADS threads a CTA, compiled for SA_BLOCKS_PER_SM such CTAs an SM,
# and SA_TAIL floats after its buffers for the group's temperatures (and
# as many for its energy shares)
SA_THREADS, SA_BLOCKS_PER_SM, SA_TAIL = 256, 4, 32
# generic SVMC's cluster route (csrc/packed_svmc.cu::
# packed_svmc_cluster_kernel): at most SVMC_THREADS threads a CTA,
# compiled for SVMC_BLOCKS_PER_SM such CTAs an SM, a head of
# SVMC_HEAD_BYTES before its slots' cos, theta and sin (and, on a packing
# that is not proper, the snapshot of cos); SM_SMEM_BYTES of shared memory
# an SM (228 KB on an H100), of which the card reserves SMEM_RESERVED_BYTES
# a CTA
SVMC_THREADS, SVMC_BLOCKS_PER_SM, SVMC_HEAD_BYTES = 256, 4, 64
SM_SMEM_BYTES, SMEM_RESERVED_BYTES = 233472, 1024
# generic SVMC's rule of size: a proper packing of at most SVMC_CTA_PASSES
# passes of the THREADS threads a class phase runs the file's first
# kernel, one CTA a chain (`packed_svmc_one_cta`)
SVMC_CTA_PASSES = 3
# generic SA's rule of size: a graph of at most SA_CTA_PASSES passes of
# the THREADS threads a class phase runs the file's first kernel, one CTA a
# chain (`packed_sa_one_cta`)
SA_CTA_PASSES = 5


# ------------------------------------------------------------ plain versions


def _step_tables(tables, t):
    """{nbr_J, h} of step t of `tables` = (nbr_J (rows, N, maxnb), h (rows,
    N), mcsteps), row t // mcsteps; {} for the static tables (None)."""
    if tables is None:
        return {}
    row = t // tables[2]
    return {"nbr_J": tables[0][row], "h": tables[1][row]}


def packed_sa_anneal_ref(pg, temps, spins, seed, energies=None,
                         tables=None, step0=0, chain0=0, disorder=None):
    """Plain form of csrc/packed_sa.cu: anneal packed spins (chains, N)
    over the float32 temperatures `temps` ((steps,), or (steps, chains): a
    temperature a chain and step), sweep t by
    `packed_sweep` on the uniforms of counter(seed, t, 0). With `energies`,
    a (steps, chains) float32 buffer, row t receives each chain's
    `packed_energy` after sweep t. With `tables` = (nbr_J (rows, N,
    maxnb), h (rows, N), mcsteps), per-step couplings in packed row order,
    sweep t reads row t // mcsteps (the noisy anneal; no energies). step0:
    the step the hash counts sweep 0 as (a one-sweep call inside a longer
    anneal, as the cluster solvers make); chain0: the global index of the
    first chain (a chain shard, whose uids count from it). With `disorder`
    = (nbr_J (D, N, maxnb), h (D, N), seeds (D ints)), the coupling
    realizations of one topology in packed row order: the chains are D
    blocks of chains // D, block r annealed on realization r's tables with
    seed seeds[r] (`seed` unused) and its chains counted from chain0, as
    a solo call of that realization (the disorder stride; no `tables`)."""
    if disorder is not None:
        if tables is not None:
            raise ValueError("a disorder batch takes no per-step tables")
        nbr_J, h, seeds = disorder
        per = _disorder_chains(spins.shape[0], len(seeds))
        out = []
        for r, seed_r in enumerate(seeds):
            rows = slice(r * per, (r + 1) * per)
            out.append(packed_sa_anneal_ref(
                dataclasses.replace(pg, nbr_J=nbr_J[r], h=h[r]),
                temps if temps.dim() == 1 else temps[:, rows], spins[rows],
                seed_r, None if energies is None else energies[:, rows],
                step0=step0, chain0=chain0))
        return torch.cat(out)
    hu = cr.hashed_uid(cr.generic_uids(spins.shape[0], pg.perm, pg.nspins,
                                       chain0=chain0))
    s = spins
    for t in range(temps.shape[0]):
        u = cr.uniform01_hashed(cr.counter(seed, step0 + t, 0), hu)
        s = packed_ops.packed_sweep(pg, s, u, step_values(temps, t),
                                    **_step_tables(tables, t))
        if energies is not None:
            energies[t] = packed_ops.packed_energy(pg, s)
    return s


def packed_svmc_anneal_ref(pg, a_sched, b_sched, temp, theta, seed, tf,
                           energies=None, tables=None, chain0=0):
    """Plain form of csrc/packed_svmc.cu: anneal packed angles (chains, N)
    over the float32 (steps,) schedules A and B at the Python-float
    temperature `temp`, sweep t by `packed_svmc_sweep_cached` on the
    proposal uniforms of counter(seed, t, 0) and the acceptance uniforms
    of svmc_accept_counter(seed, t, 0). With `energies`, row t receives
    each chain's energy of sign(cos theta) after sweep t; `tables` and
    chain0 as for `packed_sa_anneal_ref`."""
    temp32 = torch.tensor(temp, dtype=torch.float32, device=theta.device)
    hu = cr.hashed_uid(cr.generic_uids(theta.shape[0], pg.perm, pg.nspins,
                                       chain0=chain0))
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
                           energies=None, step0=0, chain0=0):
    """Plain form of csrc/generic_qmc.cu on packed confs (chains, P, N):
    sweep t is `piqmc.local_sweep` on the packed problem with B_t, J_perp_t
    (float32 (steps,) tensors; `jp` may be a (steps, chains) table, a
    J_perp a chain and step) at T_eff = `teff` (a Python float), on the
    uniforms of counter(seed, t, 0) at the (chain, slice, original site)
    ids, then, with `global_moves`, `piqmc.global_line_moves` on those of
    line_counter(seed, t, 0) at the slice-0 ids. With `energies`, row t
    receives each chain's least slice energy after step t. step0: the step
    the hash counts sweep 0 as; chain0: the global index of the first chain
    (a chain shard)."""
    prob = pg.as_problem()
    chains, P, n = confs.shape
    hu = cr.hashed_uid(cr.generic_uids(chains, pg.perm, n, slices=P,
                                       chain0=chain0))
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
                                step0=0, chain0=0):
    """Plain form of csrc/generic_qmc_bath.cu on packed confs (chains, P,
    N), P >= 2: sweep t is `piqmc.dissipative_local_sweep` (with `colored`,
    `dissipative_colored_sweep`) on the packed problem with B_t, J_perp_t
    and the (P, P) `bath` matrix, then the line moves, uniforms and
    energies and step0 all as in `generic_qmc_anneal_ref`. On a packing
    that is not
    `proper` the masked sweeps read a same-class neighbour as it stood at
    the start of its class's phase, which is what the kernel must match.
    chain0: the global index of the first chain (a chain shard)."""
    prob = pg.as_problem()
    sweep = (piqmc_ops.dissipative_colored_sweep if colored
             else piqmc_ops.dissipative_local_sweep)
    chains, P, n = confs.shape
    hu = cr.hashed_uid(cr.generic_uids(chains, pg.perm, n, slices=P,
                                       chain0=chain0))
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


# ------------------------------------------- the cluster route's rule of shape


def word_slots(n, R, colors=1):
    """Slots of one CTA of the cluster route, at most: every CTA holds
    ceil(n_c / R) slots of each of the `colors` classes of n sites, and
    sum_c ceil(n_c / R) <= ceil(n / R) + colors - 1."""
    return -(-n // R) + colors - 1


def words_smem_bytes(P, slots, energies=True, bath=False):
    """Shared memory of one CTA of the cluster route, all of it dynamic
    (csrc/generic_words.cuh::words_smem_bytes): the head
    (WORD_HEAD_BYTES), both buffers of `slots` slots' ceil(P/32) words,
    with `energies` a float a slice, and with the `bath` its (P, P)
    matrix."""
    return (WORD_HEAD_BYTES + 2 * -(-P // 32) * slots * 4
            + (4 * P if energies else 0) + (4 * P * P if bath else 0))


def _word_cluster(chains, n, P, colors, bath, sms):
    """(R, threads) of the cluster route by the rule of
    `generic_qmc_geometry`, the CTA's shared memory counted with or
    without the bath matrix; None where no R of CLUSTER_SIZES holds it."""
    if colors > 127:
        return None
    fits = [r for r in CLUSTER_SIZES
            if r <= max(n, 1) and words_smem_bytes(
                P, word_slots(n, r, colors), True, bath)
            <= _build.SMEM_LIMIT_BYTES]
    if not fits:
        return None
    R = next((r for r in fits if chains * r >= sms), fits[-1])
    return R, word_threads(n, R, colors)


def generic_qmc_geometry(chains, n, P, colors=1, sms=NUM_SMS):
    """(R, threads) of generic PIQMC's cluster route for `chains` chains
    of P slices of an n-site graph of `colors` color classes: each chain
    over a cluster of R CTAs, R the smallest of CLUSTER_SIZES (R <= n)
    whose chains x R CTAs cover the card's `sms` SMs (the wrappers pass
    the card's count) and whose CTA holds both buffers of its slots' words
    in shared memory (`word_slots`, `words_smem_bytes`, energies and the
    head counted), else the largest that holds them; `word_threads`
    threads. None when no cluster of up to CLUSTER_SIZES[-1] CTAs holds
    the chain (with two classes: at P <= 32 an n above 464,240, at P = 40
    above 232,080; at n = 6400 a P above 2208), and the wrapper runs the
    first kernel of csrc/generic_qmc.cu,
    the state as floats in device memory (LAUNCHES["generic_qmc_wide"]);
    so does a graph of more than 127 color classes, whose class no slot
    code holds (`word_layout`)."""
    return _word_cluster(chains, n, P, colors, False, sms)


def generic_qmc_bath_geometry(chains, n, P, colors=1, sms=NUM_SMS):
    """(R, threads) of the generic bath's cluster route by the rule of
    `generic_qmc_geometry`, each CTA also holding the (P, P) bath matrix in
    shared memory: with two classes n <= 225,680 at P = 40, and at
    n = 6400 P <= 226. None beyond (LAUNCHES["generic_qmc_bath_wide"])."""
    return _word_cluster(chains, n, P, colors, True, sms)


def word_threads(n, R, colors=1):
    """Threads a CTA of the cluster route: one a slot, in whole warps, at
    most WORD_THREADS (a thread then takes several)."""
    return min(WORD_THREADS, -(-word_slots(n, R, colors) // 32) * 32)


def sa_words_smem_bytes(slots, energies=True):
    """Shared memory of one CTA of generic SA's cluster route
    (csrc/generic_words.cuh::sa_words_smem_bytes): the head, both buffers
    of `slots` slots' one word, the group's SA_TAIL temperatures and, with
    `energies`, as many energy shares."""
    return (WORD_HEAD_BYTES + 2 * 4 * slots
            + (2 if energies else 1) * 4 * SA_TAIL)


def sa_word_threads(n, R, colors=1):
    """Threads a CTA of generic SA's cluster route: one a slot, in whole
    warps, at most SA_THREADS (a thread then takes several)."""
    return min(SA_THREADS, -(-word_slots(n, R, colors) // 32) * 32)


def packed_sa_geometry(chains, n, colors=1, sms=NUM_SMS, d_chains=0,
                       resident=None):
    """(C, R, threads) of generic SA's cluster route (csrc/generic_words.cuh,
    the SA mode) for `chains` chains of an n-site graph of `colors` color
    classes. C starts at kernel A's choice (`split_kernels.
    chain_word_bits`: 32 chains a word while that leaves FILL_GROUPS
    groups, else halved), halved until it divides `d_chains`, the chains a
    realization of a disorder batch (0: none), so no group straddles two.
    R is the largest of CLUSTER_SIZES (R <= n) whose CTA holds both
    buffers of its slots' words (`sa_words_smem_bytes`, energies counted,
    so the choice is the same with and without them) and whose groups all
    run at once, C doubling (up to 32, and while it divides d_chains)
    until they do: groups x R at most SA_BLOCKS_PER_SM x `sms` CTAs and,
    with `resident(R, threads, smem)` (the wrapper passes the card's
    cudaOccupancyMaxActiveClusters), at most the clusters the card holds;
    if none is held whole, the smallest R that fits at kernel A's C. A
    wider cluster puts fewer slots on each CTA, and a wider word spreads
    a site's loads over more chains: on an H100 80GB HBM3 at 700 W
    (PERF.md, 80x80 torus's generic form) 8 chains took (1, 16) 0.0042 ms
    a sweep against (1, 8) 0.0058, and 32 chains (2, 16) 0.0051 against
    (1, 8) 0.0068, the card holding fewer than 32 clusters of 16; 1280
    chains keep (32, 8). `sa_word_threads` threads. None when no cluster
    of 16 CTAs holds the words (with two classes, n above 463,984) or the
    graph has more than 127 classes, whose class no slot code holds
    (`word_layout`): the wrapper then runs the file's first kernel, one
    CTA a chain (the "_wide" launch keys)."""
    if colors > 127:
        return None
    C0 = chain_word_bits(chains)
    while d_chains and d_chains % C0:
        C0 //= 2
    fits = [r for r in CLUSTER_SIZES
            if r <= max(n, 1)
            and sa_words_smem_bytes(word_slots(n, r, colors))
            <= _build.SMEM_LIMIT_BYTES]
    if not fits:
        return None
    for r in reversed(fits):
        threads = sa_word_threads(n, r, colors)
        smem = sa_words_smem_bytes(word_slots(n, r, colors))
        C = C0
        while True:
            groups = -(-chains // C)
            if groups * r <= SA_BLOCKS_PER_SM * sms and (
                    resident is None or resident(r, threads, smem) >= groups):
                return C, r, threads
            if C >= min(32, chains) or (d_chains and d_chains % (2 * C)):
                break
            C *= 2
    return C0, fits[0], sa_word_threads(n, fits[0], colors)


def packed_sa_one_cta(n, colors=1):
    """Whether generic SA on an n-site graph of `colors` classes runs the
    file's first kernel, one CTA of THREADS threads a chain, rather than
    the cluster route: where a class phase, ceil(n / colors) sites, takes
    at most SA_CTA_PASSES passes of its threads (1280 sites). There a
    cluster route's phase costs its barrier and one update's latency,
    about 2 us, for little work, while the CTA's threads finish the class
    in a few fast passes. On an H100 80GB HBM3 at 700 W (`tools/
    time_kernels.py --packed-sa-crossover`, PERF.md), one CTA a chain
    against the cluster route, ms a sweep: random_3d_lattice(12) (864
    sites a class) at 8, 32, 128, 384, 1280 chains 0.0042, 0.0042, 0.0040,
    0.0069, 0.0197 against 0.0040, 0.0042, 0.0053, 0.0094, 0.0169, ICM's
    two-sweep call at 1536 chains 0.168 against 0.247 ms (the cluster
    route packs and unpacks the state in each launch); chimera_graph(16)
    (683) 0.0043-0.0229 against 0.0057-0.0239 at every count;
    gaussian_torus(48) (1152) 0.0044, 0.0044, 0.0045, 0.0076, 0.0222
    against 0.0040, 0.0043, 0.0055, 0.0101, 0.0204; gaussian_torus(56)
    (1568) 0.0065 against 0.0040 at 8 chains and 0.0305 against 0.0278 at
    1280 (0.0065 against 0.0072 at 128); 4096 sites 2.4-2.8x slower at 8
    and 32 chains, 1.5-1.6x at 1280."""
    return -(-n // max(colors, 1)) <= SA_CTA_PASSES * THREADS


def card_packed_sa_geometry(pg, chains, d_chains, per_chain, device):
    """`packed_sa_geometry` of `chains` chains of PackedGraph `pg` on the
    CUDA card `device`: its SMs, and how many clusters of each shape the
    card holds at once in the instantiation the wrapper launches
    (`per_chain`: a temperature a chain). Cached per shape."""
    def resident(R, threads, smem):
        key = (str(device), R, threads, smem, per_chain)
        if key not in _SA_RESIDENT:
            lib = _build.library("packed_sa")
            count = ctypes.c_int(0)
            rc = lib.packed_sa_words_max_active_clusters(
                R, threads, smem, int(per_chain), ctypes.byref(count))
            _build.raise_on_error(lib, "packed_sa_words_max_active_clusters",
                                  rc, error_fn="packed_sa_anneal_error_string")
            _SA_RESIDENT[key] = count.value
        return _SA_RESIDENT[key]
    return packed_sa_geometry(chains, pg.nspins, pg.num_colors,
                              sms=card_sms(device), d_chains=d_chains,
                              resident=resident)


def svmc_smem_bytes(slots, proper=True):
    """Shared memory of one CTA of generic SVMC's cluster route
    (csrc/packed_svmc.cu::svmc_smem_bytes): the head, then cos, theta and
    sin of `slots` slots, and on a packing that is not proper the snapshot
    of cos: 12 (16) bytes a slot."""
    return SVMC_HEAD_BYTES + (3 if proper else 4) * 4 * slots


def svmc_threads(n, R, colors=1):
    """Threads a CTA of generic SVMC's cluster route: one a slot, in whole
    warps, at most SVMC_THREADS (a thread then takes several)."""
    return min(SVMC_THREADS, -(-word_slots(n, R, colors) // 32) * 32)


def packed_svmc_geometry(chains, n, colors=1, sms=NUM_SMS, resident=None,
                         proper=True):
    """(R, threads) of generic SVMC's cluster route (csrc/packed_svmc.cu)
    for `chains` chains of an n-site graph of `colors` color classes: each
    chain over a cluster of R CTAs, R the largest of CLUSTER_SIZES (R <= n)
    whose CTA holds its slots' cos, theta and sin in shared memory
    (`svmc_smem_bytes`; with `proper` False, also the snapshot of cos) and
    whose `chains` clusters all run at once: chains x R at most the CTAs
    the `sms` SMs hold (SVMC_BLOCKS_PER_SM an SM, fewer where the shared
    memory runs out) and, with `resident(R, threads, smem)` (the wrapper
    passes the card's cudaOccupancyMaxActiveClusters), at most the
    clusters the card holds; if none is held whole, the smallest R that
    fits. Kernel 4's rule (`split_kernels.svmc_split_geometry`) on the
    generic slot layout: at 256 chains on the 80x80 torus's generic form
    R = 2, two CTAs of 256 threads a chain. `svmc_threads` threads. None
    when no cluster of 16 CTAs holds the slots (with two classes, n above
    309,824) or the graph has more than 127 classes (`word_layout`): the
    wrapper then runs the file's first kernel, one CTA a chain (the
    "_wide" launch keys)."""
    if colors > 127:
        return None
    fits = [r for r in CLUSTER_SIZES
            if r <= max(n, 1) and svmc_smem_bytes(
                word_slots(n, r, colors), proper) <= _build.SMEM_LIMIT_BYTES]
    if not fits:
        return None
    for r in reversed(fits):
        threads = svmc_threads(n, r, colors)
        smem = svmc_smem_bytes(word_slots(n, r, colors), proper)
        per_sm = min(SVMC_BLOCKS_PER_SM,
                     SM_SMEM_BYTES // (smem + SMEM_RESERVED_BYTES))
        if chains * r <= per_sm * sms and (
                resident is None or resident(r, threads, smem) >= chains):
            return r, threads
    return fits[0], svmc_threads(n, fits[0], colors)


def packed_svmc_one_cta(n, colors=1, proper=True):
    """Whether generic SVMC on an n-site graph of `colors` classes runs the
    file's first kernel, one CTA of THREADS threads a chain, rather than
    the cluster route: on a proper packing whose class phase, ceil(n /
    colors) sites, takes at most SVMC_CTA_PASSES passes of its threads
    (768 sites). There the cluster route's phase costs its barrier for
    little work. On an H100 80GB HBM3 at 700 W (`tools/time_kernels.py
    --packed-svmc-crossover`, PERF.md), ms a sweep of the cluster route
    at its rule's R against one CTA a chain: gaussian_torus(16) (128
    sites a class) 0.0036-0.0045 against 0.0016-0.0017 at 8-256 chains;
    chimera_graph(16) (683) 0.0089 against 0.0068 at 128 chains, 0.0092
    against 0.0085 at 256, even at 8 and 32, 0.0273 against 0.0303 at
    1280; random_3d_lattice(12) (864) 0.0043-0.0076 against 0.0056-0.0081
    at 8-256 chains but 128 (0.0069 against 0.0067), 0.0235 against
    0.0264 at 1280; from 2048 sites a class the cluster route ahead
    everywhere but 1280 chains (1.04-1.07x, R = 1). A packing that is not
    proper keeps the cluster route: both kernels read a class's neighbours
    as the phase began (the first from a snapshot in device memory, a copy
    and a barrier more a phase), and the crossover was measured on proper
    packings only."""
    return proper and -(-n // max(colors, 1)) <= SVMC_CTA_PASSES * THREADS


def card_packed_svmc_geometry(pg, chains, device):
    """`packed_svmc_geometry` of `chains` chains of PackedGraph `pg` on the
    CUDA card `device`: its SMs, and how many clusters of each shape the
    card holds at once (`packed_svmc_max_active_clusters`). Cached per
    shape."""
    def resident(R, threads, smem):
        key = (str(device), R, threads, smem)
        if key not in _SVMC_RESIDENT:
            lib = _build.library("packed_svmc")
            count = ctypes.c_int(0)
            rc = lib.packed_svmc_max_active_clusters(R, threads, smem,
                                                     ctypes.byref(count))
            _build.raise_on_error(lib, "packed_svmc_max_active_clusters", rc,
                                  error_fn="packed_svmc_anneal_error_string")
            _SVMC_RESIDENT[key] = count.value
        return _SVMC_RESIDENT[key]
    return packed_svmc_geometry(chains, pg.nspins, pg.num_colors,
                                sms=card_sms(device), resident=resident,
                                proper=pg.proper)


_SA_RESIDENT, _SVMC_RESIDENT, _LAYOUTS = {}, {}, {}


def word_layout(pg, R):
    """The cluster route's slot layout of PackedGraph `pg` over R CTAs, on
    its device: CTA r holds the r-th chunk of ceil(n_c / R) sites of every
    class c, class after class, at the same slots in every CTA. Returns
    (slot_site (R * nr,) int32, (c << 24) | packed site or -1 for an empty
    slot; slot_starts (C + 1,) int32, class c's first slot; nbr_loc (n,
    maxnb) int32, each neighbour's (CTA << 16) | slot; nr, the slots a
    CTA). Cached per graph and R."""
    key = (id(pg), R)
    hit = _LAYOUTS.get(key)
    if hit is not None and hit[0]() is pg:
        return hit[1]
    starts = np.asarray(pg.starts, dtype=np.int64)
    sizes = np.diff(starts)
    chunk = -(-sizes // R)
    slot_starts = np.concatenate([[0], np.cumsum(chunk)])
    nr = int(slot_starts[-1])
    n = pg.nspins
    cls = np.repeat(np.arange(len(sizes)), sizes)
    off = np.arange(n) - starts[:-1][cls]
    ch = np.maximum(chunk[cls], 1)
    rank = off // ch
    slot = slot_starts[:-1][cls] + off - rank * ch
    slot_site = np.full(R * max(nr, 1), -1, dtype=np.int64)
    slot_site[rank * nr + slot] = (cls << 24) | np.arange(n)
    loc = (rank << 16) | slot
    dev = pg.h.device
    layout = (torch.as_tensor(slot_site.astype(np.int32), device=dev),
              torch.as_tensor(slot_starts.astype(np.int32), device=dev),
              torch.as_tensor(loc[pg.nbr_idx.cpu().numpy()].astype(np.int32),
                              device=dev),
              nr)
    for k in [k for k, (ref, _) in _LAYOUTS.items() if ref() is None]:
        del _LAYOUTS[k]
    _LAYOUTS[key] = (weakref.ref(pg), layout)
    return layout


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


def _disorder_chains(chains, realizations):
    """The chains a realization of a disorder batch of `chains` chains
    (ValueError unless the realizations divide them)."""
    if realizations < 1 or chains % realizations:
        raise ValueError(f"{chains} chains do not divide into "
                         f"{realizations} realizations")
    return chains // realizations


def _check_disorder(disorder, tables, chains, n, maxnb, device):
    """(nbr_J and h pointers, d_chains, seeds tensor) of a packed SA
    launch's disorder batch `disorder` (`packed_sa_anneal_ref`), checked;
    (None, 0, None) without one."""
    if disorder is None:
        return None, 0, None
    if tables is not None:
        raise ValueError("a disorder batch takes no per-step tables")
    nbr_J, h, seeds = disorder
    d = len(seeds)
    per = _disorder_chains(chains, d)
    _build.check_arg(nbr_J, "disorder nbr_J", (d, n, maxnb), device)
    _build.check_arg(h, "disorder h", (d, n), device)
    seeds_t = torch.tensor([cr.wrap_int32(x) for x in seeds],
                           dtype=torch.int32, device=device)
    return (_build.ptr(nbr_J), _build.ptr(h)), per, seeds_t


def _snap(pg, state):
    """The scratch a packed kernel reads same-class neighbours from on a
    packing that is not proper (`PackedGraph.proper`, an odd periodic
    lattice's checkerboard): a tensor of the state's size; None on a
    proper one. Freed after the launch, its memory is reused only by work
    queued after it on the stream."""
    return None if pg.proper else torch.empty_like(state)




def packed_sa_anneal(pg, temps, spins, seed, energies=None, tables=None,
                     step0=0, chain0=0, disorder=None):
    """csrc/packed_sa.cu on CUDA tensors, `packed_sa_anneal_ref` on CPU
    tensors; arguments as for the plain version. Returns the new spins.

    Two hand-written kernels share the work, chosen by shape alone, each
    running the whole schedule in one launch: the cluster route
    (csrc/generic_words.cuh, the SA mode: up to 32 chains as the bits of
    each site's word) and the file's first kernel, one CTA a chain, the
    state in device memory. A graph whose class phase is small
    (`packed_sa_one_cta`) takes the first kernel; a larger one the cluster
    route, where `packed_sa_geometry` finds a cluster that holds a group's
    words. Both count under LAUNCHES["packed_sa"] (energies or not, a
    disorder batch or not; with `tables`, LAUNCHES["packed_sa_noisy"];
    with a (steps, chains) `temps`, the per-chain instantiation,
    LAUNCHES["packed_sa_chain"], whose table may repeat one row:
    `_build.schedule_strides`). A graph no cluster holds runs the first
    kernel under the same keys + "_wide". Both kernels equal the plain
    version bitwise; neither is a fallback from a failure of the other."""
    if _build.route(spins.device, "packed") == "cpu":
        return packed_sa_anneal_ref(pg, temps, spins, seed, energies, tables,
                                    step0, chain0, disorder)
    chains, n = spins.shape
    dev = spins.device
    steps = int(temps.shape[0])
    graph, j_stride, h_stride, mcsteps = _check_tables(pg, tables, steps,
                                                       energies, dev)
    tabs, d_chains, seeds = _check_disorder(disorder, tables, chains, n,
                                            pg.nbr_J.shape[1], dev)
    if tabs is not None:
        graph = (graph[0],) + tabs + graph[3:]
    _build.check_arg(spins, "spins", (chains, pg.nspins), dev)
    strides = _build.schedule_strides(temps, "temps", steps, chains, dev)
    if strides[1] and tables is not None:
        raise ValueError("the noisy anneal takes one shared schedule")
    key = ("packed_sa_noisy" if tables is not None
           else "packed_sa_chain" if strides[1] else "packed_sa")
    lib = _build.library("packed_sa")
    tail = (steps, cr.wrap_int32(seed), int(step0))
    geometry = card_packed_sa_geometry(pg, chains, d_chains,
                                       bool(strides[1]), dev)
    one_cta = packed_sa_one_cta(n, pg.num_colors)
    if geometry is not None and not one_cta:
        C, R, threads = geometry
        slot_site, slot_starts, nbr_loc, nr = word_layout(pg, R)
        out = torch.empty_like(spins)
        rc = lib.packed_sa_words_anneal(
            *map(_build.ptr, (slot_site, slot_starts, nbr_loc)), graph[1],
            graph[2], graph[3], _build.ptr(temps), _build.ptr(spins),
            _build.ptr(out),
            _build.energies_ptr(energies, steps, chains, dev), chains, C, n,
            pg.nbr_idx.shape[1], pg.num_colors, R, nr, threads, *tail,
            j_stride, h_stride, mcsteps, *strides, int(chain0), d_chains,
            None if seeds is None else _build.ptr(seeds),
            _build.stream_of(dev))
        _build.raise_on_error(lib, "packed_sa_words_anneal", rc,
                              error_fn="packed_sa_anneal_error_string")
        _build.LAUNCHES[key] += 1
        return out
    out = spins.clone()
    snap = _snap(pg, out)
    rc = lib.packed_sa_anneal(
        *graph, _build.ptr(temps), _build.ptr(out),
        None if snap is None else _build.ptr(snap),
        _build.energies_ptr(energies, steps, chains, dev), chains, n,
        pg.nbr_idx.shape[1], pg.num_colors, *tail, THREADS, j_stride,
        h_stride, mcsteps, *strides, int(chain0), d_chains,
        None if seeds is None else _build.ptr(seeds), _build.stream_of(dev))
    _build.raise_on_error(lib, "packed_sa_anneal", rc)
    _build.LAUNCHES[key if geometry is not None else key + "_wide"] += 1
    return out


def packed_svmc_anneal(pg, a_sched, b_sched, temp, theta, seed, tf,
                       energies=None, tables=None, chain0=0):
    """csrc/packed_svmc.cu on CUDA tensors, `packed_svmc_anneal_ref` on CPU
    tensors; arguments as for the plain version. Returns the new angles.

    Two hand-written kernels share the work, chosen by shape alone, each
    running the whole schedule in one launch: the cluster route
    (`packed_svmc_cluster_kernel`, R CTAs a chain on `word_layout`'s
    slots, the rotors in shared memory) and the file's first kernel, one
    CTA a chain, the state in device memory. A proper packing of small
    class phases (`packed_svmc_one_cta`) takes the first kernel; a larger
    graph the cluster route, where `packed_svmc_geometry` finds a cluster
    that holds a chain's rotors. Both count under LAUNCHES["packed_svmc"]
    (energies or not; with `tables`, LAUNCHES["packed_svmc_noisy"]). A
    graph no cluster of 16 CTAs holds, or of more than 127 classes, runs
    the first kernel under the same keys + "_wide". Both hold the plain
    version's angles as the SVMC checks do on any packing (on one that is
    not proper each reads a class's neighbours as the phase began, as the
    plain version does), and agree with each other bitwise on a proper
    packing; neither is a fallback from a failure of the other."""
    if _build.route(theta.device, "packed") == "cpu":
        return packed_svmc_anneal_ref(pg, a_sched, b_sched, temp, theta,
                                      seed, tf, energies, tables, chain0)
    chains, n = theta.shape
    dev = theta.device
    steps = int(a_sched.shape[0])
    graph, j_stride, h_stride, mcsteps = _check_tables(pg, tables, steps,
                                                       energies, dev)
    _build.check_arg(theta, "theta", (chains, pg.nspins), dev)
    _build.check_arg(a_sched, "a_sched", (steps,), dev)
    _build.check_arg(b_sched, "b_sched", (steps,), dev)
    key = "packed_svmc" if tables is None else "packed_svmc_noisy"
    lib = _build.library("packed_svmc")
    sched = (steps, cr.wrap_int32(seed), int(bool(tf)))
    strides = (j_stride, h_stride, mcsteps, int(chain0))
    geometry = card_packed_svmc_geometry(pg, chains, dev)
    one_cta = packed_svmc_one_cta(n, pg.num_colors, pg.proper)
    if geometry is not None and not one_cta:
        R, threads = geometry
        _, slot_starts, nbr_loc, nr = word_layout(pg, R)
        out = torch.empty_like(theta)
        rc = lib.packed_svmc_cluster_anneal(
            _build.ptr(slot_starts), graph[4], _build.ptr(nbr_loc),
            *graph[1:4], _build.ptr(a_sched), _build.ptr(b_sched),
            ctypes.c_float(temp), _build.ptr(theta), _build.ptr(out),
            _build.energies_ptr(energies, steps, chains, dev), chains, n,
            pg.nbr_idx.shape[1], pg.num_colors, R, nr, threads, *sched,
            *strides, int(not pg.proper), _build.stream_of(dev))
        _build.raise_on_error(lib, "packed_svmc_cluster_anneal", rc,
                              error_fn="packed_svmc_anneal_error_string")
        _build.LAUNCHES[key] += 1
        return out
    out = theta.clone()
    # the cos and sin caches, and on a packing that is not proper the
    # phases' snapshots of cos
    scratch = torch.empty((2 if pg.proper else 3, chains, n),
                          dtype=torch.float32, device=dev)
    rc = lib.packed_svmc_anneal(
        *graph, _build.ptr(a_sched), _build.ptr(b_sched),
        ctypes.c_float(temp), _build.ptr(out), _build.ptr(scratch),
        _build.energies_ptr(energies, steps, chains, dev), chains, n,
        pg.nbr_idx.shape[1], pg.num_colors, *sched, THREADS, *strides,
        int(not pg.proper), _build.stream_of(dev))
    _build.raise_on_error(lib, "packed_svmc_anneal", rc)
    _build.LAUNCHES[key if geometry is not None else key + "_wide"] += 1
    return out


def card_sms(device):
    """The SMs of the CUDA card `device`, which the rules of shape cover."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def generic_qmc_anneal(pg, b_sched, jp, teff, confs, seed, global_moves,
                       energies=None, step0=0, chain0=0):
    """csrc/generic_qmc.cu on CUDA tensors, `generic_qmc_anneal_ref` on
    CPU tensors; arguments as for the plain version. Returns the new
    configurations; on the card their spins must hold +/-1.

    Two hand-written kernels share the work, chosen by shape alone: where
    `generic_qmc_geometry` finds a cluster of up to CLUSTER_SIZES[-1] CTAs
    that holds a chain's slices as bits, the cluster route
    (csrc/generic_words.cuh) runs the whole schedule in one launch
    (LAUNCHES["generic_qmc"]); for a larger chain the file's first kernel
    keeps the state as floats in device memory, one CTA a chain, also one
    launch (LAUNCHES["generic_qmc_wide"]). Both equal the plain version
    bitwise; neither is a fallback from a failure of the other. A (steps,
    chains) `jp` takes each route's per-chain instantiation
    (LAUNCHES["generic_qmc_chain"], ["generic_qmc_chain_wide"])."""
    if _build.route(confs.device, "packed") == "cpu":
        return generic_qmc_anneal_ref(pg, b_sched, jp, teff, confs, seed,
                                      global_moves, energies, step0, chain0)
    chains, P, n = confs.shape
    dev = confs.device
    graph = _check_graph(pg, dev)
    _build.check_arg(confs, "confs", (chains, P, pg.nspins), dev)
    steps = int(b_sched.shape[0])
    _build.check_arg(b_sched, "b_sched", (steps,), dev)
    strides = _build.schedule_strides(jp, "jp", steps, chains, dev)
    m = piqmc_ops.spacetime_num_phases(pg.num_colors, P)
    lib = _build.library("generic_qmc")
    key = "generic_qmc_chain" if strides[1] else "generic_qmc"
    geometry = generic_qmc_geometry(chains, n, P, pg.num_colors,
                                    sms=card_sms(dev))
    if geometry is not None:
        slot_site, slot_starts, nbr_loc, nr = word_layout(pg, geometry[0])
        out = torch.empty_like(confs)
        rc = lib.generic_qmc_words_anneal(
            *map(_build.ptr, (slot_site, slot_starts, nbr_loc, pg.nbr_J,
                              pg.h, pg.perm, b_sched, jp)),
            ctypes.c_float(teff), _build.ptr(confs), _build.ptr(out),
            _build.energies_ptr(energies, steps, chains, dev), chains, P, n,
            pg.nbr_idx.shape[1], pg.num_colors, m, geometry[0], nr,
            geometry[1], steps, cr.wrap_int32(seed), int(step0),
            int(bool(global_moves)), *strides, int(chain0),
            _build.stream_of(dev))
        _build.raise_on_error(lib, "generic_qmc_words_anneal", rc,
                              error_fn="generic_qmc_anneal_error_string")
        _build.LAUNCHES[key] += 1
        return out
    out = confs.clone()
    snap = _snap(pg, out)
    rc = lib.generic_qmc_anneal(
        *graph, _build.ptr(b_sched), _build.ptr(jp), ctypes.c_float(teff),
        _build.ptr(out), None if snap is None else _build.ptr(snap),
        _build.energies_ptr(energies, steps, chains, dev),
        chains, P, n, pg.nbr_idx.shape[1], pg.num_colors, m, steps,
        cr.wrap_int32(seed), int(step0), int(bool(global_moves)), THREADS,
        *strides, int(chain0), _build.stream_of(dev))
    _build.raise_on_error(lib, "generic_qmc_anneal", rc)
    _build.LAUNCHES[key + "_wide"] += 1
    return out


def generic_qmc_bath_anneal(pg, b_sched, jp, teff, bath, confs, seed,
                            global_moves, colored=False, energies=None,
                            step0=0, chain0=0):
    """csrc/generic_qmc_bath.cu on CUDA tensors, `generic_qmc_bath_anneal_ref`
    on CPU tensors; arguments as for the plain version. Returns the new
    configurations; on the card their spins must hold +/-1. Sequential or
    colored, energies or not, one launch of one of two hand-written
    kernels chosen by shape alone, as for `generic_qmc_anneal`: the
    cluster route where `generic_qmc_bath_geometry` finds a cluster
    (LAUNCHES["generic_qmc_bath"]), else the file's first kernel
    (LAUNCHES["generic_qmc_bath_wide"])."""
    if _build.route(confs.device, "packed") == "cpu":
        return generic_qmc_bath_anneal_ref(pg, b_sched, jp, teff, bath,
                                           confs, seed, global_moves,
                                           colored, energies, step0, chain0)
    chains, P, n = confs.shape
    dev = confs.device
    graph = _check_graph(pg, dev)
    _build.check_arg(confs, "confs", (chains, P, pg.nspins), dev)
    _build.check_arg(bath, "bath", (P, P), dev)
    steps = int(b_sched.shape[0])
    _build.check_arg(b_sched, "b_sched", (steps,), dev)
    _build.check_arg(jp, "jp", (steps,), dev)
    m = piqmc_ops.spacetime_num_phases(pg.num_colors, P)
    lib = _build.library("generic_qmc_bath")
    geometry = generic_qmc_bath_geometry(chains, n, P, pg.num_colors,
                                         sms=card_sms(dev))
    if geometry is not None:
        slot_site, slot_starts, nbr_loc, nr = word_layout(pg, geometry[0])
        out = torch.empty_like(confs)
        rc = lib.generic_qmc_bath_words_anneal(
            *map(_build.ptr, (slot_site, slot_starts, nbr_loc, pg.nbr_J,
                              pg.h, pg.perm, b_sched, jp, bath)),
            ctypes.c_float(teff), ctypes.c_float(2.0 * teff),
            _build.ptr(confs), _build.ptr(out),
            _build.energies_ptr(energies, steps, chains, dev), chains, P, n,
            pg.nbr_idx.shape[1], pg.num_colors, m, geometry[0], nr,
            geometry[1], steps, cr.wrap_int32(seed), int(step0),
            int(bool(colored)), int(bool(global_moves)), int(chain0),
            _build.stream_of(dev))
        _build.raise_on_error(lib, "generic_qmc_bath_words_anneal", rc,
                              error_fn="generic_qmc_bath_anneal_error_string")
        _build.LAUNCHES["generic_qmc_bath"] += 1
        return out
    out = confs.clone()
    snap = (torch.empty_like(confs) if colored or not pg.proper else None)
    rc = lib.generic_qmc_bath_anneal(
        *graph, _build.ptr(b_sched), _build.ptr(jp), _build.ptr(bath),
        ctypes.c_float(teff), ctypes.c_float(2.0 * teff), _build.ptr(out),
        None if snap is None else _build.ptr(snap),
        _build.energies_ptr(energies, steps, chains, dev), chains, P, n,
        pg.nbr_idx.shape[1], pg.num_colors, m, steps,
        cr.wrap_int32(seed), int(step0), int(bool(colored)),
        int(bool(global_moves)),
        int(pg.proper), THREADS, int(chain0), _build.stream_of(dev))
    _build.raise_on_error(lib, "generic_qmc_bath_anneal", rc)
    _build.LAUNCHES["generic_qmc_bath_wide"] += 1
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
                  collect_energy=False, chain0=0):
    """SA anneal of an IsingProblem on the packed layout (counterpart of
    `ops/packed.py::packed_sweep_scan`, the JAX solver's engine for
    IsingProblem graphs).

    sched: (steps,) temperatures; spins: (chains, N) or (N,) float32 +/-1
    on the problem's device; seed: int counter-hash seed; collect_energy:
    also return the energy after each sweep, (steps * mcsteps,) + batch;
    chain0: the global index of the first chain (a chain shard). Returns
    the annealed spins, same shape, or (spins, energies)."""
    return _anneal_on(_graph_of(problem, spins, "spins"), sched, spins, seed,
                      mcsteps, collect_energy, chain0)


def _anneal_on(pg, sched, spins, seed, mcsteps, collect_energy, chain0):
    """`anneal_packed` on the packed layout `pg`."""
    temps = schedules.expand_mcsteps(sched, mcsteps, pg.h.device)
    batch = spins.shape[:-1]
    es = energy_buffer(collect_energy, temps.shape[0], batch, pg.h.device)
    out = packed_sa_anneal(pg, temps, _packed(pg, spins, pg.nspins), seed, es,
                           chain0=chain0)
    return with_energies(packed_ops.unpack_state(pg, out).reshape(
        spins.shape), es, batch)


def anneal_masked(problem, sched, spins, seed, mcsteps=1,
                  collect_energy=False, chain0=0):
    """SA anneal on the masked engine (`ops/metropolis.py::sweep_scan`,
    the JAX solver's engine="masked") of an IsingProblem on its greedy
    colors or of a LatticeProblem on its checkerboard, arguments and
    result as for `anneal_packed`. The masked and packed engines draw the
    same uniforms at the same sites and give the same spins bitwise, so on
    a CUDA device this runs the packed kernel: `anneal_packed` on an
    IsingProblem, and on a lattice the packing of its own checkerboard
    (`packed.packed_from_lattice`, whose slots the masked lattice sweep
    adds in the same order; not proper on an odd periodic L, where the
    kernel reads same-class neighbours as the masked phase does,
    ROADMAP.md queue 3). The masked plain version runs on the CPU (its
    lattice energies are the lattice's own plane sums)."""
    lattice = isinstance(problem, LatticeProblem)
    if lattice:
        if spins.device != problem.device:
            raise ValueError(f"spins is on {spins.device}, problem on "
                             f"{problem.device}")
    else:
        _check_problem(problem, spins, "spins")
    if _build.route(spins.device, "packed") == "cuda":
        pg = (packed_ops.packed_from_lattice(problem) if lattice
              else packed_ops.build_packed(problem))
        return _anneal_on(pg, sched, spins, seed, mcsteps, collect_energy,
                          chain0)
    temps = schedules.expand_mcsteps(sched, mcsteps, problem.device)
    batch = spins.shape[:-1]
    s = spins.to(torch.float32).reshape(-1, problem.nspins)
    out, es = sweep_scan(problem, s, seed, temps,
                         collect_energy=collect_energy, chain0=chain0)
    out = out.reshape(spins.shape)
    if es is None:
        return out
    return out, es.reshape((es.shape[0],) + tuple(batch))


def anneal_generic_qmc(problem, a_sched, b_sched, temp, confs, seed,
                       mcsteps=1, global_moves=True, collect_energy=False,
                       chain0=0):
    """PIQMC anneal of an IsingProblem at any P (counterpart of the masked
    space-time sweep of the JAX `solvers/qmc.py`, :152-180).

    a_sched / b_sched: (steps,) Gamma and B; temp: ambient T, T_eff = P*T;
    confs: (chains, P, N) or (P, N) float32 +/-1 slices-major on the
    problem's device; collect_energy: also return the best-slice energy
    after each sweep (line moves included), (steps * mcsteps,) + batch;
    chain0: the global index of the first chain (a chain shard). Returns
    the annealed configurations, same shape, or (confs, energies)."""
    pg = _graph_of(problem, confs, "confs")
    P, n = confs.shape[-2], pg.nspins
    b, jp, teff = schedules.qmc_terms(a_sched, b_sched, temp, P, mcsteps,
                                      problem.device)
    batch = confs.shape[:-2]
    es = energy_buffer(collect_energy, b.shape[0], batch, problem.device)
    c = packed_ops.pack_state(
        pg, confs.to(torch.float32).reshape(-1, P, n)).contiguous()
    out = generic_qmc_anneal(pg, b, jp, teff, c, seed, global_moves, es,
                             chain0=chain0)
    return with_energies(packed_ops.unpack_state(pg, out).reshape(
        confs.shape), es, batch)


def anneal_generic_qmc_bath(problem, a_sched, b_sched, temp, lookuptable,
                            confs, seed, mcsteps=1, global_moves=False,
                            colored=False, collect_energy=False, chain0=0):
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
    mcsteps,) + batch; chain0: the global index of the first chain (a
    chain shard). Returns the annealed configurations, same shape, or
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
                                  global_moves, colored, es, chain0=chain0)
    return with_energies(packed_ops.unpack_state(pg, out).reshape(
        confs.shape), es, batch)


def anneal_packed_svmc(problem, a_sched, b_sched, temp, theta, seed,
                       mcsteps=1, tf=False, collect_energy=False, chain0=0):
    """SVMC anneal of an IsingProblem on the packed layout (counterpart of
    `ops/packed.py::packed_svmc_scan`).

    a_sched / b_sched: (steps,) A and B; temp: the fixed temperature;
    theta: (chains, N) or (N,) float32 angles in [0, pi] on the problem's
    device; tf: TF proposals; collect_energy: also return the energy of
    sign(cos theta) after each sweep, (steps * mcsteps,) + batch; chain0:
    the global index of the first chain (a chain shard). Returns the
    annealed angles, same shape, or (theta, energies)."""
    pg = _graph_of(problem, theta, "theta")
    a_s, b_s = (schedules.expand_mcsteps(x, mcsteps, problem.device)
                for x in (a_sched, b_sched))
    batch = theta.shape[:-1]
    es = energy_buffer(collect_energy, a_s.shape[0], batch, problem.device)
    out = packed_svmc_anneal(pg, a_s, b_s, float(temp),
                             _packed(pg, theta, pg.nspins), seed, tf, es,
                             chain0=chain0)
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
                      mcsteps=1, chain0=0):
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
    device; seed: int counter-hash seed; chain0: the global index of the
    first chain (a chain shard; the tables are every chain's). Returns the
    annealed spins."""
    pg = _graph_of(problem, spins, "spins")
    tables = packed_tables(pg, nbr_J_sched, h_sched, mcsteps,
                           temps.shape[0], problem.device)
    out = packed_sa_anneal(pg, temps, _packed(pg, spins, pg.nspins), seed,
                           tables=tables, chain0=chain0)
    return packed_ops.unpack_state(pg, out).reshape(spins.shape)


def packed_noisy_svmc_scan(problem, a_sched, b_sched, temp, nbr_J_sched,
                           h_sched, theta, seed, tf=False, mcsteps=1,
                           chain0=0):
    """Noisy SVMC anneal of an IsingProblem on the packed layout (JAX
    `packed_noisy_svmc_scan`, ops/packed.py:308, and `_noisy_svmc_scan`
    :259; NoisySVMC / NoisySVMCTF, svmc.pyx:236-448): one launch of
    csrc/packed_svmc.cu (LAUNCHES["packed_svmc_noisy"]) on the static
    kernel's two uniform streams.

    a_sched / b_sched: float32 (rows * mcsteps,) A and B, one a sweep;
    temp: the fixed temperature; tables, mcsteps and theta ((chains, N) or
    (N,) angles) and chain0 as for `packed_noisy_scan`; tf: TF proposals.
    Returns the annealed angles."""
    pg = _graph_of(problem, theta, "theta")
    tables = packed_tables(pg, nbr_J_sched, h_sched, mcsteps,
                           a_sched.shape[0], problem.device)
    out = packed_svmc_anneal(pg, a_sched, b_sched, float(temp),
                             _packed(pg, theta, pg.nspins), seed, tf,
                             tables=tables, chain0=chain0)
    return packed_ops.unpack_state(pg, out).reshape(theta.shape)
