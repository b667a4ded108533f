"""Split-checkerboard SA, PIQMC, dissipative PIQMC and SVMC engines: plain
versions, kernel wrappers, launch counters.

Counterpart of `montecarlosolvers_tpu/ops/pallas_split.py`:
`anneal_lattice_split` (:932), `anneal_lattice_qmc_split` (:607),
`anneal_lattice_qmc_bath_split` (:857) and `anneal_lattice_svmc_split`
(:353), whose Pallas kernels `_split_kernel` (:109), `_qmc_split_kernel`
(:431), `_qmc_bath_split_kernel` (:696) and `_svmc_split_kernel` (:227) are
ported as the CUDA kernels `csrc/split_sa.cu` (kernel A),
`csrc/split_qmc.cu` (kernel B), `csrc/split_qmc_bath.cu` (kernel 5) and
`csrc/split_svmc.cu` (kernel 4). The solvers route a lattice here when
`ops/split.py::supports_split` holds (even L, and even P for PIQMC without
a bath; the bath engine takes any P >= 2), else to the full-plane engines
of `ops/plane_kernels.py`.

Beside each kernel wrapper sits its plain PyTorch version
(`sa_split_anneal_ref`, `qmc_split_anneal_ref`, `qmc_bath_split_anneal_ref`,
`svmc_split_anneal_ref`), with the semantics of the JAX oracles
`oracle_anneal`, `oracle_qmc`, `oracle_qmc_bath` and `oracle_svmc` in
tests/test_pallas_split.py: the same fields, the same counter-hash uniforms
and the same log-form Metropolis rule. On the CPU the spin engines equal
the oracles bitwise, and the SVMC engine equals its oracle to the last ulps
of cos and sin (torch's and XLA's may differ there); on the card each
kernel equals its plain version.

The wrappers dispatch on the device of the state: a CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises — nothing falls
back. `_build.LAUNCHES` counts the kernel launches under "sa_split",
"qmc_split", "qmc_bath_split" and "svmc_split", and those of each kernel's
per-phase kernels under the same name + "_phased".

`hw_rng=True` is the counterpart of the Pallas kernels' hardware-PRNG
branch (pallas_split.py:128-135, :253-259, :465-490, :719-725), which draws
from the TPU's on-chip generator instead of the counter hash. On the card
each kernel then draws from a generator stream per thread
(csrc/hw_rng.cuh: xoshiro128+ seeded by curand's Philox4x32-10), counted
under the kernel's name + "_hw" (+ "_phased"); the plain versions draw
24-bit uniforms from a `torch.Generator` seeded by `seed`, in the same
phase order (`hw_uniforms`). The three streams (kernel, plain version,
TPU) differ from each other and from the hash's: with hw_rng the kernels
are held to their plain versions, and to exact Boltzmann and Gibbs
weights, in distribution, not bitwise. A seed reproduces its result on
one geometry.

All four kernels spread a chain (kernel A: a group of C chains packed as
bits, `pack_chain_bits`) over a thread-block cluster of R CTAs, each
holding a band of rows of the halves (csrc/cluster.cuh), and so do kernels
3, 6 and 7 on the full plane (`ops/plane_kernels.py`). `sa_geometry`,
`qmc_geometry`, `qmc_bath_geometry` and `svmc_split_geometry` choose C, R
and the threads per CTA from the shape and, on the card, from how many
clusters it holds at once (`resident_clusters`); the CPU tests reach the
choice with a stand-in count. For a shape that no cluster of
CLUSTER_SIZES[-1] CTAs holds they return None, and the wrapper runs the
kernel's per-phase kernels, which keep the state in device memory: the
card refuses no lattice and no P.

With an `energies` buffer (the solvers' collect_energy=), every wrapper
takes its per-phase kernels at any shape and their C++ loop launches the
energy kernel (csrc/energy.cuh, `ops/energy.py`) after each step, counted
under "<key>_energy"; each plain version fills the buffer from the
readouts of `ops/energy.py`. The same holds for `ops/plane_kernels.py`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from montecarlosolvers_tpu_torch import schedules
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import counter_rng as cr
from montecarlosolvers_tpu_torch.ops import energy as energy_ops
from montecarlosolvers_tpu_torch.ops import split as split_ops
from montecarlosolvers_tpu_torch.ops import svmc_ops
from montecarlosolvers_tpu_torch.ops.metropolis import metropolis_accept
from montecarlosolvers_tpu_torch.ops.piqmc import bath_matrix_of, sum_in_order

# Cluster sizes kernels A, B, 3, 5, 6 and 7 may take: up to 8 CTAs is
# portable, 16 needs cudaFuncAttributeNonPortableClusterSizeAllowed (Hopper
# allows it).
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# Kernels A and 6 pack C = 32 chains to a word while that leaves at least
# this many groups; below it C halves, down to 1, so few chains still
# spread.
FILL_GROUPS = 32
# Threads per CTA of the cluster kernels (csrc/split_sa.cu, split_qmc.cu,
# split_qmc_bath.cu, plane_sa.cu and plane_qmc.cu compile for 5 such CTAs
# an SM, plane_svmc.cu for 4).
MAX_THREADS = 256


# ------------------------------------------------------------ plain versions


def hw_uniforms(seed, device):
    """The plain versions' uniform source with hw_rng=True: draw(shape)
    returns float32 uniforms in [0, 1), 24-bit integers from a
    `torch.Generator` on `device` seeded by `seed`, times 2^-24, as the
    Pallas kernels turn `pltpu.prng_random_bits` into a float
    (pallas_split.py:133-135). The port's counterpart of the interpreter's
    PRNG stub (tests/test_pallas_split.py:115, :368): a uniform source of
    the same distribution, equal neither to the kernels' streams nor to
    the TPU's."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def draw(shape):
        bits = torch.randint(0, 1 << 24, tuple(shape), generator=gen,
                             device=device, dtype=torch.int32)
        return bits.to(torch.float32) * (1.0 / (1 << 24))
    return draw


def step_values(sched, t):
    """Row t of a schedule: sched[t], a 0-d tensor, for one shared (steps,)
    schedule; the (chains, 1) column sched[t][:, None] of a (steps, chains)
    table (a value a chain, the samplers' ladders), which broadcasts over
    each chain's sites."""
    return sched[t] if sched.dim() == 1 else sched[t][:, None]


def sa_split_anneal_ref(sl, sched, a, b, seed, hw_rng=False,
                        energies=None, step0=0):
    """Plain form of kernel A: anneal halves a, b (chains, Nh) over the
    float32 temperatures `sched` ((steps,), or (steps, chains): a
    temperature a chain and step) with counter-hash seed `seed`
    (with `hw_rng`, uniforms from `hw_uniforms(seed)`, one draw of the
    half's shape a phase). Returns the new (a, b). One step updates half a
    from half b, then half b from the new half a (pallas_split.py:151-164).
    With `energies`, a (steps, chains) float32 buffer, row t receives each
    chain's energy after step t (`energy.halves_energy_ref`, the readout of
    ops/split.py:245); the trajectory is the same with or without it.
    step0: the step the hash counts step 0 as (a launch inside a longer
    run)."""
    chains, nh = a.shape
    draw = hw_uniforms(seed, a.device) if hw_rng else None
    hu_a = cr.hashed_uid(cr.sa_uids(chains, nh, 0, a.device))
    hu_b = cr.hashed_uid(cr.sa_uids(chains, nh, 1, a.device))
    for t in range(sched.shape[0]):
        if draw:
            ua, ub = draw(a.shape), draw(b.shape)
        else:
            ua = cr.uniform01_hashed(cr.counter(seed, step0 + t, 0), hu_a)
            ub = cr.uniform01_hashed(cr.counter(seed, step0 + t, 1), hu_b)
        a, b = split_ops.sa_split_sweep(sl, a, b, ua, ub,
                                        step_values(sched, t))
        if energies is not None:
            energies[t] = energy_ops.halves_energy_ref(sl, a, b)
    return a, b


def qmc_split_anneal_ref(sl, b_sched, jp, teff, quarters, seed,
                         global_moves, hw_rng=False, energies=None,
                         step0=0):
    """Plain form of kernel B on the quarters (xe, xo, ye, yo), each
    (chains, Q, Nh). `b_sched` and `jp` are float32 (steps,) tensors of the
    longitudinal scale B and of J_perp (`jp` may be a (steps, chains)
    table: a J_perp a chain and step); `teff` = P*T is a Python float;
    step0 the step the hash counts step 0 as.

    Per step: phase X updates xe, xo against ye, yo; phase Y updates ye, yo
    against the new xe, xo. dE = -2B s f + 2 s J_perp (up + down), with the
    Trotter ring (pallas_split.py:514-518), indices mod Q:

        xe: yo[q] + yo[q-1]     xo: ye[q] + ye[q+1]
        ye: xo[q] + xo[q-1]     yo: xe[q] + xe[q+1]

    With `global_moves`, whole-line flips follow: color A lines (xe, yo)
    against ye, xo, then color B lines (ye, xo) against the updated A
    quarters. A line's dE is -2B sum_q s f; J_perp cancels. With `hw_rng`,
    uniforms from `hw_uniforms(seed)`, one draw of the quarter's or the
    lines' shape per update phase, in that order. With `energies`, a
    (steps, chains) float32 buffer, row t receives each chain's best-slice
    energy after step t, line moves included (`energy.quarters_energy_ref`,
    ops/split.py:676); the trajectory is the same with or without it."""
    xe, xo, ye, yo = quarters
    chains, Q, nh = xe.shape
    K = sl.K
    dev = xe.device
    draw = hw_uniforms(seed, dev) if hw_rng else None
    wa, wb = sl.w_ab[:, 0], sl.w_ab[:, 1]
    ha, hb = sl.h_ab[0], sl.h_ab[1]
    teff32 = torch.tensor(teff, dtype=torch.float32, device=dev)
    hq = [cr.hashed_uid(cr.quarter_uids(chains, Q, nh, i, dev))
          for i in range(4)]
    hl = [cr.hashed_uid(cr.sa_uids(chains, nh, c, dev)) for c in (0, 1)]

    for t in range(b_sched.shape[0]):
        jpt = jp[t] if jp.dim() == 1 else jp[t][:, None, None]
        bc = -2.0 * b_sched[t]
        tc = step0 + t

        def upd(s, o, w, h, tr, idx):
            de = bc * s * (split_ops.spatial_field(w, o, K) + h) \
                + 2.0 * s * jpt * tr
            u = (draw(s.shape) if draw else
                 cr.uniform01_hashed(cr.counter(seed, tc, idx), hq[idx]))
            return torch.where(metropolis_accept(de, teff32, u), -s, s)

        xe = upd(xe, ye, wa, ha, yo + torch.roll(yo, 1, dims=-2), 0)
        xo = upd(xo, yo, wb, hb, ye + torch.roll(ye, -1, dims=-2), 1)
        ye = upd(ye, xe, wb, hb, xo + torch.roll(xo, 1, dims=-2), 2)
        yo = upd(yo, xo, wa, ha, xe + torch.roll(xe, -1, dims=-2), 3)

        if global_moves:
            xe, xo, ye, yo = quarter_line_moves(
                sl, (xe, xo, ye, yo), bc, teff32, lambda color, shape: (
                    draw(shape) if draw else cr.uniform01_hashed(
                        cr.counter(seed, tc, 4 + color), hl[color])))
        if energies is not None:
            energies[t] = energy_ops.quarters_energy_ref(sl,
                                                         (xe, xo, ye, yo))
    return xe, xo, ye, yo


def quarter_line_moves(sl, quarters, bc, teff32, uniforms):
    """Kernel B's whole-line flips on the quarters (JAX `qmc_split_global`,
    ops/split.py:413): the lines of color A (xe, yo) against ye and xo,
    then those of color B (ye, xo) against the updated A quarters. A line's
    dE is bc * (sum_q s f over its even quarter + the same over its odd
    quarter), each sum in slice order (J_perp cancels). bc: -2B; teff32:
    T_eff as a float32 tensor; uniforms(color, shape) gives the lines'
    uniforms. Returns the new quarters."""
    xe, xo, ye, yo = quarters

    def line_flips(s1, o1, s2, o2, color):
        """(chains, 1, Nh) factors -1 / +1 of the lines of `color`, whose
        sites are s1 and s2 with neighbours in o1 and o2."""
        w, h = sl.w_ab[:, color], sl.h_ab[color]
        f1 = split_ops.spatial_field(w, o1, sl.K) + h
        f2 = split_ops.spatial_field(w, o2, sl.K) + h
        de = bc * (sum_in_order(s1 * f1) + sum_in_order(s2 * f2))
        acc = metropolis_accept(de, teff32, uniforms(color, de.shape))
        return torch.where(acc, -1.0, 1.0)[:, None, :]

    m = line_flips(xe, ye, yo, xo, 0)
    xe, yo = xe * m, yo * m
    m = line_flips(ye, xe, xo, yo, 1)
    return xe, xo * m, ye * m, yo


def qmc_bath_split_anneal_ref(sl, b_sched, jp, teff, bath, a, b, seed,
                              global_moves, hw_rng=False, energies=None):
    """Plain form of kernel 5 on the per-slice halves a, b, each
    (chains, P, Nh), P >= 2. `b_sched` and `jp` are float32 (steps,) tensors
    of B and J_perp, `teff` = P*T a Python float, `bath` the (P, P) float32
    `bath_matrix`. Returns the new (a, b).

    Line by line `_qmc_bath_split_kernel` (pallas_split.py:736-803): per
    step, slices k = 0..P-1 in order; at the start of slice k the bath
    fields of both halves, sum_p M[k, p] s_p in index order from p = 0,
    and the Trotter sums s_up + s_dn (up = (k+P-1) mod P, dn = (k+1) mod P;
    the same slice at P = 2) are taken from the state as it stands; half A
    of slice k updates against half B, then half B against the new A, with

        dE = (-2B s) f + (2 s) J_perp tr + (2 T_eff s) bath,

    added left to right, at counter(seed, t, 2k + half) and the SA uids of
    the half. With `global_moves`, whole lines of half A flip with
    dE = -2B sum_p s_p (f_p + h) (slices in index order; J_perp and the
    bath cancel), then those of half B against the flipped A, at counter
    index 2P + half. With `hw_rng`, uniforms from `hw_uniforms(seed)`, one
    draw of a slice's or the lines' shape per update, in that order. With
    `energies`, a (steps, chains) float32 buffer, row t receives each
    chain's best-slice energy after step t (`energy.halves_energy_ref`,
    ops/split.py:715); the trajectory is the same with or without it."""
    chains, P, nh = a.shape
    K = sl.K
    dev = a.device
    draw = hw_uniforms(seed, dev) if hw_rng else None
    wa, wb = sl.w_ab[:, 0], sl.w_ab[:, 1]
    ha, hb = sl.h_ab[0], sl.h_ab[1]
    teff32 = torch.tensor(teff, dtype=torch.float32, device=dev)
    # 2.0 * teff in the Pallas kernel is a Python double, rounded to float32
    # where it meets the spins
    two_teff = torch.tensor(2.0 * teff, dtype=torch.float32, device=dev)
    hu = [cr.hashed_uid(cr.sa_uids(chains, nh, c, dev)) for c in (0, 1)]
    a, b = a.clone(), b.clone()  # slices are written in place below

    for t in range(b_sched.shape[0]):
        jpt = jp[t]
        bc = -2.0 * b_sched[t]
        for k in range(P):
            up, dn = (k + P - 1) % P, (k + 1) % P
            row = bath[k][:, None]  # (P, 1)
            bath_a = sum_in_order(row * a)
            bath_b = sum_in_order(row * b)
            a_tr = a[:, up] + a[:, dn]
            b_tr = b[:, up] + b[:, dn]
            a_k, b_k = a[:, k].clone(), b[:, k].clone()
            de = (bc * a_k * (split_ops.spatial_field(wa, b_k, K) + ha)
                  + 2.0 * a_k * jpt * a_tr + two_teff * a_k * bath_a)
            u = (draw(a_k.shape) if draw else
                 cr.uniform01_hashed(cr.counter(seed, t, 2 * k), hu[0]))
            a_k = torch.where(metropolis_accept(de, teff32, u), -a_k, a_k)
            a[:, k] = a_k
            de = (bc * b_k * (split_ops.spatial_field(wb, a_k, K) + hb)
                  + 2.0 * b_k * jpt * b_tr + two_teff * b_k * bath_b)
            u = (draw(b_k.shape) if draw else
                 cr.uniform01_hashed(cr.counter(seed, t, 2 * k + 1), hu[1]))
            b[:, k] = torch.where(metropolis_accept(de, teff32, u), -b_k, b_k)

        if global_moves:
            for half in (0, 1):
                s, o = (a, b) if half == 0 else (b, a)
                f = split_ops.spatial_field(sl.w_ab[:, half], o, K) \
                    + sl.h_ab[half]
                de = bc * sum_in_order(s * f)
                u = (draw(de.shape) if draw else
                     cr.uniform01_hashed(cr.counter(seed, t, 2 * P + half),
                                         hu[half]))
                acc = metropolis_accept(de, teff32, u)
                s.mul_(torch.where(acc, -1.0, 1.0)[:, None, :])
        if energies is not None:
            energies[t] = energy_ops.halves_energy_ref(sl, a, b)
    return a, b


def qmc_bath_split_colored_anneal_ref(sl, b_sched, jp, teff, bath,
                                      quarters, seed, global_moves,
                                      energies=None):
    """Plain form of kernel 5's colored template on the quarters (xe, xo,
    ye, yo), each (chains, Q, Nh), Q = P/2 (bath_update="colored"; JAX
    `qmc_bath_anneal_split`'s colored branch, ops/split.py:643-669).
    `b_sched`, `jp`: float32 (steps,) tensors of B and J_perp; `teff` = P*T
    a Python float; `bath` the (P, P) float32 `bath_matrix`. Returns the
    new quarters.

    Step t is `split.qmc_bath_split_colored_sweep` on the uniforms kernel B
    draws (counter(seed, t, i) at the quarter uids of quarter i), then,
    with `global_moves`, kernel B's line moves (`quarter_line_moves`, at
    counter index 4 + color). With `energies`, a (steps, chains) float32
    buffer, row t receives each chain's best-slice energy after step t
    (`energy.quarters_energy_ref`); the trajectory is the same with or
    without it."""
    chains, Q, nh = quarters[0].shape
    dev = quarters[0].device
    teff32 = torch.tensor(teff, dtype=torch.float32, device=dev)
    hq = [cr.hashed_uid(cr.quarter_uids(chains, Q, nh, i, dev))
          for i in range(4)]
    hl = [cr.hashed_uid(cr.sa_uids(chains, nh, c, dev)) for c in (0, 1)]
    for t in range(b_sched.shape[0]):
        us = [cr.uniform01_hashed(cr.counter(seed, t, i), hq[i])
              for i in range(4)]
        quarters = split_ops.qmc_bath_split_colored_sweep(
            sl, quarters, us, teff, jp[t], b_sched[t], bath)
        if global_moves:
            quarters = quarter_line_moves(
                sl, quarters, -2.0 * b_sched[t], teff32,
                lambda color, shape: cr.uniform01_hashed(
                    cr.counter(seed, t, 4 + color), hl[color]))
        if energies is not None:
            energies[t] = energy_ops.quarters_energy_ref(sl, quarters)
    return tuple(quarters)


def svmc_split_anneal_ref(sl, a_sched, b_sched, temp, a, b, seed, tf,
                          hw_rng=False, energies=None):
    """Plain form of kernel 4: anneal the rotor angles of halves a, b
    (chains, Nh), in [0, pi], over the float32 (steps,) schedules A
    (`a_sched`) and B (`b_sched`) at the Python-float temperature `temp`.
    Returns the new (a, b).

    Per step (pallas_split.py:273-303), phase A updates half a against cos
    of half b, then phase B updates half b against cos of the new half a.
    Half `c` proposes pi*u (or, with `tf`, the TF window around theta) from
    counter(seed, t, c) and accepts on counter(seed, t, c + 2), both at the
    SA uids of half c, with

        dE = B (cos th' - cos th) z + A (sin th - sin th'),
        z  = spatial_field(w_c, cos(other half), K) + h_c.

    cos and sin of each half are carried as the kernel carries them; an
    accepted move writes cos(th') and sin(th'), never an increment, so the
    caches always equal cos and sin of the angles. With `hw_rng`, uniforms
    from `hw_uniforms(seed)`: per half-phase a draw of the half's shape for
    the proposals, then one for the acceptances. With `energies`, a
    (steps, chains) float32 buffer, row t receives each chain's energy of
    sign(cos theta) after step t, read from the cos caches
    (`energy.halves_energy_ref`, ops/split.py:324-330); the trajectory is
    the same with or without it."""
    chains, nh = a.shape
    K = sl.K
    dev = a.device
    draw = hw_uniforms(seed, dev) if hw_rng else None
    temp32 = torch.tensor(temp, dtype=torch.float32, device=dev)
    hu = [cr.hashed_uid(cr.sa_uids(chains, nh, c, dev)) for c in (0, 1)]
    halves = [[a, torch.cos(a), torch.sin(a)], [b, torch.cos(b), torch.sin(b)]]
    for t in range(a_sched.shape[0]):
        ac, bc = a_sched[t], b_sched[t]
        for c in (0, 1):
            th, cos_t, sin_t = halves[c]
            u = (draw(th.shape) if draw else
                 cr.uniform01_hashed(cr.counter(seed, t, c), hu[c]))
            prop = (svmc_ops.propose_tf(th, u, ac, bc) if tf
                    else svmc_ops.propose_uniform(u))
            cos_p, sin_p = torch.cos(prop), torch.sin(prop)
            zf = split_ops.spatial_field(sl.w_ab[:, c], halves[1 - c][1],
                                         K) + sl.h_ab[c]
            de = bc * (cos_p - cos_t) * zf + ac * (sin_t - sin_p)
            u = (draw(th.shape) if draw else
                 cr.uniform01_hashed(cr.counter(seed, t, c + 2), hu[c]))
            acc = metropolis_accept(de, temp32, u)
            halves[c] = [torch.where(acc, prop, th),
                         torch.where(acc, cos_p, cos_t),
                         torch.where(acc, sin_p, sin_t)]
        if energies is not None:
            energies[t] = energy_ops.halves_energy_ref(
                sl, halves[0][1], halves[1][1], cos_theta=True)
    return halves[0][0], halves[1][0]


# ------------------------------------------ cluster geometry, chain packing


def band_sites(L, R):
    """Sites of the largest band when the L rows of a half (L/2 sites each)
    are cut into R bands: the common stride of every CTA's planes
    (csrc/cluster.cuh::band_stride)."""
    return -(-L // R) * (L // 2)


def _cluster(L, units, smem_of, resident):
    """R of `units` clusters: the largest R of CLUSTER_SIZES (R <= L, so a
    band holds a row) whose band fits one CTA's shared memory and whose
    `units` clusters the card holds at once (`resident(R)`, None: any
    number), so every CTA runs from the start on its own share of the SMs;
    if no R is held whole, the smallest that fits (the fewest CTAs that
    wait). None if no R fits."""
    sizes = [r for r in CLUSTER_SIZES
             if r <= L and smem_of(r) <= _build.SMEM_LIMIT_BYTES]
    for r in reversed(sizes):
        if resident is None or resident(r) >= units:
            return r
    return sizes[0] if sizes else None


def _threads(L, R):
    """Threads per CTA: one per site of the largest band, in whole warps,
    at most MAX_THREADS (a thread then takes several sites)."""
    return min(MAX_THREADS, -(-band_sites(L, R) // 32) * 32)


def chain_word_bits(chains):
    """C of kernels A and 6: 32 chains to a word while that leaves
    FILL_GROUPS groups, else halved, down to 1."""
    C = 32
    while C > 1 and -(-chains // C) < FILL_GROUPS:
        C //= 2
    return C


def sa_smem_bytes(L, R):
    """Shared memory of one kernel-A CTA: its band of both halves, one
    32-bit word of chain bits per site."""
    return 2 * band_sites(L, R) * 4


def sa_geometry(chains, L, resident=None):
    """(C, R, threads) of kernel A for `chains` chains on an L x L lattice:
    C chains to a word (32 while that leaves FILL_GROUPS groups, else
    halved), each group over a cluster of R CTAs (`_cluster`; `resident(R,
    threads)` is how many clusters the card holds at once, None: any),
    `threads` threads per CTA. None when no cluster holds the lattice's
    band of both halves (even L above 960), and the wrapper runs the
    per-phase kernel."""
    C = chain_word_bits(chains)
    R = _cluster(L, -(-chains // C), lambda r: sa_smem_bytes(L, r),
                 resident and (lambda r: resident(r, _threads(L, r))))
    return None if R is None else (C, R, _threads(L, R))


def qmc_smem_bytes(P, L, R):
    """Shared memory of one kernel-B CTA: its band of the four quarters as
    bits, ceil(Q/32) words a site each (Q = P/2)."""
    return 4 * (-(-(P // 2) // 32)) * band_sites(L, R) * 4


def qmc_geometry(chains, L, P, resident=None):
    """(R, threads) of kernel B: each chain over a cluster of R CTAs
    (`_cluster`, `resident` as for `sa_geometry`) of `threads` threads; None
    when no cluster of up to CLUSTER_SIZES[-1] CTAs holds a chain of P
    slices on an L x L lattice (at P <= 64 an even L above 674, at
    64 < P <= 128 above 480), and the wrapper runs the per-phase kernels."""
    R = _cluster(L, chains, lambda r: qmc_smem_bytes(P, L, r),
                 resident and (lambda r: resident(r, _threads(L, r))))
    return None if R is None else (R, _threads(L, R))


def qmc_bath_smem_bytes(P, L, R):
    """Shared memory of one kernel-5 CTA: its band of both halves' lines as
    bits (ceil(P/32) words per site) and the (P, P) bath matrix."""
    return (2 * (-(-P // 32)) * band_sites(L, R) + P * P) * 4


def qmc_bath_geometry(chains, L, P, resident=None):
    """(R, threads) of kernel 5: each chain over a cluster of R CTAs
    (`_cluster`, `resident` as for `sa_geometry`) of `threads` threads.
    None when no cluster holds a chain of P slices on an L x L lattice
    (even L from 674 at P = 40, from 402 at P = 128), and the wrapper runs
    the per-phase kernels."""
    R = _cluster(L, chains, lambda r: qmc_bath_smem_bytes(P, L, r),
                 resident and (lambda r: resident(r, _threads(L, r))))
    return None if R is None else (R, _threads(L, R))


def svmc_split_smem_bytes(L, R):
    """Shared memory of one kernel-4 CTA: its band of theta, sin theta and
    cos theta of both halves, 6 floats a half-site, so R = 16 holds even
    L <= 552."""
    return 6 * band_sites(L, R) * 4


def svmc_split_geometry(chains, L, resident=None):
    """(R, threads) of kernel 4: each chain over the largest cluster of R
    CTAs whose band fits a CTA and whose `chains` clusters the card holds
    at once (`_cluster`, `resident` as for `sa_geometry`), `threads` threads
    per CTA. None when no cluster holds the lattice (even L above 552), and
    the wrapper runs the per-phase kernels."""
    R = _cluster(L, chains, lambda r: svmc_split_smem_bytes(L, r),
                 resident and (lambda r: resident(r, _threads(L, r))))
    return None if R is None else (R, _threads(L, R))


def pack_chain_bits(x, C):
    """(chains, Nh) +/-1 -> (ceil(chains/C), Nh) int32 words: bit c of word
    g is the sign of chain g*C + c (1 for -1); a ragged last group's spare
    bits are 0."""
    return _pack_bits(x < 0, C)


def gather_chain_bits(words, idx, C):
    """Chain-bit words at C chains a word whose chain i is chain idx[i] of
    `words`: a gather of the chains that never unpacks them."""
    idx = idx.to(torch.int64)
    shift = (idx % C).to(torch.int32)[:, None]
    return _pack_bits((words[idx // C] >> shift) & 1, C)


def _pack_bits(neg_bits, C):
    """(chains, Nh) sign bits (bool or 0/1) -> the words of
    `pack_chain_bits`."""
    chains, nh = neg_bits.shape
    dev = neg_bits.device
    groups = -(-chains // C)
    neg = torch.zeros((groups * C, nh), dtype=torch.int64, device=dev)
    neg[:chains] = neg_bits
    shift = torch.arange(C, dtype=torch.int64, device=dev)
    words = (neg.reshape(groups, C, nh) << shift[:, None]).sum(dim=1)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def unpack_chain_bits(words, chains, C):
    """Inverse of `pack_chain_bits`: float32 (chains, Nh) of +/-1."""
    groups, nh = words.shape
    shift = torch.arange(C, dtype=torch.int32, device=words.device)
    bits = (words[:, None, :] >> shift[:, None]) & 1  # (groups, C, Nh)
    return (1.0 - 2.0 * bits.to(torch.float32)).reshape(groups * C,
                                                        nh)[:chains]


_RESIDENT = {}


def resident_clusters(kernel, R, threads, L, P=None):
    """How many clusters of R CTAs of `threads` threads of kernel
    "split_sa", "split_svmc", "plane_sa", "plane_svmc", "split_qmc",
    "split_qmc_bath" or "plane_qmc" (the last three at P slices) on an
    L x L lattice the card holds at once (cudaOccupancyMaxActiveClusters;
    0 when a CTA does not fit). Cached per shape."""
    key = (kernel, R, threads, L, P)
    if key not in _RESIDENT:
        lib = _build.library(kernel)
        n = ctypes.c_int(0)
        # kernel B's shared memory depends on Q = P/2, kernel 5's on P
        slices = () if P is None else (
            P // 2 if kernel == "split_qmc" else P,)
        rc = getattr(lib, f"{kernel}_max_active_clusters")(
            *slices, R, threads, L, ctypes.byref(n))
        _build.raise_on_error(lib, f"{kernel}_max_active_clusters", rc,
                              error_fn=f"{kernel}_anneal_error_string")
        _RESIDENT[key] = n.value
    return _RESIDENT[key]


def card_resident(kernel, L, P=None):
    """The `resident(R, threads)` of the card that the wrappers hand to
    the geometry functions."""
    return lambda r, threads: resident_clusters(kernel, r, threads, L, P)


# ------------------------------------------------------------ kernel wrappers


def _key(key, hw_rng):
    """The LAUNCHES key of kernel `key`'s hash or generator (hw_rng)
    instantiation."""
    return key + "_hw" if hw_rng else key


def sa_split_anneal(sl, sched, a, b, seed, hw_rng=False, energies=None,
                    step0=0):
    """Kernel A on CUDA tensors, `sa_split_anneal_ref` on CPU tensors.
    Arguments as for `sa_split_anneal_ref`; returns new (a, b). The kernel
    keeps each spin's sign as a bit, so the halves must hold +/-1.

    Two hand-written CUDA kernels share the work, chosen by shape alone:
    when `sa_geometry` finds a cluster of up to CLUSTER_SIZES[-1] CTAs
    whose shared memory holds a band of both halves as chain bits (even
    L <= 960), the cluster kernel runs the whole schedule in one launch
    (LAUNCHES["sa_split"]); for a larger lattice the per-phase kernel keeps
    the halves as floats in device memory and launches twice a step
    (LAUNCHES["sa_split_phased"]). Both equal the plain version bitwise;
    neither is a fallback from a failure of the other. `hw_rng` takes the
    generator instantiation of either (LAUNCHES["sa_split_hw"],
    ["sa_split_hw_phased"]), held to the plain version in distribution.

    With `energies`, a (steps, chains) float32 buffer (collect_energy=), each
    chain's energy after every step is written into it. On the card that takes
    the per-phase kernels at every shape, by that option and not by a failure,
    and the energy kernel (csrc/energy.cuh) runs after each step from the same
    loop (LAUNCHES["sa_split_energy"], one a step); the states are those of the
    route without energies. `hw_rng` collects none.

    A (steps, chains) `sched` takes the per-chain instantiation of either
    kernel (LAUNCHES["sa_split_chain"], ["sa_split_chain_phased"]; the
    hash only), whose table may repeat one row (an `expand` of a (chains,)
    vector: `_build.schedule_strides`)."""
    collect = _build.collecting(energies, hw_rng)
    if _build.route(a.device, "split") == "cpu":
        return sa_split_anneal_ref(sl, sched, a, b, seed, hw_rng, energies,
                                   step0)
    chains, nh = a.shape
    dev = a.device
    if nh != sl.nh:
        raise ValueError(f"halves have {nh} sites, lattice has {sl.nh}")
    for t, name in ((a, "a"), (b, "b")):
        _build.check_arg(t, name, (chains, nh), dev)
    _build.check_arg(sl.w_ab, "w_ab", (sl.nslots, 2, nh), dev)
    _build.check_arg(sl.h_ab, "h_ab", (2, nh), dev)
    steps = int(sched.shape[0])
    strides = _build.schedule_strides(sched, "sched", steps, chains, dev)
    if hw_rng and strides[1]:
        raise ValueError("a temperature per chain runs on the hash only")
    key = "sa_split_chain" if strides[1] else _key("sa_split", hw_rng)
    lib = _build.library("split_sa")
    geometry = None if collect else sa_geometry(
        chains, sl.L, card_resident("split_sa", sl.L))
    if geometry is None:
        a_out, b_out = torch.empty_like(a), torch.empty_like(b)
        n, ne = ctypes.c_longlong(0), ctypes.c_longlong(0)  # launched
        rc = lib.split_sa_phased_anneal(
            *map(_build.ptr, (sl.w_ab, sl.h_ab, sched, a, b, a_out, b_out)),
            chains, sl.L, sl.nslots, steps, cr.wrap_int32(seed),
            int(bool(hw_rng)), *strides, int(step0),
            _build.energies_ptr(energies, steps, chains, dev),
            _build.stream_of(dev), ctypes.byref(n), ctypes.byref(ne))
        _build.raise_on_error(lib, "split_sa_phased_anneal", rc,
                              error_fn="split_sa_anneal_error_string")
        _build.LAUNCHES[key + "_phased"] += n.value
        _build.LAUNCHES["sa_split_energy"] += ne.value
        return a_out, b_out
    C = geometry[0]
    a_out, b_out = sa_split_words_anneal(
        sl, sched, pack_chain_bits(a, C), pack_chain_bits(b, C), chains,
        geometry, seed, hw_rng, step0)
    return (unpack_chain_bits(a_out, chains, C),
            unpack_chain_bits(b_out, chains, C))


def words_geometry(sl, chains, device):
    """Kernel A's cluster geometry (C, R, threads) for `chains` chains of
    the lattice on `device`, the one `sa_split_anneal` launches at: None on
    the CPU and where no cluster holds the lattice (the per-phase kernel
    then takes float halves). A caller that launches kernel A again and
    again keeps its state as chain-bit words at this geometry."""
    if _build.route(device, "split") == "cpu":
        return None
    return sa_geometry(chains, sl.L, card_resident("split_sa", sl.L))


def sa_split_words_anneal(sl, sched, a, b, chains, geometry, seed,
                          hw_rng=False, step0=0):
    """Kernel A's cluster route on its own layout: halves a, b of `chains`
    chains as chain-bit words (`pack_chain_bits` at C = geometry[0], int32
    (ceil(chains/C), Nh)) in and new words out, one launch at
    `geometry` (`words_geometry`); `sched`, `seed`, `hw_rng` and `step0`
    as for `sa_split_anneal`, which packs, calls this and unpacks. A
    sampler that launches once an exchange keeps its state in these words
    from launch to launch. On CPU words, `sa_split_anneal_ref` on the
    unpacked halves, packed again."""
    C, R, threads = geometry
    dev = a.device
    if _build.route(dev, "split") == "cpu":
        out = sa_split_anneal_ref(sl, sched, unpack_chain_bits(a, chains, C),
                                  unpack_chain_bits(b, chains, C), seed,
                                  hw_rng, step0=step0)
        return tuple(pack_chain_bits(x, C) for x in out)
    groups = -(-chains // C)
    for t, name in ((a, "a"), (b, "b")):
        _build.check_arg(t, name, (groups, sl.nh), dev, torch.int32)
    steps = int(sched.shape[0])
    strides = _build.schedule_strides(sched, "sched", steps, chains, dev)
    if hw_rng and strides[1]:
        raise ValueError("a temperature per chain runs on the hash only")
    key = "sa_split_chain" if strides[1] else _key("sa_split", hw_rng)
    lib = _build.library("split_sa")
    a_out, b_out = torch.empty_like(a), torch.empty_like(b)
    rc = lib.split_sa_anneal(
        *map(_build.ptr, (sl.w_ab, sl.h_ab, sched, a, b, a_out, b_out)),
        chains, C, R, threads, sl.L, sl.nslots, steps,
        cr.wrap_int32(seed), int(bool(hw_rng)), *strides, int(step0),
        _build.stream_of(dev),
    )
    _build.raise_on_error(lib, "split_sa_anneal", rc)
    _build.LAUNCHES[key] += 1
    return a_out, b_out


def words_energy_ref(sl, a, b, chains, C):
    """Plain form of the chain-bit energy kernel: (chains,) float32
    energies of halves held as chain-bit words (`energy.halves_energy_ref`
    of the unpacked halves)."""
    return energy_ops.halves_energy_ref(sl, unpack_chain_bits(a, chains, C),
                                        unpack_chain_bits(b, chains, C))


def words_energy(sl, a, b, chains, C):
    """The energy kernel on kernel A's chain-bit words (csrc/energy.cuh::
    chain_bits_energy_kernel, LAUNCHES["energy_bits"]) on CUDA tensors,
    `words_energy_ref` on CPU ones: the energies without unpacking the
    state, bitwise those of `energy.halves_energy` on the unpacked
    halves."""
    if _build.route(a.device, "energy") == "cpu":
        return words_energy_ref(sl, a, b, chains, C)
    groups = -(-chains // C)
    for t, name in ((a, "a"), (b, "b")):
        _build.check_arg(t, name, (groups, sl.nh), a.device, torch.int32)
    return energy_ops.launch(
        "energy_chain_bits", a.device, chains,
        *map(_build.ptr, (sl.w_ab, sl.h_ab, a, b)), chains, C, sl.L,
        sl.nslots, key="energy_bits")


def qmc_split_anneal(sl, b_sched, jp, teff, quarters, seed, global_moves,
                     hw_rng=False, energies=None, step0=0):
    """Kernel B on CUDA tensors, `qmc_split_anneal_ref` on CPU tensors.
    Arguments as for `qmc_split_anneal_ref`; returns new quarters. The
    kernel keeps each spin's sign as a bit, so the quarters must hold +/-1.

    Two hand-written CUDA kernels share the work, chosen by shape alone:
    when `qmc_geometry` finds a cluster of up to CLUSTER_SIZES[-1] CTAs
    whose shared memory holds a band of a chain's four quarters as bits
    (every even L <= 674 at P <= 64, L <= 480 at P <= 128), the cluster
    kernel runs the whole schedule in one launch (LAUNCHES["qmc_split"]);
    for a larger chain the per-phase kernels keep the state in device
    memory and launch four times a step, two without global moves
    (LAUNCHES["qmc_split_phased"]). Both equal the plain version bitwise;
    neither is a fallback from a failure of the other. `hw_rng` takes the
    generator instantiation of either (LAUNCHES["qmc_split_hw"],
    ["qmc_split_hw_phased"]), held to the plain version in distribution.

    With `energies`, a (steps, chains) float32 buffer (collect_energy=), each
    chain's best-slice energy after every step is written into it. On the card
    that takes the per-phase kernels at every shape, by that option and not by
    a failure, and the energy kernel (csrc/energy.cuh) runs after each step
    from the same loop (LAUNCHES["qmc_split_energy"], one a step); the states
    are those of the route without energies. `hw_rng` collects none.

    A (steps, chains) `jp` takes the per-chain instantiation of either
    kernel (LAUNCHES["qmc_split_chain"], ["qmc_split_chain_phased"]; the
    hash only), as `sa_split_anneal` takes a temperature table."""
    collect = _build.collecting(energies, hw_rng)
    xe = quarters[0]
    if _build.route(xe.device, "split") == "cpu":
        return qmc_split_anneal_ref(sl, b_sched, jp, teff, quarters, seed,
                                    global_moves, hw_rng, energies, step0)
    chains, Q, nh = xe.shape
    dev = xe.device
    if nh != sl.nh:
        raise ValueError(f"quarters have {nh} sites, lattice has {sl.nh}")
    for t, name in zip(quarters, ("xe", "xo", "ye", "yo")):
        _build.check_arg(t, name, (chains, Q, nh), dev)
    _build.check_arg(sl.w_ab, "w_ab", (sl.nslots, 2, nh), dev)
    _build.check_arg(sl.h_ab, "h_ab", (2, nh), dev)
    steps = int(b_sched.shape[0])
    _build.check_arg(b_sched, "b_sched", (steps,), dev)
    strides = _build.schedule_strides(jp, "jp", steps, chains, dev)
    if hw_rng and strides[1]:
        raise ValueError("a J_perp per chain runs on the hash only")
    key = "qmc_split_chain" if strides[1] else _key("qmc_split", hw_rng)
    outs = [torch.empty_like(q) for q in quarters]
    lib = _build.library("split_qmc")
    args = (*map(_build.ptr, (sl.w_ab, sl.h_ab, b_sched, jp)),
            ctypes.c_float(teff), *map(_build.ptr, (*quarters, *outs)))
    geometry = None if collect else qmc_geometry(
        chains, sl.L, 2 * Q, card_resident("split_qmc", sl.L, 2 * Q))
    if geometry is not None:
        rc = lib.split_qmc_anneal(
            *args, chains, Q, *geometry, sl.L, sl.nslots, steps,
            cr.wrap_int32(seed), int(bool(global_moves)), int(bool(hw_rng)),
            *strides, int(step0), _build.stream_of(dev))
        _build.raise_on_error(lib, "split_qmc_anneal", rc)
        _build.LAUNCHES[key] += 1
        return tuple(outs)
    n, ne = ctypes.c_longlong(0), ctypes.c_longlong(0)  # kernels launched
    rc = lib.split_qmc_phased_anneal(
        *args, chains, Q, nh, sl.K, sl.nslots, steps, cr.wrap_int32(seed),
        int(bool(global_moves)), int(bool(hw_rng)), *strides, int(step0),
        _build.energies_ptr(energies, steps, chains, dev),
        _build.stream_of(dev), ctypes.byref(n), ctypes.byref(ne),
    )
    _build.raise_on_error(lib, "split_qmc_phased_anneal", rc,
                          error_fn="split_qmc_anneal_error_string")
    _build.LAUNCHES[key + "_phased"] += n.value
    _build.LAUNCHES["qmc_split_energy"] += ne.value
    return tuple(outs)


def qmc_bath_split_anneal(sl, b_sched, jp, teff, bath, a, b, seed,
                          global_moves, hw_rng=False, energies=None):
    """Kernel 5 on CUDA tensors, `qmc_bath_split_anneal_ref` on CPU tensors.
    Arguments as for `qmc_bath_split_anneal_ref`; returns new (a, b). The
    kernel keeps each spin's sign, so the halves must hold +/-1.

    Two hand-written CUDA kernels share the work, chosen by shape alone:
    when `qmc_bath_geometry` finds a cluster of up to CLUSTER_SIZES[-1]
    CTAs whose shared memory holds a band of a chain's lines as bits and
    the bath matrix, the cluster kernel runs the whole schedule in one
    launch (LAUNCHES["qmc_bath_split"]); for a larger chain the per-phase
    kernels keep the halves as floats in device memory and launch twice a
    step, four times with global moves (LAUNCHES["qmc_bath_split_phased"]).
    Both equal the plain version bitwise; neither is a fallback from a
    failure of the other. `hw_rng` takes the generator instantiation of
    either (LAUNCHES["qmc_bath_split_hw"], ["qmc_bath_split_hw_phased"]),
    held to the plain version in distribution.

    With `energies`, a (steps, chains) float32 buffer (collect_energy=), each
    chain's best-slice energy after every step is written into it. On the card
    that takes the per-phase kernels at every shape, by that option and not by
    a failure, and the energy kernel (csrc/energy.cuh) runs after each step
    from the same loop (LAUNCHES["qmc_bath_split_energy"], one a step); the
    states are those of the route without energies. `hw_rng` collects none."""
    collect = _build.collecting(energies, hw_rng)
    if _build.route(a.device, "split") == "cpu":
        return qmc_bath_split_anneal_ref(sl, b_sched, jp, teff, bath, a, b,
                                         seed, global_moves, hw_rng,
                                         energies)
    chains, P, nh = a.shape
    dev = a.device
    if nh != sl.nh:
        raise ValueError(f"halves have {nh} sites, lattice has {sl.nh}")
    if P < 2:
        raise ValueError(f"the bath engine takes P >= 2 slices, got {P}")
    for t, name in ((a, "a"), (b, "b")):
        _build.check_arg(t, name, (chains, P, nh), dev)
    _build.check_arg(sl.w_ab, "w_ab", (sl.nslots, 2, nh), dev)
    _build.check_arg(sl.h_ab, "h_ab", (2, nh), dev)
    _build.check_arg(bath, "bath", (P, P), dev)
    steps = int(b_sched.shape[0])
    _build.check_arg(b_sched, "b_sched", (steps,), dev)
    _build.check_arg(jp, "jp", (steps,), dev)
    a_out = torch.empty_like(a)
    b_out = torch.empty_like(b)
    lib = _build.library("split_qmc_bath")
    head = (*map(_build.ptr, (sl.w_ab, sl.h_ab, b_sched, jp, bath)),
            ctypes.c_float(teff), ctypes.c_float(2.0 * teff),
            *map(_build.ptr, (a, b, a_out, b_out)))
    geometry = None if collect else qmc_bath_geometry(
        chains, sl.L, P, card_resident("split_qmc_bath", sl.L, P))
    if geometry is None:
        n, ne = ctypes.c_longlong(0), ctypes.c_longlong(0)  # launched
        rc = lib.split_qmc_bath_phased_anneal(
            *head, chains, P, sl.L, sl.nslots, steps, cr.wrap_int32(seed),
            int(bool(global_moves)), int(bool(hw_rng)),
            _build.energies_ptr(energies, steps, chains, dev),
            _build.stream_of(dev), ctypes.byref(n), ctypes.byref(ne))
        _build.raise_on_error(lib, "split_qmc_bath_phased_anneal", rc,
                              error_fn="split_qmc_bath_anneal_error_string")
        _build.LAUNCHES[_key("qmc_bath_split", hw_rng) + "_phased"] += n.value
        _build.LAUNCHES["qmc_bath_split_energy"] += ne.value
        return a_out, b_out
    rc = lib.split_qmc_bath_anneal(
        *head, chains, P, *geometry, sl.L, sl.nslots, steps,
        cr.wrap_int32(seed), int(bool(global_moves)), int(bool(hw_rng)),
        _build.stream_of(dev),
    )
    _build.raise_on_error(lib, "split_qmc_bath_anneal", rc)
    _build.LAUNCHES[_key("qmc_bath_split", hw_rng)] += 1
    return a_out, b_out


def qmc_bath_split_colored_anneal(sl, b_sched, jp, teff, bath, quarters,
                                  seed, global_moves, energies=None):
    """Kernel 5's colored template on CUDA tensors,
    `qmc_bath_split_colored_anneal_ref` on CPU tensors; arguments as for
    the plain version (even P, the counter hash only). Returns the new
    quarters. The kernel keeps each spin's sign, so the quarters must hold
    +/-1.

    The kernel reads the halves a (xe and yo as its even and odd slices)
    and b (ye and xo), which the wrapper interleaves from the quarters and
    splits back. Its two routes are kernel 5's, by shape alone
    (`qmc_bath_geometry`): the cluster kernel, one launch
    (LAUNCHES["qmc_bath_split_colored"]), or its per-phase kernels, four
    launches a step and two more with global moves
    (LAUNCHES["qmc_bath_split_colored_phased"]). With `energies` the
    per-phase kernels run at any shape and the energy kernel after each
    step (LAUNCHES["qmc_bath_split_colored_energy"]); the states are those
    of the route without energies."""
    xe = quarters[0]
    if _build.route(xe.device, "split") == "cpu":
        return qmc_bath_split_colored_anneal_ref(
            sl, b_sched, jp, teff, bath, quarters, seed, global_moves,
            energies)
    chains, Q, nh = xe.shape
    P = 2 * Q
    dev = xe.device
    if nh != sl.nh:
        raise ValueError(f"quarters have {nh} sites, lattice has {sl.nh}")
    for t, name in zip(quarters, ("xe", "xo", "ye", "yo")):
        _build.check_arg(t, name, (chains, Q, nh), dev)
    _build.check_arg(sl.w_ab, "w_ab", (sl.nslots, 2, nh), dev)
    _build.check_arg(sl.h_ab, "h_ab", (2, nh), dev)
    _build.check_arg(bath, "bath", (P, P), dev)
    steps = int(b_sched.shape[0])
    _build.check_arg(b_sched, "b_sched", (steps,), dev)
    _build.check_arg(jp, "jp", (steps,), dev)
    xe, xo, ye, yo = quarters
    a = torch.stack([xe, yo], dim=2).reshape(chains, P, nh)
    b = torch.stack([ye, xo], dim=2).reshape(chains, P, nh)
    a_out, b_out = torch.empty_like(a), torch.empty_like(b)
    lib = _build.library("split_qmc_bath")
    head = (*map(_build.ptr, (sl.w_ab, sl.h_ab, b_sched, jp, bath)),
            ctypes.c_float(teff), ctypes.c_float(2.0 * teff),
            *map(_build.ptr, (a, b, a_out, b_out)))
    geometry = None if energies is not None else qmc_bath_geometry(
        chains, sl.L, P, card_resident("split_qmc_bath", sl.L, P))
    if geometry is None:
        tmp = torch.empty((2,) + a.shape, dtype=torch.float32, device=dev)
        n, ne = ctypes.c_longlong(0), ctypes.c_longlong(0)  # launched
        rc = lib.split_qmc_bath_colored_phased_anneal(
            *head, _build.ptr(tmp[0]), _build.ptr(tmp[1]), chains, P, sl.L,
            sl.nslots, steps, cr.wrap_int32(seed), int(bool(global_moves)),
            _build.energies_ptr(energies, steps, chains, dev),
            _build.stream_of(dev), ctypes.byref(n), ctypes.byref(ne))
        _build.raise_on_error(lib, "split_qmc_bath_colored_phased_anneal",
                              rc, error_fn="split_qmc_bath_anneal_error_string")
        _build.LAUNCHES["qmc_bath_split_colored_phased"] += n.value
        _build.LAUNCHES["qmc_bath_split_colored_energy"] += ne.value
    else:
        rc = lib.split_qmc_bath_colored_anneal(
            *head, chains, P, *geometry, sl.L, sl.nslots, steps,
            cr.wrap_int32(seed), int(bool(global_moves)),
            _build.stream_of(dev))
        _build.raise_on_error(lib, "split_qmc_bath_colored_anneal", rc,
                              error_fn="split_qmc_bath_anneal_error_string")
        _build.LAUNCHES["qmc_bath_split_colored"] += 1
    return (a_out[:, 0::2].contiguous(), b_out[:, 1::2].contiguous(),
            b_out[:, 0::2].contiguous(), a_out[:, 1::2].contiguous())


def svmc_split_anneal(sl, a_sched, b_sched, temp, a, b, seed, tf,
                      hw_rng=False, energies=None):
    """Kernel 4 on CUDA tensors, `svmc_split_anneal_ref` on CPU tensors.
    Arguments as for `svmc_split_anneal_ref`; returns new (a, b).

    Two hand-written CUDA kernels share the work, chosen by shape alone:
    when `svmc_split_geometry` finds a cluster of up to CLUSTER_SIZES[-1]
    CTAs whose shared memory holds a band of a chain's angles, cos and sin
    (even L <= 552), the cluster kernel runs the whole schedule in one
    launch (LAUNCHES["svmc_split"]); for a larger lattice the per-phase
    kernels keep them in device memory and launch twice a step, once more
    to fill the caches (LAUNCHES["svmc_split_phased"]). Both equal the
    plain version bitwise; neither is a fallback from a failure of the
    other. `hw_rng` takes the generator instantiation of either
    (LAUNCHES["svmc_split_hw"], ["svmc_split_hw_phased"]), held to the
    plain version in distribution.

    With `energies`, a (steps, chains) float32 buffer (collect_energy=), each
    chain's energy of sign(cos theta), from the cos caches, after every step is
    written into it. On the card that takes the per-phase kernels at every
    shape, by that option and not by a failure, and the energy kernel
    (csrc/energy.cuh) runs after each step from the same loop
    (LAUNCHES["svmc_split_energy"], one a step); the states are those of the
    route without energies. `hw_rng` collects none."""
    collect = _build.collecting(energies, hw_rng)
    if _build.route(a.device, "split") == "cpu":
        return svmc_split_anneal_ref(sl, a_sched, b_sched, temp, a, b, seed,
                                     tf, hw_rng, energies)
    chains, nh = a.shape
    dev = a.device
    if nh != sl.nh:
        raise ValueError(f"halves have {nh} sites, lattice has {sl.nh}")
    for t, name in ((a, "a"), (b, "b")):
        _build.check_arg(t, name, (chains, nh), dev)
    _build.check_arg(sl.w_ab, "w_ab", (sl.nslots, 2, nh), dev)
    _build.check_arg(sl.h_ab, "h_ab", (2, nh), dev)
    steps = int(a_sched.shape[0])
    _build.check_arg(a_sched, "a_sched", (steps,), dev)
    _build.check_arg(b_sched, "b_sched", (steps,), dev)
    a_out = torch.empty_like(a)
    b_out = torch.empty_like(b)
    lib = _build.library("split_svmc")
    head = (*map(_build.ptr, (sl.w_ab, sl.h_ab, a_sched, b_sched)),
            ctypes.c_float(temp), *map(_build.ptr, (a, b, a_out, b_out)))
    geometry = None if collect else svmc_split_geometry(
        chains, sl.L, card_resident("split_svmc", sl.L))
    if geometry is None:
        scratch = torch.empty((4, chains, nh), dtype=torch.float32,
                              device=dev)
        n, ne = ctypes.c_longlong(0), ctypes.c_longlong(0)  # launched
        rc = lib.split_svmc_phased_anneal(
            *head, _build.ptr(scratch), chains, sl.L, sl.nslots, steps,
            cr.wrap_int32(seed), int(bool(tf)), int(bool(hw_rng)),
            _build.energies_ptr(energies, steps, chains, dev),
            _build.stream_of(dev), ctypes.byref(n), ctypes.byref(ne))
        _build.raise_on_error(lib, "split_svmc_phased_anneal", rc,
                              error_fn="split_svmc_anneal_error_string")
        _build.LAUNCHES[_key("svmc_split", hw_rng) + "_phased"] += n.value
        _build.LAUNCHES["svmc_split_energy"] += ne.value
        return a_out, b_out
    rc = lib.split_svmc_anneal(
        *head, chains, *geometry, sl.L, sl.nslots, steps,
        cr.wrap_int32(seed), int(bool(tf)), int(bool(hw_rng)),
        _build.stream_of(dev),
    )
    _build.raise_on_error(lib, "split_svmc_anneal", rc)
    _build.LAUNCHES[_key("svmc_split", hw_rng)] += 1
    return a_out, b_out


# ------------------------------------------------------ lattice-level engines


def _split_of(problem, state, name, slices=None):
    """The SplitLattice of `problem`, once it is known to take the split
    engine (at P = `slices` for PIQMC) and `state` (the `name` argument) to
    lie on the problem's device."""
    if not split_ops.supports_split(problem, slices):
        raise ValueError("the split engine takes an even-L LatticeProblem"
                         + ("" if slices is None else " at even P"))
    if state.device != problem.device:
        raise ValueError(f"{name} is on {state.device}, problem on "
                         f"{problem.device}")
    return split_ops.build_split(problem)


def energy_buffer(collect_energy, steps, batch, device):
    """The (steps, chains) float32 buffer a collecting anneal fills, chains
    the product of the state's `batch` dimensions; None without
    `collect_energy`."""
    if not collect_energy:
        return None
    return torch.empty((steps, math.prod(batch)), dtype=torch.float32,
                       device=device)


def with_energies(out, energies, batch):
    """What a lattice-level engine returns: `out`, or (out, energies) with
    the energies shaped (steps,) + batch, as the JAX solvers return them."""
    if energies is None:
        return out
    return out, energies.reshape((energies.shape[0],) + tuple(batch))


def _on_halves(sl, state, fn):
    """Pack `state`, (chains, N) or (N,), into contiguous float32 halves,
    run fn(a, b) -> (a, b) on them, and unpack to the state's shape."""
    s = state.to(torch.float32)
    a, b = split_ops.pack_classical(sl, s[None] if s.ndim == 1 else s)
    out = split_ops.unpack_classical(sl, *fn(a.contiguous(), b.contiguous()))
    return out.reshape(state.shape)


def anneal_lattice_split(problem, sched, spins, seed, mcsteps=1,
                         hw_rng=False, collect_energy=False):
    """Split-layout SA anneal on an even-L LatticeProblem (counterpart of
    `pallas_split.anneal_lattice_split`, without its TPU lane rules and its
    `chain_block` and `chunk`, which tile the TPU's grid).

    sched: (steps,) temperatures; spins: (chains, N) or (N,) float32 +/-1 on
    the problem's device; seed: int counter-hash seed; hw_rng: draw the
    uniforms from the kernel's generator streams instead of the counter
    hash (see the module docstring: another stream, held in distribution);
    collect_energy: also return the energy after each sweep, float32 of
    shape (steps * mcsteps,) + batch (the JAX solver's `collect_energy`);
    on the card it takes the per-phase kernel and the energy kernel.
    Returns the annealed spins, same shape, or (spins, energies)."""
    sl = _split_of(problem, spins, "spins")
    temps = schedules.expand_mcsteps(sched, mcsteps, problem.device)
    batch = spins.shape[:-1]
    es = energy_buffer(collect_energy, temps.shape[0], batch, problem.device)
    out = _on_halves(sl, spins, lambda a, b: sa_split_anneal(
        sl, temps, a, b, seed, hw_rng, es))
    return with_energies(out, es, batch)


def anneal_lattice_qmc_split(problem, a_sched, b_sched, temp, confs, seed,
                             mcsteps=1, global_moves=True, hw_rng=False,
                             collect_energy=False):
    """Split-layout PIQMC anneal on an even-L LatticeProblem at even P
    (counterpart of `pallas_split.anneal_lattice_qmc_split`, without its
    `chain_block` and `chunk`).

    a_sched / b_sched: (steps,) Gamma and B; temp: ambient T, T_eff = P*T;
    confs: (chains, P, N) or (P, N) float32 +/-1 slices-major, on the
    problem's device; hw_rng as for `anneal_lattice_split`; collect_energy:
    also return the best-slice energy after each sweep (line moves
    included), (steps * mcsteps,) + batch. Returns the annealed
    configurations, same shape, or (confs, energies)."""
    slices = confs.shape[-2]
    sl = _split_of(problem, confs, "confs", slices)
    b, jp, teff = schedules.qmc_terms(a_sched, b_sched, temp, slices,
                                      mcsteps, problem.device)
    squeeze = confs.ndim == 2
    c = confs[None] if squeeze else confs
    batch = confs.shape[:-2]
    es = energy_buffer(collect_energy, b.shape[0], batch, problem.device)
    quarters = split_ops.pack_qmc(sl, c.to(torch.float32))
    quarters = qmc_split_anneal(sl, b, jp, teff, quarters, seed,
                                global_moves, hw_rng, es)
    out = split_ops.unpack_qmc(sl, *quarters)
    return with_energies(out[0] if squeeze else out, es, batch)


def anneal_lattice_qmc_bath_split(problem, a_sched, b_sched, temp,
                                  lookuptable, confs, seed, mcsteps=1,
                                  global_moves=False, hw_rng=False,
                                  collect_energy=False, colored=False):
    """Split-layout dissipative PIQMC anneal on an even-L LatticeProblem at
    any P >= 2 (counterpart of `pallas_split.anneal_lattice_qmc_bath_split`,
    without its TPU lane rules, `chain_block` and `chunk`); with `colored`,
    at even P, the colored sweep on the quarters (JAX
    `qmc_bath_anneal_split(bath_update="colored")`, ops/split.py:618),
    kernel 5's colored template.

    a_sched / b_sched: (steps,) Gamma and B; temp: ambient T, T_eff = P*T;
    lookuptable: (P-1,) bath couplings (`schedules.bath_lookuptable`), a
    tensor or array, taken as float32 on the problem's device; confs:
    (chains, P, N) or (P, N) float32 +/-1 slices-major, on the problem's
    device; seed: int counter-hash seed; global_moves: whole-line flips
    after each sweep (DissipativeQuantumAnnealGlobal, qmc.pyx:444-609);
    hw_rng as for `anneal_lattice_split` (not with `colored`);
    collect_energy as for `anneal_lattice_qmc_split`. Returns the annealed
    configurations, same shape, or (confs, energies)."""
    slices = confs.shape[-2]
    bath = bath_matrix_of(lookuptable, slices, problem.device)
    sl = _split_of(problem, confs, "confs", slices if colored else None)
    b, jp, teff = schedules.qmc_terms(a_sched, b_sched, temp, slices,
                                      mcsteps, problem.device)
    squeeze = confs.ndim == 2
    c = (confs[None] if squeeze else confs).to(torch.float32)
    batch = confs.shape[:-2]
    es = energy_buffer(collect_energy, b.shape[0], batch, problem.device)
    if colored:
        if hw_rng:
            raise ValueError("the colored bath sweep draws from the counter "
                             "hash only")
        out = split_ops.unpack_qmc(sl, *qmc_bath_split_colored_anneal(
            sl, b, jp, teff, bath, split_ops.pack_qmc(sl, c), seed,
            global_moves, es))
        return with_energies(out[0] if squeeze else out, es, batch)
    a, b_half = split_ops.pack_classical(sl, c)
    a, b_half = qmc_bath_split_anneal(sl, b, jp, teff, bath, a.contiguous(),
                                      b_half.contiguous(), seed,
                                      global_moves, hw_rng, es)
    out = split_ops.unpack_classical(sl, a, b_half)
    return with_energies(out[0] if squeeze else out, es, batch)


def anneal_lattice_svmc_split(problem, a_sched, b_sched, temp, theta, seed,
                              mcsteps=1, tf=False, hw_rng=False,
                              collect_energy=False):
    """Split-layout SVMC anneal on an even-L LatticeProblem (counterpart of
    `pallas_split.anneal_lattice_svmc_split`, without its TPU lane rules,
    `chain_block` and `chunk`).

    a_sched / b_sched: (steps,) A and B; temp: the fixed temperature;
    theta: (chains, N) or (N,) float32 angles in [0, pi] on the problem's
    device; seed: int counter-hash seed; tf: TF proposals; hw_rng as for
    `anneal_lattice_split`; collect_energy: also return the energy of the
    z-projection sign(cos theta) after each sweep, (steps * mcsteps,) +
    batch. Returns the annealed angles, same shape, or (theta,
    energies)."""
    sl = _split_of(problem, theta, "theta")
    a_s, b_s = (schedules.expand_mcsteps(x, mcsteps, problem.device)
                for x in (a_sched, b_sched))
    batch = theta.shape[:-1]
    es = energy_buffer(collect_energy, a_s.shape[0], batch, problem.device)
    out = _on_halves(sl, theta, lambda a, b: svmc_split_anneal(
        sl, a_s, b_s, temp, a, b, seed, tf, hw_rng, es))
    return with_energies(out, es, batch)
