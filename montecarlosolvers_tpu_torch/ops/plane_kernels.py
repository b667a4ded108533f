"""Full-plane SA, PIQMC and SVMC engines: plain versions, kernel wrappers.

Counterpart of `montecarlosolvers_tpu/ops/pallas_sa.py::anneal_lattice`
(:256), `ops/pallas_qmc.py::anneal_lattice_qmc` (:146) and
`ops/pallas_svmc.py::anneal_lattice_svmc` (:117), whose Pallas kernels
`_sa_kernel` (:156), `_qmc_kernel` (:70) and `_svmc_kernel` (:56) are
ported as the CUDA kernels `csrc/plane_sa.cu` (kernel 6),
`csrc/plane_qmc.cu` (kernel 3) and `csrc/plane_svmc.cu` (kernel 7). These
engines take any LatticeProblem at any P; the solvers send here what the
split engines (`ops/split_kernels.py`) do not take: odd L, and PIQMC at
odd P.

Beside each kernel wrapper sits its plain PyTorch version
(`sa_plane_anneal_ref`, `qmc_plane_anneal_ref`, `svmc_plane_anneal_ref`),
with the semantics of the Pallas kernel on the physical L x L sites: the
same fields (`ops/plane.py`), the same counter-hash uniforms on the padded
plane's site ids, the same log-form Metropolis rule. On the CPU the spin
engines equal the Pallas interpreter bitwise, and the SVMC engine equals it
to the last ulps of cos and sin (torch's and XLA's may differ there); on
the card each kernel equals its plain version.

A phase computes every site from the state as it was when the phase began
and updates the sites of that phase's color, as the Pallas kernels do. On
an odd periodic L this is not a proper coloring (see ROADMAP.md queue 3):
the wrap neighbours (r, 0) and (r, L-1) share a color, and both may move in
one phase. The port keeps that behaviour to stay bitwise equal.

The wrappers dispatch on the device of the state: a CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises — nothing falls
back. `_build.LAUNCHES` counts the kernel launches under "sa_plane",
"qmc_plane" and "svmc_plane", and those of each kernel's per-phase kernels
under the same name + "_phased".

All three spread a chain over a thread-block cluster of R CTAs, each
holding a band of rows of the plane (csrc/cluster.cuh), and run the whole
schedule in one launch. Kernel 6 packs C chains to a word per site
(`split_kernels.pack_chain_bits` on the (chains, L*L) view) and keeps its
band twice (csrc/plane_sa.cu); `plane_sa_geometry` chooses (C, R, threads)
by kernel A's rules. Kernel 3 packs a chain's P slices to ceil(P/32) words
per site (`pack_slice_bits`) and keeps its band twice (csrc/plane_qmc.cu);
`plane_qmc_geometry` chooses (R, threads) by kernel B's rules. Kernel 7
keeps theta, sin theta and cos theta twice (csrc/plane_svmc.cu);
`plane_svmc_geometry` chooses (R, threads). Each geometry function returns
None for a shape no cluster holds, which runs on that kernel's per-phase
kernels: the card refuses no L and no P.
"""

from __future__ import annotations

import ctypes

import torch

from montecarlosolvers_tpu_torch import schedules
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import counter_rng as cr
from montecarlosolvers_tpu_torch.ops import energy as energy_ops
from montecarlosolvers_tpu_torch.ops import plane as plane_ops
from montecarlosolvers_tpu_torch.ops import split_kernels as sk
from montecarlosolvers_tpu_torch.ops import svmc_ops
from montecarlosolvers_tpu_torch.ops.metropolis import metropolis_accept
from montecarlosolvers_tpu_torch.ops.piqmc import (spacetime_num_phases,
                                                   sum_in_order)


# ------------------------------------------------------------ plain versions


def sa_plane_anneal_ref(pl, sched, spins, seed, energies=None):
    """Plain form of kernel 6: anneal `spins` (chains, L, L) over the
    float32 temperatures `sched` (steps,) with counter-hash seed `seed`.
    One step runs color 0, then color 1 (pallas_sa.py:178-197); color p
    draws from counter(seed, t, p) at the SA site ids. With `energies`, a
    (steps, chains) float32 buffer, row t receives each chain's energy
    after step t (`energy.plane_energy_ref`); the trajectory is the same
    with or without it."""
    chains, L = spins.shape[0], pl.L
    hu = cr.hashed_uid(cr.plane_uids(chains, L, spins.device))
    par = plane_ops.parity(L, spins.device)
    s = spins
    for t in range(sched.shape[0]):
        temp = sched[t]
        for color in (0, 1):
            de = -2.0 * s * plane_ops.neighbor_sum(pl, s)
            u = cr.uniform01_hashed(cr.counter(seed, t, color), hu)
            flip = metropolis_accept(de, temp, u) & (par == color)
            s = torch.where(flip, -s, s)
        if energies is not None:
            energies[t] = energy_ops.plane_energy_ref(pl, s)
    return s


def qmc_plane_anneal_ref(pl, b_sched, jp, teff, confs, seed, global_moves,
                         energies=None):
    """Plain form of kernel 3 on confs (chains, P, L, L). `b_sched` and `jp`
    are float32 (steps,) tensors of the longitudinal scale B and of J_perp;
    `teff` = P*T is a Python float.

    Per step (pallas_qmc.py:100-140): m = spacetime_num_phases(2, P) local
    phases, phase p flipping the sites with ((r + c) % 2 + k) % m == p, with
    dE = -2B s f + 2 s J_perp (s[k-1] + s[k+1]) (Trotter ring mod P) and
    uniforms from counter(seed, t, p). With `global_moves`, whole-line
    flips of color 0 and then color 1 follow: a line's dE is
    sum_k -2B s f in index order (J_perp cancels), its uniform is the
    k = 0 plane's at line_counter(seed, t, color). With `energies`, a
    (steps, chains) float32 buffer, row t receives each chain's best-slice
    energy after step t (`energy.plane_energy_ref`, solvers/qmc.py:176);
    the trajectory is the same with or without it."""
    chains, P, L = confs.shape[0], confs.shape[1], pl.L
    dev = confs.device
    m = spacetime_num_phases(2, P)
    par = plane_ops.parity(L, dev)
    k = torch.arange(P, device=dev)[:, None, None]
    stc = (par + k) % m  # (P, L, L)
    hu = cr.hashed_uid(cr.plane_uids(chains, L, dev, slices=P))
    hu0 = hu[:, 0]  # line moves: the k = 0 plane's ids
    teff32 = torch.tensor(teff, dtype=torch.float32, device=dev)
    s = confs
    for t in range(b_sched.shape[0]):
        bc = -2.0 * b_sched[t]
        jpt = jp[t]
        for p in range(m):
            f = plane_ops.neighbor_sum(pl, s)
            tr = torch.roll(s, 1, dims=1) + torch.roll(s, -1, dims=1)
            de = bc * s * f + 2.0 * s * jpt * tr
            u = cr.uniform01_hashed(cr.counter(seed, t, p), hu)
            flip = metropolis_accept(de, teff32, u) & (stc == p)
            s = torch.where(flip, -s, s)
        if global_moves:
            for color in (0, 1):
                f = plane_ops.neighbor_sum(pl, s)
                de = sum_in_order(bc * s * f, dim=1)  # (chains, L, L)
                u = cr.uniform01_hashed(cr.line_counter(seed, t, color), hu0)
                flip = metropolis_accept(de, teff32, u) & (par == color)
                s = torch.where(flip[:, None], -s, s)
        if energies is not None:
            energies[t] = energy_ops.plane_energy_ref(pl, s)
    return s


def svmc_plane_anneal_ref(pl, a_sched, b_sched, temp, theta, seed, tf,
                          energies=None):
    """Plain form of kernel 7: anneal rotor angles `theta` (chains, L, L),
    in [0, pi], over the float32 (steps,) schedules A (`a_sched`) and B
    (`b_sched`) at the Python-float temperature `temp`.

    Per step, color 0 then color 1 (pallas_svmc.py:88-111): every site
    proposes pi*u (or, with `tf`, the TF window around theta) from
    counter(seed, t, color) and is tested with the uniform of
    svmc_accept_counter(seed, t, color), both at the SA site ids, on

        dE = B (cos th' - cos th) z + A (sin th - sin th'),
        z  = neighbor_sum(cos th),

    computed from the state as the phase found it; the sites of the phase's
    color take their accepted proposals. With `energies`, a (steps,
    chains) float32 buffer, row t receives each chain's energy of
    sign(cos theta) after step t (`energy.plane_energy_ref`); the
    trajectory is the same with or without it."""
    chains, L = theta.shape[0], pl.L
    dev = theta.device
    temp32 = torch.tensor(temp, dtype=torch.float32, device=dev)
    hu = cr.hashed_uid(cr.plane_uids(chains, L, dev))
    par = plane_ops.parity(L, dev)
    th = theta
    for t in range(a_sched.shape[0]):
        ac, bc = a_sched[t], b_sched[t]
        for color in (0, 1):
            u = cr.uniform01_hashed(cr.counter(seed, t, color), hu)
            prop = (svmc_ops.propose_tf(th, u, ac, bc) if tf
                    else svmc_ops.propose_uniform(u))
            cos_t = torch.cos(th)
            zf = plane_ops.neighbor_sum(pl, cos_t)
            de = bc * (torch.cos(prop) - cos_t) * zf
            de = de + ac * (torch.sin(th) - torch.sin(prop))
            u = cr.uniform01_hashed(cr.svmc_accept_counter(seed, t, color),
                                    hu)
            acc = metropolis_accept(de, temp32, u) & (par == color)
            th = torch.where(acc, prop, th)
        if energies is not None:
            energies[t] = energy_ops.plane_energy_ref(pl, torch.cos(th),
                                                      cos_theta=True)
    return th


# ------------------------------------------------------------ kernel wrappers


def _warps(sites):
    """Threads per CTA for `sites` sites of work a phase: one a site, in
    whole warps, at most MAX_THREADS (a thread then takes several)."""
    return min(sk.MAX_THREADS, -(-sites // 32) * 32)


def _slot_threads(L, R):
    """Threads of kernels 6 and 7: one per site of a phase's color in the
    largest of R bands."""
    return _warps(-(-L // R) * ((L + 1) // 2))


def _site_threads(L, R):
    """Threads of kernel 3: one per site of the largest of R bands."""
    return _warps(-(-L // R) * L)


def sa_plane_smem_bytes(L, R):
    """Shared memory of one kernel-6 CTA: its band of ceil(L/R) rows of
    the plane, one 32-bit word of chain bits per site, twice (the ping-pong
    buffers of csrc/plane_sa.cu), so R = 16 holds L <= 675."""
    return 2 * -(-L // R) * L * 4


def plane_sa_geometry(chains, L, resident=None):
    """(C, R, threads) of kernel 6 for `chains` chains on an L x L plane,
    by the rules of `split_kernels.sa_geometry`: C chains to a word
    (`chain_word_bits`), each group over the largest cluster of R CTAs whose
    band fits a CTA and whose clusters the card holds at once (`resident(R,
    threads)`, None: any), one thread per site of a phase's color in the
    largest band, in whole warps, at most MAX_THREADS. None when no cluster
    holds the plane (L above 675), and the wrapper runs the per-phase
    kernel."""
    C = sk.chain_word_bits(chains)
    R = sk._cluster(L, -(-chains // C), lambda r: sa_plane_smem_bytes(L, r),
                    resident and (lambda r: resident(r, _slot_threads(L, r))))
    return None if R is None else (C, R, _slot_threads(L, R))


def plane_qmc_smem_bytes(P, L, R):
    """Shared memory of one kernel-3 CTA: its band of ceil(L/R) rows of a
    chain's slices as bits, ceil(P/32) words a site, twice (the ping-pong
    buffers of csrc/plane_qmc.cu), so R = 16 holds L <= 675 at P <= 32 and
    L <= 480 at P <= 64."""
    return 2 * -(-P // 32) * -(-L // R) * L * 4


def plane_qmc_geometry(chains, L, P, resident=None):
    """(R, threads) of kernel 3 by the rules of `split_kernels.qmc_geometry`:
    each chain over the largest cluster of R CTAs whose band fits a CTA and
    whose `chains` clusters the card holds at once (`resident(R, threads)`,
    None: any; if none is held whole, the smallest that fits), one thread
    per site of the largest band, in whole warps, at most MAX_THREADS. None
    when no cluster of up to CLUSTER_SIZES[-1] CTAs holds a chain of P
    slices on an L x L plane, and the wrapper runs the per-phase kernels."""
    R = sk._cluster(L, chains, lambda r: plane_qmc_smem_bytes(P, L, r),
                    resident and (lambda r: resident(r, _site_threads(L, r))))
    return None if R is None else (R, _site_threads(L, R))


def pack_slice_bits(confs):
    """(chains, P, n) +/-1 -> (chains, ceil(P/32), n) int32 words: bit
    k % 32 of word k // 32 is the sign of slice k (1 for -1); the bits past
    P are 0."""
    words = []
    for lo in range(0, confs.shape[1], 32):
        neg = (confs[:, lo:lo + 32] < 0).to(torch.int64)
        shift = torch.arange(neg.shape[1], dtype=torch.int64,
                             device=confs.device)
        words.append((neg << shift[:, None]).sum(dim=1))
    w = torch.stack(words, dim=1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def unpack_slice_bits(words, P):
    """Inverse of `pack_slice_bits`: float32 (chains, P, n) of +/-1."""
    k = torch.arange(P, device=words.device)
    bits = (words[:, k // 32] >> (k % 32).to(torch.int32)[:, None]) & 1
    return 1.0 - 2.0 * bits.to(torch.float32)


def svmc_plane_smem_bytes(L, R):
    """Shared memory of one kernel-7 CTA: its band of ceil(L/R) rows of
    theta, sin theta and cos theta twice (the ping-pong buffers of
    csrc/plane_svmc.cu), 4 floats a site, so R = 16 holds L <= 480."""
    return 4 * -(-L // R) * L * 4


def plane_svmc_geometry(chains, L, resident=None):
    """(R, threads) of kernel 7: each chain over the largest cluster of R
    CTAs whose band fits a CTA and whose `chains` clusters the card holds at
    once (`split_kernels._cluster`; `resident(R, threads)`, None: any), so
    every chain runs in one wave where the card holds them; one thread per
    site of a phase's color in the largest band, in whole warps, at most
    MAX_THREADS. None when no cluster holds the plane (L above 480), and
    the wrapper runs the per-phase kernels."""
    R = sk._cluster(L, chains, lambda r: svmc_plane_smem_bytes(L, r),
                    resident and (lambda r: resident(r, _slot_threads(L, r))))
    return None if R is None else (R, _slot_threads(L, R))


def sa_plane_anneal(pl, sched, spins, seed, energies=None):
    """Kernel 6 on CUDA tensors, `sa_plane_anneal_ref` on CPU tensors.
    Arguments as for `sa_plane_anneal_ref`; returns the new spins. The
    kernel keeps each spin's sign as a bit, so the spins must hold +/-1.

    Two hand-written CUDA kernels share the work, chosen by shape alone:
    when `plane_sa_geometry` finds a cluster of up to CLUSTER_SIZES[-1]
    CTAs whose shared memory holds a band of the plane's chain words twice
    (L <= 675), the cluster kernel runs the whole schedule in one launch
    (LAUNCHES["sa_plane"]); for a larger plane the per-phase kernel keeps
    the spins as floats in device memory and launches once a phase
    (LAUNCHES["sa_plane_phased"]). Both equal the plain version bitwise;
    neither is a fallback from a failure of the other.

    With `energies`, a (steps, chains) float32 buffer (collect_energy=), each
    chain's energy after every step is written into it. On the card that takes
    the per-phase kernels at every shape, by that option and not by a failure,
    and the energy kernel (csrc/energy.cuh) runs after each step from the same
    loop (LAUNCHES["sa_plane_energy"], one a step); the states are those of the
    route without energies."""
    if _build.route(spins.device, "plane") == "cpu":
        return sa_plane_anneal_ref(pl, sched, spins, seed, energies)
    chains, L = spins.shape[0], pl.L
    dev = spins.device
    _build.check_arg(spins, "spins", (chains, L, L), dev)
    _build.check_arg(pl.w, "planes", (5, L, L), dev)
    steps = int(sched.shape[0])
    _build.check_arg(sched, "sched", (steps,), dev)
    rows, cols = pl.strides
    lib = _build.library("plane_sa")
    geometry = None if _build.collecting(energies) else plane_sa_geometry(
        chains, L, sk.card_resident("plane_sa", L))
    if geometry is None:
        out = torch.empty_like(spins)
        scratch = torch.empty_like(spins)
        n, ne = ctypes.c_longlong(0), ctypes.c_longlong(0)  # launched
        rc = lib.plane_sa_phased_anneal(
            *map(_build.ptr, (pl.w, sched, spins, out, scratch)), chains, L,
            cols, rows * cols, steps, cr.wrap_int32(seed),
            _build.energies_ptr(energies, steps, chains, dev),
            _build.stream_of(dev), ctypes.byref(n), ctypes.byref(ne))
        _build.raise_on_error(lib, "plane_sa_phased_anneal", rc,
                              error_fn="plane_sa_anneal_error_string")
        _build.LAUNCHES["sa_plane_phased"] += n.value
        _build.LAUNCHES["sa_plane_energy"] += ne.value
        return out
    C, R, threads = geometry
    words = sk.pack_chain_bits(spins.reshape(chains, L * L), C)
    out = torch.empty_like(words)
    rc = lib.plane_sa_anneal(
        *map(_build.ptr, (pl.w, sched, words, out)), chains, C, R, threads,
        L, cols, rows * cols, steps, cr.wrap_int32(seed),
        _build.stream_of(dev),
    )
    _build.raise_on_error(lib, "plane_sa_anneal", rc)
    _build.LAUNCHES["sa_plane"] += 1
    return sk.unpack_chain_bits(out, chains, C).reshape(chains, L, L)


def qmc_plane_anneal(pl, b_sched, jp, teff, confs, seed, global_moves,
                     energies=None):
    """Kernel 3 on CUDA tensors, `qmc_plane_anneal_ref` on CPU tensors.
    Arguments as for `qmc_plane_anneal_ref`; returns new configurations. The
    kernel keeps each spin's sign as a bit, so confs must hold +/-1.

    Two hand-written CUDA kernels share the work, chosen by shape alone:
    when `plane_qmc_geometry` finds a cluster of up to CLUSTER_SIZES[-1]
    CTAs whose shared memory holds a band of a chain's slices as bits
    (every L <= 675 at P <= 32, L <= 480 at P <= 64), the cluster kernel
    runs the whole schedule in one launch (LAUNCHES["qmc_plane"]); for a
    larger chain the per-phase kernels keep the state as floats in device
    memory and launch m + 2 times a step, m without global moves
    (LAUNCHES["qmc_plane_phased"]). Both equal the plain version bitwise;
    neither is a fallback from a failure of the other.

    With `energies`, a (steps, chains) float32 buffer (collect_energy=), each
    chain's best-slice energy after every step is written into it. On the card
    that takes the per-phase kernels at every shape, by that option and not by
    a failure, and the energy kernel (csrc/energy.cuh) runs after each step
    from the same loop (LAUNCHES["qmc_plane_energy"], one a step); the states
    are those of the route without energies."""
    if _build.route(confs.device, "plane") == "cpu":
        return qmc_plane_anneal_ref(pl, b_sched, jp, teff, confs, seed,
                                    global_moves, energies)
    chains, P, L = confs.shape[0], confs.shape[1], pl.L
    dev = confs.device
    _build.check_arg(confs, "confs", (chains, P, L, L), dev)
    _build.check_arg(pl.w, "planes", (5, L, L), dev)
    steps = int(b_sched.shape[0])
    _build.check_arg(b_sched, "b_sched", (steps,), dev)
    _build.check_arg(jp, "jp", (steps,), dev)
    rows, cols = pl.strides
    m = spacetime_num_phases(2, P)
    lib = _build.library("plane_qmc")
    head = (*map(_build.ptr, (pl.w, b_sched, jp)), ctypes.c_float(teff))
    geometry = None if _build.collecting(energies) else plane_qmc_geometry(
        chains, L, P, sk.card_resident("plane_qmc", L, P))
    if geometry is not None:
        words = pack_slice_bits(confs.reshape(chains, P, L * L))
        out = torch.empty_like(words)
        rc = lib.plane_qmc_anneal(
            *head, *map(_build.ptr, (words, out)), chains, P, m, *geometry,
            L, cols, rows * cols, steps, cr.wrap_int32(seed),
            int(bool(global_moves)), _build.stream_of(dev),
        )
        _build.raise_on_error(lib, "plane_qmc_anneal", rc)
        _build.LAUNCHES["qmc_plane"] += 1
        return unpack_slice_bits(out, P).reshape(chains, P, L, L)
    out = torch.empty_like(confs)
    scratch = torch.empty_like(confs)
    n, ne = ctypes.c_longlong(0), ctypes.c_longlong(0)  # kernels launched
    rc = lib.plane_qmc_phased_anneal(
        *head, *map(_build.ptr, (confs, out, scratch)), chains, P, L, cols,
        rows * cols, m, steps, cr.wrap_int32(seed), int(bool(global_moves)),
        _build.energies_ptr(energies, steps, chains, dev),
        _build.stream_of(dev), ctypes.byref(n), ctypes.byref(ne),
    )
    _build.raise_on_error(lib, "plane_qmc_phased_anneal", rc,
                          error_fn="plane_qmc_anneal_error_string")
    _build.LAUNCHES["qmc_plane_phased"] += n.value
    _build.LAUNCHES["qmc_plane_energy"] += ne.value
    return out


def svmc_plane_anneal(pl, a_sched, b_sched, temp, theta, seed, tf,
                      energies=None):
    """Kernel 7 on CUDA tensors, `svmc_plane_anneal_ref` on CPU tensors.
    Arguments as for `svmc_plane_anneal_ref`; returns the new angles.

    Two hand-written CUDA kernels share the work, chosen by shape alone:
    when `plane_svmc_geometry` finds a cluster of up to CLUSTER_SIZES[-1]
    CTAs whose shared memory holds a band of theta, sin theta and cos theta
    twice (L <= 480), the cluster kernel runs the whole schedule in one
    launch (LAUNCHES["svmc_plane"]); for a larger plane the per-phase
    kernels keep them in device memory and launch once a phase, once more
    to fill the caches (LAUNCHES["svmc_plane_phased"]). Both equal the
    plain version bitwise; neither is a fallback from a failure of the
    other.

    With `energies`, a (steps, chains) float32 buffer (collect_energy=), each
    chain's energy of sign(cos theta), from the cos cache, after every step is
    written into it. On the card that takes the per-phase kernels at every
    shape, by that option and not by a failure, and the energy kernel
    (csrc/energy.cuh) runs after each step from the same loop
    (LAUNCHES["svmc_plane_energy"], one a step); the states are those of the
    route without energies."""
    if _build.route(theta.device, "plane") == "cpu":
        return svmc_plane_anneal_ref(pl, a_sched, b_sched, temp, theta, seed,
                                     tf, energies)
    chains, L = theta.shape[0], pl.L
    dev = theta.device
    _build.check_arg(theta, "theta", (chains, L, L), dev)
    _build.check_arg(pl.w, "planes", (5, L, L), dev)
    steps = int(a_sched.shape[0])
    _build.check_arg(a_sched, "a_sched", (steps,), dev)
    _build.check_arg(b_sched, "b_sched", (steps,), dev)
    out = torch.empty_like(theta)
    rows, cols = pl.strides
    lib = _build.library("plane_svmc")
    head = (*map(_build.ptr, (pl.w, a_sched, b_sched)), ctypes.c_float(temp),
            *map(_build.ptr, (theta, out)))
    geometry = None if _build.collecting(energies) else plane_svmc_geometry(
        chains, L, sk.card_resident("plane_svmc", L))
    if geometry is None:
        scratch = torch.empty((3, chains, L, L), dtype=torch.float32,
                              device=dev)
        n, ne = ctypes.c_longlong(0), ctypes.c_longlong(0)  # launched
        rc = lib.plane_svmc_phased_anneal(
            *head, _build.ptr(scratch), chains, L, cols, rows * cols, steps,
            cr.wrap_int32(seed), int(bool(tf)),
            _build.energies_ptr(energies, steps, chains, dev),
            _build.stream_of(dev), ctypes.byref(n), ctypes.byref(ne))
        _build.raise_on_error(lib, "plane_svmc_phased_anneal", rc,
                              error_fn="plane_svmc_anneal_error_string")
        _build.LAUNCHES["svmc_plane_phased"] += n.value
        _build.LAUNCHES["svmc_plane_energy"] += ne.value
        return out
    rc = lib.plane_svmc_anneal(
        *head, chains, *geometry, L, cols, rows * cols, steps,
        cr.wrap_int32(seed), int(bool(tf)), _build.stream_of(dev),
    )
    _build.raise_on_error(lib, "plane_svmc_anneal", rc)
    _build.LAUNCHES["svmc_plane"] += 1
    return out


# ------------------------------------------------------ lattice-level engines


def _planes_of(problem, state, name):
    """The PlaneLattice of `problem`, once `state` (the `name` argument) is
    known to lie on the problem's device."""
    from montecarlosolvers_tpu_torch.models.lattice import LatticeProblem

    if not isinstance(problem, LatticeProblem):
        raise ValueError("the full-plane engine takes a LatticeProblem")
    if state.device != problem.device:
        raise ValueError(f"{name} is on {state.device}, problem on "
                         f"{problem.device}")
    return plane_ops.build_plane(problem)


def anneal_lattice(problem, sched, spins, seed, mcsteps=1,
                   collect_energy=False):
    """Full-plane SA anneal on a LatticeProblem of any L, open or periodic
    (counterpart of `pallas_sa.anneal_lattice`, without its TPU padding).

    sched: (steps,) temperatures; spins: (chains, N) or (N,) float32 +/-1 on
    the problem's device; seed: int counter-hash seed; collect_energy: also
    return the energy after each sweep, (steps * mcsteps,) + batch, as
    `split_kernels.anneal_lattice_split` does. Returns the annealed spins,
    same shape, or (spins, energies)."""
    pl = _planes_of(problem, spins, "spins")
    temps = schedules.expand_mcsteps(sched, mcsteps, problem.device)
    L = pl.L
    batch = spins.shape[:-1]
    es = sk.energy_buffer(collect_energy, temps.shape[0], batch,
                          problem.device)
    s = spins.to(torch.float32).reshape(-1, L, L).contiguous()
    out = sa_plane_anneal(pl, temps, s, seed, es)
    return sk.with_energies(out.reshape(spins.shape), es, batch)


def anneal_lattice_qmc(problem, a_sched, b_sched, temp, confs, seed,
                       mcsteps=1, global_moves=True, collect_energy=False):
    """Full-plane PIQMC anneal on a LatticeProblem of any L at any P
    (counterpart of `pallas_qmc.anneal_lattice_qmc`).

    a_sched / b_sched: (steps,) Gamma and B; temp: ambient T, T_eff = P*T;
    confs: (chains, P, N) or (P, N) float32 +/-1 slices-major, on the
    problem's device; collect_energy: also return the best-slice energy
    after each sweep, (steps * mcsteps,) + batch. Returns the annealed
    configurations, same shape, or (confs, energies)."""
    pl = _planes_of(problem, confs, "confs")
    P, L = confs.shape[-2], pl.L
    b, jp, teff = schedules.qmc_terms(a_sched, b_sched, temp, P, mcsteps,
                                      problem.device)
    batch = confs.shape[:-2]
    es = sk.energy_buffer(collect_energy, b.shape[0], batch, problem.device)
    c = confs.to(torch.float32).reshape(-1, P, L, L).contiguous()
    out = qmc_plane_anneal(pl, b, jp, teff, c, seed, global_moves, es)
    return sk.with_energies(out.reshape(confs.shape), es, batch)


def anneal_lattice_svmc(problem, a_sched, b_sched, temp, theta, seed,
                        mcsteps=1, tf=False, collect_energy=False):
    """Full-plane SVMC anneal on a LatticeProblem of any L, open or periodic
    (counterpart of `pallas_svmc.anneal_lattice_svmc`, without its TPU
    padding).

    a_sched / b_sched: (steps,) A and B; temp: the fixed temperature;
    theta: (chains, N) or (N,) float32 angles in [0, pi] on the problem's
    device; seed: int counter-hash seed; tf: TF proposals; collect_energy:
    also return the energy of sign(cos theta) after each sweep,
    (steps * mcsteps,) + batch. Returns the annealed angles, same shape,
    or (theta, energies)."""
    pl = _planes_of(problem, theta, "theta")
    a_s, b_s = (schedules.expand_mcsteps(x, mcsteps, problem.device)
                for x in (a_sched, b_sched))
    L = pl.L
    batch = theta.shape[:-1]
    es = sk.energy_buffer(collect_energy, a_s.shape[0], batch,
                          problem.device)
    th = theta.to(torch.float32).reshape(-1, L, L).contiguous()
    out = svmc_plane_anneal(pl, a_s, b_s, temp, th, seed, tf, es)
    return sk.with_energies(out.reshape(theta.shape), es, batch)
