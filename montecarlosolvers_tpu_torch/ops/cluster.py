"""Cluster updates: Wolff space-time clusters, Swendsen-Wang labeling and
the imaginary-time line clusters of the bath, as plain PyTorch
(counterpart of montecarlosolvers_tpu/ops/cluster.py).

The functions follow the JAX ones line for line and take their draws as
arguments, as `ops/piqmc.py` does: the uniforms, seed positions and coins
the JAX function draws from `jax.random` inside, here in the same shapes,
with a leading batch of chains (the JAX functions are vmapped over chains).
The tests feed them the JAX package's own draws; the anneals at the end
(`*_anneal_ref`) feed them the counter hash (`counter_rng`'s cluster
streams) and are the plain versions of the CUDA kernels of
`ops/cluster_kernels.py`. J_perp is taken precomputed, as the PIQMC sweeps
take it (`schedules.jperp`), and T_eff as a Python float or a float32
0-d tensor.

`ids`, where a function takes it, is each position's ORIGINAL site index
(the packed layout's `perm`; None: the positions themselves). It decides
which endpoint of a pair draws the pair's bond (the lower id) and the
labels of the Swendsen-Wang components (their least k * N + id), so that
a kernel on the packed layout draws and labels as the plain version does.

The float sums that decide a flip are added in index order, as XLA's CPU
loops add a reduction over one axis: the Wolff field term per slice over
the spins, then over the slices; the line's set-flip energy and
`sw_full_phase`'s closure sum over the slices (`piqmc.sum_in_order`). The
kernels add them in the same order.

The Houdayer move of parallel tempering's ICM (`solvers/pt.py::
sample_icm`): `houdayer_sweep` on a neighbour table and
`houdayer_sweep_grid` on per-axis bond masks (`grid_bonds_from_edges`,
labelled by `_label_components_grid`), both labelling each q = -1
component by its least flat index; `houdayer_move_ref` is the plain
version of csrc/houdayer.cu (`cluster_kernels.houdayer_move`) on the
counter hash's HOUDAYER stream. `classical_sw_sweep` on a LatticeProblem
runs `classical_sw_sweep_lattice` (the coupling planes, labelled by the
segmented row and column min-scans of `_label_components_lattice` /
`_seg_min_scan`), as the JAX function routes it.
"""

from __future__ import annotations

import math

import torch

import numpy as np

from montecarlosolvers_tpu_torch import _device
from montecarlosolvers_tpu_torch.ops import counter_rng as cr
from montecarlosolvers_tpu_torch.ops.metropolis import metropolis_accept
from montecarlosolvers_tpu_torch.ops.piqmc import sum_in_order


def _f32(x, like):
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _ids(ids, n, device):
    if ids is None:
        return torch.arange(n, device=device)
    return ids.to(device=device, dtype=torch.long)


def bond_prob(de, teff):
    """p = 1 - exp(dE / T_eff) for dE < 0, else 0 (JAX `_bond_prob`,
    :70)."""
    return torch.where(de < 0.0, 1.0 - torch.exp(de / _f32(teff, de)),
                       torch.zeros_like(de))


def mirror_upper(u):
    """Per-pair uniforms over the last two axes, symmetrized by mirroring
    the upper triangle: one draw per undirected pair (JAX `_mirror_upper`,
    :75)."""
    n = u.shape[-1]
    r = torch.arange(n, device=u.device)
    return torch.where(r[:, None] < r[None, :], u, u.transpose(-1, -2))


# ------------------------------------------------------- the Wolff cluster


def symmetrize_spatial(active_sp, nbr_idx):
    """The directed spatial-bond mask (..., N, maxnb) made undirected, safe
    under duplicate neighbor slots (JAX `_symmetrize_spatial`, :89): a bond
    (i <-> j) is active iff any slot of either endpoint's row that points
    at the other drew it. Pad slots point at their own row and are never
    active."""
    nbr = nbr_idx.long()
    n, maxnb = nbr.shape
    same_nb = nbr[:, :, None] == nbr[:, None, :]  # (N, maxnb, maxnb)
    active_or = (active_sp[..., :, None, :] & same_nb).any(-1)
    # rev_slot[i, m]: the first slot of j = nbr[i, m]'s row pointing at i
    back = nbr[nbr]  # (N, maxnb, maxnb)
    own = torch.arange(n, device=nbr.device)[:, None, None]
    rev_slot = torch.argmax((back == own).to(torch.uint8), dim=-1)
    flat = (nbr * maxnb + rev_slot).reshape(-1)
    lead = active_or.shape[:-2]
    active_rev = active_or.reshape(lead + (-1,))[..., flat].reshape(
        active_or.shape)
    return active_or | active_rev


def seed_component(seed_slice, seed_spin, active_sp, nbr_idx, active_up,
                   active_bath=None):
    """The seed's connected component by frontier BFS (JAX
    `_seed_component`, :124), batched over leading axes.

    seed_slice, seed_spin: ints or int tensors of the batch shape.
    active_sp: (..., P, N, maxnb) bool, directed (symmetrized here);
    active_up: (..., P, N) bool, bond (k, k + 1 mod P); active_bath:
    optional (..., N, P, P) bool, slice a reaches b's line partner when
    active_bath[n, a, b] and b is in the frontier. Returns (..., P, N)
    bool."""
    slices, nspins = active_up.shape[-2:]
    lead = active_up.shape[:-2]
    nbr = nbr_idx.long()
    active_full = symmetrize_spatial(active_sp, nbr)
    dn_active = torch.roll(active_up, 1, dims=-2)
    flat = (torch.as_tensor(seed_slice, device=active_up.device) * nspins
            + torch.as_tensor(seed_spin, device=active_up.device))
    seed = torch.zeros(lead + (slices * nspins,), dtype=torch.bool,
                       device=active_up.device)
    seed.scatter_(-1, flat.long().expand(lead)[..., None], True)
    visited = frontier = seed.reshape(lead + (slices, nspins))
    while bool(frontier.any()):
        reach = (frontier[..., nbr] & active_full).any(-1)
        reach = reach | (active_up & torch.roll(frontier, -1, dims=-2))
        reach = reach | (dn_active & torch.roll(frontier, 1, dims=-2))
        if active_bath is not None:
            f_t = frontier.transpose(-1, -2)  # (..., N, P)
            reach = reach | (active_bath & f_t[..., None, :]).any(
                -1).transpose(-1, -2)
        frontier = reach & ~visited
        visited = visited | frontier
    return visited


def bath_bond_prob(s, teff, lookuptable):
    """(..., N, P, P) FK probabilities of the bath pairs of (..., P, N)
    spins s: p[n, a, b] = bond_prob(-2 T_eff lut[(b - a) mod P - 1] s_a
    s_b) off the diagonal (JAX wolff_update :246-253 and
    spacetime_sw_sweep :915-923)."""
    slices = s.shape[-2]
    lut = _f32(lookuptable, s)
    r = torch.arange(slices, device=s.device)
    off = (r[None, :] - r[:, None]) % slices
    st = s.transpose(-1, -2)  # (..., N, P)
    de_b = (-2.0 * _f32(teff, s) * lut[(off - 1).clamp(min=0)]
            * st[..., :, None] * st[..., None, :])
    return torch.where(off > 0, bond_prob(de_b, teff),
                       torch.zeros_like(de_b))


def field_sum(problem, s, mask):
    """sum over `mask` of h_i s_i of (..., P, N) spins: each slice's spins
    in index order, then the slices in index order. All-zero fields give
    +/-0 whatever the order, and are not summed."""
    if not bool((problem.h != 0).any()):
        return torch.zeros(s.shape[:-2], dtype=torch.float32,
                           device=s.device)
    x = torch.where(mask, problem.h * s, torch.zeros_like(s))
    return sum_in_order(sum_in_order(x, dim=-1), dim=-1)


def _wolff(problem, confs, seed_slice, seed_spin, u_sp, u_t, u_b, u_acc,
           teff, jp, b, rule, lookuptable, ids):
    """wolff_update, also returning the component."""
    if rule not in ("local", "full"):
        raise ValueError(f"rule must be 'local' or 'full', got {rule!r}")
    slices, nspins = confs.shape[-2:]
    s = confs.to(torch.float32)
    nbr = problem.nbr_idx.long()
    own = torch.arange(nspins, device=s.device)
    idv = _ids(ids, nspins, s.device)
    jp, b = _f32(jp, s), _f32(b, s)
    s_nb = s[..., nbr]  # (..., P, N, maxnb)
    seed_slice = torch.as_tensor(seed_slice, device=s.device).long()
    seed_spin = torch.as_tensor(seed_spin, device=s.device).long()

    if rule == "local":
        de_sp = 2.0 * b * problem.nbr_J * s[..., None] * s_nb
        de_t = -2.0 * jp * s * torch.roll(s, -1, dims=-2)
        gate_sp = idv[:, None] < idv[nbr]  # one draw a pair; excludes pad
        gate_t = torch.ones_like(s, dtype=torch.bool)
    else:
        flat = s.reshape(s.shape[:-2] + (-1,))
        kval = flat.gather(-1, (seed_slice * nspins + seed_spin).expand(
            s.shape[:-2])[..., None])[..., None]  # (..., 1, 1)
        same = s == kval
        field = problem.local_fields(s)
        up = torch.roll(s, 1, dims=-2)
        dn = torch.roll(s, -1, dims=-2)
        de_site = -2.0 * b * kval * field + 2.0 * jp * kval * (up + dn)
        de_sp = de_site[..., nbr]
        de_t = torch.roll(de_site, -1, dims=-2)
        pad = nbr == own[:, None]
        gate_sp = same[..., None] & same[..., nbr] & ~pad
        gate_t = same & torch.roll(same, -1, dims=-2)

    active_sp = gate_sp & (u_sp < bond_prob(de_sp, teff))
    active_up = gate_t & (u_t < bond_prob(de_t, teff))
    active_bath = None
    if lookuptable is not None:
        active_bath = mirror_upper(u_b) < bath_bond_prob(s, teff,
                                                         lookuptable)
        if rule != "local":
            st = same.transpose(-1, -2)
            active_bath = active_bath & st[..., :, None] & st[..., None, :]

    comp = seed_component(seed_slice, seed_spin, active_sp, nbr, active_up,
                          active_bath)
    if rule == "local":
        de_h = -2.0 * b * field_sum(problem, s, comp)
        accept = metropolis_accept(de_h, _f32(teff, s), u_acc)
        flip = comp & accept[..., None, None]
    else:
        flip = comp & same
    return torch.where(flip, -confs, confs), comp


def wolff_update(problem, confs, seed_slice, seed_spin, u_sp, u_t, u_b,
                 u_acc, teff, jp, b, rule="local", lookuptable=None,
                 ids=None):
    """One Wolff cluster update (JAX `wolff_update`, :174) of each chain of
    (..., P, N) float32 +/-1 `confs` on an IsingProblem.

    The draws of `jax.random.split(key, 6)`: seed_slice and seed_spin
    (ints of the batch shape), u_sp (..., P, N, maxnb) spatial-bond
    uniforms, u_t (..., P, N) Trotter-bond uniforms, u_b (..., N, P, P)
    bath-pair uniforms (mirrored here; None without a bath), u_acc (the
    batch shape) the field accept's. teff: T_eff = P * T; jp: J_perp (0
    for the classical Wolff, Gamma = inf); b: B. rule "local" is
    satisfied-bond Fortuin-Kasteleyn with a Metropolis accept on the field
    term; "full" the reference's full-local-energy heuristic (flip with
    probability 1). lookuptable: optional (P-1,) bath couplings."""
    return _wolff(problem, confs, seed_slice, seed_spin, u_sp, u_t, u_b,
                  u_acc, teff, jp, b, rule, lookuptable, ids)[0]


# ---------------------------------------------- imaginary-time line clusters


def time_closure(adj):
    """Exact transitive closure of (..., P, P) boolean adjacency, self
    included: closure[a, b] iff a path a -> b (JAX `_time_closure`, :281,
    by repeated squaring)."""
    P = adj.shape[-1]
    a = adj | torch.eye(P, dtype=torch.bool, device=adj.device)
    for _ in range(max(1, math.ceil(math.log2(max(P, 2))))):
        a = (a.to(torch.float32) @ a.to(torch.float32)) > 0.0
    return a


def line_set_flip_de(confs, spin_field, flip_mask, b, jp):
    """Energy change of flipping `flip_mask` (..., P, N) of every line at
    once over the non-bath terms, (..., N) (JAX `_line_set_flip_de`, :295),
    each sum over the slices in index order."""
    s = confs.to(torch.float32)
    t = torch.where(flip_mask, -s, s)
    de = b * sum_in_order(spin_field * (t - s), dim=-2)
    return de - jp * sum_in_order(
        t * torch.roll(t, -1, dims=-2) - s * torch.roll(s, -1, dims=-2),
        dim=-2)


def pair_prob(lookuptable, slices, device):
    """(P, P) bath FK probabilities of equal-sign pairs by ring offset,
    1 - exp(-2 lut[(b - a) mod P - 1]), 0 on the diagonal (JAX
    bath_cluster_phase :339-340, sw_full_phase :400-403)."""
    lut = torch.as_tensor(lookuptable, dtype=torch.float32, device=device)
    r = torch.arange(slices, device=device)
    off = (r[None, :] - r[:, None]) % slices
    return torch.where(off > 0, 1.0 - torch.exp(-2.0 * lut[(off - 1).clamp(
        min=0)]), torch.zeros((), dtype=torch.float32, device=device))


def trotter_prob(jp, teff):
    """FK probability of a satisfied Trotter bond, 1 - exp(-2 J_perp /
    T_eff) (JAX sw_full_phase :412)."""
    return 1.0 - torch.exp(-2.0 * jp / _f32(teff, jp))


def bath_cluster_phase(problem, confs, u_bond, u_acc, seed_slices,
                       color_mask, teff, jp, b, lookuptable, p_pair=None):
    """One phase of SW-style bath-bond line clusters (JAX
    `bath_cluster_phase`, :316) on (..., P, N) confs: each line of
    `color_mask` grows its seed slice's cluster over satisfied bath bonds
    and flips it on a Metropolis accept of the non-bath set-flip energy.

    u_bond: (..., N, P, P) pair uniforms (mirrored here); u_acc: (..., N);
    seed_slices: (..., N) ints; color_mask: (N,) bool; p_pair: `pair_prob`
    of the table (computed if None)."""
    slices = confs.shape[-2]
    s = confs.to(torch.float32)
    jp, b = _f32(jp, s), _f32(b, s)
    if p_pair is None:
        p_pair = pair_prob(lookuptable, slices, confs.device)
    seeds = torch.as_tensor(seed_slices, device=s.device).long()
    kval = confs.gather(-2, seeds[..., None, :])  # (..., 1, N)
    same = confs == kval
    st = same.transpose(-1, -2)  # (..., N, P)
    adj = (mirror_upper(u_bond) < p_pair) & st[..., :, None] & st[..., None,
                                                                  :]
    closure = time_closure(adj)  # (..., N, P, P)
    comp = closure.gather(-2, seeds[..., :, None, None].expand(
        seeds.shape + (1, slices))).squeeze(-2)  # (..., N, P): seed's row
    comp = comp.transpose(-1, -2) & same
    field = problem.local_fields(s)
    de = line_set_flip_de(confs, field, comp & color_mask, b, jp)
    accept = metropolis_accept(de, _f32(teff, s), u_acc) & color_mask
    return torch.where(comp & accept[..., None, :], -confs, confs)


def sw_full_phase(problem, confs, u_bath, u_t, u_acc, color_mask, teff, jp,
                  b, lookuptable, p_pair=None):
    """One phase of full Swendsen-Wang line decomposition (JAX
    `sw_full_phase`, :363): bath and Trotter bonds of each line of
    `color_mask` in one FK draw, every cluster accepted on its own field
    set-flip energy with the uniform of its first slice.

    u_bath: (..., N, P, P) pair uniforms (mirrored here); u_t: (..., P, N)
    Trotter uniforms of bond (k, k + 1 mod P); u_acc: (..., P, N), read at
    each cluster's first slice; color_mask: (N,) bool."""
    slices = confs.shape[-2]
    s = confs.to(torch.float32)
    jp, b = _f32(jp, s), _f32(b, s)
    if p_pair is None:
        p_pair = pair_prob(lookuptable, slices, confs.device)
    st = confs.transpose(-1, -2)
    adj = (mirror_upper(u_bath) < p_pair) & (st[..., :, None]
                                             == st[..., None, :])
    # the ring's bond k <-> k+1: for P = 2 the two parallel edges union
    active_t = (confs == torch.roll(confs, -1, dims=-2)) & (
        u_t < trotter_prob(jp, teff))
    r = torch.arange(slices, device=confs.device)
    ring = (r[None, :] == (r[:, None] + 1) % slices)
    adj = adj | (ring & active_t.transpose(-1, -2)[..., :, None])
    adj = adj | adj.transpose(-1, -2)
    closure = time_closure(adj)  # row k: k's cluster
    site_de = (-2.0 * b * problem.local_fields(s) * s).transpose(-1, -2)
    de = sum_in_order(torch.where(closure, site_de[..., None, :],
                                  torch.zeros((), device=s.device)),
                      dim=-1).transpose(-1, -2)  # (..., P, N)
    rep = torch.argmax(closure.to(torch.uint8), dim=-1)  # least member
    u_sel = u_acc.transpose(-1, -2).gather(-1, rep).transpose(-1, -2)
    accept = metropolis_accept(de, _f32(teff, s), u_sel) & color_mask
    return torch.where(accept, -confs, confs)


def sw_bath_sweep(problem, confs, draws, teff, jp, b, lookuptable,
                  per_slice_seeds=False, seeds=None):
    """A full SW-bath sweep over the color classes (JAX `sw_bath_sweep`,
    :440). draws: one entry per color phase, (u_bath, u_t, u_acc) for
    `sw_full_phase` (per_slice_seeds) or (u_bond, u_acc) for
    `bath_cluster_phase`, whose (..., N) seed slices are `seeds`."""
    p_pair = pair_prob(lookuptable, confs.shape[-2], confs.device)
    for c in range(problem.num_colors):
        mask = problem.color_masks[c]
        if per_slice_seeds:
            confs = sw_full_phase(problem, confs, *draws[c], mask, teff, jp,
                                  b, lookuptable, p_pair)
        else:
            confs = bath_cluster_phase(problem, confs, *draws[c], seeds,
                                       mask, teff, jp, b, lookuptable,
                                       p_pair)
    return confs


# ------------------------------------------------------------ Swendsen-Wang


def label_components(active_full, nbr_idx, init=None, jump_every=0):
    """Connected-component labels of the active spatial bond graph (...,
    N, maxnb) by min-label relaxation (JAX `_label_components`, :487): the
    fixed point is each component's least `init` label (default the
    index), -1 absorbing (a frozen component). jump_every=k > 0 adds two
    pointer jumps after every k relax rounds; the fixed point is the same.
    Plain PyTorch only: the kernel of ops/cluster_kernels.py labels by
    union-find."""
    nbr = nbr_idx.long()
    n = nbr.shape[0]
    lead = active_full.shape[:-2]
    if init is None:
        init = torch.arange(n, device=nbr.device).expand(lead + (n,))
    labels = init.long()

    def relax(lab):
        nb = torch.where(active_full, lab[..., nbr], n)
        return torch.minimum(lab, nb.min(-1).values)

    while True:
        new = labels
        for _ in range(max(jump_every, 1)):
            new = relax(new)
        if jump_every:
            for _ in range(2):
                new = torch.where(new < 0, -1, new.gather(
                    -1, new.clamp(min=0)))
            new = relax(new)
        if bool((new == labels).all()):
            return labels
        labels = new


def classical_sw_sweep(problem, s, u_sp, u_h, coins, temp, ids=None):
    """One classical Swendsen-Wang sweep of (..., N) spins (JAX
    `classical_sw_sweep`, :559): FK bonds on satisfied pairs, ghost-spin
    bonds for the fields (label -1), every free cluster flipped on its
    coin. u_sp: (..., N, maxnb); u_h: (..., N); coins: (..., N) bool,
    read at each component's label (its least id). A LatticeProblem runs
    `classical_sw_sweep_lattice` (u_sp then (..., 2, L, L), u_h (..., L,
    L)), as the JAX function routes it."""
    if not hasattr(problem, "nbr_idx"):
        return classical_sw_sweep_lattice(problem, s, u_sp, u_h, coins, temp)
    n = problem.nspins
    nbr = problem.nbr_idx.long()
    idv = _ids(ids, n, s.device)
    de_sp = 2.0 * problem.nbr_J * s[..., None] * s[..., nbr]
    lower = idv[:, None] < idv[nbr]
    active_sp = lower & (u_sp < bond_prob(de_sp, temp))
    active_full = symmetrize_spatial(active_sp, nbr)
    ghosted = u_h < bond_prob(2.0 * problem.h * s, temp)
    labels = label_components(active_full, nbr,
                              torch.where(ghosted, -1, idv))
    flip = (labels >= 0) & coins.gather(-1, labels.clamp(min=0))
    return torch.where(flip, -s, s)


def spacetime_sw_sweep(problem, confs, u_sp, u_t, u_b, u_h, coins, teff, jp,
                       b, lookuptable=None, ids=None):
    """Full space-time Swendsen-Wang sweep (JAX `spacetime_sw_sweep`,
    :874) of (..., P, N) confs: the FK draw of spatial, Trotter and
    optional bath bonds, ghost bonds for the fields, every component
    labeled by relaxation (its least k * N + id, -1 frozen) and flipped on
    its coin. u_sp (..., P, N, maxnb), u_t and u_h (..., P, N), u_b (...,
    N, P, P) (None without a bath), coins (..., P * N) bool."""
    slices, n = confs.shape[-2:]
    s = confs.to(torch.float32)
    jp, b = _f32(jp, s), _f32(b, s)
    nbr = problem.nbr_idx.long()
    idv = _ids(ids, n, s.device)
    de_sp = 2.0 * b * problem.nbr_J * s[..., None] * s[..., nbr]
    lower = idv[:, None] < idv[nbr]
    active_sp = lower & (u_sp < bond_prob(de_sp, teff))
    active_full = symmetrize_spatial(active_sp, nbr)
    de_t = -2.0 * jp * s * torch.roll(s, -1, dims=-2)
    active_up = u_t < bond_prob(de_t, teff)
    dn_active = torch.roll(active_up, 1, dims=-2)
    active_bath = None
    if lookuptable is not None:
        active_bath = mirror_upper(u_b) < bath_bond_prob(s, teff,
                                                         lookuptable)
    ghosted = u_h < bond_prob(2.0 * b * problem.h * s, teff)
    k = torch.arange(slices, device=s.device)[:, None]
    labels = torch.where(ghosted, -1, k * n + idv)
    big = slices * n
    while True:
        new = torch.minimum(labels, torch.where(
            active_full, labels[..., nbr], big).min(-1).values)
        new = torch.minimum(new, torch.where(
            active_up, torch.roll(labels, -1, dims=-2), big))
        new = torch.minimum(new, torch.where(
            dn_active, torch.roll(labels, 1, dims=-2), big))
        if active_bath is not None:
            lt = labels.transpose(-1, -2)  # (..., N, P)
            new = torch.minimum(new, torch.where(
                active_bath, lt[..., None, :], big).min(-1).values
                .transpose(-1, -2))
        if bool((new == labels).all()):
            break
        labels = new
    flat = labels.reshape(labels.shape[:-2] + (-1,))
    flip = (flat >= 0) & coins.gather(-1, flat.clamp(min=0))
    return torch.where(flip.reshape(confs.shape), -confs, confs)


# ------------------------------------- Houdayer moves, the lattice labelers


def grid_bonds_from_edges(shape, rows, cols, vals, device=None):
    """Per-axis bond masks of a k-D grid instance (JAX
    `grid_bonds_from_edges`, :610), built on the host: for sites raveled
    in C order over `shape` whose every edge joins x and x + e_a (mod L_a)
    along one axis a, mask_a[x] is True iff the bond (x, x + e_a) has a
    nonzero coupling. Diagonal entries (fields) are ignored. Raises
    ValueError on an edge that is not a unit grid step. Returns a tuple of
    k bool tensors on `device` (None: the CUDA device)."""
    shape = tuple(int(x) for x in shape)
    masks = [np.zeros(shape, dtype=bool) for _ in shape]
    for a, b, v in zip(np.asarray(rows), np.asarray(cols), np.asarray(vals)):
        if a == b or v == 0.0:
            continue
        ia = np.unravel_index(int(a), shape)
        ib = np.unravel_index(int(b), shape)
        hit = None
        for ax in range(len(shape)):
            d = (ib[ax] - ia[ax]) % shape[ax]
            if d == 0:
                continue
            rest_equal = all(ia[o] == ib[o] for o in range(len(shape))
                             if o != ax)
            if d == 1 and rest_equal:
                hit = (ax, ia)
            elif d == shape[ax] - 1 and rest_equal:
                hit = (ax, ib)
            else:
                hit = None
                break
        if hit is None:
            raise ValueError(f"edge ({a},{b}) is not a unit grid step")
        masks[hit[0]][hit[1]] = True
    dev = _device.resolve(device)
    return tuple(torch.as_tensor(m, device=dev) for m in masks)


def _label_components_grid(bond_masks, init, rounds_per_check=8):
    """Component labels on a k-D grid bond graph by roll-based min-label
    relaxation (JAX `_label_components_grid`, :656): mask_a[x] marks the
    bond (x, x + e_a mod L_a); init an int label grid (leading batch axes
    allowed, on the masks too: a vmapped JAX call sees its masks without
    them), -1 absorbing. Returns the fixed point, each component's least
    init label."""
    k = len(bond_masks)
    big = math.prod(bond_masks[0].shape[-k:])

    def relax(lab):
        off = lab.ndim - k
        m = lab
        for ax, mask in enumerate(bond_masks):
            axis = off + ax
            fwd = torch.where(mask, torch.roll(lab, -1, axis), big)
            bwd = torch.where(torch.roll(mask, 1, mask.ndim - k + ax),
                              torch.roll(lab, 1, axis), big)
            m = torch.minimum(m, torch.minimum(fwd, bwd))
        return m

    labels = init
    while True:
        new = labels
        for _ in range(rounds_per_check):
            new = relax(new)
        if bool((new == labels).all()):
            return labels
        labels = new


def houdayer_sweep_grid(bond_masks, s1, s2, coins):
    """Houdayer move on a regular grid (JAX `houdayer_sweep_grid`, :704):
    the q = -1 domain of s1, s2 (..., n) (C-order raveled grid) labelled
    by `_label_components_grid` from the flat index (n at q = +1 sites);
    coins (..., n + 1) bool, read at min(label, n). Returns (s1', s2',
    flipped (..., n) bool)."""
    shape = tuple(bond_masks[0].shape)
    n = s1.shape[-1]
    lead = s1.shape[:-1]
    q_neg = ((s1 * s2) < 0).reshape(lead + shape)
    off = len(lead)
    active = tuple(m & q_neg & torch.roll(q_neg, -1, off + ax)
                   for ax, m in enumerate(bond_masks))
    flat = torch.arange(n, device=s1.device).reshape(shape)
    init = torch.where(q_neg, flat, n)
    labels = _label_components_grid(active, init).reshape(lead + (n,))
    flip = q_neg.reshape(lead + (n,)) & coins.gather(
        -1, torch.clamp(labels, max=n))
    return torch.where(flip, -s1, s1), torch.where(flip, -s2, s2), flip


def houdayer_sweep(problem, s1, s2, coins, jump_every=0):
    """Houdayer isoenergetic cluster move between replicas s1, s2 (..., N)
    (JAX `houdayer_sweep`, :730): the q = -1 domain cut into components
    over the problem's nonzero couplings (`label_components` from the
    index), each flipped in both replicas on coins (..., N) bool read at
    its label, its least site id. problem: an IsingProblem (a lattice's
    to_generic()). Returns (s1', s2', flipped (..., N) bool)."""
    nbr = problem.nbr_idx.long()
    q_neg = (s1 * s2) < 0
    active = (problem.nbr_J != 0.0) & q_neg[..., None] & q_neg[..., nbr]
    labels = label_components(active, nbr, jump_every=jump_every)
    flip = q_neg & coins.gather(-1, labels)
    return torch.where(flip, -s1, s1), torch.where(flip, -s2, s2), flip


def houdayer_coins(seed, step, pairs, n, device):
    """(pairs, n) bool coins of the counter hash's HOUDAYER stream at
    `step`: uniform01(sampler_counter(seed, step, HOUDAYER), pair * n +
    site) < 0.5, the coin of the component whose least id is `site`."""
    u = cr.sampler_uniforms(seed, step, cr.HOUDAYER, pairs * n, device)
    return (u < 0.5).reshape(pairs, n)


def houdayer_move_ref(problem, s1, s2, seed, step):
    """Plain form of csrc/houdayer.cu: `houdayer_sweep` of the (pairs, N)
    replicas s1, s2 on `houdayer_coins(seed, step)`. Returns (s1', s2',
    flipped (pairs,) int32, the count of flipped sites a pair)."""
    coins = houdayer_coins(seed, step, s1.shape[0], s1.shape[1], s1.device)
    a, b, flip = houdayer_sweep(problem, s1, s2, coins)
    return a, b, flip.sum(-1, dtype=torch.int32)


def _seg_min_scan(vals, link_prev, axis):
    """Per-site min over its maximal connected circular run along `axis`
    (JAX `_seg_min_scan`, :777): link_prev[..., c] marks the link of site
    c to site c - 1 mod n. The JAX function's segmented associative scans
    over the doubled axis, forward and backward, here as their sequential
    form (a scan of an associative operator has one result)."""
    n = vals.shape[axis]

    def scan(v, g):
        v2 = torch.cat([v, v], dim=axis).movedim(axis, 0)
        g2 = torch.cat([g, g], dim=axis).movedim(axis, 0)
        out = [v2[0]]
        for i in range(1, 2 * n):
            out.append(torch.where(g2[i], torch.minimum(out[-1], v2[i]),
                                   v2[i]))
        return torch.stack(out[n:]).movedim(0, axis)

    fwd = scan(vals, link_prev)
    link_next = torch.roll(link_prev, -1, dims=axis)
    bwd = scan(torch.flip(vals, dims=(axis,)),
               torch.flip(link_next, dims=(axis,)))
    return torch.minimum(fwd, torch.flip(bwd, dims=(axis,)))


def _label_components_lattice(link_left, link_up, init):
    """Component labels on an L x L lattice bond graph by alternating row
    and column segmented min-scans (JAX `_label_components_lattice`,
    :810); the fixed point is each component's least init label."""
    labels = init
    while True:
        new = _seg_min_scan(labels, link_left, axis=-1)
        new = _seg_min_scan(new, link_up, axis=-2)
        if bool((new == labels).all()):
            return labels
        labels = new


def classical_sw_sweep_lattice(problem, s, u_sp, u_h, coins, temp):
    """classical_sw_sweep on a LatticeProblem's coupling planes (JAX
    `classical_sw_sweep_lattice`, :842): s (..., L*L); u_sp (..., 2, L,
    L), the right then down bond uniforms; u_h (..., L, L); coins (...,
    L*L) bool, read at each free component's least flat index."""
    L = problem.L
    lead = s.shape[:-1]
    sp = s.reshape(lead + (L, L)).to(torch.float32)
    de_r = 2.0 * problem.j_right * sp * torch.roll(sp, -1, dims=-1)
    de_d = 2.0 * problem.j_down * sp * torch.roll(sp, -1, dims=-2)
    active_right = u_sp[..., 0, :, :] < bond_prob(de_r, temp)
    active_down = u_sp[..., 1, :, :] < bond_prob(de_d, temp)
    link_left = torch.roll(active_right, 1, dims=-1)
    link_up = torch.roll(active_down, 1, dims=-2)
    ghosted = u_h < bond_prob(2.0 * problem.h_plane * sp, temp)
    flat = torch.arange(L * L, device=s.device).reshape(L, L)
    labels = _label_components_lattice(link_left, link_up,
                                       torch.where(ghosted, -1, flat))
    lab = labels.reshape(lead + (L * L,))
    flip = (lab >= 0) & coins.gather(-1, lab.clamp(min=0))
    return torch.where(flip.reshape(sp.shape), -sp, sp).reshape(s.shape)


# ------------------------------------------- the counter-hash plain anneals


def _hash(seed, step, stream, uid):
    return cr.uniform01(cr.cluster_counter(seed, step, stream), uid)


def _row_uids(chains, slices, ids):
    """(chains, P, N) int32 (chain * P + k) * N + ids[i]."""
    n = ids.shape[0]
    c = torch.arange(chains, dtype=torch.int32, device=ids.device)
    k = torch.arange(slices, dtype=torch.int32, device=ids.device)
    return ((c[:, None] * slices + k[None, :])[:, :, None] * n
            + ids.to(torch.int32))


def _pair_uids(chains, slices, ids):
    """(chains, N, P, P) int32 ((chain * N + ids[i]) * P + a) * P + b."""
    n = ids.shape[0]
    c = torch.arange(chains, dtype=torch.int32, device=ids.device)
    a = torch.arange(slices, dtype=torch.int32, device=ids.device)
    line = c[:, None] * n + ids.to(torch.int32)  # (chains, N)
    return ((line[:, :, None, None] * slices + a[:, None]) * slices
            + a[None, :])


def spatial_uniforms(seed, step, chains, slices, ids, maxnb):
    """(chains, P, N, maxnb) uniforms of stream SP_BOND."""
    m = torch.arange(maxnb, dtype=torch.int32, device=ids.device)
    uid = _row_uids(chains, slices, ids)[..., None] * maxnb + m
    return _hash(seed, step, cr.SP_BOND, uid)


def trotter_uniforms(seed, step, chains, slices, ids):
    return _hash(seed, step, cr.TROTTER_BOND,
                 _row_uids(chains, slices, ids))


def bath_uniforms(seed, step, chains, slices, ids):
    """(chains, N, P, P) uniforms of stream BATH_BOND; entry (a, b), a < b,
    is the pair's draw (`mirror_upper` keeps it)."""
    return _hash(seed, step, cr.BATH_BOND, _pair_uids(chains, slices, ids))


def wolff_draws(seed, step, chains, slices, ids, maxnb, bath):
    """The counter-hash draws of one Wolff step, in `wolff_update`'s
    argument order (seed_slice, seed_spin, u_sp, u_t, u_b, u_acc)."""
    n = ids.shape[0]
    c = torch.arange(chains, dtype=torch.int32, device=ids.device)
    return (cr.index_draw(_hash(seed, step, cr.WOLFF_SEED, 2 * c + 1),
                          slices),
            cr.index_draw(_hash(seed, step, cr.WOLFF_SEED, 2 * c), n),
            spatial_uniforms(seed, step, chains, slices, ids, maxnb),
            trotter_uniforms(seed, step, chains, slices, ids),
            bath_uniforms(seed, step, chains, slices, ids) if bath else None,
            _hash(seed, step, cr.ACCEPT, c))


def wolff_anneal_ref(pg, b_sched, jp, teff, confs, seed, rule="local",
                     lookuptable=None, step0=0, visited=None):
    """Plain form of csrc/fk_wolff.cu on packed confs (chains, P, N): step
    t is `wolff_update` on the packed problem with B_t, J_perp_t and
    T_eff_t (float32 (steps,) tensors), on the draws of step0 + t
    (`wolff_draws`, keyed by the sites' original ids `pg.perm`). With
    `visited`, a (chains,) int64 tensor, adds each chain's cluster sizes
    to it (the kernel counts them likewise)."""
    prob = pg.as_problem()
    chains, P, _ = confs.shape
    c = confs
    for t in range(b_sched.shape[0]):
        d = wolff_draws(seed, step0 + t, chains, P, pg.perm,
                        prob.nbr_idx.shape[1], lookuptable is not None)
        c, comp = _wolff(prob, c, *d, teff[t], jp[t], b_sched[t], rule,
                         lookuptable, pg.perm)
        if visited is not None:
            visited += comp.reshape(chains, -1).sum(-1)
    return c


def sw_draws(seed, step, chains, slices, ids, maxnb, bath):
    """The counter-hash draws of one Swendsen-Wang step: (u_sp, u_t, u_b,
    u_h, coins) in `spacetime_sw_sweep`'s order; coins (chains, P * N) of
    the labels 0..P*N-1."""
    n = ids.shape[0]
    c = torch.arange(chains, dtype=torch.int32, device=ids.device)
    lab = torch.arange(slices * n, dtype=torch.int32, device=ids.device)
    return (spatial_uniforms(seed, step, chains, slices, ids, maxnb),
            trotter_uniforms(seed, step, chains, slices, ids),
            bath_uniforms(seed, step, chains, slices, ids) if bath else None,
            _hash(seed, step, cr.GHOST, _row_uids(chains, slices, ids)),
            _hash(seed, step, cr.COIN, c[:, None] * (slices * n) + lab)
            < 0.5)


def sw_anneal_ref(pg, b_sched, jp, teff, confs, seed, lookuptable=None,
                  step0=0, classical=False):
    """Plain form of csrc/fk_label.cu on packed confs (chains, P, N): step
    t is `spacetime_sw_sweep` on the packed problem (with `classical`, P =
    1, `classical_sw_sweep` at T = teff[t]: what sa.anneal_sw runs) on the
    draws of step0 + t (`sw_draws`)."""
    prob = pg.as_problem()
    chains, P, _ = confs.shape
    c = confs
    for t in range(b_sched.shape[0]):
        u_sp, u_t, u_b, u_h, coins = sw_draws(
            seed, step0 + t, chains, P, pg.perm, prob.nbr_idx.shape[1],
            lookuptable is not None)
        if classical:
            c = classical_sw_sweep(prob, c[:, 0], u_sp[:, 0], u_h[:, 0],
                                   coins, teff[t], pg.perm)[:, None]
        else:
            c = spacetime_sw_sweep(prob, c, u_sp, u_t, u_b, u_h, coins,
                                   teff[t], jp[t], b_sched[t], lookuptable,
                                   pg.perm)
    return c


def line_draws(seed, step, chains, slices, ids, per_slice_seeds):
    """The counter-hash draws of the line phases of one step: (u_bath,
    u_t, u_acc) of `sw_full_phase`, or ((u_bond, u_acc), seeds) of
    `bath_cluster_phase` with the sweep's seed slices."""
    n = ids.shape[0]
    u_pair = bath_uniforms(seed, step, chains, slices, ids)
    if per_slice_seeds:
        return (u_pair, trotter_uniforms(seed, step, chains, slices, ids),
                _hash(seed, step, cr.LINE_ACCEPT,
                      _row_uids(chains, slices, ids)))
    c = torch.arange(chains, dtype=torch.int32, device=ids.device)
    line = c[:, None] * n + ids.to(torch.int32)
    return ((u_pair, _hash(seed, step, cr.LINE_ACCEPT,
                           c[:, None] * (slices * n) + ids.to(torch.int32))),
            cr.index_draw(_hash(seed, step, cr.LINE_SEED, line), slices))


def line_phase_ref(pg, b, jp, teff, lookuptable, confs, seed, step, color,
                   per_slice_seeds, p_pair=None):
    """Plain form of one launch of csrc/fk_line.cu: the line phase of
    color class `color` of step `step` on packed confs (chains, P, N),
    `sw_full_phase` (per_slice_seeds) or `bath_cluster_phase` on the
    packed problem, at float32 0-d B and J_perp and T_eff, on
    `line_draws`."""
    prob = pg.as_problem()
    chains, P, _ = confs.shape
    mask = prob.color_masks[color]
    d = line_draws(seed, step, chains, P, pg.perm, per_slice_seeds)
    if per_slice_seeds:
        return sw_full_phase(prob, confs, *d, mask, teff, jp, b,
                             lookuptable, p_pair)
    return bath_cluster_phase(prob, confs, *d[0], d[1], mask, teff, jp, b,
                              lookuptable, p_pair)
