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


def houdayer_coins(seed, step, pairs, n, device, pair0=0):
    """(pairs, n) bool coins of the counter hash's HOUDAYER stream at
    `step`: uniform01(sampler_counter(seed, step, HOUDAYER), pair * n +
    site) < 0.5, the coin of the component whose least id is `site`, the
    pairs counted from pair0 (a rung block of a sharded ladder)."""
    u = cr.sampler_uniforms(seed, step, cr.HOUDAYER, pairs * n, device,
                            uid0=pair0 * n)
    return (u < 0.5).reshape(pairs, n)


def houdayer_move_ref(problem, s1, s2, seed, step, pair0=0):
    """Plain form of csrc/houdayer.cu: `houdayer_sweep` of the (pairs, N)
    replicas s1, s2 on `houdayer_coins(seed, step, pair0=pair0)`. Returns
    (s1', s2', flipped (pairs,) int32, the count of flipped sites a
    pair)."""
    coins = houdayer_coins(seed, step, s1.shape[0], s1.shape[1], s1.device,
                           pair0)
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


def _row_uids(chains, slices, ids, chain0=0):
    """(chains, P, N) int32 (chain * P + k) * N + ids[i], the chains
    counted from chain0 (a chain shard's first global chain)."""
    n = ids.shape[0]
    c = cr._chains(chains, chain0, ids.device)
    k = torch.arange(slices, dtype=torch.int32, device=ids.device)
    return ((c[:, None] * slices + k[None, :])[:, :, None] * n
            + ids.to(torch.int32))


def _pair_uids(chains, slices, ids, chain0=0):
    """(chains, N, P, P) int32 ((chain * N + ids[i]) * P + a) * P + b, the
    chains counted from chain0."""
    n = ids.shape[0]
    c = cr._chains(chains, chain0, ids.device)
    a = torch.arange(slices, dtype=torch.int32, device=ids.device)
    line = c[:, None] * n + ids.to(torch.int32)  # (chains, N)
    return ((line[:, :, None, None] * slices + a[:, None]) * slices
            + a[None, :])


def spatial_uniforms(seed, step, chains, slices, ids, maxnb, chain0=0):
    """(chains, P, N, maxnb) uniforms of stream SP_BOND."""
    m = torch.arange(maxnb, dtype=torch.int32, device=ids.device)
    uid = _row_uids(chains, slices, ids, chain0)[..., None] * maxnb + m
    return _hash(seed, step, cr.SP_BOND, uid)


def trotter_uniforms(seed, step, chains, slices, ids, chain0=0):
    return _hash(seed, step, cr.TROTTER_BOND,
                 _row_uids(chains, slices, ids, chain0))


def bath_uniforms(seed, step, chains, slices, ids, chain0=0):
    """(chains, N, P, P) uniforms of stream BATH_BOND; entry (a, b), a < b,
    is the pair's draw (`mirror_upper` keeps it)."""
    return _hash(seed, step, cr.BATH_BOND,
                 _pair_uids(chains, slices, ids, chain0))


def wolff_draws(seed, step, chains, slices, ids, maxnb, bath, chain0=0):
    """The counter-hash draws of one Wolff step, in `wolff_update`'s
    argument order (seed_slice, seed_spin, u_sp, u_t, u_b, u_acc), the
    chains counted from chain0."""
    n = ids.shape[0]
    c = cr._chains(chains, chain0, ids.device)
    return (cr.index_draw(_hash(seed, step, cr.WOLFF_SEED, 2 * c + 1),
                          slices),
            cr.index_draw(_hash(seed, step, cr.WOLFF_SEED, 2 * c), n),
            spatial_uniforms(seed, step, chains, slices, ids, maxnb, chain0),
            trotter_uniforms(seed, step, chains, slices, ids, chain0),
            bath_uniforms(seed, step, chains, slices, ids, chain0)
            if bath else None,
            _hash(seed, step, cr.ACCEPT, c))


def wolff_anneal_ref(pg, b_sched, jp, teff, confs, seed, rule="local",
                     lookuptable=None, step0=0, visited=None, chain0=0):
    """Plain form of csrc/fk_wolff.cu on packed confs (chains, P, N): step
    t is `wolff_update` on the packed problem with B_t, J_perp_t and
    T_eff_t (float32 (steps,) tensors), on the draws of step0 + t
    (`wolff_draws`, keyed by the sites' original ids `pg.perm` and the
    chains' global indices from chain0, a chain shard's first). With
    `visited`, a (chains,) int64 tensor, adds each chain's cluster sizes
    to it (the kernel counts them likewise)."""
    prob = pg.as_problem()
    chains, P, _ = confs.shape
    c = confs
    for t in range(b_sched.shape[0]):
        d = wolff_draws(seed, step0 + t, chains, P, pg.perm,
                        prob.nbr_idx.shape[1], lookuptable is not None,
                        chain0)
        c, comp = _wolff(prob, c, *d, teff[t], jp[t], b_sched[t], rule,
                         lookuptable, pg.perm)
        if visited is not None:
            visited += comp.reshape(chains, -1).sum(-1)
    return c


def sw_draws(seed, step, chains, slices, ids, maxnb, bath, chain0=0):
    """The counter-hash draws of one Swendsen-Wang step: (u_sp, u_t, u_b,
    u_h, coins) in `spacetime_sw_sweep`'s order; coins (chains, P * N) of
    the labels 0..P*N-1; the chains counted from chain0."""
    n = ids.shape[0]
    c = cr._chains(chains, chain0, ids.device)
    lab = torch.arange(slices * n, dtype=torch.int32, device=ids.device)
    return (spatial_uniforms(seed, step, chains, slices, ids, maxnb, chain0),
            trotter_uniforms(seed, step, chains, slices, ids, chain0),
            bath_uniforms(seed, step, chains, slices, ids, chain0)
            if bath else None,
            _hash(seed, step, cr.GHOST,
                  _row_uids(chains, slices, ids, chain0)),
            _hash(seed, step, cr.COIN, c[:, None] * (slices * n) + lab)
            < 0.5)


def sw_anneal_ref(pg, b_sched, jp, teff, confs, seed, lookuptable=None,
                  step0=0, classical=False, chain0=0):
    """Plain form of csrc/fk_label.cu on packed confs (chains, P, N): step
    t is `spacetime_sw_sweep` on the packed problem (with `classical`, P =
    1, `classical_sw_sweep` at T = teff[t]: what sa.anneal_sw runs) on the
    draws of step0 + t (`sw_draws`, the chains counted from chain0)."""
    prob = pg.as_problem()
    chains, P, _ = confs.shape
    c = confs
    for t in range(b_sched.shape[0]):
        u_sp, u_t, u_b, u_h, coins = sw_draws(
            seed, step0 + t, chains, P, pg.perm, prob.nbr_idx.shape[1],
            lookuptable is not None, chain0)
        if classical:
            c = classical_sw_sweep(prob, c[:, 0], u_sp[:, 0], u_h[:, 0],
                                   coins, teff[t], pg.perm)[:, None]
        else:
            c = spacetime_sw_sweep(prob, c, u_sp, u_t, u_b, u_h, coins,
                                   teff[t], jp[t], b_sched[t], lookuptable,
                                   pg.perm)
    return c


def line_draws(seed, step, chains, slices, ids, per_slice_seeds, chain0=0):
    """The counter-hash draws of the line phases of one step: (u_bath,
    u_t, u_acc) of `sw_full_phase`, or ((u_bond, u_acc), seeds) of
    `bath_cluster_phase` with the sweep's seed slices; the chains counted
    from chain0."""
    n = ids.shape[0]
    u_pair = bath_uniforms(seed, step, chains, slices, ids, chain0)
    if per_slice_seeds:
        return (u_pair,
                trotter_uniforms(seed, step, chains, slices, ids, chain0),
                _hash(seed, step, cr.LINE_ACCEPT,
                      _row_uids(chains, slices, ids, chain0)))
    c = cr._chains(chains, chain0, ids.device)
    line = c[:, None] * n + ids.to(torch.int32)
    return ((u_pair, _hash(seed, step, cr.LINE_ACCEPT,
                           c[:, None] * (slices * n) + ids.to(torch.int32))),
            cr.index_draw(_hash(seed, step, cr.LINE_SEED, line), slices))


def line_phase_ref(pg, b, jp, teff, lookuptable, confs, seed, step, color,
                   per_slice_seeds, p_pair=None, chain0=0):
    """Plain form of one launch of csrc/fk_line.cu: the line phase of
    color class `color` of step `step` on packed confs (chains, P, N),
    `sw_full_phase` (per_slice_seeds) or `bath_cluster_phase` on the
    packed problem, at float32 0-d B and J_perp and T_eff, on
    `line_draws` (the chains counted from chain0)."""
    prob = pg.as_problem()
    chains, P, _ = confs.shape
    mask = prob.color_masks[color]
    d = line_draws(seed, step, chains, P, pg.perm, per_slice_seeds, chain0)
    if per_slice_seeds:
        return sw_full_phase(prob, confs, *d, mask, teff, jp, b,
                             lookuptable, p_pair)
    return bath_cluster_phase(prob, confs, *d[0], d[1], mask, teff, jp, b,
                              lookuptable, p_pair)


# ------------------------------ the Trotter-sharded rounds (S6, S7), plain
#
# A rank of parallel/trotter.py's sharded cluster engines owns the rows k0
# .. k0 + Ps - 1 of one unbatched (P, N) chain, P = R * Ps. The functions
# below are the plain versions of the shard kernels of csrc/fk_shard.cu
# (`cluster_kernels.shard_wolff_*`, `shard_label_*`): each takes the
# rank's rows, the rows the ring exchange brought (`halo_up`: row k0 - 1,
# `halo_dn`: row k0 + Ps, the rows themselves on a ring of one rank) and,
# with a bath, every rank's rows gathered (`full`). Every draw is the
# single-device kernels' counter hash at the global (slice, site), chain
# 0, or, in the tests, the JAX engines' own draws sliced to the rank's rows
# (`draws`), so the sharded result is the single-device one bitwise.


def pack_bits(mask):
    """(..., M) bool -> (..., ceil(M / 32)) int32 words, element x at bit
    x % 32 of word x // 32: the kernels' bit arrays."""
    m = mask.shape[-1]
    words = -(-m // 32)
    pad = torch.zeros(mask.shape[:-1] + (words * 32 - m,), dtype=torch.bool,
                      device=mask.device)
    x = torch.cat([mask, pad], dim=-1).reshape(mask.shape[:-1]
                                               + (words, 32)).long()
    w = (x << torch.arange(32, device=mask.device)).sum(-1)
    return ((w + 2**31) % 2**32 - 2**31).to(torch.int32)


def unpack_bits(words, m):
    """The (..., m) bool mask of `pack_bits`' words."""
    bits = (words.long()[..., None] >> torch.arange(
        32, device=words.device)) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :m].bool()


def _row_draw(seed, step, stream, k0, rows, ids, slices=None):
    """Uniforms of stream `stream` at chain 0's uids k * N + ids[i] of the
    global rows k = k0 .. k0 + rows - 1 (mod `slices` when given)."""
    k = torch.arange(k0, k0 + rows, dtype=torch.int64, device=ids.device)
    if slices is not None:
        k = k % slices
    uid = k[:, None] * ids.shape[0] + ids.long()
    return _hash(seed, step, stream, uid.to(torch.int32))


def _shard_bath_uniforms(seed, step, k0, rows, slices, ids):
    """(N, rows, P) pair uniforms of chain 0's lines, rows a = k0 .. of the
    pairs (a, b), each the draw of its (min, max) pair
    (`bath_uniforms` then `mirror_upper`, on the rank's rows)."""
    a = torch.arange(k0, k0 + rows, dtype=torch.int64, device=ids.device)
    b = torch.arange(slices, dtype=torch.int64, device=ids.device)
    lo = torch.minimum(a[:, None], b[None, :])
    hi = torch.maximum(a[:, None], b[None, :])
    uid = (ids.long()[:, None, None] * slices + lo) * slices + hi
    return _hash(seed, step, cr.BATH_BOND, uid.to(torch.int32))


def _shard_bath_prob(s_rows, full, k0, teff, lookuptable):
    """(N, Ps, P) FK probabilities of the bath pairs (a, b), a a rank row,
    b any slice: `bath_bond_prob`'s rows a."""
    slices = full.shape[-2]
    ps = s_rows.shape[-2]
    lut = _f32(lookuptable, full)
    a = torch.arange(k0, k0 + ps, device=full.device)
    r = torch.arange(slices, device=full.device)
    off = (r[None, :] - a[:, None]) % slices  # (Ps, P): (b - a) mod P
    de_b = (-2.0 * _f32(teff, full) * lut[(off - 1).clamp(min=0)]
            * s_rows.transpose(-1, -2)[:, :, None]
            * full.transpose(-1, -2)[:, None, :])
    return torch.where(off > 0, bond_prob(de_b, teff),
                       torch.zeros_like(de_b))


def wolff_shard_bonds(problem, s, halo_up, halo_dn, full, kval, k0, slices,
                      b, jp, teff, rule, lookuptable, seed, step, ids=None,
                      draws=None):
    """The bonds of a rank's rows in one Wolff step of the sharded engine
    (`_wolff`'s, rows k0 .. k0 + Ps - 1): (active_full (Ps, N, maxnb) the
    symmetrized spatial bonds, active_up (Ps, N) the Trotter bond of row r
    and row r - 1 (global k0 + r - 1 mod P, the halo row at r = 0: drawn by
    the rank that owns its upper slice), active_bath (N, Ps, P): row a
    reaches b's line partner, or None). s (Ps, N), halo_up and halo_dn (N,)
    float32 +/-1; full (P, N), every rank's rows (with a bath); kval: the
    seed spin (rule "full"), a float32 tensor. draws: (u_sp (Ps, N, maxnb),
    u_t (Ps, N) the uniforms of bond rows k0 - 1 .., u_b (N, Ps, P)
    mirrored, or None), else the counter hash at step `step`."""
    ps, n = s.shape
    nbr = problem.nbr_idx.long()
    idv = _ids(ids, n, s.device)
    b, jp = _f32(b, s), _f32(jp, s)
    ext = torch.cat([halo_up[None], s, halo_dn[None]])  # rows k0-1 .. k0+Ps
    if draws is None:
        m = torch.arange(nbr.shape[1], dtype=torch.int32, device=s.device)
        rows = torch.arange(k0, k0 + ps, dtype=torch.int32, device=s.device)
        uid = (rows[:, None] * n + idv.to(torch.int32))[..., None] \
            * nbr.shape[1] + m
        u_sp = _hash(seed, step, cr.SP_BOND, uid)
        u_t = _row_draw(seed, step, cr.TROTTER_BOND, k0 - 1, ps, idv, slices)
        u_b = (_shard_bath_uniforms(seed, step, k0, ps, slices, idv)
               if lookuptable is not None else None)
    else:
        u_sp, u_t, u_b = draws
    if rule == "local":
        de_sp = 2.0 * b * problem.nbr_J * s[..., None] * s[:, nbr]
        de_t = -2.0 * jp * ext[:-2] * ext[1:-1]
        gate_sp = idv[:, None] < idv[nbr]
        gate_t = torch.ones_like(s, dtype=torch.bool)
        same_ext = None
    else:
        same_ext = ext == kval
        de_site = (-2.0 * b * kval * problem.local_fields(s)
                   + 2.0 * jp * kval * (ext[:-2] + ext[2:]))
        de_sp = de_site[:, nbr]
        de_t = de_site
        pad = nbr == torch.arange(n, device=s.device)[:, None]
        same = same_ext[1:-1]
        gate_sp = same[..., None] & same[:, nbr] & ~pad
        gate_t = same_ext[:-2] & same
    active_full = symmetrize_spatial(gate_sp & (u_sp < bond_prob(de_sp, teff)),
                                     nbr)
    active_up = gate_t & (u_t < bond_prob(de_t, teff))
    active_bath = None
    if lookuptable is not None:
        active_bath = u_b < _shard_bath_prob(s, full, k0, teff, lookuptable)
        if rule != "local":
            sf = (full == kval).transpose(-1, -2)  # (N, P)
            active_bath = (active_bath & same_ext[1:-1].transpose(
                -1, -2)[:, :, None] & sf[:, None, :])
    return active_full, active_up, active_bath


def wolff_shard_round_ref(problem, bonds, visited, in_prev, in_next,
                          full_fresh, k0, slices, seed_x=-1):
    """Plain form of a round of S6: the rank's part of the Wolff cluster
    grown to its block's fixed point from this round's frontier.

    bonds: `wolff_shard_bonds`; visited (Ps, N) bool, the cluster so far;
    in_prev (N,) bool, the previous rank's last-row sites visited in its
    last round, which reach row 0 through active_up[0]; in_next (N,) bool,
    the sites of the last row the next rank's first row reached; full_fresh
    (P, N) bool, every rank's sites visited in its last round, which reach
    the rank's rows through the bath (None: none); seed_x: the seed's flat
    index in the block, or -1. On a ring of one rank (Ps = P) the block is
    the whole ring and the messages are not read.

    Returns (visited, fresh: the sites visited in this round, out_up (N,)
    the sites of row k0 - 1 that row 0 reached (for the previous rank),
    out_dn (N,) the last row's fresh sites (for the next rank, which draws
    their bond), changed: whether any of them, or with a bath any fresh
    site, is news for another rank). A message never goes back to the rank
    it came from."""
    active_full, active_up, active_bath = bonds
    ps, n = visited.shape
    ring = ps == slices
    nbr = problem.nbr_idx.long()
    frontier = torch.zeros_like(visited)
    if seed_x >= 0:
        frontier.view(-1)[seed_x] = True
    if not ring:
        frontier[-1] |= in_next
        frontier[0] |= in_prev & active_up[0]
        if active_bath is not None and full_fresh is not None:
            remote = torch.ones(slices, dtype=torch.bool,
                                device=visited.device)
            remote[k0:k0 + ps] = False
            src = (full_fresh & remote[:, None]).transpose(-1, -2)  # (N, P)
            frontier |= (active_bath & src[:, None, :]).any(-1).transpose(
                -1, -2)
    frontier &= ~visited
    visited = visited | frontier
    fresh = frontier.clone()
    own = slice(k0, k0 + ps)
    while bool(frontier.any()):
        reach = (frontier[:, nbr] & active_full).any(-1)
        if ring:
            reach |= active_up & torch.roll(frontier, 1, dims=0)
            reach |= torch.roll(active_up & frontier, -1, dims=0)
        else:
            reach[1:] |= active_up[1:] & frontier[:-1]
            reach[:-1] |= active_up[1:] & frontier[1:]
        if active_bath is not None:
            reach |= (active_bath[:, :, own] & frontier.transpose(
                -1, -2)[:, None, :]).any(-1).transpose(-1, -2)
        frontier = reach & ~visited
        visited = visited | frontier
        fresh |= frontier
    if ring:
        out_up = out_dn = torch.zeros(n, dtype=torch.bool,
                                      device=visited.device)
    else:
        out_up = fresh[0] & active_up[0] & ~in_prev
        out_dn = fresh[-1] & ~in_next
    changed = bool(out_up.any() or out_dn.any() or (
        active_bath is not None and not ring and fresh.any()))
    return visited, fresh, out_up, out_dn, changed


def wolff_shard_sums_ref(problem, s, visited):
    """Plain form of S6's field sums: (Ps,) sum of h_i s_i over each row's
    cluster sites in index order (`field_sum`'s inner sum); the ranks'
    rows, gathered in slice order, are added in order by the flip."""
    x = torch.where(visited, problem.h * s, torch.zeros_like(s))
    return sum_in_order(x, dim=-1)


def wolff_shard_flip_ref(s, visited, rows_full, b, teff, seed, step, rule,
                         u_acc=None):
    """Plain form of S6's flip: the cluster's sites of the rank's rows
    flipped, under rule "local" on a Metropolis accept of -2B times the
    field term, `rows_full` (P,) (every rank's `wolff_shard_sums_ref`, in
    slice order) added in order, or 0 when the problem has no fields
    (rows_full None); u_acc: the accept's uniform, else the hash's at
    chain 0."""
    if rule == "local" and rows_full is not None:
        de = -2.0 * _f32(b, s) * sum_in_order(rows_full, dim=-1)
        if u_acc is None:
            u_acc = _hash(seed, step, cr.ACCEPT,
                          torch.zeros((), dtype=torch.int32,
                                      device=s.device))
        if not bool(metropolis_accept(de, _f32(teff, s), u_acc)):
            return s
    return torch.where(visited, -s, s)


def sw_shard_bonds(problem, s, halo_dn, full, k0, slices, b, jp, teff,
                   lookuptable, seed, step, ids=None, draws=None):
    """The bonds and first labels of a rank's rows in one Swendsen-Wang
    step of the sharded engine (`spacetime_sw_sweep`'s, rows k0 .. k0 + Ps
    - 1): (active_full (Ps, N, maxnb) the symmetrized spatial bonds, act_dn
    (Ps, N) the Trotter bond of row r and row r + 1 (the halo row at the
    last row: drawn by the rank that owns its lower slice), active_bath (N,
    Ps, P) or None, labels0 (Ps, N) int64: (k0 + r) * N + id, -1 where the
    ghost bond of the field holds). active_bath is directed, as
    fk_label.cu reads a bath pair: active_bath[i, a, b] when row k0 + a
    takes slice b's label, u < p at ring offset b - (k0 + a); on a table
    symmetric in ring distance both directions of a pair agree, on any
    other a pair may hold one way only. draws: (u_sp, u_t (Ps, N) of bond
    rows k0 .., u_b (N, Ps, P) mirrored or None, u_h), else the counter
    hash."""
    ps, n = s.shape
    nbr = problem.nbr_idx.long()
    idv = _ids(ids, n, s.device)
    b, jp = _f32(b, s), _f32(jp, s)
    if draws is None:
        m = torch.arange(nbr.shape[1], dtype=torch.int32, device=s.device)
        rows = torch.arange(k0, k0 + ps, dtype=torch.int32, device=s.device)
        uid = (rows[:, None] * n + idv.to(torch.int32))[..., None] \
            * nbr.shape[1] + m
        u_sp = _hash(seed, step, cr.SP_BOND, uid)
        u_t = _row_draw(seed, step, cr.TROTTER_BOND, k0, ps, idv)
        u_b = (_shard_bath_uniforms(seed, step, k0, ps, slices, idv)
               if lookuptable is not None else None)
        u_h = _row_draw(seed, step, cr.GHOST, k0, ps, idv)
    else:
        u_sp, u_t, u_b, u_h = draws
    de_sp = 2.0 * b * problem.nbr_J * s[..., None] * s[:, nbr]
    lower = idv[:, None] < idv[nbr]
    active_full = symmetrize_spatial(lower & (u_sp < bond_prob(de_sp, teff)),
                                     nbr)
    below = torch.cat([s[1:], halo_dn[None]])
    act_dn = u_t < bond_prob(-2.0 * jp * s * below, teff)
    active_bath = None
    if lookuptable is not None:
        active_bath = u_b < _shard_bath_prob(s, full, k0, teff, lookuptable)
    ghosted = u_h < bond_prob(2.0 * b * problem.h * s, teff)
    k = torch.arange(k0, k0 + ps, device=s.device)[:, None]
    labels0 = torch.where(ghosted, -1, k * n + idv)
    return active_full, act_dn, active_bath, labels0


def _relax(problem, bonds, labels, ext, k0, slices):
    """Min-label relaxation of the block to its fixed point, each site also
    taking the external labels `ext` (Ps, N) (`spacetime_sw_sweep`'s
    relaxation on the rank's rows: spatial, the Trotter bonds inside the
    block, around the ring on a ring of one rank, and the bath pulls of
    two rows of the block along their direction). Each site ends with the
    least label it reaches against the edges' direction, -1 absorbing:
    fk_label.cu's labels, whose union-find takes the two-way pairs and
    whose rounds relax the one-way ones; with a symmetric table every pull
    is two-way."""
    active_full, act_dn, active_bath, _ = bonds
    ps = labels.shape[0]
    nbr = problem.nbr_idx.long()
    big = slices * labels.shape[1]
    ring = ps == slices
    while True:
        new = torch.minimum(labels, ext)
        new = torch.minimum(new, torch.where(
            active_full, labels[:, nbr], big).min(-1).values)
        if ring:
            new = torch.minimum(new, torch.where(
                act_dn, torch.roll(labels, -1, dims=0), big))
            new = torch.minimum(new, torch.where(
                torch.roll(act_dn, 1, dims=0), torch.roll(labels, 1, dims=0),
                big))
        else:
            new[:-1] = torch.minimum(new[:-1], torch.where(
                act_dn[:-1], labels[1:], big))
            new[1:] = torch.minimum(new[1:], torch.where(
                act_dn[:-1], labels[:-1], big))
        if active_bath is not None:
            lt = labels.transpose(-1, -2)  # (N, Ps)
            own = active_bath[:, :, k0:k0 + ps]
            new = torch.minimum(new, torch.where(
                own, lt[:, None, :], big).min(-1).values.transpose(-1, -2))
        if bool((new == labels).all()):
            return labels
        labels = new


def sw_shard_init_ref(problem, bonds, k0, slices):
    """Plain form of S7's first launch of a step: the labels of the
    block's own components, each its least `labels0` (-1 absorbing), with
    no label from another rank."""
    labels0 = bonds[3]
    big = torch.full_like(labels0, slices * labels0.shape[1])
    return _relax(problem, bonds, labels0, big, k0, slices)


def sw_shard_round_ref(problem, bonds, labels, halo_prev, bond_up,
                       halo_next, full_labels, k0, slices):
    """Plain form of a round of S7: the block's labels relaxed to their
    fixed point with the other ranks' labels as they stood after their
    last round: halo_prev (N,), the previous rank's last row, across the
    bonds `bond_up` (N,) bool (that rank's act_dn of its last row);
    halo_next (N,), the next rank's first row, across the last row's
    act_dn; full_labels (P, N), every rank's labels, across the bath pairs
    with another rank's rows (None without a bath). Returns (labels,
    changed)."""
    _, act_dn, active_bath, _ = bonds
    ps = labels.shape[0]
    big = slices * labels.shape[1]
    ext = torch.full_like(labels, big)
    if ps != slices:
        ext[0] = torch.where(bond_up, halo_prev.long(), big)
        ext[-1] = torch.minimum(ext[-1], torch.where(
            act_dn[-1], halo_next.long(), big))
        if active_bath is not None:
            remote = torch.ones(slices, dtype=torch.bool,
                                device=labels.device)
            remote[k0:k0 + ps] = False
            lf = full_labels.long().transpose(-1, -2)  # (N, P)
            pulled = torch.where(active_bath & remote, lf[:, None, :],
                                 big).min(-1).values.transpose(-1, -2)
            ext = torch.minimum(ext, pulled)
    new = _relax(problem, bonds, labels, ext, k0, slices)
    return new, bool((new != labels).any())


def sw_shard_flip_ref(s, labels, seed, step, coins=None):
    """Plain form of S7's flip: every site of a free component (label >=
    0) flips on the coin of its label, the hash's at chain 0 (uid = the
    label), or `coins` (P * N,) bool."""
    lab = labels.clamp(min=0)
    if coins is None:
        heads = _hash(seed, step, cr.COIN, lab.to(torch.int32)) < 0.5
    else:
        heads = coins[lab]
    return torch.where((labels >= 0) & heads, -s, s)


def wolff_seed_draw(seed, step, slices, n, device):
    """(seed slice, seed position) of chain 0's Wolff cluster at `step`
    (`wolff_draws`' first two), as Python ints."""
    u = _hash(seed, step, cr.WOLFF_SEED,
              torch.arange(2, dtype=torch.int32, device=device))
    return (int(cr.index_draw(u[1:], slices)[0]),
            int(cr.index_draw(u[:1], n)[0]))


def wolff_sharded_steps_ref(problem, s, b_sched, jp, teff, seed, ranks,
                            rule="local", lookuptable=None, ids=None,
                            draws=None, rounds=None):
    """The sharded Wolff engine's ranks run in lockstep in one process (the
    plain version the gloo runs are held to): one (P, N) chain `s` on
    `problem` (sites in `ids` order), B_t, J_perp_t (float32 (steps,)
    tensors), T_eff a Python float, `ranks` ranks of P / ranks rows. Each
    step: the seed, the rounds of every rank (`wolff_shard_round_ref`)
    with the ring's messages and, with a bath, the gathered fresh sites,
    until no rank sends news; then the field sums and the flip. draws:
    None (the counter hash) or draws(t) -> (seed_slice, seed_spin, u_sp,
    u_t, u_b, u_acc), JAX's full-state draws (u_b unmirrored), sliced
    here to each rank's rows. rounds: a list that gains each step's number
    of rounds. Returns the new (P, N) chain."""
    slices, n = s.shape
    ps = slices // ranks
    has_field = bool((problem.h != 0).any())
    for t in range(b_sched.shape[0]):
        if draws is None:
            seed_slice, seed_spin = wolff_seed_draw(seed, t, slices, n,
                                                    s.device)
            rank_draws = [None] * ranks
            u_acc = None
        else:
            seed_slice, seed_spin, u_sp, u_t, u_b, u_acc = draws(t)
            seed_slice, seed_spin = int(seed_slice), int(seed_spin)
            u_bm = mirror_upper(u_b) if u_b is not None else None
            rank_draws = [(u_sp[r * ps:(r + 1) * ps],
                           u_t[torch.arange(r * ps - 1, (r + 1) * ps - 1)
                               % slices],
                           None if u_bm is None
                           else u_bm[:, r * ps:(r + 1) * ps])
                          for r in range(ranks)]
        kval = s[seed_slice, seed_spin]
        bonds = [wolff_shard_bonds(
            problem, s[r * ps:(r + 1) * ps], s[(r * ps - 1) % slices],
            s[((r + 1) * ps) % slices], s, kval, r * ps, slices, b_sched[t],
            jp[t], teff, rule, lookuptable, seed, t, ids, rank_draws[r])
            for r in range(ranks)]
        visited = [torch.zeros((ps, n), dtype=torch.bool, device=s.device)
                   for _ in range(ranks)]
        none = torch.zeros(n, dtype=torch.bool, device=s.device)
        in_prev, in_next = [none] * ranks, [none] * ranks
        full_fresh = None
        owner = seed_slice // ps
        count = 0
        while True:
            outs = [wolff_shard_round_ref(
                problem, bonds[r], visited[r], in_prev[r], in_next[r],
                full_fresh, r * ps, slices,
                (seed_slice - r * ps) * n + seed_spin
                if r == owner and count == 0 else -1)
                for r in range(ranks)]
            count += 1
            visited = [o[0] for o in outs]
            if not any(o[4] for o in outs):
                break
            in_prev = [outs[(r - 1) % ranks][3] for r in range(ranks)]
            in_next = [outs[(r + 1) % ranks][2] for r in range(ranks)]
            if lookuptable is not None:
                full_fresh = torch.cat([o[1] for o in outs])
        if rounds is not None:
            rounds.append(count)
        comp = torch.cat(visited)
        rows = (wolff_shard_sums_ref(problem, s, comp)
                if rule == "local" and has_field else None)
        s = wolff_shard_flip_ref(s, comp, rows, b_sched[t], teff, seed, t,
                                 rule, u_acc)
    return s


def sw_sharded_steps_ref(problem, s, b_sched, jp, teff, seed, ranks,
                         lookuptable=None, ids=None, draws=None,
                         rounds=None):
    """The sharded Swendsen-Wang engine's ranks run in lockstep in one
    process (the plain version the gloo runs are held to), arguments as
    for `wolff_sharded_steps_ref`: each step every rank's bonds and own
    labels (`sw_shard_bonds`, `sw_shard_init_ref`), then, with more than
    one rank, rounds (`sw_shard_round_ref`) on the labels of the last
    until none changes, then the flip. draws: None or draws(t) -> (u_sp,
    u_t, u_b, u_h, coins), JAX's full-state draws (u_b unmirrored)."""
    slices, n = s.shape
    ps = slices // ranks
    for t in range(b_sched.shape[0]):
        coins = None
        rank_draws = [None] * ranks
        if draws is not None:
            u_sp, u_t, u_b, u_h, coins = draws(t)
            u_bm = mirror_upper(u_b) if u_b is not None else None
            rank_draws = [(u_sp[r * ps:(r + 1) * ps],
                           u_t[r * ps:(r + 1) * ps],
                           None if u_bm is None
                           else u_bm[:, r * ps:(r + 1) * ps],
                           u_h[r * ps:(r + 1) * ps]) for r in range(ranks)]
        bonds = [sw_shard_bonds(
            problem, s[r * ps:(r + 1) * ps], s[((r + 1) * ps) % slices], s,
            r * ps, slices, b_sched[t], jp[t], teff, lookuptable, seed, t,
            ids, rank_draws[r]) for r in range(ranks)]
        labels = [sw_shard_init_ref(problem, bonds[r], r * ps, slices)
                  for r in range(ranks)]
        count = 0
        while ranks > 1:
            full = torch.cat(labels) if lookuptable is not None else None
            outs = [sw_shard_round_ref(
                problem, bonds[r], labels[r], labels[(r - 1) % ranks][-1],
                bonds[(r - 1) % ranks][1][-1], labels[(r + 1) % ranks][0],
                full, r * ps, slices) for r in range(ranks)]
            count += 1
            labels = [o[0] for o in outs]
            if not any(o[1] for o in outs):
                break
        if rounds is not None:
            rounds.append(count)
        s = sw_shard_flip_ref(s, torch.cat(labels), seed, t, coins)
    return s
