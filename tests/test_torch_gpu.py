"""Kernels A, B, 3, 4, 5, 6 and 7 and the later kernels against their
plain PyTorch versions on a CUDA device.

Marked `gpu`: each test skips when torch sees no CUDA device. The repo's
tests/conftest.py imports JAX, which the GPU machine need not have, so run
this file there with

    python -m pytest tests/test_torch_gpu.py -q --noconftest -p no:cacheprovider

Small shapes that the main path does not reach: Nh = 50 (L = 10, tails of
the 256-thread blocks), Q = 1 (P = 2, both Trotter terms one element), open
and periodic lattices, B != 1; for kernel B also 33 chains, P = 40 and 64
(one bit word a quarter), 66 and 130 (two and three), L = 4, 80 and 176
over clusters of up to 16 CTAs, more than 65535 chains, and L = 676, which
no cluster holds and the per-phase kernels run; for the full-plane kernels
odd and even L, P = 1 to 7 (m = 2, 3 and 4 local phases), and the
odd-torus wrap pairs that share a color, kernel 6 at 1, 6, 32, 33 (a
ragged chain word) and 1280 chains on L = 5 to 243, kernel 3 also at
P = 40, 64 and 70 (one, two and three words a site), 33 chains, L = 81 and
243 over clusters of up to 16 CTAs, and L = 677, which no cluster holds
and the per-phase kernels run; for the SVMC kernels 4 (even L, L = 4 to
256 at 1, 5, 33 and 256 chains over clusters of up to 16 CTAs, and L =
554, which no cluster holds and the per-phase kernels run) and 7 (any L,
L = 5 to 243 at 1, 6 and 256 chains), open and periodic, TF proposals on
and off, held to max |d theta| <= 2e-5 with no angle off by more than
1e-3 (no diverged decision); the per-phase kernels of A, 5, 6 and 7 at
the first shapes no cluster holds (A: L = 962; 5: L = 402 at P = 128 and
L = 674 at P = 40; 6: L = 676 and the odd torus 677; 7: L = 481); for the
bath kernel 5 L = 4 to 80, open and periodic, P = 2, 3, 5, 40 and 64 (one
and two bit words per line; P above 64 takes the runtime-P kernel), B !=
1, global moves on and off, and L = 176 and 256, which need a cluster of
CTAs per chain. Kernel A runs 1, 5, 32, 33 (a ragged group) and 1280
chains, which take chain words of C = 1 to 32 bits over clusters of up to
16 CTAs, and L = 256. With no device given, the port's problems,
schedules and states land on the card. The generator instantiations
(hw_rng=True) of A, B, 4 and 5, on both routes, sample the exact weights
of tests/gibbs_check.py's bonded pair, reproduce a seed and keep their chains' and
slices' streams apart; the bench's arms launch their kernels. The generic
kernels on an IsingProblem (packed SA, generic PIQMC, packed SVMC) equal
their plain versions on small graphs of 2 to 9 colors, collect energies in
their one launch, run solve() with one launch a kernel and sample exact
weights; engine="masked" runs the packed kernel. The bath kernels: the
generic bath kernel (sequential and colored, on IsingProblem graphs and on
lattices' checkerboard packings, the odd torus's improper one included)
and kernel 5's colored template (L = 10 to 674, P = 2 to 66, both routes,
the per-phase kernels also forced at small shapes) equal their plain
versions with and without energies; the generic bath kernel samples the
exact bath-extended weights, and qmc.anneal(lookuptable=...) launches the
route of the JAX solver's table. The dense kernel (csrc/dense_sa.cu)
equals its plain version on SK problems of N = 64 to 2048 (block 7 to
128, ragged CTAs, shuffled, bf16) with sweeps x ceil(N / B) launches, and
solve("sa") on a DenseProblem launches it; the packed SA and SVMC kernels
on per-step tables (the noisy anneals) equal their plain versions, one
launch an anneal, and equal the static anneals on equal rows. The
cluster kernels (fk_wolff, fk_label, fk_line) equal their plain versions
on small graphs (the duplicate-slot table, P = 1 to 64, rules "local" and
"full", with and without a bath, union-find labels in shared and in device
memory, P = 2's doubled ring bond), the local kernels' one-step launches
at step0 = t equal a whole anneal, each cluster solver launches exactly
its route, and the engines sample exact weights on the card. The
samplers' kernels: the per-chain instantiations of A and B (both routes),
of the packed SA, generic PIQMC and dense kernels equal their plain
versions on a row table and a table that changes every step (1000 chains
for A's ragged last word, the 9 x 9 torus's improper checkerboard for the
packed kernels), A and B split a run at step0, the Houdayer kernel equals
its plain version, and pt.sample, sample_icm and pa.sample equal their
plain route bitwise with their routes' launches. The compat shims on the
card equal their plain route bitwise, with their routes' launches, and a
CheckpointedAnneal resumed on the card equals the unbroken run bitwise.
"""

import contextlib

import numpy as np
import pytest
import torch

import gibbs_check as gibbs
from montecarlosolvers_tpu_torch import convert, schedules
from montecarlosolvers_tpu_torch.models import instances
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import dense_kernels as dk
from montecarlosolvers_tpu_torch.ops import energy as energy_ops
from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
from montecarlosolvers_tpu_torch.ops import packed as packed_ops
from montecarlosolvers_tpu_torch.ops import plane as plane_ops
from montecarlosolvers_tpu_torch.ops import plane_kernels as pk
from montecarlosolvers_tpu_torch.ops import split as split_ops
from montecarlosolvers_tpu_torch.ops import piqmc as piqmc_ops
from montecarlosolvers_tpu_torch.ops import split_kernels as sk
from montecarlosolvers_tpu_torch.solvers import qmc, sa, svmc
from montecarlosolvers_tpu_torch.solvers.api import solve

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _lattice(L, periodic, dev):
    if periodic:
        return instances.gaussian_torus(L, seed=L, device=dev)
    return instances.random_2d_lattice(L, rng=L, lattice=True, device=dev)[0]


@pytest.mark.parametrize("L,periodic", [(10, True), (16, False), (32, True)])
def test_kernel_a_equals_plain(cuda, L, periodic):
    lat = _lattice(L, periodic, cuda)
    sl = split_ops.build_split(lat)
    rng = np.random.default_rng(0)
    s = torch.as_tensor(rng.choice([-1.0, 1.0], size=(5, L * L))
                        .astype(np.float32), device=cuda)
    a, b = (x.contiguous() for x in split_ops.pack_classical(sl, s))
    sched = schedules.linear(3.0, 0.0, 64, device=cuda)
    out = sk.sa_split_anneal(sl, sched, a, b, 3)
    ref = sk.sa_split_anneal_ref(sl, sched, a, b, 3)
    for x, y in zip(out, ref):
        assert torch.equal(x, y)


# (L, P, periodic, global moves, B, chains); L = 676 is held by no
# cluster of 16 CTAs and runs on the per-phase kernels
@pytest.mark.parametrize(
    "L,P,periodic,gm,bscale,chains",
    [(10, 2, True, True, 1.0, 3), (16, 4, False, True, 0.7, 3),
     (16, 6, True, False, 0.7, 3), (32, 8, True, True, 1.0, 3),
     (4, 2, False, True, 1.0, 33), (80, 40, True, True, 0.7, 33),
     (80, 64, True, False, 1.0, 4), (16, 66, True, True, 0.7, 3),
     (16, 130, False, True, 1.0, 2), (176, 40, True, True, 1.0, 4),
     (676, 2, True, True, 0.7, 1)],
)
def test_kernel_b_equals_plain(cuda, L, P, periodic, gm, bscale, chains):
    lat = _lattice(L, periodic, cuda)
    sl = split_ops.build_split(lat)
    rng = np.random.default_rng(1)
    c = torch.as_tensor(rng.choice([-1.0, 1.0], size=(chains, P, L * L))
                        .astype(np.float32), device=cuda)
    qs = split_ops.pack_qmc(sl, c)
    gamma = schedules.transverse_field(2.5, 1e-8, 30, device=cuda)
    teff = (1.0 / P) * P
    jp = schedules.jperp(gamma, teff).contiguous()
    bs = torch.full_like(gamma, bscale)
    _build.reset_launches()
    out = sk.qmc_split_anneal(sl, bs, jp, teff, qs, 5, gm)
    phased = sk.qmc_geometry(chains, L, P) is None
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == (
        {"qmc_split_phased": (4 if gm else 2) * 30} if phased
        else {"qmc_split": 1})
    ref = sk.qmc_split_anneal_ref(sl, bs, jp, teff, qs, 5, gm)
    for x, y, x0 in zip(out, ref, qs):
        assert torch.equal(x, y)
        assert not torch.equal(x, x0)


def test_kernel_b_takes_more_than_65535_chains(cuda):
    sl = split_ops.build_split(_lattice(4, True, cuda))
    rng = np.random.default_rng(7)
    c = torch.as_tensor(rng.choice([-1.0, 1.0], size=(65537, 2, 16))
                        .astype(np.float32), device=cuda)
    qs = split_ops.pack_qmc(sl, c)
    gamma = schedules.transverse_field(2.5, 1e-8, 4, device=cuda)
    jp = schedules.jperp(gamma, 1.0).contiguous()
    bs = torch.ones_like(gamma)
    out = sk.qmc_split_anneal(sl, bs, jp, 1.0, qs, 5, True)
    ref = sk.qmc_split_anneal_ref(sl, bs, jp, 1.0, qs, 5, True)
    for x, y in zip(out, ref):
        assert torch.equal(x, y)


@pytest.mark.parametrize("chains,L", [(1, 80), (32, 80), (33, 80),
                                      (1280, 80), (5, 256)])
def test_kernel_a_cluster_shapes_equal_plain(cuda, chains, L):
    lat = _lattice(L, True, cuda)
    sl = split_ops.build_split(lat)
    rng = np.random.default_rng(chains)
    s = torch.as_tensor(rng.choice([-1.0, 1.0], size=(chains, L * L))
                        .astype(np.float32), device=cuda)
    a, b = (x.contiguous() for x in split_ops.pack_classical(sl, s))
    sched = schedules.linear(3.0, 0.0, 24, device=cuda)
    out = sk.sa_split_anneal(sl, sched, a, b, 9)
    ref = sk.sa_split_anneal_ref(sl, sched, a, b, 9)
    for x, y, x0 in zip(out, ref, (a, b)):
        assert torch.equal(x, y)
        assert not torch.equal(x, x0)


def test_wrapper_refusals(cuda):
    lat = _lattice(16, True, cuda)
    sl = split_ops.build_split(lat)
    a = torch.ones((2, sl.nh), device=cuda)
    sched = schedules.linear(1.0, 0.0, 4, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        sk.sa_split_anneal(sl, sched, a.double(), a.double(), 0)
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.ones((2, 2 * sl.nh), device=cuda)[:, ::2]
        sk.sa_split_anneal(sl, sched, wide, a, 0)
    # kernels A and B refuse no shape and no chain count: a lattice no
    # cluster holds runs on their per-phase kernels
    # (test_phased_kernels_equal_plain, test_kernel_b_equals_plain)
    assert sk.sa_geometry(1, 962) is None  # R = 16 holds L <= 960
    q = torch.ones((2, 1, sl.nh), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        sk.qmc_split_anneal(sl, sched, sched, 1.0, (q.double(),) * 4, 0, True)
    assert sk.qmc_geometry(2, 676, 40) is None


@pytest.mark.parametrize("L,periodic,chains", [
    (5, True, 6), (9, False, 6), (16, True, 6), (33, True, 6),
    (5, True, 1), (9, False, 32), (9, False, 1280), (81, True, 33),
    (81, True, 1280), (243, True, 1), (243, True, 32),
])
def test_kernel_6_equals_plain(cuda, L, periodic, chains):
    pl = plane_ops.build_plane(_lattice(L, periodic, cuda))
    rng = np.random.default_rng(2)
    s = torch.as_tensor(rng.choice([-1.0, 1.0], size=(chains, L, L))
                        .astype(np.float32), device=cuda)
    sched = schedules.linear(3.0, 0.0, 64, device=cuda)
    out = pk.sa_plane_anneal(pl, sched, s, 3)
    assert torch.equal(out, pk.sa_plane_anneal_ref(pl, sched, s, 3))
    assert not torch.equal(out, s)


def test_kernel_6_odd_torus_wrap_pairs(cuda):
    """The 7 x 7 ferromagnetic torus, whose wrap pairs share a phase
    (ROADMAP.md queue 3), at T = 0 and from a ramp: each pair is decided
    from the state the phase found, as the plain version decides it."""
    ferro = convert.lattice_from_arrays(-np.ones((7, 7)), -np.ones((7, 7)),
                                        np.zeros((7, 7)), device=cuda)
    pl = plane_ops.build_plane(ferro)
    rng = np.random.default_rng(5)
    s = torch.as_tensor(rng.choice([-1.0, 1.0], size=(40, 7, 7))
                        .astype(np.float32), device=cuda)
    for sched in (torch.zeros(9, device=cuda),
                  schedules.linear(3.0, 0.0, 200, device=cuda)):
        out = pk.sa_plane_anneal(pl, sched, s, 2)
        assert torch.equal(out, pk.sa_plane_anneal_ref(pl, sched, s, 2))


# (L, P, periodic, global moves, B, chains); L = 677 is held by no cluster
# of 16 CTAs and runs on the per-phase kernels
@pytest.mark.parametrize(
    "L,P,periodic,gm,bscale,chains",
    [(5, 3, True, True, 1.0, 3), (6, 5, False, True, 0.7, 3),
     (7, 4, True, False, 0.7, 3), (8, 2, True, True, 1.0, 3),
     (9, 7, True, True, 1.0, 3), (16, 5, True, True, 0.7, 3),
     (5, 1, True, True, 1.0, 3), (9, 1, False, False, 0.7, 3),
     (16, 40, True, True, 0.7, 3), (10, 64, False, True, 1.0, 3),
     (12, 70, True, True, 0.7, 2), (81, 5, True, True, 1.0, 33),
     (81, 40, True, False, 0.7, 4), (243, 5, True, True, 0.7, 2),
     (677, 3, True, True, 1.0, 1)],
)
def test_kernel_3_equals_plain(cuda, L, P, periodic, gm, bscale, chains):
    pl = plane_ops.build_plane(_lattice(L, periodic, cuda))
    rng = np.random.default_rng(3)
    c = torch.as_tensor(rng.choice([-1.0, 1.0], size=(chains, P, L, L))
                        .astype(np.float32), device=cuda)
    steps = 30
    gamma = schedules.transverse_field(2.5, 1e-8, steps, device=cuda)
    teff = (1.0 / P) * P
    jp = schedules.jperp(gamma, teff).contiguous()
    bs = torch.full_like(gamma, bscale)
    _build.reset_launches()
    out = pk.qmc_plane_anneal(pl, bs, jp, teff, c, 5, gm)
    phases = piqmc_ops.spacetime_num_phases(2, P) + (2 if gm else 0)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == (
        {"qmc_plane_phased": phases * steps}
        if pk.plane_qmc_geometry(chains, L, P) is None
        else {"qmc_plane": 1})
    ref = pk.qmc_plane_anneal_ref(pl, bs, jp, teff, c, 5, gm)
    assert torch.equal(out, ref)
    assert not torch.equal(out, c)


def test_plane_wrapper_refusals(cuda):
    pl = plane_ops.build_plane(_lattice(16, True, cuda))
    sched = schedules.linear(1.0, 0.0, 4, device=cuda)
    s = torch.ones((2, 16, 16), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        pk.sa_plane_anneal(pl, sched, s.double(), 0)
    with pytest.raises(ValueError, match="contiguous"):
        pk.sa_plane_anneal(pl, sched, s.transpose(1, 2), 0)
    # R = 16 holds L <= 675; beyond, the per-phase kernel runs
    # (test_phased_kernels_equal_plain)
    assert pk.plane_sa_geometry(1, 676) is None


# (L, P, launches): the pre-anneal is one SA launch; PIQMC is one launch
# of kernel B or of kernel 3
@pytest.mark.parametrize("L,P,launches", [
    (16, 4, {"sa_split": 1, "qmc_split": 1}),
    (16, 5, {"sa_split": 1, "qmc_plane": 1}),
    (9, 4, {"sa_plane": 1, "qmc_plane": 1}),
])
def test_solve_runs_the_kernels(cuda, L, P, launches):
    lat = _lattice(L, True, cuda)
    _build.reset_launches()
    ss = solve(lat, "piqmc", num_reads=4, sweeps=50, slices=P, seed=1)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == launches
    assert set(np.unique(ss.samples)) <= {-1.0, 1.0}
    assert np.all(np.isfinite(ss.energies))


def _angles(shape, dev, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor((rng.random(shape) * np.pi).astype(np.float32),
                           device=dev)


def _assert_angles_equal(out, ref, start):
    err = (out - ref).abs()
    assert int((err > 1e-3).sum()) == 0
    assert float(err.max()) <= 2e-5
    assert float((out - start).abs().gt(1e-3).float().mean()) > 0.3


@pytest.mark.parametrize("L,periodic,tf", [
    (6, False, True), (10, True, False), (16, False, True), (32, True, True),
    (32, True, False),
])
def test_kernel_4_equals_plain(cuda, L, periodic, tf):
    sl = split_ops.build_split(_lattice(L, periodic, cuda))
    th = _angles((5, L * L), cuda, 4)
    a, b = (x.contiguous() for x in split_ops.pack_classical(sl, th))
    A = schedules.linear(2.5, 1e-8, 64, device=cuda)
    B = torch.full_like(A, 0.9)
    out = sk.svmc_split_anneal(sl, A, B, 0.1, a, b, 3, tf)
    ref = sk.svmc_split_anneal_ref(sl, A, B, 0.1, a, b, 3, tf)
    for x, y, x0 in zip(out, ref, (a, b)):
        _assert_angles_equal(x, y, x0)


# (L, periodic, tf, chains): one chain over a cluster of up to 16 CTAs
# (L = 256 lies past the 138 that one block per chain held), and L = 554,
# which no cluster holds and the per-phase kernels run
@pytest.mark.parametrize("L,periodic,tf,chains", [
    (4, True, True, 1), (4, False, False, 33), (16, True, True, 33),
    (16, False, False, 1), (80, True, True, 256), (80, True, False, 256),
    (80, False, True, 33), (256, True, True, 1), (256, True, False, 33),
    (256, False, True, 256), (554, True, True, 1), (554, False, False, 1),
])
def test_kernel_4_cluster_shapes_equal_plain(cuda, L, periodic, tf, chains):
    sl = split_ops.build_split(_lattice(L, periodic, cuda))
    th = _angles((chains, L * L), cuda, L)
    a, b = (x.contiguous() for x in split_ops.pack_classical(sl, th))
    steps = 32
    A = schedules.linear(2.5, 1e-8, steps, device=cuda)
    B = torch.full_like(A, 0.9)
    _build.reset_launches()
    out = sk.svmc_split_anneal(sl, A, B, 0.1, a, b, 3, tf)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == (
        {"svmc_split_phased": 1 + 2 * steps}
        if sk.svmc_split_geometry(chains, L) is None
        else {"svmc_split": 1})
    ref = sk.svmc_split_anneal_ref(sl, A, B, 0.1, a, b, 3, tf)
    for x, y, x0 in zip(out, ref, (a, b)):
        _assert_angles_equal(x, y, x0)


def _phased(launches, key):
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == \
        {key: launches}


@pytest.mark.parametrize("L", [962])
def test_phased_kernel_a_equals_plain(cuda, L):
    sl = split_ops.build_split(_lattice(L, True, cuda))
    rng = np.random.default_rng(8)
    s = torch.as_tensor(rng.choice([-1.0, 1.0], size=(2, L * L))
                        .astype(np.float32), device=cuda)
    a, b = (x.contiguous() for x in split_ops.pack_classical(sl, s))
    sched = schedules.linear(3.0, 0.0, 8, device=cuda)
    _build.reset_launches()
    out = sk.sa_split_anneal(sl, sched, a, b, 9)
    _phased(16, "sa_split_phased")
    ref = sk.sa_split_anneal_ref(sl, sched, a, b, 9)
    for x, y, x0 in zip(out, ref, (a, b)):
        assert torch.equal(x, y)
        assert not torch.equal(x, x0)


@pytest.mark.parametrize("L", [676, 677])
def test_phased_kernel_6_equals_plain(cuda, L):
    pl = plane_ops.build_plane(_lattice(L, True, cuda))
    rng = np.random.default_rng(9)
    s = torch.as_tensor(rng.choice([-1.0, 1.0], size=(2, L, L))
                        .astype(np.float32), device=cuda)
    sched = schedules.linear(3.0, 0.0, 8, device=cuda)
    _build.reset_launches()
    out = pk.sa_plane_anneal(pl, sched, s, 3)
    _phased(16, "sa_plane_phased")
    assert torch.equal(out, pk.sa_plane_anneal_ref(pl, sched, s, 3))
    assert not torch.equal(out, s)


@pytest.mark.parametrize("periodic,tf", [(True, True), (False, False)])
def test_phased_kernel_7_equals_plain(cuda, periodic, tf):
    L = 481
    pl = plane_ops.build_plane(_lattice(L, periodic, cuda))
    th = _angles((2, L, L), cuda, 10)
    A = schedules.linear(2.5, 1e-8, 16, device=cuda)
    B = torch.full_like(A, 0.9)
    _build.reset_launches()
    out = pk.svmc_plane_anneal(pl, A, B, 0.1, th, 3, tf)
    _phased(1 + 2 * 16, "svmc_plane_phased")
    _assert_angles_equal(out, pk.svmc_plane_anneal_ref(pl, A, B, 0.1, th, 3,
                                                        tf), th)


@pytest.mark.parametrize("L,P,gm,steps", [(402, 128, True, 2),
                                          (674, 40, False, 4),
                                          (674, 40, True, 4)])
def test_phased_kernel_5_equals_plain(cuda, L, P, gm, steps):
    sl = split_ops.build_split(_lattice(L, True, cuda))
    rng = np.random.default_rng(11)
    c = torch.as_tensor(rng.choice([-1.0, 1.0], size=(1, P, L * L))
                        .astype(np.float32), device=cuda)
    a, b = (x.contiguous() for x in split_ops.pack_classical(sl, c))
    gamma = schedules.transverse_field(2.5, 1e-8, steps, device=cuda)
    teff = (1.0 / P) * P
    jp = schedules.jperp(gamma, teff).contiguous()
    bs = torch.full_like(gamma, 0.7)
    bath = piqmc_ops.bath_matrix(
        schedules.bath_lookuptable(P, 0.5, device=cuda), P).contiguous()
    _build.reset_launches()
    out = sk.qmc_bath_split_anneal(sl, bs, jp, teff, bath, a, b, 5, gm)
    _phased((4 if gm else 2) * steps, "qmc_bath_split_phased")
    ref = sk.qmc_bath_split_anneal_ref(sl, bs, jp, teff, bath, a, b, 5, gm)
    for x, y, x0 in zip(out, ref, (a, b)):
        assert torch.equal(x, y)
        assert not torch.equal(x, x0)


# L = 121 and 243 lie past the 120 that one block per chain held
@pytest.mark.parametrize("L,periodic,tf,chains", [
    (5, True, True, 6), (5, False, False, 6), (9, False, True, 6),
    (16, True, False, 6), (33, True, True, 6), (81, True, True, 256),
    (81, False, False, 1), (121, False, True, 6), (243, True, True, 1),
    (243, True, False, 256),
])
def test_kernel_7_equals_plain(cuda, L, periodic, tf, chains):
    pl = plane_ops.build_plane(_lattice(L, periodic, cuda))
    th = _angles((chains, L, L), cuda, 5)
    A = schedules.linear(2.5, 1e-8, 64, device=cuda)
    B = torch.full_like(A, 0.9)
    out = pk.svmc_plane_anneal(pl, A, B, 0.1, th, 3, tf)
    _assert_angles_equal(out, pk.svmc_plane_anneal_ref(pl, A, B, 0.1, th, 3,
                                                        tf), th)


def test_svmc_wrapper_refusals(cuda):
    A = schedules.linear(1.0, 1e-8, 4, device=cuda)
    # no lattice is refused: R = 16 holds even L <= 552 (kernel 4) and
    # L <= 480 (kernel 7), the per-phase kernels run beyond
    assert sk.svmc_split_geometry(1, 554) is None
    assert pk.plane_svmc_geometry(1, 481) is None
    sl = split_ops.build_split(_lattice(16, True, cuda))
    h = torch.ones((1, sl.nh), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.ones((1, 2 * sl.nh), device=cuda)[:, ::2]
        sk.svmc_split_anneal(sl, A, torch.ones_like(A), 0.1, wide, h, 0,
                             True)
    pl = plane_ops.build_plane(_lattice(16, True, cuda))
    with pytest.raises(ValueError, match="float32"):
        pk.svmc_plane_anneal(pl, A, torch.ones_like(A), 0.1,
                             torch.ones((1, 16, 16), device=cuda).double(), 0,
                             True)


@pytest.mark.parametrize("L,launches", [(16, {"svmc_split": 1}),
                                        (9, {"svmc_plane": 1}),
                                        (256, {"svmc_split": 1})])
def test_solve_svmc_runs_its_kernel(cuda, L, launches):
    lat = _lattice(L, True, cuda)
    _build.reset_launches()
    ss = solve(lat, "svmc", num_reads=8, sweeps=100, seed=2)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == launches
    assert set(np.unique(ss.samples)) <= {-1.0, 1.0}
    assert np.all(np.isfinite(ss.energies))


@pytest.mark.parametrize("L,periodic,P,bscale,gm", [
    (4, False, 2, 1.0, True), (16, True, 3, 0.7, False),
    (16, False, 5, 1.0, True), (32, True, 40, 0.7, True),
    (32, False, 40, 1.0, False), (80, True, 5, 0.7, True),
    (80, True, 40, 1.0, True), (80, True, 64, 0.7, True),
    (16, True, 70, 1.0, True), (176, True, 40, 1.0, True),
    (256, False, 40, 0.7, True),
])
def test_kernel_5_equals_plain(cuda, L, periodic, P, bscale, gm):
    sl = split_ops.build_split(_lattice(L, periodic, cuda))
    rng = np.random.default_rng(6)
    c = torch.as_tensor(rng.choice([-1.0, 1.0], size=(3, P, L * L))
                        .astype(np.float32), device=cuda)
    a, b = (x.contiguous() for x in split_ops.pack_classical(sl, c))
    gamma = schedules.transverse_field(2.5, 1e-8, 12, device=cuda)
    teff = (1.0 / P) * P
    jp = schedules.jperp(gamma, teff).contiguous()
    bs = torch.full_like(gamma, bscale)
    for alpha in (1e-2, 0.5):
        bath = piqmc_ops.bath_matrix(
            schedules.bath_lookuptable(P, alpha, device=cuda), P).contiguous()
        out = sk.qmc_bath_split_anneal(sl, bs, jp, teff, bath, a, b, 5, gm)
        ref = sk.qmc_bath_split_anneal_ref(sl, bs, jp, teff, bath, a, b, 5,
                                           gm)
        for x, y, x0 in zip(out, ref, (a, b)):
            assert torch.equal(x, y)
            assert not torch.equal(x, x0)


def test_bath_wrapper_refusals(cuda):
    # P = 128 at L = 1024: a band of 64 rows of 4 words a site is 1.1 MB
    # even over a cluster of 16 CTAs; the per-phase kernels run there
    # (test_phased_kernel_5_equals_plain)
    assert sk.qmc_bath_geometry(1, 1024, 128) is None
    A = schedules.linear(1.0, 1e-8, 4, device=cuda)
    bath = torch.zeros((128, 128), device=cuda)
    sl = split_ops.build_split(_lattice(80, True, cuda))
    h = torch.ones((1, 4, sl.nh), device=cuda)
    with pytest.raises(ValueError, match="bath"):
        sk.qmc_bath_split_anneal(sl, A, A, 1.0, bath, h, h, 0, True)


@pytest.mark.parametrize("P", [3, 40])
def test_bath_anneal_runs_its_kernel(cuda, P):
    """One qmc.anneal(lookuptable=...) is one launch of kernel 5, after the
    pre-anneal's one launch of kernel A."""
    lat = _lattice(16, True, cuda)
    gen = torch.Generator().manual_seed(P)
    _build.reset_launches()
    s = sa.random_state(gen, lat.nspins, batch=(4,), device=cuda)
    s = sa.anneal(lat, schedules.pre_anneal_schedule(3.0, 1.0, device=cuda),
                  s, gen, mcsteps=5)
    a = schedules.transverse_field(3.0, 1e-8, 50, device=cuda)
    out = qmc.anneal(lat, a, torch.ones_like(a), 1.0 / P,
                     qmc.replicate(s, P), gen, global_moves=True,
                     lookuptable=schedules.bath_lookuptable(P, 1e-2))
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == \
        {"sa_split": 1, "qmc_bath_split": 1}
    assert out.shape == (4, P, lat.nspins) and out.device == s.device
    assert set(torch.unique(out).tolist()) <= {-1.0, 1.0}


def test_device_none_means_the_card(cuda):
    lat = instances.gaussian_torus(4)
    assert lat.device == torch.device("cuda", 0)
    assert schedules.linear(1.0, 0.0, 3).device == lat.device
    gen = torch.Generator().manual_seed(0)
    assert sa.random_state(gen, 16, batch=(2,)).device == lat.device


# ------------------------------------------- hw_rng: the generator streams


def _route(route):
    return gibbs.phased_route() if route == "phased" \
        else contextlib.nullcontext()


@pytest.mark.parametrize("route", ["cluster", "phased"])
@pytest.mark.parametrize("engine", ["sa", "qmc", "bath", "svmc"])
def test_hw_rng_kernels_sample_exact_weights(cuda, engine, route):
    """The generator instantiations of kernels A, B, 5 and 4, on their
    cluster and their per-phase kernels, on the bonded pair of
    gibbs_check.py (as tests/test_torch_hw_rng.py holds the plain
    versions): every state within 5 standard errors of its exact weight,
    4096 chains."""
    name = {"sa": "split_sa", "qmc": "split_qmc", "bath": "split_qmc_bath",
            "svmc": "split_svmc"}[engine]
    sample, exact, S, _ = gibbs.CASES[name]
    _build.reset_launches()
    with _route(route):
        f = sample(gibbs.ENGINES[name][0], gibbs.pair_lattice(4, cuda), 4096)
    key = {"sa": "sa_split", "qmc": "qmc_split", "bath": "qmc_bath_split",
           "svmc": "svmc_split"}[engine] + "_hw"
    assert set(k for k, v in _build.LAUNCHES.items() if v) == {
        key + ("_phased" if route == "phased" else "")}
    z, d = gibbs.z_scores(f, exact, S)
    assert z < 5.0, (z, d)


@pytest.mark.parametrize("route", ["cluster", "phased"])
def test_hw_rng_kernel_streams(cuda, route):
    """Chains (and slices) started alike end apart; a seed reproduces its
    result, another seed differs."""
    lat = _lattice(16, True, cuda)
    one = torch.as_tensor(np.random.default_rng(3).choice(
        [-1.0, 1.0], size=256).astype(np.float32), device=cuda)
    g = torch.full((2,), 3.0, device=cuda)
    lut = schedules.bath_lookuptable(8, 0.01, device=cuda)
    runs = [
        lambda sd: sk.anneal_lattice_split(
            lat, schedules.linear(3.0, 0.5, 10, device=cuda),
            one.expand(96, 256).contiguous(), sd, hw_rng=True),
        lambda sd: sk.anneal_lattice_svmc_split(
            lat, torch.ones(10, device=cuda), torch.ones(10, device=cuda),
            0.05, (one + 2.0).expand(8, 256).contiguous(), sd, tf=True,
            hw_rng=True),
        lambda sd: sk.anneal_lattice_qmc_split(
            lat, g, torch.ones_like(g), 1.0 / 8,
            one.expand(4, 8, 256).contiguous(), sd, global_moves=True,
            hw_rng=True),
        lambda sd: sk.anneal_lattice_qmc_bath_split(
            lat, g, torch.ones_like(g), 1.0 / 8, lut,
            one.expand(4, 8, 256).contiguous(), sd, global_moves=True,
            hw_rng=True)]
    with _route(route):
        for run in runs:
            out = run(5)
            assert torch.equal(out, run(5))
            assert not torch.equal(out, run(6))
            chains = out.shape[0]
            assert torch.unique(out.reshape(chains, -1),
                                dim=0).shape[0] == chains
            if out.ndim == 3:
                assert all(torch.unique(c, dim=0).shape[0] == out.shape[1]
                           for c in out)


def test_bench_arms_run_their_kernels(cuda):
    """Every arm of bench/throughput.py on the card at tiny tau launches
    its kernel, the pallas_* arms the generator instantiations."""
    from montecarlosolvers_tpu_torch.bench import throughput

    want = {"sa": "sa_split", "piqmc": "qmc_split", "svmc": "svmc_split",
            "piqmc_bath": "qmc_bath_split", "pallas": "sa_split_hw",
            "pallas_qmc": "qmc_split_hw", "pallas_svmc": "svmc_split_hw",
            "pallas_bath": "qmc_bath_split_hw"}
    for rec in throughput.run_arms(light=True, device=cuda, side=16,
                                   taus=(4, 8)):
        assert rec["launches"] == {want[rec["arm"]]: 4}
        assert rec["attempts_per_s"] > 0


# ------------------------------------- collect_energy=: the energy kernel


@pytest.mark.parametrize("kernel,L,periodic,slices", [
    ("split_sa", 10, True, None), ("split_sa", 80, True, None),
    ("split_sa", 16, False, None),
    ("split_qmc", 10, True, 4), ("split_qmc", 80, True, 40),
    ("split_qmc", 16, False, 2),
    ("split_qmc_bath", 10, True, 3), ("split_qmc_bath", 16, False, 40),
    ("split_svmc", 10, True, None), ("split_svmc", 16, False, None),
    ("plane_sa", 9, True, None), ("plane_sa", 81, True, None),
    ("plane_sa", 10, False, None),
    ("plane_qmc", 9, True, 5), ("plane_qmc", 10, True, 3),
    ("plane_qmc", 7, False, 40),
    ("plane_svmc", 9, True, None), ("plane_svmc", 10, False, None),
])
def test_collecting_route_equals_plain(cuda, kernel, L, periodic, slices):
    """With `energies=`, each kernel's wrapper takes its per-phase kernels
    and launches the energy kernel once a step: the states equal the plain
    version's and those of the call without energies (spins bitwise,
    angles as the SVMC checks hold them), the energies are within
    ENERGY_RTOL * (sum |J| + sum |h|) of the plain version's, and a second
    run reproduces them bitwise."""
    steps, chains = 6, 5
    case = gibbs.collect_case(kernel, _lattice(L, periodic, cuda), chains,
                              steps, slices)
    wrapper, plain, _ = gibbs.COLLECTING[kernel]
    es, es_plain, es_again = (torch.full((steps, chains), float("nan"),
                                         device=cuda) for _ in range(3))
    _build.reset_launches()
    out = case["run"](wrapper, es)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == \
        case["launches"]
    ref = case["run"](plain, es_plain)
    without = case["run"](wrapper, None)
    case["run"](wrapper, es_again)
    torch.cuda.synchronize()
    for x, y, z, x0 in zip(out, ref, without, case["start"]):
        if case["angles"]:
            _assert_angles_equal(x, y, x0)
            assert torch.equal(x, z)
        else:
            assert torch.equal(x, y) and torch.equal(x, z)
    assert torch.isfinite(es).all()
    assert float((es - es_plain).abs().max()) <= \
        gibbs.ENERGY_RTOL * case["scale"]
    assert torch.equal(es, es_again)


def test_energy_kernel_equals_plain(cuda):
    """The energy kernel's stand-alone entry points against their plain
    versions: halves at P = 1 and 3, spins and cos theta; the quarters at
    P = 6; planes at P = 1 and 5 on an odd torus and an open lattice; 33
    chains. Each counts one launch under LAUNCHES["energy"]."""
    rng = np.random.default_rng(5)

    def spins(*shape):
        return torch.as_tensor(rng.choice([-1.0, 1.0], size=shape).astype(
            np.float32), device=cuda)

    def bound(lat):
        return gibbs.ENERGY_RTOL * gibbs.energy_scale(lat)

    for lat in (_lattice(10, True, cuda), _lattice(12, False, cuda)):
        sl = split_ops.build_split(lat)
        for shape in ((33, sl.nh), (33, 3, sl.nh)):
            cosines = [torch.cos(_angles(shape, cuda, i)) for i in (2, 3)]
            for (a, b), cos in (((spins(*shape), spins(*shape)), False),
                                (cosines, True)):
                _build.reset_launches()
                got = energy_ops.halves_energy(sl, a, b, cos)
                assert _build.LAUNCHES["energy"] == 1
                want = energy_ops.halves_energy_ref(sl, a, b, cos)
                assert float((got - want).abs().max()) <= bound(lat)
        quarters = split_ops.pack_qmc(sl, spins(33, 6, lat.nspins))
        got = energy_ops.quarters_energy(sl, quarters)
        want = energy_ops.quarters_energy_ref(sl, quarters)
        assert float((got - want).abs().max()) <= bound(lat)
    for lat in (_lattice(9, True, cuda), _lattice(7, False, cuda)):
        pl = plane_ops.build_plane(lat)
        L = lat.L
        for s, cos in ((spins(33, L, L), False), (spins(33, 5, L, L), False),
                       (torch.cos(_angles((33, L, L), cuda, 3)), True)):
            got = energy_ops.plane_energy(pl, s, cos)
            want = energy_ops.plane_energy_ref(pl, s, cos)
            assert float((got - want).abs().max()) <= bound(lat)


@pytest.mark.parametrize("L,P,bath,launches", [
    (16, None, False, {"sa_split_phased": 12, "sa_split_energy": 6}),
    (9, None, False, {"sa_plane_phased": 12, "sa_plane_energy": 6}),
    (16, 4, False, {"qmc_split_phased": 24, "qmc_split_energy": 6}),
    (16, 5, False, {"qmc_plane_phased": 30, "qmc_plane_energy": 6}),
    (16, 4, True, {"qmc_bath_split_phased": 24,
                   "qmc_bath_split_energy": 6}),
])
def test_solvers_collect_on_the_card(cuda, L, P, bath, launches):
    """sa.anneal and qmc.anneal with collect_energy=True on the card: the
    energies (steps * mcsteps, chains) on the card, the last row the
    readout of the returned state, launches of the per-phase and energy
    kernels only."""
    lat = _lattice(L, True, cuda)
    gen = torch.Generator().manual_seed(1)
    s = sa.random_state(gen, lat.nspins, batch=(3,))
    _build.reset_launches()
    if P is None:
        out, es = sa.anneal(lat, schedules.linear(2.0, 0.1, 3), s, gen,
                            mcsteps=2, collect_energy=True)
        want = lat.energy(out)
    else:
        a = schedules.transverse_field(2.0, 1e-8, 3)
        lut = schedules.bath_lookuptable(P, 0.1) if bath else None
        out, es = qmc.anneal(lat, a, torch.ones_like(a), 1.0 / P,
                             qmc.replicate(s, P), gen, mcsteps=2,
                             global_moves=True, lookuptable=lut,
                             collect_energy=True)
        want = qmc.best_slice_energy(lat, out)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == launches
    assert es.shape == (6, 3) and es.device == out.device
    torch.testing.assert_close(es[-1], want, rtol=1e-5, atol=1e-3)


# ---------------------------------- the generic kernels (IsingProblem)


def _generic(name, dev):
    """Small graphs of each kind: a torus's generic form (2 colors), a 3-D
    glass, a chimera (3 colors), a random graph with 9 colors (more than
    the JAX package's MAX_PACKED_COLORS) and one with fields, and an odd
    torus's generic form (a proper 4-coloring)."""
    return {
        "torus10": lambda: instances.gaussian_torus(10, 0, device=dev)
        .to_generic(),
        "torus9": lambda: instances.gaussian_torus(9, 0, device=dev)
        .to_generic(),
        "glass3d": lambda: instances.random_3d_lattice(4, rng=0,
                                                       device=dev)[0],
        "chimera": lambda: instances.chimera_graph(3, rng=0, device=dev)[0],
        "rg9": lambda: instances.random_graph(30, 220, rng=1, device=dev)[0],
        "rg_fields": lambda: instances.random_graph(
            300, 900, rng=2, with_fields=True, device=dev)[0],
    }[name]()


@pytest.mark.parametrize("kernel,graph,slices,option", [
    ("packed_sa", "torus10", None, None), ("packed_sa", "rg9", None, None),
    ("packed_sa", "rg_fields", None, None),
    ("packed_sa", "torus9", None, None),
    ("generic_qmc", "torus10", 4, True), ("generic_qmc", "chimera", 5, True),
    ("generic_qmc", "rg9", 3, False), ("generic_qmc", "glass3d", 40, True),
    ("packed_svmc", "torus10", None, True),
    ("packed_svmc", "rg9", None, False),
    ("packed_svmc", "rg_fields", None, True),
])
def test_generic_kernel_equals_plain(cuda, kernel, graph, slices, option):
    """Each generic kernel against its plain version on the card, with and
    without energies: states bitwise (angles as the SVMC checks hold
    them), energies within ENERGY_RTOL * (sum |J| + sum |h|) of the plain
    version's, one launch a call."""
    steps, chains = 12, 5
    prob = _generic(graph, cuda)
    kw = ({"tf": option} if kernel == "packed_svmc"
          else {"global_moves": option} if kernel == "generic_qmc" else {})
    case = gibbs.generic_case(kernel, prob, chains, steps, slices, bscale=0.8,
                              **kw)
    wrapper, plain, key = gibbs.GENERIC[kernel]
    es, es_plain = (torch.full((steps, chains), float("nan"), device=cuda)
                    for _ in range(2))
    _build.reset_launches()
    out = case["run"](wrapper, None)
    collected = case["run"](wrapper, es)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {key: 2}
    ref = case["run"](plain, es_plain)
    torch.cuda.synchronize()
    if case["angles"]:
        _assert_angles_equal(out, ref, case["start"])
    else:
        assert torch.equal(out, ref)
        assert float((out != case["start"]).float().mean()) > 0.05
    assert torch.equal(out, collected)
    assert torch.isfinite(es).all()
    assert float((es - es_plain).abs().max()) <= \
        gibbs.ENERGY_RTOL * case["scale"]


@pytest.mark.parametrize("method,launches", [
    ("sa", {"packed_sa": 1}),
    ("piqmc", {"packed_sa": 1, "generic_qmc": 1}),
    ("svmc", {"packed_svmc": 1}),
])
def test_solve_on_an_ising_problem_runs_its_kernels(cuda, method, launches):
    prob = instances.chimera_graph(2, 2, t=2, rng=1, device=cuda)[0]
    e_gs = float(gibbs.generic_energies(
        prob, gibbs.all_states(prob.nspins)).min())
    kw = {"slices": 4, "pt": 2.0} if method == "piqmc" else {}
    _build.reset_launches()
    ss = solve(prob, method, num_reads=16, sweeps=400, seed=1, **kw)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == launches
    assert abs(ss.best_energy - e_gs) < 1e-3


def test_masked_engine_runs_the_packed_kernel(cuda):
    prob = _generic("rg9", cuda)
    gen = torch.Generator().manual_seed(2)
    s = sa.random_state(gen, prob.nspins, batch=(4,))
    sched = schedules.linear(2.0, 0.1, 20)
    _build.reset_launches()
    a = sa.anneal(prob, sched, s, torch.Generator().manual_seed(3))
    b = sa.anneal(prob, sched, s, torch.Generator().manual_seed(3),
                  engine="masked")
    assert _build.LAUNCHES["packed_sa"] == 2
    assert torch.equal(a, b)
    cpu = prob.to("cpu")
    c = sa.anneal(cpu, sched.cpu(), s.cpu(), torch.Generator().manual_seed(3),
                  engine="masked")
    assert torch.equal(a.cpu(), c)


@pytest.mark.parametrize("engine", ["sa", "qmc", "svmc"])
def test_generic_kernels_sample_exact_weights(cuda, engine):
    """The generic kernels on the small exact cases of
    tests/test_torch_packed.py: every state (or moment) within 5 standard
    errors of the chain means."""
    if engine == "sa":
        prob = instances.random_graph(4, 5, rng=0, with_fields=True,
                                      device=cuda)[0]
        from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
        per_chain = gibbs.sample_generic_sa(gk.anneal_packed, prob, 4096,
                                            1.1, 31)
        z, _ = gibbs.z_scores(per_chain, gibbs.generic_sa_weights(prob, 1.1),
                              gibbs.SAMPLES)
    elif engine == "qmc":
        prob = instances.random_graph(2, 1, rng=0, device=cuda)[0]
        per_chain = gibbs.sample_generic_qmc(prob, 4096, 3, 0.6, 0.7, 32)
        z, _ = gibbs.z_scores(per_chain, gibbs.generic_qmc_weights(
            prob, 3, 0.6, gibbs.jperp(0.7, 3, 0.6)), gibbs.SAMPLES)
    else:
        prob = gibbs.rotor_pair_problem(cuda)
        per_chain = gibbs.sample_generic_svmc(prob, 4096, 0.6, 1.0, 0.7, 33)
        z, _ = gibbs.z_scores(per_chain,
                              np.array(gibbs.rotor_moments(0.6, 1.0, 0.7)))
    assert z < 5.0


# ------------------- the rest of dissipative PIQMC (the bath kernels)


def _bath_problem(name, dev):
    """The generic bath kernel's problems: IsingProblem graphs, and
    lattices on their checkerboard packing (the odd torus's is not a
    proper coloring)."""
    if name == "odd_torus9":
        return instances.gaussian_torus(9, 1, device=dev)
    if name == "odd_open9":
        return instances.random_2d_lattice(9, rng=2, lattice=True,
                                           with_fields=True, device=dev)[0]
    if name == "torus10":
        return instances.gaussian_torus(10, 3, device=dev)
    return _generic(name, dev)


@pytest.mark.parametrize("graph,slices,colored,gm", [
    ("torus10", 4, False, True), ("chimera", 5, False, True),
    ("rg9", 3, False, False), ("rg_fields", 40, False, True),
    ("odd_torus9", 4, False, True), ("odd_open9", 3, False, True),
    ("torus10", 4, True, True), ("chimera", 6, True, False),
    ("rg9", 2, True, True), ("odd_torus9", 5, True, True),
    ("odd_torus9", 40, True, True), ("torus10", 5, True, True),
])
def test_generic_bath_kernel_equals_plain(cuda, graph, slices, colored, gm):
    """csrc/generic_qmc_bath.cu against its plain version, with and without
    energies, on IsingProblem graphs (2 to 9 colors) and on lattices'
    checkerboard packings (torus10 is the lattice itself, at odd P for the
    colored sweep): states bitwise, energies within ENERGY_RTOL * (sum |J|
    + sum |h|), one launch a call."""
    steps, chains = 10, 5
    prob = _bath_problem(graph, cuda)
    if graph == "torus10" and not colored:
        prob = prob.to_generic()
    case = gibbs.generic_case("generic_qmc_bath", prob, chains, steps, slices,
                              global_moves=gm, colored=colored, bscale=0.8,
                              alpha=0.3)
    assert case["pg"].proper is (graph != "odd_torus9")
    wrapper, plain, key = gibbs.GENERIC["generic_qmc_bath"]
    es, es_plain = (torch.full((steps, chains), float("nan"), device=cuda)
                    for _ in range(2))
    _build.reset_launches()
    out = case["run"](wrapper, None)
    collected = case["run"](wrapper, es)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {key: 2}
    ref = case["run"](plain, es_plain)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert float((out != case["start"]).float().mean()) > 0.05
    assert torch.equal(out, collected)
    assert torch.isfinite(es).all()
    assert float((es - es_plain).abs().max()) <= \
        gibbs.ENERGY_RTOL * case["scale"]


# (L, P, periodic, global moves, B, chains); L = 674 at P = 40 is held by
# no cluster of 16 CTAs and runs on the per-phase kernels, P = 66 takes
# the runtime-P kernel
@pytest.mark.parametrize("L,P,periodic,gm,bscale,chains", [
    (10, 2, True, True, 1.0, 3), (16, 4, False, True, 0.7, 3),
    (16, 6, True, False, 0.7, 3), (80, 40, True, True, 0.7, 4),
    (80, 64, True, False, 1.0, 2), (16, 66, True, True, 0.7, 2),
    (176, 40, True, True, 1.0, 2), (674, 40, True, True, 0.7, 1)])
def test_bath_colored_kernel_equals_plain(cuda, L, P, periodic, gm, bscale,
                                          chains):
    """Kernel 5's colored template against its plain version on both
    routes, bitwise, and its collecting route (the per-phase kernels and
    the energy kernel) against the plain version's energies."""
    lat = _lattice(L, periodic, cuda)
    steps = 2 if L > 600 else 8
    case = gibbs.bath_colored_case(lat, chains, steps, P, global_moves=gm,
                                   bscale=bscale, alpha=0.3)
    geometry = sk.qmc_bath_geometry(chains, L, P, sk.card_resident(
        "split_qmc_bath", L, P))
    _build.reset_launches()
    out = case["run"](sk.qmc_bath_split_colored_anneal, None)
    launched = {k: v for k, v in _build.LAUNCHES.items() if v}
    assert launched == ({"qmc_bath_split_colored": 1} if geometry else
                        {"qmc_bath_split_colored_phased":
                         (6 if gm else 4) * steps})
    ref = case["run"](sk.qmc_bath_split_colored_anneal_ref, None)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert float((out != case["start"]).float().mean()) > 0.05
    if L > 200:
        return
    es, es_plain = (torch.full((steps, chains), float("nan"), device=cuda)
                    for _ in range(2))
    _build.reset_launches()
    collected = case["run"](sk.qmc_bath_split_colored_anneal, es)
    want = dict(case["launches"])
    if not gm:
        want["qmc_bath_split_colored_phased"] = 4 * steps
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == want
    case["run"](sk.qmc_bath_split_colored_anneal_ref, es_plain)
    assert torch.equal(collected, out)
    assert float((es - es_plain).abs().max()) <= \
        gibbs.ENERGY_RTOL * case["scale"]


def test_bath_colored_per_phase_kernels_at_small_shapes(cuda):
    """The colored template's per-phase kernels, forced at any shape
    (gibbs_check.phased_route), equal the plain version on small open and
    periodic lattices."""
    for L, periodic, P in ((4, True, 2), (10, False, 6), (16, True, 8)):
        case = gibbs.bath_colored_case(_lattice(L, periodic, cuda), 3, 6, P,
                                       alpha=0.3)
        with gibbs.phased_route():
            _build.reset_launches()
            out = case["run"](sk.qmc_bath_split_colored_anneal, None)
            assert {k: v for k, v in _build.LAUNCHES.items() if v} == \
                {"qmc_bath_split_colored_phased": 36}
        ref = case["run"](sk.qmc_bath_split_colored_anneal_ref, None)
        assert torch.equal(out, ref)


@pytest.mark.parametrize("case", ["ising", "odd_lattice"])
def test_generic_bath_kernel_samples_extended_gibbs(cuda, case):
    """The generic bath kernel on the exact cases of
    tests/test_torch_dissipative.py: every state within 5 standard errors
    of the chain means."""
    if case == "ising":
        from montecarlosolvers_tpu_torch.models.ising import IsingProblem
        prob = IsingProblem.from_edges(2, [0], [1], [0.8], maxnb=1,
                                       device=cuda)
        P, temp, gamma, alpha = 2, 0.9, 0.6, 0.05
        exact = gibbs.generic_qmc_weights(prob, P, temp,
                                          gibbs.jperp(gamma, P, temp),
                                          bath=gibbs.bath_matrix(P, alpha))
        codes, nstates = gibbs.spin_codes, 2 ** (P * prob.nspins)
    else:
        prob = gibbs.pair_lattice(3, cuda)
        P, temp, gamma, alpha = 3, 0.45, 0.6, 0.1
        exact = gibbs.qmc_weights(P, temp, gibbs.jperp(gamma, P, temp),
                                  bath=gibbs.bath_matrix(P, alpha))
        codes, nstates = gibbs.line_codes, 4 ** P
    per_chain = gibbs.sample_generic_bath(prob, 4096, P, temp, gamma, alpha,
                                          44, codes, nstates)
    z, _ = gibbs.z_scores(per_chain, exact, gibbs.SAMPLES)
    assert z < 5.0


@pytest.mark.parametrize("name,P,bath_update,launches", [
    ("ising", 4, "sequential", {"generic_qmc_bath": 1}),
    ("ising", 4, "colored", {"generic_qmc_bath": 1}),
    ("odd_torus9", 40, "sequential", {"generic_qmc_bath": 1}),
    ("torus10", 5, "colored", {"generic_qmc_bath": 1}),
    ("torus10", 40, "colored", {"qmc_bath_split_colored": 1}),
    ("torus10", 40, "sequential", {"qmc_bath_split": 1}),
])
def test_bath_routes_on_the_card(cuda, name, P, bath_update, launches):
    """qmc.anneal(lookuptable=...) launches the route of the JAX solver's
    table (solvers/qmc.py): one launch an anneal."""
    prob = (_generic("chimera", cuda) if name == "ising"
            else _bath_problem(name, cuda))
    gen = torch.Generator().manual_seed(4)
    c = qmc.replicate(sa.random_state(gen, prob.nspins, batch=(3,)), P)
    g = schedules.transverse_field(3.0, 1e-8, 20)
    _build.reset_launches()
    out = qmc.anneal(prob, g, torch.ones_like(g), 1.0 / P, c, gen,
                     global_moves=True,
                     lookuptable=schedules.bath_lookuptable(P, 0.01),
                     bath_update=bath_update)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == launches
    assert set(torch.unique(out).tolist()) <= {-1.0, 1.0}


# ------------------------------ the dense engine and the noisy anneals


@pytest.mark.parametrize("N,chains,block,shuffle,bf16", [
    (1000, 33, 128, False, False), (1000, 9, 128, True, True),
    (2048, 16, 128, False, False), (2048, 8, 128, True, False),
    (2048, 8, 128, False, True), (70, 5, 7, False, False),
    (300, 40, 100, True, True), (64, 3, 64, False, False),
])
def test_dense_kernel_equals_plain(cuda, N, chains, block, shuffle, bf16):
    """csrc/dense_sa.cu against its plain version on the card: the same
    torch.matmul block fields, spins bitwise; ragged CTAs (chains not a
    multiple of 8 warps), padded blocks (N not a multiple of B), B below
    32 and between 32 and 128, shuffled and bf16."""
    dp = instances.sk_model(N, rng=N, device=cuda)[0]
    s = torch.as_tensor(np.random.default_rng(N).choice(
        [-1.0, 1.0], size=(chains, N)).astype(np.float32), device=cuda)
    temps = schedules.linear(2.0, 0.2, 3, device=cuda)
    md = torch.bfloat16 if bf16 else None
    _build.reset_launches()
    out = dk.dense_sa_anneal(dp, temps, s, 5, block, shuffle, md)
    B = min(block, N)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "dense_sa": 3 * -(-N // B)}
    ref = dk.dense_sa_anneal_ref(dp, temps, s, 5, block, shuffle, md)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert float((out != s).float().mean()) > 0.01


def test_dense_kernel_refuses_blocks_past_its_tile(cuda):
    dp = instances.sk_model(300, rng=0, device=cuda)[0]
    s = torch.ones((2, 300), device=cuda)
    with pytest.raises(ValueError, match="block <= 128"):
        dk.dense_sa_anneal(dp, schedules.linear(1.0, 0.1, 2, device=cuda), s,
                           0, block=256)


def test_solve_on_a_dense_problem_runs_its_kernel(cuda):
    dp = instances.sk_model(12, rng=5, device=cuda)[0]
    e_gs = float(dp.energy(torch.as_tensor(
        gibbs.all_states(12), dtype=torch.float32, device=cuda)).min())
    _build.reset_launches()
    ss = solve(dp, "sa", num_reads=16, sweeps=300, seed=1)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"dense_sa": 300}
    assert abs(ss.best_energy - e_gs) < 1e-3
    gen = torch.Generator().manual_seed(0)
    s0 = sa.random_state(gen, 12, batch=(2, 3))
    out, es = sa.anneal(dp, schedules.linear(2.0, 0.1, 10), s0, gen,
                        collect_energy=True)
    assert es.shape == (10, 2, 3)
    torch.testing.assert_close(es[-1], dp.energy(out))


def _noisy_case(graph, dev, steps, mcsteps):
    prob = _generic(graph, dev)
    pg = packed_ops.build_packed(prob)
    r = np.random.default_rng(steps)
    nbr_J, h = prob.nbr_J.cpu().numpy(), prob.h.cpu().numpy()
    jt = nbr_J * (1 + 0.1 * r.standard_normal((steps,) + nbr_J.shape))
    ht = h * (1 + 0.1 * r.standard_normal((steps,) + h.shape))
    return prob, pg, gk.packed_tables(pg, jt, ht, mcsteps, steps * mcsteps,
                                      dev)


@pytest.mark.parametrize("graph,mcsteps", [("torus10", 1), ("rg9", 2),
                                           ("rg_fields", 1),
                                           ("chimera", 3)])
def test_noisy_kernels_equal_plain(cuda, graph, mcsteps):
    """The packed SA and SVMC kernels on per-step tables (csrc/packed_sa.cu
    and csrc/packed_svmc.cu with table strides) against their plain
    versions: spins bitwise, angles as the SVMC checks hold them; one
    launch an anneal under the noisy keys."""
    steps = 12
    prob, pg, tables = _noisy_case(graph, cuda, steps, mcsteps)
    n = prob.nspins
    rng = np.random.default_rng(1)
    s = torch.as_tensor(rng.choice([-1.0, 1.0], size=(6, n))
                        .astype(np.float32), device=cuda)
    temps = schedules.linear(3.0, 0.1, steps * mcsteps, device=cuda)
    _build.reset_launches()
    out = gk.packed_sa_anneal(pg, temps, s, 7, tables=tables)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "packed_sa_noisy": 1}
    ref = gk.packed_sa_anneal_ref(pg, temps, s, 7, tables=tables)
    torch.cuda.synchronize()
    assert torch.equal(out, ref) and not torch.equal(out, s)
    th = _angles((6, n), cuda, 2)
    a = schedules.linear(3.0, 1e-8, steps * mcsteps, device=cuda)
    b = torch.full_like(a, 0.9)
    for tf in (True, False):
        _build.reset_launches()
        out = gk.packed_svmc_anneal(pg, a, b, 0.05, th, 7, tf, tables=tables)
        assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
            "packed_svmc_noisy": 1}
        ref = gk.packed_svmc_anneal_ref(pg, a, b, 0.05, th, 7, tf,
                                        tables=tables)
        torch.cuda.synchronize()
        _assert_angles_equal(out, ref, th)


def test_noisy_solvers_run_their_kernels(cuda):
    steps = 20
    prob, pg, _ = _noisy_case("rg_fields", cuda, steps, 1)
    jt = prob.nbr_J.expand((steps,) + tuple(prob.nbr_J.shape))
    ht = prob.h.expand(steps, prob.nspins)
    gen = torch.Generator().manual_seed(0)
    s0 = sa.random_state(gen, prob.nspins, batch=(4,))
    sched = schedules.linear(2.0, 0.1, steps)
    _build.reset_launches()
    noisy = sa.anneal_noisy(prob, sched, jt, ht, s0,
                            torch.Generator().manual_seed(1))
    static = sa.anneal(prob, sched, s0, torch.Generator().manual_seed(1))
    assert _build.LAUNCHES["packed_sa_noisy"] == 1
    assert torch.equal(noisy, static)
    th = svmc.random_state(gen, prob.nspins, batch=(4,))
    _build.reset_launches()
    noisy = svmc.anneal_noisy(prob, sched, torch.ones_like(sched), 0.1, jt,
                              ht, th, torch.Generator().manual_seed(1),
                              tf=True)
    static = svmc.anneal(prob, sched, torch.ones_like(sched), 0.1, th,
                         torch.Generator().manual_seed(1), tf=True)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "packed_svmc_noisy": 1, "packed_svmc": 1}
    assert torch.equal(noisy, static)


# ------------------------------------------------------ the cluster kernels


def _cluster_graph(name, dev):
    """The generic graphs above, the 80x80 torus's generic form (P N past
    fk_label's shared memory at P = 8) and a dense symmetric J whose pairs
    fill two slots of each row (duplicate slots)."""
    if name == "torus80":
        return instances.gaussian_torus(80, 0, device=dev).to_generic()
    if name == "dup":
        from montecarlosolvers_tpu_torch.models.ising import IsingProblem
        r = np.random.default_rng(5)
        J = np.triu(r.normal(size=(12, 12)) * (r.random((12, 12)) < 0.5), 1)
        return IsingProblem.from_couplings(12, J + J.T, maxnb=24,
                                           device=dev)
    return _generic(name, dev)


def _cluster_case(name, P, dev, chains=4, steps=6, seed=3):
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck

    prob = _cluster_graph(name, dev)
    pg = packed_ops.build_packed(prob)
    rng = np.random.default_rng(seed)
    confs = torch.as_tensor(rng.choice(
        [-1.0, 1.0], size=(chains, P, prob.nspins)).astype(np.float32),
        device=dev)
    gamma = schedules.transverse_field(2.0, 0.2, steps, device=dev)
    teff = 0.6 * P
    jp = schedules.jperp(gamma, teff).contiguous()
    b = torch.linspace(0.7, 1.0, steps, device=dev)
    return ck, pg, confs, b, jp, torch.full_like(b, teff)


@pytest.mark.parametrize("graph,P,rule,bath", [
    ("torus10", 1, "local", False), ("torus10", 2, "local", True),
    ("torus10", 40, "local", True), ("torus10", 8, "full", False),
    ("chimera", 3, "local", False), ("chimera", 5, "full", True),
    ("rg_fields", 1, "local", False), ("rg_fields", 4, "local", True),
    ("rg9", 2, "full", False), ("dup", 1, "local", False),
    ("dup", 3, "local", True), ("dup", 2, "full", False)])
def test_wolff_kernel_equals_plain(cuda, graph, P, rule, bath):
    """csrc/fk_wolff.cu against wolff_anneal_ref on the card: spins
    bitwise, the cluster sizes it counts equal the plain version's, one
    launch an anneal; the duplicate-slot table and P = 1 included."""
    ck, pg, confs, b, jp, teff = _cluster_case(graph, P, cuda)
    lut = (schedules.bath_lookuptable(P, 0.3, device=cuda) if bath
           else None)
    vis, vis_ref = (torch.zeros(confs.shape[0], dtype=torch.int64,
                                device=cuda) for _ in range(2))
    _build.reset_launches()
    out = ck.wolff_anneal(pg, b, jp, teff, confs, 11, rule, lut, 2, vis)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "fk_wolff": 1}
    from montecarlosolvers_tpu_torch.ops import cluster as cl
    ref = cl.wolff_anneal_ref(pg, b, jp, teff, confs, 11, rule, lut, 2,
                              vis_ref)
    torch.cuda.synchronize()
    assert torch.equal(out, ref) and not torch.equal(out, confs)
    assert torch.equal(vis, vis_ref)


@pytest.mark.parametrize("graph,P,bath", [
    ("torus10", 1, False), ("rg_fields", 1, False), ("dup", 1, False),
    ("torus10", 2, True), ("chimera", 3, False), ("rg_fields", 5, True),
    ("dup", 4, True), ("torus10", 40, True), ("torus80", 8, False)])
def test_label_kernel_equals_plain(cuda, graph, P, bath):
    """csrc/fk_label.cu against sw_anneal_ref: the classical sweep at
    P = 1, the space-time one with and without a bath, labels in shared
    memory and (the 80x80 torus at P = 8) in device memory."""
    ck, pg, confs, b, jp, teff = _cluster_case(graph, P, cuda)
    classical = P == 1
    if classical:
        b, jp = torch.ones_like(b), torch.zeros_like(jp)
    lut = (schedules.bath_lookuptable(P, 0.3, device=cuda) if bath
           else None)
    assert ck.label_smem(P, pg.nspins) == (graph != "torus80")
    _build.reset_launches()
    out = ck.sw_anneal(pg, b, jp, teff, confs, 12, lut, 1, classical)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "fk_label": 1}
    from montecarlosolvers_tpu_torch.ops import cluster as cl
    ref = cl.sw_anneal_ref(pg, b, jp, teff, confs, 12, lut, 1, classical)
    torch.cuda.synchronize()
    assert torch.equal(out, ref) and not torch.equal(out, confs)


@pytest.mark.parametrize("graph,P,per_slice_seeds", [
    ("torus10", 2, True), ("torus10", 2, False), ("torus10", 3, True),
    ("chimera", 5, False), ("rg_fields", 40, True), ("rg_fields", 40, False),
    ("dup", 33, True), ("torus10", 64, True), ("torus10", 64, False)])
def test_line_kernel_equals_plain(cuda, graph, P, per_slice_seeds):
    """csrc/fk_line.cu against line_phase_ref, one launch a color phase:
    P = 2 (the ring bond doubled), one and two slices a lane (P <= 64)."""
    ck, pg, confs, b, jp, teff = _cluster_case(graph, P, cuda, steps=3)
    lut = schedules.bath_lookuptable(P, 0.2, device=cuda)
    p_pair, p_t = ck.line_tables(lut, jp, float(teff[0]), P, cuda)
    out = ref = confs
    from montecarlosolvers_tpu_torch.ops import cluster as cl
    _build.reset_launches()
    for t in range(3):
        for color in range(pg.num_colors):
            out = ck.line_phase(pg, b, jp, p_t, t, float(teff[0]), lut,
                                p_pair, out, 13, 4 + t, color,
                                per_slice_seeds)
            ref = cl.line_phase_ref(pg, b[t], jp[t], float(teff[0]), lut,
                                    ref, 13, 4 + t, color, per_slice_seeds,
                                    p_pair)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "fk_line": 3 * pg.num_colors}
    torch.cuda.synchronize()
    assert torch.equal(out, ref) and not torch.equal(out, confs)


@pytest.mark.parametrize("kernel", ["packed_sa", "generic_qmc",
                                    "generic_qmc_bath"])
def test_local_kernels_take_a_step_offset(cuda, kernel):
    """The per-step launches the cluster solvers make: T one-step launches
    at step0 = t equal one T-step launch (and one-step launches that all
    start at step 0 do not), against the plain version too."""
    steps, P = 5, 4
    prob = _generic("chimera", cuda)
    pg = packed_ops.build_packed(prob)
    rng = np.random.default_rng(2)
    shape = (3, prob.nspins) if kernel == "packed_sa" else (3, P,
                                                             prob.nspins)
    start = torch.as_tensor(rng.choice([-1.0, 1.0], size=shape).astype(
        np.float32), device=cuda)
    temps = schedules.linear(2.0, 0.5, steps, device=cuda)
    jp = schedules.jperp(temps, 1.2).contiguous()
    bath = piqmc_ops.bath_matrix(schedules.bath_lookuptable(
        P, 0.3, device=cuda), P).contiguous()

    def run(fn, sl, x, step0):
        if kernel == "packed_sa":
            return fn(pg, temps[sl], x, 5, step0=step0)
        if kernel == "generic_qmc":
            return fn(pg, temps[sl], jp[sl], 1.2, x, 5, False, step0=step0)
        return fn(pg, temps[sl], jp[sl], 1.2, bath, x, 5, False,
                  step0=step0)
    wrapper, plain, _ = gibbs.GENERIC[kernel]
    whole = run(wrapper, slice(None), start, 0)
    x, y, z = start, start, start
    for t in range(steps):
        x = run(wrapper, slice(t, t + 1), x, t)
        y = run(plain, slice(t, t + 1), y, t)
        z = run(wrapper, slice(t, t + 1), z, 0)
    torch.cuda.synchronize()
    assert torch.equal(whole, x) and torch.equal(x, y)
    assert not torch.equal(whole, z)


@pytest.mark.parametrize("name,launches", [
    ("sa_wolff", lambda T, C: {"packed_sa": T, "fk_wolff": T}),
    ("sa_wolff_alone", lambda T, C: {"fk_wolff": 1}),
    ("sa_sw", lambda T, C: {"packed_sa": T, "fk_label": T}),
    ("qmc_wolff", lambda T, C: {"fk_wolff": 1}),
    ("qmc_sw", lambda T, C: {"generic_qmc": T, "fk_label": T}),
    ("qmc_sw_bath", lambda T, C: {"fk_label": 1}),
    ("wc2", lambda T, C: {"generic_qmc_bath": T, "fk_line": T * C}),
    ("wc3", lambda T, C: {"fk_line": T * C})])
def test_cluster_solvers_launch_their_kernels(cuda, name, launches):
    """Each cluster solver on the card (problem, state and schedules there
    by default): valid spins, the same result twice, and exactly its
    route's launches."""
    prob = _generic("chimera", cuda)
    steps, P = 7, 4
    gen = torch.Generator().manual_seed(0)
    s0 = sa.random_state(gen, prob.nspins, batch=(5,))
    sched = schedules.linear(2.0, 0.3, steps)
    lut = schedules.bath_lookuptable(P, 0.01)
    calls = {
        "sa_wolff": lambda g: sa.anneal_wolff(prob, sched, s0, g),
        "sa_wolff_alone": lambda g: sa.anneal_wolff(prob, sched, s0, g,
                                                    local_sweeps=False),
        "sa_sw": lambda g: sa.anneal_sw(prob, sched, s0, g,
                                        local_sweeps=True),
        "qmc_wolff": lambda g: qmc.anneal_wolff(
            prob, sched, torch.ones_like(sched), 0.3, qmc.replicate(s0, P),
            g, lookuptable=lut),
        "qmc_sw": lambda g: qmc.anneal_sw(
            prob, sched, torch.ones_like(sched), 0.3, qmc.replicate(s0, P),
            g, local_sweeps=True),
        "qmc_sw_bath": lambda g: qmc.anneal_sw(
            prob, sched, torch.ones_like(sched), 0.3, qmc.replicate(s0, P),
            g, lookuptable=lut),
        "wc2": lambda g: qmc.anneal_sw_bath(
            prob, sched, torch.ones_like(sched), 0.3, lut,
            qmc.replicate(s0, P), g, per_slice_seeds=False),
        "wc3": lambda g: qmc.anneal_sw_bath(
            prob, sched, torch.ones_like(sched), 0.3, lut,
            qmc.replicate(s0, P), g),
    }
    _build.reset_launches()
    out = calls[name](torch.Generator().manual_seed(1))
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == launches(
        steps, prob.num_colors)
    again = calls[name](torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    assert out.is_cuda and torch.equal(out, again)
    assert set(torch.unique(out).tolist()) <= {-1.0, 1.0}


@pytest.mark.parametrize("case", ["wolff", "sw_bath", "wc3", "classical_sw"])
def test_cluster_kernels_sample_exact_weights(cuda, case):
    """The cluster solvers' engines on the card against the exact weights
    of the two-spin problems (tests/gibbs_check.py), z < 5."""
    if case == "classical_sw":
        prob = gibbs.two_spin_problem(0.9, (0.4, -0.3), cuda)
        f = gibbs.sample_cluster_sa("sw", prob, 1024, 1.3, 40, False)
        exact = gibbs.generic_sa_weights(prob, 1.3)
    else:
        prob = gibbs.two_spin_problem(0.7, (0.2, 0.0), cuda)
        P, temp, gamma, alpha = 2, 0.9, 0.6, 0.4
        if case == "wolff":
            f = gibbs.sample_cluster_qmc("wolff", prob, 1024, P, temp, gamma,
                                         41, alpha=alpha)
        elif case == "sw_bath":
            f = gibbs.sample_cluster_qmc("sw", prob, 1024, P, temp, gamma,
                                         42, alpha=alpha)
        else:
            f = gibbs.sample_cluster_qmc("line", prob, 1024, P, temp, gamma,
                                         43, alpha=alpha,
                                         per_slice_seeds=True)
        exact = gibbs.generic_qmc_weights(prob, P, temp,
                                          gibbs.jperp(gamma, P, temp),
                                          bath=gibbs.bath_matrix(P, alpha))
    z, d = gibbs.z_scores(f, exact, gibbs.SAMPLES)
    assert z < 5.0, (z, d)


def test_cluster_wrappers_refuse_on_the_card(cuda):
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck

    ck_, pg, confs, b, jp, teff = _cluster_case("torus10", 65, cuda,
                                                steps=2)
    lut = schedules.bath_lookuptable(65, 0.1, device=cuda)
    p_pair, p_t = ck.line_tables(lut, jp, 1.0, 65, cuda)
    with pytest.raises(ValueError, match="P <= 64"):
        ck.line_phase(pg, b, jp, p_t, 0, 1.0, lut, p_pair, confs, 1, 0, 0,
                      True)
    with pytest.raises(ValueError, match="symmetric"):
        ck.sw_anneal(pg, b, jp, teff, confs, 1,
                     torch.arange(64, dtype=torch.float32, device=cuda))
    with pytest.raises(ValueError):
        ck.wolff_anneal(pg, b, jp, teff.double(), confs, 1)


# ------------------------------------------------------------ the samplers


def _per_chain_case(kernel, dev, rng):
    """(start, run(fn, table, x)) of a per-chain kernel at a small shape:
    kernel A at 1000 chains (31 words of 32 and a ragged last word of 8)
    on the 10 x 10 torus, B at P = 4,
    the packed kernels on the 9 x 9 torus's checkerboard (not a proper
    coloring) and the dense kernel at N = 64, block 16."""
    def pm1(*shape):
        return torch.as_tensor(rng.choice([-1.0, 1.0], size=shape).astype(
            np.float32), device=dev)
    lat = instances.gaussian_torus(10, 0, device=dev)
    sl = split_ops.build_split(lat)
    pg = packed_ops.packed_from_lattice(instances.gaussian_torus(9, 0,
                                                                 device=dev))
    if kernel == "split_sa":
        start = tuple(x.contiguous() for x in split_ops.pack_classical(
            sl, pm1(1000, 100)))
        return start, lambda fn, tab, x, t0=0: fn(sl, tab, *x, 5, step0=t0)
    if kernel == "split_qmc":
        start = tuple(x.contiguous() for x in split_ops.pack_qmc(
            sl, pm1(5, 4, 100)))
        return start, lambda fn, tab, x, t0=0: fn(
            sl, torch.ones(tab.shape[0], device=dev), tab, 1.5, x, 5, True,
            step0=t0)
    if kernel == "packed_sa":
        return pm1(7, 81), lambda fn, tab, x, t0=0: fn(pg, tab, x, 5,
                                                       step0=t0)
    if kernel == "generic_qmc":
        return pm1(5, 3, 81), lambda fn, tab, x, t0=0: fn(
            pg, torch.ones(tab.shape[0], device=dev), tab, 1.5, x, 5, True,
            step0=t0)
    dp = gibbs_sk(dev)
    return pm1(9, 64), lambda fn, tab, x, t0=0: fn(dp, tab, x, 5, block=16,
                                                   step0=t0)


def gibbs_sk(dev):
    return instances.sk_model(64, rng=0, device=dev)[0]


_PER_CHAIN = {
    "split_sa": (sk.sa_split_anneal, sk.sa_split_anneal_ref,
                 "sa_split_chain"),
    "split_qmc": (sk.qmc_split_anneal, sk.qmc_split_anneal_ref,
                  "qmc_split_chain"),
    "packed_sa": (gk.packed_sa_anneal, gk.packed_sa_anneal_ref,
                  "packed_sa_chain"),
    "generic_qmc": (gk.generic_qmc_anneal, gk.generic_qmc_anneal_ref,
                    "generic_qmc_chain"),
    "dense_sa": (dk.dense_sa_anneal, dk.dense_sa_anneal_ref,
                 "dense_sa_chain"),
}


@pytest.mark.parametrize("kernel", sorted(_PER_CHAIN))
@pytest.mark.parametrize("route", ["cluster", "phased"])
def test_per_chain_kernels_equal_plain(cuda, kernel, route):
    """Each kernel's per-chain instantiation, a (steps, chains) table that
    repeats one row and one that changes every step, equals its plain
    version; A and B also on their per-phase kernels."""
    if route == "phased" and kernel not in ("split_sa", "split_qmc"):
        pytest.skip("only kernels A and B have per-phase kernels")
    rng = np.random.default_rng(3)
    start, run = _per_chain_case(kernel, cuda, rng)
    chains = (start[0] if isinstance(start, tuple) else start).shape[0]
    steps = 4
    row = torch.linspace(0.4, 2.5, chains, device=cuda)[None, :].expand(
        steps, -1)
    every = (row * torch.linspace(1.0, 0.5, steps, device=cuda)[:, None]
             ).contiguous()
    wrapper, plain, key = _PER_CHAIN[kernel]
    ctx = gibbs.phased_route if route == "phased" else contextlib.nullcontext
    for tab in (row, every):
        _build.reset_launches()
        with ctx():
            out = run(wrapper, tab, start)
        launched = {k: v for k, v in _build.LAUNCHES.items() if v}
        ref = run(plain, tab, start)
        torch.cuda.synchronize()
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        assert all(torch.equal(a, b) for a, b in zip(outs, refs))
        assert list(launched) == [key + ("_phased" if route == "phased"
                                         else "")]


@pytest.mark.parametrize("kernel", ["split_sa", "split_qmc"])
def test_split_kernels_take_a_step_offset(cuda, kernel):
    """Kernels A and B gained step0 for the samplers' per-exchange
    launches: two one-step launches at step0 0 and 1 equal one two-step
    launch, shared and per chain; step0 1 draws other uniforms."""
    rng = np.random.default_rng(4)
    start, run = _per_chain_case(kernel, cuda, rng)
    chains = start[0].shape[0]
    wrapper = _PER_CHAIN[kernel][0]
    for tab in (torch.full((2,), 1.1, device=cuda),
                torch.linspace(0.4, 2.5, chains, device=cuda)[None, :]
                .expand(2, -1)):
        whole = run(wrapper, tab, start)
        split = run(wrapper, tab[1:], run(wrapper, tab[:1], start), 1)
        other = run(wrapper, tab[1:], run(wrapper, tab[:1], start), 0)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(whole, split))
        assert not all(torch.equal(a, b) for a, b in zip(whole, other))


@pytest.mark.parametrize("chains", [1, 33, 1000])
def test_chain_bit_words_run_and_read_as_the_halves(cuda, chains):
    """The samplers' split engine keeps kernel A's chain-bit words: the
    words entry equals sa_split_anneal on the halves, and the energy kernel
    on the words equals, bitwise, the energy kernel on the unpacked halves
    (and its plain version on these +/-1 couplings)."""
    rng = np.random.default_rng(6)
    lat = instances.random_2d_lattice(10, rng=2, dist="pm1", lattice=True,
                                      device=cuda)[0]
    sl = split_ops.build_split(lat)
    a, b = (x.contiguous() for x in split_ops.pack_classical(
        sl, torch.as_tensor(rng.choice([-1.0, 1.0], size=(chains, 100))
                            .astype(np.float32), device=cuda)))
    geometry = sk.words_geometry(sl, chains, cuda)
    C = geometry[0]
    tab = torch.linspace(0.4, 2.5, chains, device=cuda)[None, :].expand(
        3, -1)
    words = sk.sa_split_words_anneal(sl, tab, sk.pack_chain_bits(a, C),
                                     sk.pack_chain_bits(b, C), chains,
                                     geometry, 5, step0=2)
    halves = sk.sa_split_anneal(sl, tab, a, b, 5, step0=2)
    assert all(torch.equal(sk.unpack_chain_bits(w, chains, C), h)
               for w, h in zip(words, halves))
    _build.reset_launches()
    e = sk.words_energy(sl, *words, chains, C)
    assert _build.LAUNCHES["energy_bits"] == 1
    torch.cuda.synchronize()
    assert torch.equal(e, energy_ops.halves_energy(sl, *halves))
    assert torch.equal(e, sk.words_energy_ref(sl, *words, chains, C))


@pytest.mark.parametrize("graph", ["torus10", "glass3d", "rg_fields"])
def test_houdayer_kernel_equals_plain(cuda, graph):
    from montecarlosolvers_tpu_torch.ops import cluster as cl
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck

    prob = _generic(graph, cuda)
    rng = np.random.default_rng(5)
    s1, s2 = (torch.as_tensor(rng.choice([-1.0, 1.0], size=(
        6, prob.nspins)).astype(np.float32), device=cuda) for _ in range(2))
    _build.reset_launches()
    got = ck.houdayer_move(prob, s1, s2, 9, 4)
    assert _build.LAUNCHES["houdayer"] == 1
    want = cl.houdayer_move_ref(prob, s1, s2, 9, 4)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(got[0] * got[1], s1 * s2)
    assert int(got[2].sum()) > 0


def test_samplers_equal_their_plain_route_and_launch_their_kernels(cuda):
    """pt.sample, sample_icm and pa.sample on a +/-1 lattice: the same run
    on the kernels and on the plain versions (gibbs_check.plain_route),
    bitwise; the kernel run's launches are its route's."""
    from montecarlosolvers_tpu_torch.solvers import pa, pt

    lat = instances.random_2d_lattice(8, rng=1, dist="pm1", lattice=True,
                                      device=cuda)[0]
    ladder = schedules.geometric(0.5, 2.5, 4, device=cuda)

    def states(seed, shape):
        g = torch.Generator().manual_seed(seed)
        return (torch.randint(0, 2, shape, generator=g).float() * 2
                - 1).to(cuda)
    runs = (
        (lambda: pt.sample(lat, ladder, states(1, (2, 4, 64)),
                           torch.Generator().manual_seed(1), 10),
         {"sa_split_chain": 10, "energy_bits": 10}),
        (lambda: pt.sample_icm(lat, ladder, states(2, (2, 4, 64)),
                               torch.Generator().manual_seed(2), 6),
         {"sa_split_chain": 6, "energy_bits": 6, "houdayer": 3}),
        (lambda: pa.sample(lat, pa.beta_linear(2.0, 8, device=cuda),
                           states(3, (32, 64)),
                           torch.Generator().manual_seed(3), beta0=0.0),
         {"sa_split": 8, "energy_bits": 8}),
    )
    for run, want in runs:
        _build.reset_launches()
        kernel = run()
        launched = {k: v for k, v in _build.LAUNCHES.items() if v}
        with gibbs.plain_route():
            plain = run()
        torch.cuda.synchronize()
        assert launched == want
        assert all(torch.equal(a, b) for a, b in zip(kernel, plain))


def _compat_cases(rng):
    """(name, call(nbs, seed, state) in place, a fresh state, the launches
    of its route) of the compat shims on an 8 x 8 open glass's table."""
    from montecarlosolvers_tpu_torch import compat

    _, (rows, cols, vals) = instances.random_2d_lattice(8, rng=3,
                                                        device="cpu")
    nbs = compat.GenerateNeighbors(
        64, instances.dense_matrix(64, rows, cols, vals), 4)
    steps, P = 12, 4
    A, B = np.linspace(2.0, 1e-8, steps), np.ones(steps)
    lut = schedules.bath_lookuptable(P, 0.05, device="cpu").numpy()
    nbs4d = np.broadcast_to(nbs, (steps,) + nbs.shape).copy()
    nbs4d[..., 1] *= 1.0 + 0.1 * rng.normal(size=nbs4d.shape[:-1])
    spins = lambda: rng.choice([-1.0, 1.0], size=(5, 64))  # noqa: E731
    confs = lambda: rng.choice([-1.0, 1.0], size=(64, P))  # noqa: E731
    angles = lambda: rng.uniform(0, np.pi, size=(5, 64))  # noqa: E731
    colors = compat._problem(nbs, "cpu").num_colors
    return nbs, [
        ("Anneal", lambda s, seed, x: compat.Anneal(
            np.linspace(3, 0.1, steps), 1, x, nbs, seed=seed), spins,
         {"packed_sa": 1}),
        ("NoisyAnneal", lambda s, seed, x: compat.NoisyAnneal(
            np.linspace(3, 0.1, steps), 1, x, nbs4d, seed=seed), spins,
         {"packed_sa_noisy": 1}),
        ("QuantumAnnealGlobal", lambda s, seed, x: compat.QuantumAnnealGlobal(
            A, B, 1, 0.25, x, nbs, seed=seed), confs, {"generic_qmc": 1}),
        ("DissipativeQuantumAnnealGlobal",
         lambda s, seed, x: compat.DissipativeQuantumAnnealGlobal(
             A, B, 1, 0.25, lut, x, nbs, seed=seed), confs,
         {"generic_qmc_bath": 1}),
        ("QuantumAnnealWCL", lambda s, seed, x: compat.QuantumAnnealWCL(
            A, B, 1, 0.25, x, nbs, seed=seed), confs, {"fk_wolff": 1}),
        ("DissipativeQuantumAnnealWC3",
         lambda s, seed, x: compat.DissipativeQuantumAnnealWC3(
             A, B, 1, 0.25, lut, x, nbs, seed=seed), confs,
         {"fk_line": steps * colors}),
        ("SpinVectorMonteCarloTFCompact",
         lambda s, seed, x: compat.SpinVectorMonteCarloTFCompact(
             A, B, 1, 0.1, x, nbs, seed=seed), angles, {"packed_svmc": 1}),
        ("NoisySVMCTF", lambda s, seed, x: compat.NoisySVMCTF(
            A, B, 1, 0.1, x, nbs4d, seed=seed), angles,
         {"packed_svmc_noisy": 1}),
    ]


def test_compat_shims_equal_their_plain_route_on_the_card(cuda):
    """Each shim, with no device given, runs on the card on its route's
    kernels, and writes the same result in place as the same call on the
    plain versions (gibbs_check.plain_route) from the same seed."""
    rng = np.random.default_rng(0)
    _, cases = _compat_cases(rng)
    for name, call, state, want in cases:
        x0 = state()
        a, b = x0.copy(), x0.copy()
        _build.reset_launches()
        call(None, 17, a)
        torch.cuda.synchronize()
        launched = {k: v for k, v in _build.LAUNCHES.items() if v}
        with gibbs.plain_route():
            call(None, 17, b)
        assert launched == want, name
        assert np.array_equal(a, b), name
        assert not np.array_equal(a, x0), name


def test_checkpointed_anneal_resumes_bitwise_on_the_card(cuda, tmp_path):
    from montecarlosolvers_tpu_torch.utils.checkpoint import (
        CheckpointedAnneal, generator)

    lat = instances.gaussian_torus(16, 0, device=cuda)
    s0 = sa.random_state(torch.Generator().manual_seed(0), 256,
                         batch=(40,), device=cuda)
    sched = schedules.linear(3.0, 0.1, 120, device=cuda)

    def solver(seg, state, gen):
        return sa.anneal(lat, seg, state, gen)

    _build.reset_launches()
    full = CheckpointedAnneal(str(tmp_path / "a.npz"), segment=30).run(
        solver, sched, s0, seed=4)
    assert _build.LAUNCHES["sa_split"] == 4
    ck = CheckpointedAnneal(str(tmp_path / "b.npz"), segment=30)
    state = s0
    for i in range(2):
        state = solver(sched[i * 30:(i + 1) * 30], state,
                       generator(cuda, 4, i))
        ck._save(i + 1, state)
    resumed = ck.run(solver, sched, s0, seed=4)
    assert resumed.device.type == "cuda"
    assert torch.equal(full, resumed)
