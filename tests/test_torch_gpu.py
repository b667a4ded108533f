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
Generic PIQMC and the generic bath equal their plain versions on both
routes, the cluster route and the "_wide" first kernels (forced), on a
small chimera and the 9 x 9 odd torus's improper checkerboard; fk_line
past P = 64 (rows of several words in shared memory, P = 65 to 200) and
fk_label on a bath table not symmetric in ring distance equal theirs.
Generic SA equals its plain version on both routes, the cluster route
(chains as the bits of a word over a cluster of CTAs) and the first
kernel ("_wide", forced, and by shape on a graph of 130 classes), at 1 to
1280 chains, on the odd torus's improper checkerboard, with energies,
temperatures a chain, per-step tables, a disorder batch, chain0 and
one-step launches, and at the last ring the cluster route holds; the
dense in-block kernel equals its plain version at 1 to 16 warps a CTA,
blocks of 7 to 128, h added in the kernel or given in the fields.
Generic SVMC equals its plain version on both routes, the cluster route
(a chain's rotors in the shared memory of a cluster of CTAs, at its
rule's R and at R = 1, 4 and 16) and the first kernel ("_wide", forced,
and by shape on a graph of 130 classes), TF and uniform proposals,
energies, per-step tables, chain0, the odd torus's improper
checkerboard, and the two routes agree bitwise on proper packings; the
chain-bit energy kernel equals the halves kernel bitwise at 1 to 7040
chains and every K (chains of a group a CTA); generic SVMC's rule of
size sends small class phases to the first kernel under the plain key.
Generic SVMC's first kernel, forced onto the 81 x 81 checkerboard (not
proper), reads each phase's same-class neighbours from its snapshot and
equals the plain version. The Houdayer move's cluster kernel (at its
rule's R, at R = 1 and 16, with its union-find in device memory) and the
first kernel equal houdayer_move_ref bitwise on random_3d_lattice(12) (24
pairs), the 80 x 80 torus's generic form (48) and a chimera, at pair0 0
and 100003; the move in place on the packed engine's state equals its
plain version with a permuted ror; past 619,152 sites the first kernel
runs by shape; solve("icm") moves in place with no unpack or repack.
fk_line's cluster kernel (one launch an anneal) and its first kernel
(forced, one launch a phase) equal line_phase_ref phase by phase, WC2 and
WC3, chain0 0 and 100003, and solve("piqmc_sw") at the profiled cell's
shape makes one fk_line launch.
"""

import contextlib

import numpy as np
import pytest
import torch

import gibbs_check as gibbs
from montecarlosolvers_tpu_torch import convert, schedules
from montecarlosolvers_tpu_torch.models import instances
from montecarlosolvers_tpu_torch.models.ising import IsingProblem
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


@pytest.mark.parametrize("route", ["cluster", "wide"])
@pytest.mark.parametrize("kernel,graph,slices,opts", [
    ("generic_qmc", "chimera", 20, {"global_moves": True}),
    ("generic_qmc", "odd_torus9", 5, {"global_moves": True}),
    ("generic_qmc", "odd_torus9", 40, {"global_moves": False}),
    ("generic_qmc_bath", "chimera", 20, {"global_moves": True}),
    ("generic_qmc_bath", "odd_torus9", 40, {"global_moves": True}),
    ("generic_qmc_bath", "odd_torus9", 5,
     {"global_moves": True, "colored": True}),
    ("generic_qmc_bath", "chimera", 33,
     {"global_moves": False, "colored": True}),
])
def test_generic_kernels_both_routes_equal_plain(cuda, monkeypatch, route,
                                                 kernel, graph, slices,
                                                 opts):
    """Generic PIQMC and the generic bath on both of their routes, the
    cluster route (csrc/generic_words.cuh, the slices as words over a
    cluster of CTAs) and the first kernel of each file ("_wide", forced
    here by a rule of shape that holds nothing), against the plain
    version: a small chimera and the 9 x 9 odd torus's improper
    checkerboard, P = 5 to 40 (one and two words a site), sequential and
    colored. States bitwise, one launch a call under the route's key."""
    if route == "wide":
        monkeypatch.setattr(gk, "generic_qmc_geometry",
                            lambda *a, **k: None)
        monkeypatch.setattr(gk, "generic_qmc_bath_geometry",
                            lambda *a, **k: None)
    steps, chains = 8, 3
    prob = _bath_problem(graph, cuda)
    case = gibbs.generic_case(kernel, prob, chains, steps, slices,
                              bscale=0.8, alpha=0.3, **opts)
    wrapper, plain, key = gibbs.GENERIC[kernel]
    _build.reset_launches()
    out = case["run"](wrapper, None)
    want = key + ("_wide" if route == "wide" else "")
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {want: 1}
    ref = case["run"](plain, None)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert float((out != case["start"]).float().mean()) > 0.05


# the last chain each rule keeps on the cluster route at P = 40: one chain
# of a ring of n sites (two classes) over 16 CTAs, each asking, with the
# energies, for all 232,448 bytes of shared memory a block may take
@pytest.mark.parametrize("kernel,n", [("generic_qmc", 232080),
                                      ("generic_qmc_bath", 225680)])
def test_generic_kernels_at_the_cluster_routes_last_shape(cuda, kernel, n):
    rows = np.arange(n)
    vals = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    prob = IsingProblem.from_edges(n, rows, (rows + 1) % n, vals,
                                   device=cuda)
    rule = (gk.generic_qmc_bath_geometry if kernel == "generic_qmc_bath"
            else gk.generic_qmc_geometry)
    assert rule(1, n, 40, 2) == (16, gk.WORD_THREADS)
    assert rule(1, n + 2, 40, 2) is None
    case = gibbs.generic_case(kernel, prob, 1, 2, 40, bscale=0.8,
                              alpha=0.3)
    nr = gk.word_layout(case["pg"], 16)[3]
    assert gk.words_smem_bytes(40, nr, True, kernel == "generic_qmc_bath") \
        == _build.SMEM_LIMIT_BYTES
    wrapper, plain, key = gibbs.GENERIC[kernel]
    es, es_plain = (torch.full((2, 1), float("nan"), device=cuda)
                    for _ in range(2))
    _build.reset_launches()
    out = case["run"](wrapper, None)
    collected = case["run"](wrapper, es)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {key: 2}
    ref = case["run"](plain, es_plain)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert torch.equal(collected, out)
    assert float((out != case["start"]).float().mean()) > 0.05
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
    ("dup", 3, "local", True), ("dup", 2, "full", False),
    ("torus10", 8, "local", "asym"), ("rg_fields", 5, "local", "asym"),
    ("chimera", 5, "full", "asym"), ("dup", 4, "local", "asym"),
    ("torus80", 8, "local", "asym")])
def test_wolff_kernel_equals_plain(cuda, graph, P, rule, bath):
    """csrc/fk_wolff.cu against wolff_anneal_ref on the card: spins
    bitwise, the cluster sizes it counts equal the plain version's, one
    launch an anneal; the duplicate-slot table and P = 1 included, and a
    bath table not symmetric in ring distance ("asym"), whose cluster is
    the seed's directed reach."""
    ck, pg, confs, b, jp, teff = _cluster_case(graph, P, cuda)
    lut = (_asymmetric_table(P, 0.3, cuda) if bath == "asym"
           else schedules.bath_lookuptable(P, 0.3, device=cuda) if bath
           else None)
    assert ck.ring_asymmetric(lut) == (bath == "asym")
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


def _asymmetric_table(P, alpha, dev):
    """bath_lookuptable(P, alpha) with its bath matrix's entries above the
    diagonal scaled by 1.5: lut[d - 1] for ring offsets d < P / 2 (the
    pairs (a, b) with b - a = d read lut[d - 1], those with a - b = d read
    lut[P - 1 - d]), so lut[d - 1] != lut[P - 1 - d]."""
    lut = schedules.bath_lookuptable(P, alpha, device=dev).clone()
    d = torch.arange(1, P, device=dev)
    return torch.where(2 * d < P, lut * 1.5, lut).contiguous()


@pytest.mark.parametrize("graph,P,bath", [
    ("torus10", 1, False), ("rg_fields", 1, False), ("dup", 1, False),
    ("torus10", 2, True), ("chimera", 3, False), ("rg_fields", 5, True),
    ("dup", 4, True), ("torus10", 40, True), ("torus80", 8, False),
    ("torus10", 40, "asym"), ("chimera", 5, "asym"), ("dup", 4, "asym"),
    ("torus80", 8, "asym")])
def test_label_kernel_equals_plain(cuda, graph, P, bath):
    """csrc/fk_label.cu against sw_anneal_ref: the classical sweep at
    P = 1, the space-time one with and without a bath, each chain over the
    cluster `label_geometry` picks (the 80x80 torus at P = 8: 16 CTAs),
    labels in shared memory (test_cluster_kernels_at_the_shared_memory_
    limit takes device memory); a bath table not symmetric in ring
    distance ("asym"), whose one-way pairs the kernel relaxes as directed
    edges."""
    ck, pg, confs, b, jp, teff = _cluster_case(graph, P, cuda)
    classical = P == 1
    if classical:
        b, jp = torch.ones_like(b), torch.zeros_like(jp)
    lut = (_asymmetric_table(P, 0.3, cuda) if bath == "asym"
           else schedules.bath_lookuptable(P, 0.3, device=cuda) if bath
           else None)
    assert ck.ring_asymmetric(lut) == (bath == "asym")
    R, _, on_chip = ck.card_label_geometry("fk_label", confs.shape[0], P,
                                           pg.nspins, cuda, bool(bath),
                                           bath == "asym")
    assert on_chip and R == min(ck.CLUSTER_MAX, pg.nspins,
                                -(-gk.card_sms(cuda) // confs.shape[0]))
    _build.reset_launches()
    out = ck.sw_anneal(pg, b, jp, teff, confs, 12, lut, 1, classical)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "fk_label": 1}
    from montecarlosolvers_tpu_torch.ops import cluster as cl
    ref = cl.sw_anneal_ref(pg, b, jp, teff, confs, 12, lut, 1, classical)
    torch.cuda.synchronize()
    assert torch.equal(out, ref) and not torch.equal(out, confs)


def _both_cluster_kernels(ck, pg, confs, b, jp, teff, lut, classical):
    """(fk_wolff's spins, its cluster sizes, fk_label's spins) and the plain
    versions' on one input, with the launches each made."""
    from montecarlosolvers_tpu_torch.ops import cluster as cl

    vis, vis_ref = (torch.zeros(confs.shape[0], dtype=torch.int64,
                                device=confs.device) for _ in range(2))
    _build.reset_launches()
    wolff = ck.wolff_anneal(pg, b, jp, teff, confs, 14, "local", lut, 0,
                            vis)
    label = ck.sw_anneal(pg, b, jp, teff, confs, 15, lut, 0, classical)
    launched = {k: v for k, v in _build.LAUNCHES.items() if v}
    ref = (cl.wolff_anneal_ref(pg, b, jp, teff, confs, 14, "local", lut, 0,
                               vis_ref),
           cl.sw_anneal_ref(pg, b, jp, teff, confs, 15, lut, 0, classical))
    torch.cuda.synchronize()
    return (wolff, vis, label), (ref[0], vis_ref, ref[1]), launched


@pytest.mark.parametrize("R", [1, 16])
@pytest.mark.parametrize("graph,P,bath", [
    ("torus80", 8, True), ("torus80", 8, "asym"), ("chimera", 5, True),
    ("rg_fields", 1, False)])
def test_cluster_kernels_at_forced_cluster_sizes(cuda, monkeypatch, R,
                                                 graph, P, bath):
    """fk_wolff and fk_label with `label_geometry` forced to one CTA a
    chain and to 16 (`label_shape`: the threads and the place of the
    union-find at that R; at R = 1 the 80x80 torus's P = 8 chain is past a
    CTA's shared memory): bitwise their plain versions, one launch
    each."""
    ck, pg, confs, b, jp, teff = _cluster_case(graph, P, cuda)
    classical = P == 1
    if classical:
        b, jp = torch.ones_like(b), torch.zeros_like(jp)
    lut = (_asymmetric_table(P, 0.3, cuda) if bath == "asym"
           else schedules.bath_lookuptable(P, 0.3, device=cuda) if bath
           else None)
    used = []

    def forced(chains, P, n, asym=False, sms=ck.NUM_SMS, resident=None):
        used.append(ck.label_shape(R, P, n, asym))
        return used[-1]
    monkeypatch.setattr(ck, "label_geometry", forced)
    out, ref, launched = _both_cluster_kernels(ck, pg, confs, b, jp, teff,
                                               lut, classical)
    assert [u[0] for u in used] == [R, R]
    assert launched == {"fk_wolff": 1, "fk_label": 1}
    for x, y in zip(out, ref):
        assert torch.equal(x, y)
    assert not torch.equal(out[0], confs) and not torch.equal(out[2], confs)


@pytest.mark.parametrize("kernel,chains,P,bath", [
    ("fk_label", 8, 40, False), ("fk_label", 8, 40, True),
    ("fk_label", 64, 1, False), ("fk_wolff", 1, 40, False),
    ("fk_wolff", 16, 40, False), ("fk_wolff", 64, 1, False)])
def test_label_geometry_runs_the_chains_at_once(cuda, kernel, chains, P,
                                                bath):
    """At the timed shapes on the 80x80 torus's generic form, the R that
    card_label_geometry picks holds every chain's cluster at once (the
    card's cudaOccupancyMaxActiveClusters) and is the largest such R up to
    the SM count's rule; a larger R would leave chains waiting."""
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck

    n = 6400
    sms = gk.card_sms(cuda)
    resident = ck.card_resident(kernel, P, n, cuda, bath)
    R, threads, on_chip = ck.card_label_geometry(kernel, chains, P, n, cuda,
                                                 bath)
    first = ck.label_geometry(chains, P, n, False, sms)[0]
    assert R <= first and resident(R, threads, on_chip) >= chains
    for r in range(R + 1, first + 1):
        assert resident(*ck.label_shape(r, P, n, False, chains, sms)) < \
            chains


def _last_on_chip(chains, P, sms):
    """The most sites n of a P x n chain whose union-find label_geometry
    keeps in the CTAs' shared memory (fk_wolff's, fk_label's without
    `asym`), by bisection on the rule."""
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck

    lo, hi = 1, 10 ** 7
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = ((mid, hi) if ck.label_geometry(chains, P, mid, False,
                                                 sms)[2] else (lo, mid))
    return lo


@pytest.mark.parametrize("past", [0, 1])
def test_cluster_kernels_at_the_shared_memory_limit(cuda, past):
    """One chain on a ring of the last length whose union-find stays in
    the 16 CTAs' shared memory and on the first past it (its regions in
    device memory), P = 1, the classical schedule: fk_wolff and fk_label
    bitwise their plain versions, the Wolff cluster sizes too."""
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck

    sms = gk.card_sms(cuda)
    n = _last_on_chip(1, 1, sms) + past
    for kernel in ("fk_wolff", "fk_label"):
        R, _, on_chip = ck.card_label_geometry(kernel, 1, 1, n, cuda)
        assert R == ck.CLUSTER_MAX and on_chip == (past == 0)
    rows = np.arange(n)
    vals = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    prob = IsingProblem.from_edges(n, rows, (rows + 1) % n, vals,
                                   device=cuda)
    pg = packed_ops.build_packed(prob)
    rng = np.random.default_rng(4)
    confs = torch.as_tensor(rng.choice([-1.0, 1.0], size=(1, 1, n)).astype(
        np.float32), device=cuda)
    temps = schedules.linear(3.0, 0.5, 3, device=cuda)
    out, ref, launched = _both_cluster_kernels(
        ck, pg, confs, torch.ones_like(temps), torch.zeros_like(temps),
        temps, None, True)
    assert launched == {"fk_wolff": 1, "fk_label": 1}
    for x, y in zip(out, ref):
        assert torch.equal(x, y)
    assert not torch.equal(out[0], confs) and not torch.equal(out[2], confs)


@pytest.mark.parametrize("graph,P,per_slice_seeds", [
    ("torus10", 2, True), ("torus10", 2, False), ("torus10", 3, True),
    ("chimera", 5, False), ("rg_fields", 40, True), ("rg_fields", 40, False),
    ("dup", 33, True), ("torus10", 64, True), ("torus10", 64, False),
    ("torus10", 65, True), ("torus10", 65, False), ("chimera", 128, True),
    ("rg_fields", 128, False), ("dup", 200, True)])
def test_line_kernel_equals_plain(cuda, graph, P, per_slice_seeds):
    """csrc/fk_line.cu against line_phase_ref, one launch a color phase:
    P = 2 (the ring bond doubled), one and two slices a lane (P <= 64:
    the per-phase kernel, one warp a line, and the cluster kernel one
    phase a launch), and past P = 64 the rows of several words in shared
    memory (P = 65, 128, 200)."""
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
        "fk_line_wide" if P <= 64 else "fk_line_rows": 3 * pg.num_colors}
    torch.cuda.synchronize()
    assert torch.equal(out, ref) and not torch.equal(out, confs)
    if P > 64:
        return
    out = confs
    _build.reset_launches()
    for t in range(3):
        for color in range(pg.num_colors):
            out = ck.line_anneal(pg, b, jp, p_t, float(teff[0]), lut, p_pair,
                                 out, 13, per_slice_seeds, t0=t, steps=1,
                                 colors=range(color, color + 1), step0=4 + t)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "fk_line": 3 * pg.num_colors}
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


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
    ("wc2", lambda T, C: {"generic_qmc_bath": T, "fk_line": T}),
    ("wc2_alone", lambda T, C: {"fk_line": 1}),
    ("wc3", lambda T, C: {"fk_line": 1})])
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
        "wc2_alone": lambda g: qmc.anneal_sw_bath(
            prob, sched, torch.ones_like(sched), 0.3, lut,
            qmc.replicate(s0, P), g, per_slice_seeds=False,
            local_sweeps=False),
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
    """What the cluster wrappers still refuse: a P past fk_line's shared
    memory (LINE_MAX_SLICES = 921), a float64 schedule. P = 65 and a bath
    table not symmetric in ring distance now run (against their plain
    versions in the tests above)."""
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck

    P = ck.LINE_MAX_SLICES + 1
    ck_, pg, confs, b, jp, teff = _cluster_case("torus10", P, cuda,
                                                chains=1, steps=2)
    lut = schedules.bath_lookuptable(P, 0.1, device=cuda)
    p_pair, p_t = ck.line_tables(lut, jp, 1.0, P, cuda)
    with pytest.raises(ValueError, match="P <= 921"):
        ck.line_phase(pg, b, jp, p_t, 0, 1.0, lut, p_pair, confs, 1, 0, 0,
                      True)
    small = confs[:, :65].contiguous()
    lut65 = schedules.bath_lookuptable(65, 0.1, device=cuda)
    pp65, _ = ck.line_tables(lut65, jp, 1.0, 65, cuda)
    out = ck.line_phase(pg, b, jp, p_t, 0, 1.0, lut65, pp65, small, 1, 0, 0,
                        True)
    assert out.shape == small.shape
    asym = torch.arange(64, dtype=torch.float32, device=cuda) * 1e-3
    assert ck.sw_anneal(pg, b, jp, teff, small[:, :65], 1,
                        asym).shape == small.shape
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
         {"fk_line": 1}),
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


# ---- the parallel layer: chain offsets, the shard kernels, a one-rank mesh


def _offset_case(kind, dev):
    """(run, state): run(state, chain0) on the card for one engine of a
    chain-sharded solve, at a small width."""
    lat4 = instances.gaussian_torus(16, 0, device=dev)
    lat5 = instances.gaussian_torus(17, 0, device=dev)
    gen = lat4.to_generic()
    g = torch.Generator().manual_seed(5)

    def spins(*shape):
        return (torch.randint(0, 2, shape, generator=g).float() * 2
                - 1).to(dev)
    a = schedules.transverse_field(2.0, 1e-8, 12, device=dev)
    b = torch.ones_like(a)
    sched = schedules.linear(2.0, 0.1, 12, device=dev)
    lut = schedules.bath_lookuptable(8, 1e-2, device=dev)
    runs = {
        "split_sa": (lambda s, c0: sk.anneal_lattice_split(
            lat4, sched, s, 9, chain0=c0), spins(70, 256)),
        "plane_sa": (lambda s, c0: pk.anneal_lattice(
            lat5, sched, s, 9, chain0=c0), spins(70, 289)),
        "split_qmc": (lambda s, c0: sk.anneal_lattice_qmc_split(
            lat4, a, b, 0.3, s, 9, chain0=c0), spins(8, 8, 256)),
        "plane_qmc": (lambda s, c0: pk.anneal_lattice_qmc(
            lat4, a, b, 0.3, s, 9, chain0=c0), spins(8, 5, 256)),
        "bath": (lambda s, c0: sk.anneal_lattice_qmc_bath_split(
            lat4, a, b, 0.3, lut, s, 9, global_moves=True, chain0=c0),
            spins(8, 8, 256)),
        "bath_colored": (lambda s, c0: sk.anneal_lattice_qmc_bath_split(
            lat4, a, b, 0.3, lut, s, 9, global_moves=True, colored=True,
            chain0=c0), spins(8, 8, 256)),
        "packed_sa": (lambda s, c0: gk.anneal_packed(
            gen, sched, s, 9, chain0=c0), spins(70, 256)),
        "generic_qmc": (lambda s, c0: gk.anneal_generic_qmc(
            gen, a, b, 0.3, s, 9, chain0=c0), spins(8, 8, 256)),
        "generic_bath": (lambda s, c0: gk.anneal_generic_qmc_bath(
            gen, a, b, 0.3, lut, s, 9, global_moves=True, chain0=c0),
            spins(8, 8, 256)),
    }
    return runs[kind]


@pytest.mark.parametrize("kind", ["split_sa", "plane_sa", "split_qmc",
                                  "plane_qmc", "bath", "bath_colored",
                                  "packed_sa", "generic_qmc",
                                  "generic_bath"])
@pytest.mark.parametrize("phased", [False, True])
def test_kernel_chain_offset_is_the_unsharded_rows(cuda, kind, phased):
    """A block of chains run with its chain0 equals those rows of the
    whole batch's run, on the cluster and on the per-phase kernels."""
    run, state = _offset_case(kind, cuda)
    route = gibbs.phased_route() if phased else contextlib.nullcontext()
    with route:
        full = run(state, 0)
        c0 = 3 if state.shape[0] > 8 else 2
        block = run(state[c0:c0 + 5].contiguous(), c0)
    assert torch.equal(full[c0:c0 + 5], block)


def test_shard_kernels_equal_plain(cuda):
    """S1-S4 on a slab of 3 rows of a 12-row state, against their plain
    versions, bitwise: halo rows of their own, and rows of the slab
    itself (the ring of one rank, which passes views)."""
    from montecarlosolvers_tpu_torch.ops import shard_kernels as shk

    lat = instances.gaussian_torus(16, 0, device=cuda)
    sl = split_ops.build_split(lat)
    g = torch.Generator().manual_seed(2)

    def spins(*shape):
        return (torch.randint(0, 2, shape, generator=g).float() * 2
                - 1).to(cuda)
    b = torch.full((4,), 0.7, device=cuda)
    jp = schedules.jperp(torch.linspace(2.0, 0.5, 4, device=cuda), 2.4)
    q = [spins(5, 3, sl.nh) for _ in range(4)]
    for phase in (0, 1):
        for halos in ((spins(5, sl.nh), spins(5, sl.nh)),
                      shk.halo_rows(q, phase)):
            want = shk.shard_phase_ref(sl, b, jp, 2.4, q, halos, phase, 2, 11,
                                       7, 3, 12)
            got = shk.shard_phase(sl, b, jp, 2.4, [x.clone() for x in q],
                                  halos, phase, 2, 11, 7, 3, 12)
            assert all(torch.equal(x, y) for x, y in zip(got, want))
    for color in (0, 1):
        part = shk.shard_line_part(sl, q, color)
        assert torch.equal(part, shk.shard_line_part_ref(sl, q, color))
        want = shk.shard_line_accept_ref(b, 2.4, part * 0.3, q, color, 1, 11,
                                         7)
        got = shk.shard_line_accept(sl, b, 2.4, part * 0.3,
                                    [x.clone() for x in q], color, 1, 11, 7)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    for prob in (lat.to_generic(), instances.gaussian_torus(17, 0, device=cuda)):
        pg = (packed_ops.packed_from_lattice(prob) if prob.nspins == 289
              else packed_ops.build_packed(prob))
        s = spins(4, 3, pg.nspins)
        m = piqmc_ops.spacetime_num_phases(pg.num_colors, 12)
        for up, dn in ((spins(4, pg.nspins), spins(4, pg.nspins)),
                       (s[:, -1], s[:, 0])):
            for p in range(m):
                assert torch.equal(
                    shk.generic_shard_phase(pg, b, jp, 2.4, s, up, dn, p, m,
                                            2, 11, 7, 3, 12),
                    shk.generic_shard_phase_ref(pg, b, jp, 2.4, s, up, dn, p,
                                                m, 2, 11, 7, 3, 12))
        for c in range(pg.num_colors):
            part = shk.generic_shard_line_part(pg, b, s, c, 1)
            assert torch.equal(part, shk.generic_shard_line_part_ref(
                pg, b, s, c, 1))
            assert torch.equal(
                shk.generic_shard_line_accept(pg, 2.4, part * 0.2, s.clone(),
                                              c, 1, 11, 7, 12),
                shk.generic_shard_line_accept_ref(pg, 2.4, part * 0.2, s, c,
                                                  1, 11, 7, 12))


def test_one_rank_mesh_equals_the_single_device_engines(cuda):
    """On a one-rank NCCL mesh chain sharding is the unsharded run, and
    the Trotter-sharded split engine is kernel B's run, line moves or not
    (one rank adds the line sums as kernel B does)."""
    from montecarlosolvers_tpu_torch.parallel import make_mesh, shard_chains
    from montecarlosolvers_tpu_torch.parallel import mesh as pmesh
    from montecarlosolvers_tpu_torch.parallel import trotter

    lat = instances.gaussian_torus(16, 0, device=cuda)
    gen = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    confs = qmc.replicate(sa.random_state(gen(), 256, batch=(6,),
                                          device=cuda), 8)
    a = schedules.transverse_field(2.0, 1e-8, 10, device=cuda)
    b = torch.ones_like(a)
    cmesh = make_mesh(chains=1)
    out = qmc.anneal(lat, a, b, 0.3, shard_chains(confs, cmesh), gen(),
                     global_moves=True)
    assert torch.equal(pmesh.full_tensor(out), qmc.anneal(
        lat, a, b, 0.3, confs, gen(), global_moves=True))
    rmesh = make_mesh(replica=1)
    for gm in (False, True):
        _build.reset_launches()
        out = trotter.anneal_sharded_split(lat, a, b, 0.3, confs, gen(),
                                           rmesh, global_moves=gm)
        assert _build.LAUNCHES["shard_phase"] == 2 * 10
        assert _build.LAUNCHES["shard_line_accept"] == (20 if gm else 0)
        assert torch.equal(pmesh.full_tensor(out), qmc.anneal(
            lat, a, b, 0.3, confs, gen(), global_moves=gm))


def _force_shard_routes(monkeypatch, route):
    """Force S5's and S7's route: "rule" leaves the rules of shape, an int
    R forces the cluster route over R CTAs (at most the graph's sites),
    "wide" S5's first kernel and S7's draw with its union-find in device
    memory at the rule's R."""
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck
    from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
    from montecarlosolvers_tpu_torch.ops import shard_kernels as shk

    if route == "rule":
        return
    if route == "wide":
        monkeypatch.setattr(shk, "card_shard_bath_geometry",
                            lambda *a, **k: None)
        rule = ck.card_shard_label_geometry
        monkeypatch.setattr(ck, "card_shard_label_geometry",
                            lambda *a, **k: (*rule(*a, **k)[:2], False))
        return

    def bath_shape(pg, chains, P, dev, int8):
        r = min(route, pg.nspins)
        return r, gk.word_threads(pg.nspins, r, pg.num_colors)

    def label_shape(P, ps, n, dev, bath):
        return ck.shard_label_shape(P, ps, n, min(route, n))
    monkeypatch.setattr(shk, "card_shard_bath_geometry", bath_shape)
    monkeypatch.setattr(ck, "card_shard_label_geometry", label_shape)


@pytest.mark.parametrize("route", ["rule", 1, 3, 16, "wide"])
def test_shard_rest_kernels_equal_plain(cuda, monkeypatch, route):
    """S5, S6 and S7 against their plain versions on a slab of 3 of 12
    rows, S5 and S7 on each route (the rules of shape, the cluster route at
    a forced R, S5's first kernel with S7's union-find in device memory):
    S5 every slice step on an IsingProblem
    and on an odd torus's improper checkerboard, chain0 = 7, with the
    gathered state as float32 and as int8, and at one rank on the slab
    itself; S6 a round from a seed with random messages (and random fresh
    sites of the other ranks with a bath), rules "local" and "full", its
    field sums and flip; S7 the draw, a round on random neighbour labels,
    the flip, without a bath, with one and on a table not symmetric in
    ring distance, on the slab (Ps < P) and on the whole ring (Ps = P),
    fields on. Each launch under its route's key."""
    from montecarlosolvers_tpu_torch.ops import cluster as cl
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops
    from montecarlosolvers_tpu_torch.ops import piqmc as piqmc_ops
    from montecarlosolvers_tpu_torch.ops import shard_kernels as shk

    _force_shard_routes(monkeypatch, route)
    wide = route == "wide"
    g = torch.Generator().manual_seed(5)

    def spins(*shape):
        return (torch.randint(0, 2, shape, generator=g).float() * 2
                - 1).to(cuda)
    P, k0 = 12, 3
    b = torch.full((4,), 0.8, device=cuda)
    jp = schedules.jperp(torch.linspace(2.0, 0.5, 4, device=cuda), 2.4)
    lut = schedules.bath_lookuptable(P, 0.3, device=cuda)
    bath = piqmc_ops.bath_matrix_of(lut, P, cuda)
    _build.reset_launches()
    for pg in (packed_ops.build_packed(instances.random_graph(
            30, 70, rng=2, with_fields=True, device=cuda)[0]),
               packed_ops.packed_from_lattice(
                   instances.gaussian_torus(5, 0, device=cuda))):
        full = spins(5, P, pg.nspins)
        for gathered in (full, full.to(torch.int8)):
            slab = full[:, k0:k0 + 3].contiguous()
            for kloc in range(3):
                want = shk.generic_shard_bath_slice_ref(
                    pg, b, jp, 2.4, bath, slab, full, kloc, k0 + kloc, 2, 11,
                    7)
                got = shk.generic_shard_bath_slice(
                    pg, b, jp, 2.4, bath, slab.clone(), gathered, kloc,
                    k0 + kloc, 2, 11, 7)
                assert torch.equal(got, want)
                slab = want
        whole = full.clone()
        want = shk.generic_shard_bath_slice_ref(pg, b, jp, 2.4, bath, whole,
                                                whole, 4, 4, 2, 11)
        got = shk.generic_shard_bath_slice(pg, b, jp, 2.4, bath, whole,
                                           whole, 4, 4, 2, 11)
        assert torch.equal(got, want)
    s5 = "generic_shard_bath_slice" + ("_wide" if wide else "")
    assert _build.LAUNCHES[s5] == 2 * (2 * 3 + 1)
    prob = instances.random_graph(30, 70, rng=2, with_fields=True,
                                  device=cuda)[0]
    pg = packed_ops.build_packed(prob)
    n = pg.nspins
    state = spins(1, n).expand(P, n).contiguous()
    state[:, :5] *= -1.0
    state[2:7, 7:12] *= -1.0
    rows = state[k0:k0 + 3].contiguous()
    up, dn = state[k0 - 1].contiguous(), state[k0 + 3].contiguous()
    words = -(-3 * n // 32)

    def msgs(p):
        return (torch.rand(n, generator=g) < p).to(torch.uint8).to(cuda)
    in_prev, in_next = msgs(0.2), msgs(0.2)
    ff = cl.pack_bits((torch.rand(4, 3 * n, generator=g) < 0.1)).reshape(
        -1).to(cuda)

    def step(x, rule, with_bath, first=k0, halo=(up, dn)):
        table = (_asymmetric_table(P, 0.3, cuda) if with_bath == "asym"
                 else lut if with_bath else None)
        return ck.ShardStep(pg, x, *halo, state if with_bath else None,
                            first, P, b, jp, 2.4, 2, 11, table, rule,
                            x[1, 4:5].clone(), asym=with_bath == "asym")
    for rule in ("local", "full"):
        for with_bath in (False, True):
            zero = torch.zeros(words, dtype=torch.int32, device=cuda)
            args = (in_prev, in_next, ff if with_bath else None, n + 4)
            got = ck.shard_wolff_round(step(rows, rule, with_bath),
                                       zero.clone(), *args)
            want = ck.shard_wolff_round_ref(step(rows, rule, with_bath),
                                            zero.clone(), *args)
            assert all(torch.equal(x, y) for x, y in zip(got, want))
            sums = ck.shard_wolff_sums(step(rows, rule, with_bath), got[0])
            assert torch.equal(sums, ck.shard_wolff_sums_ref(
                step(rows, rule, with_bath), got[0]))
            rows_full = torch.cat([sums] * 4)
            assert torch.equal(
                ck.shard_wolff_flip(step(rows.clone(), rule, with_bath),
                                    got[0], rows_full),
                ck.shard_wolff_flip_ref(step(rows, rule, with_bath), got[0],
                                        rows_full))
    # S7 also on a bath table not symmetric in ring distance: its one-way
    # pairs relaxed in the block, its cross-rank pulls kept directed; and
    # on the whole ring of one rank, where no round runs
    _build.reset_launches()
    for with_bath in (False, True, "asym"):
        st, ref = step(rows.clone(), "local", with_bath), step(
            rows, "local", with_bath)
        got, want = ck.shard_label_init(st), ck.shard_label_init_ref(ref)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        halo = [torch.randint(-1, P * n, (n,), generator=g).to(
            torch.int32).to(cuda) for _ in range(2)]
        fl = torch.randint(-1, P * n, (P, n), generator=g).to(
            torch.int32).to(cuda) if with_bath else None
        bond_up = msgs(0.5)
        rg = ck.shard_label_round(st, got[0].clone(), got[1], halo[0],
                                  bond_up, halo[1], fl)
        rw = ck.shard_label_round_ref(ref, want[0].clone(), want[1],
                                      halo[0], bond_up, halo[1], fl)
        assert all(torch.equal(x, y) for x, y in zip(rg, rw))
        assert torch.equal(ck.shard_label_flip(st, rg[0]),
                           ck.shard_label_flip_ref(ref, rw[0]))
        ring = (state[-1].contiguous(), state[0].contiguous())
        st, ref = (step(state.clone(), "local", with_bath, 0, ring),
                   step(state, "local", with_bath, 0, ring))
        got, want = ck.shard_label_init(st), ck.shard_label_init_ref(ref)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        assert torch.equal(ck.shard_label_flip(st, got[0]),
                           ck.shard_label_flip_ref(ref, want[0]))
    assert _build.LAUNCHES["shard_label"] == 6 + 9


def test_main_path_shapes_take_no_wide_shard_key(cuda):
    """At the shapes the parallel phase of chip_smoke.py runs (the 80x80
    torus, P = 40: the bath's 32 chains, one rank and a slab of 4; the
    cluster engines' one chain at one rank and a slab of 10), S5 and S7
    take the cluster route: their rules of shape give a cluster (S7's
    union-find in shared memory), and a
    step of each engine on the one-rank mesh launches no "_wide" key."""
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops
    from montecarlosolvers_tpu_torch.ops import shard_kernels as shk
    from montecarlosolvers_tpu_torch.parallel import make_mesh
    from montecarlosolvers_tpu_torch.parallel import mesh as pmesh
    from montecarlosolvers_tpu_torch.parallel import trotter

    torus = instances.gaussian_torus(80, 0, device=cuda)
    pg = packed_ops.packed_from_lattice(torus)
    for int8 in (False, True):
        assert shk.card_shard_bath_geometry(pg, 32, 40, cuda, int8) \
            is not None
    for ps in (40, 10, 4):
        for bath in (False, True):
            assert ck.card_shard_label_geometry(40, ps, 6400, cuda,
                                                bath)[2]
    gen = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    a = schedules.transverse_field(2.0, 1e-8, 2, device=cuda)
    b = torch.ones_like(a)
    lut = schedules.bath_lookuptable(40, 0.01, device=cuda)
    mesh = make_mesh(replica=1, device_type="cuda")
    confs = qmc.replicate(sa.random_state(gen(), 6400, batch=(32,),
                                          device=cuda), 40)
    _build.reset_launches()
    pmesh.full_tensor(trotter.anneal_sharded(
        torus, a, b, 1.0 / 40, confs, gen(), mesh, lookuptable=lut))
    one = confs[0].contiguous()
    for table in (None, lut):
        pmesh.full_tensor(trotter.anneal_sw_sharded(
            torus.to_generic(), a, b, 1.0 / 40, one, gen(), mesh,
            lookuptable=table))
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "generic_shard_bath_slice": 80, "shard_label": 8}


def test_one_rank_mesh_runs_the_rest_of_the_trotter_axis(cuda):
    """On a one-rank NCCL mesh the sharded bath equals the sequential
    generic bath kernel, and the sharded Wolff and SW engines equal
    fk_wolff and fk_label, bath bonds on (SW also on a bath table not
    symmetric in ring distance), each launching its shard kernel."""
    from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
    from montecarlosolvers_tpu_torch.parallel import make_mesh
    from montecarlosolvers_tpu_torch.parallel import mesh as pmesh
    from montecarlosolvers_tpu_torch.parallel import trotter

    lat = instances.gaussian_torus(9, 0, device=cuda)
    gen = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    confs = qmc.replicate(sa.random_state(gen(), 81, batch=(3,),
                                          device=cuda), 8)
    a = schedules.transverse_field(2.0, 1e-8, 6, device=cuda)
    b = torch.ones_like(a)
    lut = schedules.bath_lookuptable(8, 0.2, device=cuda)
    rmesh = make_mesh(replica=1)
    for gm in (False, True):
        _build.reset_launches()
        out = trotter.anneal_sharded(lat, a, b, 0.3, confs, gen(), rmesh,
                                     global_moves=gm, lookuptable=lut)
        assert _build.LAUNCHES["generic_shard_bath_slice"] == 8 * 6
        assert torch.equal(pmesh.full_tensor(out), gk.anneal_generic_qmc_bath(
            lat, a, b, 0.3, lut, confs, sa.draw_seed(gen()),
            global_moves=gm))
    for engine, single, kw in (
            (trotter.anneal_wolff_sharded, qmc.anneal_wolff,
             {"rule": "local", "lookuptable": lut}),
            (trotter.anneal_wolff_sharded, qmc.anneal_wolff,
             {"rule": "full", "lookuptable": lut}),
            (trotter.anneal_sw_sharded, qmc.anneal_sw, {"lookuptable": lut}),
            (trotter.anneal_sw_sharded, qmc.anneal_sw,
             {"lookuptable": _asymmetric_table(8, 0.2, cuda)})):
        _build.reset_launches()
        out = engine(lat, a, b, 0.3, confs[0], gen(), rmesh, **kw)
        assert (_build.LAUNCHES["shard_wolff"]
                + _build.LAUNCHES["shard_label"]) >= 2 * 6
        assert torch.equal(pmesh.full_tensor(out), single(
            lat, a, b, 0.3, confs[0], gen(), **kw))


# ---- the sharded samplers: five kernel offsets, the samplers on one rank


def _sampler_offset_case(kind, dev):
    """(run, state): run(state, chain0) -> tuple on the card for one of the
    five kernels that take a chain (pair) offset for the sharded samplers,
    at a small width."""
    lat4 = instances.gaussian_torus(16, 0, device=dev)
    lat5 = instances.gaussian_torus(17, 0, device=dev)
    gen4 = lat4.to_generic()
    g = torch.Generator().manual_seed(6)

    def angles(*shape):
        return (torch.rand(shape, generator=g) * 3.1415927).to(dev)

    def spins(*shape):
        return (torch.randint(0, 2, shape, generator=g).float() * 2
                - 1).to(dev)
    a = schedules.transverse_field(2.0, 1e-3, 12, device=dev)
    b = torch.ones_like(a)
    if kind == "split_svmc":
        return (lambda s, c0: (sk.anneal_lattice_svmc_split(
            lat4, a, b, 0.2, s, 9, tf=True, chain0=c0),), angles(40, 256))
    if kind == "plane_svmc":
        return (lambda s, c0: (pk.anneal_lattice_svmc(
            lat5, a, b, 0.2, s, 9, tf=True, chain0=c0),), angles(40, 289))
    if kind == "packed_svmc":
        return (lambda s, c0: (gk.anneal_packed_svmc(
            gen4, a, b, 0.2, s, 9, tf=True, chain0=c0),), angles(40, 256))
    if kind == "packed_svmc_tables":
        rng = np.random.default_rng(0)
        nbr_J = (gen4.nbr_J.cpu().numpy()[None] * (1 + 0.1 * rng.standard_normal(
            (12,) + tuple(gen4.nbr_J.shape)))).astype(np.float32)
        h = np.zeros((12, 256), dtype=np.float32)
        return (lambda s, c0: (gk.packed_noisy_svmc_scan(
            gen4, a, b, 0.2, nbr_J, h, s, 9, tf=True, chain0=c0),),
            angles(40, 256))
    dp = instances.sk_model(300, rng=0, device=dev)[0]
    temps = schedules.linear(2.0, 0.2, 6, device=dev)
    if kind in ("dense", "dense_per_chain"):
        def run(s, c0):
            t = temps
            if kind == "dense_per_chain":
                t = torch.linspace(0.5, 2.0, 40, device=dev)[
                    c0:c0 + s.shape[0]][None].expand(6, -1)
            return (dk.dense_sa_anneal(dp, t, s, 9, chain0=c0),)
        return run, spins(40, 300)
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck

    def houdayer(s, c0):
        return ck.houdayer_move(gen4, s[0].contiguous(), s[1].contiguous(),
                                9, 3, pair0=c0)
    return houdayer, spins(2, 40, 256)


@pytest.mark.parametrize("kind", ["split_svmc", "plane_svmc", "packed_svmc",
                                  "packed_svmc_tables", "dense",
                                  "dense_per_chain", "houdayer"])
def test_sampler_kernel_offsets_are_the_unsharded_rows(cuda, kind):
    """Kernels 4 and 7, packed SVMC (static and per-step tables), the dense
    in-block kernel (shared and per-chain temperatures) and the Houdayer
    move run a block of chains (pairs) 3..10 with its offset: equal to
    those rows of the whole batch's run (the dense anneal: to the block's
    own plain version with that offset, since its block products are
    matmuls of the block's row count) and to the plain version."""
    run, state = _sampler_offset_case(kind, cuda)
    c0, w = 3, 8
    cut = ((slice(None), slice(c0, c0 + w)) if kind == "houdayer"
           else (slice(c0, c0 + w),))
    block_state = state[cut].contiguous()
    full = run(state, 0)
    block = run(block_state, c0)
    with gibbs.plain_route():
        plain = run(block_state, c0)
    for f, b_, p in zip(full, block, plain):
        assert torch.equal(b_, p)
        if not kind.startswith("dense"):
            assert torch.equal(f[c0:c0 + w], b_)


def test_one_rank_mesh_runs_the_samplers(cuda):
    """On a one-rank NCCL mesh every sampler, svmc.anneal, both noisy
    anneals and the dense anneal take a chain-sharded state and equal the
    unsharded call bitwise, rates and log_z too, with the same launches."""
    from montecarlosolvers_tpu_torch.parallel import make_mesh, shard_chains
    from montecarlosolvers_tpu_torch.parallel import mesh as pmesh
    from montecarlosolvers_tpu_torch.solvers import pa, pt

    lat = instances.gaussian_torus(16, 0, device=cuda)
    gen4 = lat.to_generic()
    dp = instances.sk_model(200, rng=0, device=cuda)[0]
    g = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    s8 = sa.random_state(g(), 256, batch=(8,), device=cuda)
    temps = pt.geometric_ladder(0.5, 3.0, 8, device=cuda)
    gammas = torch.linspace(2.0, 0.3, 8, device=cuda)
    a = schedules.transverse_field(2.0, 1e-3, 10, device=cuda)
    th = svmc.random_state(g(), 256, batch=(8,), device=cuda)
    mesh = make_mesh(chains=1)
    cases = {
        "pt": (lambda s: pt.sample(lat, temps, s, g(), 20, swap_every=2,
                                   collect_energy=True), s8),
        "qpt": (lambda c: pt.sample_piqmc(lat, gammas, 0.5, c, g(), 10,
                                          global_moves=True),
                qmc.replicate(s8, 4)),
        "pa": (lambda s: pa.sample(lat, pa.beta_linear(
            2.0, 10, beta_start=0.0, device=cuda), s, g(), beta0=0.0,
            collect_stats=True), s8),
        "pa_adaptive": (lambda s: pa.sample_adaptive(lat, 1.0, s, g(),
                                                     max_steps=10), s8),
        "paq": (lambda c: pa.sample_piqmc(gen4, gammas, 0.5, c, g()),
                qmc.replicate(s8, 3)),
        "svmc": (lambda t: svmc.anneal(lat, a, torch.ones_like(a), 0.2, t,
                                       g(), tf=True), th),
        "sa_dense": (lambda s: sa.anneal(dp, schedules.linear(
            2.0, 0.1, 5, device=cuda), s, g()),
            sa.random_state(g(), 200, batch=(8,), device=cuda)),
    }
    for name, (run, state) in cases.items():
        _build.reset_launches()
        want = run(state)
        launched = {k: v for k, v in _build.LAUNCHES.items() if v}
        _build.reset_launches()
        got = run(shard_chains(state, mesh))
        assert {k: v for k, v in _build.LAUNCHES.items() if v} == launched
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for x, y in zip(want, got):
            if isinstance(x, dict):
                for k in x:
                    assert np.array_equal(np.asarray(torch.as_tensor(
                        x[k]).cpu()), np.asarray(torch.as_tensor(
                            y[k]).cpu())), (name, k)
            else:
                assert torch.equal(x, pmesh.full_tensor(y)), name


# ---- the rest of the parallel layer: cluster offsets, the disorder
# stride, the masked lattice engine, a one-rank mesh


def _cluster_offset_case(kind, dev):
    """(run(confs, chain0) on the card, confs) of one cluster kernel at a
    small width: fk_wolff (rules local and full, a bath), fk_label
    (classical, space-time, a bath) and fk_line (WC2, WC3)."""
    P = 1 if kind == "label_classical" else 6
    ck, pg, confs, b, jp, teff = _cluster_case("torus10", P, dev, chains=12)
    lut = schedules.bath_lookuptable(P, 0.3, device=dev) if P > 1 else None
    if P == 1:  # the classical sweep runs at B = 1, J_perp = 0
        b, jp = torch.ones_like(b), torch.zeros_like(jp)
    if kind.startswith("wolff"):
        rule = kind.split("_")[1]
        return (lambda c, c0: ck.wolff_anneal(pg, b, jp, teff, c, 11, rule,
                                              lut, 2, chain0=c0), confs)
    if kind.startswith("label"):
        classical = kind == "label_classical"
        return (lambda c, c0: ck.sw_anneal(
            pg, b, jp, teff, c, 11, None if classical else lut, 2,
            classical, chain0=c0), confs)
    p_pair, p_t = ck.line_tables(lut, jp, float(teff[0]), P, dev)

    def line(c, c0):
        return ck.line_anneal(pg, b, jp, p_t, float(teff[0]), lut, p_pair,
                              c, 11, kind == "line_wc3", steps=3, chain0=c0)
    return line, confs


@pytest.mark.parametrize("kind", ["wolff_local", "wolff_full", "label",
                                  "label_classical", "line_wc2", "line_wc3"])
def test_cluster_kernel_offsets_are_the_unsharded_rows(cuda, kind):
    """fk_wolff, fk_label and fk_line run a block of chains 3..9 with its
    chain0: equal to those rows of the whole batch's run and to the plain
    version with that offset."""
    run, confs = _cluster_offset_case(kind, cuda)
    c0, w = 3, 7
    block_state = confs[c0:c0 + w].contiguous()
    full = run(confs, 0)
    block = run(block_state, c0)
    with gibbs.plain_route():
        plain = run(block_state, c0)
    torch.cuda.synchronize()
    assert torch.equal(block, plain)
    assert torch.equal(full[c0:c0 + w], block)


def test_disorder_batch_is_one_packed_launch(cuda):
    """vmap_disorder(sa.anneal) on three realizations of the 16 x 16 torus
    is one packed SA launch whose realizations equal the solo masked
    anneals bitwise and the plain version's disorder stride."""
    from montecarlosolvers_tpu_torch.parallel import disorder

    probs = [instances.gaussian_torus(16, d, device=cuda).to_generic()
             for d in range(3)]
    stacked, axes = disorder.stack_problems(probs)
    states = sa.random_state(torch.Generator().manual_seed(1), 256,
                             batch=(3, 10), device=cuda)
    sched = schedules.linear(2.5, 0.1, 30, device=cuda)

    def gens():
        return [torch.Generator().manual_seed(40 + d) for d in range(3)]
    run = disorder.vmap_disorder(sa.anneal, axes)
    _build.reset_launches()
    out = run(stacked, sched, states, gens())
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "packed_sa": 1}
    with gibbs.plain_route():
        plain = run(stacked, sched, states, gens())
    assert torch.equal(out, plain)
    for d, (p, g) in enumerate(zip(probs, gens())):
        solo = sa.anneal(p, sched, states[d], g, engine="masked")
        assert torch.equal(out[d], solo), d


@pytest.mark.parametrize("L", [16, 17])
def test_masked_lattice_is_one_packed_launch(cuda, L):
    """sa.anneal(lattice, engine="masked") on the card is one packed SA
    launch on the checkerboard's packing (an odd torus: the improper
    template) and equals the masked plain version bitwise."""
    lat = instances.gaussian_torus(L, 0, device=cuda)
    s = sa.random_state(torch.Generator().manual_seed(2), L * L,
                        batch=(40,), device=cuda)
    sched = schedules.linear(2.5, 0.1, 20, device=cuda)
    _build.reset_launches()
    out = sa.anneal(lat, sched, s, torch.Generator().manual_seed(3),
                    engine="masked")
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "packed_sa": 1}
    with gibbs.plain_route():
        plain = sa.anneal(lat, sched, s, torch.Generator().manual_seed(3),
                          engine="masked")
    assert torch.equal(out, plain)


def test_one_rank_mesh_runs_the_cluster_solvers_and_disorder(cuda):
    """On a one-rank NCCL mesh the five cluster entry points take a
    chain-sharded state and equal the unsharded calls bitwise with the
    same launches, and run_disorder_sharded on a (1, 1) dcn_mesh equals
    vmap_disorder."""
    from montecarlosolvers_tpu_torch.parallel import (disorder, make_mesh,
                                                      multihost, shard_chains)
    from montecarlosolvers_tpu_torch.parallel import mesh as pmesh

    gen = instances.gaussian_torus(16, 0, device=cuda).to_generic()
    g = lambda: torch.Generator().manual_seed(6)  # noqa: E731
    s = sa.random_state(g(), 256, batch=(8,), device=cuda)
    c = qmc.replicate(s, 8)
    sched = schedules.linear(2.0, 0.1, 6, device=cuda)
    a = schedules.transverse_field(2.0, 1e-3, 6, device=cuda)
    b = torch.ones_like(a)
    lut = schedules.bath_lookuptable(8, 1e-2, device=cuda)
    cases = {
        "sa_wolff": (lambda x: sa.anneal_wolff(gen, sched, x, g()), s),
        "sa_sw": (lambda x: sa.anneal_sw(gen, sched, x, g(),
                                         local_sweeps=True), s),
        "qmc_wolff": (lambda x: qmc.anneal_wolff(gen, a, b, 0.1, x, g(),
                                                 lookuptable=lut), c),
        "qmc_sw": (lambda x: qmc.anneal_sw(gen, a, b, 0.1, x, g()), c),
        "qmc_sw_bath": (lambda x: qmc.anneal_sw_bath(
            gen, a, b, 0.1, lut, x, g(), per_slice_seeds=False), c),
    }
    mesh = make_mesh(chains=1)
    for name, (run, state) in cases.items():
        _build.reset_launches()
        want = run(state)
        launched = {k: v for k, v in _build.LAUNCHES.items() if v}
        _build.reset_launches()
        got = pmesh.full_tensor(run(shard_chains(state, mesh)))
        assert {k: v for k, v in _build.LAUNCHES.items() if v} == launched
        assert torch.equal(want, got), name
    probs = [instances.gaussian_torus(16, d, device=cuda).to_generic()
             for d in range(2)]
    states = sa.random_state(g(), 256, batch=(2, 6), device=cuda)
    stacked, axes = disorder.stack_problems(probs)
    want = disorder.vmap_disorder(sa.anneal, axes)(
        stacked, sched, states, [g(), g()])
    got = multihost.run_disorder_sharded(
        sa.anneal, probs, sched, states, [g(), g()], multihost.dcn_mesh())
    assert torch.equal(want, pmesh.full_tensor(got))


# ---- generic SA over a thread-block cluster, the dense kernel redesigned


def _sa_problem(name, dev):
    """Generic SA's problems: the generic graphs, a lattice's checkerboard
    packing (the odd torus's is not a proper coloring) and a complete graph
    of 130 sites, whose 130 classes no slot code holds."""
    if name == "complete130":
        rows, cols = np.triu_indices(130, k=1)
        vals = np.random.default_rng(3).standard_normal(rows.size)
        return IsingProblem.from_edges(130, rows, cols,
                                       vals.astype(np.float32), device=dev)
    return _bath_problem(name, dev)


def _sa_inputs(pg, dev, chains, steps, mode, seed=0):
    """(start spins, run(fn, energies) -> spins, launch key) of packed SA
    in `mode`: "static", "energies", "per_chain" (a temperature a chain
    and step), "noisy" (per-step tables, two sweeps a row), "disorder" (3
    realizations of the graph's couplings, each its own hash seed),
    "chain0" (uids from chain 100003) or "step0" (each sweep its own
    launch, the hash counting it as step0 = t)."""
    rng = np.random.default_rng(seed)
    n = pg.nspins
    start = torch.as_tensor(rng.choice([-1.0, 1.0], size=(chains, n))
                            .astype(np.float32), device=dev)
    temps = schedules.linear(3.0, 0.1, steps, device=dev)
    key = "packed_sa"
    kw = {}
    if mode == "per_chain":
        temps = (temps[:, None] * torch.linspace(
            0.5, 2.0, chains, device=dev)[None, :]).contiguous()
        key = "packed_sa_chain"
    elif mode == "noisy":
        xi = rng.standard_normal((steps // 2,) + tuple(pg.nbr_J.shape))
        jt = (pg.nbr_J[None] * torch.as_tensor(
            1.0 + 0.1 * xi, dtype=torch.float32, device=dev)).contiguous()
        ht = (pg.h[None] + torch.as_tensor(
            0.1 * rng.standard_normal((steps // 2, n)), dtype=torch.float32,
            device=dev)).contiguous()
        kw["tables"] = (jt, ht, 2)
        key = "packed_sa_noisy"
    elif mode == "disorder":
        xi = rng.standard_normal((3,) + tuple(pg.nbr_J.shape))
        jd = (pg.nbr_J[None] * torch.as_tensor(
            1.0 + 0.3 * xi, dtype=torch.float32, device=dev)).contiguous()
        hd = pg.h[None].expand(3, n).contiguous()
        kw["disorder"] = (jd, hd, [5, 6, 7])
    elif mode == "chain0":
        kw["chain0"] = 100003

    def run(fn, es=None):
        if mode == "step0":
            s = start
            for t in range(steps):
                s = fn(pg, temps[t:t + 1], s, 11, step0=t)
            return s
        return fn(pg, temps, start, 11, energies=es, **kw)
    return start, run, key


@pytest.mark.parametrize("route", ["cluster", "wide"])
@pytest.mark.parametrize("graph,chains,mode", [
    ("torus10", 1, "static"), ("torus10", 33, "static"),
    ("torus10", 1280, "static"), ("odd_torus9", 40, "static"),
    ("rg9", 70, "energies"), ("chimera", 5, "energies"),
    ("odd_torus9", 96, "energies"), ("rg_fields", 64, "per_chain"),
    ("odd_torus9", 384, "per_chain"), ("rg_fields", 48, "noisy"),
    ("torus10", 96, "disorder"), ("torus10", 120, "disorder"),
    ("chimera", 40, "chain0"), ("torus10", 37, "step0"),
])
def test_packed_sa_both_routes_equal_plain(cuda, monkeypatch, route, graph,
                                           chains, mode):
    """Generic SA on both of its routes, the cluster route (csrc/
    generic_words.cuh's SA mode: chains as the bits of a word over a
    cluster of CTAs; its rule of size, which sends these small graphs to
    the first kernel, answering no) and the file's first kernel ("_wide",
    forced here by a rule of shape that holds nothing), against the plain
    version: one
    chain, a ragged last group, 1280 chains, the odd torus's improper
    checkerboard, energies, a temperature a chain (384: 8 chains a word),
    per-step tables, a disorder batch of 32 and of 40 chains a
    realization, chain0 and one-step launches. Spins bitwise, energies within
    ENERGY_RTOL * (sum |J| + sum |h|), one launch a call under the
    route's key."""
    if route == "wide":
        monkeypatch.setattr(gk, "packed_sa_geometry", lambda *a, **k: None)
    else:
        monkeypatch.setattr(gk, "packed_sa_one_cta", lambda *a, **k: False)
    steps = 10
    prob = _sa_problem(graph, cuda)
    pg = gibbs.packed_of(prob)
    start, run, key = _sa_inputs(pg, cuda, chains, steps, mode)
    if route == "cluster":
        d_chains = chains // 3 if mode == "disorder" else 0
        geometry = gk.packed_sa_geometry(chains, pg.nspins, pg.num_colors,
                                         d_chains=d_chains)
        assert geometry is not None
        if d_chains:
            assert d_chains % geometry[0] == 0
    es, es_plain = ((torch.full((steps, chains), float("nan"), device=cuda)
                     for _ in range(2)) if mode == "energies"
                    else (None, None))
    _build.reset_launches()
    out = run(gk.packed_sa_anneal, es)
    want = key + ("_wide" if route == "wide" else "")
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        want: steps if mode == "step0" else 1}
    ref = run(gk.packed_sa_anneal_ref, es_plain)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert float((out != start).float().mean()) > 0.05
    if es is not None:
        assert torch.equal(out, run(gk.packed_sa_anneal))
        assert torch.isfinite(es).all()
        assert float((es - es_plain).abs().max()) <= \
            gibbs.ENERGY_RTOL * gibbs.problem_scale(prob)


@pytest.mark.parametrize("graph,chains,mode,one_cta", [
    ("chimera16", 32, "static", True), ("glass12", 64, "per_chain", True),
    ("chimera16", 16, "step0", True), ("torus80", 32, "static", False),
    ("torus80", 24, "per_chain", False),
])
def test_packed_sa_rule_of_size_picks_the_kernel(cuda, monkeypatch, graph,
                                                 chains, mode, one_cta):
    """Generic SA's rule of size on the card: chimera_graph(16) (three
    classes of about 683 sites) and random_3d_lattice(12) (864 a class)
    run the file's first kernel, one CTA a chain, the 80 x 80 torus's
    generic form (3200 a class) the cluster route; both under the plain
    launch key, bitwise the plain version. The library's two entry points
    are watched to see which one the wrapper called."""
    prob = {"chimera16": lambda: instances.chimera_graph(
                16, rng=0, device=cuda)[0],
            "glass12": lambda: instances.random_3d_lattice(
                12, rng=0, device=cuda)[0],
            "torus80": lambda: instances.gaussian_torus(
                80, seed=0, device=cuda).to_generic()}[graph]()
    pg = gibbs.packed_of(prob)
    assert gk.packed_sa_one_cta(pg.nspins, pg.num_colors) is one_cta
    lib = _build.library("packed_sa")
    called = []
    for entry in ("packed_sa_anneal", "packed_sa_words_anneal"):
        def spy(*a, entry=entry, fn=getattr(lib, entry)):
            called.append(entry)
            return fn(*a)
        monkeypatch.setattr(lib, entry, spy)
    steps = 6
    start, run, key = _sa_inputs(pg, cuda, chains, steps, mode)
    _build.reset_launches()
    out = run(gk.packed_sa_anneal)
    calls = steps if mode == "step0" else 1
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {key: calls}
    assert called == calls * ["packed_sa_anneal" if one_cta
                              else "packed_sa_words_anneal"]
    assert torch.equal(out, run(gk.packed_sa_anneal_ref))
    assert float((out != start).float().mean()) > 0.05


def test_packed_sa_takes_the_wide_route_by_shape(cuda):
    """A graph of more than 127 classes is past the cluster route's slot
    code: packed SA runs the first kernel there, by its rule of shape, and
    equals the plain version."""
    prob = _sa_problem("complete130", cuda)
    pg = gibbs.packed_of(prob)
    assert pg.num_colors == 130
    assert gk.packed_sa_geometry(8, pg.nspins, pg.num_colors) is None
    start, run, _ = _sa_inputs(pg, cuda, 8, 6, "static")
    _build.reset_launches()
    out = run(gk.packed_sa_anneal)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "packed_sa_wide": 1}
    assert torch.equal(out, run(gk.packed_sa_anneal_ref))


def test_packed_sa_at_the_cluster_routes_last_shape(cuda):
    """One chain of a ring of 463,984 sites (two classes) over 16 CTAs,
    each asking, with the energies, for all 232,448 bytes of shared
    memory a block may take; two sites more take the first kernel."""
    n = 463984
    rows = np.arange(n)
    vals = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    prob = IsingProblem.from_edges(n, rows, (rows + 1) % n, vals,
                                   device=cuda)
    assert gk.packed_sa_geometry(1, n, 2) == (1, 16, gk.SA_THREADS)
    assert gk.packed_sa_geometry(1, n + 2, 2) is None
    pg = gibbs.packed_of(prob)
    assert gk.sa_words_smem_bytes(gk.word_layout(pg, 16)[3]) \
        == _build.SMEM_LIMIT_BYTES
    start, run, _ = _sa_inputs(pg, cuda, 1, 3, "energies")
    es, es_plain = (torch.full((3, 1), float("nan"), device=cuda)
                    for _ in range(2))
    _build.reset_launches()
    out = run(gk.packed_sa_anneal, es)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "packed_sa": 1}
    ref = run(gk.packed_sa_anneal_ref, es_plain)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert float((es - es_plain).abs().max()) <= \
        gibbs.ENERGY_RTOL * gibbs.problem_scale(prob)


@pytest.mark.parametrize("warps", [1, 2, 4, 8])
@pytest.mark.parametrize("N,chains,block,per_chain,start", [
    (2048, 1024, 128, False, 128), (2048, 64, 128, True, 0),
    (300, 37, 100, False, 200), (1001, 130, 7, True, 994),
    (70, 5, 70, False, 0),
])
def test_dense_block_kernel_equals_plain(cuda, monkeypatch, warps, N, chains,
                                         block, per_chain, start):
    """One in-block launch of csrc/dense_sa.cu at 1 to 8 warps (chains) a
    CTA, WARPS included, against its plain version: the block's products
    from torch.matmul and the padded h added inside,
    B = 128, 100 (the tile's rows not 16-byte aligned: 4-byte copies), 7
    and 70, ragged warps and CTAs, a temperature a chain; spins bitwise,
    and the same with the fields given whole and a zero h."""
    dp = instances.sk_model(N, rng=N, device=cuda)[0]
    dp = type(dp)(J=dp.J, h=torch.as_tensor(
        np.random.default_rng(1).standard_normal(N).astype(np.float32),
        device=cuda))
    rng = np.random.default_rng(N + chains)
    s0 = torch.as_tensor(rng.choice([-1.0, 1.0], size=(chains, N))
                         .astype(np.float32), device=cuda)
    Jp, hp, sp = dk.ds.padded(dp.J, dp.h, s0, block)
    temps = schedules.linear(2.0, 0.2, 3, device=cuda)
    if per_chain:
        temps = (temps[:, None] * torch.linspace(
            0.5, 2.0, chains, device=cuda)[None, :]).contiguous()
    monkeypatch.setattr(dk, "WARPS", warps)
    prod = dk.ds.block_product(sp, Jp, start, block)
    fields = prod + hp[start:start + block]
    _build.reset_launches()
    got = dk.dense_sa_block(sp.clone(), prod, hp, Jp, start, temps, 1, 9, 2,
                            5)
    whole = dk.dense_sa_block(sp.clone(), fields, torch.zeros_like(hp), Jp,
                              start, temps, 1, 9, 2, 5)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "dense_sa_chain" if per_chain else "dense_sa": 2}
    ref = dk.dense_sa_block_ref(sp.clone(), prod, hp, Jp, start, temps, 1,
                                9, 2, 5)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(whole, ref)
    cols = slice(start, start + block)
    assert float((ref[:, cols] != sp[:, cols]).float().mean()) > 0.05


# ------------------------------------------- generic SVMC over a cluster


def _svmc_inputs(pg, dev, chains, steps, mode, seed=0):
    """(start angles, run(fn, energies) -> angles, launch key) of generic
    SVMC in `mode`: "static", "energies", "noisy" (per-step tables, two
    sweeps a row) or "chain0" (uids from chain 100003); A 3 -> 1e-8, B =
    0.9, T = 0.05."""
    n = pg.nspins
    start = _angles((chains, n), dev, seed)
    a = schedules.linear(3.0, 1e-8, steps, device=dev)
    b = torch.full_like(a, 0.9)
    key, kw = "packed_svmc", {}
    if mode == "noisy":
        r = np.random.default_rng(seed + 1)
        rows = steps // 2
        jt = (pg.nbr_J[None] * torch.as_tensor(
            1 + 0.1 * r.standard_normal((rows,) + tuple(pg.nbr_J.shape)),
            dtype=torch.float32, device=dev)).contiguous()
        ht = (pg.h[None] * torch.as_tensor(
            1 + 0.1 * r.standard_normal((rows, n)), dtype=torch.float32,
            device=dev)).contiguous()
        kw["tables"] = (jt, ht, 2)
        key = "packed_svmc_noisy"
    elif mode == "chain0":
        kw["chain0"] = 100003

    def run(fn, es=None, tf=True):
        return fn(pg, a, b, 0.05, start, 7, tf, energies=es, **kw)
    return start, run, key


@pytest.mark.parametrize("route", ["cluster", "wide"])
@pytest.mark.parametrize("graph,chains,tf,mode,R", [
    ("torus10", 1, True, "static", None),
    ("torus10", 33, False, "static", None),
    ("torus10", 256, True, "static", None),
    ("rg9", 7, True, "energies", None),
    ("rg_fields", 6, False, "energies", None),
    ("chimera", 40, True, "noisy", None),
    ("rg_fields", 9, False, "noisy", None),
    ("torus10", 9, True, "chain0", None),
    ("chimera", 12, True, "static", 1),
    ("torus10", 12, False, "energies", 4),
    ("glass3d", 5, True, "static", 16),
])
def test_packed_svmc_both_routes_equal_plain(cuda, monkeypatch, route, graph,
                                             chains, tf, mode, R):
    """Generic SVMC on both of its routes, the cluster route
    (packed_svmc_cluster_kernel: a chain's rotors in the shared memory of
    a cluster of CTAs, at its rule's R or at a forced one; its rule of
    size, which sends these small graphs to the first kernel, answering
    no) and the file's first kernel ("_wide", forced here by a rule of
    shape that holds nothing), against the plain version: TF and uniform
    proposals, one
    chain to 256, energies, per-step tables, chain0. Angles as the SVMC
    checks hold them, energies within ENERGY_RTOL * (sum |J| + sum |h|),
    one launch a call under the route's key; on these proper packings
    the two routes agree bitwise."""
    prob = _generic(graph, cuda)
    pg = gibbs.packed_of(prob)
    if route == "wide":
        monkeypatch.setattr(gk, "packed_svmc_geometry", lambda *a, **k: None)
    else:
        monkeypatch.setattr(gk, "packed_svmc_one_cta", lambda *a, **k: False)
        if R is not None:
            monkeypatch.setattr(gk, "packed_svmc_geometry", lambda *a, **k: (
                R, gk.svmc_threads(pg.nspins, R, pg.num_colors)))
    steps = 12
    start, run, key = _svmc_inputs(pg, cuda, chains, steps, mode)
    es, es_plain = ((torch.full((steps, chains), float("nan"), device=cuda)
                     for _ in range(2)) if mode == "energies"
                    else (None, None))
    _build.reset_launches()
    out = run(gk.packed_svmc_anneal, es, tf)
    want = key + ("_wide" if route == "wide" else "")
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {want: 1}
    ref = run(gk.packed_svmc_anneal_ref, es_plain, tf)
    torch.cuda.synchronize()
    _assert_angles_equal(out, ref, start)
    if route == "cluster":
        monkeypatch.setattr(gk, "packed_svmc_geometry", lambda *a, **k: None)
        assert torch.equal(out, run(gk.packed_svmc_anneal, None, tf))
    if es is not None:
        assert torch.isfinite(es).all()
        assert float((es - es_plain).abs().max()) <= \
            gibbs.ENERGY_RTOL * gibbs.problem_scale(prob)


@pytest.mark.parametrize("R", [None, 1, 16])
def test_packed_svmc_cluster_route_on_an_improper_packing(cuda, monkeypatch,
                                                          R):
    """The 9 x 9 odd torus's checkerboard couples sites of one class: the
    cluster route reads them from its snapshot of the phase's start, as
    the plain version does, at its rule's R and at R = 1 and 16."""
    pg = gibbs.packed_of(_bath_problem("odd_torus9", cuda))
    assert not pg.proper
    if R is not None:
        monkeypatch.setattr(gk, "packed_svmc_geometry", lambda *a, **k: (
            R, gk.svmc_threads(pg.nspins, R, pg.num_colors)))
    start, run, key = _svmc_inputs(pg, cuda, 16, 10, "energies")
    es, es_plain = (torch.full((10, 16), float("nan"), device=cuda)
                    for _ in range(2))
    _build.reset_launches()
    out = run(gk.packed_svmc_anneal, es)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {key: 1}
    ref = run(gk.packed_svmc_anneal_ref, es_plain)
    torch.cuda.synchronize()
    _assert_angles_equal(out, ref, start)
    assert float((es - es_plain).abs().max()) <= \
        gibbs.ENERGY_RTOL * float(pg.nbr_J.abs().sum() / 2 + pg.h.abs().sum())


@pytest.mark.parametrize("graph,chains,one_cta", [
    ("torus16", 32, True), ("chimera16", 128, True), ("glass12", 32, False),
    ("torus80", 8, False),
])
def test_packed_svmc_rule_of_size_picks_the_kernel(cuda, monkeypatch, graph,
                                                   chains, one_cta):
    """Generic SVMC's rule of size on the card: the 16 x 16 torus's generic
    form (128 sites a class) and chimera_graph(16) (three classes of about
    683) run the file's first kernel, one CTA a chain,
    random_3d_lattice(12) (864 a class) and the 80 x 80 torus's generic
    form the cluster route; both under the plain launch key, equal to the
    plain version. The library's two entry points are watched to see
    which one the wrapper called."""
    prob = {"torus16": lambda: instances.gaussian_torus(
                16, seed=0, device=cuda).to_generic(),
            "chimera16": lambda: instances.chimera_graph(
                16, rng=0, device=cuda)[0],
            "glass12": lambda: instances.random_3d_lattice(
                12, rng=0, device=cuda)[0],
            "torus80": lambda: instances.gaussian_torus(
                80, seed=0, device=cuda).to_generic()}[graph]()
    pg = gibbs.packed_of(prob)
    assert gk.packed_svmc_one_cta(pg.nspins, pg.num_colors) is one_cta
    lib = _build.library("packed_svmc")
    called = []
    for entry in ("packed_svmc_anneal", "packed_svmc_cluster_anneal"):
        def spy(*a, entry=entry, fn=getattr(lib, entry)):
            called.append(entry)
            return fn(*a)
        monkeypatch.setattr(lib, entry, spy)
    start, run, key = _svmc_inputs(pg, cuda, chains, 6, "static")
    _build.reset_launches()
    out = run(gk.packed_svmc_anneal)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {key: 1}
    assert called == ["packed_svmc_anneal" if one_cta
                      else "packed_svmc_cluster_anneal"]
    _assert_angles_equal(out, run(gk.packed_svmc_anneal_ref), start)


def test_packed_svmc_main_path_takes_the_cluster_route(cuda):
    """The main path's shape, 256 chains on the 80 x 80 torus's generic
    form, runs the cluster route under "packed_svmc" and equals the plain
    version."""
    prob = instances.gaussian_torus(80, 0, device=cuda).to_generic()
    pg = gibbs.packed_of(prob)
    assert gk.card_packed_svmc_geometry(pg, 256, cuda) is not None
    start, run, key = _svmc_inputs(pg, cuda, 256, 6, "static")
    _build.reset_launches()
    out = run(gk.packed_svmc_anneal)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {key: 1}
    _assert_angles_equal(out, run(gk.packed_svmc_anneal_ref), start)


def test_packed_svmc_takes_the_wide_route_by_shape(cuda):
    """A graph of more than 127 classes is past the cluster route's slot
    code: generic SVMC runs the first kernel there, by its rule of shape,
    and equals the plain version."""
    pg = gibbs.packed_of(_sa_problem("complete130", cuda))
    assert pg.num_colors == 130
    assert gk.packed_svmc_geometry(8, pg.nspins, pg.num_colors) is None
    start, run, _ = _svmc_inputs(pg, cuda, 8, 6, "static")
    _build.reset_launches()
    out = run(gk.packed_svmc_anneal)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "packed_svmc_wide": 1}
    _assert_angles_equal(out, run(gk.packed_svmc_anneal_ref), start)


@pytest.mark.parametrize("chains", [1, 7, 384, 1024, 7040])
def test_words_energy_equals_the_halves_kernel_at_every_k(cuda, monkeypatch,
                                                          chains):
    """The chain-bit energy kernel at every K (chains of a group a CTA)
    that divides kernel A's C at this many chains equals the energy
    kernel on the unpacked halves bitwise, one launch a call; the rule's
    K is one of them."""
    lat = instances.gaussian_torus(80, 0, device=cuda)
    sl = split_ops.build_split(lat)
    rng = np.random.default_rng(chains)
    a, b = (x.contiguous() for x in split_ops.pack_classical(
        sl, torch.as_tensor(rng.choice([-1.0, 1.0], size=(chains, 6400))
                            .astype(np.float32), device=cuda)))
    C = sk.chain_word_bits(chains)
    words = (sk.pack_chain_bits(a, C), sk.pack_chain_bits(b, C))
    want = energy_ops.halves_energy(sl, a, b)
    ks = [k for k in sk.ENERGY_CHAINS_A_CTA if C % k == 0]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert sk.words_energy_geometry(chains, C, sms) in ks
    for k in ks:
        monkeypatch.setattr(sk, "words_energy_geometry", lambda *_, k=k: k)
        _build.reset_launches()
        e = sk.words_energy(sl, *words, chains, C)
        assert {k_: v for k_, v in _build.LAUNCHES.items() if v} == {
            "energy_bits": 1}
        torch.cuda.synchronize()
        assert torch.equal(e, want), k


# ---- generic SVMC's first kernel on an improper packing, the Houdayer
# move over a cluster and in place, the line clusters in one launch


def test_packed_svmc_first_kernel_on_an_improper_packing(cuda, monkeypatch):
    """The 81 x 81 torus's checkerboard (its wrap pairs share a class)
    forced to the file's first kernel: each phase reads a same-class
    neighbour from its snapshot of the phase's start, so the angles are
    the plain version's as the SVMC checks hold them, and the energies."""
    pg = packed_ops.packed_from_lattice(instances.gaussian_torus(81, 0,
                                                                 device=cuda))
    assert not pg.proper
    monkeypatch.setattr(gk, "packed_svmc_geometry", lambda *a, **k: None)
    start, run, key = _svmc_inputs(pg, cuda, 64, 20, "energies")
    es, es_plain = (torch.full((20, 64), float("nan"), device=cuda)
                    for _ in range(2))
    _build.reset_launches()
    out = run(gk.packed_svmc_anneal, es)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        key + "_wide": 1}
    ref = run(gk.packed_svmc_anneal_ref, es_plain)
    torch.cuda.synchronize()
    _assert_angles_equal(out, ref, start)
    assert float((es - es_plain).abs().max()) <= \
        gibbs.ENERGY_RTOL * float(pg.nbr_J.abs().sum() / 2 + pg.h.abs().sum())


def _houdayer_graph(name, dev):
    return {"glass12": lambda: instances.random_3d_lattice(12, rng=0,
                                                           device=dev)[0],
            "torus80": lambda: instances.gaussian_torus(80, 0, device=dev)
            .to_generic(),
            "chimera": lambda: _generic("chimera", dev)}[name]()


@pytest.mark.parametrize("graph,pairs", [("glass12", 24), ("torus80", 48),
                                         ("chimera", 5)])
@pytest.mark.parametrize("pair0", [0, 100003])
def test_houdayer_routes_equal_plain(cuda, monkeypatch, graph, pairs, pair0):
    """The Houdayer move's cluster kernel at its rule's R and at forced
    R = 1 and 16, and the first kernel (forced), against houdayer_move_ref:
    spins and flipped counts bitwise, one launch under each route's
    key."""
    from montecarlosolvers_tpu_torch.ops import cluster as cl
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck

    prob = _houdayer_graph(graph, cuda)
    n = prob.nspins
    rng = np.random.default_rng(pairs + pair0)
    s1, s2 = (torch.as_tensor(rng.choice([-1.0, 1.0], size=(pairs, n))
                              .astype(np.float32), device=cuda)
              for _ in range(2))
    want = cl.houdayer_move_ref(prob, s1, s2, 41, 7, pair0)
    rule = ck.card_houdayer_geometry(pairs, n, cuda)
    for geometry, key in ((rule, "houdayer"),
                          (ck.label_shape(1, 1, n)[:2], "houdayer"),
                          (ck.label_shape(16, 1, n)[:2], "houdayer"),
                          (None, "houdayer_wide")):
        monkeypatch.setattr(ck, "card_houdayer_geometry",
                            lambda *a, g=geometry, **k: g)
        _build.reset_launches()
        got = ck.houdayer_move(prob, s1, s2, 41, 7, pair0=pair0)
        assert {k: v for k, v in _build.LAUNCHES.items() if v} == {key: 1}
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), geometry
    assert int(want[2].sum()) > 0


@pytest.mark.parametrize("graph,batch,M,pair0", [
    ("glass12", 1, 24, 0), ("glass12", 2, 12, 100003), ("torus80", 1, 48, 0),
    ("chimera", 3, 4, 5)])
def test_houdayer_in_place_route_equals_plain(cuda, graph, batch, M, pair0):
    """The move on the packed engine's state, in place through ror and the
    packing's site ids, equals its plain version (unpack, the move,
    repack) bitwise, with a permuted ror, and the site-order route on the
    same pairs."""
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck

    prob = _houdayer_graph(graph, cuda)
    pg = packed_ops.build_packed(prob)
    n = prob.nspins
    rng = np.random.default_rng(M)
    full = torch.as_tensor(rng.choice([-1.0, 1.0], size=(batch * 2 * M, n))
                           .astype(np.float32), device=cuda)
    state = packed_ops.pack_state(pg, full).contiguous()
    ror = torch.as_tensor(np.stack([np.stack([rng.permutation(M)
                                              for _ in range(2)])
                                    for _ in range(batch)]), device=cuda)
    want, want_f = ck.houdayer_move_packed_ref(prob, pg, state, ror, 29, 9,
                                               pair0)
    moved = state.clone()
    _build.reset_launches()
    got, f = ck.houdayer_move_packed(prob, pg, moved, ror, 29, 9, pair0)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"houdayer": 1}
    torch.cuda.synchronize()
    assert got.data_ptr() == moved.data_ptr()
    assert torch.equal(got, want) and torch.equal(f, want_f)
    assert int(f.sum()) > 0


def test_houdayer_takes_the_first_kernel_by_shape(cuda):
    """Past 619,152 sites no cluster of 16 CTAs holds a pair's union-find:
    the first kernel runs by shape alone (LAUNCHES["houdayer_wide"]) and
    equals the plain version, on the site order and on a packed state."""
    from montecarlosolvers_tpu_torch.ops import cluster as cl
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck

    prob = instances.gaussian_torus(800, 1, device=cuda).to_generic()
    n = prob.nspins
    assert ck.card_houdayer_geometry(2, n, cuda) is None
    rng = np.random.default_rng(8)
    s1, s2 = (torch.as_tensor(rng.choice([-1.0, 1.0], size=(2, n))
                              .astype(np.float32), device=cuda)
              for _ in range(2))
    _build.reset_launches()
    got = ck.houdayer_move(prob, s1, s2, 3, 1)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "houdayer_wide": 1}
    want = cl.houdayer_move_ref(prob, s1, s2, 3, 1)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    pg = packed_ops.build_packed(prob)
    state = packed_ops.pack_state(pg, torch.cat([s1[:1], s2[:1]]))
    ror = torch.zeros((1, 2, 1), dtype=torch.int64, device=cuda)
    moved, f = ck.houdayer_move_packed(prob, pg, state.clone(), ror, 3, 1)
    ref, ref_f = ck.houdayer_move_packed_ref(prob, pg, state, ror, 3, 1)
    torch.cuda.synchronize()
    assert torch.equal(moved, ref) and torch.equal(f, ref_f)


def test_icm_on_the_packed_engine_moves_in_place(cuda, monkeypatch):
    """solve("icm") on random_3d_lattice(12) (the packed engine): one
    Houdayer launch a move and no unpack or repack of the state around it
    (the engine's state read in site order once, at the end)."""
    from montecarlosolvers_tpu_torch.solvers import _engines

    prob = instances.random_3d_lattice(12, rng=0, device=cuda)[0]
    calls = {"full": 0, "set_full": 0}
    for name in calls:
        orig = getattr(_engines.ClassicalEngine, name)

        def counted(self, *a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(_engines.ClassicalEngine, name, counted)
    _build.reset_launches()
    ss = solve(prob, method="icm", num_reads=2, sweeps=40, seed=0)
    assert _build.LAUNCHES["houdayer"] == 20
    assert calls == {"full": 1, "set_full": 0}
    assert set(np.unique(ss.samples)) <= {-1.0, 1.0}


@pytest.mark.parametrize("per_slice_seeds", [True, False])
@pytest.mark.parametrize("chain0", [0, 100003])
def test_line_routes_equal_plain(cuda, monkeypatch, per_slice_seeds, chain0):
    """fk_line's cluster kernel (one launch, the chain's words over a
    cluster) and the first kernel (forced: one launch a color phase)
    against line_phase_ref phase by phase, bitwise: the 80 x 80 torus's
    generic form, P = 40, 8 chains, 3 steps; and a window of steps and
    classes at a hash step of its own."""
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck

    ck_, pg, confs, b, jp, teff = _cluster_case("torus80", 40, cuda,
                                                chains=8, steps=3)
    P, t_eff = 40, float(teff[0])
    lut = schedules.bath_lookuptable(P, 0.01, device=cuda)
    p_pair, p_t = ck.line_tables(lut, jp, t_eff, P, cuda)
    want = ck.line_anneal_ref(pg, b, jp, p_t, t_eff, lut, p_pair, confs, 13,
                              per_slice_seeds, chain0=chain0)
    _build.reset_launches()
    got = ck.line_anneal(pg, b, jp, p_t, t_eff, lut, p_pair, confs, 13,
                         per_slice_seeds, chain0=chain0)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"fk_line": 1}
    part = ck.line_anneal(pg, b, jp, p_t, t_eff, lut, p_pair, confs, 13,
                          per_slice_seeds, t0=1, steps=2, colors=range(1, 2),
                          step0=5, chain0=chain0)
    part_ref = ck.line_anneal_ref(pg, b, jp, p_t, t_eff, lut, p_pair, confs,
                                  13, per_slice_seeds, t0=1, steps=2,
                                  colors=range(1, 2), step0=5, chain0=chain0)
    monkeypatch.setattr(ck, "card_line_geometry", lambda *a, **k: None)
    _build.reset_launches()
    first = ck.line_anneal(pg, b, jp, p_t, t_eff, lut, p_pair, confs, 13,
                           per_slice_seeds, chain0=chain0)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "fk_line_wide": 3 * pg.num_colors}
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(first, want)
    assert torch.equal(part, part_ref) and not torch.equal(got, confs)


def test_solve_piqmc_sw_is_one_line_launch(cuda):
    """solve("piqmc_sw") at the cell's shape (the 80 x 80 torus's generic
    form, P = 40, 8 reads, 50 sweeps): the pre-anneal's SA launch and one
    fk_line launch, where the per-phase kernels made 100."""
    prob = instances.gaussian_torus(80, 0, device=cuda).to_generic()
    _build.reset_launches()
    ss = solve(prob, method="piqmc_sw", num_reads=8, sweeps=50, slices=40,
               seed=0, alpha=1e-2)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "packed_sa": 1, "fk_line": 1}
    assert np.isfinite(ss.energies).all()
