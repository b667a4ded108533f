"""Shapes the port's kernels take on the card, decided on the host.

Kernel A (`csrc/split_sa.cu`) packs C chains to a 32-bit word per site and
spreads each group of C chains over a thread-block cluster of R CTAs;
`ops/split_kernels.py::sa_geometry` picks (C, R) so that the grid fills the
H100 at the main path's 1280 SA chains and at the PIQMC pre-anneal's 32,
and R so that a band of rows fits one CTA's 227 KB. `pack_chain_bits` /
`unpack_chain_bits` move the (chains, Nh) halves in and out of that
layout. Kernel 6 (`csrc/plane_sa.cu`) takes the same design on the full
L x L plane (`ops/plane_kernels.py::plane_sa_geometry`), and kernel B
(`csrc/split_qmc.cu`) spreads one chain's four quarters as bits over a
cluster (`split_kernels.qmc_geometry`), or, for a chain no cluster holds,
runs its per-phase kernels; kernel 3 (`csrc/plane_qmc.cu`) does the same
with a chain's slices as bits on the full plane
(`plane_kernels.plane_qmc_geometry`, `pack_slice_bits`), and kernel 7
(`csrc/plane_svmc.cu`) spreads a chain's angles over a cluster
(`plane_kernels.plane_svmc_geometry`), and so does kernel 4
(`csrc/split_svmc.cu`) on the split halves (`split_kernels.
svmc_split_geometry`). Each geometry function returns None for a shape no
cluster of 16 CTAs holds, and the wrapper runs that kernel's per-phase
kernels: the card refuses no lattice (README.md states the edges).

Generic PIQMC and the generic bath on an IsingProblem take the same design
(`ops/generic_kernels.py::generic_qmc_geometry`, `generic_qmc_bath_geometry`:
a chain's slices as words over a cluster, CTA r holding the r-th chunk of
every color class, `word_layout`), or for a chain no cluster holds each
file's first kernel (the "_wide" launch keys). fk_line at P <= 64 keeps
a chain's lines as 64-bit words over a cluster on the same slot layout
(`cluster_kernels.line_geometry`), its first kernel a line's bond rows in
registers, and past P = 64 in a warp's shared memory
(`cluster_kernels.line_wide_bytes`, up to LINE_MAX_SLICES); the Houdayer
move spreads a pair over a cluster (`cluster_kernels.houdayer_geometry`,
its bonds in `houdayer_table`). Generic SVMC
spreads a chain's rotors over a cluster on the same slot layout
(`generic_kernels.packed_svmc_geometry`), and the chain-bit energy kernel
reads K chains of a group a CTA (`split_kernels.words_energy_geometry`).
"""

import numpy as np
import pytest
import torch

from montecarlosolvers_tpu_torch.models import instances
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck
from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
from montecarlosolvers_tpu_torch.ops import packed as packed_ops
from montecarlosolvers_tpu_torch.ops import plane_kernels as pk
from montecarlosolvers_tpu_torch.ops import shard_kernels as shk
from montecarlosolvers_tpu_torch.ops import split_kernels as sk


def h100_resident(R, threads):
    """A stand-in for the card's cudaOccupancyMaxActiveClusters: 5 CTAs an
    SM on 7 GPCs of 16 SMs (PERF.md)."""
    assert threads <= sk.MAX_THREADS and threads % 32 == 0
    return 7 * (16 * 5 // R)


# (chains, L) -> (C, R): 32 chains to a word while that leaves 32 groups,
# each group over the largest cluster the card holds for every group at
# once (35 clusters of 16, 70 of 8); at L = 256 both halves of a word per
# site are 256 KB, so R >= 2 whatever the chains
@pytest.mark.parametrize("chains,L,C,R", [
    (1, 80, 1, 16), (32, 80, 1, 16), (33, 80, 1, 16), (1280, 80, 32, 8),
    (1, 240, 1, 16), (32, 240, 1, 16), (33, 240, 1, 16), (1280, 240, 32, 8),
    (1, 256, 1, 16), (32, 256, 1, 16), (33, 256, 1, 16), (1280, 256, 32, 8),
])
def test_sa_geometry(chains, L, C, R):
    c, r, threads = sk.sa_geometry(chains, L, h100_resident)
    assert (c, r) == (C, R)
    assert h100_resident(r, threads) >= -(-chains // c)
    assert sk.sa_smem_bytes(L, r) <= _build.SMEM_LIMIT_BYTES
    assert threads == min(sk.MAX_THREADS,
                          -(-sk.band_sites(L, r) // 32) * 32)
    # no count of resident clusters: the largest cluster that fits
    assert sk.sa_geometry(chains, L)[:2] == (C, 16)
    # none held at once: the smallest cluster that fits
    assert sk.sa_geometry(chains, L, lambda r, th: 0)[1] == \
        (2 if L == 256 else 1)


def test_sa_geometry_limit():
    # R = 16 holds even L up to 960 (60 rows of 480 sites a band)
    assert sk.sa_geometry(32, 960, lambda r, th: 0)[1] == 16
    assert sk.sa_smem_bytes(256, 1) > _build.SMEM_LIMIT_BYTES
    # beyond, the per-phase kernel runs
    assert sk.sa_smem_bytes(962, 16) > _build.SMEM_LIMIT_BYTES
    assert sk.sa_geometry(32, 962) is None


@pytest.mark.parametrize("C", [1, 8, 32])
def test_pack_chain_bits_round_trip(C):
    rng = np.random.default_rng(C)
    chains, nh = 37, 50  # 37 chains: a ragged last group for C = 8 and 32
    x = torch.from_numpy(rng.choice([-1.0, 1.0], size=(chains, nh))
                         .astype(np.float32))
    words = sk.pack_chain_bits(x, C)
    assert words.dtype == torch.int32
    assert words.shape == (-(-chains // C), nh)
    for g, c in ((0, 0), (-(-chains // C) - 1, (chains - 1) % C)):
        bit = (words[g].to(torch.int64) >> c) & 1
        assert torch.equal(bit == 1, x[g * C + c] < 0)
    if chains % C:  # the spare bits of the ragged group are 0
        spare = (words[-1].to(torch.int64) & 0xFFFFFFFF) >> (chains % C)
        assert not spare.any()
    out = sk.unpack_chain_bits(words, chains, C)
    assert out.dtype == torch.float32 and torch.equal(out, x)


@pytest.mark.parametrize("C", [1, 8, 32])
def test_gather_chain_bits_is_a_gather_of_the_chains(C):
    """PA's resample gathers the chains in their chain-bit words: the same
    words as packing the gathered halves, bit 31 (a negative word) and a
    ragged last group included."""
    rng = np.random.default_rng(40 + C)
    chains, nh = 37, 50
    x = torch.from_numpy(rng.choice([-1.0, 1.0], size=(chains, nh))
                         .astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, chains, size=chains))
    got = sk.gather_chain_bits(sk.pack_chain_bits(x, C), idx, C)
    assert torch.equal(got, sk.pack_chain_bits(x[idx], C))


# (chains, L) -> (C, R) of kernel 6, by kernel A's rules; L = 675 is the
# largest plane whose band, twice, fits a CTA of a 16-CTA cluster, where
# 1280 chains' 40 groups take R = 16 though not all 40 clusters fit at once
@pytest.mark.parametrize("chains,L,C,R", [
    (1, 5, 1, 4), (1, 9, 1, 8), (32, 81, 1, 16), (33, 81, 1, 16),
    (1280, 81, 32, 8), (1, 243, 1, 16), (32, 243, 1, 16),
    (1280, 243, 32, 8), (1, 675, 1, 16), (1280, 675, 32, 16),
])
def test_plane_sa_geometry(chains, L, C, R):
    c, r, threads = pk.plane_sa_geometry(chains, L, h100_resident)
    assert (c, r) == (C, R)
    assert c == sk.sa_geometry(chains, 80, h100_resident)[0]
    assert pk.sa_plane_smem_bytes(L, r) <= _build.SMEM_LIMIT_BYTES
    # one thread per site of a phase's color in the largest band
    assert threads == min(sk.MAX_THREADS,
                          -(-(-(-L // r) * ((L + 1) // 2)) // 32) * 32)


def test_plane_sa_geometry_limit():
    assert pk.sa_plane_smem_bytes(675, 16) <= _build.SMEM_LIMIT_BYTES
    assert pk.sa_plane_smem_bytes(676, 16) > _build.SMEM_LIMIT_BYTES
    assert pk.plane_sa_geometry(32, 675)[1] == 16
    # beyond, the per-phase kernel runs
    assert pk.plane_sa_geometry(32, 676) is None


# (chains, L, P) -> R of kernel B, or None where no cluster of 16 CTAs
# holds a chain's four quarters as bits and the per-phase kernels run: at
# P <= 64 (one word a quarter) even L <= 674, at P = 128 L <= 480; 1280
# chains fit no R whole, so they take the smallest R that holds a chain
@pytest.mark.parametrize("chains,L,P,R", [
    (32, 80, 40, 16), (32, 80, 2, 16), (33, 80, 64, 16), (32, 176, 40, 16),
    (32, 256, 40, 16), (1280, 80, 40, 1), (4, 16, 130, 16),
    (32, 674, 40, 16), (32, 676, 40, None), (1, 480, 128, 16),
    (1, 482, 128, None),
])
def test_qmc_geometry(chains, L, P, R):
    geometry = sk.qmc_geometry(chains, L, P, h100_resident)
    if R is None:
        assert geometry is None
        assert sk.qmc_smem_bytes(P, L, 16) > _build.SMEM_LIMIT_BYTES
        return
    r, threads = geometry
    assert r == R
    assert sk.qmc_smem_bytes(P, L, r) <= _build.SMEM_LIMIT_BYTES
    assert threads == sk._threads(L, r)
    # four quarters of ceil(Q/32) words a site
    assert sk.qmc_smem_bytes(P, L, r) == \
        4 * -(-(P // 2) // 32) * sk.band_sites(L, r) * 4


# (chains, L, P) -> R of kernel 3, or None where no cluster of 16 CTAs
# holds a chain's slices as bits, twice, and the per-phase kernels run: at
# P <= 32 (one word a site) L <= 675, at P <= 64 L <= 480; 1280 chains fit
# no R whole, so they take the smallest R that holds a chain
@pytest.mark.parametrize("chains,L,P,R", [
    (32, 80, 5, 16), (32, 81, 5, 16), (32, 81, 40, 16), (1280, 80, 5, 1),
    (32, 5, 1, 4), (1, 5, 64, 4), (33, 243, 5, 16), (1280, 243, 40, 8),
    (32, 675, 5, 16), (32, 676, 5, None), (1, 480, 64, 16),
    (1, 481, 64, None), (4, 80, 70, 16), (32, 81, 70, 16),
])
def test_plane_qmc_geometry(chains, L, P, R):
    geometry = pk.plane_qmc_geometry(chains, L, P, h100_resident)
    if R is None:
        assert geometry is None
        assert pk.plane_qmc_smem_bytes(P, L, 16) > _build.SMEM_LIMIT_BYTES
        return
    r, threads = geometry
    assert r == R
    assert pk.plane_qmc_smem_bytes(P, L, r) <= _build.SMEM_LIMIT_BYTES
    # one thread per site of the largest band
    assert threads == min(sk.MAX_THREADS, -(-(-(-L // r) * L) // 32) * 32)


def test_plane_qmc_geometry_limit():
    # R = 16 holds L <= 675 at P <= 32 and L <= 480 at P <= 64, twice
    assert pk.plane_qmc_smem_bytes(32, 675, 16) <= _build.SMEM_LIMIT_BYTES
    assert pk.plane_qmc_smem_bytes(33, 480, 16) <= _build.SMEM_LIMIT_BYTES
    assert pk.plane_qmc_smem_bytes(32, 676, 16) > _build.SMEM_LIMIT_BYTES
    assert pk.plane_qmc_smem_bytes(33, 481, 16) > _build.SMEM_LIMIT_BYTES
    assert pk.plane_qmc_geometry(1, 675, 32) == (16, sk.MAX_THREADS)
    assert pk.plane_qmc_geometry(1, 676, 32) is None
    assert pk.plane_qmc_geometry(1, 481, 33) is None
    # a ping-pong band of 2 * ceil(P/32) words a site
    assert pk.plane_qmc_smem_bytes(70, 81, 4) == 2 * 3 * 21 * 81 * 4


@pytest.mark.parametrize("P", [1, 5, 31, 32, 33, 64, 65])
def test_pack_slice_bits_round_trip(P):
    rng = np.random.default_rng(P)
    chains, n = 3, 50
    x = torch.from_numpy(rng.choice([-1.0, 1.0], size=(chains, P, n))
                         .astype(np.float32))
    words = pk.pack_slice_bits(x)
    assert words.dtype == torch.int32
    assert words.shape == (chains, -(-P // 32), n)
    for k in (0, P // 2, P - 1):
        bit = (words[:, k // 32].to(torch.int64) >> (k % 32)) & 1
        assert torch.equal(bit == 1, x[:, k] < 0)
    if P % 32:  # the bits past P are 0
        spare = (words[:, -1].to(torch.int64) & 0xFFFFFFFF) >> (P % 32)
        assert not spare.any()
    out = pk.unpack_slice_bits(words, P)
    assert out.dtype == torch.float32 and torch.equal(out, x)


# (chains, L) -> R of kernel 7: the largest cluster the card holds for
# every chain at once (280 clusters of 2 at 256 chains), else the smallest
# that holds a band (256 chains on 243 x 243)
@pytest.mark.parametrize("chains,L,R", [
    (1, 5, 4), (6, 33, 16), (32, 81, 16), (256, 81, 2), (6, 121, 16),
    (1, 243, 16), (256, 243, 8), (1, 480, 16),
])
def test_plane_svmc_geometry(chains, L, R):
    r, threads = pk.plane_svmc_geometry(chains, L, h100_resident)
    assert r == R
    assert pk.svmc_plane_smem_bytes(L, r) <= _build.SMEM_LIMIT_BYTES
    # one thread per site of a phase's color in the largest band
    assert threads == min(sk.MAX_THREADS,
                          -(-(-(-L // r) * ((L + 1) // 2)) // 32) * 32)


def test_plane_svmc_geometry_limit():
    # 4 floats a site, R = 16: L <= 480, where one block per chain held
    # L <= 120
    assert pk.svmc_plane_smem_bytes(480, 16) <= _build.SMEM_LIMIT_BYTES
    assert pk.svmc_plane_smem_bytes(481, 16) > _build.SMEM_LIMIT_BYTES
    assert pk.svmc_plane_smem_bytes(121, 1) > _build.SMEM_LIMIT_BYTES
    assert pk.plane_svmc_geometry(1, 480)[0] == 16
    # beyond, the per-phase kernels run
    assert pk.plane_svmc_geometry(1, 481) is None


# (chains, L) -> R of kernel 4: the largest cluster the card holds for
# every chain at once (280 clusters of 2 at 256 chains), or None where no
# cluster of 16 CTAs holds a band of 6 floats a half-site (even L above
# 552, where one block per chain held L <= 138) and the per-phase kernels
# run
@pytest.mark.parametrize("chains,L,R", [
    (256, 80, 2), (1, 16, 16), (32, 138, 16), (32, 256, 16), (1, 552, 16),
    (1, 554, None),
])
def test_split_svmc_geometry(chains, L, R):
    geometry = sk.svmc_split_geometry(chains, L, h100_resident)
    if R is None:
        assert geometry is None
        assert sk.svmc_split_smem_bytes(L, 16) > _build.SMEM_LIMIT_BYTES
        return
    r, threads = geometry
    assert r == R
    assert sk.svmc_split_smem_bytes(L, r) <= _build.SMEM_LIMIT_BYTES
    assert sk.svmc_split_smem_bytes(L, r) == 6 * sk.band_sites(L, r) * 4
    assert threads == sk._threads(L, r)
    # no count of resident clusters: the largest cluster that fits
    assert sk.svmc_split_geometry(chains, L)[0] == 16


def test_sa_per_chain_temperatures_fit_wherever_the_halves_do():
    """Kernel A's per-chain instantiation keeps its group's 32
    temperatures after the halves (csrc/split_sa.cu): no even L and
    cluster size put the halves within those 128 bytes of the limit, so
    sa_geometry's choice holds for both instantiations."""
    for L in range(2, 2000, 2):
        for r in sk.CLUSTER_SIZES:
            if r <= L and sk.sa_smem_bytes(L, r) <= _build.SMEM_LIMIT_BYTES:
                assert sk.sa_smem_bytes(L, r) + 128 <= \
                    _build.SMEM_LIMIT_BYTES, (L, r)


# ------------------------------------ generic PIQMC and the generic bath


_PACKED = {}


def _packed(name):
    """The PackedGraphs the main path's generic solves take: the 80x80
    torus's generic form, the 81x81 torus's (its greedy colors) and its
    checkerboard packing (the bath's lattice route), chimera(16)."""
    if name not in _PACKED:
        if name == "torus80":
            prob = instances.gaussian_torus(80, 0, device="cpu").to_generic()
        elif name == "torus81":
            prob = instances.gaussian_torus(81, 0, device="cpu").to_generic()
        elif name in ("lattice80", "lattice81"):
            _PACKED[name] = packed_ops.packed_from_lattice(
                instances.gaussian_torus(int(name[-2:]), 0, device="cpu"))
            return _PACKED[name]
        else:
            prob = instances.chimera_graph(16, rng=0, device="cpu")[0]
        _PACKED[name] = packed_ops.build_packed(prob)
    return _PACKED[name]


# (graph, chains, P) -> R: the smallest cluster whose chains x R CTAs cover
# the 132 SMs (32 chains: R = 8, 256 CTAs), or with one chain the largest
# that holds its slices' words (16)
@pytest.mark.parametrize("geometry", ["generic_qmc_geometry",
                                      "generic_qmc_bath_geometry"])
@pytest.mark.parametrize("graph,chains,P,R", [
    ("torus80", 32, 40, 8), ("torus80", 32, 20, 8), ("torus81", 32, 40, 8),
    ("lattice81", 32, 20, 8), ("chimera16", 32, 20, 8),
    ("chimera16", 32, 40, 8), ("torus80", 1, 40, 16),
    ("torus80", 132, 40, 1), ("torus80", 66, 5, 2)])
def test_generic_qmc_geometry(geometry, graph, chains, P, R):
    pg = _packed(graph)
    rule = getattr(gk, geometry)
    bath = geometry == "generic_qmc_bath_geometry"
    r, threads = rule(chains, pg.nspins, P, pg.num_colors)
    assert r == R
    slot_site, slot_starts, nbr_loc, nr = gk.word_layout(pg, r)
    assert nr <= gk.word_slots(pg.nspins, r, pg.num_colors)
    # the head (16 buffer pointers, a float a warp), both buffers of a
    # CTA's slots' words, a float a slice and, for the bath, its (P, P)
    # matrix: all of the kernel's shared memory, none of it static
    words = -(-P // 32)
    smem = (16 * 8 + gk.WORD_THREADS // 32 * 4 + 2 * words * nr * 4 + 4 * P
            + (4 * P * P if bath else 0))
    assert smem == gk.words_smem_bytes(P, nr, True, bath)
    assert smem <= _build.SMEM_LIMIT_BYTES
    assert threads == min(gk.WORD_THREADS,
                          -(-gk.word_slots(pg.nspins, r,
                                           pg.num_colors) // 32) * 32)


# (rule, two classes: the most sites at P = 40, at P = 32; the most
# slices at n = 6400): the bath's CTAs also hold its (P, P) matrix
@pytest.mark.parametrize("geometry,n40,n32,p6400", [
    ("generic_qmc_geometry", 232080, 464240, 2208),
    ("generic_qmc_bath_geometry", 225680, 456048, 226)])
def test_generic_qmc_geometry_limit(geometry, n40, n32, p6400):
    """The first chain past 16 CTAs' shared memory, in n and in P, takes
    each file's first kernel (None); so does a graph of 128 classes."""
    rule = getattr(gk, geometry)
    bath = geometry == "generic_qmc_bath_geometry"
    assert rule(1, n40, 40, 2) == (16, gk.WORD_THREADS)
    assert rule(1, n40 + 1, 40, 2) is None
    # the first torus past it: the 482 x 482 generic form (232,324
    # sites), the bath's 476 x 476 checkerboard (226,576)
    first = 476 if bath else 482
    assert rule(1, first * first, 40, 2) is None
    assert rule(1, (first - 2) ** 2, 40, 2) is not None
    # at P <= 32 one word a site: about twice as many sites
    assert rule(1, n32, 32, 2) is not None
    assert rule(1, n32 + 1, 32, 2) is None
    # n = 6400 (the 80 x 80 torus)
    assert rule(1, 6400, p6400, 2) is not None
    assert rule(1, 6400, p6400 + 1, 2) is None
    assert rule(32, 6400, 40, 127) is not None
    assert rule(32, 6400, 40, 128) is None
    for r in gk.CLUSTER_SIZES:
        assert gk.words_smem_bytes(40, gk.word_slots(n40 + 1, r, 2), True,
                                   bath) > _build.SMEM_LIMIT_BYTES


# (chains, SMs) -> R: the rule covers the card's own SM count, which the
# wrappers read from the device (an H100 PCIe has 114, an SXM 132)
@pytest.mark.parametrize("geometry", ["generic_qmc_geometry",
                                      "generic_qmc_bath_geometry"])
@pytest.mark.parametrize("chains,sms,R", [
    (32, 132, 8), (32, 114, 4), (32, 128, 4), (32, 129, 8), (8, 132, 16),
    (132, 132, 1), (132, 264, 2)])
def test_generic_qmc_geometry_covers_the_cards_sms(geometry, chains, sms,
                                                   R):
    pg = _packed("torus80")
    rule = getattr(gk, geometry)
    r, threads = rule(chains, pg.nspins, 40, pg.num_colors, sms=sms)
    assert r == R
    assert threads == gk.word_threads(pg.nspins, r, pg.num_colors)
    if sms == gk.NUM_SMS:
        assert rule(chains, pg.nspins, 40, pg.num_colors) == (r, threads)


@pytest.mark.parametrize("graph,R", [("torus80", 8), ("torus81", 16),
                                     ("lattice81", 4), ("chimera16", 8),
                                     ("chimera16", 1), ("lattice80", 8),
                                     ("lattice81", 8), ("lattice81", 16)])
def test_word_layout_holds_every_site_once(graph, R):
    """CTA r holds the r-th chunk of every class, at the same slots in
    every CTA; nbr_loc names each neighbour's CTA and slot."""
    pg = _packed(graph)
    slot_site, slot_starts, nbr_loc, nr = gk.word_layout(pg, R)
    assert slot_site.shape == (R * nr,) and slot_starts[-1] == nr
    sites = slot_site[slot_site >= 0]
    assert torch.equal(torch.sort(sites & 0xFFFFFF).values,
                       torch.arange(pg.nspins, dtype=torch.int32))
    where = torch.full((pg.nspins,), -1, dtype=torch.int64)
    full = torch.nonzero(slot_site >= 0)[:, 0]
    where[(slot_site[full] & 0xFFFFFF).long()] = full
    rank, slot = where // nr, where % nr
    cls = (slot_site[full] >> 24).long()
    starts = torch.tensor(pg.starts)
    # the class of a slot is the class block its site lies in, and the
    # slot lies in that class's slots
    site = (slot_site[full] & 0xFFFFFF).long()
    assert torch.equal(torch.bucketize(site, starts[1:], right=True), cls)
    lo, hi = slot_starts.long()[cls], slot_starts.long()[cls + 1]
    assert bool(((slot % nr)[site] >= lo).all()) and \
        bool(((slot % nr)[site] < hi).all())
    # chunks of ceil(n_c / R) sites in class order
    chunk = -(-(starts[cls + 1] - starts[cls]) // R)
    assert torch.equal(rank[site], (site - starts[cls]) // chunk)
    loc = (rank << 16) | slot
    assert torch.equal(nbr_loc.long(), loc[pg.nbr_idx.long()])
    assert gk.word_layout(pg, R)[0] is slot_site  # cached per graph


@pytest.mark.parametrize("P,words,warps", [
    (64, 1, 8), (65, 2, 8), (128, 2, 8), (400, 7, 4), (921, 15, 1)])
def test_line_wide_rows(P, words, warps):
    """fk_line's rows past P = 64: ceil(P/64) 64-bit words a row, twice,
    with the reach and three floats a slice in one warp's shared memory;
    as many warps a CTA as 227 KB hold, up to LINE_WARPS. P = 921 is the
    last that one warp holds (LINE_MAX_SLICES)."""
    assert -(-P // 64) == words
    per_warp = ck.line_wide_bytes(P)
    assert per_warp == (2 * P * words + 2 * words + (3 * P + 1) // 2) * 8
    assert min(ck.LINE_WARPS, _build.SMEM_LIMIT_BYTES // per_warp) == warps
    assert ck.line_warps(P) == (ck.LINE_WARPS if P <= 64 else warps)
    assert ck.line_wide_bytes(ck.LINE_MAX_SLICES) <= _build.SMEM_LIMIT_BYTES
    assert ck.line_wide_bytes(ck.LINE_MAX_SLICES + 1) > \
        _build.SMEM_LIMIT_BYTES


# (chains, sms) -> R of fk_label and fk_wolff: the largest cluster whose
# chains x R CTAs run at once, one an SM (132 on an H100 SXM, 114 on an
# H100 PCIe), unless a quarter of the SMs would idle, then the smallest
# that covers them; at most 16
@pytest.mark.parametrize("chains,sms,R", [
    (8, 132, 16), (64, 132, 2), (1, 132, 16), (16, 132, 8), (132, 132, 1),
    (1280, 132, 1), (66, 132, 2), (44, 132, 3), (100, 132, 1),
    (90, 132, 2), (8, 114, 14), (64, 114, 2), (16, 114, 7),
    (114, 114, 1), (57, 114, 2), (80, 114, 2)])
@pytest.mark.parametrize("asym", [False, True])
def test_label_geometry_covers_the_sms(chains, sms, R, asym):
    """label_geometry's R and threads at P = 40 and P = 1 on the 80x80
    torus's sites, and a graph of fewer sites than the cluster's CTAs: R
    never exceeds its n sites (CTA r owns the r-th chunk of ceil(n / R)
    sites in every slice), a CTA's threads are one a node of its P ceil(n
    / R), in whole warps, at most LABEL_THREADS, and half that where the
    chains' CTAs outnumber the SMs and two CTAs' shared memory (a 1 KB
    reserve each) fit an SM's SM_SMEM_BYTES."""
    for P, n in ((40, 6400), (1, 6400)):
        r, threads, on_chip = ck.label_geometry(chains, P, n, asym, sms)
        assert r == R
        # all at once, or else the smallest that covers the SMs; never a
        # quarter of them idle where a larger cluster would fill them
        assert chains * r <= sms or chains * (r - 1) * 4 < 3 * sms
        assert chains * r * 4 >= 3 * sms or r == ck.CLUSTER_MAX
        nodes = P * -(-n // r)
        smem = ck.label_smem_bytes(P, n, r, asym, on_chip)
        two = chains * r > sms and 2 * (smem + 1024) <= ck.SM_SMEM_BYTES
        assert threads == min(ck.LABEL_THREADS // (2 if two else 1),
                              -(-nodes // 32) * 32)
        assert ck.label_shape(r, P, n, asym, chains, sms) == (r, threads,
                                                              on_chip)
    r, threads, on_chip = ck.label_geometry(chains, 5, 3, asym, sms)
    assert r == min(R, 3) and threads == 32 and on_chip


def _clusters_held(per_gpc):
    """A card's `resident(R, threads, on_chip)`: the clusters of R CTAs it
    holds at once, one CTA an SM (two at 512 threads or fewer), a cluster
    within one GPC of the given SM counts."""
    def resident(R, threads, on_chip):
        per_sm = 2 if threads <= ck.LABEL_THREADS // 2 else 1
        return sum(per_sm * sms // R for sms in per_gpc)
    return resident


# GPCs of 16 and 18 SMs (132 SMs), and a card one of whose GPCs holds 14
@pytest.mark.parametrize("per_gpc", [
    (18, 18, 16, 16, 16, 16, 16, 16), (18, 18, 18, 16, 16, 16, 16, 14)])
@pytest.mark.parametrize("chains", [1, 8, 9, 16, 64, 44])
@pytest.mark.parametrize("asym", [False, True])
def test_label_geometry_runs_the_chains_at_once(per_gpc, chains, asym):
    """With the card's `resident`, label_geometry takes the SM count's R
    down to the largest whose chains' clusters all run at once: never a
    larger R than the SM count's, and each R between it and the SM count's
    would leave a chain waiting. Without `resident` the SM count's R
    stays."""
    sms = sum(per_gpc)
    resident = _clusters_held(per_gpc)
    for P, n in ((40, 6400), (1, 6400)):
        first = ck.label_geometry(chains, P, n, asym, sms)
        got = ck.label_geometry(chains, P, n, asym, sms, resident)
        r = got[0]
        assert r <= first[0] and resident(*got) >= chains
        assert got == ck.label_shape(r, P, n, asym, chains, sms)
        for bigger in range(r + 1, first[0] + 1):
            assert resident(*ck.label_shape(bigger, P, n, asym, chains,
                                            sms)) < chains
    # 8 chains of 16 CTAs fit eight GPCs of 16 or more SMs; with one GPC of
    # 14 they take 14 CTAs each, one cluster a GPC
    want = min(16, min(per_gpc))
    assert ck.label_geometry(8, 40, 6400, asym, sms, resident)[0] == want


@pytest.mark.parametrize("chains,R", [(1, 16), (8, 16), (1000, 1)])
def test_label_geometry_keeps_its_r_where_none_is_held(chains, R):
    """Where no R lets the chains run at once (a card that holds no
    cluster), label_geometry keeps the SM count's R."""
    assert ck.label_geometry(chains, 40, 6400, False, 132,
                             lambda *shape: 0)[0] == R


def _last_on_chip(chains, P, asym, sms):
    """The most sites n whose P x n chain label_geometry keeps in shared
    memory (its union-find regions on chip), by bisection on the rule."""
    lo, hi = 1, 10 ** 7
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if ck.label_geometry(chains, P, mid, asym, sms)[2]:
            lo = mid
        else:
            hi = mid
    return lo


# (chains, P, asym) -> the last n on chip: one chain over 16 CTAs at P = 1
# and 40, 64 chains over 2 CTAs, 132 chains over one
@pytest.mark.parametrize("chains,P,asym,n_last", [
    (1, 1, False, 619152), (1, 1, True, 371488), (1, 40, False, 15456),
    (1, 40, True, 9264), (64, 1, False, 77394), (64, 1, True, 46436),
    (132, 1, False, 38697), (132, 1, True, 23218)])
def test_label_geometry_shared_memory_limit(chains, P, asym, n_last):
    """The union-find stays in the CTAs' shared memory exactly while each
    CTA's bytes fit SMEM_LIMIT_BYTES: the head (LABEL_HEAD_BYTES, the
    kernels' only other shared memory: they have none static), the bath's
    two rows of P floats, and its region of P ceil(n / R) nodes, 4 bytes a
    parent (8 with `asym`: the labels beside) and two flag bytes, in whole
    words. At the first n past it (one node past at P = 1) the regions
    move to device memory and the chain keeps its R CTAs."""
    sms = 132
    assert _last_on_chip(chains, P, asym, sms) == n_last
    R, _, on_chip = ck.label_geometry(chains, P, n_last, asym, sms)
    assert on_chip
    nodes = P * -(-n_last // R)
    per_node = 10 if asym else 6
    want = ck.LABEL_HEAD_BYTES + 8 * P + -(-nodes * per_node // 4) * 4
    assert ck.label_smem_bytes(P, n_last, R, asym) == want
    assert want <= _build.SMEM_LIMIT_BYTES
    # the first n whose chunk of sites grows
    R2, _, on_chip2 = ck.label_geometry(chains, P, n_last + 1, asym, sms)
    assert R2 == R and not on_chip2
    assert ck.label_smem_bytes(P, n_last + 1, R, asym) > \
        _build.SMEM_LIMIT_BYTES
    assert ck.label_smem_bytes(P, n_last + 1, R, asym, on_chip=False) == \
        ck.LABEL_HEAD_BYTES + 8 * P


# Generic SA's cluster route (generic_words.cuh's SA mode): (chains, n,
# colors, d_chains) -> (C, R, threads, shared bytes a CTA). C from kernel
# A's rule, halved until it divides d_chains; R the largest of
# CLUSTER_SIZES whose groups all fit SA_BLOCKS_PER_SM CTAs on each of the
# 132 SMs (528), C doubling (while it divides d_chains) until they do: 40
# groups of 32 at 1280 chains take R = 8, 32 or 8 single chains R = 16,
# 160 chains 8 a word at R = 16; 40 chains a realization leave 8 a word
# and 160 groups, R = 2
@pytest.mark.parametrize("chains,n,colors,d_chains,C,R,threads,smem", [
    (8, 6400, 2, 0, 1, 16, 256, 192 + 8 * 401 + 256),
    (32, 6400, 2, 0, 1, 16, 256, 192 + 8 * 401 + 256),
    (33, 6400, 2, 0, 1, 16, 256, 192 + 8 * 401 + 256),
    (160, 6400, 2, 0, 8, 16, 256, 192 + 8 * 401 + 256),
    (384, 6400, 2, 0, 16, 16, 256, 192 + 8 * 401 + 256),
    (1280, 6400, 2, 0, 32, 8, 256, 192 + 8 * 801 + 256),
    (1280, 6400, 2, 160, 32, 8, 256, 192 + 8 * 801 + 256),
    (1280, 6400, 2, 40, 8, 2, 256, 192 + 8 * 3201 + 256),
    (160, 6400, 2, 20, 4, 8, 256, 192 + 8 * 801 + 256),
    (1280, 6561, 4, 0, 32, 8, 256, 192 + 8 * 824 + 256),
    (64, 100, 2, 0, 2, 16, 32, 192 + 8 * 8 + 256),
])
def test_packed_sa_geometry(chains, n, colors, d_chains, C, R, threads,
                            smem):
    assert gk.packed_sa_geometry(chains, n, colors, d_chains=d_chains) == (
        C, R, threads)
    assert gk.sa_words_smem_bytes(gk.word_slots(n, R, colors)) == smem
    assert -(-chains // C) * R <= gk.SA_BLOCKS_PER_SM * gk.NUM_SMS
    if d_chains:
        assert d_chains % C == 0


def test_packed_sa_geometry_takes_what_the_card_holds():
    """With the card's count of resident clusters, C doubles and then R
    goes down until every group runs at once; if none is held whole, the
    smallest R that fits."""
    def resident(R, threads, smem):
        assert threads % 32 == 0 and threads <= gk.SA_THREADS
        assert smem <= _build.SMEM_LIMIT_BYTES
        return 7 * (16 * 4 // R) if R > 4 else 528 // R

    assert gk.packed_sa_geometry(8, 6400, 2, resident=resident) == (
        1, 16, 256)
    assert gk.packed_sa_geometry(32, 6400, 2, resident=resident) == (
        2, 16, 256)
    assert gk.packed_sa_geometry(3000, 6400, 2, resident=resident) == (
        32, 4, 256)
    assert gk.packed_sa_geometry(1280, 6400, 2,
                                 resident=lambda *a: 0) == (32, 1, 256)


def test_packed_sa_geometry_limit():
    """The first shapes the cluster route leaves to the first kernel: with
    two classes a ring of 463,985 sites (the slots of one of 16 CTAs no
    longer fit 227 KB beside the head and the tail), and any graph of more
    than 127 classes."""
    assert gk.packed_sa_geometry(1, 463984, 2) == (1, 16, 256)
    assert gk.sa_words_smem_bytes(gk.word_slots(463984, 16, 2)) == \
        _build.SMEM_LIMIT_BYTES
    assert gk.packed_sa_geometry(1, 463985, 2) is None
    assert gk.packed_sa_geometry(1280, 463985, 2) is None
    assert gk.packed_sa_geometry(8, 130, 127) is not None
    assert gk.packed_sa_geometry(8, 130, 128) is None


def test_sa_words_constants_match_the_header():
    """SA_THREADS, SA_BLOCKS_PER_SM and SA_TAIL are the header's."""
    import pathlib
    import re
    src = (pathlib.Path(gk.__file__).parent.parent / "csrc"
           / "generic_words.cuh").read_text()
    for name, value in (("kSaThreads", gk.SA_THREADS),
                        ("kSaMinBlocks", gk.SA_BLOCKS_PER_SM),
                        ("kSaTail", gk.SA_TAIL)):
        assert re.search(rf"constexpr int {name} = (\d+);", src).group(1) \
            == str(value)


# Generic SA's rule of size: (n, colors) -> one CTA a chain. A class phase
# of at most SA_CTA_PASSES passes of THREADS threads (1280 sites) takes the
# file's first kernel: random_3d_lattice(12) (864 sites a class),
# chimera_graph(16) (2048 sites, three classes), the 48 x 48 torus (1152),
# not the 56 x 56 torus (1568), random_3d_lattice(16) or the 80 x 80 torus
@pytest.mark.parametrize("n,colors,one_cta", [
    (1728, 2, True), (2048, 3, True), (2304, 2, True), (2560, 2, True),
    (2561, 2, False), (3136, 2, False), (4096, 2, False), (6400, 2, False),
    (6561, 2, False), (16, 2, True), (130, 130, True), (1280, 1, True),
    (1281, 1, False),
])
def test_packed_sa_one_cta(n, colors, one_cta):
    assert gk.packed_sa_one_cta(n, colors) is one_cta
    assert gk.SA_CTA_PASSES * gk.THREADS == 1280


# Generic SVMC's cluster route (csrc/packed_svmc.cu::
# packed_svmc_cluster_kernel): (graph, chains) -> (R, threads). R the
# largest of CLUSTER_SIZES whose chains x R CTAs fit SVMC_BLOCKS_PER_SM an
# SM on the 132 SMs (528; fewer where the shared memory runs out), else
# the smallest that fits: 8 and 32 chains over 16 CTAs, 256 chains over 2
# (512 CTAs), 1280 chains at R = 1, none held whole
SVMC_GRAPHS = {
    "torus": (lambda: instances.gaussian_torus(80, 0, device="cpu")
              .to_generic(), 6400, 2),
    "chimera": (lambda: instances.chimera_graph(16, rng=0, device="cpu")[0],
                2048, 3),
    "graph100": (lambda: instances.random_graph(100, 200, rng=0,
                                                device="cpu")[0], 100, 5),
}


@pytest.mark.parametrize("graph,chains,R,threads", [
    ("torus", 8, 16, 256), ("torus", 32, 16, 256), ("torus", 256, 2, 256),
    ("torus", 1280, 1, 256),
    ("chimera", 8, 16, 160), ("chimera", 32, 16, 160),
    ("chimera", 256, 2, 256), ("chimera", 1280, 1, 256),
    ("graph100", 8, 16, 32), ("graph100", 32, 16, 32),
    ("graph100", 256, 2, 64), ("graph100", 1280, 1, 128),
])
def test_packed_svmc_geometry(graph, chains, R, threads):
    make, n, colors = SVMC_GRAPHS[graph]
    pg = packed_ops.build_packed(make())
    assert (pg.nspins, pg.num_colors) == (n, colors)
    assert gk.packed_svmc_geometry(chains, n, colors) == (R, threads)
    smem = gk.svmc_smem_bytes(gk.word_slots(n, R, colors))
    assert smem <= _build.SMEM_LIMIT_BYTES
    per_sm = min(gk.SVMC_BLOCKS_PER_SM,
                 gk.SM_SMEM_BYTES // (smem + gk.SMEM_RESERVED_BYTES))
    assert chains * R <= per_sm * gk.NUM_SMS or R == 1
    # the slots of the layout the wrapper hands the kernel
    assert gk.word_layout(pg, R)[3] <= gk.word_slots(n, R, colors)


def test_packed_svmc_geometry_takes_what_the_card_holds():
    """With the card's count of resident clusters, R goes down until every
    chain's cluster runs at once; if none is held whole, the smallest R
    that fits."""
    def resident(R, threads, smem):
        assert threads % 32 == 0 and threads <= gk.SVMC_THREADS
        assert smem <= _build.SMEM_LIMIT_BYTES
        return 7 * (16 // R) if R > 4 else 528 // R

    assert gk.packed_svmc_geometry(8, 6400, 2, resident=resident) == (
        8, 256)
    assert gk.packed_svmc_geometry(7, 6400, 2, resident=resident) == (
        16, 256)
    assert gk.packed_svmc_geometry(32, 6400, 2, resident=resident) == (
        4, 256)
    assert gk.packed_svmc_geometry(256, 6400, 2, resident=resident) == (
        2, 256)
    assert gk.packed_svmc_geometry(256, 6400, 2,
                                   resident=lambda *a: 0) == (1, 256)


def test_packed_svmc_geometry_limit():
    """The first shapes the cluster route leaves to the first kernel: with
    two classes a ring of 309,825 sites (the slots of one of 16 CTAs no
    longer fit 227 KB at 12 bytes a slot beside the head), 232,369 on a
    packing that is not proper (16 bytes a slot), and any graph of more
    than 127 classes."""
    assert gk.packed_svmc_geometry(1, 309824, 2) == (16, 256)
    assert gk.svmc_smem_bytes(gk.word_slots(309824, 16, 2)) <= \
        _build.SMEM_LIMIT_BYTES < gk.svmc_smem_bytes(
            gk.word_slots(309825, 16, 2))
    assert gk.packed_svmc_geometry(1, 309825, 2) is None
    assert gk.packed_svmc_geometry(256, 309825, 2) is None
    assert gk.packed_svmc_geometry(1, 232368, 2, proper=False) == (16, 256)
    assert gk.packed_svmc_geometry(1, 232369, 2, proper=False) is None
    assert gk.packed_svmc_geometry(8, 130, 127) is not None
    assert gk.packed_svmc_geometry(8, 130, 128) is None


def test_svmc_constants_match_the_source():
    """SVMC_THREADS, SVMC_BLOCKS_PER_SM and SVMC_HEAD_BYTES are the
    kernel's, and the shared bytes a slot are its three (four) floats."""
    import pathlib
    import re
    src = (pathlib.Path(gk.__file__).parent.parent / "csrc"
           / "packed_svmc.cu").read_text()
    for name, value in (("kSvmcThreads", gk.SVMC_THREADS),
                        ("kSvmcMinBlocks", gk.SVMC_BLOCKS_PER_SM),
                        ("kSvmcHeadBytes", gk.SVMC_HEAD_BYTES)):
        assert re.search(rf"constexpr int {name} = (\d+);", src).group(1) \
            == str(value)
    assert "(improper ? 4 : 3) * static_cast<size_t>(nr)" in src
    assert gk.svmc_smem_bytes(10) == gk.SVMC_HEAD_BYTES + 120
    assert gk.svmc_smem_bytes(10, proper=False) == gk.SVMC_HEAD_BYTES + 160


# The chain-bit energy kernel's K (csrc/energy.cuh): (chains, C) -> K, the
# largest of 1, 2, 4, 8, 16, 32 dividing C whose CTAs fill at least half of
# the 132 SMs: 384 chains take 96 CTAs of 4, 1024 and 7040 chains 8 a word
# 128 and 880 CTAs of 8, 7040 chains 32 a word 220 CTAs of 32
@pytest.mark.parametrize("chains,C,K", [
    (384, 8, 4), (384, 32, 4), (1024, 8, 8), (1024, 32, 8), (7040, 8, 8),
    (7040, 32, 32), (1, 1, 1), (7, 1, 1), (33, 2, 1), (1024, 12, 4),
])
def test_words_energy_geometry(chains, C, K):
    assert sk.words_energy_geometry(chains, C, 132) == K
    groups = -(-chains // C)
    assert C % K == 0
    assert 2 * groups * (C // K) >= 132 or K == 1


def test_words_energy_chains_a_cta_match_the_launcher():
    """Every K of ENERGY_CHAINS_A_CTA has an instantiation in the
    launcher, and no other."""
    import pathlib
    import re
    src = (pathlib.Path(sk.__file__).parent.parent / "csrc"
           / "energy.cuh").read_text()
    launcher = src[src.index("inline cudaError_t launch_chain_bits_energy"):]
    launcher = launcher[:launcher.index("\n}\n")]
    assert tuple(int(k) for k in re.findall(r"case (\d+):", launcher)) == \
        sk.ENERGY_CHAINS_A_CTA


# Generic SVMC's rule of size: (n, colors, proper) -> one CTA a chain. A
# proper packing whose class phase is at most SVMC_CTA_PASSES passes of
# THREADS threads (768 sites) takes the file's first kernel: the 16 x 16
# torus (128 sites a class), chimera_graph(16) (2048 sites, three classes),
# not random_3d_lattice(12) (864), random_3d_lattice(16) or the 80 x 80
# torus; a packing that is not proper never (the rule was measured on
# proper packings only; the first kernel reads such a packing's class
# from its snapshot, as the cluster route does)
@pytest.mark.parametrize("n,colors,proper,one_cta", [
    (256, 2, True, True), (2048, 3, True, True), (1536, 2, True, True),
    (1537, 2, True, False), (1728, 2, True, False), (4096, 2, True, False),
    (6400, 2, True, False), (81, 2, False, False), (130, 130, True, True),
    (768, 1, True, True), (769, 1, True, False),
])
def test_packed_svmc_one_cta(n, colors, proper, one_cta):
    assert gk.packed_svmc_one_cta(n, colors, proper) is one_cta
    assert gk.SVMC_CTA_PASSES * gk.THREADS == 768


# The Houdayer move's cluster kernel (csrc/houdayer.cu): (pairs, n) -> R,
# the largest power of two whose pairs x R CTAs the 132 SMs hold one an SM
# (24 pairs of random_3d_lattice(12) take 4, 48 of the 80 x 80 torus 2,
# 132 or more pairs, ICM's 768 among them, 1), down where the card holds
# fewer such clusters at once, up to the first whose CTA holds its
# union-find; fk_label's threads (label_shape) at P = 1
@pytest.mark.parametrize("pairs,n,R", [
    (24, 1728, 4), (48, 6400, 2), (132, 6400, 1), (500, 6400, 1),
    (1, 6400, 16), (8, 6400, 16), (9, 6400, 8), (2, 8, 8), (3, 100000, 16)])
def test_houdayer_geometry(pairs, n, R):
    R_, threads = ck.houdayer_geometry(pairs, n, 132)
    assert R_ == R
    assert (R, threads, True) == ck.label_shape(R, 1, n, chains=pairs)
    assert ck.label_smem_bytes(1, n, R) <= _build.SMEM_LIMIT_BYTES


def test_houdayer_geometry_takes_what_the_card_holds():
    """At 24 pairs and a card that holds 20 clusters of 4 CTAs, R falls to
    2, never below the smallest R whose CTA holds its union-find; where no
    cluster holds a pair's union-find the first kernel runs."""
    assert ck.houdayer_geometry(
        24, 1728, 132, resident=lambda R, t: 20 if R == 4 else 99)[0] == 2
    assert ck.houdayer_geometry(
        24, 300_000, 132, resident=lambda R, t: 99)[0] == 8
    assert ck.houdayer_geometry(1, 619_152, 132) is not None
    assert ck.houdayer_geometry(1, 619_153, 132) is None


# fk_line's cluster kernel (csrc/fk_line.cu): (chains, P, class sizes) ->
# (R, threads): fk_label's R (8 chains on 132 SMs: 16, 16 chains 8, 64
# chains 2) up to the first
# whose CTA holds its words, down to what the card holds for every chain
# at once (an H100 holds 7 clusters of 16 CTAs of 1024 threads, and two of
# 9 in a GPC of 18 SMs); a warp a line of the largest class chunk, at most
# LINE_THREADS; None past P = 64 and where 16 CTAs hold no chain's words
@pytest.mark.parametrize("chains,P,sizes,R,threads", [
    (8, 40, (3200, 3200), 16, 1024), (1, 40, (3200, 3200), 16, 1024),
    (16, 40, (3200, 3200), 8, 1024), (64, 5, (50, 50), 2, 800),
    (132, 2, (18, 18), 1, 576), (4, 64, (50, 50), 16, 128),
    (8, 40, (683, 683, 682), 16, 1024)])
def test_line_geometry(chains, P, sizes, R, threads):
    assert ck.line_geometry(chains, P, sizes, 132) == (R, threads)


def test_line_geometry_takes_what_the_card_holds():
    def gpcs(R, threads):
        # 7 GPCs of 18 SMs, one CTA of LINE_THREADS an SM
        assert threads <= ck.LINE_THREADS
        return 7 * (18 // R)
    assert ck.line_geometry(8, 40, (3200, 3200), 132, gpcs) == (9, 1024)
    assert ck.line_geometry(8, 65, (3200, 3200), 132) is None
    assert ck.line_geometry(8, 1, (3200, 3200), 132) is None
    assert ck.line_geometry(1, 64, (181_120, 181_120), 132) is not None
    assert ck.line_geometry(1, 64, (181_121, 181_121), 132) is None
    # the snapshot of a packing that is not proper doubles the words
    assert ck.line_smem_bytes(40, 400, 32, True) - \
        ck.line_smem_bytes(40, 400, 32) == 8 * 400


def test_line_and_houdayer_constants_match_the_sources():
    """LINE_THREADS, LINE_HEAD_BYTES and LINE_WARP_BYTES are fk_line.cu's,
    line_smem_bytes counts what its launcher asks, and the Houdayer
    cluster kernel's shared memory is fk_label's at P = 1 (the head, two
    floats, the region), as label_smem_bytes counts it."""
    import pathlib
    import re
    csrc = pathlib.Path(ck.__file__).parent.parent / "csrc"
    src = (csrc / "fk_line.cu").read_text()

    def const(name):
        expr = re.search(rf"constexpr int {name} =\s*([^;]+);", src).group(1)
        return eval(expr.replace("sizeof(unsigned long long*)", "8"))
    assert const("kLineThreads") == ck.LINE_THREADS
    assert const("kLineHeadBytes") == ck.LINE_HEAD_BYTES
    assert const("kLineWarpBytes") == ck.LINE_WARP_BYTES
    body = src[src.index("line_smem_bytes(int P, int nr"):]
    body = body[:body.index("\n}\n")]
    assert "static_cast<size_t>(nr) * 8 * (improper ? 2 : 1)" in body
    assert "static_cast<size_t>(P) * P * 4" in body
    hsrc = (csrc / "houdayer.cu").read_text()
    assert "mcs::nodes_smem_bytes(1, n, R, 1, 2, true)" in hsrc
    assert ck.label_smem_bytes(1, 1728, 4) == 256 + 8 + ck.region_bytes(
        1, 1728, 4, 1)


# S5's cluster route (csrc/generic_qmc_bath.cu::
# generic_shard_bath_slice_cluster_kernel) on gk.word_layout: (graph,
# chains, P) -> R, the smallest of CLUSTER_SIZES whose chains x R CTAs
# cover the 132 SMs (32 chains of the 80x80 torus's checkerboard: 8) and
# whose CTA holds its slots' spins (two buffers), line words and the bath
# row; one chain the largest that holds them (16)
@pytest.mark.parametrize("graph,chains,P,R", [
    ("lattice80", 32, 40, 8), ("lattice81", 32, 40, 8),
    ("lattice80", 32, 4, 8), ("torus80", 32, 40, 8), ("chimera16", 32, 20, 8),
    ("lattice80", 1, 40, 16), ("lattice80", 132, 40, 1),
    ("lattice80", 66, 5, 2), ("lattice80", 8, 40, 16)])
def test_shard_bath_geometry(graph, chains, P, R):
    pg = _packed(graph)
    r, threads = shk.shard_bath_geometry(chains, pg.nspins, P, pg.num_colors)
    assert r == R
    assert chains * r >= 132 or r == 16
    _, _, _, nr = gk.word_layout(pg, r)
    assert nr <= gk.word_slots(pg.nspins, r, pg.num_colors)
    # the head (16 spin-buffer pointers), a CTA's slots' spins twice, their
    # ceil(P/32) line words and the bath row: all its shared memory
    words = -(-P // 32)
    smem = 16 * 8 + 2 * nr * 4 + words * nr * 4 + 4 * P
    assert smem == shk.shard_bath_smem_bytes(P, nr)
    assert shk.shard_bath_smem_bytes(
        P, gk.word_slots(pg.nspins, r, pg.num_colors)) <= \
        _build.SMEM_LIMIT_BYTES
    assert threads == gk.word_threads(pg.nspins, r, pg.num_colors)
    assert threads <= gk.WORD_THREADS


@pytest.mark.parametrize("chains,sms,R", [
    (32, 132, 8), (32, 114, 4), (32, 128, 4), (32, 129, 8), (8, 132, 16),
    (132, 132, 1), (132, 264, 2)])
def test_shard_bath_geometry_covers_the_cards_sms(chains, sms, R):
    """The rule covers the card's own SM count (an H100 PCIe has 114)."""
    pg = _packed("lattice80")
    assert shk.shard_bath_geometry(chains, pg.nspins, 40, pg.num_colors,
                                   sms=sms)[0] == R


def test_shard_bath_geometry_takes_what_the_card_holds():
    """With the card's residency, R goes down to the largest whose chains'
    clusters all run at once (never below the SM count's first one's
    fits), and stays where none does."""
    pg = _packed("lattice80")
    n, c = pg.nspins, pg.num_colors

    def holds(per):
        return lambda R, threads: per.get(R, 0)
    assert shk.shard_bath_geometry(32, n, 40, c,
                                   resident=holds({8: 33})) == (
        8, gk.word_threads(n, 8, c))
    assert shk.shard_bath_geometry(32, n, 40, c,
                                   resident=holds({8: 31, 4: 66}))[0] == 4
    assert shk.shard_bath_geometry(32, n, 40, c,
                                   resident=holds({8: 31, 4: 31, 2: 40,
                                                   1: 99}))[0] == 2
    assert shk.shard_bath_geometry(32, n, 40, c, resident=holds({}))[0] == 8


def test_shard_bath_geometry_limit():
    """The first slice past 16 CTAs' shared memory takes S5's first kernel
    (None), in n and in P; so does a graph of 128 classes."""
    rule = shk.shard_bath_geometry
    assert rule(1, 232_144, 40, 2) == (16, gk.WORD_THREADS)
    assert rule(1, 232_145, 40, 2) is None
    assert rule(32, 6400, 40, 127) is not None
    assert rule(32, 6400, 40, 128) is None
    # n = 6400 at growing P: 6 + ceil(P / 32) words a slot... until the
    # bath row and the words pass the limit
    last = max(p for p in range(2, 60000, 97)
               if rule(1, 6400, p, 2) is not None)
    assert rule(1, 6400, last + 97, 2) is None
    for r in gk.CLUSTER_SIZES:
        assert shk.shard_bath_smem_bytes(
            40, gk.word_slots(232_145, r, 2)) > _build.SMEM_LIMIT_BYTES


def test_shard_bath_constants_match_the_source():
    """SHARD_HEAD_BYTES is the kernel's head, shard_bath_smem_bytes counts
    what its launcher asks, and its threads stay within the launch bound
    (generic_words.cuh::kWordThreads, gk.WORD_THREADS)."""
    import pathlib
    import re
    csrc = pathlib.Path(gk.__file__).parent.parent / "csrc"
    src = (csrc / "generic_qmc_bath.cu").read_text()
    head = re.search(r"constexpr int kShardHeadBytes =\s*([^;]+);",
                     src).group(1)
    assert eval(head.replace("sizeof(uint32_t*)", "8")) == \
        shk.SHARD_HEAD_BYTES
    body = src[src.index("inline size_t shard_bath_smem_bytes(int P, int nr)"):]
    body = body[:body.index("\n}\n")]
    assert "(2 + static_cast<size_t>((P + 31) / 32)) * nr * sizeof(uint32_t)" \
        in body
    assert "static_cast<size_t>(P) * sizeof(float)" in body
    assert "__launch_bounds__(mcs::gw::kWordThreads, 2)\n" \
        "generic_shard_bath_slice_cluster_kernel" in src
    words = (csrc / "generic_words.cuh").read_text()
    assert re.search(r"constexpr int kWordThreads = (\d+);",
                     words).group(1) == str(gk.WORD_THREADS)


# S7's draw over a cluster (csrc/fk_shard.cu::fk_shard_draw_kernel): (P,
# Ps, n) -> (R, threads, on_chip): the one chain's R, at most 16 and at
# most n, its union-find (Ps ceil(n / R) nodes) in each CTA's shared memory
# at these shapes; the rounds over the same R
@pytest.mark.parametrize("P,ps,n,R,threads", [
    (40, 40, 6400, 16, 1024), (40, 10, 6400, 16, 1024),
    (40, 4, 6400, 16, 1024), (12, 3, 30, 16, 32), (8, 2, 5, 5, 32),
    (40, 40, 1024, 16, 1024), (4, 1, 6400, 16, 416)])
def test_shard_label_geometry(P, ps, n, R, threads):
    assert ck.shard_label_geometry(P, ps, n) == (R, threads, True)
    assert ck.shard_label_threads(ps, n, R) == threads
    nodes = ps * -(-n // R)
    want = ck.LABEL_HEAD_BYTES + 8 * P + -(-nodes * 6 // 4) * 4
    assert ck.shard_label_smem_bytes(P, ps, n, R) == want
    assert want <= _build.SMEM_LIMIT_BYTES


@pytest.mark.parametrize("P,ps,n_last", [
    (40, 40, 15_456), (40, 10, 61_824), (40, 4, 154_576), (8, 1, 619_008)])
def test_shard_label_geometry_limit(P, ps, n_last):
    """The block's union-find stays in 16 CTAs' shared memory exactly while
    a CTA's region, beside the head and the bath's rows, fits
    SMEM_LIMIT_BYTES; past it the same 16 CTAs keep their regions in
    device memory, and their shared memory holds the head and the rows."""
    assert ck.shard_label_geometry(P, ps, n_last) == (16, 1024, True)
    assert ck.shard_label_geometry(P, ps, n_last + 1) == (16, 1024, False)
    assert ck.shard_label_smem_bytes(P, ps, n_last, 16) <= \
        _build.SMEM_LIMIT_BYTES
    assert ck.shard_label_smem_bytes(P, ps, n_last + 1, 16) > \
        _build.SMEM_LIMIT_BYTES
    assert ck.shard_label_smem_bytes(P, ps, n_last + 1, 16, False) == \
        ck.LABEL_HEAD_BYTES + 8 * P


def test_shard_label_geometry_takes_what_the_card_holds():
    """With the card's residency R goes down to the largest cluster the
    card holds; where it holds none, the first R stays."""
    def holds(largest):
        return lambda R, threads, on_chip: int(R <= largest)
    assert ck.shard_label_geometry(40, 40, 6400, resident=holds(16))[0] == 16
    assert ck.shard_label_geometry(40, 10, 6400, resident=holds(9))[0] == 9
    assert ck.shard_label_geometry(40, 10, 6400,
                                   resident=holds(0))[0] == 16
    # down past the shared memory's limit: the regions go to device memory
    assert ck.shard_label_geometry(40, 40, 15_000, resident=holds(8)) == (
        8, 1024, False)
    assert ck.shard_label_geometry(40, 40, 15_000, resident=holds(16)) == (
        16, 1024, True)


def test_shard_label_constants_match_the_source():
    """The draw's threads, head and shared memory are the labeling core's
    (fk_nodes.cuh) and fk_label's: LABEL_THREADS, LABEL_HEAD_BYTES, the
    bath's 2 P floats and a region of Ps rows, one int32 a node."""
    import pathlib
    import re
    csrc = pathlib.Path(ck.__file__).parent.parent / "csrc"
    src = (csrc / "fk_shard.cu").read_text()
    assert re.search(r"constexpr int kLabelThreads = (\d+);",
                     src).group(1) == str(ck.LABEL_THREADS)
    assert "mcs::nodes_smem_bytes(Ps, n, R, 1, 2 * P, on_chip)" in src
    nodes = (csrc / "fk_nodes.cuh").read_text()
    assert re.search(r"constexpr int kNodesHeadBytes = (\d+);",
                     nodes).group(1) == str(ck.LABEL_HEAD_BYTES)
    assert re.search(r"constexpr int kMaxRanks = (\d+);",
                     nodes).group(1) == str(ck.CLUSTER_MAX)
