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
"""

import numpy as np
import pytest
import torch

from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import plane_kernels as pk
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


@pytest.mark.parametrize("P", [1, 5, 33, 64])
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
