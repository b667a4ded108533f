"""The port's counter hash and Metropolis rule against the JAX package.

The uniforms must equal `pallas_sa._uniform01` BITWISE: the port's plain
engines and its CUDA kernels draw every uniform from this hash, and the
bitwise checks of whole anneals rest on it.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from montecarlosolvers_tpu.ops.metropolis import (
    metropolis_accept as jax_accept,
)
from montecarlosolvers_tpu.ops.pallas_qmc import _uniform01_4d
from montecarlosolvers_tpu.ops.pallas_sa import _uniform01
from montecarlosolvers_tpu_torch.ops import counter_rng as cr
from montecarlosolvers_tpu_torch.ops.metropolis import metropolis_accept

torch.set_num_threads(1)

SEED_MULT = 2654435761 - (1 << 32)


def _jax_ctr(seed, t, idx):
    return (
        jnp.int32(seed) * jnp.int32(SEED_MULT)
        + jnp.int32(t) * jnp.int32(40503)
        + jnp.int32(idx) * jnp.int32(1013904223)
    )


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1, -(2**31), -7])
def test_uniforms_bitwise_on_random_pairs(seed):
    # ~1.2e6 (counter, uid) pairs in all: negative and wrapping values
    r = np.random.default_rng(abs(seed) % 1000)
    n = 1 << 18
    uid = r.integers(-(2**31), 2**31, size=n, dtype=np.int64).astype(np.int32)
    ctr = r.integers(-(2**31), 2**31, size=n, dtype=np.int64).astype(np.int32)
    ref = np.asarray(_uniform01(jnp.asarray(ctr), jnp.asarray(uid)))
    out = cr.uniform01(torch.from_numpy(ctr), torch.from_numpy(uid)).numpy()
    assert out.dtype == np.float32
    assert np.array_equal(ref.view(np.int32), out.view(np.int32))
    assert out.min() >= 0.0 and out.max() < 1.0
    # counters of wrapping (seed, step, index) with a Python-int counter
    for t in (0, 1, 40502, 2**31 - 1):
        for idx in range(6):
            c = cr.counter(seed, t, idx)
            assert c == int(_jax_ctr(seed, t, idx))
            ref = np.asarray(_uniform01(_jax_ctr(seed, t, idx),
                                        jnp.asarray(uid[:4096])))
            out = cr.uniform01(c, torch.from_numpy(uid[:4096])).numpy()
            assert np.array_equal(ref, out)


@pytest.mark.parametrize("chains,Q,nh", [(3, 1, 50), (4, 3, 128), (2, 20, 3200)])
def test_uid_formulas_match_kernels(chains, Q, nh):
    flat = np.arange(nh, dtype=np.int32)
    chain = np.arange(chains, dtype=np.int32)
    qid = np.arange(Q, dtype=np.int32)
    for color in (0, 1):
        # SA (pallas_split.py:142) and line uids (:492)
        ref = (jnp.asarray(chain)[:, None] * jnp.int32(2 * nh)
               + jnp.int32(color * nh) + jnp.asarray(flat)[None, :])
        assert np.array_equal(cr.sa_uids(chains, nh, color, "cpu").numpy(),
                              np.asarray(ref))
    for idx in range(4):
        # quarter uids (pallas_split.py:483-486)
        ref = (jnp.asarray(chain)[:, None, None] * jnp.int32(4 * Q * nh)
               + jnp.int32(idx * Q * nh)
               + jnp.asarray(qid)[None, :, None] * jnp.int32(nh)
               + jnp.asarray(flat)[None, None, :])
        out = cr.quarter_uids(chains, Q, nh, idx, "cpu").numpy()
        assert np.array_equal(out, np.asarray(ref))


def _jax_plane_ids(chains, L, slices=None):
    """The full-plane kernels' site ids on the padded plane, as
    pallas_sa.py:166-175 and pallas_qmc.py:83-97 build them from iotas,
    cut to the physical L x L sites."""
    R, C = -(-L // 8) * 8, -(-L // 128) * 128
    if slices is None:
        ch, r, c = (jnp.arange(n, dtype=jnp.int32) for n in (chains, R, C))
        ids = (ch[:, None, None] * jnp.int32(R * C)
               + r[None, :, None] * jnp.int32(C) + c[None, None, :])
        return np.array(ids)[:, :L, :L]
    ch, k, r, c = (jnp.arange(n, dtype=jnp.int32)
                   for n in (chains, slices, R, C))
    ids = (ch[:, None, None, None] * jnp.int32(slices * R * C)
           + k[None, :, None, None] * jnp.int32(R * C)
           + r[None, None, :, None] * jnp.int32(C) + c[None, None, None, :])
    return np.array(ids)[:, :, :L, :L]


@pytest.mark.parametrize("chains,L,P", [(3, 5, None), (2, 80, None),
                                        (2, 81, 5), (4, 6, 3), (1, 129, 2)])
def test_plane_uids_match_kernels(chains, L, P):
    """Padded strides: at L = 80 a row is C = 128 ids wide, at L = 81 the
    plane is R = 88 rows deep, at L = 129 C = 256."""
    out = cr.plane_uids(chains, L, "cpu", slices=P).numpy()
    assert np.array_equal(out, _jax_plane_ids(chains, L, P))


@pytest.mark.parametrize("seed", [0, 12345, 2**31 - 1, -(2**31), -7])
def test_full_plane_counters_and_uniforms_bitwise(seed):
    """Local phase p / SA color p: counter(seed, t, p) is the Pallas
    kernels' base + p * 1013904223. Line moves: ((seed * M + t * 40503) XOR
    374761393) + color * 69069 (pallas_qmc.py:124,131-133). Uniforms at
    the kernels' ids equal `_uniform01_4d` and `_uniform01` bitwise."""
    sd = jnp.int32(seed)
    ids4 = _jax_plane_ids(2, 6, 3)
    ids3 = _jax_plane_ids(2, 7)
    for t in (0, 1, 999, 2**31 - 1):
        base = sd * jnp.int32(SEED_MULT) + jnp.int32(t) * jnp.int32(40503)
        for p in range(3):
            ref = base + jnp.int32(p * 1013904223)
            assert cr.counter(seed, t, p) == int(ref)
            got = cr.uniform01(cr.counter(seed, t, p),
                               torch.from_numpy(ids4)).numpy()
            assert np.array_equal(
                got, np.asarray(_uniform01_4d(ref, jnp.asarray(ids4))))
        for color in (0, 1):
            ref = (base ^ jnp.int32(374761393)) + jnp.int32(color * 69069)
            assert cr.line_counter(seed, t, color) == int(ref)
            got = cr.uniform01(cr.line_counter(seed, t, color),
                               torch.from_numpy(ids4[:, 0])).numpy()
            assert np.array_equal(got, np.asarray(
                _uniform01_4d(ref, jnp.asarray(ids4))[:, 0]))
            ref = base + jnp.int32(color * 1013904223)
            got = cr.uniform01(cr.counter(seed, t, color),
                               torch.from_numpy(ids3)).numpy()
            assert np.array_equal(
                got, np.asarray(_uniform01(ref, jnp.asarray(ids3))))


def test_logical_shift_emulation():
    x = torch.tensor([-1, -(2**31), 2**31 - 1, 0, -123456789],
                     dtype=torch.int32)
    for n in (8, 13, 16):
        want = (x.numpy().view(np.uint32) >> n).view(np.int32)
        assert np.array_equal(cr._srl(x, n).numpy(), want)


def test_metropolis_accept_matches_jax():
    r = np.random.default_rng(3)
    de = r.normal(scale=2.0, size=100_000).astype(np.float32)
    de[:100] = 0.0
    u = cr.uniform01(
        0, torch.arange(100_000, dtype=torch.int32)).numpy()
    for temp in (0.0, 0.05, 1.5, float("nan")):
        t32 = np.float32(temp)
        ref = np.asarray(jax_accept(jnp.asarray(de), t32, jnp.asarray(u)))
        out = metropolis_accept(torch.from_numpy(de),
                                torch.tensor(t32), torch.from_numpy(u))
        assert np.array_equal(ref, out.numpy())
        if np.isnan(temp):
            assert not out.any()  # a NaN step is an exact no-op
