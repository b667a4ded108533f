"""Counter-hash uniforms, bitwise equal to the JAX package's Pallas kernels.

Counterpart of `montecarlosolvers_tpu/ops/pallas_sa.py::_mix32` and
`_uniform01`, and of the counter / uid formulas of
`ops/pallas_split.py::_split_kernel` and `_qmc_split_kernel`. The CUDA
kernels in `csrc/` compute the same hash on `uint32_t`; this module is the
plain form on int32 tensors that the CPU path and the tests use.

Every uniform is a pure function of (seed, step, index, uid):

    ctr = seed * SEED_MULT + step * STEP_MULT + index * INDEX_MULT
    u   = (mix32(uid * GOLDEN + ctr) >>> 8) / 2**24        in [0, 1)

with all integer arithmetic wrapping mod 2**32.

Two torch pitfalls this module avoids:
  * `>>` on an int32 tensor is an arithmetic shift; the hash needs a logical
    one, emulated as `(x >> n) & ((1 << (32 - n)) - 1)`.
  * Every constant is the signed int32 form the JAX code uses (for example
    `2654435761 - 2**32`), so no unsigned literal is left to torch's scalar
    conversion.
"""

from __future__ import annotations

import torch

# multipliers of the counter (pallas_split.py:137-141)
SEED_MULT = 2654435761 - (1 << 32)  # 0x9e3779b1 as int32
STEP_MULT = 40503
INDEX_MULT = 1013904223
# per-site multiplier of _uniform01 (pallas_sa.py:131)
GOLDEN = -1640531527  # 0x9e3779b9 as int32
# murmur3 finalizer constants (pallas_sa.py:122-124)
_M1 = -2048144789  # 0x85ebca6b
_M2 = -1028477387  # 0xc2b2ae35


def wrap_int32(x):
    """Python int -> the int32 it wraps to (two's complement)."""
    return ((int(x) + (1 << 31)) % (1 << 32)) - (1 << 31)


def counter(seed, step, index):
    """The per-(seed, step, index) counter as a wrapped Python int. Python
    integers are exact, and wrapping once at the end gives the same bits as
    wrapping after every int32 operation."""
    return wrap_int32(seed * SEED_MULT + step * STEP_MULT + index * INDEX_MULT)


def _srl(x, n):
    """Logical right shift of an int32 tensor by a constant 0 < n < 32."""
    return (x >> n) & ((1 << (32 - n)) - 1)


def mix32(x):
    """murmur3 finalizer, twice, on an int32 tensor (wrapping multiplies)."""
    for _ in range(2):
        x = x ^ _srl(x, 16)
        x = x * _M1
        x = x ^ _srl(x, 13)
        x = x * _M2
        x = x ^ _srl(x, 16)
    return x


def hashed_uid(uid):
    """`uid * GOLDEN`, the per-site half of the hash input; callers that draw
    many steps for the same sites compute it once."""
    return uid * GOLDEN


def uniform01_hashed(ctr, huid):
    """Uniforms in [0, 1) with 24-bit resolution from a Python-int counter
    and a `hashed_uid` tensor."""
    bits = mix32(huid + ctr)
    return _srl(bits, 8).to(torch.float32) * (1.0 / (1 << 24))


def uniform01(ctr, uid):
    """Counterpart of `pallas_sa._uniform01(ctr, site_ids)`. `ctr` is a
    Python int or an int32 tensor broadcastable against the int32 `uid`."""
    return uniform01_hashed(ctr, hashed_uid(uid))


def sa_uids(chains, nh, color, device):
    """(chains, nh) uids of the SA kernel's half `color`
    (pallas_split.py:142): chain * 2nh + color * nh + site. PIQMC line moves
    of `color` use the same uids (pallas_split.py:492)."""
    chain = torch.arange(chains, dtype=torch.int32, device=device)[:, None]
    flat = torch.arange(nh, dtype=torch.int32, device=device)[None, :]
    return chain * (2 * nh) + color * nh + flat


def quarter_uids(chains, q_len, nh, index, device):
    """(chains, Q, nh) uids of PIQMC quarter `index` in 0..3
    (pallas_split.py:483-486): chain * 4Qnh + index * Qnh + q * nh + site."""
    chain = torch.arange(chains, dtype=torch.int32, device=device)
    qid = torch.arange(q_len, dtype=torch.int32, device=device)
    flat = torch.arange(nh, dtype=torch.int32, device=device)
    return (
        chain[:, None, None] * (4 * q_len * nh)
        + index * q_len * nh
        + qid[None, :, None] * nh
        + flat[None, None, :]
    )
