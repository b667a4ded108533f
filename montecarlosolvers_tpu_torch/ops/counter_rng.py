"""Counter-hash uniforms, bitwise equal to the JAX package's Pallas kernels.

Counterpart of `montecarlosolvers_tpu/ops/pallas_sa.py::_mix32` and
`_uniform01`, and of the counter / uid formulas of
`ops/pallas_split.py::_split_kernel`, `_qmc_split_kernel` and
`_svmc_split_kernel` and of the full-plane kernels
`ops/pallas_sa.py::_sa_kernel`, `ops/pallas_qmc.py::_qmc_kernel` and
`ops/pallas_svmc.py::_svmc_kernel`. The CUDA kernels in `csrc/` compute the
same hash on `uint32_t`; this module is the plain form on int32 tensors that
the CPU path and the tests use.

Every uniform is a pure function of (seed, step, index, uid):

    ctr = seed * SEED_MULT + step * STEP_MULT + index * INDEX_MULT
    u   = (mix32(uid * GOLDEN + ctr) >>> 8) / 2**24        in [0, 1)

with all integer arithmetic wrapping mod 2**32. The full-plane PIQMC line
moves use another counter, `line_counter`, and the full-plane SVMC
acceptances a third, `svmc_accept_counter`. The split SVMC kernel draws its
proposals at index 0 / 1 and its acceptances at index 2 / 3, both at the SA
uids of the half (`sa_uids(chains, nh, index % 2)`).

The generic engines on an IsingProblem (`ops/generic_kernels.py`, which no
Pallas kernel covers) use the same hash at `generic_uids`, keyed by each
site's original index: one uniform per site and sweep at counter(seed, t,
0), the PIQMC line moves at line_counter(seed, t, 0) and the SVMC
acceptances at svmc_accept_counter(seed, t, 0).

The cluster updates (`ops/cluster.py`, `ops/cluster_kernels.py`,
csrc/fk_*.cu; no Pallas kernel covers them either) draw from streams of
their own, `cluster_counter(seed, t, stream) = counter(seed, t,
CLUSTER_INDEX + stream)`, one stream a kind of draw. Their uids are keyed
so that a kernel can draw a bond only when its search reaches it and still
get the uniform the plain version drew for it; `ids` is each site's
ORIGINAL index (the packed layout's `perm`), P the slices, N the spins,
maxnb the table's slots:

    stream        draw                                uid
    SP_BOND       spatial bond of slot m of the       ((chain * P + k) * N
                  row of the pair's endpoint whose       + ids[i]) * maxnb + m
                  id is lower (rule "full": of
                  either row), slice k
    TROTTER_BOND  bond (k, k + 1 mod P) of spin i     (chain * P + k) * N
                                                         + ids[i]
    BATH_BOND     bath pair (lo, hi) = (min(k, q),    ((chain * N + ids[i])
                  max(k, q)) of spin i's line           * P + lo) * P + hi
    WOLFF_SEED    the Wolff seed's packed position    2 * chain
                  and its slice, floor(u * n)         2 * chain + 1
                  clamped to n - 1
    ACCEPT        the field accept of the Wolff       chain
                  cluster
    LINE_ACCEPT   the accept of a line's cluster,     (chain * P + k) * N
                  k = 0 (bath_cluster_phase) or        + ids[i]
                  its lowest slice (sw_full_phase)
    LINE_SEED     a line's seed slice (WC2), once a   chain * N + ids[i]
                  sweep, floor(u * P) clamped
    COIN          the Swendsen-Wang coin of the       chain * P * N + label
                  component labeled `label` (its
                  least k * N + ids[i]), u < 0.5
    GHOST         the ghost-spin bond of site (k, i)  (chain * P + k) * N
                                                         + ids[i]

A step's draws are keyed by step only: the color phases of one sweep read
the same uniforms, and each line uses them only in its own color's phase.
The indices CLUSTER_INDEX + stream and the 0..3 of the other kernels differ
by at most 16, and d * INDEX_MULT = dt * STEP_MULT (mod 2**32) has no
solution with 0 < d <= 36 and |dt| < 2**26: no cluster counter equals
counter(seed, t', 0), the local sweeps' counter, for any two steps of a
schedule shorter than 67 million sweeps. The cluster solvers run their
local sweeps without line moves, so no other counter shares their seed.

The samplers (`solvers/pt.py`, `solvers/pa.py`, the Houdayer move of
`ops/cluster.py` and csrc/houdayer.cu) draw from streams of their own,
`sampler_counter(seed, t, stream) = counter(seed, t, SAMPLER_INDEX +
stream)`, at the step t of the sweep clock (PT and ICM: the sweep after
which the exchange or move happens; PA: the schedule step). Their sweeps
keep the uids above, keyed by the chain's place in the batch, so a
chain's stream does not depend on the rung it holds. B is the batch of
ladders (reads, or ICM's pairs x 2 ladders), M the rungs, R the
population, N the spins:

    stream        draw                                uid
    EXCHANGE      the exchange uniform of anchor      ladder * M + rung
                  rung k of a ladder (pair k, k + 1)
    SYSTEMATIC    PA's one systematic-resampling      0
                  offset of the step
    MULTINOMIAL   PA's multinomial draw of replica    replica
                  slot i (inverse CDF)
    HOUDAYER      the coin of the overlap component   pair * N + label
                  labelled `label` (its least site
                  id) of ICM pair (read, rung), u <
                  0.5, so every member reads one coin
    MERGE         merge_populations' run draw of      2 * slot
                  output slot i, and its replica      2 * slot + 1
                  draw

The ICM pair (read, rung) of the HOUDAYER stream is read * M + rung, the
pair's place in the launch. SAMPLER_INDEX + stream lies in 24..28, inside
the 36 indices the bound above covers: no sampler counter equals a
sweep's, a line move's or a cluster stream's counter for any two steps of
a run shorter than 67 million sweeps.

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
# line-move counter of the full-plane PIQMC kernel (pallas_qmc.py:124,132);
# the full-plane SVMC kernel XORs its acceptance counter with the same value
# (pallas_svmc.py:94)
LINE_XOR = 374761393
LINE_MULT = 69069
# first counter index of the cluster streams, and the streams
CLUSTER_INDEX = 8
(SP_BOND, TROTTER_BOND, BATH_BOND, WOLFF_SEED, ACCEPT, LINE_ACCEPT,
 LINE_SEED, COIN, GHOST) = range(9)
# first counter index of the sampler streams, and the streams
SAMPLER_INDEX = 24
EXCHANGE, SYSTEMATIC, MULTINOMIAL, HOUDAYER, MERGE = range(5)
# TPU tile of the full-plane kernels' padded planes (pallas_sa.py:57-58):
# their site ids stride by pad8(L) rows of pad128(L) columns
SUBLANE = 8
LANE = 128


def wrap_int32(x):
    """Python int -> the int32 it wraps to (two's complement)."""
    return ((int(x) + (1 << 31)) % (1 << 32)) - (1 << 31)


def counter(seed, step, index):
    """The per-(seed, step, index) counter as a wrapped Python int. Python
    integers are exact, and wrapping once at the end gives the same bits as
    wrapping after every int32 operation."""
    return wrap_int32(seed * SEED_MULT + step * STEP_MULT + index * INDEX_MULT)


def line_counter(seed, step, color):
    """Counter of the full-plane PIQMC line moves of `color`
    (pallas_qmc.py:124,131-133): an XOR of the (seed, step) base with
    LINE_XOR, then `color * LINE_MULT` added. Python's `^` on the wrapped
    base acts on its two's-complement bits, as int32 XOR does."""
    base = wrap_int32(seed * SEED_MULT + step * STEP_MULT)
    return wrap_int32((base ^ LINE_XOR) + color * LINE_MULT)


def svmc_accept_counter(seed, step, color):
    """Counter of the full-plane SVMC acceptance uniforms of `color`
    (pallas_svmc.py:93-96): `counter(seed, step, color)` XOR LINE_XOR. The
    Pallas expression `base + color * INDEX_MULT ^ 374761393` adds first,
    since `+` binds tighter than `^`; unlike `line_counter`, nothing is
    added after the XOR."""
    return wrap_int32(counter(seed, step, color) ^ LINE_XOR)


def cluster_counter(seed, step, stream):
    """Counter of cluster stream `stream` at `step` (module docstring)."""
    return counter(seed, step, CLUSTER_INDEX + stream)


def sampler_counter(seed, step, stream):
    """Counter of sampler stream `stream` at `step` (module docstring)."""
    return counter(seed, step, SAMPLER_INDEX + stream)


def sampler_uniforms(seed, step, stream, n, device, uid0=0):
    """(n,) float32 uniforms of sampler stream `stream` at `step`, uids
    uid0..uid0+n-1 (the table's layouts are all flat indices; uid0 > 0 is
    a block of a longer table), wrapping as int32."""
    uid = _chains(n, uid0, device)
    return uniform01(sampler_counter(seed, step, stream), uid)


def index_draw(u, n):
    """floor(u * n) clamped to n - 1, as int64, for float32 uniforms `u`:
    how a seed position or slice is drawn from one uniform (the product is
    rounded in float32, as the kernels round it)."""
    return torch.floor(u * float(n)).long().clamp(max=n - 1)


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


def _chains(chains, chain0, device):
    """(chains,) int32 global chain indices chain0 .. chain0 + chains - 1:
    a chain shard's chains, whose uids count from the global chain, so
    that the shard draws the unsharded run's uniforms (0: unsharded). The
    uids wrap as int32, as the kernels' uint32 ones do."""
    return (torch.arange(chains, dtype=torch.int64, device=device)
            + chain0).to(torch.int32)


def sa_uids(chains, nh, color, device, chain0=0):
    """(chains, nh) uids of the SA kernel's half `color`
    (pallas_split.py:142): chain * 2nh + color * nh + site. PIQMC line moves
    of `color` use the same uids (pallas_split.py:492). chain0: the global
    index of the first chain (a chain shard)."""
    chain = _chains(chains, chain0, device)[:, None]
    flat = torch.arange(nh, dtype=torch.int32, device=device)[None, :]
    return chain * (2 * nh) + color * nh + flat


def quarter_uids(chains, q_len, nh, index, device, chain0=0, q0=0,
                 q_total=None):
    """(chains, Q, nh) uids of PIQMC quarter `index` in 0..3
    (pallas_split.py:483-486): chain * 4Qnh + index * Qnh + q * nh + site.

    A shard of the state draws the unsharded run's uniforms: chain0 is the
    global index of its first chain, q0 the global index of its first
    quarter row and q_total the global Q (default q_len); the rows are
    then q0 .. q0 + q_len - 1 of a Q = q_total state."""
    q_total = q_len if q_total is None else q_total
    chain = _chains(chains, chain0, device)
    qid = torch.arange(q0, q0 + q_len, dtype=torch.int32, device=device)
    flat = torch.arange(nh, dtype=torch.int32, device=device)
    return (
        chain[:, None, None] * wrap_int32(4 * q_total * nh)
        + wrap_int32(index * q_total * nh)
        + qid[None, :, None] * nh
        + flat[None, None, :]
    )


def plane_strides(L):
    """(R, C) = (pad8(L), pad128(L)): the padded plane of the full-plane
    Pallas kernels (pallas_sa.py:90). The port stores only the L x L sites,
    but its site ids keep these strides, so that every stream equals the
    Pallas kernel's (at L = 80, C = 128, not 80)."""
    return (-(-L // SUBLANE) * SUBLANE, -(-L // LANE) * LANE)


def plane_uids(chains, L, device, slices=None, chain0=0):
    """Site ids of the full-plane kernels on the physical sites.

    slices=None: (chains, L, L), the SA kernel's chain*R*C + r*C + c
    (pallas_sa.py:171-175). slices=P: (chains, P, L, L), the PIQMC
    kernel's chain*P*R*C + k*R*C + r*C + c (pallas_qmc.py:91-97); its line
    moves use the k = 0 plane of these (pallas_qmc.py:135-137). chain0:
    the global index of the first chain (a chain shard)."""
    R, C = plane_strides(L)
    rows = torch.arange(L, dtype=torch.int32, device=device)[:, None]
    cols = torch.arange(L, dtype=torch.int32, device=device)[None, :]
    site = rows * C + cols  # (L, L)
    chain = _chains(chains, chain0, device)
    if slices is None:
        return chain[:, None, None] * (R * C) + site
    k = torch.arange(slices, dtype=torch.int32, device=device)
    return (chain[:, None, None, None] * (slices * R * C)
            + k[None, :, None, None] * (R * C) + site)


def generic_uids(chains, sites, nspins, slices=None, chain0=0, k0=0,
                 p_total=None):
    """Site ids of the generic engines (IsingProblem graphs), keyed by the
    ORIGINAL index of each site, so that the masked engine (sites = 0..N-1)
    and the packed one (sites = the packed layout's `perm`) draw the same
    uniform at the same site.

    sites: int32 tensor of original indices, on the device to draw on.
    slices=None: (chains, len(sites)), chain * N + site. slices=P:
    (chains, P, len(sites)), (chain * P + k) * N + site; the PIQMC line
    moves use the k = 0 ids of these, under `line_counter`. A shard of the
    state draws the unsharded run's uniforms: chain0 is the global index
    of its first chain, k0 that of its first slice and p_total the global
    P (default `slices`), the slices then k0 .. k0 + slices - 1."""
    chain = _chains(chains, chain0, sites.device)
    if slices is None:
        return chain[:, None] * nspins + sites
    p_total = slices if p_total is None else p_total
    k = torch.arange(k0, k0 + slices, dtype=torch.int32, device=sites.device)
    row = chain[:, None] * wrap_int32(p_total) + k[None, :]  # (chains, P)
    return row[:, :, None] * nspins + sites
