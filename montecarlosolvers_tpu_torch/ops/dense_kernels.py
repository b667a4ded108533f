"""The dense engine on a DenseProblem: the in-block kernel's wrapper and
plain version, the anneals on the counter hash, and the problem-level
`dense_anneal`.

No Pallas kernel covers this path: the JAX package runs it as XLA,
`ops/dense_sweep.py::dense_anneal` (:132-161) over `dense_metropolis_sweep`
(:45), whose sequential part is a `lax.fori_loop` of B micro-steps a
block. The port keeps the block products a `torch.matmul` and gives the
micro-steps, the add of the block's h included, a hand-written CUDA
kernel, `csrc/dense_sa.cu`: one launch a block, one warp a chain, the
block's B x B diagonal tile of J in shared memory.

Uniforms come from the counter hash (`ops/counter_rng.py`): sweep t draws
u = uniform01(counter(seed, t, 0), chain * Np + p) at padded position p
in visit order, padding included. With `shuffle`, the visit order of
sweep t is the stable argsort of mix32(GOLDEN * i + counter(seed, t, 1))
over the sites i, its own stream: the JAX package draws its permutation
from `jax.random`, so the shuffled anneals agree with it in distribution
only (the plain sweep, `ops/dense_sweep.py`, takes JAX's permutation and
uniforms and agrees bitwise).

`dense_sa_block` dispatches on the device of the spins: a CPU tensor takes
the plain `dense_sa_block_ref`; a CUDA tensor launches the kernel or
raises. `_build.LAUNCHES["dense_sa"]` counts one a block launch: sweeps x
ceil(N / B) an anneal. The products are library calls and are not counted.
"""

from __future__ import annotations

import math

import torch

from montecarlosolvers_tpu_torch import schedules
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import counter_rng as cr
from montecarlosolvers_tpu_torch.ops import dense_sweep as ds
from montecarlosolvers_tpu_torch.ops.split_kernels import (energy_buffer,
                                                           with_energies)

# csrc/dense_sa.cu: warps (chains) a CTA, 1 to 8 (its launch bound), and
# the largest block its tile and registers take. Eight warps ran fastest at
# 1024 and 64 chains, ahead of 4 and 16 and of two or four chains a warp
# (PERF.md)
WARPS, MAX_BLOCK = 8, 128
# the counter index of the visit-order stream (the uniforms take index 0)
PERM_INDEX = 1


def block_uniforms(seed, step, chains, np_, start, B, device, chain0=0):
    """(chains, B) uniforms of the block at `start` in sweep `step`:
    uniform01(counter(seed, step, 0), chain * Np + start + j), the chains
    counted from chain0 (a chain shard)."""
    chain = cr._chains(chains, chain0, device)[:, None]
    pos = torch.arange(start, start + B, dtype=torch.int32,
                       device=device)[None, :]
    return cr.uniform01(cr.counter(seed, step, 0), chain * np_ + pos)


def visit_order(seed, step, n, device):
    """The (n,) int64 visit order of sweep `step` with shuffle: the stable
    argsort of the 32 hash bits of each site on counter(seed, step, 1)."""
    sites = torch.arange(n, dtype=torch.int32, device=device)
    keys = cr.mix32(cr.hashed_uid(sites) + cr.counter(seed, step, PERM_INDEX))
    return torch.sort(keys, stable=True).indices


def dense_sa_block_ref(s, fb, h, J, start, temps, step, seed, step0=0,
                       chain0=0):
    """Plain form of csrc/dense_sa.cu: the micro-steps of the block at
    `start` (`dense_sweep.block_steps`) on the uniforms of
    `block_uniforms` at sweep step0 + step, at temperature temps[step] (a
    (steps, chains) `temps` gives each chain its own), in place on padded
    (chains, Np) spins `s`; fb (chains, B) the block's products
    (`dense_sweep.block_product`), to which h[start:start+B] of the padded
    fields `h` (Np,) is added; J (Np, Np) the padded couplings; chain0 the
    global index of the first chain (a chain shard, whose uids count from
    it)."""
    chains, np_ = s.shape
    u = block_uniforms(seed, step0 + step, chains, np_, start, fb.shape[1],
                       s.device, chain0)
    return ds.block_steps(s, fb, h, J, start, u, temps[step])


def dense_sa_block(s, fb, h, J, start, temps, step, seed, step0=0,
                   chain0=0):
    """csrc/dense_sa.cu on CUDA tensors, `dense_sa_block_ref` on CPU
    tensors; arguments as for the plain version (s updated in place, B =
    fb.shape[1] <= MAX_BLOCK on the card; the kernel adds h itself), one
    warp a chain in CTAs of WARPS warps. One launch (LAUNCHES["dense_sa"];
    with a (steps, chains) `temps`, the per-chain instantiation,
    LAUNCHES["dense_sa_chain"])."""
    if _build.route(s.device, "dense") == "cpu":
        return dense_sa_block_ref(s, fb, h, J, start, temps, step, seed,
                                  step0, chain0)
    chains, np_ = s.shape
    B = fb.shape[1]
    if not 0 < B <= MAX_BLOCK:
        raise ValueError(f"the dense kernel takes 1 <= block <= {MAX_BLOCK}, "
                         f"got {B}")
    dev = s.device
    _build.check_arg(s, "spins", (chains, np_), dev)
    _build.check_arg(fb, "products", (chains, B), dev)
    _build.check_arg(h, "h", (np_,), dev)
    _build.check_arg(J, "J", (np_, np_), dev)
    strides = _build.schedule_strides(temps, "temps", temps.shape[0], chains,
                                      dev)
    if not (0 <= start <= np_ - B and 0 <= step < temps.shape[0]):
        raise ValueError(f"block at {start} of {B} or step {step} out of "
                         "range")
    lib = _build.library("dense_sa")
    rc = lib.dense_sa_block(
        _build.ptr(J), _build.ptr(fb), _build.ptr(h),
        _build.ptr(temps), _build.ptr(s), chains, np_, start, B, step,
        step0 + step, cr.wrap_int32(seed), WARPS, *strides,
        int(chain0), _build.stream_of(dev))
    _build.raise_on_error(lib, "dense_sa_block", rc)
    _build.LAUNCHES["dense_sa_chain" if strides[1] else "dense_sa"] += 1
    return s


def _anneal(dp, temps, spins, seed, block, shuffle, matmul_dtype, energies,
            step_fn, step0=0, chain0=0):
    """Anneal (C, N) spins over the float32 (steps,) `temps` (or a (steps,
    C) table, a temperature a chain and sweep) with the micro-step function
    `step_fn` (`dense_sa_block` or its plain version), the hash counting
    sweep t as step0 + t and the chains from chain0; with `energies`, a
    (steps, C) buffer, row t receives dp.energy after sweep t."""
    C, N = spins.shape
    B = ds.block_size(block, N)
    J = ds.rounded(dp.J, matmul_dtype)
    if not shuffle:
        Jp, hp, s = ds.padded(J, dp.h, spins.clone(), B)
    for t in range(temps.shape[0]):
        if shuffle:
            perm = visit_order(seed, step0 + t, N, spins.device)
            Jp, hp, s = ds.padded(J[perm][:, perm], dp.h[perm],
                                  spins[:, perm], B)
        for start in range(0, Jp.shape[0], B):
            step_fn(s, ds.block_product(s, Jp, start, B), hp, Jp, start,
                    temps, t, seed, step0, chain0)
        if shuffle:
            spins = torch.empty_like(spins)
            spins[:, perm] = s[:, :N]
        if energies is not None:
            energies[t] = dp.energy(s[:, :N] if not shuffle else spins)
    return spins if shuffle else s[:, :N].contiguous()


def dense_sa_anneal_ref(dp, temps, spins, seed, block=128, shuffle=False,
                        matmul_dtype=None, energies=None, step0=0,
                        chain0=0):
    """Plain anneal of (C, N) spins on `dense_sa_block_ref`, on any device:
    what the kernel's anneal is held to."""
    return _anneal(dp, temps, spins, seed, block, shuffle, matmul_dtype,
                   energies, dense_sa_block_ref, step0, chain0)


def dense_sa_anneal(dp, temps, spins, seed, block=128, shuffle=False,
                    matmul_dtype=None, energies=None, step0=0, chain0=0):
    """Anneal of (C, N) spins on `dense_sa_block`: the kernel on a CUDA
    device, the plain version on the CPU. temps: float32 (steps,) on the
    spins' device, or a (steps, C) table (a temperature a chain: the
    per-chain instantiation); seed: int counter-hash seed; block, shuffle,
    matmul_dtype: see `ops/dense_sweep.py`; step0: the sweep the hash
    counts sweep 0 as; chain0: the global index of the first chain (a
    chain shard, whose uids count from it). Returns the new spins."""
    return _anneal(dp, temps, spins, seed, block, shuffle, matmul_dtype,
                   energies, dense_sa_block, step0, chain0)


def dense_anneal(dp, sched, spins, seed, mcsteps=1, block=128,
                 collect_energy=False, shuffle=False, matmul_dtype=None,
                 chain0=0):
    """Thermal anneal on a DenseProblem (JAX `dense_anneal`,
    ops/dense_sweep.py:132): sequential-scan sweeps of (..., N) spins on
    the problem's device, any batch shape; sched (steps,) temperatures,
    mcsteps sweeps a step; collect_energy also returns the energy after
    each sweep, (steps * mcsteps,) + batch; chain0: the global index of the
    first chain (a chain shard). Returns the spins, same shape, or (spins,
    energies)."""
    if spins.device != dp.device:
        raise ValueError(f"spins is on {spins.device}, problem on "
                         f"{dp.device}")
    temps = schedules.expand_mcsteps(sched, mcsteps, dp.device)
    batch = spins.shape[:-1]
    es = energy_buffer(collect_energy, temps.shape[0], batch, dp.device)
    s = spins.to(torch.float32).reshape(math.prod(batch), dp.nspins)
    out = dense_sa_anneal(dp, temps, s, seed, block, shuffle, matmul_dtype,
                          es, chain0=chain0)
    return with_energies(out.reshape(spins.shape), es, batch)
