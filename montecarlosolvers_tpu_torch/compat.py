"""Drop-in compatibility layer: the reference's exact API surface
(counterpart of montecarlosolvers_tpu/compat.py).

Every public kernel of the reference under its original name and
signature, with the reference's conventions:

  * neighbor tables in the (nspins, maxnb, 2) format of
    tools.GenerateNeighbors (tools.pyx:28-96), diagonal self-entries as
    local fields;
  * states mutated IN PLACE (sa.pyx:44-46): the NumPy array passed in
    holds the result, in its own dtype;
  * confs in the reference's spins-major (nspins, P) layout (qmc.pyx:69).

`seed`: an integer, a numpy Generator / RandomState (which gives the
integer, drawn as the JAX shims draw it), or None for a fresh
nondeterministic seed. It seeds a `torch.Generator` on the run's device
(`_key`), from which the port's solvers draw their counter-hash seed; the
JAX shims key `jax.random` with the same integer, so the two agree in
distribution, not bitwise.

One addition to the reference signatures: a keyword-only `device=None`,
the device the problem and the states live on while the shim runs (None:
the CUDA card, `_device.resolve`; the CPU tests pass "cpu"). `nthreads`
is accepted and ignored, as in the JAX shims.

Every shim runs on the port's solvers: `sa.anneal` and `anneal_noisy`,
`qmc.anneal` (local, global, bath), `qmc.anneal_wolff` (WCL, WC),
`qmc.anneal_sw_bath` (WC2, WC3), `svmc.anneal` and `anneal_noisy`. A
reference table builds an IsingProblem, so on the card they run the
generic kernels (csrc/packed_sa.cu, generic_qmc.cu, generic_qmc_bath.cu,
packed_svmc.cu, fk_wolff.cu, fk_line.cu and the noisy strides of the
packed kernels).
"""

from __future__ import annotations

import collections
import hashlib

import numpy as np
import torch

from montecarlosolvers_tpu_torch import _device
from montecarlosolvers_tpu_torch.models.ising import (
    IsingProblem,
    generate_neighbors as GenerateNeighbors,  # noqa: N812  (reference name)
    classical_ising_energy as ClassicalIsingEnergy,  # noqa: N812
    bits2spins,
    spins2bits,
)
from montecarlosolvers_tpu_torch.solvers import qmc as _qmc
from montecarlosolvers_tpu_torch.solvers import sa as _sa
from montecarlosolvers_tpu_torch.solvers import svmc as _svmc

__all__ = [
    "GenerateNeighbors", "ClassicalIsingEnergy", "bits2spins", "spins2bits",
    "Anneal", "AnnealMA", "Anneal_parallel", "NoisyAnneal",
    "QuantumAnneal", "DissipativeQuantumAnneal", "QuantumAnnealGlobal",
    "DissipativeQuantumAnnealGlobal", "QuantumAnnealWCL",
    "DissaptiveQuantumAnnealWCL", "QuantumAnnealWC",
    "DissipativeQuantumAnnealWC2", "DissipativeQuantumAnnealWC3",
    "SpinVectorMonteCarlo", "SpinVectorMonteCarloTF", "NoisySVMC",
    "NoisySVMCTF", "SpinVectorMonteCarloCompact",
    "SpinVectorMonteCarloTFCompact",
]

_problem_cache = collections.OrderedDict()
_PROBLEM_CACHE_MAX = 32


def _key(seed, device=None):
    """The torch.Generator on `device` (None: the card) a shim draws from:
    an int seeds it; a numpy Generator gives integers(2**63), a
    RandomState randint(2**31), as the JAX `_key` draws them; None takes
    fresh entropy."""
    if seed is None:
        seed = np.random.SeedSequence().entropy % (2 ** 63)
    elif isinstance(seed, (np.random.Generator, np.random.RandomState)):
        seed = int(
            seed.integers(2 ** 63) if isinstance(seed, np.random.Generator)
            else seed.randint(2 ** 31)
        )
    gen = torch.Generator(device=_device.resolve(device))
    return gen.manual_seed(int(seed))


def _problem(nbs, device=None):
    """The IsingProblem of a reference-format table on `device`, from an
    LRU cache of the last 32, keyed by the table's digest and the device."""
    nbs = np.asarray(nbs)
    dev = _device.resolve(device)
    digest = (hashlib.sha1(nbs.tobytes()).digest(), nbs.shape, str(dev))
    prob = _problem_cache.get(digest)
    if prob is None:
        prob = IsingProblem.from_neighbor_table(nbs, device=dev)
        _problem_cache[digest] = prob
        while len(_problem_cache) > _PROBLEM_CACHE_MAX:
            _problem_cache.popitem(last=False)
    else:
        _problem_cache.move_to_end(digest)
    return prob


def _split_noisy(nbs4d, device=None):
    """(S, N, maxnb, 2) time-dependent table -> problem + per-step (S, N,
    maxnb) couplings and (S, N) fields, float32 on `device`.

    The coloring and padding topology is built from the UNION of slots
    active at any schedule step (max |J| over time), as the JAX shim
    builds it: a coupling that is zero at step 0 but ramps up later must
    still count as an edge, or two interacting spins could share a color
    class. The tables are built in numpy on the host and copied to the
    device once."""
    nbs4d = np.asarray(nbs4d)
    idx = nbs4d[:, :, :, 0].astype(np.int64)
    val = nbs4d[:, :, :, 1]
    topo = nbs4d[0].copy()
    topo[:, :, 1] = np.abs(val).max(axis=0)
    prob = _problem(topo, device)
    own = np.arange(nbs4d.shape[1])[None, :, None]
    is_self = idx == own
    h_t = np.where(is_self, val, 0.0).sum(axis=2)
    j_t = np.where(is_self, 0.0, val)
    return (prob,
            torch.as_tensor(j_t.astype(np.float32), device=prob.device),
            torch.as_tensor(h_t.astype(np.float32), device=prob.device))


def _f32(x, prob):
    """A schedule, state or lookuptable as float32 on the problem's
    device."""
    return torch.as_tensor(np.asarray(x, np.float32), device=prob.device)


def _write_back(dst, out):
    """The in-place write of the reference: dst[:] = out in dst's dtype."""
    dst[:] = out.cpu().numpy().astype(dst.dtype)


# ----------------------------------------------------------------- sa.pyx
def Anneal(sched, mcsteps, svec, nbs, seed=None, *, device=None):
    """sa.Anneal (sa.pyx:19-101): thermal anneal, svec updated in place."""
    prob = _problem(nbs, device)
    out = _sa.anneal(prob, _f32(sched, prob), _f32(svec, prob),
                     _key(seed, prob.device), mcsteps=int(mcsteps))
    _write_back(svec, out)


def AnnealMA(sched, mcsteps, svec, nbs, seed=None, *, device=None):
    """sa.AnnealMA (sa.pyx:108-193): the same sampler; the pre-drawn
    uniform streams are subsumed by the seed."""
    Anneal(sched, mcsteps, svec, nbs, seed=seed, device=device)


def Anneal_parallel(sched, mcsteps, svec, nbs, nthreads=None, seed=None, *,
                    device=None):
    """sa.Anneal_parallel (sa.pyx:201-284). nthreads is ignored: the
    colored sweep is exactly parallel, and trajectories are a batch axis
    of the native API."""
    Anneal(sched, mcsteps, svec, nbs, seed=seed, device=device)


def NoisyAnneal(sched, mcsteps, svec, nbs, seed=None, *, device=None):
    """sa.NoisyAnneal (sa.pyx:291-378): 4-D time-dependent neighbor table,
    first axis indexed by schedule step."""
    prob, j_t, h_t = _split_noisy(nbs, device)
    out = _sa.anneal_noisy(prob, _f32(sched, prob), j_t, h_t,
                           _f32(svec, prob), _key(seed, prob.device),
                           mcsteps=int(mcsteps))
    _write_back(svec, out)


# ---------------------------------------------------------------- qmc.pyx
def _qmc_call(fn, confs, nbs, seed, device, lookuptable=None):
    """Run a (P, N)-layout solver `fn(prob, a, b, confs, generator, lut)` on
    reference (N, P)-layout confs, in place."""
    prob = _problem(nbs, device)
    c = _f32(np.asarray(confs, np.float32).T, prob)
    lut = None if lookuptable is None else _f32(lookuptable, prob)
    out = fn(prob, c, _key(seed, prob.device), lut)
    confs[:] = out.cpu().numpy().T.astype(confs.dtype)


def _anneal(A_sched, B_sched, mcsteps, temp, **kw):
    """qmc.anneal over the reference's A / B schedules, for `_qmc_call`."""
    def run(prob, c, gen, lut):
        return _qmc.anneal(prob, _f32(A_sched, prob), _f32(B_sched, prob),
                           float(temp), c, gen, mcsteps=int(mcsteps),
                           lookuptable=lut, **kw)
    return run


def QuantumAnneal(A_sched, B_sched, mcsteps, temp, confs, nbs, nthreads=None,
                  seed=None, *, device=None):
    """qmc.QuantumAnneal (qmc.pyx:25-143): PIQMC, local moves only."""
    _qmc_call(_anneal(A_sched, B_sched, mcsteps, temp), confs, nbs, seed,
              device)


def DissipativeQuantumAnneal(A_sched, B_sched, mcsteps, temp, lookuptable,
                             confs, nbs, nthreads=None, seed=None, *,
                             device=None):
    """qmc.DissipativeQuantumAnneal (qmc.pyx:149-278): + system-bath term."""
    _qmc_call(_anneal(A_sched, B_sched, mcsteps, temp), confs, nbs, seed,
              device, lookuptable)


def QuantumAnnealGlobal(A_sched, B_sched, mcsteps, temp, confs, nbs,
                        nthreads=None, seed=None, *, device=None):
    """qmc.QuantumAnnealGlobal (qmc.pyx:284-438): + whole-line moves."""
    _qmc_call(_anneal(A_sched, B_sched, mcsteps, temp, global_moves=True),
              confs, nbs, seed, device)


def DissipativeQuantumAnnealGlobal(A_sched, B_sched, mcsteps, temp,
                                   lookuptable, confs, nbs, nthreads=None,
                                   seed=None, *, device=None):
    """qmc.DissipativeQuantumAnnealGlobal (qmc.pyx:444-609)."""
    _qmc_call(_anneal(A_sched, B_sched, mcsteps, temp, global_moves=True),
              confs, nbs, seed, device, lookuptable)


def _wolff(A_sched, B_sched, mcsteps, temp, rule):
    def run(prob, c, gen, lut):
        return _qmc.anneal_wolff(prob, _f32(A_sched, prob),
                                 _f32(B_sched, prob), float(temp), c, gen,
                                 mcsteps=int(mcsteps), rule=rule,
                                 lookuptable=lut)
    return run


def QuantumAnnealWCL(A_sched, B_sched, mcsteps, temp, confs, nbs, seed=None,
                     *, device=None):
    """qmc.QuantumAnnealWCL (qmc.pyx:620-786): Wolff clusters, pair-energy
    bond rule."""
    _qmc_call(_wolff(A_sched, B_sched, mcsteps, temp, "local"), confs, nbs,
              seed, device)


def DissaptiveQuantumAnnealWCL(A_sched, B_sched, mcsteps, temp, lookuptable,
                               confs, nbs, seed=None, *, device=None):
    """qmc.DissaptiveQuantumAnnealWCL [sic] (qmc.pyx:792-1000): Wolff with
    bath bonds (the reference's typo'd name is preserved)."""
    _qmc_call(_wolff(A_sched, B_sched, mcsteps, temp, "local"), confs, nbs,
              seed, device, lookuptable)


def QuantumAnnealWC(A_sched, B_sched, mcsteps, temp, confs, nbs, seed=None,
                    *, device=None):
    """qmc.QuantumAnnealWC (qmc.pyx:1006-1225): full-local-energy bond
    rule."""
    _qmc_call(_wolff(A_sched, B_sched, mcsteps, temp, "full"), confs, nbs,
              seed, device)


def _sw_bath(A_sched, B_sched, mcsteps, temp, per_slice_seeds):
    def run(prob, c, gen, lut):
        return _qmc.anneal_sw_bath(prob, _f32(A_sched, prob),
                                   _f32(B_sched, prob), float(temp), lut, c,
                                   gen, mcsteps=int(mcsteps),
                                   per_slice_seeds=per_slice_seeds)
    return run


def DissipativeQuantumAnnealWC2(A_sched, B_sched, mcsteps, temp, lookuptable,
                                confs, nbs, nthreads=None, seed=None, *,
                                device=None):
    """qmc.DissipativeQuantumAnnealWC2 (qmc.pyx:1231-1446): local sweeps +
    SW bath clusters, one random seed slice a line. The reference's
    inverted accept test and bath-index slip are fixed, not replicated,
    as in the JAX shim."""
    _qmc_call(_sw_bath(A_sched, B_sched, mcsteps, temp, False), confs, nbs,
              seed, device, lookuptable)


def DissipativeQuantumAnnealWC3(A_sched, B_sched, mcsteps, temp, lookuptable,
                                confs, nbs, nthreads=None, seed=None, *,
                                device=None):
    """qmc.DissipativeQuantumAnnealWC3 (qmc.pyx:1452-1621): SW bath
    clusters seeded at every (slice, spin)."""
    _qmc_call(_sw_bath(A_sched, B_sched, mcsteps, temp, True), confs, nbs,
              seed, device, lookuptable)


# --------------------------------------------------------------- svmc.pyx
def _svmc_run(A_sched, B_sched, mcsteps, temp, svec, nbs, tf, seed, device):
    prob = _problem(nbs, device)
    out = _svmc.anneal(prob, _f32(A_sched, prob), _f32(B_sched, prob),
                       float(temp), _f32(svec, prob), _key(seed, prob.device),
                       mcsteps=int(mcsteps), tf=tf)
    _write_back(svec, out)


def SpinVectorMonteCarlo(A_sched, B_sched, mcsteps, temp, svec, nbs,
                         seed=None, *, device=None):
    """svmc.SpinVectorMonteCarlo (svmc.pyx:21-117): angles in [0, pi]."""
    _svmc_run(A_sched, B_sched, mcsteps, temp, svec, nbs, False, seed,
              device)


def SpinVectorMonteCarloTF(A_sched, B_sched, mcsteps, temp, svec, nbs,
                           seed=None, *, device=None):
    """svmc.SpinVectorMonteCarloTF (svmc.pyx:123-229): TF proposals."""
    _svmc_run(A_sched, B_sched, mcsteps, temp, svec, nbs, True, seed, device)


def _noisy_svmc_run(A_sched, B_sched, mcsteps, temp, svec, nbs4d, tf, seed,
                    device):
    prob, j_t, h_t = _split_noisy(nbs4d, device)
    out = _svmc.anneal_noisy(prob, _f32(A_sched, prob), _f32(B_sched, prob),
                             float(temp), j_t, h_t, _f32(svec, prob),
                             _key(seed, prob.device), mcsteps=int(mcsteps),
                             tf=tf)
    _write_back(svec, out)


def NoisySVMC(A_sched, B_sched, mcsteps, temp, svec, nbs, seed=None, *,
              device=None):
    """svmc.NoisySVMC (svmc.pyx:236-334): 4-D time-dependent couplings."""
    _noisy_svmc_run(A_sched, B_sched, mcsteps, temp, svec, nbs, False, seed,
                    device)


def NoisySVMCTF(A_sched, B_sched, mcsteps, temp, svec, nbs, seed=None, *,
                device=None):
    """svmc.NoisySVMCTF (svmc.pyx:340-448)."""
    _noisy_svmc_run(A_sched, B_sched, mcsteps, temp, svec, nbs, True, seed,
                    device)


def SpinVectorMonteCarloCompact(A_sched, B_sched, mcsteps, temp, svec, nbs,
                                seed=None, *, device=None):
    """svmc.SpinVectorMonteCarloCompact (svmc.pyx:455-554): svec is
    (numreads, nspins); reads are a batch axis here (the reference loops
    them serially, svmc.pyx:514)."""
    _svmc_run(A_sched, B_sched, mcsteps, temp, svec, nbs, False, seed,
              device)


def SpinVectorMonteCarloTFCompact(A_sched, B_sched, mcsteps, temp, svec, nbs,
                                  nthreads=None, seed=None, *, device=None):
    """svmc.SpinVectorMonteCarloTFCompact (svmc.pyx:561-674): the
    reference's 6-thread OpenMP read loop (svmc.pyx:624) is a batch axis."""
    _svmc_run(A_sched, B_sched, mcsteps, temp, svec, nbs, True, seed, device)
