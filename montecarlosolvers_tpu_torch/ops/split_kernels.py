"""Split-checkerboard SA and PIQMC engines: plain versions, kernel wrappers,
launch counters.

Counterpart of `montecarlosolvers_tpu/ops/pallas_split.py`:
`anneal_lattice_split` (:932) and `anneal_lattice_qmc_split` (:607), whose
Pallas kernels `_split_kernel` (:109) and `_qmc_split_kernel` (:431) are
ported as the CUDA kernels `csrc/split_sa.cu` (kernel A) and
`csrc/split_qmc.cu` (kernel B).

Beside each kernel wrapper sits its plain PyTorch version
(`sa_split_anneal_ref`, `qmc_split_anneal_ref`), with the semantics of the
JAX oracles `oracle_anneal` and `oracle_qmc` in tests/test_pallas_split.py:
the same fields, the same counter-hash uniforms and the same log-form
Metropolis rule, so on the CPU they equal the oracles bitwise, and on the
card the kernels equal them bitwise.

The wrappers dispatch on the device of the state: a CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises — nothing falls
back. `LAUNCHES` counts, per kernel, the wrapper calls that launched it.
"""

from __future__ import annotations

import ctypes

import torch

from montecarlosolvers_tpu_torch import _roadmap
from montecarlosolvers_tpu_torch import schedules
from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import counter_rng as cr
from montecarlosolvers_tpu_torch.ops import split as split_ops
from montecarlosolvers_tpu_torch.ops.metropolis import metropolis_accept

# Wrapper calls that launched each kernel (one call runs a whole schedule).
LAUNCHES = {"sa_split": 0, "qmc_split": 0}

# Kernel A keeps both halves of one chain in shared memory for the whole
# schedule: 2 * Nh * 4 bytes, at most the 227 KB a Hopper block can use.
SA_SMEM_LIMIT_BYTES = 232448
# Kernel B puts chains on gridDim.z.
QMC_MAX_CHAINS = 65535


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ plain versions


def sa_split_anneal_ref(sl, sched, a, b, seed):
    """Plain form of kernel A: anneal halves a, b (chains, Nh) over the
    float32 temperatures `sched` (steps,) with counter-hash seed `seed`.
    Returns the new (a, b). One step updates half a from half b, then half b
    from the new half a (pallas_split.py:151-164)."""
    chains, nh = a.shape
    K = sl.K
    wa, wb = sl.w_ab[:, 0], sl.w_ab[:, 1]
    ha, hb = sl.h_ab[0], sl.h_ab[1]
    hu_a = cr.hashed_uid(cr.sa_uids(chains, nh, 0, a.device))
    hu_b = cr.hashed_uid(cr.sa_uids(chains, nh, 1, a.device))
    for t in range(sched.shape[0]):
        temp = sched[t]
        de = -2.0 * a * (split_ops.spatial_field(wa, b, K) + ha)
        u = cr.uniform01_hashed(cr.counter(seed, t, 0), hu_a)
        a = torch.where(metropolis_accept(de, temp, u), -a, a)
        de = -2.0 * b * (split_ops.spatial_field(wb, a, K) + hb)
        u = cr.uniform01_hashed(cr.counter(seed, t, 1), hu_b)
        b = torch.where(metropolis_accept(de, temp, u), -b, b)
    return a, b


def _sum_q(x):
    """Sum over the Trotter axis -2 in index order. torch.sum would use its
    cascade order from 16 terms on; kernel B and the JAX oracle add the
    slices one after the other."""
    acc = x[..., 0, :]
    for q in range(1, x.shape[-2]):
        acc = acc + x[..., q, :]
    return acc


def qmc_split_anneal_ref(sl, b_sched, jp, teff, quarters, seed,
                         global_moves):
    """Plain form of kernel B on the quarters (xe, xo, ye, yo), each
    (chains, Q, Nh). `b_sched` and `jp` are float32 (steps,) tensors of the
    longitudinal scale B and of J_perp; `teff` = P*T is a Python float.

    Per step: phase X updates xe, xo against ye, yo; phase Y updates ye, yo
    against the new xe, xo. dE = -2B s f + 2 s J_perp (up + down), with the
    Trotter ring (pallas_split.py:514-518), indices mod Q:

        xe: yo[q] + yo[q-1]     xo: ye[q] + ye[q+1]
        ye: xo[q] + xo[q-1]     yo: xe[q] + xe[q+1]

    With `global_moves`, whole-line flips follow: color A lines (xe, yo)
    against ye, xo, then color B lines (ye, xo) against the updated A
    quarters. A line's dE is -2B sum_q s f; J_perp cancels."""
    xe, xo, ye, yo = quarters
    chains, Q, nh = xe.shape
    K = sl.K
    dev = xe.device
    wa, wb = sl.w_ab[:, 0], sl.w_ab[:, 1]
    ha, hb = sl.h_ab[0], sl.h_ab[1]
    teff32 = torch.tensor(teff, dtype=torch.float32, device=dev)
    hq = [cr.hashed_uid(cr.quarter_uids(chains, Q, nh, i, dev))
          for i in range(4)]
    hl = [cr.hashed_uid(cr.sa_uids(chains, nh, c, dev)) for c in (0, 1)]

    for t in range(b_sched.shape[0]):
        jpt = jp[t]
        bc = -2.0 * b_sched[t]

        def upd(s, o, w, h, tr, idx):
            de = bc * s * (split_ops.spatial_field(w, o, K) + h) \
                + 2.0 * s * jpt * tr
            u = cr.uniform01_hashed(cr.counter(seed, t, idx), hq[idx])
            return torch.where(metropolis_accept(de, teff32, u), -s, s)

        xe = upd(xe, ye, wa, ha, yo + torch.roll(yo, 1, dims=-2), 0)
        xo = upd(xo, yo, wb, hb, ye + torch.roll(ye, -1, dims=-2), 1)
        ye = upd(ye, xe, wb, hb, xo + torch.roll(xo, 1, dims=-2), 2)
        yo = upd(yo, xo, wa, ha, xe + torch.roll(xe, -1, dims=-2), 3)

        if global_moves:

            def line_flips(s1, o1, s2, o2, color):
                """(chains, 1, Nh) factors -1 / +1 of the lines of `color`,
                whose sites are s1 and s2 with neighbours in o1 and o2."""
                w, h = sl.w_ab[:, color], sl.h_ab[color]
                de = bc * (
                    _sum_q(s1 * (split_ops.spatial_field(w, o1, K) + h))
                    + _sum_q(s2 * (split_ops.spatial_field(w, o2, K) + h))
                )
                u = cr.uniform01_hashed(cr.counter(seed, t, 4 + color),
                                        hl[color])
                acc = metropolis_accept(de, teff32, u)
                return torch.where(acc, -1.0, 1.0)[:, None, :]

            # color A lines (xe, yo), then color B lines (ye, xo) against
            # the updated A quarters
            m = line_flips(xe, ye, yo, xo, 0)
            xe, yo = xe * m, yo * m
            m = line_flips(ye, xe, xo, yo, 1)
            ye, xo = ye * m, xo * m
    return xe, xo, ye, yo


# ------------------------------------------------------------ kernel wrappers


def _check(t, name, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _raise_on_error(lib, fn, rc):
    if rc != 0:
        msg = getattr(lib, fn + "_error_string")(rc).decode()
        raise RuntimeError(f"{fn} failed with CUDA error {rc}: {msg}")


def _route(device):
    """'cpu' or 'cuda'; any other device has neither form."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no split engine for device {device}")
    return device.type


def sa_split_anneal(sl, sched, a, b, seed):
    """Kernel A on CUDA tensors, `sa_split_anneal_ref` on CPU tensors.
    Arguments as for `sa_split_anneal_ref`; returns new (a, b)."""
    if _route(a.device) == "cpu":
        return sa_split_anneal_ref(sl, sched, a, b, seed)
    chains, nh = a.shape
    dev = a.device
    if nh != sl.nh:
        raise ValueError(f"halves have {nh} sites, lattice has {sl.nh}")
    smem = 2 * nh * 4
    if smem > SA_SMEM_LIMIT_BYTES:
        raise ValueError(
            f"kernel A keeps 2*Nh*4 = {smem} bytes of one chain in shared "
            f"memory; the limit is {SA_SMEM_LIMIT_BYTES} (L = {sl.L})"
        )
    for t, name in ((a, "a"), (b, "b")):
        _check(t, name, (chains, nh), dev)
    _check(sl.w_ab, "w_ab", (sl.nslots, 2, nh), dev)
    _check(sl.h_ab, "h_ab", (2, nh), dev)
    _check(sched, "sched", (sched.shape[0],), dev)
    a_out = torch.empty_like(a)
    b_out = torch.empty_like(b)
    lib = _build.library("split_sa")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.split_sa_anneal(
        _ptr(sl.w_ab), _ptr(sl.h_ab), _ptr(sched), _ptr(a), _ptr(b),
        _ptr(a_out), _ptr(b_out), chains, nh, sl.K, sl.nslots,
        int(sched.shape[0]), cr.wrap_int32(seed), ctypes.c_void_p(stream),
    )
    _raise_on_error(lib, "split_sa_anneal", rc)
    LAUNCHES["sa_split"] += 1
    return a_out, b_out


def qmc_split_anneal(sl, b_sched, jp, teff, quarters, seed, global_moves):
    """Kernel B on CUDA tensors, `qmc_split_anneal_ref` on CPU tensors.
    Arguments as for `qmc_split_anneal_ref`; returns new quarters."""
    xe = quarters[0]
    if _route(xe.device) == "cpu":
        return qmc_split_anneal_ref(sl, b_sched, jp, teff, quarters, seed,
                                    global_moves)
    chains, Q, nh = xe.shape
    dev = xe.device
    if nh != sl.nh:
        raise ValueError(f"quarters have {nh} sites, lattice has {sl.nh}")
    if chains > QMC_MAX_CHAINS:
        raise ValueError(f"kernel B takes at most {QMC_MAX_CHAINS} chains")
    for t, name in zip(quarters, ("xe", "xo", "ye", "yo")):
        _check(t, name, (chains, Q, nh), dev)
    _check(sl.w_ab, "w_ab", (sl.nslots, 2, nh), dev)
    _check(sl.h_ab, "h_ab", (2, nh), dev)
    steps = int(b_sched.shape[0])
    _check(b_sched, "b_sched", (steps,), dev)
    _check(jp, "jp", (steps,), dev)
    outs = [torch.empty_like(q) for q in quarters]
    lib = _build.library("split_qmc")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.split_qmc_anneal(
        _ptr(sl.w_ab), _ptr(sl.h_ab), _ptr(b_sched), _ptr(jp),
        ctypes.c_float(teff), *(_ptr(q) for q in quarters),
        *(_ptr(q) for q in outs), chains, Q, nh, sl.K, sl.nslots, steps,
        cr.wrap_int32(seed), int(bool(global_moves)), ctypes.c_void_p(stream),
    )
    _raise_on_error(lib, "split_qmc_anneal", rc)
    LAUNCHES["qmc_split"] += 1
    return tuple(outs)


# ------------------------------------------------------ lattice-level engines


def anneal_lattice_split(problem, sched, spins, seed, mcsteps=1):
    """Split-layout SA anneal on an even-L LatticeProblem (counterpart of
    `pallas_split.anneal_lattice_split`, without its TPU lane rules).

    sched: (steps,) temperatures; spins: (chains, N) or (N,) float32 +/-1 on
    the problem's device; seed: int counter-hash seed. Returns the annealed
    spins, same shape."""
    split_ops.require_split(problem)
    dev = problem.device
    if spins.device != dev:
        raise ValueError(f"spins are on {spins.device}, problem on {dev}")
    sl = split_ops.build_split(problem)
    temps = schedules.expand_mcsteps(
        torch.as_tensor(sched, dtype=torch.float32, device=dev), mcsteps
    ).contiguous()
    squeeze = spins.ndim == 1
    s = spins[None] if squeeze else spins
    a, b = split_ops.pack_classical(sl, s.to(torch.float32))
    a, b = sa_split_anneal(sl, temps, a.contiguous(), b.contiguous(), seed)
    out = split_ops.unpack_classical(sl, a, b)
    return out[0] if squeeze else out


def anneal_lattice_qmc_split(problem, a_sched, b_sched, temp, confs, seed,
                             mcsteps=1, global_moves=True):
    """Split-layout PIQMC anneal on an even-L LatticeProblem at even P
    (counterpart of `pallas_split.anneal_lattice_qmc_split`).

    a_sched / b_sched: (steps,) Gamma and B; temp: ambient T, T_eff = P*T;
    confs: (chains, P, N) or (P, N) float32 +/-1 slices-major, on the
    problem's device. Returns the annealed configurations, same shape."""
    split_ops.require_split(problem)
    dev = problem.device
    if confs.device != dev:
        raise ValueError(f"confs are on {confs.device}, problem on {dev}")
    slices = confs.shape[-2]
    if slices % 2:
        raise _roadmap.not_ported("PIQMC with odd P", _roadmap.ODD_P)
    sl = split_ops.build_split(problem)
    gamma = schedules.expand_mcsteps(
        torch.as_tensor(a_sched, dtype=torch.float32, device=dev), mcsteps)
    b = schedules.expand_mcsteps(
        torch.as_tensor(b_sched, dtype=torch.float32, device=dev), mcsteps)
    teff = float(temp) * slices
    jp = schedules.jperp(gamma, teff).contiguous()
    squeeze = confs.ndim == 2
    c = confs[None] if squeeze else confs
    quarters = split_ops.pack_qmc(sl, c.to(torch.float32))
    quarters = qmc_split_anneal(sl, b.contiguous(), jp, teff, quarters, seed,
                                global_moves)
    out = split_ops.unpack_qmc(sl, *quarters)
    return out[0] if squeeze else out
