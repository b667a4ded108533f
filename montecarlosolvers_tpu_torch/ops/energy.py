"""Per-step energy readouts of `collect_energy=`: plain versions and the
wrappers of the energy kernel.

The JAX solvers return per-step energies as scan outputs computed in XLA
(ops/split.py:245, :324-330, :676, :715; solvers/qmc.py:176); no Pallas
kernel computes them. On the card the state of a collecting anneal lives
in device memory between the launches of a per-phase route, so the energy
is read there by a hand-written kernel (csrc/energy.cuh) that the route's
C++ loop launches once a step into a (steps, chains) buffer. The
stand-alone entry points of the same kernel (csrc/energy.cu) are wrapped
here, beside their plain versions, for checks and timing:

  halves_energy    split halves a, b, (chains, nh) or (chains, P, nh):
                   classical_energy_split, least over P;
  quarters_energy  the PIQMC quarters (xe, xo, ye, yo): the least slice
                   energy (qmc_slice_energies_split);
  plane_energy     planes (chains, L, L) or (chains, P, L, L):
                   plane.plane_energy, least over P.

With `cos_theta`, the values are cos theta of SVMC rotors, read as
sign(cos theta), +1 at 0 (`svmc_ops.z_projection_from_cos`). A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises
(LAUNCHES["energy"]).
"""

from __future__ import annotations

import torch

from montecarlosolvers_tpu_torch.ops import _build
from montecarlosolvers_tpu_torch.ops import plane as plane_ops
from montecarlosolvers_tpu_torch.ops import split as split_ops
from montecarlosolvers_tpu_torch.ops import svmc_ops


def _spins(x, cos_theta):
    return svmc_ops.z_projection_from_cos(x) if cos_theta else x


def halves_energy_ref(sl, a, b, cos_theta=False):
    """(chains,) energy of halves a, b (chains, nh), or the least slice
    energy of halves (chains, P, nh)."""
    e = split_ops.classical_energy_split(sl, _spins(a, cos_theta),
                                         _spins(b, cos_theta))
    return e if a.ndim == 2 else torch.min(e, dim=-1).values


def quarters_energy_ref(sl, quarters):
    """(chains,) least slice energy of the PIQMC quarters (xe, xo, ye, yo),
    each (chains, Q, nh)."""
    return torch.min(split_ops.qmc_slice_energies_split(sl, *quarters),
                     dim=-1).values


def plane_energy_ref(pl, s, cos_theta=False):
    """(chains,) energy of planes (chains, L, L), or the least slice energy
    of planes (chains, P, L, L)."""
    e = plane_ops.plane_energy(pl, _spins(s, cos_theta))
    return e if s.ndim == 3 else torch.min(e, dim=-1).values


def launch(fn, dev, chains, *args, key="energy"):
    """Launch the energy entry point `fn` into a new (chains,) float32
    tensor, counted under LAUNCHES[key]."""
    lib = _build.library("energy")
    out = torch.empty(chains, dtype=torch.float32, device=dev)
    rc = getattr(lib, fn)(*args, _build.ptr(out), _build.stream_of(dev))
    _build.raise_on_error(lib, fn, rc, error_fn="energy_error_string")
    _build.LAUNCHES[key] += 1
    return out


def halves_energy(sl, a, b, cos_theta=False):
    """The energy kernel on CUDA halves, `halves_energy_ref` on CPU ones."""
    if _build.route(a.device, "energy") == "cpu":
        return halves_energy_ref(sl, a, b, cos_theta)
    shape = tuple(a.shape)
    if shape[-1] != sl.nh or len(shape) not in (2, 3):
        raise ValueError(f"halves of shape {shape} on a lattice of "
                         f"{sl.nh} sites a half")
    for t, name in ((a, "a"), (b, "b")):
        _build.check_arg(t, name, shape, a.device)
    P = shape[1] if len(shape) == 3 else 1
    return launch("energy_halves", a.device, shape[0],
                   *map(_build.ptr, (sl.w_ab, sl.h_ab, a, b)), shape[0], P,
                   sl.L, sl.nslots, int(bool(cos_theta)))


def quarters_energy(sl, quarters):
    """The energy kernel on CUDA quarters, `quarters_energy_ref` on CPU
    ones."""
    xe = quarters[0]
    if _build.route(xe.device, "energy") == "cpu":
        return quarters_energy_ref(sl, quarters)
    chains, Q, nh = xe.shape
    if nh != sl.nh:
        raise ValueError(f"quarters have {nh} sites, lattice has {sl.nh}")
    for t, name in zip(quarters, ("xe", "xo", "ye", "yo")):
        _build.check_arg(t, name, (chains, Q, nh), xe.device)
    return launch("energy_quarters", xe.device, chains,
                   *map(_build.ptr, (sl.w_ab, sl.h_ab, *quarters)), chains,
                   Q, sl.L, sl.nslots)


def plane_energy(pl, s, cos_theta=False):
    """The energy kernel on CUDA planes, `plane_energy_ref` on CPU ones."""
    if _build.route(s.device, "energy") == "cpu":
        return plane_energy_ref(pl, s, cos_theta)
    shape = tuple(s.shape)
    if shape[-2:] != (pl.L, pl.L) or len(shape) not in (3, 4):
        raise ValueError(f"planes of shape {shape} on an L = {pl.L} "
                         f"lattice")
    _build.check_arg(s, "s", shape, s.device)
    P = shape[1] if len(shape) == 4 else 1
    return launch("energy_plane", s.device, shape[0],
                   *map(_build.ptr, (pl.w, s)), shape[0], P, pl.L,
                   int(bool(cos_theta)))
