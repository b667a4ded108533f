"""Build the CUDA sources in `csrc/` with nvcc at first use; bind via ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on its own
into `_build/lib<name>_<digest>.so`, where the digest covers the source, the
shared headers `csrc/*.cuh` and the flags, so an edited source is rebuilt
and an unchanged one is loaded from the build directory. nvcc takes seconds
for such a file (a PyTorch C++ extension, whose sources include PyTorch's
headers, takes minutes). Building happens only when a kernel is first needed or when `build` is
called; importing this module runs nothing.

The kernel wrappers (`ops/split_kernels.py`, `ops/plane_kernels.py`,
`ops/generic_kernels.py`, `ops/dense_kernels.py`,
`ops/cluster_kernels.py`) share
the helpers below: the device route, argument checks, error reporting and
`LAUNCHES`, the one count of kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("split_sa", "split_qmc", "split_svmc", "split_qmc_bath",
           "plane_sa", "plane_qmc", "plane_svmc", "energy", "packed_sa",
           "packed_svmc", "generic_qmc", "generic_qmc_bath", "dense_sa",
           "fk_wolff", "fk_label", "fk_line", "houdayer")

# No --use_fast_math: kernels and their plain versions must round alike.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_NP = ctypes.POINTER(ctypes.c_longlong)  # out: number of kernels launched
_IP = ctypes.POINTER(ctypes.c_int)
# the last arguments of every per-phase entry point: energies (a (steps,
# chains) float32 buffer the energy kernel of csrc/energy.cuh fills after
# each step, or None), stream, launched and energy_launched (out: the energy
# kernels launched)
_PHASED_TAIL = [_P, _P, _NP, _NP]
# C signatures: function -> (restype, argtypes)
SIGNATURES = {
    "split_sa": {
        # w, h, sched, a_in, b_in, a_out, b_out (the halves as chain bits),
        # chains, C, R, threads, L, nslots, steps, seed, hw_rng, stride_t,
        # stride_c (the schedule table's strides, stride_c 0 for one shared
        # schedule), step0 (the step the hash counts the first step as),
        # stream
        "split_sa_anneal": (_I, [_P] * 7 + [_I] * 12 + [_P]),
        # R, threads, L, out: clusters resident at once
        "split_sa_max_active_clusters": (_I, [_I] * 3 + [_IP]),
        # the per-phase kernel: w, h, sched, a_in, b_in, a_out, b_out (the
        # halves as floats), chains, L, nslots, steps, seed, hw_rng,
        # stride_t, stride_c, step0, energies, stream, launched,
        # energy_launched
        "split_sa_phased_anneal": (_I, [_P] * 7 + [_I] * 9 + _PHASED_TAIL),
        "split_sa_anneal_error_string": (ctypes.c_char_p, [_I]),
    },
    "split_qmc": {
        # w, h, b_sched, jp, teff, 4 quarters in, 4 quarters out,
        # chains, Q, R, threads, L, nslots, steps, seed, global_moves,
        # hw_rng, stride_t, stride_c (jp's strides), step0, stream
        "split_qmc_anneal": (
            _I, [_P] * 4 + [ctypes.c_float] + [_P] * 8 + [_I] * 13 + [_P]
        ),
        # Q, R, threads, L, out: clusters resident at once
        "split_qmc_max_active_clusters": (_I, [_I] * 4 + [_IP]),
        # the per-phase kernels: w, h, b_sched, jp, teff, 4 quarters in,
        # 4 quarters out, chains, Q, nh, K, nslots, steps, seed,
        # global_moves, hw_rng, stride_t, stride_c, step0, energies,
        # stream, launched, energy_launched
        "split_qmc_phased_anneal": (
            _I, [_P] * 4 + [ctypes.c_float] + [_P] * 8 + [_I] * 12
            + _PHASED_TAIL
        ),
        "split_qmc_anneal_error_string": (ctypes.c_char_p, [_I]),
    },
    "split_qmc_bath": {
        # w, h, b_sched, jp, bath, teff, 2*teff, a_in, b_in, a_out, b_out,
        # chains, P, R, threads, L, nslots, steps, seed, global_moves,
        # hw_rng, stream
        "split_qmc_bath_anneal": (
            _I, [_P] * 5 + [ctypes.c_float] * 2 + [_P] * 4 + [_I] * 10 + [_P]
        ),
        # P, R, threads, L, out: clusters resident at once
        "split_qmc_bath_max_active_clusters": (_I, [_I] * 4 + [_IP]),
        # the per-phase kernels: w, h, b_sched, jp, bath, teff, 2*teff,
        # a_in, b_in, a_out, b_out, chains, P, L, nslots, steps, seed,
        # global_moves, hw_rng, energies, stream, launched,
        # energy_launched
        "split_qmc_bath_phased_anneal": (
            _I, [_P] * 5 + [ctypes.c_float] * 2 + [_P] * 4 + [_I] * 8
            + _PHASED_TAIL
        ),
        # the colored template: as split_qmc_bath_anneal without hw_rng
        "split_qmc_bath_colored_anneal": (
            _I, [_P] * 5 + [ctypes.c_float] * 2 + [_P] * 4 + [_I] * 9 + [_P]
        ),
        # its per-phase kernels: w, h, b_sched, jp, bath, teff, 2*teff,
        # a_in, b_in, a_out, b_out, a_tmp, b_tmp, chains, P, L, nslots,
        # steps, seed, global_moves, energies, stream, launched,
        # energy_launched
        "split_qmc_bath_colored_phased_anneal": (
            _I, [_P] * 5 + [ctypes.c_float] * 2 + [_P] * 6 + [_I] * 7
            + _PHASED_TAIL
        ),
        "split_qmc_bath_anneal_error_string": (ctypes.c_char_p, [_I]),
    },
    "plane_sa": {
        # planes, sched, s_in, s_out (the planes as chain bits), chains, C,
        # R, threads, L, row_stride, plane_stride, steps, seed, stream
        "plane_sa_anneal": (_I, [_P] * 4 + [_I] * 9 + [_P]),
        # R, threads, L, out: clusters resident at once
        "plane_sa_max_active_clusters": (_I, [_I] * 3 + [_IP]),
        # the per-phase kernel: planes, sched, s_in, s_out, scratch (the
        # planes as floats), chains, L, row_stride, plane_stride, steps,
        # seed, energies, stream, launched, energy_launched
        "plane_sa_phased_anneal": (_I, [_P] * 5 + [_I] * 6 + _PHASED_TAIL),
        "plane_sa_anneal_error_string": (ctypes.c_char_p, [_I]),
    },
    "plane_qmc": {
        # planes, b_sched, jp, teff, s_in, s_out (the slices as bits),
        # chains, P, m, R, threads, L, row_stride, plane_stride, steps, seed,
        # global_moves, stream
        "plane_qmc_anneal": (
            _I, [_P] * 3 + [ctypes.c_float] + [_P] * 2 + [_I] * 11 + [_P]
        ),
        # P, R, threads, L, out: clusters resident at once
        "plane_qmc_max_active_clusters": (_I, [_I] * 4 + [_IP]),
        # the per-phase kernels: planes, b_sched, jp, teff, s_in, s_out,
        # scratch, chains, P, L, row_stride, plane_stride, m, steps, seed,
        # global_moves, energies, stream, launched, energy_launched
        "plane_qmc_phased_anneal": (
            _I, [_P] * 3 + [ctypes.c_float] + [_P] * 3 + [_I] * 9
            + _PHASED_TAIL
        ),
        "plane_qmc_anneal_error_string": (ctypes.c_char_p, [_I]),
    },
    "split_svmc": {
        # w, h, a_sched, b_sched, temp, a_in, b_in, a_out, b_out,
        # chains, R, threads, L, nslots, steps, seed, tf, hw_rng, stream
        "split_svmc_anneal": (
            _I, [_P] * 4 + [ctypes.c_float] + [_P] * 4 + [_I] * 9 + [_P]
        ),
        # R, threads, L, out: clusters resident at once
        "split_svmc_max_active_clusters": (_I, [_I] * 3 + [_IP]),
        # the per-phase kernels: w, h, a_sched, b_sched, temp, a_in, b_in,
        # a_out, b_out, scratch, chains, L, nslots, steps, seed, tf, hw_rng,
        # energies, stream, launched, energy_launched
        "split_svmc_phased_anneal": (
            _I, [_P] * 4 + [ctypes.c_float] + [_P] * 5 + [_I] * 7
            + _PHASED_TAIL
        ),
        "split_svmc_anneal_error_string": (ctypes.c_char_p, [_I]),
    },
    "plane_svmc": {
        # planes, a_sched, b_sched, temp, th_in, th_out, chains, R, threads,
        # L, row_stride, plane_stride, steps, seed, tf, stream
        "plane_svmc_anneal": (
            _I, [_P] * 3 + [ctypes.c_float] + [_P] * 2 + [_I] * 9 + [_P]
        ),
        # R, threads, L, out: clusters resident at once
        "plane_svmc_max_active_clusters": (_I, [_I] * 3 + [_IP]),
        # the per-phase kernels: planes, a_sched, b_sched, temp, th_in,
        # th_out, scratch, chains, L, row_stride, plane_stride, steps, seed,
        # tf, energies, stream, launched, energy_launched
        "plane_svmc_phased_anneal": (
            _I, [_P] * 3 + [ctypes.c_float] + [_P] * 3 + [_I] * 7
            + _PHASED_TAIL
        ),
        "plane_svmc_anneal_error_string": (ctypes.c_char_p, [_I]),
    },
    "packed_sa": {
        # nbr_idx, nbr_J, h, perm, starts, temps, s (in place), snap
        # (scratch of the state's size for a packing that is not proper,
        # else null), energies, chains, n, maxnb, ncolors, steps, seed, step0 (the step the hash
        # counts the first sweep as), threads, j_stride, h_stride, mcsteps
        # (the per-step tables' strides, 0 for the static ones, and the
        # sweeps a table row), stride_t, stride_c (the temperature table's
        # strides, stride_c 0 for one shared schedule), stream
        "packed_sa_anneal": (_I, [_P] * 9 + [_I] * 13 + [_P]),
        "packed_sa_anneal_error_string": (ctypes.c_char_p, [_I]),
    },
    "packed_svmc": {
        # nbr_idx, nbr_J, h, perm, starts, a_sched, b_sched, temp, th (in
        # place), scratch, energies, chains, n, maxnb, ncolors, steps, seed,
        # tf, threads, j_stride, h_stride, mcsteps, stream
        "packed_svmc_anneal": (
            _I, [_P] * 7 + [ctypes.c_float] + [_P] * 3 + [_I] * 11 + [_P]
        ),
        "packed_svmc_anneal_error_string": (ctypes.c_char_p, [_I]),
    },
    "generic_qmc": {
        # nbr_idx, nbr_J, h, perm, starts, b_sched, jp, teff, s (in place),
        # snap (scratch, or null for a proper packing), energies, chains, P,
        # n, maxnb, ncolors, m, steps, seed, step0, global_moves, threads,
        # stride_t, stride_c (jp's strides), stream
        "generic_qmc_anneal": (
            _I, [_P] * 7 + [ctypes.c_float] + [_P] * 3 + [_I] * 13 + [_P]
        ),
        "generic_qmc_anneal_error_string": (ctypes.c_char_p, [_I]),
    },
    "generic_qmc_bath": {
        # nbr_idx, nbr_J, h, perm, starts, b_sched, jp, bath, teff, 2*teff,
        # s (in place), snap (scratch or null), energies, chains, P, n,
        # maxnb, ncolors, m, steps, seed, step0, colored, global_moves,
        # proper, threads, stream
        "generic_qmc_bath_anneal": (
            _I, [_P] * 8 + [ctypes.c_float] * 2 + [_P] * 3 + [_I] * 13
            + [_P]
        ),
        "generic_qmc_bath_anneal_error_string": (ctypes.c_char_p, [_I]),
    },
    "dense_sa": {
        # J, fb, temps, s (in place), chains, np, start, B, row (of the
        # temperature table), step (of the hash), seed, warps, stride_t,
        # stride_c, stream
        "dense_sa_block": (_I, [_P] * 4 + [_I] * 10 + [_P]),
        "dense_sa_block_error_string": (ctypes.c_char_p, [_I]),
    },
    "fk_wolff": {
        # nbr_idx, nbr_J, h, perm, b_sched, jp, teff, lut (or null), s (in
        # place), visited bits, queues (scratch), visited counts (or null),
        # chains, P, n, maxnb, steps, seed, step0, rule_full, threads,
        # stream
        "fk_wolff_anneal": (_I, [_P] * 12 + [_I] * 9 + [_P]),
        "fk_wolff_anneal_error_string": (ctypes.c_char_p, [_I]),
    },
    "fk_label": {
        # nbr_idx, nbr_J, h, perm, b_sched, jp, teff, lut (or null), s (in
        # place), parents and flags (scratch, null with smem), chains, P,
        # n, maxnb, steps, seed, step0, smem, threads, stream
        "fk_label_anneal": (_I, [_P] * 11 + [_I] * 9 + [_P]),
        "fk_label_anneal_error_string": (ctypes.c_char_p, [_I]),
    },
    "fk_line": {
        # nbr_idx, nbr_J, h, perm, starts, b_sched, jp, p_t, p_pair, teff,
        # s (in place), chains, P, n, maxnb, t, step, color, class size,
        # seed, per_slice_seeds, warps, stream
        "fk_line_phase": (
            _I, [_P] * 9 + [ctypes.c_float] + [_P] + [_I] * 11 + [_P]),
        "fk_line_phase_error_string": (ctypes.c_char_p, [_I]),
    },
    "houdayer": {
        # nbr_idx, nbr_J, s1, s2 (in place), flipped (out), parents
        # (scratch, null with smem), pairs, n, maxnb, seed, step, smem,
        # threads, stream
        "houdayer_move": (_I, [_P] * 6 + [_I] * 7 + [_P]),
        "houdayer_move_error_string": (ctypes.c_char_p, [_I]),
    },
    "energy": {
        # w, h, a, b, chains, P, L, nslots, cos_theta, out, stream
        "energy_halves": (_I, [_P] * 4 + [_I] * 5 + [_P, _P]),
        # w, h, a_words, b_words, chains, C, L, nslots, out, stream
        "energy_chain_bits": (_I, [_P] * 4 + [_I] * 4 + [_P, _P]),
        # w, h, xe, xo, ye, yo, chains, Q, L, nslots, out, stream
        "energy_quarters": (_I, [_P] * 6 + [_I] * 4 + [_P, _P]),
        # w, s, chains, P, L, cos_theta, out, stream
        "energy_plane": (_I, [_P] * 2 + [_I] * 4 + [_P, _P]),
        "energy_error_string": (ctypes.c_char_p, [_I]),
    },
}

_LIBS = {}
# ptxas's report (registers, stack frame, spills of every function) of each
# library that `build(verbose=True)` compiled in this process
PTXAS_LOG = {}

# Shared memory one Hopper block may use (232,448 bytes of the SM's 256 KB);
# the kernels that keep a chain in shared memory are refused beyond it.
SMEM_LIMIT_BYTES = 232448

# Kernel launches per kernel. Every kernel runs a whole schedule in one
# cluster launch, whatever the cluster size; the per-phase kernels of each
# for the shapes no cluster holds ("*_phased") launch once per phase (and
# those of 4 and 7 once more to fill their caches), and their C entry
# points report how many launches they issued. The generator
# instantiations of kernels A, B, 4 and 5 (hw_rng=True, csrc/hw_rng.cuh)
# count apart, under "<key>_hw" and "<key>_hw_phased".
LAUNCHES = {"sa_split": 0, "sa_split_phased": 0, "qmc_split": 0,
            "qmc_split_phased": 0, "svmc_split": 0, "svmc_split_phased": 0,
            "qmc_bath_split": 0, "qmc_bath_split_phased": 0, "sa_plane": 0,
            "sa_plane_phased": 0, "qmc_plane": 0, "qmc_plane_phased": 0,
            "svmc_plane": 0, "svmc_plane_phased": 0}
LAUNCHES.update({f"{k}_hw{phased}": 0
                 for k in ("sa_split", "qmc_split", "svmc_split",
                           "qmc_bath_split")
                 for phased in ("", "_phased")})
# Kernel 5's colored template (bath_update="colored", even P) counts apart.
LAUNCHES.update({"qmc_bath_split_colored": 0,
                 "qmc_bath_split_colored_phased": 0})
# The energy kernel (csrc/energy.cuh) of a collecting anneal counts under
# "<key>_energy", one launch a step beside the "<key>_phased" launches; its
# stand-alone entry points (csrc/energy.cu, ops/energy.py) under "energy",
# but that on kernel A's chain-bit words (the samplers' exchanges), which
# counts under "energy_bits".
LAUNCHES.update({f"{k}_energy": 0
                 for k in ("sa_split", "qmc_split", "svmc_split",
                           "qmc_bath_split", "qmc_bath_split_colored",
                           "sa_plane", "qmc_plane", "svmc_plane")})
LAUNCHES["energy"] = 0
LAUNCHES["energy_bits"] = 0
# The generic kernels on an IsingProblem (ops/generic_kernels.py) run the
# whole schedule in one launch, energies or not; so does the generic bath
# kernel, on an IsingProblem or a lattice's checkerboard packing.
LAUNCHES.update({"packed_sa": 0, "packed_svmc": 0, "generic_qmc": 0,
                 "generic_qmc_bath": 0})
# The noisy anneals (per-step coupling tables) run the packed SA and SVMC
# kernels, one launch an anneal, counted apart; the dense engine launches
# its in-block kernel once a block and sweep.
LAUNCHES.update({"packed_sa_noisy": 0, "packed_svmc_noisy": 0,
                 "dense_sa": 0})
# The cluster kernels (ops/cluster_kernels.py): fk_wolff and fk_label once
# an anneal, or once a step where local sweeps interleave; fk_line once a
# color phase.
LAUNCHES.update({"fk_wolff": 0, "fk_label": 0, "fk_line": 0})
# The samplers (solvers/pt.py, solvers/pa.py): the per-chain-schedule
# instantiations of kernels A and B, of the packed SA, generic PIQMC and
# dense kernels count apart, under "<key>_chain" (kernel A's and B's
# per-phase kernels under "<key>_chain_phased"); the Houdayer kernel once a
# move.
LAUNCHES.update({f"{k}_chain": 0 for k in ("sa_split", "qmc_split",
                                          "packed_sa", "generic_qmc",
                                          "dense_sa")})
LAUNCHES.update({"sa_split_chain_phased": 0, "qmc_split_chain_phased": 0,
                 "houdayer": 0})


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def route(device, engine):
    """'cpu' or 'cuda'; any other device has neither form of `engine`."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {engine} engine for device {device}")
    return device.type


def check_arg(t, name, shape, device, dtype=torch.float32):
    """Raise ValueError unless `t` is a contiguous tensor of `dtype` and
    `shape` on `device`: what every kernel takes (float32 but for the
    generic kernels' int32 tables)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def schedule_strides(sched, name, steps, chains, device):
    """(stride_t, stride_c) of a kernel's schedule argument: (1, 0) for one
    shared (steps,) schedule, else the strides of a (steps, chains) float32
    table read as sched[t * stride_t + chain * stride_c], whose chains must
    lie next to each other (stride 1) and whose steps may repeat one row
    (stride 0: one value a chain for the whole launch, an `expand` of a
    (chains,) vector). Raises ValueError on anything else."""
    if sched.dim() == 1:
        check_arg(sched, name, (steps,), device)
        return 1, 0
    if sched.device != device or sched.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 on {device}")
    if tuple(sched.shape) != (steps, chains):
        raise ValueError(f"{name} has shape {tuple(sched.shape)}, expected "
                         f"({steps},) or ({steps}, {chains})")
    stride_t, stride_c = sched.stride()
    if (chains > 1 and stride_c != 1) or stride_t not in (0, chains):
        raise ValueError(f"{name} must be a (steps, chains) table with "
                         "contiguous rows")
    return stride_t, 1


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def collecting(energies, hw_rng=False):
    """True when a kernel wrapper is given an energy buffer
    (collect_energy=); raises ValueError with `hw_rng`, whose
    instantiations collect none."""
    if energies is not None and hw_rng:
        raise ValueError("energies are collected on the counter hash only "
                         "(hw_rng=False)")
    return energies is not None


def energies_ptr(energies, steps, chains, device):
    """What a per-phase entry point takes for `energies`: None (NULL, no
    energies) or, once it is known to be a contiguous (steps, chains)
    float32 buffer on `device`, its pointer."""
    if energies is None:
        return None
    check_arg(energies, "energies", (steps, chains), device)
    return ptr(energies)


def stream_of(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on_error(lib, fn, rc, error_fn=None):
    """Raise RuntimeError if the C entry point `fn` returned a CUDA error;
    its text comes from `error_fn` (default: fn + "_error_string")."""
    if rc != 0:
        msg = getattr(lib, error_fn or fn + "_error_string")(rc).decode()
        raise RuntimeError(f"{fn} failed with CUDA error {rc}: {msg}")


def nvcc_path():
    """The nvcc of CUDA_HOME, of PATH, or of PyTorch's CUDA_HOME guess."""
    from torch.utils import cpp_extension

    for home in (os.environ.get("CUDA_HOME"), cpp_extension.CUDA_HOME):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built at first use and need "
        "the CUDA toolkit (set CUDA_HOME)"
    )


def _lib_path(name):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(names=KERNELS, verbose=False):
    """Compile every kernel of `names` whose library is missing, all at once
    in parallel. Returns {name: seconds nvcc took (0.0 if it was built
    already)}; with `verbose`, ptxas prints each kernel's registers and
    shared memory to stderr and keeps the report in PTXAS_LOG[name].
    Raises RuntimeError if nvcc fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    seconds = {name: 0.0 for name in names}
    for name in names:
        out = _lib_path(name)
        if out.is_file():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        jobs[name] = (subprocess.Popen(cmd, stderr=subprocess.PIPE,
                                       text=True), tmp, out, time.perf_counter())
    for name, (proc, tmp, out, t0) in jobs.items():
        _, err = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{err}")
        if verbose and err:
            PTXAS_LOG[name] = err
            print(err, end="", file=sys.stderr, flush=True)
        os.replace(tmp, out)
    return seconds


def library(name):
    """The loaded ctypes library of kernel `name`, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        _LIBS[name] = lib
    return lib
