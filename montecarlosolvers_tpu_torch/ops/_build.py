"""Build the CUDA sources in `csrc/` with nvcc at first use; bind via ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on its own
into `_build/lib<name>_<digest>.so`, where the digest covers the source, the
shared headers `csrc/*.cuh` and the flags, so an edited source is rebuilt
and an unchanged one is loaded from the build directory. nvcc takes seconds
for such a file (a PyTorch C++ extension, whose sources include PyTorch's
headers, takes minutes). Building happens only when a kernel is first needed or when `build` is
called; importing this module runs nothing.
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("split_sa", "split_qmc")

# No --use_fast_math: kernels and their plain versions must round alike.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: function -> (restype, argtypes)
SIGNATURES = {
    "split_sa": {
        # w, h, sched, a_in, b_in, a_out, b_out,
        # chains, nh, K, nslots, steps, seed, stream
        "split_sa_anneal": (_I, [_P] * 7 + [_I] * 6 + [_P]),
        "split_sa_anneal_error_string": (ctypes.c_char_p, [_I]),
    },
    "split_qmc": {
        # w, h, b_sched, jp, teff, 4 quarters in, 4 quarters out,
        # chains, Q, nh, K, nslots, steps, seed, global_moves, stream
        "split_qmc_anneal": (
            _I, [_P] * 4 + [ctypes.c_float] + [_P] * 8 + [_I] * 8 + [_P]
        ),
        "split_qmc_anneal_error_string": (ctypes.c_char_p, [_I]),
    },
}

_LIBS = {}


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
    shared memory to stderr. Raises RuntimeError if nvcc fails."""
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
