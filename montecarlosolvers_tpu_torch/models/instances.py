"""Ising instance loading and generation.

Counterpart of `montecarlosolvers_tpu/models/instances.py`, for the lattice
form only (the generic `IsingProblem` is not ported yet). The benchmark
instance ships in `i j J_ij` triplet format
(1-indexed; examples/ising_instances/santoro_80x80.txt) with a certified
ground state; the reference script negates couplings on load
(examples/santoro80.py:242-244), and that convention lives here. The file is
data, not code: it is looked up in the directory that `MCS_TPU_INSTANCE_DIR`
names, as the JAX package does.
"""

from __future__ import annotations

import os

import numpy as np

from montecarlosolvers_tpu_torch import _roadmap
from montecarlosolvers_tpu_torch.models.lattice import LatticeProblem

# Certified ground-state energy per spin of the 80x80 Gaussian instance
# (Spin Glass Server certificate), for the negated-couplings convention.
SANTORO_GS_ENERGY_PER_SPIN = -1.58051667679
SANTORO_NSPINS = 6400

def _find_instance(name):
    # env read per call so setting MCS_TPU_INSTANCE_DIR after import works
    d = os.environ.get("MCS_TPU_INSTANCE_DIR", "")
    if d and os.path.isfile(os.path.join(d, name)):
        return os.path.join(d, name)
    return None


def load_triplets(path, negate=False, one_indexed=True):
    """Load an `i j J_ij` triplet file into COO arrays."""
    model = np.loadtxt(path)
    if model.ndim == 1:
        model = model[None, :]
    rows = model[:, 0].astype(np.int64)
    cols = model[:, 1].astype(np.int64)
    vals = model[:, 2].astype(np.float64)
    if one_indexed:
        rows -= 1
        cols -= 1
    if negate:
        vals = -vals
    return rows, cols, vals


def santoro_80x80(lattice=True, device=None):
    """The MST 2D random-Gaussian-J benchmark instance, with the reference
    script's coupling sign.

    Returns (LatticeProblem, gs_energy_total); raises FileNotFoundError when
    the instance file is not reachable."""
    if not lattice:
        raise _roadmap.not_ported("lattice=False (the generic IsingProblem)",
                                  _roadmap.GENERIC_PROBLEM)
    path = _find_instance("santoro_80x80.txt")
    if path is None:
        raise FileNotFoundError(
            "santoro_80x80.txt not found; set MCS_TPU_INSTANCE_DIR"
        )
    rows, cols, vals = load_triplets(path, negate=True, one_indexed=True)
    problem = LatticeProblem.from_edges(80, rows, cols, vals, device=device)
    return problem, SANTORO_GS_ENERGY_PER_SPIN * SANTORO_NSPINS


def random_2d_lattice(L, rng=None, dist="gauss", with_fields=False,
                      lattice=True, device=None):
    """Random-coupling open-boundary square lattice (right and down edges
    only, like the santoro instance). Draws the same numbers as the JAX
    package's `random_2d_lattice` for the same `rng`.

    Returns (LatticeProblem, (rows, cols, vals))."""
    if not lattice:
        raise _roadmap.not_ported("lattice=False (the generic IsingProblem)",
                                  _roadmap.GENERIC_PROBLEM)
    rng = np.random.default_rng(rng)
    n = L * L
    rows, cols = [], []
    for r in range(L):
        for c in range(L):
            i = r * L + c
            if c + 1 < L:
                rows.append(i)
                cols.append(i + 1)
            if r + 1 < L:
                rows.append(i)
                cols.append(i + L)
    rows = np.array(rows, dtype=np.int64)
    cols = np.array(cols, dtype=np.int64)
    if dist == "gauss":
        vals = rng.normal(size=rows.shape)
    elif dist == "pm1":
        vals = rng.choice([-1.0, 1.0], size=rows.shape)
    else:
        raise ValueError(dist)
    if with_fields:
        rows = np.concatenate([rows, np.arange(n)])
        cols = np.concatenate([cols, np.arange(n)])
        vals = np.concatenate([vals, rng.normal(size=n) * 0.1])
    problem = LatticeProblem.from_edges(L, rows, cols, vals, device=device)
    return problem, (rows, cols, vals)


def gaussian_torus(L, seed=0, device=None):
    """Periodic L x L Gaussian spin glass with j_right then j_down drawn from
    `np.random.default_rng(seed).normal` — the seeded stand-in for the
    santoro torus when its file is absent, and the lattice the JAX tests
    build as `LatticeProblem.from_planes(r.normal(...), r.normal(...))`."""
    r = np.random.default_rng(seed)
    return LatticeProblem.from_planes(
        r.normal(size=(L, L)), r.normal(size=(L, L)), device=device
    )
