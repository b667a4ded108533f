"""Ising instance loading and generation.

Counterpart of `montecarlosolvers_tpu/models/instances.py`. The benchmark
instance ships in `i j J_ij` triplet format (1-indexed;
examples/ising_instances/santoro_80x80.txt) with a certified ground state;
the reference script negates couplings on load
(examples/santoro80.py:242-244), and that convention lives here. The file is
data, not code: it is looked up in the directory that `MCS_TPU_INSTANCE_DIR`
names. Every generator draws the same numbers as the JAX function of the
same name for the same `rng`, and returns the generic `IsingProblem`
unless asked for the `LatticeProblem` (`lattice=True`), as the JAX
functions do. Every function here puts its problem on `device`, and
device=None means the CUDA device (`_device.resolve`).
"""

from __future__ import annotations

import os

import numpy as np

from montecarlosolvers_tpu_torch import _roadmap
from montecarlosolvers_tpu_torch.models.ising import IsingProblem
from montecarlosolvers_tpu_torch.models.lattice import LatticeProblem

# Certified ground-state energy per spin of the 80x80 Gaussian instance
# (Spin Glass Server certificate), for the negated-couplings convention.
SANTORO_GS_ENERGY_PER_SPIN = -1.58051667679
SANTORO_NSPINS = 6400
SANTORO_MAXNB = 4


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


def santoro_80x80(maxnb=SANTORO_MAXNB, lattice=False, device=None):
    """The MST 2D random-Gaussian-J benchmark instance, with the reference
    script's coupling sign.

    lattice=True returns the LatticeProblem (the split and full-plane
    engines); False the generic IsingProblem with `maxnb` slots a spin.
    Returns (problem, gs_energy_total); raises FileNotFoundError when the
    instance file is not reachable."""
    path = _find_instance("santoro_80x80.txt")
    if path is None:
        raise FileNotFoundError(
            "santoro_80x80.txt not found; set MCS_TPU_INSTANCE_DIR"
        )
    rows, cols, vals = load_triplets(path, negate=True, one_indexed=True)
    if lattice:
        problem = LatticeProblem.from_edges(80, rows, cols, vals,
                                            device=device)
    else:
        problem = IsingProblem.from_edges(SANTORO_NSPINS, rows, cols, vals,
                                          maxnb=maxnb, device=device)
    return problem, SANTORO_GS_ENERGY_PER_SPIN * SANTORO_NSPINS


def random_2d_lattice(L, rng=None, dist="gauss", with_fields=False,
                      maxnb=None, lattice=False, device=None):
    """Random-coupling open-boundary square lattice (right and down edges
    only, like the santoro instance).

    lattice=True returns the LatticeProblem; False the IsingProblem with
    `maxnb` slots a spin (None: 5 with fields, else 4).
    Returns (problem, (rows, cols, vals))."""
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
    if lattice:
        problem = LatticeProblem.from_edges(L, rows, cols, vals,
                                            device=device)
    else:
        mx = maxnb if maxnb is not None else (5 if with_fields else 4)
        problem = IsingProblem.from_edges(n, rows, cols, vals, maxnb=mx,
                                          device=device)
    return problem, (rows, cols, vals)


def random_3d_lattice(L, rng=None, dist="pm1", periodic=True, device=None):
    """3D Edwards-Anderson spin glass on an L x L x L cubic lattice, random
    couplings (dist: 'pm1' bimodal +/-J, or 'gauss'), periodic by default.
    Returns (problem, (rows, cols, vals)) with a degree-6 IsingProblem
    (greedy-colored; 2 colors on an even periodic or any open lattice)."""
    rng = np.random.default_rng(rng)

    def node(x, y, z):
        return (x * L + y) * L + z

    rows, cols = [], []
    for x in range(L):
        for y in range(L):
            for z in range(L):
                i = node(x, y, z)
                for dx, dy, dz in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
                    xx, yy, zz = x + dx, y + dy, z + dz
                    if periodic:
                        rows.append(i)
                        cols.append(node(xx % L, yy % L, zz % L))
                    elif xx < L and yy < L and zz < L:
                        rows.append(i)
                        cols.append(node(xx, yy, zz))
    rows = np.array(rows, dtype=np.int64)
    cols = np.array(cols, dtype=np.int64)
    if dist == "pm1":
        vals = rng.choice([-1.0, 1.0], size=rows.shape)
    elif dist == "gauss":
        vals = rng.normal(size=rows.shape)
    else:
        raise ValueError(dist)
    problem = IsingProblem.from_edges(L ** 3, rows, cols, vals, maxnb=6,
                                      device=device)
    return problem, (rows, cols, vals)


def random_graph(nspins, nedges, rng=None, with_fields=False, device=None):
    """Random sparse graph of `nedges` distinct Gaussian bonds (and, with
    fields, a field of scale 0.5 on every spin); maxnb is the largest
    degree. Returns (problem, (rows, cols, vals))."""
    rng = np.random.default_rng(rng)
    seen = set()
    rows, cols = [], []
    while len(rows) < nedges:
        a, b = rng.integers(0, nspins, size=2)
        if a == b:
            continue
        key = (min(a, b), max(a, b))
        if key in seen:
            continue
        seen.add(key)
        rows.append(key[0])
        cols.append(key[1])
    rows = np.array(rows, dtype=np.int64)
    cols = np.array(cols, dtype=np.int64)
    vals = rng.normal(size=rows.shape)
    if with_fields:
        rows = np.concatenate([rows, np.arange(nspins)])
        cols = np.concatenate([cols, np.arange(nspins)])
        vals = np.concatenate([vals, rng.normal(size=nspins) * 0.5])
    deg = np.zeros(nspins, dtype=np.int64)
    off = rows != cols
    np.add.at(deg, rows[off], 1)
    np.add.at(deg, cols[off], 1)
    np.add.at(deg, rows[~off], 1)
    problem = IsingProblem.from_edges(nspins, rows, cols, vals,
                                      maxnb=int(deg.max()), device=device)
    return problem, (rows, cols, vals)


def save_triplets(path, rows, cols, vals, one_indexed=True):
    """Write an instance in the reference's `i j J_ij` triplet format (the
    format `load_triplets` and the JAX package read)."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    off = 1 if one_indexed else 0
    with open(path, "w") as f:
        for a, b, v in zip(rows, cols, np.asarray(vals)):
            f.write(f"{int(a) + off} {int(b) + off} {v:.10g}\n")


def sk_model(nspins, rng=None, dense=True, device=None):
    """Sherrington-Kirkpatrick spin glass: J_ij ~ N(0, 1/N) for all pairs.

    dense=False returns the generic IsingProblem (maxnb = N - 1, N colors:
    for small N). dense=True, the JAX package's default, builds its
    DenseProblem, which the port does not have yet: it raises
    NotImplementedError naming its ROADMAP.md item.
    Returns (problem, (rows, cols, vals))."""
    if dense:
        raise _roadmap.not_ported("sk_model(dense=True) (DenseProblem)",
                                  _roadmap.GENERIC_GRAPHS)
    rng = np.random.default_rng(rng)
    iu = np.triu_indices(nspins, k=1)
    vals = rng.normal(scale=1.0 / np.sqrt(nspins), size=iu[0].shape)
    problem = IsingProblem.from_edges(nspins, iu[0], iu[1], vals,
                                      maxnb=nspins - 1, device=device)
    return problem, (iu[0], iu[1], vals)


def chimera_graph(m, n=None, t=4, rng=None, dist="pm1", device=None):
    """D-Wave Chimera topology C_{m,n,t}: an m x n grid of K_{t,t} unit
    cells, vertical couplers between the left partitions of vertically
    adjacent cells, horizontal couplers between the right partitions of
    horizontally adjacent cells (C16 = the D-Wave 2000Q's 2048 qubits).
    Returns (problem, (rows, cols, vals)), maxnb t + 2."""
    n = m if n is None else n
    rng = np.random.default_rng(rng)

    def node(r, c, side, k):
        return ((r * n + c) * 2 + side) * t + k

    rows, cols = [], []
    for r in range(m):
        for c in range(n):
            for a in range(t):  # intra-cell bipartite K_{t,t}
                for b in range(t):
                    rows.append(node(r, c, 0, a))
                    cols.append(node(r, c, 1, b))
            if r + 1 < m:  # vertical couplers: left partition
                for k in range(t):
                    rows.append(node(r, c, 0, k))
                    cols.append(node(r + 1, c, 0, k))
            if c + 1 < n:  # horizontal couplers: right partition
                for k in range(t):
                    rows.append(node(r, c, 1, k))
                    cols.append(node(r, c + 1, 1, k))
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    if dist == "pm1":
        vals = rng.choice([-1.0, 1.0], size=rows.shape)
    else:
        vals = rng.normal(size=rows.shape)
    problem = IsingProblem.from_edges(m * n * 2 * t, rows, cols, vals,
                                      maxnb=t + 2, device=device)
    return problem, (rows, cols, vals)


def dense_matrix(nspins, rows, cols, vals):
    """Dense (N, N) float64 numpy coupling matrix from triplets, for
    oracle energy checks (`ising.classical_ising_energy`)."""
    J = np.zeros((nspins, nspins))
    for a, b, v in zip(rows, cols, vals):
        J[a, b] += v
    return J


def gaussian_torus(L, seed=0, device=None):
    """Periodic L x L Gaussian spin glass with j_right then j_down drawn from
    `np.random.default_rng(seed).normal` — the seeded stand-in for the
    santoro torus when its file is absent, and the lattice the JAX tests
    build as `LatticeProblem.from_planes(r.normal(...), r.normal(...))`."""
    r = np.random.default_rng(seed)
    return LatticeProblem.from_planes(
        r.normal(size=(L, L)), r.normal(size=(L, L)), device=device
    )
