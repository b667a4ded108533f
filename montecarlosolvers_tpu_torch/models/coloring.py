"""Greedy graph coloring (counterpart of montecarlosolvers_tpu/models/coloring.py).

Spins of one color share no coupling, so a whole color class updates at
once with exact Metropolis acceptance; sweeping the classes in turn is the
parallel stand-in for the reference's sequential shuffled order
(sa.pyx:71-79). This is host code on numpy: the JAX package first tries its
native C++ coloring (`native/neighbors.cpp`), which gives the same colors
as the loop below (tests/test_model.py), so the port keeps the loop alone.
"""

from __future__ import annotations

import numpy as np


def greedy_coloring(nbr_idx, nbr_val=None):
    """Greedy-color the interaction graph of a padded neighbor table.

    nbr_idx: (N, maxnb) int array of neighbor indices; self-index entries
    are ignored (they encode fields and padding). nbr_val: optional
    (N, maxnb) coupling values; slots with value 0 are ignored.

    Returns (colors, num_colors): an (N,) int32 array and the class count.
    Site i takes the smallest color none of its colored neighbors holds,
    visiting the sites in index order.
    """
    nbr_idx = np.asarray(nbr_idx)
    nspins, maxnb = nbr_idx.shape
    own = np.arange(nspins)[:, None]
    active = nbr_idx != own
    if nbr_val is not None:
        active &= np.asarray(nbr_val) != 0.0

    colors = np.full(nspins, -1, dtype=np.int32)
    for i in range(nspins):
        used = set()
        for k in range(maxnb):
            if active[i, k]:
                c = colors[nbr_idx[i, k]]
                if c >= 0:
                    used.add(c)
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    return colors, int(colors.max()) + 1


def ring_coloring(length):
    """Color a periodic ring (the Trotter axis, qmc.pyx:126-138): 2 colors
    when even, 3 when odd (the wrap edge breaks parity)."""
    colors = np.arange(length, dtype=np.int32) % 2
    if length % 2 == 1 and length > 1:
        colors[-1] = 2
    n = int(colors.max()) + 1 if length > 1 else 1
    return colors, n
