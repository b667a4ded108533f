"""Migration demo: reference-style code on the port (counterpart of
examples/compat_migration.py).

The body is written the way a user of the reference package writes a
driver (tools.GenerateNeighbors and in-place kernel calls,
examples/santoro80.py style); only the import line changes, and the calls
take `device=` where they should not run on the card.

    python -m montecarlosolvers_tpu_torch.examples.compat_migration \\
        [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

# reference:  import DTK.MonteCarloSolvers.piqmc.{sa,qmc,tools}
# here: one module carries the whole reference surface
from montecarlosolvers_tpu_torch import compat as mcs


def run(L=16, sweeps=1000, slices=8, device=None, verbose=True):
    """A random L x L open lattice in the reference's dict workflow: SA,
    then a pre-anneal and PIQMC with global moves in the (N, P) layout,
    all in place. Returns {"sa_energy", "piqmc_best_energy", "nspins",
    "bound"}, bound = -sum |J|, a lower bound of every energy."""
    rng = np.random.RandomState(42)
    nspins = L * L
    J = {}
    for r in range(L):
        for c in range(L):
            i = r * L + c
            if c + 1 < L:
                J[(i, i + 1)] = rng.randn()
            if r + 1 < L:
                J[(i, i + L)] = rng.randn()

    nbs = mcs.GenerateNeighbors(nspins, J, 4)

    # classical anneal, in place (sa.Anneal semantics)
    svec = (2 * rng.randint(2, size=nspins) - 1).astype(np.float64)
    sched = np.linspace(3.0, 0.0, sweeps)
    mcs.Anneal(sched, 1, svec, nbs, seed=0, device=device)
    Jd = np.zeros((nspins, nspins))
    for (a, b), v in J.items():
        Jd[a, b] = v
    e_sa = mcs.ClassicalIsingEnergy(svec, Jd)
    if verbose:
        print("SA energy:", e_sa)

    # PIQMC with global moves, reference (nspins, P) layout, in place
    P, pt = slices, 1.0
    pre = np.linspace(3.0, pt, int((3.0 - pt) / 0.05) + 1)
    state = (2 * rng.randint(2, size=nspins) - 1).astype(np.float64)
    mcs.Anneal(pre, 10, state, nbs, seed=1, device=device)
    confs = np.tile(state, (P, 1)).T
    A = np.linspace(3.0, 1e-8, sweeps)
    B = np.ones_like(A)
    mcs.QuantumAnnealGlobal(A, B, 1, pt / P, confs, nbs, seed=2,
                            device=device)
    best = min(mcs.ClassicalIsingEnergy(confs[:, k], Jd) for k in range(P))
    if verbose:
        print("PIQMC best-slice energy:", best)
    return {"sa_energy": e_sa, "piqmc_best_energy": best, "nspins": nspins,
            "bound": -float(np.sum(np.abs(list(J.values()))))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions")
    args = ap.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
