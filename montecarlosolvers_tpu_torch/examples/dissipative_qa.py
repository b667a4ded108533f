"""Open-system (dissipative) quantum annealing on the card (counterpart of
examples/dissipative_qa.py): how the residual energy of the MST protocol
answers the bath coupling alpha on the certified 80x80 instance (the
system-bath PIQMC of qmc.pyx:149-278 and :444-609; the bath Hamiltonian
alpha (pi / (P sin(pi d / P)))^2 of qmc.pyx:162-163).

Usage, from the repository root on a machine with a CUDA card and the
instance file in the directory MCS_TPU_INSTANCE_DIR names:

    python -m montecarlosolvers_tpu_torch.examples.dissipative_qa \\
        [--tau 2000] [--slices 20] [--chains 16] [--pt 1.0] \\
        [--alphas 0 0.01 0.05]

Every alpha runs from the same pre-annealed replicas with the same hash
seed. At alpha = 0 the solver takes no lookuptable, so the plain PIQMC
kernel B runs (even L and P); at alpha > 0 the bath kernel 5.
"""

from __future__ import annotations

import argparse
import time

import torch

from montecarlosolvers_tpu_torch import schedules
from montecarlosolvers_tpu_torch.models import instances
from montecarlosolvers_tpu_torch.solvers import qmc, sa


def run(problem, e_gs, tau=2000, slices=20, chains=16, pt=1.0,
        alphas=(0.0, 0.01, 0.05), verbose=True):
    """The protocol of examples/dissipative_qa.py:51-76 on `problem`: a
    classical pre-anneal 3 -> PT at mcsteps=5, one replicated `confs0`,
    then for each alpha a Gamma anneal 3 -> 1e-8 over `tau` sweeps with
    B = 1, T = PT/P, global moves and lookuptable=bath_lookuptable(P,
    alpha) (None at alpha = 0), all with one hash seed. Returns one dict
    per alpha: alpha, eps_res (the mean best-slice energy per spin above
    e_gs), eps_best, seconds and the energies (numpy)."""
    dev = problem.device
    gen = torch.Generator().manual_seed(0)
    s0 = sa.random_state(gen, problem.nspins, batch=(chains,), device=dev)
    s0 = sa.anneal(problem, schedules.pre_anneal_schedule(3.0, pt,
                                                          device=dev),
                   s0, gen, mcsteps=5)
    confs0 = qmc.replicate(s0, slices)
    a = schedules.transverse_field(3.0, 1e-8, tau, device=dev)
    b = torch.ones_like(a)
    # every alpha's anneal draws its hash seed from a generator seeded alike
    anneal_seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen))
    if verbose:
        print(f"L={problem.L}, P={slices}, tau={tau}, chains={chains}, "
              f"PT={pt}")
    rows = []
    for alpha in alphas:
        lut = (schedules.bath_lookuptable(slices, alpha, device=dev)
               if alpha > 0.0 else None)
        t0 = time.perf_counter()
        confs = qmc.anneal(problem, a, b, pt / slices, confs0,
                           torch.Generator().manual_seed(anneal_seed),
                           global_moves=True, lookuptable=lut)
        es = qmc.best_slice_energy(problem, confs).cpu().numpy()
        row = {"alpha": float(alpha),
               "eps_res": float((es.mean() - e_gs) / problem.nspins),
               "eps_best": float((es.min() - e_gs) / problem.nspins),
               "seconds": time.perf_counter() - t0, "energies": es}
        if verbose:
            print(f"  alpha={alpha:<6g} eps_res={row['eps_res']:.5f} "
                  f"(best chain {row['eps_best']:.5f}, "
                  f"{row['seconds']:.1f}s)")
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tau", type=int, default=2000)
    ap.add_argument("--slices", type=int, default=20)
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--pt", type=float, default=1.0,
                    help="effective temperature P*T (qmc.pyx:85)")
    ap.add_argument("--alphas", type=float, nargs="+",
                    default=[0.0, 0.01, 0.05])
    args = ap.parse_args(argv)
    problem, e_gs = instances.santoro_80x80(lattice=True)
    run(problem, e_gs, tau=args.tau, slices=args.slices, chains=args.chains,
        pt=args.pt, alphas=args.alphas)


if __name__ == "__main__":
    main()
