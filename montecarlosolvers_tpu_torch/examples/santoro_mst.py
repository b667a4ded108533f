"""The Martonak-Santoro-Tosatti SA-vs-PIQMC benchmark on the card
(counterpart of examples/santoro_mst.py): the certified 80x80 instance, a
tau sweep of classical annealing and PIQMC at P in {5, 10, 20, 40},
incremental checkpoints, and with --plot the log-log residual-energy
plots.

Usage, from the repository root on a machine with a CUDA card and the
instance file in the directory MCS_TPU_INSTANCE_DIR names:

    python -m montecarlosolvers_tpu_torch.examples.santoro_mst \\
        [--max-tau 60000] [--reps 45] [--outdir mst_results] [--budget S] \\
        [--plot]

Exit code 3 means "budget spent, more work remains"; a restart loop runs a
long matrix to its end:

    until python -m montecarlosolvers_tpu_torch.examples.santoro_mst \\
            --budget 900; do
        [ $? -ne 3 ] && break
    done
"""

from __future__ import annotations

import argparse
import sys

from montecarlosolvers_tpu_torch.bench import mst
from montecarlosolvers_tpu_torch.models import instances


def run(problem, e_gs, outdir="mst_results", reps=45, max_tau=None,
        budget=None, plot=False, taus=None, exps=None, verbose=True):
    """The matrix on `problem` against the ground-state energy `e_gs`:
    `mst.mst_benchmark` (taus, exps None: its default grid and arms), then,
    when it is complete and `plot` is set, the plots on both x axes.
    Returns (results, complete)."""
    results, complete = mst.mst_benchmark(
        problem, e_gs, outdir=outdir, taus=taus, reps=reps,
        exps=mst.DEFAULT_EXPS if exps is None else exps, max_tau=max_tau,
        verbose=verbose, budget_s=budget)
    if complete and plot:
        mst.plot_results(results, path=f"{outdir}/santoro_mst.png")
        mst.plot_results(results, path=f"{outdir}/santoro_mst_ref.png",
                         x="tau")
        if verbose:
            print(f"wrote {outdir}/santoro_mst.png (+_ref.png)")
    return results, complete


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--max-tau", type=int, default=None,
                    help="cap the tau sweep (the full sweep reaches 6e6)")
    ap.add_argument("--reps", type=int, default=45)
    ap.add_argument("--outdir", default="mst_results")
    ap.add_argument("--budget", type=float, default=None,
                    help="wall-clock budget in seconds; exit code 3 if more "
                         "work remains (run again to resume)")
    ap.add_argument("--plot", action="store_true",
                    help="write the PNGs (needs matplotlib)")
    args = ap.parse_args(argv)
    problem, e_gs = instances.santoro_80x80(lattice=True)
    _, complete = run(problem, e_gs, outdir=args.outdir, reps=args.reps,
                      max_tau=args.max_tau, budget=args.budget,
                      plot=args.plot)
    if not complete:
        print("budget spent; run again to resume")
        sys.exit(3)


if __name__ == "__main__":
    main()
