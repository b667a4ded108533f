"""Command-line interface: anneal instance files from the shell
(counterpart of montecarlosolvers_tpu/__main__.py).

    python -m montecarlosolvers_tpu_torch solve INSTANCE.txt --method piqmc \
        --num-reads 64 --sweeps 4000 [--negate] [--lattice L] [--out out.npz] \
        [--device cpu]
    python -m montecarlosolvers_tpu_torch bench [bench/throughput.py options]

INSTANCE.txt is the reference's `i j J_ij` triplet format (1-indexed;
--negate applies the benchmark driver's coupling negation,
examples/santoro80.py:244). `solve` prints one JSON line (the best and
mean energy, the reads and the solve's info) and writes all samples to
--out when given. It runs on the CUDA card unless --device says otherwise.
`bench` runs the port's throughput bench (`bench/throughput.py`), passing
on the arguments that follow it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

# One choice per solve() method, kept in lockstep with solvers.api.
# _METHOD_KW (and the JAX package's SOLVE_METHODS) by
# tests/test_torch_cli.py; written out so that parsing --help imports no
# solver.
SOLVE_METHODS = ("sa", "sa_wolff", "sa_sw",
                 "piqmc", "piqmc_wolff", "piqmc_sw", "piqmc_sw_full",
                 "svmc", "pt", "icm", "pa", "paq")


def _build_problem(args):
    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.models.ising import IsingProblem
    from montecarlosolvers_tpu_torch.models.lattice import LatticeProblem

    rows, cols, vals = instances.load_triplets(
        args.instance, negate=args.negate, one_indexed=not args.zero_indexed
    )
    if args.lattice:
        return LatticeProblem.from_edges(args.lattice, rows, cols, vals,
                                         device=args.device)
    n = int(max(rows.max(), cols.max())) + 1
    return IsingProblem.from_edges(n, rows, cols, vals, device=args.device)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="montecarlosolvers_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("solve", help="anneal an instance file")
    sp.add_argument("instance")
    sp.add_argument("--method", default="sa", choices=SOLVE_METHODS)
    sp.add_argument("--num-reads", type=int, default=64)
    sp.add_argument("--sweeps", type=int, default=1000)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--slices", type=int, default=20,
                    help="Trotter slices (piqmc)")
    sp.add_argument("--negate", action="store_true",
                    help="negate couplings on load (benchmark convention)")
    sp.add_argument("--zero-indexed", action="store_true")
    sp.add_argument("--lattice", type=int, default=None, metavar="L",
                    help="treat as an L x L lattice (the split and "
                         "full-plane engines)")
    sp.add_argument("--out", default=None, help="write samples to .npz")
    sp.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions")

    sub.add_parser("bench", add_help=False,
                   help="run the throughput bench (bench/throughput.py; "
                        "its options follow, see `bench --help`)")

    # the bench's own options (its --help too) go to its parser, from argv
    # as given here and never from sys.argv
    args, rest = ap.parse_known_args(argv)
    if args.cmd == "bench":
        from montecarlosolvers_tpu_torch.bench import throughput

        throughput.main(rest)
        return 0
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")

    from montecarlosolvers_tpu_torch.solvers.api import solve

    problem = _build_problem(args)
    kw = (dict(slices=args.slices)
          if args.method.startswith("piqmc") else {})
    res = solve(problem, method=args.method, num_reads=args.num_reads,
                sweeps=args.sweeps, seed=args.seed, **kw)
    print(json.dumps({
        "best_energy": res.best_energy,
        "mean_energy": float(res.energies.mean()),
        "num_reads": len(res),
        **{k: v for k, v in res.info.items() if k != "num_reads"},
    }, default=float))
    if args.out:
        np.savez(args.out, samples=res.samples, energies=res.energies)
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
