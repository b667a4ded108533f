"""How far a torch.matmul's rows depend on how many rows it is given: the
product (C, N) @ (N, B) of random +/-1 rows and Gaussian columns, whole
and split into `ranks` blocks of rows, and the count of fields that differ
(the dense engine's block fields under chain sharding, ROADMAP.md queue
3). Usage:

    python tools/matmul_row_split.py [--device cpu|cuda] [--chains 32]
        [--n 2048] [--block 128] [--ranks 2 4]
"""

import argparse

import torch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--chains", type=int, default=32)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--ranks", type=int, nargs="+", default=[2, 4])
    args = ap.parse_args()
    g = torch.Generator().manual_seed(0)
    s = (torch.randint(0, 2, (args.chains, args.n), generator=g).float()
         * 2 - 1).to(args.device)
    J = torch.randn(args.n, args.block, generator=g).to(args.device)
    full = torch.matmul(s, J)
    for r in args.ranks:
        k = args.chains // r
        bad = sum(int((torch.matmul(s[i * k:(i + 1) * k].contiguous(), J)
                       != full[i * k:(i + 1) * k]).sum()) for i in range(r))
        print(f"{args.device} ({args.chains}, {args.n}) @ ({args.n}, "
              f"{args.block}) in {r} blocks of rows: {bad} of "
              f"{full.numel()} fields differ (torch {torch.__version__}, "
              f"{torch.get_num_threads()} threads)")


if __name__ == "__main__":
    main()
