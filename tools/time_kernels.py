#!/usr/bin/env python3
"""Slope-time kernels A, 5, 6, B, 3, 7 and 4 of the
montecarlosolvers_tpu_torch found on the import path, on one CUDA card, at
the main path's shapes.

    PYTHONPATH=<checkout> python tools/time_kernels.py [--label NAME]
        [--L 80] [--sa-geometry CHAINS:C:R ...]
        [--bath-geometry R ...] [--qmc-geometry R ...]
        [--plane-qmc-geometry R ...] [--plane-svmc-geometry R ...]
        [--split-svmc-geometry R ...] [--only KERNEL ...]
    PYTHONPATH=<checkout> python tools/time_kernels.py --hw-rng [--rounds N]

Rows: kernel A at 1280 and 32 chains on the seeded L x L torus (T: 3 -> 0),
kernel 5 at P = 40, 32 chains, alpha = 1e-2, global moves on the same
torus, kernel 6 at 1280 and 32 chains on the seeded (L+1) x (L+1) torus,
kernel B at P = 40, 32 chains, global moves on the L x L torus, kernel 3 at
P = 5, 32 chains, global moves on the L x L and (L+1) x (L+1) tori, and
kernel 7 at 256 chains, TF proposals (A: 3 -> 1e-8, B = 1, T = 0.05) on
the (L+1) x (L+1) torus, and kernel 4 likewise on the L x L torus; one
JSON line each, with the geometry and the clusters the card holds at once
where the checkout reports them, with ms per sweep (the median pairwise
slope of best-of-3 wall times over two schedule lengths, as
chip_smoke.py's slope_ms), the card's name and power limit. It calls only
the wrappers `sa_split_anneal`, `qmc_bath_split_anneal`, `sa_plane_anneal`,
`qmc_split_anneal`, `qmc_plane_anneal`, `svmc_plane_anneal` and
`svmc_split_anneal`, whose arguments every version of the port shares, so
the same script times an older checkout (unpacked with `git archive`)
beside the current one in one run. `--sa-geometry` times kernel A at
CHAINS (1280 or 32) chains at each given (C, R), and `--bath-geometry` /
`--qmc-geometry` / `--plane-qmc-geometry` / `--plane-svmc-geometry` /
`--split-svmc-geometry` kernel 5 / B / 3 / 7 / 4 at each given R, instead
of the wrapper's own choice (where the checkout has `sa_geometry` /
`qmc_bath_geometry` / `qmc_geometry` / `plane_qmc_geometry` /
`plane_svmc_geometry` / `svmc_split_geometry`). `--only` times just the
named kernels (split_sa, split_qmc_bath, plane_sa, split_qmc, plane_qmc,
plane_svmc, split_svmc). `--hw-rng` times instead kernels A, B, 4 and 5
at the shapes of bench/throughput.py's pallas_* arms (A 256 chains; B
P = 40, 16 chains, global moves; 4 128 chains, TF; 5 P = 40, 8 chains,
alpha = 1e-2, global moves) with the counter hash and with hw_rng=True,
in the order hash, hw_rng, hw_rng, hash, `--rounds` times over.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def slope_ms(run, taus, trials=3):
    best = {}
    for tau in taus:
        run(tau)  # warm
        times = []
        for _ in range(trials):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(tau)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        best[tau] = min(times)
    (a, ta), (b, tb) = sorted(best.items())
    return 1e3 * (tb - ta) / (b - a)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--L", type=int, default=80)
    ap.add_argument("--sa-geometry", nargs="*", default=[])
    ap.add_argument("--bath-geometry", nargs="*", default=[])
    ap.add_argument("--qmc-geometry", nargs="*", default=[])
    ap.add_argument("--plane-qmc-geometry", nargs="*", default=[])
    ap.add_argument("--plane-svmc-geometry", nargs="*", default=[])
    ap.add_argument("--split-svmc-geometry", nargs="*", default=[])
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--hw-rng", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")

    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.ops import piqmc as piqmc_ops
    from montecarlosolvers_tpu_torch.ops import plane as plane_ops
    from montecarlosolvers_tpu_torch.ops import plane_kernels as pk
    from montecarlosolvers_tpu_torch.ops import split as split_ops
    from montecarlosolvers_tpu_torch.ops import split_kernels as sk

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    L, P = args.L, 40
    sl = split_ops.build_split(instances.gaussian_torus(L, seed=0,
                                                        device=dev))
    rng = np.random.default_rng(1)

    def spins(*shape):
        return torch.as_tensor(rng.choice([-1.0, 1.0], size=shape)
                               .astype(np.float32), device=dev)

    def taus(n):  # two schedule lengths, n and 4n sweeps, at least 5
        return max(n, 5), 4 * max(n, 5)

    def emit(**rec):
        print(json.dumps({"label": args.label, **rec, "gpu": smi}),
              flush=True)

    def wanted(kernel):
        return args.only is None or kernel in args.only

    if args.hw_rng:
        time_hw_rng(args, dev, sl, spins, taus, emit)
        return

    sa_geoms = [tuple(map(int, g.split(":"))) for g in args.sa_geometry]
    own_sa = getattr(sk, "sa_geometry", None)
    for chains in (1280, 32) if wanted("split_sa") else ():
        a, b = (x.contiguous() for x in split_ops.pack_classical(
            sl, spins(chains, L * L)))

        def run(tau):
            return sk.sa_split_anneal(
                sl, schedules.linear(3.0, 0.0, tau, device=dev), a, b, 7)
        geoms = [g[1:] for g in sa_geoms if g[0] == chains]
        for geom in geoms or [None]:
            if geom is not None:
                sk.sa_geometry = (lambda ch, lat, *_, g=geom:
                                  (g[0], g[1], sk._threads(lat, g[1])))
            used = sk.sa_geometry(chains, L, sk.card_resident(
                "split_sa", L)) if own_sa else None
            emit(kernel="split_sa", chains=chains, L=L, geometry=used,
                 resident=used and sk.resident_clusters(
                     "split_sa", used[1], used[2], L),
                 ms_per_sweep=slope_ms(run, taus(500 * 6400 // L ** 2)))
            if own_sa:
                sk.sa_geometry = own_sa

    a, b = (x.contiguous() for x in split_ops.pack_classical(
        sl, spins(32, P, L * L)))
    bath = piqmc_ops.bath_matrix(schedules.bath_lookuptable(
        P, 1e-2, device=dev), P).contiguous()
    teff = (1.0 / P) * P

    def run(tau):
        g = schedules.transverse_field(3.0, 1e-8, tau, device=dev)
        return sk.qmc_bath_split_anneal(
            sl, torch.ones_like(g), schedules.jperp(g, teff).contiguous(),
            teff, bath, a, b, 7, True)
    own_bath = getattr(sk, "qmc_bath_geometry", None)
    for geom in ([int(g) for g in args.bath_geometry] or [None]
                 if wanted("split_qmc_bath") else []):
        if geom is not None:
            sk.qmc_bath_geometry = (lambda ch, lat, p, *_, r=geom:
                                    (r, sk._threads(lat, r)))
        used = sk.qmc_bath_geometry(32, L, P, sk.card_resident(
            "split_qmc_bath", L, P)) if own_bath else None
        emit(kernel="split_qmc_bath", chains=32, L=L, P=P, geometry=used,
             resident=used and sk.resident_clusters(
                 "split_qmc_bath", used[0], used[1], L, P),
             ms_per_sweep=slope_ms(run, taus(100 * 6400 // L ** 2)))
        if own_bath:
            sk.qmc_bath_geometry = own_bath

    odd = L + 1
    pl = plane_ops.build_plane(instances.gaussian_torus(odd, seed=0,
                                                        device=dev))
    own_plane = getattr(pk, "plane_sa_geometry", None)
    for chains in (1280, 32) if wanted("plane_sa") else ():
        s = spins(chains, odd, odd)

        def run(tau):
            return pk.sa_plane_anneal(
                pl, schedules.linear(3.0, 0.0, tau, device=dev), s, 7)
        used = pk.plane_sa_geometry(chains, odd, sk.card_resident(
            "plane_sa", odd)) if own_plane else None
        emit(kernel="plane_sa", chains=chains, L=odd, geometry=used,
             ms_per_sweep=slope_ms(run, taus(500 * 6400 // odd ** 2)))

    qs = split_ops.pack_qmc(sl, spins(32, P, L * L))

    def run(tau):
        g = schedules.transverse_field(3.0, 1e-8, tau, device=dev)
        return sk.qmc_split_anneal(
            sl, torch.ones_like(g), schedules.jperp(g, teff).contiguous(),
            teff, qs, 7, True)
    own_qmc = getattr(sk, "qmc_geometry", None)
    for geom in ([int(g) for g in args.qmc_geometry] or [None]
                 if wanted("split_qmc") else []):
        if geom is not None:
            sk.qmc_geometry = (lambda ch, lat, p, *_, r=geom:
                               (r, sk._threads(lat, r)))
        used = sk.qmc_geometry(32, L, P, sk.card_resident(
            "split_qmc", L, P)) if own_qmc else None
        emit(kernel="split_qmc", chains=32, L=L, P=P, geometry=used,
             ms_per_sweep=slope_ms(run, taus(100 * 6400 // L ** 2)))
        if own_qmc:
            sk.qmc_geometry = own_qmc

    own_plane_qmc = getattr(pk, "plane_qmc_geometry", None)
    P5 = 5
    teff5 = (1.0 / P5) * P5
    for lat in (L, odd) if wanted("plane_qmc") else ():
        pl_q = plane_ops.build_plane(instances.gaussian_torus(
            lat, seed=0, device=dev))
        c = spins(32, P5, lat, lat)

        def run(tau):
            g = schedules.transverse_field(3.0, 1e-8, tau, device=dev)
            return pk.qmc_plane_anneal(
                pl_q, torch.ones_like(g),
                schedules.jperp(g, teff5).contiguous(), teff5, c, 7, True)
        for geom in [int(g) for g in args.plane_qmc_geometry] or [None]:
            if geom is not None and own_plane_qmc:
                pk.plane_qmc_geometry = (lambda ch, lt, p, *_, r=geom:
                                         (r, pk._site_threads(lt, r)))
            used = pk.plane_qmc_geometry(32, lat, P5, sk.card_resident(
                "plane_qmc", lat, P5)) if own_plane_qmc else None
            emit(kernel="plane_qmc", chains=32, L=lat, P=P5, geometry=used,
                 resident=used and sk.resident_clusters(
                     "plane_qmc", used[0], used[1], lat, P5),
                 ms_per_sweep=slope_ms(run, taus(100 * 6400 // lat ** 2)))
            if own_plane_qmc:
                pk.plane_qmc_geometry = own_plane_qmc

    own_plane_svmc = getattr(pk, "plane_svmc_geometry", None)
    th = torch.as_tensor((rng.random((256, odd, odd)) * np.pi)
                         .astype(np.float32), device=dev)

    def run(tau):
        a = schedules.linear(3.0, 1e-8, tau, device=dev)
        return pk.svmc_plane_anneal(pl, a, torch.ones_like(a), 0.05, th, 7,
                                    True)
    for geom in ([int(g) for g in args.plane_svmc_geometry] or [None]
                 if wanted("plane_svmc") else []):
        if geom is not None and own_plane_svmc:
            pk.plane_svmc_geometry = (lambda ch, lt, *_, r=geom:
                                      (r, pk._slot_threads(lt, r)))
        used = pk.plane_svmc_geometry(256, odd, sk.card_resident(
            "plane_svmc", odd)) if own_plane_svmc else None
        emit(kernel="plane_svmc", chains=256, L=odd, tf=True, geometry=used,
             resident=used and sk.resident_clusters(
                 "plane_svmc", used[0], used[1], odd),
             ms_per_sweep=slope_ms(run, taus(500 * 6400 // odd ** 2)))
        if own_plane_svmc:
            pk.plane_svmc_geometry = own_plane_svmc

    own_split_svmc = getattr(sk, "svmc_split_geometry", None)
    ah, bh = (x.contiguous() for x in split_ops.pack_classical(
        sl, torch.as_tensor((rng.random((256, L * L)) * np.pi)
                            .astype(np.float32), device=dev)))

    def run(tau):
        a = schedules.linear(3.0, 1e-8, tau, device=dev)
        return sk.svmc_split_anneal(sl, a, torch.ones_like(a), 0.05, ah, bh,
                                    7, True)
    for geom in ([int(g) for g in args.split_svmc_geometry] or [None]
                 if wanted("split_svmc") else []):
        if geom is not None and own_split_svmc:
            sk.svmc_split_geometry = (lambda ch, lt, *_, r=geom:
                                      (r, sk._threads(lt, r)))
        used = sk.svmc_split_geometry(256, L, sk.card_resident(
            "split_svmc", L)) if own_split_svmc else None
        emit(kernel="split_svmc", chains=256, L=L, tf=True, geometry=used,
             resident=used and sk.resident_clusters(
                 "split_svmc", used[0], used[1], L),
             ms_per_sweep=slope_ms(run, taus(500 * 6400 // L ** 2)))
        if own_split_svmc:
            sk.svmc_split_geometry = own_split_svmc


def time_hw_rng(args, dev, sl, spins, taus, emit):
    """Kernels A, B, 4 and 5 at the pallas_* arms' shapes, hash against
    hw_rng=True (see the module docstring)."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.ops import piqmc as piqmc_ops
    from montecarlosolvers_tpu_torch.ops import split as split_ops
    from montecarlosolvers_tpu_torch.ops import split_kernels as sk

    L, P = args.L, 40
    teff = (1.0 / P) * P

    def field(tau):
        g = schedules.transverse_field(3.0, 1e-8, tau, device=dev)
        return torch.ones_like(g), schedules.jperp(g, teff).contiguous()

    a, b = (x.contiguous() for x in split_ops.pack_classical(
        sl, spins(256, L * L)))
    qs = split_ops.pack_qmc(sl, spins(16, P, L * L))
    a5, b5 = (x.contiguous() for x in split_ops.pack_classical(
        sl, spins(8, P, L * L)))
    bath = piqmc_ops.bath_matrix(schedules.bath_lookuptable(
        P, 1e-2, device=dev), P).contiguous()
    ah, bh = (x.contiguous() for x in split_ops.pack_classical(
        sl, torch.rand((128, L * L), device=dev) * np.pi))
    rows = {
        "split_sa": (256, 500, lambda hw: lambda tau: sk.sa_split_anneal(
            sl, schedules.linear(3.0, 0.0, tau, device=dev), a, b, 7,
            hw_rng=hw)),
        "split_qmc": (16, 100, lambda hw: lambda tau: sk.qmc_split_anneal(
            sl, *field(tau), teff, qs, 7, True, hw_rng=hw)),
        "split_svmc": (128, 500, lambda hw: lambda tau: sk.svmc_split_anneal(
            sl, schedules.linear(3.0, 1e-8, tau, device=dev),
            torch.ones(tau, device=dev), 0.05, ah, bh, 7, True, hw_rng=hw)),
        "split_qmc_bath": (8, 100, lambda hw: lambda tau:
                           sk.qmc_bath_split_anneal(
                               sl, *field(tau), teff, bath, a5, b5, 7, True,
                               hw_rng=hw)),
    }
    for rnd in range(args.rounds):
        for kernel, (chains, n, make) in rows.items():
            for hw in (False, True, True, False):
                emit(kernel=kernel, hw_rng=hw, round=rnd, chains=chains,
                     L=L, ms_per_sweep=slope_ms(make(hw),
                                                taus(n * 6400 // L ** 2)))


if __name__ == "__main__":
    main()
