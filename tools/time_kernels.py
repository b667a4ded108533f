#!/usr/bin/env python3
"""Slope-time kernels A, 5, 6, B, 3, 7 and 4 of the
montecarlosolvers_tpu_torch found on the import path, on one CUDA card, at
the main path's shapes.

    PYTHONPATH=<checkout> python tools/time_kernels.py [--label NAME]
        [--L 80] [--sa-geometry CHAINS:C:R ...]
        [--bath-geometry R ...] [--qmc-geometry R ...]
        [--plane-qmc-geometry R ...] [--plane-svmc-geometry R ...]
        [--split-svmc-geometry R ...] [--generic-geometry R ...]
        [--label-geometry R ...] [--packed-sa-geometry GRAPH:CHAINS:C:R
        ...] [--packed-sa-wide] [--dense-warps W ...]
        [--energy-bits-k CHAINS:K ...] [--packed-svmc-geometry CHAINS:R
        ...] [--only KERNEL ...] [--qmc-phased]
    PYTHONPATH=<checkout> python tools/time_kernels.py --packed-sa-crossover
    PYTHONPATH=<checkout> python tools/time_kernels.py --packed-svmc-crossover
    PYTHONPATH=<checkout> python tools/time_kernels.py --hw-rng [--rounds N]

Rows: kernel A at 1280 and 32 chains on the seeded L x L torus (T: 3 -> 0),
kernel 5 at P = 40, 32 chains, alpha = 1e-2, global moves on the same
torus, kernel 6 at 1280 and 32 chains on the seeded (L+1) x (L+1) torus,
kernel B at P = 40, 32 chains, global moves on the L x L torus, kernel 3 at
P = 5, 32 chains, global moves on the L x L and (L+1) x (L+1) tori, and
kernel 7 at 256 chains, TF proposals (A: 3 -> 1e-8, B = 1, T = 0.05) on
the (L+1) x (L+1) torus, and kernel 4 likewise on the L x L torus; the
packed SA kernel (`time_packed_sa`: 1280, 32 and 8 chains, per-step
tables, 384 temperatures a chain on the L x L torus's generic form, 32
chains on chimera_graph(16)),
generic PIQMC and the generic bath at their `time_generic_qmc` shapes (32
chains, P = 40 on the L x L torus, the (L+1) x (L+1) checkerboard, P = 20
on chimera_graph(16)), and the dense
in-block kernel (400 block launches queued behind a spin kernel, CUDA
events, and the sweep with its block products, slope-timed; beside them
the host path: the host's time to queue a block launch and a sweep, and
the card's time for 5 sweeps queued behind a spin kernel, the least of
three) at 1024 and 64
chains on sk_model(2048, rng=0) (a checkout whose kernel adds h takes the
block's products and h, an older one the fields), and the cluster kernels fk_label (the
space-time sweep at P = 40, 8 chains, without and with the bath at
alpha = 1e-2, and the classical sweep at 64 chains) and fk_wolff (rule
"local" at P = 40, one chain and 16, and the classical cluster at 64
chains) on the L x L torus's generic form, chip_smoke.py::cluster_timing's
shapes, and fk_wolff at one chain, P = 40, and 64 chains, P = 1, on
random_2d_lattice(L, rng=0, with_fields=True) (bath "fields": the field
accept's ordered sums run), in ms a step; one
JSON line each, with the geometry and the clusters the card holds at once
where the checkout reports them, with ms per sweep (the median pairwise
slope of best-of-3 wall times over two schedule lengths, as
chip_smoke.py's slope_ms), the card's name and power limit. It calls only
the wrappers `sa_split_anneal`, `qmc_bath_split_anneal`, `sa_plane_anneal`,
`qmc_split_anneal`, `qmc_plane_anneal`, `svmc_plane_anneal`,
`svmc_split_anneal`, `packed_sa_anneal`, `generic_qmc_anneal`,
`generic_qmc_bath_anneal`, `dense_sa_block`, `dense_sa_anneal`,
`cluster_kernels.sw_anneal` and `cluster_kernels.wolff_anneal`, with
the arguments every version
of the port since their slice shares, so
the same script times an older checkout (unpacked with `git archive`)
beside the current one in one run. `--sa-geometry` times kernel A at
CHAINS (1280 or 32) chains at each given (C, R), and `--bath-geometry` /
`--qmc-geometry` / `--plane-qmc-geometry` / `--plane-svmc-geometry` /
`--split-svmc-geometry` kernel 5 / B / 3 / 7 / 4 at each given R, instead
of the wrapper's own choice (where the checkout has `sa_geometry` /
`qmc_bath_geometry` / `qmc_geometry` / `plane_qmc_geometry` /
`plane_svmc_geometry` / `svmc_split_geometry`); `--generic-geometry`
times generic PIQMC and the bath on the L x L torus at each given R
(where the checkout has `generic_qmc_geometry`), `--packed-sa-geometry`
packed SA's rows at each given (C, R) and `--packed-sa-wide` on the
file's first kernel (where the checkout has `packed_sa_geometry`),
`--dense-warps` the in-block kernel at each given count of warps, 1 to 8
(chains) a CTA (where the checkout's `dense_kernels.WARPS` sets it),
and `--one-step` adds
to their rows the median ms of a whole one-step call (what the cluster
solvers' interleaved local sweeps pay). `--label-geometry` times
fk_label and fk_wolff at each given cluster size R (where the checkout has
`cluster_kernels.label_geometry`). The energy kernel on kernel A's
chain-bit words (`time_energy_bits`: `split_kernels.words_energy` at 384,
1024 and 7040 chains on the L x L torus, 400 calls queued behind a spin
kernel, beside the energy kernel on the unpacked halves) and generic SVMC
(`time_packed_svmc`: `generic_kernels.packed_svmc_anneal` on the L x L
torus's generic form at 256 chains, TF and uniform proposals and per-step
tables, and at 32 and 8 chains) time as the rest; `--energy-bits-k`
times the words' energy at CHAINS chains at each given K (chains of a
group a CTA, where the checkout has `words_energy_geometry`) and
`--packed-svmc-geometry` generic SVMC at CHAINS chains at each given
cluster size R, R = 0 for the file's first kernel (where the checkout has
`packed_svmc_geometry`). `--only` times just the
named kernels (split_sa, split_qmc_bath, plane_sa, split_qmc, plane_qmc,
plane_svmc, split_svmc, packed_sa, generic_qmc, generic_qmc_bath,
dense_sa, fk_label, fk_wolff, energy_bits, packed_svmc, houdayer,
fk_line, shard_bath_slice, shard_label). The Houdayer move (`time_houdayer_line`: ms a move queued
behind a spin kernel, in site order and, where the checkout has it, in
place on a packed state, at ICM's 768 and 24 pairs of
random_3d_lattice(12, rng=0) and 48 pairs of the L x L torus's generic
form) and fk_line (`cluster_kernels.sw_bath_anneal` without local sweeps,
WC3 and WC2, 8 chains, P = 40, alpha = 1e-2, ms a step) time as the rest,
through wrappers every checkout since their slice has; so do S5 and S7,
the sharded bath's slice step and the sharded SW labels (`time_shard`:
ms a launch or a draw queued, and their one-rank engines' ms a sweep or
a step beside the single-device kernels'). `--qmc-phased`
adds a row of kernel B's per-phase route at the same shape (its
`qmc_geometry` answering that no cluster holds it). `--hw-rng` times
instead kernels A, B, 4 and 5
at the shapes of bench/throughput.py's pallas_* arms (A 256 chains; B
P = 40, 16 chains, global moves; 4 128 chains, TF; 5 P = 40, 8 chains,
alpha = 1e-2, global moves) with the counter hash and with hw_rng=True,
in the order hash, hw_rng, hw_rng, hash, `--rounds` times over.
`--packed-sa-crossover` times instead generic SA's two kernels against
each other over graph sizes and chain counts (`time_packed_sa_crossover`),
the readings its size rule (`generic_kernels.packed_sa_one_cta`) is set
from.
"""

import argparse
import inspect
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
    ap.add_argument("--generic-geometry", nargs="*", default=[])
    ap.add_argument("--label-geometry", nargs="*", default=[])
    ap.add_argument("--packed-sa-geometry", nargs="*", default=[])
    ap.add_argument("--packed-sa-wide", action="store_true")
    ap.add_argument("--packed-sa-crossover", action="store_true")
    ap.add_argument("--dense-warps", nargs="*", default=[])
    ap.add_argument("--energy-bits-k", nargs="*", default=[])
    ap.add_argument("--packed-svmc-geometry", nargs="*", default=[])
    ap.add_argument("--packed-svmc-crossover", action="store_true")
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--hw-rng", action="store_true")
    ap.add_argument("--qmc-phased", action="store_true")
    ap.add_argument("--one-step", action="store_true")
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
    if args.packed_sa_crossover:
        time_packed_sa_crossover(dev, spins, taus, emit)
        return
    if args.packed_svmc_crossover:
        time_packed_svmc_crossover(dev, taus, emit)
        return
    if wanted("houdayer") or wanted("fk_line"):
        time_houdayer_line(dev, spins, taus, emit, wanted)
    if wanted("shard_bath_slice") or wanted("shard_label"):
        time_shard(dev, spins, emit, wanted)
    if wanted("energy_bits"):
        time_energy_bits(args, dev, sl, spins, emit)
    if wanted("packed_svmc"):
        time_packed_svmc(args, dev, L, taus, emit)

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
    if args.qmc_phased and own_qmc and wanted("split_qmc"):
        sk.qmc_geometry = lambda *a, **k: None
        emit(kernel="split_qmc", route="phased", chains=32, L=L, P=P,
             ms_per_sweep=slope_ms(run, taus(100 * 6400 // L ** 2)))
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

    time_generic(args, dev, spins, taus, emit, wanted, L)


def time_generic(args, dev, spins, taus, emit, wanted, L):
    """The packed SA and generic PIQMC kernels on the L x L torus's generic
    form, and the dense in-block kernel and sweep on sk_model(2048)."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.ops import dense_kernels as dk
    from montecarlosolvers_tpu_torch.ops import dense_sweep as ds
    from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops

    pg = packed_ops.build_packed(instances.gaussian_torus(
        L, seed=0, device=dev).to_generic())
    if wanted("packed_sa"):
        time_packed_sa(args, dev, L, pg, spins, taus, emit)
    if wanted("generic_qmc") or wanted("generic_qmc_bath"):
        time_generic_qmc(args, dev, L, pg, spins, taus, emit, wanted)
    if wanted("fk_label") or wanted("fk_wolff"):
        time_cluster(args, dev, pg, spins, taus, emit, wanted)
    if not wanted("dense_sa"):
        return
    dp = instances.sk_model(2048, rng=0, device=dev)[0]
    # a checkout whose in-block kernel adds h takes the block's products
    # and h; an older one the fields
    takes_h = "h" in inspect.signature(dk.dense_sa_block).parameters
    forced = [int(w) for w in args.dense_warps]
    own_warps = dk.WARPS
    for chains in (1024, 64):
        s = spins(chains, 2048)
        temps = schedules.linear(3.0, 0.1, 1, device=dev)
        Jp, hp, sp = ds.padded(dp.J, dp.h, s.clone(), 128)
        prod = torch.matmul(sp, Jp[:, :128])
        # (products, h) or the fields
        head = (prod, hp) if takes_h else (prod + hp[:128],)
        for warps in (forced if takes_h else []) or [None]:
            dk.WARPS = warps or own_warps
            used = dk.WARPS if takes_h else None
            block = (lambda head=head: dk.dense_sa_block(
                sp, *head, Jp, 0, temps, 0, 7))
            block()  # warm
            torch.cuda.synchronize()
            # a block launch is about as short as the wrapper's host time:
            # 400 queued behind a spin kernel, so the events time the
            # launches, not the host, and the host's time is the wrapper's
            # own
            host_block, ms_per_block = queued(block, 400, 200_000_000)
            rec = dict(kernel="dense_sa", chains=chains, nspins=2048,
                       warps=used, ms_per_block=ms_per_block,
                       host_us_per_block=1e6 * host_block)
            if warps is not None:
                emit(**rec)
                continue

            def sweeps(tau, sched=None, s=s):
                if sched is None:
                    sched = schedules.linear(3.0, 0.1, tau, device=dev)
                return dk.dense_sa_anneal(dp, sched, s, 7, 128)
            # the host path of 5 sweeps (the wrapper, the products, the
            # padding; the schedule made before, as its copy from the host
            # would wait for the spin kernel) and the card's time for them;
            # a sweep whose host time exceeds its device time is
            # host-bound, and its slope follows the host's speed
            sched5 = schedules.linear(3.0, 0.1, 5, device=dev)
            sweeps(5, sched5)
            host_sweep, card_sweep = queued(lambda: sweeps(5, sched5), 1,
                                            400_000_000)
            emit(**rec, host_ms_per_sweep=1e3 * host_sweep / 5,
                 queued_device_ms_per_sweep=card_sweep / 5,
                 ms_per_sweep=slope_ms(sweeps, taus(5)))
    dk.WARPS = own_warps


def queued(fn, calls, cycles):
    """fn() `calls` times behind a spin kernel of `cycles` clocks, three
    times: the least host time a call (the host queues while the card
    spins) and the least device time a call between the events (the card
    runs the queued work back to back)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    host, card = [], []
    for _ in range(3):
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host.append((time.perf_counter() - t0) / calls)
        end.record()
        torch.cuda.synchronize()
        card.append(start.elapsed_time(end) / calls)
    return min(host), min(card)


def time_packed_sa(args, dev, L, pg, spins, taus, emit):
    """Generic SA (T: 3 -> 0) on the L x L torus's generic form: the shared
    schedule at 1280, 32 and 8 chains, per-step tables (the noisy anneal,
    J (1 + 0.1 xi) a step, 1280 chains) and a temperature a chain (384
    chains, 48 rungs of 8); at 32 chains on chimera_graph(16, rng=0) (the
    chimera PIQMC solve's pre-anneal); the disorder batch of 8
    realizations gaussian_torus(L, d).to_generic() x 160 chains, one
    launch; and 1280 chains on the (L+1) x (L+1) torus's checkerboard (the
    masked lattice route, not a proper coloring); each row names the
    geometry its rules chose ("one_cta": the rule of size's first kernel,
    `packed_sa_one_cta`, in a checkout that has it). With
    `--packed-sa-geometry GRAPH:CHAINS:C:R ...` (GRAPH torus, chimera,
    disorder or checkerboard; a checkout that has
    `packed_sa_geometry`) the rows of that graph and chains at each given
    (C, R) instead of the rule's choice, and `--packed-sa-wide` adds the
    shared rows on the file's first kernel (the rule holding nothing)."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops

    own = getattr(gk, "packed_sa_geometry", None)
    own_small = getattr(gk, "packed_sa_one_cta", None)
    forced = [g.split(":") for g in args.packed_sa_geometry]
    graphs = {"torus": pg, "chimera": packed_ops.build_packed(
        instances.chimera_graph(16, rng=0, device=dev)[0])}
    rng = np.random.default_rng(3)
    steps_t = 400
    # per-step tables in packed row order, as the wrappers take them
    xi = torch.as_tensor(rng.standard_normal(
        (steps_t,) + tuple(pg.nbr_J.shape)), dtype=torch.float32, device=dev)
    tables = ((pg.nbr_J[None] * (1.0 + 0.1 * xi)).contiguous(),
              pg.h[None].expand(steps_t, pg.nspins).contiguous())

    # the disorder batch: 8 realizations gaussian_torus(L, d).to_generic(),
    # 160 chains each, one launch (parallel/disorder.py's stride)
    from montecarlosolvers_tpu_torch.parallel import disorder
    stacked, _ = disorder.stack_problems([
        instances.gaussian_torus(L, seed=d, device=dev).to_generic()
        for d in range(8)])
    graphs["disorder"], nbr_jd, h_d = stacked.packed
    graphs["checkerboard"] = packed_ops.packed_from_lattice(
        instances.gaussian_torus(L + 1, seed=0, device=dev))

    def run_of(graph, chains, mode):
        s = spins(chains, graph.nspins)
        ladder = torch.linspace(0.5, 2.0, chains, device=dev)

        def run(tau):
            sched = schedules.linear(3.0, 0.0, tau, device=dev)
            if mode == "per_chain":
                sched = (sched[:, None] * ladder[None, :]).contiguous()
            if mode == "noisy":
                return gk.packed_sa_anneal(
                    graph, sched, s, 7, tables=(tables[0][:tau],
                                                tables[1][:tau], 1))
            if mode == "disorder":
                return gk.packed_sa_anneal(
                    graph, sched, s, 7, disorder=(nbr_jd, h_d,
                                                  list(range(8))))
            return gk.packed_sa_anneal(graph, sched, s, 7)
        return run

    rows = [("torus", 1280, "shared"), ("torus", 32, "shared"),
            ("torus", 8, "shared"), ("torus", 1280, "noisy"),
            ("torus", 384, "per_chain"), ("chimera", 32, "shared"),
            ("disorder", 1280, "disorder"), ("checkerboard", 1280,
                                             "shared")]
    for gname, chains, mode in rows:
        graph = graphs[gname]
        geoms = [(int(g[2]), int(g[3])) for g in forced
                 if g[0] == gname and int(g[1]) == chains and own]
        wide = args.packed_sa_wide and own and mode == "shared"
        for geom in geoms + (["wide"] if wide else []) or [None]:
            if geom == "wide":
                gk.packed_sa_geometry = lambda *a, **k: None
            elif geom is not None:
                gk.packed_sa_geometry = (lambda *a, g=geom, gr=graph, **k: (
                    g[0], g[1], gk.sa_word_threads(gr.nspins, g[1],
                                                   gr.num_colors)))
                if own_small is not None:  # a forced (C, R): the cluster
                    gk.packed_sa_one_cta = lambda *a, **k: False
            try:
                used = (gk.card_packed_sa_geometry(
                    graph, chains, 160 if mode == "disorder" else 0,
                    mode == "per_chain", dev) if own else None)
                if (own_small is not None and used is not None
                        and gk.packed_sa_one_cta(graph.nspins,
                                                 graph.num_colors)):
                    used = "one_cta"  # the rule of size
                tt = (min(50, steps_t // 4), steps_t) if mode == "noisy" \
                    else taus(250 if chains > 100 else 500)
                ms = slope_ms(run_of(graph, chains, mode), tt)
            finally:
                if own is not None:
                    gk.packed_sa_geometry = own
                if own_small is not None:
                    gk.packed_sa_one_cta = own_small
            emit(kernel="packed_sa", graph=gname, mode=mode, chains=chains,
                 nspins=graph.nspins, geometry="wide" if geom == "wide"
                 else used, ms_per_sweep=ms)


CROSSOVER_GRAPHS = (("random_3d_lattice(12)", "random_3d_lattice", 12),
                    ("chimera_graph(16)", "chimera_graph", 16),
                    ("gaussian_torus(48)", "gaussian_torus", 48),
                    ("gaussian_torus(56)", "gaussian_torus", 56),
                    ("random_3d_lattice(16)", "random_3d_lattice", 16),
                    ("gaussian_torus(64)", "gaussian_torus", 64),
                    ("gaussian_torus(80)", "gaussian_torus", 80))
CROSSOVER_CHAINS = (8, 32, 128, 384, 1280)


def time_packed_sa_crossover(dev, spins, taus, emit):
    """Generic SA's two kernels on one graph and chain count each, T: 3 ->
    0: the cluster route (the rule's (C, R), whatever its size rule says)
    and the file's first kernel, one CTA a chain, on CROSSOVER_GRAPHS
    (generic forms, rng / seed 0) at CROSSOVER_CHAINS chains, ms a sweep
    (slope); and the samplers' shape, a temperature a chain at 1536 chains
    (ICM's 2 x 24 rungs x 32 reads), with the ms of a whole two-sweep call
    (`call_ms`: what an exchange interval pays). A checkout that has
    `packed_sa_geometry` (and `packed_sa_one_cta`, its size rule)."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops

    own_geometry = gk.packed_sa_geometry
    own_small = getattr(gk, "packed_sa_one_cta", None)
    for gname, maker, size in CROSSOVER_GRAPHS:
        made = getattr(instances, maker)(
            size, **({"seed": 0} if maker == "gaussian_torus" else
                     {"rng": 0}), device=dev)
        prob = made.to_generic() if maker == "gaussian_torus" else made[0]
        graph = packed_ops.build_packed(prob)
        shapes = [(c, "shared") for c in CROSSOVER_CHAINS]
        if gname in ("random_3d_lattice(12)", "chimera_graph(16)"):
            shapes.append((1536, "per_chain"))
        for chains, mode in shapes:
            s = spins(chains, graph.nspins)
            ladder = torch.linspace(0.5, 2.0, chains, device=dev)

            def run(tau, s=s, ladder=ladder, mode=mode):
                sched = schedules.linear(3.0, 0.0, tau, device=dev)
                if mode == "per_chain":
                    sched = (sched[:, None] * ladder[None, :]).contiguous()
                return gk.packed_sa_anneal(graph, sched, s, 7)
            for route in ("cluster", "cta"):
                if route == "cta":
                    gk.packed_sa_geometry = lambda *a, **k: None
                if own_small is not None:
                    gk.packed_sa_one_cta = (lambda *a, r=route, **k:
                                            r == "cta")
                try:
                    geometry = gk.card_packed_sa_geometry(
                        graph, chains, 0, mode == "per_chain", dev)
                    ms = slope_ms(run, taus(250 if chains > 100 else 500))
                    two = (call_ms(lambda _: run(2))
                           if mode == "per_chain" else None)
                finally:
                    gk.packed_sa_geometry = own_geometry
                    if own_small is not None:
                        gk.packed_sa_one_cta = own_small
                emit(kernel="packed_sa", phase="crossover", graph=gname,
                     nspins=graph.nspins, colors=graph.num_colors,
                     chains=chains, mode=mode, route=route,
                     geometry=geometry if route == "cluster" else None,
                     ms_per_sweep=ms, two_sweep_call_ms=two)


def time_generic_qmc(args, dev, L, pg, spins, taus, emit, wanted):
    """Generic PIQMC and the generic bath at 32 chains, global moves, T =
    1/P: PIQMC at P = 40 on the L x L torus's generic form (shared and
    per-chain J_perp), on the (L+1) x (L+1) torus's checkerboard packing
    (not a proper coloring) and at P = 20 on chimera_graph(16); the bath
    (alpha = 1e-2) at P = 40 on the L x L torus's neighbor-table form,
    sequential and colored, on the (L+1) x (L+1) checkerboard and at P =
    20 on the chimera. With `--generic-geometry R ...` (a checkout that
    has `generic_qmc_geometry`), the L x L rows at each cluster size R
    instead of the rule's choice."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.models.ising import (
        IsingProblem, build_neighbor_table)
    from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops
    from montecarlosolvers_tpu_torch.ops import piqmc as piqmc_ops

    # the torus's neighbor-table form (compat.DissipativeQuantumAnneal's,
    # chip_smoke.py::neighbor_table_form): each site's right, then down bond
    lat = instances.gaussian_torus(L, seed=0, device=dev)
    jr, jd = (x.double().cpu().numpy() for x in (lat.j_right, lat.j_down))
    i = np.arange(L * L)
    y, x = np.divmod(i, L)
    cols = np.stack([y * L + (x + 1) % L, ((y + 1) % L) * L + x], 1).ravel()
    vals = np.stack([jr[y, x], jd[y, x]], 1).ravel()
    pg_nbt = packed_ops.build_packed(IsingProblem.from_neighbor_table(
        build_neighbor_table(L * L, np.repeat(i, 2), cols, vals, 4),
        device=dev))
    pg_odd = packed_ops.packed_from_lattice(instances.gaussian_torus(
        L + 1, seed=0, device=dev))
    pg_chim = packed_ops.build_packed(instances.chimera_graph(
        16, rng=0, device=dev)[0])
    chains = 32

    def runner(fn, graph, P, per_chain=False, bath=False, colored=False):
        c = spins(chains, P, graph.nspins)
        teff = (1.0 / P) * P
        m = piqmc_ops.bath_matrix(schedules.bath_lookuptable(
            P, 1e-2, device=dev), P).contiguous() if bath else None

        def run(tau):
            g = schedules.transverse_field(3.0, 1e-8, tau, device=dev)
            jp = schedules.jperp(g, teff).contiguous()
            if per_chain:
                jp = jp[:, None].expand(tau, chains).contiguous()
            if bath:
                return fn(graph, torch.ones_like(g), jp, teff, m, c, 7, True,
                          colored=colored)
            return fn(graph, torch.ones_like(g), jp, teff, c, 7, True)
        return run

    cases = []
    if wanted("generic_qmc"):
        cases += [("generic_qmc", f"gaussian_torus({L}).to_generic()", pg,
                   40, {}),
                  ("generic_qmc_chain", f"gaussian_torus({L}).to_generic()",
                   pg, 40, {"per_chain": True}),
                  ("generic_qmc", f"gaussian_torus({L + 1}), checkerboard",
                   pg_odd, 40, {}),
                  ("generic_qmc", "chimera_graph(16)", pg_chim, 20, {})]
    if wanted("generic_qmc_bath"):
        cases += [("generic_qmc_bath", f"gaussian_torus({L}), neighbor table",
                   pg_nbt, 40, {"bath": True}),
                  ("generic_qmc_bath_colored",
                   f"gaussian_torus({L}), neighbor table", pg_nbt, 40,
                   {"bath": True, "colored": True}),
                  ("generic_qmc_bath", f"gaussian_torus({L + 1}), "
                   "checkerboard", pg_odd, 40, {"bath": True}),
                  ("generic_qmc_bath", "chimera_graph(16)", pg_chim, 20,
                   {"bath": True})]
    own = getattr(gk, "generic_qmc_geometry", None)
    own_bath = getattr(gk, "generic_qmc_bath_geometry", None)
    for kernel, gname, graph, P, kw in cases:
        fn = (gk.generic_qmc_bath_anneal if kw.get("bath")
              else gk.generic_qmc_anneal)
        forced = ([int(r) for r in args.generic_geometry]
                  if own is not None and graph is not pg_chim
                  and graph is not pg_odd else [])
        for geom in forced or [None]:
            used = None
            if geom is not None:
                rule = (lambda *a, r=geom, **k: (
                    r, gk.word_threads(graph.nspins, r, graph.num_colors)))
                gk.generic_qmc_geometry = gk.generic_qmc_bath_geometry = rule
            if own is not None:
                used = gk.generic_qmc_geometry(chains, graph.nspins, P,
                                               graph.num_colors)
            try:
                ms = slope_ms(runner(fn, graph, P, **kw),
                              taus(10 if kw.get("bath") else 20))
                one = (call_ms(runner(fn, graph, P, **kw)) if args.one_step
                       else None)
            finally:
                if own is not None:
                    gk.generic_qmc_geometry = own
                    gk.generic_qmc_bath_geometry = own_bath
            emit(kernel=kernel, graph=gname, chains=chains, P=P,
                 nspins=graph.nspins, geometry=used, ms_per_sweep=ms,
                 **({} if one is None else {"ms_one_step_call": one}))


def time_cluster(args, dev, pg, spins, taus, emit, wanted):
    """fk_label and fk_wolff at chip_smoke.py::cluster_timing's shapes on
    the graph `pg` (the L x L torus's generic form): PIQMC steps at T = 1/P
    over Gamma: 3 -> 1e-8, B = 1, and the classical ones (P = 1, J_perp =
    0) at T: 3 -> 0.05. With `--label-geometry R ...` (a checkout that has
    `cluster_kernels.label_geometry`), each row at each cluster size R
    instead of the rule's choice (`cluster_kernels.label_shape`)."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck
    from montecarlosolvers_tpu_torch.ops import generic_kernels as gk

    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops

    n = pg.nspins
    lut = schedules.bath_lookuptable(40, 1e-2, device=dev)
    # the field-carrying form: the accept's ordered row sums run
    pg_fields = packed_ops.build_packed(instances.random_2d_lattice(
        int(round(n ** 0.5)), rng=0, with_fields=True, device=dev)[0])

    def terms(tau, P):
        if P == 1:
            temps = schedules.linear(3.0, 0.05, tau, device=dev)
            return torch.ones_like(temps), torch.zeros_like(temps), temps
        g = schedules.transverse_field(3.0, 1e-8, tau, device=dev)
        teff = (1.0 / P) * P
        return (torch.ones_like(g), schedules.jperp(g, teff).contiguous(),
                torch.full_like(g, teff))

    rows = []
    if wanted("fk_label"):
        rows += [("fk_label", 8, 40, False), ("fk_label", 8, 40, True),
                 ("fk_label", 64, 1, False)]
    if wanted("fk_wolff"):
        rows += [("fk_wolff", 1, 40, False), ("fk_wolff", 16, 40, False),
                 ("fk_wolff", 64, 1, False), ("fk_wolff", 1, 40, "fields"),
                 ("fk_wolff", 64, 1, "fields")]
    own = getattr(ck, "label_geometry", None)
    forced = [int(r) for r in args.label_geometry] if own else []
    for kernel, chains, P, bath in rows:
        graph = pg_fields if bath == "fields" else pg
        c = spins(chains, P, n)
        vis = torch.zeros(chains, dtype=torch.int64, device=dev)
        steps = taus(10 if P > 1 else 50)

        def run(tau):
            b, jp, teff = terms(tau, P)
            if kernel == "fk_label":
                return ck.sw_anneal(pg, b, jp, teff, c, 7,
                                    lut if bath else None, 0, P == 1)
            vis.zero_()
            return ck.wolff_anneal(graph, b, jp, teff, c, 7, "local", None,
                                   0, vis)
        card = getattr(ck, "card_label_geometry", None)
        for geom in forced or [None]:
            if geom is not None:
                ck.label_geometry = (
                    lambda ch, p, nn, asym=False, sms=0, resident=None,
                    r=geom: ck.label_shape(r, p, nn, asym))
            try:
                used = (card(kernel, chains, P, n, dev, bath is True)
                        if card else ck.label_geometry(
                            chains, P, n, False, gk.card_sms(dev))
                        if own else None)
                ms = slope_ms(run, steps)
            finally:
                if own:
                    ck.label_geometry = own
            rec = dict(kernel=kernel, chains=chains, P=P, bath=bath,
                       alpha=1e-2 if bath is True else None, nspins=n,
                       geometry=used, ms_per_step=ms)
            if kernel == "fk_wolff":  # the last run's, at the longer tau
                rec["mean_cluster_sites"] = float(vis.sum()) / steps[1] / \
                    chains
            emit(**rec)


def time_energy_bits(args, dev, sl, spins, emit):
    """The energy kernel on kernel A's chain-bit words (the samplers'
    exchanges) at 384 (pt_value's 48 rungs x 8 reads), 1024 and 7040
    (solve("pt")'s 110 rungs x 64 reads) chains on the L x L torus, C
    chains a word by kernel A's rule: ms a call, 400 calls queued behind a
    spin kernel (CUDA events, the least of three), with the K the rule
    chose (`words_energy_geometry`, where the checkout has it) or each
    CHAINS:K of `--energy-bits-k`, beside the energy kernel on the
    unpacked halves."""
    from montecarlosolvers_tpu_torch.ops import energy as energy_ops
    from montecarlosolvers_tpu_torch.ops import split as split_ops
    from montecarlosolvers_tpu_torch.ops import split_kernels as sk

    own = getattr(sk, "words_energy_geometry", None)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    forced = [tuple(map(int, k.split(":"))) for k in args.energy_bits_k]
    for chains in (384, 1024, 7040):
        C = sk.chain_word_bits(chains)
        a, b = (x.contiguous() for x in split_ops.pack_classical(
            sl, spins(chains, sl.L * sl.L)))
        words = (sk.pack_chain_bits(a, C), sk.pack_chain_bits(b, C))
        ks = [k for c, k in forced if c == chains and own is not None]
        for k in ks or [None]:
            if k is not None:
                sk.words_energy_geometry = lambda *_, k=k: k
            try:
                call = (lambda: sk.words_energy(sl, *words, chains, C))
                call()
                torch.cuda.synchronize()
                _, ms = queued(call, 400, 100_000_000)
                used = (sk.words_energy_geometry(chains, C, sms)
                        if own is not None else None)
            finally:
                if own is not None:
                    sk.words_energy_geometry = own
            emit(kernel="energy_bits", chains=chains, C=C, K=used,
                 ms_per_call=ms)
        halves = (lambda: energy_ops.halves_energy(sl, a, b))
        halves()
        torch.cuda.synchronize()
        emit(kernel="energy_halves", chains=chains,
             ms_per_call=queued(halves, 400, 100_000_000)[1])


def svmc_angles(dev, chains, n, seed=2):
    """(chains, n) float32 angles in [0, pi) from a seeded numpy draw."""
    r = np.random.default_rng(seed)
    return torch.as_tensor((r.random((chains, n)) * np.pi)
                           .astype(np.float32), device=dev)


def svmc_runner(pg, th, dev, tf=True, tables=None):
    """run(tau): generic SVMC on PackedGraph `pg` from angles `th`, A 3 ->
    1e-8 over tau sweeps, B = 1, T = 0.05; with `tables`, its first tau
    rows (the noisy anneal)."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.ops import generic_kernels as gk

    def run(tau):
        a = schedules.linear(3.0, 1e-8, tau, device=dev)
        kw = {} if tables is None else {
            "tables": (tables[0][:tau], tables[1][:tau], 1)}
        return gk.packed_svmc_anneal(pg, a, torch.ones_like(a), 0.05, th, 7,
                                     tf, **kw)
    return run


def forced_svmc(gk, R, n, colors):
    """A stand-in for `packed_svmc_geometry` that answers cluster size R
    (0: no cluster, the file's first kernel)."""
    if R == 0:
        return lambda *a, **k: None
    return lambda *a, **k: (R, gk.svmc_threads(n, R, colors))


def time_packed_svmc(args, dev, L, taus, emit):
    """Generic SVMC (A 3 -> 1e-8, B = 1, T = 0.05) on the L x L torus's
    generic form: 256 chains with TF proposals, uniform proposals and
    per-step tables (J (1 + 0.1 xi) a step, TF; the noisy anneal), and 32
    and 8 chains, TF; each row with the (R, threads) the checkout's rule
    chose (`card_packed_svmc_geometry`, where it has it) or each CHAINS:R
    of `--packed-svmc-geometry` (R = 0: the file's first kernel)."""
    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops

    pg = packed_ops.build_packed(instances.gaussian_torus(
        L, seed=0, device=dev).to_generic())
    own = getattr(gk, "packed_svmc_geometry", None)
    forced = [tuple(map(int, g.split(":")))
              for g in args.packed_svmc_geometry]
    rng = np.random.default_rng(4)
    steps_t = 2000
    xi = torch.as_tensor(rng.standard_normal(
        (steps_t,) + tuple(pg.nbr_J.shape)), dtype=torch.float32, device=dev)
    tables = ((pg.nbr_J[None] * (1.0 + 0.1 * xi)).contiguous(),
              pg.h[None].expand(steps_t, pg.nspins).contiguous())
    for chains, mode in ((256, "tf"), (256, "uniform"), (256, "noisy"),
                         (32, "tf"), (8, "tf")):
        th = svmc_angles(dev, chains, pg.nspins)
        run = svmc_runner(pg, th, dev, tf=mode != "uniform",
                          tables=tables if mode == "noisy" else None)
        rs = [r for c, r in forced if c == chains and own is not None
              and mode == "tf"]
        for R in rs or [None]:
            if R is not None:
                gk.packed_svmc_geometry = forced_svmc(gk, R, pg.nspins,
                                                      pg.num_colors)
            try:
                used = (gk.card_packed_svmc_geometry(pg, chains, dev)
                        if own is not None else None)
                ms = slope_ms(run, taus(500 if chains > 100 else 1000))
            finally:
                if own is not None:
                    gk.packed_svmc_geometry = own
            emit(kernel="packed_svmc", graph="torus", mode=mode,
                 chains=chains, nspins=pg.nspins,
                 geometry=used if used is not None or own is None
                 else "wide", ms_per_sweep=ms)


SVMC_CROSSOVER_GRAPHS = (("gaussian_torus(16)", "gaussian_torus", 16),
                         ("random_3d_lattice(12)", "random_3d_lattice", 12),
                         ("chimera_graph(16)", "chimera_graph", 16),
                         ("random_3d_lattice(16)", "random_3d_lattice", 16),
                         ("gaussian_torus(80)", "gaussian_torus", 80))
SVMC_CROSSOVER_CHAINS = (8, 32, 128, 256, 1280)


def time_packed_svmc_crossover(dev, taus, emit):
    """Generic SVMC's two kernels on one graph and chain count each, TF
    proposals: the cluster route at the rule's (R, threads) and the
    file's first kernel, one CTA a chain, on SVMC_CROSSOVER_GRAPHS (generic
    forms, rng / seed 0) at SVMC_CROSSOVER_CHAINS chains, ms a sweep
    (slope); the readings a rule of size between them is set from. A
    checkout that has `packed_svmc_geometry`."""
    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops

    own = gk.packed_svmc_geometry
    for gname, maker, size in SVMC_CROSSOVER_GRAPHS:
        made = getattr(instances, maker)(
            size, **({"seed": 0} if maker == "gaussian_torus" else
                     {"rng": 0}), device=dev)
        prob = made.to_generic() if maker == "gaussian_torus" else made[0]
        graph = packed_ops.build_packed(prob)
        for chains in SVMC_CROSSOVER_CHAINS:
            run = svmc_runner(graph, svmc_angles(dev, chains, graph.nspins),
                              dev)
            for route in ("cluster", "cta"):
                if route == "cta":
                    gk.packed_svmc_geometry = lambda *a, **k: None
                try:
                    geometry = gk.card_packed_svmc_geometry(graph, chains,
                                                            dev)
                    ms = slope_ms(run, taus(250 if chains > 100 else 500))
                finally:
                    gk.packed_svmc_geometry = own
                emit(kernel="packed_svmc", phase="crossover", graph=gname,
                     nspins=graph.nspins, colors=graph.num_colors,
                     chains=chains, route=route, geometry=geometry,
                     ms_per_sweep=ms)


def queued_ms(fn, reps, spin_cycles=100_000_000):
    """ms a call of fn(), CUDA events around `reps` calls queued behind a
    spin kernel, after a warm one: the card's time back to back, not the
    host's queueing of a launch shorter than it (chip_smoke.py::
    event_ms)."""
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(spin_cycles)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def time_houdayer_line(dev, spins, taus, emit, wanted):
    """The Houdayer move and the line clusters at their cells' shapes.
    Houdayer (`cluster_kernels.houdayer_move`, replicas in site order, and
    where the checkout has it `houdayer_move_packed`, in place on a packed
    state through a permuted ror), ms a move queued behind a spin kernel:
    ICM's 768 pairs (32 reads x 24 rungs) and 24 pairs of
    random_3d_lattice(12, rng=0), 48 pairs of the 80 x 80 torus's generic
    form. fk_line (`cluster_kernels.sw_bath_anneal` without local sweeps:
    the line phases alone), ms a step by the slope: WC3 and WC2 at the
    piqmc_sw cell's 8 chains, P = 40, alpha = 1e-2, on the torus's generic
    form."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops

    torus = instances.gaussian_torus(80, seed=0, device=dev).to_generic()
    if wanted("houdayer"):
        glass = instances.random_3d_lattice(12, rng=0, device=dev)[0]
        rng = np.random.default_rng(6)
        for gname, prob, pairs in (("random_3d_lattice(12)", glass, 768),
                                   ("random_3d_lattice(12)", glass, 24),
                                   ("gaussian_torus(80)", torus, 48)):
            n = prob.nspins
            s1, s2 = spins(pairs, n), spins(pairs, n)
            rec = {"kernel": "houdayer", "graph": gname, "pairs": pairs,
                   "ms_site_order": queued_ms(
                       lambda: ck.houdayer_move(prob, s1, s2, 41, 7), 200)}
            if hasattr(ck, "houdayer_move_packed"):
                pg = packed_ops.build_packed(prob)
                state = spins(2 * pairs, n)
                ror = torch.as_tensor(np.stack([rng.permutation(pairs)
                                                for _ in range(2)])[None],
                                      device=dev)
                rec["geometry"] = ck.card_houdayer_geometry(pairs, n, dev)
                rec["ms_in_place"] = queued_ms(
                    lambda: ck.houdayer_move_packed(prob, pg, state, ror, 41,
                                                    7), 200)
            emit(**rec)
    if wanted("fk_line"):
        P, chains = 40, 8
        lut = schedules.bath_lookuptable(P, 1e-2, device=dev)
        confs = spins(chains, P, torus.nspins)
        for wc3 in (True, False):
            def run(tau, wc3=wc3):
                g = schedules.transverse_field(3.0, 1e-8, tau, device=dev)
                return ck.sw_bath_anneal(torus, g, torch.ones_like(g),
                                         1.0 / P, lut, confs, 7,
                                         per_slice_seeds=wc3,
                                         local_sweeps=False)
            emit(kernel="fk_line", graph="gaussian_torus(80)", chains=chains,
                 P=P, per_slice_seeds=wc3,
                 geometry=(ck.card_line_geometry(
                     packed_ops.build_packed(torus), chains, P, dev, wc3)
                     if hasattr(ck, "card_line_geometry") else None),
                 ms_per_step=slope_ms(run, taus(25)))


def time_shard(dev, spins, emit, wanted):
    """S5 and S7 at the parallel phase's shapes (chip_smoke.py::
    shard_rest_checks: the 80 x 80 torus, P = 40, rank 1's slab of 10
    rows of 4 ranks), through wrappers every checkout with S5 and S7 has.
    shard_bath_slice: S5's ms a launch queued behind a spin kernel, 32
    chains, alpha = 1e-2, the gathered state float32 (and int8, where the
    checkout reads it); then the one-rank sharded bath
    (`trotter.anneal_sharded(lookuptable=)` on a one-rank NCCL mesh), ms
    a sweep by the slope, beside the generic bath kernel's
    (`generic_kernels.anneal_generic_qmc_bath`, sequential).
    shard_label: S7's ms a draw queued, one chain on the torus's generic
    form, without and with bath bonds; then the one-rank sharded SW
    (`trotter.anneal_sw_sharded`), ms a step by the slope, beside
    fk_label's one chain (`qmc.anneal_sw`), without a bath, with one and
    on a table whose couplings of ring offsets d < P / 2 are scaled by
    1.5 (not symmetric in ring distance)."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck
    from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops
    from montecarlosolvers_tpu_torch.ops import piqmc as piqmc_ops
    from montecarlosolvers_tpu_torch.ops import shard_kernels as shk
    from montecarlosolvers_tpu_torch.parallel import make_mesh
    from montecarlosolvers_tpu_torch.parallel import mesh as pmesh
    from montecarlosolvers_tpu_torch.parallel import trotter
    from montecarlosolvers_tpu_torch.solvers import qmc

    P, chains, ps, t, n = 40, 32, 10, 15, 6400
    k0 = ps
    torus = instances.gaussian_torus(80, seed=0, device=dev)
    gamma = schedules.transverse_field(3.0, 1e-8, 20, device=dev)
    b20 = torch.ones_like(gamma)
    jp = schedules.jperp(gamma, 1.0).contiguous()
    lut = schedules.bath_lookuptable(P, 1e-2, device=dev)
    mesh = make_mesh(replica=1, device_type="cuda")

    def gen():
        return torch.Generator().manual_seed(5)

    def field(tau):
        g = schedules.transverse_field(3.0, 1e-8, tau, device=dev)
        return g, torch.ones_like(g)

    if wanted("shard_bath_slice"):
        pg = packed_ops.packed_from_lattice(torus)
        bath = piqmc_ops.bath_matrix_of(lut, P, dev)
        full = packed_ops.pack_state(pg, spins(chains, P, n)).contiguous()
        slab = full[:, k0:k0 + ps].contiguous()
        args = (pg, b20, jp, 1.0, bath)

        def s5(f):
            return lambda: shk.generic_shard_bath_slice(
                *args, slab, f, ps - 1, k0 + ps - 1, t, 77)
        rec = {"kernel": "shard_bath_slice", "chains": chains, "P": P,
               "slab": ps, "ms": queued_ms(s5(full), 200)}
        if hasattr(shk, "shard_bath_geometry"):
            rec["int8_ms"] = queued_ms(s5(full.to(torch.int8)), 200)
            rec["geometry"] = shk.card_shard_bath_geometry(pg, chains, P,
                                                           dev, False)
        confs = spins(chains, P, n)
        rec["ms_per_sweep_sharded"] = slope_ms(
            lambda tau: pmesh.full_tensor(trotter.anneal_sharded(
                torus, *field(tau), 1.0 / P, confs, gen(), mesh,
                lookuptable=lut)), (10, 40))
        rec["ms_per_sweep_generic_bath"] = slope_ms(
            lambda tau: gk.anneal_generic_qmc_bath(
                torus, *field(tau), 1.0 / P, lut, confs, 77), (50, 200))
        emit(**rec)
    if wanted("shard_label"):
        gtorus = torus.to_generic()
        gp = packed_ops.build_packed(gtorus)
        one = spins(1, n)
        state = packed_ops.pack_state(gp, one.expand(P, n)[None])[0]
        state[:, : n // 8] *= -1.0
        state = state.contiguous()
        rows = state[k0:k0 + ps].contiguous()
        up, dn = state[k0 - 1].contiguous(), state[k0 + ps].contiguous()
        for with_bath in (False, True):
            def draw(with_bath=with_bath):
                return ck.shard_label_init(ck.ShardStep(
                    gp, rows, up, dn, state if with_bath else None, k0, P,
                    b20, jp, 1.0, t, 77, lut if with_bath else None))
            rec = {"kernel": "shard_label", "block": "slab", "rows": ps,
                   "P": P, "bath": with_bath,
                   "ms_draw": queued_ms(draw, 20)}
            if hasattr(ck, "shard_label_geometry"):
                rec["geometry"] = ck.card_shard_label_geometry(
                    P, ps, n, dev, with_bath)
            emit(**rec)
        d = torch.arange(1, P, device=dev)
        asym = torch.where(2 * d < P, lut * 1.5, lut).contiguous()
        confs1 = one.expand(P, n).contiguous()
        for tname, table in (("none", None), ("bath", lut),
                             ("asymmetric", asym)):
            emit(kernel="shard_label", block="one_rank_engine", P=P,
                 table=tname,
                 ms_per_step_sharded=slope_ms(
                     lambda tau: pmesh.full_tensor(trotter.anneal_sw_sharded(
                         gtorus, *field(tau), 1.0 / P, confs1, gen(), mesh,
                         lookuptable=table)), (5, 20)),
                 ms_per_step_single_device=slope_ms(
                     lambda tau: qmc.anneal_sw(
                         gtorus, *field(tau), 1.0 / P, confs1, gen(),
                         lookuptable=table), (5, 20)))


def call_ms(run, reps=30):
    """Median ms of a whole one-step call run(1), the wrapper's own
    launches and its schedule's beside the kernel, by CUDA events around
    each of `reps` calls after three to warm up."""
    for _ in range(3):
        run(1)
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        run(1)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


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
