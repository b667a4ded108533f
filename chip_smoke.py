#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (montecarlosolvers_tpu_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printed as one JSON line:
  device              nvidia-smi's name and power limit of the card
  build               nvcc builds kernels A, B, 3, 4, 5, 6 and 7 from csrc/,
                      all at once (seconds)
  clusters            the (C, R, threads) kernels A and 6 and the (R,
                      threads) kernels B, 5, 3, 7 and 4 take at the shapes
                      below, and how many of those clusters the card holds
                      at once (cudaOccupancyMaxActiveClusters); null where
                      no cluster holds the shape and the per-phase kernels
                      run
  sa_kernel_vs_plain  kernel A against its plain PyTorch version on the card,
                      80x80 periodic Gaussian lattice at the main path's
                      1280 chains, 200 steps of T: 3 -> 0.1; then 32 chains
                      (the PIQMC pre-anneal), 33 (a ragged chain word) and
                      the 256x256 torus at 32 chains, 100 steps
  qmc_kernel_vs_plain kernel B against its plain version at the main path's
                      P = 40 and 32 chains, 40 steps, B in {1, 0.7} x global
                      moves on / off; P = 2 (32 chains) and P = 64 on the
                      80x80 torus, P = 40 on the 176x176 torus (4 chains,
                      8 steps), and P = 2 on the 676x676 torus, which no
                      cluster holds and the per-phase kernels run
  qmc_bath_kernel_vs_plain  kernel 5 against its plain version: the 80x80
                      torus at the main path's P = 40 and 32 chains, 20
                      steps of Gamma: 3 -> 1e-8, alpha in {1e-2, 0.5} x B in
                      {1, 0.7} x global moves on / off; P = 5 and P = 2 on
                      the torus and P = 4 on an open 80x80 lattice; P = 64
                      on the torus, and P = 40 on the 176x176 and 256x256
                      tori (4 chains, 8 steps), which one block per chain
                      could not hold
  plane_sa_kernel_vs_plain   kernel 6 against its plain version on an 81x81
                      periodic Gaussian torus and an 81x81 open lattice,
                      1280 chains, 200 steps; then 32 chains (the PIQMC
                      pre-anneal), 33 (a ragged chain word) and the 243x243
                      torus at 32 chains, 100 steps
  plane_qmc_kernel_vs_plain  kernel 3 against its plain version, 40 steps,
                      B in {1, 0.7} x global moves on / off, 32 chains, on
                      the 80x80 torus at P = 5 and the 81x81 torus at P = 5
                      (the main path's two shapes) and P = 4; then P = 40
                      (two bit words a site) and, at 33 chains, P = 3 and 7
                      on the 81x81 torus, P = 5 on the 243x243 torus, and
                      P = 3 on the 677x677 torus, which no cluster holds
                      and the per-phase kernels run
  svmc_split_kernel_vs_plain  kernel 4 against its plain version on the
                      80x80 torus, 256 chains, 200 steps of A: 3 -> 1e-8,
                      B = 1, T = 0.05, TF proposals on and off: angles that
                      differ at all, by more than 1e-3 (must be 0), max
                      |d|; then the 256x256 torus (32 chains, 100 steps),
                      past the L <= 138 of one block per chain, and the
                      554x554 torus (2 chains, 32 steps), which no cluster
                      holds and the per-phase kernels run; with the (R,
                      threads) and the launches of each
  svmc_plane_kernel_vs_plain  kernel 7 likewise on the 81x81 torus and an
                      81x81 open lattice, and on the 243x243 torus, past
                      the L <= 120 of one block per chain
  phased_kernel_vs_plain  the per-phase kernels of A, 6, 7 and 5 against
                      their plain versions at the first lattice no cluster
                      of 16 CTAs holds: A on the 962x962 torus, 6 on the
                      676x676 torus (2 chains, 8 steps), 7 on the 481x481
                      torus (2 chains, 16 steps, TF), 5 on the 674x674
                      torus at P = 40 (1 chain, 4 steps, global moves), each
                      with its "*_phased" launch count
  main_path           eight solves at full width: solve("sa", 1280 reads,
                      2000 sweeps) and solve("piqmc", 32 reads, 1000
                      sweeps) at P = 40 and at P = 5 on the santoro instance
                      when MCS_TPU_INSTANCE_DIR holds it, else on the seeded
                      80x80 Gaussian torus; solve("sa") and solve("piqmc",
                      P = 5) on the seeded 81x81 torus; solve("svmc", 256
                      reads, 2000 sweeps) on the 80x80 lattice and on the
                      81x81 torus; and the open-system protocol of
                      examples/dissipative_qa.py on the 80x80 lattice
                      (sa.random_state -> sa.anneal(pre-anneal, mcsteps=5)
                      -> qmc.replicate -> qmc.anneal(lookuptable=
                      bath_lookuptable(40, 1e-2), global moves), 32 chains,
                      P = 40, tau = 1000, best slice per chain). Energies
                      are checked against a float64
                      recomputation and their mean per spin against fixed
                      ranges; the kernel launch counts (ops/_build.py::
                      LAUNCHES: one per launch of a kernel, so every
                      kernel counts once per anneal) are
                      set to 0 just before each solve, read just after it
                      and must equal the solve's route exactly
  timing              slope-timed ms per sweep of each kernel and of its
                      plain version at the main path's shapes, beside the
                      least time the card could take for a sweep (bound:
                      the work's float32 or special-function operations,
                      or its bytes, over the card's peak rates); also
                      kernels A and 6 at 32 chains (the pre-anneals),
                      kernel 5 at P = 40, 32 chains on the 256x256 torus
                      and kernel 3 at P = 5, 32 chains on the 81x81 torus;
                      and each kernel's per-phase kernels and their plain
                      versions at the shape checked above
  hw_rng_kernel_checks  the generator instantiations (hw_rng=True,
                      csrc/hw_rng.cuh) of kernels A, B, 4 and 5, on their
                      cluster kernels and on their per-phase kernels (forced
                      at any shape by tests/gibbs_check.py::phased_route):
                      (a) on the open 4x4 lattice with one bonded pair
                      (tests/gibbs_check.py), 4096 chains,
                      the pair's state frequencies (A: 4 states at T = 1;
                      B: 256 line states at P = 4; 5: 64 at P = 3 with a
                      bath) or rotor moments (4) against the exact weights
                      and against the plain versions' torch.Generator on
                      the same inputs: every state within HW_Z standard
                      errors of the chain means; (b) 1280 SA chains, 128
                      SVMC chains and 32 chains at P = 40 (B and 5) on the
                      80x80 torus, started all alike: no two chains, and no
                      two slices of a chain, end identical; (c) at each
                      pallas_* bench arm's shape and smallest light tau
                      (kernel 5's plain comparison at P = 40, its
                      compile-time-P generator instantiation, but tau =
                      64, HW_PLAIN_TAU), the per-chain energies per spin
                      on the same spins, lines or angles: their mean
                      within HW_QUALITY_SE combined standard errors of the
                      generator's plain version (the kernel's max_abs_err
                      in the kernels line) and of the hash
                      instantiation's; (d) a seed gives the same result
                      twice, another seed a different one
  bench               bench/throughput.py --light: the eight arms of
                      bench.py (the four pallas_* on the generator
                      instantiations), one line each, with the launches
                      of each, counted from 0 before the bench
  hw_rng_timing       ms per sweep of kernels A, B, 4 and 5 with the hash
                      and with hw_rng=True at the pallas_* arms' shapes, of
                      the generator's plain versions and per-phase kernels,
                      and the registers, spills and SASS instructions and
                      loops of both cluster instantiations
                      (tools/sass_counts.py)
then a line {"kernels": [...]} (the seven kernels, then their per-phase
kernels, which no main-path solve launches, then the generator
instantiations of A, B, 4 and 5 and their per-phase kernels, whose
launches are the bench's), and last {"ok": true, "device": {...}}.
Any failed check raises, so the script exits non-zero without the last line;
it also fails when torch sees no CUDA device or the package is missing.
The script imports no JAX. A torch.profiler breakdown of the main-path
solves is `python -m montecarlosolvers_tpu_torch.profiling`.
"""

import contextlib
import functools
import importlib.util
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

L, ODD_L = 80, 81
# the largest L of the Pallas split kernels, which kernels A, B and 5 take
# by spreading a chain over a cluster of CTAs
BIG_L = 256
# an odd L above the 241 that kernel 6 took when it held a chain in a block
BIG_ODD_L = 243
# an even L whose PIQMC chain no cluster of 16 CTAs holds: kernel B runs
# its per-phase kernels there; and an L that kernel 3's clusters do not
# hold at P <= 32
PHASED_L, PLANE_PHASED_L = 676, 677
# the first lattices no cluster of 16 CTAs holds for kernels A, 6, 7, 5 at
# P = 40 and 4: their per-phase kernels run there
SA_PHASED_L, PLANE_SA_PHASED_L, PLANE_SVMC_PHASED_L = 962, 676, 481
BATH_PHASED_L, SVMC_PHASED_L = 674, 554
SA_READS, SA_SWEEPS = 1280, 2000
QMC_READS, QMC_SLICES, QMC_SWEEPS = 32, 40, 1000
ODD_SLICES = 5
SVMC_READS, SVMC_SWEEPS, SVMC_TEMP = 256, 2000, 0.05
# the dissipative arm: bench.py::_piqmc_bath_arm's P, chains and alpha
BATH_READS, BATH_SLICES, BATH_ALPHA, BATH_SWEEPS = 32, 40, 1e-2, 1000
# kernels 4 and 7 against their plain versions: no angle may differ by
# more than ANGLE_MISMATCH (a diverged accept decision), and none by more
# than ANGLE_ATOL (last-ulp differences of cos / sin / log1p, if any)
ANGLE_MISMATCH, ANGLE_ATOL = 1e-3, 2e-5
# Mean energy per spin of each main-path solve on the seeded tori must lie
# in these ranges. Anchors from the JAX package's solver on the CPU at the
# same lattice, P and tau (PERF.md section 2), widened by about 0.01 per
# spin for the port's other random stream:
#   sa            SA tau=2000 on 80x80, mean -1.2784
#   piqmc_p40     PIQMC P=20 tau=500 on 80x80, mean -1.2884
#   piqmc_p5      PIQMC P=5 tau=1000 on 80x80, mean -1.2932
#   sa_l81        SA tau=2000 on 81x81, mean -1.2787
#   piqmc_p5_l81  PIQMC P=5 tau=1000 on 81x81, mean -1.2976
#   svmc          SVMC-TF T=0.05 tau=2000 on 80x80, 256 reads, mean -1.2566
#   svmc_l81      SVMC-TF T=0.05 tau=2000 on 81x81, 256 reads, mean -1.2615
#   piqmc_bath_p40  bath PIQMC P=40 alpha=1e-2 tau=1000 on 80x80, 32 reads,
#                 mean -1.29615
RANGES = {
    "sa": (-1.29, -1.268),
    "piqmc_p40": (-1.31, -1.278),
    "piqmc_p5": (-1.304, -1.282),
    "sa_l81": (-1.29, -1.268),
    "piqmc_p5_l81": (-1.309, -1.287),
    "svmc": (-1.267, -1.246),
    "svmc_l81": (-1.272, -1.251),
    "piqmc_bath_p40": (-1.307, -1.286),
}
# residual energy per spin ranges on the certified santoro instance
EPS_RANGES = {"sa": (0.0, 0.1), "piqmc_p40": (0.0, 0.05),
              "piqmc_p5": (0.0, 0.05), "svmc": (0.0, 0.2),
              "piqmc_bath_p40": (0.0, 0.05)}
# kernel name -> (LAUNCHES key, source, TPU kernel it replaces)
KERNELS = {
    "split_sa": ("sa_split", "montecarlosolvers_tpu_torch/csrc/split_sa.cu",
                 "montecarlosolvers_tpu/ops/pallas_split.py:109"),
    "split_qmc": ("qmc_split",
                  "montecarlosolvers_tpu_torch/csrc/split_qmc.cu",
                  "montecarlosolvers_tpu/ops/pallas_split.py:431"),
    "plane_sa": ("sa_plane", "montecarlosolvers_tpu_torch/csrc/plane_sa.cu",
                 "montecarlosolvers_tpu/ops/pallas_sa.py:156"),
    "plane_qmc": ("qmc_plane",
                  "montecarlosolvers_tpu_torch/csrc/plane_qmc.cu",
                  "montecarlosolvers_tpu/ops/pallas_qmc.py:70"),
    "split_svmc": ("svmc_split",
                   "montecarlosolvers_tpu_torch/csrc/split_svmc.cu",
                   "montecarlosolvers_tpu/ops/pallas_split.py:227"),
    "plane_svmc": ("svmc_plane",
                   "montecarlosolvers_tpu_torch/csrc/plane_svmc.cu",
                   "montecarlosolvers_tpu/ops/pallas_svmc.py:56"),
    "split_qmc_bath": ("qmc_bath_split",
                       "montecarlosolvers_tpu_torch/csrc/split_qmc_bath.cu",
                       "montecarlosolvers_tpu/ops/pallas_split.py:696"),
}
# each kernel's per-phase kernels, for the shapes no cluster holds, in the
# same source, under LAUNCHES[key + "_phased"]
KERNELS.update({f"{k}_phased": (f"{key}_phased", src, tpu)
                for k, (key, src, tpu) in list(KERNELS.items())})
# the generator instantiations (hw_rng=True) of kernels A, B, 4 and 5: the
# hardware-PRNG branch of the TPU kernel each replaces, and the bench arm
# (bench/throughput.py) that runs it
HW_BRANCHES = {
    "split_sa": ("montecarlosolvers_tpu/ops/pallas_split.py:128", "pallas"),
    "split_qmc": ("montecarlosolvers_tpu/ops/pallas_split.py:465",
                  "pallas_qmc"),
    "split_svmc": ("montecarlosolvers_tpu/ops/pallas_split.py:253",
                   "pallas_svmc"),
    "split_qmc_bath": ("montecarlosolvers_tpu/ops/pallas_split.py:719",
                       "pallas_bath"),
}
for _k, (_tpu, _) in HW_BRANCHES.items():
    for _suffix in ("_hw", "_hw_phased"):
        KERNELS[_k + _suffix] = (KERNELS[_k][0] + _suffix, KERNELS[_k][1],
                                 _tpu)
# (a): chains of the exact-distribution samplers, and the largest
# |mean - exact| (or kernel - plain) they may show, in standard errors of
# the chain means (gibbs_check.z_scores: at most 1 state in about 3 million
# passes it by chance)
HW_CHAINS, HW_Z = 4096, 5.0
# (c): the largest |difference of mean energy per spin| between the
# generator and its plain version, or the hash, in combined standard
# errors of the chain means
HW_QUALITY_SE = 4.0
# (c): the tau of the plain comparison where the arm's light tau would
# keep the plain version past a few seconds (kernel 5's plain version takes
# about 0.1 s a sweep at P = 40; still P = 40, the generator's
# compile-time-P instantiation)
HW_PLAIN_TAU = {"pallas_bath": 64}
# Least time of a sweep on an H100 SXM: float32 operations over 67 TFLOP/s
# and bytes over 3.35 TB/s (NVIDIA's data sheet), and special-function
# operations (logarithm, sine, cosine) over 67e12 * 16 / 256 per second:
# the CUDA C++ Programming Guide's throughput table gives compute
# capability 9.0 16 of them per clock per SM, against the 128 float32 FMAs
# (256 operations) per clock per SM that the 67 TFLOP/s counts. The two
# units run side by side, so the largest of the three times bounds.
PEAK_FLOPS, PEAK_SFU, PEAK_BYTES = 67e12, 67e12 * 16 / 256, 3.35e12
# Operations of one site update as the work needs them, not as the kernels
# are written. A product with a spin (+/-1) is a sign flip and one with the
# bath matrix's zero diagonal is nothing: neither is a float operation.
# The split layout's empty stencil slots are no work. So the field of a
# spin site is its four signed couplings and h: four adds. Metropolis is
# the uniform from 24 hash bits (convert, scale), 1 - u, the product with
# T ln 2 and the compare: five float32 operations, and the logarithm on the
# special-function unit.
SPIN_FIELD, METROPOLIS = 4, 5
# Beside the bound, not in it: the counter hash's integer operations, 19
# per uniform (two murmur3 rounds 16, uid * golden + ctr 2, shift 1), over
# the INT32 pipes' 64 per clock per SM (the same table): 67e12 * 64 / 256
# per second.
HASH_OPS, PEAK_INT32 = 19, 67e12 * 64 / 256


def hash_ops_per_sweep(kname, chains, slices, sites):
    """Integer operations of the uniforms one sweep hashes: one per spin
    update and per PIQMC line, two per SVMC update."""
    if kname.endswith("svmc"):
        per_site = 2
    else:
        per_site = slices + 1 if "qmc" in kname else 1
    return HASH_OPS * per_site * chains * sites


def ops_per_sweep(kname, chains, slices, sites):
    """(float32, special-function) operations of one sweep of `kname` at
    this shape, global moves on for the PIQMC kernels and TF proposals for
    SVMC, as the work needs them:
      SA      field, 2 f, Metropolis;
      PIQMC   per slice: field, dE = (bc s) f + (2 s J_perp)(s_up + s_dn)
              (four), Metropolis; per line: f + h of each slice, the P - 1
              adds across them, the product with B, Metropolis;
      bath    PIQMC, and per slice the P - 2 adds of the bath field (P - 1
              sign-flipped terms) and (2 T_eff s) bath with its add;
      SVMC-TF two uniforms (4), theta + w (2 pi u - pi) and its clip (6),
              the range scaling of sin and cos (2), the field sum J cos + h
              (8), dE (6), acceptance 1 - u, times T, compare (3); and a
              logarithm, a sine and a cosine."""
    P = slices
    local = SPIN_FIELD + 4 + METROPOLIS
    line = (SPIN_FIELD + 1) * P + METROPOLIS
    f32, sfu = {
        "sa": (SPIN_FIELD + 1 + METROPOLIS, 1),
        "qmc": (local * P + line, P + 1),
        "qmc_bath": ((local + P) * P + line, P + 1),
        "svmc": (4 + 6 + 2 + 8 + 6 + 3, 3),
    }[kname.split("_", 1)[1]]
    return f32 * chains * sites, sfu * chains * sites


def bytes_per_anneal(kname, chains, slices, sites, tau):
    """Bytes an anneal of `tau` sweeps must move: the state read once and
    written once; the couplings (right, down), h, the bath matrix and the
    two schedules read once."""
    state = 2 * chains * slices * sites * 4
    bath = slices * slices * 4 if kname == "split_qmc_bath" else 0
    return state + 3 * sites * 4 + bath + 2 * tau * 4


def bound_ms(kname, chains, slices, sites, tau):
    """(least ms per sweep over an anneal of `tau` sweeps, "operations" or
    "bytes", and which of "fp32", "sfu" or "bytes" bounds it)."""
    f32, sfu = ops_per_sweep(kname, chains, slices, sites)
    times = {"fp32": f32 / PEAK_FLOPS, "sfu": sfu / PEAK_SFU,
             "bytes": bytes_per_anneal(kname, chains, slices, sites, tau)
             / PEAK_BYTES / tau}
    unit = max(times, key=times.get)
    return (1e3 * times[unit], "bytes" if unit == "bytes" else "operations",
            unit)


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out


def mismatches(xs, ys):
    """(number of differing elements, max |x - y|) over paired tensors."""
    n = sum(int((x != y).sum()) for x, y in zip(xs, ys))
    err = max(float((x - y).abs().max()) for x, y in zip(xs, ys))
    return n, err


def angle_diffs(xs, ys):
    """Counts of angles that differ at all and by more than ANGLE_MISMATCH,
    and max |x - y|, over paired tensors."""
    d = [(x - y).abs() for x, y in zip(xs, ys)]
    return {"bitwise_differing_angles": sum(int((x != y).sum())
                                            for x, y in zip(xs, ys)),
            "mismatched_angles": sum(int((e > ANGLE_MISMATCH).sum())
                                     for e in d),
            "max_abs_err": max(float(e.max()) for e in d)}


def slope_ms(run, taus, trials):
    """Median pairwise slope of the best-of-`trials` wall time of run(tau)
    (ending in a synchronize) over the tau points, in ms per sweep;
    fixed overhead cancels in the slope (bench.py::_measure_rate)."""
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
    ts = sorted(best)
    slopes = [(best[b] - best[a]) / (b - a)
              for i, a in enumerate(ts) for b in ts[i + 1:]]
    return 1e3 * float(np.median(slopes)), best


def launched_now():
    from montecarlosolvers_tpu_torch.ops import _build
    return {k: v for k, v in _build.LAUNCHES.items() if v}


def routes():
    """The two routes of the split kernels: ("cluster", no change) and
    ("phased", gibbs_check.phased_route)."""
    return (("cluster", contextlib.nullcontext),
            ("phased", gibbs_tool().phased_route))


def hw_exact_checks(dev, results):
    """(a): the generator instantiations, on both routes, and the plain
    versions' generator, against the exact weights of the bonded pair
    (tests/gibbs_check.py) and against each other, on the same inputs."""
    from montecarlosolvers_tpu_torch.ops import _build

    gibbs = gibbs_tool()
    lat = gibbs.pair_lattice(4, dev)
    for kname, (sample, exact, samples, what) in gibbs.CASES.items():
        kernel, plain = gibbs.ENGINES[kname]
        _build.reset_launches()
        per_plain = sample(plain, lat, HW_CHAINS)
        check(not launched_now(), f"the plain {kname} launched nothing")
        z_plain, d_plain = gibbs.z_scores(per_plain, exact, samples)
        for route, ctx in routes():
            name = f"{kname}_hw" + ("_phased" if route == "phased" else "")
            _build.reset_launches()
            with ctx():
                kern = sample(kernel, lat, HW_CHAINS)
            launched = launched_now()
            z_k, d_k = gibbs.z_scores(kern, exact, samples)
            z_kp, d_kp = gibbs.z_between(kern, per_plain, samples)
            emit({"phase": "hw_rng_kernel_checks", "check": "a_exact",
                  "kernel": name, "route": route, "what": what,
                  "chains": HW_CHAINS, "samples": gibbs.SAMPLES,
                  "z_kernel_vs_exact": z_k, "max_abs_kernel_vs_exact": d_k,
                  "z_plain_vs_exact": z_plain,
                  "max_abs_plain_vs_exact": d_plain,
                  "z_kernel_vs_plain": z_kp, "max_abs_kernel_vs_plain": d_kp,
                  "bound_z": HW_Z, "launches": launched})
            check(set(launched) == {KERNELS[name][0]},
                  f"{name} launched {launched}")
            check(max(z_k, z_plain, z_kp) < HW_Z,
                  f"{name} samples the exact weights ({what})")


def hw_stream_checks(dev, torus):
    """(b) and (d): chains (and slices) started alike end apart; a seed
    reproduces, another differs; each kernel on both routes."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.ops import split_kernels as sk

    n = torus.nspins
    rng = np.random.default_rng(5)
    one = torch.as_tensor(rng.choice([-1.0, 1.0], size=n).astype(np.float32),
                          device=dev)
    angles = torch.as_tensor((rng.random(n) * np.pi).astype(np.float32),
                             device=dev)
    gamma = torch.full((2,), 3.0, device=dev)
    lut = schedules.bath_lookuptable(QMC_SLICES, BATH_ALPHA, device=dev)
    lines = one.expand(QMC_READS, QMC_SLICES, n).contiguous()
    cases = {
        "split_sa": (SA_READS, lambda sd: sk.anneal_lattice_split(
            torus, schedules.linear(3.0, 0.5, 20, device=dev),
            one.expand(SA_READS, n).contiguous(), sd, hw_rng=True)),
        "split_qmc": (QMC_READS, lambda sd: sk.anneal_lattice_qmc_split(
            torus, gamma, torch.ones_like(gamma), 1.0 / QMC_SLICES, lines,
            sd, global_moves=True, hw_rng=True)),
        "split_qmc_bath": (QMC_READS, lambda sd:
                           sk.anneal_lattice_qmc_bath_split(
                               torus, gamma, torch.ones_like(gamma),
                               1.0 / QMC_SLICES, lut, lines, sd,
                               global_moves=True, hw_rng=True)),
        "split_svmc": (128, lambda sd: sk.anneal_lattice_svmc_split(
            torus, torch.ones(20, device=dev), torch.ones(20, device=dev),
            SVMC_TEMP, angles.expand(128, n).contiguous(), sd, tf=True,
            hw_rng=True)),
    }
    for kname, (chains, run) in cases.items():
        for route, ctx in routes():
            with ctx():
                out, again, other = run(99), run(99), run(100)
            torch.cuda.synchronize()
            distinct = int(torch.unique(out.reshape(chains, -1),
                                        dim=0).shape[0])
            rec = {"phase": "hw_rng_kernel_checks", "check": "b_d_streams",
                   "kernel": kname + "_hw", "route": route,
                   "chains": chains, "started_alike": True,
                   "distinct_chains": distinct,
                   "same_seed_equal": bool(torch.equal(out, again)),
                   "other_seed_differs": not torch.equal(out, other)}
            if out.ndim == 3:  # no two slices of a chain alike
                rec["min_distinct_slices"] = min(
                    int(torch.unique(c, dim=0).shape[0]) for c in out)
                rec["slices"] = out.shape[1]
            emit(rec)
            check(distinct == chains, f"{kname} hw: chains end distinct "
                                      f"({route})")
            check(rec.get("min_distinct_slices", 0) == rec.get("slices", 0),
                  f"{kname} hw: no two slices of a chain alike ({route})")
            check(rec["same_seed_equal"] and rec["other_seed_differs"],
                  f"{kname} hw: a seed reproduces, another differs "
                  f"({route})")


def hw_quality_checks(dev, torus, results):
    """(c): at each pallas_* arm's shape and smallest light tau, on the same
    spins, lines or angles, the per-chain energies per spin of the
    generator instantiations (both routes) against the generator's plain
    version and against the hash instantiation."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.bench import throughput
    from montecarlosolvers_tpu_torch.ops import svmc_ops
    from montecarlosolvers_tpu_torch.solvers import qmc

    gibbs = gibbs_tool()
    n = torus.nspins
    rng = np.random.default_rng(6)

    def makers(arm):
        """(tau, run(engine, hw_rng, tau) -> per-chain energies) of
        `arm`."""
        chains, slices, _, light, _, _ = throughput.ARMS[arm]
        spins = torch.as_tensor(rng.choice(
            [-1.0, 1.0], size=(chains, n)).astype(np.float32), device=dev)
        lines = qmc.replicate(spins, slices)
        angles = torch.as_tensor((rng.random((chains, n)) * np.pi)
                                 .astype(np.float32), device=dev)

        def gamma(tau):
            return schedules.transverse_field(3.0, 1e-8, tau, device=dev)
        return light[0], {
            "pallas": lambda eng, hw, tau: torus.energy(gibbs.anneal_sa(
                eng, torus, schedules.linear(3.0, 0.0, tau, device=dev),
                spins, 21, hw)),
            "pallas_qmc": lambda eng, hw, tau: qmc.best_slice_energy(
                torus, gibbs.anneal_qmc(eng, torus, gamma(tau), 1.0 / slices,
                                        lines, 22, True, hw)),
            "pallas_svmc": lambda eng, hw, tau: torus.energy(
                svmc_ops.z_projection(gibbs.anneal_svmc(
                    eng, torus, gamma(tau), torch.ones(tau, device=dev),
                    SVMC_TEMP, angles, 23, True, hw))),
            "pallas_bath": lambda eng, hw, tau: qmc.best_slice_energy(
                torus, gibbs.anneal_bath(eng, torus, gamma(tau),
                                         1.0 / slices, BATH_ALPHA, lines, 24,
                                         False, hw)),
        }[arm]

    def per_spin(energies):
        return energies.double().cpu().numpy() / n

    def apart(x, y):
        """|difference of the means|, combined standard error."""
        se = np.hypot(x.std(ddof=1), y.std(ddof=1)) / np.sqrt(len(x))
        return float(abs(x.mean() - y.mean())), float(se)

    for kname, (_, arm) in HW_BRANCHES.items():
        tau, run = makers(arm)
        plain_tau = HW_PLAIN_TAU.get(arm, tau)
        kernel, plain = gibbs.ENGINES[kname]
        ref = per_spin(run(kernel, False, tau))
        t0 = time.perf_counter()
        want = per_spin(run(plain, True, plain_tau))
        plain_s = time.perf_counter() - t0
        for route, ctx in routes():
            name = f"{kname}_hw" + ("_phased" if route == "phased" else "")
            with ctx():
                got = per_spin(run(kernel, True, tau))
                got_p = (got if plain_tau == tau
                         else per_spin(run(kernel, True, plain_tau)))
            d_plain, se_plain = apart(got_p, want)
            d_hash, se_hash = apart(got, ref)
            emit({"phase": "hw_rng_kernel_checks", "check": "c_quality",
                  "kernel": name, "route": route, "arm": arm,
                  "chains": len(got), "tau": tau, "plain_tau": plain_tau,
                  "mean_energy_per_spin_hw": float(got.mean()),
                  "mean_energy_per_spin_hash": float(ref.mean()),
                  "mean_energy_per_spin_hw_at_plain_tau": float(got_p.mean()),
                  "mean_energy_per_spin_plain": float(want.mean()),
                  "diff_plain": d_plain, "combined_se_plain": se_plain,
                  "diff_hash": d_hash, "combined_se_hash": se_hash,
                  "plain_seconds": plain_s, "bound_se": HW_QUALITY_SE})
            check(d_plain < HW_QUALITY_SE * se_plain,
                  f"{name} anneals as its plain version does at {arm}'s "
                  f"shape")
            check(d_hash < HW_QUALITY_SE * se_hash,
                  f"{name} anneals as the hash does at {arm}'s shape")
            results[name]["max_abs_err"] = d_plain


def repo_module(relpath):
    """The Python file `relpath` of this checkout, as a module."""
    path = Path(__file__).resolve().parent / relpath
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.cache
def gibbs_tool():
    """tests/gibbs_check.py of this checkout: the bonded pair's exact
    weights, the samplers and the per-phase route."""
    return repo_module("tests/gibbs_check.py")


def sass_tool():
    """tools/sass_counts.py of this checkout, as a module."""
    return repo_module("tools/sass_counts.py")


def energy64(problem, states):
    """Classical energies of (reads, N) numpy states in float64."""
    Lp = problem.L
    jr, jd, hp = (x.double().cpu().numpy() for x in
                  (problem.j_right, problem.j_down, problem.h_plane))
    s = states.astype(np.float64).reshape(-1, Lp, Lp)
    return ((jr * s * np.roll(s, -1, axis=-1)).sum(axis=(1, 2))
            + (jd * s * np.roll(s, -1, axis=-2)).sum(axis=(1, 2))
            + (hp * s).sum(axis=(1, 2)))


def main():
    check(torch.cuda.is_available(), "torch.cuda.is_available()")
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.ops import piqmc as piqmc_ops
    from montecarlosolvers_tpu_torch.ops import plane as plane_ops
    from montecarlosolvers_tpu_torch.ops import plane_kernels as pk
    from montecarlosolvers_tpu_torch.ops import split as split_ops
    from montecarlosolvers_tpu_torch.ops import split_kernels as sk
    from montecarlosolvers_tpu_torch.solvers.api import solve
    from montecarlosolvers_tpu_torch.solvers.dissipative import dissipative_qa

    dev = torch.device("cuda", 0)

    # ---- device
    smi = nvidia_smi()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": name})

    # ---- build
    t0 = time.perf_counter()
    seconds = _build.build(verbose=True)
    emit({"phase": "build", "nvcc_seconds": seconds,
          "total_seconds": time.perf_counter() - t0})

    # ---- cluster shapes of kernels A, 6, B and 5
    for kname, geometry, shapes in (
            ("split_sa", sk.sa_geometry,
             ((SA_READS, L), (QMC_READS, L), (QMC_READS + 1, L),
              (QMC_READS, BIG_L))),
            ("plane_sa", pk.plane_sa_geometry,
             ((SA_READS, ODD_L), (QMC_READS, ODD_L),
              (QMC_READS, BIG_ODD_L)))):
        for chains, lat_l in shapes:
            c, r, threads = geometry(chains, lat_l,
                                     sk.card_resident(kname, lat_l))
            emit({"phase": "clusters", "kernel": kname, "chains": chains,
                  "L": lat_l, "C": c, "R": r, "threads": threads,
                  "ctas": -(-chains // c) * r,
                  "resident_clusters": sk.resident_clusters(kname, r,
                                                            threads, lat_l)})
    for kname, geometry, shapes in (
            ("split_qmc", sk.qmc_geometry,
             ((QMC_READS, L, QMC_SLICES), (QMC_READS, BIG_L, QMC_SLICES))),
            ("split_qmc_bath", sk.qmc_bath_geometry,
             ((BATH_READS, L, BATH_SLICES), (BATH_READS, BIG_L, BATH_SLICES),
              (4, BIG_L, BATH_SLICES))),
            ("plane_qmc", pk.plane_qmc_geometry,
             ((QMC_READS, L, ODD_SLICES), (QMC_READS, ODD_L, ODD_SLICES),
              (QMC_READS, ODD_L, QMC_SLICES)))):
        for chains, lat_l, slices in shapes:
            r, threads = geometry(chains, lat_l, slices,
                                  sk.card_resident(kname, lat_l, slices))
            emit({"phase": "clusters", "kernel": kname, "chains": chains,
                  "L": lat_l, "slices": slices, "R": r, "threads": threads,
                  "ctas": chains * r,
                  "resident_clusters": sk.resident_clusters(
                      kname, r, threads, lat_l, slices)})
    for kname, geometry, shapes in (
            ("plane_svmc", pk.plane_svmc_geometry,
             ((SVMC_READS, ODD_L), (SVMC_READS, BIG_ODD_L))),
            ("split_svmc", sk.svmc_split_geometry,
             ((SVMC_READS, L), (QMC_READS, BIG_L), (2, SVMC_PHASED_L)))):
        for chains, lat_l in shapes:
            r, threads = geometry(chains, lat_l, sk.card_resident(
                kname, lat_l)) or (None, None)
            emit({"phase": "clusters", "kernel": kname, "chains": chains,
                  "L": lat_l, "R": r, "threads": threads,
                  "ctas": r and chains * r,
                  "resident_clusters": r and sk.resident_clusters(
                      kname, r, threads, lat_l)})

    torus = instances.gaussian_torus(L, seed=0, device=dev)
    big_torus = instances.gaussian_torus(BIG_L, seed=0, device=dev)
    odd_torus = instances.gaussian_torus(ODD_L, seed=0, device=dev)
    odd_open = instances.random_2d_lattice(ODD_L, rng=0, device=dev)[0]
    sl = split_ops.build_split(torus)
    rng = np.random.default_rng(1)
    results = {k: {} for k in KERNELS}

    def random_spins(*shape):
        return torch.as_tensor(
            rng.choice([-1.0, 1.0], size=shape).astype(np.float32),
            device=dev)

    def random_angles(*shape):
        return torch.as_tensor(
            (rng.random(shape) * np.pi).astype(np.float32), device=dev)

    # ---- kernel A against its plain version
    a, b = (x.contiguous() for x in split_ops.pack_classical(
        sl, random_spins(SA_READS, L * L)))
    sched = schedules.linear(3.0, 0.1, 200, device=dev)
    ka = sk.sa_split_anneal(sl, sched, a, b, seed=12345)
    ra = sk.sa_split_anneal_ref(sl, sched, a, b, seed=12345)
    torch.cuda.synchronize()
    n_bad, err = mismatches(ka, ra)
    emit({"phase": "sa_kernel_vs_plain", "chains": SA_READS, "steps": 200,
          "nslots": sl.nslots, "mismatched_spins": n_bad, "max_abs_err": err,
          "flipped_fraction": float((ka[0] != a).float().mean())})
    check(n_bad == 0, "kernel A equals its plain version")
    err_a = err
    sched100 = schedules.linear(3.0, 0.1, 100, device=dev)
    for lname, lat, chains in (("gaussian_torus(80, 0)", torus, QMC_READS),
                               ("gaussian_torus(80, 0)", torus,
                                QMC_READS + 1),
                               ("gaussian_torus(256, 0)", big_torus,
                                QMC_READS)):
        sla = split_ops.build_split(lat)
        a, b = (x.contiguous() for x in split_ops.pack_classical(
            sla, random_spins(chains, lat.L * lat.L)))
        ka = sk.sa_split_anneal(sla, sched100, a, b, seed=2468)
        ra = sk.sa_split_anneal_ref(sla, sched100, a, b, seed=2468)
        torch.cuda.synchronize()
        n_bad, err = mismatches(ka, ra)
        err_a = max(err_a, err)
        emit({"phase": "sa_kernel_vs_plain", "lattice": lname,
              "chains": chains, "steps": 100,
              "geometry": sk.sa_geometry(
                  chains, lat.L, sk.card_resident("split_sa", lat.L)),
              "mismatched_spins": n_bad, "max_abs_err": err,
              "flipped_fraction": float((ka[0] != a).float().mean())})
        check(n_bad == 0, f"kernel A equals its plain version on {lname}, "
                          f"{chains} chains")
    results["split_sa"]["max_abs_err"] = err_a

    # ---- kernel B against its plain version
    gamma = schedules.transverse_field(3.0, 1e-8, 40, device=dev)
    teff = (1.0 / QMC_SLICES) * QMC_SLICES
    cases = [("gaussian_torus(80, 0)", torus, QMC_SLICES, bscale, gm,
              QMC_READS, 40) for bscale in (1.0, 0.7) for gm in (True, False)]
    # Q = 1 (both ring terms one element), Q = 32 (a full quarter word), a
    # lattice one block could not hold, and one no cluster holds
    cases += [("gaussian_torus(80, 0)", torus, 2, 0.7, True, QMC_READS, 40),
              ("gaussian_torus(80, 0)", torus, 64, 1.0, True, 4, 20),
              ("gaussian_torus(176, 0)",
               instances.gaussian_torus(176, seed=0, device=dev), 40, 0.7,
               True, 4, 8),
              (f"gaussian_torus({PHASED_L}, 0)",
               instances.gaussian_torus(PHASED_L, seed=0, device=dev), 2,
               1.0, True, 1, 8)]
    for lname, lat, slices, bscale, gm, chains, steps in cases:
        slq = split_ops.build_split(lat)
        quarters = split_ops.pack_qmc(
            slq, random_spins(chains, slices, lat.L * lat.L))
        teff_q = (1.0 / slices) * slices
        jp = schedules.jperp(gamma[:steps], teff_q).contiguous()
        bs = torch.full_like(jp, bscale)
        geometry = sk.qmc_geometry(chains, lat.L, slices, sk.card_resident(
            "split_qmc", lat.L, slices))
        _build.reset_launches()
        kq = sk.qmc_split_anneal(slq, bs, jp, teff_q, quarters, 777, gm)
        launched = {k: v for k, v in _build.LAUNCHES.items() if v}
        rq = sk.qmc_split_anneal_ref(slq, bs, jp, teff_q, quarters, 777, gm)
        torch.cuda.synchronize()
        n_bad, err = mismatches(kq, rq)
        name_b = "split_qmc" if geometry else "split_qmc_phased"
        results[name_b]["max_abs_err"] = max(
            results[name_b].get("max_abs_err", 0.0), err)
        emit({"phase": "qmc_kernel_vs_plain", "lattice": lname,
              "chains": chains, "slices": slices, "steps": steps,
              "B": bscale, "global_moves": gm, "geometry": geometry,
              "launches": launched, "mismatched_spins": n_bad,
              "max_abs_err": err,
              "flipped_fraction": float((kq[0] != quarters[0]).float()
                                        .mean())})
        check(n_bad == 0, f"kernel B equals its plain version on {lname}, "
                          f"P={slices} (B={bscale}, global_moves={gm})")
        check(launched == ({"qmc_split": 1} if geometry else
                           {"qmc_split_phased": (4 if gm else 2) * steps}),
              f"kernel B on {lname}, P={slices} launched {launched}")

    # ---- kernel 5 against its plain version
    open80 = instances.random_2d_lattice(L, rng=0, device=dev)[0]
    gamma5 = schedules.transverse_field(3.0, 1e-8, 20, device=dev)
    err_5 = 0.0
    cases = [("gaussian_torus(80, 0)", torus, BATH_SLICES, bscale, gm)
             for bscale in (1.0, 0.7) for gm in (True, False)]
    cases += [(lname, lat, slices, bscale, gm)
              for lname, lat, slices in (
                  ("gaussian_torus(80, 0)", torus, 5),
                  ("gaussian_torus(80, 0)", torus, 2),
                  ("random_2d_lattice(80, 0), open", open80, 4))
              for bscale, gm in ((0.7, True), (1.0, False))]
    cases = [(*c, BATH_READS, 20) for c in cases]
    # shapes one block per chain could not hold, and P = 64, the largest
    # compile-time P
    cases += [("gaussian_torus(80, 0)", torus, 64, 0.7, True, 4, 8),
              ("gaussian_torus(176, 0)",
               instances.gaussian_torus(176, seed=0, device=dev), 40, 1.0,
               True, 4, 8),
              ("gaussian_torus(256, 0)", big_torus, 40, 0.7, True, 4, 8)]
    for lname, lat, slices, bscale, gm, chains, steps in cases:
        sl5 = split_ops.build_split(lat)
        a5, b5 = (x.contiguous() for x in split_ops.pack_classical(
            sl5, random_spins(chains, slices, lat.L * lat.L)))
        teff5 = (1.0 / slices) * slices
        g5 = gamma5[:steps]
        jp5 = schedules.jperp(g5, teff5).contiguous()
        bs = torch.full_like(g5, bscale)
        for alpha in (BATH_ALPHA, 0.5):
            bath = piqmc_ops.bath_matrix(schedules.bath_lookuptable(
                slices, alpha, device=dev), slices).contiguous()
            k5 = sk.qmc_bath_split_anneal(sl5, bs, jp5, teff5, bath, a5, b5,
                                          888, gm)
            r5 = sk.qmc_bath_split_anneal_ref(sl5, bs, jp5, teff5, bath, a5,
                                              b5, 888, gm)
            torch.cuda.synchronize()
            n_bad, err = mismatches(k5, r5)
            err_5 = max(err_5, err)
            emit({"phase": "qmc_bath_kernel_vs_plain", "lattice": lname,
                  "chains": chains, "slices": slices, "steps": steps,
                  "geometry": sk.qmc_bath_geometry(
                      chains, lat.L, slices,
                      sk.card_resident("split_qmc_bath", lat.L, slices)),
                  "alpha": alpha, "B": bscale, "global_moves": gm,
                  "mismatched_spins": n_bad, "max_abs_err": err,
                  "flipped_fraction": float((k5[0] != a5).float().mean())})
            check(n_bad == 0, f"kernel 5 equals its plain version on {lname}"
                              f", P={slices} (alpha={alpha}, B={bscale}, "
                              f"global_moves={gm})")
    results["split_qmc_bath"]["max_abs_err"] = err_5

    # ---- kernel 6 against its plain version
    err_6 = 0.0
    big_odd = instances.gaussian_torus(BIG_ODD_L, seed=0, device=dev)
    for lname, lat, chains, sched6 in (
            ("gaussian_torus(81, 0)", odd_torus, SA_READS, sched),
            ("random_2d_lattice(81, 0), open", odd_open, SA_READS, sched),
            ("gaussian_torus(81, 0)", odd_torus, QMC_READS, sched100),
            ("gaussian_torus(81, 0)", odd_torus, QMC_READS + 1, sched100),
            (f"gaussian_torus({BIG_ODD_L}, 0)", big_odd, QMC_READS,
             sched100)):
        pl = plane_ops.build_plane(lat)
        s = random_spins(chains, lat.L, lat.L)
        k6 = pk.sa_plane_anneal(pl, sched6, s, seed=4321)
        r6 = pk.sa_plane_anneal_ref(pl, sched6, s, seed=4321)
        torch.cuda.synchronize()
        n_bad, err = mismatches([k6], [r6])
        err_6 = max(err_6, err)
        emit({"phase": "plane_sa_kernel_vs_plain", "lattice": lname,
              "chains": chains, "steps": int(sched6.shape[0]),
              "geometry": pk.plane_sa_geometry(
                  chains, lat.L, sk.card_resident("plane_sa", lat.L)),
              "mismatched_spins": n_bad, "max_abs_err": err,
              "flipped_fraction": float((k6[0] != s[0]).float().mean())})
        check(n_bad == 0, f"kernel 6 equals its plain version on {lname}, "
                          f"{chains} chains")
    results["plane_sa"]["max_abs_err"] = err_6

    # ---- kernel 3 against its plain version
    cases = [(lname, lat, slices, bscale, gm, QMC_READS, 40)
             for lname, lat, slices in (
                 ("gaussian_torus(80, 0)", torus, ODD_SLICES),
                 ("gaussian_torus(81, 0)", odd_torus, ODD_SLICES),
                 ("gaussian_torus(81, 0)", odd_torus, 4))
             for bscale in (1.0, 0.7) for gm in (True, False)]
    # two bit words a site, m = 3 and 4 at 33 chains, a lattice one cluster
    # of 16 CTAs holds at one word a site, and one that no cluster holds
    cases += [("gaussian_torus(81, 0)", odd_torus, QMC_SLICES, 0.7, True,
               QMC_READS, 40),
              ("gaussian_torus(81, 0)", odd_torus, 3, 1.0, True,
               QMC_READS + 1, 40),
              ("gaussian_torus(81, 0)", odd_torus, 7, 0.7, False,
               QMC_READS + 1, 40),
              (f"gaussian_torus({BIG_ODD_L}, 0)", big_odd, ODD_SLICES, 0.7,
               True, QMC_READS, 20),
              (f"gaussian_torus({PLANE_PHASED_L}, 0)",
               instances.gaussian_torus(PLANE_PHASED_L, seed=0, device=dev),
               3, 1.0, True, 1, 8)]
    for lname, lat, slices, bscale, gm, chains, steps in cases:
        pl = plane_ops.build_plane(lat)
        c = random_spins(chains, slices, lat.L, lat.L)
        teff3 = (1.0 / slices) * slices
        jp3 = schedules.jperp(gamma[:steps], teff3).contiguous()
        bs = torch.full_like(jp3, bscale)
        geometry = pk.plane_qmc_geometry(chains, lat.L, slices,
                                         sk.card_resident("plane_qmc", lat.L,
                                                          slices))
        _build.reset_launches()
        k3 = pk.qmc_plane_anneal(pl, bs, jp3, teff3, c, 555, gm)
        launched = {k: v for k, v in _build.LAUNCHES.items() if v}
        r3 = pk.qmc_plane_anneal_ref(pl, bs, jp3, teff3, c, 555, gm)
        torch.cuda.synchronize()
        n_bad, err = mismatches([k3], [r3])
        name_3 = "plane_qmc" if geometry else "plane_qmc_phased"
        results[name_3]["max_abs_err"] = max(
            results[name_3].get("max_abs_err", 0.0), err)
        emit({"phase": "plane_qmc_kernel_vs_plain", "lattice": lname,
              "chains": chains, "slices": slices, "steps": steps,
              "B": bscale, "global_moves": gm, "geometry": geometry,
              "launches": launched, "mismatched_spins": n_bad,
              "max_abs_err": err,
              "flipped_fraction": float((k3[0] != c[0]).float().mean())})
        check(n_bad == 0, f"kernel 3 equals its plain version on {lname}, "
                          f"P={slices} (B={bscale}, global_moves={gm})")
        phases = piqmc_ops.spacetime_num_phases(2, slices) + (2 if gm else 0)
        check(launched == ({"qmc_plane": 1} if geometry else
                           {"qmc_plane_phased": phases * steps}),
              f"kernel 3 on {lname}, P={slices} launched {launched}")

    # ---- kernels 4 and 7 against their plain versions
    a_sv = schedules.linear(3.0, 1e-8, 200, device=dev)
    b_sv = torch.ones_like(a_sv)

    def check_angles(phase, what, kernel_out, plain_out, rec):
        d = angle_diffs(kernel_out, plain_out)
        emit({"phase": phase, **rec, **d})
        check(d["mismatched_angles"] == 0 and d["max_abs_err"] <= ANGLE_ATOL,
              f"{what} equals its plain version ({rec})")
        return d["max_abs_err"]

    sl_svmc_phased = split_ops.build_split(
        instances.gaussian_torus(SVMC_PHASED_L, seed=0, device=dev))
    cases = [(f"gaussian_torus({L}, 0)", sl, SVMC_READS, 200, tf)
             for tf in (True, False)]
    cases += [(f"gaussian_torus({BIG_L}, 0)",
               split_ops.build_split(big_torus), QMC_READS, 100, True)]
    cases += [(f"gaussian_torus({SVMC_PHASED_L}, 0)", sl_svmc_phased, 2, 32,
               tf) for tf in (True, False)]
    for lname, sl4, chains, steps, tf in cases:
        ah, bh = (x.contiguous() for x in split_ops.pack_classical(
            sl4, random_angles(chains, sl4.L * sl4.L)))
        geometry = sk.svmc_split_geometry(
            chains, sl4.L, sk.card_resident("split_svmc", sl4.L))
        _build.reset_launches()
        k4 = sk.svmc_split_anneal(sl4, a_sv[:steps], b_sv[:steps],
                                  SVMC_TEMP, ah, bh, 2468, tf)
        launched = {k: v for k, v in _build.LAUNCHES.items() if v}
        r4 = sk.svmc_split_anneal_ref(sl4, a_sv[:steps], b_sv[:steps],
                                      SVMC_TEMP, ah, bh, 2468, tf)
        torch.cuda.synchronize()
        name4 = "split_svmc" if geometry else "split_svmc_phased"
        results[name4]["max_abs_err"] = max(
            results[name4].get("max_abs_err", 0.0), check_angles(
                "svmc_split_kernel_vs_plain", "kernel 4", k4, r4,
                {"lattice": lname, "chains": chains, "steps": steps,
                 "tf": tf, "nslots": sl4.nslots, "geometry": geometry,
                 "launches": launched,
                 "moved_fraction": float((k4[0] - ah[0]).abs().gt(1e-3)
                                         .float().mean())}))
        check(launched == ({"svmc_split": 1} if geometry else
                           {"svmc_split_phased": 1 + 2 * steps}),
              f"kernel 4 on {lname} launched {launched}")

    err_7 = 0.0
    for lname, lat, tfs in (("gaussian_torus(81, 0)", odd_torus,
                             (True, False)),
                            ("random_2d_lattice(81, 0), open", odd_open,
                             (True, False)),
                            (f"gaussian_torus({BIG_ODD_L}, 0)", big_odd,
                             (True,))):
        pl = plane_ops.build_plane(lat)
        th = random_angles(SVMC_READS, lat.L, lat.L)
        for tf in tfs:
            k7 = pk.svmc_plane_anneal(pl, a_sv, b_sv, SVMC_TEMP, th, 1357,
                                      tf)
            r7 = pk.svmc_plane_anneal_ref(pl, a_sv, b_sv, SVMC_TEMP, th,
                                          1357, tf)
            torch.cuda.synchronize()
            err_7 = max(err_7, check_angles(
                "svmc_plane_kernel_vs_plain", "kernel 7", [k7], [r7],
                {"lattice": lname, "chains": SVMC_READS, "steps": 200,
                 "tf": tf, "geometry": pk.plane_svmc_geometry(
                     SVMC_READS, lat.L, sk.card_resident("plane_svmc",
                                                         lat.L))}))
    results["plane_svmc"]["max_abs_err"] = err_7

    # ---- the per-phase kernels of A, 6, 7 and 5 against their plain
    # versions at the first lattice no cluster of 16 CTAs holds
    sl_a = split_ops.build_split(
        instances.gaussian_torus(SA_PHASED_L, seed=0, device=dev))
    pl_6 = plane_ops.build_plane(
        instances.gaussian_torus(PLANE_SA_PHASED_L, seed=0, device=dev))
    pl_7 = plane_ops.build_plane(
        instances.gaussian_torus(PLANE_SVMC_PHASED_L, seed=0, device=dev))
    sl_5 = split_ops.build_split(
        instances.gaussian_torus(BATH_PHASED_L, seed=0, device=dev))
    sched8 = schedules.linear(3.0, 0.1, 8, device=dev)

    def phased_case(kname, lname, run, geometry, steps, rec):
        """run(fn) on the wrapper and on the plain version; holds the two
        equal and the wrapper's launches to its per-phase kernels'."""
        check(geometry is None, f"no cluster holds {kname} on {lname}")
        _build.reset_launches()
        out = run(True)
        launched = {k: v for k, v in _build.LAUNCHES.items() if v}
        ref = run(False)
        torch.cuda.synchronize()
        if kname.endswith("svmc"):
            err = check_angles("phased_kernel_vs_plain", f"{kname} phased",
                               out, ref, {"kernel": kname, "lattice": lname,
                                          "launches": launched, **rec})
        else:
            n_bad, err = mismatches(out, ref)
            emit({"phase": "phased_kernel_vs_plain", "kernel": kname,
                  "lattice": lname, "launches": launched, **rec,
                  "mismatched_spins": n_bad, "max_abs_err": err,
                  "flipped_fraction": float((out[0] != run.start).float()
                                            .mean())})
            check(n_bad == 0, f"{kname} phased equals its plain version")
        want = {"sa": 2 * steps, "svmc": 1 + 2 * steps,
                "qmc_bath": (4 if rec.get("global_moves") else 2) * steps}
        key = KERNELS[kname][0] + "_phased"
        check(launched == {key: want[kname.split("_", 1)[1]]},
              f"{kname} on {lname} launched {launched}")
        results[f"{kname}_phased"]["max_abs_err"] = err

    a, b = (x.contiguous() for x in split_ops.pack_classical(
        sl_a, random_spins(2, SA_PHASED_L ** 2)))

    def run_a(kernel):
        fn = sk.sa_split_anneal if kernel else sk.sa_split_anneal_ref
        return fn(sl_a, sched8, a, b, 2468)
    run_a.start = a
    phased_case("split_sa", f"gaussian_torus({SA_PHASED_L}, 0)", run_a,
                sk.sa_geometry(2, SA_PHASED_L,
                               sk.card_resident("split_sa", SA_PHASED_L)),
                8, {"chains": 2, "steps": 8})

    s6 = random_spins(2, PLANE_SA_PHASED_L, PLANE_SA_PHASED_L)

    def run_6(kernel):
        fn = pk.sa_plane_anneal if kernel else pk.sa_plane_anneal_ref
        return [fn(pl_6, sched8, s6, 4321)]
    run_6.start = s6
    phased_case("plane_sa", f"gaussian_torus({PLANE_SA_PHASED_L}, 0)",
                run_6, pk.plane_sa_geometry(2, PLANE_SA_PHASED_L,
                                            sk.card_resident(
                                                "plane_sa",
                                                PLANE_SA_PHASED_L)),
                8, {"chains": 2, "steps": 8})

    th7 = random_angles(2, PLANE_SVMC_PHASED_L, PLANE_SVMC_PHASED_L)

    def run_7(kernel):
        fn = pk.svmc_plane_anneal if kernel else pk.svmc_plane_anneal_ref
        return [fn(pl_7, a_sv[:16], b_sv[:16], SVMC_TEMP, th7, 1357, True)]
    phased_case("plane_svmc", f"gaussian_torus({PLANE_SVMC_PHASED_L}, 0)",
                run_7, pk.plane_svmc_geometry(2, PLANE_SVMC_PHASED_L,
                                              sk.card_resident(
                                                  "plane_svmc",
                                                  PLANE_SVMC_PHASED_L)),
                16, {"chains": 2, "steps": 16, "tf": True})

    a5, b5 = (x.contiguous() for x in split_ops.pack_classical(
        sl_5, random_spins(1, BATH_SLICES, BATH_PHASED_L ** 2)))
    g5 = gamma5[:4]
    teff5 = (1.0 / BATH_SLICES) * BATH_SLICES
    jp5 = schedules.jperp(g5, teff5).contiguous()
    bath5 = piqmc_ops.bath_matrix(schedules.bath_lookuptable(
        BATH_SLICES, BATH_ALPHA, device=dev), BATH_SLICES).contiguous()

    def run_5(kernel):
        fn = (sk.qmc_bath_split_anneal if kernel
              else sk.qmc_bath_split_anneal_ref)
        return fn(sl_5, torch.full_like(g5, 0.7), jp5, teff5, bath5, a5,
                  b5, 888, True)
    run_5.start = a5
    phased_case("split_qmc_bath", f"gaussian_torus({BATH_PHASED_L}, 0)",
                run_5, sk.qmc_bath_geometry(1, BATH_PHASED_L, BATH_SLICES,
                                            sk.card_resident(
                                                "split_qmc_bath",
                                                BATH_PHASED_L, BATH_SLICES)),
                4, {"chains": 1, "slices": BATH_SLICES, "steps": 4,
                    "alpha": BATH_ALPHA, "B": 0.7, "global_moves": True})

    # ---- main path through solve(), launch counts read around each solve
    try:
        problem, e_gs = instances.santoro_80x80(lattice=True, device=dev)
        lattice = "santoro_80x80"
    except FileNotFoundError:
        problem, e_gs = torus, None
        lattice = "gaussian_torus(80, seed=0)"
    def solved(method):
        def run(prob, num_reads, sweeps, slices=None):
            kw = {} if slices is None else {"slices": slices}
            ss = solve(prob, method=method, num_reads=num_reads,
                       sweeps=sweeps, seed=0, **kw)
            return ss.samples, ss.energies
        return run

    def dissipative(prob, num_reads, sweeps, slices):
        return dissipative_qa(prob, num_reads, sweeps, slices, BATH_ALPHA,
                              seed=0)

    sa_kw = dict(num_reads=SA_READS, sweeps=SA_SWEEPS)
    qmc_kw = dict(num_reads=QMC_READS, sweeps=QMC_SWEEPS)
    svmc_kw = dict(num_reads=SVMC_READS, sweeps=SVMC_SWEEPS)
    bath_kw = dict(num_reads=BATH_READS, sweeps=BATH_SWEEPS,
                   slices=BATH_SLICES)
    sa_run, qmc_run, svmc_run = solved("sa"), solved("piqmc"), solved("svmc")
    # key, lattice name, problem, run(problem, **options) -> (samples,
    # energies), its options, the launches it must make: every kernel once
    # per anneal (the PIQMC pre-anneal is one SA anneal)
    paths = (
        ("sa", lattice, problem, sa_run, sa_kw, {"sa_split": 1}),
        ("piqmc_p40", lattice, problem, qmc_run,
         dict(qmc_kw, slices=QMC_SLICES),
         {"sa_split": 1, "qmc_split": 1}),
        ("piqmc_p5", lattice, problem, qmc_run,
         dict(qmc_kw, slices=ODD_SLICES),
         {"sa_split": 1, "qmc_plane": 1}),
        ("sa_l81", "gaussian_torus(81, seed=0)", odd_torus, sa_run, sa_kw,
         {"sa_plane": 1}),
        ("piqmc_p5_l81", "gaussian_torus(81, seed=0)", odd_torus, qmc_run,
         dict(qmc_kw, slices=ODD_SLICES),
         {"sa_plane": 1, "qmc_plane": 1}),
        ("svmc", lattice, problem, svmc_run, svmc_kw, {"svmc_split": 1}),
        ("svmc_l81", "gaussian_torus(81, seed=0)", odd_torus, svmc_run,
         svmc_kw, {"svmc_plane": 1}),
        ("piqmc_bath_p40", lattice, problem, dissipative, bath_kw,
         {"sa_split": 1, "qmc_bath_split": 1}),
    )
    main_launches = {k: 0 for k in _build.LAUNCHES}
    for key, lname, prob, run, kw, needs in paths:
        _build.reset_launches()
        t0 = time.perf_counter()
        samples, energies = run(prob, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        for k, v in launches.items():
            main_launches[k] += v
        n, reads = prob.nspins, kw["num_reads"]
        check(samples.shape == (reads, n), f"{key} sample shape")
        check(set(np.unique(samples)) <= {-1.0, 1.0}, f"{key} spins +/-1")
        check(bool(np.all(np.isfinite(energies))), f"{key} finite")
        check(np.allclose(energies, energy64(prob, samples),
                          rtol=1e-5, atol=1e-3),
              f"{key} energies equal a float64 recomputation")
        per_spin = energies / n
        rec = {"phase": "main_path", "path": key,
               "slices": kw.get("slices"), "lattice": lname, "reads": reads,
               "sweeps": kw["sweeps"], "seconds": secs,
               "mean_energy_per_spin": float(per_spin.mean()),
               "best_energy_per_spin": float(per_spin.min()),
               "launches": launches}
        certified = e_gs is not None and prob is problem
        if certified:
            eps = (energies - e_gs) / n
            rec["eps_res_mean"] = float(eps.mean())
            rec["eps_res_best"] = float(eps.min())
        emit(rec)
        lo, hi = EPS_RANGES[key] if certified else RANGES[key]
        val = rec["eps_res_mean"] if certified \
            else rec["mean_energy_per_spin"]
        check(lo <= val <= hi, f"{key} mean {val} inside [{lo}, {hi}]")
        launched = {k: v for k, v in launches.items() if v}
        check(launched == needs, f"{key} launched {launched}, its route "
                                 f"{needs}")
    emit({"phase": "main_path", "launches": main_launches})

    # ---- timing: slope ms per sweep, kernel and plain version
    def split_sa_runner(fn, chains=SA_READS, sl=sl):
        ha, hb = (x.contiguous() for x in split_ops.pack_classical(
            sl, random_spins(chains, sl.L * sl.L)))
        return lambda tau: fn(sl, schedules.linear(3.0, 0.0, tau, device=dev),
                              ha, hb, 7)

    def split_qmc_runner(fn, chains=QMC_READS, slices=QMC_SLICES, sl=sl):
        qs = split_ops.pack_qmc(sl, random_spins(chains, slices,
                                                 sl.L * sl.L))
        teff_q = (1.0 / slices) * slices

        def run(tau):
            g = schedules.transverse_field(3.0, 1e-8, tau, device=dev)
            return fn(sl, torch.ones_like(g), schedules.jperp(g, teff_q)
                      .contiguous(), teff_q, qs, 7, True)
        return run

    def split_bath_runner(fn, sl=sl, chains=BATH_READS):
        ha, hb = (x.contiguous() for x in split_ops.pack_classical(
            sl, random_spins(chains, BATH_SLICES, sl.L * sl.L)))
        bath = piqmc_ops.bath_matrix(schedules.bath_lookuptable(
            BATH_SLICES, BATH_ALPHA, device=dev), BATH_SLICES).contiguous()

        def run(tau):
            g = schedules.transverse_field(3.0, 1e-8, tau, device=dev)
            return fn(sl, torch.ones_like(g), schedules.jperp(g, teff)
                      .contiguous(), teff, bath, ha, hb, 7, True)
        return run

    pl81 = plane_ops.build_plane(odd_torus)
    pl80 = plane_ops.build_plane(torus)

    def svmc_sched(tau):
        a = schedules.linear(3.0, 1e-8, tau, device=dev)
        return a, torch.ones_like(a)

    def split_svmc_runner(fn, chains=SVMC_READS, sl=sl):
        ha, hb = (x.contiguous() for x in split_ops.pack_classical(
            sl, random_angles(chains, sl.L * sl.L)))
        return lambda tau: fn(sl, *svmc_sched(tau), SVMC_TEMP, ha, hb, 7,
                              True)

    def plane_svmc_runner(fn, chains=SVMC_READS, pl=pl81):
        th = random_angles(chains, pl.L, pl.L)
        return lambda tau: fn(pl, *svmc_sched(tau), SVMC_TEMP, th, 7, True)

    def plane_sa_runner(fn, chains=SA_READS, pl=pl81):
        s = random_spins(chains, pl.L, pl.L)
        return lambda tau: fn(pl, schedules.linear(3.0, 0.0, tau,
                                                   device=dev), s, 7)

    def plane_qmc_runner(fn, pl=pl80, chains=QMC_READS, slices=ODD_SLICES):
        c = random_spins(chains, slices, pl.L, pl.L)
        teff_q = (1.0 / slices) * slices

        def run(tau):
            g = schedules.transverse_field(3.0, 1e-8, tau, device=dev)
            return fn(pl, torch.ones_like(g), schedules.jperp(g, teff_q)
                      .contiguous(), teff_q, c, 7, True)
        return run

    # the per-phase kernels at the shapes checked above
    sl_b = split_ops.build_split(
        instances.gaussian_torus(PHASED_L, seed=0, device=dev))
    pl_3 = plane_ops.build_plane(
        instances.gaussian_torus(PLANE_PHASED_L, seed=0, device=dev))
    phased = {
        "split_sa": (lambda fn: split_sa_runner(fn, 2, sl_a), 2, 1,
                     SA_PHASED_L),
        "split_qmc": (lambda fn: split_qmc_runner(fn, 1, 2, sl_b), 1, 2,
                      PHASED_L),
        "split_qmc_bath": (lambda fn: split_bath_runner(fn, sl_5, 1), 1,
                           BATH_SLICES, BATH_PHASED_L),
        "plane_sa": (lambda fn: plane_sa_runner(fn, 2, pl_6), 2, 1,
                     PLANE_SA_PHASED_L),
        "plane_qmc": (lambda fn: plane_qmc_runner(fn, pl_3, 1, 3), 1, 3,
                      PLANE_PHASED_L),
        "plane_svmc": (lambda fn: plane_svmc_runner(fn, 2, pl_7), 2, 1,
                       PLANE_SVMC_PHASED_L),
        "split_svmc": (lambda fn: split_svmc_runner(fn, 2, sl_svmc_phased),
                       2, 1, SVMC_PHASED_L),
    }
    wrappers = {
        "split_sa": (sk.sa_split_anneal, sk.sa_split_anneal_ref),
        "split_qmc": (sk.qmc_split_anneal, sk.qmc_split_anneal_ref),
        "split_qmc_bath": (sk.qmc_bath_split_anneal,
                           sk.qmc_bath_split_anneal_ref),
        "plane_sa": (pk.sa_plane_anneal, pk.sa_plane_anneal_ref),
        "plane_qmc": (pk.qmc_plane_anneal, pk.qmc_plane_anneal_ref),
        "plane_svmc": (pk.svmc_plane_anneal, pk.svmc_plane_anneal_ref),
        "split_svmc": (sk.svmc_split_anneal, sk.svmc_split_anneal_ref),
    }
    phased_rows = []
    for kname, (runner, chains, slices, lat_l) in phased.items():
        kernel, plain = wrappers[kname]
        phased_rows += [
            (f"{kname}_phased", "cuda", runner(kernel),
             (5, 20) if kname == "split_qmc_bath" else (20, 80), 3, chains,
             slices, lat_l * lat_l),
            (f"{kname}_phased", "plain", runner(plain),
             (1, 3) if kname == "split_qmc_bath" else (2, 6), 2, chains,
             slices, lat_l * lat_l)]

    power = smi.split(",")[-1].strip() if "," in smi else smi
    # kernel, route, runner, taus, trials, chains, slices, sites; the rows
    # after the plain ones are beside the main path's shapes and stay out
    # of the kernels line
    timings = (
        ("split_sa", "cuda", split_sa_runner(sk.sa_split_anneal),
         (500, 2000), 3, SA_READS, 1, L * L),
        ("split_sa", "plain", split_sa_runner(sk.sa_split_anneal_ref),
         (10, 40), 2, SA_READS, 1, L * L),
        ("split_qmc", "cuda", split_qmc_runner(sk.qmc_split_anneal),
         (100, 400), 3, QMC_READS, QMC_SLICES, L * L),
        ("split_qmc", "plain", split_qmc_runner(sk.qmc_split_anneal_ref),
         (4, 12), 2, QMC_READS, QMC_SLICES, L * L),
        ("plane_sa", "cuda", plane_sa_runner(pk.sa_plane_anneal),
         (500, 2000), 3, SA_READS, 1, ODD_L * ODD_L),
        ("plane_sa", "plain", plane_sa_runner(pk.sa_plane_anneal_ref),
         (10, 40), 2, SA_READS, 1, ODD_L * ODD_L),
        ("plane_qmc", "cuda", plane_qmc_runner(pk.qmc_plane_anneal),
         (200, 800), 3, QMC_READS, ODD_SLICES, L * L),
        ("plane_qmc", "plain", plane_qmc_runner(pk.qmc_plane_anneal_ref),
         (4, 12), 2, QMC_READS, ODD_SLICES, L * L),
        ("split_svmc", "cuda", split_svmc_runner(sk.svmc_split_anneal),
         (500, 2000), 3, SVMC_READS, 1, L * L),
        ("split_svmc", "plain", split_svmc_runner(sk.svmc_split_anneal_ref),
         (10, 40), 2, SVMC_READS, 1, L * L),
        ("plane_svmc", "cuda", plane_svmc_runner(pk.svmc_plane_anneal),
         (500, 2000), 3, SVMC_READS, 1, ODD_L * ODD_L),
        ("plane_svmc", "plain", plane_svmc_runner(pk.svmc_plane_anneal_ref),
         (10, 40), 2, SVMC_READS, 1, ODD_L * ODD_L),
        ("split_qmc_bath", "cuda", split_bath_runner(sk.qmc_bath_split_anneal),
         (100, 400), 3, BATH_READS, BATH_SLICES, L * L),
        ("split_qmc_bath", "plain",
         split_bath_runner(sk.qmc_bath_split_anneal_ref), (2, 6), 2,
         BATH_READS, BATH_SLICES, L * L),
        *phased_rows,
    )
    extra = (
        ("split_sa", "cuda", split_sa_runner(sk.sa_split_anneal, QMC_READS),
         (500, 2000), 3, QMC_READS, 1, L * L),
        ("plane_sa", "cuda", plane_sa_runner(pk.sa_plane_anneal, QMC_READS),
         (500, 2000), 3, QMC_READS, 1, ODD_L * ODD_L),
        ("split_qmc_bath", "cuda",
         split_bath_runner(sk.qmc_bath_split_anneal,
                           split_ops.build_split(big_torus)),
         (20, 80), 3, BATH_READS, BATH_SLICES, BIG_L * BIG_L),
        ("plane_qmc", "cuda", plane_qmc_runner(pk.qmc_plane_anneal, pl81),
         (200, 800), 3, QMC_READS, ODD_SLICES, ODD_L * ODD_L),
    )
    def time_row(phase, kname, route, run, taus, trials, chains, slices,
                 sites, record=True):
        """Slope-time run and emit its line; with `record`, keep the time
        (and the bound) as kernel `kname`'s, or as its plain version's."""
        ms, best = slope_ms(run, taus, trials)
        rate = sites * slices * chains / (ms * 1e-3) if ms > 0 \
            else float("nan")
        # the work is the kernel's, whichever instantiation does it
        base = kname.removesuffix("_phased").removesuffix("_hw")
        bound, bound_by, unit = bound_ms(base, chains, slices, sites,
                                         max(taus))
        f32, sfu = ops_per_sweep(base, chains, slices, sites)
        hashed = hash_ops_per_sweep(base, chains, slices, sites)
        emit({"phase": phase, "kernel": kname, "route": route,
              "chains": chains, "slices": slices, "sites": sites,
              "global_moves": "qmc" in kname,
              "tf": True if base.endswith("svmc") else None,
              "taus": list(taus),
              "best_seconds": {str(k): v for k, v in best.items()},
              "ms_per_sweep": ms, "attempts_per_s": rate,
              "bound_ms": bound, "bound_by": bound_by, "bound_unit": unit,
              "fp32_ops_per_sweep": f32, "sfu_ops_per_sweep": sfu,
              "hash_int32_ops_per_sweep": hashed,
              "hash_ms": 1e3 * hashed / PEAK_INT32,
              "bytes_per_anneal": bytes_per_anneal(base, chains, slices,
                                                   sites, max(taus)),
              "gpu": name, "power_limit": power})
        check(ms > 0, f"{kname} {route} slope is positive")
        if record and route == "cuda":
            results[kname].update(ms=ms, bound_ms=bound, bound_by=bound_by)
        elif record:
            results[kname]["plain_ms"] = ms

    for i, row in enumerate(timings + extra):
        time_row("timing", *row, record=i < len(timings))

    # ---- the generator instantiations of A, B, 4 and 5 (hw_rng=True)
    hw_exact_checks(dev, results)
    hw_stream_checks(dev, torus)
    hw_quality_checks(dev, torus, results)

    # ---- this slice's path: the bench's eight arms, launch counts read
    # around the whole bench
    from montecarlosolvers_tpu_torch.bench import throughput
    _build.reset_launches()
    t0 = time.perf_counter()
    for rec in throughput.run_arms(light=True, device=dev):
        emit({"phase": "bench", **rec})
        check(np.isfinite(rec["attempts_per_s"])
              and rec["attempts_per_s"] > 0, f"{rec['arm']} rate")
        want = {"sa": "sa_split", "piqmc": "qmc_split",
                "svmc": "svmc_split", "piqmc_bath": "qmc_bath_split",
                "pallas": "sa_split_hw", "pallas_qmc": "qmc_split_hw",
                "pallas_svmc": "svmc_split_hw",
                "pallas_bath": "qmc_bath_split_hw"}[rec["arm"]]
        # a warm run and one trial at each of the light taus
        check(rec["launches"] == {want: 2 * len(rec["taus"])},
              f"{rec['arm']} launched {rec['launches']}")
        if "mean_energy_per_spin" in rec:
            check(np.isfinite(rec["mean_energy_per_spin"])
                  and rec["mean_energy_per_spin"] < 0,
                  f"{rec['arm']} energy")
    bench_launches = dict(_build.LAUNCHES)
    emit({"phase": "bench", "seconds": time.perf_counter() - t0,
          "launches": {k: v for k, v in bench_launches.items() if v}})

    # ---- hw_rng_timing: hash and generator at the pallas_* arms' shapes
    arm_rows, hw_rows = [], []
    runners = {"split_sa": split_sa_runner, "split_qmc": split_qmc_runner,
               "split_svmc": split_svmc_runner,
               "split_qmc_bath": split_bath_runner}
    for kname, (_, arm) in HW_BRANCHES.items():
        chains, slices = throughput.ARMS[arm][:2]
        kernel, plain = wrappers[kname]
        size = ({"chains": chains, "slices": slices}
                if kname == "split_qmc" else {"chains": chains})
        taus = {"split_qmc": (100, 400), "split_qmc_bath": (100, 400)}.get(
            kname, (500, 2000))
        plain_taus = {"split_qmc_bath": (2, 6), "split_qmc": (4, 12)}.get(
            kname, (10, 40))
        hw = functools.partial(kernel, hw_rng=True)
        arm_rows.append((kname, "cuda", runners[kname](kernel, **size),
                         taus, 3, chains, slices, L * L))
        hw_rows += [
            (f"{kname}_hw", "cuda", runners[kname](hw, **size), taus, 3,
             chains, slices, L * L),
            (f"{kname}_hw", "plain", runners[kname](functools.partial(
                plain, hw_rng=True), **size), plain_taus, 2, chains, slices,
             L * L)]
        # the per-phase kernels at the first shape no cluster holds
        run_p, p_chains, p_slices, p_l = phased[kname]
        hw_rows += [
            (f"{kname}_hw_phased", "cuda", run_p(hw),
             (5, 20) if kname == "split_qmc_bath" else (20, 80), 3,
             p_chains, p_slices, p_l * p_l),
            (f"{kname}_hw_phased", "plain", run_p(functools.partial(
                plain, hw_rng=True)),
             (1, 3) if kname == "split_qmc_bath" else (2, 6), 2, p_chains,
             p_slices, p_l * p_l)]
    for row in arm_rows:
        time_row("hw_rng_timing", *row, record=False)
    for row in hw_rows:
        time_row("hw_rng_timing", *row)
    sass = sass_tool()
    for lib in HW_BRANCHES:
        log = _build.PTXAS_LOG.get(lib, "")
        for source, part in ((src, nm) for lb, src, nm in sass.KERNELS
                             if lb == lib):
            rec = sass.count(_build._lib_path(lib), part, log)
            rec.pop("by_opcode")
            emit({"phase": "hw_rng_timing", "library": lib,
                  "uniforms": source, **rec})

    # No single PyTorch call computes a Metropolis sweep, so no kernel has a
    # library yardstick (library_ms null). The generator instantiations'
    # launches are the bench's, the others' the main path's.
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": tpu,
         "launches": (bench_launches if "_hw" in k else main_launches)[key],
         "max_abs_err": results[k]["max_abs_err"], "ms": results[k]["ms"],
         "plain_ms": results[k]["plain_ms"],
         "bound_ms": results[k]["bound_ms"],
         "bound_by": results[k]["bound_by"], "library_ms": None}
        for k, (key, src, tpu) in KERNELS.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
