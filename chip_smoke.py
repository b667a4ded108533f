#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (montecarlosolvers_tpu_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printed as one JSON line:
  device              nvidia-smi's name and power limit of the card
  build               nvcc builds kernels A, B, 3, 4, 5 (with its colored
                      template), 6 and 7, the energy kernel's entry points,
                      the four generic kernels (packed SA, generic PIQMC,
                      packed SVMC, generic bath), the dense in-block
                      kernel, the three cluster kernels (fk_wolff,
                      fk_label, fk_line) and the Houdayer kernel from
                      csrc/, all at once (seconds)
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
  generic_kernel_vs_plain  the generic kernels on an IsingProblem
                      (ops/generic_kernels.py: csrc/packed_sa.cu,
                      csrc/generic_qmc.cu, csrc/packed_svmc.cu) against
                      their plain versions on the card, with and without
                      collect_energy, on the 80x80 torus's to_generic()
                      (N 6400, maxnb 5, 2 colors; SA 1280 chains, PIQMC
                      32 chains at P = 40 and 5, SVMC 256 chains, TF and
                      uniform), random_3d_lattice(16, rng=0) (N 4096, 6
                      neighbours, 2 colors), chimera_graph(16, rng=0) (the
                      D-Wave 2000Q's C16, N 2048, 3 colors),
                      random_graph(2000, 12000, rng=0) (9 colors, more
                      than the JAX MAX_PACKED_COLORS of 8, maxnb 25) and
                      the 81x81 torus's to_generic() (4 colors, a proper
                      coloring); 64 chains (PIQMC 8 at P = 40 and 5) on
                      the last four: 0 mismatched spins, angles by the
                      ANGLE_MISMATCH rule, the collecting run's states
                      bitwise the plain run's, its energies within 1e-5
                      (sum |J| + sum |h|) of the plain version's
                      packed_energy, one launch a call
  bath_kernel_vs_plain  the rest of dissipative PIQMC: the generic bath
                      kernel (csrc/generic_qmc_bath.cu) against its plain
                      version on the 80x80 torus's neighbor-table form (P =
                      40, 32 chains, sequential and colored, global moves
                      on and off, B = 1 and 0.7), the 81x81 torus's
                      checkerboard (P = 40 sequential, P = 5 colored: a
                      coloring that is not proper), the 80x80 torus at P =
                      5 colored, chimera_graph(16, rng=0) at P = 20, the
                      9-color random_graph(2000, 12000, rng=0) and the open
                      81x81 lattice (8 chains, P = 5), BATH_STEPS steps,
                      each with and without collect_energy; then kernel 5's
                      colored template (the quarter sweep) on the 80x80
                      torus at P = 40, 32 chains, B in {1, 0.7} x global
                      moves on / off (the collecting route beside the
                      first), P = 2, P = 64, the open 80x80 lattice at
                      P = 4, the 176x176 torus, and the 674x674 torus,
                      which no cluster holds and the per-phase kernels run:
                      0 mismatched spins, energies within 1e-5 (sum |J| +
                      sum |h|), launches exactly the route's
  dense_kernel_vs_plain  the dense engine's in-block kernel
                      (csrc/dense_sa.cu, ops/dense_kernels.py) against its
                      plain version on the card: sk_model(2048, rng=0) at
                      the main path's 1024 chains, 3 sweeps of T: 3 -> 0.1,
                      blocks of 128, systematic, shuffled and bf16, and one
                      sweep of an SK problem of N = 8192 drawn on the
                      card: 0 mismatched spins, sweeps x ceil(N / 128)
                      launches (TF32 off, so both take full-float32 block
                      fields from the same torch.matmul)
  noisy_kernel_vs_plain  the packed SA and SVMC kernels' table variant
                      (the noisy anneals: per-step coupling tables) against
                      their plain versions on the 80x80 torus's
                      to_generic(), 1280 and 256 chains, 20 steps of the
                      main path's noisy tables, at mcsteps 1 and 2 (a row
                      for two sweeps), SVMC with TF proposals and uniform:
                      0 mismatched spins, angles by the ANGLE_MISMATCH
                      rule, one launch an anneal
  cluster_kernel_vs_plain  the cluster kernels (ops/cluster_kernels.py)
                      against their plain versions on the card, on the
                      80x80 torus's generic form, CLUSTER_STEPS steps:
                      fk_wolff at P = 40 (16 chains, rule "local"; 4 with
                      the bath; 4 with rule "full") and P = 1 (64 chains,
                      the classical Wolff), fk_label at P = 1 (64 chains,
                      labels in shared memory) and P = 40 (8 chains, and 4
                      with the bath; in device memory), fk_line WC2 and
                      WC3 at P = 40, 16 chains, 3 steps of both colors: 0
                      mismatched spins, equal cluster sizes, one launch an
                      anneal (fk_line one a color phase)
  sampler_kernels_vs_plain  the samplers' kernels (solvers/pt.py,
                      solvers/pa.py): the per-chain-schedule instantiations
                      against their plain versions on the card, a (steps,
                      chains) table that repeats one row, as the samplers
                      pass it, and one that changes every step: kernel A
                      at PT_RUNGS x PT_READS = 384 chains (pt_value's 48
                      rungs x 8 reads), 1000 (a ragged last word of 8
                      chains) and 33 on the 80x80 torus, and 33 on its
                      per-phase kernel; kernel
                      B at P = 40, 32 chains of distinct Gamma, global
                      moves, and 4 chains on its per-phase kernels; the
                      packed SA kernel at 384 chains on the torus's
                      generic form and at 64 on the 81x81 torus's
                      checkerboard (not a proper coloring: the kernel's
                      snapshot template), the generic PIQMC kernel at P =
                      40 and P = 5 on those two, and the dense kernel at
                      64 chains on sk_model(2048, rng=0): 0 mismatched
                      spins, one launch each; step0 splits kernels A and B
                      (two one-step launches equal one two-step launch,
                      shared and per chain); the energy kernel on kernel
                      A's chain-bit words (the samplers' split engine
                      keeps those from launch to launch) at 384 and 7040
                      chains on the 80x80 torus, bitwise the energy
                      kernel on the unpacked halves and within
                      ENERGY_RTOL x sum |J| of its plain version, timed
                      beside it; the timing of each per-chain
                      instantiation beside the shared one at its shape
                      (shared, per chain, per chain, shared) and of its
                      plain version; then the whole samplers, pt.sample,
                      sample_piqmc, sample_icm and pa.sample,
                      sample_adaptive, sample_piqmc, sample_piqmc_adaptive,
                      run twice from one seed at small widths, on the
                      kernels and on their plain versions
                      (gibbs_check.plain_route): states, rates, log_z and
                      stats bitwise equal (+/-1 couplings where the split
                      engines' energy kernel reads the energies)
  houdayer_vs_plain   csrc/houdayer.cu against cluster.houdayer_move_ref,
                      bitwise, on the 80x80 torus's generic form (48 pairs)
                      and random_3d_lattice(12, rng=0) (24 pairs): spins and
                      flipped counts, the overlap and E1 + E2 kept; ms a
                      move beside its bound (the table and both replicas'
                      bytes) and the plain version
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
                      and must equal the solve's route exactly; then five
                      solves on IsingProblem graphs: solve("sa"),
                      solve("piqmc", P = 40) and solve("svmc") at the same
                      widths on the same instance in its generic form
                      (santoro_80x80(lattice=False), or the seeded torus's
                      to_generic()), solve("piqmc", P = 20, 32 reads, 1000
                      sweeps) on chimera_graph(16, rng=0) and solve("sa",
                      1280 reads, 2000 sweeps) on random_3d_lattice(16,
                      rng=0), each launching packed_sa, generic_qmc or
                      packed_svmc once an anneal and nothing else; then
                      six bath solves of examples/dissipative_qa.py's
                      protocol (32 chains, alpha = 1e-2, tau =
                      BATH_NEW_SWEEPS, P = 40): sequential and colored on
                      the 80x80 torus's neighbor-table form (what
                      compat.DissipativeQuantumAnneal builds; the generic
                      bath kernel), sequential on the 81x81 torus (the
                      generic bath kernel on its checkerboard), colored on
                      the 80x80 torus (kernel 5's colored template) and at
                      P = 5 (the generic bath kernel), and sequential on
                      chimera_graph(16, rng=0) at P = 20, each in a range
                      around its JAX CPU anchor; then solve("sa", 1024
                      reads, 1000 sweeps) on sk_model(2048, rng=0) (the
                      dense engine: 16000 launches of dense_sa), and
                      sa.anneal_noisy (1280 chains, T 3 -> 0) and
                      svmc.anneal_noisy (256 chains, TF, T = 0.05) over
                      1000 steps of per-step tables nbr_J (1 + 0.1 xi_t)
                      on the 80x80 torus's generic form (one launch each),
                      in ranges around their JAX CPU anchors; then the
                      five cluster methods on the 80x80 torus's generic
                      form: solve("sa_wolff") and solve("sa_sw") (64
                      reads, 200 sweeps, T 3 -> 0.05, a packed SA launch
                      and a cluster launch a sweep), solve("piqmc_wolff"),
                      solve("piqmc_sw", alpha = 1e-2) and
                      solve("piqmc_sw_full") (8 reads, 50 sweeps, P = 40,
                      after the pre-anneal's one packed SA launch: one
                      fk_wolff launch; a fk_line launch a color phase; a
                      generic PIQMC and a fk_label launch a sweep), in
                      ranges around their JAX CPU anchors
                      (tools/cluster_anchors.py); then the samplers
                      (sampler_solves): pt.sample on the 80x80 torus with
                      pt_value's ladder (48 rungs, T 0.5 -> 2.5, 2000
                      sweeps, swap_every 2, the cold rung's mean over the
                      second half; a kernel-A launch and an energy launch
                      on its chain-bit words a sweep), solve("pt", 64
                      reads, 500 sweeps; the auto ladder, 110 rungs, 7040
                      chains), solve("icm", 32 reads, 1000 sweeps,
                      ladder 24) on random_3d_lattice(12, rng=0) (a
                      packed SA launch per exchange interval, a Houdayer
                      launch every second sweep), solve("pa", 1024
                      reads, 500 steps; adaptive to beta = 2 in at most
                      2000 steps; a kernel-A and an energy launch on its
                      words a step) and solve("paq", 32 reads, 500 steps,
                      P = 20; a kernel-B launch a step), each with exactly
                      its launches and in a range around its JAX CPU
                      anchor (tools/sampler_anchors.py)
  timing              slope-timed ms per sweep of each kernel and of its
                      plain version at the main path's shapes, beside the
                      least time the card could take for a sweep (bound:
                      the work's float32 or special-function operations,
                      or its bytes, over the card's peak rates); also
                      kernels A and 6 at 32 chains (the pre-anneals),
                      kernel 5 at P = 40, 32 chains on the 256x256 torus
                      and kernel 3 at P = 5, 32 chains on the 81x81 torus;
                      and each kernel's per-phase kernels and their plain
                      versions at the shape checked above; the generic
                      kernels at the main path's widths on the 80x80
                      torus's generic form, and a line generic_vs_lattice
                      with the lattice kernel's time on the same torus
                      (A, B, 4) beside each; the generic bath kernel on the
                      80x80 torus's neighbor-table form (P = 40, 32 chains;
                      also colored, and on the 81x81 torus and the chimera
                      beside the kernels line), kernel 5's colored template
                      on the 80x80 torus and its per-phase kernels on the
                      674x674 torus, and a line bath_vs_lattice with each
                      beside kernel 5 on the same torus; the dense sweep
                      (kernel route and plain route) at N = 2048, 1024
                      chains, and the kernel route at N = 8192, each with
                      the in-block kernel's ms alone (CUDA events) and one
                      sweep's block products by torch.matmul (its
                      library_ms); the noisy kernels and their plain
                      versions at the main path's widths, their bounds
                      counting the tables' bytes; the cluster kernels' ms
                      a step (fk_wolff at 1 and 16 chains, P = 40, with
                      the mean cluster it counted; fk_label at P = 40, 8
                      chains and P = 1, 64 chains; fk_line a WC3 and a
                      WC2 step at one chain, P = 40) beside
                      `cluster_bound`
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
  cluster_bench       bench/throughput.py's cluster arm in full
                      (bench.py::_cluster_arm): wolff_cluster_ms (one
                      chain, tau 30 and 90), wolff_cluster_ms_per_chain
                      (16 chains), sw_bath_sweep_ms (WC2) and
                      sw_full_sweep_ms (WC3), P = 40, alpha = 1e-2, with
                      exactly the launches of its runs
  hw_rng_timing       ms per sweep of kernels A, B, 4 and 5 with the hash
                      and with hw_rng=True at the pallas_* arms' shapes, of
                      the generator's plain versions and per-phase kernels,
                      and the registers, spills and SASS instructions and
                      loops of both cluster instantiations
                      (tools/sass_counts.py)
  collect_energy_vs_plain  collect_energy=: each of the seven kernels'
                      collecting route (energies=: its per-phase kernels
                      and the energy kernel, csrc/energy.cuh, once a step)
                      at the main path's shapes (SA 1280 chains on 80x80
                      and 81x81, PIQMC P = 40 and 5 and bath P = 40 at 32,
                      SVMC 256; 20-40 steps) against its plain version and
                      against the cluster kernel's run without energies:
                      0 mismatched spins (angles as above), energies
                      within 1e-5 (sum |J| + sum |h|) of the plain
                      version's and, at the last step, of a float64
                      readout; launches exactly the route's. Then
                      collect_energy_solvers: sa/qmc/svmc.anneal(
                      collect_energy=True) at the same shapes, the counts
                      read around each: the energy kernel's launches in
                      the kernels line
  collect_energy_timing  slope ms per sweep of each collecting route beside
                      its cluster kernel's (cluster, collecting,
                      collecting, cluster), and the energy kernel's
                      entry points, ms per launch over 200 launches,
                      beside their plain versions and their bound (the
                      state's and couplings' bytes over 3.35 TB/s)
  mst                 bench/mst.py's matrix, the five arms at tau = 60 and
                      1000, 45 reps, on the santoro instance when
                      MCS_TPU_INSTANCE_DIR holds it (residual energies),
                      else on the seeded 80x80 torus with e_gs = 0: launches
                      exactly its route, every arm lower at tau = 1000, P =
                      5 and 40 in the main path's ranges, a second run finds
                      every point cached, and a run stopped by its budget
                      inside a point (stepping clock, chunks of 16) and
                      resumed writes bitwise the unbroken run's energies;
                      mst_chunks: ms per sweep of a PIQMC chunk of 8, 16,
                      32 and 45 chains at P = 40 and 5
  examples            examples/dissipative_qa.py's run() at alpha = 0 and
                      0.01, tau = 1000, P = 20, 16 chains: kernels A, B and
                      5 once each, energies in range
then a line {"kernels": [...]} (the seven kernels, then their per-phase
kernels, which no main-path solve launches, then the generator
instantiations of A, B, 4 and 5 and their per-phase kernels, whose
launches are the bench's, then the energy kernel by the layout it reads,
halves, quarters or planes, whose launches are the collecting solves',
then the three generic kernels, whose launches are the main path's,
then the generic bath kernel, kernel 5's colored template and its
per-phase kernels, the dense in-block kernel, the packed SA and SVMC
kernels' table variant and the three cluster kernels, whose launches are
the main path's, then the per-chain instantiations of kernels A and B
(and their per-phase kernels, which no main-path solve launches), of the
packed SA, generic PIQMC and dense kernels, and the Houdayer kernel, whose
launches are the sampler solves'),
a line {"phase": "done", "seconds": ..., "phase_seconds": {...}} (the
seconds from the start at the end of each phase), and last
{"ok": true, "device": {...}}.
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
# collect_energy=: the steps of each collecting route held to its plain
# version (the plain bath and PIQMC versions take about 0.1 s a step at
# P = 40), and the taus its ms per sweep is slope-timed over
COLLECT_STEPS = {"split_qmc": 20, "split_qmc_bath": 20}
COLLECT_TAUS = {"split_qmc": (50, 200), "split_qmc_bath": (20, 80)}
# the MST phase: bench/mst.py's matrix at these taus and reps, the five
# arms; its resume is checked at chunks of MST_STOP_CHUNK chains (three a
# point, the last ragged), stopped at the stepping clock's reading
# MST_BUDGET_READINGS, inside the first PIQMC point after its first chunk;
# the chunk sizes timed at P = 40 (kernel B) and P = 5 (kernel 3)
MST_TAUS, MST_REPS = (60, 1000), 45
MST_STOP_CHUNK, MST_BUDGET_READINGS = 16, 9
MST_CHUNKS = (8, 16, 32, 45)
# the open-system driver (examples/dissipative_qa.py's protocol)
DQA_TAU, DQA_SLICES, DQA_CHAINS, DQA_ALPHAS = 1000, 20, 16, (0.0, 0.01)
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
# The generic solves (IsingProblem): the same instance as the lattice
# cells in its generic form takes the lattice cells' ranges; the chimera
# and 3-D glass ranges are JAX CPU anchors (PERF.md section 2,
# tools/generic_anchors.py: the JAX solve at the same sweeps and P), mean
# per spin +/- 0.01:
#   piqmc_chimera  PIQMC P=20 tau=1000 on chimera_graph(16, rng=0), 32
#                  reads: mean -1.75967, sd 0.00470 a read
#   sa_3d          SA tau=2000 on random_3d_lattice(16, rng=0), 64 reads:
#                  mean -1.77815, sd 0.00392 a read
RANGES.update({
    "sa_generic": RANGES["sa"],
    "piqmc_p40_generic": RANGES["piqmc_p40"],
    "svmc_generic": RANGES["svmc"],
    "piqmc_chimera": (-1.770, -1.750),
    "sa_3d": (-1.788, -1.768),
})
# residual energy per spin ranges on the certified santoro instance
EPS_RANGES = {"sa": (0.0, 0.1), "piqmc_p40": (0.0, 0.05),
              "piqmc_p5": (0.0, 0.05), "svmc": (0.0, 0.2),
              "piqmc_bath_p40": (0.0, 0.05)}
EPS_RANGES.update({f"{k}_generic": EPS_RANGES[k]
                   for k in ("sa", "piqmc_p40", "svmc")})
# the chimera PIQMC solve: slices, reads and sweeps of its JAX anchor
CHIMERA_SLICES, CHIMERA_READS, CHIMERA_SWEEPS = 20, 32, 1000
# steps of the generic kernels against their plain versions (PIQMC: fewer,
# its plain version computes every field in every phase)
GENERIC_STEPS, GENERIC_QMC_STEPS = 20, 10
# The rest of dissipative PIQMC (the bath on an IsingProblem, on odd L and
# with bath_update="colored"): examples/dissipative_qa.py's protocol at the
# bath arm's 32 chains, P = 40 (the chimera at 20) and alpha = 1e-2, tau =
# BATH_NEW_SWEEPS. Anchors from the JAX package on the CPU at the same
# problem, P, tau and bath update (tools/jax_bath_anchor.py --tau 200
# --chains 32, key 0; PERF.md section 2), mean best-slice energy per spin
# +/- 0.01 (sd of one read 0.0018-0.0055):
#   piqmc_bath_nbtable_p40          --problem nbtable --L 80: -1.28242
#   piqmc_bath_nbtable_colored_p40  the same, --bath-update colored: -1.28268
#   piqmc_bath_l81_p40              --problem torus --L 81: -1.28648
#   piqmc_bath_colored_p40          --problem torus --L 80, colored: -1.28303
#   piqmc_bath_colored_p5           the same at --slices 5: -1.28196
#   piqmc_bath_chimera_p20          --problem chimera --slices 20: -1.75208
BATH_NEW_SWEEPS, BATH_STEPS = 200, 10
RANGES.update({
    "piqmc_bath_nbtable_p40": (-1.292, -1.272),
    "piqmc_bath_nbtable_colored_p40": (-1.293, -1.273),
    "piqmc_bath_l81_p40": (-1.296, -1.276),
    "piqmc_bath_colored_p40": (-1.293, -1.273),
    "piqmc_bath_colored_p5": (-1.292, -1.272),
    "piqmc_bath_chimera_p20": (-1.762, -1.742),
})
# The dense engine (DenseProblem) and the noisy anneals. Dense: the main
# path's solve("sa", DENSE_READS reads, DENSE_SWEEPS sweeps) on
# sk_model(DENSE_N, rng=0), the largest SK size of
# bench/ladder_calibration.py, blocks of DENSE_BLOCK; its kernel held to
# the plain version over DENSE_STEPS sweeps (the plain micro-steps are a
# loop of PyTorch ops, about 0.2 s a sweep at N = 2048), and timed also at
# N = DENSE_BIG_N, the largest shape of the JAX dense_sweep docstring (an
# SK matrix drawn on the card: its J is 256 MB). Noisy: per-step tables
# nbr_J_t = nbr_J (1 + NOISY_SCALE xi_t), h_t = h, xi float32 normals of
# default_rng(NOISY_SEED) (`noisy_tables`; tools/generic_anchors.py builds
# the same for the JAX anchors), NOISY_SWEEPS steps on the 80x80 torus's
# generic form: SA at SA_READS chains, T 3 -> 0; SVMC-TF at SVMC_READS,
# T = SVMC_TEMP; NOISY_STEPS of them against the plain versions.
DENSE_N, DENSE_READS, DENSE_SWEEPS, DENSE_BLOCK = 2048, 1024, 1000, 128
DENSE_BIG_N, DENSE_STEPS = 8192, 3
NOISY_SWEEPS, NOISY_SEED, NOISY_SCALE, NOISY_STEPS = 1000, 0, 0.1, 20
# Their ranges: the JAX CPU anchors (tools/generic_anchors.py sk | noisy_sa
# | noisy_svmc, 64 reads, key 0; PERF.md section 2), mean per spin +/- 5 sd
# of one read:
#   sa_dense    sk: -0.751803, sd 0.002466
#   sa_noisy    noisy_sa: -1.273436, sd 0.002740
#   svmc_noisy  noisy_svmc: -1.251242, sd 0.003017
RANGES.update({
    "sa_dense": (-0.764134, -0.739471),
    "sa_noisy": (-1.287138, -1.259734),
    "svmc_noisy": (-1.266325, -1.236159),
})
# The cluster solves: the five cluster methods of solve() on the 80x80
# torus's generic form at bench.py::_cluster_arm's P = 40 and alpha = 1e-2
# (piqmc_sw), CLUSTER_SA_* reads and sweeps for sa_wolff / sa_sw and
# CLUSTER_QMC_* for the three PIQMC methods; their ranges are the JAX CPU
# anchors (tools/cluster_anchors.py, the same reads, sweeps and options,
# seed 0; PERF.md section 2), mean per spin +/- max(0.01, 5 sd of a read).
# Their kernels against their plain versions run CLUSTER_STEPS steps.
CLUSTER_SLICES, CLUSTER_ALPHA = 40, 1e-2
CLUSTER_SA_READS, CLUSTER_SA_SWEEPS = 64, 200
CLUSTER_QMC_READS, CLUSTER_QMC_SWEEPS = 8, 50
CLUSTER_STEPS = 6
#   sa_wolff           tools/cluster_anchors.py sa_wolff: -1.26789, sd 0.00286
#   sa_sw              ... sa_sw: -1.26569, sd 0.00354
#   piqmc_wolff_p40    ... piqmc_wolff: -1.21749, sd 0.00418
#   piqmc_sw_full_p40  ... piqmc_sw_full: -1.26540, sd 0.00333
#   piqmc_sw_p40       ... piqmc_sw: -1.26347, sd 0.00440
CLUSTER_ANCHORS = {
    "sa_wolff": (-1.2678889036178589, 0.0028559609781950712),
    "sa_sw": (-1.2656936645507812, 0.003539035562425852),
    "piqmc_wolff_p40": (-1.2174911499023438, 0.0041766115464270115),
    "piqmc_sw_full_p40": (-1.2654012441635132, 0.0033305161632597446),
    "piqmc_sw_p40": (-1.2634696960449219, 0.004400114994496107),
}
RANGES.update({k: (m - max(0.01, 5 * sd), m + max(0.01, 5 * sd))
               for k, (m, sd) in CLUSTER_ANCHORS.items()})
# The samplers (solvers/pt.py, solvers/pa.py). pt.sample: bench/pt_value.py's
# ladder (PT_RUNGS rungs, geometric T PT_COLD -> PT_HOT), PT_SWEEPS sweeps,
# swap_every PT_SWAP, the cold rung's energy averaged over the second half;
# the per-chain kernels are held to their plain versions at PT_RUNGS x
# PT_READS chains (kernel A, packed SA), QPT_CHAINS chains of distinct
# Gamma at P = 40 (kernel B, generic PIQMC) and DENSE_PT_CHAINS (dense),
# SAMPLER_STEPS (SAMPLER_QMC_STEPS) steps; the Houdayer kernel at PT_RUNGS
# pairs and at ICM_RUNGS (bench/icm_value.py's RUNGS) on the 3-D glass.
# The solves: solve("pt") at PT_SOLVE_READS reads and the auto ladder
# (PT_AUTO_RUNGS rungs at N = 6400), solve("icm") at ICM_READS reads,
# ladder ICM_RUNGS, on random_3d_lattice(12, rng=0), solve("pa") at
# bench/pa_value.py's PA_READS replicas, fixed (PA_SWEEPS steps to beta =
# 10) and adaptive (to beta = PA_ADAPTIVE_BETA, pa_value's sampling target
# T = 0.5, in at most PA_ADAPTIVE_STEPS steps), and solve("paq") at P =
# PAQ_SLICES.
PT_RUNGS, PT_READS, PT_COLD, PT_HOT, PT_SWEEPS, PT_SWAP = (48, 8, 0.5, 2.5,
                                                          2000, 2)
QPT_CHAINS, DENSE_PT_CHAINS, ICM_RUNGS = 32, 64, 24
SAMPLER_STEPS, SAMPLER_QMC_STEPS = 20, 10
PT_SOLVE_READS, PT_SOLVE_SWEEPS, PT_AUTO_RUNGS = 64, 500, 110
# quantum PT (pt.sample_piqmc): pt_value's quantum arm on the torus (48
# rungs, geometric Gamma 1.5 -> 0.3, P = 20, T = 1/P, 500 sweeps, swap
# every 2, line moves, from random paths; kernel B per chain) and a 16-rung
# P = 8 ladder on random_3d_lattice(12, rng=0) (the generic PIQMC kernel
# per chain); PT on sk_model(2048, rng=0) through solve("pt") (the dense
# kernel per chain; the auto ladder, 63 rungs)
QPT_RUNGS, QPT_SLICES, QPT_SWEEPS = 48, 20, 500
QPT_GENERIC_RUNGS, QPT_GENERIC_SLICES, QPT_GENERIC_SWEEPS = 16, 8, 300
PT_DENSE_READS, PT_DENSE_SWEEPS = 16, 200
ICM_READS, ICM_SWEEPS = 32, 1000
PA_READS, PA_SWEEPS, PA_ADAPTIVE_STEPS, PA_ADAPTIVE_BETA = 1024, 500, 2000, 2.0
PAQ_READS, PAQ_SWEEPS, PAQ_SLICES = 32, 500, 20
# Their JAX CPU anchors (tools/sampler_anchors.py <case>, the JAX call on
# the CPU at the chip's shapes but for the reads: pt, paq, icm and pt_dense
# 8; PERF.md section 2): the mean energy per spin and the sd of one read,
# seed 0; for the single ladders (pt_sample, qpt_sample, qpt_generic) the
# mean and sd over seeds 0 to 3. The range is the anchor +/- max(0.01, 5
# sd):
#   pt_sample    -1.26734, sd 0.00033 (the cold rung's second-half mean)
#   pt           pt 8 500: -1.26830, sd 0.00134 (110 rungs, swap 0.623)
#   qpt_sample   -1.26664, sd 0.00189 (the Gamma = 0.3 rung's mean slice
#                energy at the end; swap 0.025-0.033)
#   qpt_generic  -1.72027, sd 0.00820 (swap 0.049-0.069)
#   pt_dense     pt_dense 8 200: -0.75160, sd 0.00175 (63 rungs)
#   icm          icm 8 1000: -1.75897, sd 0.00212 (swap 0.324, Houdayer
#                flips 0.250)
#   pa           pa 1024 500: -1.28072, sd 0.00014 (min ESS 0.0084)
#   pa_adaptive  pa_adaptive 1024 2000: -1.26652, sd 0.00217 (334 steps)
#   paq          paq 8 500: -1.27069, sd 0.00097
SAMPLER_ANCHORS = {
    "pt_sample": (-1.267336130142212, 0.0003321066115573864),
    "qpt_sample": (-1.2666440308094025, 0.001888496000323475),
    "qpt_generic": (-1.7202690839767456, 0.008195563280163557),
    "pt_dense": (-0.7515978813171387, 0.001746332854963839),
    "pt": (-1.2682995796203613, 0.0013372339308261871),
    "icm": (-1.758969783782959, 0.0021206524688750505),
    "pa": (-1.280724048614502, 0.00013869453687220812),
    "pa_adaptive": (-1.2665197849273682, 0.0021736216731369495),
    "paq": (-1.2706942558288574, 0.0009730702731758356),
}
RANGES.update({k: (m - max(0.01, 5 * sd), m + max(0.01, 5 * sd))
               for k, (m, sd) in SAMPLER_ANCHORS.items()})
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
# the energy kernel of collect_energy= (csrc/energy.cuh), one entry per
# layout it reads: it replaces no TPU kernel but the XLA readout of the JAX
# scans (ops/split.py:245); its launches are those of the collecting
# solves, under the LAUNCHES keys of the kernels whose routes read each
# layout, "<key>_energy"
ENERGY_LAYOUTS = {
    "energy_halves": ("sa_split", "qmc_bath_split", "svmc_split"),
    "energy_quarters": ("qmc_split",),
    "energy_plane": ("sa_plane", "qmc_plane", "svmc_plane"),
}
for _k in ENERGY_LAYOUTS:
    KERNELS[_k] = (None, "montecarlosolvers_tpu_torch/csrc/energy.cuh",
                   "montecarlosolvers_tpu/ops/split.py:245")
# the generic kernels on an IsingProblem replace no TPU kernel either, but
# the XLA scans of the JAX package's generic engines: the body of each scan
GENERIC_KERNELS = {
    "packed_sa": ("packed_sa", "montecarlosolvers_tpu_torch/csrc/packed_sa.cu",
                  "montecarlosolvers_tpu/ops/packed.py:129"),
    "generic_qmc": ("generic_qmc",
                    "montecarlosolvers_tpu_torch/csrc/generic_qmc.cu",
                    "montecarlosolvers_tpu/ops/piqmc.py:79"),
    "packed_svmc": ("packed_svmc",
                    "montecarlosolvers_tpu_torch/csrc/packed_svmc.cu",
                    "montecarlosolvers_tpu/ops/packed.py:149"),
}
KERNELS.update(GENERIC_KERNELS)
# the rest of dissipative PIQMC: the generic bath kernel (the XLA masked
# sweeps of the JAX solver) and kernel 5's colored template with its
# per-phase kernels (the XLA colored quarter sweep)
BATH_KERNELS = {
    "generic_qmc_bath": (
        "generic_qmc_bath",
        "montecarlosolvers_tpu_torch/csrc/generic_qmc_bath.cu",
        "montecarlosolvers_tpu/ops/piqmc.py:110"),
    "split_qmc_bath_colored": (
        "qmc_bath_split_colored",
        "montecarlosolvers_tpu_torch/csrc/split_qmc_bath.cu",
        "montecarlosolvers_tpu/ops/split.py:578"),
    "split_qmc_bath_colored_phased": (
        "qmc_bath_split_colored_phased",
        "montecarlosolvers_tpu_torch/csrc/split_qmc_bath.cu",
        "montecarlosolvers_tpu/ops/split.py:578"),
}
KERNELS.update(BATH_KERNELS)
# the dense in-block kernel (the sequential loop of the JAX
# dense_metropolis_sweep, an XLA fori_loop) and the packed kernels' table
# variant (the XLA noisy scans), whose launches are the main path's
DENSE_NOISY_KERNELS = {
    "dense_sa": ("dense_sa", "montecarlosolvers_tpu_torch/csrc/dense_sa.cu",
                 "montecarlosolvers_tpu/ops/dense_sweep.py:45"),
    "packed_sa_noisy": ("packed_sa_noisy",
                        "montecarlosolvers_tpu_torch/csrc/packed_sa.cu",
                        "montecarlosolvers_tpu/ops/packed.py:221"),
    "packed_svmc_noisy": ("packed_svmc_noisy",
                          "montecarlosolvers_tpu_torch/csrc/packed_svmc.cu",
                          "montecarlosolvers_tpu/ops/packed.py:259"),
}
KERNELS.update(DENSE_NOISY_KERNELS)
# The cluster updates: three kernels that replace no TPU kernel but the XLA
# loops of the JAX cluster engine (the BFS of wolff_update, the relaxation
# of _label_components, the closure of the line phases), whose launches
# are the main path's
CLUSTER_KERNELS = {
    "fk_wolff": ("fk_wolff", "montecarlosolvers_tpu_torch/csrc/fk_wolff.cu",
                 "montecarlosolvers_tpu/ops/cluster.py:174"),
    "fk_label": ("fk_label", "montecarlosolvers_tpu_torch/csrc/fk_label.cu",
                 "montecarlosolvers_tpu/ops/cluster.py:487"),
    "fk_line": ("fk_line", "montecarlosolvers_tpu_torch/csrc/fk_line.cu",
                "montecarlosolvers_tpu/ops/cluster.py:316"),
}
KERNELS.update(CLUSTER_KERNELS)
# The samplers: the per-chain-schedule instantiations of kernels A and B
# (and their per-phase kernels), of the packed SA, generic PIQMC and dense
# kernels, which replace the XLA sweeps the JAX samplers run with one
# temperature or Gamma a chain (pt.py:112, :123, :221, :238), and the
# Houdayer kernel, which replaces the XLA relaxation of houdayer_sweep
_SRC = "montecarlosolvers_tpu_torch/csrc/"
SAMPLER_KERNELS = {
    "split_sa_chain": ("sa_split_chain", _SRC + "split_sa.cu",
                       "montecarlosolvers_tpu/ops/split.py:209"),
    "split_qmc_chain": ("qmc_split_chain", _SRC + "split_qmc.cu",
                        "montecarlosolvers_tpu/ops/split.py:379"),
    "packed_sa_chain": ("packed_sa_chain", _SRC + "packed_sa.cu",
                        "montecarlosolvers_tpu/ops/metropolis.py:60"),
    "generic_qmc_chain": ("generic_qmc_chain", _SRC + "generic_qmc.cu",
                          "montecarlosolvers_tpu/ops/piqmc.py:79"),
    "dense_sa_chain": ("dense_sa_chain", _SRC + "dense_sa.cu",
                       "montecarlosolvers_tpu/ops/dense_sweep.py:45"),
    "split_sa_chain_phased": ("sa_split_chain_phased", _SRC + "split_sa.cu",
                              "montecarlosolvers_tpu/ops/split.py:209"),
    "split_qmc_chain_phased": ("qmc_split_chain_phased",
                               _SRC + "split_qmc.cu",
                               "montecarlosolvers_tpu/ops/split.py:379"),
    "houdayer": ("houdayer", _SRC + "houdayer.cu",
                 "montecarlosolvers_tpu/ops/cluster.py:730"),
    # the exchanges' energies on kernel A's chain-bit words: the XLA
    # readout the JAX samplers compute (classical_energy_split)
    "energy_chain_bits": ("energy_bits", _SRC + "energy.cuh",
                          "montecarlosolvers_tpu/ops/split.py:197"),
}
KERNELS.update(SAMPLER_KERNELS)
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


def ops_per_sweep(kname, chains, slices, sites, graph=None):
    """(float32, special-function) operations of one sweep of `kname` at
    this shape, global moves on for the PIQMC kernels and TF proposals for
    SVMC, as the work needs them. On a lattice a spin's field is
    SPIN_FIELD adds; on an IsingProblem (`graph` = (degree, maxnb), the
    mean number of real couplings a site and the table's slots) it is
    `degree` adds, its couplings and h, and an SVMC field 2 * degree:
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
    field = SPIN_FIELD if graph is None else graph[0]
    local = field + 4 + METROPOLIS
    line = (field + 1) * P + METROPOLIS
    f32, sfu = {
        "sa": (field + 1 + METROPOLIS, 1),
        "qmc": (local * P + line, P + 1),
        "qmc_bath": ((local + P) * P + line, P + 1),
        # the same work: P - 1 nonzero bath terms a slice in two blocks
        "qmc_bath_colored": ((local + P) * P + line, P + 1),
        "svmc": (4 + 6 + 2 + 2 * field + 6 + 3, 3),
    }[kname.split("_", 1)[1]]
    return f32 * chains * sites, sfu * chains * sites


def bytes_per_anneal(kname, chains, slices, sites, tau, graph=None):
    """Bytes an anneal of `tau` sweeps must move: the state read once and
    written once; the couplings (right, down), h, the bath matrix and the
    two schedules read once. On an IsingProblem (`graph` = (degree,
    maxnb)) the couplings are the table as stored, maxnb int32 indices and
    float32 values a site, with h and the packed layout's original site
    ids (perm)."""
    state = 2 * chains * slices * sites * 4
    bath = slices * slices * 4 if "qmc_bath" in kname else 0
    tables = 3 * sites * 4 if graph is None else sites * (graph[1] * 8 + 8)
    return state + tables + bath + 2 * tau * 4


def bound_ms(kname, chains, slices, sites, tau, graph=None):
    """(least ms per sweep over an anneal of `tau` sweeps, "operations" or
    "bytes", and which of "fp32", "sfu" or "bytes" bounds it)."""
    f32, sfu = ops_per_sweep(kname, chains, slices, sites, graph)
    times = {"fp32": f32 / PEAK_FLOPS, "sfu": sfu / PEAK_SFU,
             "bytes": bytes_per_anneal(kname, chains, slices, sites, tau,
                                       graph) / PEAK_BYTES / tau}
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
    """Classical energies of (reads, N) numpy states in float64, on a
    LatticeProblem, an IsingProblem or a DenseProblem."""
    if hasattr(problem, "J"):
        J, h = (x.double().cpu().numpy() for x in (problem.J, problem.h))
        s = states.astype(np.float64)
        return 0.5 * ((s @ J) * s).sum(axis=1) + s @ h
    if not hasattr(problem, "L"):
        return gibbs_tool().generic_energies(problem,
                                             states.astype(np.float64))
    Lp = problem.L
    jr, jd, hp = (x.double().cpu().numpy() for x in
                  (problem.j_right, problem.j_down, problem.h_plane))
    s = states.astype(np.float64).reshape(-1, Lp, Lp)
    return ((jr * s * np.roll(s, -1, axis=-1)).sum(axis=(1, 2))
            + (jd * s * np.roll(s, -1, axis=-2)).sum(axis=(1, 2))
            + (hp * s).sum(axis=(1, 2)))


def best_energy64(lat, spins):
    """Float64 (chains,) energies of flat spins (chains, N), or the least
    slice energy of (chains, P, N)."""
    s = spins.cpu().numpy()
    e = energy64(lat, s.reshape(-1, lat.nspins)).reshape(s.shape[:-1])
    return e if e.ndim == 1 else e.min(axis=-1)


def readout64(kname, lat, state):
    """`best_energy64` of a collecting route's final state tuple, of
    sign(cos theta) for SVMC."""
    from montecarlosolvers_tpu_torch.ops import split as split_ops

    if kname.startswith("split"):
        sl = split_ops.build_split(lat)
        flat = (split_ops.unpack_qmc(sl, *state) if kname == "split_qmc"
                else split_ops.unpack_classical(sl, *state))
    else:
        flat = state[0].reshape(state[0].shape[:-2] + (lat.nspins,))
    if kname.endswith("svmc"):
        flat = torch.where(torch.cos(flat) >= 0.0, 1.0, -1.0)
    return best_energy64(lat, flat)


# (kernel, lattice, chains, slices) of the collecting routes: the main
# path's shapes of the seven kernels
def collect_shapes(torus, odd_torus):
    return (("split_sa", "gaussian_torus(80, 0)", torus, SA_READS, None),
            ("plane_sa", "gaussian_torus(81, 0)", odd_torus, SA_READS, None),
            ("split_qmc", "gaussian_torus(80, 0)", torus, QMC_READS,
             QMC_SLICES),
            ("plane_qmc", "gaussian_torus(80, 0)", torus, QMC_READS,
             ODD_SLICES),
            ("plane_qmc", "gaussian_torus(81, 0)", odd_torus, QMC_READS,
             ODD_SLICES),
            ("split_qmc_bath", "gaussian_torus(80, 0)", torus, BATH_READS,
             BATH_SLICES),
            ("split_svmc", "gaussian_torus(80, 0)", torus, SVMC_READS, None),
            ("plane_svmc", "gaussian_torus(81, 0)", odd_torus, SVMC_READS,
             None))


def collect_energy_checks(dev, results, torus, odd_torus):
    """collect_energy_vs_plain: at each main-path shape, the collecting
    route of the wrapper (energies=) against its plain version on the same
    inputs and against the cluster kernel's run without energies (states:
    0 mismatched spins, angles as the SVMC checks hold them; energies within
    ENERGY_RTOL (sum |J| + sum |h|) of the plain version's, the last step's
    of a float64 readout of the final state; launches exactly the route's).
    Then the solvers' collect_energy=True through sa/qmc/svmc.anneal at the
    same shapes, the counts set to 0 before and read after each: this
    slice's path of the energy kernel, whose counts it returns."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.solvers import qmc, sa, svmc

    gibbs = gibbs_tool()
    errs = {k: 0.0 for k in ENERGY_LAYOUTS}
    for kname, lname, lat, chains, slices in collect_shapes(torus,
                                                            odd_torus):
        steps = COLLECT_STEPS.get(kname, 40)
        case = gibbs.collect_case(kname, lat, chains, steps, slices)
        wrapper, plain, key = gibbs.COLLECTING[kname]
        es, es_plain = (torch.full((steps, chains), float("nan"), device=dev)
                        for _ in range(2))
        _build.reset_launches()
        out = case["run"](wrapper, es)
        launched = launched_now()
        ref = case["run"](plain, es_plain)
        _build.reset_launches()
        cluster = case["run"](wrapper, None)
        cluster_launched = launched_now()
        torch.cuda.synchronize()
        rec = {"phase": "collect_energy_vs_plain", "kernel": kname,
               "lattice": lname, "chains": chains, "slices": slices,
               "steps": steps, "launches": launched,
               "cluster_launches": cluster_launched}
        if case["angles"]:
            d_plain, d_cluster = angle_diffs(out, ref), angle_diffs(out,
                                                                    cluster)
            rec.update(plain=d_plain, cluster=d_cluster)
            ok = all(d["mismatched_angles"] == 0
                     and d["max_abs_err"] <= ANGLE_ATOL
                     for d in (d_plain, d_cluster))
        else:
            n_plain, _ = mismatches(out, ref)
            n_cluster, _ = mismatches(out, cluster)
            rec.update(mismatched_spins=n_plain,
                       mismatched_spins_cluster=n_cluster)
            ok = n_plain == 0 and n_cluster == 0
        tol = gibbs.ENERGY_RTOL * case["scale"]
        err = float((es - es_plain).abs().max())
        last = float(np.abs(es[-1].double().cpu().numpy()
                            - readout64(kname, lat, out)).max())
        rec.update(energy_max_abs_err=err, last_step_vs_float64=last,
                   tolerance=tol, finite=bool(torch.isfinite(es).all()),
                   mean_last_energy_per_spin=float(es[-1].mean())
                   / lat.nspins)
        emit(rec)
        what = f"{kname} collecting on {lname}"
        check(ok, f"{what}: states equal the plain version's and the "
                  f"cluster kernel's")
        check(rec["finite"] and err <= tol and last <= tol,
              f"{what}: energies within {tol} (plain {err}, float64 "
              f"{last})")
        check(launched == case["launches"],
              f"{what} launched {launched}, its route {case['launches']}")
        check(cluster_launched == {key: 1},
              f"{what}: without energies it launched {cluster_launched}")
        layout = next(k for k, keys in ENERGY_LAYOUTS.items()
                      if key in keys)
        errs[layout] = max(errs[layout], err)
    for k, err in errs.items():
        results[k]["max_abs_err"] = err

    # the solvers' collect_energy=True: this slice's path of the kernel
    path = {k: 0 for k in _build.LAUNCHES}
    gen = torch.Generator().manual_seed(3)
    steps = 20
    sched = schedules.linear(3.0, 0.1, steps, device=dev)
    gamma = schedules.transverse_field(3.0, 1e-8, steps, device=dev)
    ones = torch.ones_like(gamma)
    for kname, lname, lat, chains, slices in collect_shapes(torus,
                                                            odd_torus):
        s = sa.random_state(gen, lat.nspins, batch=(chains,), device=dev)
        _build.reset_launches()
        if kname.endswith("_sa"):
            out, es = sa.anneal(lat, sched, s, gen, collect_energy=True)
            state = out
        elif kname.endswith("svmc"):
            th = svmc.random_state(gen, lat.nspins, batch=(chains,),
                                   device=dev)
            out, es = svmc.anneal(lat, gamma, ones, SVMC_TEMP, th, gen,
                                  tf=True, collect_energy=True)
            state = svmc.z_projection(out)
        else:
            lut = (schedules.bath_lookuptable(slices, BATH_ALPHA, device=dev)
                   if "bath" in kname else None)
            out, es = qmc.anneal(lat, gamma, ones, 1.0 / slices,
                                 qmc.replicate(s, slices), gen,
                                 global_moves=True, lookuptable=lut,
                                 collect_energy=True)
            state = out
        torch.cuda.synchronize()
        launched = dict(_build.LAUNCHES)
        for k, v in launched.items():
            path[k] += v
        launched = {k: v for k, v in launched.items() if v}
        last = float(np.abs(es[-1].double().cpu().numpy()
                            - best_energy64(lat, state)).max())
        emit({"phase": "collect_energy_solvers", "kernel": kname,
              "lattice": lname, "chains": chains, "slices": slices,
              "steps": steps, "shape": list(es.shape),
              "launches": launched, "last_step_vs_float64": last,
              "mean_energy_per_spin": [float(es[0].mean()) / lat.nspins,
                                       float(es[-1].mean()) / lat.nspins]})
        check(tuple(es.shape) == (steps, chains), f"{kname} energies shape")
        check(launched == gibbs.collect_launches(kname, steps, slices),
              f"collecting {kname} solve launched {launched}")
        check(last <= gibbs.ENERGY_RTOL * gibbs.energy_scale(lat),
              f"collecting {kname} solve: last energies vs float64 {last}")
    emit({"phase": "collect_energy_solvers",
          "launches": {k: v for k, v in path.items() if v}})
    return path


def event_ms(fn, reps):
    """ms per call of fn(), CUDA events around `reps` calls after a warm
    one."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def collect_energy_timing(dev, results, torus, odd_torus, power):
    """collect_energy_timing: at each main-path shape, the slope-timed ms
    per sweep of the collecting route (per-phase kernels + the energy
    kernel) beside the cluster kernel's without energies, in turns; and the
    energy kernel's stand-alone entry points, ms per launch (CUDA events
    over 200 launches) beside their plain versions and their bound: the
    state's bytes (read once) and the couplings' (once) over 3.35 TB/s.
    The kernels line takes, for each layout, the first shape below."""
    from montecarlosolvers_tpu_torch.ops import energy as energy_ops
    from montecarlosolvers_tpu_torch.ops import plane as plane_ops
    from montecarlosolvers_tpu_torch.ops import split as split_ops

    gibbs = gibbs_tool()
    name = torch.cuda.get_device_name(0)
    for kname, lname, lat, chains, slices in collect_shapes(torus,
                                                            odd_torus):
        taus = COLLECT_TAUS.get(kname, (100, 400))
        cases = {tau: gibbs.collect_case(kname, lat, chains, tau, slices)
                 for tau in taus}
        bufs = {tau: torch.empty((tau, chains), device=dev) for tau in taus}
        wrapper = gibbs.COLLECTING[kname][0]
        ms = {}
        for route in ("cluster", "collecting", "collecting_2", "cluster_2"):
            collect = route.startswith("collecting")
            ms[route], _ = slope_ms(lambda tau: cases[tau]["run"](
                wrapper, bufs[tau] if collect else None), taus, 2)
        cluster = (ms["cluster"] + ms["cluster_2"]) / 2
        collecting = (ms["collecting"] + ms["collecting_2"]) / 2
        emit({"phase": "collect_energy_timing", "kernel": kname,
              "lattice": lname, "chains": chains, "slices": slices,
              "taus": list(taus), "ms_per_sweep": ms,
              "cluster_ms_per_sweep": cluster,
              "collecting_ms_per_sweep": collecting,
              "slowdown": collecting / cluster, "gpu": name,
              "power_limit": power})

    rng = np.random.default_rng(9)

    def spins(*shape):
        return torch.as_tensor(rng.choice([-1.0, 1.0], size=shape).astype(
            np.float32), device=dev)

    sl80 = split_ops.build_split(torus)
    pl80, pl81 = (plane_ops.build_plane(x) for x in (torus, odd_torus))
    n80, n81 = torus.nspins, odd_torus.nspins
    cos = torch.cos(torch.as_tensor(rng.random((SVMC_READS, n80)) * np.pi,
                                    dtype=torch.float32, device=dev))
    halves_cos = [x.contiguous() for x in split_ops.pack_classical(sl80,
                                                                    cos)]
    split_w = (sl80.nslots * 2 + 2) * sl80.nh * 4
    plane_w = 3 * n80 * 4
    # layout, what, fn(kernel_or_plain), chains, slices, sites, weights
    rows = [
        ("energy_halves", "SA, 1280 chains on 80x80",
         [x.contiguous() for x in split_ops.pack_classical(
             sl80, spins(SA_READS, n80))], None, SA_READS, 1, n80, split_w),
        ("energy_halves", "bath, P = 40, 32 chains on 80x80",
         [x.contiguous() for x in split_ops.pack_classical(
             sl80, spins(BATH_READS, BATH_SLICES, n80))], None, BATH_READS,
         BATH_SLICES, n80, split_w),
        ("energy_halves", "SVMC cos theta, 256 chains on 80x80", halves_cos,
         True, SVMC_READS, 1, n80, split_w),
        ("energy_quarters", "PIQMC P = 40, 32 chains on 80x80",
         split_ops.pack_qmc(sl80, spins(QMC_READS, QMC_SLICES, n80)), None,
         QMC_READS, QMC_SLICES, n80, split_w),
        ("energy_plane", "SA, 1280 chains on 81x81",
         [spins(SA_READS, ODD_L, ODD_L)], pl81, SA_READS, 1, n81,
         3 * n81 * 4),
        ("energy_plane", "PIQMC P = 5, 32 chains on 80x80",
         [spins(QMC_READS, ODD_SLICES, L, L)], pl80, QMC_READS, ODD_SLICES,
         n80, plane_w),
    ]
    seen = set()
    for layout, what, state, arg, chains, slices, sites, wbytes in rows:
        if layout == "energy_halves":
            cos_theta = arg is True
            run = {k: (lambda f=f: f(sl80, *state, cos_theta))
                   for k, f in (("cuda", energy_ops.halves_energy),
                                ("plain", energy_ops.halves_energy_ref))}
        elif layout == "energy_quarters":
            run = {k: (lambda f=f: f(sl80, state))
                   for k, f in (("cuda", energy_ops.quarters_energy),
                                ("plain", energy_ops.quarters_energy_ref))}
        else:
            run = {k: (lambda f=f: f(arg, *state))
                   for k, f in (("cuda", energy_ops.plane_energy),
                                ("plain", energy_ops.plane_energy_ref))}
        ms = event_ms(run["cuda"], 200)
        plain_ms = event_ms(run["plain"], 20)
        state_bytes = chains * slices * sites * 4
        bound = 1e3 * (state_bytes + wbytes + chains * 4) / PEAK_BYTES
        err = float((run["cuda"]() - run["plain"]()).abs().max())
        emit({"phase": "collect_energy_timing", "kernel": layout,
              "shape": what, "ms_per_step": ms, "plain_ms": plain_ms,
              "bound_ms": bound, "bound_by": "bytes",
              "state_bytes": state_bytes, "max_abs_err_vs_plain": err,
              "gpu": name, "power_limit": power})
        if layout not in seen:  # the first shape of each layout
            seen.add(layout)
            results[layout].update(ms=ms, plain_ms=plain_ms,
                                   bound_ms=bound, bound_by="bytes")


class SteppingClock:
    """A stand-in for bench/mst.py's `time` whose time() reads 0, 1, 2, ...
    at successive readings, so a budget of k stops a run at its k-th
    reading of the clock, the same place in every run."""

    def __init__(self):
        self.now = -1.0

    def time(self):
        self.now += 1.0
        return self.now


def mst_checks(dev, problem, e_gs, torus):
    """mst: bench/mst.py's matrix through examples/santoro_mst.py's run(),
    the five arms at MST_TAUS and MST_REPS,
    on the certified instance when it is reachable (residual energies in
    EPS_RANGES), else on the seeded 80x80 torus with e_gs = 0 (eps reads as
    the mean energy per spin, in RANGES); the launches of the whole matrix
    exactly its route; every arm lower at the longest tau than at the
    shortest; a second run finds every point cached; a run stopped by its
    budget and resumed writes bitwise the energies of an unbroken one (at
    chunks of MST_STOP_CHUNK chains, so it stops inside a point). Then
    the ms per sweep of a PIQMC chunk of MST_CHUNKS chains at P = 40 and 5,
    which set mst.PIQMC_CHUNK."""
    import tempfile
    from unittest import mock

    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.bench import mst
    from montecarlosolvers_tpu_torch.examples import santoro_mst
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.solvers import qmc, sa

    certified = e_gs is not None
    prob, egs = (problem, e_gs) if certified else (torus, 0.0)
    lname = "santoro_80x80" if certified else "gaussian_torus(80, seed=0)"
    arms = ["CA"] + [f"PT={pt}_P={p}" for pt, p in mst.DEFAULT_EXPS]
    kw = dict(taus=MST_TAUS, reps=MST_REPS, exps=mst.DEFAULT_EXPS,
              verbose=False)
    with tempfile.TemporaryDirectory() as tmp:
        full, broken = Path(tmp) / "full", Path(tmp) / "broken"
        unbroken = Path(tmp) / "unbroken"
        _build.reset_launches()
        t0 = time.perf_counter()
        res, complete = santoro_mst.run(prob, egs, outdir=str(full), **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = launched_now()
        # the warm-up (one SA anneal and one PIQMC anneal an arm), one SA
        # anneal a CA point, a pre-anneal and a PIQMC anneal a chunk
        chunks = -(-MST_REPS // mst.PIQMC_CHUNK) * len(MST_TAUS)
        want = {"sa_split": 1 + len(MST_TAUS) + 4 * chunks,
                "qmc_split": 3 + 3 * chunks, "qmc_plane": 1 + chunks}
        for name in arms:
            for tau, eps in zip(res[name]["tau"].tolist(),
                                res[name]["eps"].tolist()):
                emit({"phase": "mst", "lattice": lname, "arm": name,
                      "tau": tau, "reps": MST_REPS, "eps": eps,
                      "eps_is": "residual energy per spin" if certified
                      else "mean energy per spin (e_gs = 0)"})
        emit({"phase": "mst", "lattice": lname, "seconds": secs,
              "chunk": mst.PIQMC_CHUNK, "complete": complete,
              "launches": launched})
        check(complete, "the MST matrix completes without a budget")
        check(launched == want, f"the MST matrix launched {launched}, its "
                                f"route {want}")
        for name in arms:
            eps = res[name]["eps"]
            check(len(eps) == len(MST_TAUS) and bool(np.all(np.isfinite(
                eps))), f"MST {name}: a finite point at every tau")
            check(eps[-1] < eps[0], f"MST {name}: tau={MST_TAUS[-1]} "
                                    f"({eps[-1]}) below tau={MST_TAUS[0]} "
                                    f"({eps[0]})")
        for name, key in (("PT=1_P=5", "piqmc_p5"),
                          ("PT=1_P=40", "piqmc_p40")):
            lo, hi = EPS_RANGES[key] if certified else RANGES[key]
            val = float(res[name]["eps"][-1])
            check(lo <= val <= hi, f"MST {name} at tau={MST_TAUS[-1]}: "
                                   f"{val} inside [{lo}, {hi}]")

        def refuse(*args, **kwargs):
            raise RuntimeError("a cached MST point was computed again")

        with mock.patch.object(mst, "sa_arm", refuse), \
                mock.patch.object(mst, "piqmc_arm", refuse):
            again, complete = santoro_mst.run(prob, egs, outdir=str(full),
                                              **kw)
        check(complete and all(np.array_equal(again[k]["eps"],
                                              res[k]["eps"]) for k in arms),
              "a second MST run finds every point cached")
        with mock.patch.object(mst, "PIQMC_CHUNK", MST_STOP_CHUNK):
            santoro_mst.run(prob, egs, outdir=str(unbroken), **kw)
            with mock.patch.object(mst, "time", SteppingClock()):
                _, stopped = santoro_mst.run(prob, egs, outdir=str(broken),
                                             budget=MST_BUDGET_READINGS,
                                             **kw)
            left = sorted(p.name for p in broken.glob("*.npz"))
            _, complete = santoro_mst.run(prob, egs, outdir=str(broken),
                                          **kw)
        differing = [p.name for p in unbroken.glob("*.npz")
                     if not np.array_equal(
                         np.load(p)["energies"],
                         np.load(broken / p.name)["energies"])]
        emit({"phase": "mst", "budget_stop": {
            "chunk": MST_STOP_CHUNK,
            "budget_readings": MST_BUDGET_READINGS, "stopped": not stopped,
            "on_disk_at_stop": left, "resumed_complete": complete,
            "points_differing_from_unbroken": differing}})
        check(not stopped and complete and not differing
              and any(".chunk" in n for n in left),
              "a budget-stopped MST run, stopped inside a point and resumed, "
              "equals the unbroken run")

    # PIQMC chunks: ms per sweep of qmc.anneal on a chunk of c chains
    name = torch.cuda.get_device_name(0)
    gen = torch.Generator().manual_seed(0)
    for slices in (QMC_SLICES, ODD_SLICES):
        per_chain = {}
        for c in MST_CHUNKS:
            s = sa.random_state(gen, torus.nspins, batch=(c,), device=dev)
            confs = qmc.replicate(s, slices)

            def run(tau):
                g = schedules.transverse_field(3.0, 1e-8, tau, device=dev)
                return qmc.anneal(torus, g, torch.ones_like(g),
                                  1.0 / slices, confs, gen,
                                  global_moves=True)
            ms, _ = slope_ms(run, (100, 400), 2)
            per_chain[c] = ms / c
            emit({"phase": "mst_chunks", "slices": slices, "chunk": c,
                  "ms_per_sweep": ms, "ms_per_sweep_per_chain": ms / c,
                  "gpu": name})
        emit({"phase": "mst_chunks", "slices": slices,
              "ms_per_sweep_per_chain": per_chain,
              "default_chunk": mst.PIQMC_CHUNK})


def examples_checks(dev, problem, e_gs, torus):
    """examples: examples/dissipative_qa.py's run() at DQA_ALPHAS, tau =
    DQA_TAU, P = DQA_SLICES, DQA_CHAINS chains (the certified instance when
    it is reachable, else the seeded torus with e_gs = 0): kernel A for the
    pre-anneal, B at alpha = 0 and 5 at alpha > 0, one launch each; finite
    energies, the residual (or mean) energy per spin in range."""
    from montecarlosolvers_tpu_torch.examples import dissipative_qa
    from montecarlosolvers_tpu_torch.ops import _build

    certified = e_gs is not None
    prob, egs = (problem, e_gs) if certified else (torus, 0.0)
    _build.reset_launches()
    t0 = time.perf_counter()
    rows = dissipative_qa.run(prob, egs, tau=DQA_TAU, slices=DQA_SLICES,
                              chains=DQA_CHAINS, alphas=DQA_ALPHAS,
                              verbose=False)
    torch.cuda.synchronize()
    launched = launched_now()
    lo, hi = EPS_RANGES["piqmc_p40"] if certified else RANGES["piqmc_p40"]
    for row in rows:
        emit({"phase": "examples", "driver": "dissipative_qa",
              "lattice": "santoro_80x80" if certified
              else "gaussian_torus(80, seed=0)", "tau": DQA_TAU,
              "slices": DQA_SLICES, "chains": DQA_CHAINS,
              **{k: v for k, v in row.items() if k != "energies"}})
        check(bool(np.all(np.isfinite(row["energies"])))
              and row["energies"].shape == (DQA_CHAINS,),
              f"dissipative_qa alpha={row['alpha']}: finite energies")
        check(lo <= row["eps_res"] <= hi,
              f"dissipative_qa alpha={row['alpha']}: {row['eps_res']} "
              f"inside [{lo}, {hi}]")
    emit({"phase": "examples", "seconds": time.perf_counter() - t0,
          "launches": launched})
    check(launched == {"sa_split": 1, "qmc_split": 1, "qmc_bath_split": 1},
          f"dissipative_qa launched {launched}")


def generic_graphs(dev):
    """name -> IsingProblem of the generic phases: the 80x80 torus's
    generic form first (the main path's instance), then the graphs the
    generic kernels must take."""
    from montecarlosolvers_tpu_torch.models import instances

    return {
        f"gaussian_torus({L}, 0).to_generic()":
            instances.gaussian_torus(L, seed=0, device=dev).to_generic(),
        "random_3d_lattice(16, rng=0)":
            instances.random_3d_lattice(16, rng=0, device=dev)[0],
        "chimera_graph(16, rng=0)":
            instances.chimera_graph(16, rng=0, device=dev)[0],
        "random_graph(2000, 12000, rng=0)":
            instances.random_graph(2000, 12000, rng=0, device=dev)[0],
        f"gaussian_torus({ODD_L}, 0).to_generic()":
            instances.gaussian_torus(ODD_L, seed=0, device=dev).to_generic(),
    }


def graph_shape(problem):
    """(mean real couplings a site, maxnb) of an IsingProblem or a
    PackedGraph: what `ops_per_sweep` and `bytes_per_anneal` count for the
    generic kernels."""
    return (float((problem.nbr_J != 0).sum()) / problem.nspins,
            int(problem.nbr_J.shape[1]))


def generic_checks(dev, results, graphs):
    """Phase generic_kernel_vs_plain: each generic kernel against its plain
    version with and without energies, on every graph of `graphs`."""
    from montecarlosolvers_tpu_torch.ops import _build

    gibbs = gibbs_tool()
    main = next(iter(graphs))
    cases = []
    for gname, prob in graphs.items():
        wide = gname == main
        cases += [("packed_sa", gname, prob, SA_READS if wide else 64, None,
                   {})]
        cases += [("generic_qmc", gname, prob, QMC_READS if wide else 8, P,
                   {"global_moves": gm, "bscale": bs})
                  for P, gm, bs in ((QMC_SLICES, True, 1.0),
                                    (ODD_SLICES, True, 0.7))
                  + (((ODD_SLICES, False, 1.0),) if wide else ())]
        cases += [("packed_svmc", gname, prob, SVMC_READS if wide else 64,
                   None, {"tf": tf}) for tf in ((True, False) if wide
                                               else (True,))]
    for kname, gname, prob, chains, slices, kw in cases:
        steps = GENERIC_QMC_STEPS if slices else GENERIC_STEPS
        case = gibbs.generic_case(kname, prob, chains, steps, slices, **kw)
        wrapper, plain, key = gibbs.GENERIC[kname]
        es, es_plain = (torch.full((steps, chains), float("nan"), device=dev)
                        for _ in range(2))
        _build.reset_launches()
        out = case["run"](wrapper, None)
        collected = case["run"](wrapper, es)
        launched = launched_now()
        ref = case["run"](plain, es_plain)
        torch.cuda.synchronize()
        rec = {"phase": "generic_kernel_vs_plain", "kernel": kname,
               "graph": gname, "nspins": prob.nspins, "maxnb": prob.maxnb,
               "colors": prob.num_colors, "chains": chains,
               "slices": slices, "steps": steps, **kw,
               "launches": launched,
               "energy_err": float((es - es_plain).abs().max()),
               "energy_bound": gibbs.ENERGY_RTOL * case["scale"],
               "collected_equals_uncollected": bool(torch.equal(out,
                                                                collected))}
        if case["angles"]:
            d = angle_diffs([out], [ref])
            rec.update(d, moved_fraction=float(
                (out - case["start"]).abs().gt(1e-3).float().mean()))
            err = d["max_abs_err"]
            ok = d["mismatched_angles"] == 0 and err <= ANGLE_ATOL
        else:
            n_bad, err = mismatches([out], [ref])
            rec.update(mismatched_spins=n_bad, max_abs_err=err,
                       flipped_fraction=float(
                           (out != case["start"]).float().mean()))
            ok = n_bad == 0
        emit(rec)
        what = f"{kname} on {gname}, {chains} chains, P={slices} ({kw})"
        check(ok, f"{what} equals its plain version")
        check(rec["collected_equals_uncollected"],
              f"{what}: collecting changes no state")
        check(bool(torch.isfinite(es).all())
              and rec["energy_err"] <= rec["energy_bound"],
              f"{what}: energies within {rec['energy_bound']}")
        check(launched == {key: 2}, f"{what} launched {launched}")
        results[kname]["max_abs_err"] = max(
            results[kname].get("max_abs_err", 0.0), err)


def neighbor_table_form(lat):
    """The IsingProblem compat.DissipativeQuantumAnneal builds for a
    lattice: IsingProblem.from_neighbor_table of its reference-format
    (N, 4, 2) table, each site's right, then down bond, in row-major order
    (tools/jax_bath_anchor.py builds the JAX one alike)."""
    from montecarlosolvers_tpu_torch.models.ising import (
        IsingProblem, build_neighbor_table)

    L = lat.L
    jr, jd = (x.cpu().numpy() for x in (lat.j_right, lat.j_down))
    i = np.arange(L * L)
    y, x = np.divmod(i, L)
    rows = np.repeat(i, 2)
    cols = np.stack([y * L + (x + 1) % L, ((y + 1) % L) * L + x], 1).ravel()
    vals = np.stack([jr[y, x], jd[y, x]], 1).ravel()
    return IsingProblem.from_neighbor_table(
        build_neighbor_table(L * L, rows, cols, vals, 4), device=lat.device)


def bath_problems(dev, graphs, torus, odd_torus):
    """name -> problem of the bath phases: the 80x80 torus's neighbor-table
    form (the main path's IsingProblem), the 81x81 torus (its checkerboard
    is not a proper coloring), the 80x80 torus, the chimera, the 9-color
    random graph and the open 81x81 lattice."""
    from montecarlosolvers_tpu_torch.models import instances

    return {
        f"gaussian_torus({L}, 0), neighbor table": neighbor_table_form(torus),
        f"gaussian_torus({ODD_L}, 0)": odd_torus,
        f"gaussian_torus({L}, 0)": torus,
        "chimera_graph(16, rng=0)": graphs["chimera_graph(16, rng=0)"],
        "random_graph(2000, 12000, rng=0)":
            graphs["random_graph(2000, 12000, rng=0)"],
        f"random_2d_lattice({ODD_L}, 0), open":
            instances.random_2d_lattice(ODD_L, rng=0, lattice=True,
                                        device=dev)[0],
    }


def bath_checks(dev, results, problems):
    """Phase bath_kernel_vs_plain: the generic bath kernel
    (csrc/generic_qmc_bath.cu) on every problem of `problems` that its
    routes take, sequential and colored, and kernel 5's colored template
    on both of its routes, against their plain versions on the card, with
    and without collect_energy: states bitwise, energies within
    ENERGY_RTOL (sum |J| + sum |h|) of the plain version's, launches
    exactly the route's."""
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.ops import split_kernels as sk

    gibbs = gibbs_tool()
    names = list(problems)
    nbt, odd, tor, chim, rg9, odd_open = names
    # problem, chains, P, colored, global moves, B
    cases = [(nbt, QMC_READS, BATH_SLICES, False, True, 1.0),
             (nbt, QMC_READS, BATH_SLICES, True, True, 1.0),
             (nbt, QMC_READS, BATH_SLICES, False, False, 0.7),
             (odd, QMC_READS, BATH_SLICES, False, True, 1.0),
             (odd, QMC_READS, ODD_SLICES, True, True, 0.7),
             (tor, QMC_READS, ODD_SLICES, True, True, 1.0),
             (chim, QMC_READS, CHIMERA_SLICES, False, True, 1.0),
             (rg9, 8, ODD_SLICES, False, True, 0.7),
             (rg9, 8, ODD_SLICES, True, False, 1.0),
             (odd_open, 8, ODD_SLICES, False, True, 1.0)]
    wrapper, plain, key = gibbs.GENERIC["generic_qmc_bath"]
    for pname, chains, slices, colored, gm, bscale in cases:
        case = gibbs.generic_case("generic_qmc_bath", problems[pname],
                                  chains, BATH_STEPS, slices,
                                  global_moves=gm, colored=colored,
                                  bscale=bscale, alpha=BATH_ALPHA)
        bath_case(results, "generic_qmc_bath", pname, case, wrapper, plain,
                  {key: 1}, {key: 1},
                  {"chains": chains, "slices": slices, "colored": colored,
                   "global_moves": gm, "B": bscale,
                   "proper": case["pg"].proper})
    # kernel 5's colored template: lattice, chains, P, global moves, B,
    # steps; 176 needs a cluster of CTAs, the 674 torus no cluster holds
    from montecarlosolvers_tpu_torch.models import instances
    big = instances.gaussian_torus(176, seed=0, device=dev)
    phased = instances.gaussian_torus(BATH_PHASED_L, seed=0, device=dev)
    open80 = instances.random_2d_lattice(L, rng=0, lattice=True,
                                         device=dev)[0]
    cases = [(tor, problems[tor], BATH_READS, BATH_SLICES, gm, bs, 20)
             for gm in (True, False) for bs in (1.0, 0.7)]
    cases += [(tor, problems[tor], BATH_READS, 2, True, 0.7, 20),
              (f"random_2d_lattice({L}, 0), open", open80, BATH_READS, 4,
               True, 1.0, 20),
              (tor, problems[tor], 4, 64, True, 0.7, 8),
              ("gaussian_torus(176, 0)", big, 4, BATH_SLICES, True, 1.0, 8),
              (f"gaussian_torus({BATH_PHASED_L}, 0)", phased, 1,
               BATH_SLICES, True, 0.7, 2)]
    for lname, lat, chains, slices, gm, bscale, steps in cases:
        case = gibbs.bath_colored_case(lat, chains, steps, slices,
                                       global_moves=gm, bscale=bscale,
                                       alpha=BATH_ALPHA)
        geometry = sk.qmc_bath_geometry(chains, lat.L, slices,
                                        sk.card_resident("split_qmc_bath",
                                                         lat.L, slices))
        kname = ("split_qmc_bath_colored" if geometry
                 else "split_qmc_bath_colored_phased")
        phases = (6 if gm else 4) * steps
        route = ({"qmc_bath_split_colored": 1} if geometry
                 else {"qmc_bath_split_colored_phased": phases})
        collecting = dict(case["launches"],
                          qmc_bath_split_colored_phased=phases)
        # the collecting route is the per-phase kernels at any shape: at
        # the main path's shape it is checked once, beside the cluster run
        collect = chains == BATH_READS and slices == BATH_SLICES \
            and gm and bscale == 1.0
        bath_case(results, kname, lname, case,
                  sk.qmc_bath_split_colored_anneal,
                  sk.qmc_bath_split_colored_anneal_ref, route,
                  collecting if collect else None,
                  {"chains": chains, "slices": slices, "steps": steps,
                   "global_moves": gm, "B": bscale, "geometry": geometry})


def bath_case(results, kname, pname, case, wrapper, plain, route,
              collecting, rec):
    """One case of bath_kernel_vs_plain: the wrapper's run (and, with
    `collecting`, its collecting run) against the plain version's."""
    from montecarlosolvers_tpu_torch.ops import _build

    steps, chains = rec.get("steps", BATH_STEPS), rec["chains"]
    es, es_plain = (torch.full((steps, chains), float("nan"),
                               device=case["start"].device)
                    for _ in range(2))
    _build.reset_launches()
    out = case["run"](wrapper, None)
    launched = launched_now()
    ref = case["run"](plain, es_plain if collecting else None)
    rec = {"phase": "bath_kernel_vs_plain", "kernel": kname,
           "problem": pname, **rec, "launches": launched}
    if collecting:
        _build.reset_launches()
        collected = case["run"](wrapper, es)
        rec.update(collecting_launches=launched_now(),
                   collected_equals_uncollected=bool(torch.equal(out,
                                                                 collected)),
                   energy_err=float((es - es_plain).abs().max()),
                   energy_bound=gibbs_tool().ENERGY_RTOL * case["scale"])
    torch.cuda.synchronize()
    n_bad, err = mismatches([out], [ref])
    rec.update(mismatched_spins=n_bad, max_abs_err=err,
               flipped_fraction=float((out != case["start"]).float()
                                      .mean()))
    emit(rec)
    what = f"{kname} on {pname} ({rec})"
    check(n_bad == 0, f"{what} equals its plain version")
    check(rec["flipped_fraction"] > 0.05, f"{what} moves")
    check(launched == route, f"{what} launched {launched}")
    if collecting:
        check(rec["collecting_launches"] == collecting,
              f"{what}: collecting launched {rec['collecting_launches']}")
        check(rec["collected_equals_uncollected"],
              f"{what}: collecting changes no state")
        check(bool(torch.isfinite(es).all())
              and rec["energy_err"] <= rec["energy_bound"],
              f"{what}: energies within {rec['energy_bound']}")
    results[kname]["max_abs_err"] = max(
        results[kname].get("max_abs_err", 0.0), err)


def dense_problem(n, dev):
    """An SK DenseProblem of n spins drawn on the card (torch's generator,
    seed 0): J_ij ~ N(0, 1/n) above the diagonal, mirrored, h = 0. For the
    shapes where building sk_model's matrix on the host would take
    seconds."""
    from montecarlosolvers_tpu_torch.models.dense import DenseProblem

    gen = torch.Generator(device=dev).manual_seed(0)
    J = torch.randn((n, n), generator=gen, device=dev).triu(1) / n ** 0.5
    return DenseProblem(J=(J + J.T).contiguous(),
                        h=torch.zeros(n, device=dev))


def random_pm1(rng, shape, dev):
    return torch.as_tensor(rng.choice([-1.0, 1.0], size=shape).astype(
        np.float32), device=dev)


def dense_checks(dev, results):
    """Phase dense_kernel_vs_plain: csrc/dense_sa.cu against its plain
    version on the card at the main path's shape, systematic, shuffled
    and bf16, and one sweep at N = DENSE_BIG_N; sweeps x ceil(N / B)
    launches each. Returns the main path's sk_model(DENSE_N, rng=0)."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.ops import dense_kernels as dk

    sk = instances.sk_model(DENSE_N, rng=0, device=dev)[0]
    rng = np.random.default_rng(3)
    for name, dp, steps, shuffle, md in (
            (f"sk_model({DENSE_N}, rng=0)", sk, DENSE_STEPS, False, None),
            (f"sk_model({DENSE_N}, rng=0)", sk, DENSE_STEPS, True, None),
            (f"sk_model({DENSE_N}, rng=0)", sk, DENSE_STEPS, False,
             torch.bfloat16),
            (f"SK N={DENSE_BIG_N} drawn on the card",
             dense_problem(DENSE_BIG_N, dev), 1, False, None)):
        n = dp.nspins
        s = random_pm1(rng, (DENSE_READS, n), dev)
        temps = schedules.linear(3.0, 0.1, steps, device=dev)
        _build.reset_launches()
        out = dk.dense_sa_anneal(dp, temps, s, 77, DENSE_BLOCK, shuffle, md)
        launched = launched_now()
        ref = dk.dense_sa_anneal_ref(dp, temps, s, 77, DENSE_BLOCK, shuffle,
                                     md)
        torch.cuda.synchronize()
        n_bad, err = mismatches([out], [ref])
        rec = {"phase": "dense_kernel_vs_plain", "problem": name,
               "nspins": n, "chains": DENSE_READS, "steps": steps,
               "block": DENSE_BLOCK, "shuffle": shuffle,
               "matmul_dtype": str(md), "launches": launched,
               "mismatched_spins": n_bad, "max_abs_err": err,
               "flipped_fraction": float((out != s).float().mean())}
        emit(rec)
        what = f"dense_sa on {name} ({rec})"
        check(n_bad == 0, f"{what} equals its plain version")
        check(rec["flipped_fraction"] > 0.01, f"{what} moves")
        check(launched == {"dense_sa": steps * -(-n // DENSE_BLOCK)},
              f"{what} launched {launched}")
        results["dense_sa"]["max_abs_err"] = max(
            results["dense_sa"].get("max_abs_err", 0.0), err)
    return sk


def noisy_tables(problem, dev, steps=NOISY_SWEEPS, seed=NOISY_SEED):
    """The per-step tables of the noisy anneals on IsingProblem `problem`
    in its slot layout, float32 on `dev`: nbr_J (1 + NOISY_SCALE xi), xi of
    shape (steps,) + nbr_J.shape from default_rng(seed), and h each step
    (tools/generic_anchors.py::noisy_tables, bitwise)."""
    nbr_J, h = (x.cpu().numpy() for x in (problem.nbr_J, problem.h))
    xi = np.random.default_rng(seed).standard_normal(
        (steps,) + nbr_J.shape, dtype=np.float32)
    jt = nbr_J * (np.float32(1.0) + np.float32(NOISY_SCALE) * xi)
    return (torch.as_tensor(jt, device=dev),
            torch.as_tensor(h, device=dev).expand(steps, -1).contiguous())


def noisy_checks(dev, results, gtorus, tables):
    """Phase noisy_kernel_vs_plain: the packed SA and SVMC kernels on
    per-step tables against their plain versions on the card, the main
    path's chains on the 80x80 torus's generic form, NOISY_STEPS steps
    (and half as many rows at mcsteps = 2): 0 mismatched spins, angles by
    the ANGLE_MISMATCH rule, one launch an anneal."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops

    pg = packed_ops.build_packed(gtorus)
    n = pg.nspins
    rng = np.random.default_rng(4)
    steps = NOISY_STEPS
    for mcsteps in (1, 2):
        rows = steps // mcsteps
        tb = gk.packed_tables(pg, tables[0][:rows], tables[1][:rows],
                              mcsteps, steps, dev)
        s = random_pm1(rng, (SA_READS, n), dev)
        th = torch.as_tensor((rng.random((SVMC_READS, n)) * np.pi).astype(
            np.float32), device=dev)
        a = schedules.linear(3.0, 1e-8, steps, device=dev)
        b = torch.ones_like(a)
        cases = [("packed_sa_noisy", None, s,
                  lambda fn: fn(pg, schedules.linear(3.0, 0.0, steps,
                                                     device=dev),
                                s, 7, tables=tb))]
        cases += [("packed_svmc_noisy", tf, th,
                   lambda fn, tf=tf: fn(pg, a, b, SVMC_TEMP, th, 7, tf,
                                        tables=tb))
                  for tf in (True, False)]
        for kname, tf, start, run in cases:
            wrapper, plain = ((gk.packed_sa_anneal, gk.packed_sa_anneal_ref)
                              if tf is None else
                              (gk.packed_svmc_anneal,
                               gk.packed_svmc_anneal_ref))
            _build.reset_launches()
            out = run(wrapper)
            launched = launched_now()
            ref = run(plain)
            torch.cuda.synchronize()
            rec = {"phase": "noisy_kernel_vs_plain", "kernel": kname,
                   "graph": f"gaussian_torus({L}, 0).to_generic()",
                   "chains": start.shape[0], "steps": steps,
                   "mcsteps": mcsteps, "tf": tf, "launches": launched}
            if tf is None:
                n_bad, err = mismatches([out], [ref])
                rec.update(mismatched_spins=n_bad, max_abs_err=err,
                           flipped_fraction=float((out != start).float()
                                                  .mean()))
                ok = n_bad == 0
            else:
                d = angle_diffs([out], [ref])
                rec.update(d)
                err = d["max_abs_err"]
                ok = d["mismatched_angles"] == 0 and err <= ANGLE_ATOL
            emit(rec)
            what = f"{kname} ({rec})"
            check(ok, f"{what} equals its plain version")
            check(launched == {kname: 1}, f"{what} launched {launched}")
            results[kname]["max_abs_err"] = max(
                results[kname].get("max_abs_err", 0.0), err)


def dense_noisy_timing(dev, results, sk, gtorus, tables, power, name):
    """Slope ms per sweep of the dense engine (kernel route and plain
    route at the main path's shape, the kernel route also at N =
    DENSE_BIG_N) and of the noisy kernels and their plain versions at the
    main path's widths, beside each bound; the dense in-block kernel alone
    and one sweep's block products (torch.matmul, the library yardstick),
    ms by CUDA events."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.ops import dense_kernels as dk
    from montecarlosolvers_tpu_torch.ops import dense_sweep as ds
    from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops

    rng = np.random.default_rng(5)
    B = DENSE_BLOCK

    big = dense_problem(DENSE_BIG_N, dev)
    for dp, fn, route, taus, trials, record in (
            (sk, dk.dense_sa_anneal, "cuda", (10, 40), 3, True),
            (sk, dk.dense_sa_anneal_ref, "plain", (1, 3), 2, True),
            (big, dk.dense_sa_anneal, "cuda", (2, 6), 2, False)):
        n = dp.nspins
        s = random_pm1(rng, (DENSE_READS, n), dev)
        ms, best = slope_ms(
            lambda tau, dp=dp, fn=fn, s=s: fn(
                dp, schedules.linear(3.0, 0.1, tau, device=dev), s, 7, B),
            taus, trials)
        Jp, hp, sp = ds.padded(dp.J, dp.h, s.clone(), B)
        fb = ds.block_fields(sp, Jp, hp, 0, B)
        temps = schedules.linear(3.0, 0.1, 1, device=dev)
        nblocks = Jp.shape[0] // B
        block_ms = event_ms(lambda: dk.dense_sa_block(sp, fb, Jp, 0, temps,
                                                      0, 7), 200)
        matmul_ms = event_ms(lambda: [torch.matmul(sp, Jp[:, st:st + B])
                                      for st in range(0, Jp.shape[0], B)],
                             20)
        bound, bound_by, unit = dense_bound(DENSE_READS, n)
        emit({"phase": "timing", "kernel": "dense_sa", "route": route,
              "chains": DENSE_READS, "nspins": n, "block": B,
              "taus": list(taus),
              "best_seconds": {str(k): v for k, v in best.items()},
              "ms_per_sweep": ms,
              "attempts_per_s": DENSE_READS * n / (ms * 1e-3),
              "kernel_ms_per_block": block_ms,
              "kernel_ms_per_sweep": block_ms * nblocks,
              "matmul_ms_per_sweep": matmul_ms,
              "bound_ms": bound, "bound_by": bound_by, "bound_unit": unit,
              "gpu": name, "power_limit": power})
        check(ms > 0, f"dense_sa {route} slope is positive")
        if record and route == "cuda":
            results["dense_sa"].update(ms=ms, bound_ms=bound,
                                       bound_by=bound_by,
                                       library_ms=matmul_ms)
        elif record:
            results["dense_sa"]["plain_ms"] = ms

    pg = packed_ops.build_packed(gtorus)
    n = pg.nspins
    jt, ht, _ = gk.packed_tables(pg, *tables, 1, NOISY_SWEEPS, dev)
    graph = graph_shape(gtorus)
    s = random_pm1(rng, (SA_READS, n), dev)
    th = torch.as_tensor((rng.random((SVMC_READS, n)) * np.pi).astype(
        np.float32), device=dev)

    def sa_run(fn):
        return lambda tau: fn(pg, schedules.linear(3.0, 0.0, tau, device=dev),
                              s, 7, tables=(jt[:tau], ht[:tau], 1))

    def svmc_run(fn):
        def run(tau):
            a = schedules.linear(3.0, 1e-8, tau, device=dev)
            return fn(pg, a, torch.ones_like(a), SVMC_TEMP, th, 7, True,
                      tables=(jt[:tau], ht[:tau], 1))
        return run

    for kname, base, chains, run, route, taus, trials in (
            ("packed_sa_noisy", "packed_sa", SA_READS,
             sa_run(gk.packed_sa_anneal), "cuda", (250, 1000), 3),
            ("packed_sa_noisy", "packed_sa", SA_READS,
             sa_run(gk.packed_sa_anneal_ref), "plain", (10, 40), 2),
            ("packed_svmc_noisy", "packed_svmc", SVMC_READS,
             svmc_run(gk.packed_svmc_anneal), "cuda", (250, 1000), 3),
            ("packed_svmc_noisy", "packed_svmc", SVMC_READS,
             svmc_run(gk.packed_svmc_anneal_ref), "plain", (10, 40), 2)):
        ms, best = slope_ms(run, taus, trials)
        f32, sfu = ops_per_sweep(base, chains, 1, n, graph)
        tau = max(taus)
        moved = (bytes_per_anneal(base, chains, 1, n, tau, graph)
                 + tau * n * (graph[1] + 1) * 4)
        times = {"fp32": f32 / PEAK_FLOPS, "sfu": sfu / PEAK_SFU,
                 "bytes": moved / PEAK_BYTES / tau}
        unit = max(times, key=times.get)
        bound = 1e3 * times[unit]
        bound_by = "bytes" if unit == "bytes" else "operations"
        emit({"phase": "timing", "kernel": kname, "route": route,
              "chains": chains, "sites": n, "taus": list(taus),
              "best_seconds": {str(k): v for k, v in best.items()},
              "ms_per_sweep": ms, "attempts_per_s": chains * n / (ms * 1e-3),
              "bound_ms": bound, "bound_by": bound_by, "bound_unit": unit,
              "fp32_ops_per_sweep": f32, "sfu_ops_per_sweep": sfu,
              "bytes_per_anneal": moved, "table_bytes": int(
                  tau * n * (graph[1] + 1) * 4),
              "gpu": name, "power_limit": power})
        check(ms > 0, f"{kname} {route} slope is positive")
        if route == "cuda":
            results[kname].update(ms=ms, bound_ms=bound, bound_by=bound_by)
        else:
            results[kname]["plain_ms"] = ms


def cluster_inputs(pg, dev, rng, chains, P, steps, classical=False):
    """Random packed (chains, P, N) spins and the (B, J_perp, T_eff)
    schedules of `steps` steps: PIQMC at T = 1/P over Gamma: 3 -> 1e-8, B =
    1; with `classical` (P = 1) B = 1, J_perp = 0 and T_eff: 3 -> 0.05."""
    from montecarlosolvers_tpu_torch import schedules

    confs = random_pm1(rng, (chains, P, pg.nspins), dev)
    if classical:
        temps = schedules.linear(3.0, 0.05, steps, device=dev)
        return confs, torch.ones_like(temps), torch.zeros_like(temps), temps
    gamma = schedules.transverse_field(3.0, 1e-8, steps, device=dev)
    teff = (1.0 / P) * P
    return (confs, torch.ones_like(gamma),
            schedules.jperp(gamma, teff).contiguous(),
            torch.full_like(gamma, teff))


def cluster_checks(dev, results, gtorus):
    """Phase cluster_kernel_vs_plain: fk_wolff, fk_label and fk_line
    against their plain versions on the card on the 80x80 torus's generic
    form at the cluster solves' widths, CLUSTER_STEPS steps: 0 mismatched
    spins, the same cluster sizes, one launch an anneal (fk_line: one a
    color phase)."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.ops import cluster as cl
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops

    pg = packed_ops.build_packed(gtorus)
    rng = np.random.default_rng(7)
    P, steps = CLUSTER_SLICES, CLUSTER_STEPS
    lut = schedules.bath_lookuptable(P, CLUSTER_ALPHA, device=dev)
    graph = f"gaussian_torus({L}, 0).to_generic()"

    def record(kname, case, out, ref, start, launched, want, extra=None):
        torch.cuda.synchronize()
        n_bad, err = mismatches([out], [ref])
        rec = {"phase": "cluster_kernel_vs_plain", "kernel": kname,
               "graph": graph, **case, "launches": launched,
               "mismatched_spins": n_bad, "max_abs_err": err,
               "flipped_fraction": float((out != start).float().mean()),
               **(extra or {})}
        emit(rec)
        check(n_bad == 0, f"{kname} ({rec}) equals its plain version")
        check(rec["flipped_fraction"] > 0, f"{kname} ({rec}) moves")
        check(launched == want, f"{kname} ({rec}) launched {launched}")
        results[kname]["max_abs_err"] = max(
            results[kname].get("max_abs_err", 0.0), err)

    # Wolff: rule "local" at the bench's 16 chains, with the bath, rule
    # "full", and the classical cluster (P = 1, Gamma = inf) at 64 chains
    for chains, slices, rule, bath in ((16, P, "local", False),
                                       (4, P, "local", True),
                                       (4, P, "full", False),
                                       (CLUSTER_SA_READS, 1, "local", False)):
        c, b, jp, teff = cluster_inputs(pg, dev, rng, chains, slices, steps,
                                        classical=slices == 1)
        table = lut if bath else None
        vis, vis_ref = (torch.zeros(chains, dtype=torch.int64, device=dev)
                        for _ in range(2))
        _build.reset_launches()
        out = ck.wolff_anneal(pg, b, jp, teff, c, 21, rule, table, 0, vis)
        launched = launched_now()
        ref = cl.wolff_anneal_ref(pg, b, jp, teff, c, 21, rule, table, 0,
                                  vis_ref)
        record("fk_wolff", {"chains": chains, "slices": slices, "rule": rule,
                            "bath": bath, "steps": steps}, out, ref, c,
               launched, {"fk_wolff": 1},
               {"mean_cluster_sites": float(vis.double().mean()) / steps})
        check(torch.equal(vis, vis_ref), "fk_wolff counts its clusters as "
                                         "its plain version")
    # Swendsen-Wang: classical (labels in shared memory) and space-time at
    # P = 40 with and without a bath (labels in device memory)
    for chains, slices, bath in ((CLUSTER_SA_READS, 1, False),
                                 (CLUSTER_QMC_READS, P, False),
                                 (4, P, True)):
        classical = slices == 1
        c, b, jp, teff = cluster_inputs(pg, dev, rng, chains, slices, steps,
                                        classical)
        table = lut if bath else None
        _build.reset_launches()
        out = ck.sw_anneal(pg, b, jp, teff, c, 22, table, 0, classical)
        launched = launched_now()
        ref = cl.sw_anneal_ref(pg, b, jp, teff, c, 22, table, 0, classical)
        record("fk_label", {"chains": chains, "slices": slices,
                            "bath": bath, "steps": steps,
                            "shared_memory": ck.label_smem(slices,
                                                           pg.nspins)},
               out, ref, c, launched, {"fk_label": 1})
    # the line phases, WC2 and WC3, 3 steps of both colors
    for per_slice_seeds in (False, True):
        c, b, jp, teff = cluster_inputs(pg, dev, rng, 16, P, 3)
        t_eff = float(teff[0])
        p_pair, p_t = ck.line_tables(lut, jp, t_eff, P, dev)
        out = ref = c
        _build.reset_launches()
        for t in range(3):
            for color in range(pg.num_colors):
                out = ck.line_phase(pg, b, jp, p_t, t, t_eff, lut, p_pair,
                                    out, 23, t, color, per_slice_seeds)
        launched = launched_now()
        for t in range(3):
            for color in range(pg.num_colors):
                ref = cl.line_phase_ref(pg, b[t], jp[t], t_eff, lut, ref,
                                        23, t, color, per_slice_seeds,
                                        p_pair)
        record("fk_line", {"chains": 16, "slices": P, "steps": 3,
                           "per_slice_seeds": per_slice_seeds}, out, ref,
               c, launched, {"fk_line": 3 * pg.num_colors})


def cluster_bound(kname, chains, slices, sites, degree, visited=None,
                  bath=False):
    """(least ms of one step, "bytes" or "operations", unit) of a cluster
    kernel at this shape, as the work needs it:
      fk_wolff  the bonds drawn from the `visited` (chains x per step)
                cluster sites, each shared by at most two of them: (degree
                + 2 + (P - 1 with a bath)) / 2 exponentials a site; bytes:
                each visited site read and written;
      fk_label  every bond of the graph drawn once: degree / 2 spatial, one
                Trotter (P > 1) and one ghost a site, an exponential each;
                bytes: the state read and written;
      fk_line   no exponential (the host's table holds the bath pairs'
                probabilities): a site's field (degree adds), its pair
                comparisons (P - 1), the cluster sum (P adds) as float32
                operations, one logarithm a slice (its accept); bytes: the
                state read and written.
    The exponentials and logarithms run at the special-function rate."""
    P = slices
    f32 = 0.0
    if kname == "fk_wolff":
        sfu = visited * (degree + 2 + (P - 1 if bath else 0)) / 2
        moved = visited * 8
    elif kname == "fk_label":
        sfu = chains * P * sites * (degree / 2 + (1 if P > 1 else 0) + 1)
        moved = chains * P * sites * 8
    else:
        f32 = chains * P * sites * (degree + (P - 1) + P)
        sfu = chains * P * sites
        moved = chains * P * sites * 8
    times = {"fp32": f32 / PEAK_FLOPS, "sfu": sfu / PEAK_SFU,
             "bytes": moved / PEAK_BYTES}
    unit = max(times, key=times.get)
    return 1e3 * times[unit], ("bytes" if unit == "bytes"
                               else "operations"), unit


def cluster_timing(dev, results, gtorus, power, name):
    """Slope ms a step of fk_wolff (one chain and 16, P = 40: the bench's
    two Wolff shapes), fk_label (the space-time sweep at the PIQMC solves'
    8 chains, P = 40, and the classical sweep at 64 chains) and fk_line (a
    WC3 and a WC2 step, both colors, one chain at P = 40: the bench's
    shape), and of their plain versions, beside each bound
    (`cluster_bound`); the kernels line takes the first row of each."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.ops import cluster as cl
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops

    pg = packed_ops.build_packed(gtorus)
    n = pg.nspins
    degree = graph_shape(gtorus)[0]
    rng = np.random.default_rng(8)
    P = CLUSTER_SLICES
    lut = schedules.bath_lookuptable(P, CLUSTER_ALPHA, device=dev)

    def wolff_runner(fn, chains):
        c = random_pm1(rng, (chains, P, n), dev)
        vis = torch.zeros(chains, dtype=torch.int64, device=dev)

        def run(tau):
            _, b, jp, teff = cluster_inputs(pg, dev, rng, 1, P, tau)
            vis.zero_()
            return fn(pg, b, jp, teff, c, 7, "local", None, 0, vis)
        return run, vis

    def label_runner(fn, chains, slices):
        c = random_pm1(rng, (chains, slices, n), dev)

        def run(tau):
            _, b, jp, teff = cluster_inputs(pg, dev, rng, 1, slices, tau,
                                            classical=slices == 1)
            return fn(pg, b, jp, teff, c, 7, None, 0, slices == 1)
        return run

    def line_runner(phase, per_slice_seeds):
        c = random_pm1(rng, (1, P, n), dev)

        def run(tau):
            _, b, jp, teff = cluster_inputs(pg, dev, rng, 1, P, tau)
            t_eff = float(teff[0])
            p_pair, p_t = ck.line_tables(lut, jp, t_eff, P, dev)
            x = c
            for t in range(tau):
                for color in range(pg.num_colors):
                    x = (phase(pg, b, jp, p_t, t, t_eff, lut, p_pair, x, 7,
                               t, color, per_slice_seeds)
                         if phase is ck.line_phase else
                         phase(pg, b[t], jp[t], t_eff, lut, x, 7, t, color,
                               per_slice_seeds, p_pair))
            return x
        return run

    rows = []
    for chains in (1, 16):
        run, vis = wolff_runner(ck.wolff_anneal, chains)
        rows.append(("fk_wolff", "cuda", run, (30, 90), 3, chains, P, vis))
    # the plain versions take 8-60 ms a step: taus far enough apart that
    # the host's jitter does not swamp the slope
    run_p, vis_p = wolff_runner(cl.wolff_anneal_ref, 1)
    rows.append(("fk_wolff", "plain", run_p, (2, 6), 2, 1, P, vis_p))
    for chains, slices in ((CLUSTER_QMC_READS, P), (CLUSTER_SA_READS, 1)):
        rows.append(("fk_label", "cuda", label_runner(ck.sw_anneal, chains,
                                                      slices),
                     (10, 30), 3, chains, slices, None))
        rows.append(("fk_label", "plain", label_runner(cl.sw_anneal_ref,
                                                       chains, slices),
                     (1, 4), 2, chains, slices, None))
    for per_slice_seeds in (True, False):
        rows.append(("fk_line", "cuda", line_runner(ck.line_phase,
                                                    per_slice_seeds),
                     (20, 80), 3, 1, P, per_slice_seeds))
        rows.append(("fk_line", "plain", line_runner(cl.line_phase_ref,
                                                     per_slice_seeds),
                     (2, 8), 2, 1, P, per_slice_seeds))
    for kname, route, run, taus, trials, chains, slices, extra in rows:
        ms, best = slope_ms(run, taus, trials)
        rec = {"phase": "timing", "kernel": kname, "route": route,
               "graph": f"gaussian_torus({L}, 0).to_generic()",
               "chains": chains, "slices": slices, "taus": list(taus),
               "best_seconds": {str(k): v for k, v in best.items()},
               "ms_per_step": ms}
        visited = None
        if kname == "fk_wolff":
            # the cluster sites of the last run, at the largest tau
            visited = float(extra.sum()) / max(taus)
            rec["mean_cluster_sites"] = visited / chains
        if kname == "fk_line":
            rec["per_slice_seeds"] = extra
            rec["launches_per_step"] = pg.num_colors
        bound, bound_by, unit = cluster_bound(kname, chains, slices, n,
                                              degree, visited)
        rec.update(bound_ms=bound, bound_by=bound_by, bound_unit=unit,
                   gpu=name, power_limit=power)
        emit(rec)
        check(ms > 0, f"{kname} {route} slope is positive")
        if "ms" not in results[kname] and route == "cuda":
            results[kname].update(ms=ms, bound_ms=bound, bound_by=bound_by)
        elif "plain_ms" not in results[kname] and route == "plain":
            results[kname]["plain_ms"] = ms


def cluster_bench(dev, problem):
    """Phase cluster_bench: bench/throughput.py's cluster arm
    (bench.py::_cluster_arm) in full, its four timings and exactly the
    launches its runs make: a warm run and two trials at each of two taus,
    fk_wolff once a run (unbatched and 16 chains), WC2 a generic bath
    launch and a fk_line launch a color a step, WC3 a fk_line launch a
    color a step."""
    from montecarlosolvers_tpu_torch.bench import throughput
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck

    t0 = time.perf_counter()
    rec = throughput.cluster_arm(problem)
    colors = ck.generic_form(problem).num_colors
    emit({"phase": "cluster_bench", **rec,
          "seconds": time.perf_counter() - t0,
          "nvidia_smi": throughput.nvidia_smi()})
    for key in ("wolff_cluster_ms", "wolff_cluster_ms_per_chain",
                "sw_bath_sweep_ms", "sw_full_sweep_ms"):
        check(np.isfinite(rec[key]) and rec[key] > 0, f"cluster bench {key}")
    steps = 3 * (10 + 30)  # a warm run and two trials at tau 10 and 30
    want = {"fk_wolff": 2 * 3 * 2, "generic_qmc_bath": steps,
            "fk_line": 2 * steps * colors}
    check(rec["launches"] == want,
          f"cluster bench launched {rec['launches']}, its route {want}")


# ---------------------------------------------------------------- samplers


def dense_bound(chains, n, block=DENSE_BLOCK):
    """The least ms of a dense sweep: its 2 C N^2 field operations and
    C N (B + 6) in-block ones over the float32 peak, C N logarithms over
    the special-function peak, or J read once and the spins read and
    written over 3.35 TB/s, the largest."""
    times = {"fp32": (2 * chains * n * n + chains * n * (block + 6))
             / PEAK_FLOPS,
             "sfu": chains * n / PEAK_SFU,
             "bytes": (n * n * 4 + 2 * chains * n * 4) / PEAK_BYTES}
    unit = max(times, key=times.get)
    return 1e3 * times[unit], ("bytes" if unit == "bytes"
                               else "operations"), unit


def houdayer_bound(pairs, n, maxnb):
    """(least ms of one Houdayer move, "bytes", unit): the table (maxnb
    int32 indices and float32 couplings a site) read once, both replicas
    read and written once and the counts written, over 3.35 TB/s. Its
    labelling is integer work whose amount depends on the overlap."""
    moved = n * maxnb * 8 + 4 * pairs * n * 4 + pairs * 4
    return 1e3 * moved / PEAK_BYTES, "bytes", "bytes"


def per_chain(values, chains):
    """A sampler's per-chain values: the ladder `values` repeated over
    `chains` chains (rungs x reads), float32, contiguous."""
    reps = -(-chains // values.shape[0])
    return values.repeat(reps)[:chains].contiguous()


def sampler_kernel_checks(dev, results, torus, gtorus, odd_torus, power,
                          name):
    """Phase sampler_kernels_vs_plain: the per-chain-schedule instantiations
    of kernels A and B (cluster and per-phase routes), of the packed SA,
    generic PIQMC and dense kernels against their plain versions on the
    card, a (steps, chains) table that repeats one row, as the samplers
    pass it, and one that changes every step; the packed kernels also on
    the 81x81 torus's checkerboard, a packing that is not proper; the
    step0 split of kernels A and B (two one-step launches at step0 0 and 1
    against one two-step launch, bitwise, shared and per chain). Then the
    timing of each per-chain instantiation beside the shared-schedule one
    at the same shape, and of its plain version."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.ops import dense_kernels as dk
    from montecarlosolvers_tpu_torch.ops import energy as energy_ops
    from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops
    from montecarlosolvers_tpu_torch.ops import split as split_ops
    from montecarlosolvers_tpu_torch.ops import split_kernels as sk

    gibbs = gibbs_tool()
    rng = np.random.default_rng(11)
    sl = split_ops.build_split(torus)
    ladder = schedules.geometric(PT_COLD, PT_HOT, PT_RUNGS, device=dev)
    gammas = schedules.linear(3.0, 0.3, QPT_CHAINS, device=dev)

    def tables(values, steps):
        """The row table the samplers pass, and one that changes every
        step."""
        row = values[None, :].expand(steps, -1)
        scale = torch.linspace(1.0, 0.5, steps, device=dev)[:, None]
        return {"row": row, "every_step": (row * scale).contiguous()}

    def record(kname, case, out, ref, start, launched, want):
        torch.cuda.synchronize()
        out = out if isinstance(out, (tuple, list)) else (out,)
        ref = ref if isinstance(ref, (tuple, list)) else (ref,)
        start = start if isinstance(start, (tuple, list)) else (start,)
        n_bad, err = mismatches(out, ref)
        moved = float(sum(int((o != s).sum()) for o, s in zip(out, start))
                      / sum(o.numel() for o in out))
        rec = {"phase": "sampler_kernels_vs_plain", "kernel": kname, **case,
               "launches": launched, "mismatched_spins": n_bad,
               "max_abs_err": err, "flipped_fraction": moved}
        emit(rec)
        check(n_bad == 0, f"{kname} ({case}) equals its plain version")
        check(moved > 0, f"{kname} ({case}) moves")
        check(launched == want, f"{kname} ({case}) launched {launched}, "
                                f"want {want}")
        results[kname]["max_abs_err"] = max(
            results[kname].get("max_abs_err", 0.0), err)

    # kernel A: the PT ladder's 48 rungs x 8 reads (8 chains a word), 1000
    # chains (31 words of 32 and a ragged last word of 8, which must read
    # only its own chains' temperatures) and 33 (one a word) on the cluster
    # route; 33 chains on the per-phase kernel
    steps = SAMPLER_STEPS
    for chains, route in ((PT_RUNGS * PT_READS, "cluster"),
                          (1000, "cluster"), (33, "cluster"),
                          (33, "phased")):
        a, b = (x.contiguous() for x in split_ops.pack_classical(
            sl, random_pm1(rng, (chains, L * L), dev)))
        temps = per_chain(ladder, chains)
        kinds = tables(temps, steps)
        if chains != PT_RUNGS * PT_READS:
            kinds.pop("every_step")
        ctx = gibbs.phased_route if route == "phased" else \
            contextlib.nullcontext
        key = "sa_split_chain" + ("_phased" if route == "phased" else "")
        for kind, tab in kinds.items():
            _build.reset_launches()
            with ctx():
                out = sk.sa_split_anneal(sl, tab, a, b, 31)
            launched = launched_now()
            ref = sk.sa_split_anneal_ref(sl, tab, a, b, 31)
            record("split_sa" + key[8:], {"lattice": f"gaussian_torus({L}, "
                                          "0)", "chains": chains,
                                          "route": route, "table": kind,
                                          "steps": steps},
                   out, ref, (a, b), launched,
                   {key: 2 * steps if route == "phased" else 1})

    # kernel B: 32 chains of distinct Gamma at P = 40, global moves, both
    # routes (the per-phase kernels at 4 chains)
    teff = 1.0 * QMC_SLICES / QMC_SLICES
    qsteps = SAMPLER_QMC_STEPS
    for chains, route in ((QPT_CHAINS, "cluster"), (4, "phased")):
        quarters = tuple(q.contiguous() for q in split_ops.pack_qmc(
            sl, random_pm1(rng, (chains, QMC_SLICES, L * L), dev)))
        jp = schedules.jperp(per_chain(gammas, chains), teff).contiguous()
        b_sched = torch.ones(qsteps, device=dev)
        ctx = gibbs.phased_route if route == "phased" else \
            contextlib.nullcontext
        key = "qmc_split_chain" + ("_phased" if route == "phased" else "")
        for kind, tab in tables(jp, qsteps).items():
            _build.reset_launches()
            with ctx():
                out = sk.qmc_split_anneal(sl, b_sched, tab, teff, quarters,
                                          32, True)
            launched = launched_now()
            ref = sk.qmc_split_anneal_ref(sl, b_sched, tab, teff, quarters,
                                          32, True)
            record("split_qmc" + key[9:], {
                "lattice": f"gaussian_torus({L}, 0)", "chains": chains,
                "slices": QMC_SLICES, "route": route, "table": kind,
                "steps": qsteps}, out, ref, quarters, launched,
                {key: 4 * qsteps if route == "phased" else 1})

    # the step0 split: two one-step launches against one two-step launch
    a, b = (x.contiguous() for x in split_ops.pack_classical(
        sl, random_pm1(rng, (PT_RUNGS * PT_READS, L * L), dev)))
    temps = per_chain(ladder, a.shape[0])
    quarters = tuple(q.contiguous() for q in split_ops.pack_qmc(
        sl, random_pm1(rng, (QPT_CHAINS, QMC_SLICES, L * L), dev)))
    jp = schedules.jperp(gammas, teff).contiguous()
    ones = torch.ones(2, device=dev)
    for kname, shared, run in (
            ("split_sa", True,
             lambda s, n, t0: sk.sa_split_anneal(
                 sl, torch.full((n,), 1.2, device=dev), *s, 33, step0=t0)),
            ("split_sa", False,
             lambda s, n, t0: sk.sa_split_anneal(
                 sl, temps[None, :].expand(n, -1), *s, 33, step0=t0)),
            ("split_qmc", True,
             lambda s, n, t0: sk.qmc_split_anneal(
                 sl, ones[:n], jp[:1].expand(n).contiguous(), teff, s, 34,
                 True, step0=t0)),
            ("split_qmc", False,
             lambda s, n, t0: sk.qmc_split_anneal(
                 sl, ones[:n], jp[None, :].expand(n, -1), teff, s, 34, True,
                 step0=t0))):
        start = (a, b) if kname == "split_sa" else quarters
        whole = run(start, 2, 0)
        split = run(run(start, 1, 0), 1, 1)
        torch.cuda.synchronize()
        n_bad, _ = mismatches(whole, split)
        n_same, _ = mismatches(run(start, 1, 0), run(start, 1, 1))
        emit({"phase": "sampler_kernels_vs_plain", "kernel": kname,
              "check": "step0_split", "shared_schedule": shared,
              "mismatched_spins": n_bad,
              "step0_changes_the_draws": n_same > 0})
        check(n_bad == 0, f"{kname} step0 splits a run bitwise "
                          f"(shared {shared})")
        check(n_same > 0, f"{kname}: step0 1 draws other uniforms")

    # the energy kernel on kernel A's chain-bit words, what the samplers'
    # split engine reads at each exchange: pt_value's 384 chains and
    # solve("pt")'s 7040 on the 80x80 torus, against the energy kernel on
    # the unpacked halves (bitwise) and the plain version (within
    # ENERGY_RTOL x sum |J|); ms a call beside the halves' kernel and the
    # bound (the words, the couplings and the energies moved once)
    tol = gibbs.ENERGY_RTOL * float(torus.j_right.abs().sum()
                                    + torus.j_down.abs().sum()
                                    + torus.h_plane.abs().sum())
    for chains in (PT_RUNGS * PT_READS, PT_AUTO_RUNGS * PT_SOLVE_READS):
        a, b = (x.contiguous() for x in split_ops.pack_classical(
            sl, random_pm1(rng, (chains, L * L), dev)))
        C = sk.words_geometry(sl, chains, dev)[0]
        words = (sk.pack_chain_bits(a, C), sk.pack_chain_bits(b, C))
        _build.reset_launches()
        e = sk.words_energy(sl, *words, chains, C)
        launched = launched_now()
        same = torch.equal(e, energy_ops.halves_energy(sl, a, b))
        err = float((e - sk.words_energy_ref(sl, *words, chains, C)).abs()
                    .max())
        ms = event_ms(lambda: sk.words_energy(sl, *words, chains, C), 200)
        halves_ms = event_ms(lambda: energy_ops.halves_energy(sl, a, b),
                             200)
        plain_ms = event_ms(lambda: sk.words_energy_ref(sl, *words, chains,
                                                        C), 5)
        nbytes = (2 * words[0].numel() * 4
                  + (sl.nslots * 2 + 2) * sl.nh * 4 + chains * 4)
        bound = 1e3 * nbytes / PEAK_BYTES
        emit({"phase": "sampler_kernels_vs_plain",
              "kernel": "energy_chain_bits", "chains": chains,
              "chains_a_word": C, "launches": launched,
              "equals_halves_kernel": same, "max_abs_err": err,
              "tolerance": tol, "ms": ms, "halves_kernel_ms": halves_ms,
              "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
              "bytes": nbytes, "gpu": name, "power_limit": power})
        what = f"energy_chain_bits at {chains} chains"
        check(same, f"{what} equals the energy kernel on the halves")
        check(err <= tol, f"{what} within {tol} of its plain version")
        check(launched == {"energy_bits": 1}, f"{what} launched {launched}")
        results["energy_chain_bits"]["max_abs_err"] = max(
            results["energy_chain_bits"].get("max_abs_err", 0.0), err)
        if "ms" not in results["energy_chain_bits"]:
            results["energy_chain_bits"].update(
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes")

    # the packed SA kernel: the 80x80 torus's generic form (PT's 384
    # chains), and the 81x81 torus's checkerboard (not proper), per chain
    # and shared
    for gname, pg, chains in (
            (f"gaussian_torus({L}, 0).to_generic()",
             packed_ops.build_packed(gtorus), PT_RUNGS * PT_READS),
            (f"gaussian_torus({ODD_L}, 0) checkerboard",
             packed_ops.packed_from_lattice(odd_torus), 64)):
        s = random_pm1(rng, (chains, pg.nspins), dev)
        temps = per_chain(ladder, chains)
        cases = [("row", temps[None, :].expand(steps, -1), "packed_sa_chain"),
                 ("every_step", tables(temps, steps)["every_step"],
                  "packed_sa_chain")]
        if not pg.proper:
            cases.append(("shared", schedules.linear(3.0, 0.1, steps,
                                                     device=dev),
                          "packed_sa"))
        for kind, tab, key in cases:
            _build.reset_launches()
            out = gk.packed_sa_anneal(pg, tab, s, 35)
            launched = launched_now()
            ref = gk.packed_sa_anneal_ref(pg, tab, s, 35)
            record("packed_sa_chain" if key == "packed_sa_chain"
                   else "packed_sa", {"graph": gname, "chains": chains,
                                      "proper": pg.proper, "table": kind,
                                      "steps": steps},
                   out, ref, s, launched, {key: 1})

    # the generic PIQMC kernel: P = 40 on the torus's generic form, P = 5
    # on the 81x81 checkerboard, global moves, per chain and shared
    for gname, pg, slices, chains in (
            (f"gaussian_torus({L}, 0).to_generic()",
             packed_ops.build_packed(gtorus), QMC_SLICES, 8),
            (f"gaussian_torus({ODD_L}, 0) checkerboard",
             packed_ops.packed_from_lattice(odd_torus), ODD_SLICES, 8)):
        c = random_pm1(rng, (chains, slices, pg.nspins), dev)
        jpc = schedules.jperp(per_chain(gammas, chains), teff).contiguous()
        b_sched = torch.ones(GENERIC_QMC_STEPS, device=dev)
        cases = [("row", jpc[None, :].expand(GENERIC_QMC_STEPS, -1),
                  "generic_qmc_chain")]
        if not pg.proper:
            cases.append(("shared", schedules.jperp(schedules.transverse_field(
                3.0, 0.3, GENERIC_QMC_STEPS, device=dev), teff).contiguous(),
                "generic_qmc"))
        for kind, tab, key in cases:
            _build.reset_launches()
            out = gk.generic_qmc_anneal(pg, b_sched, tab, teff, c, 36, True)
            launched = launched_now()
            ref = gk.generic_qmc_anneal_ref(pg, b_sched, tab, teff, c, 36,
                                            True)
            record(key, {"graph": gname, "chains": chains, "slices": slices,
                         "proper": pg.proper, "table": kind,
                         "steps": GENERIC_QMC_STEPS},
                   out, ref, c, launched, {key: 1})

    # the dense kernel: sk_model(2048, rng=0), 64 chains of a ladder
    skp = instances.sk_model(DENSE_N, rng=0, device=dev)[0]
    s = random_pm1(rng, (DENSE_PT_CHAINS, DENSE_N), dev)
    dtemps = per_chain(schedules.geometric(0.3, 2.0, 16, device=dev),
                       DENSE_PT_CHAINS)
    tab = dtemps[None, :].expand(DENSE_STEPS, -1)
    _build.reset_launches()
    out = dk.dense_sa_anneal(skp, tab, s, 37, DENSE_BLOCK)
    launched = launched_now()
    ref = dk.dense_sa_anneal_ref(skp, tab, s, 37, DENSE_BLOCK)
    record("dense_sa_chain", {"problem": f"sk_model({DENSE_N}, rng=0)",
                              "chains": DENSE_PT_CHAINS,
                              "steps": DENSE_STEPS},
           out, ref, s, launched,
           {"dense_sa_chain": DENSE_STEPS * -(-DENSE_N // DENSE_BLOCK)})

    # timing: each per-chain instantiation beside the shared one, and its
    # plain version, ms per sweep (slope over two schedule lengths)
    pg80 = packed_ops.build_packed(gtorus)
    graph = graph_shape(gtorus)
    nh = sl.nh

    def sa_runner(fn, chains, per, ctx=contextlib.nullcontext):
        a, b = (x.contiguous() for x in split_ops.pack_classical(
            sl, random_pm1(rng, (chains, L * L), dev)))
        temps = per_chain(ladder, chains)

        def run(tau):
            tab = (temps[None, :].expand(tau, -1) if per else
                   schedules.linear(3.0, 0.1, tau, device=dev))
            with ctx():
                return fn(sl, tab, a, b, 7)
        return run

    def qmc_runner(fn, chains, per, ctx=contextlib.nullcontext):
        q = tuple(x.contiguous() for x in split_ops.pack_qmc(
            sl, random_pm1(rng, (chains, QMC_SLICES, L * L), dev)))
        jpc = schedules.jperp(per_chain(gammas, chains), teff).contiguous()

        def run(tau):
            tab = (jpc[None, :].expand(tau, -1) if per else schedules.jperp(
                schedules.transverse_field(3.0, 1e-8, tau, device=dev),
                teff).contiguous())
            with ctx():
                return fn(sl, torch.ones(tau, device=dev), tab, teff, q, 7,
                          True)
        return run

    def packed_runner(fn, chains, per):
        s = random_pm1(rng, (chains, L * L), dev)
        temps = per_chain(ladder, chains)
        return lambda tau: fn(pg80, temps[None, :].expand(tau, -1) if per
                              else schedules.linear(3.0, 0.1, tau,
                                                    device=dev), s, 7)

    def gqmc_runner(fn, chains, per):
        c = random_pm1(rng, (chains, QMC_SLICES, L * L), dev)
        jpc = schedules.jperp(per_chain(gammas, chains), teff).contiguous()
        return lambda tau: fn(pg80, torch.ones(tau, device=dev), jpc[
            None, :].expand(tau, -1) if per else schedules.jperp(
                schedules.transverse_field(3.0, 1e-8, tau, device=dev),
                teff).contiguous(), teff, c, 7, True)

    def dense_runner(fn, chains, per):
        s = random_pm1(rng, (chains, DENSE_N), dev)
        temps = per_chain(dtemps, chains)
        return lambda tau: fn(skp, temps[None, :].expand(tau, -1) if per
                              else schedules.linear(3.0, 0.1, tau,
                                                    device=dev), s, 7,
                              DENSE_BLOCK)

    na = PT_RUNGS * PT_READS
    phased = gibbs.phased_route
    rows = [
        # (kernel, runner(fn, per), chains, slices, taus, plain taus, bound)
        ("split_sa_chain", lambda fn, per: sa_runner(fn, na, per), na, 1,
         (100, 400), (2, 8), bound_ms("split_sa", na, 1, 2 * nh, 400),
         sk.sa_split_anneal, sk.sa_split_anneal_ref),
        ("split_sa_chain_phased",
         lambda fn, per: sa_runner(fn, 33, per, phased), 33, 1, (20, 80),
         (2, 8), bound_ms("split_sa", 33, 1, 2 * nh, 80),
         sk.sa_split_anneal, sk.sa_split_anneal_ref),
        ("split_qmc_chain",
         lambda fn, per: qmc_runner(fn, QPT_CHAINS, per), QPT_CHAINS,
         QMC_SLICES, (50, 200), (1, 3),
         bound_ms("split_qmc", QPT_CHAINS, QMC_SLICES, 2 * nh, 200),
         sk.qmc_split_anneal, sk.qmc_split_anneal_ref),
        ("split_qmc_chain_phased",
         lambda fn, per: qmc_runner(fn, 4, per, phased), 4, QMC_SLICES,
         (10, 40), (1, 3), bound_ms("split_qmc", 4, QMC_SLICES, 2 * nh, 40),
         sk.qmc_split_anneal, sk.qmc_split_anneal_ref),
        ("packed_sa_chain", lambda fn, per: packed_runner(fn, na, per), na,
         1, (50, 200), (2, 8),
         bound_ms("packed_sa", na, 1, L * L, 200, graph),
         gk.packed_sa_anneal, gk.packed_sa_anneal_ref),
        ("generic_qmc_chain",
         lambda fn, per: gqmc_runner(fn, QPT_CHAINS, per), QPT_CHAINS,
         QMC_SLICES, (10, 40), (1, 2),
         bound_ms("generic_qmc", QPT_CHAINS, QMC_SLICES, L * L, 40, graph),
         gk.generic_qmc_anneal, gk.generic_qmc_anneal_ref),
        ("dense_sa_chain",
         lambda fn, per: dense_runner(fn, DENSE_PT_CHAINS, per),
         DENSE_PT_CHAINS, 1, (4, 16), (1, 2),
         dense_bound(DENSE_PT_CHAINS, DENSE_N),
         dk.dense_sa_anneal, dk.dense_sa_anneal_ref),
    ]
    for kname, runner, chains, slices, taus, ptaus, bound, fn, plain in rows:
        # shared, per chain, per chain, shared: the two in turns
        ms = {"shared": [], "per_chain": []}
        for per in (False, True, True, False):
            ms["per_chain" if per else "shared"].append(
                slope_ms(runner(fn, per), taus, 3)[0])
        plain_ms = slope_ms(runner(plain, True), ptaus, 2)[0]
        chain_ms = float(np.mean(ms["per_chain"]))
        shared_ms = float(np.mean(ms["shared"]))
        emit({"phase": "timing", "kernel": kname, "chains": chains,
              "slices": slices, "taus": list(taus),
              "ms_per_sweep": chain_ms, "ms_per_chain_runs": ms["per_chain"],
              "shared_schedule_ms": shared_ms,
              "shared_schedule_runs": ms["shared"],
              "per_chain_over_shared": chain_ms / shared_ms,
              "plain_ms": plain_ms, "bound_ms": bound[0],
              "bound_by": bound[1], "bound_unit": bound[2], "gpu": name,
              "power_limit": power})
        check(chain_ms > 0 and shared_ms > 0, f"{kname} slopes positive")
        results[kname].update(ms=chain_ms, plain_ms=plain_ms,
                              bound_ms=bound[0], bound_by=bound[1])


def houdayer_checks(dev, results, gtorus, power, name):
    """Phase houdayer_vs_plain: csrc/houdayer.cu against
    cluster.houdayer_move_ref on the card, bitwise (spins and flipped
    counts), on the 80x80 torus's generic form (48 pairs: pt_value's
    rungs) and on the 3-D +/-J glass random_3d_lattice(12, rng=0) (24
    pairs: icm_value's rungs), from random replicas; the move keeps each
    pair's overlap q and E1 + E2 (float64); ms a move beside the bound
    and the plain version."""
    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.ops import cluster as cl
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck

    rng = np.random.default_rng(12)
    glass = instances.random_3d_lattice(12, rng=0, device=dev)[0]
    for gname, prob, pairs in (
            (f"gaussian_torus({L}, 0).to_generic()", gtorus, PT_RUNGS),
            ("random_3d_lattice(12, rng=0)", glass, ICM_RUNGS)):
        n = prob.nspins
        s1, s2 = (random_pm1(rng, (pairs, n), dev) for _ in range(2))
        _build.reset_launches()
        a, b, f = ck.houdayer_move(prob, s1, s2, 41, 7)
        launched = launched_now()
        ra, rb, rf = cl.houdayer_move_ref(prob, s1, s2, 41, 7)
        torch.cuda.synchronize()
        n_bad, err = mismatches((a, b), (ra, rb))
        e0 = energy64(prob, s1.cpu().numpy()) + energy64(prob,
                                                         s2.cpu().numpy())
        e1 = energy64(prob, a.cpu().numpy()) + energy64(prob,
                                                        b.cpu().numpy())
        scale = float(prob.nbr_J.abs().sum() + prob.h.abs().sum())
        rec = {"phase": "houdayer_vs_plain", "graph": gname, "nspins": n,
               "pairs": pairs, "launches": launched,
               "mismatched_spins": n_bad, "max_abs_err": err,
               "flips_equal": bool(torch.equal(f, rf)),
               "flipped_fraction": float(f.sum()) / (pairs * n),
               "overlap_kept": bool(torch.equal(a * b, s1 * s2)),
               "max_energy_sum_change": float(np.abs(e1 - e0).max()),
               "energy_scale": scale}
        ms = event_ms(lambda: ck.houdayer_move(prob, s1, s2, 41, 7), 50)
        plain_ms = event_ms(lambda: cl.houdayer_move_ref(prob, s1, s2, 41,
                                                         7), 2)
        bound, bound_by, unit = houdayer_bound(pairs, n,
                                               int(prob.nbr_idx.shape[1]))
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                   bound_by=bound_by, gpu=name, power_limit=power)
        emit(rec)
        what = f"houdayer on {gname}, {pairs} pairs"
        check(n_bad == 0 and rec["flips_equal"],
              f"{what} equals its plain version")
        check(rec["flipped_fraction"] > 0, f"{what} flips")
        check(rec["overlap_kept"], f"{what} keeps the overlap")
        check(rec["max_energy_sum_change"] <= 1e-9 * scale,
              f"{what} keeps E1 + E2")
        check(launched == {"houdayer": 1}, f"{what} launched {launched}")
        results["houdayer"]["max_abs_err"] = max(
            results["houdayer"].get("max_abs_err", 0.0), err)
        if "ms" not in results["houdayer"]:
            results["houdayer"].update(ms=ms, plain_ms=plain_ms,
                                       bound_ms=bound, bound_by=bound_by)


def sampler_bitwise_checks(dev):
    """Phase sampler_kernels_vs_plain, whole samplers: pt.sample,
    sample_piqmc and sample_icm and pa.sample, sample_adaptive,
    sample_piqmc and sample_piqmc_adaptive run on the card twice from the
    same generator seed, on the kernels and on their plain versions
    (gibbs_check.plain_route), at small widths; states, swap and Houdayer
    rates, log_z and stats bitwise equal. The split engines' energies come
    from the energy kernel on the one run and from torch on the other, so
    their problems have +/-1 couplings, where every energy is an exact
    integer; the packed and dense engines take torch's energies on both,
    so a Gaussian torus (the 9x9 one, a packing that is not proper) and an
    SK problem serve there."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.solvers import pa, pt

    gibbs = gibbs_tool()
    pm1 = instances.random_2d_lattice(16, rng=0, dist="pm1", lattice=True,
                                      device=dev)[0]
    glass = instances.random_3d_lattice(4, rng=0, device=dev)[0]
    odd = instances.gaussian_torus(9, seed=0, device=dev)
    skp = instances.sk_model(256, rng=0, device=dev)[0]
    ladder = schedules.geometric(0.5, 2.5, 8, device=dev)
    gam = schedules.geometric(0.5, 3.0, 6, device=dev)

    def states(seed, shape):
        g = torch.Generator().manual_seed(seed)
        return (torch.randint(0, 2, shape, generator=g).float() * 2 - 1).to(
            dev)

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    cases = (
        ("pt.sample, 16x16 +/-1 lattice (kernel A)", lambda: pt.sample(
            pm1, ladder, states(1, (2, 8, 256)), gen(1), 60,
            per_pair_rates=True)),
        ("pt.sample, 9x9 torus checkerboard (packed SA)", lambda: pt.sample(
            odd, ladder, states(2, (8, 81)), gen(2), 40, swap_every=2,
            collect_energy=True)),
        ("pt.sample, sk_model(256) (dense)", lambda: pt.sample(
            skp, ladder, states(3, (8, 256)), gen(3), 10)),
        ("pt.sample_piqmc, 16x16 +/-1 lattice, P = 4 (kernel B)",
         lambda: pt.sample_piqmc(pm1, gam, 0.25, states(4, (6, 4, 256)),
                                 gen(4), 30, global_moves=True,
                                 per_pair_rates=True)),
        ("pt.sample_piqmc, random_3d_lattice(4), P = 3 (generic PIQMC)",
         lambda: pt.sample_piqmc(glass, gam, 1 / 3, states(5, (6, 3, 64)),
                                 gen(5), 30, global_moves=True)),
        ("pt.sample_icm, random_3d_lattice(4) (packed SA, Houdayer)",
         lambda: pt.sample_icm(glass, ladder[:6], states(6, (2, 2, 6, 64)),
                               gen(6), 40, swap_every=2)),
        ("pt.sample_icm, 16x16 +/-1 lattice (kernel A, Houdayer)",
         lambda: pt.sample_icm(pm1, ladder[:6], states(7, (2, 6, 256)),
                               gen(7), 30)),
        ("pa.sample, 16x16 +/-1 lattice (kernel A)", lambda: pa.sample(
            pm1, pa.beta_linear(2.0, 60, device=dev), states(8, (128, 256)),
            gen(8), beta0=0.0, collect_stats=True)),
        ("pa.sample multinomial, random_3d_lattice(4) (packed SA)",
         lambda: pa.sample(glass, pa.beta_linear(2.0, 40, device=dev),
                           states(9, (128, 64)), gen(9), mcsteps=2,
                           beta0=0.0, resample="multinomial",
                           collect_stats=True)),
        ("pa.sample_adaptive, 16x16 +/-1 lattice (kernel A)",
         lambda: pa.sample_adaptive(pm1, 2.0, states(10, (128, 256)),
                                    gen(10), max_steps=100)),
        ("pa.sample_piqmc, 16x16 +/-1 lattice, P = 4 (kernel B)",
         lambda: pa.sample_piqmc(pm1, schedules.transverse_field(
             2.5, 0.2, 30, device=dev), 0.25, states(11, (64, 4, 256)),
             gen(11), global_moves=True, collect_stats=True)),
        ("pa.sample_piqmc_adaptive, random_3d_lattice(4), P = 3",
         lambda: pa.sample_piqmc_adaptive(glass, 2.5, 0.2, 1 / 3,
                                          states(12, (64, 3, 64)), gen(12),
                                          max_steps=60, global_moves=True)),
    )

    def flat(out):
        if isinstance(out, dict):
            return [v for k in sorted(out) for v in flat(out[k])]
        if isinstance(out, (tuple, list)):
            return [v for x in out for v in flat(x)]
        if torch.is_tensor(out):
            return [out]
        return [torch.as_tensor(np.asarray(out, dtype=np.float64))]

    for what, run in cases:
        kernel = flat(run())
        with gibbs.plain_route():
            plain = flat(run())
        torch.cuda.synchronize()
        same = len(kernel) == len(plain) and all(
            k.shape == p.shape and torch.equal(k.cpu(), p.cpu())
            for k, p in zip(kernel, plain))
        emit({"phase": "sampler_kernels_vs_plain", "sampler": what,
              "outputs": len(kernel), "bitwise_equal": same})
        check(same, f"{what}: kernels and plain versions agree bitwise")


def sampler_solves(dev, main_launches, torus, power, name):
    """Phase sampler_solves: the four sampler methods and pt.sample at full
    width through the public entry points, each with the counts set to 0
    just before it and read just after (its exact launches), and its mean
    energy per spin in the range around its JAX CPU anchor
    (tools/sampler_anchors.py)."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.solvers import pt
    from montecarlosolvers_tpu_torch.solvers.api import solve

    glass = instances.random_3d_lattice(12, rng=0, device=dev)[0]
    gname80 = f"gaussian_torus({L}, 0)"

    def pt_sample():
        gen = torch.Generator().manual_seed(0)
        s0 = (torch.randint(0, 2, (PT_RUNGS, L * L), generator=gen).float()
              * 2 - 1).to(dev)
        ladder = pt.geometric_ladder(PT_COLD, PT_HOT, PT_RUNGS, device=dev)
        out, rate, es = pt.sample(torus, ladder, s0, gen, PT_SWEEPS,
                                  swap_every=PT_SWAP, collect_energy=True)
        value = float(es[PT_SWEEPS // 2:, 0].double().mean()) / (L * L)
        return out, {"swap_rate": float(rate)}, value

    def solved(prob, method, **kw):
        def run():
            ss = solve(prob, method, seed=0, **kw)
            value = float(np.mean(ss.energies)) / prob.nspins
            check(np.allclose(ss.energies, energy64(prob, ss.samples),
                              rtol=1e-5, atol=1e-3),
                  f"{method} energies equal a float64 recomputation")
            return ss.samples, ss.info, value
        return run

    def qpt_sample(prob, rungs, slices, sweeps):
        def run():
            gen = torch.Generator().manual_seed(0)
            confs = (torch.randint(0, 2, (rungs, slices, prob.nspins),
                                   generator=gen).float() * 2 - 1).to(dev)
            gammas = schedules.geometric(1.5, 0.3, rungs, device=dev)
            out, rate = pt.sample_piqmc(prob, gammas, 1.0 / slices, confs,
                                        gen, sweeps, swap_every=2,
                                        global_moves=True)
            value = float(prob.energy(out[-1]).double().mean()) / prob.nspins
            return out, {"swap_rate": float(rate)}, value
        return run

    skp = instances.sk_model(DENSE_N, rng=0, device=dev)[0]

    def pa_launches(info, steps):
        n = info.get("n_steps", steps)
        return {"sa_split": n, "energy_bits": n}

    cases = (
        ("pt_sample", gname80, pt_sample,
         lambda info: {"sa_split_chain": PT_SWEEPS,
                       "energy_bits": PT_SWEEPS}),
        ("pt", gname80, solved(torus, "pt", num_reads=PT_SOLVE_READS,
                               sweeps=PT_SOLVE_SWEEPS),
         lambda info: {"sa_split_chain": PT_SOLVE_SWEEPS,
                       "energy_bits": PT_SOLVE_SWEEPS}),
        # a launch a sweep up to each exchange, every second sweep, and one
        # for the last
        ("qpt_sample", gname80,
         qpt_sample(torus, QPT_RUNGS, QPT_SLICES, QPT_SWEEPS),
         lambda info: {"qmc_split_chain": QPT_SWEEPS // 2 + 1}),
        ("qpt_generic", "random_3d_lattice(12, rng=0)",
         qpt_sample(glass, QPT_GENERIC_RUNGS, QPT_GENERIC_SLICES,
                    QPT_GENERIC_SWEEPS),
         lambda info: {"generic_qmc_chain": QPT_GENERIC_SWEEPS // 2 + 1}),
        ("pt_dense", f"sk_model({DENSE_N}, rng=0)",
         solved(skp, "pt", num_reads=PT_DENSE_READS,
                sweeps=PT_DENSE_SWEEPS),
         lambda info: {"dense_sa_chain": PT_DENSE_SWEEPS
                       * -(-DENSE_N // DENSE_BLOCK)}),
        ("icm", "random_3d_lattice(12, rng=0)",
         solved(glass, "icm", num_reads=ICM_READS, sweeps=ICM_SWEEPS,
                ladder=ICM_RUNGS),
         lambda info: {"packed_sa_chain": ICM_SWEEPS // 2 + 1,
                       "houdayer": ICM_SWEEPS // 2}),
        ("pa", gname80, solved(torus, "pa", num_reads=PA_READS,
                               sweeps=PA_SWEEPS),
         lambda info: pa_launches(info, PA_SWEEPS)),
        ("pa_adaptive", gname80,
         solved(torus, "pa", num_reads=PA_READS, sweeps=PA_ADAPTIVE_STEPS,
                adaptive=True, beta_end=PA_ADAPTIVE_BETA),
         lambda info: pa_launches(info, PA_ADAPTIVE_STEPS)),
        ("paq", gname80, solved(torus, "paq", num_reads=PAQ_READS,
                                sweeps=PAQ_SWEEPS, slices=PAQ_SLICES),
         lambda info: {"qmc_split": PAQ_SWEEPS}),
    )
    for key, lname, run, needs in cases:
        _build.reset_launches()
        t0 = time.perf_counter()
        samples, info, value = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = launched_now()
        for k, v in launched.items():
            main_launches[k] += v
        samples = np.asarray(samples.cpu() if torch.is_tensor(samples)
                             else samples)
        check(set(np.unique(samples)) <= {-1.0, 1.0}, f"{key} spins +/-1")
        check(np.isfinite(value), f"{key} finite")
        lo, hi = RANGES[key]
        rec = {"phase": "sampler_solves", "path": key, "problem": lname,
               "seconds": secs, "mean_energy_per_spin": value,
               "range": [lo, hi], "anchor": SAMPLER_ANCHORS[key],
               "info": {k: v for k, v in info.items()
                        if isinstance(v, (int, float, bool, str))},
               "launches": launched, "gpu": name, "power_limit": power}
        emit(rec)
        check(lo <= value <= hi, f"{key} mean {value} inside [{lo}, {hi}]")
        want = needs(info)
        check(launched == want, f"{key} launched {launched}, its route "
                                f"{want}")
        if key == "pt":
            check(info["ladder"] == PT_AUTO_RUNGS,
                  f"pt auto ladder {info['ladder']}")
        if key in ("pa", "pa_adaptive"):
            check(np.isfinite(info["log_z"]), f"{key} log_z finite")
        if key == "pa_adaptive":
            check(info["reached"], "pa_adaptive reached beta_end")


def main():
    t_script = time.perf_counter()
    phase_seconds = {}
    check(torch.cuda.is_available(), "torch.cuda.is_available()")
    # the dense engine's kernel equals its plain version bitwise only when
    # both take their block fields from full-float32 products
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "float32 matmuls run in full float32 (no TF32)")
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
    power = smi.split(",")[-1].strip() if "," in smi else smi
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": name})
    phase_seconds["device"] = time.perf_counter() - t_script

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
    odd_open = instances.random_2d_lattice(ODD_L, rng=0, lattice=True,
                                           device=dev)[0]
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
    phase_seconds["build_and_clusters"] = time.perf_counter() - t_script

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
    open80 = instances.random_2d_lattice(L, rng=0, lattice=True,
                                         device=dev)[0]
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
    phase_seconds["lattice_vs_plain"] = time.perf_counter() - t_script

    # ---- the generic kernels (IsingProblem) against their plain versions
    graphs = generic_graphs(dev)
    generic_checks(dev, results, graphs)
    phase_seconds["generic_kernel_vs_plain"] = time.perf_counter() - t_script

    # ---- the bath kernels (generic, kernel 5's colored template) against
    # their plain versions
    bproblems = bath_problems(dev, graphs, torus, odd_torus)
    bath_checks(dev, results, bproblems)
    phase_seconds["bath_kernel_vs_plain"] = time.perf_counter() - t_script

    # ---- the dense engine and the noisy kernels against their plain
    # versions
    sk_problem = dense_checks(dev, results)
    gtorus80 = graphs[f"gaussian_torus({L}, 0).to_generic()"]
    tables = noisy_tables(gtorus80, dev)
    noisy_checks(dev, results, gtorus80, tables)
    phase_seconds["dense_noisy_vs_plain"] = time.perf_counter() - t_script

    # ---- the cluster kernels against their plain versions
    cluster_checks(dev, results, gtorus80)
    phase_seconds["cluster_kernel_vs_plain"] = time.perf_counter() - t_script

    # ---- the samplers' kernels against their plain versions: the per-chain
    # instantiations, the Houdayer kernel, the whole samplers on both
    sampler_kernel_checks(dev, results, torus, gtorus80, odd_torus, power,
                          name)
    houdayer_checks(dev, results, gtorus80, power, name)
    sampler_bitwise_checks(dev)
    phase_seconds["sampler_kernels_vs_plain"] = time.perf_counter() - t_script

    # ---- main path through solve(), launch counts read around each solve
    try:
        problem, e_gs = instances.santoro_80x80(lattice=True, device=dev)
        gproblem = instances.santoro_80x80(device=dev)[0]
        lattice = "santoro_80x80"
    except FileNotFoundError:
        problem, e_gs = torus, None
        gproblem = graphs[f"gaussian_torus({L}, 0).to_generic()"]
        lattice = "gaussian_torus(80, seed=0)"
    glattice = f"{lattice}, generic (maxnb {gproblem.maxnb})"
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

    def colored(prob, num_reads, sweeps, slices):
        return dissipative_qa(prob, num_reads, sweeps, slices, BATH_ALPHA,
                              seed=0, bath_update="colored")

    def noisy(kind):
        """sa.anneal_noisy (T 3 -> 0) or svmc.anneal_noisy (TF, A 3 ->
        1e-8, B = 1, T = SVMC_TEMP) over the first `sweeps` rows of the
        noisy tables, from the solvers' random states of a generator of
        seed 0: (spins or z-projections, their static-problem
        energies)."""
        from montecarlosolvers_tpu_torch.solvers import sa, svmc

        def run(prob, num_reads, sweeps):
            gen = torch.Generator().manual_seed(0)
            jt, ht = tables[0][:sweeps], tables[1][:sweeps]
            if kind == "sa":
                s0 = sa.random_state(gen, prob.nspins, batch=(num_reads,),
                                     device=dev)
                out = sa.anneal_noisy(prob, schedules.linear(
                    3.0, 0.0, sweeps, device=dev), jt, ht, s0, gen)
            else:
                th = svmc.random_state(gen, prob.nspins, batch=(num_reads,),
                                       device=dev)
                a = schedules.linear(3.0, 1e-8, sweeps, device=dev)
                out = svmc.z_projection(svmc.anneal_noisy(
                    prob, a, torch.ones_like(a), SVMC_TEMP, jt, ht, th, gen,
                    tf=True))
            return out.cpu().numpy(), prob.energy(out).cpu().numpy()
        return run

    def cluster_solved(method, **opts):
        """solve(method) with `opts` beside the slices."""
        def run(prob, num_reads, sweeps, slices=None):
            kw = dict(opts, **({} if slices is None else {"slices": slices}))
            ss = solve(prob, method=method, num_reads=num_reads,
                       sweeps=sweeps, seed=0, **kw)
            return ss.samples, ss.energies
        return run

    sa_kw = dict(num_reads=SA_READS, sweeps=SA_SWEEPS)
    qmc_kw = dict(num_reads=QMC_READS, sweeps=QMC_SWEEPS)
    svmc_kw = dict(num_reads=SVMC_READS, sweeps=SVMC_SWEEPS)
    bath_kw = dict(num_reads=BATH_READS, sweeps=BATH_SWEEPS,
                   slices=BATH_SLICES)
    new_kw = dict(bath_kw, sweeps=BATH_NEW_SWEEPS)
    csa_kw = dict(num_reads=CLUSTER_SA_READS, sweeps=CLUSTER_SA_SWEEPS)
    cqmc_kw = dict(num_reads=CLUSTER_QMC_READS, sweeps=CLUSTER_QMC_SWEEPS,
                   slices=CLUSTER_SLICES)
    gname80 = f"gaussian_torus({L}, 0).to_generic()"
    nbt = f"gaussian_torus({L}, 0), neighbor table"
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
        # the generic IsingProblem: the same instance, a chimera, a 3-D glass
        ("sa_generic", glattice, gproblem, sa_run, sa_kw, {"packed_sa": 1}),
        ("piqmc_p40_generic", glattice, gproblem, qmc_run,
         dict(qmc_kw, slices=QMC_SLICES), {"packed_sa": 1, "generic_qmc": 1}),
        ("svmc_generic", glattice, gproblem, svmc_run, svmc_kw,
         {"packed_svmc": 1}),
        ("piqmc_chimera", "chimera_graph(16, rng=0)",
         graphs["chimera_graph(16, rng=0)"], qmc_run,
         dict(num_reads=CHIMERA_READS, sweeps=CHIMERA_SWEEPS,
              slices=CHIMERA_SLICES), {"packed_sa": 1, "generic_qmc": 1}),
        ("sa_3d", "random_3d_lattice(16, rng=0)",
         graphs["random_3d_lattice(16, rng=0)"], sa_run, sa_kw,
         {"packed_sa": 1}),
        # the rest of dissipative PIQMC: the bath on the neighbor-table
        # form (compat.DissipativeQuantumAnneal's), on the odd torus, the
        # colored sweep on the lattice at P = 40 (kernel 5's template) and
        # P = 5 (the checkerboard packing), and the chimera
        ("piqmc_bath_nbtable_p40", nbt, bproblems[nbt], dissipative,
         new_kw, {"packed_sa": 1, "generic_qmc_bath": 1}),
        ("piqmc_bath_nbtable_colored_p40", nbt, bproblems[nbt], colored,
         new_kw, {"packed_sa": 1, "generic_qmc_bath": 1}),
        ("piqmc_bath_l81_p40", "gaussian_torus(81, seed=0)", odd_torus,
         dissipative, new_kw, {"sa_plane": 1, "generic_qmc_bath": 1}),
        ("piqmc_bath_colored_p40", "gaussian_torus(80, seed=0)", torus,
         colored, new_kw, {"sa_split": 1, "qmc_bath_split_colored": 1}),
        ("piqmc_bath_colored_p5", "gaussian_torus(80, seed=0)", torus,
         colored, dict(new_kw, slices=ODD_SLICES),
         {"sa_split": 1, "generic_qmc_bath": 1}),
        ("piqmc_bath_chimera_p20", "chimera_graph(16, rng=0)",
         graphs["chimera_graph(16, rng=0)"], dissipative,
         dict(new_kw, slices=CHIMERA_SLICES),
         {"packed_sa": 1, "generic_qmc_bath": 1}),
        # the dense engine: one in-block launch a block and sweep; the
        # noisy anneals: one launch an anneal
        ("sa_dense", f"sk_model({DENSE_N}, rng=0)", sk_problem, sa_run,
         dict(num_reads=DENSE_READS, sweeps=DENSE_SWEEPS),
         {"dense_sa": DENSE_SWEEPS * -(-DENSE_N // DENSE_BLOCK)}),
        ("sa_noisy", f"gaussian_torus({L}, 0).to_generic(), noisy tables",
         gtorus80, noisy("sa"), dict(num_reads=SA_READS,
                                     sweeps=NOISY_SWEEPS),
         {"packed_sa_noisy": 1}),
        ("svmc_noisy", f"gaussian_torus({L}, 0).to_generic(), noisy tables",
         gtorus80, noisy("svmc"), dict(num_reads=SVMC_READS,
                                       sweeps=NOISY_SWEEPS),
         {"packed_svmc_noisy": 1}),
        # the cluster methods: the classical ones a local sweep and a
        # cluster launch a step, the PIQMC ones after the pre-anneal's one
        # SA launch (piqmc_sw: a fk_line launch a color phase;
        # piqmc_sw_full: a local and a labeling launch a step)
        ("sa_wolff", gname80, gtorus80, cluster_solved("sa_wolff"),
         csa_kw, {"packed_sa": CLUSTER_SA_SWEEPS,
                  "fk_wolff": CLUSTER_SA_SWEEPS}),
        ("sa_sw", gname80, gtorus80, cluster_solved("sa_sw"), csa_kw,
         {"packed_sa": CLUSTER_SA_SWEEPS, "fk_label": CLUSTER_SA_SWEEPS}),
        ("piqmc_wolff_p40", gname80, gtorus80,
         cluster_solved("piqmc_wolff"), cqmc_kw,
         {"packed_sa": 1, "fk_wolff": 1}),
        ("piqmc_sw_p40", gname80, gtorus80,
         cluster_solved("piqmc_sw", alpha=CLUSTER_ALPHA), cqmc_kw,
         {"packed_sa": 1,
          "fk_line": CLUSTER_QMC_SWEEPS * gtorus80.num_colors}),
        ("piqmc_sw_full_p40", gname80, gtorus80,
         cluster_solved("piqmc_sw_full"), cqmc_kw,
         {"packed_sa": 1, "generic_qmc": CLUSTER_QMC_SWEEPS,
          "fk_label": CLUSTER_QMC_SWEEPS}),
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
        certified = e_gs is not None and prob in (problem, gproblem)
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
    # ---- the samplers at full width, launch counts read around each
    sampler_solves(dev, main_launches, torus, power, name)
    emit({"phase": "main_path", "launches": main_launches})
    phase_seconds["main_path"] = time.perf_counter() - t_script

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

    # the generic kernels at the main path's widths on the torus's generic
    # form
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops

    gtorus = graphs[f"gaussian_torus({L}, 0).to_generic()"]
    pg80 = packed_ops.build_packed(gtorus)

    def generic_runner(kname, fn, chains, slices=None):
        n = pg80.nspins
        if kname == "packed_sa":
            s = random_spins(chains, n)
            return lambda tau: fn(pg80, schedules.linear(
                3.0, 0.0, tau, device=dev), s, 7)
        if kname == "packed_svmc":
            th = random_angles(chains, n)
            return lambda tau: fn(pg80, *svmc_sched(tau), SVMC_TEMP, th, 7,
                                  True)
        c = random_spins(chains, slices, n)
        teff_q = (1.0 / slices) * slices

        def run(tau):
            g = schedules.transverse_field(3.0, 1e-8, tau, device=dev)
            return fn(pg80, torch.ones_like(g), schedules.jperp(g, teff_q)
                      .contiguous(), teff_q, c, 7, True)
        return run

    generic_rows = []
    for kname, chains, slices, taus, plain_taus in (
            ("packed_sa", SA_READS, 1, (500, 2000), (10, 40)),
            ("generic_qmc", QMC_READS, QMC_SLICES, (100, 400), (2, 6)),
            ("packed_svmc", SVMC_READS, 1, (500, 2000), (10, 40))):
        kernel, plain, _ = gibbs_tool().GENERIC[kname]
        generic_rows += [
            (kname, "cuda", generic_runner(kname, kernel, chains, slices),
             taus, 3, chains, slices, L * L),
            (kname, "plain", generic_runner(kname, plain, chains, slices),
             plain_taus, 2, chains, slices, L * L)]

    # the bath kernels at the main path's widths: the generic bath kernel
    # on the neighbor-table torus (sequential, as compat's path runs it),
    # kernel 5's colored template on the torus, its per-phase kernels at
    # the first torus no cluster holds
    from montecarlosolvers_tpu_torch.ops import generic_kernels as gk

    pg_nbt = packed_ops.build_packed(bproblems[nbt])
    pg_odd = packed_ops.packed_from_lattice(odd_torus)
    pg_chim = packed_ops.build_packed(graphs["chimera_graph(16, rng=0)"])

    def bath_of(slices):
        return piqmc_ops.bath_matrix(schedules.bath_lookuptable(
            slices, BATH_ALPHA, device=dev), slices).contiguous()

    def generic_bath_runner(fn, pg=pg_nbt, slices=BATH_SLICES,
                            colored=False):
        c = random_spins(QMC_READS, slices, pg.nspins)
        teff_q = (1.0 / slices) * slices
        bath = bath_of(slices)

        def run(tau):
            g = schedules.transverse_field(3.0, 1e-8, tau, device=dev)
            return fn(pg, torch.ones_like(g), schedules.jperp(g, teff_q)
                      .contiguous(), teff_q, bath, c, 7, True,
                      colored=colored)
        return run

    def colored_runner(fn, sl=sl, chains=BATH_READS):
        qs = split_ops.pack_qmc(sl, random_spins(chains, BATH_SLICES,
                                                 sl.L * sl.L))
        bath = bath_of(BATH_SLICES)

        def run(tau):
            g = schedules.transverse_field(3.0, 1e-8, tau, device=dev)
            return fn(sl, torch.ones_like(g), schedules.jperp(g, teff)
                      .contiguous(), teff, bath, qs, 7, True)
        return run

    bath_rows = (
        ("generic_qmc_bath", "cuda",
         generic_bath_runner(gk.generic_qmc_bath_anneal), (50, 200), 3,
         QMC_READS, BATH_SLICES, L * L),
        ("generic_qmc_bath", "plain",
         generic_bath_runner(gk.generic_qmc_bath_anneal_ref), (1, 3), 2,
         QMC_READS, BATH_SLICES, L * L),
        ("split_qmc_bath_colored", "cuda",
         colored_runner(sk.qmc_bath_split_colored_anneal), (100, 400), 3,
         BATH_READS, BATH_SLICES, L * L),
        ("split_qmc_bath_colored", "plain",
         colored_runner(sk.qmc_bath_split_colored_anneal_ref), (2, 6), 2,
         BATH_READS, BATH_SLICES, L * L),
        ("split_qmc_bath_colored_phased", "cuda",
         colored_runner(sk.qmc_bath_split_colored_anneal, sl_5, 1), (5, 20),
         3, 1, BATH_SLICES, BATH_PHASED_L ** 2),
        ("split_qmc_bath_colored_phased", "plain",
         colored_runner(sk.qmc_bath_split_colored_anneal_ref, sl_5, 1),
         (1, 3), 2, 1, BATH_SLICES, BATH_PHASED_L ** 2),
    )
    # beside the kernels line: the generic bath kernel's other routes
    bath_extra = (
        (pg_nbt, generic_bath_runner(gk.generic_qmc_bath_anneal,
                                     colored=True), BATH_SLICES, L * L),
        (pg_odd, generic_bath_runner(gk.generic_qmc_bath_anneal, pg_odd),
         BATH_SLICES, ODD_L * ODD_L),
        (pg_chim, generic_bath_runner(gk.generic_qmc_bath_anneal, pg_chim,
                                      CHIMERA_SLICES), CHIMERA_SLICES,
         pg_chim.nspins),
    )
    graph_of = {"generic_qmc_bath": pg_nbt}

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
        *generic_rows,
        *bath_rows,
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
                 sites, record=True, graph_problem=None):
        """Slope-time run and emit its line; with `record`, keep the time
        (and the bound) as kernel `kname`'s, or as its plain version's.
        The generic kernels' bound counts `graph_problem`'s table (the
        kernel's row problem by default)."""
        ms, best = slope_ms(run, taus, trials)
        rate = sites * slices * chains / (ms * 1e-3) if ms > 0 \
            else float("nan")
        # the work is the kernel's, whichever instantiation does it
        base = kname.removesuffix("_phased").removesuffix("_hw")
        if graph_problem is None and (kname in GENERIC_KERNELS
                                      or kname in graph_of):
            graph_problem = graph_of.get(kname, gtorus)
        graph = None if graph_problem is None else graph_shape(graph_problem)
        bound, bound_by, unit = bound_ms(base, chains, slices, sites,
                                         max(taus), graph)
        f32, sfu = ops_per_sweep(base, chains, slices, sites, graph)
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
                                                   sites, max(taus), graph),
              "gpu": name, "power_limit": power})
        check(ms > 0, f"{kname} {route} slope is positive")
        if record and route == "cuda":
            results[kname].update(ms=ms, bound_ms=bound, bound_by=bound_by)
        elif record:
            results[kname]["plain_ms"] = ms

    for i, row in enumerate(timings + extra):
        time_row("timing", *row, record=i < len(timings))
    for pg_row, run, slices, sites in bath_extra:
        time_row("timing", "generic_qmc_bath", "cuda", run, (50, 200), 3,
                 QMC_READS, slices, sites, record=False,
                 graph_problem=pg_row)
    # the bath kernels beside kernel 5 on the same torus, P and chains
    for kname in ("generic_qmc_bath", "split_qmc_bath_colored"):
        emit({"phase": "bath_vs_lattice", "kernel": kname,
              "lattice": "split_qmc_bath", "ms": results[kname]["ms"],
              "lattice_ms": results["split_qmc_bath"]["ms"],
              "ratio": results[kname]["ms"]
              / results["split_qmc_bath"]["ms"],
              "bound_ms": results[kname]["bound_ms"],
              "gpu": name, "power_limit": power})
    # the same torus through two layouts: the generic kernel beside the
    # lattice kernel at the same widths
    for gname, lname in (("packed_sa", "split_sa"),
                         ("generic_qmc", "split_qmc"),
                         ("packed_svmc", "split_svmc")):
        emit({"phase": "generic_vs_lattice", "generic": gname,
              "lattice": lname, "generic_ms": results[gname]["ms"],
              "lattice_ms": results[lname]["ms"],
              "ratio": results[gname]["ms"] / results[lname]["ms"],
              "generic_bound_ms": results[gname]["bound_ms"],
              "gpu": name, "power_limit": power})
    dense_noisy_timing(dev, results, sk_problem, gtorus80, tables, power,
                       name)
    cluster_timing(dev, results, gtorus80, power, name)
    phase_seconds["timing"] = time.perf_counter() - t_script

    # ---- the generator instantiations of A, B, 4 and 5 (hw_rng=True)
    hw_exact_checks(dev, results)
    hw_stream_checks(dev, torus)
    hw_quality_checks(dev, torus, results)
    phase_seconds["hw_rng_kernel_checks"] = time.perf_counter() - t_script

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
    phase_seconds["bench"] = time.perf_counter() - t_script

    # ---- the cluster arm of the bench (bench.py::_cluster_arm)
    cluster_bench(dev, problem)
    phase_seconds["cluster_bench"] = time.perf_counter() - t_script

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
    phase_seconds["hw_rng_timing"] = time.perf_counter() - t_script

    # ---- collect_energy=: each kernel's collecting route (its per-phase
    # kernels and the energy kernel) against its plain version, and against
    # its cluster kernel's run without energies, at the main path's shapes
    energy_path_launches = collect_energy_checks(dev, results, torus,
                                                 odd_torus)
    collect_energy_timing(dev, results, torus, odd_torus, power)
    phase_seconds["collect_energy"] = time.perf_counter() - t_script

    # ---- this slice's drivers: the MST matrix and the open-system example
    mst_checks(dev, problem, e_gs, torus)
    examples_checks(dev, problem, e_gs, torus)

    # No single PyTorch call computes a Metropolis sweep or labels the
    # components of a graph, so no kernel has a library yardstick
    # (library_ms null) but the dense engine's: one sweep's block products
    # by torch.matmul, which its sweep contains.
    # The generator instantiations' launches are the bench's, the others'
    # the main path's.
    # The energy kernel's launches are those of the collecting solves.
    def path_launches(k, key):
        if k in ENERGY_LAYOUTS:
            return sum(energy_path_launches[f"{kk}_energy"]
                       for kk in ENERGY_LAYOUTS[k])
        return (bench_launches if "_hw" in k else main_launches)[key]

    emit({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": tpu,
         "launches": path_launches(k, key),
         "max_abs_err": results[k]["max_abs_err"], "ms": results[k]["ms"],
         "plain_ms": results[k]["plain_ms"],
         "bound_ms": results[k]["bound_ms"],
         "bound_by": results[k]["bound_by"],
         "library_ms": results[k].get("library_ms")}
        for k, (key, src, tpu) in KERNELS.items()
    ]})
    phase_seconds["mst_and_examples"] = time.perf_counter() - t_script
    # seconds from the start at the end of each phase
    emit({"phase": "done", "seconds": time.perf_counter() - t_script,
          "phase_seconds": phase_seconds})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
