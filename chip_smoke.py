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
                      fk_label, fk_line), the Houdayer kernel and the
                      sharded cluster kernels (fk_shard) from csrc/, all
                      at once (seconds)
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
  sa_dense_redesign   generic SA's cluster route (csrc/generic_words.cuh's
                      SA mode: up to 32 chains as the bits of a word over
                      a cluster of CTAs) with the (C, R, threads) its rule
                      chose and the clusters the card holds, on the 80x80
                      torus's generic form at 1280, 32 and 8 chains, the
                      81x81 checkerboard (not proper), per-step tables,
                      384 temperatures a chain, the 8 x 160 disorder
                      batch, chain0 = 100003, energies and one-step
                      launches; the file's first kernel ("_wide", forced)
                      shared, per-chain and with tables; the dense
                      in-block kernel (h added inside) at 1024 chains,
                      systematic and shuffled, 64 chains with a
                      temperature each, blocks of 100 and chain0: 0
                      mismatched spins, energies within 1e-5 (sum |J| +
                      sum |h|), launches exactly the route's; then the
                      "_wide" routes slope-timed beside their plain
                      versions and bounds, and the cluster route at 32
                      and 8 chains beside kernel A on the same torus;
                      the rule of size (packed_sa_one_cta): the chimera
                      pre-anneal's 32 chains and ICM's 1536 (a
                      temperature each) on the first kernel, one CTA a
                      chain, random_3d_lattice(16) at 1280 on the cluster
                      route, each against its plain version and timed
                      beside the other kernel forced
  energy_svmc_redesign  the chain-bit energy kernel (csrc/energy.cuh,
                      K chains of a group a CTA) at 1, 7, 384, 1024 and
                      7040 chains on the 80x80 torus at every K that
                      divides kernel A's C: energies bitwise the halves
                      kernel's, 0 mismatched, the rule's K timed beside
                      the halves kernel; generic SVMC's cluster route
                      (csrc/packed_svmc.cu, a chain's rotors in the shared
                      memory of R CTAs) with the (R, threads) its rule
                      chose and the clusters the card holds, on the 80x80
                      torus's generic form at 256 chains (TF, uniform,
                      energies, per-step tables at mcsteps 1 and 2, chain0,
                      R forced to 1 and 4), 32 and 8 chains, the 81x81
                      checkerboard (not proper), the chimera, the 3-D
                      lattice and the 9-color graph: angles by the
                      ANGLE_MISMATCH rule, bitwise the first kernel on a
                      proper packing; the first kernel ("_wide", forced)
                      on static and per-step tables, then slope-timed
                      beside its plain version and bound, and the cluster
                      route beside kernel 4 on the same torus, in turns;
                      the rule of size (packed_svmc_one_cta): small class
                      phases on the first kernel under the plain key,
                      each shape against its plain version and timed
                      beside the other kernel forced
  houdayer_line_redesign  generic SVMC's first kernel ("_wide", forced)
                      on the 81x81 checkerboard (not proper: its phases'
                      snapshots of cos), 256 chains, angles by the
                      ANGLE_MISMATCH rule; the Houdayer move's cluster
                      kernel (csrc/houdayer.cu, a pair over R CTAs on the
                      labeling core) in site order and in place on a
                      packed state through a permuted ror, and its first
                      kernel ("houdayer_wide", forced), at ICM's 768 and
                      24 pairs of random_3d_lattice(12, rng=0) and 48 of
                      the 80x80 torus's generic form, pair0 0 and 100003,
                      bitwise the plain versions, ms a move queued beside
                      the plain version and the bound; fk_line's cluster
                      kernel (one launch an anneal, a chain's lines as
                      64-bit words over R CTAs) and its first kernel
                      ("fk_line_wide", forced, one launch a phase) at the
                      piqmc_sw solve's shape (8 chains, P = 40), WC3 and
                      WC2, chain0 0 and 100003, bitwise line_phase_ref
                      phase by phase, ms a step by the slope beside the
                      plain version, the bound and the pair hashes' floor
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
                      anneal (fk_line's cluster kernel here one a color
                      phase: line_anneal a phase at a time)
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
                      fk_wolff launch; one fk_line launch; a generic
                      PIQMC and a fk_label launch a sweep), in
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
  api_surface         the compat shims on the 80x80 torus's reference-format
                      table: Anneal (64 reads, 2000 steps), QuantumAnneal-
                      Global (P = 40, 500 steps), DissipativeQuantumAnneal-
                      Global (P = 40, 200 steps), DissipativeQuantumAnneal-
                      WC3 (P = 40, 20 steps), SpinVectorMonteCarloTFCompact
                      (256 reads, 2000 steps), NoisyAnneal and NoisySVMCTF
                      (64 reads, 200 steps of noisy tables); the CLI's
                      solve in process ("sa", "piqmc" at P = 40 and "svmc"
                      with --lattice 80, "sa" on the generic form) on the
                      torus's triplet file; a CheckpointedAnneal of SA
                      (1280 chains, 2000 steps, 4 segments), unbroken and
                      stopped after 2 and resumed, bitwise equal. Each run
                      with the counts set to 0 just before it: exactly its
                      route's launches, no wrapper on its plain version,
                      its energy per spin in the range around its JAX CPU
                      anchor (tools/compat_anchors.py) or the main path's
                      range for the same solve
  studies             the value studies' arms at full width and reduced
                      sweeps on the 80x80 torus (e_gs = -sum |J|):
                      pt_value (48 rungs, 200 sweeps; quantum 48 rungs, P =
                      20, 50 sweeps), pa_value's sampling and optimization
                      arms (1024 replicas, 50 steps), icm_value on
                      random_3d_lattice(12, 0) (one seed, two segments of
                      500 sweeps, cadences 2, 8 and 32, and the PT
                      baseline), cluster_value (32 chains, P = 40, tau 200,
                      with and without the bath), the crossover's arms at
                      L = 32, P = 4, 16 chains and its classical arms at
                      L = 32, the ladder calibration at N = 6400, and the
                      examples compat_migration and cluster_and_pt: each
                      arm's record keys (the study's RECORD_KEYS), its
                      route's kernels (exact counts where the arm fixes
                      them), no plain route, and its value in the range
                      around its JAX CPU anchor (an equal-wall arm's eps
                      between 0 and its fixed-tau sibling's range; the
                      crossover's tau_int and Wolff flip fraction too, and
                      its cluster moves' tau_int below the local
                      dynamics')
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
                      WC2 step at one chain, P = 40, one launch a run)
                      beside `cluster_bound`
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
  parallel            the parallel layer's chain and Trotter axes
                      (parallel/): (a) each kernel of a chain-sharded solve
                      (A and packed SA at 1280 chains, 6 at 1280 on the
                      81x81 torus, B, 5 sequential and colored, generic
                      PIQMC and generic bath at P = 40, 3 at P = 5, 32
                      chains; the per-phase kernels of A, B and 5) runs a
                      block of chains with its chain0 and equals those rows
                      of the whole batch's run, 0 mismatched spins; (b) the
                      shard kernels S1-S4 (ops/shard_kernels.py) on rank 1's
                      slab of 4 at 80x80, P = 40, 32 chains (the generic
                      form likewise) against their plain versions, timed
                      beside them and their bounds; (c) a one-rank NCCL
                      mesh: chain-sharded SA and PIQMC equal the unsharded
                      runs, and the Trotter-sharded anneals (PARALLEL_STEPS
                      steps, line moves off and on: the launches of S1-S4
                      in the kernels line) equal kernel B's and the generic
                      kernel's; their ms a sweep beside kernel B's cluster
                      and per-phase routes and the exchange's share; (d)
                      PARALLEL_RANKS gloo ranks sharing the card run both
                      Trotter-sharded anneals at replica 4: bitwise the
                      single-device kernels without line moves, within
                      PARALLEL_ANCHOR of their mean best-slice energy with
                      them and at most PARALLEL_LINES differing lines, each
                      rank's launches exact; (f) the rest of the Trotter
                      axis's shard kernels S5 (the sharded bath's slice
                      step: the torus's packing, P = 40, 32 chains, alpha =
                      1e-2) and S6, S7 (the sharded Wolff round, field sums
                      and flip, rules "local" and "full", and the sharded
                      SW labels: the generic form, one chain at P = 40,
                      with and without bath bonds) on rank 1's slab of 4
                      against their plain versions, 0 mismatches, timed
                      beside shard_bound; (f2) S5 and S7 redesigned
                      (`shard_redesign`): S5 over a cluster (the 80x80 and
                      81x81 checkerboards, float32 and int8 gathered
                      states, chain0 0 and 100003) and S7's draw over a
                      cluster, round over the cluster and flip over the
                      card (the slab and the one-rank ring, without a
                      bath, with one and on an asymmetric table), each
                      against its plain version and its first kernel
                      ("_wide", forced), bitwise; ms queued behind a spin
                      kernel beside the first kernel, the plain version,
                      shard_bound and the counter hash's floor; (g) the
                      one-rank NCCL mesh: the
                      sharded bath (tau = 200, line moves off and on)
                      equals the sequential generic bath kernel, the
                      sharded Wolff and SW engines (50 steps) equal
                      fk_wolff and fk_label, with and without the bath,
                      launches exact, ms a sweep or step beside the
                      single-device kernels', rounds a step and the
                      exchange's share; (h) PARALLEL_RANKS gloo ranks
                      sharing the card: the sharded bath at P = 40 and at
                      P = 4 (one slice a rank, the ring coloured) equals
                      its one-process lockstep plain version, within
                      PARALLEL_ANCHOR of the sequential bath's energy, and
                      the sharded Wolff and SW engines equal the
                      single-device kernels; (j) kernels 4 and 7 (cluster
                      and per-phase routes), packed SVMC (static and
                      per-step tables) at SVMC_READS chains, TF, the dense
                      in-block kernel at DENSE_READS chains of sk_model(
                      DENSE_N) (shared and per-chain temperatures) and the
                      Houdayer move at PT_RUNGS pairs run a block with its
                      chain (pair) offset and equal those rows of the
                      whole batch's run, 0 mismatches, each timed at offset
                      0 and at OFFSET_CHAIN0 (the dense anneal's rows,
                      block products of the block's own row count, counted);
                      (k) a one-rank NCCL mesh: pt.sample, sample_piqmc,
                      sample_icm, pa.sample, sample_adaptive, sample_piqmc,
                      svmc.anneal, both noisy anneals and the dense anneal
                      at full width on a chain-sharded state equal the
                      unsharded calls bitwise (rates, log_z and stats too),
                      launches exact, walls and the gathers' share; (l)
                      PARALLEL_RANKS gloo ranks sharing the card: the same
                      calls at GLOO_SAMPLER_STEPS, bitwise (the dense
                      anneal within 4 standard errors, its mismatches
                      counted), each rank's launches exact, and the bytes
                      a pa.sample step gathers; (i) and (m)
                      parallel.dryrun.dryrun_multichip on PARALLEL_RANKS
                      ranks, JAX's legs 3c, 3d, 4, 5, 5b, 6 and 6b among
                      them
then a line {"kernels": [...]} (the launches of the main path's solves,
the sampler solves and the api_surface and studies runs unless said: the
seven kernels, then their per-phase kernels, which only the studies'
collecting quench arms launch (sa.anneal(collect_energy=True)), then the
generator
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
launches are the sampler solves' and the studies', then the shard kernels
S1-S7 of the Trotter-sharded engines, whose launches are the parallel
phase's one-rank sharded anneals),
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
# The redesigned generic PIQMC and generic bath (their cluster route,
# csrc/generic_words.cuh) and each file's first kernel, the "_wide" route,
# which the rule of shape (ops/generic_kernels.py::generic_qmc_geometry)
# sends a chain no cluster of 16 CTAs holds: WIDE_L is the first L whose
# torus's generic form at P = 40 it sends there (232,324 sites past the
# 232,080 that 16 CTAs hold), WIDE_BATH_L the first whose checkerboard the
# bath's rule sends there (226,576 past 225,680: its CTAs also hold the
# bath matrix), one chain, WIDE_STEPS steps against the plain versions;
# fk_line past its one-word
# rows at LINE_WIDE_SLICES, and solve("piqmc_sw") at P = SW_WIDE_SLICES,
# SW_WIDE_READS reads and SW_WIDE_SWEEPS sweeps; fk_label and fk_line on
# ASYM_ALPHA's bath table with the couplings of ring offsets below P / 2
# scaled by ASYM_SCALE (not symmetric in ring distance)
WIDE_L, WIDE_BATH_L, WIDE_STEPS = 482, 476, 2
# The last chains the rules keep on the cluster route at P = 40, one chain
# of a two-class graph (a ring of EDGE_N sites for PIQMC, EDGE_BATH_N for
# the bath): R = 16 CTAs each asking for all but a few bytes of the 227 KB
# a block may take, WIDE_STEPS steps against the plain versions
EDGE_N, EDGE_BATH_N = 232080, 225680
# The redesigned generic SA (its cluster route, generic_words.cuh's SA
# mode: a group of chains as the bits of a word over a cluster of CTAs)
# and the redesigned dense in-block kernel against their plain versions
# over SA_REDESIGN_STEPS sweeps (dense: DENSE_STEPS) at the main path's
# widths, the PIQMC pre-anneals' 32 and 8 chains, SA_PER_CHAIN_READS
# temperatures a chain (pt.sample's 48 rungs of 8 reads), the dense
# engine at DENSE_CHAIN_READS chains with a temperature each and blocks of
# DENSE_SMALL_BLOCK; the first kernel of packed_sa.cu, the "_wide" route,
# slope-timed over WIDE_SA_TAUS sweeps
SA_REDESIGN_STEPS, SA_PER_CHAIN_READS = 20, 384
DENSE_CHAIN_READS, DENSE_SMALL_BLOCK = 64, 100
WIDE_SA_TAUS, FEW_SA_TAUS = (250, 1000), (500, 2000)
# The redesigned chain-bit energy kernel (K chains of a group a CTA) at
# ENERGY_BITS_CHAINS chains on the 80x80 torus: one, a few, pt_value's 384,
# 1024 and solve("pt")'s 7040; generic SVMC's cluster route and the first
# kernel of packed_svmc.cu, the "_wide" route, slope-timed over
# WIDE_SVMC_TAUS sweeps
ENERGY_BITS_CHAINS = (1, 7, 384, 1024, 7040)
WIDE_SVMC_TAUS = (250, 1000)
LINE_WIDE_SLICES = (65, 128)
SW_WIDE_SLICES, SW_WIDE_READS, SW_WIDE_SWEEPS = 128, 8, 20
ASYM_ALPHA, ASYM_SCALE = 1e-2, 1.5
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
# The API surface (phase api_surface) on the 80x80 torus's reference-format
# (6400, 4, 2) table: the compat shims, SA and the noisy ones at
# SHIM_*_READS reads (svec (reads, N)), the PIQMC shims one chain in the
# (N, P) layout at P = SHIM_SLICES (T = 1/P, A 3 -> 1e-8, B = 1; the bath
# alpha SHIM_ALPHA), SVMC-TF compact at SHIM_SVMC_READS reads, T
# SHIM_SVMC_TEMP; the noisy tables J_t = J (1 + SHIM_NOISY_SCALE xi_t), xi
# default_rng(0) normals, SHIM_NOISY_STEPS steps. The CLI's solve at the
# main path's reads and sweeps, and a CheckpointedAnneal of SA (CKPT_*).
SHIM_SA_READS, SHIM_SA_SWEEPS = 64, 2000
SHIM_SLICES, SHIM_ALPHA = 40, 1e-2
SHIM_QMC_SWEEPS, SHIM_BATH_SWEEPS, SHIM_WC3_SWEEPS = 500, 200, 20
SHIM_SVMC_READS, SHIM_SVMC_SWEEPS, SHIM_SVMC_TEMP = 256, 2000, 0.05
SHIM_NOISY_READS, SHIM_NOISY_STEPS, SHIM_NOISY_SCALE = 64, 200, 0.1
CKPT_READS, CKPT_SWEEPS, CKPT_SEGMENTS = 1280, 2000, 4
# The studies (phase studies) at full width and reduced sweeps: each
# module's constants while it runs, cluster_value at tau CV_TAU, the
# crossover at L XO_L, P XO_SLICES, XO_CHAINS chains, XO_SWEEPS sweeps
# after XO_BURN in chunks of XO_CHUNK, the ladder calibration's auto ladder
# at N = 6400 (LADDER_RUNGS rungs), and examples/cluster_and_pt.py's run()
# at EXAMPLE_CLUSTER_PT on the torus's generic form.
STUDY_CONSTS = {
    "pt_value": dict(RUNGS=48, SWEEPS=200, Q_RUNGS=48, Q_SLICES=20,
                     Q_SWEEPS=50),
    "pa_value": dict(REPLICAS=1024, SWEEPS=50),
    "icm_value": dict(RUNGS=24, SEG=500, ICM_SEGS={12: 2}, REPS={12: 1},
                      L_SIZES=(12,), SEEDS_BY_L={12: (0,)},
                      CADENCES_BY_L={12: (2, 8, 32)}),
    "cluster_value": dict(CHAINS=32, P=40),
}
CV_TAU = 200
XO_L, XO_SLICES, XO_CHAINS, XO_SWEEPS, XO_BURN, XO_CHUNK = (32, 4, 16, 2048,
                                                            256, 512)
LADDER_RUNGS = 53
EXAMPLE_CLUSTER_PT = dict(tau=200, chains=8, rungs=48, pt_sweeps=100,
                          slices=8)
# Their JAX CPU anchors (tools/compat_anchors.py <case>, the JAX shims,
# studies and examples at these shapes on the CPU; PERF.md section 2):
# key -> (mean, sd, floor), the range mean +/- max(floor, 5 sd). The shims'
# sd is that of one read (of one run for the one-chain PIQMC shims, over 8
# seeds); SVMC-TF's anchor ran 32 reads; their floor 0.01 is the main
# path's (RANGES). A study arm's value is its eps (mean or least energy
# per spin above e_gs = -sum |J|), sd over 3 JAX keys, floor 0.005: an
# annealed eps is a value out of equilibrium, which depends on the order
# of the updates, and the JAX package on the CPU shares that order with
# neither its TPU kernels nor the port's (the port's card values sit up to
# 0.0033 from these means, pa_value.opt_pa; cluster_value's four arms,
# from one pre-annealed start, all 0.0009-0.0015 below). icm_value's value
# is the cold-rung mean energy per spin of the second segment (2 keys;
# floor 0.02: two keys understate the spread of the cold rung after 1000
# sweeps at T = 0.3, the port's first card run read 0.008 from one
# anchor). The crossover's are the mean m^2, tau_int and the Wolff flip
# fraction, the ladder's the swap rate (8 keys each, no floor); the
# examples' the energy per spin (8 seeds) and eps (3 runs), floor 0.01.
# An equal-wall arm, whose tau this card's walls set, has no JAX run at
# its shape (studies(): eps_value).
API_ANCHORS = {
    "Anneal": (-1.278756, 0.002921, 0.01),
    "QuantumAnnealGlobal": (-1.268876, 0.001120, 0.01),
    "DissipativeQuantumAnnealGlobal": (-1.268490, 0.001132, 0.01),
    "DissipativeQuantumAnnealWC3": (-1.189597, 0.002788, 0.01),
    "SpinVectorMonteCarloTFCompact": (-1.256581, 0.003243, 0.01),
    "NoisyAnneal": (-1.255622, 0.003565, 0.01),
    "NoisySVMCTF": (-1.228408, 0.004147, 0.01),
    "pt_value.sampling_pt": (0.346552, 0.000712, 0.005),
    "pt_value.sampling_quench": (0.372295, 0.000649, 0.005),
    "pt_value.opt_pt": (0.332092, 0.002335, 0.005),
    "pt_value.opt_sa_tau200": (0.331969, 0.002143, 0.005),
    "pt_value.quantum_pt": (0.306428, 0.000947, 0.005),
    "pt_value.quantum_piqmc_tau50": (0.317628, 0.000393, 0.005),
    "pt_value.sampling_icm": (0.353212, 0.000403, 0.005),
    "pt_value.opt_icm": (0.333662, 0.002103, 0.005),
    "pa_value.sampling_pa": (0.350371, 0.000468, 0.005),
    "pa_value.sampling_quench": (0.400619, 0.000237, 0.005),
    "pa_value.sampling_pt_matched_21x48": (0.376233, 0.000620, 0.005),
    "pa_value.opt_pa": (0.367513, 0.001399, 0.005),
    "pa_value.opt_sa_tau50": (0.349635, 0.002614, 0.005),
    "pa_value.opt_pt_matched_21x48": (0.346955, 0.000902, 0.005),
    "cluster_value.baseline_tau200": (0.312449, 0.000170, 0.005),
    "cluster_value.mixed_wcl_tau200": (0.312362, 0.000504, 0.005),
    "cluster_value.bath_baseline_tau200": (0.309420, 0.000597, 0.005),
    "cluster_value.bath_mixed_sw_tau200": (0.308760, 0.000222, 0.005),
    "icm_value.icm_h2_L12_s0": (-1.765727, 0.000936, 0.02),
    "icm_value.icm_h8_L12_s0": (-1.761623, 0.001771, 0.02),
    "icm_value.icm_h32_L12_s0": (-1.760387, 0.000390, 0.02),
    "icm_value.pt_L12_s0": (-1.763838, 0.001296, 0.02),
    "crossover.critical_localglobal_L32": (0.455955, 0.006753, 0.0),
    "crossover.critical_wolff1_L32": (0.456809, 0.001418, 0.0),
    "crossover.critical_wolff4_L32": (0.453737, 0.004154, 0.0),
    "crossover.cl_critical_local_L32": (0.456691, 0.007648, 0.0),
    "crossover.cl_critical_wolff_L32": (0.457854, 0.001805, 0.0),
    "crossover.cl_critical_sw_L32": (0.458704, 0.002249, 0.0),
    "crossover.cl_critical_sw+local_L32": (0.459018, 0.001535, 0.0),
    "crossover.critical_localglobal_L32.tau_int": (29.572468, 6.017145, 0.0),
    "crossover.critical_wolff1_L32.tau_int": (2.374157, 0.072228, 0.0),
    "crossover.critical_wolff1_L32.flip_frac": (0.456000, 0.001860, 0.0),
    "crossover.critical_wolff4_L32.tau_int": (6.719087, 0.509179, 0.0),
    "crossover.critical_wolff4_L32.flip_frac": (0.113074, 0.001280, 0.0),
    "crossover.cl_critical_local_L32.tau_int": (30.939619, 3.500380, 0.0),
    "crossover.cl_critical_wolff_L32.tau_int": (3.114916, 0.207490, 0.0),
    "crossover.cl_critical_sw_L32.tau_int": (3.643554, 0.142580, 0.0),
    "crossover.cl_critical_sw+local_L32.tau_int": (2.857295, 0.125396, 0.0),
    "ladder_calibration.lattice_N6400": (0.430625, 0.007094, 0.0),
    "examples.compat_migration.sa": (-1.176240, 0.010443, 0.01),
    "examples.compat_migration.piqmc": (-1.197361, 0.004288, 0.01),
    "examples.cluster_and_pt.sa": (0.339600, 0.000458, 0.01),
    "examples.cluster_and_pt.sa_wolff": (0.325800, 0.000917, 0.01),
    "examples.cluster_and_pt.sa_sw": (0.330967, 0.001159, 0.01),
    "examples.cluster_and_pt.piqmc_sw": (0.374667, 0.002122, 0.01),
    "examples.cluster_and_pt.pt": (0.339600, 0.000872, 0.01),
    "examples.cluster_and_pt.icm": (0.351467, 0.001882, 0.01),
    "examples.cluster_and_pt.quantum_pt": (0.344567, 0.005358, 0.01),
    "examples.cluster_and_pt.pa": (0.323467, 0.001650, 0.01),
}
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
    # generic SA's two kernels, both launched from packed_sa.cu, by shape:
    # the cluster route (csrc/generic_words.cuh's SA mode) and, on a graph
    # whose class phase is small (generic_kernels.packed_sa_one_cta), the
    # file's first kernel, one CTA a chain; the same kernel on a graph no
    # cluster holds is "packed_sa_wide"
    "packed_sa": ("packed_sa",
                  "montecarlosolvers_tpu_torch/csrc/packed_sa.cu",
                  "montecarlosolvers_tpu/ops/packed.py:129"),
    # the cluster route (csrc/generic_words.cuh, launched from
    # generic_qmc.cu); the file's first kernel is "generic_qmc_wide"
    "generic_qmc": ("generic_qmc",
                    "montecarlosolvers_tpu_torch/csrc/generic_words.cuh",
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
        "montecarlosolvers_tpu_torch/csrc/generic_words.cuh",
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
    # fk_line past P = 64 (fk_line_rows_kernel, one launch a color phase):
    # no main-path solve runs it; the phase generic_redesign holds and
    # times it at P in LINE_WIDE_SLICES
    "fk_line_rows": ("fk_line_rows",
                     "montecarlosolvers_tpu_torch/csrc/fk_line.cu",
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
    "generic_qmc_chain": ("generic_qmc_chain", _SRC + "generic_words.cuh",
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
# The parallel layer's shard kernels (ops/shard_kernels.py), which replace
# no TPU kernel but the XLA code the JAX package's Trotter-sharded engines
# run inside shard_map; their launches are the one-rank mesh's sharded
# anneals of the parallel phase
PARALLEL_KERNELS = {
    "shard_phase": ("shard_phase", _SRC + "split_qmc.cu",
                    "montecarlosolvers_tpu/parallel/trotter.py:358"),
    "shard_line_part": ("shard_line_part", _SRC + "split_qmc.cu",
                        "montecarlosolvers_tpu/parallel/trotter.py:386"),
    "shard_line_accept": ("shard_line_accept", _SRC + "split_qmc.cu",
                          "montecarlosolvers_tpu/parallel/trotter.py:386"),
    "generic_shard_phase": ("generic_shard_phase", _SRC + "generic_qmc.cu",
                            "montecarlosolvers_tpu/parallel/trotter.py:115"),
    "generic_shard_line_part": (
        "generic_shard_line_part", _SRC + "generic_qmc.cu",
        "montecarlosolvers_tpu/parallel/trotter.py:233"),
    "generic_shard_line_accept": (
        "generic_shard_line_accept", _SRC + "generic_qmc.cu",
        "montecarlosolvers_tpu/parallel/trotter.py:233"),
    # the rest of the Trotter axis: S5, the sharded bath's slice step, and
    # S6, S7, the sharded Wolff and Swendsen-Wang rounds; their launches
    # are the one-rank mesh's sharded anneals too
    "generic_shard_bath_slice": (
        "generic_shard_bath_slice", _SRC + "generic_qmc_bath.cu",
        "montecarlosolvers_tpu/parallel/trotter.py:170"),
    "shard_wolff": ("shard_wolff", _SRC + "fk_shard.cu",
                    "montecarlosolvers_tpu/parallel/trotter.py:500"),
    "shard_label": ("shard_label", _SRC + "fk_shard.cu",
                    "montecarlosolvers_tpu/parallel/trotter.py:689"),
}
KERNELS.update(PARALLEL_KERNELS)
# The first kernels of csrc/generic_qmc.cu and generic_qmc_bath.cu (one
# CTA a chain, the state as floats in device memory), kept for the chains
# no cluster holds: the "_wide" routes of generic PIQMC (shared and
# per-chain J_perp) and of the generic bath. No main-path solve reaches
# them; the phase generic_redesign holds and times them at WIDE_L.
WIDE_KERNELS = {
    "generic_qmc_wide": ("generic_qmc_wide", _SRC + "generic_qmc.cu",
                         "montecarlosolvers_tpu/ops/piqmc.py:79"),
    "generic_qmc_chain_wide": ("generic_qmc_chain_wide",
                               _SRC + "generic_qmc.cu",
                               "montecarlosolvers_tpu/ops/piqmc.py:79"),
    "generic_qmc_bath_wide": ("generic_qmc_bath_wide",
                              _SRC + "generic_qmc_bath.cu",
                              "montecarlosolvers_tpu/ops/piqmc.py:110"),
    # ... and of csrc/packed_sa.cu (generic SA, its per-chain and per-step
    # table instantiations), for a graph whose words no cluster holds or of
    # more than 127 classes; the phase sa_dense_redesign holds and times
    # them at the main path's widths, the rule forced
    "packed_sa_wide": ("packed_sa_wide", _SRC + "packed_sa.cu",
                       "montecarlosolvers_tpu/ops/packed.py:129"),
    "packed_sa_chain_wide": ("packed_sa_chain_wide", _SRC + "packed_sa.cu",
                             "montecarlosolvers_tpu/ops/metropolis.py:60"),
    "packed_sa_noisy_wide": ("packed_sa_noisy_wide", _SRC + "packed_sa.cu",
                             "montecarlosolvers_tpu/ops/packed.py:221"),
    # ... and of csrc/packed_svmc.cu (generic SVMC, static and per-step
    # tables) for a graph whose rotors no cluster holds or of more than 127
    # classes; the phase energy_svmc_redesign holds and times them at the
    # main path's widths, the rule forced
    "packed_svmc_wide": ("packed_svmc_wide", _SRC + "packed_svmc.cu",
                         "montecarlosolvers_tpu/ops/packed.py:149"),
    "packed_svmc_noisy_wide": ("packed_svmc_noisy_wide",
                               _SRC + "packed_svmc.cu",
                               "montecarlosolvers_tpu/ops/packed.py:259"),
    # ... and the first kernels of csrc/houdayer.cu (one CTA a pair) and
    # csrc/fk_line.cu (one warp a line, P <= 64, one launch a phase), kept
    # for a pair or a chain no cluster of 16 CTAs holds; the phase
    # houdayer_line_redesign holds and times them at the main path's
    # widths, the rule forced
    "houdayer_wide": ("houdayer_wide", _SRC + "houdayer.cu",
                      "montecarlosolvers_tpu/ops/cluster.py:730"),
    "fk_line_wide": ("fk_line_wide", _SRC + "fk_line.cu",
                     "montecarlosolvers_tpu/ops/cluster.py:316"),
    # ... and the first kernel of S5 (csrc/generic_qmc_bath.cu, one CTA a
    # chain), kept for a slice no cluster of 16 CTAs holds; the parallel
    # phase's shard_redesign holds and times it at the main path's widths,
    # the rule forced
    "generic_shard_bath_slice_wide": (
        "generic_shard_bath_slice_wide", _SRC + "generic_qmc_bath.cu",
        "montecarlosolvers_tpu/parallel/trotter.py:170"),
}
KERNELS.update(WIDE_KERNELS)
# what the rest of the parallel layer added to four kernels: the cluster
# kernels' chain offset, packed SA's disorder stride
GAINED = {"fk_wolff": "chain0", "fk_label": "chain0", "fk_line": "chain0",
          "packed_sa": "disorder stride (d_chains, seeds)"}
# the parallel phase: gloo ranks sharing the card, steps of its sharded
# anneals, the taus of its slope timings, and the largest difference of the
# mean best-slice energy per spin between a sharded anneal with line moves
# and the single-device kernel's from the same seed (the main path's
# ranges' half-width)
PARALLEL_RANKS, PARALLEL_STEPS, PARALLEL_TAUS = 4, 60, (20, 60)
PARALLEL_ANCHOR = 0.0105
# the sharded bath's one-rank check (tau, as the main path's bath solves),
# the sharded cluster engines' steps, and the gloo legs' sweeps (fewer:
# every local slice step of the sharded bath gathers the state through
# host memory) and the sharded bath's second P there (one slice a rank,
# the ring coloured)
SHARD_BATH_TAU, SHARD_CLUSTER_STEPS = 200, 50
GLOO_BATH_TAU, GLOO_CLUSTER_STEPS, GLOO_RING_SLICES = 30, 12, 4
# ... and the most lines (chain, site) whose spins may differ there: one
# chain's (6400 of the 204800 at 80x80, 32 chains). The ranks add their
# parts of a line's dE in another order than kernel B adds its rows, so a
# float32 rounding may turn one near-tie decision, and that chain's
# trajectory parts from there on; a wrong or lost sum parts every chain.
# Measured: 0 on every run
PARALLEL_LINES = 80 * 80
# the sharded samplers in the parallel phase: (j) the five kernels that take
# a chain (pair) offset for them, timed at offset 0 and at OFFSET_CHAIN0 in turns,
# OFFSET_STEPS steps (SVMC) or sweeps; (k) and (l) each sharded entry point
# (`sampler_calls`) at full width, SHARDED_STEPS sweeps or steps on the
# one-rank NCCL mesh and GLOO_SAMPLER_STEPS on the gloo ranks (fewer: every
# exchange, reweight and resample gathers through host memory there)
OFFSET_STEPS, OFFSET_CHAIN0 = 200, 100003
SHARDED_STEPS, GLOO_SAMPLER_STEPS = 100, 40
# the rest of the parallel layer, (n)-(r): (n) the cluster kernels' chain
# offsets at their PERF.md rows' widths, P = CLUSTER_SLICES, fk_wolff and
# fk_label CLUSTER_OFFSET_STEPS steps, fk_line one step (both colors),
# timed at offset 0 and OFFSET_CHAIN0 in turns; (o) the cluster solves
# (`cluster_calls`) at the main path's reads and sweeps; (p) and (q) the
# disorder batch at the SA arm's width, DISORDER_D realizations of
# gaussian_torus(L, d).to_generic() with SA_READS // DISORDER_D chains each,
# SA_SWEEPS sweeps, slope-timed over DISORDER_TAUS; (q) on the gloo ranks
# as DISORDER_HOSTS hosts; (r) the masked lattice engine at SA_READS x
# SA_SWEEPS, slope-timed over the same taus
CLUSTER_OFFSET_STEPS, DISORDER_D, DISORDER_HOSTS = 6, 8, 2
DISORDER_TAUS = (500, 2000)
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


def slope_ms(run, taus, trials, sync=None):
    """Median pairwise slope of the best-of-`trials` wall time of run(tau)
    (ending in a synchronize, `sync`: the card's by default) over the tau
    points, in ms per sweep; fixed overhead cancels in the slope
    (bench.py::_measure_rate)."""
    sync = sync or torch.cuda.synchronize
    best = {}
    for tau in taus:
        run(tau)  # warm
        times = []
        for _ in range(trials):
            sync()
            t0 = time.perf_counter()
            run(tau)
            sync()
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


def event_ms(fn, reps, spin_cycles=0):
    """ms per call of fn(), CUDA events around `reps` calls after a warm
    one; with `spin_cycles`, the calls are queued behind a spin kernel of
    that many clocks, so the events time the card's work back to back and
    not the host's queueing of a launch shorter than it."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if spin_cycles:
        torch.cuda._sleep(spin_cycles)
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
    (N, 4, 2) table of `torus_triplets` (tools/jax_bath_anchor.py builds
    the JAX one alike)."""
    from montecarlosolvers_tpu_torch.models.ising import (
        IsingProblem, build_neighbor_table)

    return IsingProblem.from_neighbor_table(
        build_neighbor_table(lat.L ** 2, *torus_triplets(lat), 4),
        device=lat.device)


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


def ring_couplings(n):
    """ring_problem's couplings: J of bond (i, i + 1 mod n), Gaussian
    from a fixed seed."""
    return np.random.default_rng(n).standard_normal(n).astype(np.float32)


def ring_problem(n, dev):
    """An IsingProblem on a ring of n sites (n even: two color classes),
    Gaussian couplings from a fixed seed."""
    from montecarlosolvers_tpu_torch.models.ising import IsingProblem

    rows = np.arange(n)
    return IsingProblem.from_edges(n, rows, (rows + 1) % n,
                                   ring_couplings(n), device=dev)


def ring_ground_state(n):
    """(n,) float32 +/-1 spins satisfying every bond of ring_problem(n)
    but the last, (n - 1, 0): J_i s_i s_(i+1) < 0, the bonds the FK draw
    may activate, so the clusters run along the ring."""
    steps = -np.sign(ring_couplings(n)[:-1])
    return np.concatenate([[1.0], np.cumprod(steps)]).astype(np.float32)


def asymmetric_table(P, dev):
    """bath_lookuptable(P, ASYM_ALPHA) with the couplings of ring offsets
    d < P / 2 scaled by ASYM_SCALE: lut[d - 1] != lut[P - 1 - d], so a bath
    pair's two directions bond with different probabilities."""
    from montecarlosolvers_tpu_torch import schedules

    lut = schedules.bath_lookuptable(P, ASYM_ALPHA, device=dev)
    d = torch.arange(1, P, device=dev)
    return torch.where(2 * d < P, lut * ASYM_SCALE, lut).contiguous()


def generic_redesign(dev, results, graphs, odd_torus, power, name):
    """Phase generic_redesign: generic PIQMC and the generic bath on both
    routes, and the two repaired cluster kernels, against their plain
    versions on the card, 0 mismatched spins and exactly the route's
    launches:
      - the cluster route (csrc/generic_words.cuh) with the geometry its
        rule chose, on the shapes generic_kernel_vs_plain and
        bath_kernel_vs_plain leave out: PIQMC on the 81x81 torus's
        checkerboard (not a proper coloring) and with a J_perp a chain,
        and one chain at the last shape each rule keeps there (a ring of
        EDGE_N, EDGE_BATH_N sites: 16 CTAs each asking for all of the
        shared memory a block may take);
      - the "_wide" routes (each file's first kernel) at the first shape
        each rule sends there at P = 40 (WIDE_L, WIDE_BATH_L), one chain:
        PIQMC shared and per-chain, the bath sequential and colored;
      - fk_line past its one-word rows (P in LINE_WIDE_SLICES, WC2 and
        WC3) and solve("piqmc_sw", slices=SW_WIDE_SLICES);
      - fk_label (the space-time sweep) and fk_line (WC3, the full-line
        decomposition) on `asymmetric_table`.
    Then slope-times the "_wide" routes and fk_line past P = 64
    (fk_line_rows) and their plain versions beside their bounds (the
    kernels line's rows)."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.ops import cluster as cl
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck
    from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops
    from montecarlosolvers_tpu_torch.ops import piqmc as piqmc_ops
    from montecarlosolvers_tpu_torch.solvers.api import solve

    rng = np.random.default_rng(21)
    P = QMC_SLICES
    gname80 = f"gaussian_torus({L}, 0).to_generic()"
    pg80 = packed_ops.build_packed(graphs[gname80])
    pg81 = packed_ops.packed_from_lattice(odd_torus)
    pg_wide = packed_ops.build_packed(instances.gaussian_torus(
        WIDE_L, seed=0, device=dev).to_generic())
    pg_wide_lat = packed_ops.packed_from_lattice(instances.gaussian_torus(
        WIDE_BATH_L, seed=0, device=dev))
    for pg, rule, what in (
            (pg_wide, gk.generic_qmc_geometry, f"{WIDE_L} torus's generic "
                                               "form"),
            (pg_wide_lat, gk.generic_qmc_bath_geometry,
             f"{WIDE_BATH_L} torus's checkerboard (the bath)")):
        check(rule(1, pg.nspins, P, pg.num_colors) is None,
              f"the {what} at P = {P} is past the cluster route")
    pg_edge, pg_edge_bath = (packed_ops.build_packed(ring_problem(n, dev))
                             for n in (EDGE_N, EDGE_BATH_N))
    for pg, rule in ((pg_edge, gk.generic_qmc_geometry),
                     (pg_edge_bath, gk.generic_qmc_bath_geometry)):
        n = pg.nspins
        check(pg.num_colors == 2
              and rule(1, n, P, 2) == (16, gk.WORD_THREADS)
              and rule(1, n + 2, P, 2) is None
              and gk.words_smem_bytes(P, gk.word_layout(pg, 16)[3], True,
                                      rule is gk.generic_qmc_bath_geometry)
              > _build.SMEM_LIMIT_BYTES - 256,
              f"a ring of {n} sites at P = {P} is the last chain the "
              f"{rule.__name__} keeps on the cluster route")
    bath40 = piqmc_ops.bath_matrix(schedules.bath_lookuptable(
        P, BATH_ALPHA, device=dev), P).contiguous()

    def schedule(steps, chains=None):
        gamma = schedules.transverse_field(3.0, 1e-8, steps, device=dev)
        teff = (1.0 / P) * P
        jp = schedules.jperp(gamma, teff).contiguous()
        if chains is not None:  # a J_perp a chain: rung c at 1 + c / chains
            jp = (jp[:, None] * (1.0 + torch.arange(
                chains, device=dev) / chains)).contiguous()
        return torch.ones_like(gamma), jp, teff

    def qmc_case(pg, chains, steps, per_chain=False, bath=False,
                 colored=False, gm=True):
        c = random_pm1(rng, (chains, P, pg.nspins), dev)
        b, jp, teff = schedule(steps, chains if per_chain else None)
        if bath:
            return c, lambda fn: fn(pg, b, jp, teff, bath40, c, 31, gm,
                                    colored=colored)
        return c, lambda fn: fn(pg, b, jp, teff, c, 31, gm)

    def record(kname, case, out, ref, start, launched, want):
        torch.cuda.synchronize()
        n_bad, err = mismatches([out], [ref])
        rec = {"phase": "generic_redesign", "kernel": kname, **case,
               "launches": launched, "mismatched_spins": n_bad,
               "max_abs_err": err,
               "flipped_fraction": float((out != start).float().mean())}
        emit(rec)
        check(n_bad == 0, f"{kname} ({rec}) equals its plain version")
        check(rec["flipped_fraction"] > 0, f"{kname} ({rec}) moves")
        check(launched == want, f"{kname} ({rec}) launched {launched}")
        results[kname]["max_abs_err"] = max(
            results[kname].get("max_abs_err", 0.0), err)

    # generic PIQMC and the bath, both routes
    cases = (
        ("generic_qmc", "gaussian_torus(81, 0), checkerboard", pg81,
         QMC_READS, GENERIC_QMC_STEPS, {}),
        ("generic_qmc_chain", gname80, pg80, QMC_READS, GENERIC_QMC_STEPS,
         {"per_chain": True}),
        ("generic_qmc", f"ring({EDGE_N})", pg_edge, 1, WIDE_STEPS, {}),
        ("generic_qmc_bath", f"ring({EDGE_BATH_N})", pg_edge_bath, 1,
         WIDE_STEPS, {"bath": True}),
        ("generic_qmc_wide", f"gaussian_torus({WIDE_L}, 0).to_generic()",
         pg_wide, 1, WIDE_STEPS, {}),
        ("generic_qmc_chain_wide",
         f"gaussian_torus({WIDE_L}, 0).to_generic()", pg_wide, 1,
         WIDE_STEPS, {"per_chain": True}),
        ("generic_qmc_bath_wide", f"gaussian_torus({WIDE_BATH_L}, 0)",
         pg_wide_lat, 1, WIDE_STEPS, {"bath": True}),
        ("generic_qmc_bath_wide", f"gaussian_torus({WIDE_BATH_L}, 0)",
         pg_wide_lat, 1, WIDE_STEPS, {"bath": True, "colored": True}),
    )
    for kname, gname, pg, chains, steps, kw in cases:
        start, run = qmc_case(pg, chains, steps, **kw)
        wrapper, plain = ((gk.generic_qmc_bath_anneal,
                           gk.generic_qmc_bath_anneal_ref) if kw.get("bath")
                          else (gk.generic_qmc_anneal,
                                gk.generic_qmc_anneal_ref))
        geometry = (gk.generic_qmc_bath_geometry if kw.get("bath")
                    else gk.generic_qmc_geometry)(
                        chains, pg.nspins, P, pg.num_colors,
                        sms=gk.card_sms(dev))
        _build.reset_launches()
        out = run(wrapper)
        launched = launched_now()
        ref = run(plain)
        record(kname, {"graph": gname, "nspins": pg.nspins,
                       "proper": pg.proper, "chains": chains, "slices": P,
                       "steps": steps, "geometry": geometry, **kw},
               out, ref, start, launched, {KERNELS[kname][0]: 1})

    # fk_line past P = 64, WC2 and WC3, two steps of both colors
    for slices in LINE_WIDE_SLICES:
        lut = schedules.bath_lookuptable(slices, CLUSTER_ALPHA, device=dev)
        for per_slice_seeds in (False, True):
            c, b, jp, teff = cluster_inputs(pg80, dev, rng, 2, slices, 2)
            t_eff = float(teff[0])
            p_pair, p_t = ck.line_tables(lut, jp, t_eff, slices, dev)
            out = ref = c
            _build.reset_launches()
            for t in range(2):
                for color in range(pg80.num_colors):
                    out = ck.line_phase(pg80, b, jp, p_t, t, t_eff, lut,
                                        p_pair, out, 24, t, color,
                                        per_slice_seeds)
            launched = launched_now()
            for t in range(2):
                for color in range(pg80.num_colors):
                    ref = cl.line_phase_ref(pg80, b[t], jp[t], t_eff, lut,
                                            ref, 24, t, color,
                                            per_slice_seeds, p_pair)
            record("fk_line_rows", {"graph": gname80, "chains": 2,
                                    "slices": slices, "steps": 2,
                                    "per_slice_seeds": per_slice_seeds,
                                    "warps_a_cta": ck.line_warps(slices)},
                   out, ref, c, launched,
                   {"fk_line_rows": 2 * pg80.num_colors})

    # a bath table not symmetric in ring distance: fk_label's space-time
    # sweep (each chain over 16 CTAs, labels in their shared memory) and
    # fk_line's WC3
    asym = asymmetric_table(P, dev)
    check(ck.ring_asymmetric(asym), "the hand-made table is asymmetric")
    c, b, jp, teff = cluster_inputs(pg80, dev, rng, 4, P, CLUSTER_STEPS)
    _build.reset_launches()
    out = ck.sw_anneal(pg80, b, jp, teff, c, 25, asym)
    launched = launched_now()
    ref = cl.sw_anneal_ref(pg80, b, jp, teff, c, 25, asym)
    record("fk_label", {"graph": gname80, "chains": 4, "slices": P,
                        "steps": CLUSTER_STEPS, "bath": "asymmetric",
                        "geometry": ck.card_label_geometry(
                            "fk_label", 4, P, pg80.nspins, dev, True,
                            True)},
           out, ref, c, launched, {"fk_label": 1})
    c, b, jp, teff = cluster_inputs(pg80, dev, rng, 4, P, 3)
    t_eff = float(teff[0])
    p_pair, p_t = ck.line_tables(asym, jp, t_eff, P, dev)
    out = ref = c
    _build.reset_launches()
    for t in range(3):
        for color in range(pg80.num_colors):
            out = ck.line_anneal(pg80, b, jp, p_t, t_eff, asym, p_pair, out,
                                 26, True, t0=t, steps=1,
                                 colors=range(color, color + 1))
    launched = launched_now()
    for t in range(3):
        for color in range(pg80.num_colors):
            ref = cl.line_phase_ref(pg80, b[t], jp[t], t_eff, asym, ref, 26,
                                    t, color, True, p_pair)
    record("fk_line", {"graph": gname80, "chains": 4, "slices": P,
                       "steps": 3, "per_slice_seeds": True,
                       "bath": "asymmetric"},
           out, ref, c, launched, {"fk_line": 3 * pg80.num_colors})

    # solve("piqmc_sw") at P = 128: one SA launch, a fk_line_rows launch a
    # color and sweep
    gtorus80 = graphs[gname80]
    _build.reset_launches()
    ss = solve(gtorus80, method="piqmc_sw", num_reads=SW_WIDE_READS,
               sweeps=SW_WIDE_SWEEPS, slices=SW_WIDE_SLICES, seed=0,
               alpha=CLUSTER_ALPHA)
    torch.cuda.synchronize()
    launched = launched_now()
    energies = np.asarray(ss.energies)
    samples = np.asarray(ss.samples)
    rec = {"phase": "generic_redesign", "path": "piqmc_sw",
           "slices": SW_WIDE_SLICES, "graph": gname80,
           "reads": SW_WIDE_READS, "sweeps": SW_WIDE_SWEEPS,
           "launches": launched,
           "mean_energy_per_spin": float(energies.mean()
                                         / gtorus80.nspins)}
    emit(rec)
    check(launched == {"packed_sa": 1,
                       "fk_line_rows": SW_WIDE_SWEEPS * gtorus80.num_colors},
          f"solve('piqmc_sw', slices={SW_WIDE_SLICES}) launched {launched}")
    check(samples.shape == (SW_WIDE_READS, gtorus80.nspins)
          and bool(np.all(np.isfinite(energies)))
          and np.allclose(energies, energy64(gtorus80, samples), rtol=1e-5,
                          atol=1e-3),
          f"solve('piqmc_sw', slices={SW_WIDE_SLICES}) gives spins and "
          "their energies")

    # the "_wide" routes' times, one chain at WIDE_L, beside their bounds
    for kname, pg, kw, taus, plain_taus in (
            ("generic_qmc_wide", pg_wide, {}, (2, 6), (1, 3)),
            ("generic_qmc_chain_wide", pg_wide, {"per_chain": True}, (2, 6),
             (1, 3)),
            ("generic_qmc_bath_wide", pg_wide_lat, {"bath": True}, (1, 3),
             (1, 2))):
        c = random_pm1(rng, (1, P, pg.nspins), dev)
        bath = kw.get("bath", False)
        wrapper, plain = ((gk.generic_qmc_bath_anneal,
                           gk.generic_qmc_bath_anneal_ref) if bath
                          else (gk.generic_qmc_anneal,
                                gk.generic_qmc_anneal_ref))

        def runner(fn, c=c, pg=pg, kw=kw, bath=bath):
            def run(tau):
                b, jp, teff = schedule(tau, 1 if kw.get("per_chain")
                                       else None)
                if bath:
                    return fn(pg, b, jp, teff, bath40, c, 7, True)
                return fn(pg, b, jp, teff, c, 7, True)
            return run
        base = "generic_qmc_bath" if bath else "generic_qmc"
        graph = graph_shape(pg)
        bound, bound_by, unit = bound_ms(base, 1, P, pg.nspins, max(taus),
                                         graph)
        for route, fn, tt, trials in (("cuda", wrapper, taus, 3),
                                      ("plain", plain, plain_taus, 2)):
            ms, best = slope_ms(runner(fn), tt, trials)
            emit({"phase": "generic_redesign", "kernel": kname,
                  "route": route, "chains": 1, "slices": P,
                  "sites": pg.nspins, "taus": list(tt),
                  "best_seconds": {str(k): v for k, v in best.items()},
                  "ms_per_sweep": ms, "bound_ms": bound,
                  "bound_by": bound_by, "bound_unit": unit, "gpu": name,
                  "power_limit": power})
            check(ms > 0, f"{kname} {route} slope is positive")
            if route == "cuda":
                results[kname].update(ms=ms, bound_ms=bound,
                                      bound_by=bound_by)
            else:
                results[kname]["plain_ms"] = ms

    # fk_line past P = 64: ms a step by the slope, 2 chains at the largest
    # of LINE_WIDE_SLICES, WC3, beside its bound
    slices = max(LINE_WIDE_SLICES)
    lut = schedules.bath_lookuptable(slices, CLUSTER_ALPHA, device=dev)
    c = random_pm1(rng, (2, slices, pg80.nspins), dev)

    def line_rows(fn):
        def run(tau):
            _, b, jp, teff = cluster_inputs(pg80, dev, rng, 1, slices, tau)
            t_eff = float(teff[0])
            p_pair, p_t = ck.line_tables(lut, jp, t_eff, slices, dev)
            return fn(pg80, b, jp, p_t, t_eff, lut, p_pair, c, 7, True)
        return run
    taus = (4, 12)
    bound, bound_by, unit = cluster_bound(
        "fk_line", 2, slices, pg80.nspins, graph_shape(graphs[gname80])[0],
        steps=max(taus))
    for route, fn, tt, trials in (("cuda", ck.line_anneal, taus, 3),
                                  ("plain", ck.line_anneal_ref, (1, 3), 2)):
        ms, best = slope_ms(line_rows(fn), tt, trials)
        emit({"phase": "generic_redesign", "kernel": "fk_line_rows",
              "route": route, "chains": 2, "slices": slices,
              "per_slice_seeds": True, "sites": pg80.nspins,
              "taus": list(tt),
              "best_seconds": {str(k): v for k, v in best.items()},
              "ms_per_step": ms, "bound_ms": bound, "bound_by": bound_by,
              "bound_unit": unit, "gpu": name, "power_limit": power})
        check(ms > 0, f"fk_line_rows {route} slope is positive")
        if route == "cuda":
            results["fk_line_rows"].update(ms=ms, bound_ms=bound,
                                           bound_by=bound_by)
        else:
            results["fk_line_rows"]["plain_ms"] = ms


def sa_dense_redesign(dev, results, graphs, torus, odd_torus, sk, tables,
                      power, name):
    """Phase sa_dense_redesign: generic SA's two routes and the dense
    in-block kernel against their plain versions on the card, 0 mismatched
    spins and exactly the route's launches:
      - the cluster route (csrc/generic_words.cuh's SA mode: a group of C
        chains as the bits of each site's word over a cluster of R CTAs)
        with the (C, R, threads) its rule chose on the card and the
        clusters the card holds at once: the 80x80 torus's generic form at
        SA_READS, 32 and 8 chains (the PIQMC pre-anneals), the 81x81
        torus's checkerboard (not a proper coloring), per-step tables,
        SA_PER_CHAIN_READS temperatures a chain (48 rungs of 8), the
        DISORDER_D x SA_READS // DISORDER_D disorder batch, chain0 =
        OFFSET_CHAIN0, energies on, and one-step launches (step0 = t, as
        the cluster solvers' local sweeps);
      - the file's first kernel, the "_wide" route, forced by a rule of
        shape that holds nothing: shared schedule, per-chain and per-step
        tables;
      - the dense in-block kernel (csrc/dense_sa.cu, h added inside) at
        the main path's DENSE_READS chains (systematic and shuffled, with
        the (chains a warp, warps a CTA) of its rule), DENSE_CHAIN_READS
        chains with a temperature a chain, block DENSE_SMALL_BLOCK and
        chain0 = OFFSET_CHAIN0.
    Then slope-times the "_wide" routes and their plain versions beside
    their bounds (the kernels line's rows) and the cluster route at 32 and
    8 chains beside kernel A on the same torus (`torus`) and chains. Last,
    the rule of size (`packed_sa_one_cta`): the chimera pre-anneal's and
    ICM's shapes run the first kernel, random_3d_lattice(16) at SA_READS
    the cluster route, each under the plain key, against its plain
    version, and slope-timed beside the other kernel forced."""
    import ctypes

    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.ops import dense_kernels as dk
    from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops
    from montecarlosolvers_tpu_torch.ops import split as split_ops
    from montecarlosolvers_tpu_torch.ops import split_kernels as sk_ops
    from montecarlosolvers_tpu_torch.parallel import disorder
    from montecarlosolvers_tpu_torch.solvers import sa

    rng = np.random.default_rng(23)
    gibbs = gibbs_tool()
    steps = SA_REDESIGN_STEPS
    gname80 = f"gaussian_torus({L}, 0).to_generic()"
    gtorus80 = graphs[gname80]
    pg80 = packed_ops.build_packed(gtorus80)
    pg81 = packed_ops.packed_from_lattice(odd_torus)
    n = pg80.nspins
    probs, _, states, generators = disorder_case(dev, steps)
    stacked, _ = disorder.stack_problems(probs)
    pg_d, nbr_jd, h_d = stacked.packed
    seeds_d = [sa.draw_seed(g) for g in generators()]
    tb = gk.packed_tables(pg80, tables[0][:steps], tables[1][:steps], 1,
                          steps, dev)
    ladder = torch.linspace(0.5, 2.0, SA_PER_CHAIN_READS, device=dev)

    def sched(tau, chains=None):
        t = schedules.linear(3.0, 0.0, tau, device=dev)
        return t if chains is None else (t[:, None] * ladder[None, :chains]
                                         ).contiguous()

    def record(kname, case, out, ref, start, launched, want, extra=None):
        torch.cuda.synchronize()
        n_bad, err = mismatches([out], [ref])
        rec = {"phase": "sa_dense_redesign", "kernel": kname, **case,
               "launches": launched, "mismatched_spins": n_bad,
               "max_abs_err": err,
               "flipped_fraction": float((out != start).float().mean()),
               **(extra or {})}
        emit(rec)
        check(n_bad == 0, f"{kname} ({rec}) equals its plain version")
        check(rec["flipped_fraction"] > 0, f"{kname} ({rec}) moves")
        check(launched == want, f"{kname} ({rec}) launched {launched}")
        results[kname]["max_abs_err"] = max(
            results[kname].get("max_abs_err", 0.0), err)

    # (graph name, packing, chains, mode, keyword arguments of the calls)
    cases = [(gname80, pg80, SA_READS, "shared", {}),
             (gname80, pg80, 32, "shared", {}),
             (gname80, pg80, 8, "shared", {}),
             (f"gaussian_torus({ODD_L}, 0), checkerboard", pg81, SA_READS,
              "shared", {}),
             (gname80, pg80, SA_READS, "noisy", {"tables": tb}),
             (gname80, pg80, SA_PER_CHAIN_READS, "per_chain", {}),
             (f"{DISORDER_D} x gaussian_torus({L}, d).to_generic()", pg_d,
              SA_READS, "disorder", {"disorder": (nbr_jd, h_d, seeds_d)}),
             (gname80, pg80, SA_READS, "chain0", {"chain0": OFFSET_CHAIN0}),
             (gname80, pg80, SA_READS, "energies", {}),
             (gname80, pg80, 32, "one_step", {})]
    wide = [("packed_sa_wide", gname80, pg80, SA_READS, "shared", {}),
            ("packed_sa_chain_wide", gname80, pg80, SA_PER_CHAIN_READS,
             "per_chain", {}),
            ("packed_sa_noisy_wide", gname80, pg80, SA_READS, "noisy",
             {"tables": tb})]
    own_rule = gk.packed_sa_geometry
    for kname, gname, pg, chains, mode, kw in (
            [("packed_sa", *c) for c in cases] + wide):
        if kname.endswith("_wide"):
            gk.packed_sa_geometry = lambda *a, **k: None
        try:
            per_chain = mode == "per_chain"
            key = ("packed_sa_chain" if per_chain else "packed_sa_noisy"
                   if mode == "noisy" else "packed_sa")
            if kname.endswith("_wide"):
                key += "_wide"
            d_chains = chains // DISORDER_D if mode == "disorder" else 0
            geometry = gk.card_packed_sa_geometry(pg, chains, d_chains,
                                                  per_chain, dev)
            resident = None
            if geometry is not None:
                lib = _build.library("packed_sa")
                count = ctypes.c_int(0)
                rc = lib.packed_sa_words_max_active_clusters(
                    geometry[1], geometry[2], gk.sa_words_smem_bytes(
                        gk.word_layout(pg, geometry[1])[3]),
                    int(per_chain), ctypes.byref(count))
                check(rc == 0, "cudaOccupancyMaxActiveClusters answers")
                resident = count.value
            start = (states.reshape(SA_READS, n) if mode == "disorder"
                     else random_pm1(rng, (chains, pg.nspins), dev))
            if mode == "disorder":
                start = packed_ops.pack_state(pg, start).contiguous()
            temps = sched(steps, chains if per_chain else None)
            es = es_plain = None
            if mode == "energies":
                es, es_plain = (torch.full((steps, chains), float("nan"),
                                           device=dev) for _ in range(2))

            def run(fn, es=None, temps=temps, start=start, kw=kw,
                    mode=mode):
                if mode == "one_step":
                    x = start
                    for t in range(steps):
                        x = fn(pg, temps[t:t + 1], x, 41, step0=t)
                    return x
                return fn(pg, temps, start, 41, energies=es, **kw)
            _build.reset_launches()
            out = run(gk.packed_sa_anneal, es)
            launched = launched_now()
            ref = run(gk.packed_sa_anneal_ref, es_plain)
        finally:
            gk.packed_sa_geometry = own_rule
        extra = {"geometry": geometry, "clusters_resident": resident}
        if es is not None:
            extra.update(energy_err=float((es - es_plain).abs().max()),
                         energy_bound=gibbs.ENERGY_RTOL
                         * gibbs.problem_scale(gtorus80))
            check(bool(torch.isfinite(es).all())
                  and extra["energy_err"] <= extra["energy_bound"],
                  f"packed_sa's energies within {extra['energy_bound']}")
        record(kname, {"graph": gname, "nspins": pg.nspins,
                       "colors": pg.num_colors, "proper": pg.proper,
                       "chains": chains, "steps": steps, "mode": mode},
               out, ref, start, launched,
               {key: steps if mode == "one_step" else 1}, extra)

    # the dense in-block kernel: (chains, block, shuffle, per chain,
    # chain0), SK sweeps of DENSE_STEPS
    for chains, block, shuffle, per_chain, chain0 in (
            (DENSE_READS, DENSE_BLOCK, False, False, 0),
            (DENSE_READS, DENSE_BLOCK, True, False, 0),
            (DENSE_CHAIN_READS, DENSE_BLOCK, False, True, 0),
            (DENSE_READS, DENSE_SMALL_BLOCK, False, False, 0),
            (DENSE_READS, DENSE_BLOCK, False, False, OFFSET_CHAIN0)):
        s = random_pm1(rng, (chains, DENSE_N), dev)
        temps = schedules.linear(3.0, 0.1, DENSE_STEPS, device=dev)
        if per_chain:
            temps = (temps[:, None] * torch.linspace(
                0.5, 2.0, chains, device=dev)[None, :]).contiguous()
        _build.reset_launches()
        out = dk.dense_sa_anneal(sk, temps, s, 43, block, shuffle,
                                 chain0=chain0)
        launched = launched_now()
        ref = dk.dense_sa_anneal_ref(sk, temps, s, 43, block, shuffle,
                                     chain0=chain0)
        kname = "dense_sa_chain" if per_chain else "dense_sa"
        record(kname, {"problem": f"sk_model({DENSE_N}, rng=0)",
                       "chains": chains, "steps": DENSE_STEPS,
                       "block": block, "shuffle": shuffle,
                       "chain0": chain0},
               out, ref, s, launched,
               {kname: DENSE_STEPS * -(-DENSE_N // block)},
               {"warps": dk.WARPS})

    # the "_wide" routes' times at the main path's widths, beside their
    # bounds and plain versions, and the cluster route at the pre-anneals'
    # chains beside kernel A at the same chains
    graph = graph_shape(gtorus80)
    tb_long = gk.packed_tables(pg80, tables[0][:WIDE_SA_TAUS[1]],
                               tables[1][:WIDE_SA_TAUS[1]], 1,
                               WIDE_SA_TAUS[1], dev)
    for kname, chains, mode in (("packed_sa_wide", SA_READS, "shared"),
                                ("packed_sa_chain_wide",
                                 SA_PER_CHAIN_READS, "per_chain"),
                                ("packed_sa_noisy_wide", SA_READS, "noisy")):
        s = random_pm1(rng, (chains, n), dev)

        def runner(fn, s=s, chains=chains, mode=mode):
            def run(tau):
                kw = ({"tables": (tb_long[0][:tau], tb_long[1][:tau], 1)}
                      if mode == "noisy" else {})
                return fn(pg80, sched(tau, chains if mode == "per_chain"
                                      else None), s, 7, **kw)
            return run
        tau = WIDE_SA_TAUS[1]
        f32, sfu = ops_per_sweep("packed_sa", chains, 1, n, graph)
        # the noisy anneal also reads its tables once
        moved = bytes_per_anneal("packed_sa", chains, 1, n, tau, graph) + (
            tau * n * (graph[1] + 1) * 4 if mode == "noisy" else 0)
        times = {"fp32": f32 / PEAK_FLOPS, "sfu": sfu / PEAK_SFU,
                 "bytes": moved / PEAK_BYTES / tau}
        unit = max(times, key=times.get)
        bound = 1e3 * times[unit]
        bound_by = "bytes" if unit == "bytes" else "operations"
        for route, fn, tt, trials in (
                ("cuda", gk.packed_sa_anneal, WIDE_SA_TAUS, 3),
                ("plain", gk.packed_sa_anneal_ref, (2, 6), 2)):
            if route == "cuda":
                gk.packed_sa_geometry = lambda *a, **k: None
            try:
                ms, best = slope_ms(runner(fn), tt, trials)
            finally:
                gk.packed_sa_geometry = own_rule
            emit({"phase": "sa_dense_redesign", "kernel": kname,
                  "route": route, "chains": chains, "sites": n,
                  "taus": list(tt),
                  "best_seconds": {str(k): v for k, v in best.items()},
                  "ms_per_sweep": ms, "bound_ms": bound,
                  "bound_by": bound_by, "bound_unit": unit, "gpu": name,
                  "power_limit": power})
            check(ms > 0, f"{kname} {route} slope is positive")
            if route == "cuda":
                results[kname].update(ms=ms, bound_ms=bound,
                                      bound_by=bound_by)
            else:
                results[kname]["plain_ms"] = ms
    sl = split_ops.build_split(torus)
    for chains in (32, 8):
        s = random_pm1(rng, (chains, n), dev)
        a, b = (x.contiguous() for x in split_ops.pack_classical(sl, s))
        packed = packed_ops.pack_state(pg80, s).contiguous()
        ms_packed = slope_ms(lambda tau: gk.packed_sa_anneal(
            pg80, sched(tau), packed, 7), FEW_SA_TAUS, 3)[0]
        ms_a = slope_ms(lambda tau: sk_ops.sa_split_anneal(
            sl, sched(tau), a, b, 7), FEW_SA_TAUS, 3)[0]
        emit({"phase": "sa_dense_redesign", "kernel": "packed_sa",
              "chains": chains, "geometry": gk.card_packed_sa_geometry(
                  pg80, chains, 0, False, dev),
              "ms_per_sweep": ms_packed, "split_sa_ms_per_sweep": ms_a,
              "ratio": ms_packed / ms_a,
              "bound_ms": bound_ms("packed_sa", chains, 1, n,
                                   FEW_SA_TAUS[1], graph)[0],
              "gpu": name, "power_limit": power})
        check(ms_packed > 0 and ms_a > 0,
              f"packed SA and kernel A at {chains} chains time")

    # the rule of size (gk.packed_sa_one_cta): the chimera pre-anneal's
    # shape and ICM's (two ladders of ICM_RUNGS x ICM_READS chains, a
    # temperature each) take the file's first kernel, one CTA a chain,
    # random_3d_lattice(16) at SA_READS the cluster route, all under the
    # plain keys; each against its plain version, then the rule's kernel
    # slope-timed beside the other one forced, and ICM's two-sweep call
    from montecarlosolvers_tpu_torch.models import instances
    own_small = gk.packed_sa_one_cta
    for gname, prob, chains, per_chain, one_cta in (
            ("chimera_graph(16, rng=0)", graphs["chimera_graph(16, rng=0)"],
             CHIMERA_READS, False, True),
            ("random_3d_lattice(12, rng=0)", instances.random_3d_lattice(
                12, rng=0, device=dev)[0], 2 * ICM_RUNGS * ICM_READS, True,
             True),
            ("random_3d_lattice(16, rng=0)",
             graphs["random_3d_lattice(16, rng=0)"], SA_READS, False,
             False)):
        pg = packed_ops.build_packed(prob)
        check(gk.packed_sa_one_cta(pg.nspins, pg.num_colors) == one_cta,
              f"the rule of size sends {gname} at {chains} chains to "
              + ("one CTA a chain" if one_cta else "the cluster route"))
        rungs = torch.linspace(0.5, 2.0, chains, device=dev)

        def table(tau, per_chain=per_chain, rungs=rungs):
            t = schedules.linear(3.0, 0.0, tau, device=dev)
            return (t[:, None] * rungs[None, :]).contiguous() if per_chain \
                else t
        s = random_pm1(rng, (chains, pg.nspins), dev)
        key = "packed_sa_chain" if per_chain else "packed_sa"
        _build.reset_launches()
        out = gk.packed_sa_anneal(pg, table(steps), s, 41)
        launched = launched_now()
        ref = gk.packed_sa_anneal_ref(pg, table(steps), s, 41)
        record(key, {"graph": gname, "nspins": pg.nspins,
                     "colors": pg.num_colors, "chains": chains,
                     "steps": steps, "mode": "rule_of_size"},
               out, ref, s, launched, {key: 1}, {"one_cta": one_cta})
        for forced in (one_cta, not one_cta):
            gk.packed_sa_one_cta = lambda *a, f=forced, **k: f
            try:
                ms = slope_ms(lambda tau: gk.packed_sa_anneal(
                    pg, table(tau), s, 7), WIDE_SA_TAUS, 3)[0]
                two = (event_ms(lambda: gk.packed_sa_anneal(
                    pg, table(2), s, 7), 30) if per_chain else None)
            finally:
                gk.packed_sa_one_cta = own_small
            emit({"phase": "sa_dense_redesign", "kernel": key,
                  "graph": gname, "chains": chains, "mode": "rule_of_size",
                  "route": "one_cta" if forced else "cluster",
                  "rule_choice": forced == one_cta, "ms_per_sweep": ms,
                  "two_sweep_call_ms": two, "gpu": name,
                  "power_limit": power})
            check(ms > 0, f"{key} on {gname} times")


def energy_svmc_redesign(dev, results, graphs, torus, odd_torus, tables,
                         power, name):
    """Phase energy_svmc_redesign: the two redesigned kernels against
    their plain versions on the card, at every listed shape, with exactly
    the route's launches:
      - the chain-bit energy kernel (csrc/energy.cuh::
        chain_bits_energy_kernel, K chains of a group a CTA) at
        ENERGY_BITS_CHAINS chains on the 80x80 torus, kernel A's C a word,
        at every K that divides C and at the K its rule chose
        (`words_energy_geometry`): every energy bitwise the energy kernel's
        on the unpacked halves (0 mismatched energies), within
        ENERGY_RTOL x sum |J| of the plain version; ms a call at the rule's
        K beside the halves kernel;
      - generic SVMC's cluster route (csrc/packed_svmc.cu::
        packed_svmc_cluster_kernel) with the (R, threads) its rule chose on
        the card and the clusters the card holds: the 80x80 torus's generic
        form at SVMC_READS chains (TF and uniform, energies, per-step
        tables at mcsteps 1 and 2, chain0 = OFFSET_CHAIN0, R forced to 1
        and 4), at 32 and 8 chains, the 81x81 checkerboard (not proper),
        random_3d_lattice(16), and chimera_graph(16) and the 9-color
        random_graph(2000, 12000), which the rule of size sends to the
        first kernel: angles by the ANGLE_MISMATCH rule, bitwise the file's
        first kernel on a proper packing; the first kernel ("_wide",
        forced by a rule that holds nothing) on the static and per-step
        tables.
    Then slope-times the "_wide" routes beside their plain versions and
    bounds (the kernels line's rows), the cluster route beside kernel 4
    on the same torus at SVMC_READS chains, in turns, and the rule of size
    (`packed_svmc_one_cta`): the 16 x 16 torus's generic form and the
    chimera at 128 chains on the first kernel, random_3d_lattice(12) on
    the cluster route, each against its plain version and timed beside
    the other kernel forced."""
    import ctypes

    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.ops import energy as energy_ops
    from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops
    from montecarlosolvers_tpu_torch.ops import split as split_ops
    from montecarlosolvers_tpu_torch.ops import split_kernels as sk_ops

    gibbs = gibbs_tool()
    rng = np.random.default_rng(24)
    phase = "energy_svmc_redesign"
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    # the energy kernel on kernel A's chain-bit words, every K
    sl = split_ops.build_split(torus)
    tol = gibbs.ENERGY_RTOL * float(torus.j_right.abs().sum()
                                    + torus.j_down.abs().sum()
                                    + torus.h_plane.abs().sum())
    own_k = sk_ops.words_energy_geometry
    for chains in ENERGY_BITS_CHAINS:
        C = sk_ops.chain_word_bits(chains)
        a, b = (x.contiguous() for x in split_ops.pack_classical(
            sl, random_pm1(rng, (chains, L * L), dev)))
        words = (sk_ops.pack_chain_bits(a, C), sk_ops.pack_chain_bits(b, C))
        want = energy_ops.halves_energy(sl, a, b)
        ref = sk_ops.words_energy_ref(sl, *words, chains, C)
        rule = own_k(chains, C, sms)
        for K in [k for k in sk_ops.ENERGY_CHAINS_A_CTA if C % k == 0]:
            sk_ops.words_energy_geometry = lambda *_, K=K: K
            try:
                _build.reset_launches()
                e = sk_ops.words_energy(sl, *words, chains, C)
                launched = launched_now()
                torch.cuda.synchronize()
                ms = (event_ms(lambda: sk_ops.words_energy(sl, *words,
                                                           chains, C), 200,
                               spin_cycles=100_000_000)
                      if K == rule else None)
            finally:
                sk_ops.words_energy_geometry = own_k
            n_bad = int((e != want).sum())
            err = float((e - ref).abs().max())
            rec = {"phase": phase, "kernel": "energy_chain_bits",
                   "chains": chains, "chains_a_word": C, "K": K,
                   "rule_K": rule, "ctas": -(-chains // C) * (C // K),
                   "launches": launched, "mismatched_energies": n_bad,
                   "max_abs_err": err, "tolerance": tol, "ms": ms}
            if ms is not None:
                rec["halves_kernel_ms"] = event_ms(
                    lambda: energy_ops.halves_energy(sl, a, b), 200,
                    spin_cycles=100_000_000)
                rec.update(gpu=name, power_limit=power)
            emit(rec)
            what = f"energy_chain_bits at {chains} chains, K = {K}"
            check(n_bad == 0, f"{what} equals the halves kernel bitwise")
            check(err <= tol, f"{what} within {tol} of its plain version")
            check(launched == {"energy_bits": 1},
                  f"{what} launched {launched}")
            results["energy_chain_bits"]["max_abs_err"] = max(
                results["energy_chain_bits"].get("max_abs_err", 0.0), err)

    # generic SVMC on both routes
    gname80 = f"gaussian_torus({L}, 0).to_generic()"
    gtorus80 = graphs[gname80]
    pg80 = packed_ops.build_packed(gtorus80)
    pg81 = packed_ops.packed_from_lattice(odd_torus)
    others = {g: packed_ops.build_packed(graphs[g]) for g in (
        "chimera_graph(16, rng=0)", "random_3d_lattice(16, rng=0)",
        "random_graph(2000, 12000, rng=0)")}
    steps = NOISY_STEPS

    def tables_of(pg, mcsteps):
        rows = steps // mcsteps
        return gk.packed_tables(pg, tables[0][:rows], tables[1][:rows],
                                mcsteps, steps, dev)

    def forced(R, pg):
        if R == "wide":
            return lambda *a, **k: None
        return lambda *a, **k: (R, gk.svmc_threads(pg.nspins, R,
                                                   pg.num_colors))

    # (kernel row, graph name, packing, chains, TF, mode, forced R)
    cases = [("packed_svmc", gname80, pg80, SVMC_READS, True, "static",
              None),
             ("packed_svmc", gname80, pg80, SVMC_READS, False, "static",
              None),
             ("packed_svmc", gname80, pg80, SVMC_READS, True, "energies",
              None),
             ("packed_svmc_noisy", gname80, pg80, SVMC_READS, True,
              "noisy1", None),
             ("packed_svmc_noisy", gname80, pg80, SVMC_READS, False,
              "noisy2", None),
             ("packed_svmc", gname80, pg80, SVMC_READS, True, "chain0",
              None),
             ("packed_svmc", gname80, pg80, SVMC_READS, True, "static", 1),
             ("packed_svmc", gname80, pg80, SVMC_READS, True, "static", 4),
             ("packed_svmc", gname80, pg80, 32, True, "static", None),
             ("packed_svmc", gname80, pg80, 8, True, "static", None),
             ("packed_svmc", f"gaussian_torus({ODD_L}, 0), checkerboard",
              pg81, 64, True, "energies", None)]
    cases += [("packed_svmc", g, pg, 64, True, "static", None)
              for g, pg in others.items()]
    cases += [("packed_svmc_wide", gname80, pg80, SVMC_READS, True,
               "static", "wide"),
              ("packed_svmc_noisy_wide", gname80, pg80, SVMC_READS, True,
               "noisy1", "wide")]
    own = gk.packed_svmc_geometry
    for kname, gname, pg, chains, tf, mode, R in cases:
        n = pg.nspins
        th = torch.as_tensor((rng.random((chains, n)) * np.pi).astype(
            np.float32), device=dev)
        a = schedules.linear(3.0, 1e-8, steps, device=dev)
        b = torch.full_like(a, 0.9)
        kw = ({"tables": tables_of(pg, int(mode[-1]))}
              if mode.startswith("noisy") else
              {"chain0": OFFSET_CHAIN0} if mode == "chain0" else {})
        es = es_plain = None
        if mode == "energies":
            es, es_plain = (torch.full((steps, chains), float("nan"),
                                       device=dev) for _ in range(2))
        if R is not None:
            gk.packed_svmc_geometry = forced(R, pg)
        try:
            geometry = gk.card_packed_svmc_geometry(pg, chains, dev)
            route = ("wide" if geometry is None else "one_cta"
                     if gk.packed_svmc_one_cta(n, pg.num_colors, pg.proper)
                     else "cluster")
            resident = None
            if geometry is not None:
                lib = _build.library("packed_svmc")
                count = ctypes.c_int(0)
                rc = lib.packed_svmc_max_active_clusters(
                    geometry[0], geometry[1], gk.svmc_smem_bytes(
                        gk.word_layout(pg, geometry[0])[3], pg.proper),
                    ctypes.byref(count))
                check(rc == 0, "cudaOccupancyMaxActiveClusters answers")
                resident = count.value
            _build.reset_launches()
            out = gk.packed_svmc_anneal(pg, a, b, SVMC_TEMP, th, 7, tf, es,
                                        **kw)
            launched = launched_now()
            gk.packed_svmc_geometry = forced("wide", pg)
            wide = gk.packed_svmc_anneal(pg, a, b, SVMC_TEMP, th, 7, tf, **kw)
        finally:
            gk.packed_svmc_geometry = own
        ref = gk.packed_svmc_anneal_ref(pg, a, b, SVMC_TEMP, th, 7, tf,
                                        es_plain, **kw)
        torch.cuda.synchronize()
        d = angle_diffs([out], [ref])
        rec = {"phase": phase, "kernel": kname, "graph": gname,
               "nspins": n, "colors": pg.num_colors, "proper": pg.proper,
               "chains": chains, "steps": steps, "tf": tf, "mode": mode,
               "forced_R": R, "route": route, "geometry": geometry,
               "clusters_resident": resident, "launches": launched, **d,
               "bitwise_first_kernel": bool(torch.equal(out, wide)),
               "moved_fraction": float((out - th).abs().gt(1e-3).float()
                                       .mean())}
        if es is not None:
            rec.update(energy_err=float((es - es_plain).abs().max()),
                       energy_bound=gibbs.ENERGY_RTOL * float(
                           pg.nbr_J.abs().sum() / 2 + pg.h.abs().sum()))
        emit(rec)
        what = f"{kname} on {gname}, {chains} chains ({mode}, R {R})"
        check(d["mismatched_angles"] == 0 and d["max_abs_err"] <= ANGLE_ATOL,
              f"{what} equals its plain version")
        check(rec["moved_fraction"] > 0.3, f"{what} moves")
        check(launched == {kname: 1}, f"{what} launched {launched}")
        if pg.proper:
            check(rec["bitwise_first_kernel"],
                  f"{what} equals the first kernel bitwise")
        if es is not None:
            check(bool(torch.isfinite(es).all())
                  and rec["energy_err"] <= rec["energy_bound"],
                  f"{what}: energies within {rec['energy_bound']}")
        results[kname]["max_abs_err"] = max(
            results[kname].get("max_abs_err", 0.0), d["max_abs_err"])

    # the "_wide" routes slope-timed beside their plain versions and
    # bounds, at the main path's widths
    graph = graph_shape(gtorus80)
    n = pg80.nspins
    jt, ht, _ = gk.packed_tables(pg80, *tables, 1, NOISY_SWEEPS, dev)
    th = torch.as_tensor((rng.random((SVMC_READS, n)) * np.pi).astype(
        np.float32), device=dev)

    def svmc_run(fn, noisy):
        def run(tau):
            a = schedules.linear(3.0, 1e-8, tau, device=dev)
            kw = {"tables": (jt[:tau], ht[:tau], 1)} if noisy else {}
            return fn(pg80, a, torch.ones_like(a), SVMC_TEMP, th, 7, True,
                      **kw)
        return run

    for kname, noisy in (("packed_svmc_wide", False),
                         ("packed_svmc_noisy_wide", True)):
        tau = WIDE_SVMC_TAUS[1]
        f32, sfu = ops_per_sweep("packed_svmc", SVMC_READS, 1, n, graph)
        moved = bytes_per_anneal("packed_svmc", SVMC_READS, 1, n, tau,
                                 graph) + (tau * n * (graph[1] + 1) * 4
                                           if noisy else 0)
        times = {"fp32": f32 / PEAK_FLOPS, "sfu": sfu / PEAK_SFU,
                 "bytes": moved / PEAK_BYTES / tau}
        unit = max(times, key=times.get)
        bound = 1e3 * times[unit]
        bound_by = "bytes" if unit == "bytes" else "operations"
        for route, fn, tt, trials in (
                ("cuda", gk.packed_svmc_anneal, WIDE_SVMC_TAUS, 3),
                ("plain", gk.packed_svmc_anneal_ref, (10, 40), 2)):
            if route == "cuda":
                gk.packed_svmc_geometry = forced("wide", pg80)
            try:
                ms, best = slope_ms(svmc_run(fn, noisy), tt, trials)
            finally:
                gk.packed_svmc_geometry = own
            emit({"phase": phase, "kernel": kname, "route": route,
                  "chains": SVMC_READS, "sites": n, "taus": list(tt),
                  "best_seconds": {str(k): v for k, v in best.items()},
                  "ms_per_sweep": ms, "bound_ms": bound,
                  "bound_by": bound_by, "bound_unit": unit, "gpu": name,
                  "power_limit": power})
            check(ms > 0, f"{kname} {route} slope is positive")
            if route == "cuda":
                results[kname].update(ms=ms, bound_ms=bound,
                                      bound_by=bound_by)
            else:
                results[kname]["plain_ms"] = ms

    # the cluster route beside kernel 4 on the same torus and chains, in
    # turns (cluster, kernel 4, kernel 4, cluster)
    ha, hb = (x.contiguous() for x in split_ops.pack_classical(sl, th))

    def split_run(tau):
        a = schedules.linear(3.0, 1e-8, tau, device=dev)
        return sk_ops.svmc_split_anneal(sl, a, torch.ones_like(a), SVMC_TEMP,
                                        ha, hb, 7, True)
    runs = {"packed_svmc": svmc_run(gk.packed_svmc_anneal, False),
            "split_svmc": split_run}
    got = {k: [] for k in runs}
    for k in ("packed_svmc", "split_svmc", "split_svmc", "packed_svmc"):
        got[k].append(slope_ms(runs[k], WIDE_SVMC_TAUS, 3)[0])
    emit({"phase": phase, "kernel": "packed_svmc", "chains": SVMC_READS,
          "geometry": gk.card_packed_svmc_geometry(pg80, SVMC_READS, dev),
          "ms_per_sweep": got["packed_svmc"],
          "split_svmc_ms_per_sweep": got["split_svmc"],
          "ratio": min(got["packed_svmc"]) / min(got["split_svmc"]),
          "bound_ms": bound_ms("packed_svmc", SVMC_READS, 1, n,
                               WIDE_SVMC_TAUS[1], graph)[0],
          "gpu": name, "power_limit": power})
    check(min(got["packed_svmc"]) > 0 and min(got["split_svmc"]) > 0,
          "generic SVMC and kernel 4 time")

    # the rule of size (gk.packed_svmc_one_cta): the 16 x 16 torus's
    # generic form and the chimera at 128 chains take the file's first
    # kernel, one CTA a chain, random_3d_lattice(12) at 32 chains the
    # cluster route, all under the plain key; each against its plain
    # version, then slope-timed beside the other kernel forced
    from montecarlosolvers_tpu_torch.models import instances
    own_small = gk.packed_svmc_one_cta
    for gname, prob, chains, one_cta in (
            ("gaussian_torus(16, 0).to_generic()", instances.gaussian_torus(
                16, seed=0, device=dev).to_generic(), 32, True),
            ("chimera_graph(16, rng=0)", graphs["chimera_graph(16, rng=0)"],
             128, True),
            ("random_3d_lattice(12, rng=0)", instances.random_3d_lattice(
                12, rng=0, device=dev)[0], 32, False)):
        pg = packed_ops.build_packed(prob)
        check(gk.packed_svmc_one_cta(pg.nspins, pg.num_colors) == one_cta,
              f"the rule of size sends {gname} at {chains} chains to "
              + ("one CTA a chain" if one_cta else "the cluster route"))
        th = torch.as_tensor((rng.random((chains, pg.nspins)) * np.pi)
                             .astype(np.float32), device=dev)
        a = schedules.linear(3.0, 1e-8, steps, device=dev)
        _build.reset_launches()
        out = gk.packed_svmc_anneal(pg, a, torch.ones_like(a), SVMC_TEMP, th,
                                    7, True)
        launched = launched_now()
        ref = gk.packed_svmc_anneal_ref(pg, a, torch.ones_like(a), SVMC_TEMP,
                                        th, 7, True)
        torch.cuda.synchronize()
        d = angle_diffs([out], [ref])
        emit({"phase": phase, "kernel": "packed_svmc", "graph": gname,
              "nspins": pg.nspins, "colors": pg.num_colors,
              "chains": chains, "steps": steps, "mode": "rule_of_size",
              "one_cta": one_cta, "launches": launched, **d})
        check(d["mismatched_angles"] == 0 and d["max_abs_err"] <= ANGLE_ATOL,
              f"packed_svmc on {gname} equals its plain version")
        check(launched == {"packed_svmc": 1},
              f"packed_svmc on {gname} launched {launched}")
        results["packed_svmc"]["max_abs_err"] = max(
            results["packed_svmc"].get("max_abs_err", 0.0),
            d["max_abs_err"])

        def run(tau, pg=pg, th=th):
            a = schedules.linear(3.0, 1e-8, tau, device=dev)
            return gk.packed_svmc_anneal(pg, a, torch.ones_like(a),
                                         SVMC_TEMP, th, 7, True)
        for forced_cta in (one_cta, not one_cta):
            gk.packed_svmc_one_cta = lambda *a, f=forced_cta, **k: f
            try:
                ms = slope_ms(run, WIDE_SVMC_TAUS, 3)[0]
            finally:
                gk.packed_svmc_one_cta = own_small
            emit({"phase": phase, "kernel": "packed_svmc", "graph": gname,
                  "chains": chains, "mode": "rule_of_size",
                  "route": "one_cta" if forced_cta else "cluster",
                  "rule_choice": forced_cta == one_cta, "ms_per_sweep": ms,
                  "gpu": name, "power_limit": power})
            check(ms > 0, f"packed_svmc on {gname} times")


def houdayer_line_redesign(dev, results, gtorus, odd_torus, power, name):
    """Phase houdayer_line_redesign: the three kernels this slice changed,
    against their plain versions on the card at the main path's widths,
    with exactly each route's launches:
      - generic SVMC's first kernel (csrc/packed_svmc.cu::
        packed_svmc_kernel, "_wide", forced by a rule that holds nothing)
        on the 81x81 torus's checkerboard, which is not proper: SVMC_READS
        chains, TF, its phases' snapshots of cos; angles by the
        ANGLE_MISMATCH rule;
      - the Houdayer move's cluster kernel (csrc/houdayer.cu::
        houdayer_cluster_kernel) at its rule's R on replicas in site order
        and in place on a packed state through a permuted ror, and its
        first kernel ("houdayer_wide", forced), at ICM's pairs
        (random_3d_lattice(12, rng=0): ICM_RUNGS and ICM_READS x
        ICM_RUNGS, the ICM solve's) and PT_RUNGS pairs of the 80x80
        torus's generic form, pair0 0 and OFFSET_CHAIN0: spins and flipped
        counts bitwise;
      - fk_line's cluster kernel (csrc/fk_line.cu::fk_line_cluster_kernel,
        one launch an anneal) and its first kernel ("fk_line_wide",
        forced, one launch a phase) at the piqmc_sw solve's shape
        (CLUSTER_QMC_READS chains, P = CLUSTER_SLICES, the 80x80 torus's
        generic form, CLUSTER_ALPHA), WC3 and WC2, chain0 0 and
        OFFSET_CHAIN0: spins bitwise line_phase_ref's, phase by phase.
    Then times each, queued behind a spin kernel (the Houdayer move a
    call, fk_line a step by the slope over two anneal lengths), beside its
    plain version and its bound; fk_line's also beside the floor of its
    pair hashes (HASH_OPS a uniform over the INT32 rate, one a bath pair:
    `hash_ms`). The kernels line takes the ICM solve's Houdayer shape and
    the WC3 fk_line rows."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.ops import cluster as cl
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck
    from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops

    phase = "houdayer_line_redesign"
    rng = np.random.default_rng(25)
    spin = 100_000_000

    def forced(module, attr, value, run):
        own = getattr(module, attr)
        setattr(module, attr, value)
        try:
            return run()
        finally:
            setattr(module, attr, own)

    # generic SVMC's first kernel on an improper packing
    pg81 = packed_ops.packed_from_lattice(odd_torus)
    check(not pg81.proper, "the 81x81 checkerboard is not proper")
    steps = 200
    theta = torch.as_tensor(rng.uniform(0, np.pi, (SVMC_READS, pg81.nspins))
                            .astype(np.float32), device=dev)
    a = schedules.linear(3.0, 1e-8, steps, device=dev)
    b = torch.ones_like(a)
    _build.reset_launches()
    out = forced(gk, "packed_svmc_geometry", lambda *x, **k: None,
                 lambda: gk.packed_svmc_anneal(pg81, a, b, SVMC_TEMP, theta,
                                               7, True))
    launched = launched_now()
    ref = gk.packed_svmc_anneal_ref(pg81, a, b, SVMC_TEMP, theta, 7, True)
    torch.cuda.synchronize()
    diffs = angle_diffs((out,), (ref,))
    emit({"phase": phase, "kernel": "packed_svmc_wide",
          "graph": "gaussian_torus(81, seed=0), checkerboard (not proper)",
          "chains": SVMC_READS, "steps": steps, "launches": launched,
          **diffs, "gpu": name, "power_limit": power})
    check(launched == {"packed_svmc_wide": 1},
          f"SVMC's first kernel forced launched {launched}")
    check(diffs["mismatched_angles"] == 0
          and diffs["max_abs_err"] <= ANGLE_ATOL,
          "SVMC's first kernel on an improper packing equals its plain "
          "version")
    results["packed_svmc_wide"]["max_abs_err"] = max(
        results["packed_svmc_wide"].get("max_abs_err", 0.0),
        diffs["max_abs_err"])

    # the Houdayer move: both routes, in site order and in place
    glass = instances.random_3d_lattice(12, rng=0, device=dev)[0]
    gname3 = "random_3d_lattice(12, rng=0)"
    for gname, prob, pairs in ((gname3, glass, ICM_READS * ICM_RUNGS),
                               (gname3, glass, ICM_RUNGS),
                               (f"gaussian_torus({L}, 0).to_generic()",
                                gtorus, PT_RUNGS)):
        n = prob.nspins
        pg = packed_ops.build_packed(prob)
        geometry = ck.card_houdayer_geometry(pairs, n, dev)
        s1, s2 = (random_pm1(rng, (pairs, n), dev) for _ in range(2))
        state = random_pm1(rng, (2 * pairs, n), dev)
        ror = torch.as_tensor(np.stack([rng.permutation(pairs)
                                        for _ in range(2)])[None],
                              device=dev)
        for pair0 in (0, OFFSET_CHAIN0):
            want = cl.houdayer_move_ref(prob, s1, s2, 41, 7, pair0)
            _build.reset_launches()
            got = ck.houdayer_move(prob, s1, s2, 41, 7, pair0=pair0)
            l_site = launched_now()
            _build.reset_launches()
            first = forced(ck, "card_houdayer_geometry",
                           lambda *x, **k: None,
                           lambda: ck.houdayer_move(prob, s1, s2, 41, 7,
                                                    pair0=pair0))
            l_first = launched_now()
            want_p, want_f = ck.houdayer_move_packed_ref(
                prob, pg, state, ror, 43, 9, pair0)
            moved = state.clone()
            _build.reset_launches()
            got_p, got_f = ck.houdayer_move_packed(prob, pg, moved, ror, 43,
                                                   9, pair0)
            l_packed = launched_now()
            torch.cuda.synchronize()
            n_site, err = mismatches(got[:2], want[:2])
            n_first, _ = mismatches(first[:2], want[:2])
            n_packed, _ = mismatches((got_p,), (want_p,))
            rec = {"phase": phase, "kernel": "houdayer", "graph": gname,
                   "nspins": n, "pairs": pairs, "pair0": pair0,
                   "geometry": geometry, "launches": l_site,
                   "first_kernel_launches": l_first,
                   "in_place_launches": l_packed,
                   "mismatched_spins": n_site,
                   "first_kernel_mismatched_spins": n_first,
                   "in_place_mismatched_spins": n_packed,
                   "flips_equal": bool(torch.equal(got[2], want[2])
                                       and torch.equal(first[2], want[2])
                                       and torch.equal(got_f, want_f)),
                   "in_place": got_p.data_ptr() == moved.data_ptr(),
                   "flipped_fraction": float(want[2].sum()) / (pairs * n)}
            what = f"houdayer on {gname}, {pairs} pairs, pair0 {pair0}"
            check(n_site == n_first == n_packed == 0 and rec["flips_equal"],
                  f"{what}: both routes and the in-place move equal their "
                  f"plain versions")
            check(rec["in_place"] and rec["flipped_fraction"] > 0,
                  f"{what} moves in place and flips")
            check(l_site == l_packed == {"houdayer": 1}
                  and l_first == {"houdayer_wide": 1},
                  f"{what} launched {l_site}, {l_packed}, {l_first}")
            if pair0 == 0:
                moved = state.clone()
                rec["ms"] = event_ms(lambda: ck.houdayer_move_packed(
                    prob, pg, moved, ror, 43, 9), 200, spin)
                rec["site_order_ms"] = event_ms(lambda: ck.houdayer_move(
                    prob, s1, s2, 41, 7), 200, spin)
                rec["first_kernel_ms"] = forced(
                    ck, "card_houdayer_geometry", lambda *x, **k: None,
                    lambda: event_ms(lambda: ck.houdayer_move(
                        prob, s1, s2, 41, 7), 200, spin))
                rec["plain_ms"] = event_ms(lambda: ck.houdayer_move_packed_ref(
                    prob, pg, state, ror, 43, 9), 3)
                bound, bound_by, _ = houdayer_bound(
                    pairs, n, int(prob.nbr_idx.shape[1]))
                rec.update(bound_ms=bound, bound_by=bound_by, gpu=name,
                           power_limit=power)
                for key, ms_key in (("houdayer", "ms"),
                                    ("houdayer_wide", "first_kernel_ms")):
                    if "ms" not in results[key]:
                        results[key].update(ms=rec[ms_key],
                                            plain_ms=rec["plain_ms"],
                                            bound_ms=bound,
                                            bound_by=bound_by)
            emit(rec)
            for key in ("houdayer", "houdayer_wide"):
                results[key]["max_abs_err"] = max(
                    results[key].get("max_abs_err", 0.0), err)

    # fk_line: one launch an anneal against the plain version's phases
    pg = packed_ops.build_packed(gtorus)
    n, P, chains = pg.nspins, CLUSTER_SLICES, CLUSTER_QMC_READS
    degree = graph_shape(gtorus)[0]
    lut = schedules.bath_lookuptable(P, CLUSTER_ALPHA, device=dev)
    confs = random_pm1(rng, (chains, P, n), dev)

    def line_inputs(tau):
        _, b, jp, teff = cluster_inputs(pg, dev, rng, 1, P, tau)
        t_eff = float(teff[0])
        p_pair, p_t = ck.line_tables(lut, jp, t_eff, P, dev)
        return b, jp, p_t, t_eff, p_pair

    def anneal(fn, tau, wc3, chain0=0):
        b, jp, p_t, t_eff, p_pair = line_inputs(tau)
        return fn(pg, b, jp, p_t, t_eff, lut, p_pair, confs, 13, wc3,
                  chain0=chain0)

    for wc3 in (True, False):
        for chain0 in (0, OFFSET_CHAIN0):
            want = anneal(ck.line_anneal_ref, 3, wc3, chain0)
            _build.reset_launches()
            got = anneal(ck.line_anneal, 3, wc3, chain0)
            l_cluster = launched_now()
            _build.reset_launches()
            first = forced(ck, "card_line_geometry", lambda *x, **k: None,
                           lambda: anneal(ck.line_anneal, 3, wc3, chain0))
            l_first = launched_now()
            torch.cuda.synchronize()
            n_bad, err = mismatches((got,), (want,))
            n_first, _ = mismatches((first,), (want,))
            rec = {"phase": phase, "kernel": "fk_line",
                   "graph": f"gaussian_torus({L}, 0).to_generic()",
                   "chains": chains, "slices": P, "steps": 3,
                   "per_slice_seeds": wc3, "chain0": chain0,
                   "geometry": ck.card_line_geometry(pg, chains, P, dev, wc3),
                   "launches": l_cluster, "first_kernel_launches": l_first,
                   "mismatched_spins": n_bad,
                   "first_kernel_mismatched_spins": n_first,
                   "changed_spins": int((got != confs).sum())}
            what = f"fk_line {'WC3' if wc3 else 'WC2'} chain0 {chain0}"
            check(n_bad == n_first == 0 and rec["changed_spins"] > 0,
                  f"{what}: both routes equal line_phase_ref phase by phase")
            check(l_cluster == {"fk_line": 1}
                  and l_first == {"fk_line_wide": 3 * pg.num_colors},
                  f"{what} launched {l_cluster}, {l_first}")
            if chain0 == 0:
                taus = (10, 30)
                rec["ms_per_step"] = slope_ms(
                    lambda tau: anneal(ck.line_anneal, tau, wc3), taus,
                    3)[0]
                rec["first_kernel_ms_per_step"] = forced(
                    ck, "card_line_geometry", lambda *x, **k: None,
                    lambda: slope_ms(lambda tau: anneal(ck.line_anneal, tau,
                                                        wc3), taus, 3)[0])
                rec["plain_ms_per_step"] = slope_ms(
                    lambda tau: anneal(ck.line_anneal_ref, tau, wc3), (1, 3),
                    2)[0]
                bound, bound_by, unit = cluster_bound("fk_line", chains, P, n,
                                                      degree, steps=max(taus))
                rec.update(bound_ms=bound, bound_by=bound_by, bound_unit=unit,
                           hash_ms=1e3 * HASH_OPS * chains * n * P * (P - 1)
                           / 2 / PEAK_INT32, gpu=name, power_limit=power)
                if wc3:
                    for key, ms_key in (("fk_line", "ms_per_step"),
                                        ("fk_line_wide",
                                         "first_kernel_ms_per_step")):
                        results[key].update(ms=rec[ms_key],
                                            plain_ms=rec["plain_ms_per_step"],
                                            bound_ms=bound, bound_by=bound_by)
            emit(rec)
            for key in ("fk_line", "fk_line_wide"):
                results[key]["max_abs_err"] = max(
                    results[key].get("max_abs_err", 0.0), err)


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
        fb = ds.block_product(sp, Jp, 0, B)
        temps = schedules.linear(3.0, 0.1, 1, device=dev)
        nblocks = Jp.shape[0] // B
        # the launch is shorter than the wrapper's host time: queued
        block_ms = event_ms(lambda: dk.dense_sa_block(sp, fb, hp, Jp, 0,
                                                      temps, 0, 7), 200,
                            spin_cycles=200_000_000)
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

    # Wolff: rule "local" at the bench's 16 chains, with the bath and with
    # a bath table not symmetric in ring distance, rule "full", and the
    # classical cluster (P = 1, Gamma = inf) at 64 chains
    for chains, slices, rule, bath in ((16, P, "local", False),
                                       (4, P, "local", True),
                                       (4, P, "local", "asymmetric"),
                                       (4, P, "full", False),
                                       (CLUSTER_SA_READS, 1, "local", False)):
        c, b, jp, teff = cluster_inputs(pg, dev, rng, chains, slices, steps,
                                        classical=slices == 1)
        table = (asymmetric_table(P, dev) if bath == "asymmetric"
                 else lut if bath else None)
        vis, vis_ref = (torch.zeros(chains, dtype=torch.int64, device=dev)
                        for _ in range(2))
        _build.reset_launches()
        out = ck.wolff_anneal(pg, b, jp, teff, c, 21, rule, table, 0, vis)
        launched = launched_now()
        ref = cl.wolff_anneal_ref(pg, b, jp, teff, c, 21, rule, table, 0,
                                  vis_ref)
        record("fk_wolff", {"chains": chains, "slices": slices, "rule": rule,
                            "bath": bath, "steps": steps,
                            "geometry": ck.card_label_geometry(
                                "fk_wolff", chains, slices, pg.nspins, dev,
                                table is not None, rule_full=rule == "full")},
               out, ref, c,
               launched, {"fk_wolff": 1},
               {"mean_cluster_sites": float(vis.double().mean()) / steps})
        check(torch.equal(vis, vis_ref), "fk_wolff counts its clusters as "
                                         "its plain version")
    # Swendsen-Wang: classical and space-time at P = 40 with and without a
    # bath, each chain over the cluster of label_geometry
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
                            "geometry": ck.card_label_geometry(
                                "fk_label", chains, slices, pg.nspins, dev,
                                bath)},
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
                out = ck.line_anneal(pg, b, jp, p_t, t_eff, lut, p_pair, out,
                                     23, per_slice_seeds, t0=t, steps=1,
                                     colors=range(color, color + 1))
        launched = launched_now()
        for t in range(3):
            for color in range(pg.num_colors):
                ref = cl.line_phase_ref(pg, b[t], jp[t], t_eff, lut, ref,
                                        23, t, color, per_slice_seeds,
                                        p_pair)
        record("fk_line", {"chains": 16, "slices": P, "steps": 3,
                           "per_slice_seeds": per_slice_seeds}, out, ref,
               c, launched, {"fk_line": 3 * pg.num_colors})


def last_on_chip(P, asym, sms, chains=1):
    """The most sites n of `chains` chains of P x n whose union-find
    cluster_kernels.label_geometry keeps in the CTAs' shared memory, by
    bisection on the rule."""
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck

    lo, hi = 1, 10 ** 7
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = ((mid, hi) if ck.label_geometry(chains, P, mid, asym,
                                                 sms)[2] else (lo, mid))
    return lo


def cluster_redesign(dev, results, gtorus):
    """Phase cluster_redesign: fk_wolff and fk_label, each chain over a
    thread-block cluster, at the boundary shapes of label_geometry, against
    their plain versions on the card: one chain on a ring of the last
    length whose union-find stays in the 16 CTAs' shared memory and of the
    first past it (its regions in device memory), from ring_ground_state,
    at P = 1 (T: 1 -> 0.5) and at P = CLUSTER_SLICES on asymmetric_table
    (fk_label's labels beside its parents); and the rule forced to one CTA a chain and
    to 16 on the 80x80 torus's generic form at P = CLUSTER_SLICES on
    asymmetric_table. 0 mismatched spins, the same cluster sizes, one
    launch each."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.ops import cluster as cl
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck
    from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops

    sms = gk.card_sms(dev)
    rng = np.random.default_rng(9)
    P = CLUSTER_SLICES
    asym = asymmetric_table(P, dev)

    def run(kname, pg, c, b, jp, teff, lut, case):
        classical = c.shape[1] == 1
        vis, vis_ref = (torch.zeros(c.shape[0], dtype=torch.int64,
                                    device=dev) for _ in range(2))
        _build.reset_launches()
        if kname == "fk_wolff":
            out = ck.wolff_anneal(pg, b, jp, teff, c, 31, "local", lut, 0,
                                  vis)
        else:
            out = ck.sw_anneal(pg, b, jp, teff, c, 32, lut, 0, classical)
        launched = launched_now()
        if kname == "fk_wolff":
            ref = cl.wolff_anneal_ref(pg, b, jp, teff, c, 31, "local", lut,
                                      0, vis_ref)
        else:
            ref = cl.sw_anneal_ref(pg, b, jp, teff, c, 32, lut, 0, classical)
        torch.cuda.synchronize()
        n_bad, err = mismatches([out], [ref])
        rec = {"phase": "cluster_redesign", "kernel": kname, **case,
               "chains": c.shape[0], "slices": c.shape[1],
               "sites": pg.nspins, "steps": b.shape[0],
               "launches": launched, "mismatched_spins": n_bad,
               "max_abs_err": err,
               "flipped_fraction": float((out != c).float().mean())}
        if kname == "fk_wolff":
            rec["mean_cluster_sites"] = float(vis.double().mean()) / \
                b.shape[0]
        emit(rec)
        check(n_bad == 0, f"{kname} ({rec}) equals its plain version")
        check(rec["flipped_fraction"] > 0, f"{kname} ({rec}) moves")
        check(launched == {kname: 1}, f"{kname} ({rec}) launched once")
        check(torch.equal(vis, vis_ref), f"{kname} ({rec}) counts its "
                                         "clusters as its plain version")
        results[kname]["max_abs_err"] = max(
            results[kname].get("max_abs_err", 0.0), err)

    # the boundary of shared memory, one chain over 16 CTAs, from a state
    # whose bonds are all satisfied (clusters of many sites)
    for slices, table in ((1, None), (P, asym)):
        for kname in ("fk_wolff", "fk_label"):
            directed = table is not None and kname == "fk_label"
            last = last_on_chip(slices, directed, sms)
            for n in (last, last + 1):
                pg = packed_ops.build_packed(ring_problem(n, dev))
                c = packed_ops.pack_state(pg, torch.as_tensor(
                    np.tile(ring_ground_state(n), (1, slices, 1)),
                    device=dev)).contiguous()
                if slices == 1:
                    teff = schedules.linear(1.0, 0.5, 3, device=dev)
                    b, jp = torch.ones_like(teff), torch.zeros_like(teff)
                else:
                    gamma = schedules.transverse_field(3.0, 1.0, 3,
                                                       device=dev)
                    b, teff = torch.ones_like(gamma), torch.ones_like(gamma)
                    jp = schedules.jperp(gamma, 1.0).contiguous()
                geometry = ck.card_label_geometry(
                    kname, 1, slices, n, dev, table is not None, directed)
                check(geometry[2] == (n == last),
                      f"{kname} at n = {n}, P = {slices}: the union-find "
                      f"on chip iff n <= {last} ({geometry})")
                run(kname, pg, c, b, jp, teff, table,
                    {"graph": f"ring_problem({n})", "geometry": geometry,
                     "bath": "asymmetric" if table is not None else False,
                     "on_chip": geometry[2]})
    # the rule forced to one CTA a chain and to 16
    pg80 = packed_ops.build_packed(gtorus)
    rule = ck.label_geometry
    for R in (1, 16):
        def forced(chains, P, n, asym=False, sms=ck.NUM_SMS, resident=None,
                   R=R):
            return ck.label_shape(R, P, n, asym)
        ck.label_geometry = forced
        try:
            for kname in ("fk_wolff", "fk_label"):
                c, b, jp, teff = cluster_inputs(pg80, dev, rng, 2, P, 3)
                run(kname, pg80, c, b, jp, teff, asym,
                    {"graph": f"gaussian_torus({L}, 0).to_generic()",
                     "bath": "asymmetric", "forced_R": R,
                     "geometry": ck.label_geometry(2, P, pg80.nspins,
                                                   kname == "fk_label",
                                                   sms)})
        finally:
            ck.label_geometry = rule


def cluster_bound(kname, chains, slices, sites, degree, visited=None,
                  bath=False, steps=1):
    """(least ms of one step, "bytes" or "operations", unit) of a cluster
    kernel at this shape, as the work needs it:
      fk_wolff  the bonds drawn from the `visited` (chains x per step)
                cluster sites, each shared by at most two of them: (degree
                + 2) / 2 exponentials a site, and with a bath (P - 1) / 2
                pairs a site, a comparison each against the step's table
                of 2 (P - 1) probabilities (exponentials once a chain);
                bytes: each visited site read and written;
      fk_label  every bond of the graph drawn once: degree / 2 spatial, one
                Trotter (P > 1) and one ghost a site, an exponential each,
                and with a bath (P - 1) / 2 pairs a site, a comparison each
                against the table of 2 (P - 1) probabilities a chain that
                the kernel builds once a step (the pair's probability
                depends only on its ring offset, the spins' agreement and
                T_eff); bytes: the state read and written;
      fk_line   no exponential (the host's table holds the bath pairs'
                probabilities): a site's field (degree adds), its pair
                comparisons (P - 1), the cluster sum (P adds) as float32
                operations, one logarithm a slice (its accept); a hash
                (HASH_OPS integer operations) a bath pair, P (P - 1) / 2 a
                line, at the INT32 rate (the Trotter bonds' and accepts'
                draws left out); bytes: the state read and written once
                an anneal of `steps` steps (the cluster kernel's one
                launch; the per-phase kernels move it every step, which
                the work does not need).
    The exponentials and logarithms run at the special-function rate."""
    P = slices
    f32 = int32 = 0.0
    pairs = (P - 1) / 2 if bath else 0
    table = chains * 2 * (P - 1) if bath else 0
    if kname == "fk_wolff":
        sfu = visited * (degree + 2) / 2 + table
        f32 = visited * pairs
        moved = visited * 8
    elif kname == "fk_label":
        sfu = chains * P * sites * (degree / 2 + (1 if P > 1 else 0) + 1) \
            + table
        f32 = chains * P * sites * pairs
        moved = chains * P * sites * 8
    else:
        f32 = chains * P * sites * (degree + (P - 1) + P)
        sfu = chains * P * sites
        int32 = HASH_OPS * chains * sites * P * (P - 1) / 2
        moved = chains * P * sites * 8 / steps
    times = {"fp32": f32 / PEAK_FLOPS, "sfu": sfu / PEAK_SFU,
             "int32": int32 / PEAK_INT32, "bytes": moved / PEAK_BYTES}
    unit = max(times, key=times.get)
    return 1e3 * times[unit], ("bytes" if unit == "bytes"
                               else "operations"), unit


def cluster_timing(dev, results, gtorus, power, name):
    """Slope ms a step of fk_wolff (one chain and 16, P = 40: the bench's
    two Wolff shapes, and the classical cluster at sa_wolff's 64 chains,
    P = 1), fk_label (the space-time sweep at the PIQMC solves' 8 chains,
    P = 40, without and with the bath at CLUSTER_ALPHA, and the classical
    sweep at 64 chains) and fk_line (a WC3 and a WC2 step, both colors, one
    chain at P = 40: the bench's shape), and of their plain versions (one
    a shape), beside each bound (`cluster_bound`); the kernels line takes
    the first row of each."""
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

    def wolff_runner(fn, chains, slices=P):
        c = random_pm1(rng, (chains, slices, n), dev)
        vis = torch.zeros(chains, dtype=torch.int64, device=dev)

        def run(tau):
            _, b, jp, teff = cluster_inputs(pg, dev, rng, 1, slices, tau,
                                            classical=slices == 1)
            vis.zero_()
            return fn(pg, b, jp, teff, c, 7, "local", None, 0, vis)
        return run, vis

    def label_runner(fn, chains, slices, bath=False):
        c = random_pm1(rng, (chains, slices, n), dev)

        def run(tau):
            _, b, jp, teff = cluster_inputs(pg, dev, rng, 1, slices, tau,
                                            classical=slices == 1)
            return fn(pg, b, jp, teff, c, 7, lut if bath else None, 0,
                      slices == 1)
        return run

    def line_runner(anneal, per_slice_seeds):
        c = random_pm1(rng, (1, P, n), dev)

        def run(tau):
            _, b, jp, teff = cluster_inputs(pg, dev, rng, 1, P, tau)
            t_eff = float(teff[0])
            p_pair, p_t = ck.line_tables(lut, jp, t_eff, P, dev)
            return anneal(pg, b, jp, p_t, t_eff, lut, p_pair, c, 7,
                          per_slice_seeds)
        return run

    rows = []
    for chains, slices in ((1, P), (16, P), (CLUSTER_SA_READS, 1)):
        run, vis = wolff_runner(ck.wolff_anneal, chains, slices)
        rows.append(("fk_wolff", "cuda", run, (30, 90), 3, chains, slices,
                     vis))
        # the plain versions take 8-60 ms a step: taus far enough apart
        # that the host's jitter does not swamp the slope
        run_p, vis_p = wolff_runner(cl.wolff_anneal_ref, chains, slices)
        rows.append(("fk_wolff", "plain", run_p, (2, 6), 2, chains, slices,
                     vis_p))
    for chains, slices, bath in ((CLUSTER_QMC_READS, P, False),
                                 (CLUSTER_SA_READS, 1, False),
                                 (CLUSTER_QMC_READS, P, True)):
        rows.append(("fk_label", "cuda", label_runner(ck.sw_anneal, chains,
                                                      slices, bath),
                     (10, 30), 3, chains, slices, bath))
        rows.append(("fk_label", "plain", label_runner(cl.sw_anneal_ref,
                                                       chains, slices, bath),
                     (1, 4), 2, chains, slices, bath))
    for per_slice_seeds in (True, False):
        rows.append(("fk_line", "cuda", line_runner(ck.line_anneal,
                                                    per_slice_seeds),
                     (20, 80), 3, 1, P, per_slice_seeds))
        rows.append(("fk_line", "plain", line_runner(ck.line_anneal_ref,
                                                     per_slice_seeds),
                     (2, 8), 2, 1, P, per_slice_seeds))
    for kname, route, run, taus, trials, chains, slices, extra in rows:
        ms, best = slope_ms(run, taus, trials)
        rec = {"phase": "timing", "kernel": kname, "route": route,
               "graph": f"gaussian_torus({L}, 0).to_generic()",
               "chains": chains, "slices": slices, "taus": list(taus),
               "best_seconds": {str(k): v for k, v in best.items()},
               "ms_per_step": ms}
        visited, bath = None, False
        if kname == "fk_wolff":
            # the cluster sites of the last run, at the largest tau
            visited = float(extra.sum()) / max(taus)
            rec["mean_cluster_sites"] = visited / chains
        if kname == "fk_label":
            bath = rec["bath"] = extra
            rec["alpha"] = CLUSTER_ALPHA if bath else None
        if kname in ("fk_label", "fk_wolff"):
            rec["geometry"] = ck.card_label_geometry(kname, chains, slices,
                                                     n, dev, bool(bath))
        if kname == "fk_line":
            rec["per_slice_seeds"] = extra
            rec["launches_per_run"] = 1
        bound, bound_by, unit = cluster_bound(kname, chains, slices, n,
                                              degree, visited, bath,
                                              max(taus))
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
    launch and a fk_line launch a step, WC3 a fk_line launch a run."""
    from montecarlosolvers_tpu_torch.bench import throughput

    t0 = time.perf_counter()
    rec = throughput.cluster_arm(problem)
    emit({"phase": "cluster_bench", **rec,
          "seconds": time.perf_counter() - t0,
          "nvidia_smi": throughput.nvidia_smi()})
    for key in ("wolff_cluster_ms", "wolff_cluster_ms_per_chain",
                "sw_bath_sweep_ms", "sw_full_sweep_ms"):
        check(np.isfinite(rec[key]) and rec[key] > 0, f"cluster bench {key}")
    steps = 3 * (10 + 30)  # a warm run and two trials at tau 10 and 30
    want = {"fk_wolff": 2 * 3 * 2, "generic_qmc_bath": steps,
            "fk_line": steps + 2 * 3}
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
        # a launch can be shorter than the wrapper's host time: queued
        # behind a spin kernel, so the events time the card's work
        ms = event_ms(lambda: sk.words_energy(sl, *words, chains, C), 200,
                      spin_cycles=100_000_000)
        halves_ms = event_ms(lambda: energy_ops.halves_energy(sl, a, b),
                             200, spin_cycles=100_000_000)
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


# ------------------------------------------------ the API surface, studies


@contextlib.contextmanager
def no_plain_route():
    """Count every wrapper call that takes its plain version (`_build.route`
    answering "cpu") inside the block; yields the count box, which must
    stay 0 on the card."""
    from montecarlosolvers_tpu_torch.ops import _build

    saved, box = _build.route, {"plain": 0}

    def route(device, engine):
        r = saved(device, engine)
        box["plain"] += r == "cpu"
        return r

    _build.route = route
    try:
        yield box
    finally:
        _build.route = saved


def torus_triplets(lat):
    """(rows, cols, vals) of a periodic lattice: each site's right, then
    down bond, in row-major order."""
    Lt = lat.L
    jr, jd = (x.double().cpu().numpy() for x in (lat.j_right, lat.j_down))
    i = np.arange(Lt * Lt)
    y, x = np.divmod(i, Lt)
    rows = np.repeat(i, 2)
    cols = np.stack([y * Lt + (x + 1) % Lt, ((y + 1) % Lt) * Lt + x],
                    1).ravel()
    return rows, cols, np.stack([jr[y, x], jd[y, x]], 1).ravel()


def table_energy(nbs, s):
    """Float64 energies of (..., N) spins on a reference-format table with
    no fields."""
    idx = nbs[:, :, 0].astype(np.int64)
    val = nbs[:, :, 1]
    s = np.asarray(s, np.float64)
    return 0.5 * np.sum(s * np.sum(val * s[..., idx], axis=-1), axis=-1)


def z_of(theta):
    return np.where(np.cos(theta) >= 0, 1.0, -1.0)


def anchored(key):
    """The range of `key`: RANGES, else its compat anchor +/- max(floor, 5
    sd)."""
    if key in RANGES:
        return RANGES[key]
    m, sd, floor = API_ANCHORS[key]
    return m - max(floor, 5 * sd), m + max(floor, 5 * sd)


def driven(phase, key, run, want, main_launches, power, name, **rec):
    """Drive run() -> (value or None, info) with the counts set to 0 just
    before it and read just after; check its launches against `want` (a
    dict: exact counts; a set: exactly these kernels), no plain route, and
    the value inside anchored(key) when it is not None. Emits a record and
    returns (value, info)."""
    from montecarlosolvers_tpu_torch.ops import _build

    _build.reset_launches()
    t0 = time.perf_counter()
    with no_plain_route() as box:
        value, info = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = launched_now()
    for k, v in launched.items():
        main_launches[k] += v
    out = {"phase": phase, "path": key, "seconds": secs,
           "launches": launched, "plain_routes": box["plain"], **rec,
           "info": info, "gpu": name, "power_limit": power}
    if value is not None:
        lo, hi = anchored(key)
        out.update(value=value, range=[lo, hi])
    emit(out)
    check(box["plain"] == 0, f"{key}: no plain route on the card")
    got = set(launched) if isinstance(want, set) else launched
    check(got == want, f"{key} launched {launched}, its route {want}")
    if value is not None:
        check(np.isfinite(value) and lo <= value <= hi,
              f"{key} value {value} inside [{lo}, {hi}]")
    return value, info


def api_surface(dev, main_launches, torus, power, name):
    """Phase api_surface: the compat shims at full width on the 80x80
    torus's reference-format table, the CLI's solve in process, and a
    CheckpointedAnneal stopped after 2 of 4 segments and resumed, bitwise
    the unbroken run."""
    import tempfile

    from montecarlosolvers_tpu_torch import compat, schedules
    from montecarlosolvers_tpu_torch.models.ising import build_neighbor_table

    n = torus.nspins
    rows, cols, vals = torus_triplets(torus)
    nbs = build_neighbor_table(n, rows, cols, vals, 4)
    xi = np.random.default_rng(0).normal(size=(SHIM_NOISY_STEPS,)
                                         + nbs.shape[:2])
    nbs4d = np.broadcast_to(nbs, (SHIM_NOISY_STEPS,) + nbs.shape).copy()
    nbs4d[..., 1] *= 1.0 + SHIM_NOISY_SCALE * xi
    lut = schedules.bath_lookuptable(SHIM_SLICES, SHIM_ALPHA,
                                     device="cpu").numpy()
    P = SHIM_SLICES

    def spins(reads):
        return np.random.default_rng(0).choice([-1.0, 1.0], size=(reads, n))

    def angles(reads):
        return np.random.default_rng(0).uniform(0, np.pi, size=(reads, n))

    def sa_shim(fn, table, steps, reads):
        def run():
            s = spins(reads)
            fn(np.linspace(3.0, 0.0, steps), 1, s, table, seed=0)
            check(set(np.unique(s)) <= {-1.0, 1.0}, "shim spins +/-1")
            return float(table_energy(nbs, s).mean()) / n, {"reads": reads}
        return run

    def svmc_shim(fn, table, steps, reads):
        def run():
            th = angles(reads)
            a = np.linspace(3.0, 1e-8, steps)
            fn(a, np.ones_like(a), 1, SHIM_SVMC_TEMP, th, table, seed=0)
            check(th.min() >= 0 and th.max() <= np.pi + 1e-6,
                  "shim angles in [0, pi]")
            return (float(table_energy(nbs, z_of(th)).mean()) / n,
                    {"reads": reads})
        return run

    def qmc_shim(fn, steps, bath):
        def run():
            c = np.tile(spins(1)[0], (P, 1)).T.copy()
            a = np.linspace(3.0, 1e-8, steps)
            args = (a, np.ones_like(a), 1, 1.0 / P) + ((lut,) if bath
                                                       else ())
            fn(*args, c, nbs, seed=0)
            check(c.shape == (n, P) and set(np.unique(c)) <= {-1.0, 1.0},
                  "shim confs (N, P) +/-1")
            return (float(table_energy(nbs, c.T).mean()) / n,
                    {"slices": P, "steps": steps})
        return run

    shims = (
        ("Anneal", sa_shim(compat.Anneal, nbs, SHIM_SA_SWEEPS,
                           SHIM_SA_READS), {"packed_sa": 1}),
        ("QuantumAnnealGlobal", qmc_shim(compat.QuantumAnnealGlobal,
                                         SHIM_QMC_SWEEPS, False),
         {"generic_qmc": 1}),
        ("DissipativeQuantumAnnealGlobal",
         qmc_shim(compat.DissipativeQuantumAnnealGlobal, SHIM_BATH_SWEEPS,
                  True), {"generic_qmc_bath": 1}),
        ("DissipativeQuantumAnnealWC3",
         qmc_shim(compat.DissipativeQuantumAnnealWC3, SHIM_WC3_SWEEPS,
                  True), {"fk_line": 1}),
        ("SpinVectorMonteCarloTFCompact",
         svmc_shim(compat.SpinVectorMonteCarloTFCompact, nbs,
                   SHIM_SVMC_SWEEPS, SHIM_SVMC_READS), {"packed_svmc": 1}),
        ("NoisyAnneal", sa_shim(compat.NoisyAnneal, nbs4d, SHIM_NOISY_STEPS,
                                SHIM_NOISY_READS), {"packed_sa_noisy": 1}),
        ("NoisySVMCTF", svmc_shim(compat.NoisySVMCTF, nbs4d,
                                  SHIM_NOISY_STEPS, SHIM_NOISY_READS),
         {"packed_svmc_noisy": 1}),
    )
    for key, run, want in shims:
        driven("api_surface", key, run, want, main_launches, power, name,
               problem=f"gaussian_torus({L}, 0), reference table")

    # the command line, in process, on the torus's triplet file, and the
    # checkpoints, in a directory removed at the end
    with tempfile.TemporaryDirectory(prefix="mcs_api_") as tmp:
        api_files(dev, main_launches, torus, power, name, tmp, rows,
                  cols, vals)


def api_files(dev, main_launches, torus, power, name, tmp, rows, cols,
              vals):
    """api_surface's CLI solves and CheckpointedAnneal runs, their files
    in `tmp`."""
    import io

    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.__main__ import main as cli
    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.solvers import sa
    from montecarlosolvers_tpu_torch.utils.checkpoint import (
        CheckpointedAnneal)

    n = torus.nspins
    inst = str(Path(tmp) / "torus80.txt")
    instances.save_triplets(inst, rows, cols, vals)

    def cli_run(args, prob):
        def run():
            out = str(Path(tmp) / "samples.npz")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli(["solve", inst, "--out", out] + args)
            check(rc == 0, "cli solve rc 0")
            res = json.loads([ln for ln in buf.getvalue().splitlines()
                              if ln.startswith("{")][-1])
            data = np.load(out)
            e = energy64(prob, data["samples"])
            check(np.allclose(data["energies"], e, rtol=1e-5, atol=1e-3)
                  and res["best_energy"] == float(data["energies"][0]),
                  "cli energies: the npz's, a float64 recomputation's, "
                  "the JSON's")
            return float(e.mean()) / n, {k: v for k, v in res.items()
                                         if not isinstance(v, dict)}
        return run

    gtorus = instances.gaussian_torus(L, 0, device=dev).to_generic()
    cases = (
        ("cli_sa", ["--method", "sa", "--lattice", str(L), "--num-reads",
                    str(SA_READS), "--sweeps", str(SA_SWEEPS)], torus,
         {"sa_split": 1}, "sa"),
        ("cli_piqmc", ["--method", "piqmc", "--lattice", str(L),
                       "--slices", str(QMC_SLICES), "--num-reads",
                       str(QMC_READS), "--sweeps", str(QMC_SWEEPS)], torus,
         {"sa_split": 1, "qmc_split": 1}, "piqmc_p40"),
        ("cli_svmc", ["--method", "svmc", "--lattice", str(L),
                      "--num-reads", str(SVMC_READS), "--sweeps",
                      str(SVMC_SWEEPS)], torus, {"svmc_split": 1}, "svmc"),
        ("cli_sa_generic", ["--method", "sa", "--num-reads", str(SA_READS),
                            "--sweeps", str(SA_SWEEPS)], gtorus,
         {"packed_sa": 1}, "sa_generic"),
    )
    for key, args, prob, want, rkey in cases:
        RANGES[key] = RANGES[rkey]
        driven("api_surface", key, cli_run(args, prob), want, main_launches,
               power, name, argv=args)

    # CheckpointedAnneal: 4 segments unbroken, and stopped after 2, resumed
    sched = schedules.linear(3.0, 0.0, CKPT_SWEEPS, device=dev)
    s0 = sa.random_state(torch.Generator().manual_seed(0), n,
                         batch=(CKPT_READS,), device=dev)
    seg = CKPT_SWEEPS // CKPT_SEGMENTS

    def solver(part, state, gen):
        return sa.anneal(torus, part, state, gen)

    class Stop(Exception):
        pass

    def stopping(part, state, gen):
        stopping.calls += 1
        if stopping.calls > 2:
            raise Stop
        return solver(part, state, gen)
    stopping.calls = 0

    def unbroken():
        full = CheckpointedAnneal(str(Path(tmp) / "a.npz"), segment=seg,
                                  validate="ising").run(solver, sched, s0, 0)
        unbroken.state = full
        return (float(energy64(torus, full.cpu().numpy()).mean()) / n,
                {"segments": CKPT_SEGMENTS})

    RANGES["checkpoint_unbroken"] = RANGES["checkpoint_resumed"] = \
        RANGES["sa"]
    driven("api_surface", "checkpoint_unbroken", unbroken,
           {"sa_split": CKPT_SEGMENTS}, main_launches, power, name,
           reads=CKPT_READS, sweeps=CKPT_SWEEPS)
    path = str(Path(tmp) / "b.npz")
    try:
        CheckpointedAnneal(path, segment=seg).run(stopping, sched, s0, 0)
    except Stop:
        pass
    check(int(np.load(path)["seg_idx"]) == 2, "checkpoint stopped at 2")

    def resumed():
        out = CheckpointedAnneal(path, segment=seg).run(solver, sched, s0, 0)
        check(torch.equal(out, unbroken.state),
              "resumed checkpoint equals the unbroken run bitwise")
        return (float(energy64(torus, out.cpu().numpy()).mean()) / n,
                {"resumed_from": 2, "bitwise": True})

    driven("api_surface", "checkpoint_resumed", resumed,
           {"sa_split": CKPT_SEGMENTS - 2}, main_launches, power, name,
           reads=CKPT_READS, sweeps=CKPT_SWEEPS)


def study_recorder(phase, study, routes, keys, values, main_launches, power,
                   name):
    """A `record(name, fn)` for a study's arms: each arm driven (its
    launches against its family's entry in `routes` and no plain route),
    its record's keys against its family's in `keys` (the study's
    RECORD_KEYS; `_common.by_family`), and values(arm, rec) -> None or
    (value, (lo, hi)) checked. Returns (record, done)."""
    from montecarlosolvers_tpu_torch.bench._common import by_family

    done = {}

    def record(arm, fn):
        box = {}

        def run():
            box["rec"] = fn()
            return None, None

        driven(phase, f"{study}.{arm}", run, by_family(routes, arm),
               main_launches, power, name)
        rec = box["rec"]
        check(set(rec) == by_family(keys, arm),
              f"{study}.{arm} record keys {sorted(rec)}")
        # a cluster move that flips nothing leaves every value the same
        for k, v in rec.items():
            if k.endswith("flip_frac"):
                check(0 < v <= 1, f"{study}.{arm} {k} {v} in (0, 1]")
        held = values(arm, rec)
        emit({"phase": phase, "path": f"{study}.{arm}", "record": rec,
              "range": None if held is None else held[1]})
        if held is not None:
            value, (lo, hi) = held
            check(np.isfinite(value) and lo <= value <= hi,
                  f"{study}.{arm} {value} inside [{lo}, {hi}]")
        done[arm] = rec
        return rec

    return record, done


def eps_value(arm, rec, prefix):
    """(value, range) of a study arm's eps (eps_cold, eps_best or eps): an
    arm of fixed shape around its JAX anchor prefix.arm; an equal-wall arm,
    whose tau this card's walls set, between 0 and the upper end of its
    fixed-tau sibling's range (it runs the sibling's protocol at tau' =
    tau x the wall ratio, and tau' >= tau: the ratio is that of a costlier
    arm's wall to the sibling's, so it must not end worse)."""
    field = next(f for f in ("eps_cold", "eps_best", "eps") if f in rec)
    key = f"{prefix}.{arm}"
    if key in API_ANCHORS:
        return rec[field], anchored(key)
    check("_equalwall" in arm, f"{key} has a JAX anchor")
    base = f"{prefix}.{arm.split('_equalwall')[0]}"
    sibling = [k for k in API_ANCHORS
               if k.startswith(base) and "_equalwall" not in k]
    check(len(sibling) == 1, f"{key}: one fixed-tau sibling {sibling}")
    return rec[field], (0.0, anchored(sibling[0])[1])


def studies(dev, main_launches, torus, power, name):
    """Phase studies: each value study's arms at full width and reduced
    sweeps on the 80x80 torus (e_gs = -sum |J|, a certified lower bound),
    icm_value on random_3d_lattice(12, 0), the crossover on the 32 x 32
    ferromagnet, the ladder calibration at N = 6400, and the two new
    examples."""
    from montecarlosolvers_tpu_torch.bench import (cluster_crossover,
                                                   cluster_value, icm_value,
                                                   ladder_calibration,
                                                   pa_value, pt_value)
    from montecarlosolvers_tpu_torch.bench._common import generator
    from montecarlosolvers_tpu_torch.examples import (cluster_and_pt,
                                                      compat_migration)
    from montecarlosolvers_tpu_torch.models import instances

    e_gs = -float(torus.j_right.abs().sum() + torus.j_down.abs().sum())
    chain = {"sa_split_chain", "energy_bits"}
    collect = {"sa_split_phased", "sa_split_energy"}
    saved = {}

    def setconst(mod, **kw):
        for k, v in kw.items():
            saved.setdefault((mod, k), getattr(mod, k))
            setattr(mod, k, v)

    try:
        # --- pt_value
        setconst(pt_value, **STUDY_CONSTS["pt_value"])
        pt_routes = {"sampling_pt": chain, "sampling_quench": collect,
                     "opt_pt": chain, "opt_sa": {"sa_split"},
                     "quantum_pt": {"qmc_split_chain", "qmc_split"},
                     "quantum_piqmc": {"qmc_split"},
                     "sampling_icm": chain | {"houdayer"},
                     "opt_icm": chain | {"houdayer"}}
        record, done = study_recorder(
            "studies", "pt_value", pt_routes, pt_value.RECORD_KEYS,
            lambda a, r: eps_value(a, r, "pt_value"), main_launches, power,
            name)
        for arms_fn, seed in ((pt_value.sampling_arms, 1),
                              (pt_value.optimization_arms, 2),
                              (pt_value.quantum_arms, 3),
                              (pt_value.icm_arms, 4)):
            arms_fn(torus, e_gs, generator(dev, 11, seed), done, record)
        check(len(done) == 11, f"pt_value ran {sorted(done)}")

        # --- pa_value
        setconst(pa_value, **STUDY_CONSTS["pa_value"])
        pa_routes = {"sampling_pa": {"sa_split", "energy_bits"},
                     "opt_pa": {"sa_split", "energy_bits"},
                     "sampling_quench": collect, "opt_sa": {"sa_split"},
                     "sampling_pt_matched": chain, "opt_pt_matched": chain}
        record, done = study_recorder(
            "studies", "pa_value", pa_routes, pa_value.RECORD_KEYS,
            lambda a, r: eps_value(a, r, "pa_value"), main_launches, power,
            name)
        pa_value.sampling_arms(torus, e_gs, generator(dev, 23, 1), done,
                               record)
        pa_value.optimization_arms(torus, e_gs, generator(dev, 23, 2), done,
                                   record)
        check(len(done) == 8, f"pa_value ran {sorted(done)}")

        # --- icm_value: L = 12, one seed, two segments
        setconst(icm_value, **STUDY_CONSTS["icm_value"])
        icm_l = 12
        routes_icm = {"tune": {"packed_sa_chain"},
                      "icm": {"packed_sa_chain", "houdayer"},
                      "pt": {"packed_sa_chain"}}

        def icm_values(arm, rec):
            if arm.startswith("tune"):
                check(len(rec["temps"]) == icm_value.RUNGS, "tuned ladder")
                return None
            segs = rec["segments"]
            check(all(set(s) == icm_value.SEGMENT_KEYS for s in segs),
                  f"{arm} segment keys")
            check(all((s["h_frac"] > 0) == arm.startswith("icm")
                      for s in segs), f"{arm} Houdayer flips only in ICM")
            return (segs[min(1, len(segs) - 1)]["e_cold"] / icm_l ** 3,
                    anchored(f"icm_value.{arm}"))

        record, done = study_recorder(
            "studies", "icm_value", routes_icm, icm_value.RECORD_KEYS,
            icm_values, main_launches, power, name)
        icm_value.run_instance(icm_l, 0, generator(dev, 5, 100 * icm_l),
                               record)
        verdict = icm_value.summarize(done)
        emit({"phase": "studies", "path": "icm_value.summarize",
              "verdicts": verdict})
        check(set(verdict) == {f"L{icm_l}_h{h}" for h in (2, 8, 32)},
              "icm_value verdicts")

        # --- cluster_value: 32 chains, P = 40, with and without the bath
        setconst(cluster_value, **STUDY_CONSTS["cluster_value"])
        cv_routes = {"baseline": {"qmc_split"},
                     "mixed_wcl": {"qmc_split", "fk_wolff"},
                     "bath_baseline": {"qmc_bath_split"},
                     "bath_mixed_sw": {"qmc_bath_split", "fk_line"}}
        record, done = study_recorder(
            "studies", "cluster_value", cv_routes, cluster_value.RECORD_KEYS,
            lambda a, r: eps_value(a, r, "cluster_value"), main_launches,
            power, name)
        cluster_value.arms(torus, e_gs, generator(dev, 0), record,
                           taus=(CV_TAU,))
        check(len(done) == 6, f"cluster_value ran {sorted(done)}")

        # --- cluster_crossover: L = 32, P = 4, 16 chains, and classical.
        # Every dynamics samples the same m^2 (driven's value), so each
        # arm's tau_int and a Wolff arm's flip fraction are held to their
        # anchors too, and the cluster moves' tau_int must be below the
        # local dynamics'
        fm = cluster_crossover.fm_lattice(XO_L, device=dev)
        n_all = XO_BURN + XO_SWEEPS
        tau = {}

        def crossover_arm(key, run, want):
            def go():
                out = dict(zip(("tau_int_sweeps", "wall_per_sweep_s",
                                "mean_m2", "flip_frac"), run()))
                return out["mean_m2"], out

            _, out = driven("studies", key, go, want, main_launches, power,
                            name)
            tau[key] = out["tau_int_sweeps"]
            for akey, field in (("tau_int", "tau_int_sweeps"),
                                ("flip_frac", "flip_frac")):
                if f"{key}.{akey}" in API_ANCHORS:
                    lo, hi = anchored(f"{key}.{akey}")
                    check(lo <= out[field] <= hi,
                          f"{key} {field} {out[field]} inside [{lo}, {hi}]")
            if "fk_wolff" in want and "flip_frac" in out:
                check(out["flip_frac"] > 0, f"{key} Wolff flips spins")

        q, c = "crossover.critical_", "crossover.cl_critical_"
        for arm, we in (("localglobal", 0), ("wolff1", 1), ("wolff4", 4)):
            want = {"generic_qmc": n_all}
            if we:
                want["fk_wolff"] = -(-n_all // we)
            crossover_arm(f"{q}{arm}_L{XO_L}", lambda we=we: (
                cluster_crossover.run_arm(
                    fm, cluster_crossover.T_C, 0.1, XO_CHAINS, XO_SWEEPS,
                    generator(dev, 0, we), wolff_every=we, P=XO_SLICES,
                    chunk=XO_CHUNK, burn=XO_BURN)), want)
        moves = {"local": {"packed_sa": n_all}, "wolff": {"fk_wolff": n_all},
                 "sw": {"fk_label": n_all},
                 "sw+local": {"packed_sa": n_all, "fk_label": n_all}}
        for move, want in moves.items():
            crossover_arm(f"{c}{move}_L{XO_L}", lambda move=move: (
                cluster_crossover.run_classical_arm(
                    fm, cluster_crossover.T_C, XO_CHAINS, XO_SWEEPS,
                    generator(dev, 42, len(move)), move=move,
                    chunk=XO_CHUNK, burn=XO_BURN)), want)
        for fast, slow in ((f"{q}wolff1", f"{q}localglobal"),
                           (f"{q}wolff4", f"{q}localglobal"),
                           (f"{c}wolff", f"{c}local"), (f"{c}sw", f"{c}local"),
                           (f"{c}sw+local", f"{c}local")):
            f, s_ = tau[f"{fast}_L{XO_L}"], tau[f"{slow}_L{XO_L}"]
            check(f < s_, f"tau_int {fast} {f} below {slow} {s_}")

        # --- ladder_calibration at N = 6400
        lat80 = instances.random_2d_lattice(L, rng=L, lattice=True,
                                            device=dev)[0]

        def ladder():
            out = ladder_calibration._measure(lat80, L * L,
                                              generator(dev, 21, L))
            check(out["rungs"] == LADDER_RUNGS, f"auto ladder {out}")
            return out["swap_rate"], out

        driven("studies", "ladder_calibration.lattice_N6400", ladder, chain,
               main_launches, power, name)

        # --- the two new examples
        def migration():
            out = compat_migration.run(device=dev, verbose=False)
            check(out["bound"] <= out["sa_energy"] < 0, "migration SA")
            RANGES["examples.compat_migration.piqmc"] = anchored(
                "examples.compat_migration.piqmc")
            lo, hi = RANGES["examples.compat_migration.piqmc"]
            value = out["piqmc_best_energy"] / out["nspins"]
            check(lo <= value <= hi, f"migration PIQMC {value} inside "
                                     f"[{lo}, {hi}]")
            return out["sa_energy"] / out["nspins"], out

        driven("studies", "examples.compat_migration.sa", migration,
               {"packed_sa": 2, "generic_qmc": 1}, main_launches, power,
               name)

        gtorus = torus.to_generic()

        def cluster_pt():
            out = cluster_and_pt.run(gtorus, e_gs, verbose=False,
                                     **EXAMPLE_CLUSTER_PT)
            for k, v in out.items():
                eps = v["eps_res"] if isinstance(v, dict) else v
                lo, hi = anchored(f"examples.cluster_and_pt.{k}")
                check(np.isfinite(eps) and lo <= eps <= hi,
                      f"cluster_and_pt {k} {eps} inside [{lo}, {hi}]")
            return None, out

        driven("studies", "examples.cluster_and_pt", cluster_pt,
               {"packed_sa", "fk_wolff", "fk_label", "packed_sa_chain",
                "houdayer", "generic_qmc_chain"}, main_launches, power, name)
    finally:
        for (mod, k), v in saved.items():
            setattr(mod, k, v)


def shard_bound(kname, chains, rows, sites, graph=None, updated=None,
                block=None, slices=None, visited=None, bath=False):
    """(least ms of one launch of shard kernel `kname`, "bytes" or
    "operations"): the work of kernel B's (split) or the generic PIQMC
    kernel's (generic) update or line move on a slab of `rows` quarter rows
    or slices of `sites` sites a row, `chains` chains, by `ops_per_sweep`'s
    counts, plus the halo rows' bytes. graph: (degree, maxnb) of a generic
    form; updated: the sites a generic phase updates; block: the sites of
    the generic line color. The rest of the Trotter axis, at P = `slices`:
    S5 a slice of every chain as the generic bath kernel's update
    (`ops_per_sweep`'s "qmc_bath" a site), the gathered state read once;
    S6 a round's bonds from its `visited` sites and S7 its draw, every bond
    of the rows, as `cluster_bound` counts them (with `bath` the pairs a
    comparison each against a table of 2 (P - 1) probabilities a chain).
    S5 and S7 also count the counter hash's integer work (HASH_OPS a
    uniform over the INT32 rate, `shard_hash_ms`), as `cluster_bound`
    counts fk_line's."""
    int32 = (shard_hash_ms(kname, chains, rows, sites, graph, slices, bath)
             / 1e3 * PEAK_INT32
             if kname in ("shard_label", "generic_shard_bath_slice") else 0)
    if kname in ("shard_wolff", "shard_label"):
        degree, P = graph[0], slices
        pairs = (P - 1) / 2 if bath else 0
        table = chains * 2 * (P - 1) if bath else 0
        if kname == "shard_wolff":
            sfu = visited * (degree + 2) / 2 + table
            f32 = visited * pairs
            nbytes = visited * 8
        else:
            sfu = rows * sites * (degree / 2 + 2) + table
            f32 = rows * sites * pairs
            nbytes = rows * sites * 8
        times = {"operations": max(sfu / PEAK_SFU, f32 / PEAK_FLOPS,
                                   int32 / PEAK_INT32),
                 "bytes": nbytes / PEAK_BYTES}
        unit = max(times, key=times.get)
        return 1e3 * times[unit], unit
    field = SPIN_FIELD if graph is None else graph[0]
    local = field + 4 + METROPOLIS
    slab = chains * rows * sites * 4
    tables = (5 * sites * 4 if graph is None
              else sites * (graph[1] * 8 + 8))
    row = chains * sites * 4
    f32, sfu, nbytes = {
        # a phase: two quarters' updates; the four quarters read, the two
        # updated ones written, the two halo rows read
        "shard_phase": (local * chains * 2 * rows * sites,
                        chains * 2 * rows * sites,
                        6 * slab + 2 * row + tables),
        # two quarters' field sums a line: field and h (field + 1) and the
        # running sum (1) a row; four quarters read, the part written
        "shard_line_part": ((field + 2) * 2 * rows * chains * sites, 0,
                            4 * slab + row + tables),
        # a line: bc * total and Metropolis; the total read, s1 and s2 read
        # and written
        "shard_line_accept": ((1 + METROPOLIS) * chains * sites,
                              chains * sites, row + 4 * slab),
        # a phase: its updated sites; the slab read, the updated sites
        # written, both halo rows read
        "generic_shard_phase": (local * (updated or 0), updated or 0,
                                slab + 4 * (updated or 0) + 2 * row
                                + tables),
        # a color's lines: (bc s) f summed over the slab's slices; the slab
        # read, the part written
        "generic_shard_line_part": ((field + 2) * rows * chains
                                    * (block or 0), 0,
                                    slab + chains * (block or 0) * 4
                                    + tables),
        # a color's lines: Metropolis; the total read, the lines' slab
        # sites read and written
        "generic_shard_line_accept": (
            METROPOLIS * chains * (block or 0), chains * (block or 0),
            chains * (block or 0) * 4 * (1 + 2 * rows)
            + (block or 0) * 4),
        # a slice of every chain: the bath update (local + P) a site; the
        # slice read and written, the gathered state and the bath row read
        "generic_shard_bath_slice": (
            (local + (slices or 0)) * chains * sites, chains * sites,
            2 * row + chains * (slices or 0) * sites * 4 + tables
            + (slices or 0) * 4),
    }[kname]
    times = {"operations": max(f32 / PEAK_FLOPS, sfu / PEAK_SFU,
                               int32 / PEAK_INT32),
             "bytes": nbytes / PEAK_BYTES}
    unit = max(times, key=times.get)
    return 1e3 * times[unit], unit


def shard_hash_ms(kname, chains, rows, sites, graph, slices, bath=False):
    """The counter hash's floor of one launch of S5 or S7's draw: HASH_OPS
    integer operations a uniform over the INT32 rate. S5 one uniform a
    site of a slice of every chain; S7's draw a uniform a bond of the
    block's rows, degree / 2 spatial, one Trotter and one ghost a site,
    and with the bath each pair that touches the rows once: the pairs of
    two block rows, rows (rows - 1) / 2 a line, and each row's pairs with
    the other ranks' rows, rows (P - rows) a line."""
    if kname == "generic_shard_bath_slice":
        uniforms = chains * sites
    else:
        pairs = (rows * (rows - 1) / 2 + rows * (slices - rows)
                 if bath else 0)
        uniforms = chains * sites * (rows * (graph[0] / 2 + 2) + pairs)
    return 1e3 * HASH_OPS * uniforms / PEAK_INT32


def shard_rest_checks(dev, results, torus, power, name):
    """(f) of phase parallel: S5, S6 and S7 against their plain versions on
    rank 1's slab of PARALLEL_RANKS, timed with CUDA events beside
    `shard_bound`. S5: the 80x80 torus's own packing at P = QMC_SLICES,
    QMC_READS chains, alpha = BATH_ALPHA, every local slice step of the
    slab. S6 and S7: the torus's generic form, one chain at P =
    QMC_SLICES, replicated slices (the pre-anneal's start, whose Trotter
    bonds hold), rules "local" and "full", with and without bath bonds;
    S6 a round from a seed in the slab with random messages from both
    ranks around it (and random fresh sites of the others with the bath),
    its field sums and its flip; S7 the draw, a round on random labels of
    the neighbours, and the flip. Every output equal: 0 mismatched spins,
    bits, messages and labels."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.ops import cluster as cl
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops
    from montecarlosolvers_tpu_torch.ops import piqmc as piqmc_ops
    from montecarlosolvers_tpu_torch.ops import shard_kernels as shk

    P, n, ranks = QMC_SLICES, L * L, PARALLEL_RANKS
    ps = P // ranks
    k0 = ps  # rank 1
    temp, t = 1.0 / P, 15
    gamma = schedules.transverse_field(3.0, 1e-8, 20, device=dev)
    b20 = torch.ones_like(gamma)
    jp = schedules.jperp(gamma, temp * P).contiguous()
    rng = np.random.default_rng(41)

    def record(kname, bad, bound, ms, plain_ms, rec):
        """Emit one case; the kernels line takes each kernel's first case
        (S6: rule "local", no bath; S7: no bath), its times beside its
        own bound."""
        if "ms" not in results[kname]:
            results[kname].update(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound[0], bound_by=bound[1])
        rec.update(kernel=kname, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound[0])
        emit({"phase": "parallel", "check": "shard_kernel_vs_plain",
              "rank_of": [1, ranks], **rec, "card": name,
              "power_limit": power})
        check(sum(bad) == 0, f"{kname} equals its plain version ({rec})")

    # S5
    pg = packed_ops.packed_from_lattice(torus)
    lut = schedules.bath_lookuptable(P, BATH_ALPHA, device=dev)
    bath = piqmc_ops.bath_matrix_of(lut, P, dev)
    full = packed_ops.pack_state(pg, parallel_state(QMC_READS, P, n, 42,
                                                    dev)).contiguous()
    slab = full[:, k0:k0 + ps].contiguous()
    bad = 0
    for kloc in range(ps):
        args = (pg, b20, jp, temp * P, bath)
        want = shk.generic_shard_bath_slice_ref(*args, slab, full, kloc,
                                                k0 + kloc, t, 77)
        got = shk.generic_shard_bath_slice(*args, slab.clone(), full, kloc,
                                           k0 + kloc, t, 77)
        torch.cuda.synchronize()
        bad += mismatches([got], [want])[0]
        slab = want
    work, kt = slab.clone(), ps - 1
    ms = event_ms(lambda: shk.generic_shard_bath_slice(
        pg, b20, jp, temp * P, bath, work, full, kt, k0 + kt, t, 77), 50)
    plain_ms = event_ms(lambda: shk.generic_shard_bath_slice_ref(
        pg, b20, jp, temp * P, bath, slab, full, kt, k0 + kt, t, 77), 5)
    bound = shard_bound("generic_shard_bath_slice", QMC_READS, 1, n,
                        graph_shape(torus.to_generic()), slices=P)
    record("generic_shard_bath_slice", [bad], bound, ms, plain_ms,
           {"slices": P, "chains": QMC_READS, "slab_slices": ps,
            "mismatched_spins": bad})

    # S6 and S7
    gtorus = torus.to_generic()
    graph = graph_shape(gtorus)
    gp = packed_ops.build_packed(gtorus)
    one = torch.as_tensor(rng.choice([-1.0, 1.0], size=(1, n)).astype(
        np.float32), device=dev)
    state = packed_ops.pack_state(gp, one.expand(P, n)[None])[0]
    state[:, : n // 8] *= -1.0  # a stripe the Trotter bonds cut
    state = state.contiguous()
    rows = state[k0:k0 + ps].contiguous()
    up, dn = state[k0 - 1].contiguous(), state[k0 + ps].contiguous()
    words = -(-ps * n // 32)

    def messages(density):
        return torch.as_tensor((rng.random(n) < density).astype(np.uint8),
                               device=dev)

    in_prev, in_next = messages(0.05), messages(0.05)
    ff_words = torch.as_tensor(rng.integers(
        -2**31, 2**31, size=ranks * words, dtype=np.int64).astype(
            np.int32) & np.int32(0x01010101), device=dev)
    seed_r, seed_j = ps // 2, n // 2 + 1
    seed_x = seed_r * n + seed_j

    def step(x, rule="local", with_bath=False):
        return ck.ShardStep(gp, x, up, dn, state if with_bath else None, k0,
                            P, b20, jp, temp * P, t, 77,
                            lut.contiguous() if with_bath else None, rule,
                            x[seed_r, seed_j:seed_j + 1].clone())

    def differ(xs, ys):
        return [int((x != y).sum()) for x, y in zip(xs, ys)]

    for rule in ("local", "full"):
        for with_bath in (False, True):
            zero = torch.zeros(words, dtype=torch.int32, device=dev)
            ff = ff_words if with_bath else None
            msgs = (in_prev, in_next, ff, seed_x)
            got = ck.shard_wolff_round(step(rows.clone(), rule, with_bath),
                                       zero.clone(), *msgs)
            want = ck.shard_wolff_round_ref(step(rows, rule, with_bath),
                                            zero.clone(), *msgs)
            torch.cuda.synchronize()
            bad = differ(got, want)
            visited = int(cl.unpack_bits(got[0], ps * n).sum())
            sums = ck.shard_wolff_sums(step(rows, rule, with_bath), got[0])
            bad += differ([sums], [ck.shard_wolff_sums_ref(
                step(rows, rule, with_bath), got[0])])
            rows_full = torch.cat([sums] * ranks)
            flipped = ck.shard_wolff_flip(step(rows.clone(), rule,
                                               with_bath), got[0], rows_full)
            bad += differ([flipped], [ck.shard_wolff_flip_ref(
                step(rows, rule, with_bath), got[0], rows_full)])
            ms = event_ms(lambda: ck.shard_wolff_round(
                step(rows, rule, with_bath), zero.clone(), *msgs), 20)
            plain_ms = event_ms(lambda: ck.shard_wolff_round_ref(
                step(rows, rule, with_bath), zero.clone(), *msgs), 2)
            bound = shard_bound("shard_wolff", 1, ps, n, graph, slices=P,
                                visited=visited, bath=with_bath)
            record("shard_wolff", bad, bound, ms, plain_ms,
                   {"rule": rule, "bath": with_bath,
                    "visited_in_round": visited,
                    "plain_visited": int(cl.unpack_bits(
                        want[0], ps * n).sum()),
                    "changed": int(got[4].item()),
                    "mismatches": dict(zip(
                        ("visited", "fresh", "out_up", "out_dn", "changed",
                         "sums", "flip"), bad))})
    for with_bath in (False, True):
        lab_g, bdn_g = ck.shard_label_init(step(rows.clone(), "local",
                                                with_bath))
        st_ref = step(rows, "local", with_bath)
        lab_w, bdn_w = ck.shard_label_init_ref(st_ref)
        torch.cuda.synchronize()
        bad = differ([lab_g, bdn_g], [lab_w, bdn_w])
        halo_prev, halo_next = (torch.as_tensor(rng.integers(
            -1, P * n, n).astype(np.int32), device=dev) for _ in range(2))
        full_labels = torch.as_tensor(rng.integers(-1, P * n, (P, n)).astype(
            np.int32), device=dev) if with_bath else None
        bond_up = messages(0.5)
        st = step(rows.clone(), "local", with_bath)
        lab_g, bdn_g = ck.shard_label_init(st)
        got = ck.shard_label_round(st, lab_g.clone(), bdn_g, halo_prev,
                                   bond_up, halo_next, full_labels)
        want = ck.shard_label_round_ref(st_ref, lab_w.clone(), bdn_w,
                                        halo_prev, bond_up, halo_next,
                                        full_labels)
        bad += differ(got, want)
        bad += differ([ck.shard_label_flip(st, got[0])],
                      [ck.shard_label_flip_ref(st_ref, got[0])])
        ms = event_ms(lambda: ck.shard_label_init(
            step(rows, "local", with_bath)), 20)
        plain_ms = event_ms(lambda: ck.shard_label_init_ref(
            step(rows, "local", with_bath)), 2)
        bound = shard_bound("shard_label", 1, ps, n, graph, slices=P,
                            bath=with_bath)
        record("shard_label", bad, bound, ms, plain_ms,
               {"bath": with_bath, "changed": int(got[1].item()),
                "mismatches": dict(zip(
                    ("labels", "bond_dn", "round_labels", "changed",
                     "flip"), bad))})


def shard_redesign(dev, results, torus, odd_torus, power, name):
    """(f2) of phase parallel: S5 and S7 redesigned, each against its plain
    version bitwise on each route (S5's first kernel, "_wide", forced by a
    rule of shape that holds nothing; S7's draw with its union-find in
    device memory, forced off chip), at the shapes of `shard_rest_checks`
    (P = QMC_SLICES, rank 1's slab of PARALLEL_RANKS), exactly each
    route's launches:
      - S5 over a cluster of its rule's R: the 80x80 and 81x81 tori's
        checkerboards (the second not proper), QMC_READS chains, alpha =
        BATH_ALPHA, every local slice step of the slab, the gathered state
        as float32 and as the int8 the collective sends, chain0 0 and
        OFFSET_CHAIN0; and the one-rank step on the whole state (full is
        the slab);
      - S7's draw over a cluster, its round over the same cluster (random
        neighbour labels) and its flip over a grid that covers the card,
        on the 80x80 torus's generic form, one chain: the slab and the
        one-rank ring (Ps = P), without a bath, with one and on
        `asymmetric_table`.
    Then times each queued behind a spin kernel (ms a launch, ms a draw)
    beside its other route, its plain version, `shard_bound` and the
    counter hash's floor (`shard_hash_ms`). The kernels line takes S5's
    slab rows at float32 and S7's slab draw without a bath, each row's
    max_abs_err the largest |kernel - plain| over the compared tensors."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops
    from montecarlosolvers_tpu_torch.ops import piqmc as piqmc_ops
    from montecarlosolvers_tpu_torch.ops import shard_kernels as shk

    P, ranks = QMC_SLICES, PARALLEL_RANKS
    ps = P // ranks
    k0 = ps  # rank 1
    temp, t, seed = 1.0 / P, 15, 77
    spin = 100_000_000
    gamma = schedules.transverse_field(3.0, 1e-8, 20, device=dev)
    b20 = torch.ones_like(gamma)
    jp = schedules.jperp(gamma, temp * P).contiguous()
    lut = schedules.bath_lookuptable(P, BATH_ALPHA, device=dev)
    bath = piqmc_ops.bath_matrix_of(lut, P, dev)
    rng = np.random.default_rng(26)

    def forced(module, attr, run, shape=lambda own, *x, **k: None):
        own = getattr(module, attr)
        setattr(module, attr, lambda *x, **k: shape(own, *x, **k))
        try:
            return run()
        finally:
            setattr(module, attr, own)

    def off_chip(own, *x, **k):
        R, threads, _ = own(*x, **k)
        return R, threads, False

    # S5
    for lat in (torus, odd_torus):
        lname = f"gaussian_torus({lat.L}, 0) checkerboard"
        pg = packed_ops.packed_from_lattice(lat)
        n = pg.nspins
        full = packed_ops.pack_state(pg, parallel_state(
            QMC_READS, P, n, 42, dev)).contiguous()
        full8 = full.to(torch.int8)
        geometry = shk.card_shard_bath_geometry(pg, QMC_READS, P, dev, False)
        args = (pg, b20, jp, temp * P, bath)
        for chain0 in (0, OFFSET_CHAIN0):
            slab = full[:, k0:k0 + ps].contiguous()
            bad = {"float32": 0, "int8": 0, "wide": 0}
            err = {"float32": 0.0, "int8": 0.0, "wide": 0.0}
            launched = {}
            for kloc in range(ps):
                want = shk.generic_shard_bath_slice_ref(
                    *args, slab, full, kloc, k0 + kloc, t, seed, chain0)
                _build.reset_launches()
                got = {"float32": shk.generic_shard_bath_slice(
                    *args, slab.clone(), full, kloc, k0 + kloc, t, seed,
                    chain0), "int8": shk.generic_shard_bath_slice(
                    *args, slab.clone(), full8, kloc, k0 + kloc, t, seed,
                    chain0)}
                got["wide"] = forced(
                    shk, "card_shard_bath_geometry",
                    lambda: shk.generic_shard_bath_slice(
                        *args, slab.clone(), full, kloc, k0 + kloc, t, seed,
                        chain0))
                for k, v in launched_now().items():
                    launched[k] = launched.get(k, 0) + v
                torch.cuda.synchronize()
                for key in bad:
                    n_bad, e = mismatches([got[key]], [want])
                    bad[key] += n_bad
                    err[key] = max(err[key], e)
                slab = want
            changed = int((slab != full[:, k0:k0 + ps]).sum())
            rec = {"phase": "parallel", "check": "shard_redesign",
                   "kernel": "generic_shard_bath_slice", "graph": lname,
                   "proper": pg.proper, "chains": QMC_READS, "slices": P,
                   "slab_slices": ps, "rank_of": [1, ranks],
                   "chain0": chain0, "geometry": geometry,
                   "launches": launched, "mismatched_spins": bad,
                   "max_abs_err": err, "changed_spins": changed}
            what = f"S5 on {lname}, chain0 {chain0}"
            check(sum(bad.values()) == 0 and changed > 0,
                  f"{what}: the cluster route (float32 and int8) and the "
                  f"first kernel equal the plain version")
            check(launched == {"generic_shard_bath_slice": 2 * ps,
                               "generic_shard_bath_slice_wide": ps},
                  f"{what} launched {launched}")
            if chain0 == 0:
                work, kt = slab.clone(), ps - 1

                def s5(f, work=work, kt=kt):
                    return lambda: shk.generic_shard_bath_slice(
                        *args, work, f, kt, k0 + kt, t, seed)
                rec["ms"] = event_ms(s5(full), 200, spin)
                rec["int8_ms"] = event_ms(s5(full8), 200, spin)
                rec["first_kernel_ms"] = forced(
                    shk, "card_shard_bath_geometry",
                    lambda: event_ms(s5(full), 50, spin))
                rec["plain_ms"] = event_ms(
                    lambda: shk.generic_shard_bath_slice_ref(
                        *args, slab, full, kt, k0 + kt, t, seed), 5)
                whole = full.clone()
                rec["one_rank_ms"] = event_ms(
                    lambda: shk.generic_shard_bath_slice(
                        *args, whole, whole, 4, 4, t, seed), 200, spin)
                gshape = graph_shape(lat.to_generic())
                bound = shard_bound("generic_shard_bath_slice", QMC_READS,
                                    1, n, gshape, slices=P)
                rec.update(bound_ms=bound[0], bound_by=bound[1],
                           int8_bytes_ms=1e3 * (QMC_READS * P * n
                                                + 8 * QMC_READS * n)
                           / PEAK_BYTES,
                           hash_ms=shard_hash_ms(
                               "generic_shard_bath_slice", QMC_READS, 1, n,
                               gshape, P),
                           card=name, power_limit=power)
                if lat is torus:
                    for key, ms_key in (("generic_shard_bath_slice", "ms"),
                                        ("generic_shard_bath_slice_wide",
                                         "first_kernel_ms")):
                        results[key].update(ms=rec[ms_key],
                                            plain_ms=rec["plain_ms"],
                                            bound_ms=bound[0],
                                            bound_by=bound[1])
            emit(rec)
            for key, route in (("generic_shard_bath_slice", "float32"),
                               ("generic_shard_bath_slice_wide", "wide")):
                results[key]["max_abs_err"] = max(
                    results[key].get("max_abs_err", 0.0), err[route])

    # S7
    gtorus = torus.to_generic()
    graph = graph_shape(gtorus)
    gp = packed_ops.build_packed(gtorus)
    n = gp.nspins
    one = random_pm1(rng, (1, n), dev)
    state = packed_ops.pack_state(gp, one.expand(P, n)[None])[0]
    state[:, : n // 8] *= -1.0  # a stripe the Trotter bonds cut
    state[ps // 2:ps + 3, n // 2:n // 2 + 640] *= -1.0
    state = state.contiguous()
    tables = {"none": None, "bath": lut.contiguous(),
              "asymmetric": asymmetric_table(P, dev)}
    for block in ("slab", "ring"):
        first, rows_n = (k0, ps) if block == "slab" else (0, P)
        rows = state[first:first + rows_n].contiguous()
        halo = ((state[first - 1].contiguous(),
                 state[first + rows_n].contiguous()) if block == "slab"
                else (state[-1].contiguous(), state[0].contiguous()))
        for tname, table in tables.items():
            def step(x, table=table, rows=rows, first=first, halo=halo):
                return ck.ShardStep(gp, x, *halo,
                                    None if table is None else state, first,
                                    P, b20, jp, temp * P, t, seed, table,
                                    asym=ck.ring_asymmetric(table))
            ref = step(rows)
            want = ck.shard_label_init_ref(ref)
            hp, hn = (torch.as_tensor(rng.integers(-1, P * n, n).astype(
                np.int32), device=dev) for _ in range(2))
            fl = (torch.as_tensor(rng.integers(-1, P * n, (P, n)).astype(
                np.int32), device=dev) if table is not None else None)
            bond_up = torch.as_tensor((rng.random(n) < 0.5).astype(
                np.uint8), device=dev)
            if block == "slab":
                want_r = ck.shard_label_round_ref(ref, want[0].clone(),
                                                  want[1], hp, bond_up, hn,
                                                  fl)
                labels_w = want_r[0]
            else:
                labels_w = want[0]
            flip_w = ck.shard_label_flip_ref(ref, labels_w)
            bad, err, launched = {}, {}, {}
            for route in ("rule", "off_chip"):
                def run(route=route):
                    st = step(rows.clone())
                    got = ck.shard_label_init(st)
                    out = [got[0].clone(), got[1]]
                    if block == "slab":
                        rg = ck.shard_label_round(st, got[0], got[1], hp,
                                                  bond_up, hn, fl)
                        out += [rg[0].clone(), rg[1]]
                        labels = rg[0]
                    else:
                        labels = got[0]
                    out.append(ck.shard_label_flip(st, labels))
                    return out
                _build.reset_launches()
                out = (run() if route == "rule" else forced(
                    ck, "card_shard_label_geometry", run, off_chip))
                launched[route] = launched_now()
                torch.cuda.synchronize()
                ref_out = [want[0], want[1]] + ([want_r[0], want_r[1]]
                                                if block == "slab" else [])
                ref_out.append(flip_w)
                bad[route], err[route] = mismatches(
                    [x.double() for x in out], [y.double() for y in ref_out])
            rounds = 1 if block == "slab" else 0
            rec = {"phase": "parallel", "check": "shard_redesign",
                   "kernel": "shard_label",
                   "graph": f"gaussian_torus({L}, 0).to_generic()",
                   "block": block, "rows": rows_n, "slices": P,
                   "table": tname, "geometry": ck.card_shard_label_geometry(
                       P, rows_n, n, dev, table is not None),
                   "launches": launched, "mismatches": bad,
                   "max_abs_err": err, "frozen_or_free_labels": int((want[0] >= 0).sum())}
            what = f"S7 on the {block}, table {tname}"
            check(sum(bad.values()) == 0,
                  f"{what}: both routes equal the plain versions")
            check(all(v == {"shard_label": 2 + rounds}
                      for v in launched.values()),
                  f"{what} launched {launched}")
            if tname != "asymmetric":
                draw = lambda: ck.shard_label_init(step(rows))  # noqa: E731
                rec["ms"] = event_ms(draw, 50, spin)
                rec["off_chip_ms"] = forced(
                    ck, "card_shard_label_geometry",
                    lambda: event_ms(draw, 50, spin), off_chip)
                st = step(rows.clone())
                labels, bdn = ck.shard_label_init(st)
                if block == "slab":
                    rec["round_ms"] = event_ms(lambda: ck.shard_label_round(
                        st, labels.clone(), bdn, hp, bond_up, hn, fl), 50,
                        spin)
                rec["flip_ms"] = event_ms(
                    lambda: ck.shard_label_flip(st, labels), 200, spin)
                if block == "slab":
                    rec["plain_ms"] = event_ms(
                        lambda: ck.shard_label_init_ref(step(rows)), 2)
                bath_on = table is not None
                bound = shard_bound("shard_label", 1, rows_n, n, graph,
                                    slices=P, bath=bath_on)
                rec.update(bound_ms=bound[0], bound_by=bound[1],
                           hash_ms=shard_hash_ms("shard_label", 1, rows_n, n,
                                                 graph, P, bath_on),
                           card=name, power_limit=power)
                if block == "slab" and tname == "none":
                    results["shard_label"].update(
                        ms=rec["ms"], plain_ms=rec["plain_ms"],
                        bound_ms=bound[0], bound_by=bound[1])
            emit(rec)
            results["shard_label"]["max_abs_err"] = max(
                results["shard_label"].get("max_abs_err", 0.0),
                err["rule"])


def parallel_state(chains, slices, sites, seed, dev):
    """(chains, slices, sites) random +/-1 float32 confs from `seed` on
    `dev`, the same on every rank."""
    r = np.random.default_rng(seed)
    return torch.as_tensor(
        r.choice([-1.0, 1.0], size=(chains, slices, sites)).astype(
            np.float32), device=dev)


def card_trotter_rank(n_ranks, device_type, lat_l, chains, slices, steps,
                      taus, trials):
    """The body of each gloo rank of the parallel phase on the card:
    anneal_sharded_split on the lat_l x lat_l torus and anneal_sharded on
    its generic form at P = `slices`, `chains` chains, replica n_ranks,
    line moves off and on, from one seed; the launches each made on this
    rank; rank 0's slope ms a sweep of the split anneal with line moves and
    the host ms of one ring exchange of its rows. Rank 0 returns the states
    as int8."""
    import torch.distributed as dist
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.parallel import _collectives as coll
    from montecarlosolvers_tpu_torch.parallel import make_mesh, trotter
    from montecarlosolvers_tpu_torch.parallel import mesh as pmesh

    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    sync = torch.cuda.synchronize if dev.type == "cuda" else lambda: None
    rank = dist.get_rank()
    torus = instances.gaussian_torus(lat_l, seed=0, device=dev)
    confs = parallel_state(chains, slices, lat_l * lat_l, 31, dev)
    mesh = make_mesh(replica=n_ranks, device_type=device_type)
    a = schedules.transverse_field(3.0, 1e-8, steps, device=dev)
    b = torch.ones_like(a)
    out = {}
    for kind, prob, engine in (
            ("split", torus, trotter.anneal_sharded_split),
            ("generic", torus.to_generic(), trotter.anneal_sharded)):
        for gm in (False, True):
            _build.reset_launches()
            got = pmesh.full_tensor(engine(
                prob, a, b, 1.0 / slices, confs,
                torch.Generator().manual_seed(5), mesh, global_moves=gm))
            sync()
            out[f"{kind}_gm{int(gm)}"] = (
                got.to(torch.int8).cpu().numpy() if rank == 0 else None,
                launched_now())

    def run(tau):
        g = schedules.transverse_field(3.0, 1e-8, tau, device=dev)
        trotter.anneal_sharded_split(
            torus, g, torch.ones_like(g), 1.0 / slices, confs,
            torch.Generator().manual_seed(5), mesh, global_moves=True)
    sweep_ms, _ = slope_ms(run, taus, trials, sync)
    rows = confs[:, :2, : lat_l * lat_l // 2].contiguous()
    group = mesh.get_group("replica")
    coll.ring_halo(rows[:, -1], rows[:, 0], group)
    sync()
    t0 = time.perf_counter()
    for _ in range(20):
        coll.ring_halo(rows[:, -1], rows[:, 0], group)
    sync()
    out["timing"] = {"sweep_ms": sweep_ms,
                     "exchange_ms": 1e3 * (time.perf_counter() - t0) / 20}
    return out


def rest_confs(slices, sites, seed, dev):
    """One (slices, sites) chain of the sharded cluster engines: a random
    +/-1 configuration from `seed` in every slice, as the pre-anneal hands
    PIQMC its replicated states."""
    return parallel_state(1, 1, sites, seed, dev)[0].expand(
        slices, sites).contiguous()


def cluster_runs(problem, slices, steps, dev):
    """(name, run(engine kwargs) -> state, single-device run) of the
    sharded Wolff and SW legs: rules "local" without and "full" with bath
    bonds, SW without them, with them and on asymmetric_table (a bath table
    not symmetric in ring distance), at T = 1/P over Gamma: 3 -> 1e-8."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.solvers import qmc

    a = schedules.transverse_field(3.0, 1e-8, steps, device=dev)
    b = torch.ones_like(a)
    lut = schedules.bath_lookuptable(slices, BATH_ALPHA, device=dev)
    confs = rest_confs(slices, problem.nspins, 17, dev)
    cases = []
    for label, kind, kw in (
            ("wolff_local", "wolff", {"rule": "local"}),
            ("wolff_full_bath", "wolff", {"rule": "full",
                                          "lookuptable": lut}),
            ("sw", "sw", {}),
            ("sw_bath", "sw", {"lookuptable": lut}),
            ("sw_bath_asymmetric", "sw",
             {"lookuptable": asymmetric_table(slices, dev)})):
        single = qmc.anneal_wolff if kind == "wolff" else qmc.anneal_sw
        cases.append((label, kind, kw, lambda engine, kw=kw: engine(
            problem, a, b, 1.0 / slices, confs,
            torch.Generator().manual_seed(5), **kw),
            lambda kw=kw, single=single: single(
                problem, a, b, 1.0 / slices, confs,
                torch.Generator().manual_seed(5), **kw)))
    return cases


def one_rank_rest(dev, main_launches, torus, rmesh, power, name):
    """(g) of phase parallel: on the one-rank NCCL mesh, the sharded bath
    (SHARD_BATH_TAU sweeps, QMC_READS chains, P = QMC_SLICES, line moves
    off and on) equals the sequential generic bath kernel bitwise, and the
    sharded Wolff and SW engines (SHARD_CLUSTER_STEPS steps, one chain)
    equal fk_wolff and fk_label, with and without the bath; each run's
    launches exact and counted into the kernels line; ms a sweep or step
    beside the single-device kernels', rounds a step and the exchange's
    share."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops
    from montecarlosolvers_tpu_torch.ops import split_kernels as sk
    from montecarlosolvers_tpu_torch.parallel import mesh as pmesh
    from montecarlosolvers_tpu_torch.parallel import trotter
    from montecarlosolvers_tpu_torch.solvers.sa import draw_seed

    P, n, tau = QMC_SLICES, L * L, SHARD_BATH_TAU
    temp = 1.0 / P
    a = schedules.transverse_field(3.0, 1e-8, tau, device=dev)
    b = torch.ones_like(a)
    lut = schedules.bath_lookuptable(P, BATH_ALPHA, device=dev)
    confs = parallel_state(QMC_READS, P, n, 31, dev)
    seed = draw_seed(torch.Generator().manual_seed(5))
    colors = packed_ops.packed_from_lattice(torus).num_colors

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for gm in (False, True):
        single, t_single = wall(lambda: gk.anneal_generic_qmc_bath(
            torus, a, b, temp, lut, confs, seed, global_moves=gm))
        _build.reset_launches()
        got, t_sharded = wall(lambda: pmesh.full_tensor(trotter.anneal_sharded(
            torus, a, b, temp, confs, torch.Generator().manual_seed(5), rmesh,
            global_moves=gm, lookuptable=lut)))
        launched = launched_now()
        for k, v in launched.items():
            if k in PARALLEL_KERNELS:
                main_launches[k] += v
        bad, _ = mismatches([got], [single])
        want = {"generic_shard_bath_slice": P * tau}
        if gm:
            want.update({"generic_shard_line_part": colors * tau,
                         "generic_shard_line_accept": colors * tau})
        k5 = None
        if gm:
            _, t5 = wall(lambda: sk.anneal_lattice_qmc_bath_split(
                torus, a, b, temp, lut, confs, 5, global_moves=True))
            k5 = 1e3 * t5 / tau
        emit({"phase": "parallel", "check": "one_rank_nccl_bath",
              "global_moves": gm, "slices": P, "chains": QMC_READS,
              "tau": tau, "mismatched_spins": bad, "launches": launched,
              "ms_per_sweep_sharded": 1e3 * t_sharded / tau,
              "ms_per_sweep_generic_bath": 1e3 * t_single / tau,
              "ms_per_sweep_kernel5": k5, "card": name,
              "power_limit": power})
        check(bad == 0, f"the one-rank sharded bath (global_moves={gm}) "
                        "equals the generic bath kernel's")
        check(launched == want, f"the one-rank sharded bath launched "
                                f"{launched}")
    gtorus = torus.to_generic()
    has_field = bool((gtorus.h != 0).any())
    steps = SHARD_CLUSTER_STEPS
    for label, kind, kw, run, single_run in cluster_runs(gtorus, P, steps,
                                                         dev):
        single, t_single = wall(single_run)
        stats = {}
        engine = (trotter.anneal_wolff_sharded if kind == "wolff"
                  else trotter.anneal_sw_sharded)
        _build.reset_launches()
        got, t_sharded = wall(lambda: pmesh.full_tensor(run(
            lambda *x, **y: engine(*x, rmesh, stats=stats, **y))))
        launched = launched_now()
        for k, v in launched.items():
            if k in PARALLEL_KERNELS:
                main_launches[k] += v
        bad, _ = mismatches([got], [single])
        if kind == "wolff":
            extra = 1 + int(kw["rule"] == "local" and has_field)
            want = {"shard_wolff": sum(stats["rounds"]) + extra * steps}
        else:
            want = {"shard_label": 2 * steps + sum(stats["rounds"])}
        emit({"phase": "parallel", "check": "one_rank_nccl_cluster",
              "case": label, "slices": P, "steps": steps,
              "mismatched_spins": bad, "launches": launched,
              "rounds_per_step": sum(stats["rounds"]) / steps,
              "ms_per_step_sharded": 1e3 * t_sharded / steps,
              "ms_per_step_single_device": 1e3 * t_single / steps,
              "exchange_share": stats["exchange_seconds"] / t_sharded,
              "card": name, "power_limit": power})
        check(bad == 0, f"the one-rank sharded {label} equals the "
                        "single-device kernel's")
        check(launched == want, f"the one-rank sharded {label} launched "
                                f"{launched}")


def card_rest_rank(n_ranks, device_type, lat_l, chains, slices, ring_slices,
                   tau, steps):
    """The body of each gloo rank of (h): the sharded bath on the lat_l x
    lat_l torus at P = `slices` and at P = `ring_slices` (one slice a
    rank: the ring coloured), `chains` chains, `tau` sweeps; the sharded
    Wolff and SW legs of `cluster_runs` on its generic form at P = `slices`,
    `steps` steps. Rank 0 returns the states (int8) and the rounds; every
    rank its launches."""
    import torch.distributed as dist
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.parallel import make_mesh, trotter
    from montecarlosolvers_tpu_torch.parallel import mesh as pmesh

    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    rank = dist.get_rank()
    torus = instances.gaussian_torus(lat_l, seed=0, device=dev)
    mesh = make_mesh(replica=n_ranks, device_type=device_type)
    out = {}

    def keep(key, x, stats=None):
        x = pmesh.full_tensor(x)
        out[key] = (x.to(torch.int8).cpu().numpy() if rank == 0 else None,
                    launched_now(), stats and stats["rounds"])

    for p in (slices, ring_slices):
        a = schedules.transverse_field(3.0, 1e-8, tau, device=dev)
        lut = schedules.bath_lookuptable(p, BATH_ALPHA, device=dev)
        confs = parallel_state(chains, p, lat_l * lat_l, 33, dev)
        _build.reset_launches()
        keep(f"bath_p{p}", trotter.anneal_sharded(
            torus, a, torch.ones_like(a), 1.0 / p, confs,
            torch.Generator().manual_seed(5), mesh, lookuptable=lut))
    for label, kind, kw, run, _ in cluster_runs(torus.to_generic(), slices,
                                                steps, dev):
        engine = (trotter.anneal_wolff_sharded if kind == "wolff"
                  else trotter.anneal_sw_sharded)
        stats = {}
        _build.reset_launches()
        keep(label, run(lambda *x, **y: engine(*x, mesh, stats=stats, **y)),
             stats)
    return out


def gloo_rest(dev, torus, power, name):
    """(h) of phase parallel: PARALLEL_RANKS gloo ranks sharing the card
    (`dryrun.run_ranks`, `card_rest_rank`): the sharded bath at P =
    QMC_SLICES and at P = GLOO_RING_SLICES equals the one-process lockstep
    plain version (`trotter.anneal_sharded_bath_ref`) bitwise, and its mean
    energy per spin lies within PARALLEL_ANCHOR of the sequential bath
    kernel's from the same seed; the sharded Wolff and SW legs equal the
    single-device kernels bitwise; every rank's launches as its rounds
    say."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
    from montecarlosolvers_tpu_torch.parallel import dryrun, trotter
    from montecarlosolvers_tpu_torch.solvers import qmc
    from montecarlosolvers_tpu_torch.solvers.sa import draw_seed

    P, n, ranks = QMC_SLICES, L * L, PARALLEL_RANKS
    tau, steps = GLOO_BATH_TAU, GLOO_CLUSTER_STEPS
    t0 = time.perf_counter()
    out = dryrun.run_ranks(card_rest_rank, ranks, dev.type, args=(
        L, QMC_READS, P, GLOO_RING_SLICES, tau, steps))
    seconds = time.perf_counter() - t0
    seed = draw_seed(torch.Generator().manual_seed(5))
    for p in (P, GLOO_RING_SLICES):
        state = torch.as_tensor(out[0][f"bath_p{p}"][0], dtype=torch.float32,
                                device=dev)
        a = schedules.transverse_field(3.0, 1e-8, tau, device=dev)
        b = torch.ones_like(a)
        lut = schedules.bath_lookuptable(p, BATH_ALPHA, device=dev)
        confs = parallel_state(QMC_READS, p, n, 33, dev)
        ref = trotter.anneal_sharded_bath_ref(torus, a, b, 1.0 / p, lut,
                                              confs, seed, ranks)
        single = gk.anneal_generic_qmc_bath(torus, a, b, 1.0 / p, lut, confs,
                                            seed)
        bad = int((state != ref).sum())
        e_sh = float(qmc.best_slice_energy(torus, state).mean()) / n
        e_1 = float(qmc.best_slice_energy(torus, single).mean()) / n
        launches = [o[f"bath_p{p}"][1] for o in out]
        per_rank = max(1, p // ranks)
        emit({"phase": "parallel", "check": "gloo_bath", "ranks": ranks,
              "slices": p, "slices_per_rank": p // ranks, "tau": tau,
              "mismatched_spins_vs_lockstep": bad,
              "mean_best_energy_per_spin": e_sh,
              "sequential_energy_per_spin": e_1,
              "launches_each_rank": launches})
        check(bad == 0, f"{ranks} gloo ranks' sharded bath at P = {p} equals "
                        "the one-process lockstep plain version")
        check(abs(e_sh - e_1) <= PARALLEL_ANCHOR,
              f"the sharded bath at P = {p}: {e_sh} within "
              f"{PARALLEL_ANCHOR} of the sequential bath's {e_1}")
        check(all(x == {"generic_shard_bath_slice": per_rank * tau}
                  for x in launches), f"each rank's bath launches "
                                      f"{launches}")
    gtorus = torus.to_generic()
    has_field = bool((gtorus.h != 0).any())
    for label, kind, kw, _, single_run in cluster_runs(gtorus, P, steps,
                                                       dev):
        state, launched, rounds = out[0][label]
        single = single_run().to(torch.int8).cpu().numpy()
        bad = int((state != single).sum())
        key = "shard_wolff" if kind == "wolff" else "shard_label"
        extra = ((1 + int(kw["rule"] == "local" and has_field))
                 if kind == "wolff" else 2)
        want = sum(rounds) + extra * steps
        emit({"phase": "parallel", "check": "gloo_cluster", "case": label,
              "ranks": ranks, "slices": P, "steps": steps,
              "mismatched_spins": bad, "rounds": rounds,
              "launches_each_rank": [o[label][1] for o in out]})
        check(bad == 0, f"{ranks} gloo ranks' sharded {label} equals the "
                        "single-device kernel's")
        check(all(o[label][1] == {key: want} for o in out),
              f"each rank's {label} launches {want}")
    emit({"phase": "parallel", "check": "gloo_rest_timing", "ranks": ranks,
          "seconds": seconds, "card": name, "power_limit": power})


@contextlib.contextmanager
def plane_svmc_phased():
    """Within the block kernel 7's wrapper takes its per-phase kernels at
    every shape (gibbs_check.phased_route does so for kernels A, B, 4 and
    5)."""
    from montecarlosolvers_tpu_torch.ops import plane_kernels as pk

    saved = pk.plane_svmc_geometry
    try:
        pk.plane_svmc_geometry = lambda *args, **kw: None
        yield
    finally:
        pk.plane_svmc_geometry = saved


def sampler_offset_checks(dev, torus, odd_torus, power, name):
    """(j): kernels 4 and 7 (each on its cluster and per-phase route) and
    packed SVMC (static and per-step tables) at SVMC_READS chains, TF, on
    the 80x80 torus, the 81x81 one and the generic form; the dense in-block
    kernel at sk_model(DENSE_N), DENSE_READS chains, shared and per-chain
    temperatures, on one block's fields; the Houdayer move on the generic
    form, PT_RUNGS pairs: a block of chains (pairs) with its offset equals
    those rows of the whole batch's run, 0 mismatches. Each is timed with
    CUDA events at offset 0 and at OFFSET_CHAIN0 on the whole batch, in
    turns (0, offset, offset, 0; the best of each). The dense anneal's
    rows (block products of the block's own row count, ROADMAP.md queue 3)
    are counted, not held."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck
    from montecarlosolvers_tpu_torch.ops import dense_kernels as dk
    from montecarlosolvers_tpu_torch.ops import dense_sweep as ds
    from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops
    from montecarlosolvers_tpu_torch.ops import plane_kernels as pk
    from montecarlosolvers_tpu_torch.ops import split as split_ops
    from montecarlosolvers_tpu_torch.ops import split_kernels as sk

    gtorus = torus.to_generic()
    rng = np.random.default_rng(41)

    def angles(*shape):
        return torch.as_tensor((rng.random(shape) * np.pi).astype(
            np.float32), device=dev)

    def spins(*shape):
        return torch.as_tensor(rng.choice([-1.0, 1.0], size=shape).astype(
            np.float32), device=dev)
    steps = OFFSET_STEPS
    a = schedules.transverse_field(2.0, 1e-3, steps, device=dev)
    b = torch.ones_like(a)
    sl = split_ops.build_split(torus)
    pl = pk._planes_of(odd_torus, torch.empty(0, device=dev), "planes")
    pg = packed_ops.build_packed(gtorus)
    tables = gk.packed_tables(pg, *noisy_tables(gtorus, dev, steps), 1,
                              steps, dev)
    halves = tuple(x.contiguous() for x in split_ops.pack_classical(
        sl, angles(SVMC_READS, L * L)))
    th81 = angles(SVMC_READS, ODD_L, ODD_L)
    packed_th = packed_ops.pack_state(pg, angles(SVMC_READS, L * L)
                                      ).contiguous()
    dp = instances.sk_model(DENSE_N, rng=0, device=dev)[0]
    jp_, hp_, dense_s = ds.padded(dp.J, dp.h, spins(DENSE_READS, DENSE_N),
                                  DENSE_BLOCK)
    start = DENSE_BLOCK  # the second block
    fb = ds.block_product(dense_s, jp_, start, DENSE_BLOCK)
    dense_t = schedules.linear(3.0, 0.1, 4, device=dev)
    dense_pc = torch.linspace(0.5, 3.0, DENSE_READS, device=dev)[None].expand(
        4, -1)
    pairs = tuple(spins(PT_RUNGS, L * L) for _ in range(2))
    temp = SVMC_TEMP
    # kernel -> (run(state, chain0) -> tuple, state tuple, route context,
    # block width)
    cases = {
        "split_svmc": (lambda st, c0: sk.svmc_split_anneal(
            sl, a, b, temp, *st, 71, True, chain0=c0), halves),
        "plane_svmc": (lambda st, c0: (pk.svmc_plane_anneal(
            pl, a, b, temp, st[0], 71, True, chain0=c0),), (th81,)),
        "packed_svmc": (lambda st, c0: (gk.packed_svmc_anneal(
            pg, a, b, temp, st[0], 71, True, chain0=c0),), (packed_th,)),
        "packed_svmc_noisy": (lambda st, c0: (gk.packed_svmc_anneal(
            pg, a, b, temp, st[0], 71, True, tables=tables, chain0=c0),),
            (packed_th,)),
        "dense_sa": (lambda st, c0: (dk.dense_sa_block(
            st[0].clone(), st[1], hp_, jp_, start, dense_t, 2, 71,
            chain0=c0),), (dense_s, fb)),
        "dense_sa_chain": (lambda st, c0: (dk.dense_sa_block(
            st[0].clone(), st[1], hp_, jp_, start, st[2], 2, 71,
            chain0=c0),), (dense_s, fb, dense_pc)),
        "houdayer": (lambda st, c0: ck.houdayer_move(
            gtorus, *st, 71, 4, pair0=c0), pairs),
    }
    routes_of = {"split_svmc": routes(),
                 "plane_svmc": (("cluster", contextlib.nullcontext),
                                ("phased", plane_svmc_phased))}
    for kname, (run, state) in cases.items():
        width = state[0].shape[0]
        c0, w = width // 4 + 13, width // 4
        if kname == "dense_sa_chain":  # the table's rows of the block
            def cut(x, i):
                return x[c0:c0 + w] if i < 2 else x[:, c0:c0 + w]
        else:
            def cut(x, i):
                return x[c0:c0 + w]
        for route, ctx in routes_of.get(kname, (("cluster",
                                                 contextlib.nullcontext),)):
            with ctx():
                full = run(state, 0)
                block = run(tuple(cut(x, i).contiguous()
                                  for i, x in enumerate(state)), c0)
                torch.cuda.synchronize()
                bad = sum(int((f[c0:c0 + w] != g).sum())
                          for f, g in zip(full, block))
                times = {0: [], OFFSET_CHAIN0: []}
                for off in (0, OFFSET_CHAIN0, OFFSET_CHAIN0, 0):
                    times[off].append(event_ms(lambda: run(state, off),
                                               3 if "svmc" in kname else 20))
            emit({"phase": "parallel", "check": "sampler_kernel_offset",
                  "kernel": kname, "route": route, "chains": width,
                  "block": [c0, c0 + w], "mismatched": bad,
                  "ms_offset_0": min(times[0]),
                  "ms_offset": min(times[OFFSET_CHAIN0]),
                  "offset": OFFSET_CHAIN0,
                  "steps": steps if "svmc" in kname else 1,
                  "card": name, "power_limit": power})
            check(bad == 0, f"{kname} ({route}) on [{c0}, {c0 + w}) with "
                            "its offset equals the unsharded rows")

    # the dense anneal's block against the whole batch's rows: counted
    sweeps = 4
    sched = schedules.linear(3.0, 0.1, sweeps, device=dev)
    s0 = dense_s[:, :DENSE_N].contiguous()
    full = dk.dense_anneal(dp, sched, s0, 71)
    c0, w = DENSE_READS // 4, DENSE_READS // 4
    block = dk.dense_anneal(dp, sched, s0[c0:c0 + w].contiguous(), 71,
                            chain0=c0)
    emit({"phase": "parallel", "check": "dense_anneal_block_rows",
          "chains": DENSE_READS, "block": [c0, c0 + w], "sweeps": sweeps,
          "mismatched_spins": int((full[c0:c0 + w] != block).sum()),
          "of": int(block.numel())})


def sampler_calls(dev, steps):
    """name -> (state, sharded dim, run): every entry point the samplers'
    slice shards, at the main path's widths, `steps` sweeps or steps, from
    fixed seeds; run(state) takes the full or the chain-sharded state.
    pt.sample at PT_RUNGS rungs and sample_piqmc at P = QMC_SLICES on the
    80x80 torus, sample_icm (ICM_RUNGS) on random_3d_lattice(12), pa.sample
    and sample_adaptive at PA_READS, sample_piqmc at PAQ_READS x
    PAQ_SLICES, svmc.anneal (SVMC_READS, TF), the noisy anneals on the
    generic form (SA_READS, SVMC_READS) and the dense anneal (sk_model(
    DENSE_N), DENSE_READS)."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.solvers import pa, pt, qmc, sa, svmc

    torus = instances.gaussian_torus(L, seed=0, device=dev)
    gtorus = torus.to_generic()
    g3 = instances.random_3d_lattice(12, rng=0, device=dev)[0]
    dp = instances.sk_model(DENSE_N, rng=0, device=dev)[0]
    n = L * L

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def spins(batch, sites, seed):
        return sa.random_state(gen(seed), sites, batch=batch, device=dev)
    temps = pt.geometric_ladder(PT_COLD, PT_HOT, PT_RUNGS, device=dev)
    gammas = torch.tensor(np.geomspace(1.5, 0.3, PT_RUNGS),
                          dtype=torch.float32, device=dev)
    temps_icm = pt.geometric_ladder(0.5, 3.0, ICM_RUNGS, device=dev)
    a = schedules.transverse_field(2.0, 1e-3, steps, device=dev)
    b = torch.ones_like(a)
    jt, ht = noisy_tables(gtorus, dev, steps)
    return {
        "pt.sample": (spins((PT_RUNGS,), n, 21), 0, lambda s: pt.sample(
            torus, temps, s, gen(22), steps, swap_every=PT_SWAP,
            collect_energy=True, per_pair_rates=True)),
        "pt.sample_piqmc": (
            qmc.replicate(spins((PT_RUNGS,), n, 23), QMC_SLICES), 0,
            lambda c: pt.sample_piqmc(torus, gammas, 1.0 / QMC_SLICES, c,
                                      gen(24), steps, swap_every=2,
                                      global_moves=True,
                                      per_pair_rates=True)),
        "pt.sample_icm": (spins((2, ICM_RUNGS), g3.nspins, 25), 1,
                          lambda s: pt.sample_icm(g3, temps_icm, s, gen(26),
                                                  steps, houdayer_every=2)),
        "pa.sample": (spins((PA_READS,), n, 27), 0, lambda s: pa.sample(
            torus, pa.beta_linear(3.0, steps, beta_start=0.0, device=dev),
            s, gen(28), beta0=0.0, collect_stats=True)),
        "pa.sample_adaptive": (spins((PA_READS,), n, 29), 0,
                               lambda s: pa.sample_adaptive(
                                   torus, PA_ADAPTIVE_BETA, s, gen(30),
                                   max_steps=steps)),
        "pa.sample_piqmc": (
            qmc.replicate(spins((PAQ_READS,), n, 31), PAQ_SLICES), 0,
            lambda c: pa.sample_piqmc(
                torus, torch.linspace(2.0, 0.3, steps, device=dev),
                1.0 / PAQ_SLICES, c, gen(32), global_moves=True,
                collect_stats=True)),
        "svmc.anneal": (
            svmc.random_state(gen(33), n, batch=(SVMC_READS,), device=dev),
            0, lambda th: svmc.anneal(torus, a, b, SVMC_TEMP, th, gen(34),
                                      tf=True)),
        "sa.anneal_noisy": (spins((SA_READS,), n, 35), 0,
                            lambda s: sa.anneal_noisy(
                                gtorus, schedules.linear(3.0, 0.1, steps,
                                                         device=dev),
                                jt, ht, s, gen(36))),
        "svmc.anneal_noisy": (
            svmc.random_state(gen(37), n, batch=(SVMC_READS,), device=dev),
            0, lambda th: svmc.anneal_noisy(gtorus, a, b, SVMC_TEMP, jt, ht,
                                            th, gen(38), tf=True)),
        "sa.anneal dense": (spins((DENSE_READS,), DENSE_N, 39), 0,
                            lambda s: sa.anneal(dp, schedules.linear(
                                3.0, 0.1, max(2, steps // 10), device=dev),
                                s, gen(40))),
    }


def flat_outputs(out):
    """A call's outputs as a tuple of host tensors, in order: DTensors
    gathered, a stats dict by sorted key, numbers as 0-d tensors; +/-1
    states as int8."""
    from montecarlosolvers_tpu_torch.parallel import mesh as pmesh

    if isinstance(out, tuple):
        return sum((flat_outputs(x) for x in out), ())
    if isinstance(out, dict):
        return sum((flat_outputs(out[k]) for k in sorted(out)), ())
    if torch.is_tensor(out):
        x = pmesh.full_tensor(out)
        if x.dtype == torch.float32 and x.dim() >= 2 and bool(
                (x.abs() == 1).all()):
            x = x.to(torch.int8)
        return (x.cpu(),)
    return (torch.as_tensor(np.asarray(out)),)


def sharded_launches(name, launched):
    """The launches a sharded call makes on each rank, from its unsharded
    call's: the same, but for ICM, whose rank sweeps each ladder's run of
    its rungs on an engine of its own (two launches, and two energy
    launches, where the unsharded run makes one)."""
    if name != "pt.sample_icm":
        return launched
    return {k: v * (1 if k == "houdayer" else 2) for k, v in launched.items()}


def card_sampler_rank(n_ranks, device_type, steps):
    """The body of each gloo rank of (l): every call of `sampler_calls` on
    its state sharded over a chains mesh of n_ranks, each returning (rank
    0's outputs, the launches this rank made, the wall); and the bytes
    this rank sent in each gather of pa.sample."""
    import torch.distributed as dist
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.parallel import _collectives as coll
    from montecarlosolvers_tpu_torch.parallel import make_mesh
    from montecarlosolvers_tpu_torch.parallel import mesh as pmesh

    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    sync = torch.cuda.synchronize if dev.type == "cuda" else lambda: None
    rank = dist.get_rank()
    mesh = make_mesh(chains=n_ranks, device_type=device_type)
    out = {}
    sent = []
    gather = coll.gather
    for name, (state, dim, run) in sampler_calls(dev, steps).items():
        local = pmesh.as_dtensor(pmesh.local_block(state, mesh,
                                                   {dim: "chains"}),
                                 mesh, {dim: "chains"}, tuple(state.shape))
        if name == "pa.sample":
            coll.gather = lambda t, g, d: (sent.append(
                t.numel() * t.element_size()) or gather(t, g, d))
        _build.reset_launches()
        sync()
        t0 = time.perf_counter()
        try:
            res = run(local)
        finally:
            coll.gather = gather
        sync()
        wall = time.perf_counter() - t0
        flat = flat_outputs(res)
        out[name] = (tuple(x.numpy() for x in flat) if rank == 0 else None,
                     launched_now(), wall)
    out["pa_gather_bytes"] = sent
    return out


def sampler_sharding_checks(dev, power, name):
    """(k) a one-rank NCCL mesh: each call of `sampler_calls` at
    SHARDED_STEPS on its chain-sharded state equals the unsharded call
    bitwise (states, rates, log_z, stats, energies), with the launches of
    `sharded_launches`; its wall beside the unsharded wall and the share
    spent in gathers. (l) PARALLEL_RANKS gloo ranks sharing the card run
    the same calls at GLOO_SAMPLER_STEPS: bitwise the single-device run
    (the dense anneal: in distribution, its mismatched spins counted,
    ROADMAP.md queue 3), each rank's launches exact; the bytes a rank sends
    a pa.sample step."""
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.parallel import _collectives as coll
    from montecarlosolvers_tpu_torch.parallel import dryrun, make_mesh
    from montecarlosolvers_tpu_torch.parallel import mesh as pmesh

    def differing(want, got):
        """Differing values of paired outputs (a whole output's size where
        the shapes differ, and one more where the counts do)."""
        bad = abs(len(want) - len(got))
        for x, y in zip(want, got):
            x, y = np.asarray(x), np.asarray(y)
            bad += int((x != y).sum()) if x.shape == y.shape else x.size
        return bad

    # (k) one NCCL rank
    cmesh = make_mesh(chains=1, device_type=dev.type)
    for cname, (state, dim, run) in sampler_calls(dev, SHARDED_STEPS).items():
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = run(state)
        torch.cuda.synchronize()
        wall_1 = time.perf_counter() - t0
        launched = launched_now()
        in_gather = []
        gather = coll.gather

        def timed_gather(t, g, d):
            t1 = time.perf_counter()
            out = gather(t, g, d)
            torch.cuda.synchronize()
            in_gather.append(time.perf_counter() - t1)
            return out
        placed = pmesh.as_dtensor(pmesh.local_block(state, cmesh,
                                                    {dim: "chains"}),
                                  cmesh, {dim: "chains"}, tuple(state.shape))
        coll.gather = timed_gather
        _build.reset_launches()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = run(placed)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            coll.gather = gather
        launched_sh = launched_now()
        w, g_ = flat_outputs(want), flat_outputs(got)
        bad = differing(w, g_)
        emit({"phase": "parallel", "check": "one_rank_nccl_samplers",
              "call": cname, "shape": list(state.shape), "sharded_dim": dim,
              "steps": SHARDED_STEPS, "mismatched": bad,
              "outputs": len(w), "launches": launched_sh,
              "wall_s": wall, "unsharded_wall_s": wall_1,
              "gathers": len(in_gather),
              "gather_share": sum(in_gather) / wall,
              "card": name, "power_limit": power})
        check(bad == 0,
              f"{cname} on a one-rank NCCL mesh equals the unsharded call")
        check(launched_sh == sharded_launches(cname, launched),
              f"{cname} on one rank launched {launched_sh}, the unsharded "
              f"call {launched}")

    # (l) gloo ranks sharing the card
    t0 = time.perf_counter()
    ranks = dryrun.run_ranks(card_sampler_rank, PARALLEL_RANKS, dev.type,
                             args=(GLOO_SAMPLER_STEPS,))
    rank_seconds = time.perf_counter() - t0
    for cname, (state, dim, run) in sampler_calls(
            dev, GLOO_SAMPLER_STEPS).items():
        _build.reset_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = flat_outputs(run(state))
        torch.cuda.synchronize()
        wall_1 = time.perf_counter() - t1
        launched = sharded_launches(cname, launched_now())
        got, _, wall = ranks[0][cname]
        bad = differing(want, got)
        rec = {"phase": "parallel", "check": "gloo_ranks_samplers",
               "call": cname, "ranks": PARALLEL_RANKS,
               "steps": GLOO_SAMPLER_STEPS, "mismatched": bad,
               "wall_s_rank0": wall, "unsharded_wall_s": wall_1,
               "launches_each_rank": [r[cname][1] for r in ranks]}
        if cname == "sa.anneal dense":
            from montecarlosolvers_tpu_torch.models import instances

            dp = instances.sk_model(DENSE_N, rng=0, device=dev)[0]
            e_sh, e_1 = (dp.energy(torch.as_tensor(x, device=dev).float()
                                   ).double().cpu().numpy() / DENSE_N
                         for x in (got[0], want[0]))
            se = float(np.sqrt(e_sh.var() / e_sh.size
                               + e_1.var() / e_1.size))
            rec.update({"energy_per_spin": float(e_sh.mean()),
                        "unsharded_energy_per_spin": float(e_1.mean()),
                        "standard_error": se})
            emit(rec)
            check(abs(e_sh.mean() - e_1.mean()) <= 4 * se + 1e-6,
                  "the gloo ranks' dense anneal within 4 standard errors "
                  "of the single-device run")
        else:
            emit(rec)
            check(bad == 0, f"{PARALLEL_RANKS} gloo ranks' {cname} equals "
                            "the single-device call")
        check(all(r[cname][1] == launched for r in ranks),
              f"each gloo rank's {cname} launched {launched}")
    sent = ranks[0]["pa_gather_bytes"]
    emit({"phase": "parallel", "check": "gloo_pa_gathered_bytes",
          "ranks": PARALLEL_RANKS, "replicas": PA_READS,
          "steps": GLOO_SAMPLER_STEPS, "gathers": len(sent),
          "bytes_sent_by_rank0": int(sum(sent)),
          "bytes_a_step_each_rank": sum(sent) / GLOO_SAMPLER_STEPS,
          "bytes_a_step_all_ranks": PARALLEL_RANKS * sum(sent)
          / GLOO_SAMPLER_STEPS, "seconds": rank_seconds})

# ---------------------------------------- the rest of the parallel layer


def cluster_offset_checks(dev, gtorus, power, name):
    """(n): fk_wolff (16 chains, rule "local"), fk_label (8 chains, the
    space-time sweep) and fk_line (16 chains, WC3 and WC2, alpha
    CLUSTER_ALPHA) at P = CLUSTER_SLICES on the 80x80 torus's generic form:
    a block of chains run with its chain0 equals those rows of the whole
    batch's run, 0 mismatched spins. Each is timed with CUDA events on the
    whole batch at offset 0 and at OFFSET_CHAIN0, in turns (0, offset,
    offset, 0; the best of each). A Wolff step's work is its clusters,
    which the offset's draws change: its line gives the cluster sites of
    one run at each offset beside the times."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.ops import cluster_kernels as ck
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops

    pg = packed_ops.build_packed(gtorus)
    rng = np.random.default_rng(43)
    P, steps = CLUSTER_SLICES, CLUSTER_OFFSET_STEPS
    lut = schedules.bath_lookuptable(P, CLUSTER_ALPHA, device=dev)

    def wolff(chains):
        c, b, jp, teff = cluster_inputs(pg, dev, rng, chains, P, steps)
        vis = torch.zeros(chains, dtype=torch.int64, device=dev)
        # the cluster sites are counted on runs of the whole batch
        return (lambda x, c0: ck.wolff_anneal(
            pg, b, jp, teff, x, 31, "local", None, 0,
            vis if x.shape[0] == chains else None, chain0=c0)), c, vis

    def label(chains):
        c, b, jp, teff = cluster_inputs(pg, dev, rng, chains, P, steps)
        return (lambda x, c0: ck.sw_anneal(pg, b, jp, teff, x, 32, None, 0,
                                           chain0=c0)), c, None

    def line(per_slice_seeds, chains):
        c, b, jp, teff = cluster_inputs(pg, dev, rng, chains, P, 1)
        t_eff = float(teff[0])
        p_pair, p_t = ck.line_tables(lut, jp, t_eff, P, dev)

        def run(x, c0):
            return ck.line_anneal(pg, b, jp, p_t, t_eff, lut, p_pair, x, 33,
                                  per_slice_seeds, chain0=c0)
        return run, c, None

    for kname, case, (run, state, vis) in (
            ("fk_wolff", "rule local", wolff(16)),
            ("fk_label", "space-time", label(8)),
            ("fk_line", "WC3", line(True, 16)),
            ("fk_line", "WC2", line(False, 16))):
        width = state.shape[0]
        c0, w = width // 4 + 1, width // 4
        full = run(state, 0)
        block = run(state[c0:c0 + w].contiguous(), c0)
        torch.cuda.synchronize()
        bad = int((full[c0:c0 + w] != block).sum())
        times = {0: [], OFFSET_CHAIN0: []}
        for off in (0, OFFSET_CHAIN0, OFFSET_CHAIN0, 0):
            times[off].append(event_ms(lambda: run(state, off), 3))
        rec = {"phase": "parallel", "check": "cluster_kernel_offset",
               "kernel": kname, "case": case, "chains": width,
               "slices": P, "steps": 1 if kname == "fk_line" else steps,
               "block": [c0, c0 + w], "mismatched_spins": bad,
               "ms_offset_0": min(times[0]),
               "ms_offset": min(times[OFFSET_CHAIN0]),
               "offset": OFFSET_CHAIN0,
               "ratio": min(times[OFFSET_CHAIN0]) / min(times[0]),
               "card": name, "power_limit": power}
        if vis is not None:
            for off in (0, OFFSET_CHAIN0):
                vis.zero_()
                run(state, off)
                rec[f"cluster_sites_offset_{off}"] = int(vis.sum())
        emit(rec)
        check(bad == 0, f"{kname} ({case}) on [{c0}, {c0 + w}) with its "
                        "offset equals the unsharded rows")


def cluster_calls(dev, sa_steps, qmc_steps):
    """name -> (state, run): the five cluster methods of solve() as it runs
    them (sa_wolff and sa_sw with local sweeps; piqmc_wolff, rule "local";
    piqmc_sw, WC3 at alpha CLUSTER_ALPHA; piqmc_sw_full with local sweeps),
    sa.anneal_sw without local sweeps (one fk_label launch) and WC2
    (anneal_sw_bath, per_slice_seeds=False), on the 80x80 torus's generic
    form at CLUSTER_SA_READS chains, `sa_steps` steps, and CLUSTER_QMC_READS
    x CLUSTER_SLICES, `qmc_steps`, from fixed seeds; run(state) takes the
    full or the chain-sharded state."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.solvers import qmc, sa

    gtorus = instances.gaussian_torus(L, seed=0, device=dev).to_generic()
    n, P = L * L, CLUSTER_SLICES

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def spins(seed):
        return sa.random_state(gen(seed), n, batch=(CLUSTER_SA_READS,),
                               device=dev)

    def confs(seed):
        return qmc.replicate(sa.random_state(
            gen(seed), n, batch=(CLUSTER_QMC_READS,), device=dev), P)
    sched = schedules.linear(3.0, 0.05, sa_steps, device=dev)
    a = schedules.transverse_field(3.0, 1e-8, qmc_steps, device=dev)
    b = torch.ones_like(a)
    lut = schedules.bath_lookuptable(P, CLUSTER_ALPHA, device=dev)
    return {
        "sa_wolff": (spins(51), lambda s: sa.anneal_wolff(
            gtorus, sched, s, gen(52))),
        "sa_sw": (spins(53), lambda s: sa.anneal_sw(
            gtorus, sched, s, gen(54), local_sweeps=True)),
        "sa_sw_no_local": (spins(55), lambda s: sa.anneal_sw(
            gtorus, sched, s, gen(56))),
        "piqmc_wolff": (confs(57), lambda c: qmc.anneal_wolff(
            gtorus, a, b, 1.0 / P, c, gen(58))),
        "piqmc_sw": (confs(59), lambda c: qmc.anneal_sw_bath(
            gtorus, a, b, 1.0 / P, lut, c, gen(60))),
        "piqmc_sw_wc2": (confs(61), lambda c: qmc.anneal_sw_bath(
            gtorus, a, b, 1.0 / P, lut, c, gen(62), per_slice_seeds=False)),
        "piqmc_sw_full": (confs(63), lambda c: qmc.anneal_sw(
            gtorus, a, b, 1.0 / P, c, gen(64), local_sweeps=True)),
    }


def disorder_case(dev, steps=SA_SWEEPS):
    """(problems, sched, states, generators()) of the disorder batch:
    DISORDER_D realizations gaussian_torus(L, d).to_generic(), SA_READS //
    DISORDER_D chains each, SA's schedule 3 -> 0 over `steps` sweeps, one
    generator a realization (made anew by each call of generators())."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.models import instances
    from montecarlosolvers_tpu_torch.solvers import sa

    probs = [instances.gaussian_torus(L, seed=d, device=dev).to_generic()
             for d in range(DISORDER_D)]
    states = sa.random_state(torch.Generator().manual_seed(81), L * L,
                             batch=(DISORDER_D, SA_READS // DISORDER_D),
                             device=dev)
    sched = schedules.linear(3.0, 0.0, steps, device=dev)

    def generators():
        return [torch.Generator().manual_seed(90 + d)
                for d in range(DISORDER_D)]
    return probs, sched, states, generators


def card_cluster_disorder_rank(n_ranks, device_type, sa_steps, qmc_steps):
    """The body of each gloo rank of (o) and (q): every call of
    `cluster_calls` on its state sharded over a chains mesh of n_ranks,
    each (rank 0's outputs as int8, this rank's launches, wall); and
    run_disorder_sharded(sa.anneal) of `disorder_case` on a dcn_mesh of
    DISORDER_HOSTS hosts (LOCAL_WORLD_SIZE, which the parent sets): (this
    rank's block as int8, its placements, its launches, wall, the mesh's
    rows)."""
    import torch.distributed as dist
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.parallel import make_mesh, multihost
    from montecarlosolvers_tpu_torch.parallel import mesh as pmesh
    from montecarlosolvers_tpu_torch.parallel import shard_chains
    from montecarlosolvers_tpu_torch.solvers import sa

    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    sync = torch.cuda.synchronize if dev.type == "cuda" else lambda: None
    rank = dist.get_rank()
    mesh = make_mesh(chains=n_ranks, device_type=device_type)
    out = {}
    for cname, (state, run) in cluster_calls(dev, sa_steps,
                                             qmc_steps).items():
        run(shard_chains(state, mesh))  # warm: the wall is the second run's
        _build.reset_launches()
        sync()
        t0 = time.perf_counter()
        res = run(shard_chains(state, mesh))
        sync()
        wall = time.perf_counter() - t0
        launched = launched_now()
        full = pmesh.full_tensor(res).to(torch.int8).cpu().numpy()
        out[cname] = (full if rank == 0 else None, launched, wall)
    probs, sched, states, generators = disorder_case(dev)
    dmesh = multihost.dcn_mesh(disorder=DISORDER_HOSTS,
                               device_type=device_type)
    _build.reset_launches()
    sync()
    t0 = time.perf_counter()
    res = multihost.run_disorder_sharded(sa.anneal, probs, sched, states,
                                         generators(), dmesh)
    sync()
    out["disorder"] = (res.to_local().to(torch.int8).cpu().numpy(),
                       str(list(res.placements)), launched_now(),
                       time.perf_counter() - t0, dmesh.mesh.tolist())
    return out


def rest_sharding_checks(dev, main_launches, power, name):
    """(o) and (q). On the one-rank NCCL mesh: each call of `cluster_calls`
    (CLUSTER_SA_SWEEPS and CLUSTER_QMC_SWEEPS) on its chain-sharded state
    equals the unsharded call bitwise with the same launches (which the
    kernels line counts as the main path's), its wall beside the
    unsharded wall; run_disorder_sharded(sa.anneal) on a (1, 1) dcn_mesh
    equals vmap_disorder bitwise, one packed SA launch. On PARALLEL_RANKS
    gloo ranks sharing the card: the same calls, rank 0's gathered output
    bitwise the unsharded call and each rank's launches the unsharded
    call's; the disorder batch on a dcn_mesh of DISORDER_HOSTS hosts, each
    row on one host, every rank's block bitwise its rows of vmap_disorder,
    one packed SA launch a rank."""
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.parallel import (disorder, dryrun,
                                                      make_mesh, multihost,
                                                      shard_chains)
    from montecarlosolvers_tpu_torch.parallel import mesh as pmesh
    from montecarlosolvers_tpu_torch.solvers import sa

    def timed(run, state):
        run(state)  # warm: the wall is the second run's
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(state)
        torch.cuda.synchronize()
        return out, launched_now(), time.perf_counter() - t0

    # (o) one NCCL rank
    cmesh = make_mesh(chains=1, device_type=dev.type)
    unsharded = {}
    for cname, (state, run) in cluster_calls(dev, CLUSTER_SA_SWEEPS,
                                             CLUSTER_QMC_SWEEPS).items():
        want, launched, wall_1 = timed(run, state)
        unsharded[cname] = (want, launched)
        got, launched_sh, wall = timed(run, shard_chains(state, cmesh))
        for k, v in launched_sh.items():
            main_launches[k] += v
        bad = int((pmesh.full_tensor(got) != want).sum())
        emit({"phase": "parallel", "check": "one_rank_nccl_cluster",
              "call": cname, "shape": list(state.shape),
              "mismatched_spins": bad, "launches": launched_sh,
              "wall_s": wall, "unsharded_wall_s": wall_1,
              "card": name, "power_limit": power})
        check(bad == 0, f"{cname} on a one-rank NCCL mesh equals the "
                        "unsharded call")
        check(launched_sh == launched, f"{cname} on one rank launched "
                                       f"{launched_sh}, unsharded {launched}")
    probs, sched, states, generators = disorder_case(dev)
    stacked, axes = disorder.stack_problems(probs)
    want_d, _, wall_1 = timed(lambda s: disorder.vmap_disorder(
        sa.anneal, axes)(stacked, sched, s, generators()), states)
    got, launched, wall = timed(lambda s: multihost.run_disorder_sharded(
        sa.anneal, probs, sched, s, generators(), multihost.dcn_mesh(
            device_type=dev.type)), states)
    main_launches["packed_sa"] += launched.get("packed_sa", 0)
    bad = int((pmesh.full_tensor(got) != want_d).sum())
    emit({"phase": "parallel", "check": "one_rank_nccl_disorder",
          "realizations": DISORDER_D, "chains": SA_READS // DISORDER_D,
          "sweeps": SA_SWEEPS, "mismatched_spins": bad,
          "placements": str(list(got.placements)), "launches": launched,
          "wall_s": wall, "unsharded_wall_s": wall_1,
          "card": name, "power_limit": power})
    check(bad == 0, "run_disorder_sharded on a one-rank mesh equals "
                    "vmap_disorder")
    check(launched == {"packed_sa": 1}, f"the one-rank disorder run "
                                        f"launched {launched}")

    # (o) and (q) on gloo ranks sharing the card, two "hosts"
    t0 = time.perf_counter()
    ranks = dryrun.run_ranks(
        card_cluster_disorder_rank, PARALLEL_RANKS, dev.type,
        args=(CLUSTER_SA_SWEEPS, CLUSTER_QMC_SWEEPS),
        env={"LOCAL_WORLD_SIZE": str(PARALLEL_RANKS // DISORDER_HOSTS)})
    rank_seconds = time.perf_counter() - t0
    for cname, (want, launched) in unsharded.items():
        got, _, wall = ranks[0][cname]
        bad = int((got != want.to(torch.int8).cpu().numpy()).sum())
        emit({"phase": "parallel", "check": "gloo_ranks_cluster",
              "call": cname, "ranks": PARALLEL_RANKS,
              "mismatched_spins": bad, "wall_s_rank0": wall,
              "launches_each_rank": [r[cname][1] for r in ranks]})
        check(bad == 0, f"{PARALLEL_RANKS} gloo ranks' {cname} equals the "
                        "single-device call")
        check(all(r[cname][1] == launched for r in ranks),
              f"each gloo rank's {cname} launched {launched}")
    want_np = want_d.to(torch.int8).cpu().numpy()
    rows = ranks[0]["disorder"][4]
    # the (disorder, chains) mesh: a host's ranks a row
    chains_ax = PARALLEL_RANKS // DISORDER_HOSTS
    d_loc = DISORDER_D // DISORDER_HOSTS
    c_loc = SA_READS // DISORDER_D // chains_ax
    bad = 0
    for r, out in enumerate(ranks):
        block, placements, launched, _, _ = out["disorder"]
        dr, cr_ = r // chains_ax, r % chains_ax
        want_block = want_np[dr * d_loc:(dr + 1) * d_loc,
                             cr_ * c_loc:(cr_ + 1) * c_loc]
        bad += int((block != want_block).sum()) if \
            block.shape == want_block.shape else block.size
        check(placements == "[Shard(dim=0), Shard(dim=1)]",
              f"rank {r}'s disorder block is placed {placements}")
        check(launched == {"packed_sa": 1},
              f"gloo rank {r}'s disorder block launched {launched}")
    emit({"phase": "parallel", "check": "gloo_ranks_disorder",
          "ranks": PARALLEL_RANKS, "hosts": DISORDER_HOSTS,
          "mesh_rows": rows, "mismatched_spins": bad,
          "wall_s_each_rank": [out["disorder"][3] for out in ranks],
          "seconds": rank_seconds})
    check(all(len({x // chains_ax for x in row}) == 1 for row in rows),
          f"each disorder row {rows} lies on one host")
    check(bad == 0, "every gloo rank's disorder block equals its rows of "
                    "vmap_disorder")


def disorder_checks(dev, main_launches, power, name):
    """(p): vmap_disorder(sa.anneal) on `disorder_case` is one packed SA
    launch (the main path's); each realization's rows equal its solo
    sa.anneal(p_d, engine="masked") with its generator bitwise;
    realization 0's mean energy per spin lies in SA's 80x80 range, the
    others printed. Slope-timed beside one packed SA launch of the same
    SA_READS chains on realization 0 (the stride's cost), beside the
    DISORDER_D solo calls and beside its plain version, with the bound of
    the batch's work (its D tables read once each)."""
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops
    from montecarlosolvers_tpu_torch.parallel import disorder
    from montecarlosolvers_tpu_torch.solvers import sa

    probs, sched, states, generators = disorder_case(dev)
    stacked, axes = disorder.stack_problems(probs)
    run = disorder.vmap_disorder(sa.anneal, axes)
    n = L * L
    _build.reset_launches()
    out = run(stacked, sched, states, generators())
    torch.cuda.synchronize()
    launched = launched_now()
    main_launches["packed_sa"] += launched.get("packed_sa", 0)
    bad = []
    for d, (p, g) in enumerate(zip(probs, generators())):
        solo = sa.anneal(p, sched, states[d], g, engine="masked")
        bad.append(int((solo != out[d]).sum()))
    means = [float(x) for x in stacked.energy(out).double().mean(1) / n]
    emit({"phase": "parallel", "check": "disorder_batch",
          "realizations": DISORDER_D, "chains": SA_READS // DISORDER_D,
          "sweeps": SA_SWEEPS, "launches": launched,
          "mismatched_spins_each": bad, "mean_energy_per_spin": means,
          "range_realization_0": RANGES["sa"]})
    check(launched == {"packed_sa": 1}, f"the disorder batch launched "
                                        f"{launched}")
    check(sum(bad) == 0, "each realization equals its solo masked anneal")
    lo, hi = RANGES["sa"]
    check(lo <= means[0] <= hi, f"realization 0's mean {means[0]} lies in "
                                f"SA's range [{lo}, {hi}]")

    from montecarlosolvers_tpu_torch import schedules

    def batched(tau):
        run(stacked, schedules.linear(3.0, 0.0, tau, device=dev), states,
            generators())

    flat = states.reshape(SA_READS, n)

    def single(tau):
        gk.anneal_packed(probs[0], schedules.linear(3.0, 0.0, tau,
                                                    device=dev), flat, 7)

    def solos(tau):
        s = schedules.linear(3.0, 0.0, tau, device=dev)
        for d, (p, g) in enumerate(zip(probs, generators())):
            sa.anneal(p, s, states[d], g, engine="masked")
    pg, nbr_j, h = stacked.packed
    packed = packed_ops.pack_state(pg, flat).contiguous()
    seeds = [sa.draw_seed(g) for g in generators()]

    def plain(tau):
        gk.packed_sa_anneal_ref(pg, schedules.linear(3.0, 0.0, tau,
                                                     device=dev), packed,
                                0, disorder=(nbr_j, h, seeds))
    times = {}
    for key, fn in (("batched", batched), ("one_launch_realization_0",
                                           single),
                    ("solo_calls", solos), ("batched_again", batched)):
        times[key] = slope_ms(fn, DISORDER_TAUS, 3)[0]
    # the plain version takes about 2 ms a sweep: a few sweeps suffice
    times["plain"] = slope_ms(plain, (2, 6), 2)[0]
    graph = graph_shape(probs[0])
    f32, sfu = ops_per_sweep("packed_sa", SA_READS, 1, n, graph)
    moved = bytes_per_anneal("packed_sa", SA_READS, 1, n, SA_SWEEPS, graph) \
        + (DISORDER_D - 1) * n * (graph[1] * 4 + 4)
    bounds = {"fp32": f32 / PEAK_FLOPS, "sfu": sfu / PEAK_SFU,
              "bytes": moved / PEAK_BYTES / SA_SWEEPS}
    unit = max(bounds, key=bounds.get)
    batched_ms = min(times["batched"], times["batched_again"])
    emit({"phase": "parallel", "check": "disorder_timing",
          "realizations": DISORDER_D, "chains": SA_READS,
          "taus": list(DISORDER_TAUS), "ms_per_sweep": times,
          "stride_cost": batched_ms / times["one_launch_realization_0"],
          "bound_ms": 1e3 * bounds[unit],
          "bound_by": "bytes" if unit == "bytes" else "operations",
          "bound_unit": unit, "card": name, "power_limit": power})


def masked_lattice_checks(dev, main_launches, torus, odd_torus, power,
                          name):
    """(r): sa.anneal(engine="masked") on the 80x80 and 81x81 tori at
    SA_READS x SA_SWEEPS: one packed SA launch each (the main path's), the
    mean energy per spin in SA's range for that torus; its ms a sweep
    slope-timed beside the lattice's own engine (kernel A on 80x80, kernel
    6 on 81x81)."""
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.solvers import sa

    for key, lat, own in (("sa", torus, "split_sa"),
                          ("sa_l81", odd_torus, "plane_sa")):
        n = lat.nspins
        s0 = sa.random_state(torch.Generator().manual_seed(101), n,
                             batch=(SA_READS,), device=dev)

        def anneal(tau, engine="masked"):
            return sa.anneal(lat, schedules.linear(3.0, 0.0, tau, device=dev),
                             s0, torch.Generator().manual_seed(102),
                             engine=engine)
        _build.reset_launches()
        out = anneal(SA_SWEEPS)
        torch.cuda.synchronize()
        launched = launched_now()
        main_launches["packed_sa"] += launched.get("packed_sa", 0)
        mean = float(lat.energy(out).double().mean()) / n
        ms = slope_ms(anneal, DISORDER_TAUS, 3)[0]
        own_ms = slope_ms(lambda tau: anneal(tau, "auto"), DISORDER_TAUS,
                          3)[0]
        lo, hi = RANGES[key]
        emit({"phase": "parallel", "check": "masked_lattice",
              "lattice": f"{int(n ** 0.5)}x{int(n ** 0.5)}",
              "chains": SA_READS, "sweeps": SA_SWEEPS, "launches": launched,
              "mean_energy_per_spin": mean, "range": [lo, hi],
              "ms_per_sweep": ms, f"{own}_ms_per_sweep": own_ms,
              "ratio": ms / own_ms, "card": name, "power_limit": power})
        check(launched == {"packed_sa": 1}, f"the masked {key} anneal "
                                            f"launched {launched}")
        check(lo <= mean <= hi, f"the masked {key} mean {mean} lies in "
                                f"[{lo}, {hi}]")


def parallel_checks(dev, results, main_launches, torus, odd_torus, power,
                    name):
    """parallel: the parallel layer's chain and Trotter axes on the card.
    (a) each kernel of a chain-sharded solve (A, 6, B, 3, 5 sequential and
    colored, packed SA, generic PIQMC, generic bath, and the per-phase
    kernels of A, B and 5) runs a block of chains with its chain0, at the
    main path's widths, and equals those rows of the whole batch's run;
    (b) the shard kernels S1-S4 against their plain versions on a slab of
    one rank of 4 (80x80, P = 40, 32 chains; the generic form likewise),
    timed beside them and their bounds; (c) a one-rank NCCL mesh: chain
    sharding equals the unsharded run, and the Trotter-sharded anneals
    (the main path of S1-S4, their launches counted) equal kernel B's and
    the generic kernel's, line moves or not; their ms a sweep beside kernel
    B's two routes; (d) PARALLEL_RANKS gloo ranks sharing the card run the
    Trotter-sharded anneals: bitwise the single-device kernels without line
    moves, within PARALLEL_ANCHOR with them, the lines that differ
    printed, exact launches; (f) S5-S7 against their plain versions
    (`shard_rest_checks`); (g) the sharded bath, Wolff and SW engines on
    the one-rank mesh (`one_rank_rest`); (h) on the gloo ranks
    (`gloo_rest`); (j) the samplers' five kernel offsets
    (`sampler_offset_checks`); (k) and (l) the sharded samplers and
    non-cluster engines on the one-rank mesh and the gloo ranks
    (`sampler_sharding_checks`); (n) the cluster kernels' chain offsets
    (`cluster_offset_checks`); (o) and (q) the sharded cluster solves and
    the disorder batch on the one-rank mesh and the gloo ranks as two
    hosts (`rest_sharding_checks`); (p) the disorder batch, one launch
    (`disorder_checks`); (r) the masked lattice engine
    (`masked_lattice_checks`); (i) and (m)
    dryrun.dryrun_multichip(PARALLEL_RANKS), JAX's legs 5-7 among them.
    """
    import torch.distributed as dist
    from montecarlosolvers_tpu_torch import schedules
    from montecarlosolvers_tpu_torch.ops import _build
    from montecarlosolvers_tpu_torch.ops import generic_kernels as gk
    from montecarlosolvers_tpu_torch.ops import packed as packed_ops
    from montecarlosolvers_tpu_torch.ops import plane_kernels as pk
    from montecarlosolvers_tpu_torch.ops import shard_kernels as shk
    from montecarlosolvers_tpu_torch.ops import split as split_ops
    from montecarlosolvers_tpu_torch.ops import split_kernels as sk
    from montecarlosolvers_tpu_torch.ops.piqmc import spacetime_num_phases
    from montecarlosolvers_tpu_torch.parallel import _collectives as coll
    from montecarlosolvers_tpu_torch.parallel import dryrun
    from montecarlosolvers_tpu_torch.parallel import make_mesh, shard_chains
    from montecarlosolvers_tpu_torch.parallel import mesh as pmesh
    from montecarlosolvers_tpu_torch.parallel import trotter
    from montecarlosolvers_tpu_torch.solvers import qmc, sa

    t_phase = time.perf_counter()
    gtorus = torus.to_generic()
    P, n, nh = QMC_SLICES, L * L, L * L // 2
    temp = 1.0 / P
    a20 = schedules.transverse_field(3.0, 1e-8, 20, device=dev)
    b20 = torch.ones_like(a20)
    sched = schedules.linear(3.0, 0.1, 50, device=dev)
    lut = schedules.bath_lookuptable(P, BATH_ALPHA, device=dev)

    def conf(chains, slices, sites, seed):
        return parallel_state(chains, slices, sites, seed, dev)

    # (a) chain offsets at full width
    sa_state = conf(SA_READS, 1, n, 1)[:, 0].contiguous()
    odd_state = conf(SA_READS, 1, ODD_L * ODD_L, 2)[:, 0].contiguous()
    q40 = conf(QMC_READS, P, n, 3)
    q5 = conf(QMC_READS, ODD_SLICES, n, 4)
    # a block of chains that starts inside a chain word (kernels A and 6
    # pack 32 chains a word) and one of PIQMC chains
    sa_block = (SA_READS // 4 + 13, SA_READS // 4)
    q_block = (QMC_READS // 4, QMC_READS // 2)
    cases = (
        ("split_sa", lambda s, c0: sk.anneal_lattice_split(
            torus, sched, s, 101, chain0=c0), sa_state, *sa_block),
        ("plane_sa", lambda s, c0: pk.anneal_lattice(
            odd_torus, sched, s, 101, chain0=c0), odd_state, *sa_block),
        ("split_qmc", lambda c, c0: sk.anneal_lattice_qmc_split(
            torus, a20, b20, temp, c, 101, chain0=c0), q40, *q_block),
        ("plane_qmc", lambda c, c0: pk.anneal_lattice_qmc(
            torus, a20, b20, 1.0 / ODD_SLICES, c, 101, chain0=c0), q5,
         *q_block),
        ("split_qmc_bath", lambda c, c0: sk.anneal_lattice_qmc_bath_split(
            torus, a20, b20, temp, lut, c, 101, global_moves=True,
            chain0=c0), q40, *q_block),
        ("split_qmc_bath_colored",
         lambda c, c0: sk.anneal_lattice_qmc_bath_split(
             torus, a20, b20, temp, lut, c, 101, global_moves=True,
             colored=True, chain0=c0), q40, *q_block),
        ("packed_sa", lambda s, c0: gk.anneal_packed(
            gtorus, sched, s, 101, chain0=c0), sa_state, *sa_block),
        ("generic_qmc", lambda c, c0: gk.anneal_generic_qmc(
            gtorus, a20, b20, temp, c, 101, chain0=c0), q40, *q_block),
        ("generic_qmc_bath", lambda c, c0: gk.anneal_generic_qmc_bath(
            gtorus, a20, b20, temp, lut, c, 101, global_moves=True,
            chain0=c0), q40, *q_block),
    )
    phased = {"split_sa", "split_qmc", "split_qmc_bath"}
    for kname, run, state, c0, width in cases:
        for route, ctx in routes():
            if route == "phased" and kname not in phased:
                continue
            with ctx():
                full = run(state, 0)
                block = run(state[c0:c0 + width].contiguous(), c0)
            torch.cuda.synchronize()
            bad, _ = mismatches([full[c0:c0 + width]], [block])
            emit({"phase": "parallel", "check": "chain_offset",
                  "kernel": kname, "route": route,
                  "chains": int(state.shape[0]),
                  "block": [c0, c0 + width], "mismatched_spins": bad})
            check(bad == 0, f"{kname} ({route}) on chains [{c0}, "
                            f"{c0 + width}) with chain0 equals the "
                            "unsharded rows")

    # (b) S1-S4 against their plain versions on rank 1's slab of 4
    sl = split_ops.build_split(torus)
    jp = schedules.jperp(a20, temp * P).contiguous()
    quarters = split_ops.pack_qmc(sl, conf(QMC_READS, P, n, 5))
    Q, ranks = P // 2, PARALLEL_RANKS
    rows = Q // ranks
    q0 = rows
    slab = [x[:, q0:q0 + rows].contiguous() for x in quarters]
    up_rows = [x[:, q0 - 1].contiguous() for x in quarters]
    dn_rows = [x[:, q0 + rows].contiguous() for x in quarters]

    def timed(kname, kernel_fn, plain_fn, reps=50, plain_reps=5):
        ms = event_ms(kernel_fn, reps)
        results[kname]["ms"] = min(results[kname].get("ms", ms), ms)
        results[kname]["plain_ms"] = event_ms(plain_fn, plain_reps)

    def record(kname, err, bound):
        results[kname]["max_abs_err"] = max(
            results[kname].get("max_abs_err", 0.0), err)
        results[kname]["bound_ms"], results[kname]["bound_by"] = bound

    t = 3
    args = (sl, b20, jp, temp * P)
    for phase, updates in enumerate(shk.PHASES):
        halos = [up_rows[r] if d < 0 else dn_rows[r]
                 for _, _, r, d, _ in updates]
        tail = (halos, phase, t, 77, 0, q0, Q)
        want = shk.shard_phase_ref(*args, slab, *tail)
        got = shk.shard_phase(*args, [x.clone() for x in slab], *tail)
        torch.cuda.synchronize()
        bad, err = mismatches(got, want)
        check(bad == 0, f"S1 phase {phase} equals its plain version")
        record("shard_phase", err,
               shard_bound("shard_phase", QMC_READS, rows, nh))
        work = [x.clone() for x in slab]
        timed("shard_phase",
              lambda: shk.shard_phase(*args, work, *tail),
              lambda: shk.shard_phase_ref(*args, slab, *tail))
    for color in (0, 1):
        part = shk.shard_line_part(sl, slab, color)
        want = shk.shard_line_part_ref(sl, slab, color)
        bad, err = mismatches([part], [want])
        check(bad == 0, f"S2 part of color {color} equals its plain version")
        record("shard_line_part", err,
               shard_bound("shard_line_part", QMC_READS, rows, nh))
        timed("shard_line_part",
              lambda: shk.shard_line_part(sl, slab, color),
              lambda: shk.shard_line_part_ref(sl, slab, color))
        total = part * ranks  # a stand-in for the sum of 4 ranks' parts
        want = shk.shard_line_accept_ref(b20, temp * P, total, slab, color, t,
                                         77)
        got = shk.shard_line_accept(sl, b20, temp * P, total,
                                    [x.clone() for x in slab], color, t, 77)
        torch.cuda.synchronize()
        bad, err = mismatches(got, want)
        check(bad == 0, f"S2 accept of color {color} equals its plain "
                        "version")
        record("shard_line_accept", err,
               shard_bound("shard_line_accept", QMC_READS, rows, nh))
        work = [x.clone() for x in slab]
        timed("shard_line_accept",
              lambda: shk.shard_line_accept(sl, b20, temp * P, total, work,
                                            color, t, 77),
              lambda: shk.shard_line_accept_ref(b20, temp * P, total, slab,
                                                color, t, 77))
    pg = packed_ops.build_packed(gtorus)
    m = spacetime_num_phases(pg.num_colors, P)
    graph = graph_shape(gtorus)
    rows_g = P // ranks
    k0 = rows_g
    full_g = packed_ops.pack_state(pg, conf(QMC_READS, P, n, 6)).contiguous()
    gslab = full_g[:, k0:k0 + rows_g].contiguous()
    gup = full_g[:, k0 - 1].contiguous()
    gdn = full_g[:, k0 + rows_g].contiguous()
    sizes = np.diff(pg.starts)
    for p in range(m):
        gargs = (pg, b20, jp, temp * P, gslab, gup, gdn, p, m, t, 77, 0, k0,
                 P)
        got = shk.generic_shard_phase(*gargs)
        want = shk.generic_shard_phase_ref(*gargs)
        torch.cuda.synchronize()
        bad, err = mismatches([got], [want])
        check(bad == 0, f"S3 phase {p} equals its plain version")
        updated = QMC_READS * sum(
            int(sizes[(p - k) % m]) for k in range(k0, k0 + rows_g)
            if (p - k) % m < pg.num_colors)
        record("generic_shard_phase", err,
               shard_bound("generic_shard_phase", QMC_READS, rows_g, n,
                           graph, updated=updated))
        timed("generic_shard_phase",
              lambda: shk.generic_shard_phase(*gargs),
              lambda: shk.generic_shard_phase_ref(*gargs))
    for c in range(pg.num_colors):
        part = shk.generic_shard_line_part(pg, b20, gslab, c, t)
        want = shk.generic_shard_line_part_ref(pg, b20, gslab, c, t)
        bad, err = mismatches([part], [want])
        check(bad == 0, f"S4 part of color {c} equals its plain version")
        block = int(sizes[c])
        record("generic_shard_line_part", err,
               shard_bound("generic_shard_line_part", QMC_READS, rows_g, n,
                           graph, block=block))
        timed("generic_shard_line_part",
              lambda: shk.generic_shard_line_part(pg, b20, gslab, c, t),
              lambda: shk.generic_shard_line_part_ref(pg, b20, gslab, c,
                                                      t))
        total = part * ranks
        got = shk.generic_shard_line_accept(pg, temp * P, total,
                                            gslab.clone(), c, t, 77, 0, P)
        want = shk.generic_shard_line_accept_ref(pg, temp * P, total, gslab,
                                                 c, t, 77, 0, P)
        torch.cuda.synchronize()
        bad, err = mismatches([got], [want])
        check(bad == 0, f"S4 accept of color {c} equals its plain version")
        record("generic_shard_line_accept", err,
               shard_bound("generic_shard_line_accept", QMC_READS, rows_g, n,
                           graph, block=block))
        work = gslab.clone()
        timed("generic_shard_line_accept",
              lambda: shk.generic_shard_line_accept(pg, temp * P, total,
                                                    work, c, t, 77, 0, P),
              lambda: shk.generic_shard_line_accept_ref(
                  pg, temp * P, total, gslab, c, t, 77, 0, P))
    for kname in list(PARALLEL_KERNELS)[:6]:
        emit({"phase": "parallel", "check": "shard_kernel_vs_plain",
              "kernel": kname, "chains": QMC_READS, "slices": P,
              "rank_of": [1, ranks], **results[kname],
              "card": name, "power_limit": power})

    # (f) S5-S7 against their plain versions; (f2) S5 and S7's routes
    shard_rest_checks(dev, results, torus, power, name)
    shard_redesign(dev, results, torus, odd_torus, power, name)

    # (c) a one-rank NCCL mesh: chain sharding, and the main path of S1-S4
    cmesh = make_mesh(chains=1, device_type=dev.type)
    check(dist.get_backend() == {"cuda": "nccl", "cpu": "gloo"}[dev.type],
          "a one-rank mesh on the card runs NCCL")
    for what, run, state in (
            ("sa.anneal split", lambda s: sa.anneal(
                torus, sched, s, torch.Generator().manual_seed(3)),
             sa_state),
            ("qmc.anneal split", lambda c: qmc.anneal(
                torus, a20, b20, temp, c, torch.Generator().manual_seed(3),
                global_moves=True), q40)):
        got = pmesh.full_tensor(run(shard_chains(state, cmesh)))
        bad, _ = mismatches([got], [run(state)])
        emit({"phase": "parallel", "check": "one_rank_nccl_chains",
              "solve": what, "mismatched_spins": bad})
        check(bad == 0, f"{what} on a one-rank NCCL mesh equals the "
                        "unsharded run")
    rmesh = make_mesh(replica=1, device_type=dev.type)
    steps = PARALLEL_STEPS
    a_p = schedules.transverse_field(3.0, 1e-8, steps, device=dev)
    b_p = torch.ones_like(a_p)
    confs = parallel_state(QMC_READS, P, n, 31, dev)
    singles = {}
    for kind, prob, engine, counts in (
            ("split", torus, trotter.anneal_sharded_split,
             lambda gm: {"shard_phase": 2 * steps,
                         **({"shard_line_part": 2 * steps,
                             "shard_line_accept": 2 * steps} if gm else {})}),
            ("generic", gtorus, trotter.anneal_sharded,
             lambda gm: {"generic_shard_phase": m * steps,
                         **({"generic_shard_line_part":
                             pg.num_colors * steps,
                             "generic_shard_line_accept":
                             pg.num_colors * steps} if gm else {})})):
        for gm in (False, True):
            single = qmc.anneal(prob, a_p, b_p, temp, confs,
                                torch.Generator().manual_seed(5),
                                global_moves=gm)
            singles[f"{kind}_gm{int(gm)}"] = single
            _build.reset_launches()
            got = pmesh.full_tensor(engine(
                prob, a_p, b_p, temp, confs,
                torch.Generator().manual_seed(5), rmesh, global_moves=gm))
            torch.cuda.synchronize()
            launched = launched_now()
            for k, v in launched.items():
                if k in PARALLEL_KERNELS:
                    main_launches[k] += v
            bad, _ = mismatches([got], [single])
            emit({"phase": "parallel", "check": "one_rank_nccl_trotter",
                  "engine": kind, "global_moves": gm, "steps": steps,
                  "mismatched_spins": bad, "launches": launched})
            check(bad == 0, f"the one-rank {kind} Trotter-sharded anneal "
                            f"(global_moves={gm}) equals the single-device "
                            "kernel's")
            check(launched == counts(gm), f"one-rank {kind} launched "
                                          f"{launched}")

    def sharded_run(tau):
        g = schedules.transverse_field(3.0, 1e-8, tau, device=dev)
        trotter.anneal_sharded_split(torus, g, torch.ones_like(g), temp,
                                     confs, torch.Generator().manual_seed(5),
                                     rmesh, global_moves=True)

    def kernel_b_run(tau):
        g = schedules.transverse_field(3.0, 1e-8, tau, device=dev)
        sk.anneal_lattice_qmc_split(torus, g, torch.ones_like(g), temp,
                                    confs, 5)
    sweep = {"sharded_one_rank": slope_ms(sharded_run, PARALLEL_TAUS, 3)[0],
             "kernel_b_cluster": slope_ms(kernel_b_run, PARALLEL_TAUS, 3)[0]}
    with gibbs_tool().phased_route():
        sweep["kernel_b_phased"] = slope_ms(kernel_b_run, PARALLEL_TAUS,
                                            3)[0]
    group = rmesh.get_group("replica")
    last, first = quarters[3][:, -1], quarters[2][:, 0]
    exchange_ms = event_ms(lambda: coll.ring_halo(last, first, group), 100)
    emit({"phase": "parallel", "check": "sweep_ms", "lattice": f"{L}x{L}",
          "slices": P, "chains": QMC_READS, "global_moves": True,
          **sweep, "exchange_ms_one_rank": exchange_ms,
          "exchange_share_one_rank": 2 * exchange_ms
          / sweep["sharded_one_rank"], "card": name, "power_limit": power})

    # (g) the rest of the Trotter axis on the one-rank NCCL mesh
    one_rank_rest(dev, main_launches, torus, rmesh, power, name)

    # (d) gloo ranks sharing the card
    t0 = time.perf_counter()
    out = dryrun.run_ranks(card_trotter_rank, PARALLEL_RANKS, dev.type,
                           args=(L, QMC_READS, P, steps, PARALLEL_TAUS, 2))
    rank_seconds = time.perf_counter() - t0
    for key, (state, _) in out[0].items():
        if key == "timing":
            continue
        single = singles[key].to(torch.int8).cpu().numpy()
        kind, gm = key.split("_gm")
        prob = torus if kind == "split" else gtorus
        lines = int(np.any(state != single, axis=1).sum())
        e_sh = float(qmc.best_slice_energy(prob, torch.as_tensor(
            state, dtype=torch.float32, device=dev)).mean()) / n
        e_1 = float(qmc.best_slice_energy(prob, singles[key]).mean()) / n
        emit({"phase": "parallel", "check": "gloo_ranks_on_the_card",
              "engine": kind, "ranks": PARALLEL_RANKS,
              "global_moves": gm == "1", "steps": steps,
              "mismatched_spins": int((state != single).sum()),
              "differing_lines": lines,
              "mean_best_energy_per_spin": e_sh,
              "single_device_energy_per_spin": e_1,
              "launches_each_rank": [o[key][1] for o in out]})
        if gm == "0":
            check(lines == 0, f"{PARALLEL_RANKS} gloo ranks' {kind} anneal "
                              "equals the single-device kernel's")
        else:
            check(lines <= PARALLEL_LINES,
                  f"{PARALLEL_RANKS} gloo ranks' {kind} anneal with line "
                  f"moves: {lines} lines differ from the single-device "
                  f"kernel's (at most {PARALLEL_LINES})")
            check(abs(e_sh - e_1) <= PARALLEL_ANCHOR,
                  f"{PARALLEL_RANKS} gloo ranks' {kind} anneal with line "
                  f"moves: {e_sh} within {PARALLEL_ANCHOR} of {e_1}")
        rows_k = P // 2 // PARALLEL_RANKS if kind == "split" else \
            P // PARALLEL_RANKS
        want = ({"shard_phase": 2 * steps} if kind == "split" else
                {"generic_shard_phase": m * steps})
        if gm == "1":
            want.update({"shard_line_part": 2 * steps,
                         "shard_line_accept": 2 * steps}
                        if kind == "split" else
                        {"generic_shard_line_part": pg.num_colors * steps,
                         "generic_shard_line_accept":
                         pg.num_colors * steps})
        check(all(o[key][1] == want for o in out),
              f"each rank's {kind} launches {want} (rows {rows_k})")
    timing = out[0]["timing"]
    emit({"phase": "parallel", "check": "gloo_timing",
          "ranks": PARALLEL_RANKS, "seconds": rank_seconds,
          "sweep_ms_rank0": timing["sweep_ms"],
          "exchange_ms": timing["exchange_ms"],
          "exchange_share": 2 * timing["exchange_ms"] / timing["sweep_ms"],
          "card": name, "power_limit": power})

    # (h) the rest of the Trotter axis on the gloo ranks
    gloo_rest(dev, torus, power, name)

    # (j) the five kernels the sharded samplers add offsets to
    t0 = time.perf_counter()
    sampler_offset_checks(dev, torus, odd_torus, power, name)
    # (k) the sharded samplers and non-cluster engines on the one-rank
    # NCCL mesh, (l) on the gloo ranks
    sampler_sharding_checks(dev, power, name)
    emit({"phase": "parallel", "check": "samplers_slice_seconds",
          "seconds": time.perf_counter() - t0})

    # (n) the cluster kernels' chain offsets
    t0 = time.perf_counter()
    cluster_offset_checks(dev, gtorus, power, name)
    # (o) and (q): the sharded cluster solves and the disorder batch on the
    # one-rank NCCL mesh and the gloo ranks
    rest_sharding_checks(dev, main_launches, power, name)
    # (p) the disorder batch, (r) the masked lattice engine
    disorder_checks(dev, main_launches, power, name)
    masked_lattice_checks(dev, main_launches, torus, odd_torus, power, name)
    emit({"phase": "parallel", "check": "rest_slice_seconds",
          "seconds": time.perf_counter() - t0})

    # (i) and (m): the dry run, legs 3c, 3d, 4, 5, 5b, 6, 6b and 7 among them
    t0 = time.perf_counter()
    legs = dryrun.dryrun_multichip(PARALLEL_RANKS, dev.type)
    emit({"phase": "parallel", "check": "dryrun_multichip",
          "ranks": PARALLEL_RANKS, "legs": legs,
          "seconds": time.perf_counter() - t0})
    dist.destroy_process_group()
    emit({"phase": "parallel", "seconds": time.perf_counter() - t_phase})


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

    # ---- the redesigned generic kernels on both routes, fk_line past
    # P = 64 and fk_label on an asymmetric bath table
    generic_redesign(dev, results, graphs, odd_torus, power, name)
    phase_seconds["generic_redesign"] = time.perf_counter() - t_script

    # ---- the dense engine and the noisy kernels against their plain
    # versions
    sk_problem = dense_checks(dev, results)
    gtorus80 = graphs[f"gaussian_torus({L}, 0).to_generic()"]
    tables = noisy_tables(gtorus80, dev)
    noisy_checks(dev, results, gtorus80, tables)
    phase_seconds["dense_noisy_vs_plain"] = time.perf_counter() - t_script

    # ---- generic SA over a cluster on both routes, the dense in-block
    # kernel at the listed shapes
    sa_dense_redesign(dev, results, graphs, torus, odd_torus, sk_problem,
                      tables, power, name)
    phase_seconds["sa_dense_redesign"] = time.perf_counter() - t_script

    # ---- the chain-bit energy kernel at every K and generic SVMC over a
    # cluster on both routes
    energy_svmc_redesign(dev, results, graphs, torus, odd_torus, tables,
                         power, name)
    phase_seconds["energy_svmc_redesign"] = time.perf_counter() - t_script

    # ---- generic SVMC's first kernel on an improper packing, the Houdayer
    # move over a cluster and in place, fk_line in one launch an anneal
    houdayer_line_redesign(dev, results, gtorus80, odd_torus, power, name)
    phase_seconds["houdayer_line_redesign"] = time.perf_counter() - t_script

    # ---- the cluster kernels against their plain versions
    cluster_checks(dev, results, gtorus80)
    phase_seconds["cluster_kernel_vs_plain"] = time.perf_counter() - t_script

    # ---- fk_wolff and fk_label at the boundary shapes of their rule
    cluster_redesign(dev, results, gtorus80)
    phase_seconds["cluster_redesign"] = time.perf_counter() - t_script

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
        # SA launch (piqmc_sw: one fk_line launch an anneal;
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
         {"packed_sa": 1, "fk_line": 1}),
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
    phase_seconds["sampler_solves"] = time.perf_counter() - t_script
    # ---- the API surface and the studies, the counts read around each run
    api_surface(dev, main_launches, torus, power, name)
    phase_seconds["api_surface"] = time.perf_counter() - t_script
    studies(dev, main_launches, torus, power, name)
    phase_seconds["studies"] = time.perf_counter() - t_script
    emit({"phase": "main_path", "launches": main_launches})
    check(not any(main_launches[k] for k, _, _ in WIDE_KERNELS.values()),
          "no main-path solve takes a generic kernel's _wide route")
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
    phase_seconds["mst_and_examples"] = time.perf_counter() - t_script

    # ---- the parallel layer: chain offsets, the shard kernels, a one-rank
    # NCCL mesh, gloo ranks sharing the card, the dry run
    parallel_checks(dev, results, main_launches, torus, odd_torus, power,
                    name)
    phase_seconds["parallel"] = time.perf_counter() - t_script

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
         "library_ms": results[k].get("library_ms"),
         **({"gained": GAINED[k]} if k in GAINED else {})}
        for k, (key, src, tpu) in KERNELS.items()
    ]})
    # seconds from the start at the end of each phase
    emit({"phase": "done", "seconds": time.perf_counter() - t_script,
          "phase_seconds": phase_seconds})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
