"""Drivers of the port (counterparts of the repository's examples/): each
exposes a `run(...)` that its `main()` calls (santoro_mst, dissipative_qa
and cluster_and_pt take any (problem, e_gs); compat_migration builds the
reference-style instance it drives), and runs as `python -m
montecarlosolvers_tpu_torch.examples.<name>` on the card."""
