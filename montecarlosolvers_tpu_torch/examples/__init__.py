"""Drivers of the port (counterparts of the repository's examples/): each
exposes a `run(...)` that its `main()` calls and that takes any
(problem, e_gs), and runs as `python -m montecarlosolvers_tpu_torch.
examples.<name>` on the card."""
