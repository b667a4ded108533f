"""Benchmarks of the port (counterparts of bench.py and
montecarlosolvers_tpu/bench/)."""
