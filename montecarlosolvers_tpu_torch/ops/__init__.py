"""Sweep engines and their kernels (counterpart of montecarlosolvers_tpu.ops)."""
