"""Solver entry points (counterpart of montecarlosolvers_tpu.solvers)."""
