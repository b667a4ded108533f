"""Problem models and instances (counterpart of montecarlosolvers_tpu.models)."""
