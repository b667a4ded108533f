"""Utilities of the port (counterpart of montecarlosolvers_tpu/utils/):
observables, checkpointed anneals and profiling helpers. The JAX
`xla_cache` and `profiling.suggest_chains` exist only for the TPU and are
not ported (ROADMAP.md, "Not to port")."""

from montecarlosolvers_tpu_torch.utils import observables, profiling
from montecarlosolvers_tpu_torch.utils.checkpoint import (
    CheckpointedAnneal,
    validate_state,
    save_neighbor_table,
    load_neighbor_table,
)

__all__ = [
    "observables",
    "profiling",
    "CheckpointedAnneal",
    "validate_state",
    "save_neighbor_table",
    "load_neighbor_table",
]
