"""The parallel layer on torch.distributed (counterpart of
montecarlosolvers_tpu/parallel/): device meshes and chain sharding of every
solver (`mesh.py`; the samplers' rung- and population-sharded runs are
solvers/_engines.py::ShardedEngine on it), the Trotter-sharded PIQMC
engines, the bath and the Wolff and Swendsen-Wang cluster engines among
them (`trotter.py`), disorder batches of coupling realizations
(`disorder.py`) and their (disorder, chains) mesh across hosts
(`multihost.py`)."""

from montecarlosolvers_tpu_torch.parallel.mesh import (
    chain_sharding,
    make_mesh,
    shard_chains,
)
from montecarlosolvers_tpu_torch.parallel import trotter

__all__ = ["make_mesh", "shard_chains", "chain_sharding", "trotter"]
from montecarlosolvers_tpu_torch.parallel import disorder  # noqa: E402

__all__.append("disorder")
from montecarlosolvers_tpu_torch.parallel import multihost  # noqa: E402

__all__.append("multihost")
