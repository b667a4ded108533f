"""The parallel layer on torch.distributed (counterpart of
montecarlosolvers_tpu/parallel/): device meshes and chain sharding
(`mesh.py`; the samplers' rung- and population-sharded runs are
solvers/_engines.py::ShardedEngine on it), and the Trotter-sharded PIQMC
engines, the bath and the Wolff and Swendsen-Wang cluster engines among
them (`trotter.py`). The disorder and multihost modules are queued at
ROADMAP.md queue 1, item 6."""

from montecarlosolvers_tpu_torch.parallel.mesh import (
    chain_sharding,
    make_mesh,
    shard_chains,
)
from montecarlosolvers_tpu_torch.parallel import trotter

__all__ = ["make_mesh", "shard_chains", "chain_sharding", "trotter"]
