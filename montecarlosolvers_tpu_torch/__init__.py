"""montecarlosolvers_tpu_torch — the PyTorch/CUDA port of montecarlosolvers_tpu.

The JAX package beside this one is the reference; this package is held
against it module by module. Module names and layout follow the JAX
package (`models/`, `ops/`, `solvers/`, `schedules.py`) so each module's
counterpart is easy to find.

Scope of this package today: the Martonak-Santoro-Tosatti main path on a
`LatticeProblem` with even L — classical SA and PIQMC (even P, local plus
whole-line global moves) on the split-checkerboard layout, and the one-call
`solvers.api.solve` with method "sa" or "piqmc". On a CUDA device the two
engines run hand-written CUDA kernels (`csrc/split_sa.cu`,
`csrc/split_qmc.cu`); on the CPU they run the plain PyTorch versions beside
the kernel wrappers (`ops/split_kernels.py`), which equal the JAX oracles
bitwise. Everything else raises NotImplementedError naming the ROADMAP.md
item that will port it.

Random numbers come from the counter hash of the JAX package's Pallas
kernels (`ops/counter_rng.py`), not from torch's generators: solvers draw
only the integer hash seed from their `torch.Generator`.

This package imports torch and numpy and never jax.
"""

from montecarlosolvers_tpu_torch import schedules
from montecarlosolvers_tpu_torch.models.lattice import LatticeProblem
from montecarlosolvers_tpu_torch.solvers import sa, qmc
from montecarlosolvers_tpu_torch.solvers.api import SampleSet, solve

__version__ = "0.1.0"

__all__ = ["LatticeProblem", "SampleSet", "qmc", "sa", "schedules", "solve"]
