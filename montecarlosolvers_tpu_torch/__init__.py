"""montecarlosolvers_tpu_torch — the PyTorch/CUDA port of montecarlosolvers_tpu.

The JAX package beside this one is the reference; this package is held
against it module by module. Module names and layout follow the JAX
package (`models/`, `ops/`, `solvers/`, `schedules.py`) so each module's
counterpart is easy to find.

Scope of this package today: the Martonak-Santoro-Tosatti main path,
dissipative PIQMC and spin-vector Monte Carlo on any `LatticeProblem` (any
L, open or periodic) — classical SA, PIQMC at any P (local plus whole-line
global moves; with a bath `lookuptable`, the dissipative sweep,
sequential or colored, on every problem at any P >= 2), SVMC with uniform
or TF proposals, and the
one-call `solvers.api.solve` with method "sa", "piqmc" or "svmc"; the
same solvers on the generic `IsingProblem` (neighbor tables, COO triplets,
QUBOs, chimera graphs, 3-D glasses, random graphs: `models/ising.py`,
`models/instances.py`). Even L (and even P) take the split-checkerboard
engines (`ops/split_kernels.py`), other lattices the full-plane engines
(`ops/plane_kernels.py`), an IsingProblem the class-major packed engines
(`ops/generic_kernels.py`). On a CUDA device the engines run hand-written
CUDA kernels (`csrc/split_sa.cu`, `csrc/split_qmc.cu`,
`csrc/split_qmc_bath.cu`, `csrc/split_svmc.cu`, `csrc/plane_sa.cu`,
`csrc/plane_qmc.cu`, `csrc/plane_svmc.cu`, and `csrc/packed_sa.cu`,
`csrc/generic_qmc.cu`, `csrc/packed_svmc.cu`, `csrc/generic_qmc_bath.cu`
for the generic problem and the bath on odd L); on
the CPU they run the plain PyTorch versions
beside the kernel wrappers, which equal the JAX oracles and the Pallas
interpreter (bitwise for spins, to the last ulps of cos and sin for rotor
angles). The three solvers take `collect_energy=` (on the card: the
per-phase kernels and the energy kernel, `csrc/energy.cuh`);
`bench/mst.py` runs the MST matrix with its resume and `examples/` holds
the reference's `santoro_mst` and `dissipative_qa` scripts. The
fully-connected `DenseProblem` (`models/dense.py`, `instances.sk_model`'s
default) anneals through `sa.anneal` and `solve(method="sa")` on the dense
engine (`ops/dense_kernels.py`: block fields by torch.matmul, the
sequential in-block steps on `csrc/dense_sa.cu`), and `sa.anneal_noisy` /
`svmc.anneal_noisy` anneal an IsingProblem on per-step coupling tables
through the packed kernels. The cluster updates (`sa/qmc.anneal_wolff`,
`anneal_sw`, `qmc.anneal_sw_bath`, `ops/cluster_kernels.py`) and the
samplers (`solvers/pt.py`: parallel tempering, quantum PT, ICM;
`solvers/pa.py`: population annealing, classical and quantum, fixed and
adaptive; solve's "pt", "icm", "pa" and "paq") run too. The parallel
layer is not ported yet: a call that needs it raises NotImplementedError
naming its ROADMAP.md item, and so does a call the JAX package does not
run on a DenseProblem (`qmc.anneal`, `svmc.anneal`, solve's "piqmc",
"svmc", "paq").

Every function that takes `device=None` builds on the CUDA card and raises
on a host without one (`_device.resolve`); the solvers run on the
problem's device, so the plain versions run on the host only when the
caller asks for `device="cpu"`.

Random numbers come from the counter hash of the JAX package's Pallas
kernels (`ops/counter_rng.py`), not from torch's generators: solvers draw
only the integer hash seed from their `torch.Generator`.

This package imports torch and numpy and never jax.
"""

from montecarlosolvers_tpu_torch import schedules
from montecarlosolvers_tpu_torch.models.dense import DenseProblem
from montecarlosolvers_tpu_torch.models.ising import IsingProblem
from montecarlosolvers_tpu_torch.models.lattice import LatticeProblem
from montecarlosolvers_tpu_torch.solvers import sa, qmc, svmc, pt
from montecarlosolvers_tpu_torch.solvers.api import SampleSet, solve

__version__ = "0.1.0"

__all__ = ["DenseProblem", "IsingProblem", "LatticeProblem", "SampleSet",
           "pt", "qmc", "sa", "schedules", "solve", "svmc"]
