"""Kernels A and B against their plain PyTorch versions on a CUDA device.

Marked `gpu`: each test skips when torch sees no CUDA device. The repo's
tests/conftest.py imports JAX, which the GPU machine need not have, so run
this file there with

    python -m pytest tests/test_torch_gpu.py -q --noconftest -p no:cacheprovider

Small shapes that the main path does not reach: Nh = 50 (L = 10, tails of
the 256-thread blocks), Q = 1 (P = 2, both Trotter terms one element), open
and periodic lattices, B != 1.
"""

import numpy as np
import pytest
import torch

from montecarlosolvers_tpu_torch import schedules
from montecarlosolvers_tpu_torch.models import instances
from montecarlosolvers_tpu_torch.ops import split as split_ops
from montecarlosolvers_tpu_torch.ops import split_kernels as sk
from montecarlosolvers_tpu_torch.solvers.api import solve

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _lattice(L, periodic, dev):
    if periodic:
        return instances.gaussian_torus(L, seed=L, device=dev)
    return instances.random_2d_lattice(L, rng=L, device=dev)[0]


@pytest.mark.parametrize("L,periodic", [(10, True), (16, False), (32, True)])
def test_kernel_a_equals_plain(cuda, L, periodic):
    lat = _lattice(L, periodic, cuda)
    sl = split_ops.build_split(lat)
    rng = np.random.default_rng(0)
    s = torch.as_tensor(rng.choice([-1.0, 1.0], size=(5, L * L))
                        .astype(np.float32), device=cuda)
    a, b = (x.contiguous() for x in split_ops.pack_classical(sl, s))
    sched = schedules.linear(3.0, 0.0, 64, device=cuda)
    out = sk.sa_split_anneal(sl, sched, a, b, 3)
    ref = sk.sa_split_anneal_ref(sl, sched, a, b, 3)
    for x, y in zip(out, ref):
        assert torch.equal(x, y)


@pytest.mark.parametrize(
    "L,P,periodic,gm,bscale",
    [(10, 2, True, True, 1.0), (16, 4, False, True, 0.7),
     (16, 6, True, False, 0.7), (32, 8, True, True, 1.0)],
)
def test_kernel_b_equals_plain(cuda, L, P, periodic, gm, bscale):
    lat = _lattice(L, periodic, cuda)
    sl = split_ops.build_split(lat)
    rng = np.random.default_rng(1)
    c = torch.as_tensor(rng.choice([-1.0, 1.0], size=(3, P, L * L))
                        .astype(np.float32), device=cuda)
    qs = split_ops.pack_qmc(sl, c)
    gamma = schedules.transverse_field(2.5, 1e-8, 30, device=cuda)
    teff = (1.0 / P) * P
    jp = schedules.jperp(gamma, teff).contiguous()
    bs = torch.full_like(gamma, bscale)
    out = sk.qmc_split_anneal(sl, bs, jp, teff, qs, 5, gm)
    ref = sk.qmc_split_anneal_ref(sl, bs, jp, teff, qs, 5, gm)
    for x, y in zip(out, ref):
        assert torch.equal(x, y)


def test_wrapper_refusals(cuda):
    lat = _lattice(16, True, cuda)
    sl = split_ops.build_split(lat)
    a = torch.ones((2, sl.nh), device=cuda)
    sched = schedules.linear(1.0, 0.0, 4, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        sk.sa_split_anneal(sl, sched, a.double(), a.double(), 0)
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.ones((2, 2 * sl.nh), device=cuda)[:, ::2]
        sk.sa_split_anneal(sl, sched, wide, a, 0)
    big = _lattice(242, False, cuda)
    sl_big = split_ops.build_split(big)
    ab = torch.ones((1, sl_big.nh), device=cuda)
    with pytest.raises(ValueError, match="shared"):
        sk.sa_split_anneal(sl_big, sched, ab, ab, 0)


def test_solve_runs_the_kernels(cuda):
    lat = _lattice(16, True, cuda)
    sk.reset_launches()
    ss = solve(lat, "piqmc", num_reads=4, sweeps=50, slices=4, seed=1)
    assert sk.LAUNCHES["sa_split"] == 1 and sk.LAUNCHES["qmc_split"] == 1
    assert set(np.unique(ss.samples)) <= {-1.0, 1.0}
    assert np.all(np.isfinite(ss.energies))
