"""`collect_energy=` of the port's sa/qmc/svmc.anneal on the CPU: the
energies' shape against the JAX solvers', the last row against the state
the call returns, every row against a run over that prefix of the
schedule, the trajectory against the same call without energies, and the
port's readouts against the JAX package's on the same numpy states.

On the CPU the solvers run the plain versions (ops/split_kernels.py,
ops/plane_kernels.py) and read the energies through ops/energy.py's plain
versions; the energy kernel on the card is held to them by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from montecarlosolvers_tpu import schedules as jsched
from montecarlosolvers_tpu.models.lattice import LatticeProblem as JLattice
from montecarlosolvers_tpu.ops import split as jsplit
from montecarlosolvers_tpu.ops import svmc_ops as jsvmc_ops
from montecarlosolvers_tpu.solvers import qmc as jqmc
from montecarlosolvers_tpu.solvers import sa as jsa
from montecarlosolvers_tpu.solvers import svmc as jsvmc
from montecarlosolvers_tpu_torch import convert
from montecarlosolvers_tpu_torch import schedules as tsched
from montecarlosolvers_tpu_torch.ops import energy as energy_ops
from montecarlosolvers_tpu_torch.ops import plane as plane_ops
from montecarlosolvers_tpu_torch.ops import split as split_ops
from montecarlosolvers_tpu_torch.ops import split_kernels as sk
from montecarlosolvers_tpu_torch.solvers import qmc, sa, svmc

torch.set_num_threads(1)

STEPS, CHAINS, SLICES_EVEN, SLICES_ODD, TEMP_SVMC = 3, 2, 4, 5, 0.05
# (solver, P, bath, tf): SA; PIQMC at even P (split engine on even L) and
# odd P (full plane); the bath engine; SVMC with uniform and TF proposals
KINDS = {
    "sa": ("sa", None, False, False),
    "piqmc_even_p": ("qmc", SLICES_EVEN, False, False),
    "piqmc_odd_p": ("qmc", SLICES_ODD, False, False),
    "piqmc_bath": ("qmc", SLICES_EVEN, True, False),
    "svmc_uniform": ("svmc", None, False, False),
    "svmc_tf": ("svmc", None, False, True),
}
CASES = [(kind, L) for kind in KINDS for L in (8, 7)
         if not (KINDS[kind][2] and L % 2)]  # the bath takes even L


def torus(L, seed=3):
    r = np.random.default_rng(seed)
    jr, jd = r.normal(size=(L, L)), r.normal(size=(L, L))
    h = 0.1 * r.normal(size=(L, L))
    return (JLattice.from_planes(jr, jd, h),
            convert.lattice_from_arrays(jr, jd, h, col_wrap=True,
                                        device="cpu"))


def start(kind, L, batched, seed=11):
    """Numpy start state of `kind`: spins (chains, N), lines (chains, P, N)
    or angles (chains, N), without the chain axis when not `batched`."""
    solver, P, _, _ = KINDS[kind]
    r = np.random.default_rng(seed)
    shape = (CHAINS,) if batched else ()
    if solver == "svmc":
        return (r.random(shape + (L * L,)) * np.pi).astype(np.float32)
    s = r.choice([-1.0, 1.0], size=shape + (L * L,)).astype(np.float32)
    return s if solver == "sa" else np.repeat(s[..., None, :], P, axis=-2)


def schedule(kind):
    """(first schedule, second schedule) of `kind` as float32 numpy."""
    solver = KINDS[kind][0]
    if solver == "sa":
        return np.linspace(2.0, 0.2, STEPS, dtype=np.float32), None
    gamma = np.linspace(2.0, 1e-8, STEPS, dtype=np.float32)
    return gamma, np.ones(STEPS, np.float32)


def port_anneal(kind, prob, state, sched, seed, mcsteps=1, collect=False):
    solver, P, bath, tf = KINDS[kind]
    gen = torch.Generator().manual_seed(seed)
    x = torch.as_tensor(state)
    first = torch.as_tensor(sched[0])
    if solver == "sa":
        return sa.anneal(prob, first, x, gen, mcsteps=mcsteps,
                         collect_energy=collect)
    second = torch.as_tensor(sched[1])
    if solver == "svmc":
        return svmc.anneal(prob, first, second, TEMP_SVMC, x, gen,
                           mcsteps=mcsteps, tf=tf, collect_energy=collect)
    lut = tsched.bath_lookuptable(P, 0.2, device="cpu") if bath else None
    return qmc.anneal(prob, first, second, 1.0 / P, x, gen, mcsteps=mcsteps,
                      global_moves=True, lookuptable=lut,
                      collect_energy=collect)


def readout(kind, prob, state):
    """The energy the solver collects, of a returned state."""
    solver = KINDS[kind][0]
    if solver == "qmc":
        return qmc.best_slice_energy(prob, state)
    if solver == "svmc":
        return prob.energy(svmc.z_projection(state))
    return prob.energy(state)


@pytest.mark.parametrize("mcsteps", [1, 2])
@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("kind,L", CASES)
def test_collect_energy(kind, L, batched, mcsteps):
    """(states, energies): energies float32 of shape (steps * mcsteps,) +
    batch; the last row the readout of the returned state; the state
    bitwise that of the call without energies; row t the readout of a run
    over the first t + 1 sweeps with the same generator seed, whose state
    the counter hash makes bitwise the same."""
    _, prob = torus(L)
    x0 = start(kind, L, batched)
    sched = schedule(kind)
    out, es = port_anneal(kind, prob, x0, sched, 5, mcsteps, collect=True)
    batch = (CHAINS,) if batched else ()
    assert es.dtype == torch.float32
    assert tuple(es.shape) == (STEPS * mcsteps,) + batch
    assert torch.equal(out, port_anneal(kind, prob, x0, sched, 5, mcsteps))
    torch.testing.assert_close(es[-1], readout(kind, prob, out), rtol=1e-6,
                               atol=1e-5)
    sweeps = [None if s is None else np.repeat(s, mcsteps) for s in sched]
    for t in range(STEPS * mcsteps):
        prefix = [None if s is None else s[:t + 1] for s in sweeps]
        part = port_anneal(kind, prob, x0, prefix, 5)
        if t == STEPS * mcsteps - 1:
            assert torch.equal(part, out)
        torch.testing.assert_close(es[t], readout(kind, prob, part),
                                   rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("kind,L", CASES)
def test_collect_energy_shape_matches_jax(kind, L, batched):
    """The JAX solver's energies on the same lattice, P, start and schedule
    (mcsteps = 2) have the port's shape, and its last row is the JAX
    readout of its returned state, as tests/test_sa.py and test_qmc.py
    hold it."""
    jprob, prob = torus(L)
    solver, P, bath, tf = KINDS[kind]
    x0 = start(kind, L, batched)
    first, second = schedule(kind)
    key = jax.random.key(4)
    x = jnp.asarray(x0)
    if solver == "sa":
        jout, jes = jsa.anneal(jprob, jnp.asarray(first), x, key, mcsteps=2,
                               collect_energy=True)
        want = jprob.energy(jout)
    elif solver == "svmc":
        jout, jes = jsvmc.anneal(jprob, jnp.asarray(first),
                                 jnp.asarray(second), TEMP_SVMC, x, key,
                                 mcsteps=2, tf=tf, collect_energy=True)
        want = jprob.energy(jsvmc_ops.z_projection(jout))
    else:
        lut = jsched.bath_lookuptable(P, 0.2) if bath else None
        jout, jes = jqmc.anneal(jprob, jnp.asarray(first),
                                jnp.asarray(second), 1.0 / P, x, key,
                                mcsteps=2, global_moves=True,
                                lookuptable=lut, collect_energy=True)
        want = jqmc.best_slice_energy(jprob, jout)
    np.testing.assert_allclose(np.asarray(jes[-1]), np.asarray(want),
                               rtol=1e-5, atol=1e-4)
    _, es = port_anneal(kind, prob, x0, (first, second), 5, 2, collect=True)
    assert tuple(es.shape) == tuple(jes.shape)


@pytest.mark.parametrize("L", [8, 7])
def test_readouts_match_jax(L):
    """The port's readouts of collect_energy= on the same numpy states as
    the JAX package's, to rtol 1e-6: the classical energy
    (ops/energy.py's halves and plane forms against JAX
    classical_energy_split and problem.energy), the best slice (quarters,
    halves per slice and planes against JAX qmc.best_slice_energy) and the
    z-projection (cos theta forms against JAX svmc_ops.z_projection +
    energy), with cos theta = 0 exactly at some sites."""
    jprob, prob = torus(L)
    r = np.random.default_rng(7)
    n = L * L
    spins = r.choice([-1.0, 1.0], size=(3, n)).astype(np.float32)
    lines = r.choice([-1.0, 1.0], size=(3, SLICES_EVEN, n)).astype(
        np.float32)
    theta = (r.random((3, n)) * np.pi).astype(np.float32)
    theta[:, ::5] = np.float32(np.pi / 2)  # cos theta rounds near 0
    cos = np.cos(theta)
    cos[:, ::7] = 0.0  # the boundary: +1
    rtol = dict(rtol=1e-6, atol=1e-5)

    def close(port, jax_value):
        np.testing.assert_allclose(port.numpy(), np.asarray(jax_value),
                                   **rtol)

    want_s = jprob.energy(jnp.asarray(spins))
    want_l = jqmc.best_slice_energy(jprob, jnp.asarray(lines))
    want_z = jprob.energy(jsvmc_ops.z_projection_from_cos(jnp.asarray(cos)))
    pl = plane_ops.build_plane(prob)
    close(energy_ops.plane_energy(pl, torch.as_tensor(spins).reshape(
        3, L, L)), want_s)
    close(energy_ops.plane_energy(pl, torch.as_tensor(lines).reshape(
        3, SLICES_EVEN, L, L)), want_l)
    close(energy_ops.plane_energy(pl, torch.as_tensor(cos).reshape(3, L, L),
                                  cos_theta=True), want_z)
    close(prob.energy(svmc.z_projection(torch.as_tensor(theta))),
          jprob.energy(jsvmc_ops.z_projection(jnp.asarray(theta))))
    if L % 2:
        return
    sl = split_ops.build_split(prob)
    jsl = jsplit.build_split(jprob)
    ja, jb = jsplit.pack_classical(jsl, jnp.asarray(spins))
    a, b = split_ops.pack_classical(sl, torch.as_tensor(spins))
    close(energy_ops.halves_energy(sl, a, b),
          jsplit.classical_energy_split(jsl, ja, jb))
    close(energy_ops.halves_energy(sl, a, b), want_s)
    a, b = split_ops.pack_classical(sl, torch.as_tensor(lines))
    close(energy_ops.halves_energy(sl, a, b), want_l)
    close(energy_ops.quarters_energy(
        sl, split_ops.pack_qmc(sl, torch.as_tensor(lines))), want_l)
    a, b = split_ops.pack_classical(sl, torch.as_tensor(cos))
    close(energy_ops.halves_energy(sl, a, b, cos_theta=True), want_z)


def test_energies_need_the_counter_hash():
    """The generator instantiations (hw_rng=True) collect no energies: a
    wrapper given both raises, and without energies nothing changes."""
    _, prob = torus(8)
    sl = split_ops.build_split(prob)
    a, b = split_ops.pack_classical(
        sl, torch.as_tensor(start("sa", 8, True)))
    sched = torch.as_tensor(schedule("sa")[0])
    with pytest.raises(ValueError, match="hw_rng"):
        sk.sa_split_anneal(sl, sched, a, b, 3, hw_rng=True,
                           energies=torch.empty(STEPS, CHAINS))
    es = torch.empty(STEPS, CHAINS)
    got = sk.sa_split_anneal(sl, sched, a, b, 3, energies=es)
    assert all(torch.equal(x, y) for x, y in
               zip(got, sk.sa_split_anneal(sl, sched, a, b, 3)))


@pytest.mark.parametrize("kernel,L,slices", [
    ("split_sa", 8, None), ("split_qmc", 8, 4), ("split_qmc_bath", 8, 3),
    ("split_svmc", 8, None), ("plane_sa", 7, None), ("plane_qmc", 7, 5),
    ("plane_svmc", 7, None)])
def test_collect_cases_on_the_cpu(kernel, L, slices):
    """tests/gibbs_check.py::collect_case, which the card's checks use, on
    CPU tensors: the wrapper takes the plain version (no launch), fills
    every row, and its last row is the readout of the state it returns."""
    import gibbs_check as gibbs
    from montecarlosolvers_tpu_torch.ops import _build

    lat = torus(L)[1]
    case = gibbs.collect_case(kernel, lat, 3, 4, slices)
    wrapper, plain, key = gibbs.COLLECTING[kernel]
    assert set(case["launches"]) == {f"{key}_phased", f"{key}_energy"}
    es, es_plain = torch.full((4, 3), np.nan), torch.full((4, 3), np.nan)
    _build.reset_launches()
    out = case["run"](wrapper, es)
    assert not any(_build.LAUNCHES.values())
    ref = case["run"](plain, es_plain)
    assert all(torch.equal(x, y) for x, y in zip(out, ref))
    assert torch.equal(es, es_plain) and bool(torch.isfinite(es).all())
    if kernel.startswith("split"):
        sl = split_ops.build_split(lat)
        if kernel == "split_qmc":
            state = split_ops.unpack_qmc(sl, *out)
        else:
            state = split_ops.unpack_classical(sl, *out)
    else:
        state = out[0].reshape(out[0].shape[:-2] + (L * L,))
    if kernel.endswith("svmc"):
        state = svmc.z_projection(state)
    want = (qmc.best_slice_energy(lat, state) if slices
            else lat.energy(state))
    torch.testing.assert_close(es[-1], want, rtol=1e-6, atol=1e-5)
