"""Population annealing, classical and quantum, fixed and adaptive
(counterpart of montecarlosolvers_tpu/solvers/pa.py).

A population of R replicas anneals down one schedule; between steps each
replica is reweighted, and the population resampled when its effective
sample size falls below `ess_threshold * R`, so it tracks the Gibbs (or
extended path-integral) distribution, and the normalizers accumulate the
free-energy estimator log_z = ln[Z(end) / Z(start)].

The temperature (or Gamma) of a step is shared by the whole population, so
the sweeps run on the engines' shared-schedule kernels
(`solvers/_engines.py`: kernel A, the packed SA or dense kernels; kernel B
or the generic PIQMC kernel), one launch a step of `mcsteps` sweeps, the
hash counting them from step0 = step * mcsteps. The per-step work on the
(R,) vectors, the reweight, logsumexp, the ESS, the cumulative sum and
searchsorted of the resample, and the row gather of the population and of
its lineage `anc`, are torch ops on the population's device; they run in
float32, as the JAX sampler's do, and decide the resample there with no
host round trip (the adaptive loops read one flag a step to stop).

Draws come from the counter hash (ops/counter_rng.py): the systematic
offset of step k on the sampler stream SYSTEMATIC (uid 0), the multinomial
draws on MULTINOMIAL (uid the slot; inverse-CDF draws, which have the
distribution of the JAX sampler's Gumbel-max `jax.random.categorical`, not
its draws), merge_populations' draws on MERGE. The pieces that take their
draws as arguments (`_systematic_indices`, `merge_populations(draws=)`)
equal the JAX functions on JAX's own draws.

Three departures from the JAX sampler, each a fix of a defect the JAX
package keeps (ADVICE.md):
  * the adaptive samplers report reached = (the final beta, or J_perp,
    reached its end), not n_steps < max_steps, so a run that ends exactly
    on its last step is not reported as truncated;
  * solve("pa", adaptive=True) with no live step reports min_ess_frac 1.0
    (solvers/api.py) where the JAX solve takes the min of an empty array;
  * solve("pa", adaptive=True, ess_threshold=...) is refused (the adaptive
    sampler resamples every step), where the JAX solve ignores it.
`combine_runs` computes in float64, as the JAX function does, and
`merge_populations` draws on float32 weights, as it does.
"""

from __future__ import annotations

import numpy as np
import torch

from montecarlosolvers_tpu_torch import _device, schedules
from montecarlosolvers_tpu_torch.ops import counter_rng as cr
from montecarlosolvers_tpu_torch.solvers._engines import (ClassicalEngine,
                                                          QuantumEngine)
from montecarlosolvers_tpu_torch.solvers.sa import draw_seed

RESAMPLES = ("systematic", "multinomial")


def beta_linear(beta_end, num, beta_start=0.0, device=None):
    """Temperature schedule linear in beta (JAX `beta_linear`, pa.py:50),
    float32 on `device` (None: the card); beta_start=0.0 makes the first
    temperature inf, where a uniform-random population is the exact Gibbs
    ensemble and ln Z becomes absolute through `uniform_log_z`."""
    betas = np.linspace(beta_start, beta_end, num)
    with np.errstate(divide="ignore"):
        temps = (1.0 / betas).astype(np.float32)
    return torch.from_numpy(temps).to(_device.resolve(device))


def uniform_log_z(nspins):
    """ln Z at beta = 0, N ln 2 (JAX `uniform_log_z`, pa.py:66)."""
    return float(nspins) * float(np.log(2.0))


def _systematic_indices(u, w):
    """Stratified comb over the cumulative weights (JAX
    `_systematic_indices`, pa.py:72): slot i takes the first replica j with
    cum[j] >= (i + u) / R, for one uniform u (a float32 0-d tensor) and
    normalized float32 weights w (R,). torch.cumsum adds in index order
    (XLA's cumsum in another), so the two agree bitwise where no comb point
    lies within the sums' last-ulp difference of a boundary."""
    r = w.shape[0]
    cum = torch.cumsum(w, 0)
    pts = (torch.arange(r, dtype=w.dtype, device=w.device) + u) / r
    idx = torch.searchsorted(cum, pts, side="left")
    return torch.clamp(idx, 0, r - 1)


def _multinomial_indices(u, logw):
    """R independent categorical draws of the replicas with probabilities
    prop. to exp(logw), by inverse CDF on uniforms u (R,)."""
    w = torch.exp(logw - torch.max(logw))
    cum = torch.cumsum(w, 0)
    idx = torch.searchsorted(cum, u * cum[-1], side="right")
    return torch.clamp(idx, 0, logw.shape[0] - 1)


def _resample_indices(resample, seed, step, logw, log_r):
    """The resampling indices of `step`: systematic on normalized weights,
    or multinomial."""
    r = logw.shape[0]
    if resample == "systematic":
        u = cr.sampler_uniforms(seed, step, cr.SYSTEMATIC, 1, logw.device)[0]
        return _systematic_indices(u, torch.exp(logw - log_r))
    u = cr.sampler_uniforms(seed, step, cr.MULTINOMIAL, r, logw.device)
    return _multinomial_indices(u, logw)


def _check_resample(resample):
    if resample not in RESAMPLES:
        raise ValueError(f"resample must be 'systematic' or 'multinomial', "
                         f"got {resample!r}")


class _Population:
    """The weights, the free-energy accumulator and the lineage of R
    replicas (pa.py:138-166)."""

    def __init__(self, r, device):
        self.r = r
        self.log_r = torch.tensor(np.log(r), dtype=torch.float32,
                                  device=device)
        self.logw = torch.zeros(r, dtype=torch.float32, device=device)
        self.log_z = torch.zeros((), dtype=torch.float32, device=device)
        self.anc = torch.arange(r, dtype=torch.int32, device=device)

    def normalize(self):
        """Roll the normalizer into log_z; return the ESS (Kish) of the
        normalized weights."""
        c = torch.logsumexp(self.logw, 0) - self.log_r
        self.log_z = self.log_z + c
        self.logw = self.logw - c
        w = torch.exp(self.logw - self.log_r)
        return 1.0 / torch.sum(w * w)

    def resample(self, engine, idx, do_rs=None):
        """Gather the population at idx where do_rs (a bool tensor; None:
        always), resetting those weights."""
        if do_rs is not None:
            idx = torch.where(do_rs, idx, torch.arange(
                self.r, device=idx.device))
            self.logw = torch.where(do_rs, torch.zeros_like(self.logw),
                                    self.logw)
        else:
            self.logw = torch.zeros_like(self.logw)
        engine.permute(idx)
        self.anc = self.anc[idx]

    def families(self):
        return int(torch.unique(self.anc).numel())


def sample(problem, temps, states, generator, mcsteps=1, beta0=None,
           ess_threshold=1.0, resample="systematic", collect_stats=False):
    """Population annealing down the temperature schedule `temps` (JAX
    `sample`, pa.py:174; the port loops a step at a time, so it has no
    `segment`).

    problem: LatticeProblem, IsingProblem or DenseProblem. temps: (S,)
    temperatures > 0 (inf for beta = 0). Step k reweights the population
    from the previous inverse temperature to 1/temps[k], resamples if ESS <
    ess_threshold * R, then runs `mcsteps` sweeps at temps[k]. states: (R,
    N) +/-1 (uniform random for an absolute ln Z with beta0=0.0).
    generator: torch.Generator the hash seed is drawn from. beta0: the
    inverse temperature of the initial population (None: 1/temps[0]).

    Returns (states, log_z[, stats]): log_z a float32 0-d tensor of
    ln[Z(1/temps[-1]) / Z(beta0)]; stats {"ess" (S,), "e_mean" (S,),
    "resampled" (S,) bool, "families" int}."""
    _check_resample(resample)
    dev = problem.device
    temps = torch.as_tensor(temps, dtype=torch.float32, device=dev)
    r = states.shape[0]
    seed = draw_seed(generator)
    eng = ClassicalEngine(problem, states)
    pop = _Population(r, dev)
    beta_prev = (torch.tensor(beta0, dtype=torch.float32, device=dev)
                 if beta0 is not None else 1.0 / temps[0])
    thresh = torch.tensor(ess_threshold, dtype=torch.float32,
                          device=dev) * r
    ess_s, e_s, rs_s = [], [], []
    for k in range(temps.shape[0]):
        beta = 1.0 / temps[k]
        e = eng.energy().to(torch.float32)
        pop.logw = pop.logw - (beta - beta_prev) * e
        ess = pop.normalize()
        do_rs = ess < thresh
        pop.resample(eng, _resample_indices(resample, seed, k, pop.logw,
                                            pop.log_r), do_rs)
        eng.sweep(temps[k:k + 1], seed, k * mcsteps, mcsteps)
        beta_prev = beta
        if collect_stats:
            ess_s.append(ess)
            e_s.append(torch.mean(e))
            rs_s.append(do_rs)
    out = eng.full()
    if collect_stats:
        return out, pop.log_z, {
            "ess": torch.stack(ess_s), "e_mean": torch.stack(e_s),
            "resampled": torch.stack(rs_s), "families": pop.families()}
    return out, pop.log_z


def _ess_of(logw):
    """Effective sample size of a log-weight vector (Kish; JAX `_ess_of`,
    pa.py:255)."""
    return torch.exp(2.0 * torch.logsumexp(logw, -1)
                     - torch.logsumexp(2.0 * logw, -1))


def _solve_dbeta(logw, e, remaining, target_ess, iters=40):
    """Largest dbeta in [0, remaining] with ESS(logw - dbeta e) >=
    target_ess, by `iters` bisections (JAX `_solve_dbeta`, pa.py:260; 40
    halvings, so the adaptive schedule is the JAX one). All float32
    tensors; no host round trip."""
    hi_ok = _ess_of(logw - remaining * e) >= target_ess
    a = torch.zeros((), dtype=torch.float32, device=logw.device)
    b = remaining
    for _ in range(iters):
        mid = 0.5 * (a + b)
        ok = _ess_of(logw - mid * e) >= target_ess
        a, b = torch.where(ok, mid, a), torch.where(ok, b, mid)
    return torch.where(hi_ok, remaining, a)


def sample_adaptive(problem, beta_end, states, generator, target_frac=0.9,
                    mcsteps=1, max_steps=400, beta0=0.0,
                    resample="systematic"):
    """Adaptive-step population annealing (JAX `sample_adaptive`,
    pa.py:342): each dbeta chosen by `_solve_dbeta` so the incremental ESS
    holds target_frac * R, beta0 -> beta_end in at most max_steps steps,
    resampling every step.

    Returns (states, log_z, stats) with stats {"betas", "ess", "e_mean"
    (n_steps,) numpy, "n_steps", "reached" (the final beta reached
    beta_end: the module docstring's first departure), "families"}."""
    _check_resample(resample)
    dev = problem.device
    r = states.shape[0]
    seed = draw_seed(generator)
    eng = ClassicalEngine(problem, states)
    pop = _Population(r, dev)
    beta_end = torch.tensor(beta_end, dtype=torch.float32, device=dev)
    beta = torch.tensor(beta0, dtype=torch.float32, device=dev)
    target = torch.tensor(target_frac, dtype=torch.float32, device=dev) * r
    betas, ess_s, e_s = [], [], []
    for k in range(int(max_steps)):
        if bool(beta >= beta_end):
            break
        e = eng.energy().to(torch.float32)
        db = _solve_dbeta(pop.logw, e, torch.clamp(beta_end - beta, min=0.0),
                          target)
        beta = beta + db
        pop.logw = pop.logw - db * e
        pop.normalize()
        ess = _ess_of(pop.logw)
        pop.resample(eng, _resample_indices(resample, seed, k, pop.logw,
                                            pop.log_r))
        t = 1.0 / torch.clamp(beta, min=1e-30)
        eng.sweep(t.reshape(1), seed, k * mcsteps, mcsteps)
        betas.append(beta)
        ess_s.append(ess)
        e_s.append(torch.mean(e))
    stats = {
        "betas": _host(betas), "ess": _host(ess_s), "e_mean": _host(e_s),
        "n_steps": len(betas), "reached": bool(beta >= beta_end),
        "families": pop.families()}
    return eng.full(), pop.log_z, stats


def _host(xs):
    """A list of 0-d float32 tensors as a float32 numpy array."""
    if not xs:
        return np.zeros(0, dtype=np.float32)
    return torch.stack(xs).cpu().numpy()


def _host64(x):
    """float64 numpy of a tensor, an array, or a sequence of numbers or 0-d
    tensors (a list of `sample`'s log_z), with no float32 step between."""
    if torch.is_tensor(x):
        return x.detach().cpu().to(torch.float64).numpy()
    try:
        return np.asarray(x, dtype=np.float64)
    except (TypeError, RuntimeError):
        return np.asarray([float(v) for v in x], dtype=np.float64)


def combine_runs(log_zs, observables=None):
    """Combine K independent PA runs (JAX `combine_runs`, pa.py:395; the
    same float64 numpy): log_z, the mean in Z-space; weights prop. to
    exp(log_z_k); run_ess, Kish's effective number of runs; observable,
    weights @ observables when given."""
    lz = _host64(log_zs)
    k = lz.shape[0]
    m = lz.max()
    w = np.exp(lz - m)
    out = {
        "log_z": float(m + np.log(w.sum() / k)),
        "weights": w / w.sum(),
        "run_ess": float(w.sum() ** 2 / (w * w).sum()),
    }
    if observables is not None:
        obs = _host64(observables)
        out["observable"] = tuple(
            float(x) for x in (out["weights"] @ obs).reshape(-1)
        ) if obs.ndim > 1 else float(out["weights"] @ obs)
    return out


def sample_piqmc(problem, gammas, temp, confs, generator, mcsteps=1, b=1.0,
                 gamma0=None, ess_threshold=1.0, resample="systematic",
                 global_moves=False, collect_stats=False):
    """Quantum population annealing over the PIQMC extended ensemble (JAX
    `sample_piqmc`, pa.py:525): R path configurations (R, P, N) sweep down
    the transverse-field schedule `gammas`, reweighted between steps by
    dlogw = (J_perp(G) - J_perp(G_prev)) K / T_eff (T_eff = temp * P, K
    the kinetic term); gamma0 the Gamma of the initial population (None:
    gammas[0]).

    Returns (confs, log_z[, stats {"ess" (S,), "resampled" (S,),
    "families"}])."""
    _check_resample(resample)
    dev = problem.device
    gammas = torch.as_tensor(gammas, dtype=torch.float32, device=dev)
    r = confs.shape[0]
    seed = draw_seed(generator)
    eng = QuantumEngine(problem, confs, temp, b, global_moves,
                        "pa.sample_piqmc")
    teff32 = torch.tensor(eng.teff, dtype=torch.float32, device=dev)
    jps = schedules.jperp(gammas, eng.teff)
    g0 = (torch.tensor([gamma0], dtype=torch.float32, device=dev)
          if gamma0 is not None else gammas[:1])
    jp_prev = schedules.jperp(g0, eng.teff)[0]
    pop = _Population(r, dev)
    thresh = torch.tensor(ess_threshold, dtype=torch.float32,
                          device=dev) * r
    ess_s, rs_s = [], []
    for k in range(gammas.shape[0]):
        jp = jps[k]
        kk = eng.kinetic().to(torch.float32)
        pop.logw = pop.logw + (jp - jp_prev) * kk / teff32
        ess = pop.normalize()
        do_rs = ess < thresh
        pop.resample(eng, _resample_indices(resample, seed, k, pop.logw,
                                            pop.log_r), do_rs)
        eng.sweep(jps[k:k + 1], seed, k * mcsteps, mcsteps)
        jp_prev = jp
        if collect_stats:
            ess_s.append(ess)
            rs_s.append(do_rs)
    out = eng.full()
    if collect_stats:
        return out, pop.log_z, {"ess": torch.stack(ess_s),
                                "resampled": torch.stack(rs_s),
                                "families": pop.families()}
    return out, pop.log_z


def sample_piqmc_adaptive(problem, gamma_start, gamma_end, temp, confs,
                          generator, target_frac=0.9, mcsteps=1,
                          max_steps=400, b=1.0, resample="systematic",
                          global_moves=False):
    """Adaptive-step quantum PA (JAX `sample_piqmc_adaptive`, pa.py:693):
    J_perp from J_perp(gamma_start) up to J_perp(gamma_end), each step
    chosen by `_solve_dbeta` with e = -K / T_eff (the reweight is linear in
    J_perp); the sweeps run at Gamma = T_eff atanh(exp(-2 J_perp / T_eff)),
    clipped as the JAX sampler clips it, and that Gamma's J_perp.

    Returns (confs, log_z, stats {"jps", "ess" (n_steps,) numpy, "n_steps",
    "reached" (the final J_perp reached its end), "families"})."""
    _check_resample(resample)
    dev = problem.device
    r = confs.shape[0]
    eng = QuantumEngine(problem, confs, temp, b, global_moves,
                        "pa.sample_piqmc_adaptive")
    teff, teff32 = eng.teff, torch.tensor(eng.teff, dtype=torch.float32,
                                          device=dev)
    jp = schedules.jperp(torch.tensor([gamma_start], dtype=torch.float32,
                                      device=dev), teff)[0]
    jp_end = schedules.jperp(torch.tensor([gamma_end], dtype=torch.float32,
                                          device=dev), teff)[0]
    if bool(jp_end < jp):
        raise ValueError(
            "annealing direction must increase J_perp (decrease Gamma)")
    seed = draw_seed(generator)
    pop = _Population(r, dev)
    target = torch.tensor(target_frac, dtype=torch.float32, device=dev) * r
    jps, ess_s = [], []
    for k in range(int(max_steps)):
        if bool(jp >= jp_end):
            break
        kk = eng.kinetic().to(torch.float32)
        djp = _solve_dbeta(pop.logw, -kk / teff32,
                           torch.clamp(jp_end - jp, min=0.0), target)
        jp = jp + djp
        pop.logw = pop.logw + djp * kk / teff32
        pop.normalize()
        ess = _ess_of(pop.logw)
        pop.resample(eng, _resample_indices(resample, seed, k, pop.logw,
                                            pop.log_r))
        gamma = teff32 * torch.atanh(torch.clamp(
            torch.exp(-2.0 * jp / teff32), 1e-30, 1.0 - 1e-7))
        eng.sweep(schedules.jperp(gamma.reshape(1), teff), seed,
                  k * mcsteps, mcsteps)
        jps.append(jp)
        ess_s.append(ess)
    stats = {"jps": _host(jps), "ess": _host(ess_s), "n_steps": len(jps),
             "reached": bool(jp >= jp_end), "families": pop.families()}
    return eng.full(), pop.log_z, stats


def merge_populations(states_list, log_zs, generator, r_out=None,
                      draws=None):
    """Resample one population from K independent equally-weighted runs
    (JAX `merge_populations`, pa.py:741): output slot i takes run k with
    probability prop. to exp(log_z_k) (`combine_runs`' weights, as float32)
    and a replica of it uniformly.

    draws: None (the counter hash's MERGE stream, seeded from `generator`),
    or (u_run (r_out,) float32 uniforms, rep_of (r_out,) ints), the JAX
    function's own draws: its `jax.random.choice` takes run searchsorted(
    cumsum(w), cumsum(w)[-1] * (1 - u_run)), and rep_of is its randint.

    Returns (states (r_out, ...), run_of (r_out,) int32)."""
    k = len(states_list)
    r = states_list[0].shape[0]
    if r_out is None:
        r_out = r
    dev = states_list[0].device
    w = torch.tensor(np.asarray(combine_runs(log_zs)["weights"],
                                dtype=np.float32), device=dev)
    if draws is None:
        seed = draw_seed(generator)
        u = cr.sampler_uniforms(seed, 0, cr.MERGE, 2 * r_out, dev)
        u_run = u[0::2]
        rep_of = cr.index_draw(u[1::2], r)
    else:
        u_run = torch.as_tensor(draws[0], dtype=torch.float32, device=dev)
        rep_of = torch.as_tensor(draws[1], device=dev).long()
    cum = torch.cumsum(w, 0)
    run_of = torch.searchsorted(cum, cum[-1] * (1.0 - u_run), side="left")
    run_of = torch.clamp(run_of, max=k - 1)
    stacked = torch.stack(list(states_list))
    return stacked[run_of, rep_of], run_of.to(torch.int32)
