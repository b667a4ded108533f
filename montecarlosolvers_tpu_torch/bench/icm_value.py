"""ICM value experiment (counterpart of
montecarlosolvers_tpu/bench/icm_value.py): do Houdayer cluster moves + PT
(pt.sample_icm) pay on 3D Edwards-Anderson landscapes at equal WALL-CLOCK
on the card?

  * Instances: 3D EA +/-J, L in {8, 10, 12, 14} periodic
    (models/instances.random_3d_lattice), several disorder seeds with
    several independent repetitions each (hitting times are heavy-tailed).
    T_c ~ 1.1; the ladder's cold end sits at 0.3.
  * Arms per instance: ICM at Houdayer cadences {2, 8, 32} sweeps ({8, 32}
    at the frontier size), and the PT-only baseline, the same sampler with
    houdayer_every=0, so the Houdayer phases are the only difference.
  * Equal wall: every arm runs in SEG-sweep segments with per-segment
    cumulative best energy and wall recorded; the PT baseline runs until
    it has covered the slowest ICM arm's wall.

Every ICM call passes `grid_bonds` (the instance's per-axis bond masks,
`ops/cluster.py::grid_bonds_from_edges`) as the JAX study does; the port's
union-find labeler needs no masks, so they change nothing (`pt.sample_icm`).

The verdict (`summarize`) pairs each ICM run with the PT run of the same
stream index and fixes the JAX study's defect (its line 227): the PT trace
is cut at the paired ICM arm's final wall before the winner is decided,
for the hitting wall and for the best-energy fallback alike, so the
verdict is equal-wall as the study says.

Writes results/h100/icm_value/summary.json (resume-cached by arm name).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from montecarlosolvers_tpu_torch import _device
from montecarlosolvers_tpu_torch.bench._common import (generator,
                                                       make_recorder, split)
from montecarlosolvers_tpu_torch.models import instances
from montecarlosolvers_tpu_torch.ops.cluster import grid_bonds_from_edges
from montecarlosolvers_tpu_torch.solvers import pt, sa

L_SIZES = (8, 10, 12, 14)
SEEDS_BY_L = {8: (0, 1, 2, 3, 4), 10: (0, 1, 2, 3, 4),
              12: (0, 1, 2, 3, 4), 14: (0, 1, 2, 3, 4)}
RUNGS = 24
SEG = 500            # sweeps per segment
# deeper runs for the harder sizes (per-L segment count)
ICM_SEGS = {8: 8, 10: 12, 12: 36, 14: 48}
# cadence h2 pays double cluster overhead; at the frontier size keep the
# cadences the smaller sizes showed to be competitive
CADENCES_BY_L = {8: (2, 8, 32), 10: (2, 8, 32), 12: (2, 8, 32),
                 14: (8, 32)}
# independent repetitions per (instance, arm): the verdict aggregates
# PAIRED (icm, pt) hitting times over seeds x reps
REPS = {8: 1, 10: 3, 12: 5, 14: 3}
T_COLD, T_HOT = 0.3, 1.6
# the PT baseline's segment cap (a mis-measured wall cannot run away)
PT_MAX_SEGS = 400
# ladder tuning: sweeps a round (the JAX study's 3 rounds of 200)
TUNE_SWEEPS = 200
# the keys of each arm family's record (`_common.by_family`), and of
# each segment of an icm or pt arm's
RECORD_KEYS = {"tune": {"temps", "pair_rate_min", "pair_rate_mean"},
               "icm": {"segments"}, "pt": {"segments"}}
SEGMENT_KEYS = {"wall_s", "sweeps", "e_best", "e_cold", "swap_rate",
                "h_frac"}


def _run_segments(problem, temps, s0, generator_, n_segs, houdayer_every,
                  max_wall=None, grid_bonds=None):
    """Run sample_icm in SEG-sweep segments, carrying states, each segment
    on the next seed `generator_` gives; returns a per-segment record list
    and the final states. Stops early once max_wall (seconds of
    accumulated measured wall) is reached."""
    states = s0
    recs = []
    e_best = np.inf
    wall = 0.0
    for seg in range(n_segs):
        t0 = time.perf_counter()
        states, rate, hfrac, es = pt.sample_icm(
            problem, temps, states, generator_, SEG, swap_every=2,
            houdayer_every=houdayer_every, collect_energy=True,
            grid_bonds=grid_bonds,
        )
        es = es.cpu().numpy()  # (SEG, 2, M) rung-ordered; the fetch syncs
        dt = time.perf_counter() - t0
        wall += dt
        e_best = min(e_best, float(es.min()))
        recs.append(dict(
            wall_s=round(wall, 3),
            sweeps=(seg + 1) * SEG,
            e_best=e_best,
            e_cold=float(es[SEG // 2:, :, 0].mean()),
            swap_rate=float(rate),
            h_frac=float(hfrac),
        ))
        if max_wall is not None and wall >= max_wall:
            break
    return recs, states


def run_instance(L, seed, generator_, record):
    dev = generator_.device
    problem, (rows, cols, vals) = instances.random_3d_lattice(
        L, rng=seed, dist="pm1", device=dev
    )
    gb = grid_bonds_from_edges((L, L, L), rows, cols, vals, device=dev)
    n = problem.nspins
    k_init, k_tune, k_run = split(generator_, 3)
    s0 = sa.random_state(generator(dev, k_init), n, batch=(2, RUNGS),
                         device=dev)

    def arm_tune():
        temps0 = pt.geometric_ladder(T_COLD, T_HOT, RUNGS, device=dev)
        temps, pair_rates = pt.tune_ladder(
            problem, temps0, generator(dev, k_tune), rounds=3,
            sweeps_per_round=TUNE_SWEEPS
        )
        return dict(
            temps=[float(t) for t in temps.cpu().numpy()],
            pair_rate_min=float(np.min(pair_rates)),
            pair_rate_mean=float(np.mean(pair_rates)),
        )

    tune = record(f"tune_L{L}_s{seed}", arm_tune)
    if tune is None:
        return
    temps = np.asarray(tune["temps"], np.float32)

    # --- ICM arms, one per cadence x rep --------------------------------
    max_wall = 0.0
    for h in CADENCES_BY_L[L]:
        for rep in range(REPS[L]):
            def arm_icm(h=h, rep=rep):
                # a warm segment (kernel builds) outside the recorded walls
                _run_segments(problem, temps, s0,
                              generator(dev, k_run, 9000 + h), 1, h,
                              grid_bonds=gb)
                recs, _ = _run_segments(
                    problem, temps, s0,
                    generator(dev, k_run, 1000 * rep + h),
                    ICM_SEGS[L], h, grid_bonds=gb,
                )
                return dict(segments=recs)

            suffix = f"_r{rep}" if rep else ""
            out = record(f"icm_h{h}_L{L}_s{seed}{suffix}", arm_icm)
            if out:
                max_wall = max(max_wall, out["segments"][-1]["wall_s"])

    # --- PT baseline: same code path, no Houdayer, run to max ICM wall --
    for rep in range(REPS[L]):
        def arm_pt(rep=rep):
            _run_segments(problem, temps, s0, generator(dev, k_run, 9999), 1,
                          0)
            # cover the slowest ICM arm's wall with margin
            recs, _ = _run_segments(
                problem, temps, s0,
                generator(dev, k_run, 1000 * rep + 7),
                n_segs=PT_MAX_SEGS, houdayer_every=0,
                max_wall=max(max_wall * 1.1, 1.0),
            )
            return dict(segments=recs)

        suffix = f"_r{rep}" if rep else ""
        record(f"pt_L{L}_s{seed}{suffix}", arm_pt)


def _arm_keys(done, prefix):
    """All rep keys for an arm, rep 0 unsuffixed (resume-compat)."""
    keys = [k for k in done
            if k == prefix or k.startswith(prefix + "_r")]
    return sorted(keys)


def within_wall(recs, wall):
    """The segments of a trace that ended by `wall` seconds."""
    return [r for r in recs if r["wall_s"] <= wall]


def summarize(done):
    """Paired equal-wall verdict: per (L, cadence), every (seed, rep)
    pairs one ICM run with the PT run of the same stream index; the PT
    trace is cut at that ICM run's final wall (`within_wall`); the pair's
    winner is decided by ground-state hitting (reached or not, then the
    wall to the reference energy at segment granularity), else by the best
    energy each reached by that wall (a PT run with no segment inside the
    wall has found nothing by then). The verdict is the paired win count
    plus median hitting walls over all pairs."""
    out = {}
    for L in L_SIZES:
        n = L ** 3
        for h in CADENCES_BY_L[L]:
            pairs = []
            h_fracs = []
            for seed in SEEDS_BY_L[L]:
                pt_keys = _arm_keys(done, f"pt_L{L}_s{seed}")
                icm_keys = _arm_keys(done, f"icm_h{h}_L{L}_s{seed}")
                if not pt_keys or not icm_keys:
                    continue
                # instance reference energy: the best ANY arm of ANY
                # cadence ever found on this (L, seed)
                e_ref = np.inf
                tag = f"_L{L}_s{seed}"
                for k, v in done.items():
                    if (isinstance(v, dict) and "segments" in v
                            and (k.endswith(tag) or f"{tag}_r" in k)):
                        e_ref = min(
                            e_ref, min(r["e_best"] for r in v["segments"])
                        )

                def wall_to_ref(recs):
                    for rec in recs:
                        if rec["e_best"] <= e_ref:
                            return rec["wall_s"]
                    return None

                for ik, pk in zip(icm_keys, pt_keys):
                    i_recs = done[ik]["segments"]
                    p_recs = within_wall(done[pk]["segments"],
                                         i_recs[-1]["wall_s"])
                    i_ttr = wall_to_ref(i_recs)
                    p_ttr = wall_to_ref(p_recs)
                    i_eps = (i_recs[-1]["e_best"] - e_ref) / n
                    p_eps = ((p_recs[-1]["e_best"] - e_ref) / n if p_recs
                             else np.inf)
                    h_fracs.append(i_recs[-1]["h_frac"])
                    if i_ttr is not None and p_ttr is None:
                        win = "icm"
                    elif p_ttr is not None and i_ttr is None:
                        win = "pt"
                    elif i_ttr is not None and p_ttr is not None:
                        win = ("icm" if i_ttr < p_ttr
                               else "pt" if p_ttr < i_ttr else "tie")
                    else:
                        win = ("icm" if i_eps < p_eps
                               else "pt" if p_eps < i_eps else "tie")
                    pairs.append(dict(
                        pair=f"s{len(pairs)}", icm_ttr=i_ttr, pt_ttr=p_ttr,
                        icm_eps=round(i_eps, 6),
                        pt_eps=(round(p_eps, 6) if np.isfinite(p_eps)
                                else None),
                        winner=win,
                    ))
            if not pairs:
                continue
            wins = [p["winner"] for p in pairs]
            i_hits = [p["icm_ttr"] for p in pairs if p["icm_ttr"] is not None]
            p_hits = [p["pt_ttr"] for p in pairs if p["pt_ttr"] is not None]
            out[f"L{L}_h{h}"] = dict(
                pairs=len(pairs),
                icm_wins=wins.count("icm"),
                pt_wins=wins.count("pt"),
                ties=wins.count("tie"),
                icm_hit_frac=round(len(i_hits) / len(pairs), 3),
                pt_hit_frac=round(len(p_hits) / len(pairs), 3),
                icm_median_ttr=(round(float(np.median(i_hits)), 3)
                                if i_hits else None),
                pt_median_ttr=(round(float(np.median(p_hits)), 3)
                               if p_hits else None),
                h_frac_mean=round(float(np.mean(h_fracs)), 4),
            )
    return out


def main(outdir="results/h100/icm_value", budget_s=2400, device=None):
    dev = _device.resolve(device)
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "summary.json")
    done = {}
    if os.path.exists(path):
        with open(path) as f:
            done = json.load(f)
    record = make_recorder(path, done, budget_s=budget_s)

    for L in L_SIZES:
        for seed in SEEDS_BY_L[L]:
            run_instance(L, seed, generator(dev, 5, 100 * L + seed), record)

    done["equal_wall_verdicts"] = summarize(done)
    with open(path, "w") as f:
        json.dump(done, f, indent=2)
    print(json.dumps(done["equal_wall_verdicts"], indent=2))
    return done


if __name__ == "__main__":
    main()
