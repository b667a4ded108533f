"""Shared helpers of the value studies (counterpart of
montecarlosolvers_tpu/bench/_common.py): the resume cache keyed on arm
name, persisted as JSON after every completed arm so that an interrupted
study restarts where it left off, and a best-of-2 wall-clock timer after a
warm-up run.

The studies draw from torch.Generators where the JAX studies split and
fold `jax.random` keys: `split(generator, n)` draws n integer seeds (the
part of jax.random.split), and `generator(device, *words)`
(`utils/checkpoint.py`) builds the generator of a tuple of integers (the
part of jax.random.fold_in), so that every arm and every timed repetition
has a stream of its own that does not depend on what ran before it.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from montecarlosolvers_tpu_torch.utils.checkpoint import generator
from montecarlosolvers_tpu_torch.utils.profiling import sync

__all__ = ["by_family", "generator", "make_recorder", "split", "sync",
           "timed"]


def split(generator_, num):
    """`num` integer seeds drawn from `generator_`."""
    return [int(x) for x in torch.randint(
        0, 2 ** 62, (num,), generator=generator_,
        device=generator_.device).tolist()]


def by_family(table, arm):
    """The entry of arm name `arm` in `table`, a dict keyed by arm family
    (a study's RECORD_KEYS): that of the longest family name `arm` starts
    with."""
    return table[max((f for f in table if arm.startswith(f)), key=len)]


def timed(fn, *args):
    """Best-of-2 timed runs of fn(*args, t) for t = 1, 2 after a warm-up
    fn(*args, 0) (kernel builds and first launches land there); each run
    ends with a sync on its result's device. Returns (the last result, the
    smaller wall in seconds)."""
    out = fn(*args, 0)
    sync(out)
    wall, kept = np.inf, out
    for t in (1, 2):
        t0 = time.perf_counter()
        out = fn(*args, t)
        sync(out)
        wall = min(wall, time.perf_counter() - t0)
        kept = out
    return kept, wall


def make_recorder(path, done, budget_s=None):
    """Resume-cache recorder: returns ``record(name, fn)``.

    Cached names return the stored value without running ``fn``; fresh
    names run it, persist the updated ``done`` dict to ``path``, and
    return the result. With ``budget_s`` set, arms starting after the
    budget (measured from this call) are skipped and return None — the
    resume cache makes the next invocation pick them up.
    """
    t_start = time.time()

    def record(name, fn):
        if name in done:
            print(f"{name}: cached {done[name]}", flush=True)
            return done[name]
        if budget_s is not None and time.time() - t_start > budget_s:
            print(f"{name}: skipped (budget)", flush=True)
            return None
        out = fn()
        done[name] = out
        with open(path, "w") as f:
            json.dump(done, f, indent=2)
        print(f"{name}: {out}", flush=True)
        return out

    return record
