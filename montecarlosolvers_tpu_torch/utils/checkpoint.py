"""Checkpoint and resume for long anneals (counterpart of
montecarlosolvers_tpu/utils/checkpoint.py).

The schedule runs in segments, and (segment index, state) is written
after each to a `.npz` with the JAX package's keys (`seg_idx`, `state`),
by an atomic `os.replace`: the port resumes from a state file the JAX
package wrote, and the other way round. Where the JAX segments take
`jax.random.fold_in(key, i)`, the port's take a torch.Generator seeded
from (seed, i) (`generator`), so a resumed run equals the uninterrupted
segmented run bitwise.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from montecarlosolvers_tpu_torch import _device


def save_neighbor_table(path, nbs):
    """Cache a compiled neighbor table (tools.pyx:94-95 analog)."""
    np.save(path, np.asarray(nbs))


def load_neighbor_table(path):
    return np.load(path)


def validate_state(state, domain="ising"):
    """Failure detection for long runs: raise if a state left its domain
    (NaNs from a bad schedule, a corrupted restore, ...). domain: "ising"
    (+/-1) or "angles" ([0, pi]). Takes numpy arrays or tensors; returns
    `state`."""
    arr = np.asarray(state.cpu() if torch.is_tensor(state) else state)
    if not np.isfinite(arr).all():
        raise FloatingPointError("state contains non-finite values")
    if domain == "ising":
        if not np.isin(arr, (-1.0, 1.0)).all():
            raise ValueError("ising state left the +/-1 domain")
    elif domain == "angles":
        if arr.min() < -1e-6 or arr.max() > np.pi + 1e-6:
            raise ValueError("angle state left [0, pi]")
    return state


def generator(device, *words):
    """A torch.Generator on `device` seeded from the integers `words`, mixed
    by numpy's SeedSequence: segment i of a run of seed s draws from
    generator(device, s, i)."""
    seed = np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


class CheckpointedAnneal:
    """Run any schedule-scanned solver in resumable segments.

    >>> ck = CheckpointedAnneal("run.npz", segment=50_000)
    >>> out = ck.run(lambda seg, s, g: sa.anneal(problem, seg, s, g),
    ...              sched, s0, seed=0)

    After a crash, re-running the same call resumes from the last
    completed segment. With validate="ising" / "angles", each segment is
    domain-checked before the snapshot is written (a corrupt segment never
    overwrites a good one).
    """

    def __init__(self, path, segment=100_000, validate=None):
        self.path = path
        self.segment = int(segment)
        self.validate = validate

    def _load(self):
        if not os.path.exists(self.path):
            return None
        d = np.load(self.path, allow_pickle=False)
        return int(d["seg_idx"]), d["state"]

    def _save(self, seg_idx, state):
        if torch.is_tensor(state):
            state = state.cpu().numpy()
        tmp = self.path + ".tmp.npz"
        with open(tmp, "wb") as f:
            np.savez(f, seg_idx=seg_idx, state=np.asarray(state))
        os.replace(tmp, self.path)  # atomic: a crash never corrupts

    def run(self, solver_fn, sched, state, seed, verbose=False):
        """solver_fn(sched_segment, state, generator) -> new state.

        sched: (steps,) numpy or tensor; state: a tensor on the run's
        device; seed: the run's integer seed. Segment i takes
        sched[i * segment:(i + 1) * segment] (a float32 tensor on the
        state's device) and `generator(device, seed, i)`. Returns the final
        state."""
        dev = state.device if torch.is_tensor(state) else _device.resolve(
            None)
        sched = np.asarray(sched.cpu() if torch.is_tensor(sched) else sched,
                           dtype=np.float32)
        n_seg = max(1, -(-sched.shape[0] // self.segment))
        start = 0
        loaded = self._load()
        if loaded is not None:
            start, state_np = loaded
            state = torch.as_tensor(state_np, device=dev)
            if verbose:
                print(f"resuming from segment {start}/{n_seg}")
        for i in range(start, n_seg):
            seg = torch.as_tensor(
                sched[i * self.segment:(i + 1) * self.segment], device=dev)
            state = solver_fn(seg, state, generator(dev, seed, i))
            if self.validate is not None:
                validate_state(state, self.validate)
            self._save(i + 1, state)
            if verbose:
                print(f"segment {i + 1}/{n_seg} checkpointed")
        return state

    def clear(self):
        if os.path.exists(self.path):
            os.remove(self.path)
