"""Fault injection and the fault-tolerant training loop (port of
``repro.runtime.fault``).

Two fault surfaces share this module:

* **storage**: :class:`FaultPlan` schedules deterministic crashes at the
  LSM engine's named fault points (``flush`` / ``mid-merge`` /
  ``pre-swap`` / ``post-swap``) and at the durable-storage I/O points
  (``runtime/durable.py``), raising :class:`StorageFault`. The engine's
  crash-consistency contract (``engine/lsm.py`` ``recover``): a crash at
  ANY point leaves hard state (matter + tombstone rows, the
  atomically-swapped manifest) intact and only soft state (index
  payloads, zone maps, bookkeeping, view partials) rebuildable — readers
  on the old manifest return bit-identical results throughout, and a
  reopened store serves exactly the acknowledged batches.

* **training**: :class:`FailureInjector` schedules node failures, NaN
  batches and stragglers by step, driving :class:`FaultTolerantLoop`
  (checkpoint and rollback, NaN recovery, straggler deadlines). On a pod
  the failure signal is a missing heartbeat or a collective timeout; here
  the injector raises on schedule, so tests run the same recovery code.

Both schedules are deterministic, so seeded tests replay identical
failure sequences.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.tree import tree_map


class NodeFailure(RuntimeError):
    pass


class Straggler(RuntimeError):
    pass


class StorageFault(RuntimeError):
    """An injected storage-layer crash, raised by FaultPlan at a named
    engine fault point."""


# The LSM engine's named crash points, in flush/merge order of occurrence:
#   flush      — before the buffered batch becomes a run (buffer intact)
#   mid-merge  — while a compaction builds fresh components (old set intact)
#   pre-swap   — after the build, before the atomic manifest publish
#   post-swap  — after the publish, before the soft-state bookkeeping
STORAGE_FAULT_POINTS = ("flush", "mid-merge", "pre-swap", "post-swap")

# The durable-storage I/O crash points (runtime/durable.py), in write-path
# order:
#   torn-write       — half a segment/WAL payload is on disk (CRC-detected)
#   pre-rename       — manifest tmp fully written + fsynced, not yet renamed
#                      into place (previous generation still authoritative)
#   pre-wal-truncate — manifest generation committed, covered WAL records
#                      not yet dropped (replay skips them by sequence)
#   mid-replay       — between replayed WAL batches during Session.open
IO_FAULT_POINTS = ("torn-write", "pre-rename", "pre-wal-truncate",
                   "mid-replay")


@dataclasses.dataclass
class FaultPlan:
    """Deterministic storage fault schedule over named crash points, by Nth
    arrival at a point.

    ``schedule`` maps a point name to the arrival indices (0-based) that
    crash, or ``True`` to crash on every arrival. Each passage of a fault
    point counts one arrival whether or not it fires, so a retry after an
    injected crash proceeds past a one-shot fault — how the
    BackgroundCompactor's bounded-retry loop recovers."""

    schedule: dict[str, object] = dataclasses.field(default_factory=dict)
    seen: dict[str, int] = dataclasses.field(default_factory=dict)
    fired: list[tuple[str, int]] = dataclasses.field(default_factory=list)

    @classmethod
    def once(cls, point: str, arrival: int = 0) -> "FaultPlan":
        """Crash exactly once: on the ``arrival``-th passage of ``point``."""
        return cls(schedule={point: (arrival,)})

    def check(self, point: str) -> None:
        """Count one arrival at ``point``; raise StorageFault if scheduled."""
        i = self.seen.get(point, 0)
        self.seen[point] = i + 1
        hits = self.schedule.get(point)
        if hits is True or (hits is not None and i in hits):
            self.fired.append((point, i))
            raise StorageFault(
                f"injected storage fault at {point} (arrival {i})")

    def reset(self) -> None:
        self.seen.clear()
        self.fired.clear()


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure schedule: {step: kind} with kind in
    {"node", "nan", "straggler"}; each step fires once."""

    schedule: dict[int, str] = dataclasses.field(default_factory=dict)
    fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        kind = self.schedule.get(step)
        if kind is None or step in self.fired:
            return None
        self.fired.add(step)
        return kind


@dataclasses.dataclass
class TrainLoopConfig:
    ckpt_every: int = 10
    max_retries_per_step: int = 3
    step_deadline_s: float = 0.0  # 0 = disabled; >0 enables straggler check


# the leaves numpy counts as floating: the reference poisons only these, so
# a bf16 leaf (frames, patches) and an int-only batch pass untouched
_POISONED = (torch.float16, torch.float32, torch.float64)


def _poison(x):
    """A float16/32/64 leaf times NaN, in its own dtype; any other leaf as
    it is (the reference's rule: ``np.issubdtype(dtype, np.floating)``,
    which bf16 does not pass)."""
    if isinstance(x, torch.Tensor):
        return (x.float() * float("nan")).to(x.dtype) \
            if x.dtype in _POISONED else x
    a = np.asarray(x)
    return (a.astype(np.float32) * np.nan).astype(a.dtype) \
        if np.issubdtype(a.dtype, np.floating) else x


class TreeState:
    """How :class:`FaultTolerantLoop` checkpoints functional steps (the
    reference's contract: ``params`` and ``opt_state`` are trees of
    tensors and each step returns new ones). A checkpoint holds
    ``{"params": params, "opt": opt_state}``; a rollback returns the
    restored trees, each leaf on the device of the leaf it replaces."""

    def tree(self, params, opt_state):
        return {"params": params, "opt": opt_state}

    def restore(self, ckpt: CheckpointManager, params, opt_state):
        like = self.tree(params, opt_state)
        step, state = ckpt.restore(None, like, device="cpu")
        state = tree_map(lambda new, old: new.to(old.device)
                         if isinstance(old, torch.Tensor) else new, state, like)
        return step, state["params"], state["opt"]


class FaultTolerantLoop:
    """Drives (params, opt_state) through ``train_step`` with recovery.

    ``data_iter_factory(start_step)`` must return an iterator positioned at
    ``start_step``: deterministic data order is what makes rollback exact
    (the fast-skip the paper-scale systems use). ``state`` says what a
    checkpoint holds and how a rollback puts it back: :class:`TreeState`
    (the default) for functional steps, ``launch.train.ModelState`` for
    the port's in-place steps on a model.

    ``spans`` records each step (``ok`` False for a failed one), each
    snapshot handed to a save and each rollback, with host-clock stamps;
    the checkpoint manager's ``spans`` hold the rest."""

    def __init__(self, train_step: Callable, ckpt: CheckpointManager,
                 cfg: Optional[TrainLoopConfig] = None,
                 injector: Optional[FailureInjector] = None,
                 state: Any = None):
        self.train_step = train_step
        self.ckpt = ckpt
        # one per instance: a shared default instance would be mutable
        # across every loop
        self.cfg = cfg if cfg is not None else TrainLoopConfig()
        self.injector = injector or FailureInjector()
        self.state = state if state is not None else TreeState()
        self.events: list[tuple[int, str]] = []
        self.spans: list[dict] = []

    def _span(self, name: str, step: int, t0: float, **kw) -> None:
        self.spans.append({"span": name, "step": step, "t0": t0,
                           "t1": time.perf_counter(), **kw})

    def _save(self, step: int, params, opt_state, wait: bool = False) -> None:
        t0 = time.perf_counter()
        tree = self.state.tree(params, opt_state)
        self._span("snapshot", step, t0)
        self.ckpt.save(step, tree, wait=wait)

    def run(self, params: Any, opt_state: Any, data_iter_factory: Callable,
            num_steps: int, start_step: int = 0):
        step = start_step
        it = data_iter_factory(step)
        metrics_log = []
        retries = 0
        # step 0 checkpoint so the first rollback has a target
        self._save(step, params, opt_state, wait=True)
        while step < num_steps:
            t_try = time.perf_counter()
            try:
                kind = self.injector.check(step)
                if kind == "node":
                    raise NodeFailure(f"injected node failure at step {step}")
                if kind == "straggler":
                    raise Straggler(f"injected straggler at step {step}")
                t0 = time.perf_counter()
                batch = next(it)
                if kind == "nan":  # poison the batch -> NaN loss path
                    batch = tree_map(_poison, batch)
                params, opt_state, metrics = self.train_step(params, opt_state,
                                                             batch)
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at step {step}")
                if self.cfg.step_deadline_s and \
                        time.perf_counter() - t0 > self.cfg.step_deadline_s:
                    raise Straggler(f"step {step} exceeded deadline")
                self._span("step", step, t_try, ok=True)
                metrics_log.append((step, loss))
                step += 1
                retries = 0
                if step % self.cfg.ckpt_every == 0:
                    self._save(step, params, opt_state)
            except (NodeFailure, Straggler, FloatingPointError) as e:
                self._span("step", step, t_try, ok=False)
                retries += 1
                self.events.append((step, f"{type(e).__name__}: {e}"))
                if retries > self.cfg.max_retries_per_step:
                    raise RuntimeError(
                        f"step {step} failed {retries} times; giving up") from e
                # rollback: latest good checkpoint + iterator fast-skip
                t1 = time.perf_counter()
                step, params, opt_state = self.state.restore(self.ckpt, params,
                                                             opt_state)
                self._span("rollback", step, t1)
                it = data_iter_factory(step)
        self._save(step, params, opt_state, wait=True)
        return params, opt_state, metrics_log
