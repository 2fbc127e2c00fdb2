"""Storage fault injection (port of the storage half of
``repro.runtime.fault``).

:class:`FaultPlan` schedules deterministic crashes at the LSM engine's named
fault points (``flush`` / ``mid-merge`` / ``pre-swap`` / ``post-swap``) and
at the durable-storage I/O points (``runtime/durable.py``), raising
:class:`StorageFault`. The engine's crash-consistency contract
(``engine/lsm.py`` ``recover``): a crash at ANY point leaves hard state
(matter + tombstone rows, the atomically-swapped manifest) intact and only
soft state (index payloads, zone maps, bookkeeping, view partials)
rebuildable — readers on the old manifest return bit-identical results
throughout, and a reopened store serves exactly the acknowledged batches.

The schedule is a deterministic arrival count, so seeded tests replay
identical failure sequences. The training half of the reference module
(node failures, stragglers, the fault-tolerant training loop) belongs with
training, ROADMAP A10.
"""
from __future__ import annotations

import dataclasses


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
