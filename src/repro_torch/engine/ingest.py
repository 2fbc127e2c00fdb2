"""Live data ingestion — the paper's Twitter data-feed analogue (§III-A);
port of ``repro.engine.ingest``.

AsterixDB feeds append to LSM components and maintain indexes online; the
device-resident analogue (engine/lsm.py) is run-based: arriving rows buffer
on the host, flush into *runs* on the session device (block-padded, with
per-run sorted indexes + zone maps built at flush time), and compaction is
*deferred* until the size-ratio policy fires — then one merge folds every
component into the base. Queries see base ∪ runs (the
``UnionRuns`` plan node) — the same data before and after compaction,
exactly like querying an LSM tree across its components. Registered
materialized views refresh incrementally from each flushed delta.

Mutations follow the engine's anti-matter design (AsterixDB §III):

  * ``Feed.delete(keys)`` buffers an anti-matter record per key — at query
    or merge time it annihilates every matter record with that key in
    strictly older components.
  * ``Feed.upsert(rows)`` buffers an anti-matter record for each row's
    primary key plus the fresh matter — newest wins: all older rows with
    the key die, the upserted row survives.

A flush first *normalizes* the buffer (O(batch)): mutations later in the
buffer annihilate matter earlier in the same buffer on the host, so the
flushed run holds only intra-batch survivors plus one tombstone per key
that must still subtract from older components. Flush stays O(batch);
annihilation of older components is bookkeeping (O(tombstones · log n)),
never a rewrite.

On a rank mesh every rank makes the same feed calls with the same batches:
normalization is pure and host-side, so every rank flushes the same run
and keeps its own rows of it (``lsm.make_run``), and every publish commits
on every rank or on none (``lsm._vote``).

With a durable store attached to the session's catalog, every validated
batch is appended to the dataset's feed WAL and fsynced before the ack, and
the covered prefix is truncated only after the covering flush's manifest
commit (``runtime/durable.py``). On a rank mesh the store's writer rank
appends and truncates, and every rank votes after each (the ack vote): a
batch is acked, and buffered, on every rank or on none.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from repro_torch.core.physical_planner import STALL_WARN_FRAC
from repro_torch.engine import lsm
from repro_torch.engine.table import Table, is_lane_column, numpy_dtype
from repro_torch.runtime import telemetry as tel


def stall_delay(pressure: float, max_delay_s: float,
                warn_frac: float = STALL_WARN_FRAC) -> float:
    """Proportional (AsterixDB-style) write-stall delay.

    ``pressure`` is the planner's stall-pressure signal — resident
    components over the stall cap. Below ``warn_frac`` (the same threshold
    the planner flags ``stall_imminent`` at) the delay is zero; above it
    the delay grows linearly, reaching ``max_delay_s`` at pressure 1.0
    (the hard cap) and saturating there. The hard cap itself remains a
    blocking ceiling — this curve only slows the writer down smoothly on
    the approach instead of letting it slam into the cap and block for
    the full timeout."""
    if max_delay_s <= 0.0 or pressure < warn_frac:
        return 0.0
    return max_delay_s * min((pressure - warn_frac) / (1.0 - warn_frac), 1.0)


class Feed:
    def __init__(self, session, dataset: str, dataverse: str = "Default",
                 flush_rows: int = 4096,
                 policy: Optional[lsm.CompactionPolicy] = None,
                 compactor: Optional["lsm.BackgroundCompactor"] = None,
                 stall_runs: Optional[int] = None,
                 stall_timeout_s: float = 5.0,
                 stall_delay_s: float = 0.05):
        """``compactor`` moves compaction off the ingest hot path: flushes
        notify the background worker instead of merging inline, and the
        write-stall policy backpressures THIS writer — never readers.
        Backpressure is proportional: as resident components approach
        ``stall_runs`` (default: 2× the policy's ``max_runs``), each flush
        sleeps up to ``stall_delay_s`` along the planner's stall-pressure
        curve; at the hard cap the writer blocks up to ``stall_timeout_s``
        for the worker to catch up (the ceiling)."""
        self.session = session
        self.dataset = dataset
        self.dataverse = dataverse
        self.flush_rows = flush_rows
        self.policy = policy if policy is not None else lsm.CompactionPolicy()
        self.compactor = compactor
        self.stall_runs = stall_runs if stall_runs is not None \
            else max(2 * self.policy.max_runs, 4)
        self.stall_timeout_s = stall_timeout_s
        self.stall_delay_s = stall_delay_s
        self._buffer: list[tuple[str, object]] = []  # (kind, payload)
        self._buffered = 0
        # the durable feed WAL (runtime/durable.py) when the catalog has a
        # store. ``_replay`` marks cold-start WAL replay: batches arriving
        # through the normal path must not be appended to the log they came
        # from.
        self._store = session.catalog.store
        self._replay = False
        self.stats = {"ingested": 0, "flushes": 0, "compactions": 0,
                      "runs": 0, "run_rows": 0,
                      "upserts": 0, "deletes": 0, "tombstones": 0,
                      "tombstones_flushed": 0, "level_merges": 0,
                      "stalls": 0, "soft_stalls": 0, "stall_s": 0.0}

    # -- ingest ------------------------------------------------------------

    def push(self, rows: dict[str, np.ndarray]) -> None:
        """Append a batch of arriving records (host-side buffer). The batch
        is validated against the dataset schema up front — a malformed batch
        raises here, not deep inside a device merge."""
        self.session._on_owner()
        ds = self.session.catalog.get(self.dataverse, self.dataset)
        rows = _validate_batch(rows, ds.table)
        n = len(next(iter(rows.values())))
        self._wal("push", rows)
        self._buffer.append(("push", rows))
        self._buffered += n
        self.stats["ingested"] += n
        self._maybe_flush()

    def upsert(self, rows: dict[str, np.ndarray]) -> None:
        """Insert-or-replace by primary key: every older record with one of
        the batch's keys is annihilated (anti-matter), the batch's rows
        survive. Duplicate keys *within* the batch resolve newest-wins —
        only each key's last row is kept."""
        self.session._on_owner()
        self._key_column("upsert")  # primary key required; raises without one
        ds = self.session.catalog.get(self.dataverse, self.dataset)
        rows = _validate_batch(rows, ds.table)
        n = len(next(iter(rows.values())))
        self._wal("upsert", rows)
        self._buffer.append(("upsert", rows))
        self._buffered += n
        self.stats["ingested"] += n
        self.stats["upserts"] += n
        self._maybe_flush()

    def delete(self, keys: np.ndarray) -> None:
        """Delete by primary key: buffers one anti-matter record per key.
        Deleting an absent key is a no-op (the tombstone annihilates
        nothing). All matter with the key dies — including duplicates a
        plain ``push`` appended."""
        self.session._on_owner()
        key_col = self._key_column("delete")
        ds = self.session.catalog.get(self.dataverse, self.dataset)
        keys = _validate_keys(keys, ds.table, key_col)
        self._wal("delete", {"__keys__": keys})
        self._buffer.append(("delete", keys))
        self._buffered += len(keys)
        self.stats["deletes"] += len(keys)
        self._maybe_flush()

    def _wal(self, kind: str, payload: dict) -> None:
        """Durability ack: append the validated batch to the dataset's WAL
        and fsync before returning. Runs AFTER validation (a rejected batch
        never reaches the log) and BEFORE buffering (a crash mid-append —
        the ``torn-write`` fault — leaves a CRC-invalid tail and an
        un-acked, un-buffered batch: lost consistently on both sides).
        Without a store the buffer is the only write-ahead state. On a
        rank mesh the append is voted on (``DurableStore.wal_append``): a
        torn append on the writer raises on every rank."""
        if self._store is not None and not self._replay:
            self._store.wal_append(self.dataverse, self.dataset, kind,
                                   payload)

    def _key_column(self, op: str) -> str:
        ds = self.session.catalog.get(self.dataverse, self.dataset)
        primary = ds.primary_index
        if primary is None:
            raise ValueError(
                f"Feed.{op} needs a primary key on "
                f"{self.dataverse}.{self.dataset} (anti-matter records "
                "annihilate by primary key; create the dataset with "
                "primary=<column>)")
        return primary.column

    def _maybe_flush(self) -> None:
        if self._buffered >= self.flush_rows:
            self.flush()

    def flush(self) -> None:
        """Normalize the host buffer (intra-batch newest-wins) and move it
        into a new device-resident run — O(batch): pad + shard + per-run
        index build, never touching the base. Older components only get
        their annihilation bookkeeping updated. Views registered on the
        dataset refresh from the delta (inserts) and the retraction (the
        old rows the tombstones just annihilated); the compaction policy
        may then fold components."""
        self.session._on_owner()
        if not self._buffer:
            return
        t0 = time.perf_counter()
        ds_label = f"{self.dataverse}.{self.dataset}"
        # a cold-start mount rebuilds its soft state at the first bind: the
        # flush reads host keys (annihilation) and the index inventory
        lsm.ensure_soft(self.session, self.dataverse, self.dataset)
        ds = self.session.catalog.get(self.dataverse, self.dataset)
        key_col = ds.primary_index.column if ds.primary_index is not None else None
        # the buffer is the flush's write-ahead state: it is dropped only
        # AFTER the manifest publish succeeds, so a crash at the "flush" or
        # "pre-swap" fault point loses nothing — re-flushing replays the
        # exact same batch (normalization is pure). With a durable store the
        # on-disk WAL mirrors the buffer batch for batch.
        lsm._agreed_fault(self.session, "flush")
        cols, anti_keys = _normalize_buffer(self._buffer, ds.table, key_col)
        if not len(next(iter(cols.values()))) and anti_keys is None:
            self._buffer.clear()
            self._buffered = 0
            return
        if self._store is not None:
            # the WAL sequence this flush covers: every buffered batch was
            # appended at or below the current ack counter. The manifest
            # commit inside register_run embeds it (wal_upto), so the
            # covered prefix is dead for replay even if the truncate below
            # never happens (the pre-wal-truncate crash point).
            self._store.set_wal_coverage(
                self.dataverse, self.dataset,
                self._store.wal_seq(self.dataverse, self.dataset))
        run = lsm.make_run(self.session, ds, Table(cols), anti_keys=anti_keys)
        retracted = lsm.register_run(self.session, ds, run)
        if self._store is not None:
            # strictly after the covering manifest commit
            self._store.wal_truncate(self.dataverse, self.dataset)
        self._buffer.clear()
        self._buffered = 0
        self.session.refresh_views(self.dataverse, self.dataset, cols,
                                   retracted)
        self.stats["flushes"] += 1
        self._refresh_run_stats()
        if anti_keys is not None:  # post-normalization: actually flushed
            self.stats["tombstones_flushed"] += len(anti_keys)
        tel.inc("ingest.flushes_total", dataset=ds_label)
        tel.inc("ingest.flushed_rows_total", run.num_live_rows,
                dataset=ds_label)
        if anti_keys is not None:
            tel.inc("ingest.flushed_tombstones_total", len(anti_keys),
                    dataset=ds_label)
        tel.observe("ingest.flush_seconds", time.perf_counter() - t0,
                    dataset=ds_label)
        tel.set_gauge("ingest.resident_runs", self.stats["runs"],
                      dataset=ds_label)
        # Gauge (not histogram) so the write-stall series is populated —
        # and monotone — even on runs where no stall occurred.
        tel.set_gauge("ingest.stall_seconds_total", self.stats["stall_s"],
                      dataset=ds_label)
        self._apply_policy()

    def drop_buffer(self) -> None:
        """Discard the buffered (un-flushed) batches. Crash recovery uses
        this after a post-swap fault: the manifest already committed the
        flush, so replaying the buffer would double-apply it. With a
        durable store the WAL mirror of the dropped batches is truncated
        too — discard means discard on both sides."""
        self._buffer.clear()
        self._buffered = 0
        if self._store is not None and not self._replay:
            self._store.set_wal_coverage(
                self.dataverse, self.dataset,
                self._store.wal_seq(self.dataverse, self.dataset))
            self._store.wal_truncate(self.dataverse, self.dataset)

    def _refresh_run_stats(self) -> None:
        runs = self.session.catalog.get(self.dataverse, self.dataset).runs
        self.stats["runs"] = len(runs)
        self.stats["run_rows"] = sum(r.num_live_rows for r in runs)
        self.stats["tombstones"] = sum(r.anti_rows for r in runs)

    def _apply_policy(self) -> None:
        """Run the compaction policy to quiescence: leveled merges may
        cascade (an L0 fold can overflow L1), the full fold ends it.

        With a background compactor attached, this only notifies the worker
        — plus write-stall backpressure: as runs pile toward the hard cap
        THIS writer sleeps a proportional delay (the planner's
        stall-pressure curve), and at the cap it blocks until the count
        drops or the stall timeout expires. Readers never block either
        way."""
        if self.compactor is not None:
            self.compactor.notify(self.dataverse, self.dataset)
            runs = self.session.catalog.get(self.dataverse,
                                            self.dataset).runs
            ds_label = f"{self.dataverse}.{self.dataset}"
            if self.stall_runs and len(runs) >= self.stall_runs:
                waited = self.compactor.wait_below(
                    self.dataverse, self.dataset, self.stall_runs,
                    self.stall_timeout_s)
                self.stats["stalls"] += 1
                self.stats["stall_s"] += waited
                tel.inc("ingest.write_stalls_total", dataset=ds_label)
                tel.observe("ingest.write_stall_seconds", waited,
                            dataset=ds_label)
                tel.set_gauge("ingest.stall_seconds_total",
                              self.stats["stall_s"], dataset=ds_label)
                self._refresh_run_stats()
                return
            if self.stall_runs:
                # below the ceiling: proportional backpressure along the
                # same pressure signal the planner gauges (max of what the
                # planner last observed and this dataset's own run count)
                pressure = max(
                    len(runs) / self.stall_runs,
                    float(tel.gauge_value("planner.stall_pressure",
                                          default=0.0) or 0.0))
                delay = stall_delay(pressure, self.stall_delay_s)
                if delay > 0.0:
                    time.sleep(delay)
                    self.stats["soft_stalls"] += 1
                    self.stats["stall_s"] += delay
                    tel.inc("ingest.write_soft_stalls_total",
                            dataset=ds_label)
                    tel.observe("ingest.write_stall_seconds", delay,
                                dataset=ds_label)
                    tel.set_gauge("ingest.stall_seconds_total",
                                  self.stats["stall_s"], dataset=ds_label)
            return
        for _ in range(16):
            m = self.session.catalog.manifest(self.dataverse, self.dataset)
            ds = m.base
            actions = self.policy.plan(lsm._ManifestView(ds, m))
            if not actions:
                return
            act = actions[0]
            if act[0] == "full":
                self.compact()
                return
            _, start, end, level = act
            lsm.merge_runs(self.session, ds, start, end, level, manifest=m)
            self.stats["level_merges"] += 1
            self._refresh_run_stats()

    def compact(self) -> None:
        """Merge base ∪ runs into a fresh base (single newest-wins merge +
        re-sort + index rebuild; annihilated matter and tombstones drop).
        Query results are unchanged — the LSM invariant."""
        self.session._on_owner()
        ds = self.session.catalog.get(self.dataverse, self.dataset)
        if not ds.runs:
            return
        lsm.compact(self.session, ds)
        self.stats["compactions"] += 1
        self.stats["runs"] = 0
        self.stats["run_rows"] = 0
        self.stats["tombstones"] = 0


def _normalize_buffer(buffer, base: Table, key_col: Optional[str]):
    """Resolve one flush's worth of interleaved push/upsert/delete batches
    into (surviving matter columns, sorted unique anti keys or None).

    Newest wins: a matter row survives the buffer iff no strictly LATER
    batch mutated its key; an upsert batch additionally keeps only each
    key's last occurrence. One reverse walk accumulates the kill-set of
    later mutations and masks every matter batch exactly once — O(total ·
    log tombstones), never quadratic in the batch count. The resulting
    anti set applies to strictly OLDER components only — survivors in this
    very flush are newer than the tombstones by construction."""
    kill: Optional[np.ndarray] = None  # sorted unique keys of later mutations
    matter: list[tuple[dict, np.ndarray]] = []  # reversed arrival order
    for kind, payload in reversed(buffer):
        if kind == "delete":
            keys = np.unique(np.asarray(payload))
            kill = keys if kill is None else np.union1d(kill, keys)
            continue
        keys = np.asarray(payload[key_col]) if key_col is not None else None
        if kind == "push":
            n = len(next(iter(payload.values())))
            live = np.ones(n, bool)
        else:  # upsert: last occurrence per key wins within the batch
            n = keys.shape[0]
            live = np.zeros(n, bool)
            _, last_rev = np.unique(keys[::-1], return_index=True)
            live[n - 1 - last_rev] = True
        if kill is not None and keys is not None:
            live &= ~np.isin(keys, kill)
        matter.append((payload, live))
        if kind == "upsert":
            uk = np.unique(keys)
            kill = uk if kill is None else np.union1d(kill, uk)
    matter.reverse()
    schema = [c for c in base.column_names()
              if c not in lsm.INTERNAL_COLUMNS
              and not is_lane_column(c)]
    out: dict[str, np.ndarray] = {}
    for c in schema:
        parts = [np.asarray(cols[c])[m] for cols, m in matter]
        if parts:
            out[c] = np.concatenate(parts, axis=0)
        else:
            tgt = base.columns[c]
            shape = (0,) if tgt.ndim == 1 else (0, tgt.shape[1])
            out[c] = np.zeros(shape, numpy_dtype(tgt.dtype))
    return out, kill


def _validate_keys(keys, base: Table, key_col: str) -> np.ndarray:
    """Validate one delete batch: 1-D, losslessly castable to the primary
    key's stored dtype."""
    a = np.asarray(keys)
    if a.ndim != 1:
        raise ValueError(f"delete keys must be 1-d, got {a.ndim}-d")
    tdt = numpy_dtype(base.columns[key_col].dtype)
    if not np.can_cast(a.dtype, tdt, casting="same_kind"):
        raise ValueError(
            f"delete keys: dtype {a.dtype} is not safely castable to "
            f"primary key dtype {tdt}")
    cast = a.astype(tdt, copy=False)
    if cast.dtype != a.dtype:
        roundtrip = cast.astype(a.dtype, copy=False)
        if not np.array_equal(roundtrip, a,
                              equal_nan=np.issubdtype(a.dtype, np.inexact)):
            raise ValueError(
                f"delete keys do not fit primary key dtype {tdt} "
                f"(lossy narrowing from {a.dtype})")
    return cast


def _validate_batch(rows: dict[str, np.ndarray], base: Table) -> dict[str, np.ndarray]:
    """Schema-check one pushed batch against the stored table: exact column
    set, rectangular, dtypes safely castable, string widths matching.
    Returns the batch cast to the base dtypes, in base column order."""
    schema = [c for c in base.column_names()
              if c not in lsm.INTERNAL_COLUMNS
              and not is_lane_column(c)]
    missing = [c for c in schema if c not in rows]
    extra = [c for c in rows if c not in schema]
    if missing or extra:
        parts = []
        if missing:
            parts.append(f"missing columns {missing}")
        if extra:
            parts.append(f"unexpected columns {extra}")
        raise ValueError(f"feed batch does not match dataset schema: "
                         f"{'; '.join(parts)} (expected {schema})")
    arrays = {c: np.asarray(rows[c]) for c in schema}
    lengths = {c: a.shape[0] for c, a in arrays.items()}
    if len(set(lengths.values())) > 1:
        raise ValueError(f"feed batch has ragged columns: {lengths}")
    out = {}
    for c in schema:
        a = arrays[c]
        tgt = base.columns[c]
        if a.ndim != tgt.ndim:
            raise ValueError(
                f"feed batch column {c!r}: expected {tgt.ndim}-d "
                f"(shape {tuple(tgt.shape[1:])} per row), got {a.ndim}-d")
        if a.ndim == 2 and a.shape[1] != tgt.shape[1]:
            raise ValueError(
                f"feed batch column {c!r}: fixed width {tgt.shape[1]} "
                f"expected, got {a.shape[1]}")
        tdt = numpy_dtype(tgt.dtype)
        if not np.can_cast(a.dtype, tdt, casting="same_kind"):
            raise ValueError(
                f"feed batch column {c!r}: dtype {a.dtype} is not safely "
                f"castable to dataset dtype {tdt}")
        cast = a.astype(tdt, copy=False)
        if cast.dtype != a.dtype:
            # same_kind permits narrowing (int64->int32): admit it only when
            # every value round-trips — a wrapped key would silently corrupt
            # joins/filters downstream, the exact failure this guard exists
            # to surface at push time.
            roundtrip = cast.astype(a.dtype, copy=False)
            if not np.array_equal(roundtrip, a,
                                  equal_nan=np.issubdtype(a.dtype, np.inexact)):
                raise ValueError(
                    f"feed batch column {c!r}: values do not fit dataset "
                    f"dtype {tdt} (lossy narrowing from {a.dtype})")
        out[c] = cast
    return out
