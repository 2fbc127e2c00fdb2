"""The catalog: datasets, indexes and their manifests (port of
``repro.core.catalog``).

A ``Dataset`` owns a :class:`~repro_torch.engine.table.Table` plus any
indexes. ``closed`` datasets have a declared schema (typed dense columns);
``open`` datasets simulate schema-on-read: integer values are stored widened
to float32 and every access pays a cast (the paper's "AFrame" vs "AFrame
Schema").

Concurrency model (snapshot-isolated serving), as in the reference:

  * every dataset's component set — the base table plus its LSM runs — is
    described by an immutable, LSN-stamped :class:`Manifest`. A writer
    builds fresh components off the hot path and **publishes** a new
    manifest under the catalog lock; the old one is **retired**.
  * readers capture :meth:`Catalog.snapshot` (O(datasets) metadata) and
    plan, compile and execute against the pinned manifests, so a concurrent
    flush or compaction never changes what a bound plan reads.
  * runs are addressed by stable ids ``"<ds>@run<uid>"``; uids are per
    dataset, monotone and never reused.

Reclaiming a retired, unpinned, engine-owned component drops the catalog's
references to its tensors (the caching allocator then reuses the memory);
a component a pinned snapshot still reaches is never touched.

With a durable store attached (``runtime/durable.py``), every publish also
commits a manifest generation to disk and reclamation unlinks the segment
files no kept generation references.

On a mesh of ``torch.distributed`` ranks each rank has its own catalog,
and every rank makes the same calls in the same order, so run uids and
LSNs advance alike on every rank. The engine votes before each publish
(``engine/lsm._vote``): a CAS that fails, or a fault that fires, on one
rank aborts the swap on all of them, and every rank holds the same
manifests. With a durable store the ranks share one store: its commit,
inside each publish, is voted on too (``runtime/durable.py``), so a crash
before the manifest rename stops the publish on every rank; segment GC
unlinks on the store's writer rank only.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Optional

import numpy as np
import torch

from repro_torch.engine.table import ColumnMeta, Table, is_lane_column
from repro_torch.runtime import telemetry as tel

# Engine-internal per-row columns that never surface in query envs, schemas
# or statistics: the padding/validity mask and the anti-matter flag.
INTERNAL_COLUMNS = ("__valid__", "__antimatter__")


@dataclasses.dataclass
class IndexInfo:
    name: str
    column: str
    kind: str  # "primary" (clustered: table sorted by column) | "secondary"
    # payload: sorted keys + row ids + per-ZONE_BLOCK zone maps of the
    # sorted keys (soft state, rebuildable from the table columns)
    sorted_keys: Optional[torch.Tensor] = None
    row_ids: Optional[torch.Tensor] = None
    zone_min: Optional[torch.Tensor] = None
    zone_max: Optional[torch.Tensor] = None


@dataclasses.dataclass(eq=False)  # identity semantics, as the reference
class Dataset:
    name: str
    dataverse: str
    table: Table
    closed: bool = True
    indexes: dict[str, IndexInfo] = dataclasses.field(default_factory=dict)
    live_rows: Optional[int] = None  # matter-row count (None -> len(table))
    # -- anti-matter bookkeeping (see the reference) ------------------------
    anti_rows: int = 0                       # tombstones this component holds
    anti_keys_arr: Optional[torch.Tensor] = None  # sorted device anti keys
    host_anti_keys: Optional[np.ndarray] = None   # host copy of the same
    annihilated_rows: int = 0                # own matter shadowed by newer anti
    annihilated_keys: set = dataclasses.field(default_factory=set)
    host_keys: Optional[np.ndarray] = None   # sorted matter primary keys
    level: int = 0                           # LSM level (leveled compaction)
    # per-ZONE_BLOCK [min, max] zone maps of every numeric column
    # (core/stats.py BlockZones), harvested at load / flush / compaction
    block_zones: Optional[object] = None
    uid: int = -1                            # stable run id; -1 for bases
    manifest: Optional["Manifest"] = None    # current manifest of a base
    # True for components whose tensors the engine built and owns
    # exclusively (flush-built runs, compaction-built bases): only these are
    # reclaimed eagerly; a user-loaded base may share its tensors.
    engine_owned: bool = False
    # durable segment file name (runtime/durable.py) once this component's
    # hard state is on disk; None while memory-only. Set by
    # DurableStore.write_component and at cold-start mount, so a re-publish
    # never rewrites a segment.
    seg_name: Optional[str] = None
    # True while this component's soft state (index payloads, zone maps,
    # host key copies, anti arrays, annihilation bookkeeping) awaits its
    # rebuild after a cold-start mount; lsm.ensure_soft clears it at the
    # first bind.
    soft_stale: bool = False

    @property
    def runs(self) -> list["Dataset"]:
        """The dataset's CURRENT LSM runs (a copy: mutating it changes
        nothing)."""
        if self.manifest is None:
            return []
        return list(self.manifest.runs)

    @property
    def num_live_rows(self) -> int:
        """Visible matter rows: physical matter minus rows newer anti-matter
        has annihilated."""
        matter = self.live_rows if self.live_rows is not None \
            else self.table.global_rows
        return max(matter - self.annihilated_rows, 0)

    def index_on(self, column: str) -> Optional[IndexInfo]:
        for ix in self.indexes.values():
            if ix.column == column:
                return ix
        return None

    @property
    def primary_index(self) -> Optional[IndexInfo]:
        for ix in self.indexes.values():
            if ix.kind == "primary":
                return ix
        return None


@dataclasses.dataclass
class Manifest:
    """One immutable description of a dataset's component set: the base
    plus the ordered run list (oldest → newest), stamped with the
    catalog-global LSN of its publish. ``pins`` counts live snapshots."""

    lsn: int
    base: Dataset
    runs: tuple = ()
    retired: bool = False
    pins: int = 0

    @property
    def components(self) -> tuple:
        """(base, run_0, ..., run_n) — oldest to newest."""
        return (self.base,) + tuple(self.runs)


def _component_tensors(ds: Dataset) -> list[torch.Tensor]:
    out = list(ds.table.columns.values())
    if ds.anti_keys_arr is not None:
        out.append(ds.anti_keys_arr)
    for ix in ds.indexes.values():
        out += [a for a in (ix.sorted_keys, ix.row_ids, ix.zone_min,
                            ix.zone_max) if a is not None]
    return out


def component_nbytes(ds: Dataset) -> int:
    """Device bytes one component holds: table columns, index payloads and
    the sorted anti-key array (metadata only, no device work)."""
    return sum(int(t.numel()) * t.element_size() for t in _component_tensors(ds))


def _delete_component_buffers(ds: Dataset) -> None:
    """Drop the catalog's references to one component's tensors (table
    columns, anti keys, index payloads). Host copies stay: they are cheap
    and nothing reads a retired component's."""
    ds.table.columns.clear()
    ds.anti_keys_arr = None
    for ix in ds.indexes.values():
        ix.sorted_keys = ix.row_ids = ix.zone_min = ix.zone_max = None


def _resolve_run(manifest: Manifest, dataverse: str, base_name: str,
                 comp: str) -> Dataset:
    """Resolve a component address suffix ("run<uid>") against one manifest;
    KeyError for malformed suffixes, unknown uids and retired runs alike."""
    if comp.startswith("run"):
        try:
            uid = int(comp[3:])
        except ValueError:
            raise KeyError(
                f"malformed LSM component address {dataverse}.{base_name}"
                f"@{comp}: expected '@run<uid>'") from None
        for r in manifest.runs:
            if r.uid == uid:
                return r
    raise KeyError(f"unknown LSM component {dataverse}.{base_name}@{comp}")


class Snapshot:
    """A pinned view of the catalog at one LSN. Duck-types the catalog's
    read surface (``get`` / ``components`` / ``manifest`` /
    ``stats_epoch``) so every layer binds it without knowing."""

    def __init__(self, catalog: "Catalog", manifests: dict,
                 stats_epoch: int, lsn: int):
        self._catalog = catalog
        self._manifests = manifests  # (dataverse, name) -> Manifest
        self.stats_epoch = stats_epoch
        self.lsn = lsn
        self._released = False

    def manifest(self, dataverse: str, name: str) -> Manifest:
        key = (dataverse, name)
        if key not in self._manifests:
            raise KeyError(f"unknown dataset {dataverse}.{name}")
        return self._manifests[key]

    def components(self, dataverse: str, name: str) -> tuple:
        return self.manifest(dataverse, name).components

    def get(self, dataverse: str, name: str) -> Dataset:
        if "@" in name:  # stable component address: "<dataset>@run<uid>"
            base_name, _, comp = name.partition("@")
            return _resolve_run(self.manifest(dataverse, base_name),
                                dataverse, base_name, comp)
        return self.manifest(dataverse, name).base

    def names(self) -> list[str]:
        """The pinned datasets' ``"dataverse.name"`` keys."""
        return [f"{dv}.{n}" for dv, n in self._manifests]

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        with self._catalog.lock:
            for m in self._manifests.values():
                m.pins -= 1
        if self._catalog._retired:
            self._catalog._reclaim()
            self._catalog.gc_stats()

    def __enter__(self) -> "Snapshot":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class Catalog:
    def __init__(self):
        self._datasets: dict[tuple[str, str], Dataset] = {}
        # bumped on every event that changes what statistics describe (DDL,
        # flush, compaction); compiled plans are keyed by (epoch, LSN)
        self.stats_epoch: int = 0
        self.lsn: int = 0
        self._lock = threading.RLock()
        self._run_uids: dict[tuple[str, str], int] = {}
        # retired manifests still alive, weakly held (tracking must not
        # itself retain them)
        self._retired: "weakref.WeakValueDictionary[int, Manifest]" = \
            weakref.WeakValueDictionary()
        # the durable store (runtime/durable.py DurableStore), None for a
        # memory-only catalog: publish() then gains a durable-commit step
        # and _reclaim() unlinks dead components' segment files
        self.store = None
        # datasets with soft-stale components (cold-start mounts awaiting
        # their first bind): one set probe on the query path
        self.stale: set[tuple[str, str]] = set()

    def attach_store(self, store) -> None:
        """Attach the durable store. One store per catalog: sessions that
        share a catalog share its storage directory too."""
        with self._lock:
            if self.store is not None and self.store is not store:
                raise RuntimeError(
                    "catalog already has a durable store attached")
            self.store = store

    @property
    def lock(self) -> threading.RLock:
        return self._lock

    def bump_stats_epoch(self) -> int:
        with self._lock:
            self.stats_epoch += 1
            return self.stats_epoch

    def next_run_uid(self, dataverse: str, name: str) -> int:
        """The next stable run uid of a dataset: monotone, never reused (a
        compaction resets the run list, not the counter)."""
        with self._lock:
            key = (dataverse, name)
            uid = self._run_uids.get(key, 0)
            self._run_uids[key] = uid + 1
            return uid

    def register(self, ds: Dataset) -> Manifest:
        """DDL entry point: publish a fresh base under a one-component
        manifest."""
        return self.publish(ds.dataverse, ds.name, ds, ())

    def publish(self, dataverse: str, name: str, base: Dataset,
                runs) -> Manifest:
        """Atomically swap a dataset's manifest (publish-then-retire)."""
        with self._lock:
            key = (dataverse, name)
            old = self._datasets.get(key)
            # flushes republish the SAME base object: capture its manifest
            # before the swap
            old_manifest = old.manifest if old is not None else None
            self.lsn += 1
            m = Manifest(self.lsn, base, tuple(runs))
            base.manifest = m
            self._datasets[key] = base
            tel.inc("catalog.publishes_total")
            if old_manifest is not None and old_manifest is not m:
                old_manifest.retired = True
                self._retired[id(old_manifest)] = old_manifest
                tel.inc("catalog.manifests_retired_total")
            self.bump_stats_epoch()
            if self.store is not None:
                # the durable-commit step of the swap: segments still
                # missing (fresh DDL bases; flush and compaction builds were
                # written off-lock), then the manifest generation through
                # write-temp → fsync → atomic rename. A crash before the
                # rename leaves the previous generation + the WAL tail
                # authoritative. On a rank mesh the commit is voted on:
                # it fails on every rank or on none.
                self.store.commit(dataverse, name, m)
            self._reclaim()
            self.gc_stats()
            return m

    def manifest(self, dataverse: str, name: str) -> Manifest:
        key = (dataverse, name)
        if key not in self._datasets:
            raise KeyError(f"unknown dataset {dataverse}.{name}")
        return self._datasets[key].manifest

    def components(self, dataverse: str, name: str) -> tuple:
        """(base, *runs) of the dataset's CURRENT manifest."""
        return self.manifest(dataverse, name).components

    def snapshot(self) -> Snapshot:
        """Capture and pin the current manifest of every dataset."""
        with self._lock:
            manifests = {k: ds.manifest for k, ds in self._datasets.items()}
            for m in manifests.values():
                m.pins += 1
            return Snapshot(self, manifests, self.stats_epoch, self.lsn)

    def get(self, dataverse: str, name: str) -> Dataset:
        if "@" in name:  # stable component address: "<dataset>@run<uid>"
            base_name, _, comp = name.partition("@")
            return _resolve_run(self.manifest(dataverse, base_name),
                                dataverse, base_name, comp)
        key = (dataverse, name)
        if key not in self._datasets:
            raise KeyError(f"unknown dataset {dataverse}.{name}")
        return self._datasets[key]

    def drop(self, dataverse: str, name: str) -> None:
        with self._lock:
            ds = self._datasets.pop((dataverse, name), None)
            self.stale.discard((dataverse, name))
            if ds is not None:
                if ds.manifest is not None:
                    ds.manifest.retired = True
                    self._retired[id(ds.manifest)] = ds.manifest
                    tel.inc("catalog.manifests_retired_total")
                if self.store is not None:
                    self.store.drop_dataset(dataverse, name)
                self.bump_stats_epoch()
                self._reclaim()
                self.gc_stats()

    def _reclaim(self) -> None:
        """Free the tensors of engine-owned components reachable ONLY through
        retired, unpinned manifests, and forget those manifests; with a
        store, also unlink the dead components' segment files (the store
        keeps any a kept manifest generation or an in-flight build still
        needs). Components in a current manifest or in any pinned retired
        manifest are never touched."""
        with self._lock:
            protected: set[int] = set()
            for ds in self._datasets.values():
                if ds.manifest is not None:
                    protected.update(id(c) for c in ds.manifest.components)
            for m in list(self._retired.values()):
                if m.pins > 0:
                    protected.update(id(c) for c in m.components)
            comps_freed = bytes_freed = 0
            dead_segs: list[tuple[str, str, str]] = []
            for mid, m in list(self._retired.items()):
                if m.pins > 0:
                    continue
                for comp in m.components:
                    if id(comp) in protected:
                        continue
                    protected.add(id(comp))  # shared across retired: once
                    if comp.seg_name is not None:
                        dead_segs.append((comp.dataverse,
                                          comp.name.partition("@")[0],
                                          comp.seg_name))
                    if not comp.engine_owned:
                        continue  # may share tensors with a caller's Table
                    bytes_freed += component_nbytes(comp)
                    comps_freed += 1
                    _delete_component_buffers(comp)
                self._retired.pop(mid, None)
        if self.store is not None:
            for dv, name, seg in dead_segs:
                self.store.maybe_unlink(dv, name, seg)
        if comps_freed:
            tel.inc("catalog.reclaimed_components_total", comps_freed)
            tel.inc("catalog.reclaimed_bytes_total", bytes_freed)

    def gc_stats(self) -> dict:
        """What the still-alive retired manifests retain: manifest counts and
        the bytes of components reachable ONLY through them (``catalog.*``
        gauges)."""
        with self._lock:
            current: set[int] = set()
            pinned_current = 0
            for ds in self._datasets.values():
                if ds.manifest is None:
                    continue
                if ds.manifest.pins > 0:
                    pinned_current += 1
                current.update(id(c) for c in ds.manifest.components)
            retired = retired_pinned = 0
            leaked: dict[int, Dataset] = {}
            for m in list(self._retired.values()):
                retired += 1
                if m.pins > 0:
                    retired_pinned += 1
                for comp in m.components:
                    if id(comp) not in current:
                        leaked[id(comp)] = comp
            retained = sum(component_nbytes(c) for c in leaked.values())
        out = {"manifests_retired": retired,
               "manifests_retired_pinned": retired_pinned,
               "manifests_pinned": pinned_current + retired_pinned,
               "retired_components": len(leaked),
               "retired_component_bytes": retained}
        for k, v in out.items():
            tel.set_gauge(f"catalog.{k}", v)
        return out

    def names(self) -> list[str]:
        """Every registered dataset's ``"dataverse.name"`` key."""
        return [f"{dv}.{n}" for dv, n in self._datasets]


def open_widen(table: Table) -> Table:
    """Simulate an *open* datatype: 1-D integer columns stored as float32
    (schema-on-read; the cost modelled is the cast itself). Derived string
    lanes and the validity mask stay as they are."""
    cols = {}
    meta = {}
    for name, col in table.columns.items():
        m = table.meta[name]
        if col.ndim == 1 and not col.dtype.is_floating_point \
                and col.dtype != torch.bool and name != "__valid__" \
                and not is_lane_column(name):
            cols[name] = col.to(torch.float32)
            meta[name] = ColumnMeta(np.dtype(np.float32), m.lo, m.hi,
                                    m.distinct, m.is_string,
                                    m.sorted_ascending)
        else:
            cols[name] = col
            meta[name] = m
    return table.with_columns(cols, meta)
