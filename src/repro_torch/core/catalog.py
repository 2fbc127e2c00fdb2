"""The catalog: datasets and their manifests (port of ``repro.core.catalog``).

Every dataset is described by an immutable, LSN-stamped :class:`Manifest`;
registering a dataset publishes a new manifest and retires the old one. A
query binds a pinned :class:`Snapshot` — the manifests of every dataset at
one LSN — and plans, compiles and executes against it, as in the reference.
This slice serves closed base datasets only: a manifest holds one component
(LSM runs, anti-matter, background compaction and durable storage are
ROADMAP items A6 and A8).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from repro_torch.engine.table import Table
from repro_torch.runtime import telemetry as tel

# Engine-internal per-row columns that never surface in query envs, schemas
# or statistics.
INTERNAL_COLUMNS = ("__valid__", "__antimatter__")


@dataclasses.dataclass(eq=False)  # identity semantics, as the reference
class Dataset:
    name: str
    dataverse: str
    table: Table
    closed: bool = True
    live_rows: Optional[int] = None  # matter-row count (None -> len(table))
    # per-ZONE_BLOCK [min, max] zone maps of every numeric column
    # (core/stats.py BlockZones), harvested at load
    block_zones: Optional[object] = None
    manifest: Optional["Manifest"] = None

    @property
    def num_live_rows(self) -> int:
        return self.live_rows if self.live_rows is not None else len(self.table)


@dataclasses.dataclass
class Manifest:
    """One immutable description of a dataset, stamped with the
    catalog-global LSN of the publish that created it. ``pins`` counts the
    snapshots bound to it."""

    lsn: int
    base: Dataset
    retired: bool = False
    pins: int = 0


class Snapshot:
    """A pinned view of the catalog at one LSN. Duck-types the catalog's
    read surface (``get`` / ``stats_epoch``) so every layer binds it without
    knowing."""

    def __init__(self, catalog: "Catalog", manifests: dict,
                 stats_epoch: int, lsn: int):
        self._catalog = catalog
        self._manifests = manifests  # (dataverse, name) -> Manifest
        self.stats_epoch = stats_epoch
        self.lsn = lsn
        self._released = False

    def get(self, dataverse: str, name: str) -> Dataset:
        key = (dataverse, name)
        if key not in self._manifests:
            raise KeyError(f"unknown dataset {dataverse}.{name}")
        return self._manifests[key].base

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        with self._catalog.lock:
            for m in self._manifests.values():
                m.pins -= 1

    def __enter__(self) -> "Snapshot":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class Catalog:
    def __init__(self):
        self._datasets: dict[tuple[str, str], Dataset] = {}
        # bumped on every event that changes what statistics describe (DDL);
        # compiled plans are keyed by (epoch, LSN)
        self.stats_epoch: int = 0
        self.lsn: int = 0
        self._lock = threading.RLock()

    @property
    def lock(self) -> threading.RLock:
        return self._lock

    def register(self, ds: Dataset) -> Manifest:
        """DDL entry point: atomically publish a fresh base dataset and
        retire the manifest it replaces (publish-then-retire)."""
        with self._lock:
            old = self._datasets.get((ds.dataverse, ds.name))
            self.lsn += 1
            m = Manifest(self.lsn, ds)
            ds.manifest = m
            self._datasets[(ds.dataverse, ds.name)] = ds
            tel.inc("catalog.publishes_total")
            if old is not None:
                old.manifest.retired = True
                tel.inc("catalog.manifests_retired_total")
            self.stats_epoch += 1
            return m

    def snapshot(self) -> Snapshot:
        """Capture and pin the current manifest of every dataset."""
        with self._lock:
            manifests = {k: ds.manifest for k, ds in self._datasets.items()}
            for m in manifests.values():
                m.pins += 1
            return Snapshot(self, manifests, self.stats_epoch, self.lsn)

    def get(self, dataverse: str, name: str) -> Dataset:
        key = (dataverse, name)
        if key not in self._datasets:
            raise KeyError(f"unknown dataset {dataverse}.{name}")
        return self._datasets[key]
