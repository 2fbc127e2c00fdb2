"""Statistics layer — the planner's single source of truth (port of
``repro.core.stats``).

A uniform harvest over every storage component the engine owns — base
datasets (per-column lo/hi/distinct collected at load, index inventory,
live row counts), LSM runs (the same shape per flush: a run's column
``[lo, hi]`` is its zone span, what run-level pruning tests predicates
against) and materialized views (group counts and key domain). Every
harvest is O(metadata); the per-block zone maps are computed once at load,
flush or compaction and handed through. The catalog's ``stats_epoch`` keys
compiled plans, so a stale plan never reads a dropped component.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np

from repro_torch.core.catalog import INTERNAL_COLUMNS, Catalog, Dataset
# Zone-map block granularity: one zone block per filter_count kernel tile.
from repro_torch.kernels.filter_count import BLOCK as ZONE_BLOCK_ROWS


def mesh_shards(mesh, data_axes=None) -> int:
    """Row-partition count of a session mesh: the product of the data-axis
    extents. 1 for meshless sessions (the zone layout is then global)."""
    if mesh is None:
        return 1
    if data_axes:
        return int(np.prod([mesh.shape[a] for a in data_axes]))
    return int(mesh.devices.size)


@dataclasses.dataclass(frozen=True)
class BlockZones:
    """Per-``ZONE_BLOCK_ROWS`` [min, max] of each numeric column over the
    component's physical row layout (live rows only). The bind-time
    block-skip test intersects predicate intervals with these spans to
    shrink the kernel grid to the surviving blocks.

    The layout follows the mesh's row partitions: flat block
    ``s * blocks_per_shard + j`` is shard ``s``'s LOCAL block ``j`` over
    its ``rows_per_shard`` rows (a shard's trailing partial block is
    sentinel-padded), so per-shard kernel grids address their own tiles.
    ``n_shards == 1`` is the global layout."""

    block: int
    n_blocks: int
    spans: Mapping[str, "object"]  # column -> (n_blocks, 2) ndarray
    n_shards: int = 1
    rows_per_shard: int = 0        # 0 = whole table (unsharded)

    @property
    def blocks_per_shard(self) -> int:
        return self.n_blocks // max(self.n_shards, 1)

    def span_of(self, column: str):
        return self.spans.get(column)

    def shard_lists(self, block_ids) -> list[list[int]]:
        """Split a flat surviving-block tuple into per-shard LOCAL id lists
        (flat ``s * blocks_per_shard + j`` -> shard ``s``, local ``j``);
        sorted flat ids give sorted local lists."""
        bp = self.blocks_per_shard
        out: list[list[int]] = [[] for _ in range(max(self.n_shards, 1))]
        for b in block_ids:
            out[b // bp].append(b % bp)
        return out


def harvest_block_zones(table, n_shards: int = 1) -> Optional[BlockZones]:
    """A table's per-block zone maps (None when it has no numeric column or
    no rows), laid out over ``n_shards`` row partitions — one partition
    when the rows do not split evenly. O(rows) at load — never at query
    time."""
    from repro_torch.engine.table import compute_block_zones

    n = len(table)
    if n_shards <= 1 or (n and n % n_shards):
        n_shards = 1
    spans = compute_block_zones(table, ZONE_BLOCK_ROWS, n_shards)
    if not spans:
        return None
    nb = int(next(iter(spans.values())).shape[0])
    return BlockZones(ZONE_BLOCK_ROWS, nb, spans, n_shards,
                      n // max(n_shards, 1))


@dataclasses.dataclass(frozen=True)
class ColumnStats:
    """Per-column statistics: ``lo``/``hi`` bound the live value domain (an
    LSM run's zone span); ``index`` is the kind of index covering the column
    ("primary"/"secondary") or None; ``dict_values`` is a
    dictionary-encoded string column's sorted dictionary."""

    dtype: np.dtype
    lo: Optional[float] = None
    hi: Optional[float] = None
    distinct: Optional[int] = None
    is_string: bool = False
    sorted_ascending: bool = False
    index: Optional[str] = None
    dict_values: Optional[tuple] = None

    @property
    def bounded(self) -> bool:
        return self.lo is not None and self.hi is not None

    @property
    def span(self) -> Optional[tuple[float, float]]:
        return (self.lo, self.hi) if self.bounded else None


@dataclasses.dataclass(frozen=True)
class TableStats:
    """Statistics for one storage component (base, LSM run or view).
    ``rows`` counts visible rows (matter minus what newer anti-matter
    annihilated); ``padded_rows`` is the physical length every full scan
    touches — the quantity the cost model charges for. ``tombstones``
    counts the anti-matter records this component carries, ``shadowed`` its
    own matter newer anti-matter annihilated (already out of ``rows``)."""

    address: str                 # "dataverse.name" (runs: "dv.name@run<uid>")
    rows: int
    padded_rows: int
    columns: Mapping[str, ColumnStats]
    kind: str = "dataset"        # dataset | run | view
    tombstones: int = 0
    shadowed: int = 0
    block_zones: Optional[BlockZones] = None

    def column(self, name: str) -> Optional[ColumnStats]:
        return self.columns.get(name)

    def span(self, name: str) -> Optional[tuple[float, float]]:
        c = self.columns.get(name)
        return c.span if c is not None else None

    def index_on(self, name: str) -> Optional[str]:
        c = self.columns.get(name)
        return c.index if c is not None else None

    @property
    def is_run(self) -> bool:
        return self.kind == "run"


def harvest(ds: Dataset) -> TableStats:
    """Uniform stats harvest for a base dataset or an LSM run."""
    cols: dict[str, ColumnStats] = {}
    for name, meta in ds.table.meta.items():
        if name in INTERNAL_COLUMNS:
            continue
        ix = ds.index_on(name)
        cols[name] = ColumnStats(
            dtype=np.dtype(meta.dtype), lo=meta.lo, hi=meta.hi,
            distinct=meta.distinct, is_string=meta.is_string,
            sorted_ascending=meta.sorted_ascending,
            index=ix.kind if ix is not None else None,
            dict_values=meta.dict_values)
    return TableStats(address=f"{ds.dataverse}.{ds.name}",
                      rows=ds.num_live_rows, padded_rows=len(ds.table),
                      columns=cols,
                      kind="run" if "@" in ds.name else "dataset",
                      tombstones=ds.anti_rows, shadowed=ds.annihilated_rows,
                      block_zones=ds.block_zones)


def component_stats(catalog: Catalog, dataverse: str, name: str) -> TableStats:
    """Stats for a component address ("<name>@run<uid>" resolves like the
    catalog does)."""
    return harvest(catalog.get(dataverse, name))


def view_stats(view) -> TableStats:
    """Stats of a MaterializedView: live group count and the key domain of
    its dense state."""
    counts = getattr(view, "_counts", None)
    if counts is None:
        return TableStats(address=f"{view.dataverse}.{view.name}", rows=0,
                          padded_rows=0, columns={}, kind="view")
    live = int((counts > 0).sum())
    g = int(counts.shape[0])
    key_dtype = np.dtype(view._key_dtype) if view._key_dtype is not None \
        else np.dtype(np.int64)
    cols = {view.key: ColumnStats(dtype=key_dtype, lo=view.lo,
                                  hi=view.lo + g - 1, distinct=live,
                                  sorted_ascending=True)}
    return TableStats(address=f"{view.dataverse}.{view.name}", rows=live,
                      padded_rows=g, columns=cols, kind="view")
