"""Statistics layer — the planner's single source of truth (port of
``repro.core.stats``).

Per-column lo/hi/distinct collected at load, live row counts, and the
per-block zone maps harvested once at load; every harvest here is
O(metadata). The catalog's ``stats_epoch`` keys compiled plans.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np

from repro_torch.core.catalog import INTERNAL_COLUMNS, Dataset
# Zone-map block granularity: one zone block per filter_count kernel tile.
from repro_torch.kernels.filter_count import BLOCK as ZONE_BLOCK_ROWS


@dataclasses.dataclass(frozen=True)
class BlockZones:
    """Per-``ZONE_BLOCK_ROWS`` [min, max] of each numeric column over the
    component's physical row layout (live rows only). The bind-time
    block-skip test intersects predicate intervals with these spans to
    shrink the kernel grid to the surviving blocks."""

    block: int
    n_blocks: int
    spans: Mapping[str, "object"]  # column -> (n_blocks, 2) ndarray

    def span_of(self, column: str):
        return self.spans.get(column)


def harvest_block_zones(table) -> Optional[BlockZones]:
    """A table's per-block zone maps (None when it has no numeric column or
    no rows). O(rows) at load — never at query time."""
    from repro_torch.engine.table import compute_block_zones

    spans = compute_block_zones(table, ZONE_BLOCK_ROWS)
    if not spans:
        return None
    nb = int(next(iter(spans.values())).shape[0])
    return BlockZones(ZONE_BLOCK_ROWS, nb, spans)


@dataclasses.dataclass(frozen=True)
class ColumnStats:
    """Per-column statistics: ``lo``/``hi`` bound the live value domain."""

    dtype: np.dtype
    lo: Optional[float] = None
    hi: Optional[float] = None
    distinct: Optional[int] = None
    is_string: bool = False
    dict_values: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class TableStats:
    """Statistics for one storage component. ``rows`` counts visible rows;
    ``padded_rows`` is the physical length every full scan touches — the
    quantity the cost model charges for."""

    rows: int
    padded_rows: int
    columns: Mapping[str, ColumnStats]
    block_zones: Optional[BlockZones] = None

    def column(self, name: str) -> Optional[ColumnStats]:
        return self.columns.get(name)


def harvest(ds: Dataset) -> TableStats:
    """Uniform stats harvest for a base dataset."""
    cols = {name: ColumnStats(dtype=np.dtype(meta.dtype), lo=meta.lo,
                              hi=meta.hi, distinct=meta.distinct,
                              is_string=meta.is_string,
                              dict_values=meta.dict_values)
            for name, meta in ds.table.meta.items()
            if name not in INTERNAL_COLUMNS}
    return TableStats(rows=ds.num_live_rows, padded_rows=len(ds.table),
                      columns=cols, block_zones=ds.block_zones)
