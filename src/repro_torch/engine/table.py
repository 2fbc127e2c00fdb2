"""Columnar tables over torch tensors — the storage layer of the engine.

Port of ``repro.engine.table``. A table is a dict of equal-length tensors on
one device. Strings are fixed-width ``uint8`` tensors of shape
``(n, STRING_WIDTH)`` so string operations are elementwise byte maps.

Every string column carries integer lanes derived at load time: an
order-preserving big-endian prefix lane (``__pfx_<col>``, the first
``PREFIX_BYTES`` bytes packed into one int32) and, for columns with at most
``DICT_THRESHOLD`` distinct values, a sorted dictionary-id lane
(``__dict_<col>``). The lanes are the same as the reference's, byte for byte.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

STRING_WIDTH = 16
DICT_THRESHOLD = 256   # distinct values above this: prefix lane only
PREFIX_BYTES = 4       # leading encoded bytes packed into the prefix lane

_PREFIX_LANE = "__pfx_"
_DICT_LANE = "__dict_"

_TORCH_DTYPES = {np.dtype(np.bool_): torch.bool, np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
                 np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}


def prefix_lane_name(column: str) -> str:
    return _PREFIX_LANE + column


def dict_lane_name(column: str) -> str:
    return _DICT_LANE + column


def is_lane_column(name: str) -> bool:
    """True for the derived string-lane columns (never user-visible)."""
    return name.startswith(_PREFIX_LANE) or name.startswith(_DICT_LANE)


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (catalog metadata is numpy-typed)."""
    return np.dtype(torch.empty((), dtype=dtype).numpy().dtype)


def pack_prefix(arr) -> torch.Tensor:
    """Pack the first PREFIX_BYTES of each (n, width) uint8 row into one
    big-endian int32 per row — order-preserving, and non-negative for ASCII
    rows. Runs on the input's device."""
    a = torch.as_tensor(arr)[:, :PREFIX_BYTES].to(torch.int64)
    shifts = torch.arange(PREFIX_BYTES - 1, -1, -1, device=a.device) * 8
    return (a << shifts).sum(dim=1).to(torch.int32)


def encode_strings(values: Sequence[str], width: int = STRING_WIDTH) -> torch.Tensor:
    """Encode python strings into an (n, width) uint8 tensor, space padded
    (one bytes join, no per-row tensor writes)."""
    raw = b"".join(s.encode("ascii")[:width].ljust(width, b" ") for s in values)
    return torch.from_numpy(
        np.frombuffer(raw, dtype=np.uint8).reshape(len(values), width).copy())


def decode_strings(arr) -> list[str]:
    a = np.asarray(torch.as_tensor(arr).cpu(), dtype=np.uint8)
    return [bytes(row).decode("ascii").rstrip() for row in a]


def canon_string(v: str, width: int = STRING_WIDTH) -> str:
    """A string literal in its stored form: ascii, truncated to ``width``,
    trailing padding stripped."""
    return v.encode("ascii")[:width].decode("ascii").rstrip()


@dataclasses.dataclass(frozen=True)
class ColumnMeta:
    """Catalog statistics for one column: ``lo``/``hi`` bound the value
    domain, ``distinct`` bounds its cardinality; ``dict_values`` is the sorted
    value dictionary of a dictionary-encoded string column."""

    dtype: np.dtype
    lo: float | None = None
    hi: float | None = None
    distinct: int | None = None
    is_string: bool = False
    sorted_ascending: bool = False
    dict_values: tuple | None = None


class Table:
    """An immutable columnar table of equal-length tensors on one device.

    String columns have shape (n, STRING_WIDTH) uint8; numeric columns are
    1-D. ``meta`` carries per-column stats used by the planner."""

    def __init__(self, columns: Mapping[str, torch.Tensor | np.ndarray],
                 meta: Mapping[str, ColumnMeta] | None = None,
                 num_rows: int | None = None, *, mesh=None,
                 data_axes: tuple = ("data",), global_rows: int | None = None,
                 row_offset: int = 0, real_rows: int | None = None,
                 shard_valid: bool = False):
        self.columns = {k: torch.as_tensor(v) for k, v in columns.items()}
        lengths = {k: int(v.shape[0]) for k, v in self.columns.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"ragged columns: {lengths}")
        self.num_rows = num_rows if num_rows is not None \
            else next(iter(lengths.values()), 0)
        # a rank's row shard (``shard`` on a RankMesh, over ``data_axes``):
        # ``num_rows`` is the rows this rank holds, ``global_rows`` the
        # padded table's, ``row_offset`` the global row id of its first row
        self.mesh, self.data_axes = mesh, tuple(data_axes)
        self.global_rows = self.num_rows if global_rows is None else global_rows
        self.row_offset = row_offset
        # the rows of the table before ``shard`` padded it to a multiple of
        # the shards, and whether ``shard`` added ``__valid__`` (the source
        # had none): what a durable segment cuts back to
        self.real_rows = self.global_rows if real_rows is None else real_rows
        self.shard_valid = shard_valid
        self.meta = dict(meta or {})
        for k, v in self.columns.items():
            if k not in self.meta:
                self.meta[k] = ColumnMeta(dtype=numpy_dtype(v.dtype),
                                          is_string=v.ndim == 2)

    @property
    def device(self) -> torch.device:
        return next(iter(self.columns.values())).device

    def column_names(self) -> list[str]:
        return list(self.columns.keys())

    def __len__(self) -> int:
        return self.num_rows

    def with_columns(self, columns, meta) -> "Table":
        """A Table of ``columns`` with this one's row layout (its shard)."""
        return Table(columns, meta, self.num_rows, mesh=self.mesh,
                     data_axes=self.data_axes, global_rows=self.global_rows,
                     row_offset=self.row_offset, real_rows=self.real_rows,
                     shard_valid=self.shard_valid)

    def select(self, names: Sequence[str]) -> "Table":
        """A Table of the named columns (the same tensors), their meta and
        the row count (a rank's shard stays that shard)."""
        return self.with_columns({n: self.columns[n] for n in names},
                                 {n: self.meta[n] for n in names})

    def head_dict(self, k: int) -> dict[str, np.ndarray]:
        """The first ``k`` rows of every column, as numpy arrays. On a
        rank's shard: the first ``k`` rows of the whole (padded) table,
        the same on every rank (each rank sends its first ``k`` rows; every
        rank takes part)."""
        if self.mesh is None:
            return {name: col[:k].cpu().numpy()
                    for name, col in self.columns.items()}
        from repro_torch.engine import distributed as D

        sh = D.Shards(self.mesh, self.data_axes)
        take = min(k, self.num_rows)
        names = list(self.columns)
        rows = sh.gather_rows([self.columns[n][:take] for n in names], take)
        return {n: r[:k].cpu().numpy() for n, r in zip(names, rows)}

    def to(self, device) -> "Table":
        return self.with_columns(
            {k: v.to(device) for k, v in self.columns.items()}, self.meta)

    def to_numpy(self) -> dict[str, np.ndarray]:
        return {k: v.cpu().numpy() for k, v in self.columns.items()}

    def shard(self, mesh, data_axes: tuple[str, ...] = ("data",)) -> "Table":
        """Row-shard every column over ``data_axes``: pad the rows to a
        multiple of the shard count S (pad rows are zeros) and add the
        ``__valid__`` mask column (always; pad rows False), so relational
        operators ignore the pad. Shard ``i`` holds rows ``[i * rps, (i +
        1) * rps)``, rps = ceil(n / S).

        On the one-process mesh every shard lives on the mesh's one device,
        so the columns stay single tensors and shard ``i`` is a view. On a
        ``RankMesh`` this rank keeps only its own shard ``i = mesh.index(
        data_axes)``: its rows are sliced from this table (a host table
        stays on the host) and padded, and only they move to
        ``mesh.device``; the result records the padded table's
        ``global_rows``, this shard's ``row_offset``, the rows before the
        padding (``real_rows``) and whether ``__valid__`` was added here
        (``shard_valid``)."""
        from repro_torch.launch.mesh import is_rank_mesh

        nshards = int(np.prod([mesh.shape[a] for a in data_axes]))
        n = self.num_rows
        padded = ((n + nshards - 1) // nshards) * nshards
        meta = dict(self.meta)
        meta["__valid__"] = ColumnMeta(dtype=np.dtype(np.bool_))
        if is_rank_mesh(mesh):
            rps = padded // nshards
            lo = mesh.index(tuple(data_axes)) * rps
            hi = min(lo + rps, n)
            cols = dict(self.columns)
            if "__valid__" not in cols:
                cols["__valid__"] = torch.ones((n,), dtype=torch.bool)
            out = {}
            for k, v in cols.items():
                v = v[lo:hi]
                if v.shape[0] < rps:
                    v = torch.cat([v, v.new_zeros((rps - v.shape[0],)
                                                  + tuple(v.shape[1:]))])
                out[k] = v.to(mesh.device)
            return Table(out, meta, rps, mesh=mesh, data_axes=data_axes,
                         global_rows=padded, row_offset=lo, real_rows=n,
                         shard_valid="__valid__" not in self.columns)
        cols = dict(self.columns)
        if "__valid__" not in cols:
            cols["__valid__"] = torch.ones((n,), dtype=torch.bool,
                                           device=self.device)
        out = {}
        for k, v in cols.items():
            if padded != n:
                v = torch.cat([v, v.new_zeros((padded - n,) + tuple(v.shape[1:]))])
            out[k] = v.to(mesh.device)
        return Table(out, meta, padded)

    @property
    def valid(self) -> torch.Tensor:
        if "__valid__" in self.columns:
            return self.columns["__valid__"]
        return torch.ones((self.num_rows,), dtype=torch.bool, device=self.device)


def from_numpy(columns: Mapping[str, np.ndarray], meta: Mapping[str, dict],
               device) -> Table:
    """Build a port Table from another table's arrays (numpy) and its
    ``ColumnMeta`` fields (``dataclasses.asdict`` form) — how a table made by
    the reference package is loaded into the port."""
    cols = {k: torch.from_numpy(np.array(v)).to(device)  # a writable copy
            for k, v in columns.items()}
    metas = {}
    for k, m in meta.items():
        m = dict(m)
        m["dtype"] = np.dtype(m["dtype"])
        if m.get("dict_values") is not None:
            m["dict_values"] = tuple(m["dict_values"])
        metas[k] = ColumnMeta(**m)
    return Table(cols, metas)


def compute_block_zones(table: Table, block: int,
                        n_shards: int = 1) -> dict[str, np.ndarray]:
    """Per-block [min, max] zone maps over the table's physical row layout:
    one (n_blocks, 2) int64 (or float64) array per 1-D numeric column, taken
    over matter rows only (valid and not anti-matter: a tombstone's key must
    not widen the span a query's predicate is tested against). Dead rows,
    anti-matter, the trailing pad and float NaNs carry the empty-span
    sentinel (``[int64.max, int64.min]`` / ``[+inf, -inf]``). Index copies
    (``__ix*``) have no zones. Computed on the table's device.

    ``n_shards > 1`` lays the blocks out per shard: the rows split into
    ``n_shards`` equal contiguous chunks (``Table.shard``'s partitions),
    each with its own ``ceil(rows_per_shard / block)`` blocks, the last
    one sentinel-padded — flat block ``s * blocks_per_shard + j`` is shard
    ``s``'s local block ``j``. Rows that do not split evenly get the
    one-shard layout."""
    n = len(table)
    if n == 0:
        return {}
    if n_shards <= 1 or n % n_shards:
        n_shards = 1
    live_rows = table.valid
    anti = table.columns.get("__antimatter__")
    if anti is not None:
        live_rows = live_rows & ~anti
    rps = n // n_shards                     # rows per shard chunk
    bp = -(-rps // block)                   # blocks per shard
    pad = bp * block - rps
    out: dict[str, np.ndarray] = {}
    for name, col in table.columns.items():
        if name in ("__valid__", "__antimatter__") or name.startswith("__ix") \
                or col.ndim != 1:
            continue
        if col.dtype.is_floating_point:
            v = col.to(torch.float64)
            live = live_rows & ~torch.isnan(v)
            lo_fill, hi_fill = float("inf"), float("-inf")
        elif col.dtype != torch.bool:
            v = col.to(torch.int64)
            live = live_rows
            i64 = torch.iinfo(torch.int64)
            lo_fill, hi_fill = i64.max, i64.min
        else:
            continue
        # the pad sentinels go in as tensors: a float pad value would round
        # int64.max and wrap it
        lo = torch.where(live, v, lo_fill).view(n_shards, rps)
        hi = torch.where(live, v, hi_fill).view(n_shards, rps)
        lo = torch.cat([lo, v.new_full((n_shards, pad), lo_fill)], dim=1)
        hi = torch.cat([hi, v.new_full((n_shards, pad), hi_fill)], dim=1)
        out[name] = torch.stack([lo.reshape(n_shards * bp, block).amin(dim=1),
                                 hi.reshape(n_shards * bp, block).amax(dim=1)],
                                dim=1).cpu().numpy()
    return out


def pad_to_block(table: Table, block: int) -> Table:
    """Pad rows up to a multiple of ``block`` with a ``__valid__`` mask (pad
    rows are zeros, ``__valid__`` False). Unpadded lengths still gain the
    mask column."""
    n = table.num_rows
    padded = ((n + block - 1) // block) * block if n else block
    cols = dict(table.columns)
    if "__valid__" not in cols:
        cols["__valid__"] = torch.ones((n,), dtype=torch.bool,
                                       device=table.device)
    out = {}
    for k, v in cols.items():
        if padded != n:
            v = torch.cat([v, v.new_zeros((padded - n,) + tuple(v.shape[1:]))])
        out[k] = v
    meta = dict(table.meta)
    meta["__valid__"] = ColumnMeta(dtype=np.dtype(np.bool_))
    return Table(out, meta, padded)


def concat_tables(a: Table, b: Table) -> Table:
    names = a.column_names()
    cols = {n: torch.cat([a.columns[n], b.columns[n]], dim=0) for n in names}
    meta = {}
    for n in names:
        ma, mb = a.meta[n], b.meta[n]
        lo = None if ma.lo is None or mb.lo is None else min(ma.lo, mb.lo)
        hi = None if ma.hi is None or mb.hi is None else max(ma.hi, mb.hi)
        distinct = None if ma.distinct is None or mb.distinct is None \
            else ma.distinct + mb.distinct
        meta[n] = ColumnMeta(ma.dtype, lo, hi, distinct, ma.is_string, False)
    return Table(cols, meta)
