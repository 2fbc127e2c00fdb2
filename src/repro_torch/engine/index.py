"""Indexes: sorted-column secondary indexes and the clustered primary order
(port of ``repro.engine.index``).

A secondary index is the sorted key column plus the row-id permutation, so
every probe is a vectorized ``torch.searchsorted``:
  * range COUNT   — two binary searches (index-only query)
  * range + LIMIT — gather k row ids from the sorted run (no scan)
  * equi-join     — the build side is pre-sorted: no sort before the join
Zone maps (per-block min/max of the sorted keys) ride along; block skipping
in the kernels uses the storage-order zone maps on ``Dataset.block_zones``.
"""
from __future__ import annotations

import dataclasses

import torch

ZONE_BLOCK = 1024


@dataclasses.dataclass
class SortedIndex:
    """Sorted view of one column. ``sorted_keys`` ascending; ``row_ids``
    maps back to table row positions. Invalid (padding) rows sort to the end
    behind the dtype's maximum and are excluded by ``num_valid``."""

    column: str
    kind: str  # "primary" | "secondary"
    sorted_keys: torch.Tensor  # (n,)
    row_ids: torch.Tensor      # (n,) int32
    zone_min: torch.Tensor     # (n / ZONE_BLOCK,)
    zone_max: torch.Tensor


def _sentinel_max(dtype: torch.dtype):
    return torch.finfo(dtype).max if dtype.is_floating_point \
        else torch.iinfo(dtype).max


def _search(seq: torch.Tensor, values, side: str) -> torch.Tensor:
    """``torch.searchsorted`` with the reference's type promotion: the
    sequence and the values are compared in their common dtype (an int
    literal against float keys compares as float, never truncated)."""
    v = torch.as_tensor(values, device=seq.device)
    dt = torch.promote_types(seq.dtype, v.dtype)
    if seq.dtype != dt:
        seq = seq.to(dt)
    return torch.searchsorted(seq, v.to(dt), side=side)


def build_index_local(keys: torch.Tensor, valid: torch.Tensor, column: str,
                      kind: str = "secondary") -> SortedIndex:
    """Sort one column (stable, as ``jnp.argsort``: ties keep row order)."""
    sk = torch.where(valid, keys, _sentinel_max(keys.dtype))
    order = torch.argsort(sk, stable=True)
    sorted_keys = sk[order]
    n = keys.shape[0]
    pad = (-n) % ZONE_BLOCK
    fill = sorted_keys[-1:] if n else sorted_keys.new_zeros(1)
    zk = torch.cat([sorted_keys, fill.expand(pad)]).view(-1, ZONE_BLOCK)
    return SortedIndex(column, kind, sorted_keys, order.to(torch.int32),
                       zk.amin(dim=1), zk.amax(dim=1))


def build_index(keys: torch.Tensor, valid: torch.Tensor, column: str,
                kind: str = "secondary", n_shards: int = 1) -> SortedIndex:
    """The index of a row-sharded table: each shard sorts its own chunk
    (pad and dead rows to that shard's +inf tail) and the per-shard
    results concatenate in shard order — ``row_ids`` are shard-local
    positions, the zone arrays per-shard. One shard (or rows that do not
    split evenly) is :func:`build_index_local`."""
    n = keys.shape[0]
    if n_shards <= 1 or n % n_shards:
        return build_index_local(keys, valid, column, kind)
    rps = n // n_shards
    parts = [build_index_local(keys[s * rps:(s + 1) * rps],
                               valid[s * rps:(s + 1) * rps], column, kind)
             for s in range(n_shards)]
    return SortedIndex(column, kind,
                       torch.cat([p.sorted_keys for p in parts]),
                       torch.cat([p.row_ids for p in parts]),
                       torch.cat([p.zone_min for p in parts]),
                       torch.cat([p.zone_max for p in parts]))


def build_index_on_ranks(keys: torch.Tensor, valid: torch.Tensor, column: str,
                         kind: str, mesh, data_axes) -> SortedIndex:
    """The index of a rank's row shard (a ``RankMesh``): the rank sorts its
    own rows (:func:`build_index_local`, ``row_ids`` local to the shard)
    and the ranks all-gather their zone arrays, so every rank holds the
    per-shard zones the one-process mesh's :func:`build_index` lays out."""
    from repro_torch.engine import distributed as D

    ix = build_index_local(keys, valid, column, kind)
    sh = D.Shards(mesh, data_axes)
    return dataclasses.replace(ix, zone_min=sh.gather([ix.zone_min]),
                               zone_max=sh.gather([ix.zone_max]))


def index_count_local(ix_keys: torch.Tensor, num_valid: torch.Tensor,
                      lo, hi) -> torch.Tensor:
    """Range count on sorted keys (index-only), int32."""
    lo_pos = _search(ix_keys, lo, "left") if lo is not None \
        else torch.zeros((), dtype=torch.int64, device=ix_keys.device)
    hi_pos = _search(ix_keys, hi, "right") if hi is not None else num_valid
    hi_pos = torch.minimum(hi_pos, num_valid)
    lo_pos = torch.minimum(lo_pos, num_valid)
    return (hi_pos - lo_pos).clamp(min=0).to(torch.int32)


def shadow_count_local(ix_keys: torch.Tensor, num_valid: torch.Tensor,
                       anti_keys: torch.Tensor, lo, hi) -> torch.Tensor:
    """Anti-matter subtrahend: for every tombstone key inside [lo, hi], count
    its matter occurrences in the sorted (primary) index — two batched binary
    searches. ``anti_keys`` must already be deduplicated (a row dies exactly
    once)."""
    l = torch.minimum(_search(ix_keys, anti_keys, "left"), num_valid)
    r = torch.minimum(_search(ix_keys, anti_keys, "right"), num_valid)
    occ = (r - l).clamp(min=0)
    keep = torch.ones(anti_keys.shape, dtype=torch.bool, device=anti_keys.device)
    if lo is not None:
        keep = keep & (anti_keys >= lo)
    if hi is not None:
        keep = keep & (anti_keys <= hi)
    return torch.where(keep, occ, 0).sum(dtype=torch.int32)


def index_head_rows_local(ix: SortedIndex, num_valid, lo, hi, k: int):
    """First-k row ids in index order within [lo, hi] (LIMIT pushdown).
    Returns (row_ids (k,), found count)."""
    dev = ix.sorted_keys.device
    num_valid = torch.as_tensor(num_valid, device=dev)
    lo_pos = _search(ix.sorted_keys, lo, "left") if lo is not None \
        else torch.zeros((), dtype=torch.int64, device=dev)
    hi_pos = _search(ix.sorted_keys, hi, "right") if hi is not None \
        else num_valid
    hi_pos = torch.minimum(hi_pos, num_valid)
    found = (hi_pos - lo_pos).clamp(min=0)
    take = torch.clamp(found, max=k)
    idx = lo_pos + torch.arange(k, device=dev)
    idx = torch.minimum(idx, (num_valid - 1).clamp(min=0))
    return ix.row_ids[idx], take
