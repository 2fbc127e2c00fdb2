"""Relational kernel dispatch (port of ``repro.kernels.ops``, relational part).

Each op picks its backend from where its operands lie: CUDA tensors go to
the hand-written CUDA kernels, CPU tensors to their plain PyTorch versions
(the CPU path of kernel mode and the tests' bridge to the reference).
``DISPATCH_COUNTS`` ticks once per op call on either backend — the kernel
mode's tests assert the relational kernels are on the executed path; the
CUDA launch counts themselves live in ``_build.LAUNCHES``.

The flash-attention ops of the reference belong to the model zoo and are
not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import filter_count as _fc
from repro_torch.kernels import merge_join as _mj
from repro_torch.kernels import segment_agg as _sa
from repro_torch.kernels import topk_mask as _tk
from repro_torch.runtime import telemetry as tel

# Zone-map block size the planner's block-skip lists are expressed in: the
# filter_count kernel's own tile. segment_agg's smaller BLOCK is bridged by
# _expand_block_ids (one zone block = several kernel blocks).
ZONE_BLOCK_ROWS = _fc.BLOCK

INT32_MAX = torch.iinfo(torch.int32).max

DISPATCH_COUNTS: dict[str, int] = {}


def reset_dispatch_counts() -> None:
    DISPATCH_COUNTS.clear()


def _tick(name: str, device: torch.device, grid: Optional[int] = None,
          blocks_total: Optional[int] = None) -> None:
    """One tick per op call, mirrored into telemetry with the backend and,
    for the block-skipping kernels, grid size vs the block count."""
    DISPATCH_COUNTS[name] = DISPATCH_COUNTS.get(name, 0) + 1
    tel.inc("kernel.launches_total", kernel=name,
            backend="cuda" if device.type == "cuda" else "torch")
    if grid is not None:
        tel.inc("kernel.grid_blocks_total", grid, kernel=name)
        if blocks_total is not None:
            tel.inc("kernel.blocks_scanned_total", grid, kernel=name)
            tel.inc("kernel.blocks_skipped_total", blocks_total - grid,
                    kernel=name)


def _expand_block_ids(block_ids, zone_block: int, block: int,
                      n: int) -> Optional[tuple]:
    """Re-express zone-block ids in units of a kernel's own (smaller or
    equal) block size, clipped to the kernel's block count."""
    if block_ids is None:
        return None
    assert zone_block % block == 0, (zone_block, block)
    r = zone_block // block
    nb = -(-n // block)
    out = tuple(j for b in block_ids
                for j in range(b * r, min((b + 1) * r, nb)))
    assert out, (block_ids, zone_block, block, n)
    return out


def filter_count(cols: torch.Tensor, bounds: torch.Tensor, n_valid: int,
                 block_ids: Optional[tuple] = None) -> torch.Tensor:
    ids = _expand_block_ids(block_ids, ZONE_BLOCK_ROWS, _fc.BLOCK,
                            cols.shape[1])
    nb = -(-cols.shape[1] // _fc.BLOCK)
    _tick("filter_count", cols.device,
          grid=len(ids) if ids is not None else nb, blocks_total=nb)
    return _fc.filter_count(cols, bounds, n_valid, block_ids=ids)


def segment_agg(values: torch.Tensor, gids: torch.Tensor, num_groups: int,
                n_valid: int, op: str = "sum",
                block_ids: Optional[tuple] = None) -> torch.Tensor:
    ids = _expand_block_ids(block_ids, ZONE_BLOCK_ROWS, _sa.BLOCK,
                            values.shape[0])
    nb = -(-values.shape[0] // _sa.BLOCK)
    _tick("segment_agg", values.device,
          grid=len(ids) if ids is not None else nb, blocks_total=nb)
    return _sa.segment_agg(values, gids, num_groups, n_valid, op=op,
                           block_ids=ids)


def sort_join_keys(keys: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Prepare one side for merge_join_count's contract: int32 keys, dead
    rows replaced by the INT32_MAX sentinel, ascending sort."""
    return torch.sort(torch.where(mask, keys.to(torch.int32), INT32_MAX)).values


def merge_join_count(lkeys: torch.Tensor, rkeys: torch.Tensor, nl,
                     nr) -> torch.Tensor:
    """Equi-join cardinality over SORTED key columns (valid prefix of length
    nl / nr, sentinel padding after)."""
    _tick("merge_join_count", lkeys.device)
    return _mj.merge_join_count(lkeys, rkeys, nl, nr)


def topk(scores: torch.Tensor, mask: torch.Tensor, n_valid: int,
         k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked top-k over the valid prefix: (values (k,), global indices (k,)
    int32), ties to the lowest index."""
    _tick("topk", scores.device)
    return _tk.topk_merge(scores, mask, n_valid, k)
