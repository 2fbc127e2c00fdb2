"""Fused multi-predicate filter + count (paper expressions 3 and 11).

Replaces the Pallas TPU kernel ``repro/kernels/filter_count.py:filter_count``
with the hand-written CUDA kernel ``csrc/filter_count.cu``: one CUDA block
per 4096-row tile (the zone-map block), bounds as a device operand so new
literals never rebuild anything, and an optional list of surviving tile
ids that becomes the grid, so skipped tiles are never read: a static tuple
(``block_ids``), or a device int32 list ``-1``-padded at the end
(``block_ids_arr``, the per-shard form of ``repro.kernels.ops``), whose pad
entries the kernel skips with no host sync. On the H100 the kernel is bound
by bytes — k int32 columns read once — and its design reads each byte once
and writes one int32.

``filter_count`` launches the kernel for CUDA tensors and runs
``filter_count_plain`` for CPU tensors; it never runs the plain version on
the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

BLOCK = 4096

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
         ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p]


def _rows(n: int, block: int, block_ids=None, block_ids_arr=None,
          device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(row indices, live) of the rows a pass visits: all rows, the listed
    blocks, or the blocks of a -1-padded id list. As ``ref._arr_select``, a
    pad id visits block 0's rows as dead ones, and rows past ``n`` (the
    last block's tail) are dead and read row n - 1."""
    if block_ids_arr is not None:
        if block_ids is not None:
            raise ValueError("block_ids and block_ids_arr are exclusive")
        ids = block_ids_arr.to(device=device, dtype=torch.int64)
        pos = (ids.clamp(min=0)[:, None] * block
               + torch.arange(block, device=device)[None, :]).reshape(-1)
        live = (ids >= 0).repeat_interleave(block) & (pos < n)
        return pos.clamp(max=n - 1), live
    if block_ids is None:
        rows = torch.arange(n, device=device)
    else:
        rows = torch.cat([torch.arange(b * block, min((b + 1) * block, n))
                          for b in block_ids]).to(device)
    return rows, torch.ones(rows.shape, dtype=torch.bool, device=device)


def _id_list(name: str, n: int, block: int, block_ids, block_ids_arr,
             device) -> Optional[torch.Tensor]:
    """The kernel's tile-id operand (None: every tile), checked."""
    if block_ids_arr is not None:
        if block_ids is not None:
            raise ValueError(f"{name}: block_ids and block_ids_arr are exclusive")
        if block_ids_arr.dtype != torch.int32 or block_ids_arr.dim() != 1:
            raise ValueError(f"{name}: block_ids_arr must be (m,) int32")
        return block_ids_arr
    if block_ids is None:
        return None
    nb = -(-n // block)
    if not all(0 <= b < nb for b in block_ids):
        raise ValueError(f"{name}: block ids out of range {block_ids}")
    return torch.tensor(block_ids, dtype=torch.int32, device=device)


def filter_count_plain(cols: torch.Tensor, bounds: torch.Tensor, n_valid,
                       block_ids: Optional[tuple] = None, block: int = BLOCK,
                       block_ids_arr: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """cols: (k, n) int32; bounds: (k, 2) inclusive [lo, hi]. Count (int32)
    of rows i < n_valid with AND_k lo_k <= cols[k, i] <= hi_k, restricted to
    the listed row blocks when ``block_ids`` or ``block_ids_arr`` (int32,
    -1-padded) is given."""
    rows, live = _rows(cols.shape[1], block, block_ids, block_ids_arr,
                       cols.device)
    c = cols[:, rows]
    ok = ((c >= bounds[:, :1]) & (c <= bounds[:, 1:2])).all(dim=0)
    return (ok & live & (rows < n_valid)).sum(dtype=torch.int32)


def filter_count(cols: torch.Tensor, bounds: torch.Tensor, n_valid: int, *,
                 block: int = BLOCK, block_ids: Optional[tuple] = None,
                 block_ids_arr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel wrapper: same contract as :func:`filter_count_plain`,
    returns a 0-dim int32 tensor on the input's device."""
    if not cols.is_cuda:
        if cols.device.type != "cpu":
            raise ValueError(f"filter_count: unsupported device {cols.device}")
        return filter_count_plain(cols, bounds, n_valid, block_ids, block,
                                  block_ids_arr)
    k, n = cols.shape
    if cols.dtype != torch.int32 or bounds.dtype != torch.int32 \
            or tuple(bounds.shape) != (k, 2):
        raise ValueError("filter_count: cols (k, n) and bounds (k, 2) must be int32")
    ids = _id_list("filter_count", n, block, block_ids, block_ids_arr,
                   cols.device)
    _build.require_cuda("filter_count", cols, bounds,
                        *([ids] if ids is not None else []))
    out = torch.zeros((), dtype=torch.int32, device=cols.device)
    n_tiles = -(-n // block) if ids is None else ids.shape[0]
    if n_tiles == 0:
        return out
    fn = _build.function("fc_filter_count", _ARGS)
    rc = fn(cols.data_ptr(), k, n, bounds.data_ptr(), int(n_valid),
            ids.data_ptr() if ids is not None else None, n_tiles, block,
            out.data_ptr(), _build.stream_of(cols))
    _build.check(rc, "filter_count")
    _build.count_launch("filter_count")
    return out
