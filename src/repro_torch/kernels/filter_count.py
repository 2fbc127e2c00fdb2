"""Fused multi-predicate filter + count (paper expressions 3 and 11).

Replaces the Pallas TPU kernel ``repro/kernels/filter_count.py:filter_count``
with the hand-written CUDA kernel ``csrc/filter_count.cu``: a persistent
grid sized by the occupancy calculator streams the k predicate columns in
16-byte groups and counts in registers, one atomicAdd per warp. The
columns come as a (k, n) int32 matrix (the reference's form) or as a
sequence of k (n,) int32 columns, read through their own pointers, so the
caller stacks nothing; past ``MAX_COLS`` columns the wrapper stacks a
sequence into one matrix. Bounds are a device operand, so new literals
never rebuild anything. An optional list of surviving ``block``-row tile
ids restricts the pass, so skipped tiles are never read: a static tuple
(``block_ids``), or a device int32 list ``-1``-padded at the end
(``block_ids_arr``, the per-shard form of ``repro.kernels.ops``), whose pad
entries the kernel skips with no host sync. On the H100 the kernel is bound
by bytes — k int32 columns read once.

``filter_count`` launches the kernel for CUDA tensors and runs
``filter_count_plain`` for CPU tensors; it never runs the plain version on
the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Union

import torch

from repro_torch.kernels import _build

BLOCK = 4096

MAX_COLS = 16  # csrc/filter_count.cu kMaxCols: columns passed by pointer

_ARGS = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int64,
         ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p]

Columns = Union[torch.Tensor, Sequence[torch.Tensor]]


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


def num_rows(cols: Columns) -> int:
    """n of a (k, n) matrix or of a sequence of (n,) columns."""
    return cols.shape[1] if isinstance(cols, torch.Tensor) else cols[0].shape[0]


def filter_count_plain(cols: Columns, bounds: torch.Tensor, n_valid,
                       block_ids: Optional[tuple] = None, block: int = BLOCK,
                       block_ids_arr: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """cols: (k, n) int32, or k (n,) int32 columns; bounds: (k, 2)
    inclusive [lo, hi]. Count (int32) of rows i < n_valid with AND_k
    lo_k <= cols[k][i] <= hi_k, restricted to the listed row blocks when
    ``block_ids`` or ``block_ids_arr`` (int32, -1-padded) is given."""
    first = cols if isinstance(cols, torch.Tensor) else cols[0]
    rows, live = _rows(num_rows(cols), block, block_ids, block_ids_arr,
                       first.device)
    ok = live & (rows < n_valid)
    for col, (lo, hi) in zip(cols, bounds):
        v = col[rows]
        ok &= (v >= lo) & (v <= hi)
    return ok.sum(dtype=torch.int32)


def filter_count(cols: Columns, bounds: torch.Tensor, n_valid: int, *,
                 block: int = BLOCK, block_ids: Optional[tuple] = None,
                 block_ids_arr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel wrapper: same contract as :func:`filter_count_plain`,
    returns a 0-dim int32 tensor on the input's device."""
    matrix = isinstance(cols, torch.Tensor)
    if not matrix:
        cols = list(cols)
        if not cols:
            raise ValueError("filter_count: no columns")
    first = cols if matrix else cols[0]
    if not first.is_cuda:
        if first.device.type != "cpu":
            raise ValueError(f"filter_count: unsupported device {first.device}")
        return filter_count_plain(cols, bounds, n_valid, block_ids, block,
                                  block_ids_arr)
    if matrix and cols.dim() != 2 or not matrix and any(
            c.dim() != 1 or c.shape[0] != cols[0].shape[0] for c in cols):
        raise ValueError("filter_count: cols must be (k, n) or k (n,) columns")
    k, n = len(cols), num_rows(cols)
    if any(c.dtype != torch.int32 for c in ([cols] if matrix else cols)) \
            or bounds.dtype != torch.int32 or tuple(bounds.shape) != (k, 2):
        raise ValueError("filter_count: cols and bounds (k, 2) must be int32")
    if not matrix and k > MAX_COLS:
        cols, matrix = torch.stack(cols), True
    ids = _id_list("filter_count", n, block, block_ids, block_ids_arr,
                   first.device)
    operands = [cols] if matrix else cols
    _build.require_cuda("filter_count", *operands, bounds,
                        *([ids] if ids is not None else []))
    out = torch.zeros((), dtype=torch.int32, device=first.device)
    if ids is not None and ids.shape[0] == 0:
        return out
    ptrs = (ctypes.c_void_p * len(operands))(*[c.data_ptr() for c in operands])
    fn = _build.function("fc_filter_count", _ARGS)
    rc = fn(ptrs, k, n if matrix else 0, n, bounds.data_ptr(), int(n_valid),
            ids.data_ptr() if ids is not None else None,
            ids.shape[0] if ids is not None else 0, block,
            _build.sm_count(first.device), out.data_ptr(),
            _build.stream_of(first))
    _build.check(rc, "filter_count")
    _build.count_launch("filter_count")
    return out
