"""Fused multi-predicate filter + count (paper expressions 3 and 11).

Replaces the Pallas TPU kernel ``repro/kernels/filter_count.py:filter_count``
with the hand-written CUDA kernel ``csrc/filter_count.cu``: one CUDA block
per 4096-row tile (the zone-map block), bounds as a device operand so new
literals never rebuild anything, and an optional static list of surviving
tile ids that becomes the grid, so skipped tiles are never read. On the
H100 the kernel is bound by bytes — k int32 columns read once — and its
design reads each byte once and writes one int32.

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


def _rows(n: int, block: int, block_ids) -> torch.Tensor:
    """Original row indices the pass visits (all rows, or the listed blocks)."""
    if block_ids is None:
        return torch.arange(n)
    return torch.cat([torch.arange(b * block, min((b + 1) * block, n))
                      for b in block_ids])


def filter_count_plain(cols: torch.Tensor, bounds: torch.Tensor, n_valid,
                       block_ids: Optional[tuple] = None,
                       block: int = BLOCK) -> torch.Tensor:
    """cols: (k, n) int32; bounds: (k, 2) inclusive [lo, hi]. Count (int32)
    of rows i < n_valid with AND_k lo_k <= cols[k, i] <= hi_k, restricted to
    the listed row blocks when ``block_ids`` is given."""
    rows = _rows(cols.shape[1], block, block_ids).to(cols.device)
    c = cols[:, rows]
    ok = ((c >= bounds[:, :1]) & (c <= bounds[:, 1:2])).all(dim=0)
    return (ok & (rows < n_valid)).sum(dtype=torch.int32)


def filter_count(cols: torch.Tensor, bounds: torch.Tensor, n_valid: int, *,
                 block: int = BLOCK,
                 block_ids: Optional[tuple] = None) -> torch.Tensor:
    """The kernel wrapper: same contract as :func:`filter_count_plain`,
    returns a 0-dim int32 tensor on the input's device."""
    if not cols.is_cuda:
        if cols.device.type != "cpu":
            raise ValueError(f"filter_count: unsupported device {cols.device}")
        return filter_count_plain(cols, bounds, n_valid, block_ids, block)
    k, n = cols.shape
    if cols.dtype != torch.int32 or bounds.dtype != torch.int32 \
            or tuple(bounds.shape) != (k, 2):
        raise ValueError("filter_count: cols (k, n) and bounds (k, 2) must be int32")
    nb = -(-n // block)
    ids = None
    if block_ids is not None:
        if not all(0 <= b < nb for b in block_ids):
            raise ValueError(f"filter_count: block ids out of range {block_ids}")
        ids = torch.tensor(block_ids, dtype=torch.int32, device=cols.device)
    _build.require_cuda("filter_count", cols, bounds,
                        *([ids] if ids is not None else []))
    out = torch.zeros((), dtype=torch.int32, device=cols.device)
    fn = _build.function("fc_filter_count", _ARGS)
    rc = fn(cols.data_ptr(), k, n, bounds.data_ptr(), int(n_valid),
            ids.data_ptr() if ids is not None else None,
            len(block_ids) if block_ids is not None else nb, block,
            out.data_ptr(), _build.stream_of(cols))
    _build.check(rc, "filter_count")
    _build.count_launch("filter_count")
    return out
