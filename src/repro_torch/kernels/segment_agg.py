"""Group-by aggregation: per-group sum / max / min (paper expressions 4, 8).

Replaces the Pallas TPU kernel ``repro/kernels/segment_agg.py:segment_agg``
(a one-hot matmul on the MXU per 2048-row tile) with the hand-written CUDA
kernels of ``csrc/segment_agg.cu``: a grid sized by the occupancy
calculator streams the rows with 16-byte loads into copies of the (G, C)
cells in shared memory — a private copy per lane up to 227 cells (plain
loads and stores, no atomics), a copy per warp with shared atomics up to
7,264 — and each block writes its partial (G, C) to scratch; a second
kernel folds the partials in a fixed order into every output cell. Past
7,264 cells the output is filled with the identity and updated with global
atomics instead. On the H100 the kernels are bound by bytes — values and
group ids read once.

Sums are plain float32 (never TF32). With lane-private copies the order of
the adds is fixed by the data and the grid, so they repeat bit for bit;
they are exact on integer-valued data whose partials stay below 2^24, and
on general data within float32 rounding of any other order — 1e-5 of the
group's sum of |x| plus 1e-3 (at the reference's test sizes, rtol 1e-5 /
atol 1e-3 of the sum). Max and min are exact.

Tiles are ``block`` rows. ``block_ids`` (a static tuple) or
``block_ids_arr`` (a device int32 list, ``-1``-padded at the end: the
per-shard form of ``repro.kernels.ops``) restrict the pass to the listed
tiles; the kernel skips pad entries with no host sync.

``segment_agg`` launches the kernels for CUDA tensors and runs
``segment_agg_plain`` for CPU tensors; it never runs the plain version on
the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.filter_count import _id_list, _rows

BLOCK = 2048

_OPS = {"sum": 0, "max": 1, "min": 2}
IDENTITY = {"sum": 0.0, "max": float("-inf"), "min": float("inf")}

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p]


def segment_agg_plain(values: torch.Tensor, gids: torch.Tensor,
                      num_groups: int, n_valid, op: str = "sum",
                      block_ids: Optional[tuple] = None,
                      block: int = BLOCK,
                      block_ids_arr: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """values: (n, c) float32; gids: (n,) int32 -> (num_groups, c) float32
    per-group ``op``-reductions over rows i < n_valid with a gid in
    [0, num_groups), restricted to the listed row blocks when ``block_ids``
    or ``block_ids_arr`` (int32, -1-padded) is given. Empty groups hold the
    identity (0 / -inf / +inf)."""
    rows, live = _rows(values.shape[0], block, block_ids, block_ids_arr,
                       values.device)
    v, g = values[rows].to(torch.float32), gids[rows]
    live = live & (rows < n_valid) & (g >= 0) & (g < num_groups)
    v, g = v[live], g[live].to(torch.int64)
    out = torch.full((num_groups, values.shape[1]), IDENTITY[op],
                     dtype=torch.float32, device=values.device)
    if op == "sum":
        return out.index_add_(0, g, v)
    idx = g[:, None].expand_as(v)
    return out.scatter_reduce_(0, idx, v, "amax" if op == "max" else "amin")


def segment_agg(values: torch.Tensor, gids: torch.Tensor, num_groups: int,
                n_valid: int, *, op: str = "sum", block: int = BLOCK,
                block_ids: Optional[tuple] = None,
                block_ids_arr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel wrapper: same contract as :func:`segment_agg_plain`."""
    if op not in _OPS:
        raise ValueError(f"segment_agg: unknown op {op!r}")
    if not values.is_cuda:
        if values.device.type != "cpu":
            raise ValueError(f"segment_agg: unsupported device {values.device}")
        return segment_agg_plain(values, gids, num_groups, n_valid, op,
                                 block_ids, block, block_ids_arr)
    n, c = values.shape
    if values.dtype != torch.float32 or gids.dtype != torch.int32 \
            or tuple(gids.shape) != (n,) or num_groups < 1 or c < 1:
        raise ValueError("segment_agg: values (n, c) float32, gids (n,) int32")
    ids = _id_list("segment_agg", n, block, block_ids, block_ids_arr,
                   values.device)
    _build.require_cuda("segment_agg", values, gids,
                        *([ids] if ids is not None else []))
    fn = _build.function("sa_segment_agg", _ARGS)
    scratch_floats = _build.function(
        "sa_scratch_floats", [ctypes.c_int] * 4, restype=ctypes.c_int64)
    n_tiles = -(-n // block) if ids is None else ids.shape[0]
    sms = _build.sm_count(values.device)
    scratch = torch.empty(scratch_floats(num_groups, c, n_tiles, sms),
                          dtype=torch.float32, device=values.device)
    out = torch.empty((num_groups, c), dtype=torch.float32, device=values.device)
    rc = fn(values.data_ptr(), c, gids.data_ptr(), n, int(n_valid), num_groups,
            _OPS[op], ids.data_ptr() if ids is not None else None, n_tiles,
            block, sms, scratch.data_ptr(), out.data_ptr(),
            _build.stream_of(values))
    _build.check(rc, "segment_agg")
    _build.count_launch("segment_agg")
    return out
