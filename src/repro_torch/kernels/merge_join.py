"""Sorted equi-join cardinality (paper expression 12).

Replaces the Pallas TPU kernel ``repro/kernels/merge_join.py:merge_join_count``
(a 2-D grid over left-block x right-block pairs) with the hand-written CUDA
kernel ``csrc/merge_join.cu``, which follows the merge path: each block takes
one left tile, binary-searches the right array for the tile's key range, and
counts equal keys only inside that window. On the H100 the kernel is bound by
bytes — each key read once — where the pair grid would be ~24M block pairs at
5M rows. The count is an exact int32.

Contract (as ``repro.kernels.ops``): both key arrays sorted ascending, valid
prefixes of length ``nl`` / ``nr``, INT32_MAX padding after. ``nl`` and
``nr`` may be device scalars, so the launch needs no host sync.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

BLOCK = 1024

_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p]


def merge_join_count_plain(lkeys: torch.Tensor, rkeys: torch.Tensor, nl,
                           nr) -> torch.Tensor:
    """Σ_{i<nl, j<nr} [lkeys_i == rkeys_j] (int32) over sorted keys, by two
    binary searches per left key."""
    lo = torch.searchsorted(rkeys, lkeys, side="left")
    hi = torch.minimum(torch.searchsorted(rkeys, lkeys, side="right"),
                       torch.as_tensor(nr, device=rkeys.device))
    lm = torch.arange(lkeys.shape[0], device=lkeys.device) < nl
    return torch.where(lm, (hi - lo).clamp(min=0), 0).sum(dtype=torch.int32)


def merge_join_count(lkeys: torch.Tensor, rkeys: torch.Tensor, nl, nr, *,
                     block: int = BLOCK) -> torch.Tensor:
    """The kernel wrapper: same contract as :func:`merge_join_count_plain`;
    returns a 0-dim int32 tensor."""
    if not lkeys.is_cuda:
        if lkeys.device.type != "cpu":
            raise ValueError(f"merge_join_count: unsupported device {lkeys.device}")
        return merge_join_count_plain(lkeys, rkeys, nl, nr)
    dev = lkeys.device
    if lkeys.dtype != torch.int32 or rkeys.dtype != torch.int32:
        raise ValueError("merge_join_count: keys must be int32")
    nl_t = torch.as_tensor(nl, dtype=torch.int32, device=dev).reshape(())
    nr_t = torch.as_tensor(nr, dtype=torch.int32, device=dev).reshape(())
    _build.require_cuda("merge_join_count", lkeys, rkeys, nl_t, nr_t)
    out = torch.zeros((), dtype=torch.int32, device=dev)
    fn = _build.function("mj_merge_join_count", _ARGS)
    rc = fn(lkeys.data_ptr(), lkeys.shape[0], rkeys.data_ptr(), rkeys.shape[0],
            nl_t.data_ptr(), nr_t.data_ptr(), block, out.data_ptr(),
            _build.stream_of(lkeys))
    _build.check(rc, "merge_join_count")
    _build.count_launch("merge_join_count")
    return out
