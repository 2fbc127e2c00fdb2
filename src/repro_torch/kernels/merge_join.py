"""Sorted equi-join cardinality (paper expression 12).

Replaces the Pallas TPU kernel ``repro/kernels/merge_join.py:merge_join_count``
(a 2-D grid over left-block x right-block pairs) with the hand-written CUDA
kernels of ``csrc/merge_join.cu``. The left keys are cut into tiles of
``tile()`` keys (2,048, the kernel's own). A partition pass finds each
tile's right window — ``[lower(first key), upper(last key))`` over the
valid right prefix — by a 32-way warp search; then one block per tile
stages its window in shared memory (when it holds at most 6,144 keys) and
each thread counts its 8 consecutive left keys against it: the first key's
run of equal right keys by an exponential search from the key's place in
the tile scaled to the window, each later key's by a few linear steps from
where the last run ended, then the same search. A larger window is walked
the same way in device memory. On the H100 the kernels are bound by bytes —
each key read once — where the pair grid would be ~24M block pairs at 5M
rows. The count is exact for any number of duplicates, summed in int64 and
returned as the int32 the plain version's int32 sum gives.

Contract (as ``repro.kernels.ops``): both key arrays sorted ascending, valid
prefixes of length ``nl`` / ``nr``, INT32_MAX padding after; only positions
below ``nl`` / ``nr`` count, so a prefix may cut a run of equal keys.
``nl`` and ``nr`` may be device scalars, so the launch needs no host sync.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p]


@functools.cache
def tile() -> int:
    """Left keys per tile of the CUDA kernel (``csrc/merge_join.cu``)."""
    return _build.function("mj_tile", [])()


def merge_join_count_plain(lkeys: torch.Tensor, rkeys: torch.Tensor, nl,
                           nr) -> torch.Tensor:
    """Σ_{i<nl, j<nr} [lkeys_i == rkeys_j] (int32) over sorted keys, by two
    binary searches per left key."""
    lo = torch.searchsorted(rkeys, lkeys, side="left")
    hi = torch.minimum(torch.searchsorted(rkeys, lkeys, side="right"),
                       torch.as_tensor(nr, device=rkeys.device))
    lm = torch.arange(lkeys.shape[0], device=lkeys.device) < nl
    return torch.where(lm, (hi - lo).clamp(min=0), 0).sum(dtype=torch.int32)


def merge_join_count(lkeys: torch.Tensor, rkeys: torch.Tensor, nl,
                     nr) -> torch.Tensor:
    """The kernel wrapper: same contract as :func:`merge_join_count_plain`;
    returns a 0-dim int32 tensor."""
    if not lkeys.is_cuda:
        if lkeys.device.type != "cpu":
            raise ValueError(f"merge_join_count: unsupported device {lkeys.device}")
        return merge_join_count_plain(lkeys, rkeys, nl, nr)
    dev = lkeys.device
    if lkeys.dtype != torch.int32 or rkeys.dtype != torch.int32 \
            or lkeys.dim() != 1 or rkeys.dim() != 1:
        raise ValueError("merge_join_count: keys must be (n,) int32")
    nl_t = torch.as_tensor(nl, dtype=torch.int32, device=dev).reshape(())
    nr_t = torch.as_tensor(nr, dtype=torch.int32, device=dev).reshape(())
    _build.require_cuda("merge_join_count", lkeys, rkeys, nl_t, nr_t)
    out = torch.zeros((), dtype=torch.int32, device=dev)
    n_tiles = -(-lkeys.shape[0] // tile())
    if n_tiles == 0:
        return out
    win = torch.empty(2 * n_tiles, dtype=torch.int64, device=dev)
    fn = _build.function("mj_merge_join_count", _ARGS)
    rc = fn(lkeys.data_ptr(), lkeys.shape[0], rkeys.data_ptr(), rkeys.shape[0],
            nl_t.data_ptr(), nr_t.data_ptr(), win.data_ptr(),
            out.data_ptr(), _build.stream_of(lkeys))
    _build.check(rc, "merge_join_count")
    _build.count_launch("merge_join_count")
    return out
