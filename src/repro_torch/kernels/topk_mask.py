"""Masked per-block top-k and its merge (paper expression 9: ORDER BY ...
LIMIT k).

Replaces the Pallas TPU kernel ``repro/kernels/topk_mask.py:block_topk``
and the merge after it with the hand-written CUDA kernels of
``csrc/topk_mask.cu``. For k <= 16: four warps per
4096-row block read its scores and mask once in 16-byte and 4-byte loads;
each warp keeps its best k rows so far across its lanes, starting from
the best k of its lanes' own best rows, and lets in only rows that beat
the k-th, best first (value desc, index asc: ties to the lower index);
the four lists meet in shared memory. Above 16, a block per tile runs k
rounds of a successor search over its staged scores. ``topk_merge`` then
launches one block that walks the blocks' sorted candidate lists and takes
the k best of the (nb * k) candidates in the same order — bit for bit what
a stable descending sort of the block-major list gives. On the H100 the
block kernel is bound by bytes (score and mask read once).

The CPU plain versions: a stable sort per block, and a stable descending
sort of the candidates.

Known difference from the Pallas kernel: a block with fewer than k live rows
pads its candidates with -inf; the Pallas kernel repeats the index
``base + 0`` for them, while this kernel (like ``repro.kernels.ref``) gives
the next distinct indices. Finite candidates agree exactly; the engine masks
the rest.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

BLOCK = 4096

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p]
_MERGE_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p]


def _masked(scores: torch.Tensor, mask: torch.Tensor, n_valid) -> torch.Tensor:
    live = mask & (torch.arange(scores.shape[0], device=scores.device) < n_valid)
    return torch.where(live, scores.to(torch.float32),
                       torch.tensor(float("-inf"), device=scores.device))


def block_topk_plain(scores: torch.Tensor, mask: torch.Tensor, n_valid, k: int,
                     block: int = BLOCK) -> tuple[torch.Tensor, torch.Tensor]:
    """scores (n,), mask (n,) -> per-block (values (nb, k) float32, global
    indices (nb, k) int32): the k largest masked scores of each block, ties
    to the lower index (a stable descending sort)."""
    n = scores.shape[0]
    nb = -(-n // block)
    s = torch.nn.functional.pad(_masked(scores, mask, n_valid),
                                (0, nb * block - n), value=float("-inf"))
    v, i = torch.sort(s.view(nb, block), dim=1, descending=True, stable=True)
    base = torch.arange(nb, device=scores.device)[:, None] * block
    return v[:, :k].contiguous(), (i[:, :k] + base).to(torch.int32)


def block_topk(scores: torch.Tensor, mask: torch.Tensor, n_valid: int, k: int,
               *, block: int = BLOCK) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel wrapper: same contract as :func:`block_topk_plain`."""
    if not scores.is_cuda:
        if scores.device.type != "cpu":
            raise ValueError(f"block_topk: unsupported device {scores.device}")
        return block_topk_plain(scores, mask, n_valid, k, block)
    n = scores.shape[0]
    if scores.dtype != torch.float32 or mask.dtype != torch.bool \
            or tuple(mask.shape) != (n,) or not 1 <= k <= block:
        raise ValueError("block_topk: scores (n,) float32, mask (n,) bool, "
                         "1 <= k <= block")
    _build.require_cuda("block_topk", scores, mask)
    nb = -(-n // block)
    vals = torch.empty((nb, k), dtype=torch.float32, device=scores.device)
    idx = torch.empty((nb, k), dtype=torch.int32, device=scores.device)
    if nb == 0:
        return vals, idx
    fn = _build.function("tk_block_topk", _ARGS)
    rc = fn(scores.data_ptr(), mask.data_ptr(), n, int(n_valid), k, block, nb,
            vals.data_ptr(), idx.data_ptr(), _build.stream_of(scores))
    _build.check(rc, "block_topk")
    _build.count_launch("block_topk")
    return vals, idx


def merge_candidates_plain(vals: torch.Tensor, idx: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(nb, k) candidates -> the k best (values (k,), indices (k,)): a
    stable descending sort of the block-major list."""
    k = vals.shape[1]
    flat_v, flat_i = vals.reshape(-1), idx.reshape(-1)
    order = torch.sort(flat_v, descending=True, stable=True).indices[:k]
    return flat_v[order], flat_i[order]


def merge_candidates(vals: torch.Tensor, idx: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The merge kernel's wrapper: same contract as
    :func:`merge_candidates_plain` on :func:`block_topk`'s output."""
    if not vals.is_cuda:
        if vals.device.type != "cpu":
            raise ValueError(f"topk_merge: unsupported device {vals.device}")
        return merge_candidates_plain(vals, idx)
    if vals.dtype != torch.float32 or idx.dtype != torch.int32 \
            or vals.dim() != 2 or idx.shape != vals.shape:
        raise ValueError("topk_merge: vals (nb, k) float32, idx (nb, k) int32")
    nb, k = vals.shape
    heads = torch.empty(nb, dtype=torch.int32, device=vals.device)  # scratch
    _build.require_cuda("topk_merge", vals, idx, heads)
    out_v = torch.empty(min(k, nb * k), dtype=torch.float32, device=vals.device)
    out_i = torch.empty(min(k, nb * k), dtype=torch.int32, device=vals.device)
    if nb == 0:
        return out_v, out_i
    fn = _build.function("tk_topk_merge", _MERGE_ARGS)
    rc = fn(vals.data_ptr(), idx.data_ptr(), nb, k, heads.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), _build.stream_of(vals))
    _build.check(rc, "topk_merge")
    _build.count_launch("topk_merge")
    return out_v, out_i


def topk_merge(scores: torch.Tensor, mask: torch.Tensor, n_valid: int, k: int,
               *, block: int = BLOCK) -> tuple[torch.Tensor, torch.Tensor]:
    """Full masked top-k: block_topk, then the merge of the (nb * k)
    candidates (ties to the lower global index). Returns (values (k,),
    global indices (k,) int32)."""
    vals, idx = block_topk(scores, mask, n_valid, k, block=block)
    return merge_candidates(vals, idx)
