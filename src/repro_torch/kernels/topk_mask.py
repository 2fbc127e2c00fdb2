"""Masked per-block top-k and its merge (paper expression 9: ORDER BY ...
LIMIT k).

Replaces the Pallas TPU kernel ``repro/kernels/topk_mask.py:block_topk``
with the hand-written CUDA kernel ``csrc/topk_mask.cu``: one CUDA block per
4096-row block stages its masked scores in shared memory and runs k rounds
of a (value desc, index asc) successor search, so ties go to the lower
index. On the H100 the kernel is bound by bytes (score and mask read once);
the k rounds stay in shared memory.

The merge (``topk_merge``) is a stable descending sort of the block-major
(nb * k) candidates — outside the kernel, as in the reference, and stable
because ``torch.topk`` on CUDA does not promise the lowest-index tie order.

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
    fn = _build.function("tk_block_topk", _ARGS)
    rc = fn(scores.data_ptr(), mask.data_ptr(), n, int(n_valid), k, block, nb,
            vals.data_ptr(), idx.data_ptr(), _build.stream_of(scores))
    _build.check(rc, "block_topk")
    _build.count_launch("block_topk")
    return vals, idx


def topk_merge(scores: torch.Tensor, mask: torch.Tensor, n_valid: int, k: int,
               *, block: int = BLOCK) -> tuple[torch.Tensor, torch.Tensor]:
    """Full masked top-k: block_topk, then one stable descending sort of the
    (nb * k) candidates (block-major, so ties still go to the lower global
    index). Returns (values (k,), global indices (k,) int32)."""
    vals, idx = block_topk(scores, mask, n_valid, k, block=block)
    flat_v, flat_i = vals.reshape(-1), idx.reshape(-1)
    order = torch.sort(flat_v, descending=True, stable=True).indices[:k]
    return flat_v[order], flat_i[order]
