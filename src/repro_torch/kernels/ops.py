"""Kernel dispatch (port of ``repro.kernels.ops``): the relational kernels
and the two attention kernels of the model zoo.

Each op picks its backend from where its operands lie: CUDA tensors go to
the hand-written CUDA kernels, CPU tensors to their plain PyTorch versions
(the CPU path of kernel mode and the tests' bridge to the reference).
``DISPATCH_COUNTS`` ticks once per op call on either backend — the kernel
mode's tests assert the relational kernels are on the executed path; the
CUDA launch counts themselves live in ``_build.LAUNCHES``.

The reference's flash ops default to its jnp twins on every platform
(``backend="xla"``); here, as for the relational ops, the operand's device
decides, so on the card ``attn_impl="flash"`` launches the CUDA kernel.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import filter_count as _fc
from repro_torch.kernels import flash_attention as _fa
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


def shard_block_arrays(block_ids, zone_block: int, block: int, n_shards: int,
                       blocks_per_shard: int, rows_per_shard: int) -> np.ndarray:
    """Expand a flat shard-aware zone-block id tuple into the per-shard
    KERNEL-block id matrix: row ``s`` lists shard ``s``'s surviving local
    kernel-block ids (units of ``block`` rows over the shard's own chunk),
    ``-1``-padded at the END to the largest surviving count (at least 1,
    so every grid is non-empty; an all-``-1`` row is a shard with nothing
    to scan). The zone layout places flat block ``s * blocks_per_shard +
    j`` wholly inside shard ``s``, so the expansion never crosses a shard
    boundary. Row ``s`` is what shard ``s``'s launch takes as its
    ``block_ids_arr``."""
    assert zone_block % block == 0, (zone_block, block)
    r = zone_block // block
    nb_local = -(-rows_per_shard // block)
    per: list[list[int]] = [[] for _ in range(n_shards)]
    for b in block_ids:
        s, j = divmod(int(b), blocks_per_shard)
        per[s].extend(range(j * r, min((j + 1) * r, nb_local)))
    m = max(1, max(len(p) for p in per))
    out = np.full((n_shards, m), -1, np.int32)
    for s, p in enumerate(per):
        out[s, : len(p)] = p
    return out


def filter_count(cols: _fc.Columns, bounds: torch.Tensor, n_valid: int,
                 block_ids: Optional[tuple] = None,
                 block_ids_arr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``cols``: a (k, n) int32 matrix or a sequence of k (n,) int32
    columns (the compiler's form: nothing stacked). ``block_ids``:
    surviving zone blocks (a static tuple). ``block_ids_arr``: the
    per-shard alternative, a device int32 (m,) list already in the
    kernel's own block units, ``-1``-padded at the end; passed through as
    it is (the grid strides over its m entries), and exclusive with
    ``block_ids``."""
    device = (cols if isinstance(cols, torch.Tensor) else cols[0]).device
    if block_ids_arr is not None:
        _tick("filter_count", device, grid=int(block_ids_arr.shape[0]))
        return _fc.filter_count(cols, bounds, n_valid, block_ids=block_ids,
                                block_ids_arr=block_ids_arr)
    n = _fc.num_rows(cols)
    ids = _expand_block_ids(block_ids, ZONE_BLOCK_ROWS, _fc.BLOCK, n)
    nb = -(-n // _fc.BLOCK)
    _tick("filter_count", device,
          grid=len(ids) if ids is not None else nb, blocks_total=nb)
    return _fc.filter_count(cols, bounds, n_valid, block_ids=ids)


def segment_agg(values: torch.Tensor, gids: torch.Tensor, num_groups: int,
                n_valid: int, op: str = "sum",
                block_ids: Optional[tuple] = None,
                block_ids_arr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``block_ids`` / ``block_ids_arr`` as for :func:`filter_count`; the
    list in ``block_ids_arr`` is in segment_agg's own block units."""
    if block_ids_arr is not None:
        _tick("segment_agg", values.device, grid=int(block_ids_arr.shape[0]))
        return _sa.segment_agg(values, gids, num_groups, n_valid, op=op,
                               block_ids=block_ids,
                               block_ids_arr=block_ids_arr)
    ids = _expand_block_ids(block_ids, ZONE_BLOCK_ROWS, _sa.BLOCK,
                            values.shape[0])
    nb = -(-values.shape[0] // _sa.BLOCK)
    _tick("segment_agg", values.device,
          grid=len(ids) if ids is not None else nb, blocks_total=nb)
    return _sa.segment_agg(values, gids, num_groups, n_valid, op=op,
                           block_ids=ids)


def sort_join_keys(keys: torch.Tensor, mask: torch.Tensor,
                   presorted: bool = False) -> torch.Tensor:
    """Prepare one side for merge_join_count's contract: int32 keys, dead
    rows replaced by the INT32_MAX sentinel, ascending sort (skipped when
    the keys come from a sorted index: valid ascending, sentinel tail)."""
    if presorted:
        return keys.to(torch.int32)
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


class _FlashAttention(torch.autograd.Function):
    """The forward kernel under autograd, as the reference's ``custom_vjp``:
    the forward keeps q, k, v, out and lse; the backward is the B7 kernel
    (``flash_attention.flash_attention_bwd``), or its plain version on CPU
    tensors. Both passes are deterministic, so ``torch.utils.checkpoint``
    recomputes the same forward. The gradient of the output arrives as the
    caller made it: on the model path the (B,H,S,D) view of a contiguous
    (B,S,H,D) tensor, read in place; a layout the kernel cannot read (a
    broadcast gradient, an odd stride) is copied to a contiguous one
    first."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _fa.flash_mha_fwd(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        if _fa.layout_problem(grad_out) is not None:
            grad_out = grad_out.contiguous()
        _tick("flash_attention_bwd", q.device)
        dq, dk, dv = _fa.flash_attention_bwd(q, k, v, out, lse, grad_out,
                                             causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """GQA attention forward. q: (B,H,Sq,D); k, v: (B,KV,Skv,D) ->
    (B,H,Sq,D) in q's dtype. Unlike the reference's op it takes no q
    chunk: the kernel's q tile is fixed."""
    _tick("flash_attention", q.device)
    return _FlashAttention.apply(q, k, v, causal)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """Single-token decode attention. q: (B,H,D); k, v: (B,KV,S,D), any
    views the kernel reads in place (a layer's (B,S,KV,D) cache
    transposed); lengths: (B,) int32. Its model caller is
    ``models.attention.decode_attention`` under ``attn_impl="flash"``:
    every decode step of the dense, MoE and VLM transformers and of
    whisper's self-attention."""
    _tick("flash_decode", q.device)
    return _da.flash_decode(q, k, v, lengths)
