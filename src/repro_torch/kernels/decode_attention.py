"""Flash-decode: one-token GQA attention against a KV cache, masked at each
sequence's valid length.

Replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py:flash_decode`` with the hand-written
CUDA kernels of ``csrc/decode_attention.cu``: the cache walk is split into
slices of ``split_size(B, KV, S)`` slots, one thread block per (b, kv
head, slice), each writing a partial online-softmax state (m, l, acc) to
float32 scratch; a second kernel merges the slices. A slice reads only the
slots below the length (all S for a length of 0, whose reference output is
the uniform mean of V); a slice wholly past the length adds nothing. See
the source's header for its bound on the H100.

The kernels take strides: q may be any (B,H,D) view and k, v any
(B,KV,S,D) views whose last dimension has stride 1 and whose other strides
and base addresses are 16-byte aligned (``flash_attention.check_layout``),
such as the transposed (B,S,KV,D) layer cache the decode path writes. A
layout the kernel cannot take raises; nothing is copied to make it fit.

``flash_decode`` launches the kernels for CUDA tensors and runs
``flash_decode_plain`` (a port of ``repro.kernels.ref.decode_attention``)
for CPU tensors; it never runs the plain version on the card: on "meta"
tensors it returns an empty meta output and launches nothing.
:func:`flash_decode_cost` gives the operations and bytes its work needs.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import _DTYPES, NEG, check_layout

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
TARGET_BLOCKS = 132 * 16   # the H100's SMs, 16 blocks of 4 warps each
# Slices are rounded up to multiples of SPLIT_ROWS slots. That need not be
# a whole number of the split kernel's steps (4 warps x rows per warp load
# x rows per lane group: 128 slots for a 64-dim bf16 row with one q head
# per kv head, 512 for D = 16 bf16); the kernel bounds each step at the
# slice's end, so a slice's last step may run partly idle, never wrong.
SPLIT_ROWS = 64


def split_size(B: int, KV: int, S: int) -> int:
    """Cache slots per slice: enough slices that B*KV*slices blocks fill
    the card about TARGET_BLOCKS / 132 times over, each a multiple of
    SPLIT_ROWS slots, and at most 65535 slices (the grid's y extent)."""
    splits = min(-(-TARGET_BLOCKS // max(B * KV, 1)), -(-S // SPLIT_ROWS),
                 65535)
    per_split = -(-S // splits)
    return -(-per_split // SPLIT_ROWS) * SPLIT_ROWS


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """q: (B,H,D); k, v: (B,KV,S,D); lengths: (B,) valid cache length per
    sequence -> (B,H,D) in q's dtype. A length of 0 masks every slot alike,
    which gives the uniform mean of V."""
    B, H, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, D)
    s = torch.einsum("bkgd,bksd->bkgs", qg.float(), k.float()) / math.sqrt(D)
    m = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(m[:, None, None], s, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    return o.reshape(B, H, D).to(q.dtype)


def flash_decode_cost(q: torch.Tensor, k: torch.Tensor,
                      lengths: torch.Tensor | None) -> dict:
    """The kernels' work: the slots walked, 2 products of 2 flops a (q
    head, walked slot, head dim) element, and the bytes: the walked
    slots' K and V, q and out read or written once, and the int32
    lengths. A slice walks the slots below its sequence's length, and
    all S of a length of 0; with ``lengths`` None (the cost model, which
    reads no data) every slot is walked."""
    B, H, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    if lengths is None:
        walked = B * S
    else:
        walked = int(torch.where(lengths > 0, lengths.clamp(max=S), S).sum())
    nbytes = (2 * walked * KV * D + 2 * q.numel()) * q.element_size() + B * 4
    return {"flops": 2 * 2 * walked * H * D, "bytes": nbytes, "walked": walked}


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """The kernel wrapper: same contract as :func:`flash_decode_plain`."""
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_decode: q (B,H,D), k and v (B,KV,S,D)")
    B, H, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KV == 0 or H % KV or S == 0:
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, "
                         f"k/v {tuple(k.shape)} do not form GQA")
    if tuple(lengths.shape) != (B,) or lengths.dtype != torch.int32:
        raise ValueError("flash_decode: lengths (B,) int32")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_decode: q, k, v all float32 or all bfloat16")
    meta = q.device.type == "meta"
    if not q.is_cuda and not meta:
        if q.device.type != "cpu":
            raise ValueError(f"flash_decode: unsupported device {q.device}")
        return flash_decode_plain(q, k, v, lengths)
    check_layout(q, k, v, name="flash_decode")
    if lengths.device != q.device or not lengths.is_contiguous():
        raise ValueError(f"flash_decode: lengths must be contiguous on {q.device}")
    split = split_size(B, KV, S)
    n_split = -(-S // split)
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    if meta:
        return out
    part_acc = torch.empty(B * H * n_split * D, dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty(B * H * n_split * 2, dtype=torch.float32,
                          device=q.device)
    strides = (ctypes.c_int64 * 8)(*q.stride()[:2], *k.stride()[:3],
                                   *v.stride()[:3])
    fn = _build.function("fd_flash_decode", _ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
            _DTYPES[q.dtype], B, H, KV, S, D, split, ctypes.addressof(strides),
            1.0 / math.sqrt(D), _build.stream_of(q))
    _build.check(rc, "flash_decode")
    _build.count_launch("flash_decode")
    return out
