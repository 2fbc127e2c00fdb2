"""Error-feedback int8 gradient compression (port of the local half of
``repro.runtime.compress``), over nested dicts of tensors.

Per-leaf symmetric scaling (max-abs / 127) and an error-feedback
accumulator (the quantization residual is carried into the next step) cut
a data-parallel all-reduce's wire bytes 4x against float32 and keep
SGD / Adam converging. ``torch.round`` rounds half to even as
``jnp.round`` does, so every result equals the reference's bit for bit.

``compressed_psum`` is the data-parallel all-reduce over a mesh's data
shards (``launch/mesh.py``: every shard on one device): it takes the
shards' gradient and error trees in shard order and merges them with
``engine/distributed.py``'s collectives, as the reference's does inside
shard_map. It is elementwise work that the reference computes in jnp, so
it is plain torch here too. Across several cards (``torch.distributed``)
it waits for ROADMAP A9b.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.engine import distributed as D
from repro_torch.runtime.tree import flatten, tree_map, unflatten


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload, 0-d scale in ``x``'s dtype): ``x / scale`` rounded
    half to even into [-127, 127], ``scale = max(max|x|, 1e-12) / 127``."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_state(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def compress_grads(grads: Any, err: Any) -> tuple[Any, Any, Any]:
    """Error-feedback quantization: g' = Q(g + e); e' = (g + e) - deQ(g').

    Returns (quantized tree, scales tree, new error tree)."""
    def one(g, e):
        t = g.to(torch.float32) + e
        q, s = quantize(t)
        return q, s, t - dequantize(q, s)

    flat_g, treedef = flatten(grads)
    flat_e, err_def = flatten(err)
    if err_def != treedef:
        raise ValueError(f"error state {err_def} does not match the "
                         f"gradients' {treedef}")
    out = [one(g, e) for g, e in zip(flat_g, flat_e)]
    return tuple(unflatten(treedef, [o[i] for o in out]) for i in range(3))


def decompress_grads(qs: Any, ss: Any) -> Any:
    return tree_map(dequantize, qs, ss)


def compressed_psum(grads: list, err: list) -> tuple[Any, list]:
    """The int8 error-feedback all-reduce of the shards' gradient trees
    ``grads`` with their error trees ``err`` (lists in shard order).

    Every shard quantizes against one SHARED scale (``pmax`` of the local
    max-abs values) so the int32 ``psum`` of the int8 payloads dequantizes
    exactly: mean = total * s / n. Each shard's new error is t - q * s.
    Returns (the mean gradient tree every shard holds, the shards' new
    error trees); bit for bit the reference's formula."""
    if len(grads) != len(err) or not grads:
        raise ValueError(f"{len(grads)} gradient trees, {len(err)} error trees")
    flat, treedef = [], None
    for g, e in zip(grads, err):
        fg, gdef = flatten(g)
        fe, edef = flatten(e)
        if treedef is None:
            treedef = gdef
        if gdef != treedef or edef != treedef:
            raise ValueError(f"shard trees {gdef} / {edef} do not match "
                             f"{treedef}")
        flat.append((fg, fe))
    means, errs = [], [[] for _ in grads]
    for j in range(treedef.num_leaves):
        ts = [fg[j].to(torch.float32) + fe[j] for fg, fe in flat]
        # the divisors are tensors on the leaves' device: CUDA divides by a
        # host scalar as a product with its reciprocal, which can round apart
        # from the CPU's (and the reference's) division
        dev = ts[0].device
        n = D.psum([torch.ones((), dtype=torch.float32, device=dev)
                    for _ in ts])
        m = D.pmax([t.abs().max() for t in ts])
        s = torch.clamp(m, min=1e-12) / torch.full((), 127.0, device=dev)
        qs = [torch.clamp(torch.round(t / s), -127, 127).to(torch.int8)
              for t in ts]
        total = D.psum([q.to(torch.int32) for q in qs])   # the int8 payload
        means.append(total.to(torch.float32) * s / n)
        for i, (t, q) in enumerate(zip(ts, qs)):
            errs[i].append(t - q.to(torch.float32) * s)
    return unflatten(treedef, means), [unflatten(treedef, e) for e in errs]
