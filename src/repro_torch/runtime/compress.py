"""Error-feedback int8 gradient compression (port of the local half of
``repro.runtime.compress``), over nested dicts of tensors.

Per-leaf symmetric scaling (max-abs / 127) and an error-feedback
accumulator (the quantization residual is carried into the next step) cut
a data-parallel all-reduce's wire bytes 4x against float32 and keep
SGD / Adam converging. ``torch.round`` rounds half to even as
``jnp.round`` does, so every result equals the reference's bit for bit.

``compressed_psum`` is the data-parallel all-reduce over a mesh's data
shards, merged with ``engine/distributed.py``'s collectives as the
reference's is inside shard_map: on the one-process mesh it takes the
shards' gradient and error trees in shard order; on a rank mesh
(``group=``, the data axes' process group) this rank's trees, and the
int32 sum of the int8 payloads is a ``dist.all_reduce``. Integer sums do
not depend on their order, so both forms give the same bits. It is
elementwise work that the reference computes in jnp, so it is plain
torch here too.
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


def _compressed_leaf(ts: list, psum, pmax) -> tuple[torch.Tensor, list]:
    """One leaf of :func:`compressed_psum`: ``ts`` are the parts merged
    here (every shard's, or this rank's alone), ``psum`` / ``pmax`` the
    collectives over the data shards. Returns (mean, the parts' new
    errors)."""
    # the divisors are tensors on the leaves' device: CUDA divides by a
    # host scalar as a product with its reciprocal, which can round apart
    # from the CPU's (and the reference's) division
    dev = ts[0].device
    n = psum([torch.ones((), dtype=torch.float32, device=dev) for _ in ts])
    m = pmax([t.abs().max() for t in ts])
    s = torch.clamp(m, min=1e-12) / torch.full((), 127.0, device=dev)
    qs = [torch.clamp(torch.round(t / s), -127, 127).to(torch.int8) for t in ts]
    total = psum([q.to(torch.int32) for q in qs])   # the int8 payload
    return total.to(torch.float32) * s / n, \
        [t - q.to(torch.float32) * s for t, q in zip(ts, qs)]


def compressed_psum(grads, err, group=None) -> tuple[Any, Any]:
    """The int8 error-feedback all-reduce of the data shards' gradients.

    Every shard quantizes against one SHARED scale (``pmax`` of the local
    max-abs values) so the int32 ``psum`` of the int8 payloads dequantizes
    exactly: mean = total * s / n. Each shard's new error is t - q * s;
    bit for bit the reference's formula.

    One-process mesh (``group=None``): ``grads`` and ``err`` are the
    shards' trees in shard order; returns (the mean tree every shard
    holds, the shards' new error trees). Rank mesh: ``grads`` and ``err``
    are this rank's trees and ``group`` the data axes' process group;
    returns (the mean tree, this rank's new error tree)."""
    if group is not None:
        fg, treedef = flatten(grads)
        fe, edef = flatten(err)
        if edef != treedef:
            raise ValueError(f"error state {edef} does not match the "
                             f"gradients' {treedef}")
        sum_ = lambda xs: D.psum(xs[0], group=group)  # noqa: E731
        max_ = lambda xs: D.pmax(xs[0], group=group)  # noqa: E731
        out = [_compressed_leaf([g.to(torch.float32) + e], sum_, max_)
               for g, e in zip(fg, fe)]
        return unflatten(treedef, [m for m, _ in out]), \
            unflatten(treedef, [e[0] for _, e in out])
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
        mean, new_err = _compressed_leaf(
            [fg[j].to(torch.float32) + fe[j] for fg, fe in flat], D.psum, D.pmax)
        means.append(mean)
        for i, e in enumerate(new_err):
            errs[i].append(e)
    return unflatten(treedef, means), [unflatten(treedef, e) for e in errs]
