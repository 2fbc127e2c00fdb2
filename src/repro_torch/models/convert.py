"""Carry the JAX package's parameters into the port's modules.

The reference keeps parameters as a dict pytree with every layer's arrays
stacked on a leading L axis (``params["layers"]["attn"]["wq"]`` is
(L, d, H*hd); MoE experts (L, E, d, fe)). The caller hands that pytree over
with numpy arrays at the leaves (``jax.tree_util.tree_map(np.asarray,
params)``), so this module never imports JAX.

Layout: the one place it is decided. Both packages compute ``x @ w`` with
projection weights stored (in, out); the port keeps that layout in plain
``nn.Parameter``s rather than ``nn.Linear`` (whose weight is (out, in)), so
no weight is transposed on the way across. Every port module names its
parameters and submodules as the reference names its keys, and a stacked
key (``layers``, ``first_layers``, ``enc_layers``, ``dec_layers``) is an
``nn.ModuleList`` whose block i takes index i of every leaf below it.
Arrays that are stacked in the port too (experts (E, d, fe), the hybrid's
per-invocation ``inv_proj`` (n_inv, d, d)) are copied whole. A key of the
reference with no home in the port, or a port parameter with no reference
key, raises.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import LM

STACKED = ("layers", "first_layers", "enc_layers", "dec_layers")


def _copy(dst: nn.Parameter, src, where: str) -> None:
    src = np.array(src, dtype=np.float32)  # a writable copy
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{where}: shape {src.shape} does not fit "
                         f"{tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(src))


def _names(mod: nn.Module) -> set:
    return {n for n, p in mod._parameters.items() if p is not None} \
        | set(mod._modules)


def _load(mod: nn.Module, tree: dict, where: str, index=None) -> None:
    if _names(mod) != set(tree):
        raise ValueError(f"{where}: reference keys {sorted(tree)} != port's "
                         f"{sorted(_names(mod))}")
    for key, sub in tree.items():
        dst = getattr(mod, key)
        at = f"{where}/{key}"
        if key in STACKED:
            n = len(next(iter(_leaves(sub))))
            if len(dst) != n:
                raise ValueError(f"{at}: {n} reference layers, {len(dst)} "
                                 "in the port")
            for i, blk in enumerate(dst):
                _load(blk, sub, f"{at}[{i}]", i)
        elif isinstance(sub, dict):
            _load(dst, sub, at, index)
        else:
            _copy(dst, sub if index is None else sub[index], at)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def from_jax(params: dict, cfg: ArchConfig, device=None) -> nn.Module:
    """The family's port model holding the reference pytree's weights, on
    ``device``: ``None`` means the CUDA card, and raises without one (as
    ``Session()``); pass ``device="cpu"`` to build it on the CPU."""
    from repro_torch.models.registry import get_api

    dev = resolve_device(device)
    model = get_api(cfg).init(cfg, torch.Generator(device=dev).manual_seed(0))
    _load(model, params, cfg.name)
    return model


def lm_from_jax(params: dict, cfg: ArchConfig, device=None) -> LM:
    """:func:`from_jax` for the transformer families (dense, moe, vlm)."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"lm_from_jax builds a transformer LM, not the "
                         f"{cfg.family!r} family")
    return from_jax(params, cfg, device)
