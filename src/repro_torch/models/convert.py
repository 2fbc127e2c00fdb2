"""Carry the JAX package's parameters into the port's modules.

The reference keeps parameters as a dict pytree with every layer's arrays
stacked on a leading L axis (``params["layers"]["attn"]["wq"]`` is
(L, d, H*hd)). The caller hands that pytree over with numpy arrays at the
leaves (``jax.tree_util.tree_map(np.asarray, params)``), so this module
never imports JAX.

Layout: the one place it is decided. Both packages compute ``x @ w`` with
projection weights stored (in, out); the port keeps that layout in plain
``nn.Parameter``s rather than ``nn.Linear`` (whose weight is (out, in)), so
no weight is transposed on the way across. The embedding is (V, d) and the
untied head (d, V) in both.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import LM


def _copy(dst: nn.Parameter, src) -> None:
    src = np.array(src, dtype=np.float32)  # a writable copy
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {src.shape} does not fit {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(src))


def lm_from_jax(params: dict, cfg: ArchConfig, device=None) -> LM:
    """A dense ``LM`` holding the reference pytree's weights, on ``device``:
    ``None`` means the CUDA card, and raises without one (as ``Session()``);
    pass ``device="cpu"`` to build it on the CPU."""
    dev = resolve_device(device)
    model = LM(cfg, torch.Generator(device=dev).manual_seed(0))
    _copy(model.embed, params["embed"])
    _copy(model.final_norm, params["final_norm"])
    if model.lm_head is not None:
        _copy(model.lm_head, params["lm_head"])
    layers = params["layers"]
    for i, blk in enumerate(model.layers):
        _copy(blk.ln1, layers["ln1"][i])
        _copy(blk.ln2, layers["ln2"][i])
        for part in ("attn", "mlp"):
            mod = getattr(blk, part)
            names = {n for n, _ in mod.named_parameters()}
            if names != set(layers[part]):
                raise ValueError(f"layer {part}: reference keys "
                                 f"{sorted(layers[part])} != port's {sorted(names)}")
            for name in names:
                _copy(getattr(mod, name), layers[part][name][i])
    return model
