"""Shared neural-net building blocks (port of ``repro.models.layers``).

Parameters are float32 ``nn.Parameter``s in the reference's layout: a
projection weight is (in, out) and layers compute ``x @ w`` (see
``models/convert.py``). Compute runs in ``COMPUTE_DTYPE`` (bf16), with
float32 norm statistics, rotary angles and logits; every weight is cast to
the activation dtype at its use, as the reference does. Initialisers draw
from an explicit ``torch.Generator`` on the target device.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

COMPUTE_DTYPE = torch.bfloat16


def he_init(shape, generator: torch.Generator,
            fan_in: Optional[int] = None) -> nn.Parameter:
    """N(0, 1/fan_in) float32; fan_in defaults to shape[-2] (shape[0] for
    a vector)."""
    if fan_in is None:
        fan_in = shape[-2] if len(shape) > 1 else shape[0]
    w = torch.randn(shape, generator=generator, device=generator.device)
    return nn.Parameter(w * (1.0 / math.sqrt(fan_in)))


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """float32 statistics, applied in x's dtype."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """The reference's own formula (layers.py:33-38), not
    ``F.layer_norm``: float32 mean and ``var = E[x^2] - mu^2`` clamped at
    0, the normalisation applied in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.square().mean(dim=-1, keepdim=True) - mu.square()
    inv = torch.rsqrt(var.clamp_min(0) + eps).to(x.dtype)
    return (x - mu.to(x.dtype)) * inv * scale.to(x.dtype) + bias.to(x.dtype)


# -- rotary embeddings ---------------------------------------------------------


def rope_freqs(d_head: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float32) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(d, theta)).to(x.device)
    angles = positions[..., :, None].float() * freqs       # (..., S, d/2)
    cos = torch.cos(angles)[..., None, :]                  # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- mlp -------------------------------------------------------------------------


class MLP(nn.Module):
    """SwiGLU (w1, w3 gate, w2 down) or, ungated, GELU (whisper; the tanh
    approximation, ``jax.nn.gelu``'s default)."""

    def __init__(self, d_model: int, d_ff: int, generator: torch.Generator,
                 gated: bool = True):
        super().__init__()
        self.w1 = he_init((d_model, d_ff), generator)
        self.w2 = he_init((d_ff, d_model), generator)
        self.w3 = he_init((d_model, d_ff), generator) if gated else None


def init_mlp(d_model: int, d_ff: int, generator: torch.Generator,
             gated: bool = True) -> MLP:
    return MLP(d_model, d_ff, generator, gated)


def mlp(x: torch.Tensor, p: MLP) -> torch.Tensor:
    h = x @ p.w1.to(x.dtype)
    if p.w3 is not None:
        h = F.silu(h) * (x @ p.w3.to(x.dtype))
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p.w2.to(x.dtype)


# -- embedding / logits ----------------------------------------------------------


def init_embed(vocab: int, d_model: int,
               generator: torch.Generator) -> nn.Parameter:
    w = torch.randn((vocab, d_model), generator=generator,
                    device=generator.device)
    return nn.Parameter(w * 0.02)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return embed[tokens.long()].to(COMPUTE_DTYPE)


def logits_from_hidden(h: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """h: (..., d); head: (d, V) -> float32 logits."""
    return (h @ head.to(h.dtype)).float()
