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
from torch.utils.checkpoint import checkpoint

from repro_torch.engine import distributed as D
from repro_torch.models.sharding import (current_ctx, model_split, tp_enter,
                                         tp_merge, vocab_offset, weight)

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
    """On a rank mesh with ``w1`` split over model: w1 / w3
    column-parallel, w2 row-parallel, the partial outputs summed."""
    tp = model_split(p, "w1")
    xi = tp_enter(x) if tp else x
    h = xi @ weight(p, "w1", x.dtype)
    if p.w3 is not None:
        h = F.silu(h) * (xi @ weight(p, "w3", x.dtype))
    else:
        h = F.gelu(h, approximate="tanh")
    y = h @ weight(p, "w2", x.dtype)
    return tp_merge(y) if tp else y


# -- embedding / logits ----------------------------------------------------------


def init_embed(vocab: int, d_model: int,
               generator: torch.Generator) -> nn.Parameter:
    w = torch.randn((vocab, d_model), generator=generator,
                    device=generator.device)
    return nn.Parameter(w * 0.02)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor,
                 vocab_offset: int | None = None) -> torch.Tensor:
    """The tokens' rows of ``embed``. With ``vocab_offset`` (a rank
    mesh's vocab-parallel block of rows from that id): the rows this rank
    holds, zero elsewhere, summed over model (one rank holds each row)."""
    if vocab_offset is None:
        return embed[tokens.long()].to(COMPUTE_DTYPE)
    V = embed.shape[0]
    local = tokens.long() - vocab_offset
    mine = (local >= 0) & (local < V)
    rows = embed[local.clamp(0, V - 1)]
    return tp_merge(torch.where(mine[..., None], rows, 0).to(COMPUTE_DTYPE))


def embed_lookup(mod, tokens: torch.Tensor, name: str = "embed") -> torch.Tensor:
    """:func:`embed_tokens` of ``mod.name``: vocab-parallel on a rank mesh
    that splits it over model."""
    return embed_tokens(weight(mod, name), tokens, vocab_offset(mod, name))


def head_logits(h: torch.Tensor, mod, name: str,
                tied: bool = False) -> torch.Tensor:
    """:func:`logits_from_hidden` with ``mod.name`` as the (d, V) head (its
    transpose, a tied (V, d) embedding, under ``tied``): vocab-parallel on
    a rank mesh that splits it over model."""
    w = weight(mod, name)
    return logits_from_hidden(h, w.T if tied else w,
                              vocab_parallel=vocab_offset(mod, name) is not None)


def logits_from_hidden(h: torch.Tensor, head: torch.Tensor,
                       vocab_parallel: bool = False) -> torch.Tensor:
    """h: (..., d); head: (d, V) -> float32 logits. A vocab-parallel head
    (this rank's block of columns) gives every rank the whole logits
    (all-gathered over model)."""
    logits = (h @ head.to(h.dtype)).float()
    if vocab_parallel:
        logits = D.all_gather(logits, group=current_ctx().group("model"),
                              dim=-1)
    return logits


def _ce_from_logits(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Summed cross entropy: sum(logsumexp - gold logit)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.sum(lse - gold)


def remat(fn, *args, enabled: bool = True):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant: the
    backward recomputes ``fn``'s activations instead of keeping them) when
    ``enabled`` and autograd is recording; a plain call otherwise (serving,
    the eval step)."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor,
                       offset: int) -> torch.Tensor:
    """Summed cross entropy over this rank's vocab block of the logits
    (ids ``[offset, offset + V_local)``): the max by ``pmax``, the sum of
    exponentials and the gold logit (held by one rank) by ``psum`` over
    model."""
    V = logits.shape[-1]
    m = D.pmax(logits.detach().amax(dim=-1),
               group=current_ctx().group("model"))
    lse = m + torch.log(tp_merge(torch.exp(logits - m[..., None]).sum(dim=-1)))
    local = labels.long() - offset
    gold = torch.gather(logits, -1, local.clamp(0, V - 1)[..., None])[..., 0]
    gold = tp_merge(torch.where((local >= 0) & (local < V), gold, 0.0))
    return torch.sum(lse - gold)


def _chunk_loss(h_c, head, l_c, vocab_offset=None):
    if vocab_offset is None:
        return _ce_from_logits(logits_from_hidden(h_c, head), l_c)
    return _vocab_parallel_ce(logits_from_hidden(tp_enter(h_c), head), l_c,
                              vocab_offset)


def chunked_ce_loss(hidden: torch.Tensor, head: torch.Tensor,
                    labels: torch.Tensor, chunk: int = 2048,
                    vocab_offset: int | None = None) -> torch.Tensor:
    """Cross entropy without materialising the whole (B, S, V) float32
    logits: a loop over sequence chunks (the last one the remainder), each
    under :func:`remat` (the reference's ``jax.checkpoint``), so the
    backward recomputes a chunk's logits and the peak is one chunk
    of them. Returns the summed loss (the caller divides by the token
    count). The reference's optional ``mask`` has no caller and is left
    out. ``vocab_offset``: ``head`` is a rank mesh's vocab-parallel block
    of columns from that id (a vocab-parallel cross entropy)."""
    S = hidden.shape[1]
    chunk = min(chunk, S)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s0 in range(0, S, chunk):
        sl = slice(s0, s0 + chunk)
        total = total + remat(_chunk_loss, hidden[:, sl], head,
                              labels[:, sl], vocab_offset)
    return total
