"""Decoder-only transformer LM, dense family (port of
``repro.models.transformer``).

The reference stacks layer parameters on a leading L axis and scans a
checkpointed block over them; here the layers are an ``nn.ModuleList`` and
inference walks them in a plain loop (no remat: nothing is kept for a
backward). MoE, VLM, ``forward_hidden``/``lm_loss`` and ``lm_decode_step``
wait for ROADMAP A10.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.attention import (Attention, _project_qkv,
                                          attention_core)
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (MLP, embed_tokens, he_init, init_embed,
                                       logits_from_hidden, mlp, rms_norm)


def _dense_only(cfg: ArchConfig, what: str) -> None:
    if cfg.family != "dense" or cfg.moe is not None:
        raise NotImplementedError(
            f"{what} for the {cfg.family!r} family waits for ROADMAP A10 "
            "(MoE / VLM transformer)")


class Block(nn.Module):
    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        dev = generator.device
        self.attn = Attention(cfg, generator)
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, device=dev))
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, device=dev))
        self.mlp = MLP(cfg.d_model, cfg.d_ff, generator, gated=True)


class LM(nn.Module):
    """embed (V, d), lm_head (d, V) unless tied, per-layer Blocks,
    final_norm (d,)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        _dense_only(cfg, "init_lm")
        dev = generator.device
        self.embed = init_embed(cfg.vocab, cfg.d_model, generator)
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model, device=dev))
        self.lm_head = None if cfg.tie_embeddings else he_init(
            (cfg.d_model, cfg.vocab), generator, fan_in=cfg.d_model)
        self.layers = nn.ModuleList(Block(cfg, generator)
                                    for _ in range(cfg.n_layers))


def init_lm(cfg: ArchConfig, generator: torch.Generator) -> LM:
    """Random weights from ``generator``, on its device."""
    return LM(cfg, generator)


def _head(model: LM, cfg: ArchConfig) -> torch.Tensor:
    return model.embed.T if cfg.tie_embeddings else model.lm_head


def embed_input(model: LM, tokens: torch.Tensor, cfg: ArchConfig,
                patches=None) -> torch.Tensor:
    if patches is not None or cfg.family == "vlm":
        raise NotImplementedError("patch prefixes (vlm) wait for ROADMAP A10")
    return embed_tokens(model.embed, tokens)


def make_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """An empty KV cache on ``device``: ``None`` means the CUDA card, and
    raises without one; pass ``device="cpu"`` for the CPU."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def lm_prefill(model: LM, batch: dict, cfg: ArchConfig,
               max_len: Optional[int] = None, *, cache: bool = True):
    """Run the trunk over ``batch["tokens"]`` (B, S) -> (cache, last-token
    logits (B, 1, V) float32). The cache holds every layer's K and V in
    bf16, padded to ``max_len``. ``cache=False`` returns ``(None, logits)``
    without building it: the same computation, minus the (L, B, S, KV, hd)
    copies a caller that only wants logits would throw away."""
    _dense_only(cfg, "lm_prefill")
    tokens = batch["tokens"]
    x = embed_input(model, tokens, cfg, batch.get("patches"))
    B, S = x.shape[0], x.shape[1]
    max_len = max(max_len or 0, S)
    positions = torch.arange(S, device=x.device)
    ks, vs = [], []
    for lp in model.layers:
        h_in = rms_norm(x, lp.ln1, cfg.norm_eps)
        q, k, v = _project_qkv(h_in, h_in, lp.attn, cfg, positions, positions,
                               True)
        o = attention_core(q, k, v, positions, positions, cfg, causal=True)
        x = x + o.reshape(B, S, -1) @ lp.attn.wo.to(x.dtype)
        x = x + mlp(rms_norm(x, lp.ln2, cfg.norm_eps), lp.mlp)
        if cache:
            pad = (0, 0, 0, 0, 0, max_len - S)
            ks.append(nn.functional.pad(k, pad).to(torch.bfloat16))
            vs.append(nn.functional.pad(v, pad).to(torch.bfloat16))
    x = rms_norm(x[:, -1:, :], model.final_norm, cfg.norm_eps)  # per token
    logits = logits_from_hidden(x, _head(model, cfg))
    if not cache:
        return None, logits
    return {"k": torch.stack(ks), "v": torch.stack(vs),
            "pos": torch.tensor(S, dtype=torch.int32, device=x.device)}, logits
