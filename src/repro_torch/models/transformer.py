"""Decoder-only transformer LM covering the dense, moe and vlm families
(port of ``repro.models.transformer``).

The reference stacks layer parameters on a leading L axis and scans a
checkpointed block over them; here the layers are an ``nn.ModuleList`` and
inference walks them in a plain loop (no remat: nothing is kept for a
backward). DeepSeek-style MoE keeps its first ``first_dense_layers`` blocks
dense, in ``first_layers``; their cache entries fill the leading slots of
the (n_layers, ...) cache. The vlm family prepends its projected patch
prefix to the token embeddings. ``forward_hidden`` and ``lm_loss`` wait for
ROADMAP A10 (training).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.models.attention import (Attention, _project_qkv,
                                          attention_core, decode_attention,
                                          init_kv_cache)
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (MLP, embed_tokens, he_init, init_embed,
                                       logits_from_hidden, mlp, rms_norm)
from repro_torch.models.moe import MoE, moe_ffn


class Block(nn.Module):
    """attn, ln1, ln2, and ``moe`` (a MoE layer) or ``mlp``."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator,
                 moe_layer: bool = False):
        super().__init__()
        dev = generator.device
        self.attn = Attention(cfg, generator)
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, device=dev))
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, device=dev))
        if moe_layer:
            self.moe = MoE(cfg, cfg.moe, generator)
        else:
            d_ff = cfg.d_ff
            if cfg.moe is not None:  # a dense layer inside a MoE arch
                d_ff = (cfg.moe.top_k + cfg.moe.num_shared) * cfg.moe.d_ff_expert
            self.mlp = MLP(cfg.d_model, d_ff, generator, gated=True)


class LM(nn.Module):
    """embed (V, d), lm_head (d, V) unless tied, ``layers`` (MoE blocks in a
    MoE arch), ``first_layers`` (DeepSeek's leading dense blocks),
    ``patch_proj`` (patch_dim, d) for vlm, final_norm (d,)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"the transformer LM does not build the "
                             f"{cfg.family!r} family")
        dev = generator.device
        n_first = cfg.moe.first_dense_layers if cfg.moe else 0
        self.embed = init_embed(cfg.vocab, cfg.d_model, generator)
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model, device=dev))
        self.lm_head = None if cfg.tie_embeddings else he_init(
            (cfg.d_model, cfg.vocab), generator, fan_in=cfg.d_model)
        self.layers = nn.ModuleList(Block(cfg, generator, cfg.moe is not None)
                                    for _ in range(cfg.n_layers - n_first))
        if n_first:
            self.first_layers = nn.ModuleList(Block(cfg, generator)
                                              for _ in range(n_first))
        if cfg.family == "vlm":
            self.patch_proj = he_init((cfg.patch_dim, cfg.d_model), generator,
                                      fan_in=cfg.patch_dim)

    def blocks(self) -> list[tuple[Block, bool]]:
        """(block, is a MoE layer) in cache order: first_layers, then
        layers."""
        first = [(b, False) for b in getattr(self, "first_layers", ())]
        return first + [(b, hasattr(b, "moe")) for b in self.layers]


def init_lm(cfg: ArchConfig, generator: torch.Generator) -> LM:
    """Random weights from ``generator``, on its device."""
    return LM(cfg, generator)


def _head(model: LM, cfg: ArchConfig) -> torch.Tensor:
    return model.embed.T if cfg.tie_embeddings else model.lm_head


def embed_input(model: LM, tokens: torch.Tensor, cfg: ArchConfig,
                patches=None) -> torch.Tensor:
    """Token embeddings, with the projected patch prefix for vlm."""
    x = embed_tokens(model.embed, tokens)
    if cfg.family == "vlm":
        if patches is None:
            raise ValueError("vlm needs patch embeddings (the stub frontend's "
                             "batch['patches'])")
        pe = patches.to(x.dtype) @ model.patch_proj.to(x.dtype)
        x = torch.cat([pe, x], dim=1)
    return x


def _ffn(x: torch.Tensor, blk: Block, cfg: ArchConfig,
         moe_layer: bool) -> torch.Tensor:
    hidden = rms_norm(x, blk.ln2, cfg.norm_eps)
    if moe_layer:
        return moe_ffn(hidden, blk.moe, cfg, cfg.moe)[0]
    return mlp(hidden, blk.mlp)


def make_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """An empty KV cache on ``device``: ``None`` means the CUDA card, and
    raises without one; pass ``device="cpu"`` for the CPU."""
    return init_kv_cache(cfg, cfg.n_layers, batch, max_len, dtype, device)


def lm_prefill(model: LM, batch: dict, cfg: ArchConfig,
               max_len: Optional[int] = None, *, cache: bool = True):
    """Run the trunk over ``batch["tokens"]`` (B, S) (after the patch
    prefix for vlm) -> (cache, last-token logits (B, 1, V) float32). The
    cache holds every layer's K and V in bf16, padded to ``max_len`` (at
    least the context: vlm's patch prefix extends it). ``cache=False``
    returns ``(None, logits)`` without building it: the same computation,
    minus the (L, B, S, KV, hd) copies a caller that only wants logits
    would throw away."""
    tokens = batch["tokens"]
    x = embed_input(model, tokens, cfg, batch.get("patches"))
    B, S = x.shape[0], x.shape[1]
    max_len = max(max_len or 0, S)
    positions = torch.arange(S, device=x.device)
    ks, vs = [], []
    for blk, moe_layer in model.blocks():
        h_in = rms_norm(x, blk.ln1, cfg.norm_eps)
        q, k, v = _project_qkv(h_in, h_in, blk.attn, cfg, positions, positions,
                               True)
        o = attention_core(q, k, v, positions, positions, cfg, causal=True)
        x = x + o.reshape(B, S, -1) @ blk.attn.wo.to(x.dtype)
        x = x + _ffn(x, blk, cfg, moe_layer)
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


def lm_decode_step(model: LM, cache: dict, tokens: torch.Tensor,
                   cfg: ArchConfig):
    """One decode step. tokens: (B, 1). Returns (cache, logits (B, 1, V)):
    the cache's K and V are written in place (layer i is slot i, the
    DeepSeek first layers leading) and ``pos`` advances by the tokens."""
    x = embed_tokens(model.embed, tokens)
    pos = cache["pos"]
    for i, (blk, moe_layer) in enumerate(model.blocks()):
        h, _, _ = decode_attention(rms_norm(x, blk.ln1, cfg.norm_eps),
                                   blk.attn, cfg, cache["k"][i],
                                   cache["v"][i], pos)
        x = x + h
        x = x + _ffn(x, blk, cfg, moe_layer)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = logits_from_hidden(x, _head(model, cfg))
    return {"k": cache["k"], "v": cache["v"],
            "pos": pos + tokens.shape[1]}, logits
