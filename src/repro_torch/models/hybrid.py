"""Zamba2-style hybrid: a Mamba2 (SSD) backbone with ONE shared-weight
attention block applied every ``attn_every`` layers (port of
``repro.models.hybrid``).

The shared block's input is ``concat(hidden, original embedding)`` (2 d
wide), its weights are shared across invocations, and each invocation owns
its output linear (``inv_proj[inv]``). Its full-sequence attention
(``_shared_attn_full``: training's ``forward_hidden`` and the prefill)
goes through ``attention_core`` (flash under ``attn_impl="flash"``
without a sliding window). Its KV cache is a ring of W slots (W = the sliding window, or
max_len): slot j holds position ``pos - ((pos - j) mod W)``. The ring's
decode stays on plain torch, as in the reference: once the ring wraps its
valid slots are not a prefix, which is what ``flash_decode``'s lengths
describe.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.attention import (Attention, _project_qkv,
                                          attention_core)
from repro_torch.models.config import ArchConfig
from repro_torch.models.hybrid_groups import group_bounds
from repro_torch.models.layers import (MLP, chunked_ce_loss, embed_tokens,
                                       he_init, init_embed, logits_from_hidden,
                                       mlp, remat, rms_norm)
from repro_torch.models.ssm import CONV_W, SSMBlock, dims, ssm_mixer

NEG_INF = -1e30


def _attn_cfg(cfg: ArchConfig) -> ArchConfig:
    return dataclasses.replace(cfg, d_head=(2 * cfg.d_model) // cfg.n_heads)


def n_invocations(cfg: ArchConfig) -> int:
    return (cfg.n_layers + cfg.attn_every - 1) // cfg.attn_every


class Hybrid(nn.Module):
    """embed, ``layers`` (SSD blocks), shared_attn (input 2 d), shared_ln
    (2 d), shared_mlp and shared_mlp_ln, inv_proj (n_inv, d, d),
    final_norm, lm_head."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        d = cfg.d_model
        dev = generator.device
        self.embed = init_embed(cfg.vocab, d, generator)
        self.layers = nn.ModuleList(SSMBlock(cfg, generator)
                                    for _ in range(cfg.n_layers))
        self.shared_attn = Attention(_attn_cfg(cfg), generator, d_in=2 * d)
        self.shared_ln = nn.Parameter(torch.ones(2 * d, device=dev))
        self.shared_mlp = MLP(d, cfg.d_ff, generator, gated=True)
        self.shared_mlp_ln = nn.Parameter(torch.ones(d, device=dev))
        self.inv_proj = he_init((n_invocations(cfg), d, d), generator, fan_in=d)
        self.final_norm = nn.Parameter(torch.ones(d, device=dev))
        self.lm_head = he_init((d, cfg.vocab), generator, fan_in=d)


def init_hybrid(cfg: ArchConfig, generator: torch.Generator) -> Hybrid:
    return Hybrid(cfg, generator)


def _shared_mlp(h, model: Hybrid, cfg: ArchConfig):
    return h + mlp(rms_norm(h, model.shared_mlp_ln, cfg.norm_eps),
                   model.shared_mlp)


def _shared_in(x, emb0, model: Hybrid, cfg: ArchConfig):
    return rms_norm(torch.cat([x, emb0], dim=-1), model.shared_ln, cfg.norm_eps)


def _ssm_layer(x, blk, cfg: ArchConfig, cache=None, sequential=False):
    h, st = ssm_mixer(rms_norm(x, blk.ln, cfg.norm_eps), blk.ssm, cfg,
                      cache=cache, sequential=sequential)
    return x + h, st


def _shared_attn_full(x, emb0, model: Hybrid, cfg: ArchConfig, inv: int,
                      positions):
    """Invocation ``inv`` of the shared block over the full sequence ->
    (x, k, v), k and v (B, S, KV, hd) for a prefill's ring."""
    acfg = _attn_cfg(cfg)
    xin = _shared_in(x, emb0, model, cfg)
    q, k, v = _project_qkv(xin, xin, model.shared_attn, acfg, positions,
                           positions, True)
    o = attention_core(q, k, v, positions, positions, acfg, causal=True)
    o = o.reshape(x.shape[0], x.shape[1], -1) @ model.shared_attn.wo.to(x.dtype)
    o = _shared_mlp(o, model, cfg)
    return x + o @ model.inv_proj[inv].to(x.dtype), k, v


def _train_shared(x, emb0, model, cfg, inv, positions):
    return _shared_attn_full(x, emb0, model, cfg, inv, positions)[0]


def _train_ssm(x, blk, cfg):
    return _ssm_layer(x, blk, cfg)[0]


def forward_hidden(model: Hybrid, tokens: torch.Tensor,
                   cfg: ArchConfig) -> torch.Tensor:
    """The training trunk: the shared block before each group of SSD
    layers (``hybrid_groups.group_bounds``), each block checkpointed under
    ``cfg.remat`` -> the final-normed (B, S, d) hidden states."""
    x = embed_tokens(model.embed, tokens)
    emb0 = x
    positions = torch.arange(x.shape[1], device=x.device)
    for inv, (s, e) in enumerate(group_bounds(cfg)):
        x = remat(_train_shared, x, emb0, model, cfg, inv, positions,
                  enabled=cfg.remat)
        for blk in model.layers[s:e]:
            x = remat(_train_ssm, x, blk, cfg, enabled=cfg.remat)
    return rms_norm(x, model.final_norm, cfg.norm_eps)


def hybrid_loss(model: Hybrid, batch: dict, cfg: ArchConfig):
    """Next-token cross entropy -> (loss, {"ce"})."""
    tokens = batch["tokens"]
    hidden = forward_hidden(model, tokens, cfg)
    loss_sum = chunked_ce_loss(hidden[:, :-1], model.lm_head, tokens[:, 1:],
                               chunk=cfg.loss_chunk)
    loss = loss_sum / (tokens.shape[0] * (tokens.shape[1] - 1))
    return loss, {"ce": loss}


# -- serving -------------------------------------------------------------------


def effective_window(cfg: ArchConfig, max_len: int) -> int:
    return min(cfg.sliding_window, max_len) if cfg.sliding_window else max_len


def make_cache(cfg: ArchConfig, batch: int, max_len: int, device=None) -> dict:
    """conv (L, B, W-1, di + 2N) bf16, state (L, B, H, N, P) float32, the
    shared block's ring attn_k / attn_v (n_inv, B, W, KV, hd) bf16, pos;
    on ``device`` (``None``: the card, raising without one)."""
    dev = resolve_device(device)
    di, H, P, N = dims(cfg)
    acfg = _attn_cfg(cfg)
    W = effective_window(cfg, max_len)
    n_inv = n_invocations(cfg)
    bf16 = torch.bfloat16
    shapes = {
        "conv": ((cfg.n_layers, batch, CONV_W - 1, di + 2 * N), bf16),
        "state": ((cfg.n_layers, batch, H, N, P), torch.float32),
        "attn_k": ((n_inv, batch, W, acfg.n_kv_heads, acfg.d_head), bf16),
        "attn_v": ((n_inv, batch, W, acfg.n_kv_heads, acfg.d_head), bf16),
        "pos": ((), torch.int32),
    }
    return {k: torch.zeros(s, dtype=dt, device=dev)
            for k, (s, dt) in shapes.items()}


def _ring_slot_positions(pos, W: int):
    """Absolute position stored in each ring slot at write position pos."""
    j = torch.arange(W, device=pos.device)
    return pos - torch.remainder(pos - j, W)


def _shared_attn_decode(x, emb0, model: Hybrid, cfg: ArchConfig, inv: int,
                        ck_inv, cv_inv, pos):
    """Ring-buffer decode of the shared block. x / emb0: (B,1,d); ck_inv /
    cv_inv: this invocation's (B,W,KV,hd) ring, written in place at slot
    ``pos mod W`` by the reference's one-hot rewrite."""
    acfg = _attn_cfg(cfg)
    B = x.shape[0]
    W = ck_inv.shape[1]
    xin = _shared_in(x, emb0, model, cfg)
    positions = pos + torch.arange(1, device=x.device)
    q, k_new, v_new = _project_qkv(xin, xin, model.shared_attn, acfg,
                                   positions, positions, True)
    slot = torch.remainder(pos, W)
    onehot = (torch.arange(W, device=x.device)[:, None]
              == slot[None, None]).to(ck_inv.dtype)
    keep = (1 - onehot.sum(dim=1))[None, :, None, None]
    for c, new in ((ck_inv, k_new), (cv_inv, v_new)):
        c.mul_(keep).add_(torch.einsum("st,btkh->bskh", onehot, new.to(c.dtype)))

    KV, G = acfg.n_kv_heads, acfg.n_heads // acfg.n_kv_heads
    qq = q.reshape(B, 1, KV, G, acfg.d_head).float()
    scores = torch.einsum("bckgh,bskh->bkgcs", qq, ck_inv.float()) \
        / math.sqrt(acfg.d_head)
    valid = _ring_slot_positions(pos, W) >= 0
    scores = torch.where(valid[None, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgcs,bskh->bckgh", probs.to(cv_inv.dtype), cv_inv)
    out = out.reshape(B, 1, acfg.n_heads * acfg.d_head).to(x.dtype)
    h = out @ model.shared_attn.wo.to(x.dtype)
    h = _shared_mlp(h, model, cfg)
    return x + h @ model.inv_proj[inv].to(x.dtype)


def hybrid_prefill(model: Hybrid, batch: dict, cfg: ArchConfig,
                   max_len: int | None = None):
    """The forward pass capturing the SSD states, the conv rings and the
    shared block's ring KV -> (cache, last-token logits (B, 1, V))."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    max_len = max_len or S
    W = effective_window(cfg, max_len)
    x = embed_tokens(model.embed, tokens)
    emb0 = x
    dev = x.device
    positions = torch.arange(S, device=dev)

    # the final ring layout: slot j holds position S-1-((S-1-j) mod W),
    # gathered as jax gathers: a negative index wraps once, then clamps
    ring_src = S - 1 - torch.remainder(S - 1 - torch.arange(W, device=dev), W)
    ring_src = torch.where(ring_src < 0, ring_src + S, ring_src).clamp(0, S - 1)

    aks, avs, convs, states = [], [], [], []
    for inv, (s, e) in enumerate(group_bounds(cfg)):
        x, k, v = _shared_attn_full(x, emb0, model, cfg, inv, positions)
        aks.append(k[:, ring_src].to(torch.bfloat16))
        avs.append(v[:, ring_src].to(torch.bfloat16))
        for blk in model.layers[s:e]:
            x, st = _ssm_layer(x, blk, cfg)
            convs.append(st["conv"].to(torch.bfloat16))
            states.append(st["state"])
    x = rms_norm(x[:, -1:, :], model.final_norm, cfg.norm_eps)
    logits = logits_from_hidden(x, model.lm_head)
    cache = {"conv": torch.stack(convs), "state": torch.stack(states),
             "attn_k": torch.stack(aks), "attn_v": torch.stack(avs),
             "pos": torch.tensor(S, dtype=torch.int32, device=dev)}
    return cache, logits


def hybrid_decode_step(model: Hybrid, cache: dict, tokens: torch.Tensor,
                       cfg: ArchConfig):
    """One decode step; the cache's rings are written in place, the conv
    rings and states replaced per layer, ``pos`` advanced."""
    x = embed_tokens(model.embed, tokens)
    emb0 = x
    pos = cache["pos"]
    conv, state = cache["conv"], cache["state"]
    for inv, (s, e) in enumerate(group_bounds(cfg)):
        x = _shared_attn_decode(x, emb0, model, cfg, inv, cache["attn_k"][inv],
                                cache["attn_v"][inv], pos)
        for i in range(s, e):
            x, st = _ssm_layer(x, model.layers[i], cfg,
                               cache={"conv": conv[i].to(x.dtype),
                                      "state": state[i]},
                               sequential=True)
            conv[i].copy_(st["conv"])
            state[i].copy_(st["state"])
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = logits_from_hidden(x, model.lm_head)
    return dict(cache, pos=pos + tokens.shape[1]), logits
