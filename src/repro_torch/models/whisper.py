"""Whisper-base backbone (port of ``repro.models.whisper``): a bidirectional
encoder over precomputed frame embeddings (the conv frontend is a stub: the
batch supplies (B, enc_len, d) frames) and a causal decoder with
cross-attention. Sinusoidal positions, pre-norm RMS norms, tied
embeddings, ungated GELU MLPs — the reference's deviations from Whisper,
kept.

Serving caches the decoder's self-attention K / V (padded to max_len) and
each layer's cross-attention K / V over the encoder output. Decode's
self-attention goes through ``attention.decode_attention`` (so
``flash_decode`` under ``attn_impl="flash"``); its cross-attention runs
over the cached encoder K / V as the reference computes it (an einsum, no
mask).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.attention import (Attention, _project_qkv, attention,
                                          attention_core, decode_attention)
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (MLP, chunked_ce_loss, embed_tokens,
                                       init_embed, logits_from_hidden, mlp,
                                       remat, rms_norm)


def sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(S,) positions -> (S, d) float32 [sin | cos]; the frequencies in
    float64 rounded to float32, as the reference's constant."""
    inv = torch.from_numpy((1.0 / (10000 ** (np.arange(0, d, 2) / d)))
                           .astype(np.float32)).to(positions.device)
    ang = positions[:, None].float() * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _ones(cfg: ArchConfig, dev) -> nn.Parameter:
    return nn.Parameter(torch.ones(cfg.d_model, device=dev))


class EncBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        self.attn = Attention(cfg, generator)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, generator, gated=False)
        self.ln1, self.ln2 = _ones(cfg, generator.device), _ones(cfg, generator.device)


class DecBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        dev = generator.device
        self.attn = Attention(cfg, generator)
        self.xattn = Attention(cfg, generator)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, generator, gated=False)
        self.ln1, self.ln2, self.ln3 = (_ones(cfg, dev) for _ in range(3))


class Whisper(nn.Module):
    """embed (V, d, tied), ``enc_layers``, enc_norm, ``dec_layers``,
    final_norm."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        dev = generator.device
        self.embed = init_embed(cfg.vocab, cfg.d_model, generator)
        self.enc_layers = nn.ModuleList(EncBlock(cfg, generator)
                                        for _ in range(cfg.enc_layers))
        self.enc_norm = _ones(cfg, dev)
        self.dec_layers = nn.ModuleList(DecBlock(cfg, generator)
                                        for _ in range(cfg.n_layers))
        self.final_norm = _ones(cfg, dev)


def init_whisper(cfg: ArchConfig, generator: torch.Generator) -> Whisper:
    return Whisper(cfg, generator)


def _enc_block(x, lp: EncBlock, cfg: ArchConfig):
    x = x + attention(rms_norm(x, lp.ln1, cfg.norm_eps), lp.attn, cfg,
                      causal=False, rope=False)
    return x + mlp(rms_norm(x, lp.ln2, cfg.norm_eps), lp.mlp)


def encode(model: Whisper, frames: torch.Tensor, cfg: ArchConfig):
    """frames: (B, enc_len, d) stub frame embeddings -> (B, enc_len, d);
    each layer checkpointed under ``cfg.remat`` when autograd records."""
    x = frames.to(torch.bfloat16)
    x = x + sinusoid(torch.arange(x.shape[1], device=x.device),
                     cfg.d_model).to(x.dtype)
    for lp in model.enc_layers:
        x = remat(_enc_block, x, lp, cfg, enabled=cfg.remat)
    return rms_norm(x, model.enc_norm, cfg.norm_eps)


def _dec_block(x, lp: DecBlock, enc_out, cfg: ArchConfig, positions,
               enc_pos):
    """One decoder layer over the full sequence -> (x, k, v, xk, xv): the
    self- and cross-attention K and V (B, S | enc_len, KV, hd) for a
    prefill's cache."""
    B, S = x.shape[0], x.shape[1]
    h_in = rms_norm(x, lp.ln1, cfg.norm_eps)
    q, k, v = _project_qkv(h_in, h_in, lp.attn, cfg, positions, positions,
                           False)
    o = attention_core(q, k, v, positions, positions, cfg, causal=True)
    x = x + o.reshape(B, S, -1) @ lp.attn.wo.to(x.dtype)
    h_in = rms_norm(x, lp.ln2, cfg.norm_eps)
    q2, xk, xv = _project_qkv(h_in, enc_out, lp.xattn, cfg, positions,
                              enc_pos, False)
    o2 = attention_core(q2, xk, xv, positions, enc_pos, cfg, causal=False)
    x = x + o2.reshape(B, S, -1) @ lp.xattn.wo.to(x.dtype)
    x = x + mlp(rms_norm(x, lp.ln3, cfg.norm_eps), lp.mlp)
    return x, k, v, xk, xv


def _train_dec_block(x, lp, enc_out, cfg, positions, enc_pos):
    return _dec_block(x, lp, enc_out, cfg, positions, enc_pos)[0]


def _decoder_hidden(model: Whisper, tokens: torch.Tensor, enc_out,
                    cfg: ArchConfig) -> torch.Tensor:
    """The training decoder over ``tokens`` (B, S) attending to
    ``enc_out``, each layer checkpointed under ``cfg.remat`` -> the
    final-normed (B, S, d) hidden states."""
    S = tokens.shape[1]
    dev = enc_out.device
    positions = torch.arange(S, device=dev)
    enc_pos = torch.arange(enc_out.shape[1], device=dev)
    x = embed_tokens(model.embed, tokens)
    x = x + sinusoid(positions, cfg.d_model).to(x.dtype)
    for lp in model.dec_layers:
        x = remat(_train_dec_block, x, lp, enc_out, cfg, positions, enc_pos,
                  enabled=cfg.remat)
    return rms_norm(x, model.final_norm, cfg.norm_eps)


def whisper_loss(model: Whisper, batch: dict, cfg: ArchConfig):
    """Next-token cross entropy of the decoder over ``batch["tokens"]``
    given ``batch["frames"]`` (tied head) -> (loss, {"ce"})."""
    enc_out = encode(model, batch["frames"], cfg)
    tokens = batch["tokens"]
    hidden = _decoder_hidden(model, tokens, enc_out, cfg)
    loss_sum = chunked_ce_loss(hidden[:, :-1], model.embed.T, tokens[:, 1:],
                               chunk=cfg.loss_chunk)
    loss = loss_sum / (tokens.shape[0] * (tokens.shape[1] - 1))
    return loss, {"ce": loss}


# -- serving -------------------------------------------------------------------


def make_cache(cfg: ArchConfig, batch: int, max_len: int, device=None) -> dict:
    """Self-attention k / v (L, B, max_len, KV, hd), cross-attention xk / xv
    (L, B, enc_len, KV, hd), all bf16, and pos; on ``device`` (``None``:
    the card, raising without one)."""
    dev = resolve_device(device)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    out = {}
    for key, S in (("k", max_len), ("v", max_len), ("xk", cfg.enc_len),
                   ("xv", cfg.enc_len)):
        out[key] = torch.zeros((L, batch, S, KV, hd), dtype=torch.bfloat16,
                               device=dev)
    out["pos"] = torch.zeros((), dtype=torch.int32, device=dev)
    return out


def whisper_prefill(model: Whisper, batch: dict, cfg: ArchConfig,
                    max_len: int | None = None):
    """Encode the frames, run the decoder over the prompt and capture the
    self- and cross-attention caches -> (cache, last-token logits)."""
    enc_out = encode(model, batch["frames"], cfg)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    max_len = max_len or S
    dev = enc_out.device
    positions = torch.arange(S, device=dev)
    enc_pos = torch.arange(cfg.enc_len, device=dev)
    x = embed_tokens(model.embed, tokens)
    x = x + sinusoid(positions, cfg.d_model).to(x.dtype)
    ks, vs, xks, xvs = [], [], [], []
    pad = (0, 0, 0, 0, 0, max_len - S)
    for lp in model.dec_layers:
        x, k, v, xk, xv = _dec_block(x, lp, enc_out, cfg, positions, enc_pos)
        ks.append(nn.functional.pad(k, pad).to(torch.bfloat16))
        vs.append(nn.functional.pad(v, pad).to(torch.bfloat16))
        xks.append(xk.to(torch.bfloat16))
        xvs.append(xv.to(torch.bfloat16))
    x = rms_norm(x[:, -1:, :], model.final_norm, cfg.norm_eps)
    logits = logits_from_hidden(x, model.embed.T)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "xk": torch.stack(xks), "xv": torch.stack(xvs),
             "pos": torch.tensor(S, dtype=torch.int32, device=dev)}
    return cache, logits


def _cross_decode(x, lp: Attention, cfg: ArchConfig, xk, xv):
    """Cross-attention of the new token over one layer's cached encoder
    K / V (B, enc_len, KV, hd): all slots valid, no mask."""
    B = x.shape[0]
    q = x @ lp.wq.to(x.dtype)
    if cfg.qkv_bias:
        q = q + lp.bq.to(x.dtype)
    KV, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    qq = q.reshape(B, 1, KV, G, cfg.d_head).float()
    scores = torch.einsum("bckgh,bskh->bkgcs", qq, xk.float()) \
        / math.sqrt(cfg.d_head)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgcs,bskh->bckgh", probs.to(xv.dtype), xv)
    out = out.reshape(B, 1, cfg.n_heads * cfg.d_head).to(x.dtype)
    return out @ lp.wo.to(x.dtype)


def whisper_decode_step(model: Whisper, cache: dict, tokens: torch.Tensor,
                        cfg: ArchConfig):
    """One decode step; the self-attention cache is written in place, the
    cross-attention cache read, ``pos`` advanced."""
    x = embed_tokens(model.embed, tokens)
    pos = cache["pos"]
    x = x + sinusoid(pos + torch.arange(1, device=x.device),
                     cfg.d_model).to(x.dtype)
    for i, lp in enumerate(model.dec_layers):
        h, _, _ = decode_attention(rms_norm(x, lp.ln1, cfg.norm_eps), lp.attn,
                                   cfg, cache["k"][i], cache["v"][i], pos,
                                   rope=False)
        x = x + h
        x = x + _cross_decode(rms_norm(x, lp.ln2, cfg.norm_eps), lp.xattn, cfg,
                              cache["xk"][i], cache["xv"][i])
        x = x + mlp(rms_norm(x, lp.ln3, cfg.norm_eps), lp.mlp)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = logits_from_hidden(x, model.embed.T)
    return dict(cache, pos=pos + tokens.shape[1]), logits
