"""GQA attention for the full-sequence (prefill) path (port of
``repro.models.attention``): projections with optional biases and qk-norm,
rotary embeddings, and the two attention cores the config selects.

``cfg.attn_impl == "blocked"`` (the default) runs ``_blocked_attention``,
a loop over query chunks with a float32 masked softmax over the whole key
range per chunk. ``"flash"`` runs ``kernels.ops.flash_attention`` for the
aligned full-window case — the CUDA kernel on the card (reading the
projections through strided views, no transpose copies), its plain version
on CPU tensors. Decode, cache updates and the shard_map decode path wait
for ROADMAP A10 (serving).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import apply_rope, he_init, rms_norm

NEG_INF = -1e30


class Attention(nn.Module):
    """wq (d, H*hd), wk / wv (d, KV*hd), wo (H*hd, d), with biases under
    ``cfg.qkv_bias`` and per-head norms under ``cfg.qk_norm``."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        d = cfg.d_model
        hq = cfg.n_heads * cfg.d_head
        hkv = cfg.n_kv_heads * cfg.d_head
        dev = generator.device
        self.wq = he_init((d, hq), generator)
        self.wk = he_init((d, hkv), generator)
        self.wv = he_init((d, hkv), generator)
        self.wo = he_init((hq, cfg.d_model), generator, fan_in=hq)
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.zeros(hq, device=dev))
            self.bk = nn.Parameter(torch.zeros(hkv, device=dev))
            self.bv = nn.Parameter(torch.zeros(hkv, device=dev))
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.ones(cfg.d_head, device=dev))
            self.k_norm = nn.Parameter(torch.ones(cfg.d_head, device=dev))


def init_attention(cfg: ArchConfig, generator: torch.Generator) -> Attention:
    return Attention(cfg, generator)


def _project_qkv(x, x_kv, p: Attention, cfg: ArchConfig, positions,
                 positions_kv, rope: bool):
    B, Sq, _ = x.shape
    Skv = x_kv.shape[1]
    q = x @ p.wq.to(x.dtype)
    k = x_kv @ p.wk.to(x.dtype)
    v = x_kv @ p.wv.to(x.dtype)
    if cfg.qkv_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    q = q.reshape(B, Sq, cfg.n_heads, cfg.d_head)
    k = k.reshape(B, Skv, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(B, Skv, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions_kv, cfg.rope_theta)
    return q, k, v


def _blocked_attention(q, k, v, q_pos, k_pos, *, causal: bool, window: int,
                       chunk_q: int) -> torch.Tensor:
    """q: (B,Sq,H,hd); k, v: (B,Skv,KV,hd) -> (B,Sq,H,hd).

    A loop over query chunks; per chunk the full key range is scored in
    float32 (bf16 products are exact in float32, as the reference's
    ``preferred_element_type=f32``) with a masked softmax, and the
    probabilities meet V in V's dtype."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    kf = k.float()
    outs = []
    for s0 in range(0, Sq, min(chunk_q, Sq)):
        qc = q[:, s0:s0 + chunk_q]
        c = qc.shape[1]
        qq = qc.reshape(B, c, KV, G, hd).float()
        scores = torch.einsum("bckgh,bskh->bkgcs", qq, kf) * scale
        if causal:
            qpos = q_pos[s0:s0 + c]
            m = qpos[:, None] >= k_pos[None, :]
            if window:
                m &= (qpos[:, None] - k_pos[None, :]) < window
            scores = torch.where(m[None, None, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgcs,bskh->bckgh", probs.to(v.dtype), v)
        outs.append(out.reshape(B, c, H, hd))
    return torch.cat(outs, dim=1)


def attention_core(q, k, v, q_pos, k_pos, cfg: ArchConfig, *,
                   causal: bool) -> torch.Tensor:
    """The reference's dispatch (models/attention.py:115-129): flash covers
    the aligned full-window case; sliding windows stay on the blocked
    path."""
    aligned = q.shape[1] == k.shape[1]
    if cfg.attn_impl == "flash" and cfg.sliding_window == 0 and aligned:
        from repro_torch.kernels import ops as kops

        # (B,H,S,D) views of the (B,S,H,D) projections: the kernel reads
        # them in place and writes (B,S,H,D) memory, so neither side copies
        out = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal)
        return out.transpose(1, 2)
    return _blocked_attention(q, k, v, q_pos, k_pos, causal=causal,
                              window=cfg.sliding_window, chunk_q=cfg.chunk_q)


def attention(x, p: Attention, cfg: ArchConfig, *, x_kv=None, causal=True,
              rope=True, positions=None, positions_kv=None) -> torch.Tensor:
    """Full-sequence (train/prefill) attention. x: (B, S, d_in)."""
    B, Sq, _ = x.shape
    x_kv = x if x_kv is None else x_kv
    Skv = x_kv.shape[1]
    if positions is None:
        positions = torch.arange(Sq, device=x.device)
    if positions_kv is None:
        positions_kv = positions if Skv == Sq else torch.arange(Skv, device=x.device)
    q, k, v = _project_qkv(x, x_kv, p, cfg, positions, positions_kv, rope)
    out = attention_core(q, k, v, positions, positions_kv, cfg, causal=causal)
    out = out.reshape(B, Sq, cfg.n_heads * cfg.d_head)
    return out @ p.wo.to(x.dtype)
