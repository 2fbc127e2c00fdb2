"""GQA attention (port of ``repro.models.attention``): projections with
optional biases and qk-norm, rotary embeddings, the two attention cores the
config selects for the full-sequence (prefill) path, and the KV-cache
decode path.

``cfg.attn_impl == "blocked"`` (the default) runs ``_blocked_attention``,
a loop over query chunks with a float32 masked softmax over the whole key
range per chunk. ``"flash"`` runs ``kernels.ops.flash_attention`` for the
aligned full-window case — the CUDA kernel on the card (reading the
projections through strided views, no transpose copies), its plain version
on CPU tensors.

Decode writes the new token's K and V into the layer's (B,S,KV,hd) cache
(``cfg.decode_cache_update``: the reference's one-hot rewrite, or an
in-place slice write) and attends over it: an einsum with a float32 masked
softmax, or under ``attn_impl="flash"`` without a sliding window
``kernels.ops.flash_decode`` on the (B,KV,S,hd) views of the cache, read
in place. Both writes update the cache's buffers in place, where the
reference returns new arrays (its serving loop donates them): a decode
step consumes the cache it is given.

``"shardmap"`` under a sharding context whose model extent M divides the
cache length is the reference's shard_map decode on the port's
one-device mesh (``models/sharding.py``): model rank r owns cache rows
[r*S/M, (r+1)*S/M), a view of the one cache tensor, and each data shard
its batch rows. A rank writes the new token in place only where it owns
``pos``, scores its rows under the causal (and sliding-window) mask, and
the online softmax merges over the ranks with a ``pmax`` and two
``psum``s in float32. The reference's local body is an einsum, not its
Pallas kernel, so the port's is too: ``flash_decode`` is not on this
path. Without a context ``"shardmap"`` takes the one-hot write, as the
reference does.

On a rank mesh (``launch/mesh.RankMesh``, weights placed by
``sharding.place_params``) the projections are column-parallel over
"model" (q, k, v: this rank's heads, so the flash kernels see local,
contiguous heads) and ``wo`` row-parallel (:func:`out_proj`, the partials
summed over model). The decode cache is this rank's: its batch rows and,
under ``"shardmap"``, its S / M sequence rows of every head (q, k and v
all-gathered over model first), the merges over the model group;
otherwise every row of its own heads.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.engine import distributed as D
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import apply_rope, he_init, rms_norm
from repro_torch.models.sharding import (current_ctx, model_split, tp_enter,
                                         tp_merge, weight)

NEG_INF = -1e30


class Attention(nn.Module):
    """wq (d, H*hd), wk / wv (d, KV*hd), wo (H*hd, d), with biases under
    ``cfg.qkv_bias`` and per-head norms under ``cfg.qk_norm``."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator,
                 d_in: int | None = None, d_kv_in: int | None = None):
        super().__init__()
        d_in = d_in or cfg.d_model
        d_kv_in = d_kv_in or d_in
        hq = cfg.n_heads * cfg.d_head
        hkv = cfg.n_kv_heads * cfg.d_head
        dev = generator.device
        self.wq = he_init((d_in, hq), generator)
        self.wk = he_init((d_kv_in, hkv), generator)
        self.wv = he_init((d_kv_in, hkv), generator)
        self.wo = he_init((hq, cfg.d_model), generator, fan_in=hq)
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.zeros(hq, device=dev))
            self.bk = nn.Parameter(torch.zeros(hkv, device=dev))
            self.bv = nn.Parameter(torch.zeros(hkv, device=dev))
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.ones(cfg.d_head, device=dev))
            self.k_norm = nn.Parameter(torch.ones(cfg.d_head, device=dev))


def init_attention(cfg: ArchConfig, generator: torch.Generator,
                   d_in: int | None = None,
                   d_kv_in: int | None = None) -> Attention:
    return Attention(cfg, generator, d_in, d_kv_in)


def _project_qkv(x, x_kv, p: Attention, cfg: ArchConfig, positions,
                 positions_kv, rope: bool):
    """q (B,Sq,H,hd), k / v (B,Skv,KV,hd); on a rank mesh with the
    projections split over model, this rank's heads (column-parallel)."""
    B, Sq, _ = x.shape
    Skv = x_kv.shape[1]
    tp = model_split(p, "wq")
    xq = tp_enter(x) if tp else x
    xkv = xq if x_kv is x else (tp_enter(x_kv) if tp else x_kv)
    xkv = xkv.to(x.dtype)  # whisper's bf16 encoder output under float32
    q = xq @ weight(p, "wq", x.dtype)
    k = xkv @ weight(p, "wk", x.dtype)
    v = xkv @ weight(p, "wv", x.dtype)
    if cfg.qkv_bias:
        q = q + weight(p, "bq", x.dtype)
        k = k + weight(p, "bk", x.dtype)
        v = v + weight(p, "bv", x.dtype)
    q = q.reshape(B, Sq, -1, cfg.d_head)
    k = k.reshape(B, Skv, -1, cfg.d_head)
    v = v.reshape(B, Skv, -1, cfg.d_head)
    if cfg.qk_norm:
        # whole scales over this rank's heads: their gradients are partial
        qn, kn = (tp_enter(t) if tp else t for t in (p.q_norm, p.k_norm))
        q = rms_norm(q, qn, cfg.norm_eps)
        k = rms_norm(k, kn, cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions_kv, cfg.rope_theta)
    return q, k, v


def out_proj(o: torch.Tensor, p: Attention, dtype) -> torch.Tensor:
    """``o @ wo`` (o: (..., heads * hd)); row-parallel on a rank mesh with
    ``wo`` split over model: this rank's heads' partial, summed."""
    y = o @ weight(p, "wo", dtype)
    return tp_merge(y) if model_split(p, "wo") else y


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
    return out_proj(out.reshape(B, Sq, -1), p, x.dtype)


# -- KV-cache decode -------------------------------------------------------------


def init_kv_cache(cfg: ArchConfig, n_layers: int, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None) -> dict:
    """(n_layers, B, S, KV, hd) K and V, zeros, and ``pos`` 0, on
    ``device`` (``None``: the card, raising without one)."""
    dev = resolve_device(device)
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def update_cache_layer(cache_k_l, cache_v_l, k_new, v_new, pos):
    """The reference's masked one-hot write at ``pos`` (attention.py:
    191-204), computed as it computes it: a (S, T) one-hot in the cache's
    dtype, its einsum with the new rows, and ``cache * keep + add`` — two
    full passes over the layer's cache. Written into ``cache_*_l`` in
    place; returns them. cache_*_l: (B, S, KV, hd); k_new / v_new:
    (B, T, KV, hd); pos: a 0-d integer tensor."""
    S, T = cache_k_l.shape[1], k_new.shape[1]
    dev = cache_k_l.device
    onehot = (torch.arange(S, device=dev)[:, None]
              == (pos + torch.arange(T, device=dev))[None, :]).to(cache_k_l.dtype)
    keep = (1 - onehot.sum(dim=1))[None, :, None, None]
    for c, new in ((cache_k_l, k_new), (cache_v_l, v_new)):
        add = torch.einsum("st,btkh->bskh", onehot, new.to(c.dtype))
        c.mul_(keep).add_(add)
    return cache_k_l, cache_v_l


def update_cache_layer_dus(cache_k_l, cache_v_l, k_new, v_new, pos):
    """The in-place slice write (the reference's dynamic_update_slice on
    its donated cache): only the T written rows move. The start is clamped
    to [0, S - T], as dynamic_update_slice clamps it, and stays on the
    device (no host sync)."""
    S, T = cache_k_l.shape[1], k_new.shape[1]
    start = pos.clamp(0, S - T)
    rows = start + torch.arange(T, device=cache_k_l.device)
    cache_k_l.index_copy_(1, rows, k_new.to(cache_k_l.dtype))
    cache_v_l.index_copy_(1, rows, v_new.to(cache_v_l.dtype))
    return cache_k_l, cache_v_l


def _decode_attention_smap(q, k_new, v_new, cache_k_l, cache_v_l, pos,
                           cfg: ArchConfig, ctx):
    """The shard_map decode (the reference's attention.py:197-259) over
    the mesh's data x model shards. q: (B, 1, H, hd); k_new / v_new:
    (B, 1, KV, hd); cache_*_l: (B, S, KV, hd), written in place. Returns
    the (B, 1, KV, G, hd) attention output in q's dtype.

    On the one-process mesh every rank's rows are views of the one cache
    and the merges take the ranks' partials; on a rank mesh the batch and
    ``cache_*_l`` are this rank's (its data rows, its S / M sequence rows,
    every head) and the merges run over the model group."""
    B, S = cache_k_l.shape[0], cache_k_l.shape[1]
    KV, G, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.d_head
    if ctx.ranked:
        S_loc, b_loc, ranks = S, B, (ctx.model_rank,)
        g = ctx.group("model")
        pmax = lambda xs: D.pmax(xs[0], group=g)  # noqa: E731
        psum = lambda xs: D.psum(xs[0], group=g)  # noqa: E731
    else:
        S_loc, ranks = S // ctx.model_size, range(ctx.model_size)
        b_loc = B // ctx.data_blocks(B)
        pmax, psum = D.pmax, D.psum
    dev = q.device
    outs = []
    for b0 in range(0, B, b_loc):
        rows = slice(b0, b0 + b_loc)
        qq = q[rows].reshape(b_loc, 1, KV, G, hd).float()
        scores, values = [], []
        for rank in ranks:
            lo = 0 if ctx.ranked else rank * S_loc
            ck = cache_k_l[rows, lo:lo + S_loc]
            cv = cache_v_l[rows, lo:lo + S_loc]
            # -- 1-token in-place write, taken only on the owning rank ----
            lpos = pos - rank * S_loc
            in_range = (lpos >= 0) & (lpos < S_loc)
            idx = lpos.clamp(0, S_loc - 1).reshape(1).long()
            for c, new in ((ck, k_new[rows]), (cv, v_new[rows])):
                old = c.index_select(1, idx)
                c.index_copy_(1, idx, torch.where(in_range, new.to(c.dtype), old))
            # -- local scores ----------------------------------------------
            s = torch.einsum("bckgh,bskh->bkgcs", qq, ck.float()) / math.sqrt(hd)
            kpos = rank * S_loc + torch.arange(S_loc, device=dev)
            valid = kpos <= pos
            if cfg.sliding_window:
                valid &= (pos - kpos) < cfg.sliding_window
            scores.append(torch.where(valid[None, None, None, None, :], s, NEG_INF))
            values.append(cv)
        # -- the online softmax, merged over the ranks ------------------------
        m = pmax([s.amax(dim=-1) for s in scores])
        ps = [torch.exp(s - m[..., None]) for s in scores]
        l = psum([p_.sum(dim=-1) for p_ in ps])
        o = psum([torch.einsum("bkgcs,bskh->bckgh", p_.to(cv.dtype), cv).float()
                  for p_, cv in zip(ps, values)])            # (b, 1, KV, G, hd)
        norm = l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]  # (b, 1, KV, G, 1)
        outs.append((o / norm).to(q.dtype))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def _rank_smap(q, k_new, v_new, cache_k_l, cache_v_l, pos, p: Attention,
               cfg: ArchConfig, ctx) -> torch.Tensor:
    """The shardmap decode on a rank mesh, its cache this rank's sequence
    rows of every head: column-parallel q / k / v (this rank's heads) are
    all-gathered over model first, and the whole output's slice of this
    rank's heads goes through the row-parallel ``wo``. Returns the
    attention output before ``wo``, (B, 1, heads here * hd)."""
    B = q.shape[0]
    tp = model_split(p, "wq")
    if tp:
        g = ctx.group("model")
        q, k_new, v_new = (D.all_gather(t, group=g, dim=2)
                           for t in (q, k_new, v_new))
    out = _decode_attention_smap(q, k_new, v_new, cache_k_l, cache_v_l, pos,
                                 cfg, ctx).reshape(B, 1, -1)
    if tp:
        w = out.shape[-1] // ctx.model_size
        out = out[..., ctx.model_rank * w:(ctx.model_rank + 1) * w]
    return out


def decode_attention(x, p: Attention, cfg: ArchConfig, cache_k_l, cache_v_l,
                     pos, *, rope: bool = True):
    """Single-token decode. x: (B, T, d) (T = 1 when serving); cache_*_l:
    (B, S, KV, hd), updated in place. Returns (out (B, T, d), cache_k_l,
    cache_v_l).

    Under ``attn_impl="flash"`` without a sliding window (and T = 1) the
    attention is ``kernels.ops.flash_decode`` over the (B,KV,S,hd) views of
    the updated cache with lengths ``pos + 1``: slots past ``pos`` are what
    the einsum path masks. A q of another dtype than the cache's (float32
    compute) is cast to the cache's, as the kernel takes one dtype.

    On a rank mesh the cache is this rank's: its data rows and, under
    "shardmap", its S / M sequence rows of every head (``lm_prefill``
    lays it out so); otherwise every row of this rank's heads."""
    B, T = x.shape[0], x.shape[1]
    S = cache_k_l.shape[1]
    positions = pos + torch.arange(T, device=x.device)
    q, k_new, v_new = _project_qkv(x, x, p, cfg, positions, positions, rope)
    ctx = current_ctx()
    if cfg.decode_cache_update == "shardmap" and ctx is not None \
            and (ctx.ranked or S % ctx.model_size == 0):
        if T != 1:
            raise ValueError(f"the shardmap decode writes one token, not {T}")
        if ctx.ranked:
            out = _rank_smap(q, k_new, v_new, cache_k_l, cache_v_l, pos, p,
                             cfg, ctx)
        else:
            out = _decode_attention_smap(q, k_new, v_new, cache_k_l, cache_v_l,
                                         pos, cfg, ctx).reshape(B, 1, -1)
        return out_proj(out.to(x.dtype), p, x.dtype), cache_k_l, cache_v_l
    upd = update_cache_layer_dus if cfg.decode_cache_update == "dus" \
        else update_cache_layer
    ck, cv = upd(cache_k_l, cache_v_l, k_new, v_new, pos)

    if cfg.attn_impl == "flash" and cfg.sliding_window == 0 and T == 1:
        from repro_torch.kernels import ops as kops

        lengths = (pos + 1).to(torch.int32).reshape(1).expand(B).contiguous()
        o = kops.flash_decode(q[:, 0].to(ck.dtype), ck.transpose(1, 2),
                              cv.transpose(1, 2), lengths)
        return out_proj(o.reshape(B, 1, -1).to(x.dtype), p, x.dtype), ck, cv

    out = cache_attention(q, ck, cv, positions, cfg).to(x.dtype)
    return out_proj(out, p, x.dtype), ck, cv


def cache_attention(q, ck, cv, positions, cfg: ArchConfig) -> torch.Tensor:
    """The einsum decode attention over a written cache: q (B, T, H, hd)
    at ``positions`` (T,), ck / cv (B, S, KV, hd) -> (B, T, H*hd) in the
    cache's dtype; float32 scores, the causal (and sliding-window) mask, the
    probabilities in the cache's dtype against V."""
    B, T, H, hd = q.shape
    S, KV = ck.shape[1], ck.shape[2]
    G = H // KV
    qq = q.reshape(B, T, KV, G, hd).float()
    scores = torch.einsum("bckgh,bskh->bkgcs", qq, ck.float()) / math.sqrt(hd)
    kpos = torch.arange(S, device=q.device)
    m = kpos[None, :] <= positions[:, None]
    if cfg.sliding_window:
        m &= (positions[:, None] - kpos[None, :]) < cfg.sliding_window
    scores = torch.where(m[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgcs,bskh->bckgh", probs.to(cv.dtype), cv)
    return out.reshape(B, T, H * hd)
