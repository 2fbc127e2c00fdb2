"""RWKV6 "Finch": an attention-free LM with data-dependent per-channel decay
(port of ``repro.models.rwkv``).

Prefill uses the chunked form of the linear recurrence: within a chunk of
C steps the pairwise decay factorises into r~ = r exp(ecum), k~ = k
exp(-cum), so the intra-chunk interaction is one (C x C) product per head;
the (N x N) state per head flows from chunk to chunk in a Python loop (the
reference's ``lax.scan``). Decode keeps the exact O(1) recurrence. As in
the reference, the chunked path clamps the log-decay at -4 a step (C = 16
keeps every exponent below e^64); the sequential path has no clamp beyond
the one in the projection.

On a rank mesh (weights placed by ``sharding.place_params``) the time mix
is tensor-parallel over "model" as the reference's rule table places it:
``wr``, ``wk``, ``wv``, ``wg`` and ``w_lora_b`` column-parallel (this
rank's heads), ``wo`` row-parallel, ``w_lora_a`` whole. A rank runs the
WKV recurrence on its H / M heads alone, with its heads' slices of the
whole ``w0``, ``u`` and ``ln_x``; the channel mix is whole, as in the
reference. The embedding and the head are vocab-parallel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (chunked_ce_loss, embed_lookup,
                                       he_init, head_logits, init_embed,
                                       layer_norm, remat, rms_norm)
from repro_torch.models.sharding import (current_ctx, local_heads, model_split,
                                         rank_slice, tp_enter, tp_merge,
                                         vocab_offset, weight)

CHUNK = 16
LW_MIN = -4.0  # per-step log-decay clamp for the chunked path


def _full(n: int, value: float, dev) -> nn.Parameter:
    return nn.Parameter(torch.full((n,), value, device=dev))


class TimeMix(nn.Module):
    """wr, wk, wv, wg, wo (d, d); the decay LoRA w_lora_a (d, r), w_lora_b
    (r, d) and w0 (d,); the bonus u (H, N); the token-shift mixes mu_*; the
    per-head output norm ln_x (d,)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        d, r = cfg.d_model, cfg.rwkv_lora
        H, N = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        dev = generator.device
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, he_init((d, d), generator))
        self.w_lora_a = nn.Parameter(he_init((d, r), generator).data * 0.1)
        self.w_lora_b = nn.Parameter(he_init((r, d), generator).data * 0.1)
        self.w0 = _full(d, -0.6, dev)  # decay ~ exp(-exp(-0.6)) ~ 0.58
        self.u = nn.Parameter(torch.zeros((H, N), device=dev))
        for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
            setattr(self, name, _full(d, 0.5, dev))
        self.ln_x = nn.Parameter(torch.ones(d, device=dev))


class ChannelMix(nn.Module):
    """mu_k, mu_r (d,); ck (d, f), cv (f, d), cr (d, d)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        dev = generator.device
        self.mu_k = _full(d, 0.5, dev)
        self.mu_r = _full(d, 0.5, dev)
        self.ck = he_init((d, f), generator)
        self.cv = he_init((f, d), generator)
        self.cr = he_init((d, d), generator)


class RWKVBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        d, dev = cfg.d_model, generator.device
        self.wkv = TimeMix(cfg, generator)
        self.cmix = ChannelMix(cfg, generator)
        self.ln1, self.ln2 = _full(d, 1.0, dev), _full(d, 1.0, dev)
        self.ln1_b, self.ln2_b = _full(d, 0.0, dev), _full(d, 0.0, dev)


class RWKVLM(nn.Module):
    """embed, ln0 / ln0_b, ``layers``, final_norm / final_norm_b,
    lm_head."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        d, dev = cfg.d_model, generator.device
        self.embed = init_embed(cfg.vocab, d, generator)
        self.ln0, self.ln0_b = _full(d, 1.0, dev), _full(d, 0.0, dev)
        self.layers = nn.ModuleList(RWKVBlock(cfg, generator)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _full(d, 1.0, dev)
        self.final_norm_b = _full(d, 0.0, dev)
        self.lm_head = he_init((d, cfg.vocab), generator, fan_in=d)


def init_rwkv_lm(cfg: ArchConfig, generator: torch.Generator) -> RWKVLM:
    return RWKVLM(cfg, generator)


def _token_shift(x, x_prev_last):
    """x: (B,S,D); x_prev_last: (B,D), the previous segment's last input
    (zeros at the start). Returns x shifted right one step."""
    return torch.cat([x_prev_last[:, None, :], x[:, :-1, :]], dim=1)


def _lerp(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def _heads(p: TimeMix, H: int) -> tuple[bool, int, int]:
    """(tensor-parallel, this rank's head count, its first head): the
    time mix runs H / M heads from rank r * H / M where ``wr`` is split
    over model, else all H."""
    if not model_split(p, "wr"):
        return False, H, 0
    ctx = current_ctx()
    Hl = H // ctx.model_size
    return True, Hl, ctx.model_rank * Hl


def _project_rkvwg(x, xs, p: TimeMix, H: int, N: int):
    """r, k, v, lw (B,S,H,N) and g (B,S,H*N); on a rank mesh with the
    projections split over model, this rank's heads."""
    B, S, d = x.shape
    tp, Hl, h0 = _heads(p, H)

    def col(h, name):  # column-parallel: a whole input, this rank's columns
        return (tp_enter(h) if tp else h) @ weight(p, name, x.dtype)

    r = col(_lerp(x, xs, p.mu_r), "wr")
    k = col(_lerp(x, xs, p.mu_k), "wk")
    v = col(_lerp(x, xs, p.mu_v), "wv")
    g = F.silu(col(_lerp(x, xs, p.mu_g), "wg"))
    xw = _lerp(x, xs, p.mu_w)
    lora = col(torch.tanh(xw @ weight(p, "w_lora_a", x.dtype)), "w_lora_b")
    w0 = rank_slice(p.w0, (h0 * N, Hl * N)) if tp else p.w0
    lw = -torch.exp((w0.float() + lora.float()).clamp(-20.0, 1.386))
    lw = lw.clamp_min(LW_MIN)
    shp = (B, S, Hl, N)
    return r.reshape(shp), k.reshape(shp), v.reshape(shp), g, lw.reshape(shp)


def wkv6_chunked(r, k, v, lw, u, state0=None, chunk: int = CHUNK):
    """Chunked WKV6. r, k, v, lw: (B,S,H,N), lw the log-decay (float32,
    <= 0); u: (H,N). Returns (out (B,S,H,N) in r's dtype, state (B,H,N,N)
    float32)."""
    B, S, H, N = r.shape
    chunk = min(chunk, S)
    if S % chunk:  # pad the tail: k = v = 0 add nothing, lw = 0 keeps state
        pw = (0, 0, 0, 0, 0, chunk - S % chunk)
        out, state = wkv6_chunked(F.pad(r, pw), F.pad(k, pw), F.pad(v, pw),
                                  F.pad(lw, pw), u, state0, chunk)
        return out[:, :S], state
    nc = S // chunk

    def split(a):  # (nc, B, H, C, N)
        return a.float().reshape(B, nc, chunk, H, N).permute(1, 0, 3, 2, 4)

    rf, kf, vf, lwf = split(r), split(k), split(v), split(lw)
    st = state0 if state0 is not None else torch.zeros(
        (B, H, N, N), dtype=torch.float32, device=r.device)
    uu = u.float()
    mask = torch.tril(torch.ones((chunk, chunk), device=r.device), diagonal=-1)
    outs = []
    for c in range(nc):
        rc, kc, vc, lwc = rf[c], kf[c], vf[c], lwf[c]       # (B,H,C,N)
        cum = torch.cumsum(lwc, dim=2)                      # inclusive
        ecum = cum - lwc                                    # exclusive
        total = cum[:, :, -1:, :]                           # (B,H,1,N)
        r_t = rc * torch.exp(ecum)
        k_t = kc * torch.exp(-cum)
        att = torch.einsum("bhcn,bhsn->bhcs", r_t, k_t) * mask
        diag = torch.einsum("bhcn,hn->bhc", rc * kc, uu)
        out = torch.einsum("bhcs,bhsn->bhcn", att, vc) + diag[..., None] * vc
        out = out + torch.einsum("bhcn,bhnm->bhcm", r_t, st)
        k_hat = kc * torch.exp(total - cum)
        st = torch.exp(total).transpose(2, 3) * st \
            + torch.einsum("bhsn,bhsm->bhnm", k_hat, vc)
        outs.append(out)
    out = torch.stack(outs, dim=1)                          # (B,nc,H,C,N)
    out = out.permute(0, 1, 3, 2, 4).reshape(B, S, H, N)
    return out.to(r.dtype), st


def wkv6_sequential(r, k, v, lw, u, state0=None):
    """The exact per-step recurrence (the oracle and the decode path); the
    same signature as :func:`wkv6_chunked`."""
    B, S, H, N = r.shape
    st = state0 if state0 is not None else torch.zeros(
        (B, H, N, N), dtype=torch.float32, device=r.device)
    rf, kf, vf, lwf = (a.float() for a in (r, k, v, lw))
    uu = u.float()
    outs = []
    for t in range(S):
        kv = torch.einsum("bhn,bhm->bhnm", kf[:, t], vf[:, t])
        outs.append(torch.einsum("bhn,bhnm->bhm", rf[:, t],
                                 st + uu[None, :, :, None] * kv))
        st = torch.exp(lwf[:, t])[..., None] * st + kv
    return torch.stack(outs, dim=1).to(r.dtype), st


def rwkv_time_mix(x, p: TimeMix, cfg: ArchConfig, x_prev=None, state=None, *,
                  sequential=False):
    """x: (B,S,D). Returns (y, (last input, new state))."""
    B, S, d = x.shape
    H, N = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    if x_prev is None:
        x_prev = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    xs = _token_shift(x, x_prev)
    r, k, v, g, lw = _project_rkvwg(x, xs, p, H, N)
    tp, Hl, h0 = _heads(p, H)
    u = rank_slice(p.u, (h0, Hl)) if tp else p.u
    ln_x = rank_slice(p.ln_x, (h0 * N, Hl * N)) if tp else p.ln_x
    fn = wkv6_sequential if sequential else wkv6_chunked
    out, new_state = fn(r, k, v, lw, u, state)
    out = rms_norm(out, ln_x.reshape(Hl, N), cfg.norm_eps).reshape(B, S, Hl * N)
    y = (out * g) @ weight(p, "wo", x.dtype)     # row-parallel under TP
    return (tp_merge(y) if tp else y), (x[:, -1, :], new_state)


def rwkv_channel_mix(x, p: ChannelMix, x_prev=None):
    B, S, d = x.shape
    if x_prev is None:
        x_prev = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    xs = _token_shift(x, x_prev)
    k = torch.square(F.relu(_lerp(x, xs, p.mu_k) @ p.ck.to(x.dtype)))
    kv = k @ p.cv.to(x.dtype)
    rgate = torch.sigmoid(_lerp(x, xs, p.mu_r) @ p.cr.to(x.dtype))
    return rgate * kv, x[:, -1, :]


def rwkv_block(x, p: RWKVBlock, cfg: ArchConfig, cache=None, *,
               sequential=False):
    """The full block. cache: None (prefill from the start) or a dict of
    att_x / att_state / ffn_x."""
    c = cache or {}
    att, (ax, astate) = rwkv_time_mix(
        layer_norm(x, p.ln1, p.ln1_b, cfg.norm_eps), p.wkv, cfg,
        c.get("att_x"), c.get("att_state"), sequential=sequential)
    x = x + att
    ffn, fx = rwkv_channel_mix(layer_norm(x, p.ln2, p.ln2_b, cfg.norm_eps),
                               p.cmix, c.get("ffn_x"))
    x = x + ffn
    return x, {"att_x": ax, "att_state": astate, "ffn_x": fx}


def _train_block(x, blk, cfg):
    return rwkv_block(x, blk, cfg)[0]


def rwkv_forward_hidden(model: RWKVLM, tokens: torch.Tensor,
                        cfg: ArchConfig) -> torch.Tensor:
    """The training trunk (the chunked WKV6 form), each block checkpointed
    under ``cfg.remat`` -> the final-normed (B, S, d) hidden states."""
    x = embed_lookup(model, tokens)
    x = layer_norm(x, model.ln0, model.ln0_b, cfg.norm_eps)
    for blk in model.layers:
        x = remat(_train_block, x, blk, cfg, enabled=cfg.remat)
    return layer_norm(x, model.final_norm, model.final_norm_b, cfg.norm_eps)


def rwkv_loss(model: RWKVLM, batch: dict, cfg: ArchConfig):
    """Next-token cross entropy -> (loss, {"ce"})."""
    tokens = batch["tokens"]
    hidden = rwkv_forward_hidden(model, tokens, cfg)
    loss_sum = chunked_ce_loss(hidden[:, :-1], weight(model, "lm_head"),
                               tokens[:, 1:], chunk=cfg.loss_chunk,
                               vocab_offset=vocab_offset(model, "lm_head"))
    loss = loss_sum / (tokens.shape[0] * (tokens.shape[1] - 1))
    return loss, {"ce": loss}


# -- serving -------------------------------------------------------------------


def make_cache(cfg: ArchConfig, batch: int, max_len: int, device=None) -> dict:
    """O(1) in the sequence length: an (N x N) state per head per layer and
    the two token-shift carries (``max_len`` is not used); on ``device``
    (``None``: the card, raising without one). Under a rank mesh's
    context the state holds this rank's heads."""
    dev = resolve_device(device)
    d = cfg.d_model
    H, N = local_heads(d // cfg.rwkv_head_dim), cfg.rwkv_head_dim
    L = cfg.n_layers
    bf16 = torch.bfloat16
    shapes = {"att_x": ((L, batch, d), bf16),
              "att_state": ((L, batch, H, N, N), torch.float32),
              "ffn_x": ((L, batch, d), bf16), "pos": ((), torch.int32)}
    return {k: torch.zeros(s, dtype=dt, device=dev)
            for k, (s, dt) in shapes.items()}


def rwkv_prefill(model: RWKVLM, batch: dict, cfg: ArchConfig,
                 max_len: int | None = None):
    tokens = batch["tokens"]
    x = embed_lookup(model, tokens)
    x = layer_norm(x, model.ln0, model.ln0_b, cfg.norm_eps)
    ax, ast, fx = [], [], []
    for blk in model.layers:
        x, c = rwkv_block(x, blk, cfg)
        ax.append(c["att_x"].to(torch.bfloat16))
        ast.append(c["att_state"])
        fx.append(c["ffn_x"].to(torch.bfloat16))
    x = layer_norm(x[:, -1:, :], model.final_norm, model.final_norm_b,
                   cfg.norm_eps)
    logits = head_logits(x, model, "lm_head")
    cache = {"att_x": torch.stack(ax), "att_state": torch.stack(ast),
             "ffn_x": torch.stack(fx),
             "pos": torch.tensor(tokens.shape[1], dtype=torch.int32,
                                 device=x.device)}
    return cache, logits


def rwkv_decode_step(model: RWKVLM, cache: dict, tokens: torch.Tensor,
                     cfg: ArchConfig):
    """One decode step; each layer's carries and state are replaced in the
    cache's buffers, ``pos`` advanced."""
    x = embed_lookup(model, tokens)
    x = layer_norm(x, model.ln0, model.ln0_b, cfg.norm_eps)
    for i, blk in enumerate(model.layers):
        x, c = rwkv_block(x, blk, cfg,
                          cache={"att_x": cache["att_x"][i].to(x.dtype),
                                 "att_state": cache["att_state"][i],
                                 "ffn_x": cache["ffn_x"][i].to(x.dtype)},
                          sequential=True)
        for key in ("att_x", "att_state", "ffn_x"):
            cache[key][i].copy_(c[key])
    x = layer_norm(x, model.final_norm, model.final_norm_b, cfg.norm_eps)
    logits = head_logits(x, model, "lm_head")
    return dict(cache, pos=cache["pos"] + tokens.shape[1]), logits
