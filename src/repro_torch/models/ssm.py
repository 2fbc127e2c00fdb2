"""Mamba2 (state-space dual / SSD) blocks, used by the zamba2 hybrid (port
of ``repro.models.ssm``).

The decay is one scalar per head, so the chunked form is stable: every
exponent it uses is a within-chunk decay difference <= 0 (the unused,
masked ones are masked before the exponential, not after it as in the
reference, whose exp overflows there at published widths and turns the
mask's 0 into NaN). Within a chunk the work
is (C x C) products; the (H, N, P) state per sequence flows from chunk to
chunk in a Python loop (the reference's ``lax.scan``). Decode is the exact
per-step recurrence plus a ring of the last CONV_W - 1 conv inputs.

On a rank mesh (weights placed by ``sharding.place_params``) the mixer is
tensor-parallel over "model": a rank runs H / M heads. The rule table
cuts ``w_in`` (d, 2 di + 2N + H) into contiguous column blocks, which do
not line up with the heads (``z | x | B | C | dt``), so it is stored as
cut and all-gathered over model in the layer (``sharding.model_gathered``,
the backward a reduce-scatter: the B and C columns every rank reads get
the sum of the ranks' parts); a rank then takes its heads' ``z``, ``x``
and ``dt`` columns and all of B and C, its x channels and the B and C
ones of the whole conv, and its heads of ``dt_bias``, ``A_log``, ``D``
and the norm scale. The gated norm normalises over all di channels: a
rank's sum of squares is summed over model (``sharding.model_sum``).
``w_out`` is row-parallel, its row blocks a rank's heads.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import he_init, rms_norm
from repro_torch.models.sharding import (current_ctx, model_gathered, model_split,
                                         model_sum, rank_slice, tp_enter,
                                         tp_merge, weight)

SSD_CHUNK = 64
CONV_W = 4


def dims(cfg: ArchConfig):
    di = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    H = di // P
    N = cfg.ssm_state
    return di, H, P, N


class SSM(nn.Module):
    """w_in (d, 2 di + 2N + H), the depthwise conv (conv_w (Ch, W), conv_b),
    dt_bias, A_log (a = exp(-exp(A_log) dt)), D, the gated norm and w_out
    (di, d)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        d = cfg.d_model
        di, H, P, N = dims(cfg)
        dev = generator.device
        conv_ch = di + 2 * N
        self.w_in = he_init((d, 2 * di + 2 * N + H), generator)
        self.conv_w = nn.Parameter(torch.randn((conv_ch, CONV_W),
                                               generator=generator,
                                               device=dev) * 0.2)
        self.conv_b = nn.Parameter(torch.zeros(conv_ch, device=dev))
        self.dt_bias = nn.Parameter(torch.zeros(H, device=dev))
        self.A_log = nn.Parameter(torch.zeros(H, device=dev))
        self.D = nn.Parameter(torch.ones(H, device=dev))
        self.norm = nn.Parameter(torch.ones(di, device=dev))
        self.w_out = he_init((di, d), generator, fan_in=di)


class SSMBlock(nn.Module):
    """ssm and its pre-norm ln (d,)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        self.ssm = SSM(cfg, generator)
        self.ln = nn.Parameter(torch.ones(cfg.d_model, device=generator.device))


def init_ssm_block(cfg: ArchConfig, generator: torch.Generator) -> SSMBlock:
    return SSMBlock(cfg, generator)


def _causal_conv(x, w, b, x_prev=None):
    """Depthwise causal conv. x: (B,S,Ch); w: (Ch,W); x_prev: (B,W-1,Ch).
    Returns (silu(conv), the last W-1 inputs)."""
    B, S, Ch = x.shape
    W = w.shape[1]
    if x_prev is None:
        x_prev = torch.zeros((B, W - 1, Ch), dtype=x.dtype, device=x.device)
    xp = torch.cat([x_prev, x], dim=1)                 # (B, S+W-1, Ch)
    out = sum(xp[:, j:j + S, :] * w[:, j].to(x.dtype) for j in range(W))
    out = out + b.to(x.dtype)
    return F.silu(out), xp[:, -(W - 1):, :]


def ssd_chunked(xh, Bc, Cc, la, dt, state0=None, chunk: int = SSD_CHUNK):
    """Chunked SSD scan. xh: (B,S,H,P) head inputs; Bc / Cc: (B,S,N); la:
    (B,S,H) log-decay <= 0; dt: (B,S,H) input gates. Returns (y (B,S,H,P)
    in xh's dtype, state (B,H,N,P) float32)."""
    B, S, H, P = xh.shape
    N = Bc.shape[-1]
    chunk = min(chunk, S)
    if S % chunk:  # pad the tail: dt = 0 adds no state, la = 0 keeps decay 1
        pad = chunk - S % chunk
        p3, p4 = (0, 0, 0, pad), (0, 0, 0, 0, 0, pad)
        out, state = ssd_chunked(F.pad(xh, p4), F.pad(Bc, p3), F.pad(Cc, p3),
                                 F.pad(la, p3), F.pad(dt, p3), state0, chunk)
        return out[:, :S], state
    nc = S // chunk

    def split(a, tail):
        return a.float().reshape((B, nc, chunk) + tail).transpose(0, 1)

    xs, bs, cs = split(xh, (H, P)), split(Bc, (N,)), split(Cc, (N,))
    las, dts = split(la, (H,)), split(dt, (H,))
    st = state0 if state0 is not None else torch.zeros(
        (B, H, N, P), dtype=torch.float32, device=xh.device)
    future = ~torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                    device=xh.device))           # s > t
    ys = []
    for c in range(nc):
        xc, bc, cc, lac, dtc = xs[c], bs[c], cs[c], las[c], dts[c]
        cum = torch.cumsum(lac, dim=1)                           # (B,C,H)
        total = cum[:, -1:, :]                                   # (B,1,H)
        cb = torch.einsum("btn,bsn->bts", cc, bc)
        # decay from s to t (B,t,s,H): exponents <= 0 where s <= t; the
        # masked s > t entries would be exp of a positive sum, which
        # overflows to inf at published widths (the reference's exp-then-
        # mask makes inf * 0 = NaN there), so they are masked before exp
        seg = cum[:, :, None, :] - cum[:, None, :, :]
        dec = torch.exp(seg.masked_fill(future[None, :, :, None], -math.inf))
        att = cb[..., None] * dec * dtc[:, None, :, :]
        y = torch.einsum("btsh,bshp->bthp", att, xc)
        y = y + torch.einsum("btn,bhnp->bthp", cc, st) * torch.exp(cum)[..., None]
        khat = torch.exp(total - cum) * dtc                      # (B,C,H)
        st = torch.exp(total)[:, 0, :, None, None] * st \
            + torch.einsum("bsn,bshp,bsh->bhnp", bc, xc, khat)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, S, H, P)
    return y.to(xh.dtype), st


def ssd_sequential(xh, Bc, Cc, la, dt, state0=None):
    """The exact per-step recurrence (the oracle and the decode path); the
    same signature as :func:`ssd_chunked`."""
    B, S, H, P = xh.shape
    N = Bc.shape[-1]
    st = state0 if state0 is not None else torch.zeros(
        (B, H, N, P), dtype=torch.float32, device=xh.device)
    xf, bf, cf, laf, dtf = (a.float() for a in (xh, Bc, Cc, la, dt))
    ys = []
    for t in range(S):
        st = torch.exp(laf[:, t])[:, :, None, None] * st \
            + torch.einsum("bn,bhp,bh->bhnp", bf[:, t], xf[:, t], dtf[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", cf[:, t], st))
    return torch.stack(ys, dim=1).to(xh.dtype), st


class Share:
    """The part of the mixer one rank runs: heads ``[h0, h0 + Hl)`` of H,
    their di channels ``[c0, c0 + dl)``; ``tp`` where the mixer is
    tensor-parallel (its weights split over model on a rank mesh)."""

    def __init__(self, p: SSM, cfg: ArchConfig):
        di, H, P, _ = dims(cfg)
        self.tp = model_split(p, "w_out")   # row blocks: whole heads
        M, r = (current_ctx().model_size, current_ctx().model_rank) \
            if self.tp else (1, 0)
        self.Hl, self.h0 = H // M, r * (H // M)
        self.dl, self.c0 = self.Hl * P, self.h0 * P


def _in_columns(w, share: Share, di: int, N: int):
    """A rank's columns of the whole w_in (d, 2 di + 2N + H): its heads'
    z, its heads' x, all of B and C, its heads' dt."""
    c0, dl = share.c0, share.dl
    return torch.cat([w.narrow(1, c0, dl), w.narrow(1, di + c0, dl),
                      w.narrow(1, 2 * di, 2 * N),
                      w.narrow(1, 2 * di + 2 * N + share.h0, share.Hl)], dim=1)


def _gated_norm(h, scale, cfg: ArchConfig, share: Share):
    """``rms_norm(h, scale)`` over all di channels, h (B,S,dl) this rank's
    channels: the float32 sum of squares summed over model under TP."""
    if not share.tp:
        return rms_norm(h, scale, cfg.norm_eps)
    ss = model_sum(h.float().square().sum(dim=-1, keepdim=True))
    di = dims(cfg)[0]
    inv = torch.rsqrt(ss / di + cfg.norm_eps).to(h.dtype)
    return h * inv * scale.to(h.dtype)


def ssm_mixer(x, p: SSM, cfg: ArchConfig, cache=None, *, sequential=False):
    """Mamba2 mixer. x: (B,S,d). cache: {conv: (B,W-1,Ch), state:
    (B,H,N,P)}, this rank's channels and heads under TP. Returns (out
    (B,S,d), {conv, state})."""
    B, S, d = x.shape
    di, H, P, N = dims(cfg)
    c = cache or {}
    sh = Share(p, cfg)
    Hl, dl = sh.Hl, sh.dl
    if sh.tp:
        # the whole w_in: gathered where it is split (where M does not
        # divide 2 di + 2N + H it is whole, each rank's gradient partial)
        w_in = model_gathered(p, "w_in", x.dtype) if model_split(p, "w_in") \
            else tp_enter(weight(p, "w_in", x.dtype))
        proj = tp_enter(x) @ _in_columns(w_in, sh, di, N)
        # whole parameters: this rank's channels and heads
        chans = ((sh.c0, dl), (di, 2 * N))
        conv_w, conv_b = rank_slice(p.conv_w, *chans), rank_slice(p.conv_b, *chans)
        heads = (sh.h0, Hl)
        dt_bias, A_log, D = (rank_slice(t, heads) for t in (p.dt_bias, p.A_log, p.D))
        norm = rank_slice(p.norm, (sh.c0, dl))
    else:
        proj = x @ weight(p, "w_in", x.dtype)
        conv_w, conv_b, dt_bias, A_log, D, norm = (
            p.conv_w, p.conv_b, p.dt_bias, p.A_log, p.D, p.norm)
    z, xBC, dt_raw = proj.split([dl, dl + 2 * N, Hl], dim=-1)
    xBC, conv_state = _causal_conv(xBC, conv_w, conv_b, c.get("conv"))
    xc, Bc, Cc = xBC.split([dl, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + dt_bias)                   # (B,S,Hl)
    la = -torch.exp(A_log.float()) * dt                         # log decay <= 0
    xh = xc.reshape(B, S, Hl, P)
    fn = ssd_sequential if sequential else ssd_chunked
    y, state = fn(xh, Bc, Cc, la, dt, c.get("state"))
    y = y + D.to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(B, S, dl)
    y = _gated_norm(y * F.silu(z), norm, cfg, sh)
    out = y @ weight(p, "w_out", x.dtype)                     # row-parallel
    return (tp_merge(out) if sh.tp else out), {"conv": conv_state, "state": state}
