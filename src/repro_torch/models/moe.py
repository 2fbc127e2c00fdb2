"""Fine-grained MoE (DeepSeek-MoE / Moonlight family): shared experts +
top-k routed experts (port of ``repro.models.moe``, single rank).

The reference dispatches per (data, model) shard under a mesh; without one
it runs the same body, ``_local_moe``, with every expert local, rank 0 and
``psum`` / ``pmean`` the identity — which is what this port runs (the
expert-parallel mesh waits for ROADMAP A9b / A10). Dispatch is sort-based
with a capacity bound, in plain torch as the reference computes it outside
any Pallas kernel: a stable argsort of the expert ids, ``searchsorted`` for
each expert's first slot, the rank of each (token, choice) within its
expert, and ``index_add_`` for the reference's ``jax.ops.segment_sum``.

The top-k is a stable descending sort, so equal probabilities go to the
lower expert index, as ``jax.lax.top_k`` orders them (``torch.topk`` makes
no such promise).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ArchConfig, MoESpec
from repro_torch.models.layers import MLP, he_init, mlp


class Experts(nn.Module):
    """w1, w3 (E, d, fe) and w2 (E, fe, d): every expert's SwiGLU."""

    def __init__(self, d: int, fe: int, E: int, generator: torch.Generator):
        super().__init__()
        self.w1 = he_init((E, d, fe), generator, fan_in=d)
        self.w3 = he_init((E, d, fe), generator, fan_in=d)
        self.w2 = he_init((E, fe, d), generator, fan_in=fe)


class MoE(nn.Module):
    """router (d, E), experts, and ``shared`` (an MLP of num_shared * fe)
    when the spec has shared experts."""

    def __init__(self, cfg: ArchConfig, spec: MoESpec,
                 generator: torch.Generator):
        super().__init__()
        d, fe, E = cfg.d_model, spec.d_ff_expert, spec.num_experts
        self.router = he_init((d, E), generator)
        self.experts = Experts(d, fe, E, generator)
        if spec.num_shared:
            self.shared = MLP(d, spec.num_shared * fe, generator, gated=True)


def init_moe(cfg: ArchConfig, spec: MoESpec,
             generator: torch.Generator) -> MoE:
    return MoE(cfg, spec, generator)


def _capacity(tokens: int, spec: MoESpec) -> int:
    return max(int(math.ceil(tokens * spec.top_k * spec.capacity_factor
                             / spec.num_experts)), 4)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last dim, ties to the
    lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _local_moe(xl, router_w, w1, w3, w2, *, spec: MoESpec, e_local: int,
               rank: int, psum, pmean):
    """One rank's MoE body (moe.py:60-113 of the reference). xl: (B, S, d).
    Returns (y (B, S, d), aux loss)."""
    B, S, d = xl.shape
    T = B * S
    xf = xl.reshape(T, d)
    k = spec.top_k
    E = spec.num_experts
    C = _capacity(T, spec)
    off = rank * e_local
    dev = xl.device

    logits = (xf @ router_w.to(xf.dtype)).float()             # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, k)                              # (T, k)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    # switch-style load-balance aux loss over the (global) tokens
    onehot_frac = F.one_hot(idx, E).float().sum(dim=1).mean(dim=0)
    mean_prob = probs.mean(dim=0)
    aux = E * torch.sum(pmean(onehot_frac) * pmean(mean_prob)) / k

    # -- local dispatch (sort-based rank-in-expert, capacity C) --------------
    flat_idx = idx.reshape(-1)                                 # (T*k,)
    flat_gate = gates.reshape(-1)
    is_local = (flat_idx >= off) & (flat_idx < off + e_local)
    lidx = (flat_idx - off).clamp(0, e_local - 1)
    sort_key = torch.where(is_local, lidx, e_local).to(torch.int32)
    order = torch.argsort(sort_key, stable=True)
    sorted_key = sort_key[order]
    starts = torch.searchsorted(
        sorted_key, torch.arange(e_local + 1, device=dev, dtype=torch.int32),
        side="left")
    rank_sorted = torch.arange(T * k, device=dev) \
        - starts[sorted_key.clamp(0, e_local).long()]
    rank_in_e = torch.zeros(T * k, dtype=torch.int64, device=dev)
    rank_in_e[order] = rank_sorted
    keep = is_local & (rank_in_e < C)
    slot = lidx * C + rank_in_e.clamp(max=C - 1)
    token_of = torch.arange(T * k, device=dev) // k

    contrib = torch.where(keep[:, None], xf[token_of], 0).to(xf.dtype)
    xdisp = torch.zeros((e_local * C, d), dtype=xf.dtype, device=dev) \
        .index_add_(0, slot, contrib).reshape(e_local, C, d)

    # -- expert FFN (swiglu), the rank's e_local experts ----------------------
    h1 = torch.einsum("ecd,edf->ecf", xdisp, w1.to(xdisp.dtype))
    h3 = torch.einsum("ecd,edf->ecf", xdisp, w3.to(xdisp.dtype))
    yd = torch.einsum("ecf,efd->ecd", F.silu(h1) * h3, w2.to(xdisp.dtype))

    # -- combine: gather own slots, weight, sum over k, psum over ranks -------
    y_flat = yd.reshape(e_local * C, d)
    w = torch.where(keep, flat_gate, 0.0).to(y_flat.dtype)
    y_tok = y_flat[slot] * w[:, None]
    y_part = y_tok.reshape(T, k, d).sum(dim=1)
    return psum(y_part).reshape(B, S, d), aux


def _identity(v):
    return v


def moe_ffn(x: torch.Tensor, p: MoE, cfg: ArchConfig,
            spec: MoESpec) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux loss); the shared experts add on top."""
    y, aux = _local_moe(x, p.router, p.experts.w1, p.experts.w3, p.experts.w2,
                        spec=spec, e_local=spec.num_experts, rank=0,
                        psum=_identity, pmean=_identity)
    if getattr(p, "shared", None) is not None:
        y = y + mlp(x, p.shared)
    return y, aux
