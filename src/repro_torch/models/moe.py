"""Fine-grained MoE (DeepSeek-MoE / Moonlight family): shared experts +
top-k routed experts, expert-parallel over the mesh's "model" axis (port
of ``repro.models.moe``).

Without a mesh the layer is the reference's ``_local_moe`` with every
expert local, rank 0 and ``psum`` / ``pmean`` the identity. Under a
sharding context with a model extent M > 1 that divides the expert count
it is the reference's expert-parallel shard_map on the port's one-device
mesh (``models/sharding.py``): each data shard's row block goes to M
ranks, rank r runs experts [r*E/M, (r+1)*E/M) with the capacity of its
block's tokens (``cfg.moe_gather_dtype="bf16"`` casts the expert weights
first, as the reference does before its shard_map), and a ``psum`` over
the ranks combines their partial outputs; the aux loss takes ``pmean``
over the data shards. The router runs once per row block: every rank of
the reference computes the same routing redundantly.

Dispatch is sort-based with a capacity bound, in plain torch as the
reference computes it outside any Pallas kernel: a stable argsort of the
expert ids, ``searchsorted`` for each expert's first slot, the rank of
each (token, choice) within its expert, and ``index_add_`` for the
reference's ``jax.ops.segment_sum``. The top-k is a stable descending
sort, so equal probabilities go to the lower expert index, as
``jax.lax.top_k`` orders them (``torch.topk`` makes no such promise).
On a rank mesh (``launch/mesh.RankMesh``) the layer is
:func:`_rank_moe`: this rank stores only its experts (``sharding.place_params``)
and the merges run over the ranks' process groups.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.engine import distributed as D
from repro_torch.models.config import ArchConfig, MoESpec
from repro_torch.models.layers import MLP, he_init, mlp
from repro_torch.models.sharding import (current_ctx, data_pmean, model_split,
                                         tp_enter, tp_merge, weight)


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


def _route(xf: torch.Tensor, router_w: torch.Tensor, spec: MoESpec):
    """(probs (T, E) float32, gates (T, k), expert ids (T, k)) of tokens
    xf (T, d): the softmax router, its top k, the gates renormalised."""
    logits = (xf @ router_w.to(xf.dtype)).float()             # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, spec.top_k)                     # (T, k)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, idx


def _frac(idx: torch.Tensor, E: int) -> torch.Tensor:
    """Each expert's share of the (token, choice) pairs, times k. The
    one-hot rows are built by comparison, not ``F.one_hot``, whose CPU
    path first checks the ids' range on the host (an extra reduction a
    cost model would count on the CPU alone); the values are the same."""
    onehot = idx[..., None] == torch.arange(E, device=idx.device)
    return onehot.float().sum(dim=1).mean(dim=0)


def _expert_counts(idx: torch.Tensor, E: int) -> torch.Tensor:
    """Tokens routed to each expert, (E,) int64: ``torch.bincount``'s
    counts as a scatter-add, which also runs on "meta" (the dry-run)."""
    flat = idx.reshape(-1)
    return torch.zeros(E, dtype=torch.int64, device=idx.device).scatter_add_(
        0, flat, torch.ones_like(flat))


def _dispatch(xf, gates, idx, w1, w3, w2, *, e_local: int, rank: int,
              capacity: int, rank_offset=None) -> torch.Tensor:
    """One rank's experts over tokens xf (T, d) -> its partial output
    (T, d): every (token, choice) routed to one of experts
    [rank * e_local, (rank + 1) * e_local) takes a slot by its rank within
    its expert (``rank_offset`` (e_local,), where given, adds the tokens
    of earlier row blocks to that rank), up to ``capacity`` slots an
    expert; each slot goes through its expert's SwiGLU and comes back
    weighted by its gate."""
    T, d = xf.shape
    k = idx.shape[1]
    C = capacity
    off = rank * e_local
    dev = xf.device

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
    if rank_offset is not None:
        rank_in_e = rank_in_e + rank_offset[lidx]
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

    # -- combine: gather own slots, weight, sum over k -------------------------
    y_flat = yd.reshape(e_local * C, d)
    w = torch.where(keep, flat_gate, 0.0).to(y_flat.dtype)
    y_tok = y_flat[slot] * w[:, None]
    return y_tok.reshape(T, k, d).sum(dim=1)


def _local_moe(xl, router_w, w1, w3, w2, *, spec: MoESpec, e_local: int,
               rank: int, psum, pmean):
    """One rank's MoE body (moe.py:60-113 of the reference). xl: (B, S, d).
    Returns (y (B, S, d), aux loss)."""
    B, S, d = xl.shape
    T = B * S
    xf = xl.reshape(T, d)
    E, k = spec.num_experts, spec.top_k
    probs, gates, idx = _route(xf, router_w, spec)
    # switch-style load-balance aux loss over the (global) tokens
    aux = E * torch.sum(pmean(_frac(idx, E)) * pmean(probs.mean(dim=0))) / k
    y = _dispatch(xf, gates, idx, w1, w3, w2, e_local=e_local, rank=rank,
                  capacity=_capacity(T, spec))
    return psum(y).reshape(B, S, d), aux


def _identity(v):
    return v


def _mesh_moe(x, p: MoE, cfg: ArchConfig, spec: MoESpec, ctx):
    """``moe_ffn`` under a sharding context. With expert parallelism (a
    model extent M > 1 that divides E) the batch splits into the data
    shards' row blocks and each block into M ranks of E/M experts, each
    with the capacity of its block's tokens; a ``psum`` over the ranks
    combines a block (the reference's shard_map). Without it the layer is
    the reference's GSPMD one: every expert over the whole batch, one
    capacity. The aux loss takes ``pmean`` over the data shards of the
    routing fractions and mean probabilities.

    Inside one data shard's body (``ctx.data_index``; the data-parallel
    train step) the batch is that shard's block. The step's first pass
    (``ctx.gathering``, no gradients) records each block's routing
    fractions and per-expert token counts in ``ctx.gathered``; its second
    pass reads them: the aux loss is its global value split over the
    shards (E / k * sum(pmean(frac) * probs_i), whose mean over the
    shards is the reference's), and without expert parallelism each
    block's ranks within an expert start after the earlier blocks' tokens
    and the capacity is the whole batch's, as GSPMD computes it."""
    B, S, d = x.shape
    E, k = spec.num_experts, spec.top_k
    M = ctx.model_size
    ep = M > 1 and E % M == 0
    e_local = E // M if ep else E
    ranks = range(M) if ep else range(1)
    w1, w3, w2 = p.experts.w1, p.experts.w3, p.experts.w2
    if ep and cfg.moe_gather_dtype == "bf16":
        w1, w3, w2 = (w.to(torch.bfloat16) for w in (w1, w3, w2))

    def block(xb, capacity, rank_offset=None):
        xf = xb.reshape(-1, d)
        probs, gates, idx = _route(xf, p.router, spec)
        parts = [_dispatch(xf, gates, idx, w1[r * e_local:(r + 1) * e_local],
                           w3[r * e_local:(r + 1) * e_local],
                           w2[r * e_local:(r + 1) * e_local], e_local=e_local,
                           rank=r, capacity=capacity,
                           rank_offset=None if rank_offset is None
                           else rank_offset[r * e_local:(r + 1) * e_local])
                 for r in ranks]
        return D.psum(parts).reshape(xb.shape), probs, idx

    if ctx.data_index is None:
        blocks = x.chunk(ctx.data_blocks(B) if ep else 1)
        outs = [block(xb, _capacity(xb.shape[0] * S, spec)) for xb in blocks]
        y = torch.cat([o[0] for o in outs]) if len(outs) > 1 else outs[0][0]
        aux = E * torch.sum(D.pmean([_frac(o[2], E) for o in outs])
                            * D.pmean([o[1].mean(dim=0) for o in outs])) / k
        return y, aux

    i, n = ctx.data_index, ctx.data_size
    stats = ctx.gathered.setdefault(id(p), [None] * n)
    T = B * S
    offset = None
    capacity = _capacity(T, spec)
    if not ep:
        capacity = _capacity(T * n, spec)
        earlier = [c for _, c in stats[:i]]
        offset = D.psum(earlier) if earlier else torch.zeros(
            E, dtype=torch.int64, device=x.device)
    y, probs, idx = block(x, capacity, offset)
    if ctx.gathering:
        stats[i] = (_frac(idx, E), _expert_counts(idx, E))
        return y, torch.zeros((), dtype=torch.float32, device=x.device)
    frac = D.pmean([f for f, _ in stats])
    return y, E * torch.sum(frac * probs.mean(dim=0)) / k


def _rank_moe(x, p: MoE, cfg: ArchConfig, spec: MoESpec, ctx):
    """``moe_ffn`` on a rank mesh: ``_local_moe``'s body with the seam's
    rank-mesh collectives. x is this data rank's block (or the whole batch
    where it did not divide, ``ctx.batch_split``). With the experts split
    over model (M > 1) this rank stores and runs experts
    ``[r*E/M, (r+1)*E/M)`` with the capacity of its own tokens: the tokens
    and gates enter its partial work (``tp_enter``) and a ``psum`` over
    model combines the ranks' outputs. Without, every expert runs here
    with the reference's GSPMD capacity over the global batch, this rank's
    ranks within an expert starting after the earlier data ranks' tokens
    (an ``all_gather`` of the per-expert counts over the data axes). The
    aux loss is the reference's over the global batch: ``pmean`` over the
    data axes of the routing fractions and the (differentiable) mean
    probabilities."""
    B, S, d = x.shape
    E, k = spec.num_experts, spec.top_k
    ep = ctx.model_size > 1 and model_split(p.experts, "w1")
    cast = torch.bfloat16 if ep and cfg.moe_gather_dtype == "bf16" else None
    w1, w3, w2 = (weight(p.experts, n, cast) for n in ("w1", "w3", "w2"))
    xf = x.reshape(-1, d)
    T = xf.shape[0]
    probs, gates, idx = _route(xf, weight(p, "router"), spec)
    dg = ctx.group("data")
    if ep:
        y = tp_merge(_dispatch(tp_enter(xf), tp_enter(gates), idx, w1, w3, w2,
                               e_local=w1.shape[0], rank=ctx.model_rank,
                               capacity=_capacity(T, spec)))
    else:
        n = ctx.data_size if ctx.batch_split else 1
        offset = None
        if n > 1:
            counts = D.all_gather(_expert_counts(idx, E)[None], group=dg)
            offset = counts[:ctx.data_rank].sum(dim=0)
        y = _dispatch(xf, gates, idx, w1, w3, w2, e_local=E, rank=0,
                      capacity=_capacity(T * n, spec), rank_offset=offset)
    aux = E * torch.sum(D.pmean(_frac(idx, E), group=dg)
                        * data_pmean(probs.mean(dim=0))) / k
    return y.reshape(B, S, d), aux


def moe_ffn(x: torch.Tensor, p: MoE, cfg: ArchConfig,
            spec: MoESpec) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux loss); the shared experts add on top."""
    ctx = current_ctx()
    if ctx is None:
        y, aux = _local_moe(x, p.router, p.experts.w1, p.experts.w3,
                            p.experts.w2, spec=spec, e_local=spec.num_experts,
                            rank=0, psum=_identity, pmean=_identity)
    elif ctx.ranked:
        y, aux = _rank_moe(x, p, cfg, spec, ctx)
    else:
        y, aux = _mesh_moe(x, p, cfg, spec, ctx)
    if getattr(p, "shared", None) is not None:
        y = y + mlp(x, p.shared)
    return y, aux
