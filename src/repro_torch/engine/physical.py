"""Generic physical operators over torch tensors (port of
``repro.engine.physical``).

Every streaming operator maps ``(env, mask) -> (env, mask)``: ``env`` is a
dict of equal-length columns and ``mask`` marks live rows (selection-vector
execution — filters never compact; compaction happens only at LIMIT / TopK /
result delivery). Results keep the reference's x64-off dtypes: counts are
int32, and integer reductions accumulate in the column's own dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

Env = dict[str, torch.Tensor]


def _minval(dtype: torch.dtype):
    return torch.finfo(dtype).min if dtype.is_floating_point else torch.iinfo(dtype).min


def _maxval(dtype: torch.dtype):
    return torch.finfo(dtype).max if dtype.is_floating_point else torch.iinfo(dtype).max


# -- streaming ops ------------------------------------------------------------


def limit(env: Env, mask: torch.Tensor, n: int) -> tuple[Env, torch.Tensor]:
    """Compact the first ``n`` live rows into a length-``n`` table. Row j
    comes from the first index whose running live count reaches j + 1;
    missing rows point at the last row, as ``jnp.nonzero(size=n,
    fill_value=len - 1)`` does — with no host sync."""
    pos = torch.cumsum(mask, dim=0)
    want = torch.arange(1, n + 1, device=mask.device, dtype=pos.dtype)
    idx = torch.searchsorted(pos, want).clamp(max=mask.shape[0] - 1)
    found = torch.clamp(pos[-1], max=n)
    out = {k: v[idx] for k, v in env.items()}
    return out, torch.arange(n, device=mask.device) < found


def _select_topk(score: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """Default selection primitive: indices of the k largest masked scores,
    lowest index first among ties (a stable descending sort)."""
    s = torch.where(mask, score, float("-inf"))
    return torch.sort(s, descending=True, stable=True).indices[:k]


def kernel_topk_select():
    """Selection primitive backed by the block_topk kernel — same contract
    as :func:`_select_topk`."""
    def select(score, mask, k):
        from repro_torch.kernels import ops

        _, idx = ops.topk(score, mask, mask.shape[0], k)
        return idx.to(torch.int64)
    return select


def topk(env: Env, mask: torch.Tensor, key: str, k: int, ascending: bool,
         select=_select_topk) -> tuple[Env, torch.Tensor]:
    """Score prep (f32 cast, ascending negation), selection via ``select``,
    then gather — the single home of the top-k contract; the kernel mode
    only swaps the selection primitive."""
    col = env[key]
    score = col if col.dtype.is_floating_point else col.to(torch.float32)
    if ascending:
        score = -score
    idx = select(score, mask, k)
    found = torch.clamp(mask.sum(), max=k)
    out = {kk: v[idx] for kk, v in env.items()}
    return out, torch.arange(k, device=mask.device) < found


def sort_full(env: Env, mask: torch.Tensor, key: str,
              ascending: bool) -> tuple[Env, torch.Tensor]:
    """One stable argsort on the sentineled key, either direction (equal
    keys keep their original order)."""
    col = env[key]
    sk = torch.where(mask, col, _maxval(col.dtype) if ascending else _minval(col.dtype))
    order = torch.argsort(sk, stable=True, descending=not ascending)
    out = {k: v[order] for k, v in env.items()}
    return out, mask[order]


# -- terminal aggregates ------------------------------------------------------


def agg_scalar(env: Env, mask: torch.Tensor, op: str,
               column: Optional[str]) -> torch.Tensor:
    if op == "count":
        return mask.sum(dtype=torch.int32)
    col = env[column]
    if op == "max":
        return torch.where(mask, col, _minval(col.dtype)).max()
    if op == "min":
        return torch.where(mask, col, _maxval(col.dtype)).min()
    if op == "sum":
        return torch.where(mask, col, 0).sum(dtype=col.dtype)
    if op == "mean":
        s = torch.where(mask, col, 0).to(torch.float32).sum()
        return s / mask.sum(dtype=torch.int32).clamp(min=1)
    raise ValueError(op)


def group_agg(env: Env, mask: torch.Tensor, key: str, lo: int, num_groups: int,
              aggs: list[tuple[str, str, Optional[str]]]) -> tuple[Env, torch.Tensor]:
    """Bounded-domain group-by: group id = key - lo, dead rows dumped in an
    overflow bucket; each aggregate is one segment reduction."""
    key_col = env[key]
    gid = torch.where(mask, (key_col - lo).to(torch.int64), num_groups)
    out: Env = {key: torch.arange(lo, lo + num_groups, dtype=key_col.dtype,
                                  device=key_col.device)}
    counts = torch.zeros(num_groups + 1, dtype=torch.int32, device=mask.device) \
        .index_add_(0, gid, mask.to(torch.int32))[:num_groups]
    for out_name, op, column in aggs:
        if op == "count":
            out[out_name] = counts
            continue
        col = env[column]
        if op in ("sum", "mean"):
            s = torch.zeros(num_groups + 1, dtype=col.dtype, device=col.device) \
                .index_add_(0, gid, torch.where(mask, col, 0))[:num_groups]
            out[out_name] = (s / counts.clamp(min=1)) if op == "mean" else s
        elif op in ("max", "min"):
            fill = _minval(col.dtype) if op == "max" else _maxval(col.dtype)
            init = float("-inf") if op == "max" else float("inf")
            if not col.dtype.is_floating_point:
                init = fill
            out[out_name] = torch.full((num_groups + 1,), init, dtype=col.dtype,
                                       device=col.device).scatter_reduce_(
                0, gid, torch.where(mask, col, fill),
                "amax" if op == "max" else "amin")[:num_groups]
        else:
            raise ValueError(op)
    return out, counts > 0


# -- joins ---------------------------------------------------------------------


def join_count(lkey: torch.Tensor, lmask: torch.Tensor, rkey: torch.Tensor,
               rmask: torch.Tensor) -> torch.Tensor:
    """Exact inner-equi-join cardinality via sort + binary search: each
    probe row finds its match run with two ``searchsorted`` calls. Correct
    for any duplicates on both sides."""
    rs = torch.sort(torch.where(rmask, rkey, _maxval(rkey.dtype))).values
    n_r = rmask.sum()
    lkey = lkey.to(rs.dtype)
    lo = torch.searchsorted(rs, lkey, side="left")
    hi = torch.minimum(torch.searchsorted(rs, lkey, side="right"), n_r)
    return torch.where(lmask, (hi - lo).clamp(min=0), 0).sum(dtype=torch.int32)


def join_materialize(lenv: Env, lmask: torch.Tensor, renv: Env,
                     rmask: torch.Tensor, left_on: str, right_on: str,
                     suffix: str = "_r") -> tuple[Env, torch.Tensor]:
    """Left-probe inner join with unique build keys: each live left row
    gathers its single match; mask = matched & live."""
    rkey = renv[right_on]
    skey = torch.where(rmask, rkey, _maxval(rkey.dtype))
    order = torch.argsort(skey)
    rs = skey[order]
    lkey = lenv[left_on].to(rs.dtype)
    pos = torch.searchsorted(rs, lkey, side="left").clamp(max=rs.shape[0] - 1)
    matched = (rs[pos] == lkey) & lmask
    src = order[pos]
    out = dict(lenv)
    for k, v in renv.items():
        out[k if k not in lenv else k + suffix] = v[src]
    return out, matched


# -- index access ---------------------------------------------------------------


def index_range_mask(keys: torch.Tensor, valid: torch.Tensor,
                     lo: Optional[torch.Tensor],
                     hi: Optional[torch.Tensor]) -> torch.Tensor:
    """The IndexProbe stream mask: live rows whose indexed key lies in
    [lo, hi] (an open side is None)."""
    m = valid
    if lo is not None:
        m = m & (keys >= lo)
    if hi is not None:
        m = m & (keys <= hi)
    return m
