"""Shared-nothing relational operators over a mesh of row shards (port of
``repro.engine.distributed``) — the ``shard_map`` execution mode.

Every operator does shard-local work sized rows/S over its shard's views,
then merges the partials with the smallest collective:

  operator          local work                merge collective
  ----------------- ------------------------- -------------------------------
  filter+count      masked popcount           psum (4 B)
  scalar agg        local min/max/sum         psum/pmax/pmin
  group-by agg      segment reduction (G)     psum/pmax/pmin (G × aggs)
  top-k             local top-k(k)            all_gather(k) + final top-k
  limit(n)          local compact(n)          all_gather(n) + recompact
  join count        local sort + probe        all_gather of build keys
                    (or the hash all-to-all repartition,
                    ``hash_repartition_counts``)
  index range count searchsorted per shard    psum

The engine's mesh is the one-process one: its shards all live on one
device (``launch/mesh.py``), so a table's column is one tensor and shard
``s`` is the view of rows ``[s * rps, (s + 1) * rps)`` — nothing is copied
to split it. The collectives below (``psum``, ``pmax``, ``pmin``,
``pmean``, ``all_gather``, ``all_to_all``) take one partial per shard, in
shard order, and return the merged value every shard would hold; work
that follows a collective and is the same on every shard runs once. On a
one-shard mesh every operator reduces to the local op. The kernel
compositions launch the relational kernels once per shard, each over its
own view.

The same collectives (and ``reduce_scatter``) have a rank form, the seam
to ``torch.distributed``: this rank's own part and the process group of
a ``RankMesh`` axis (``group=``). The model paths use it on a rank mesh
(``models/sharding.py``), and so does every operator below: on a
``RankMesh`` a table's column IS this rank's shard (``Table.shard`` keeps
only its rows), so an operator does its shard-local work once over the
whole tensor it holds and merges over the data axes' process group
(``Shards``). Every rank runs the same collectives in the same order
(they plan alike) and ends with the same merged value. Where the list
form adds float partials in shard order, the rank form gathers them and
adds them in rank order (``Shards.psum``), so a float result is the
same bit for bit on either mesh; integer sums are exact either way. (Over
a fed dataset's union stream the one-process mesh splits the concatenated
components evenly while a rank holds its rows of each component, so a
float sum of a generic group-by over base ∪ runs may differ there in its
last bits.)
Streams of unequal length across ranks (a block gather keeps each rank's
own surviving blocks) are padded with dead rows before a gather. A stream
over a fed dataset (base ∪ runs) holds, on a rank, its rows of each
component one after another; made whole (``gather_stream`` with the
components' lengths) it is component-major, each component in shard
order, as the one-process mesh and a meshless session concatenate it, and
a top-k or limit over it breaks ties by that order (``union_positions``).
``gather_to_host`` brings the rows a host mask keeps, from every rank, to
every rank's host in global row order, in chunks (a compaction's merge
input, a view's seed, the rows a tombstone retracts).

Each collective reports itself to the active cost counters
(``runtime/costs.py``, ``launch/hlocost.py``): its kind (the
reference's HLO name), the number of parts, and the bytes one device
reads and receives — one part for ``psum`` / ``pmax`` / ``pmin`` /
``pmean``, the concatenated result for ``all_gather``, one destination's
block for ``all_to_all``. The ops that merge the parts on the one device
are not counted as elementwise work.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.engine import physical
from repro_torch.engine.index import _search
from repro_torch.launch.mesh import is_rank_mesh
from repro_torch.runtime import costs


def n_shards(mesh, data_axes) -> int:
    """Row-partition count of ``mesh`` over ``data_axes``."""
    return int(np.prod([mesh.shape[a] for a in data_axes]))


def shard_views(x: torch.Tensor, nsh: int) -> list[torch.Tensor]:
    """Shard ``s``'s rows of ``x`` (split along dim 0 into ``nsh`` equal
    contiguous chunks) as views. A length that does not split evenly is
    first zero-padded (pad rows are dead: a zero mask is False)."""
    n = x.shape[0]
    pad = (-n) % nsh
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    rps = x.shape[0] // nsh
    return [x[s * rps:(s + 1) * rps] for s in range(nsh)]


# -- collectives ------------------------------------------------------------------
#
# Each collective has two forms. The list form (``group=None``) takes one
# partial per shard of the one-process mesh, in shard order, and merges
# them on the one device. The rank form takes this rank's own part and a
# ``torch.distributed`` process group (an axis of ``launch/mesh.RankMesh``)
# and runs the collective over it: ``all_reduce`` (SUM / MAX / MIN; pmean
# is a SUM, then a divide in the part's dtype, since gloo has no AVG),
# ``all_gather_into_tensor``, ``all_to_all_single``,
# ``reduce_scatter_tensor``. A float sum across ranks is in the backend's
# order (NCCL's rings and trees, gloo's), not shard order; integer sums
# are exact either way.


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collective(kind: str, parts: list, merge, received):
    """``merge()`` of ``parts``: one ``kind`` collective over
    ``len(parts)`` devices for the active cost counters, each reading its
    part and receiving ``received(result)`` bytes."""
    return costs.collective(kind, len(parts), _nbytes(parts[0]), merge, received)


def _ranked(kind: str, part: torch.Tensor, group, merge, received):
    """``merge()``, a collective over ``group``'s ranks, booked as the
    list form books it: ``group.size()`` parts, this rank's part read."""
    return costs.collective(kind, group.size(), _nbytes(part), merge, received)


def _dist():
    import torch.distributed as dist
    return dist


def _gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    # ``all_gather_single`` where the installed torch has it (the older
    # name warns there), ``all_gather_into_tensor`` before it
    dist = _dist()
    fn = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    fn(out, x, group=group)


def _scatter_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    dist = _dist()
    fn = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)
    fn(out, x, group=group)


def _all_reduce(part: torch.Tensor, group, op: str) -> torch.Tensor:
    dist = _dist()
    out = part.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=getattr(dist.ReduceOp, op), group=group)
    return out


def psum(parts, group=None) -> torch.Tensor:
    """Sum of the shards' partials, in shard order and in their dtype (the
    rank form: this rank's part summed over ``group``)."""
    if group is not None:
        return _ranked("all-reduce", parts, group,
                       lambda: _all_reduce(parts, group, "SUM"), _nbytes)
    return _collective("all-reduce", parts,
                       lambda: functools.reduce(torch.add, parts), _nbytes)


def pmax(parts, group=None) -> torch.Tensor:
    if group is not None:
        return _ranked("all-reduce", parts, group,
                       lambda: _all_reduce(parts, group, "MAX"), _nbytes)
    return _collective("all-reduce", parts,
                       lambda: functools.reduce(torch.maximum, parts), _nbytes)


def pmin(parts, group=None) -> torch.Tensor:
    if group is not None:
        return _ranked("all-reduce", parts, group,
                       lambda: _all_reduce(parts, group, "MIN"), _nbytes)
    return _collective("all-reduce", parts,
                       lambda: functools.reduce(torch.minimum, parts), _nbytes)


def pmean(parts, group=None) -> torch.Tensor:
    """``psum`` over the shard count (``jax.lax.pmean``)."""
    if group is not None:
        return _ranked("all-reduce", parts, group,
                       lambda: _all_reduce(parts, group, "SUM") / group.size(),
                       _nbytes)
    return _collective("all-reduce", parts,
                       lambda: functools.reduce(torch.add, parts) / len(parts),
                       _nbytes)


def all_gather(parts, group=None, dim: int = 0) -> torch.Tensor:
    """Tiled all-gather: the shards' blocks concatenated along ``dim`` in
    shard order."""
    if group is not None:
        def merge():
            x = parts.detach().movedim(dim, 0).contiguous()
            out = x.new_empty((group.size() * x.shape[0],) + tuple(x.shape[1:]))
            _gather_into(out, x, group)
            return out.movedim(0, dim)
        return _ranked("all-gather", parts, group, merge, _nbytes)
    return _collective("all-gather", parts, lambda: torch.cat(parts, dim=dim),
                       _nbytes)


def all_to_all(parts, group=None):
    """Tiled all-to-all over axis 0: shard ``s`` sends row ``d`` of its
    (S, ...) block to shard ``d``, which concatenates what it receives in
    source order. The list form returns every destination's result; the
    rank form this rank's."""
    if group is not None:
        def merge():
            out = torch.empty_like(parts, memory_format=torch.contiguous_format)
            _dist().all_to_all_single(out, parts.detach().contiguous(),
                                      group=group)
            return out.flatten(0, 1)
        return _ranked("all-to-all", parts, group, merge, _nbytes)
    return _collective(
        "all-to-all", parts,
        lambda: [torch.cat([p[d] for p in parts], dim=0)
                 for d in range(len(parts))],
        lambda out: _nbytes(out[0]))


def reduce_scatter(part: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Rank form only: the sum over ``group`` of the ranks' parts, split
    along ``dim`` into ``group.size()`` equal blocks, this rank's block
    (the transpose of ``all_gather``)."""
    def merge():
        x = part.detach().movedim(dim, 0).contiguous()
        out = x.new_empty((x.shape[0] // group.size(),) + tuple(x.shape[1:]))
        _scatter_into(out, x, group)
        return out.movedim(0, dim)
    return _ranked("reduce-scatter", part, group, merge, _nbytes)


_MERGE = {"sum": psum, "max": pmax, "min": pmin}


class Shards:
    """A mesh's row shards as the operators see them. On the one-process
    mesh: ``views`` splits each whole column into its shards' views, and
    the merges take one partial per shard (the list form). On a
    ``RankMesh``: ``views`` is this rank's own tensor, one part, and the
    merges run over the data axes' process group (the rank form); ``index``
    is this rank's shard number."""

    def __init__(self, mesh, data_axes):
        self.n = n_shards(mesh, data_axes)
        self.group = self.index = None
        if is_rank_mesh(mesh):
            axes = tuple(data_axes)
            self.group, self.index = mesh.group(axes), mesh.index(axes)

    def views(self, x: torch.Tensor) -> list[torch.Tensor]:
        return [x] if self.group is not None else shard_views(x, self.n)

    def merge(self, op: str, parts: list) -> torch.Tensor:
        """``op`` ("sum" / "max" / "min") over the partials. A float sum is
        added in shard order on either form."""
        if self.group is None:
            return _MERGE[op](parts)
        part = parts[0]
        if op == "sum" and part.dtype.is_floating_point:
            return _ordered_sum(part, self.group)
        return _MERGE[op](part, group=self.group)

    def psum(self, parts: list) -> torch.Tensor:
        return self.merge("sum", parts)

    def longest(self, x: torch.Tensor) -> int:
        """The most rows any shard's ``x`` has (its own length on the
        one-process mesh, where the views split evenly)."""
        if self.group is None:
            return x.shape[0]
        n = torch.tensor(x.shape[0], dtype=torch.int64, device=x.device)
        return int(pmax(n, group=self.group))

    def gather(self, parts: list, rows: Optional[int] = None,
               fill=0) -> torch.Tensor:
        """The shards' parts concatenated along dim 0 in shard order. In
        the rank form each part is first padded with ``fill`` to ``rows``
        rows (None: the longest part)."""
        if self.group is None:
            return all_gather(parts)
        x = parts[0]
        if rows is None:
            rows = self.longest(x)
        if x.shape[0] < rows:
            x = torch.cat([x, x.new_full((rows - x.shape[0],) + tuple(x.shape[1:]),
                                         fill)])
        if x.dtype == torch.bool:   # gloo and NCCL move bytes, not bools
            return all_gather(x.to(torch.uint8), group=self.group).bool()
        return all_gather(x, group=self.group)

    def gather_rows(self, tensors: list, rows: int,
                    dst: Optional[int] = None) -> Optional[list]:
        """Rank form only: each of ``tensors`` (this rank's rows, at most
        ``rows`` of them) zero-padded to ``rows`` rows and concatenated over
        the shards in shard order, in ONE all-gather: every tensor's rows
        are packed side by side as bytes, gathered, and cut back into
        their dtypes and shapes. A collective costs host time and, across
        processes, a round trip; a stream's columns move together. With
        ``dst`` (a global rank of the group) the rows are gathered to that
        rank alone and cut on its host; the others get None."""
        packed = []
        for t in tensors:
            t = t.contiguous()
            if t.shape[0] < rows:
                t = torch.cat([t, t.new_zeros((rows - t.shape[0],)
                                              + tuple(t.shape[1:]))])
            packed.append(t.view(torch.uint8).reshape(rows, -1))
        widths = [p.shape[1] for p in packed]
        if dst is None:
            every = all_gather(torch.cat(packed, dim=1), group=self.group)
        else:
            import torch.distributed as dist

            mine = torch.cat(packed, dim=1)
            got = [torch.empty_like(mine) for _ in range(self.n)] \
                if dist.get_rank() == dst else None
            dist.gather(mine, got, dst=dst, group=self.group)
            if got is None:
                return None
            every = torch.cat(got).cpu()
        out, at = [], 0
        for t, w in zip(tensors, widths):
            cut = every[:, at:at + w].contiguous().view(t.dtype)
            out.append(cut.reshape((every.shape[0],) + tuple(t.shape[1:])))
            at += w
        return out

    def all_to_all(self, parts: list) -> list:
        """Every destination's received rows on the one-process mesh; this
        rank's alone (a list of one) on a rank mesh."""
        if self.group is None:
            return all_to_all(parts)
        return [all_to_all(parts[0], group=self.group)]


def _ordered_sum(part: torch.Tensor, group) -> torch.Tensor:
    """The rank form of a float psum that adds in shard order: the parts
    gathered, then added one after another as the list form adds them (an
    all-reduce's own order is the backend's)."""
    def merge():
        x = part.detach().reshape((1,) + tuple(part.shape)).contiguous()
        out = x.new_empty((group.size(),) + tuple(part.shape))
        _gather_into(out, x, group)
        return functools.reduce(torch.add, out.unbind(0))
    return _ranked("all-reduce", part, group, merge, _nbytes)


# -- scalar aggregation -----------------------------------------------------------


def dist_count(mesh, data_axes, mask: torch.Tensor) -> torch.Tensor:
    sh = Shards(mesh, data_axes)
    return sh.psum([m.sum(dtype=torch.int32) for m in sh.views(mask)])


def dist_agg(mesh, data_axes, op: str, col: torch.Tensor, mask: torch.Tensor):
    sh = Shards(mesh, data_axes)
    cols, masks = sh.views(col), sh.views(mask)
    if op == "mean":
        s = sh.psum([torch.where(m, c, 0).to(torch.float32).sum()
                     for c, m in zip(cols, masks)])
        n = sh.psum([m.sum(dtype=torch.int32) for m in masks])
        return s / n.clamp(min=1)
    if op == "count":
        op = "sum"
        parts = [m.sum(dtype=torch.int32) for m in masks]
    else:
        parts = [physical.agg_scalar({"c": c}, m, op, "c")
                 for c, m in zip(cols, masks)]
    if op not in _MERGE:
        raise ValueError(op)
    return sh.merge(op, parts)


# -- group by ----------------------------------------------------------------------


def dist_group_agg(mesh, data_axes, key_col, mask, lo: int, num_groups: int,
                   aggs, value_cols: dict):
    """Bounded-domain group-by: local segment reduction, psum/pmax/pmin
    merge. ``aggs``: [(out_name, op, col|None)]; ``value_cols``: {col:
    tensor}. ``mean`` decomposes into psum(sum) / psum(count). Returns the
    merged (G-row) group table and its live-group mask."""
    sh = Shards(mesh, data_axes)
    names = sorted(value_cols)
    prim: list[tuple[str, str, Optional[str]]] = [("__n__", "count", None)]
    for o, op, c in aggs:
        if op == "mean":
            prim.append((f"__sum_{o}", "sum", c))
        else:
            prim.append((o, op, c))
    keys, masks = sh.views(key_col), sh.views(mask)
    vals = {n: sh.views(value_cols[n]) for n in names}
    outs = []
    for s in range(len(keys)):
        env = {"__key__": keys[s], **{n: vals[n][s] for n in names}}
        out, _ = physical.group_agg(env, masks[s], "__key__", lo, num_groups,
                                    prim)
        outs.append(out)
    merged = {o: sh.merge("sum" if op == "count" else op, [d[o] for d in outs])
              for o, op, _ in prim}
    out = {"__key__": outs[0]["__key__"]}
    for o, op, c in aggs:
        if op == "mean":
            out[o] = merged[f"__sum_{o}"] / merged["__n__"].clamp(min=1)
        else:
            out[o] = merged[o]
    return out, merged["__n__"] > 0


# -- top-k / limit -----------------------------------------------------------------


def _shard_env(sh: Shards, env: dict, mask):
    names = sorted(env)
    cols = {n: sh.views(env[n]) for n in names}
    masks = sh.views(mask)
    return [({n: cols[n][s] for n in names}, masks[s])
            for s in range(len(masks))]


def _gather_env(sh: Shards, parts: list,
                rows: Optional[int] = None) -> tuple[dict, torch.Tensor]:
    """The shards' (env, mask) parts concatenated in shard order; in the
    rank form each padded to ``rows`` rows with dead ones (None: the
    longest)."""
    names = list(parts[0][0])
    if sh.group is None:
        return ({n: sh.gather([e[n] for e, _ in parts]) for n in names},
                sh.gather([m for _, m in parts]))
    env, mask = parts[0]
    if rows is None:
        rows = sh.longest(mask)
    *cols, mask = sh.gather_rows([env[n] for n in names] + [mask], rows)
    return dict(zip(names, cols)), mask


def _union_lengths(sh: Shards, lens: list, device) -> np.ndarray:
    """Every rank's lengths of its union stream's segments, (S, C) on the
    host (one small all-gather; the same on every rank)."""
    mine = torch.tensor(lens, dtype=torch.int64, device=device)
    return sh.gather([mine]).cpu().numpy().reshape(sh.n, len(lens))


def union_positions(mesh, data_axes, lens: list, device) -> torch.Tensor:
    """Rank form only: each row of this rank's union stream (its ``lens[c]``
    rows of component c, one component after another) as its position in
    the whole, component-major stream (component c's rows of every shard,
    in shard order, after those of every earlier component)."""
    sh = Shards(mesh, data_axes)
    every = _union_lengths(sh, lens, device)
    base = np.concatenate([[0], np.cumsum(every.sum(axis=0))])[:-1]
    before = every[:sh.index].sum(axis=0)
    pos = [np.arange(n, dtype=np.int64) + int(base[c] + before[c])
           for c, n in enumerate(lens)]
    return torch.from_numpy(np.concatenate(pos)).to(device)


def gather_stream(mesh, data_axes, env: dict, mask,
                  segments: Optional[list] = None) -> tuple[dict, torch.Tensor]:
    """A row-sharded stream made whole on every rank (shard order is row
    order; the pad rows between shards are dead): what a rank mesh does
    before an operator that has no shard-local form (a full sort, a
    window, a materialized join) and at result delivery. The identity on
    the one-process mesh, whose columns are whole. ``segments`` (a union
    stream): this rank's row count of each component, in order; the
    gathered rows are then put in component-major order."""
    sh = Shards(mesh, data_axes)
    if sh.group is None:
        return env, mask
    if not segments or len(segments) < 2:
        return _gather_env(sh, [(env, mask)])
    every = _union_lengths(sh, segments, mask.device)
    rows = int(every.sum(axis=1).max())
    names = list(env)
    *cols, gm = sh.gather_rows([env[n] for n in names] + [mask], rows)
    starts = np.cumsum(every, axis=1) - every          # within each rank
    order = np.concatenate([np.arange(n) + r * rows + starts[r, c]
                            for c in range(every.shape[1])
                            for r, n in enumerate(every[:, c])])
    idx = torch.from_numpy(order.astype(np.int64)).to(mask.device)
    return {n: c[idx] for n, c in zip(names, cols)}, gm[idx]


_POS = "__upos__"


def _in_order(env: dict, mask) -> tuple[dict, torch.Tensor]:
    """Gathered candidates put back in stream order (``_POS``, live rows
    first) and the position column dropped."""
    big = torch.iinfo(torch.int64).max
    order = torch.argsort(torch.where(mask, env[_POS], big), stable=True)
    return ({n: v[order] for n, v in env.items() if n != _POS}, mask[order])


def dist_topk(mesh, data_axes, env: dict, mask, key: str, k: int,
              ascending: bool, select=physical._select_topk,
              positions: Optional[torch.Tensor] = None):
    """Local top-k, a k-per-shard gather, then the final top-k. ``select``
    swaps the selection primitive (kernel mode passes block_topk); the
    merge is the same. The gathered candidates are shard-major and shards
    are contiguous in row order, so ties still go to the lower row. A rank
    pads its candidates to k rows (dead ones), so that every rank sends as
    many. ``positions`` (a rank's union stream, ``union_positions``): the
    candidates are put in whole-stream order before the final top-k, so
    that ties go to the lower row of the whole stream."""
    sh = Shards(mesh, data_axes)
    if positions is not None:
        env = dict(env, **{_POS: positions})
    local = [physical.topk(e, m, key, min(k, m.shape[0]), ascending,
                           select=select)
             for e, m in _shard_env(sh, env, mask)]
    ge, gm = _gather_env(sh, local, k)
    if positions is not None:
        ge, gm = _in_order(ge, gm)
    return physical.topk(ge, gm, key, k, ascending, select=select)


def dist_limit(mesh, data_axes, env: dict, mask, n: int,
               positions: Optional[torch.Tensor] = None):
    """Local compact(n), gather, then the first n (shard-major order; with
    ``positions``, whole-stream order, as :func:`dist_topk`)."""
    sh = Shards(mesh, data_axes)
    if positions is not None:
        env = dict(env, **{_POS: positions})
    local = [physical.limit(e, m, n) for e, m in _shard_env(sh, env, mask)]
    ge, gm = _gather_env(sh, local, n)
    if positions is not None:
        ge, gm = _in_order(ge, gm)
    return physical.limit(ge, gm, n)


# -- rows to the host -----------------------------------------------------------------

GATHER_CHUNK_ROWS = 1 << 18   # rows a rank sends per collective of gather_to_host


def gather_to_host(mesh, data_axes, columns: list, keep: np.ndarray,
                   chunk_rows: int = GATHER_CHUNK_ROWS,
                   dst: Optional[int] = None) -> Optional[list]:
    """Rank form only: the rows of ``columns`` (this rank's shard of a
    component) that the host mask ``keep`` selects, from every rank, as
    numpy arrays on every rank's HOST, in global row order (rank order,
    each rank's rows in order). The counts per rank are exchanged first
    (one small all-gather: a shard of pads only or of tombstones only
    sends nothing); then the rows move in chunks of at most ``chunk_rows``
    a rank, each chunk ONE packed all-gather (every column's rows side by
    side as bytes, ``Shards.gather_rows``) copied to the host before the
    next: no more than S x ``chunk_rows`` of the rows sit on a device at
    once, never the whole component. With ``dst`` (a global rank of the
    data axes' group: a durable segment's writer) each chunk is gathered
    to that rank alone (``Shards.gather_rows``); the others send their
    rows and get None."""
    sh = Shards(mesh, data_axes)
    assert sh.group is not None, "gather_to_host is the rank form"
    dev = columns[0].device
    idx = np.flatnonzero(keep)
    counts = sh.gather([torch.tensor([idx.size], dtype=torch.int64,
                                     device=dev)]).cpu().numpy()
    starts = np.concatenate([[0], np.cumsum(counts)])
    out = [np.empty((int(starts[-1]),) + tuple(c.shape[1:]),
                    dtype=torch.empty((), dtype=c.dtype).numpy().dtype)
           for c in columns] if dst in (None, mesh.rank) else None
    at = 0
    while at < counts.max():
        rows = int(min(chunk_rows, counts.max() - at))
        mine = torch.from_numpy(idx[at:at + rows]).to(dev)
        every = sh.gather_rows([c[mine] for c in columns], rows, dst)
        for to, got in zip(out or (), every or ()):
            got = got.cpu().numpy()
            for r in range(sh.n):
                take = int(min(max(counts[r] - at, 0), rows))
                if take:
                    to[starts[r] + at:starts[r] + at + take] = \
                        got[r * rows:r * rows + take]
        at += rows
    return out


# -- joins -------------------------------------------------------------------------


def dist_join_count(mesh, data_axes, lkey, lmask, rkey, rmask,
                    presorted_right: bool = False) -> torch.Tensor:
    """Broadcast-merge join count: each shard sorts its build keys (a
    sorted index skips that), the sorted runs are gathered and merged, each
    shard probes its own rows with two binary searches, psum. int32, as
    the reference's x64-off result."""
    sh = Shards(mesh, data_axes)
    sentinel = physical._maxval(rkey.dtype)
    rks, rms = sh.views(rkey), sh.views(rmask)
    runs = [rk if presorted_right
            else torch.sort(torch.where(rm, rk, sentinel)).values
            for rk, rm in zip(rks, rms)]
    # merge the gathered runs (a rank's run is padded with the sentinel)
    rs_g = torch.sort(sh.gather(runs, fill=sentinel)).values
    n_r = sh.psum([rm.sum() for rm in rms])
    parts = []
    for lk, lm in zip(sh.views(lkey), sh.views(lmask)):
        lo = _search(rs_g, lk, "left")
        hi = torch.minimum(_search(rs_g, lk, "right"), n_r)
        parts.append(torch.where(lm, (hi - lo).clamp(min=0), 0)
                     .sum(dtype=torch.int32))
    return sh.psum(parts)


def hash_repartition_counts(mesh, data_axes, lkey, lmask, rkey, rmask,
                            capacity_factor: float = 2.0):
    """Hybrid-hash analogue: an all-to-all repartitions both sides by key
    hash so matching keys meet on one shard, then a local sort-merge count
    and a psum. Each (source, destination) bucket holds a fixed capacity;
    what does not fit is dropped and counted. Returns (total, drops), int32
    tensors. ``capacity_factor=2`` drops nothing for uniform keys."""
    sh = Shards(mesh, data_axes)
    nsh = sh.n

    def repartition(k, m):
        n = k.shape[0]
        dev = k.device
        cap = int(np.ceil(n / nsh * capacity_factor))
        # the reference hashes k.astype(uint32) % S: torch's uint32
        # arithmetic is partial, so take the low 32 bits in int64
        dest = ((k.to(torch.int64) & 0xFFFFFFFF) % nsh).to(torch.int32)
        dest = torch.where(m, dest, nsh)            # dead rows: overflow bucket
        order = torch.argsort(dest, stable=True)
        ds, ks = dest[order], k[order]
        starts = torch.searchsorted(
            ds, torch.arange(nsh + 1, dtype=torch.int32, device=dev),
            side="left")
        rank = torch.arange(n, device=dev) - starts[ds.clamp(0, nsh).long()]
        keep = (ds < nsh) & (rank < cap)
        slot = ds.clamp(0, nsh - 1).long() * cap + rank.clamp(max=cap - 1)
        slot = torch.where(keep, slot, nsh * cap)   # trash slot for drops
        buf = torch.zeros(nsh * cap + 1, dtype=k.dtype, device=dev)
        buf[slot] = ks
        bm = torch.zeros(nsh * cap + 1, dtype=torch.uint8, device=dev)
        bm[slot] = keep.to(torch.uint8)
        dropped = m.sum(dtype=torch.int32) - keep.sum(dtype=torch.int32)
        return buf[:-1].view(nsh, cap), bm[:-1].view(nsh, cap), dropped

    left = [repartition(k, m) for k, m in zip(sh.views(lkey), sh.views(lmask))]
    right = [repartition(k, m) for k, m in zip(sh.views(rkey), sh.views(rmask))]
    # all_to_all: row d of every source's block goes to shard d
    lbuf, lbm = (sh.all_to_all([b for b, _, _ in left]),
                 sh.all_to_all([b for _, b, _ in left]))
    rbuf, rbm = (sh.all_to_all([b for b, _, _ in right]),
                 sh.all_to_all([b for _, b, _ in right]))
    counts = [physical.join_count(lbuf[s], lbm[s].bool(), rbuf[s],
                                  rbm[s].bool()).to(torch.int32)
              for s in range(len(lbuf))]
    drops = [lf[2] + rt[2] for lf, rt in zip(left, right)]
    return sh.psum(counts), sh.psum(drops)


# -- kernel-mode compositions -------------------------------------------------------
#
# The kernel execution mode runs the relational kernels shard by shard and
# merges partials with the same collectives as the operators above:
# filter-count / group-agg psum their partials, join-count gathers the
# sorted build side. Kernel top-k is dist_topk with the block_topk
# selection primitive. On a rank mesh each rank launches each kernel once,
# over its own shard.


class ShardBlocks:
    """A per-shard kernel-block matrix (``ops.shard_block_arrays``: row
    ``s`` is shard ``s``'s local kernel-block ids, ``-1``-padded at the
    end), kept on the host for the block accounting and placed on each
    device once — row ``s`` is then a view that shard ``s``'s launch takes
    as its ``block_ids_arr`` (on a rank mesh, the row of this rank's
    shard)."""

    def __init__(self, host: np.ndarray):
        self.host = np.asarray(host, np.int32)
        self.scanned = int((self.host >= 0).sum())
        self._placed: dict = {}

    def on(self, device) -> torch.Tensor:
        t = self._placed.get(device)
        if t is None:
            t = self._placed[device] = torch.from_numpy(self.host).to(device)
        return t

    def rows(self, sh: Shards, device) -> torch.Tensor:
        """The rows of the shards this process launches for, in order."""
        ids = self.on(device)
        return ids if sh.group is None else ids[sh.index:sh.index + 1]


def _check_blocks(nsh: int, block_ids, shard_blocks):
    if block_ids is not None:
        assert nsh == 1, "global block_ids require a single-shard mesh " \
                         "(use shard_blocks on multi-shard meshes)"
    if shard_blocks is None:
        return None
    assert block_ids is None
    sb = shard_blocks if isinstance(shard_blocks, ShardBlocks) \
        else ShardBlocks(shard_blocks)
    assert sb.host.shape[0] == nsh, (sb.host.shape, nsh)
    return sb


def _count_blocks(kernel: str, sb: ShardBlocks, nsh: int, rows: int,
                  block: int) -> None:
    """The true scanned / skipped block accounting over every shard (the
    same totals on every rank), kept here where the ``-1`` pads are
    visible (each shard's grid length over-counts by its padding).
    ``rows``: one shard's rows."""
    from repro_torch.runtime import telemetry as tel

    nb_local = -(-rows // block)
    tel.inc("kernel.blocks_scanned_total", sb.scanned, kernel=kernel)
    tel.inc("kernel.blocks_skipped_total", nsh * nb_local - sb.scanned,
            kernel=kernel)


def dist_kernel_filter_count(mesh, data_axes, cols, bounds: torch.Tensor,
                             block_ids=None, shard_blocks=None) -> torch.Tensor:
    """``cols``: the k predicate columns ((n,) int32 each, or a (k, n)
    matrix), row-sharded; ``bounds``: (k, 2) replicated. Each shard runs
    filter_count over its own views (pad rows arrive folded into the
    matter column with bounds (1, 1)); the merge is one psum.

    ``block_ids`` are surviving zone blocks over the GLOBAL layout (one
    shard only, where local == global). ``shard_blocks`` is the
    multi-shard form (a ``ShardBlocks`` or its host matrix): shard ``s``
    scans only the blocks of row ``s``, whose ``-1`` pads it skips."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.filter_count import BLOCK as _FC_BLOCK

    sh = Shards(mesh, data_axes)
    sb = _check_blocks(sh.n, block_ids, shard_blocks)
    cols = list(cols)
    per_col = [sh.views(c) for c in cols]
    ids = None
    if sb is not None:
        _count_blocks("filter_count", sb, sh.n, per_col[0][0].shape[0],
                      _FC_BLOCK)
        ids = sb.rows(sh, cols[0].device)
    parts = []
    for s in range(len(per_col[0])):
        local = [v[s] for v in per_col]
        rows = local[0].shape[0]
        if ids is not None:
            parts.append(ops.filter_count(local, bounds, rows,
                                          block_ids_arr=ids[s]))
        else:
            parts.append(ops.filter_count(local, bounds, rows,
                                          block_ids=block_ids))
    return sh.psum(parts)


def dist_kernel_group_agg(mesh, data_axes, gids: torch.Tensor,
                          values: torch.Tensor, num_groups: int,
                          op: str = "sum", block_ids=None,
                          shard_blocks=None) -> torch.Tensor:
    """gids: (n,) int32 (-1 for dead rows); values: (n, C) f32. One
    segment_agg launch per shard over its views, merged with psum for sums
    and pmax / pmin for extremes -> (G, C). ``block_ids`` /
    ``shard_blocks`` as in :func:`dist_kernel_filter_count` (shard_blocks
    ids in segment_agg's OWN block units)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.segment_agg import BLOCK as _SA_BLOCK

    sh = Shards(mesh, data_axes)
    sb = _check_blocks(sh.n, block_ids, shard_blocks)
    gv, vv = sh.views(gids), sh.views(values)
    ids = None
    if sb is not None:
        _count_blocks("segment_agg", sb, sh.n, gv[0].shape[0], _SA_BLOCK)
        ids = sb.rows(sh, gids.device)
    parts = []
    for s, (g, v) in enumerate(zip(gv, vv)):
        if ids is not None:
            parts.append(ops.segment_agg(v, g, num_groups, v.shape[0], op=op,
                                         block_ids_arr=ids[s]))
        else:
            parts.append(ops.segment_agg(v, g, num_groups, v.shape[0], op=op,
                                         block_ids=block_ids))
    return sh.merge(op, parts)


def dist_kernel_join_count(mesh, data_axes, lkey, lmask, rkey, rmask,
                           presorted_right: bool = False) -> torch.Tensor:
    """Broadcast-merge join count on merge_join_count: each shard sorts its
    probe rows, the build side's sorted runs are gathered and merged (a
    sorted index skips the local sort), one merge-join launch per shard,
    psum."""
    from repro_torch.kernels import ops

    sh = Shards(mesh, data_axes)
    rms = sh.views(rmask)
    runs = [ops.sort_join_keys(rk, rm, presorted=presorted_right)
            for rk, rm in zip(sh.views(rkey), rms)]
    rs = torch.sort(sh.gather(runs, fill=ops.INT32_MAX)).values
    nr = sh.psum([rm.sum(dtype=torch.int32) for rm in rms])
    parts = []
    for lk, lm in zip(sh.views(lkey), sh.views(lmask)):
        ls = ops.sort_join_keys(lk, lm)
        nl = lm.sum(dtype=torch.int32)
        parts.append(ops.merge_join_count(ls, rs, nl, nr).to(torch.int32))
    return sh.psum(parts)


# -- index -------------------------------------------------------------------------


def dist_index_count(mesh, data_axes, sorted_keys, valid, lo, hi):
    """Index-only range count: per-shard binary searches + psum. ``valid``
    is the base table's validity column (a shard's local popcount is its
    ``num_valid``: pad rows sort to the +inf tail of each shard's index)."""
    from repro_torch.engine.index import index_count_local

    sh = Shards(mesh, data_axes)
    return sh.psum([index_count_local(sk, v.sum(dtype=torch.int32), lo, hi)
                    .to(torch.int32)
                    for sk, v in zip(sh.views(sorted_keys), sh.views(valid))])


def dist_shadow_count(mesh, data_axes, sorted_keys, valid, anti_keys, lo, hi):
    """Anti-matter subtrahend of the index-only count: the replicated,
    deduplicated tombstone keys probe each shard's sorted primary index;
    the per-shard occurrence counts psum."""
    from repro_torch.engine.index import shadow_count_local

    sh = Shards(mesh, data_axes)
    return sh.psum([shadow_count_local(sk, v.sum(dtype=torch.int32), anti_keys,
                                       lo, hi).to(torch.int32)
                    for sk, v in zip(sh.views(sorted_keys), sh.views(valid))])
