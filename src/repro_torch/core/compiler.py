"""Physical-plan compiler: costed physical plan → one callable over torch
tensors (port of ``repro.core.compiler``).

The reference wraps the lowered function in ``jax.jit``; PyTorch runs
eagerly, so ``compile_physical`` builds a closure ``fn(tables, params)``
once per physical fingerprint and the session caches it. Literal values are
runtime params (tensors on the session device), so randomized predicates
reuse the compiled query — the prepared-statement effect.

The execution modes are lowering strategies, not branches inside operator
lowerings:

  * ``gspmd``     — :class:`LoweringStrategy`: plain torch ops over the
    whole (possibly row-sharded) columns;
  * ``shard_map`` — :class:`ShardMapStrategy`: the relational operators of
    ``engine/distributed.py``, shard-local work merged by explicit
    collectives over the session mesh's row shards;
  * ``kernel``    — either strategy (``ShardMapStrategy`` on a mesh); what
    differs is the physical operators the planner emitted
    (``KernelRangeCount``, ``KernelSegmentAgg``, kernel ``JoinCountOp``,
    kernel ``TopKSelect``), whose lowerings call
    ``repro_torch.kernels.ops`` — locally or once per shard. Those ops
    launch the hand-written CUDA kernels on CUDA tensors and their plain
    versions on CPU tensors.

On a mesh of ``torch.distributed`` ranks (``launch.mesh.RankMesh``) every
mode lowers onto :class:`ShardMapStrategy`: a rank holds only its row
shard, so even ``gspmd`` (which torch has no compiler for) runs the same
explicit collectives. A stream is then either this rank's shard (a scan
and the filters and projections over it) or whole and the same on every
rank (what a merge returned: a limit, a top-k, a group-by); operators over
a whole stream run locally (:func:`_strategy`), and a sharded stream is
gathered before an operator that has no shard-local form (a full sort, a
window, a materialized join) and before delivery (:func:`_whole`).

Over a fed dataset every component lowers on its own (per-component index
probes, kernel launches, visibility masks) and the results merge: scalars
with +/max/min (``MergeScalars``), streams by concatenation
(``PrunedUnionRuns``), group-by partials by +/max/min. Newer components'
anti-matter subtracts from every matter stream through ``_shadowed``. On
a rank mesh a union stream holds this rank's rows of each component, one
component after another; made whole it is put back in component order,
and a top-k or limit over it breaks ties by the whole stream's order
(``_whole``, ``_positions``).
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import physical as PH
from repro_torch.core.catalog import INTERNAL_COLUMNS, Catalog
from repro_torch.core.expr import collect_params, param_values
from repro_torch.core.stats import mesh_shards
from repro_torch.core.window import execute_window
from repro_torch.engine import physical
from repro_torch.engine.distributed import ShardBlocks
from repro_torch.engine.index import _search
from repro_torch.engine.table import encode_strings, is_lane_column
from repro_torch.launch.mesh import is_rank_mesh
from repro_torch.runtime import telemetry as tel


# -- lowering strategy --------------------------------------------------------


class LoweringStrategy:
    """Single-program lowering: plain torch ops over the whole columns, or
    the relational kernels for the kernel physical operators.

    ``mesh`` is the session mesh when its tables are split over more than
    one shard: their sorted indexes are then sorted per shard (pad rows at
    each shard's +inf tail), so the index probes search shard by shard."""

    def __init__(self, mesh=None, data_axes=("data",)):
        self.mesh, self.data_axes = mesh, data_axes

    def count(self, mask):
        return mask.sum(dtype=torch.int32)

    def agg(self, env, mask, op, column):
        return physical.agg_scalar(env, mask, op, column)

    def limit(self, env, mask, n, positions=None):
        return physical.limit(env, mask, n)

    def topk(self, env, mask, key, k, ascending, select, positions=None):
        return physical.topk(env, mask, key, k, ascending, select=select)

    def group_agg(self, env, mask, key, lo, num_groups, aggs):
        return physical.group_agg(env, mask, key, lo, num_groups, aggs)

    def kernel_group_agg(self, gid, values, num_groups, n, op,
                         block_ids: Optional[tuple] = None,
                         shard_blocks=None):
        from repro_torch.kernels import ops
        assert shard_blocks is None, \
            "per-shard grids need the shard_map strategy"
        return ops.segment_agg(values, gid, num_groups, n, op=op,
                               block_ids=block_ids)

    def kernel_filter_count(self, cols, bounds,
                            block_ids: Optional[tuple] = None,
                            shard_blocks=None):
        from repro_torch.kernels import ops
        assert shard_blocks is None, \
            "per-shard grids need the shard_map strategy"
        return ops.filter_count(cols, bounds, cols[0].shape[0],
                                block_ids=block_ids)

    def index_count(self, ix_keys, valid, lo, hi):
        if self.mesh is not None:
            from repro_torch.engine import distributed as D
            return D.dist_index_count(self.mesh, self.data_axes, ix_keys,
                                      valid, lo, hi)
        from repro_torch.engine.index import index_count_local
        return index_count_local(ix_keys, valid.sum(dtype=torch.int32), lo, hi)

    def shadow_count(self, ix_keys, valid, anti_keys, lo, hi):
        if self.mesh is not None:
            from repro_torch.engine import distributed as D
            return D.dist_shadow_count(self.mesh, self.data_axes, ix_keys,
                                       valid, anti_keys, lo, hi)
        from repro_torch.engine.index import shadow_count_local
        return shadow_count_local(ix_keys, valid.sum(dtype=torch.int32),
                                  anti_keys, lo, hi)

    def join_count(self, lkey, lmask, rkey, rmask, presorted):
        if presorted and self.mesh is not None:
            from repro_torch.engine import distributed as D
            return D.dist_join_count(self.mesh, self.data_axes, lkey, lmask,
                                     rkey, rmask, presorted_right=True)
        if presorted:
            # index order: valid keys ascending, sentinel tail
            n_r = rmask.sum(dtype=torch.int32)
            lo = _search(rkey, lkey, "left")
            hi = torch.minimum(_search(rkey, lkey, "right"), n_r)
            return torch.where(lmask, (hi - lo).clamp(min=0), 0) \
                .sum(dtype=torch.int32)
        return physical.join_count(lkey, lmask, rkey, rmask)

    def kernel_join_count(self, lkey, lmask, rkey, rmask, presorted):
        from repro_torch.kernels import ops
        ls = ops.sort_join_keys(lkey, lmask)
        rs = ops.sort_join_keys(rkey, rmask, presorted=presorted)
        nl = lmask.sum(dtype=torch.int32)
        nr = rmask.sum(dtype=torch.int32)
        return ops.merge_join_count(ls, rs, nl, nr)


class ShardMapStrategy(LoweringStrategy):
    """Explicit collectives: each relational primitive runs shard by shard
    over the mesh's row shards and merges with a psum / pmax / pmin /
    gather (engine/distributed.py)."""

    def count(self, mask):
        from repro_torch.engine import distributed as D
        return D.dist_count(self.mesh, self.data_axes, mask)

    def agg(self, env, mask, op, column):
        from repro_torch.engine import distributed as D
        if op == "count":
            return D.dist_count(self.mesh, self.data_axes, mask)
        return D.dist_agg(self.mesh, self.data_axes, op, env[column], mask)

    def limit(self, env, mask, n, positions=None):
        from repro_torch.engine import distributed as D
        return D.dist_limit(self.mesh, self.data_axes, env, mask, n,
                            positions=positions)

    def topk(self, env, mask, key, k, ascending, select, positions=None):
        from repro_torch.engine import distributed as D
        return D.dist_topk(self.mesh, self.data_axes, env, mask, key, k,
                           ascending, select=select, positions=positions)

    def group_agg(self, env, mask, key, lo, num_groups, aggs):
        from repro_torch.engine import distributed as D
        value_cols = {c: env[c] for _, _, c in aggs if c}
        out, gmask = D.dist_group_agg(self.mesh, self.data_axes, env[key],
                                      mask, lo, num_groups, aggs, value_cols)
        out[key] = out.pop("__key__")
        return out, gmask

    def kernel_group_agg(self, gid, values, num_groups, n, op,
                         block_ids: Optional[tuple] = None,
                         shard_blocks=None):
        from repro_torch.engine import distributed as D
        return D.dist_kernel_group_agg(self.mesh, self.data_axes, gid, values,
                                       num_groups, op=op, block_ids=block_ids,
                                       shard_blocks=shard_blocks)

    def kernel_filter_count(self, cols, bounds,
                            block_ids: Optional[tuple] = None,
                            shard_blocks=None):
        from repro_torch.engine import distributed as D
        return D.dist_kernel_filter_count(self.mesh, self.data_axes, cols,
                                          bounds, block_ids=block_ids,
                                          shard_blocks=shard_blocks)

    def join_count(self, lkey, lmask, rkey, rmask, presorted):
        from repro_torch.engine import distributed as D
        return D.dist_join_count(self.mesh, self.data_axes, lkey, lmask,
                                 rkey, rmask, presorted_right=presorted)

    def kernel_join_count(self, lkey, lmask, rkey, rmask, presorted):
        from repro_torch.engine import distributed as D
        return D.dist_kernel_join_count(self.mesh, self.data_axes, lkey,
                                        lmask, rkey, rmask,
                                        presorted_right=presorted)


def make_strategy(ctx: "ExecContext") -> LoweringStrategy:
    """The only place the execution mode is consulted at lowering time:
    pick the collective placement. Operator choice already happened in the
    planner. A rank mesh takes the explicit collectives in every mode."""
    if ctx.mesh is not None and (ctx.mode in ("shard_map", "kernel")
                                 or is_rank_mesh(ctx.mesh)):
        return ShardMapStrategy(ctx.mesh, ctx.data_axes)
    sharded = ctx.mesh is not None and mesh_shards(ctx.mesh, ctx.data_axes) > 1
    return LoweringStrategy(ctx.mesh if sharded else None, ctx.data_axes)


@dataclasses.dataclass
class ExecContext:
    catalog: Catalog
    mode: str = "gspmd"         # gspmd | shard_map | kernel
    device: Any = "cpu"
    mesh: Any = None            # launch.mesh.Mesh of a sharded session
    data_axes: tuple = ("data",)
    strategy: Optional[LoweringStrategy] = None

    def __post_init__(self):
        if self.strategy is None:
            self.strategy = make_strategy(self)

    @property
    def on_ranks(self) -> bool:
        return is_rank_mesh(self.mesh)


_LOCAL = LoweringStrategy()


def _replicated(node: PH.PhysOp) -> bool:
    """On a rank mesh: True where ``node``'s stream is whole and the same
    on every rank (a merge's result, or computed from one), False where it
    is this rank's row shard (a scan, and the filters and projections over
    it)."""
    if isinstance(node, (PH.TableScan, PH.IndexProbe)):
        return False
    if isinstance(node, (PH.LimitRows, PH.TopKSelect, PH.SortRows,
                         PH.WindowEval, PH.JoinGather, PH.GroupAggGeneric,
                         PH.KernelSegmentAgg)):
        return True
    return bool(node.children) and all(_replicated(c) for c in node.children)


def _strategy(ctx: "ExecContext", child: PH.PhysOp) -> LoweringStrategy:
    """The strategy for an operator over ``child``'s stream: a whole
    stream on a rank mesh is merged already, so the operator runs locally
    (the same on every rank)."""
    return _LOCAL if ctx.on_ranks and _replicated(child) else ctx.strategy


def _union_below(node: PH.PhysOp) -> Optional[PH.PrunedUnionRuns]:
    """The union of several components whose rows ``node``'s stream
    carries one for one (through filters, projections and dictionary
    remaps), else None."""
    while isinstance(node, (PH.FullScanFilter, PH.ProjectCols,
                            PH.DictRemapCols)):
        node = node.children[0]
    if isinstance(node, PH.PrunedUnionRuns) and len(node.children) > 1:
        return node
    return None


def _segments(tables: dict, union) -> Optional[list]:
    """On a rank mesh: this rank's row count of each component of
    ``union``'s stream in this run (its lowering records them), else
    None."""
    return None if union is None else tables[("union", id(union))]


def _whole(fn: Callable, child: PH.PhysOp, ctx: "ExecContext") -> Callable:
    """``fn`` (``child``'s lowered stream) made whole on every rank of a
    rank mesh: this rank's shard is gathered with the others (shard order
    is row order; a union's rows component by component). The identity
    elsewhere."""
    if not ctx.on_ranks or _replicated(child):
        return fn
    from repro_torch.engine.distributed import gather_stream

    union = _union_below(child)

    def gathered(tables, params):
        env, mask = fn(tables, params)
        return gather_stream(ctx.mesh, ctx.data_axes, env, mask,
                             segments=_segments(tables, union))
    return gathered


def _positions(ctx: "ExecContext", child: PH.PhysOp) -> Callable:
    """``positions(tables, device)``: on a rank mesh, where ``child``'s
    stream is this rank's rows of a union, each row's position in the whole
    stream (a top-k or limit breaks ties by it); None elsewhere."""
    union = _union_below(child) if ctx.on_ranks and not _replicated(child) \
        else None
    if union is None:
        return lambda tables, device: None
    from repro_torch.engine.distributed import union_positions

    return lambda tables, device: union_positions(
        ctx.mesh, ctx.data_axes, _segments(tables, union), device)


@dataclasses.dataclass
class CompiledQuery:
    physical: PH.PhysOp         # the costed physical plan that was lowered
    kind: str                   # scalar | table | grouped
    fn: Callable                # (tables, params) -> result
    leaf_keys: list             # dataset keys feeding `tables` (pruned runs excluded)
    lits: list                  # literal slots (physical plan order)
    device: Any = "cpu"
    # components whose sorted anti-key arrays the plan subtracts with (may
    # include runs whose MATTER was zone-pruned: their tombstones still
    # annihilate into older components)
    anti_keys: list = dataclasses.field(default_factory=list)
    # the private copy of ``physical`` the closure was lowered from: its
    # Lit objects carry THIS query's param slots
    lowered: Optional[PH.PhysOp] = None

    def gather_tables(self, catalog: Catalog) -> dict:
        tables = {}
        for key in self.leaf_keys:
            ds = catalog.get(*key)
            cols = dict(ds.table.columns)
            for ix in ds.indexes.values():
                if ix.sorted_keys is not None:
                    cols[f"__ix_{ix.column}__"] = ix.sorted_keys
                    cols[f"__ixid_{ix.column}__"] = ix.row_ids
            tables[f"{key[0]}.{key[1]}"] = cols
        for key in self.anti_keys:
            tables[f"anti:{key[0]}.{key[1]}"] = catalog.get(*key).anti_keys_arr
        return tables

    def run(self, catalog: Catalog, params=None):
        """``params``: literal values in slot order (the session's plan
        cache binds them); None runs the compiled literals."""
        if params is None:
            params = param_values(self.lits, self.device)
        return self.fn(self.gather_tables(catalog), params)


def compile_physical(phys: PH.PhysOp, ctx: ExecContext,
                     gathered: bool = True) -> CompiledQuery:
    """Lower one physical plan into a callable. The lowering works on a
    private copy of the plan: a literal's param slot lives on its Lit
    object, and the physical plans of one optimized plan's variants share
    Lit objects, so a later variant's slot assignment must never reach an
    earlier variant's closure (it reads the slots when it runs).
    ``gathered=False`` (``Session.persist`` on a rank mesh) leaves a row
    stream as this rank's rows instead of making it whole."""
    lowered = copy.deepcopy(phys)
    leaf_keys = PH.scan_leaves(lowered)
    lits = collect_params(PH.all_exprs(lowered))
    kind, build = _lower_terminal(lowered, ctx, gathered)
    return CompiledQuery(phys, kind, build, leaf_keys, lits, ctx.device,
                         anti_keys=PH.anti_leaves(lowered), lowered=lowered)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _result_rows(kind: str, out) -> int:
    """Actual row count of one lowered result: live mask sum for streams and
    groups, 1 for a scalar dict."""
    if kind in ("table", "grouped"):
        return int(out[1].sum())
    return 1


def profile_physical(phys: PH.PhysOp, ctx: ExecContext, tables: dict,
                     params) -> dict:
    """Per-operator measurement for ``explain(analyze=True)``: lower each
    node's subtree standalone and run it, synchronized on the device. Self
    time = subtree total − Σ direct-child subtree totals, clamped at 0. Row
    counts are exact (same lowering, same inputs). Only paid when the user
    asks to analyze.

    Returns ``{"nodes": {id(node): {kind, total_seconds, self_seconds,
    rows}}}`` — the dict ``format_plan(root, analyze=...)`` renders."""
    nodes: dict[int, dict] = {}
    for node in PH.walk(phys):
        try:
            kind, build = _lower_terminal(node, ctx)
        except NotImplementedError:  # pragma: no cover - defensive
            continue
        with tel.span("profile.operator", op=type(node).__name__):
            _sync(ctx.device)
            t0 = time.perf_counter()
            out = build(tables, params)
            _sync(ctx.device)
            dt = time.perf_counter() - t0
        nodes[id(node)] = {"kind": kind, "total_seconds": dt,
                           "rows": _result_rows(kind, out)}
    for node in PH.walk(phys):
        m = nodes.get(id(node))
        if m is None:
            continue
        kids = sum(nodes[id(c)]["total_seconds"] for c in node.children
                   if id(c) in nodes)
        m["self_seconds"] = max(m["total_seconds"] - kids, 0.0)
    return {"nodes": nodes}


# -- streaming lowering -------------------------------------------------------


def _env_of(cols: dict, open_cast: bool = False):
    env = {k: v for k, v in cols.items()
           if k not in INTERNAL_COLUMNS and not k.startswith("__ix")}
    if open_cast:  # schema-on-read: a cast per access (string lanes stay int)
        env = {k: (v.to(torch.float32) if v.ndim == 1
                   and not v.dtype.is_floating_point and v.dtype != torch.bool
                   and not is_lane_column(k) else v)
               for k, v in env.items()}
    mask = cols.get("__valid__")
    if mask is None:
        first = next(iter(env.values()))
        mask = torch.ones((first.shape[0],), dtype=torch.bool, device=first.device)
    return env, mask


def _shadowed(tables: dict, keys: torch.Tensor, shadow_sources) -> torch.Tensor:
    """True where a row's primary key appears in any newer component's
    sorted anti-key set — the newest-wins subtraction every matter stream
    applies. One batched binary search per tombstone set, in the anti
    keys' own dtype."""
    hit = None
    for dv, name in shadow_sources:
        ak = tables[f"anti:{dv}.{name}"]
        k = keys.to(ak.dtype)
        pos = torch.searchsorted(ak, k, side="left").clamp(max=ak.shape[0] - 1)
        h = ak[pos] == k
        hit = h if hit is None else (hit | h)
    return hit


def _block_gather(blocks: Optional[tuple], zone_block: int,
                  n_shards: int = 1, blocks_per_shard: int = 0,
                  rows_per_shard: int = 0, pad_multiple: int = 1,
                  own_shard: Optional[int] = None):
    """Static-slice gather of the surviving row blocks (ascending ids keep
    the original row order); None = identity.

    With ``n_shards > 1`` flat ids address per-shard local blocks (``s *
    blocks_per_shard + j`` = shard ``s``'s block ``j``): the slice lies in
    shard ``s``'s row chunk and a trailing partial block clips at the
    chunk's end, so a gather never straddles shards. ``pad_multiple``
    zero-pads the gathered length to a multiple (the shard_map operators
    split rows evenly over the mesh); pad rows carry a False mask.

    ``own_shard`` (a rank mesh): the columns are that shard's rows alone,
    so only its own blocks are gathered, at local offsets; a rank with no
    surviving block keeps one dead row (every rank still takes part in the
    merges that follow)."""
    if blocks is None:
        return lambda col: col
    spans = []
    for b in blocks:
        if n_shards <= 1:
            spans.append((b * zone_block, (b + 1) * zone_block))
        else:
            s, j = divmod(b, blocks_per_shard)
            if own_shard is not None and s != own_shard:
                continue
            base = 0 if own_shard is not None else s * rows_per_shard
            spans.append((base + j * zone_block,
                          base + min((j + 1) * zone_block, rows_per_shard)))

    def sel(col):
        parts = [col[lo:hi] for lo, hi in spans] or [col[:0]]
        out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
        if not out.shape[0]:
            return out.new_zeros((1,) + tuple(out.shape[1:]))
        pad = (-out.shape[0]) % pad_multiple
        if pad:
            out = torch.cat([out, out.new_zeros((pad,) + tuple(out.shape[1:]))])
        return out
    return sel


def _stream_pad(ctx: ExecContext) -> int:
    """Row-count multiple a gathered stream must keep: the shard_map
    operators split their inputs evenly over the one-process mesh's
    shards (a rank's stream is its shard alone)."""
    if isinstance(ctx.strategy, ShardMapStrategy) and not ctx.on_ranks:
        return mesh_shards(ctx.mesh, ctx.data_axes)
    return 1


def _own_shard(ctx: ExecContext) -> Optional[int]:
    """This rank's shard number on a rank mesh, else None."""
    return ctx.mesh.index(tuple(ctx.data_axes)) if ctx.on_ranks else None


def _lower_component(node, ctx: ExecContext,
                     index_col: Optional[str] = None) -> Callable:
    """The matter stream of one component (TableScan / IndexProbe): the
    surviving blocks, the open-dataset cast, newer anti-matter subtracted
    from the mask; an IndexProbe adds its range mask and residual."""
    key = f"{node.dataverse}.{node.dataset}"
    open_cast = node.open_cast
    shadow, key_col = node.shadow_sources, node.key_col
    sel = _block_gather(node.block_ids, node.zone_block, *node.shard_layout(),
                        pad_multiple=_stream_pad(ctx),
                        own_shard=_own_shard(ctx))

    def fn(tables, params):
        env, mask = _env_of(tables[key], open_cast)
        env = {k: sel(v) for k, v in env.items()}
        mask = sel(mask)
        if shadow:
            mask = mask & ~_shadowed(tables, sel(tables[key][key_col]), shadow)
        if index_col is not None:
            lo = node.lo.evaluate(env, params) if node.lo is not None else None
            hi = node.hi.evaluate(env, params) if node.hi is not None else None
            mask = physical.index_range_mask(env[index_col], mask, lo, hi)
            if node.residual is not None:
                mask = mask & node.residual.evaluate(env, params)
        return env, mask
    return fn


def _lower_stream(node: PH.PhysOp, ctx: ExecContext) -> Callable:
    """Returns fn(tables, params) -> (env, mask). Filters never compact
    (selection-vector execution)."""
    if isinstance(node, PH.TableScan):
        return _lower_component(node, ctx)

    if isinstance(node, PH.IndexProbe):
        # the probe inherits its Scan site's surviving-block list: rows in
        # skipped blocks provably fail the conjuncts that bound the probe
        return _lower_component(node, ctx, index_col=node.index_col)

    if isinstance(node, PH.PrunedUnionRuns):
        kids = [_lower_stream(c, ctx) for c in node.children]
        if len(kids) == 1:
            return kids[0]

        def fn(tables, params):
            envs, masks = [], []
            for k in kids:
                e, m = k(tables, params)
                envs.append(e)
                masks.append(m)
            if ctx.on_ranks:   # this rank's rows of each component
                tables[("union", id(node))] = [m.shape[0] for m in masks]
            env = {n: torch.cat([e[n] for e in envs], dim=0) for n in envs[0]}
            return env, torch.cat(masks, dim=0)
        return fn

    if isinstance(node, PH.DictRemapCols):
        child = _lower_stream(node.children[0], ctx)
        key, lane = node.key, node.lane
        remap = torch.tensor(node.remap, dtype=torch.int32, device=ctx.device)

        def fn(tables, params):
            env, mask = child(tables, params)
            env = dict(env)
            lane_col = env.pop(lane)
            if not node.remap:
                # empty local dictionary: the component has no live string
                # rows, so every row is masked — any id is fine.
                env[key] = torch.zeros_like(lane_col)
            else:
                # dead rows carry id -1: clamp to 0 — they map to SOME valid
                # union id, but their mask is False so they weigh nothing.
                env[key] = remap[lane_col.clamp(min=0).long()]
            return env, mask
        return fn

    if isinstance(node, PH.FullScanFilter):
        child = _lower_stream(node.children[0], ctx)

        def fn(tables, params):
            env, mask = child(tables, params)
            return env, mask & node.predicate.evaluate(env, params)
        return fn

    if isinstance(node, PH.ProjectCols):
        child = _lower_stream(node.children[0], ctx)
        outputs = node.outputs

        def fn(tables, params):
            env, mask = child(tables, params)
            return {name: e.evaluate(env, params) for name, e in outputs}, mask
        return fn

    if isinstance(node, PH.LimitRows):
        child = _lower_stream(node.children[0], ctx)
        strategy = _strategy(ctx, node.children[0])
        positions = _positions(ctx, node.children[0])

        def fn(tables, params):
            env, mask = child(tables, params)
            return strategy.limit(env, mask, node.n,
                                  positions=positions(tables, mask.device))
        return fn

    if isinstance(node, PH.TopKSelect):
        child = _lower_stream(node.children[0], ctx)
        # one lowering, parameterized by the selection primitive: the planner
        # swaps in the block_topk kernel, everything else is shared
        select = physical.kernel_topk_select() if node.kernel \
            else physical._select_topk
        strategy = _strategy(ctx, node.children[0])
        positions = _positions(ctx, node.children[0])

        def fn(tables, params):
            env, mask = child(tables, params)
            return strategy.topk(env, mask, node.key, node.k, node.ascending,
                                 select,
                                 positions=positions(tables, mask.device))
        return fn

    if isinstance(node, PH.SortRows):
        child = _whole(_lower_stream(node.children[0], ctx),
                       node.children[0], ctx)

        def fn(tables, params):
            env, mask = child(tables, params)
            return physical.sort_full(env, mask, node.key, node.ascending)
        return fn

    if isinstance(node, PH.WindowEval):
        child = _whole(_lower_stream(node.children[0], ctx),
                       node.children[0], ctx)

        def fn(tables, params):
            env, mask = child(tables, params)
            return execute_window(env, mask, node.window)
        return fn

    if isinstance(node, PH.JoinGather):
        # build-key uniqueness/disjointness was proven by the planner
        lchild = _whole(_lower_stream(node.children[0], ctx),
                        node.children[0], ctx)
        rchild = _whole(_lower_stream(node.children[1], ctx),
                        node.children[1], ctx)

        def fn(tables, params):
            lenv, lm = lchild(tables, params)
            renv, rm = rchild(tables, params)
            return physical.join_materialize(lenv, lm, renv, rm,
                                             node.left_on, node.right_on)
        return fn

    if isinstance(node, (PH.GroupAggGeneric, PH.KernelSegmentAgg)):
        return _lower_groupagg(node, ctx)

    raise NotImplementedError(f"stream lowering for {type(node).__name__}")


def _lower_groupagg(node, ctx: ExecContext) -> Callable:
    aggs = [(s.out_name, s.op, s.column) for s in node.aggs]
    if isinstance(node, PH.KernelSegmentAgg):
        comps = [_lower_stream(c, ctx) for c in node.children]
        inner = _lower_kernel_segment_agg(node, ctx, comps, aggs)
    else:
        child = _lower_stream(node.children[0], ctx)
        key, lo, num_groups = node.key, node.lo, node.num_groups
        strategy = _strategy(ctx, node.children[0])

        def inner(tables, params):
            env, mask = child(tables, params)
            return strategy.group_agg(env, mask, key, lo, num_groups, aggs)

    if node.key_values is None:
        return inner

    # string group-by: the machinery above grouped over union-dictionary ids
    # (DictRemapCols remapped each component below the concat). Decode the
    # surviving ids back to the encoded (G, 16) string rows at the result
    # boundary — identical in both modes, since every path returns the group
    # id itself as the key column.
    enc = encode_strings(list(node.key_values)).to(ctx.device)
    out_key = node.key

    def fn(tables, params):
        out, gmask = inner(tables, params)
        out = dict(out)
        out[out_key] = enc[out[out_key].long()]
        return out, gmask
    return fn


def _lower_kernel_segment_agg(node: PH.KernelSegmentAgg, ctx: ExecContext,
                              comps: list, aggs: list) -> Callable:
    """One lowered stream per LSM component (a single entry for a plain
    dataset). Each component runs its own launches — one segment_agg for
    the sum family (count/sum/mean fused into one (n, C) value tile: column
    0 counts, columns 1.. sum the value columns), one per extreme family —
    and the (G, C) partials merge with +/max/min. The planner proved f32
    exactness, so every float32 group result is an exact integer and the
    casts below reproduce the generic path bit for bit."""
    key, lo, num_groups = node.key, node.lo, node.num_groups
    comp_blocks = node.comp_blocks or tuple(None for _ in comps)
    # resolve each component's hoisted block list once, here: a one-shard
    # layout keeps the static zone-block tuple; a multi-shard layout
    # expands to the per-shard (-1-padded) kernel-block matrix, row s
    # driving shard s's launch
    resolved: list[tuple] = []
    for blk in comp_blocks:
        if blk is None or blk[0] is None:
            resolved.append((None, None))
            continue
        ids, zb, nsh, bp, rps = blk
        if nsh > 1:
            from repro_torch.kernels import ops
            from repro_torch.kernels.segment_agg import BLOCK as _SA_BLOCK
            resolved.append((None, ShardBlocks(ops.shard_block_arrays(
                ids, zb, _SA_BLOCK, nsh, bp, rps))))
        else:
            resolved.append((ids, None))
    vcols: list[str] = []   # distinct sum-family value columns, first-use order
    xcols: dict[str, list[str]] = {"max": [], "min": []}
    for _, op, col in aggs:
        if op in ("sum", "mean") and col not in vcols:
            vcols.append(col)
        elif op in ("max", "min") and col not in xcols[op]:
            xcols[op].append(col)
    merge = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}

    def fn(tables, params):
        parts: dict[str, torch.Tensor] = {}
        key_dtype = val_dtypes = None
        for comp, (block_ids, shard_blocks) in zip(comps, resolved):
            # the block list was hoisted off the component's TableScan: the
            # stream stays full-length and the kernel grid skips the tiles
            env, mask = comp(tables, params)
            key_col = env[key]
            key_dtype = key_col.dtype
            val_dtypes = {c: env[c].dtype for _, _, c in aggs if c}
            # dead rows get gid -1: the kernel's live check drops them, so an
            # arbitrary (non-prefix) mask needs no compaction
            gid = torch.where(mask, (key_col - lo).to(torch.int32), -1)
            n = mask.shape[0]
            tiles = {"sum": [torch.ones(mask.shape, dtype=torch.float32,
                                        device=mask.device)]
                     + [env[c].to(torch.float32) for c in vcols]}
            for op, cols in xcols.items():
                if cols:
                    tiles[op] = [env[c].to(torch.float32) for c in cols]
            for op, cols_f32 in tiles.items():
                part = ctx.strategy.kernel_group_agg(
                    gid, torch.stack(cols_f32, dim=1), num_groups, n, op,
                    block_ids=block_ids, shard_blocks=shard_blocks)
                parts[op] = part if op not in parts else merge[op](parts[op], part)
        sums = parts["sum"]
        counts = sums[:, 0].to(torch.int32)
        out = {key: torch.arange(lo, lo + num_groups, dtype=key_dtype,
                                 device=sums.device)}
        for out_name, op, col in aggs:
            if op == "count":
                out[out_name] = counts
            elif op == "sum":
                out[out_name] = sums[:, 1 + vcols.index(col)].to(val_dtypes[col])
            elif op == "mean":  # exact-integer f32 sum / count, as generic
                out[out_name] = sums[:, 1 + vcols.index(col)] / counts.clamp(min=1)
            else:  # max/min: empty groups hold ±inf — pin before the int cast
                v = parts[op][:, xcols[op].index(col)]
                out[out_name] = torch.where(counts > 0, v, 0.0).to(val_dtypes[col])
        return out, counts > 0
    return fn


# -- terminal lowering --------------------------------------------------------


def _lower_terminal(node: PH.PhysOp, ctx: ExecContext,
                    gathered: bool = True) -> tuple[str, Callable]:
    if isinstance(node, PH.MergeScalars):
        # per-component scalar programs (each with its own access path)
        # merged with +/max/min; pruned runs never compile, gather or launch
        subs = []
        for c in node.children:
            kind, build = _lower_terminal(c, ctx)
            assert kind == "scalar", f"MergeScalars over {kind} child"
            subs.append(build)
        merges = node.merges
        combine = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}

        def fn(tables, params):
            outs = [s(tables, params) for s in subs]
            res = dict(outs[0])
            for o in outs[1:]:
                for name, op in merges:
                    res[name] = combine[op](res[name], o[name])
            return res
        return "scalar", fn

    if isinstance(node, PH.SubtractScalars):
        # anti-matter subtraction: visible = all matter − shadowed matter
        kind_a, minuend = _lower_terminal(node.children[0], ctx)
        kind_b, subtrahend = _lower_terminal(node.children[1], ctx)
        assert kind_a == kind_b == "scalar", (kind_a, kind_b)
        names = node.names

        def fn(tables, params):
            a = minuend(tables, params)
            b = subtrahend(tables, params)
            return {n: (a[n] - b[n]).to(a[n].dtype)
                    if n in names and n in b else a[n] for n in a}
        return "scalar", fn

    if isinstance(node, PH.ShadowProbeCount):
        return "scalar", _lower_shadow_probe_count(node, ctx)

    if isinstance(node, PH.KernelRangeCount):
        return "scalar", _lower_kernel_range_count(node, ctx)

    if isinstance(node, PH.IndexOnlyCount):
        return "scalar", _lower_index_only_count(node, ctx)

    if isinstance(node, PH.MaskCount):
        child = _lower_stream(node.children[0], ctx)
        pred = node.predicate
        strategy = _strategy(ctx, node.children[0])

        def fn(tables, params):
            env, mask = child(tables, params)
            if pred is not None:
                mask = mask & pred.evaluate(env, params)
            return {"count": strategy.count(mask)}
        return "scalar", fn

    if isinstance(node, PH.JoinCountOp):
        return "scalar", _lower_join_count(node, ctx)

    if isinstance(node, PH.ScalarAgg):
        child = _lower_stream(node.children[0], ctx)
        aggs = [(s.out_name, s.op, s.column) for s in node.aggs]
        strategy = _strategy(ctx, node.children[0])

        def fn(tables, params):
            env, mask = child(tables, params)
            return {name: strategy.agg(env, mask, op, col)
                    for name, op, col in aggs}
        return "scalar", fn

    if isinstance(node, (PH.GroupAggGeneric, PH.KernelSegmentAgg)):
        return "grouped", _lower_groupagg(node, ctx)

    stream = _lower_stream(node, ctx)
    return "table", _whole(stream, node, ctx) if gathered else stream


def _lower_kernel_range_count(node: PH.KernelRangeCount, ctx: ExecContext) -> Callable:
    """Lower onto the filter_count kernel. The plan keeps one entry per
    conjunct (open sides are int32-extreme literals); here the entries group
    by column at run time — a column's lower bound is the max of its lower
    params, its upper bound the min of its upper ones — so each distinct
    column reaches the kernel once, in a list (nothing stacked), with a
    (k, 2) bounds operand. The column read bypasses the generic stream
    path, so no row mask is built outside the kernel, except the matter
    column: the validity mask and newer components' anti-matter
    (valid ∧ ¬shadowed) fold into ONE extra kernel column with bounds
    (1, 1). ``block_ids`` drive the kernel grid; on a multi-shard layout
    they expand to the per-shard kernel-block matrix, row s driving shard
    s's launch."""
    key = f"{node.dataverse}.{node.dataset}"
    shadow, key_col, has_valid = node.shadow_sources, node.key_col, node.has_valid
    block_ids = node.block_ids
    shard_blocks = None
    nsh, bp, rps = node.shard_layout()
    if block_ids is not None and nsh > 1:
        from repro_torch.kernels import ops
        from repro_torch.kernels.filter_count import BLOCK as _FC_BLOCK
        shard_blocks = ShardBlocks(ops.shard_block_arrays(
            block_ids, node.zone_block, _FC_BLOCK, nsh, bp, rps))
        block_ids = None
    groups: dict[str, tuple[list, list]] = {}
    for col, lo, hi in zip(node.cols, node.los, node.his):
        los, his = groups.setdefault(col, ([], []))
        los.append(lo)
        his.append(hi)
    consts: dict = {}  # per device: int32 [1, 1]

    def fold(exprs, params, op):
        v = exprs[0].evaluate({}, params).reshape(1)
        for e in exprs[1:]:
            v = op(v, e.evaluate({}, params).reshape(1))
        return v

    def fn(tables, params):
        t = tables[key]
        columns = [t[c].to(torch.int32) for c in groups]
        bounds = []
        for los, his in groups.values():
            bounds.append(fold(los, params, torch.maximum))
            bounds.append(fold(his, params, torch.minimum))
        if has_valid or shadow:
            dev = columns[0].device
            if not shadow:
                matter = t["__valid__"]
            elif has_valid:
                matter = t["__valid__"] & ~_shadowed(tables, t[key_col], shadow)
            else:
                matter = ~_shadowed(tables, t[key_col], shadow)
            columns.append(matter.to(torch.int32))
            one = consts.get(dev)
            if one is None:
                one = consts[dev] = torch.ones(2, dtype=torch.int32, device=dev)
            bounds.append(one)
        bounds = torch.cat(bounds).to(torch.int32).view(-1, 2)
        cnt = ctx.strategy.kernel_filter_count(columns, bounds,
                                               block_ids=block_ids,
                                               shard_blocks=shard_blocks)
        return {"count": cnt.to(torch.int32)}
    return fn


def _lower_shadow_probe_count(node: PH.ShadowProbeCount, ctx: ExecContext) -> Callable:
    """The index-only subtrahend: the sorted-unique union of the newer
    components' anti-key sets (a key tombstoned twice dies once), clipped to
    the predicate range, counts each tombstone's matter occurrences in this
    component's sorted primary index. The anti sets are immutable for the
    life of the plan (it is keyed by stats epoch and LSN), so the union is
    computed once here on the host and placed on the device once."""
    key = f"{node.dataverse}.{node.dataset}"
    ix_name = f"__ix_{node.index_col}__"
    parts = []
    for dv, name in node.shadow_sources:
        ds = ctx.catalog.get(dv, name)
        parts.append(ds.host_anti_keys if ds.host_anti_keys is not None
                     else ds.anti_keys_arr.cpu().numpy())
    anti_union = np.unique(np.concatenate(parts))
    placed: dict = {}  # (device, dtype) -> tensor

    def fn(tables, params):
        t = tables[key]
        ix_keys = t[ix_name]
        valid = t.get("__valid__")
        if valid is None:
            valid = torch.ones(ix_keys.shape, dtype=torch.bool,
                               device=ix_keys.device)
        where = (ix_keys.device, ix_keys.dtype)
        anti = placed.get(where)
        if anti is None:
            anti = placed[where] = torch.from_numpy(anti_union).to(
                device=ix_keys.device, dtype=ix_keys.dtype)
        lo = node.lo.evaluate({}, params) if node.lo is not None else None
        hi = node.hi.evaluate({}, params) if node.hi is not None else None
        cnt = ctx.strategy.shadow_count(ix_keys, valid, anti, lo, hi)
        return {"count": cnt.to(torch.int32)}
    return fn


def _lower_index_only_count(node: PH.IndexOnlyCount, ctx: ExecContext) -> Callable:
    key = f"{node.dataverse}.{node.dataset}"
    ix_name = f"__ix_{node.index_col}__"

    def fn(tables, params):
        cols = tables[key]
        ix_keys = cols[ix_name]
        valid = cols.get("__valid__")
        if valid is None:
            valid = torch.ones(ix_keys.shape, dtype=torch.bool,
                               device=ix_keys.device)
        lo = node.lo.evaluate({}, params) if node.lo is not None else None
        hi = node.hi.evaluate({}, params) if node.hi is not None else None
        return {"count": ctx.strategy.index_count(ix_keys, valid, lo, hi)}
    return fn


def _lower_join_count(node: PH.JoinCountOp, ctx: ExecContext) -> Callable:
    lchild = _lower_stream(node.children[0], ctx)
    rchild = _lower_stream(node.children[1], ctx)
    left_on, right_on = node.left_on, node.right_on
    presorted = node.presorted
    strategy = ctx.strategy
    if ctx.on_ranks and (_replicated(node.children[0])
                         or _replicated(node.children[1])):
        # a whole side on a rank mesh: the other is gathered, and the
        # join runs locally (the right keys from its stream, not from
        # this rank's shard of an index)
        lchild = _whole(lchild, node.children[0], ctx)
        rchild = _whole(rchild, node.children[1], ctx)
        presorted, strategy = False, _LOCAL
    if presorted:
        rkey_table = f"{node.presorted_key[0]}.{node.presorted_key[1]}"
        rkey_name = f"__ix_{right_on}__"
    join = strategy.kernel_join_count if node.kernel \
        else strategy.join_count

    def fn(tables, params):
        lenv, lm = lchild(tables, params)
        renv, rm = rchild(tables, params)
        rkey = tables[rkey_table][rkey_name] if presorted else renv[right_on]
        return {"count": join(lenv[left_on], lm, rkey, rm, presorted)}
    return fn
