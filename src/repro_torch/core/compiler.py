"""Physical-plan compiler: costed physical plan → one callable over torch
tensors (port of ``repro.core.compiler``, single-device lowering).

The reference wraps the lowered function in ``jax.jit``; PyTorch runs
eagerly, so ``compile_physical`` builds a closure ``fn(tables, params)``
once per physical fingerprint and the session caches it. Literal values are
runtime params (tensors on the session device), so randomized predicates
reuse the compiled query — the prepared-statement effect.

The execution mode is not a branch inside operator lowerings: kernel mode
differs only in the physical operators the planner emitted
(``KernelRangeCount``, ``KernelSegmentAgg``, kernel ``JoinCountOp``, kernel
``TopKSelect``), whose lowerings call ``repro_torch.kernels.ops``. Those ops
launch the hand-written CUDA kernels on CUDA tensors and their plain
versions on CPU tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core import physical as PH
from repro_torch.core.catalog import INTERNAL_COLUMNS, Catalog
from repro_torch.core.expr import collect_params, param_values
from repro_torch.core.optimizer import _RANGE_MAX, _RANGE_MIN
from repro_torch.engine import physical


# -- lowering strategy --------------------------------------------------------


class LoweringStrategy:
    """Single-device lowering: plain torch ops, or the relational kernels
    for the kernel physical operators."""

    def count(self, mask):
        return mask.sum(dtype=torch.int32)

    def agg(self, env, mask, op, column):
        return physical.agg_scalar(env, mask, op, column)

    def limit(self, env, mask, n):
        return physical.limit(env, mask, n)

    def topk(self, env, mask, key, k, ascending, select):
        return physical.topk(env, mask, key, k, ascending, select=select)

    def group_agg(self, env, mask, key, lo, num_groups, aggs):
        return physical.group_agg(env, mask, key, lo, num_groups, aggs)

    def kernel_group_agg(self, gid, values, num_groups, n, op,
                         block_ids: Optional[tuple] = None):
        from repro_torch.kernels import ops
        return ops.segment_agg(values, gid, num_groups, n, op=op,
                               block_ids=block_ids)

    def kernel_filter_count(self, cols, bounds,
                            block_ids: Optional[tuple] = None):
        from repro_torch.kernels import ops
        return ops.filter_count(cols, bounds, cols[0].shape[0],
                                block_ids=block_ids)

    def join_count(self, lkey, lmask, rkey, rmask):
        return physical.join_count(lkey, lmask, rkey, rmask)

    def kernel_join_count(self, lkey, lmask, rkey, rmask):
        from repro_torch.kernels import ops
        ls = ops.sort_join_keys(lkey, lmask)
        rs = ops.sort_join_keys(rkey, rmask)
        nl = lmask.sum(dtype=torch.int32)
        nr = rmask.sum(dtype=torch.int32)
        return ops.merge_join_count(ls, rs, nl, nr)


@dataclasses.dataclass
class ExecContext:
    catalog: Catalog
    mode: str = "gspmd"         # gspmd | kernel
    device: Any = "cpu"
    strategy: LoweringStrategy = dataclasses.field(
        default_factory=LoweringStrategy)


@dataclasses.dataclass
class CompiledQuery:
    physical: PH.PhysOp         # the costed physical plan that was lowered
    kind: str                   # scalar | table | grouped
    fn: Callable                # (tables, params) -> result
    leaf_keys: list             # dataset keys feeding `tables`
    lits: list                  # literal slots (physical plan order)
    device: Any = "cpu"

    def gather_tables(self, catalog: Catalog) -> dict:
        tables = {}
        for key in self.leaf_keys:
            ds = catalog.get(*key)
            tables[f"{key[0]}.{key[1]}"] = dict(ds.table.columns)
        return tables

    def run(self, catalog: Catalog, params=None):
        """``params``: literal values in slot order (the session's plan
        cache binds them); None runs the compiled literals."""
        if params is None:
            params = param_values(self.lits, self.device)
        return self.fn(self.gather_tables(catalog), params)


def compile_physical(phys: PH.PhysOp, ctx: ExecContext) -> CompiledQuery:
    """Lower one physical plan into a callable."""
    leaf_keys = PH.scan_leaves(phys)
    lits = collect_params(PH.all_exprs(phys))
    kind, build = _lower_terminal(phys, ctx)
    return CompiledQuery(phys, kind, build, leaf_keys, lits, ctx.device)


# -- streaming lowering -------------------------------------------------------


def _env_of(cols: dict):
    env = {k: v for k, v in cols.items() if k not in INTERNAL_COLUMNS}
    mask = cols.get("__valid__")
    if mask is None:
        first = next(iter(env.values()))
        mask = torch.ones((first.shape[0],), dtype=torch.bool, device=first.device)
    return env, mask


def _block_gather(blocks: Optional[tuple], zone_block: int):
    """Static-slice gather of the surviving row blocks (ascending ids keep
    the original row order); None = identity."""
    if blocks is None:
        return lambda col: col
    spans = [(b * zone_block, (b + 1) * zone_block) for b in blocks]

    def sel(col):
        parts = [col[lo:hi] for lo, hi in spans]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
    return sel


def _lower_stream(node: PH.PhysOp, ctx: ExecContext) -> Callable:
    """Returns fn(tables, params) -> (env, mask). Filters never compact
    (selection-vector execution)."""
    if isinstance(node, PH.TableScan):
        key = f"{node.dataverse}.{node.dataset}"
        sel = _block_gather(node.block_ids, node.zone_block)

        def fn(tables, params):
            env, mask = _env_of(tables[key])
            return {k: sel(v) for k, v in env.items()}, sel(mask)
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

        def fn(tables, params):
            env, mask = child(tables, params)
            return ctx.strategy.limit(env, mask, node.n)
        return fn

    if isinstance(node, PH.TopKSelect):
        child = _lower_stream(node.children[0], ctx)
        # one lowering, parameterized by the selection primitive: the planner
        # swaps in the block_topk kernel, everything else is shared
        select = physical.kernel_topk_select() if node.kernel \
            else physical._select_topk

        def fn(tables, params):
            env, mask = child(tables, params)
            return ctx.strategy.topk(env, mask, node.key, node.k,
                                     node.ascending, select)
        return fn

    if isinstance(node, PH.SortRows):
        child = _lower_stream(node.children[0], ctx)

        def fn(tables, params):
            env, mask = child(tables, params)
            return physical.sort_full(env, mask, node.key, node.ascending)
        return fn

    if isinstance(node, PH.JoinGather):
        lchild = _lower_stream(node.children[0], ctx)
        rchild = _lower_stream(node.children[1], ctx)

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
        return _lower_kernel_segment_agg(node, ctx, aggs)
    child = _lower_stream(node.children[0], ctx)
    key, lo, num_groups = node.key, node.lo, node.num_groups

    def fn(tables, params):
        env, mask = child(tables, params)
        return ctx.strategy.group_agg(env, mask, key, lo, num_groups, aggs)
    return fn


def _lower_kernel_segment_agg(node: PH.KernelSegmentAgg, ctx: ExecContext,
                              aggs: list) -> Callable:
    """One segment_agg launch for the sum family — count/sum/mean fused into
    one (n, C) value tile: column 0 counts, columns 1.. sum the value
    columns — plus one per extreme family. The planner proved f32
    exactness, so every float32 group result is an exact integer and the
    casts below reproduce the generic path bit for bit."""
    child = _lower_stream(node.children[0], ctx)
    key, lo, num_groups = node.key, node.lo, node.num_groups
    block_ids = node.comp_blocks[0] if node.comp_blocks else None
    vcols: list[str] = []   # distinct sum-family value columns, first-use order
    xcols: dict[str, list[str]] = {"max": [], "min": []}
    for _, op, col in aggs:
        if op in ("sum", "mean") and col not in vcols:
            vcols.append(col)
        elif op in ("max", "min") and col not in xcols[op]:
            xcols[op].append(col)

    def launch(gid, cols_f32, n, op):
        values = torch.stack(cols_f32, dim=1)  # (n, C)
        return ctx.strategy.kernel_group_agg(gid, values, num_groups, n, op,
                                             block_ids=block_ids)

    def fn(tables, params):
        env, mask = child(tables, params)
        key_col = env[key]
        # dead rows get gid -1: the kernel's live check drops them, so an
        # arbitrary (non-prefix) mask needs no compaction
        gid = torch.where(mask, (key_col - lo).to(torch.int32), -1)
        n = mask.shape[0]
        tiles = [torch.ones(mask.shape, dtype=torch.float32, device=mask.device)]
        tiles += [env[c].to(torch.float32) for c in vcols]
        sums = launch(gid, tiles, n, "sum")
        ext = {op: launch(gid, [env[c].to(torch.float32) for c in cols], n, op)
               for op, cols in xcols.items() if cols}
        counts = sums[:, 0].to(torch.int32)
        out = {key: torch.arange(lo, lo + num_groups, dtype=key_col.dtype,
                                 device=key_col.device)}
        for out_name, op, col in aggs:
            if op == "count":
                out[out_name] = counts
            elif op == "sum":
                out[out_name] = sums[:, 1 + vcols.index(col)].to(env[col].dtype)
            elif op == "mean":  # exact-integer f32 sum / count, as generic
                out[out_name] = sums[:, 1 + vcols.index(col)] / counts.clamp(min=1)
            else:  # max/min: empty groups hold ±inf — pin before the int cast
                v = ext[op][:, xcols[op].index(col)]
                out[out_name] = torch.where(counts > 0, v, 0.0).to(env[col].dtype)
        return out, counts > 0
    return fn


# -- terminal lowering --------------------------------------------------------


def _lower_terminal(node: PH.PhysOp, ctx: ExecContext) -> tuple[str, Callable]:
    if isinstance(node, PH.KernelRangeCount):
        return "scalar", _lower_kernel_range_count(node, ctx)

    if isinstance(node, PH.MaskCount):
        child = _lower_stream(node.children[0], ctx)
        pred = node.predicate

        def fn(tables, params):
            env, mask = child(tables, params)
            if pred is not None:
                mask = mask & pred.evaluate(env, params)
            return {"count": ctx.strategy.count(mask)}
        return "scalar", fn

    if isinstance(node, PH.JoinCountOp):
        return "scalar", _lower_join_count(node, ctx)

    if isinstance(node, PH.ScalarAgg):
        child = _lower_stream(node.children[0], ctx)
        aggs = [(s.out_name, s.op, s.column) for s in node.aggs]

        def fn(tables, params):
            env, mask = child(tables, params)
            return {name: ctx.strategy.agg(env, mask, op, col)
                    for name, op, col in aggs}
        return "scalar", fn

    if isinstance(node, (PH.GroupAggGeneric, PH.KernelSegmentAgg)):
        return "grouped", _lower_groupagg(node, ctx)

    return "table", _lower_stream(node, ctx)


def _lower_kernel_range_count(node: PH.KernelRangeCount, ctx: ExecContext) -> Callable:
    """Lower onto the filter_count kernel: each distinct predicate column
    once, in a list (the kernel reads each through its own pointer; nothing
    is stacked), and a (k, 2) bounds operand built from the runtime params
    in one concatenation: a column's lower bound is the max of its lower
    params, its upper bound the min of its upper ones, an open side the
    int32 extreme. The column read bypasses the generic stream path, so no
    row mask is built outside the kernel; a ``__valid__`` padding column
    folds in as one extra kernel column with bounds (1, 1). ``block_ids``
    drive the kernel grid."""
    key = f"{node.dataverse}.{node.dataset}"
    cols, los, his, has_valid = node.cols, node.los, node.his, node.has_valid
    block_ids = node.block_ids
    consts: dict = {}  # per device: int32 [min, max, 1, 1]

    def side(exprs, params, fold, open_):
        if not exprs:
            return open_
        v = exprs[0].evaluate({}, params).reshape(1)
        for e in exprs[1:]:
            v = fold(v, e.evaluate({}, params).reshape(1))
        return v

    def fn(tables, params):
        t = tables[key]
        columns = [t[c].to(torch.int32) for c in cols]
        dev = columns[0].device
        c = consts.get(dev)
        if c is None:
            c = consts[dev] = torch.tensor([_RANGE_MIN, _RANGE_MAX, 1, 1],
                                           dtype=torch.int32, device=dev)
        bounds = []
        for lo, hi in zip(los, his):
            bounds.append(side(lo, params, torch.maximum, c[0:1]))
            bounds.append(side(hi, params, torch.minimum, c[1:2]))
        if has_valid:
            columns.append(t["__valid__"].to(torch.int32))
            bounds.append(c[2:4])
        bounds = torch.cat(bounds).to(torch.int32).view(-1, 2)
        cnt = ctx.strategy.kernel_filter_count(columns, bounds,
                                               block_ids=block_ids)
        return {"count": cnt}
    return fn


def _lower_join_count(node: PH.JoinCountOp, ctx: ExecContext) -> Callable:
    lchild = _lower_stream(node.children[0], ctx)
    rchild = _lower_stream(node.children[1], ctx)
    left_on, right_on = node.left_on, node.right_on
    join = ctx.strategy.kernel_join_count if node.kernel \
        else ctx.strategy.join_count

    def fn(tables, params):
        lenv, lm = lchild(tables, params)
        renv, rm = rchild(tables, params)
        return {"count": join(lenv[left_on], lm, renv[right_on], rm)}
    return fn
