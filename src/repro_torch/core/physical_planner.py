"""Cost-based physical planner: optimized logical plan → physical plan
(port of ``repro.core.physical_planner``, base-dataset paths).

Every access-path and execution-strategy decision is made here by comparing
estimated costs from the statistics layer:

  * COUNT over a predicate — ``KernelRangeCount`` (fused filter_count
    launch) vs. ``MaskCount`` (generic full scan).
  * GroupAgg — ``KernelSegmentAgg`` (segment_agg kernel, gated on a static
    f32-exactness proof) vs. ``GroupAggGeneric``.
  * JoinCount — merge_join kernel (int32-safety proof) vs. generic
    sort+searchsorted.
  * TopK — the block_topk kernel as the selection primitive in kernel mode.
  * Bind-time block zone-map skipping: a Scan constrained by ``col <op>
    lit`` conjuncts keeps only the 4096-row blocks whose zone span can hold
    a passing row. The test depends on literal values, so ``build_pruner``
    runs once per (logical plan, stats epoch) and ``Pruner.decide`` per
    execution; its signature keys the session's third plan-cache level.

Everything else is deterministic given (logical fingerprint, stats epoch,
prune signature): selectivities come from distinct counts and default
fractions, never from literal values.

Not in this slice (each raises ``NotImplementedError`` naming its ROADMAP
item): indexes (A2), LSM unions and anti-matter (A6), the string
dictionary-lane fast path for ``==``/``IN``/group-by (A7) and windows (A7).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import physical as PH
from repro_torch.core import plan as P
from repro_torch.core.catalog import Catalog
from repro_torch.core.expr import Col, Compare, Expr, IsIn, Lit
from repro_torch.core.optimizer import _RANGE_MAX, _RANGE_MIN, _split_conjuncts
from repro_torch.core.stats import ColumnStats, TableStats, harvest
from repro_torch.engine.table import encode_strings, pack_prefix, prefix_lane_name

# -- cost model --------------------------------------------------------------
# Units: ~relative per-row work of a generic masked scan; only ratios steer
# the plan choice.

C_ROW_SCAN = 1.0       # generic stream: evaluate predicate columns, mask
C_ROW_KERNEL = 0.35    # fused kernel row (single pass, no mask in memory)
C_ROW_GROUP = 2.0      # segment reduction per row
C_ROW_SORT = 8.0       # full-sort per row (n log n folded into the constant)
C_ROW_JOIN = 4.0       # sort+searchsorted join per row
C_KERNEL_LAUNCH = 64.0  # fixed per kernel launch

DEFAULT_EQ_SELECTIVITY = 0.1
DEFAULT_RANGE_SELECTIVITY = 0.33
_F32_EXACT = 1 << 24   # ints in [-2^24, 2^24] are exact in float32

_STRING_FAST_PATH = ("string ==/IN/group-by on a dictionary lane waits for "
                     "ROADMAP A7 (string fast path)")


def _conjunct_selectivity(c: Expr, stats: TableStats) -> float:
    """Deterministic textbook selectivity from stats alone (literal values
    are runtime params — the compiled query must not depend on them)."""
    if isinstance(c, IsIn):
        l = c.children[0]
        if not isinstance(l, Col):
            return 1.0
        k = len(c.values)
        cs = stats.column(l.name)
        if cs is not None and cs.distinct:
            return min(k / max(cs.distinct, 1), 1.0)
        return min(k * DEFAULT_EQ_SELECTIVITY, 1.0)
    if not isinstance(c, Compare):
        return 1.0
    l, r = c.children
    if not (isinstance(l, Col) and isinstance(r, Lit)):
        return 1.0
    cs = stats.column(l.name)
    if c.op == "==":
        if cs is not None and cs.distinct:
            return 1.0 / max(cs.distinct, 1)
        return DEFAULT_EQ_SELECTIVITY
    if c.op == "!=":
        return 1.0 - (_conjunct_selectivity(Compare("==", l, r), stats))
    return DEFAULT_RANGE_SELECTIVITY


def _filter_selectivity(pred: Optional[Expr], stats: TableStats) -> float:
    if pred is None:
        return 1.0
    sel = 1.0
    for c in _split_conjuncts(pred):
        sel *= _conjunct_selectivity(c, stats)
    return sel


# -- bind-time block zone-map skipping ----------------------------------------


def _prefix_xform(v):
    """Bind-time transform for string constraints routed through a
    ``__pfx_<col>`` lane: the big-endian pack of the literal's first bytes
    (order-preserving, so span tests are conservative-correct for ==/IN).
    Non-string values return None and the constraint does not apply."""
    if not isinstance(v, str):
        return None
    return int(pack_prefix(encode_strings([v]))[0])


@dataclasses.dataclass(frozen=True)
class _Constraint:
    """One ``col <op> lit`` conjunct constraining a scan. ``ref`` resolves
    the literal at bind time: ("raw", i) reads the i-th literal of the raw
    plan, ("const", v) is a plan constant; op "in" carries ("many", refs).
    ``xform`` maps each value into a lane's integer domain first."""

    column: str
    op: str
    ref: tuple
    xform: object = None

    def value(self, raw_values: list):
        kind, v = self.ref
        if kind == "many":
            vals = tuple(raw_values[i] if k == "raw" else i for k, i in v)
            if self.xform is not None:
                vals = tuple(self.xform(x) for x in vals)
                if any(x is None for x in vals):
                    return None
            return vals
        out = raw_values[v] if kind == "raw" else v
        return self.xform(out) if self.xform is not None else out

    def block_keep(self, spans: np.ndarray, v) -> np.ndarray:
        """Per-block keep mask over the (n_blocks, 2) [lo, hi] zone array;
        empty blocks carry the [max, min] sentinel and fail every test."""
        lo, hi = spans[:, 0], spans[:, 1]
        if self.op == "==":
            return (lo <= v) & (v <= hi)
        if self.op == "in":
            keep = np.zeros(spans.shape[0], bool)
            for x in v:
                keep |= (lo <= x) & (x <= hi)
            return keep
        if self.op == ">=":
            return hi >= v
        if self.op == ">":
            return hi > v
        if self.op == "<=":
            return lo <= v
        if self.op == "<":
            return lo < v
        return np.ones(spans.shape[0], bool)


@dataclasses.dataclass
class _ScanDesc:
    """Block-skip opportunity for one Scan site: its per-block zone maps plus
    the provenance-proven ``col <op> lit`` conjuncts applied above it."""

    ordinal: int                 # scan ordinal (walk order over the opt plan)
    n_blocks: int
    spans: dict                  # column -> (n_blocks, 2) zone array
    constraints: list[_Constraint]


class PruneDecisions:
    """Bind-time outcome: per scan ordinal, the surviving block-id list.
    ``signature`` keys the session's third cache level — block lists are
    static plan structure (kernel grids and gather slices bake them in)."""

    def __init__(self, blocks: Optional[dict] = None):
        self.blocks = blocks or {}
        self.signature = tuple(sorted(self.blocks.items()))

    def block_ids(self, scan_ordinal: int) -> Optional[tuple]:
        return self.blocks.get(scan_ordinal)


NO_PRUNE = PruneDecisions({})


def _numeric(v) -> bool:
    """Bind-time type gate: a number, or (op "in") a non-empty tuple of
    numbers; anything else opts the constraint out."""
    if isinstance(v, tuple):
        return len(v) > 0 and all(_numeric(x) for x in v)
    return isinstance(v, (int, float, np.integer, np.floating))


class Pruner:
    """Extracted once per (optimized plan, stats epoch); ``decide`` is the
    cheap per-execution pass (one O(n_blocks) vector test per constrained
    scan)."""

    def __init__(self, scans: list[_ScanDesc]):
        self.scans = scans

    def decide(self, raw_values: list) -> PruneDecisions:
        blocks: dict[int, tuple] = {}
        for d in self.scans:
            keep = np.ones(d.n_blocks, bool)
            applied = False
            for con in d.constraints:
                v = con.value(raw_values)
                if v is None or not _numeric(v):
                    continue
                applied = True
                keep &= con.block_keep(d.spans[con.column], v)
            if not applied or keep.all():
                continue
            ids = tuple(int(b) for b in np.nonzero(keep)[0])
            # keep at least one block: downstream shapes need >= 1 row, and
            # an extra block never changes the result
            blocks[d.ordinal] = ids if ids else (0,)
        return PruneDecisions(blocks)


def _origin_column(node: P.Plan, name: str) -> Optional[str]:
    """Resolve a stream column name at ``node``'s output to the STORED
    column it reads, following pure ``Col`` Project rebindings; None when
    computed or shadowed."""
    if isinstance(node, P.Scan):
        return name
    if isinstance(node, P.Project):
        for n, e in node.outputs:
            if n == name:
                if isinstance(e, Col):
                    return _origin_column(node.children[0], e.name)
                return None
        return None
    if len(node.children) == 1:  # filter/limit/sort pass through
        return _origin_column(node.children[0], name)
    return None


def _identity_project(node: P.Plan) -> bool:
    """True for the narrow Projects column pruning inserts (every output is
    the same-named stored column)."""
    return isinstance(node, P.Project) and all(
        isinstance(e, Col) and e.name == n for n, e in node.outputs)


def _scan_ordinals(opt: P.Plan) -> dict[int, int]:
    """Scan nodes numbered in walk order (build_pruner and plan_physical
    walk the same plan object, so the numbering agrees)."""
    out: dict[int, int] = {}
    for node in P.walk(opt):
        if isinstance(node, P.Scan):
            out[id(node)] = len(out)
    return out


def _scan_constraints(opt: P.Plan, lit_ref) -> dict[int, list[_Constraint]]:
    """Provenance-proven ``col <op> lit`` conjuncts per Scan site: a
    Filter/FilterCount contributes to the Scan it reaches through ROW-WISE
    nodes only (Filters, Projects); anything positional in between (Limit,
    TopK, a join) breaks the chain."""
    out: dict[int, list[_Constraint]] = {}
    for node in P.walk(opt):
        pred = getattr(node, "predicate", None)
        if not isinstance(node, (P.Filter, P.FilterCount)) or pred is None:
            continue
        cur = node.children[0]
        while isinstance(cur, (P.Filter, P.Project)):
            cur = cur.children[0]
        if not isinstance(cur, P.Scan):
            continue
        for c in _split_conjuncts(pred):
            if isinstance(c, IsIn):
                l = c.children[0]
                if isinstance(l, Col) and c.values \
                        and all(isinstance(v, Lit) for v in c.values):
                    origin = _origin_column(node.children[0], l.name)
                    if origin is not None:
                        out.setdefault(id(cur), []).append(_Constraint(
                            origin, "in",
                            ("many", tuple(lit_ref(v) for v in c.values))))
                continue
            if not isinstance(c, Compare):
                continue
            l, r = c.children
            if not (isinstance(l, Col) and isinstance(r, Lit)) \
                    or c.op not in ("==", ">=", ">", "<=", "<"):
                continue
            origin = _origin_column(node.children[0], l.name)
            if origin is not None:
                out.setdefault(id(cur), []).append(
                    _Constraint(origin, c.op, lit_ref(r)))
    return out


def _expand_string_constraints(cons, stats: TableStats) -> list[_Constraint]:
    """String ==/IN conjuncts prune through the ``__pfx_<col>`` lane: emit a
    twin constraint on the lane with the prefix-pack transform."""
    out = list(cons)
    for c in cons:
        if c.op not in ("==", "in") or c.xform is not None:
            continue
        cs = stats.column(c.column)
        if cs is None or not cs.is_string:
            continue
        lane = prefix_lane_name(c.column)
        if stats.column(lane) is None:
            continue
        out.append(dataclasses.replace(c, column=lane, xform=_prefix_xform))
    return out


def build_pruner(opt: P.Plan, catalog: Catalog, raw_lits: list) -> Pruner:
    """Describe every constrained Scan's block-level skip opportunity."""
    raw_index = {id(l): i for i, l in enumerate(raw_lits)}

    def lit_ref(lit: Lit) -> tuple:
        src = lit
        while id(src) not in raw_index and getattr(src, "source", None) is not None:
            src = src.source
        if id(src) in raw_index:
            return ("raw", raw_index[id(src)])
        return ("const", lit.value)

    per_scan = _scan_constraints(opt, lit_ref)
    scan_ords = _scan_ordinals(opt)
    descs: list[_ScanDesc] = []
    for node in P.walk(opt):
        if not isinstance(node, P.Scan):
            continue
        cons = per_scan.get(id(node))
        if not cons:
            continue
        stats = harvest(catalog.get(node.dataverse, node.dataset))
        bz = stats.block_zones
        if bz is None or bz.n_blocks <= 1:
            continue  # a single block can never be skipped
        cons = _expand_string_constraints(cons, stats)
        usable = [c for c in cons if c.column in bz.spans]
        if usable:
            descs.append(_ScanDesc(scan_ords[id(node)], bz.n_blocks,
                                   dict(bz.spans), usable))
    return Pruner(descs)


# -- the planner -------------------------------------------------------------


class _PlannerCtx:
    def __init__(self, catalog: Catalog, mode: str, decisions: PruneDecisions):
        self.catalog = catalog
        self.mode = mode
        self.decisions = decisions
        self.scan_ordinals: dict[int, int] = {}

    def stats(self, dataverse: str, dataset: str) -> Optional[TableStats]:
        try:
            return harvest(self.catalog.get(dataverse, dataset))
        except KeyError:
            return None

    def scan_blocks(self, scan: P.Plan) -> Optional[tuple]:
        ordinal = self.scan_ordinals.get(id(scan))
        if ordinal is None:
            return None
        return self.decisions.block_ids(ordinal)

    @property
    def kernels(self) -> bool:
        return self.mode == "kernel"


def plan_physical(opt: P.Plan, catalog: Catalog, *, mode: str = "gspmd",
                  decisions: PruneDecisions = NO_PRUNE) -> PH.PhysOp:
    """Logical (optimized) plan → costed physical plan that reads only the
    surviving blocks of every constrained scan."""
    ctx = _PlannerCtx(catalog, mode, decisions)
    ctx.scan_ordinals = _scan_ordinals(opt)
    return _plan_terminal(opt, ctx)


# -- stream planning ---------------------------------------------------------


def _scan_stats(ctx: _PlannerCtx, node) -> Optional[TableStats]:
    return ctx.stats(node.dataverse, node.dataset)


def _plan_scan(node: P.Scan, ctx: _PlannerCtx) -> PH.PhysOp:
    stats = _scan_stats(ctx, node)
    out = PH.TableScan(node.dataverse, node.dataset)
    if stats is not None:
        out.est_rows = stats.rows
        out.rows_touched = stats.padded_rows
        out.cost = stats.padded_rows * C_ROW_SCAN
        bz = stats.block_zones
        blocks = ctx.scan_blocks(node)
        if bz is not None:
            out.set_blocks(blocks, bz.block, bz.n_blocks)
        if blocks is not None and bz is not None:
            # the lowering streams only these blocks
            frac = len(blocks) / bz.n_blocks
            out.rows_touched = min(stats.padded_rows, len(blocks) * bz.block)
            out.est_rows = max(stats.rows * frac, 1)
            out.cost = out.rows_touched * C_ROW_SCAN
            out.note = out.block_note()
    return out


def _leaf_stats(phys: PH.PhysOp, ctx: _PlannerCtx) -> Optional[TableStats]:
    for n in PH.walk(phys):
        key = getattr(n, "source_key", None)
        if key is not None:
            return ctx.stats(*key)
    return None


def _plan_stream(node: P.Plan, ctx: _PlannerCtx) -> PH.PhysOp:
    if isinstance(node, P.Scan):
        return _plan_scan(node, ctx)

    if isinstance(node, P.Filter):
        child = _plan_stream(node.children[0], ctx)
        out = PH.FullScanFilter(child, node.predicate)
        stats0 = _leaf_stats(child, ctx)
        sel = _filter_selectivity(node.predicate, stats0) if stats0 else 0.5
        out.est_rows = max(child.est_rows * sel, 1)
        out.rows_touched = child.est_rows
        out.cost = child.est_rows * 0.2
        return out

    if isinstance(node, P.Project):
        child = _plan_stream(node.children[0], ctx)
        out = PH.ProjectCols(child, node.outputs)
        out.est_rows = child.est_rows
        out.cost = child.est_rows * 0.1 * len(node.outputs)
        return out

    if isinstance(node, P.Limit):
        child = _plan_stream(node.children[0], ctx)
        out = PH.LimitRows(child, node.n)
        out.est_rows = min(node.n, child.est_rows or node.n)
        out.cost = child.est_rows * 0.1
        return out

    if isinstance(node, P.TopK):
        child = _plan_stream(node.children[0], ctx)
        out = PH.TopKSelect(child, node.key, node.k, node.ascending,
                            kernel=ctx.kernels)
        out.est_rows = min(node.k, child.est_rows or node.k)
        out.cost = child.est_rows * (C_ROW_KERNEL if ctx.kernels else C_ROW_SCAN)
        if ctx.kernels:
            out.cost += C_KERNEL_LAUNCH
            out.note = "block_topk kernel selection"
        return out

    if isinstance(node, P.Sort):
        child = _plan_stream(node.children[0], ctx)
        out = PH.SortRows(child, node.key, node.ascending)
        out.est_rows = child.est_rows
        out.cost = child.est_rows * C_ROW_SORT
        return out

    if isinstance(node, P.GroupAgg):
        return _plan_groupagg(node, ctx)

    if isinstance(node, P.Join):
        _check_join_materializable(node, ctx)
        left = _plan_stream(node.children[0], ctx)
        right = _plan_stream(node.children[1], ctx)
        out = PH.JoinGather(left, right, node.left_on, node.right_on)
        out.est_rows = left.est_rows
        out.cost = (left.est_rows + right.est_rows) * C_ROW_JOIN
        return out

    raise NotImplementedError(
        f"no physical plan for {type(node).__name__} (windows and LSM unions "
        f"wait for ROADMAP A6/A7)")


# -- join guards ----------------------------------------------------------------


def _check_join_materializable(node: P.Join, ctx: _PlannerCtx) -> None:
    """Materializing joins require unique build keys (each probe row gathers
    at most one match) — proven from catalog stats or refused."""
    for leaf in P.walk(node.children[1]):
        if not isinstance(leaf, P.Scan):
            continue
        stats = _scan_stats(ctx, leaf)
        cs = stats.column(node.right_on) if stats is not None else None
        if cs is not None and cs.distinct is not None and cs.distinct < stats.rows:
            raise NotImplementedError(
                f"materializing join on non-unique key "
                f"{node.right_on!r} (distinct={cs.distinct} < "
                f"rows={stats.rows}); COUNT over such joins is "
                "supported (join-count path)")
        return


def _join_key_int32_safe(side: P.Plan, col: str, ctx: _PlannerCtx) -> bool:
    """True when stats prove the join key casts to int32 losslessly (the
    merge_join kernel's key dtype)."""
    i32 = np.iinfo(np.int32)
    metas: list[ColumnStats] = []
    for leaf in P.walk(side):
        if isinstance(leaf, P.Scan):
            stats = _scan_stats(ctx, leaf)
            cs = stats.column(col) if stats is not None else None
            if cs is not None:
                metas.append(cs)
    if not metas:
        return False
    for m in metas:
        if m.is_string or not np.issubdtype(m.dtype, np.integer):
            return False
        if m.lo is None or m.hi is None or m.lo < i32.min or m.hi > i32.max:
            return False
    return True


# -- terminal planning -------------------------------------------------------


def _plan_terminal(node: P.Plan, ctx: _PlannerCtx) -> PH.PhysOp:
    if isinstance(node, P.FilterCount):
        return _plan_count(node, ctx)

    if isinstance(node, P.JoinCount):
        return _plan_join_count(node.children[0], node.children[1],
                                node.left_on, node.right_on, ctx)

    if isinstance(node, P.Agg):
        # COUNT over a Join must use the duplicate-correct join-count path
        # even when the optimizer was disabled (semantics ≠ optimization).
        if len(node.aggs) == 1 and node.aggs[0].op == "count" \
                and isinstance(node.children[0], P.Join):
            j = node.children[0]
            return _plan_join_count(j.children[0], j.children[1],
                                    j.left_on, j.right_on, ctx)
        child = _plan_stream(node.children[0], ctx)
        out = PH.ScalarAgg(child, node.aggs)
        out.est_rows = 1
        out.cost = child.est_rows * 0.1 * len(node.aggs)
        return out

    if isinstance(node, P.GroupAgg):
        return _plan_groupagg(node, ctx)

    return _plan_stream(node, ctx)


def _plan_count(node: P.FilterCount, ctx: _PlannerCtx) -> PH.PhysOp:
    """COUNT(pred) over one component picks the cheapest valid access path."""
    child = node.children[0]
    pred = node.predicate
    # kernel candidates may only look through IDENTITY Projects: a renaming
    # Project changes what predicate names mean
    inner = child.children[0] if _identity_project(child) else child

    candidates: list[PH.PhysOp] = []
    if ctx.kernels and isinstance(inner, P.Scan) and pred is not None:
        stats = _scan_stats(ctx, inner)
        if stats is not None:
            krc = _try_kernel_range_count(inner, pred, stats, ctx)
            if krc is not None:
                krc.est_rows = max(stats.rows * _filter_selectivity(pred, stats), 1)
                krc.rows_touched = stats.padded_rows
                if krc.block_ids is not None:
                    # the grid visits only surviving blocks
                    krc.rows_touched = min(stats.padded_rows,
                                           len(krc.block_ids) * krc.zone_block)
                    krc.est_rows = max(krc.est_rows * len(krc.block_ids)
                                       / max(krc.blocks_total, 1), 1)
                    krc.note = krc.block_note()
                krc.cost = C_KERNEL_LAUNCH + krc.rows_touched * C_ROW_KERNEL
                candidates.append(krc)

    generic = PH.MaskCount(_plan_stream(child, ctx), pred)
    gstats = _leaf_stats(generic, ctx)
    gsel = _filter_selectivity(pred, gstats) if gstats is not None else 1.0
    generic.est_rows = max((gstats.rows if gstats else 0) * gsel, 0)
    generic.rows_touched = generic.children[0].est_rows
    generic.cost = generic.children[0].est_rows * 0.05
    candidates.append(generic)

    best = min(candidates, key=lambda c: c.total_cost())
    if len(candidates) > 1:
        alts = "; ".join(f"{type(c).__name__} cost={c.total_cost():,.0f}"
                         for c in candidates if c is not best)
        best.note = (best.note + " — " if best.note else "") + \
            f"chosen over {alts}"
    return best


def _try_kernel_range_count(scan: P.Scan, pred: Expr, stats: TableStats,
                            ctx: _PlannerCtx) -> Optional[PH.KernelRangeCount]:
    """COUNT whose predicate fully decomposes into ``Col {==,>=,<=} Lit``
    conjuncts on int32-provable integer columns → filter_count kernel.
    The conjuncts are grouped by column, so each column is read once
    (``x >= a & x <= b`` is one kernel column): a ``>=`` bounds its column
    below only, a ``<=`` above only, an ``==`` both. Partial matches never
    fuse (graceful fallback to the mask path)."""
    bounds: dict[str, tuple[list[Expr], list[Expr]]] = {}
    conjuncts = _split_conjuncts(pred)
    for c in conjuncts:
        if isinstance(c, IsIn) and isinstance(c.children[0], Col):
            cs = stats.column(c.children[0].name)
            if cs is not None and cs.is_string and cs.dict_values is not None:
                raise NotImplementedError(_STRING_FAST_PATH)
    for c in conjuncts:
        if not isinstance(c, Compare):
            return None
        l, r = c.children
        if not (isinstance(l, Col) and isinstance(r, Lit)):
            return None
        cs = stats.column(l.name)
        if cs is None:
            return None
        if cs.is_string:
            if c.op == "==" and isinstance(r.value, str) \
                    and cs.dict_values is not None:
                raise NotImplementedError(_STRING_FAST_PATH)
            return None
        if not np.issubdtype(cs.dtype, np.integer):
            return None
        # the kernel evaluates on int32 tiles: column bounds must prove the
        # cast lossless, or wider-int values wrap and counts corrupt
        if cs.lo is None or cs.hi is None \
                or cs.lo < _RANGE_MIN or cs.hi > _RANGE_MAX:
            return None
        if not isinstance(r.value, (int, np.integer)):
            return None
        if c.op == "==":
            # never alias one Lit as both bounds (a point and a range plan
            # share a physical fingerprint, so the two param slots must map
            # to two distinct Lit objects)
            lo, hi = [r], [Lit(r.value, source=r)]
        elif c.op == ">=":
            lo, hi = [r], []
        elif c.op == "<=":
            lo, hi = [], [r]
        else:  # strict bounds / != : conservative, stay on the mask path
            return None
        col_los, col_his = bounds.setdefault(l.name, ([], []))
        col_los.extend(lo)
        col_his.extend(hi)
    ds = ctx.catalog.get(scan.dataverse, scan.dataset)
    out = PH.KernelRangeCount(scan.dataverse, scan.dataset, list(bounds),
                              [lo for lo, _ in bounds.values()],
                              [hi for _, hi in bounds.values()],
                              "__valid__" in ds.table.columns)
    bz = stats.block_zones
    if bz is not None:
        out.set_blocks(ctx.scan_blocks(scan), bz.block, bz.n_blocks)
    return out


def _plan_join_count(lnode: P.Plan, rnode: P.Plan, left_on: str, right_on: str,
                     ctx: _PlannerCtx) -> PH.PhysOp:
    left = _plan_stream(lnode, ctx)
    right = _plan_stream(rnode, ctx)
    kernel = ctx.kernels and _join_key_int32_safe(lnode, left_on, ctx) \
        and _join_key_int32_safe(rnode, right_on, ctx)
    out = PH.JoinCountOp(left, right, left_on, right_on, kernel=kernel)
    n = left.est_rows + right.est_rows
    out.est_rows = 1
    out.cost = C_KERNEL_LAUNCH + n * C_ROW_KERNEL if kernel else n * C_ROW_JOIN
    if kernel:
        out.note = "int32-safety proven from stats: merge_join kernel"
    return out


# -- group-by planning -------------------------------------------------------


def _group_domain(phys_child: PH.PhysOp, key: str, ctx: _PlannerCtx):
    """(lo, num_groups) of the bounded-domain group-by, from the first
    physical leaf whose stats bound the key."""
    for leaf in PH.walk(phys_child):
        skey = getattr(leaf, "source_key", None)
        if skey is None:
            continue
        stats = ctx.stats(*skey)
        cs = stats.column(key) if stats is not None else None
        if cs is not None and cs.lo is not None and cs.hi is not None:
            return int(cs.lo), int(cs.hi - cs.lo + 1)
    raise ValueError(
        f"group key {key!r} has no domain statistics; bounded-domain group-by "
        "requires catalog lo/hi (Wisconsin columns carry them)")


def _trace_col(node: P.Plan, col: str, ctx: _PlannerCtx) -> Optional[ColumnStats]:
    """The ColumnStats a stream column name originates from, following
    Project renames and join name resolution; None when provenance cannot be
    established (computed expressions, suffixed join collisions)."""
    if isinstance(node, P.Scan):
        stats = _scan_stats(ctx, node)
        return stats.column(col) if stats is not None else None
    if isinstance(node, P.Project):
        for name, e in node.outputs:
            if name == col:
                if isinstance(e, Col):
                    return _trace_col(node.children[0], e.name, ctx)
                return None
        return None
    if isinstance(node, P.Join):
        left_meta = _trace_col(node.children[0], col, ctx)
        if left_meta is not None:
            return left_meta
        return _trace_col(node.children[1], col, ctx)
    if len(node.children) == 1:
        return _trace_col(node.children[0], col, ctx)
    return None


def _kernel_groupagg_exact(node: P.GroupAgg, ctx: _PlannerCtx, aggs) -> bool:
    """The f32-exactness gate: the segment_agg kernel computes in float32,
    bit-identical to the generic path only when every per-group result is an
    exactly-representable integer — counts need n < 2^24; sum/mean need
    integer value columns whose bounds prove n * max|value| < 2^24; max/min
    only need the values representable. Provenance is traced to the origin
    table."""
    leaf_stats = [_scan_stats(ctx, l) for l in P.walk(node)
                  if isinstance(l, P.Scan)]
    leaf_stats = [s for s in leaf_stats if s is not None]
    if not leaf_stats:
        return False
    n = sum(s.padded_rows for s in leaf_stats)
    if n >= _F32_EXACT:
        return False
    for _, op, col in aggs:
        if op == "count":
            continue
        m = _trace_col(node.children[0], col, ctx)
        if m is None or m.is_string or not np.issubdtype(m.dtype, np.integer):
            return False
        if m.lo is None or m.hi is None:
            return False
        maxabs = max(abs(int(m.lo)), abs(int(m.hi)))
        bound = maxabs if op in ("max", "min") else n * maxabs
        if bound >= _F32_EXACT:
            return False
    return True


def _plan_groupagg(node: P.GroupAgg, ctx: _PlannerCtx) -> PH.PhysOp:
    assert len(node.keys) == 1, "single-key group-by (paper expressions 4/8)"
    key = node.keys[0]
    key_stats = _trace_col(node.children[0], key, ctx)
    if key_stats is not None and key_stats.is_string \
            and key_stats.dict_values is not None:
        raise NotImplementedError(_STRING_FAST_PATH)
    child = _plan_stream(node.children[0], ctx)
    lo, num_groups = _group_domain(child, key, ctx)
    aggs = [(s.out_name, s.op, s.column) for s in node.aggs]

    if ctx.kernels and _kernel_groupagg_exact(node, ctx, aggs):
        out = PH.KernelSegmentAgg([child], key, lo, num_groups, node.aggs)
        # hoist the surviving-block list off the TableScan into the
        # segment_agg grid: the stream feeds full-length columns (no gather
        # copy) and the kernel skips pruned tiles — rows there are already
        # masked out by the filter the list was derived from
        scans = [s for s in PH.walk(child) if isinstance(s, PH.TableScan)
                 and s.block_ids is not None]
        out.comp_blocks = (None,)
        if len(scans) == 1:
            s = scans[0]
            out.comp_blocks = (s.block_ids,)
            out.note = (f"zone maps: {len(s.block_ids)}/{s.blocks_total} "
                        f"block(s) in the segment_agg grid, "
                        f"{s.blocks_total - len(s.block_ids)} skipped — ")
            s.block_ids = None  # the kernel grid skips, not the stream
        out.est_rows = num_groups
        out.cost = child.est_rows * C_ROW_KERNEL + C_KERNEL_LAUNCH
        out.note += "f32 exactness proven from stats: segment_agg kernel"
        return out

    out = PH.GroupAggGeneric(child, key, lo, num_groups, node.aggs)
    out.est_rows = num_groups
    out.cost = child.est_rows * C_ROW_GROUP + num_groups
    return out
