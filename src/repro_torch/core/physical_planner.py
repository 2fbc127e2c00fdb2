"""Cost-based physical planner: optimized logical plan → physical plan
(port of ``repro.core.physical_planner``).

The logical optimizer (core/optimizer.py) only *rewrites* (filter fusion,
limit pushdown, feed expansion, union pushdown); every access-path and
execution-strategy decision is made here, by comparing estimated costs from
the statistics layer (core/stats.py):

  * COUNT over a predicate — ``IndexOnlyCount`` (two binary searches) vs.
    ``KernelRangeCount`` (fused filter_count launch) vs. ``MaskCount``
    (generic full scan): the planner costs all valid candidates and keeps
    the cheapest.
  * GroupAgg — ``KernelSegmentAgg`` (segment_agg kernel, gated on a static
    f32-exactness proof) vs. ``GroupAggGeneric``.
  * JoinCount — merge_join kernel (int32-safety proof) vs. generic
    sort+searchsorted, presorted build side detected from index stats.
  * LSM unions — **zone-map run pruning**: at bind time, every run whose
    column zone span ``[lo, hi]`` misses the bound predicate range is
    dropped from the plan entirely (``PrunedUnionRuns``/``MergeScalars``
    record the rationale). Pruning never changes results: a pruned run
    provably contributes zero live rows.

Pruning depends on *literal values* (runtime parameters), so it cannot be
baked into the optimized-plan cache entry. The split:

  * ``build_pruner`` runs once per (logical plan, stats epoch): it extracts
    the prunable-union descriptors (component zone spans + the literal slots
    that bound each column).
  * ``Pruner.decide`` runs per execution with the fresh literal values —
    a few interval overlap tests — and yields the **prune signature** the
    Session's third cache level is keyed by, plus the per-run rationale.

Everything else in the cost model is deterministic given (logical
fingerprint, stats epoch, prune signature) — selectivities come from
distinct counts and default fractions, never from literal values — so a
cached query is always the one this planner would rebuild.

String ``==`` / ``IN`` on a dictionary-encoded column lower onto
filter_count over the ``__dict_<col>`` id lane, and a string group-by onto
the integer group-by over union-dictionary ids (``DictRemapCols``). On a
mesh the block ids live in the per-shard zone layout (``BlockZones``), and
scan nodes carry that layout to the lowering.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core import physical as PH
from repro_torch.core import plan as P
from repro_torch.core.catalog import Catalog
from repro_torch.core.expr import BoolOp, Col, Compare, Expr, IsIn, Lit
from repro_torch.core.optimizer import (_RANGE_MAX, _RANGE_MIN, _range_bounds,
                                        _split_conjuncts)
from repro_torch.core.stats import ColumnStats, TableStats, harvest
from repro_torch.core.window import Window
from repro_torch.engine.table import (canon_string, dict_lane_name,
                                      encode_strings, pack_prefix,
                                      prefix_lane_name)
from repro_torch.runtime import telemetry as tel

# -- cost model --------------------------------------------------------------
# Units: ~relative per-row work of a generic masked scan. The absolute scale
# is irrelevant; only ratios steer the plan choice.

C_ROW_SCAN = 1.0       # generic stream: evaluate predicate columns, mask
C_ROW_KERNEL = 0.35    # fused kernel row (single pass, no mask in memory)
C_ROW_GROUP = 2.0      # segment reduction per row
C_ROW_SORT = 8.0       # full-sort per row (n log n folded into the constant)
C_ROW_JOIN = 4.0       # sort+searchsorted join per row
C_KERNEL_LAUNCH = 64.0  # fixed per kernel launch
C_PROBE = 24.0         # one binary-search probe pair (per component)
C_TOMBSTONE = 0.05     # per anti-matter key: one probe pair in a batched
#                        searchsorted (visibility masks / shadow subtraction)

DEFAULT_EQ_SELECTIVITY = 0.1
DEFAULT_RANGE_SELECTIVITY = 0.33
_F32_EXACT = 1 << 24   # ints in [-2^24, 2^24] are exact in float32

# Read-amplification thresholds (the mutation follow-up): a query over a fed
# dataset pays one access-path probe per component plus one batched probe per
# retained tombstone. When either grows past these bounds the per-query tax
# exceeds what one compaction would amortize — explain() says so.
READ_AMP_COMPONENTS = 6        # components probed per query
READ_AMP_TOMBSTONE_FRAC = 0.25  # tombstones / visible rows

# Write-stall early warning: the ingest path hard-stalls writers at
# ~2× max_runs resident components (Feed.stall_runs). The planner sees the
# same component count through its probe charge, so it can warn *before*
# the cap: stall pressure = components probed / STALL_COMPONENT_CAP, with a
# note once pressure crosses STALL_WARN_FRAC.
STALL_COMPONENT_CAP = 2 * READ_AMP_COMPONENTS
STALL_WARN_FRAC = 0.75

def _conjunct_selectivity(c: Expr, stats: TableStats) -> float:
    """Deterministic textbook selectivity from stats alone (literal values
    are runtime params — the executable must not depend on them)."""
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


# -- bind-time zone-map pruning ----------------------------------------------


def _prefix_xform(v):
    """Bind-time transform for string constraints routed through a
    ``__pfx_<col>`` lane: the big-endian pack of the literal's first
    PREFIX_BYTES encoded bytes. Order-preserving over the space-padded
    encoding, so span tests against prefix-lane zone maps are conservative-
    correct for ==/IN (a prefix miss proves the full string cannot match).
    Non-string values return None — the constraint then simply doesn't
    apply (literal rebinding may swap a string for an int)."""
    if not isinstance(v, str):
        return None
    return int(pack_prefix(encode_strings([v]))[0])


@dataclasses.dataclass(frozen=True)
class _Constraint:
    """One ``col <op> lit`` conjunct constraining a union component. ``ref``
    resolves the literal at bind time: ("raw", i) reads the i-th literal of
    the raw plan, ("const", v) is a plan constant. Op "in" carries a
    ("many", (ref, ...)) set — it excludes only when EVERY member misses.
    ``xform`` (prefix-lane twins) maps each resolved value into the lane's
    integer domain before the interval tests."""

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

    def excludes(self, span: tuple, v) -> bool:
        """True when the component's zone span proves zero matching rows."""
        lo, hi = span
        if self.op == "==":
            return v < lo or v > hi
        if self.op == "in":
            return all(x < lo or x > hi for x in v)
        if self.op == ">=":
            return hi < v
        if self.op == ">":
            return hi <= v
        if self.op == "<=":
            return lo > v
        if self.op == "<":
            return lo >= v
        return False

    def block_keep(self, spans: np.ndarray, v) -> np.ndarray:
        """Vectorized per-block form of (not excludes): ``spans`` is the
        (n_blocks, 2) [lo, hi] zone-map array; returns the boolean keep mask.
        Empty blocks carry the [max, min] sentinel and fail every test."""
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

    def bound_repr(self, v) -> tuple:
        if self.op == "in":
            return (min(v), max(v)) if v else ("∅", "∅")
        return {"==": (v, v), ">=": (v, "+∞"), ">": (f">{v}", "+∞"),
                "<=": ("-∞", v), "<": ("-∞", f"<{v}")}[self.op]


@dataclasses.dataclass
class _CompDesc:
    address: str
    rows: int
    spans: dict[str, tuple]
    constraints: list[_Constraint]
    prunable: bool
    tombstones: int = 0  # anti-matter the component retains even when its
    #                      matter is pruned (key-visibility reasoning: a span
    #                      miss proves zero visible MATTER, never zero
    #                      annihilation into older components)


@dataclasses.dataclass
class _UnionDesc:
    ordinal: int
    comps: list[_CompDesc]


@dataclasses.dataclass
class _ScanDesc:
    """Block-skip opportunity for one Scan site: its component's per-block
    zone maps plus the provenance-proven ``col <op> lit`` conjuncts applied
    above it. The second level of the pruning hierarchy — run-level pruning
    drops whole components, this refines what survives down to blocks."""

    ordinal: int                 # scan ordinal (walk order over the opt plan)
    address: str
    n_blocks: int
    zone_block: int
    spans: dict                  # column -> (n_blocks, 2) zone array
    constraints: list[_Constraint]
    n_shards: int = 1            # mesh row partitions the layout was built for
    rows_per_shard: int = 0


@dataclasses.dataclass
class _InDesc:
    """A dictionary-lane IN count at one Scan site (the shape
    ``_try_kernel_isin_count`` lowers to one launch per member): the
    component's dictionary positions, its dict-lane block spans and the
    members' literal refs."""

    ordinal: int
    pos: dict
    lane_spans: np.ndarray
    refs: tuple


class PruneDecisions:
    """Bind-time pruning outcome: per union ordinal, the surviving component
    indices and the zone-map rationale for each dropped run; per scan
    ordinal, the surviving block-id list of the intra-component refinement,
    and for a dictionary-lane IN count each member's own block list and
    bound value. ``signature`` keys the Session's third cache level — block
    lists are in it because they are static plan structure (kernel grids /
    gather slices bake them in)."""

    def __init__(self, by_union: dict[int, tuple[tuple, tuple]],
                 blocks: Optional[dict] = None,
                 member_blocks: Optional[dict] = None,
                 member_values: Optional[dict] = None):
        self.by_union = by_union
        self.blocks = blocks or {}
        self.member_blocks = member_blocks or {}
        self.member_values = member_values or {}
        self.signature = (
            tuple(sorted((k, tuple(surv))
                         for k, (surv, _) in by_union.items())),
            tuple(sorted(self.blocks.items())),
            tuple(sorted(self.member_blocks.items())))

    def surviving(self, ordinal: int, n: int) -> tuple:
        if ordinal not in self.by_union:
            return tuple(range(n))
        return self.by_union[ordinal][0]

    def pruned(self, ordinal: int) -> tuple:
        if ordinal not in self.by_union:
            return ()
        return self.by_union[ordinal][1]

    def block_ids(self, scan_ordinal: int) -> Optional[tuple]:
        return self.blocks.get(scan_ordinal)


NO_PRUNE = PruneDecisions({})


def _numeric(v) -> bool:
    """Bind-time type gate for the interval tests: a scalar number, or (op
    "in") a non-empty tuple of numbers. A rebound literal of any other type
    (or an xform that refused it) silently opts the constraint out."""
    if isinstance(v, tuple):
        return len(v) > 0 and all(_numeric(x) for x in v)
    return isinstance(v, (int, float, np.integer, np.floating))


class Pruner:
    """Extracted once per (optimized plan, stats epoch); ``decide`` is the
    cheap per-execution pass (pure interval arithmetic on python scalars,
    plus one O(n_blocks) vector test per constrained scan)."""

    def __init__(self, unions: list[_UnionDesc],
                 scans: Optional[list[_ScanDesc]] = None,
                 isins: Optional[list[_InDesc]] = None):
        self.unions = unions
        self.scans = scans or []
        self.isins = isins or []

    @property
    def has_prunable(self) -> bool:
        return any(c.prunable and c.constraints for u in self.unions
                   for c in u.comps)

    def decide(self, raw_values: list,
               block_skip: bool = True) -> PruneDecisions:
        by_union: dict[int, tuple[tuple, tuple]] = {}
        for u in self.unions:
            surviving: list[int] = []
            pruned: list[PH.PrunedComponent] = []
            for i, comp in enumerate(u.comps):
                record = None
                if comp.prunable:
                    for con in comp.constraints:
                        span = comp.spans.get(con.column)
                        if span is None:
                            continue
                        v = con.value(raw_values)
                        if v is None or not _numeric(v):
                            continue
                        if con.excludes(span, v):
                            record = PH.PrunedComponent(
                                address=comp.address, column=con.column,
                                span=span, bound=con.bound_repr(v),
                                rows=comp.rows, tombstones=comp.tombstones)
                            break
                if record is None:
                    surviving.append(i)
                else:
                    pruned.append(record)
            if not surviving:
                # keep the first component: the merged identity result
                # (count 0 / ±inf extremes) must still be computed on-device,
                # bit-identical to the unpruned all-empty execution.
                surviving = [0]
                pruned = [r for r in pruned if r.address != u.comps[0].address]
            by_union[u.ordinal] = (tuple(surviving), tuple(pruned))
        blocks: dict[int, tuple] = {}
        for d in self.scans if block_skip else ():
            keep = np.ones(d.n_blocks, bool)
            applied = False
            for con in d.constraints:
                spans = d.spans.get(con.column)
                if spans is None:
                    continue
                v = con.value(raw_values)
                if v is None or not _numeric(v):
                    continue
                applied = True
                keep &= con.block_keep(spans, v)
            if not applied or keep.all():
                continue
            ids = tuple(int(b) for b in np.nonzero(keep)[0])
            # keep at least one block: a zero-size kernel grid never
            # initializes its accumulator, and downstream static shapes
            # need >= 1 row. An extra surviving block never changes the
            # result — its rows simply fail the predicate.
            blocks[d.ordinal] = ids if ids else (0,)
        member_blocks: dict[int, tuple] = {}
        member_values: dict[int, tuple] = {}
        for d in self.isins:
            # each member's launch visits only the blocks whose dict-id span
            # holds ITS id (a duplicate or absent member binds the empty
            # range; the min-one-block guard keeps its grid non-empty).
            # Computed from THIS binding's members, so a rebind with other
            # members replans instead of reusing another binding's grids.
            cur = tuple(raw_values[v] if k == "raw" else v for k, v in d.refs)
            if not all(isinstance(v, str) for v in cur):
                continue
            cands = blocks.get(d.ordinal, range(d.lane_spans.shape[0]))
            lists = []
            for j in range(len(cur)):
                blo, bhi = _isin_binders(d.pos, j)
                mlo, mhi = blo(*cur), bhi(*cur)
                lists.append(tuple(b for b in cands
                                   if d.lane_spans[b, 0] <= mhi
                                   and mlo <= d.lane_spans[b, 1]) or (0,))
            member_blocks[d.ordinal] = tuple(lists)
            member_values[d.ordinal] = cur
        return PruneDecisions(by_union, blocks, member_blocks, member_values)


def _origin_column(node: P.Plan, name: str) -> Optional[str]:
    """Resolve a stream column name at ``node``'s output down to the STORED
    column it reads, following pure ``Col`` Project rebindings. None when the
    name is computed (UDF/arith) or shadowed — a predicate on such a column
    must never be matched against catalog spans by name (``df["k"] =
    df["v"]`` rebinds the name k to v's values; k's stored span is a lie)."""
    if isinstance(node, P.Scan):
        return name
    if isinstance(node, P.Project):
        for n, e in node.outputs:
            if n == name:
                if isinstance(e, Col):
                    return _origin_column(node.children[0], e.name)
                return None
        return None
    if isinstance(node, Window) and name == node.out_name:
        return None  # computed analytic column shadows any stored namesake
    if len(node.children) == 1:  # filter/limit/sort/window pass through
        return _origin_column(node.children[0], name)
    return None


def _identity_project(node: P.Plan) -> bool:
    """True for the narrow Projects column pruning inserts: every output is
    the same-named stored column (no renames, no computed expressions) — the
    only Project shape access-path planning may safely look through."""
    return isinstance(node, P.Project) and all(
        isinstance(e, Col) and e.name == n for n, e in node.outputs)


def _union_ordinals(opt: P.Plan) -> dict[int, int]:
    """Union nodes numbered in walk order — build_pruner and plan_physical
    must agree on the numbering."""
    out: dict[int, int] = {}
    for node in P.walk(opt):
        if isinstance(node, (P.UnionRuns, P.UnionScalar)):
            out[id(node)] = len(out)
    return out


def _scan_ordinals(opt: P.Plan) -> dict[int, int]:
    """Scan nodes numbered in walk order — the block-skip decisions are
    keyed by these, and build_pruner / plan_physical walk the same plan
    object so the numbering agrees."""
    out: dict[int, int] = {}
    for node in P.walk(opt):
        if isinstance(node, P.Scan):
            out[id(node)] = len(out)
    return out


def _scan_constraints(opt: P.Plan, lit_ref) -> dict[int, list[_Constraint]]:
    """Provenance-proven ``col <op> lit`` conjuncts per Scan site: a
    Filter/FilterCount contributes its conjuncts to the Scan it reaches
    through ROW-WISE nodes only (more Filters, Projects — renames resolved
    by ``_origin_column``; a rebound name never constrains the stored
    column). Anything positional between the filter and the scan (Limit,
    TopK, Sort+Limit, Window, a union, a join) breaks the chain: those
    operators consume rows by position, so pruning rows the *later* filter
    would drop could change which rows they emit."""
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
        scan = cur
        for c in _split_conjuncts(pred):
            if isinstance(c, IsIn):
                l = c.children[0]
                if isinstance(l, Col) and c.values \
                        and all(isinstance(v, Lit) for v in c.values):
                    origin = _origin_column(node.children[0], l.name)
                    if origin is not None:
                        out.setdefault(id(scan), []).append(_Constraint(
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
                out.setdefault(id(scan), []).append(
                    _Constraint(origin, c.op, lit_ref(r)))
    return out


def _expand_string_constraints(cons, stats: TableStats) -> list[_Constraint]:
    """String ==/IN conjuncts prune through the ``__pfx_<col>`` lane: emit a
    twin constraint on the lane with the prefix-pack bind-time transform.
    Component-independent by construction (the pack is a pure function of
    the literal), unlike dict ids, which are per-component — so prefix lanes
    are the ONLY string pruning route here."""
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


def build_pruner(opt: P.Plan, catalog: Catalog, raw_lits: list,
                 n_shards: int = 1) -> Pruner:
    """Walk the optimized plan's LSM unions and describe every component's
    prune opportunity: its zone spans plus the ``col <op> lit`` conjuncts
    (from the pushed-down per-component filters) that bound it. A second
    pass describes every constrained Scan's *block-level* opportunity (the
    per-ZONE_BLOCK zone maps harvested at load/flush time) — including
    scans of plain, non-fed datasets, which have no run to prune but whole
    kernel tiles to skip.

    ``n_shards`` is the session mesh's row-partition count: a scan's block
    zones are usable only when harvested for the SAME layout (flat block
    ids address per-shard local tiles, so another layout would skip the
    wrong rows). A component harvested for another layout opts out of
    block skipping; run-level pruning is unaffected."""
    raw_index = {id(l): i for i, l in enumerate(raw_lits)}

    def lit_ref(lit: Lit) -> tuple:
        src = lit
        while id(src) not in raw_index and getattr(src, "source", None) is not None:
            src = src.source
        if id(src) in raw_index:
            return ("raw", raw_index[id(src)])
        return ("const", lit.value)

    per_scan = _scan_constraints(opt, lit_ref)
    unions: list[_UnionDesc] = []
    ordinals = _union_ordinals(opt)
    for node in P.walk(opt):
        if not isinstance(node, (P.UnionRuns, P.UnionScalar)):
            continue
        comps: list[_CompDesc] = []
        for child in node.children:
            scans = [n for n in P.walk(child) if isinstance(n, P.Scan)]
            if len(scans) != 1:
                comps.append(_CompDesc("?", 0, {}, [], prunable=False))
                continue
            scan = scans[0]
            try:
                stats = harvest(catalog.get(scan.dataverse, scan.dataset))
            except KeyError:
                comps.append(_CompDesc("?", 0, {}, [], prunable=False))
                continue
            spans = {name: cs.span for name, cs in stats.columns.items()
                     if cs.span is not None and not cs.is_string}
            cons_all = _expand_string_constraints(
                per_scan.get(id(scan), ()), stats)
            constraints = [c for c in cons_all if c.column in spans]
            comps.append(_CompDesc(stats.address, stats.rows, spans,
                                   constraints, prunable=True,
                                   tombstones=stats.tombstones))
        unions.append(_UnionDesc(ordinals[id(node)], comps))
    scan_descs: list[_ScanDesc] = []
    scan_ords = _scan_ordinals(opt)
    for node in P.walk(opt):
        if not isinstance(node, P.Scan):
            continue
        cons = per_scan.get(id(node))
        if not cons:
            continue
        try:
            stats = harvest(catalog.get(node.dataverse, node.dataset))
        except KeyError:
            continue
        bz = stats.block_zones
        if bz is None or bz.n_blocks <= 1:
            continue  # a single block can never be skipped
        if bz.n_shards != max(n_shards, 1):
            continue  # zone layout predates the mesh: ids would be wrong
        cons = _expand_string_constraints(cons, stats)
        usable = [c for c in cons if c.column in bz.spans]
        if usable:
            scan_descs.append(_ScanDesc(scan_ords[id(node)], stats.address,
                                        bz.n_blocks, bz.block, dict(bz.spans),
                                        usable, bz.n_shards,
                                        bz.rows_per_shard))
    return Pruner(unions, scan_descs,
                  _isin_descs(opt, catalog, lit_ref, scan_ords, n_shards))


def _isin_descs(opt: P.Plan, catalog: Catalog, lit_ref,
                scan_ords: dict, n_shards: int = 1) -> list[_InDesc]:
    """Every COUNT of one string ``col IN [...]`` straight over a Scan (an
    identity Project between, as ``_plan_count`` allows) whose component
    dictionary-encodes ``col`` and has its lane's block zones."""
    out: list[_InDesc] = []
    for node in P.walk(opt):
        if not isinstance(node, P.FilterCount) or node.predicate is None:
            continue
        inner = node.children[0]
        if _identity_project(inner):
            inner = inner.children[0]
        conjuncts = _split_conjuncts(node.predicate)
        if not isinstance(inner, P.Scan) or len(conjuncts) != 1 \
                or not isinstance(conjuncts[0], IsIn):
            continue
        col, vals = conjuncts[0].children[0], conjuncts[0].values
        if not (isinstance(col, Col) and vals
                and all(isinstance(v, Lit) for v in vals)):
            continue
        try:
            stats = harvest(catalog.get(inner.dataverse, inner.dataset))
        except KeyError:
            continue
        bz = stats.block_zones
        lane = dict_lane_name(col.name)
        if bz is None or _dict_lane_stats(stats, col.name) is None \
                or bz.span_of(lane) is None or bz.n_shards != max(n_shards, 1):
            continue
        values = stats.column(col.name).dict_values
        out.append(_InDesc(scan_ords[id(inner)],
                           {v: i for i, v in enumerate(values)},
                           np.asarray(bz.span_of(lane)),
                           tuple(lit_ref(v) for v in vals)))
    return out


# -- the planner -------------------------------------------------------------


class _PlannerCtx:
    def __init__(self, catalog: Catalog, mode: str, decisions: PruneDecisions,
                 enable_index: bool):
        self.catalog = catalog
        self.mode = mode
        self.decisions = decisions
        self.enable_index = enable_index
        self.ordinals: dict[int, int] = {}
        self.scan_ordinals: dict[int, int] = {}

    def stats(self, dataverse: str, dataset: str) -> Optional[TableStats]:
        try:
            return harvest(self.catalog.get(dataverse, dataset))
        except KeyError:
            return None

    def scan_blocks(self, scan: P.Plan) -> Optional[tuple]:
        """Surviving block ids of the bind-time block zone-map test for this
        Scan site (None = no skipping)."""
        ordinal = self.scan_ordinals.get(id(scan))
        if ordinal is None:
            return None
        return self.decisions.block_ids(ordinal)

    @property
    def kernels(self) -> bool:
        return self.mode == "kernel"


def plan_physical(opt: P.Plan, catalog: Catalog, *, mode: str = "gspmd",
                  decisions: PruneDecisions = NO_PRUNE,
                  enable_index: bool = True) -> PH.PhysOp:
    """Logical (optimized) plan → costed physical plan. ``decisions`` is the
    bind-time pruning outcome; the returned plan reads only surviving
    components, and only their surviving blocks. ``enable_index=False``
    leaves every index access path out of the candidates."""
    ctx = _PlannerCtx(catalog, mode, decisions, enable_index)
    ctx.ordinals = _union_ordinals(opt)
    ctx.scan_ordinals = _scan_ordinals(opt)
    return _plan_terminal(opt, ctx)


# -- stream planning ---------------------------------------------------------


def _scan_stats(ctx: _PlannerCtx, node) -> Optional[TableStats]:
    return ctx.stats(node.dataverse, node.dataset)


def _component_shadow(ctx: _PlannerCtx, dataverse: str, dataset: str):
    """Anti-matter shadowing info for one LSM component: the primary key the
    visibility probes compare on, the strictly-newer components that hold
    tombstones (their anti sets must subtract from this component), and the
    total tombstone count (for costing). Newest-wins is an ORDER property:
    base < run0 < run1 < …, and only newer anti-matter annihilates."""
    base_name = dataset.split("@")[0]
    try:
        comps = ctx.catalog.components(dataverse, base_name)
    except KeyError:
        return None, (), 0
    primary = comps[0].primary_index
    if primary is None or len(comps) == 1:
        return (primary.column if primary is not None else None), (), 0
    # locate this component by its stable address IN the bound manifest's
    # order — uids are creation-ordered, not positional, so "newer than"
    # is a position property of the pinned component tuple
    names = [c.name for c in comps]
    try:
        ordinal = names.index(dataset) if "@" in dataset else 0
    except ValueError:  # address not served by this manifest
        return primary.column, (), 0
    sources: list[tuple[str, str]] = []
    total = 0
    for r in comps[ordinal + 1:]:
        if r.anti_rows:
            sources.append((dataverse, r.name))
            total += r.anti_rows
    return primary.column, tuple(sources), total


def _plan_scan(node: P.Scan, ctx: _PlannerCtx) -> PH.PhysOp:
    stats = _scan_stats(ctx, node)
    ds = ctx.catalog.get(node.dataverse, node.dataset)
    key_col, shadow, n_anti = _component_shadow(ctx, node.dataverse,
                                                node.dataset)
    out = PH.TableScan(node.dataverse, node.dataset, open_cast=not ds.closed,
                       key_col=key_col if shadow else None,
                       shadow_sources=shadow)
    if stats is not None:
        out.est_rows = stats.rows
        out.rows_touched = stats.padded_rows
        out.cost = stats.padded_rows * C_ROW_SCAN + n_anti * C_TOMBSTONE
        bz = stats.block_zones
        blocks = ctx.scan_blocks(node)
        if bz is not None:
            out.set_blocks(blocks, bz.block, bz.n_blocks,
                           n_shards=bz.n_shards,
                           rows_per_shard=bz.rows_per_shard)
        if blocks is not None and bz is not None:
            # discount the scan by the surviving fraction: the lowering
            # streams only these blocks (skipped blocks provably hold no
            # rows passing the conjuncts the list was derived from).
            frac = len(blocks) / bz.n_blocks
            out.rows_touched = min(stats.padded_rows,
                                   len(blocks) * bz.block)
            out.est_rows = max(stats.rows * frac, 1)
            out.cost = out.rows_touched * C_ROW_SCAN + n_anti * C_TOMBSTONE
            out.note = out.block_note()
    if shadow:
        note = (f"newest-wins: {n_anti} tombstone(s) in "
                f"{len(shadow)} newer component(s) subtract from this "
                f"scan's mask")
        out.note = (out.note + " — " if out.note else "") + note
    return out


def _plan_filter(node: P.Filter, ctx: _PlannerCtx) -> PH.PhysOp:
    """Stream filter: an ``IndexProbe`` access path when an indexed column is
    range-bound (remaining conjuncts stay residual), generic mask otherwise.
    Both stream every physical row — the probe's value is the tighter
    cardinality estimate it gives operators above (and the count path)."""
    inner = node.children[0]
    proj = None
    if _identity_project(inner) and isinstance(inner.children[0], P.Scan):
        # look through the narrow Project column pruning inserted (identity
        # outputs only — a renaming Project would change what names mean)
        proj, inner = inner, inner.children[0]
    if ctx.enable_index and isinstance(inner, P.Scan):
        stats = _scan_stats(ctx, inner)
        if stats is not None:
            conjuncts = _split_conjuncts(node.predicate)
            for colname, cs in stats.columns.items():
                if cs.index is None:
                    continue
                found = _range_bounds(conjuncts, colname)
                if found is None:
                    continue
                lo, hi, residual = found
                res_expr = None
                for r in residual:
                    res_expr = r if res_expr is None else BoolOp("AND", res_expr, r)
                ds = ctx.catalog.get(inner.dataverse, inner.dataset)
                key_col, shadow, n_anti = _component_shadow(
                    ctx, inner.dataverse, inner.dataset)
                probe = PH.IndexProbe(inner.dataverse, inner.dataset, colname,
                                      lo, hi, res_expr, open_cast=not ds.closed,
                                      key_col=key_col if shadow else None,
                                      shadow_sources=shadow)
                probe.est_rows = max(
                    stats.rows * _filter_selectivity(node.predicate, stats), 1)
                probe.rows_touched = stats.padded_rows
                probe.cost = stats.padded_rows * C_ROW_SCAN \
                    + n_anti * C_TOMBSTONE
                probe.note = f"index {cs.index}:{colname} bounds the stream"
                bz = stats.block_zones
                blocks = ctx.scan_blocks(inner)
                if bz is not None:
                    probe.set_blocks(blocks, bz.block, bz.n_blocks,
                                     n_shards=bz.n_shards,
                                     rows_per_shard=bz.rows_per_shard)
                if blocks is not None and bz is not None:
                    # literal-aware refinement: the bind-time zone test
                    # already intersected the predicate's literals with the
                    # per-block spans, so the surviving-block fraction is a
                    # tighter (and signature-stable — block lists are in the
                    # prune signature) selectivity than the stats default.
                    frac = len(blocks) / bz.n_blocks
                    probe.rows_touched = min(stats.padded_rows,
                                             len(blocks) * bz.block)
                    probe.est_rows = max(min(probe.est_rows,
                                             stats.rows * frac), 1)
                    probe.cost = probe.rows_touched * C_ROW_SCAN \
                        + n_anti * C_TOMBSTONE
                    probe.note += " — " + probe.block_note()
                if shadow:
                    probe.note += (f" — {n_anti} newer tombstone(s) subtract "
                                   f"from the mask")
                if proj is None:
                    return probe
                # mask-then-project ≡ project-then-mask for identity outputs
                out = PH.ProjectCols(probe, proj.outputs)
                out.est_rows = probe.est_rows
                out.cost = probe.est_rows * 0.1 * len(proj.outputs)
                return out
    child = _plan_stream(node.children[0], ctx)
    out = PH.FullScanFilter(child, node.predicate)
    stats0 = _leaf_stats(child, ctx)
    sel = _filter_selectivity(node.predicate, stats0) if stats0 else 0.5
    out.est_rows = max(child.est_rows * sel, 1)
    out.rows_touched = child.est_rows
    out.cost = child.est_rows * 0.2
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
        return _plan_filter(node, ctx)

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

    if isinstance(node, Window):
        child = _plan_stream(node.children[0], ctx)
        out = PH.WindowEval(child, node)
        out.est_rows = child.est_rows
        out.cost = child.est_rows * C_ROW_SORT
        return out

    if isinstance(node, P.UnionRuns):
        return _plan_union_runs(node, ctx)

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

    raise NotImplementedError(f"no physical plan for {type(node).__name__}")


def _charge_read_amp(ctx: _PlannerCtx, out: PH.PhysOp, kids: list) -> None:
    """The read-amplification cost term (mutation follow-up): every query
    over a fed dataset pays one access-path probe per surviving component
    plus one batched searchsorted probe per resident tombstone. The per-
    component per-tombstone charges already live on the scans; this charges
    the *union-level* probing tax and flags when a compaction would pay for
    itself within a handful of queries."""
    probes = 0
    tombstones = visible = 0
    for k in kids:
        st = _leaf_stats(k, ctx)
        if st is None:
            continue
        probes += 1
        tombstones += st.tombstones
        visible += st.rows
    tombstones += sum(p.tombstones for p in getattr(out, "pruned", ()))
    out.cost += probes * C_PROBE
    out.stall_pressure = probes / STALL_COMPONENT_CAP
    tel.set_gauge("planner.stall_pressure", out.stall_pressure)
    amp = probes > READ_AMP_COMPONENTS or (
        visible > 0 and tombstones / visible > READ_AMP_TOMBSTONE_FRAC)
    if amp:
        out.compaction_recommended = True
        note = (f"read amplification: {probes} component probe(s), "
                f"{tombstones} tombstone(s) subtract per query — "
                f"compaction recommended")
        out.note = (out.note + " — " if out.note else "") + note
    if out.stall_pressure >= STALL_WARN_FRAC:
        out.stall_imminent = True
        note = (f"stall imminent: {probes}/{STALL_COMPONENT_CAP} components "
                f"toward the write-stall cap "
                f"(pressure {out.stall_pressure:.2f})")
        out.note = (out.note + " — " if out.note else "") + note


def _plan_union_runs(node: P.UnionRuns, ctx: _PlannerCtx) -> PH.PhysOp:
    ordinal = ctx.ordinals.get(id(node), -1)
    surviving = ctx.decisions.surviving(ordinal, len(node.children))
    pruned = ctx.decisions.pruned(ordinal)
    kids = [_plan_stream(node.children[i], ctx) for i in surviving]
    out = PH.PrunedUnionRuns(kids, pruned)
    out.est_rows = sum(k.est_rows for k in kids)
    out.cost = out.est_rows * 0.05
    if pruned:
        out.note = (f"zone maps pruned {len(pruned)}/{len(node.children)} "
                    f"components ({sum(p.rows for p in pruned):,} rows skipped)")
    _charge_read_amp(ctx, out, kids)
    return out


# -- join guards (moved from the compiler: they are *planning* decisions) ----


def _check_join_materializable(node: P.Join, ctx: _PlannerCtx) -> None:
    """Materializing joins require unique build keys (static shapes: each
    probe row gathers ≤1 match). A fed build side contributes base + runs, so
    every component must be internally unique AND the component key ranges
    pairwise disjoint — proven from catalog stats or refused."""
    scans = [l for l in P.walk(node.children[1]) if isinstance(l, P.Scan)]
    if not scans:
        return
    first = scans[0].dataset.split("@")[0]
    comps = [l for l in scans if l.dataverse == scans[0].dataverse
             and l.dataset.split("@")[0] == first]
    ranges = []
    for leaf in comps:
        stats = _scan_stats(ctx, leaf)
        cs = stats.column(node.right_on) if stats is not None else None
        if cs is None:
            continue
        if cs.distinct is not None and cs.distinct < stats.rows:
            raise NotImplementedError(
                f"materializing join on non-unique key "
                f"{node.right_on!r} (distinct={cs.distinct} < "
                f"rows={stats.rows}); COUNT over such joins is "
                "supported (join-count path)")
        if cs.lo is not None:
            ranges.append((cs.lo, cs.hi))
    if len(comps) > 1:
        if len(ranges) < len(comps):
            raise NotImplementedError(
                f"materializing join against a fed dataset needs "
                f"key bounds on {node.right_on!r} to prove the LSM "
                "components disjoint")
        for i, (lo_a, hi_a) in enumerate(ranges):
            for lo_b, hi_b in ranges[i + 1:]:
                if lo_a <= hi_b and lo_b <= hi_a:
                    raise NotImplementedError(
                        f"materializing join key {node.right_on!r} "
                        "may repeat across LSM components "
                        f"(overlapping bounds); compact first or "
                        "use COUNT (join-count path)")


def _join_key_int32_safe(side: P.Plan, col: str, ctx: _PlannerCtx) -> bool:
    """True when stats prove the join key casts to int32 losslessly (the
    merge_join kernel's tile dtype). Every leaf carrying the column must
    pass — an LSM run can extend the base's domain."""
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
    if isinstance(node, P.UnionScalar):
        ordinal = ctx.ordinals.get(id(node), -1)
        surviving = ctx.decisions.surviving(ordinal, len(node.children))
        pruned = ctx.decisions.pruned(ordinal)
        kids = [_plan_terminal(node.children[i], ctx) for i in surviving]
        out = PH.MergeScalars(kids, node.merges, pruned)
        out.est_rows = 1
        out.cost = len(kids) * 0.5
        if pruned:
            out.note = (f"zone maps pruned {len(pruned)}/{len(node.children)} "
                        f"components "
                        f"({sum(p.rows for p in pruned):,} rows skipped)")
        _charge_read_amp(ctx, out, kids)
        return out

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
    """The flagship costed decision: COUNT(pred) over one component picks the
    cheapest valid access path instead of the old rewrite-rule priority."""
    child = node.children[0]
    pred = node.predicate
    # index/kernel candidates may only look through IDENTITY Projects (the
    # narrow ones column pruning inserts): a renaming Project changes what
    # predicate names mean, and a candidate reading stored columns by those
    # names would count the wrong data — renames stay on the mask path.
    inner = child.children[0] if _identity_project(child) else child

    candidates: list[PH.PhysOp] = []
    if isinstance(inner, P.Scan) and pred is not None:
        stats = _scan_stats(ctx, inner)
        if stats is not None:
            conjuncts = _split_conjuncts(pred)
            sel = _filter_selectivity(pred, stats)
            key_col, shadow, n_anti = _component_shadow(
                ctx, inner.dataverse, inner.dataset)
            if ctx.enable_index:
                for colname, cs in stats.columns.items():
                    if cs.index is None:
                        continue
                    found = _range_bounds(conjuncts, colname)
                    if found is None:
                        continue
                    lo, hi, residual = found
                    if residual:
                        continue  # residual conjuncts: not index-only
                    if shadow and colname != key_col:
                        # newer anti-matter shadows rows of this component by
                        # PRIMARY key; a secondary index alone cannot tell
                        # which of its matching entries died — only the
                        # primary index supports index-only subtraction. The
                        # mask/kernel candidates below stay valid.
                        continue
                    cand: PH.PhysOp = PH.IndexOnlyCount(
                        inner.dataverse, inner.dataset, colname, lo, hi)
                    cand.est_rows = max(stats.rows * sel, 1)
                    cand.rows_touched = cand.est_rows
                    cand.cost = C_PROBE + math.log2(max(stats.padded_rows, 2))
                    cand.note = f"index-only: sorted {cs.index} index on {colname}"
                    if shadow:
                        sub = PH.ShadowProbeCount(inner.dataverse,
                                                  inner.dataset, colname,
                                                  lo, hi, shadow)
                        sub.est_rows = min(n_anti, cand.est_rows)
                        sub.cost = C_PROBE + n_anti * C_TOMBSTONE
                        sub.note = (f"{n_anti} tombstone(s) from "
                                    f"{len(shadow)} newer component(s) probe "
                                    f"the primary index")
                        wrapped = PH.SubtractScalars(cand, sub)
                        wrapped.est_rows = cand.est_rows
                        wrapped.cost = 0.5
                        wrapped.note = ("anti-matter subtraction: count = "
                                        "index-only matches − matches newer "
                                        "tombstones shadow")
                        cand = wrapped
                    candidates.append(cand)
            if ctx.kernels:
                krc = _try_kernel_range_count(inner, pred, stats, ctx,
                                              key_col if shadow else None,
                                              shadow)
                if krc is not None:
                    krc.est_rows = max(stats.rows * sel, 1)
                    krc.rows_touched = stats.padded_rows
                    notes = [krc.note] if krc.note else []
                    if krc.block_ids is not None:
                        # the kernel grid visits only surviving blocks: the
                        # launch cost scales with blocks scanned, not total.
                        krc.rows_touched = min(
                            stats.padded_rows,
                            len(krc.block_ids) * krc.zone_block)
                        krc.est_rows = max(
                            krc.est_rows * len(krc.block_ids)
                            / max(krc.blocks_total, 1), 1)
                        notes.append(krc.block_note())
                    krc.cost = C_KERNEL_LAUNCH \
                        + krc.rows_touched * C_ROW_KERNEL \
                        + n_anti * C_TOMBSTONE
                    if shadow:
                        notes.append(f"matter mask folds {n_anti} newer "
                                     f"tombstone(s) into one kernel row")
                    krc.note = " — ".join(notes)
                    candidates.append(krc)
                kic = _try_kernel_isin_count(inner, pred, stats, ctx,
                                             key_col if shadow else None,
                                             shadow)
                if kic is not None:
                    for kid in kic.children:
                        rt = stats.padded_rows
                        if kid.block_ids is not None:
                            rt = min(stats.padded_rows,
                                     len(kid.block_ids) * kid.zone_block)
                        kid.rows_touched = rt
                        kid.est_rows = max(
                            stats.rows * sel / len(kic.children), 1)
                        kid.cost = C_KERNEL_LAUNCH + rt * C_ROW_KERNEL \
                            + n_anti * C_TOMBSTONE
                    kic.est_rows = max(stats.rows * sel, 1)
                    kic.cost = 0.5 * len(kic.children)
                    candidates.append(kic)

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


def _dict_lane_stats(stats: TableStats, col: str) -> Optional[ColumnStats]:
    """The ``__dict_<col>`` lane's stats when the component dictionary-
    encodes ``col`` AND the lane passes the filter_count int32 proof
    (ids are 0..G-1, so the proof only fails on an empty dictionary)."""
    cs = stats.column(col)
    if cs is None or not cs.is_string or cs.dict_values is None:
        return None
    lcs = stats.column(dict_lane_name(col))
    if lcs is None or not np.issubdtype(lcs.dtype, np.integer) \
            or lcs.lo is None or lcs.hi is None \
            or lcs.lo < _RANGE_MIN or lcs.hi > _RANGE_MAX:
        return None
    return lcs


def _dict_eq_binders(values: tuple):
    """lo/hi bind-time transforms for ``col == lit`` on the dict-id lane:
    a present literal binds both bounds to its id; an absent one binds the
    empty range [1, 0] — the kernel then counts zero rows, exactly what the
    full-width comparison would. Literals are canonicalized to stored form
    first (ascii, width-truncated, padding stripped) so e.g. a
    trailing-space literal binds to the same id its encoded row matches."""
    pos = {v: i for i, v in enumerate(values)}

    def lo(v):
        return pos.get(canon_string(v), 1)

    def hi(v):
        return pos.get(canon_string(v), 0)

    return lo, hi


def _isin_binders(pos: dict, j: int):
    """lo/hi transforms for member ``j`` of an IN list. Each binder sees ALL
    sibling values, so a duplicate of an earlier member (or an absent value)
    binds the empty range — per-member counts stay disjoint and their sum
    never double-counts. Members are compared in canonical stored form, so
    two spellings that encode to the same row count as duplicates."""
    def lo(*vals):
        v = canon_string(vals[j])
        return 1 if v in map(canon_string, vals[:j]) or v not in pos \
            else pos[v]

    def hi(*vals):
        v = canon_string(vals[j])
        return 0 if v in map(canon_string, vals[:j]) or v not in pos \
            else pos[v]

    return lo, hi


def _try_kernel_range_count(scan: P.Scan, pred: Expr, stats: TableStats,
                            ctx: _PlannerCtx,
                            key_col: Optional[str] = None,
                            shadow_sources: tuple = ()
                            ) -> Optional[PH.KernelRangeCount]:
    """COUNT whose predicate fully decomposes into ``Col {==,>=,<=} Lit``
    conjuncts on int32-provable integer columns → filter_count kernel. One
    entry per conjunct; an open side is the int32-extreme literal (the
    lowering groups entries by column at run time). String equality on a
    dictionary-encoded column joins the fast path as an ordinary int
    conjunct on the ``__dict_<col>`` id lane (the literal binds to its
    sorted-dictionary id). Partial matches never fuse (graceful fallback to
    the mask path)."""
    cols: list[str] = []
    los: list[Expr] = []
    his: list[Expr] = []
    notes: list[str] = []
    for c in _split_conjuncts(pred):
        if not isinstance(c, Compare):
            return None
        l, r = c.children
        if not (isinstance(l, Col) and isinstance(r, Lit)):
            return None
        cs = stats.column(l.name)
        if cs is None:
            return None
        if cs.is_string:
            if c.op != "==" or not isinstance(r.value, str) \
                    or _dict_lane_stats(stats, l.name) is None:
                return None
            blo, bhi = _dict_eq_binders(cs.dict_values)
            lo = Lit(blo(r.value))
            lo.binder, lo.sources = blo, (r,)
            hi = Lit(bhi(r.value))
            hi.binder, hi.sources = bhi, (r,)
            i = blo(r.value)
            notes.append(
                f"dict lane {dict_lane_name(l.name)}: {l.name} == "
                f"{r.value!r} → id "
                f"{i if i <= bhi(r.value) else '∅'}/{len(cs.dict_values)}")
            cols.append(dict_lane_name(l.name))
            los.append(lo)
            his.append(hi)
            continue
        if not np.issubdtype(cs.dtype, np.integer):
            return None
        # the kernel evaluates on int32 tiles: column bounds must prove the
        # cast lossless, or wider-int values wrap and counts corrupt.
        if cs.lo is None or cs.hi is None \
                or cs.lo < _RANGE_MIN or cs.hi > _RANGE_MAX:
            return None
        if not isinstance(r.value, (int, np.integer)):
            return None
        if c.op == "==":
            # NEVER alias one Lit as both bounds: a point and a range plan
            # share a physical fingerprint (literal values excluded), so the
            # executable's two param slots must map to two distinct Lit
            # objects or a cache hit cross-binds them.
            lo, hi = r, Lit(r.value, source=r)
        elif c.op == ">=":
            lo, hi = r, Lit(_RANGE_MAX)
        elif c.op == "<=":
            lo, hi = Lit(_RANGE_MIN), r
        else:  # strict bounds / != : conservative, stay on the mask path
            return None
        cols.append(l.name)
        los.append(lo)
        his.append(hi)
    ds = ctx.catalog.get(scan.dataverse, scan.dataset)
    has_valid = "__valid__" in ds.table.columns
    out = PH.KernelRangeCount(scan.dataverse, scan.dataset, cols, los, his,
                              has_valid, key_col=key_col,
                              shadow_sources=shadow_sources)
    if notes:
        out.note = "; ".join(notes)
    bz = stats.block_zones
    if bz is not None:
        out.set_blocks(ctx.scan_blocks(scan), bz.block, bz.n_blocks,
                       n_shards=bz.n_shards, rows_per_shard=bz.rows_per_shard)
    return out


def _try_kernel_isin_count(scan: P.Scan, pred: Expr, stats: TableStats,
                           ctx: _PlannerCtx,
                           key_col: Optional[str] = None,
                           shadow_sources: tuple = ()
                           ) -> Optional[PH.MergeScalars]:
    """COUNT(col IN [...]) on a dictionary-encoded string column → one
    filter_count launch per member on the ``__dict_<col>`` id lane, partial
    counts summed. Dict ids partition rows, so the sum never double-counts;
    duplicate or absent members bind the empty range and contribute zero."""
    conjuncts = _split_conjuncts(pred)
    if len(conjuncts) != 1 or not isinstance(conjuncts[0], IsIn):
        return None
    e = conjuncts[0]
    l = e.children[0]
    vals = e.values
    if not (isinstance(l, Col) and vals
            and all(isinstance(v, Lit) and isinstance(v.value, str)
                    for v in vals)):
        return None
    cs = stats.column(l.name)
    if _dict_lane_stats(stats, l.name) is None:
        return None
    lane = dict_lane_name(l.name)
    ds = ctx.catalog.get(scan.dataverse, scan.dataset)
    has_valid = "__valid__" in ds.table.columns
    pos = {v: i for i, v in enumerate(cs.dict_values)}
    sources = tuple(vals)
    # the members bound for THIS plan, and each member's own block list
    # (``Pruner.decide``); with no such decision every launch scans the
    # scan's surviving blocks
    ordinal = ctx.scan_ordinals.get(id(scan))
    cur = ctx.decisions.member_values.get(ordinal,
                                          tuple(v.value for v in vals))
    member_blocks = ctx.decisions.member_blocks.get(ordinal)
    bz = stats.block_zones
    kids: list[PH.PhysOp] = []
    for j in range(len(vals)):
        blo, bhi = _isin_binders(pos, j)
        lo = Lit(blo(*cur))
        lo.binder, lo.sources = blo, sources
        hi = Lit(bhi(*cur))
        hi.binder, hi.sources = bhi, sources
        kid = PH.KernelRangeCount(scan.dataverse, scan.dataset, [lane],
                                  [lo], [hi], has_valid, key_col=key_col,
                                  shadow_sources=shadow_sources)
        if bz is not None:
            keep = member_blocks[j] if member_blocks is not None \
                else ctx.scan_blocks(scan)
            kid.set_blocks(keep, bz.block, bz.n_blocks,
                           n_shards=bz.n_shards,
                           rows_per_shard=bz.rows_per_shard)
        kids.append(kid)
    out = PH.MergeScalars(kids, [("count", "sum")], ())
    ids = [pos.get(v) for v in cur]
    out.note = (f"dict lane {lane}: {l.name} IN {list(cur)!r} → ids "
                f"{ids} ({len(kids)} filter_count launch(es), partials "
                f"summed)")
    return out


def _plan_join_count(lnode: P.Plan, rnode: P.Plan, left_on: str, right_on: str,
                     ctx: _PlannerCtx) -> PH.PhysOp:
    left = _plan_stream(lnode, ctx)
    right = _plan_stream(rnode, ctx)
    presorted_key = None
    if isinstance(rnode, P.Scan):
        stats = _scan_stats(ctx, rnode)
        if stats is not None and stats.index_on(right_on) is not None:
            presorted_key = (rnode.dataverse, rnode.dataset)
    kernel = ctx.kernels and _join_key_int32_safe(lnode, left_on, ctx) \
        and _join_key_int32_safe(rnode, right_on, ctx)
    out = PH.JoinCountOp(left, right, left_on, right_on,
                         presorted_key=presorted_key, kernel=kernel)
    n = left.est_rows + right.est_rows
    out.est_rows = 1
    out.cost = C_KERNEL_LAUNCH + n * C_ROW_KERNEL if kernel else n * C_ROW_JOIN
    if kernel:
        out.note = "int32-safety proven from stats: merge_join kernel"
    return out


# -- group-by planning -------------------------------------------------------


def _group_domain(phys_child: PH.PhysOp, key: str, ctx: _PlannerCtx):
    """Resolve (lo, num_groups) for the bounded-domain group-by from the
    *surviving* physical leaves. Bounds merge across the LSM components of
    the FIRST dataset family that carries them; leaves of other datasets (a
    join build side with a same-named column) never widen the domain."""
    lo = hi = family = None
    for leaf in PH.walk(phys_child):
        skey = getattr(leaf, "source_key", None)
        if skey is None:
            continue
        stats = ctx.stats(*skey)
        cs = stats.column(key) if stats is not None else None
        if cs is None or cs.lo is None or cs.hi is None:
            continue
        fam = (skey[0], skey[1].split("@")[0])
        if family is None:
            family = fam
        elif fam != family:
            continue
        lo = cs.lo if lo is None else min(lo, cs.lo)
        hi = cs.hi if hi is None else max(hi, cs.hi)
    if lo is not None:
        return int(lo), int(hi - lo + 1)
    raise ValueError(
        f"group key {key!r} has no domain statistics; bounded-domain group-by "
        "requires catalog lo/hi (Wisconsin columns carry them)")


def _trace_col(node: P.Plan, col: str, ctx: _PlannerCtx) -> Optional[ColumnStats]:
    """Resolve the ColumnStats a stream column name originates from, following
    Project renames and join name-resolution; None when provenance cannot be
    established (computed expressions, suffixed join collisions)."""
    if isinstance(node, Window) and col == node.out_name:
        return None  # computed analytic column, no catalog bounds
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
    if isinstance(node, P.UnionRuns):
        # every component must prove the column; the union's bound is the
        # envelope of the per-component bounds (runs may extend the domain).
        metas = [_trace_col(c, col, ctx) for c in node.children]
        if any(m is None or m.lo is None or m.hi is None for m in metas):
            return None
        return ColumnStats(metas[0].dtype,
                           min(m.lo for m in metas), max(m.hi for m in metas),
                           sum(m.distinct or 0 for m in metas) or None,
                           any(m.is_string for m in metas), False)
    if isinstance(node, P.Join):
        # join_materialize: the left side wins a bare name; right-only names
        # pass through; a collision suffixes the right column (untraceable by
        # its stream name, so it resolves to None here).
        left_meta = _trace_col(node.children[0], col, ctx)
        if left_meta is not None:
            return left_meta
        return _trace_col(node.children[1], col, ctx)
    if len(node.children) == 1:  # filter/limit/sort/window pass columns through
        return _trace_col(node.children[0], col, ctx)
    return None


def _kernel_groupagg_exact(node: P.GroupAgg, ctx: _PlannerCtx, aggs) -> bool:
    """The segment_agg kernel computes in float32 — bit-identical to the
    generic path only when every per-group result is an exactly-representable
    integer: counts need n < 2^24; sum/mean need integer value columns whose
    stats bounds prove n * max|value| < 2^24; max/min only need the values
    representable. Provenance is traced to the origin table (conservative:
    the UNPRUNED component set bounds n)."""
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


def _string_group_setup(node: P.GroupAgg, child: PH.PhysOp, key: str,
                        ctx: _PlannerCtx):
    """String group-by over dictionary-encoded components: build the UNION
    dictionary U (byte-lex sorted — ASCII str-sort over the space-padded
    encoding) and wrap every physical component in a ``DictRemapCols`` that
    rewrites its local dict ids into positions in U *below* the union
    concat. The group-by then runs over the int domain [0, |U|) on the
    existing segment-reduce/segment_agg machinery; ``key_values`` decodes
    surviving ids back to strings at the result boundary. None when the key
    isn't a stored dictionary-encoded string column on every component."""
    top = node.children[0]
    origins = {_origin_column(c, key) for c in top.children} \
        if isinstance(top, P.UnionRuns) else {_origin_column(top, key)}
    if origins != {key}:
        return None  # renamed/computed key: lane names would not line up
    comps = list(child.children) if isinstance(child, PH.PrunedUnionRuns) \
        else [child]
    dicts: list[tuple] = []
    family = None
    for c in comps:
        skey = None
        for leaf in PH.walk(c):
            skey = getattr(leaf, "source_key", None)
            if skey is not None:
                break
        if skey is None:
            return None
        stats = ctx.stats(*skey)
        cs = stats.column(key) if stats is not None else None
        if cs is None or not cs.is_string or cs.dict_values is None:
            return None
        fam = (skey[0], skey[1].split("@")[0])
        if family is None:
            family = fam
        elif fam != family:
            return None
        dicts.append(tuple(cs.dict_values))
    union: set = set()
    for d in dicts:
        union.update(d)
    if not union:
        return None  # no live string anywhere: stay on the generic raise
    U = sorted(union)
    upos = {v: i for i, v in enumerate(U)}
    lane = dict_lane_name(key)
    wrapped: list[PH.PhysOp] = []
    for c, d in zip(comps, dicts):
        w = PH.DictRemapCols(c, key, lane, tuple(upos[v] for v in d))
        w.est_rows = c.est_rows
        w.cost = c.est_rows * 0.05
        wrapped.append(w)
    return wrapped, tuple(U)


def _plan_groupagg(node: P.GroupAgg, ctx: _PlannerCtx) -> PH.PhysOp:
    assert len(node.keys) == 1, "single-key group-by (paper expressions 4/8)"
    key = node.keys[0]
    child = _plan_stream(node.children[0], ctx)
    key_values = None
    setup = _string_group_setup(node, child, key, ctx)
    if setup is not None:
        wrapped, key_values = setup
        if isinstance(child, PH.PrunedUnionRuns):
            child.children = tuple(wrapped)  # remap BELOW the concat
        else:
            child = wrapped[0]
        lo, num_groups = 0, len(key_values)
    else:
        lo, num_groups = _group_domain(child, key, ctx)
    aggs = [(s.out_name, s.op, s.column) for s in node.aggs]

    if ctx.kernels \
            and all(op in ("count", "sum", "mean", "max", "min")
                    for _, op, _ in aggs) \
            and _kernel_groupagg_exact(node, ctx, aggs):
        comps = list(child.children) if isinstance(child, PH.PrunedUnionRuns) \
            else [child]
        out = PH.KernelSegmentAgg(comps, key, lo, num_groups, node.aggs,
                                  key_values=key_values)
        if isinstance(child, PH.PrunedUnionRuns):
            out.pruned = child.pruned
            out.note = child.note
        # hoist each component's surviving-block list off its TableScan into
        # the segment_agg grid itself: the stream then feeds full-length
        # columns (no gather copy) and the kernel's index_map skips pruned
        # tiles — rows in skipped blocks are already masked out by the
        # filter the list was derived from.
        comp_blocks: list = []
        skipped = total = 0
        for c in comps:
            scans = [s for s in PH.walk(c) if isinstance(s, PH.TableScan)
                     and s.block_ids is not None]
            if len(scans) == 1:
                s = scans[0]
                comp_blocks.append(
                    (s.block_ids, s.zone_block) + s.shard_layout())
                skipped += s.blocks_total - len(s.block_ids)
                total += s.blocks_total
                s.block_ids = None  # the kernel grid skips, not the stream
            else:
                comp_blocks.append(None)
        out.comp_blocks = tuple(comp_blocks)
        out.est_rows = num_groups
        out.cost = sum(c.est_rows for c in comps) * C_ROW_KERNEL \
            + C_KERNEL_LAUNCH * len(comps)
        if skipped:
            out.note = (out.note + " — " if out.note else "") + \
                (f"zone maps: {total - skipped}/{total} block(s) in the "
                 f"segment_agg grid(s), {skipped} skipped")
        out.note = (out.note + " — " if out.note else "") + \
            "f32 exactness proven from stats: segment_agg kernel"
        return out

    out = PH.GroupAggGeneric(child, key, lo, num_groups, node.aggs,
                             key_values=key_values)
    out.est_rows = num_groups
    out.cost = child.est_rows * C_ROW_GROUP + num_groups
    return out
