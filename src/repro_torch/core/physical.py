"""Physical query plans — what the cost-based planner hands the compiler
(port of ``repro.core.physical``).

Every *how* decision — index probe vs. full scan vs. fused kernel, which LSM
runs to read at all — lives in a physical operator chosen by the planner
(core/physical_planner.py) from catalog statistics (core/stats.py). Each
node carries its cost annotations (``est_rows``, ``rows_touched``,
``cost``, ``note``). ``fingerprint()`` keys the compiled-query dedup cache:
two logical plans the planner maps to the same physical shape (a ``x >= a``
and a ``x <= a`` over the same column) share one compiled query, literal
values staying runtime parameters. ``format_plan`` renders the tree
``explain()`` shows, with the zone-span rationale of every pruned run and,
under ``analyze``, the measured time and rows of every operator.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core.expr import Expr


@dataclasses.dataclass(frozen=True)
class PrunedComponent:
    """One LSM component the planner dropped at bind time, with the zone-map
    rationale (recorded for explain; the compiled plan never reads it).

    Pruning is mutation-safe because it reasons per key-visibility: only the
    component's *matter* contribution is dropped (zone spans cover matter
    only, and a span miss proves zero visible matching rows). Its anti-matter
    — which annihilates *into* older components — is never pruned: surviving
    scans keep the pruned run's tombstone set among their shadow sources, so
    the subtraction still happens. ``tombstones`` records that retention for
    the explain rationale."""

    address: str
    column: str
    span: tuple          # the run's zone span [lo, hi]
    bound: tuple         # the predicate's effective [lo, hi] at bind time
    rows: int            # live rows the pruned run holds
    tombstones: int = 0  # anti-matter records the run keeps contributing

    def describe(self) -> str:
        out = (f"{self.address} PRUNED: zone span {self.column}∈"
               f"[{self.span[0]}, {self.span[1]}] misses predicate "
               f"[{self.bound[0]}, {self.bound[1]}] ({self.rows} rows skipped)")
        if self.tombstones:
            out += (f"; {self.tombstones} anti-matter record(s) RETAINED — "
                    f"they still subtract from older components")
        return out


class PhysOp:
    """Base physical operator. ``children`` are other PhysOps; cost fields
    are filled by the planner."""

    children: tuple["PhysOp", ...] = ()
    est_rows: float = 0.0
    rows_touched: float = 0.0
    cost: float = 0.0
    note: str = ""
    # Write-stall early warning (set by the planner's read-amp charge):
    # component probes / write-stall component cap, and whether it crossed
    # the warn fraction. 0.0 everywhere on un-fed plans.
    stall_pressure: float = 0.0
    stall_imminent: bool = False

    def exprs(self) -> list[Expr]:
        return []

    def fingerprint(self) -> str:
        raise NotImplementedError

    def label(self) -> str:
        return type(self).__name__

    def total_cost(self) -> float:
        return self.cost + sum(c.total_cost() for c in self.children)


def walk(node: PhysOp):
    yield node
    for c in node.children:
        yield from walk(c)


def all_exprs(node: PhysOp) -> list[Expr]:
    out: list[Expr] = []
    for n in walk(node):
        out.extend(n.exprs())
    return out


def scan_leaves(node: PhysOp) -> list[tuple[str, str]]:
    """Dataset keys the physical plan actually reads (pruned runs excluded —
    the executable must never gather a dropped component)."""
    keys: list[tuple[str, str]] = []
    for n in walk(node):
        key = getattr(n, "source_key", None)
        if key is not None and key not in keys:
            keys.append(key)
    return keys


def anti_leaves(node: PhysOp) -> list[tuple[str, str]]:
    """Components whose anti-matter key sets the plan subtracts with. A
    matter-pruned run can still appear here: its tombstones annihilate into
    surviving older components, so its anti array must be gathered even
    though its table is not."""
    keys: list[tuple[str, str]] = []
    for n in walk(node):
        for key in getattr(n, "shadow_sources", ()):
            if key not in keys:
                keys.append(key)
    return keys


def _shadow_fp(shadow_sources) -> str:
    return "|".join(f"{dv}.{name}" for dv, name in shadow_sources)


def _blocks_fp(block_ids) -> str:
    # Surviving-block lists are STATIC plan structure (baked into the gather
    # slices / kernel grid), so they must participate in the executable-dedup
    # fingerprint — two bindings with different surviving blocks can never
    # share a compiled program.
    return "all" if block_ids is None else ",".join(map(str, block_ids))


class _BlockSkip:
    """Mixin state for operators that skip zone-map-pruned blocks:
    ``block_ids`` is the ascending tuple of surviving block indices (None =
    scan everything), ``zone_block`` the block size in rows,
    ``blocks_total`` the component's block count, ``blocks_scanned`` what
    the operator actually reads.

    On a sharded mesh the ids live in the per-shard layout (flat id
    ``s * blocks_per_shard + j`` = shard ``s``'s local block ``j``;
    stats.BlockZones): ``n_shards`` / ``blocks_per_shard`` /
    ``rows_per_shard`` carry it to the lowering, which re-bases the flat
    list into per-shard grids and gathers. ``n_shards == 1`` is the global
    layout."""

    block_ids: Optional[tuple] = None
    zone_block: int = 0
    blocks_total: int = 0
    blocks_scanned: int = 0
    n_shards: int = 1
    blocks_per_shard: int = 0
    rows_per_shard: int = 0

    def set_blocks(self, block_ids, zone_block: int, total: int,
                   n_shards: int = 1, rows_per_shard: int = 0) -> None:
        self.block_ids = tuple(block_ids) if block_ids is not None else None
        self.zone_block = int(zone_block)
        self.blocks_total = int(total)
        self.blocks_scanned = total if block_ids is None else len(block_ids)
        self.n_shards = max(int(n_shards), 1)
        self.blocks_per_shard = self.blocks_total // self.n_shards
        self.rows_per_shard = int(rows_per_shard)

    def shard_layout(self) -> tuple:
        """(n_shards, blocks_per_shard, rows_per_shard): what the lowering
        needs to slice a flat surviving-block list per shard."""
        return (self.n_shards, self.blocks_per_shard, self.rows_per_shard)

    def block_note(self) -> str:
        skipped = self.blocks_total - self.blocks_scanned
        out = (f"zone maps: {self.blocks_scanned}/{self.blocks_total} "
               f"block(s) scanned, {skipped} skipped")
        if self.n_shards > 1 and self.block_ids is not None:
            bp = max(self.blocks_per_shard, 1)
            per = [0] * self.n_shards
            for b in self.block_ids:
                per[min(b // bp, self.n_shards - 1)] += 1
            out += (f" ({self.n_shards} shards, per-shard "
                    f"{'/'.join(map(str, per))} of {bp})")
        return out


# -- stream operators (produce (env, mask)) ---------------------------------


class TableScan(PhysOp, _BlockSkip):
    """Full component scan. ``shadow_sources`` are the newer LSM components
    whose anti-matter annihilates into this one: the lowering subtracts the
    shadowed rows from the stream mask (a sorted-probe per source on the
    ``key_col`` primary key), so every operator above sees only visible
    matter — in all three execution modes.

    With ``block_ids`` set (bind-time block zone-map test) the lowering
    streams only the surviving row blocks — sound because the planner only
    sets the list when every conjunct it derives from is applied above this
    scan, so skipped blocks provably contribute no passing rows."""

    def __init__(self, dataverse: str, dataset: str, open_cast: bool = False,
                 key_col: Optional[str] = None,
                 shadow_sources: tuple = ()):
        self.dataverse, self.dataset, self.open_cast = dataverse, dataset, open_cast
        self.key_col = key_col
        self.shadow_sources = tuple(shadow_sources)

    @property
    def source_key(self):
        return (self.dataverse, self.dataset)

    def fingerprint(self):
        return (f"p:scan({self.dataverse}.{self.dataset},{int(self.open_cast)},"
                f"{self.key_col},{_shadow_fp(self.shadow_sources)},"
                f"blk:{_blocks_fp(self.block_ids)})")

    def label(self):
        out = f"TableScan {self.dataverse}.{self.dataset}" + \
            (" [open: cast-per-access]" if self.open_cast else "")
        if self.blocks_total and self.blocks_scanned < self.blocks_total:
            out += f" [blocks {self.blocks_scanned}/{self.blocks_total}]"
        if self.shadow_sources:
            out += (f" ⊖ anti-matter of {len(self.shadow_sources)} newer "
                    f"component(s)")
        return out


class IndexProbe(PhysOp, _BlockSkip):
    """Streaming access path via an indexed column's range predicate: the
    bound conjuncts become the index mask, the rest stay residual. Shadow
    sources subtract exactly like :class:`TableScan`.

    With ``block_ids`` set, the lowering gathers only the surviving row
    blocks before the probe (the same static-slice gather as TableScan) —
    the sorted-index mask then tests a fraction of the physical rows instead
    of streaming all of them."""

    def __init__(self, dataverse: str, dataset: str, index_col: str,
                 lo: Optional[Expr], hi: Optional[Expr],
                 residual: Optional[Expr] = None, open_cast: bool = False,
                 key_col: Optional[str] = None,
                 shadow_sources: tuple = ()):
        self.dataverse, self.dataset, self.index_col = dataverse, dataset, index_col
        self.lo, self.hi, self.residual = lo, hi, residual
        self.open_cast = open_cast
        self.key_col = key_col
        self.shadow_sources = tuple(shadow_sources)

    @property
    def source_key(self):
        return (self.dataverse, self.dataset)

    def exprs(self):
        return [e for e in (self.lo, self.hi, self.residual) if e is not None]

    def fingerprint(self):
        lo = self.lo.fingerprint() if self.lo else "-inf"
        hi = self.hi.fingerprint() if self.hi else "+inf"
        res = self.residual.fingerprint() if self.residual else ""
        return (f"p:ixprobe({self.dataverse}.{self.dataset},{self.index_col},"
                f"{lo},{hi},{res},{int(self.open_cast)},{self.key_col},"
                f"{_shadow_fp(self.shadow_sources)},"
                f"blk:{_blocks_fp(self.block_ids)})")

    def label(self):
        bounds = f"{self.index_col} ∈ [{'-∞' if self.lo is None else '?'}, " \
                 f"{'+∞' if self.hi is None else '?'}]"
        res = " +residual" if self.residual is not None else ""
        out = f"IndexProbe {self.dataverse}.{self.dataset} ({bounds}{res})"
        if self.blocks_total and self.blocks_scanned < self.blocks_total:
            out += f" [blocks {self.blocks_scanned}/{self.blocks_total}]"
        if self.shadow_sources:
            out += (f" ⊖ anti-matter of {len(self.shadow_sources)} newer "
                    f"component(s)")
        return out


class FullScanFilter(PhysOp):
    def __init__(self, child: PhysOp, predicate: Expr):
        self.children, self.predicate = (child,), predicate

    def exprs(self):
        return [self.predicate]

    def fingerprint(self):
        return f"p:filter({self.predicate.fingerprint()},{self.children[0].fingerprint()})"

    def label(self):
        return f"FullScanFilter ({self.predicate.to_sql()})"


class ProjectCols(PhysOp):
    def __init__(self, child: PhysOp, outputs: Sequence[tuple[str, Expr]]):
        self.children, self.outputs = (child,), tuple(outputs)

    def exprs(self):
        return [e for _, e in self.outputs]

    def fingerprint(self):
        items = ",".join(f"{n}:{e.fingerprint()}" for n, e in self.outputs)
        return f"p:project([{items}],{self.children[0].fingerprint()})"

    def label(self):
        return f"Project [{', '.join(n for n, _ in self.outputs)}]"


class LimitRows(PhysOp):
    def __init__(self, child: PhysOp, n: int):
        self.children, self.n = (child,), int(n)

    def fingerprint(self):
        return f"p:limit({self.n},{self.children[0].fingerprint()})"

    def label(self):
        return f"Limit {self.n}"


class TopKSelect(PhysOp):
    """Sort+limit fused; ``kernel`` selects the block_topk kernel as the
    selection primitive instead of a stable sort (a planner decision)."""

    def __init__(self, child: PhysOp, key: str, k: int, ascending: bool,
                 kernel: bool = False):
        self.children = (child,)
        self.key, self.k, self.ascending, self.kernel = key, int(k), ascending, kernel

    def fingerprint(self):
        return (f"p:topk({self.key},{self.k},{self.ascending},"
                f"{int(self.kernel)},{self.children[0].fingerprint()})")

    def label(self):
        how = "block_topk kernel" if self.kernel else "stable sort"
        d = "asc" if self.ascending else "desc"
        return f"TopK {self.key} {d} k={self.k} [{how}]"


class SortRows(PhysOp):
    def __init__(self, child: PhysOp, key: str, ascending: bool):
        self.children, self.key, self.ascending = (child,), key, ascending

    def fingerprint(self):
        return f"p:sort({self.key},{self.ascending},{self.children[0].fingerprint()})"

    def label(self):
        return f"Sort {self.key} {'asc' if self.ascending else 'desc'}"


class WindowEval(PhysOp):
    def __init__(self, child: PhysOp, window):
        self.children, self.window = (child,), window

    def fingerprint(self):
        return f"p:window({self.window.fingerprint()},{self.children[0].fingerprint()})"

    def label(self):
        return f"Window {self.window.func}(order by {self.window.order_by})"


class JoinGather(PhysOp):
    """Materializing inner equi-join (unique build keys, proven from stats
    by the planner): probe rows gather their single match."""

    def __init__(self, left: PhysOp, right: PhysOp, left_on: str, right_on: str):
        self.children = (left, right)
        self.left_on, self.right_on = left_on, right_on

    def fingerprint(self):
        return (f"p:joingather({self.left_on}={self.right_on},"
                f"{self.children[0].fingerprint()},{self.children[1].fingerprint()})")

    def label(self):
        return f"JoinGather {self.left_on} = {self.right_on}"


class PrunedUnionRuns(PhysOp):
    """Base ∪ surviving runs of a fed dataset. ``pruned`` records the runs
    the bind-time zone-span test dropped; the executable only ever reads the
    surviving children."""

    def __init__(self, children: Sequence[PhysOp],
                 pruned: Sequence[PrunedComponent] = ()):
        self.children = tuple(children)
        self.pruned = tuple(pruned)

    def fingerprint(self):
        inner = ",".join(c.fingerprint() for c in self.children)
        return f"p:unionruns({inner})"

    def label(self):
        return (f"UnionRuns [{len(self.children)} components, "
                f"{len(self.pruned)} pruned]")


# -- grouped operators -------------------------------------------------------


def _keyvals_fp(key_values) -> str:
    # The decoded-key dictionary is static plan structure (baked into the
    # id → string gather), so it participates in the compiled-query dedup
    # fingerprint like surviving-block lists do.
    return "-" if key_values is None else "|".join(map(str, key_values))


class DictRemapCols(PhysOp):
    """Per-component dictionary-id remap for a string group-by key: replaces
    ``key`` in the stream env with this component's ``__dict_<key>`` lane
    mapped through ``remap`` (component-local id → position in the union
    dictionary). Runs BELOW the union concat, so by the time components
    merge, every row speaks the same global id space — the same remap a
    compaction applies when it rebuilds lanes over merged rows."""

    def __init__(self, child: PhysOp, key: str, lane: str, remap):
        self.children = (child,)
        self.key, self.lane = key, lane
        self.remap = tuple(int(r) for r in remap)

    def fingerprint(self):
        r = ",".join(map(str, self.remap))
        return (f"p:dictremap({self.key},{self.lane},[{r}],"
                f"{self.children[0].fingerprint()})")

    def label(self):
        return (f"DictRemap {self.key} via {self.lane} "
                f"[{len(self.remap)} local ids → union dictionary]")


class GroupAggGeneric(PhysOp):
    """Bounded-domain group-by via segment reductions; the domain
    [lo, lo+num_groups) comes from planner stats.

    ``key_values`` (string group-by): the union dictionary — surviving group
    ids decode back to encoded strings at the result boundary."""

    def __init__(self, child: PhysOp, key: str, lo: int, num_groups: int, aggs,
                 key_values=None):
        self.children = (child,)
        self.key, self.lo, self.num_groups = key, int(lo), int(num_groups)
        self.aggs = tuple(aggs)
        self.key_values = tuple(key_values) if key_values is not None else None

    def fingerprint(self):
        a = ",".join(s.fingerprint() for s in self.aggs)
        return (f"p:groupagg({self.key},{self.lo},{self.num_groups},[{a}],"
                f"kv:{_keyvals_fp(self.key_values)},"
                f"{self.children[0].fingerprint()})")

    def label(self):
        out = (f"GroupAgg {self.key} G={self.num_groups} "
               f"[{', '.join(s.op for s in self.aggs)}] [segment-reduce]")
        if self.key_values is not None:
            out += " [string key: union dictionary]"
        return out


class KernelSegmentAgg(PhysOp):
    """Group-by lowered onto the segment_agg kernel: per LSM component
    (``children``), one fused launch for the sum family (count/sum/mean
    share one (n, C) value tile) plus one per extreme family, partials
    merged with +/max/min. Chosen only under a static f32-exactness proof.

    ``comp_blocks[i]`` is component i's ``(block_ids, zone_block,
    n_shards, blocks_per_shard, rows_per_shard)`` (zone-block units and
    the TableScan's shard layout; None = all blocks), hoisted off its
    TableScan so the kernel grid itself skips pruned tiles instead of the
    stream gathering a copy first.

    ``key_values`` (string group-by): the union dictionary — surviving group
    ids decode back to encoded strings at the result boundary."""

    comp_blocks: tuple = ()

    def __init__(self, comps: Sequence[PhysOp], key: str, lo: int,
                 num_groups: int, aggs, key_values=None):
        self.children = tuple(comps)
        self.key, self.lo, self.num_groups = key, int(lo), int(num_groups)
        self.aggs = tuple(aggs)
        self.key_values = tuple(key_values) if key_values is not None else None

    def fingerprint(self):
        a = ",".join(s.fingerprint() for s in self.aggs)
        inner = ",".join(c.fingerprint() for c in self.children)
        blk = ";".join(_blocks_fp(b) for b in self.comp_blocks) \
            if self.comp_blocks else "all"
        return (f"p:ksegagg({self.key},{self.lo},{self.num_groups},[{a}],"
                f"blk:{blk},kv:{_keyvals_fp(self.key_values)},{inner})")

    def label(self):
        out = (f"KernelSegmentAgg {self.key} G={self.num_groups} "
               f"[{', '.join(s.op for s in self.aggs)}] "
               f"[{len(self.children)} segment_agg launch group(s)]")
        if self.key_values is not None:
            out += " [string key: union dictionary]"
        return out


# -- scalar terminals --------------------------------------------------------


class MaskCount(PhysOp):
    """Generic COUNT: stream the child, reduce the mask (full scan)."""

    def __init__(self, child: PhysOp, predicate: Optional[Expr]):
        self.children, self.predicate = (child,), predicate

    def exprs(self):
        return [self.predicate] if self.predicate is not None else []

    def fingerprint(self):
        p = self.predicate.fingerprint() if self.predicate else "true"
        return f"p:maskcount({p},{self.children[0].fingerprint()})"

    def label(self):
        p = f" ({self.predicate.to_sql()})" if self.predicate is not None else ""
        return f"MaskCount{p} [full scan]"


class IndexOnlyCount(PhysOp):
    """COUNT answered from the sorted index alone: two binary searches —
    never touches the base columns (the paper's index-only query)."""

    def __init__(self, dataverse: str, dataset: str, index_col: str,
                 lo: Optional[Expr], hi: Optional[Expr]):
        self.dataverse, self.dataset, self.index_col = dataverse, dataset, index_col
        self.lo, self.hi = lo, hi

    @property
    def source_key(self):
        return (self.dataverse, self.dataset)

    def exprs(self):
        return [e for e in (self.lo, self.hi) if e is not None]

    def fingerprint(self):
        lo = self.lo.fingerprint() if self.lo else "-inf"
        hi = self.hi.fingerprint() if self.hi else "+inf"
        return f"p:ixcount({self.dataverse}.{self.dataset},{self.index_col},{lo},{hi})"

    def label(self):
        return (f"IndexOnlyCount {self.dataverse}.{self.dataset} "
                f"on {self.index_col} [binary search]")


class ShadowProbeCount(PhysOp):
    """The subtrahend of anti-matter subtraction on the index-only path:
    COUNT of this component's matter rows with primary key ∈ [lo, hi] that
    newer components' anti-matter shadows. Still index-only — the unioned
    (deduplicated) anti keys probe the component's sorted primary index,
    two binary searches per tombstone, never touching base columns."""

    def __init__(self, dataverse: str, dataset: str, index_col: str,
                 lo: Optional[Expr], hi: Optional[Expr],
                 shadow_sources: tuple):
        self.dataverse, self.dataset, self.index_col = dataverse, dataset, index_col
        self.lo, self.hi = lo, hi
        self.shadow_sources = tuple(shadow_sources)

    @property
    def source_key(self):
        return (self.dataverse, self.dataset)

    def exprs(self):
        return [e for e in (self.lo, self.hi) if e is not None]

    def fingerprint(self):
        lo = self.lo.fingerprint() if self.lo else "-inf"
        hi = self.hi.fingerprint() if self.hi else "+inf"
        return (f"p:shadowprobe({self.dataverse}.{self.dataset},"
                f"{self.index_col},{lo},{hi},"
                f"{_shadow_fp(self.shadow_sources)})")

    def label(self):
        return (f"ShadowProbeCount {self.dataverse}.{self.dataset} "
                f"on {self.index_col} [{len(self.shadow_sources)} anti "
                f"set(s), binary search]")


class SubtractScalars(PhysOp):
    """Anti-matter subtraction at the scalar merge: result = minuend −
    subtrahend per output (sum-merged outputs only — counts and sums; an
    extremum is never subtractable and takes the mask path instead). This
    is what keeps a component's index-only access path valid after newer
    components deleted/upserted into it."""

    def __init__(self, child: PhysOp, shadow: PhysOp,
                 names: Sequence[str] = ("count",)):
        self.children = (child, shadow)
        self.names = tuple(names)

    def fingerprint(self):
        return (f"p:subtract([{','.join(self.names)}],"
                f"{self.children[0].fingerprint()},"
                f"{self.children[1].fingerprint()})")

    def label(self):
        return f"SubtractScalars [{', '.join(self.names)}] [anti-matter]"


class KernelRangeCount(PhysOp, _BlockSkip):
    """COUNT of conjunctive inclusive ranges over integer columns lowered
    onto the filter_count kernel. One entry per conjunct, as the reference:
    ``los[j]``/``his[j]`` bound ``cols[j]``, an open side being the literal
    int32 extreme (a runtime param like any other, so ``x >= a`` and
    ``x <= a`` share one compiled query). The lowering groups the entries by
    column at run time, so the kernel reads each distinct column once. The
    validity mask and, with shadow sources, the newer components'
    anti-matter fold in as ONE extra kernel column with bounds (1, 1) — the
    kernel itself performs the subtract-at-merge.

    ``block_ids`` drives the kernel grid through the surviving blocks only;
    the count stays bit-identical because a skipped block's zone span proves
    no row satisfies the conjuncts."""

    def __init__(self, dataverse: str, dataset: str, cols: Sequence[str],
                 los: Sequence[Expr], his: Sequence[Expr], has_valid: bool,
                 key_col: Optional[str] = None,
                 shadow_sources: tuple = ()):
        self.dataverse, self.dataset = dataverse, dataset
        self.cols = tuple(cols)
        self.los, self.his = tuple(los), tuple(his)
        self.has_valid = has_valid
        self.key_col = key_col
        self.shadow_sources = tuple(shadow_sources)

    @property
    def source_key(self):
        return (self.dataverse, self.dataset)

    def exprs(self):
        out: list[Expr] = []
        for lo, hi in zip(self.los, self.his):
            out.extend((lo, hi))
        return out

    def fingerprint(self):
        return (f"p:krangecount({self.dataverse}.{self.dataset},"
                f"[{','.join(self.cols)}],{int(self.has_valid)},"
                f"{self.key_col},{_shadow_fp(self.shadow_sources)},"
                f"blk:{_blocks_fp(self.block_ids)})")

    def label(self):
        out = (f"KernelRangeCount {self.dataverse}.{self.dataset} "
               f"[{', '.join(self.cols)}] [filter_count kernel]")
        if self.blocks_total and self.blocks_scanned < self.blocks_total:
            out += f" [blocks {self.blocks_scanned}/{self.blocks_total}]"
        if self.shadow_sources:
            out += " [matter-mask row folded]"
        return out


class ScalarAgg(PhysOp):
    def __init__(self, child: PhysOp, aggs):
        self.children, self.aggs = (child,), tuple(aggs)

    def fingerprint(self):
        a = ",".join(s.fingerprint() for s in self.aggs)
        return f"p:scalaragg([{a}],{self.children[0].fingerprint()})"

    def label(self):
        return f"ScalarAgg [{', '.join(s.op for s in self.aggs)}]"


class JoinCountOp(PhysOp):
    """Fused join+count. ``kernel`` lowers onto merge_join_count (int32-safe
    proof required); ``presorted`` reuses the build side's sorted index."""

    def __init__(self, left: PhysOp, right: PhysOp, left_on: str, right_on: str,
                 presorted_key: Optional[tuple] = None, kernel: bool = False):
        self.children = (left, right)
        self.left_on, self.right_on = left_on, right_on
        self.presorted_key = presorted_key  # (dataverse, dataset) of sorted build
        self.kernel = kernel

    @property
    def presorted(self) -> bool:
        return self.presorted_key is not None

    def fingerprint(self):
        return (f"p:joincount({self.left_on}={self.right_on},"
                f"{self.presorted_key},{int(self.kernel)},"
                f"{self.children[0].fingerprint()},{self.children[1].fingerprint()})")

    def label(self):
        how = "merge_join kernel" if self.kernel else "sort+searchsorted"
        pre = ", presorted build" if self.presorted else ""
        return f"JoinCount {self.left_on} = {self.right_on} [{how}{pre}]"


class MergeScalars(PhysOp):
    """Merge of per-LSM-component scalar programs (+/max/min per output). ``pruned`` records runs the zone-span
    test excluded at bind time."""

    def __init__(self, children: Sequence[PhysOp],
                 merges: Sequence[tuple[str, str]],
                 pruned: Sequence[PrunedComponent] = ()):
        self.children = tuple(children)
        self.merges = tuple(merges)
        self.pruned = tuple(pruned)

    def fingerprint(self):
        m = ",".join(f"{n}:{op}" for n, op in self.merges)
        inner = ",".join(c.fingerprint() for c in self.children)
        return f"p:mergescalars([{m}],{inner})"

    def label(self):
        ops = ", ".join(f"{n}:{op}" for n, op in self.merges)
        return (f"MergeScalars [{ops}] [{len(self.children)} components, "
                f"{len(self.pruned)} pruned]")


class PointLookup(PhysOp):
    """Primary-key point lookup — the one access path that bypasses query
    compilation entirely: per-component host binary searches over the
    clustered key copy, walked newest → oldest so anti-matter resolves
    without any subtraction arithmetic (the first component owning the key
    decides: fresh matter wins, a tombstone kills every older occurrence).
    Components whose key zone span misses the probe are skipped without a
    search. On a sharded mesh each probe is routed to the owning row
    partition(s) through the per-shard key zone spans (``shards`` is the
    mesh's partition count, ``shard_probes`` the shard windows searched).
    Rendered by ``explain`` like every other physical operator."""

    def __init__(self, dataverse: str, dataset: str, key_col: str,
                 components: int, probed: int, skipped: int,
                 found_in: Optional[str] = None,
                 tombstoned_by: Optional[str] = None,
                 shards: int = 1, shard_probes: int = 0):
        self.dataverse, self.dataset, self.key_col = dataverse, dataset, key_col
        self.components = components
        self.probed, self.skipped = probed, skipped
        self.found_in = found_in
        self.tombstoned_by = tombstoned_by
        self.shards = shards
        self.shard_probes = shard_probes

    def fingerprint(self):
        return (f"p:pointlookup({self.dataverse}.{self.dataset},"
                f"{self.key_col})")

    def label(self):
        out = (f"PointLookup {self.dataverse}.{self.dataset} on "
               f"{self.key_col} [newest-wins, {self.probed} of "
               f"{self.components} component(s) probed, "
               f"{self.skipped} span-skipped]")
        if self.shards > 1:
            out += (f" [shard-routed: {self.shard_probes} of "
                    f"{self.probed * self.shards} shard window(s) searched]")
        return out


# -- explain rendering --------------------------------------------------------


def _fmt_ms(seconds: float) -> str:
    return f"{seconds * 1e3:.2f}ms"


def format_plan(root: PhysOp, analyze: Optional[dict] = None) -> str:
    """The ``explain()`` rendering: one line per operator with cost
    estimates, nested tree structure, planner rationale, and a pruning line
    per excluded LSM run.

    With ``analyze`` (the per-node measurement dict ``profile_physical``
    returns, keyed by ``id(node)``), each operator line also shows the
    *measured* self/total wall time and the actual row count beside the
    estimates — estimate-vs-actual drift on one line."""
    measures = (analyze or {}).get("nodes", {})
    lines: list[str] = []

    def emit(node: PhysOp, prefix: str, is_last: bool, is_root: bool):
        branch = "" if is_root else ("└─ " if is_last else "├─ ")
        meta = f"cost={node.cost:,.0f} rows≈{node.est_rows:,.0f}"
        if node.rows_touched and node.rows_touched != node.est_rows:
            meta += f" touched={node.rows_touched:,.0f}"
        m = measures.get(id(node))
        if m is not None:
            meta += (f" | self={_fmt_ms(m['self_seconds'])} "
                     f"total={_fmt_ms(m['total_seconds'])} "
                     f"rows={m['rows']:,}")
        lines.append(f"{prefix}{branch}{node.label()}  [{meta}]")
        child_prefix = prefix if is_root else prefix + ("   " if is_last else "│  ")
        if node.note:
            lines.append(f"{child_prefix}· {node.note}")
        pruned = getattr(node, "pruned", ())
        items: list = list(node.children) + list(pruned)
        for i, item in enumerate(items):
            last = i == len(items) - 1
            if isinstance(item, PrunedComponent):
                mark = "└─ " if last else "├─ "
                lines.append(f"{child_prefix}{mark}✂ {item.describe()}")
            else:
                emit(item, child_prefix, last, False)

    emit(root, "", True, True)
    lines.append(f"total estimated cost: {root.total_cost():,.0f}")
    if analyze is not None:
        rm = measures.get(id(root))
        if rm is not None:
            lines.append(f"measured wall time (per-operator, unjitted): "
                         f"{_fmt_ms(rm['total_seconds'])}")
        if analyze.get("jit_seconds") is not None:
            lines.append(f"jitted end-to-end: "
                         f"{_fmt_ms(analyze['jit_seconds'])}")
    return "\n".join(lines)


def prune_report(root: PhysOp) -> dict:
    """Aggregate pruning metrics over a physical plan (benchmarks / CI smoke
    read this): component counts, physical rows touched vs. skipped, and the
    intra-component block tally of the second pruning level."""
    components = pruned = 0
    rows_pruned = tombstones_retained = 0
    blocks_total = blocks_scanned = 0
    shards = 1
    shard_probes = 0
    compaction_recommended = False
    stall_pressure = 0.0
    stall_imminent = False
    for node in walk(root):
        shards = max(shards, getattr(node, "shards", 1),
                     getattr(node, "n_shards", 1))
        shard_probes += getattr(node, "shard_probes", 0)
        if getattr(node, "compaction_recommended", False):
            compaction_recommended = True
        stall_pressure = max(stall_pressure,
                             getattr(node, "stall_pressure", 0.0))
        if getattr(node, "stall_imminent", False):
            stall_imminent = True
        bt = getattr(node, "blocks_total", 0)
        if bt:
            blocks_total += bt
            blocks_scanned += getattr(node, "blocks_scanned", bt)
        p = getattr(node, "pruned", None)
        if p is None:
            continue
        components += len(node.children) + len(p)
        pruned += len(p)
        rows_pruned += sum(pc.rows for pc in p)
        tombstones_retained += sum(pc.tombstones for pc in p)
    rows_touched = sum(int(n.rows_touched) for n in walk(root)
                       if getattr(n, "source_key", None) is not None)
    return {"components": components, "pruned": pruned,
            "rows_pruned": rows_pruned, "rows_touched": rows_touched,
            "tombstones_retained": tombstones_retained,
            "blocks_total": blocks_total, "blocks_scanned": blocks_scanned,
            "blocks_skipped": blocks_total - blocks_scanned,
            "shards": shards, "shard_probes": shard_probes,
            "compaction_recommended": compaction_recommended,
            "stall_pressure": stall_pressure,
            "stall_imminent": stall_imminent,
            "total_cost": root.total_cost()}
