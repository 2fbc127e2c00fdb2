"""Physical query plans — what the cost-based planner hands the compiler
(port of ``repro.core.physical``, the operators a closed base dataset uses).

Each node carries its cost annotations (``est_rows``, ``rows_touched``,
``cost``, ``note``). ``fingerprint()`` keys the compiled-query dedup cache:
two logical plans the planner maps to the same physical shape share one
compiled query, literal values staying runtime parameters. ``format_plan``
renders the tree ``explain()`` shows.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.expr import Expr


class PhysOp:
    """Base physical operator. ``children`` are other PhysOps; cost fields
    are filled by the planner."""

    children: tuple["PhysOp", ...] = ()
    est_rows: float = 0.0
    rows_touched: float = 0.0
    cost: float = 0.0
    note: str = ""

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
    """Dataset keys the physical plan reads."""
    keys: list[tuple[str, str]] = []
    for n in walk(node):
        key = getattr(n, "source_key", None)
        if key is not None and key not in keys:
            keys.append(key)
    return keys


def _blocks_fp(block_ids) -> str:
    # surviving-block lists are static plan structure (kernel grids and
    # gather slices bake them in), so they are part of the fingerprint
    return "all" if block_ids is None else ",".join(map(str, block_ids))


class _BlockSkip:
    """Mixin state for operators that skip zone-map-pruned blocks:
    ``block_ids`` is the ascending tuple of surviving block indices (None =
    scan everything), ``zone_block`` the block size in rows,
    ``blocks_total`` the component's block count, ``blocks_scanned`` what
    the operator actually reads."""

    block_ids: Optional[tuple] = None
    zone_block: int = 0
    blocks_total: int = 0
    blocks_scanned: int = 0

    def set_blocks(self, block_ids, zone_block: int, total: int) -> None:
        self.block_ids = tuple(block_ids) if block_ids is not None else None
        self.zone_block = int(zone_block)
        self.blocks_total = int(total)
        self.blocks_scanned = total if block_ids is None else len(block_ids)

    def block_note(self) -> str:
        skipped = self.blocks_total - self.blocks_scanned
        return (f"zone maps: {self.blocks_scanned}/{self.blocks_total} "
                f"block(s) scanned, {skipped} skipped")


# -- stream operators (produce (env, mask)) ---------------------------------


class TableScan(PhysOp, _BlockSkip):
    """Full component scan; with ``block_ids`` the lowering streams only
    the surviving row blocks (sound because every conjunct the list derives
    from is applied above this scan)."""

    def __init__(self, dataverse: str, dataset: str):
        self.dataverse, self.dataset = dataverse, dataset

    @property
    def source_key(self):
        return (self.dataverse, self.dataset)

    def fingerprint(self):
        return (f"p:scan({self.dataverse}.{self.dataset},"
                f"blk:{_blocks_fp(self.block_ids)})")

    def label(self):
        out = f"TableScan {self.dataverse}.{self.dataset}"
        if self.blocks_total and self.blocks_scanned < self.blocks_total:
            out += f" [blocks {self.blocks_scanned}/{self.blocks_total}]"
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


# -- grouped operators -------------------------------------------------------


class GroupAggGeneric(PhysOp):
    """Bounded-domain group-by via segment reductions; the domain
    [lo, lo+num_groups) comes from planner stats."""

    def __init__(self, child: PhysOp, key: str, lo: int, num_groups: int, aggs):
        self.children = (child,)
        self.key, self.lo, self.num_groups = key, int(lo), int(num_groups)
        self.aggs = tuple(aggs)

    def fingerprint(self):
        a = ",".join(s.fingerprint() for s in self.aggs)
        return (f"p:groupagg({self.key},{self.lo},{self.num_groups},[{a}],"
                f"{self.children[0].fingerprint()})")

    def label(self):
        return (f"GroupAgg {self.key} G={self.num_groups} "
                f"[{', '.join(s.op for s in self.aggs)}] [segment-reduce]")


class KernelSegmentAgg(PhysOp):
    """Group-by lowered onto the segment_agg kernel: one fused launch for
    the sum family (count/sum/mean share one (n, C) value tile) plus one per
    extreme family. Chosen only under a static f32-exactness proof.

    ``comp_blocks[i]`` is component i's surviving-block list (zone-block
    units; None = all), hoisted off its TableScan so the kernel grid itself
    skips pruned tiles instead of the stream gathering a copy first."""

    comp_blocks: tuple = ()

    def __init__(self, comps: Sequence[PhysOp], key: str, lo: int,
                 num_groups: int, aggs):
        self.children = tuple(comps)
        self.key, self.lo, self.num_groups = key, int(lo), int(num_groups)
        self.aggs = tuple(aggs)

    def fingerprint(self):
        a = ",".join(s.fingerprint() for s in self.aggs)
        inner = ",".join(c.fingerprint() for c in self.children)
        blk = ";".join(_blocks_fp(b) for b in self.comp_blocks) \
            if self.comp_blocks else "all"
        return (f"p:ksegagg({self.key},{self.lo},{self.num_groups},[{a}],"
                f"blk:{blk},{inner})")

    def label(self):
        return (f"KernelSegmentAgg {self.key} G={self.num_groups} "
                f"[{', '.join(s.op for s in self.aggs)}] [segment_agg kernel]")


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


class KernelRangeCount(PhysOp, _BlockSkip):
    """COUNT of conjunctive inclusive ranges over integer columns lowered
    onto the filter_count kernel: one int32 pass over each distinct column,
    bounds as a (k, 2) runtime operand, no mask column in device memory.
    ``los[j]`` / ``his[j]``: the bounds of ``cols[j]`` from below / above
    (the column's lower bound is their max, its upper bound their min; an
    empty side is open). A ``__valid__`` padding column folds in as one
    extra kernel column with bounds (1, 1). ``block_ids`` makes the kernel
    grid visit the surviving blocks only."""

    def __init__(self, dataverse: str, dataset: str, cols: Sequence[str],
                 los: Sequence[Sequence[Expr]], his: Sequence[Sequence[Expr]],
                 has_valid: bool):
        self.dataverse, self.dataset = dataverse, dataset
        self.cols = tuple(cols)
        self.los = tuple(tuple(x) for x in los)
        self.his = tuple(tuple(x) for x in his)
        self.has_valid = has_valid

    @property
    def source_key(self):
        return (self.dataverse, self.dataset)

    def exprs(self):
        out: list[Expr] = []
        for lo, hi in zip(self.los, self.his):
            out.extend(lo + hi)
        return out

    def fingerprint(self):
        # the bound counts fix the param slots' meaning (x >= a and x <= a
        # must not share a compiled query)
        cols = ",".join(f"{c}:{len(lo)}/{len(hi)}"
                        for c, lo, hi in zip(self.cols, self.los, self.his))
        return (f"p:krangecount({self.dataverse}.{self.dataset},"
                f"[{cols}],{int(self.has_valid)},"
                f"blk:{_blocks_fp(self.block_ids)})")

    def label(self):
        out = (f"KernelRangeCount {self.dataverse}.{self.dataset} "
               f"[{', '.join(self.cols)}] [filter_count kernel]")
        if self.blocks_total and self.blocks_scanned < self.blocks_total:
            out += f" [blocks {self.blocks_scanned}/{self.blocks_total}]"
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
    """Fused join+count; ``kernel`` lowers onto merge_join_count (int32-safe
    proof required)."""

    def __init__(self, left: PhysOp, right: PhysOp, left_on: str, right_on: str,
                 kernel: bool = False):
        self.children = (left, right)
        self.left_on, self.right_on = left_on, right_on
        self.kernel = kernel

    def fingerprint(self):
        return (f"p:joincount({self.left_on}={self.right_on},"
                f"{int(self.kernel)},"
                f"{self.children[0].fingerprint()},{self.children[1].fingerprint()})")

    def label(self):
        how = "merge_join kernel" if self.kernel else "sort+searchsorted"
        return f"JoinCount {self.left_on} = {self.right_on} [{how}]"


# -- explain rendering --------------------------------------------------------


def format_plan(root: PhysOp) -> str:
    """The ``explain()`` rendering: one line per operator with its cost
    estimates and the planner's rationale, as a nested tree."""
    lines: list[str] = []

    def emit(node: PhysOp, prefix: str, is_last: bool, is_root: bool):
        branch = "" if is_root else ("└─ " if is_last else "├─ ")
        meta = f"cost={node.cost:,.0f} rows≈{node.est_rows:,.0f}"
        if node.rows_touched and node.rows_touched != node.est_rows:
            meta += f" touched={node.rows_touched:,.0f}"
        lines.append(f"{prefix}{branch}{node.label()}  [{meta}]")
        child_prefix = prefix if is_root else prefix + ("   " if is_last else "│  ")
        if node.note:
            lines.append(f"{child_prefix}· {node.note}")
        for i, c in enumerate(node.children):
            emit(c, child_prefix, i == len(node.children) - 1, False)

    emit(root, "", True, True)
    lines.append(f"total estimated cost: {root.total_cost():,.0f}")
    return "\n".join(lines)


def prune_report(root: PhysOp) -> dict:
    """Block-skipping tally over a physical plan (benchmarks read this)."""
    blocks_total = blocks_scanned = 0
    for node in walk(root):
        bt = getattr(node, "blocks_total", 0)
        if bt:
            blocks_total += bt
            blocks_scanned += getattr(node, "blocks_scanned", bt)
    rows_touched = sum(int(n.rows_touched) for n in walk(root)
                       if getattr(n, "source_key", None) is not None)
    return {"rows_touched": rows_touched,
            "blocks_total": blocks_total, "blocks_scanned": blocks_scanned,
            "blocks_skipped": blocks_total - blocks_scanned,
            "total_cost": root.total_cost()}
