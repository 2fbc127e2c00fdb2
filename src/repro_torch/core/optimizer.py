"""Rule-based *logical* optimizer (port of ``repro.core.optimizer``).

It decides *what* to compute, never *how* (that is the physical planner's
job). Rules, applied bottom-up to a fixpoint:
  1. ``fuse_filters``   — Filter(Filter(x, a), b)   -> Filter(x, a AND b)
  2. ``pushdown_limit`` — Limit(Project(x), n)      -> Project(Limit(x, n))
                          Limit(Sort(x), n)         -> TopK(x, n)
     (the paper's lazy-evaluation win on expressions 5 / 10: the map runs
     on n rows, not the dataset)
  3. ``fuse_agg``       — Agg[count*](Filter(x, p)) -> FilterCount(x, p)
                          Agg[count*](Join(l, r))   -> JoinCount(l, r)
  4. ``prune_columns``  — narrow Projects above Scans so only referenced
     columns are touched.
The LSM feed expansion and union pushdown of the reference wait for the
storage slice (ROADMAP A6): this slice's datasets have no runs.
"""
from __future__ import annotations

import copy

import numpy as np

from repro_torch.core import plan as P
from repro_torch.core.catalog import INTERNAL_COLUMNS, Catalog
from repro_torch.core.expr import BoolOp, Col, Compare, Expr, Lit
from repro_torch.engine.table import dict_lane_name, is_lane_column

# Sentinel bounds for one-sided ranges: the filter_count kernel works on
# int32 column tiles, so the sentinels are the int32 domain edges.
_RANGE_MIN = int(np.iinfo(np.int32).min)
_RANGE_MAX = int(np.iinfo(np.int32).max)


def optimize(root: P.Plan, catalog: Catalog | None = None) -> P.Plan:
    prev_fp = None
    node = root
    for _ in range(12):  # fixpoint with a safety bound
        node = _rewrite(node, _fuse_filters)
        node = _rewrite(node, _pushdown_limit)
        node = _rewrite(node, _fuse_agg)
        fp = node.fingerprint()
        if fp == prev_fp:
            break
        prev_fp = fp
    if catalog is not None:
        node = _prune_columns(node, catalog)
    return _uniquify(node, set())


def _uniquify(node: P.Plan, seen: set[int]) -> P.Plan:
    """Make the optimized plan a proper tree: clone every node reachable
    twice (derived frames share Scans; a self-join shares subtrees), since
    the physical planner keys per-scan state by object identity. Expr
    objects stay shared — literal slots are bound by Expr identity."""
    clone = copy.copy(node) if id(node) in seen else node
    seen.add(id(clone))
    kids = tuple(_uniquify(c, seen) for c in clone.children)
    if kids != tuple(clone.children):
        if clone is node:  # never mutate a node the raw plan still owns
            clone = copy.copy(node)
            seen.add(id(clone))
        clone.children = kids
    return clone


def _rewrite(node: P.Plan, rule) -> P.Plan:
    new_children = tuple(_rewrite(c, rule) for c in node.children)
    if new_children != node.children:
        node = _with_children(node, new_children)
    out = rule(node)
    return out if out is not None else node


def _with_children(node: P.Plan, children: tuple[P.Plan, ...]) -> P.Plan:
    clone = copy.copy(node)
    clone.children = children
    return clone


# -- rules -------------------------------------------------------------------


def _fuse_filters(node: P.Plan):
    if isinstance(node, P.Filter) and isinstance(node.children[0], P.Filter):
        inner = node.children[0]
        return P.Filter(inner.children[0], BoolOp("AND", inner.predicate, node.predicate))
    return None


def _pushdown_limit(node: P.Plan):
    if not isinstance(node, P.Limit):
        return None
    child = node.children[0]
    if isinstance(child, P.Project):
        return P.Project(P.Limit(child.children[0], node.n), child.outputs)
    if isinstance(child, P.Sort):
        return P.TopK(child.children[0], child.key, node.n, child.ascending)
    if isinstance(child, P.Limit):
        return P.Limit(child.children[0], min(node.n, child.n))
    return None


def _fuse_agg(node: P.Plan):
    if not isinstance(node, P.Agg):
        return None
    if len(node.aggs) == 1 and node.aggs[0].op == "count" and node.aggs[0].column is None:
        child = node.children[0]
        if isinstance(child, P.Filter):
            return P.FilterCount(child.children[0], child.predicate)
        if isinstance(child, P.Join):
            return P.JoinCount(child.children[0], child.children[1],
                               child.left_on, child.right_on)
        if isinstance(child, P.Scan):
            return P.FilterCount(child, None)
    return None


def _split_conjuncts(e: Expr) -> list[Expr]:
    if isinstance(e, BoolOp) and e.op == "AND":
        return _split_conjuncts(e.children[0]) + _split_conjuncts(e.children[1])
    return [e]


def _range_bounds(conjuncts: list[Expr], column: str):
    """Extract (lo, hi, residual_conjuncts) for ``column`` from conjuncts of
    the form Col <cmp> Lit. Returns None if no usable bound exists."""
    lo = hi = None
    residual: list[Expr] = []
    for c in conjuncts:
        used = False
        if isinstance(c, Compare):
            l, r = c.children
            if isinstance(l, Col) and l.name == column and isinstance(r, Lit):
                if c.op == "==":
                    # never alias one Lit as both bounds: the executable's two
                    # param slots must map to two distinct Lit objects
                    lo, hi = r, Lit(r.value, source=r)
                    used = True
                elif c.op == ">=":
                    lo = r
                    used = True
                elif c.op == "<=":
                    hi = r
                    used = True
        if not used:
            residual.append(c)
    if lo is None and hi is None:
        return None
    return lo, hi, residual


# -- projection pushdown ------------------------------------------------------


def _prune_columns(node: P.Plan, catalog: Catalog, needed: set[str] | None = None) -> P.Plan:
    """Top-down pass: compute the columns each subtree must produce and wrap
    Scans in narrow Projects. ``needed=None`` means "all columns"."""
    if isinstance(node, P.Scan):
        if needed is None:
            return node
        ds = catalog.get(node.dataverse, node.dataset)
        names = ds.table.column_names()
        cols = [c for c in names
                if c in needed and c not in INTERNAL_COLUMNS
                and not is_lane_column(c)]
        if set(cols) >= set(n for n in names if n not in INTERNAL_COLUMNS
                            and not is_lane_column(n)):
            return node
        # selected string columns keep their dict lanes riding along
        lanes = [dict_lane_name(c) for c in cols
                 if dict_lane_name(c) in names]
        return P.Project(node, [(c, Col(c)) for c in cols + lanes])

    if isinstance(node, P.Project):
        child_needed = set()
        for _, e in node.outputs:
            child_needed |= e.columns()
        kids = (_prune_columns(node.children[0], catalog, child_needed),)
        return _with_children(node, kids)

    if isinstance(node, (P.Filter, P.FilterCount)):
        child_needed = None
        if needed is not None:
            child_needed = set(needed)
            for e in node.exprs():
                child_needed |= e.columns()
        kids = (_prune_columns(node.children[0], catalog, child_needed),)
        return _with_children(node, kids)

    if isinstance(node, (P.Agg, P.GroupAgg, P.TopK, P.Sort)):
        child_needed = node.required_columns() if isinstance(node, (P.Agg, P.GroupAgg)) else None
        if isinstance(node, (P.TopK, P.Sort)):
            child_needed = None if needed is None else (set(needed) | node.required_columns())
        kids = (_prune_columns(node.children[0], catalog, child_needed),)
        return _with_children(node, kids)

    if isinstance(node, (P.Join, P.JoinCount)):
        if isinstance(node, P.JoinCount):
            ln, rn = {node.left_on}, {node.right_on}
        else:
            ln = None if needed is None else set(needed) | {node.left_on}
            rn = None if needed is None else set(needed) | {node.right_on}
        kids = (
            _prune_columns(node.children[0], catalog, ln),
            _prune_columns(node.children[1], catalog, rn),
        )
        return _with_children(node, kids)

    kids = tuple(_prune_columns(c, catalog, None) for c in node.children)
    return _with_children(node, kids) if kids != node.children else node
