"""Logical query plan (port of ``repro.core.plan``).

The AFrame object never executes anything; each DataFrame operation wraps the
previous plan in a new node (the paper's "incremental query formation",
§III-B). ``to_sql()`` renders the equivalent SQL++ for ``AFrame.query``;
``fingerprint()`` keys the compiled-executable cache (literal values excluded
— they are runtime parameters, so the benchmark's randomized predicates reuse
one executable).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core.expr import Col, Expr

AGG_OPS = ("count", "sum", "max", "min", "mean")


class Plan:
    children: tuple["Plan", ...] = ()

    def fingerprint(self) -> str:
        raise NotImplementedError

    def to_sql(self) -> str:
        raise NotImplementedError

    def exprs(self) -> list[Expr]:
        return []

    # required output columns -> required input columns; used by the
    # projection-pushdown rule.
    def required_columns(self) -> set[str]:
        out: set[str] = set()
        for e in self.exprs():
            out |= e.columns()
        return out


@dataclasses.dataclass(frozen=True)
class AggSpec:
    out_name: str
    op: str  # one of AGG_OPS
    column: Optional[str]  # None for count(*)

    def fingerprint(self) -> str:
        return f"{self.out_name}={self.op}({self.column})"

    def to_sql(self) -> str:
        arg = f"t.{self.column}" if self.column else "*"
        return f"{self.op.upper()}({arg}) AS {self.out_name}"


class Scan(Plan):
    def __init__(self, dataset: str, dataverse: str = "Default"):
        self.dataset, self.dataverse = dataset, dataverse

    def fingerprint(self):
        return f"scan({self.dataverse}.{self.dataset})"

    def to_sql(self):
        return f"SELECT VALUE t FROM {self.dataverse}.{self.dataset} t"

    def _from(self):
        return f"FROM {self.dataverse}.{self.dataset} t"


class Filter(Plan):
    def __init__(self, child: Plan, predicate: Expr):
        self.children, self.predicate = (child,), predicate

    def fingerprint(self):
        return f"filter({self.predicate.fingerprint()},{self.children[0].fingerprint()})"

    def exprs(self):
        return [self.predicate]

    def to_sql(self):
        return f"SELECT VALUE t FROM ({self.children[0].to_sql()}) t WHERE {self.predicate.to_sql()}"


class Project(Plan):
    """Named output expressions (projection, derived columns, UDF columns)."""

    def __init__(self, child: Plan, outputs: Sequence[tuple[str, Expr]]):
        self.children, self.outputs = (child,), tuple(outputs)

    def fingerprint(self):
        items = ",".join(f"{n}:{e.fingerprint()}" for n, e in self.outputs)
        return f"project([{items}],{self.children[0].fingerprint()})"

    def exprs(self):
        return [e for _, e in self.outputs]

    def to_sql(self):
        cols = ", ".join(
            e.to_sql() if (isinstance(e, Col) and e.name == n) else f"{e.to_sql()} AS {n}"
            for n, e in self.outputs
        )
        return f"SELECT {cols} FROM ({self.children[0].to_sql()}) t"


class Limit(Plan):
    def __init__(self, child: Plan, n: int):
        self.children, self.n = (child,), int(n)

    def fingerprint(self):
        return f"limit({self.n},{self.children[0].fingerprint()})"

    def to_sql(self):
        return f"{self.children[0].to_sql()} LIMIT {self.n}"


class Sort(Plan):
    def __init__(self, child: Plan, key: str, ascending: bool = True):
        self.children, self.key, self.ascending = (child,), key, ascending

    def fingerprint(self):
        return f"sort({self.key},{self.ascending},{self.children[0].fingerprint()})"

    def required_columns(self):
        return {self.key}

    def to_sql(self):
        d = "ASC" if self.ascending else "DESC"
        return f"SELECT VALUE t FROM ({self.children[0].to_sql()}) t ORDER BY t.{self.key} {d}"


class TopK(Plan):
    """Sort + Limit fused by the optimizer (the distributed-limit-pushdown
    the paper gets from AsterixDB's ORDER BY ... LIMIT rewrite)."""

    def __init__(self, child: Plan, key: str, k: int, ascending: bool):
        self.children, self.key, self.k, self.ascending = (child,), key, int(k), ascending

    def fingerprint(self):
        return f"topk({self.key},{self.k},{self.ascending},{self.children[0].fingerprint()})"

    def required_columns(self):
        return {self.key}

    def to_sql(self):
        d = "ASC" if self.ascending else "DESC"
        return (
            f"SELECT VALUE t FROM ({self.children[0].to_sql()}) t "
            f"ORDER BY t.{self.key} {d} LIMIT {self.k}"
        )


class GroupAgg(Plan):
    def __init__(self, child: Plan, keys: Sequence[str], aggs: Sequence[AggSpec]):
        self.children, self.keys, self.aggs = (child,), tuple(keys), tuple(aggs)

    def fingerprint(self):
        a = ",".join(s.fingerprint() for s in self.aggs)
        return f"groupagg({self.keys},[{a}],{self.children[0].fingerprint()})"

    def required_columns(self):
        cols = set(self.keys)
        for s in self.aggs:
            if s.column:
                cols.add(s.column)
        return cols

    def to_sql(self):
        key_sql = ", ".join(f"t.{k} AS grp_{k}" for k in self.keys)
        aggs = ", ".join(s.to_sql() for s in self.aggs)
        keys = ", ".join(f"t.{k}" for k in self.keys)
        return (
            f"SELECT {key_sql}, {aggs} FROM ({self.children[0].to_sql()}) t "
            f"GROUP BY {keys}"
        )


class Agg(Plan):
    """Global (scalar) aggregation: len(df), df['x'].max(), describe()."""

    def __init__(self, child: Plan, aggs: Sequence[AggSpec]):
        self.children, self.aggs = (child,), tuple(aggs)

    def fingerprint(self):
        a = ",".join(s.fingerprint() for s in self.aggs)
        return f"agg([{a}],{self.children[0].fingerprint()})"

    def required_columns(self):
        return {s.column for s in self.aggs if s.column}

    def to_sql(self):
        if len(self.aggs) == 1 and self.aggs[0].op == "count" and self.aggs[0].column is None:
            return f"SELECT VALUE COUNT(*) FROM ({self.children[0].to_sql()}) t"
        aggs = ", ".join(s.to_sql() for s in self.aggs)
        return f"SELECT {aggs} FROM ({self.children[0].to_sql()}) t"


class Join(Plan):
    def __init__(self, left: Plan, right: Plan, left_on: str, right_on: str, how: str = "inner"):
        assert how == "inner", "only inner equi-joins (paper expression 12)"
        self.children = (left, right)
        self.left_on, self.right_on, self.how = left_on, right_on, how

    def fingerprint(self):
        return (
            f"join({self.left_on}={self.right_on},{self.how},"
            f"{self.children[0].fingerprint()},{self.children[1].fingerprint()})"
        )

    def to_sql(self):
        return (
            f"SELECT l, r FROM ({self.children[0].to_sql()}) l "
            f"JOIN ({self.children[1].to_sql()}) r ON l.{self.left_on} = r.{self.right_on}"
        )


# -- fused logical nodes introduced by the optimizer ------------------------
# (Access paths — index probes, kernel launches, run pruning — are PHYSICAL
# decisions and live in core/physical.py; these nodes only record semantic
# fusions like "this aggregate is a COUNT over a filter".)


class UnionRuns(Plan):
    """Base ∪ runs over a fed (LSM) dataset: children are the per-component
    streams (a Scan of the base plus one Scan per device-resident run, or
    whatever row-wise operators the optimizer pushed into them). Lowering
    concatenates component streams; results are identical to executing the
    same plan over the compacted dataset — the LSM read invariant."""

    def __init__(self, children: Sequence[Plan]):
        self.children = tuple(children)

    def fingerprint(self):
        inner = ",".join(c.fingerprint() for c in self.children)
        return f"unionruns({inner})"

    def required_columns(self):
        out: set[str] = set()
        for c in self.children:
            out |= c.required_columns()
        return out

    def to_sql(self):
        return " UNION ALL ".join(f"({c.to_sql()})" for c in self.children)


class UnionScalar(Plan):
    """Merge of per-component scalar aggregates over an LSM union: each child
    is a scalar-terminal plan (FilterCount / FusedRangeCount / Agg) over one
    component; ``merges`` maps each output name to its merge operator
    ('sum' for counts and sums, 'min'/'max' for extremes). This is what lets
    per-component index probes and kernel launches compose with a final
    psum-style merge instead of materializing the union."""

    def __init__(self, children: Sequence[Plan], merges: Sequence[tuple[str, str]]):
        self.children = tuple(children)
        self.merges = tuple(merges)

    def fingerprint(self):
        m = ",".join(f"{n}:{op}" for n, op in self.merges)
        inner = ",".join(c.fingerprint() for c in self.children)
        return f"unionscalar([{m}],{inner})"

    def to_sql(self):
        parts = " UNION ALL ".join(f"({c.to_sql()})" for c in self.children)
        aggs = ", ".join(
            f"{'SUM' if op == 'sum' else op.upper()}(t.{n}) AS {n}"
            for n, op in self.merges)
        return f"SELECT {aggs} FROM ({parts}) t"


# -- fused logical nodes introduced by the optimizer ------------------------
# (Access paths — index probes, kernel launches, run pruning — are PHYSICAL
# decisions and live in core/physical.py; these nodes only record semantic
# fusions like "this aggregate is a COUNT over a filter".)


class FilterCount(Plan):
    """Fused filter+count node: the physical planner lowers it onto the
    ``filter_count`` kernel or a generic mask count."""

    def __init__(self, child: Plan, predicate: Expr | None):
        self.children, self.predicate = (child,), predicate

    def exprs(self):
        return [self.predicate] if self.predicate is not None else []

    def fingerprint(self):
        p = self.predicate.fingerprint() if self.predicate else "true"
        return f"filtercount({p},{self.children[0].fingerprint()})"

    def to_sql(self):
        base = self.children[0].to_sql()
        if self.predicate is None:
            return f"SELECT VALUE COUNT(*) FROM ({base}) t"
        return f"SELECT VALUE COUNT(*) FROM ({base}) t WHERE {self.predicate.to_sql()}"


class JoinCount(Plan):
    """Fused join+count (paper expression 12: ``len(pd.merge(...))``)."""

    def __init__(self, left: Plan, right: Plan, left_on: str, right_on: str):
        self.children = (left, right)
        self.left_on, self.right_on = left_on, right_on

    def fingerprint(self):
        return (
            f"joincount({self.left_on}={self.right_on},"
            f"{self.children[0].fingerprint()},{self.children[1].fingerprint()})"
        )

    def to_sql(self):
        return (
            f"SELECT VALUE COUNT(*) FROM (SELECT l, r FROM ({self.children[0].to_sql()}) l "
            f"JOIN ({self.children[1].to_sql()}) r ON l.{self.left_on} = r.{self.right_on}) t"
        )


def walk(plan: Plan):
    yield plan
    for c in plan.children:
        yield from walk(c)


def all_exprs(plan: Plan) -> list[Expr]:
    out = []
    for node in walk(plan):
        out.extend(node.exprs())
    return out
