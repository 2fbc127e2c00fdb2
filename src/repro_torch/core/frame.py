"""AFrame — the Pandas-like lazy DataFrame over the engine (port of
``repro.core.frame``, paper §III).

Every operation wraps the current logical plan in a new node; nothing
executes until an *action* (head / collect / len / agg). ``.query`` shows
the SQL++ the paper's AFrame would have sent.

    >>> df = AFrame("bench", "data", session=Session(mode="kernel"))
    >>> len(df[(df["ten"] == 3) & (df["two"] == 1)])   # filter_count kernel
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

from repro_torch.core import plan as P
from repro_torch.core.expr import (Arith, BoolOp, Col, Compare, ElementwiseUDF,
                                   Expr, IsIn, IsKnown, ModelUDF, Not,
                                   StrLower, StrUpper, wrap)


class ColumnExpr:
    """A column-level expression bound to a source AFrame (Pandas Series
    analogue). Comparisons and arithmetic build Exprs; aggregations run."""

    def __init__(self, frame: "AFrame", expr: Expr, name: str):
        self._frame = frame
        self.expr = expr
        self.name = name

    def _wrap(self, e: Expr, name: str) -> "ColumnExpr":
        return ColumnExpr(self._frame, e, name)

    def __eq__(self, other):  # type: ignore[override]
        return self._wrap(Compare("==", self.expr, wrap(_unbox(other))), self.name)

    def __ne__(self, other):  # type: ignore[override]
        return self._wrap(Compare("!=", self.expr, wrap(_unbox(other))), self.name)

    def __lt__(self, other):
        return self._wrap(Compare("<", self.expr, wrap(_unbox(other))), self.name)

    def __le__(self, other):
        return self._wrap(Compare("<=", self.expr, wrap(_unbox(other))), self.name)

    def __gt__(self, other):
        return self._wrap(Compare(">", self.expr, wrap(_unbox(other))), self.name)

    def __ge__(self, other):
        return self._wrap(Compare(">=", self.expr, wrap(_unbox(other))), self.name)

    def __and__(self, other):
        return self._wrap(BoolOp("AND", self.expr, _unbox_expr(other)), self.name)

    def __or__(self, other):
        return self._wrap(BoolOp("OR", self.expr, _unbox_expr(other)), self.name)

    def __invert__(self):
        return self._wrap(Not(self.expr), self.name)

    def __add__(self, other):
        return self._wrap(Arith("+", self.expr, wrap(_unbox(other))), self.name)

    def __sub__(self, other):
        return self._wrap(Arith("-", self.expr, wrap(_unbox(other))), self.name)

    def __mul__(self, other):
        return self._wrap(Arith("*", self.expr, wrap(_unbox(other))), self.name)

    def __mod__(self, other):
        return self._wrap(Arith("%", self.expr, wrap(_unbox(other))), self.name)

    def __truediv__(self, other):
        return self._wrap(Arith("/", self.expr, wrap(_unbox(other))), self.name)

    def __hash__(self):
        return id(self)

    def notna(self) -> "ColumnExpr":
        return self._wrap(IsKnown(self.expr), self.name)

    def isin(self, values: Sequence[Any]) -> "ColumnExpr":
        return self._wrap(IsIn(self.expr, [wrap(_unbox(v)) for v in values]),
                          self.name)

    def map(self, fn: Any, name: Optional[str] = None) -> "ColumnExpr":
        """Apply a function elementwise — the paper's §III-C UDF application.
        Accepts ``str.upper``/``str.lower``, any torch callable, or a
        registered model-UDF name / ModelHandle."""
        from repro_torch.udf.model_udf import ModelHandle

        if fn is str.upper:
            return self._wrap(StrUpper(self.expr), self.name)
        if fn is str.lower:
            return self._wrap(StrLower(self.expr), self.name)
        if isinstance(fn, ModelHandle):
            return self._wrap(ModelUDF(fn.name, self.expr), name or fn.name)
        if isinstance(fn, str):
            return self._wrap(ModelUDF(fn, self.expr), name or fn)
        if callable(fn):
            return self._wrap(ElementwiseUDF(fn, name or getattr(fn, "__name__", "udf"),
                                             self.expr), self.name)
        raise TypeError(f"cannot map {fn!r}")

    @property
    def str(self) -> "_StrOps":
        return _StrOps(self)

    # -- actions ---------------------------------------------------------------
    def _agg(self, op: str):
        plan = P.Agg(self._frame._project_plan([(self.name, self.expr)]),
                     [P.AggSpec(op, op, self.name if op != "count" else None)])
        return self._frame._session.execute(plan)

    def max(self):
        return self._agg("max")

    def min(self):
        return self._agg("min")

    def sum(self):
        return self._agg("sum")

    def mean(self):
        return self._agg("mean")

    def count(self):
        return self._agg("count")

    def head(self, n: int = 5) -> dict[str, np.ndarray]:
        return AFrame._from_plan(
            self._frame, self._frame._project_plan([(self.name, self.expr)])).head(n)

    @property
    def query(self) -> str:
        return self._frame._project_plan([(self.name, self.expr)]).to_sql()


class _StrOps:
    def __init__(self, col: ColumnExpr):
        self._col = col

    def upper(self) -> ColumnExpr:
        return self._col.map(str.upper)

    def lower(self) -> ColumnExpr:
        return self._col.map(str.lower)


def _unbox(v):
    return v.expr if isinstance(v, ColumnExpr) else v


def _unbox_expr(v) -> Expr:
    return v.expr if isinstance(v, ColumnExpr) else wrap(v)


class AFrame:
    """The lazy DataFrame. Construct from a registered dataset (O(1): the
    data is managed, no file scan) or internally from a plan."""

    def __init__(self, dataverse: str, dataset: Optional[str] = None, *,
                 session=None, plan: Optional[P.Plan] = None):
        if session is None:
            raise ValueError("AFrame needs a Session (the engine connection)")
        self._session = session
        if plan is None:
            session.catalog.get(dataverse, dataset)  # must exist
            plan = P.Scan(dataset, dataverse)
        self._plan = plan
        self._dataverse = dataverse

    @staticmethod
    def _from_plan(like: "AFrame", plan: P.Plan) -> "AFrame":
        return AFrame(like._dataverse, session=like._session, plan=plan)

    @property
    def query(self) -> str:
        """The underlying SQL++ (paper Inputs 7/8)."""
        return self._plan.to_sql() + ";"

    @property
    def optimized_query(self) -> str:
        from repro_torch.core.optimizer import optimize
        return optimize(self._plan, self._session.catalog).to_sql() + ";"

    def query_in(self, dialect: str) -> str:
        """Render the plan in another engine's dialect (paper §VI:
        language-layer abstraction; 'postgres' supported)."""
        from repro_torch.core.dialect import render
        return render(self._plan, dialect)

    def explain(self, analyze: bool = False) -> str:
        """The costed physical plan: per-operator cost estimates, the access
        path the planner chose over its alternatives, and — over a fed
        dataset — which LSM runs the zone maps pruned and why.

        ``analyze=True`` executes the query and adds measured per-operator
        wall time and actual rows beside the estimates (``Session.profile``)."""
        return self._session.explain(self._plan, analyze=analyze)

    def profile(self) -> dict:
        """Execute with per-operator measurement: returns ``{"text",
        "result", "measures", "prune_report"}``."""
        return self._session.profile(self._plan)

    def _project_plan(self, outputs) -> P.Plan:
        return P.Project(self._plan, outputs)

    # -- pandas surface ------------------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, str):
            return ColumnExpr(self, Col(key), key)
        if isinstance(key, list):
            return AFrame._from_plan(self, P.Project(
                self._plan, [(k, Col(k)) for k in key]))
        if isinstance(key, ColumnExpr):
            return AFrame._from_plan(self, P.Filter(self._plan, key.expr))
        raise TypeError(f"cannot index AFrame with {type(key)}")

    def __setitem__(self, name: str, value: ColumnExpr):
        """df['x2'] = df['x'] * 2 — extends the projection."""
        expr = value.expr if isinstance(value, ColumnExpr) else wrap(value)
        cols = self._current_columns()
        outputs = [(c, Col(c)) for c in cols if c != name] + [(name, expr)]
        self._plan = P.Project(self._plan, outputs)

    def _current_columns(self) -> list[str]:
        from repro_torch.core.catalog import INTERNAL_COLUMNS
        from repro_torch.engine.table import is_lane_column

        node = self._plan
        while True:
            if isinstance(node, P.Project):
                return [n for n, _ in node.outputs]
            if isinstance(node, P.Scan):
                ds = self._session.catalog.get(node.dataverse, node.dataset)
                return [c for c in ds.table.column_names()
                        if c not in INTERNAL_COLUMNS and not is_lane_column(c)]
            if not node.children:
                raise ValueError("cannot infer columns")
            node = node.children[0]

    def __len__(self) -> int:
        return int(self._session.execute(
            P.Agg(self._plan, [P.AggSpec("count", "count", None)])))

    # -- transformations -------------------------------------------------------------
    def sort_values(self, by: str, ascending: bool = True) -> "AFrame":
        return AFrame._from_plan(self, P.Sort(self._plan, by, ascending))

    def merge(self, other: "AFrame", left_on: str, right_on: str,
              how: str = "inner") -> "AFrame":
        return AFrame._from_plan(self, P.Join(self._plan, other._plan,
                                              left_on, right_on, how))

    def groupby(self, key: str) -> "GroupBy":
        return GroupBy(self, key)

    def window(self, order_by: str, partition_by: Optional[str] = None,
               ascending: bool = True) -> "WindowBuilder":
        """Window functions (the paper's §VI future-work item):

            df['rn'] = df.window(order_by='unique1',
                                 partition_by='ten').row_number()
        """
        return WindowBuilder(self, order_by, partition_by, ascending)

    def map(self, fn, column: str, name: Optional[str] = None) -> "AFrame":
        out = self[column].map(fn, name)
        new = AFrame._from_plan(self, self._plan)
        new[name or column] = out
        return new

    # -- actions -----------------------------------------------------------------------
    def get(self, key) -> Optional[dict[str, np.ndarray]]:
        """Point lookup by primary key: per-component binary searches over
        the clustered key copy (newest-wins across LSM components,
        anti-matter aware), bypassing query compilation and kernel launches.
        Returns the row(s) as ``{column: array}`` or None when the key is
        absent or deleted. Only valid on a bare dataset frame."""
        if not isinstance(self._plan, P.Scan):
            raise ValueError(
                "get() is a primary-key point lookup on the base dataset; "
                "this frame carries pending operations — use a filter query")
        return self._session.point_lookup(self._plan.dataverse,
                                          self._plan.dataset, key)

    def explain_get(self, key) -> str:
        """The PointLookup plan ``get(key)`` executes, rendered like
        ``explain()``."""
        if not isinstance(self._plan, P.Scan):
            raise ValueError("explain_get() needs a bare dataset frame")
        return self._session.explain_lookup(self._plan.dataverse,
                                            self._plan.dataset, key)

    def head(self, n: int = 5) -> dict[str, np.ndarray]:
        return self._session.execute(P.Limit(self._plan, n))

    def collect(self) -> dict[str, np.ndarray]:
        return self._session.execute(self._plan)

    def persist(self, name: str, dataverse: Optional[str] = None) -> "AFrame":
        """CREATE DATASET AS <this query> (paper Input 15): the result stays
        on the session's device as a new closed dataset."""
        ds = self._session.persist(self._plan, name, dataverse or self._dataverse)
        return AFrame(ds.dataverse, ds.name, session=self._session)

    def describe(self) -> dict[str, dict[str, float]]:
        """min/max/mean/count per numeric column (string columns skipped by
        catalog metadata)."""
        meta = {}
        for node in P.walk(self._plan):
            if isinstance(node, P.Scan):
                meta = self._session.catalog.get(node.dataverse, node.dataset).table.meta
                break
        out = {}
        for c in self._current_columns():
            if c in meta and meta[c].is_string:
                continue
            specs = [P.AggSpec(f"{op}", op, c) for op in ("min", "max", "mean")]
            specs.append(P.AggSpec("count", "count", None))
            r = self._session.execute(P.Agg(self._project_plan([(c, Col(c))]), specs))
            out[c] = r if isinstance(r, dict) else {"value": r}
        return out


class WindowBuilder:
    def __init__(self, frame: AFrame, order_by: str,
                 partition_by: Optional[str], ascending: bool):
        self._f, self._o, self._p, self._asc = frame, order_by, partition_by, ascending

    def _apply(self, func: str, value_col: Optional[str] = None,
               frame_rows: int = 0, name: Optional[str] = None) -> AFrame:
        from repro_torch.core.window import Window

        plan = Window(self._f._plan, name or func, func, self._o, self._p,
                      value_col, frame_rows, self._asc)
        return AFrame._from_plan(self._f, plan)

    def row_number(self, name: str = "row_number") -> AFrame:
        return self._apply("row_number", name=name)

    def rank(self, name: str = "rank") -> AFrame:
        return self._apply("rank", name=name)

    def cumsum(self, col: str, name: Optional[str] = None) -> AFrame:
        return self._apply("cumsum", value_col=col, name=name or f"cumsum_{col}")

    def moving_avg(self, col: str, window: int,
                   name: Optional[str] = None) -> AFrame:
        return self._apply("moving_avg", value_col=col, frame_rows=window,
                           name=name or f"mavg{window}_{col}")


class GroupBy:
    def __init__(self, frame: AFrame, key: str):
        self._frame = frame
        self._key = key
        self._column: Optional[str] = None

    def __getitem__(self, column: str) -> "GroupBy":
        g = GroupBy(self._frame, self._key)
        g._column = column
        return g

    def agg_plan(self, spec) -> P.Plan:
        """The GroupAgg plan for ``spec`` without executing it."""
        if isinstance(spec, str):
            if spec == "count":
                aggs = [P.AggSpec("count", "count", None)]
            else:
                assert self._column, "select a column before agg('op')"
                aggs = [P.AggSpec(f"{spec}_{self._column}", spec, self._column)]
        elif isinstance(spec, dict):
            aggs = [P.AggSpec(f"{op}_{c}", op, c) for c, op in spec.items()]
        else:
            raise TypeError(spec)
        return P.GroupAgg(self._frame._plan, [self._key], aggs)

    def agg(self, spec) -> dict[str, np.ndarray]:
        """agg('count') / agg('max') on a selected column / agg({col: op})."""
        return self._frame._session.execute(self.agg_plan(spec))

    def count(self):
        return self.agg("count")

    def max(self):
        return self.agg("max")
