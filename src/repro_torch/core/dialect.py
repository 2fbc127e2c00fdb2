"""Language-layer abstraction (port of ``repro.core.dialect``) — the
paper's §VI future-work item:
"By separating its language module from the DataFrame operation translation
mechanism, we should also be able to deploy AFrame on other query-based data
management systems (e.g., Postgres)."

``render(plan, dialect)`` re-renders any logical plan in a target dialect.
The plan IR is the single source of truth; SQL++ remains the default
(``plan.to_sql()``) and this module maps the few divergent constructs:

  construct        SQL++ (AsterixDB)            postgres
  ---------------- ---------------------------- -----------------------------
  whole-record     SELECT VALUE t                SELECT t.*
  missing check    t.x IS KNOWN                  t.x IS NOT NULL
  dataset ref      dataverse.Dataset             schema.table (lowercased)
  index hint       /*+ index(col) */             (omitted — planner decides)
  group output     SELECT VALUE COUNT(*)         SELECT COUNT(*)
"""
from __future__ import annotations

from repro_torch.core import plan as P
from repro_torch.core.expr import (Arith, BoolOp, Col, Compare,
                                   ElementwiseUDF, Expr, IsKnown, Lit,
                                   ModelUDF, Not, StrLower, StrUpper)
from repro_torch.core.window import Window

DIALECTS = ("sqlpp", "postgres")


def render(plan: P.Plan, dialect: str = "sqlpp") -> str:
    if dialect not in DIALECTS:
        raise ValueError(f"unknown dialect {dialect!r}: expected one of {DIALECTS}")
    if dialect == "sqlpp":
        return plan.to_sql() + ";"
    return _pg_plan(plan) + ";"


# -- postgres expression rendering ------------------------------------------------


def _pg_expr(e: Expr) -> str:
    if isinstance(e, Col):
        return f"t.{e.name}"
    if isinstance(e, Lit):
        return f"'{e.value}'" if isinstance(e.value, str) else repr(e.value)
    if isinstance(e, Compare):
        return f"{_pg_expr(e.children[0])} {e._SQL[e.op]} {_pg_expr(e.children[1])}"
    if isinstance(e, BoolOp):
        return f"({_pg_expr(e.children[0])} {e.op} {_pg_expr(e.children[1])})"
    if isinstance(e, Not):
        return f"NOT ({_pg_expr(e.children[0])})"
    if isinstance(e, Arith):
        return f"({_pg_expr(e.children[0])} {e.op} {_pg_expr(e.children[1])})"
    if isinstance(e, IsKnown):
        return f"{_pg_expr(e.children[0])} IS NOT NULL"
    if isinstance(e, StrUpper):
        return f"UPPER({_pg_expr(e.children[0])})"
    if isinstance(e, StrLower):
        return f"LOWER({_pg_expr(e.children[0])})"
    if isinstance(e, (ElementwiseUDF, ModelUDF)):
        name = getattr(e, "name", None) or getattr(e, "model_name")
        args = ", ".join(_pg_expr(c) for c in e.children)
        return f"{name}({args})"  # assumes a registered pg function
    raise NotImplementedError(type(e).__name__)


def _pg_table(dataverse: str, dataset: str) -> str:
    return f"{dataverse.lower()}.{dataset.lower()}"


def _pg_plan(node: P.Plan) -> str:
    if isinstance(node, P.Scan):
        return f"SELECT t.* FROM {_pg_table(node.dataverse, node.dataset)} t"
    if isinstance(node, P.Filter):
        return (f"SELECT t.* FROM ({_pg_plan(node.children[0])}) t "
                f"WHERE {_pg_expr(node.predicate)}")
    if isinstance(node, P.Project):
        cols = ", ".join(
            _pg_expr(e) if (isinstance(e, Col) and e.name == n)
            else f"{_pg_expr(e)} AS {n}"
            for n, e in node.outputs)
        return f"SELECT {cols} FROM ({_pg_plan(node.children[0])}) t"
    if isinstance(node, P.Limit):
        return f"{_pg_plan(node.children[0])} LIMIT {node.n}"
    if isinstance(node, (P.Sort, P.TopK)):
        d = "ASC" if node.ascending else "DESC"
        sql = (f"SELECT t.* FROM ({_pg_plan(node.children[0])}) t "
               f"ORDER BY t.{node.key} {d}")
        if isinstance(node, P.TopK):
            sql += f" LIMIT {node.k}"
        return sql
    if isinstance(node, P.GroupAgg):
        aggs = ", ".join(
            f"{s.op.upper()}({'t.' + s.column if s.column else '*'}) AS {s.out_name}"
            for s in node.aggs)
        keys = ", ".join(f"t.{k}" for k in node.keys)
        return (f"SELECT {keys}, {aggs} FROM ({_pg_plan(node.children[0])}) t "
                f"GROUP BY {keys}")
    if isinstance(node, P.Agg):
        aggs = ", ".join(
            f"{s.op.upper()}({'t.' + s.column if s.column else '*'}) AS {s.out_name}"
            for s in node.aggs)
        return f"SELECT {aggs} FROM ({_pg_plan(node.children[0])}) t"
    if isinstance(node, (P.FilterCount,)):
        base = _pg_plan(node.children[0])
        if node.predicate is None:
            return f"SELECT COUNT(*) FROM ({base}) t"
        return f"SELECT COUNT(*) FROM ({base}) t WHERE {_pg_expr(node.predicate)}"
    if isinstance(node, (P.Join, P.JoinCount)):
        l = _pg_plan(node.children[0])
        r = _pg_plan(node.children[1])
        inner = (f"SELECT l.*, r.* FROM ({l}) l JOIN ({r}) r "
                 f"ON l.{node.left_on} = r.{node.right_on}")
        if isinstance(node, P.JoinCount):
            return f"SELECT COUNT(*) FROM ({inner}) t"
        return inner
    if isinstance(node, Window):
        # the node's own OVER() rendering is already SELECT VALUE-free
        return node.to_sql()
    raise NotImplementedError(type(node).__name__)
