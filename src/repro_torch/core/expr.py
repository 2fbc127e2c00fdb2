"""Expression AST for the lazy DataFrame (port of ``repro.core.expr``).

Two consumers:
  * ``evaluate(env, params)`` — elementwise torch evaluation inside a
    compiled query (columns in ``env`` are tensors on the session device).
  * ``to_sql()`` — the SQL++ the paper's AFrame would have sent.

Literals are parameterized: ``collect_params`` lifts every ``Lit`` into a
runtime argument, so a new predicate constant reuses the compiled query.
Parameters follow the reference's x64-off dtypes: Python ints become int32
tensors, floats float32, strings (STRING_WIDTH,) uint8 rows.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch


class Expr:
    children: tuple["Expr", ...] = ()

    # -- python operator sugar (mirrors the Pandas surface AFrame exposes) --
    def _cmp(self, op, other):
        return Compare(op, self, wrap(other))

    def __eq__(self, other):  # type: ignore[override]
        return self._cmp("==", other)

    def __ne__(self, other):  # type: ignore[override]
        return self._cmp("!=", other)

    def __lt__(self, other):
        return self._cmp("<", other)

    def __le__(self, other):
        return self._cmp("<=", other)

    def __gt__(self, other):
        return self._cmp(">", other)

    def __ge__(self, other):
        return self._cmp(">=", other)

    def __and__(self, other):
        return BoolOp("AND", self, wrap(other))

    def __or__(self, other):
        return BoolOp("OR", self, wrap(other))

    def __invert__(self):
        return Not(self)

    def __add__(self, other):
        return Arith("+", self, wrap(other))

    def __sub__(self, other):
        return Arith("-", self, wrap(other))

    def __mul__(self, other):
        return Arith("*", self, wrap(other))

    def __mod__(self, other):
        return Arith("%", self, wrap(other))

    def __truediv__(self, other):
        return Arith("/", self, wrap(other))

    def __hash__(self):
        return hash(self.fingerprint())

    # -- interface -----------------------------------------------------------
    def evaluate(self, env: dict[str, torch.Tensor],
                 params: Sequence[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def to_sql(self) -> str:
        raise NotImplementedError

    def fingerprint(self) -> str:
        """Structural identity, excluding literal *values* (they are params)."""
        raise NotImplementedError

    def columns(self) -> set[str]:
        out: set[str] = set()
        for c in self.children:
            out |= c.columns()
        return out

    def literals(self) -> list["Lit"]:
        out: list[Lit] = []
        for c in self.children:
            out.extend(c.literals())
        return out


def wrap(v: Any) -> Expr:
    return v if isinstance(v, Expr) else Lit(v)


class Col(Expr):
    def __init__(self, name: str):
        self.name = name

    def evaluate(self, env, params):
        return env[self.name]

    def to_sql(self):
        return f"t.{self.name}"

    def fingerprint(self):
        return f"col:{self.name}"

    def columns(self):
        return {self.name}


class Lit(Expr):
    """A literal. At compile time each Lit receives a slot index; at run time
    its value arrives via the params list. ``source`` marks a literal the
    optimizer synthesized as a mirror of a user literal (the second bound of
    a ``==`` range): a plan-cache rebind makes it follow the source's fresh
    value."""

    def __init__(self, value: Any, source: "Lit | None" = None):
        self.value = value
        self.slot: int | None = None
        self.source = source

    def evaluate(self, env, params):
        if self.slot is None:  # un-parameterized evaluation (tests)
            return encode_param(self.value)
        return params[self.slot]

    def to_sql(self):
        if isinstance(self.value, str):
            return f"'{self.value}'"
        return repr(self.value)

    def fingerprint(self):
        return f"lit:{np.asarray(self.value).dtype}"

    def literals(self):
        return [self]


def _strings(a: torch.Tensor, b) -> bool:
    return a.ndim == 2 or (hasattr(b, "ndim") and b.ndim == 2)


class Compare(Expr):
    _OPS: dict[str, Callable] = {
        "==": lambda a, b: a == b,
        "!=": lambda a, b: a != b,
        "<": lambda a, b: a < b,
        "<=": lambda a, b: a <= b,
        ">": lambda a, b: a > b,
        ">=": lambda a, b: a >= b,
    }
    _SQL = {"==": "=", "!=": "!=", "<": "<", "<=": "<=", ">": ">", ">=": ">="}

    def __init__(self, op: str, left: Expr, right: Expr):
        assert op in self._OPS, op
        self.op, self.children = op, (left, right)

    def evaluate(self, env, params):
        a = self.children[0].evaluate(env, params)
        b = self.children[1].evaluate(env, params)
        if _strings(a, b):  # fixed-width strings: whole-row equality
            res = (a == b).all(dim=-1)
            return res if self.op == "==" else ~res
        return self._OPS[self.op](a, b)

    def to_sql(self):
        return f"{self.children[0].to_sql()} {self._SQL[self.op]} {self.children[1].to_sql()}"

    def fingerprint(self):
        return f"cmp({self.op},{self.children[0].fingerprint()},{self.children[1].fingerprint()})"


class IsIn(Expr):
    """Membership against a literal set — SQL++ ``IN [...]``."""

    def __init__(self, child: Expr, values: Sequence[Expr]):
        self.children = (child,) + tuple(values)

    @property
    def values(self) -> tuple[Expr, ...]:
        return self.children[1:]

    def evaluate(self, env, params):
        a = self.children[0].evaluate(env, params)
        out = None
        for v in self.values:
            b = v.evaluate(env, params)
            hit = (a == b).all(dim=-1) if _strings(a, b) else a == b
            out = hit if out is None else (out | hit)
        if out is None:  # empty value set matches nothing
            return torch.zeros(a.shape[:1], dtype=torch.bool, device=a.device)
        return out

    def to_sql(self):
        vals = ", ".join(v.to_sql() for v in self.values)
        return f"{self.children[0].to_sql()} IN [{vals}]"

    def fingerprint(self):
        inner = ",".join(c.fingerprint() for c in self.children)
        return f"isin({inner})"


class BoolOp(Expr):
    def __init__(self, op: str, left: Expr, right: Expr):
        assert op in ("AND", "OR")
        self.op, self.children = op, (left, right)

    def evaluate(self, env, params):
        a = self.children[0].evaluate(env, params)
        b = self.children[1].evaluate(env, params)
        return (a & b) if self.op == "AND" else (a | b)

    def to_sql(self):
        return f"({self.children[0].to_sql()} {self.op} {self.children[1].to_sql()})"

    def fingerprint(self):
        return f"bool({self.op},{self.children[0].fingerprint()},{self.children[1].fingerprint()})"


class Not(Expr):
    def __init__(self, child: Expr):
        self.children = (child,)

    def evaluate(self, env, params):
        return ~self.children[0].evaluate(env, params)

    def to_sql(self):
        return f"NOT ({self.children[0].to_sql()})"

    def fingerprint(self):
        return f"not({self.children[0].fingerprint()})"


class Arith(Expr):
    # "%" is the floored modulo (sign of the divisor), as jnp.mod; "/" is
    # true division (int / int -> float32), as jnp.divide with x64 off.
    _OPS = {
        "+": torch.add,
        "-": torch.sub,
        "*": torch.mul,
        "/": torch.true_divide,
        "%": torch.remainder,
    }

    def __init__(self, op: str, left: Expr, right: Expr):
        assert op in self._OPS
        self.op, self.children = op, (left, right)

    def evaluate(self, env, params):
        return self._OPS[self.op](
            self.children[0].evaluate(env, params),
            self.children[1].evaluate(env, params),
        )

    def to_sql(self):
        return f"({self.children[0].to_sql()} {self.op} {self.children[1].to_sql()})"

    def fingerprint(self):
        return f"arith({self.op},{self.children[0].fingerprint()},{self.children[1].fingerprint()})"


class IsKnown(Expr):
    """``notna`` — SQL++ ``IS KNOWN`` (paper Input 4/7)."""

    def __init__(self, child: Expr):
        self.children = (child,)

    def evaluate(self, env, params):
        v = self.children[0].evaluate(env, params)
        if v.dtype.is_floating_point:
            return ~torch.isnan(v)
        return torch.ones(v.shape[:1], dtype=torch.bool, device=v.device)

    def to_sql(self):
        return f"{self.children[0].to_sql()} IS KNOWN"

    def fingerprint(self):
        return f"isknown({self.children[0].fingerprint()})"


class StrUpper(Expr):
    """Byte-map uppercase over fixed-width uint8 strings (expression 5)."""

    def __init__(self, child: Expr):
        self.children = (child,)

    def evaluate(self, env, params):
        v = self.children[0].evaluate(env, params)
        lower = (v >= ord("a")) & (v <= ord("z"))
        return torch.where(lower, v - 32, v)

    def to_sql(self):
        return f"UPPER({self.children[0].to_sql()})"

    def fingerprint(self):
        return f"upper({self.children[0].fingerprint()})"


class StrLower(Expr):
    def __init__(self, child: Expr):
        self.children = (child,)

    def evaluate(self, env, params):
        v = self.children[0].evaluate(env, params)
        upper = (v >= ord("A")) & (v <= ord("Z"))
        return torch.where(upper, v + 32, v)

    def to_sql(self):
        return f"LOWER({self.children[0].to_sql()})"

    def fingerprint(self):
        return f"lower({self.children[0].fingerprint()})"


class ElementwiseUDF(Expr):
    """A user torch function applied elementwise to one or more columns
    (AFrame's per-row ``map``; the engine-side UDF of paper §III-C)."""

    def __init__(self, fn: Callable, name: str, *children: Expr):
        self.fn, self.name, self.children = fn, name, tuple(children)

    def evaluate(self, env, params):
        return self.fn(*[c.evaluate(env, params) for c in self.children])

    def to_sql(self):
        args = ", ".join(c.to_sql() for c in self.children)
        return f"{self.name}({args})"

    def fingerprint(self):
        inner = ",".join(c.fingerprint() for c in self.children)
        return f"udf({self.name},{inner})"


def ordered_lits(exprs: Sequence[Expr]) -> list[Lit]:
    """Every literal in plan order, *without* assigning slots."""
    lits: list[Lit] = []
    for e in exprs:
        lits.extend(e.literals())
    return lits


def collect_params(exprs: Sequence[Expr]) -> list[Lit]:
    """Assign param slots to every literal in plan order; returns the slots."""
    lits = ordered_lits(exprs)
    for i, lit in enumerate(lits):
        lit.slot = i
    return lits


def encode_param(v: Any, device=None) -> torch.Tensor:
    """A literal value as a tensor with the reference's (x64-off) dtype."""
    if isinstance(v, str):
        from repro_torch.engine.table import encode_strings

        return encode_strings([v])[0].to(device)
    a = np.asarray(v)
    if a.dtype == np.int64 or a.dtype == np.uint64:
        a = a.astype(np.int32)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(device)


def param_values(lits: Sequence[Lit], device=None) -> list[torch.Tensor]:
    return [encode_param(lit.value, device) for lit in lits]
