"""The expression AST and SQL++ rendering on the port (paper Fig. 3 Inputs
7/8, Appendix C): the scenarios of tests/test_expr_sql.py replayed on both
packages in one process. SQL text and fingerprints equal the reference's;
expressions evaluated over the same numpy inputs (torch tensors in the
port, jnp arrays in the reference) give the same values and dtypes; a
literal rebind hits the plan cache as in the reference."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_replay import PORT, REF


def _exprs(E):
    """Every expression of the reference scenarios, built in package ``E``."""
    return {
        "compare": E.Compare("==", E.Col("ten"), E.Lit(5)),
        "boolop": E.BoolOp("AND", E.Compare(">=", E.Col("a"), E.Lit(1)),
                           E.Compare("<=", E.Col("a"), E.Lit(9))),
        "isknown": E.IsKnown(E.Col("coordinate")),
        "upper": E.StrUpper(E.Col("stringu1")),
        "lower": E.StrLower(E.Col("stringu1")),
        "not": E.Not(E.Compare("!=", E.Col("x"), E.Lit(2))),
        "arith": E.Arith("*", E.Col("x"), E.Lit(3)),
        "mod": E.Arith("%", E.Col("x"), E.Lit(7)),
        "string_lit": E.Compare("==", E.Col("s"), E.Lit("abc")),
        "isin": E.IsIn(E.Col("s"), [E.Lit("abc"), E.Lit("abd")]),
    }


def test_sql_columns_and_fingerprints_equal_reference():
    ref, port = _exprs(REF.expr), _exprs(PORT.expr)
    for k in ref:
        assert port[k].to_sql() == ref[k].to_sql(), k
        assert port[k].columns() == ref[k].columns(), k
        assert port[k].fingerprint() == ref[k].fingerprint(), k
    assert port["compare"].to_sql() == "t.ten = 5"
    assert port["compare"].columns() == {"ten"}
    assert port["boolop"].to_sql() == "(t.a >= 1 AND t.a <= 9)"
    assert port["isknown"].to_sql() == "t.coordinate IS KNOWN"
    assert port["upper"].to_sql() == "UPPER(t.stringu1)"


def _evaluate(pk, expr, env):
    """Evaluate with slotted params, as a compiled query does; numpy out."""
    lits = pk.expr.collect_params([expr])
    out = expr.evaluate(env, pk.expr.param_values(lits))
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


@pytest.mark.parametrize("case", ["numeric", "string_equality", "arith", "mod",
                                  "not", "isin"])
def test_eval_equals_reference(case):
    strings = REF.table.encode_strings(["abc", "abd", "abc"])
    env_np = {"x": np.asarray([1, 2, 3, 4], np.int32),
              "s": np.asarray(strings)}
    build = {
        "numeric": lambda E: E.Compare("<", E.Col("x"), E.Lit(3)),
        "string_equality": lambda E: E.Compare("==", E.Col("s"), E.Lit("abc")),
        "arith": lambda E: E.Arith("*", E.Col("x"), E.Lit(3)),
        "mod": lambda E: E.Arith("%", E.Col("x"), E.Lit(3)),
        "not": lambda E: E.Not(E.Compare(">=", E.Col("x"), E.Lit(2))),
        "isin": lambda E: E.IsIn(E.Col("s"), [E.Lit("abd"), E.Lit("zz")]),
    }[case]
    got = _evaluate(PORT, build(PORT.expr),
                    {k: torch.from_numpy(v) for k, v in env_np.items()})
    want = _evaluate(REF, build(REF.expr),
                     {k: jnp.asarray(v) for k, v in env_np.items()})
    assert got.dtype == want.dtype, case
    np.testing.assert_array_equal(got, want, err_msg=case)
    if case == "numeric":
        assert list(got) == [True, True, False, False]
    if case == "string_equality":
        assert list(got) == [True, False, True]
    if case == "arith":
        assert list(got) == [3, 6, 9, 12]


def test_fingerprint_excludes_literal_values():
    E = PORT.expr
    a = E.Compare("==", E.Col("x"), E.Lit(3))
    b = E.Compare("==", E.Col("x"), E.Lit(99))
    assert a.fingerprint() == b.fingerprint()


# -- plan SQL++ matches paper appendix C patterns ------------------------------


@pytest.fixture(scope="module")
def frames():
    out = {}
    for pk in (REF, PORT):
        sess = pk.session()
        sess.create_dataset("Data", pk.wisconsin.generate(100), dataverse="d")
        out[pk.name] = pk.AFrame("d", "Data", session=sess)
    return out


def _plans(pk, df):
    P = pk.P
    return {
        "scan": df._plan,
        "filter": df[df["ten"] == 3]._plan,
        "limit": P.Limit(df._plan, 5),
        "groupby": P.GroupAgg(df._plan, ["oddOnePercent"],
                              [P.AggSpec("cnt", "count", None)]),
        "join_count": P.JoinCount(df._plan, df._plan, "unique1", "unique1"),
        "project": df[["two", "four"]]._plan,
        "sort": P.Sort(df._plan, "unique1", False),
        "agg": P.Agg(df._plan, [P.AggSpec("m", "max", "unique1")]),
    }


def test_plan_sql_equals_reference(frames):
    ref = _plans(REF, frames["ref"])
    port = _plans(PORT, frames["port"])
    for k in ref:
        assert port[k].to_sql() == ref[k].to_sql(), k
        assert port[k].fingerprint() == ref[k].fingerprint(), k
    assert frames["port"].query == frames["ref"].query \
        == "SELECT VALUE t FROM d.Data t;"
    assert "WHERE t.ten = 3" in port["filter"].to_sql()
    assert port["limit"].to_sql().endswith("LIMIT 5")
    q = port["groupby"].to_sql()
    assert "GROUP BY t.oddOnePercent" in q and "COUNT(*) AS cnt" in q
    q = port["join_count"].to_sql()
    assert "JOIN" in q and "COUNT(*)" in q and "l.unique1 = r.unique1" in q


def test_plan_cache_hit(frames):
    out = {}
    for pk in (REF, PORT):
        df = frames[pk.name]
        sess = df._session
        before = dict(sess.stats)
        a = len(df[df["ten"] == 1])
        mid = dict(sess.stats)
        b = len(df[df["ten"] == 7])  # different literal, same fingerprint
        after = dict(sess.stats)
        assert after["compiles"] == mid["compiles"]
        assert after["hits"] == mid["hits"] + 1
        out[pk.name] = (a, b, before, mid, after)
    assert out["port"] == out["ref"]
