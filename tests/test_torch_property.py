"""The optimizer and planner never change results, on the port too: the
hypothesis properties of tests/test_property.py replayed on both packages
in one process. For random predicate trees, top-k keys, group-bys, index
ranges and self-join keys, a session with every rewrite and index off
(``Session(enable_index=False, enable_pushdown=False)``) and a fully
optimized, indexed and clustered one answer alike, equal to the numpy
oracle and to the reference's two sessions, bit for bit. The reference's
``max_examples`` and ``deadline=None`` throughout."""
import numpy as np
from hypothesis import given, settings, strategies as st

from torch_replay import PORT, REF, assert_same

COLS = ["two", "four", "ten", "twenty", "onePercent", "twentyPercent"]
DOMAIN = {"two": 2, "four": 4, "ten": 10, "twenty": 20, "onePercent": 100,
          "twentyPercent": 5}
OPS = ["==", "!=", "<", "<=", ">", ">="]
NP_OPS = {"==": np.equal, "!=": np.not_equal, "<": np.less,
          "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal}
N_ROWS = 2_000


def _sessions(pk):
    t = pk.wisconsin.generate(N_ROWS, seed=7)
    plain = pk.session(enable_index=False, enable_pushdown=False)
    plain.create_dataset("D", t, dataverse="p")
    opt = pk.session()
    opt.create_dataset("D", t, dataverse="p",
                       indexes=["onePercent", "ten"], primary="unique2")
    return plain, opt


RAW = {k: np.asarray(v)
       for k, v in REF.wisconsin.generate(N_ROWS, seed=7).columns.items()}
SESSIONS = {pk.name: _sessions(pk) for pk in (REF, PORT)}


@st.composite
def predicates(draw, depth=0) -> tuple:
    """(expression builder taking a package, numpy evaluator)."""
    if depth < 2 and draw(st.booleans()):
        op = draw(st.sampled_from(["AND", "OR", "NOT"]))
        l_e, l_np = draw(predicates(depth=depth + 1))
        if op == "NOT":
            return (lambda pk: pk.expr.Not(l_e(pk)), lambda r: ~l_np(r))
        r_e, r_np = draw(predicates(depth=depth + 1))
        if op == "AND":
            return (lambda pk: pk.expr.BoolOp("AND", l_e(pk), r_e(pk)),
                    lambda r: l_np(r) & r_np(r))
        return (lambda pk: pk.expr.BoolOp("OR", l_e(pk), r_e(pk)),
                lambda r: l_np(r) | r_np(r))
    col = draw(st.sampled_from(COLS))
    op = draw(st.sampled_from(OPS))
    val = draw(st.integers(min_value=-1, max_value=DOMAIN[col]))
    return (lambda pk: pk.expr.Compare(op, pk.expr.Col(col), pk.expr.Lit(val)),
            lambda r: NP_OPS[op](r[col], val))


def _run_all(make_plan):
    """``make_plan(pk)`` on the four sessions: {(package, session): result}."""
    return {(pk.name, i): sess.execute(make_plan(pk))
            for pk in (REF, PORT) for i, sess in enumerate(SESSIONS[pk.name])}


def _assert_port_equals_ref(out):
    for i in (0, 1):
        assert_same(out["port", i], out["ref", i], f"session {i}")


@settings(max_examples=25, deadline=None)
@given(predicates())
def test_filter_count_optimizer_equivalence(pred):
    make_expr, np_eval = pred
    want = int(np_eval(RAW).sum())
    out = _run_all(lambda pk: pk.P.Agg(
        pk.P.Filter(pk.P.Scan("D", "p"), make_expr(pk)),
        [pk.P.AggSpec("count", "count", None)]))
    assert out["port", 0] == out["port", 1] == want
    _assert_port_equals_ref(out)


@settings(max_examples=10, deadline=None)
@given(predicates(), st.sampled_from(COLS), st.booleans(),
       st.integers(min_value=1, max_value=7))
def test_topk_equivalence(pred, key, ascending, k):
    make_expr, np_eval = pred
    vals = np.sort(RAW[key][np_eval(RAW)])
    want = vals[:k] if ascending else vals[::-1][:k]
    out = _run_all(lambda pk: pk.P.Limit(pk.P.Sort(
        pk.P.Filter(pk.P.Scan("D", "p"), make_expr(pk)), key, ascending), k))
    for i in (0, 1):
        assert list(out["port", i][key]) == list(want), i
    _assert_port_equals_ref(out)


@settings(max_examples=10, deadline=None)
@given(st.sampled_from(["two", "four", "ten", "twenty"]),
       st.sampled_from(["count", "max", "min", "sum"]))
def test_groupby_equivalence(key, op):
    col = "unique1"
    out = _run_all(lambda pk: pk.P.GroupAgg(
        pk.P.Scan("D", "p"), [key],
        [pk.P.AggSpec("out", op, None if op == "count" else col)]))
    for i in (0, 1):
        got = out["port", i]
        for kv, ov in zip(got[key], got["out"]):
            sel = RAW[col][RAW[key] == kv]
            assert ov == {"count": sel.size, "max": sel.max(),
                          "min": sel.min(), "sum": sel.sum()}[op]
    _assert_port_equals_ref(out)


@settings(max_examples=10, deadline=None)
@given(st.integers(min_value=0, max_value=99),
       st.integers(min_value=0, max_value=99))
def test_range_count_index_equivalence(a, b):
    lo, hi = min(a, b), max(a, b)
    want = int(((RAW["onePercent"] >= lo) & (RAW["onePercent"] <= hi)).sum())

    def plan(pk):
        E = pk.expr
        pred = E.BoolOp("AND", E.Compare(">=", E.Col("onePercent"), E.Lit(lo)),
                        E.Compare("<=", E.Col("onePercent"), E.Lit(hi)))
        return pk.P.Agg(pk.P.Filter(pk.P.Scan("D", "p"), pred),
                        [pk.P.AggSpec("count", "count", None)])

    out = _run_all(plan)
    assert out["port", 1] == out["port", 0] == want  # index-only vs scan
    _assert_port_equals_ref(out)
    kinds = {pk.name: type(SESSIONS[pk.name][1].last_physical).__name__
             for pk in (REF, PORT)}
    assert kinds["port"] == kinds["ref"] == "IndexOnlyCount"


@settings(max_examples=8, deadline=None)
@given(st.sampled_from(["unique1", "ten", "onePercent"]))
def test_join_count_equivalence(key):
    _, per_key = np.unique(RAW[key], return_counts=True)
    want = int((per_key.astype(np.int64) ** 2).sum())
    out = _run_all(lambda pk: pk.P.Agg(
        pk.P.Join(pk.P.Scan("D", "p"), pk.P.Scan("D", "p"), key, key),
        [pk.P.AggSpec("count", "count", None)]))
    assert out["port", 0] == out["port", 1] == want
    _assert_port_equals_ref(out)


def test_ablation_switches_reach_the_planner():
    """``enable_pushdown=False`` keeps the raw plan shape (no fusion, no
    column pruning) and ``enable_index=False`` leaves the index paths out,
    as the reference's sessions do."""
    shapes = {}
    for pk in (REF, PORT):
        plain, opt = SESSIONS[pk.name]
        E = pk.expr
        pred = E.BoolOp("AND", E.Compare(">=", E.Col("onePercent"), E.Lit(3)),
                        E.Compare("<=", E.Col("onePercent"), E.Lit(9)))
        plan = pk.P.Agg(pk.P.Filter(pk.P.Scan("D", "p"), pred),
                        [pk.P.AggSpec("count", "count", None)])
        row = []
        for sess in (plain, opt):
            sess.execute(plan)
            row.append((sess.last_optimized.fingerprint(),
                        sess.last_physical.fingerprint(),
                        pk.PH.format_plan(sess.last_physical),
                        type(sess.last_physical).__name__))
        shapes[pk.name] = row
    assert shapes["port"] == shapes["ref"]
    (p_opt, _, _, p_kind), (o_opt, _, _, o_kind) = shapes["port"]
    assert p_opt.startswith("agg(") and o_opt.startswith("filtercount(")
    assert p_kind == "ScalarAgg" and o_kind == "IndexOnlyCount"
