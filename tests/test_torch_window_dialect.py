"""Window functions and dialect rendering on the port (``core/window.py``,
``core/dialect.py``, ``AFrame.window`` / ``query_in``): the scenarios of
tests/test_window_dialect.py replayed on both packages in one process — the
same numpy-seeded table, gspmd and kernel mode, the port on ``device="cpu"``.

Window results are held to the reference bit for bit, dtypes included:
int32 ranks, and float32 prefix sums that are exact here because every
prefix sum is an integer below 2^24 (the reference's own numpy checks keep
its tolerance, ``rtol=1e-5``). Plans and explain texts equal the
reference's; the SQL++ and Postgres texts equal the reference's for the same
plan."""
import numpy as np
import pytest

from torch_replay import PORT, REF, assert_same, counts

MODES = ("gspmd", "kernel")
N = 5_000


@pytest.fixture(scope="module")
def sessions():
    out = {}
    for pk in (REF, PORT):
        for mode in MODES:
            s = pk.session(mode)
            s.create_dataset("D", pk.wisconsin.generate(N, seed=5),
                             dataverse="w", indexes=["onePercent"])
            out[pk.name, mode] = s
    return out


def _both(sessions, mode, build):
    """Run ``build(frame) -> AFrame`` on both packages: the collected
    results, plus each plan's fingerprint and explain text."""
    out = {}
    for pk in (REF, PORT):
        sess = sessions[pk.name, mode]
        df = build(pk.AFrame("w", "D", session=sess))
        res = df.collect()
        out[pk.name] = (res, sess.last_physical.fingerprint(),
                        pk.PH.format_plan(sess.last_physical))
    assert_same(out["port"][0], out["ref"][0], mode)
    assert out["port"][1:] == out["ref"][1:]
    return out["port"][0]


@pytest.mark.parametrize("mode", MODES)
def test_row_number_global(sessions, mode):
    out = _both(sessions, mode, lambda df: df.window(order_by="unique1")
                .row_number())
    assert out["row_number"].dtype == np.int32
    order = np.argsort(out["unique1"])
    assert list(out["row_number"][order]) == list(range(1, N + 1))


@pytest.mark.parametrize("mode", MODES)
def test_row_number_partitioned(sessions, mode):
    out = _both(sessions, mode, lambda df: df.window(
        order_by="unique1", partition_by="ten").row_number("rn"))
    for t in range(10):
        grp = out["rn"][out["ten"] == t]
        assert sorted(grp) == list(range(1, len(grp) + 1))
    for t in range(3):
        m = out["ten"] == t
        assert out["rn"][m][np.argmin(out["unique1"][m])] == 1


@pytest.mark.parametrize("mode", MODES)
def test_rank_with_ties(sessions, mode):
    out = _both(sessions, mode, lambda df: df.window(order_by="two").rank("r"))
    zeros = (out["two"] == 0).sum()
    assert set(out["r"][out["two"] == 0]) == {1}
    assert set(out["r"][out["two"] == 1]) == {zeros + 1}


@pytest.mark.parametrize("mode", MODES)
def test_cumsum_partitioned(sessions, mode):
    out = _both(sessions, mode, lambda df: df.window(
        order_by="unique1", partition_by="four").cumsum("two"))
    assert out["cumsum_two"].dtype == np.float32
    for p in range(4):
        m = out["four"] == p
        order = np.argsort(out["unique1"][m])
        want = np.cumsum(out["two"][m][order])
        np.testing.assert_allclose(out["cumsum_two"][m][order], want, rtol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_moving_avg(sessions, mode):
    out = _both(sessions, mode, lambda df: df.window(order_by="unique2")
                .moving_avg("unique1", 4))
    order = np.argsort(out["unique2"])
    v = out["unique1"][order].astype(np.float64)
    got = out["mavg4_unique1"][order]
    for i in (0, 1, 5, 100):
        lo = max(0, i - 3)
        np.testing.assert_allclose(got[i], v[lo:i + 1].mean(), rtol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_descending_partitioned_windows(sessions, mode):
    """Descending order keys, a partition with one value per row and a
    moving average within partitions: the f32 keys, stable sorts and
    running maxima agree with the reference's for every function."""
    for build in (
            lambda df: df.window(order_by="unique1", partition_by="twenty",
                                 ascending=False).rank("r"),
            lambda df: df.window(order_by="two", partition_by="unique2")
            .row_number("rn"),
            lambda df: df.window(order_by="unique2", partition_by="ten",
                                 ascending=False).moving_avg("four", 3, "m"),
            lambda df: df.window(order_by="four", ascending=False)
            .cumsum("ten", "c")):
        _both(sessions, mode, build)


@pytest.mark.parametrize("mode", MODES)
def test_window_over_filter(sessions, mode):
    out = _both(sessions, mode, lambda df: df[df["two"] == 0].window(
        order_by="unique1").row_number("rn"))
    raw = np.asarray(REF.wisconsin.generate(N, seed=5).columns["two"])
    assert len(out["rn"]) == (raw == 0).sum()
    assert sorted(out["rn"]) == list(range(1, len(out["rn"]) + 1))


def test_window_sql_rendering(sessions):
    q = {pk.name: pk.AFrame("w", "D", session=sessions[pk.name, "gspmd"])
         .window(order_by="unique1", partition_by="ten").row_number().query
         for pk in (REF, PORT)}
    assert q["port"] == q["ref"]
    assert "ROW_NUMBER() OVER (PARTITION BY t.ten ORDER BY t.unique1)" in q["port"]


# -- dialect ----------------------------------------------------------------------


def _frames(sessions):
    return {pk.name: pk.AFrame("w", "D", session=sessions[pk.name, "gspmd"])
            for pk in (REF, PORT)}


def _plans(pk, df):
    """One plan of every node kind the dialect renders."""
    P, E = pk.P, pk.expr
    scan = df._plan
    win = df.window(order_by="unique1", partition_by="ten")
    return {
        "filter_project": df[df["ten"] == 3][["two", "four"]]._plan,
        "notna": df[df["unique1"].notna()]._plan,
        "bool_arith": P.Filter(scan, E.BoolOp(
            "OR", E.Not(E.Compare(">", E.Col("two"), E.Lit(0))),
            E.Compare("<=", E.Arith("%", E.Col("unique1"), E.Lit(7)),
                      E.Lit(2)))),
        "strings": P.Project(scan, [("u", E.StrUpper(E.Col("stringu1"))),
                                    ("l", E.StrLower(E.Col("string4"))),
                                    ("s", E.Col("string4"))]),
        "string_lit": df[df["string4"] == "HHHHxxxx"]._plan,
        "limit": P.Limit(scan, 5),
        "sort": P.Sort(scan, "unique1", False),
        "topk": P.TopK(scan, "unique1", 3, True),
        "group": P.GroupAgg(scan, ["twenty"], [P.AggSpec("c", "count", None),
                                               P.AggSpec("m", "max", "four")]),
        "agg": P.Agg(scan, [P.AggSpec("s", "sum", "ten")]),
        "filter_count": P.FilterCount(scan, E.Compare("==", E.Col("ten"),
                                                      E.Lit(1))),
        "count_all": P.FilterCount(scan, None),
        "join": P.Join(scan, scan, "unique1", "unique2"),
        "join_count": P.JoinCount(scan, scan, "unique1", "unique1"),
        "row_number": win.row_number()._plan,
        "rank_desc": df.window(order_by="two", ascending=False).rank()._plan,
        "cumsum": win.cumsum("two")._plan,
        "moving_avg": df.window(order_by="unique2").moving_avg("four", 10)._plan,
    }


@pytest.mark.parametrize("dialect", ["sqlpp", "postgres"])
def test_dialect_text_equals_reference(sessions, dialect):
    frames = _frames(sessions)
    texts = {pk.name: {k: pk.dialect.render(plan, dialect)
                       for k, plan in _plans(pk, frames[pk.name]).items()}
             for pk in (REF, PORT)}
    assert texts["port"] == texts["ref"]
    for pk in (REF, PORT):
        df = frames[pk.name]
        d = df[df["ten"] == 3][["two", "four"]]
        assert d.query_in(dialect) == texts[pk.name]["filter_project"]


def test_unknown_dialect_raises(sessions):
    with pytest.raises(ValueError, match="dialect"):
        _frames(sessions)["port"].query_in("mysql")


def test_postgres_dialect_basic(sessions):
    frames = _frames(sessions)
    pg = {}
    for name, df in frames.items():
        pg[name] = df[df["ten"] == 3][["two", "four"]].query_in("postgres")
    assert pg["port"] == pg["ref"]
    assert pg["port"].startswith("SELECT") and "SELECT VALUE" not in pg["port"]
    assert "w.d" in pg["port"] and "t.ten = 3" in pg["port"]


def test_postgres_is_not_null(sessions):
    frames = _frames(sessions)
    out = {}
    for name, df in frames.items():
        f = df[df["unique1"].notna()]
        out[name] = (f.query_in("postgres"), f.query)
    assert out["port"] == out["ref"]
    pg, sqlpp = out["port"]
    assert "IS NOT NULL" in pg and "IS KNOWN" not in pg and "IS KNOWN" in sqlpp


def test_postgres_groupby_join(sessions):
    frames = _frames(sessions)
    out = {}
    for pk in (REF, PORT):
        plan = frames[pk.name]._plan
        g = pk.P.GroupAgg(plan, ["twenty"], [pk.P.AggSpec("c", "count", None)])
        j = pk.P.JoinCount(plan, plan, "unique1", "unique1")
        out[pk.name] = (pk.dialect.render(g, "postgres"),
                        pk.dialect.render(j, "postgres"))
    assert out["port"] == out["ref"]
    g, j = out["port"]
    assert "GROUP BY t.twenty" in g and "COUNT(*) AS c" in g
    assert "JOIN" in j and "COUNT(*)" in j


@pytest.mark.parametrize("mode", MODES)
def test_dialect_roundtrip_same_semantics(sessions, mode):
    """The IR is dialect-independent: results come from the engine."""
    out = {}
    for pk in (REF, PORT):
        sess = sessions[pk.name, mode]
        df = pk.AFrame("w", "D", session=sess)
        n = len(df[(df["onePercent"] >= 5) & (df["onePercent"] <= 9)])
        out[pk.name] = (n, sess.last_physical.fingerprint(), counts(sess))
    raw = np.asarray(REF.wisconsin.generate(N, seed=5).columns["onePercent"])
    assert out["port"][0] == int(((raw >= 5) & (raw <= 9)).sum())
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, 10_000, 65_537])
@pytest.mark.parametrize("kind", ["int64", "float32", "mostly -inf"])
def test_two_level_cummax_equals_torch_cummax(n, kind):
    """The windows' running max (rows scanned side by side, then lifted by
    the rows before them) is ``torch.cummax`` bit for bit."""
    import torch

    from repro_torch.core.window import _cummax

    rng = np.random.default_rng(n)
    if kind == "int64":
        x = torch.from_numpy(rng.integers(-10**12, 10**12, n))
    else:
        x = torch.from_numpy(rng.normal(size=n).astype(np.float32))
        if kind == "mostly -inf":
            x = torch.where(torch.from_numpy(rng.random(n) < 0.01), x,
                            float("-inf"))
    got = _cummax(x)
    assert got.dtype == x.dtype
    assert torch.equal(got, torch.cummax(x, dim=0).values)
