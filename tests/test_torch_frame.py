"""AFrame end to end on the port: the scenarios of tests/test_frame.py (the
paper's 12 benchmark expressions against a numpy oracle, describe,
setitem + persist, open vs closed datasets, lazy evaluation) replayed on
both packages in one process, over the same numpy-seeded table, in gspmd
and kernel mode. Every action's result equals the reference's bit for bit,
dtypes included (but the mean of unique1, a float32 sum past 2^24, which
both hold to the reference's own tolerance), and the reference's own
assertions hold on the port's."""
import numpy as np
import pytest

from torch_replay import PORT, REF, assert_same

MODES = ("gspmd", "kernel")


@pytest.fixture(scope="module")
def frames():
    """(package, mode) -> AFrame over the reference's ``session_with_data``
    fixture: 10,000 Wisconsin rows (seed 1), clustered by unique2, indexes on
    onePercent and unique1."""
    out = {}
    for pk in (REF, PORT):
        t = pk.wisconsin.generate(10_000, seed=1)
        for mode in MODES:
            sess = pk.session(mode)
            sess.create_dataset("Data", t, dataverse="demo",
                                indexes=["onePercent", "unique1"],
                                primary="unique2")
            out[pk.name, mode] = pk.AFrame("demo", "Data", session=sess)
    return out


RAW = {k: np.asarray(v)
       for k, v in REF.wisconsin.generate(10_000, seed=1).columns.items()}


def _both(frames, mode, action, label):
    """Run ``action(frame)`` on both packages; the port's result, after
    checking it equals the reference's."""
    got = action(frames["port", mode])
    assert_same(got, action(frames["ref", mode]), label)
    return got


@pytest.mark.parametrize("mode", MODES)
def test_exp1_total_count(frames, mode):
    assert _both(frames, mode, len, "e1") == len(RAW["unique1"])


@pytest.mark.parametrize("mode", MODES)
def test_exp2_project_head(frames, mode):
    h = _both(frames, mode, lambda d: d[["two", "four"]].head(), "e2")
    assert set(h) == {"two", "four"} and len(h["two"]) == 5


@pytest.mark.parametrize("mode", MODES)
def test_exp3_filter_count(frames, mode):
    n = _both(frames, mode, lambda d: len(
        d[(d["ten"] == 3) & (d["twentyPercent"] == 2) & (d["two"] == 1)]), "e3")
    assert n == int(((RAW["ten"] == 3) & (RAW["twentyPercent"] == 2)
                     & (RAW["two"] == 1)).sum())


@pytest.mark.parametrize("mode", MODES)
def test_exp4_group_count(frames, mode):
    g = _both(frames, mode, lambda d: d.groupby("oddOnePercent").agg("count"),
              "e4")
    assert g["count"].sum() == len(RAW["unique1"]) and len(g["count"]) == 100
    k = int(g["oddOnePercent"][7])
    assert g["count"][7] == (RAW["oddOnePercent"] == k).sum()


@pytest.mark.parametrize("mode", MODES)
def test_exp5_map_upper_head(frames, mode):
    up = _both(frames, mode, lambda d: d["stringu1"].map(str.upper).head(3),
               "e5")
    s = PORT.table.decode_strings(up["stringu1"])
    assert len(s) == 3 and all(x == x.upper() for x in s)


@pytest.mark.parametrize("mode", MODES)
def test_exp6_max(frames, mode):
    assert _both(frames, mode, lambda d: d["unique1"].max(), "e6") \
        == RAW["unique1"].max()


@pytest.mark.parametrize("mode", MODES)
def test_exp7_min(frames, mode):
    assert _both(frames, mode, lambda d: d["unique1"].min(), "e7") \
        == RAW["unique1"].min()


@pytest.mark.parametrize("mode", MODES)
def test_exp8_group_max(frames, mode):
    g = _both(frames, mode, lambda d: d.groupby("twenty")["four"].agg("max"),
              "e8")
    for k, v in zip(g["twenty"], g["max_four"]):
        assert v == RAW["four"][RAW["twenty"] == k].max()


@pytest.mark.parametrize("mode", MODES)
def test_exp9_sort_head(frames, mode):
    sh = _both(frames, mode, lambda d: d.sort_values(
        "unique1", ascending=False).head(5), "e9")
    assert list(sh["unique1"]) == sorted(RAW["unique1"])[-5:][::-1]


@pytest.mark.parametrize("mode", MODES)
def test_exp10_selection_head(frames, mode):
    sel = _both(frames, mode, lambda d: d[d["ten"] == 4].head(5), "e10")
    assert all(sel["ten"] == 4) and len(sel["ten"]) == 5


@pytest.mark.parametrize("mode", MODES)
def test_exp11_range_count(frames, mode):
    n = _both(frames, mode, lambda d: len(
        d[(d["onePercent"] >= 10) & (d["onePercent"] <= 30)]), "e11")
    assert n == int(((RAW["onePercent"] >= 10) & (RAW["onePercent"] <= 30)).sum())


@pytest.mark.parametrize("mode", MODES)
def test_exp12_join_count(frames, mode):
    def join(d):
        d2 = type(d)("demo", "Data", session=d._session)
        return len(d.merge(d2, left_on="unique1", right_on="unique1"))

    assert _both(frames, mode, join, "e12") == len(RAW["unique1"])


@pytest.mark.parametrize("mode", MODES)
def test_mean_describe(frames, mode):
    # unique1 sums past 2^24: a float32 sum is inexact in any order, so the
    # two packages agree to the reference's tolerance, not bit for bit
    means = {pk: frames[pk, mode]["unique1"].mean() for pk in ("ref", "port")}
    assert type(means["port"]) is type(means["ref"])
    for m in means.values():
        assert abs(m - RAW["unique1"].mean()) < 0.5
    # describe over columns whose float32 sums stay exact: equal outright
    desc = {pk: frames[pk, mode][["two", "twenty", "stringu1"]].describe()
            for pk in ("ref", "port")}
    assert desc["port"] == desc["ref"] and "stringu1" not in desc["port"]


@pytest.mark.parametrize("mode", MODES)
def test_setitem_and_persist(frames, mode):
    out = {}
    for pk in ("ref", "port"):
        d = frames[pk, mode]
        sub = d[d["two"] == 0][["unique1", "ten"]]
        sub["ten_sq"] = sub["ten"] * sub["ten"]
        kept = sub.persist(f"TwoZero_{mode}")
        out[pk] = (len(kept), kept.head(4), kept.query)
    assert out["port"][0] == out["ref"][0] == int((RAW["two"] == 0).sum())
    assert_same(out["port"][1], out["ref"][1], "persisted head")
    h = out["port"][1]
    assert all(h["ten_sq"] == h["ten"] * h["ten"])
    assert out["port"][2] == out["ref"][2]


@pytest.mark.parametrize("mode", MODES)
def test_open_vs_closed_types(mode):
    """Open (schema-on-read) and closed datasets answer alike."""
    out = {}
    for pk in (REF, PORT):
        t = pk.wisconsin.generate(10_000, seed=1)
        sess = pk.session(mode)
        sess.create_dataset("Open", t, dataverse="d", closed=False)
        sess.create_dataset("Closed", t, dataverse="d", closed=True)
        a = pk.AFrame("d", "Open", session=sess)
        b = pk.AFrame("d", "Closed", session=sess)
        out[pk.name] = (len(a[a["ten"] == 3]), len(b[b["ten"] == 3]),
                        a[a["ten"] == 3][["unique1", "ten"]].head(3))
    assert out["port"][0] == out["port"][1] == out["ref"][0]
    assert_same(out["port"][2], out["ref"][2], "open head")


@pytest.mark.parametrize("mode", MODES)
def test_lazy_no_execution_until_action(frames, mode):
    out = {}
    for pk in ("ref", "port"):
        d = frames[pk, mode]
        sess = d._session
        before = sess.stats["compiles"] + sess.stats["hits"]
        filtered = d[d["ten"] == 1][["two", "four"]]  # builds the plan only
        out[pk] = (sess.stats["compiles"] + sess.stats["hits"] - before,
                   filtered.query)
    assert out["port"] == out["ref"]
    assert out["port"][0] == 0 and "WHERE" in out["port"][1]
