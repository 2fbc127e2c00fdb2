"""The slice end to end: the paper's 12 Wisconsin expressions through the
port's AFrame → Session, in gspmd and kernel mode on the CPU (kernel mode
runs every relational kernel's plain version there), held bit for bit,
dtypes included, against the JAX reference's gspmd session over three
rounds of randomized literals — plus the reference's kernel-mode checks
(tests/test_kernel_mode.py): physical operator choice, plan-cache counts,
dispatch of all four kernel families, graceful fallbacks, the f32-exactness
gate and the single multi-aggregate launch."""
import numpy as np
import pytest
import torch

from repro.core import plan as RP
from repro.core.expr import Col as RCol
from repro.core.frame import AFrame as RFrame
from repro.data import wisconsin as rw
from repro.engine.session import Session as RSession
from repro.engine.table import ColumnMeta as RMeta
from repro.engine.table import Table as RTable
from repro_torch.core import physical as PH
from repro_torch.core import plan as TP
from repro_torch.core.expr import Col as TCol
from repro_torch.core.frame import AFrame as TFrame
from repro_torch.data import wisconsin as tw
from repro_torch.engine import session as tsession
from repro_torch.engine.session import Session as TSession
from repro_torch.engine.table import ColumnMeta as TMeta
from repro_torch.engine.table import Table as TTable
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_production_mesh

from engine_probe import EXPRESSIONS

N_ROWS = 8_192


@pytest.fixture(scope="module")
def tables():
    return rw.generate(N_ROWS, seed=5), tw.generate(N_ROWS, seed=5)


def _rsession(table, mode, **kw):
    sess = RSession(mode=mode, **kw)
    sess.create_dataset("data", table, dataverse="bench", closed=True)
    sess.create_dataset("data_r", table, dataverse="bench", closed=True)
    return sess


def _tsession(table, mode, **kw):
    sess = TSession(mode=mode, device="cpu", **kw)
    sess.create_dataset("data", table, dataverse="bench", closed=True)
    sess.create_dataset("data_r", table, dataverse="bench", closed=True)
    return sess


@pytest.fixture(scope="module")
def sessions(tables):
    rt, tt = tables
    return {"ref-gspmd": _rsession(rt, "gspmd"), "ref-kernel": _rsession(rt, "kernel"),
            "gspmd": _tsession(tt, "gspmd"), "kernel": _tsession(tt, "kernel")}


def _frames(sess):
    F = TFrame if isinstance(sess, TSession) else RFrame
    return F("bench", "data", session=sess), F("bench", "data_r", session=sess)


def _assert_same(a, b, label):
    if isinstance(b, dict):
        assert set(a) == set(b), label
        for k in b:
            av, bv = np.asarray(a[k]), np.asarray(b[k])
            assert av.dtype == bv.dtype, (label, k, av.dtype, bv.dtype)
            np.testing.assert_array_equal(av, bv, err_msg=f"{label}:{k}")
    else:
        assert type(a) is type(b) and a == b, (label, a, b)


@pytest.mark.parametrize("expr", sorted(EXPRESSIONS))
@pytest.mark.parametrize("mode", ["gspmd", "kernel"])
def test_wisconsin_expressions_bit_identical_to_reference(sessions, expr, mode):
    """Three rounds with randomized literals: the port's result equals the
    reference gspmd session's, and the physical operator at the plan root
    is the one the reference's session of the same mode picked."""
    fn = EXPRESSIONS[expr]
    for round_ in range(3):
        want = fn(*_frames(sessions["ref-gspmd"]), np.random.default_rng(100 + round_))
        got = fn(*_frames(sessions[mode]), np.random.default_rng(100 + round_))
        _assert_same(got, want, f"{expr}[{mode}] round {round_}")
        fn(*_frames(sessions[f"ref-{mode}"]), np.random.default_rng(100 + round_))
        assert type(sessions[mode].last_physical).__name__ == \
            type(sessions[f"ref-{mode}"].last_physical).__name__


@pytest.mark.parametrize("expr", sorted(EXPRESSIONS))
def test_optimized_plans_equal_reference(sessions, expr):
    """The logical optimizer is a faithful port: equal optimized-plan
    fingerprints and SQL++ for every expression."""
    fn = EXPRESSIONS[expr]
    got, want = [], []
    for store, key in ((got, "kernel"), (want, "ref-kernel")):
        fn(*_frames(sessions[key]), np.random.default_rng(7))
        store.append(sessions[key].last_optimized)
    assert got[0].fingerprint() == want[0].fingerprint()
    assert got[0].to_sql() == want[0].to_sql()


def test_kernels_on_lowered_path(tables):
    sess = _tsession(tables[1], "kernel")
    df, dr = _frames(sess)
    ops.reset_dispatch_counts()
    len(df[(df["ten"] == 4) & (df["twentyPercent"] == 4) & (df["two"] == 0)])
    assert ops.DISPATCH_COUNTS.get("filter_count", 0) >= 1
    assert isinstance(sess.last_physical, PH.KernelRangeCount)
    df.groupby("oddOnePercent").agg("count")
    assert ops.DISPATCH_COUNTS.get("segment_agg", 0) >= 1
    df.sort_values("unique1", ascending=False).head()
    assert ops.DISPATCH_COUNTS.get("topk", 0) >= 1
    len(df.merge(dr, left_on="unique1", right_on="unique1"))
    assert ops.DISPATCH_COUNTS.get("merge_join_count", 0) >= 1


RANGE_SHAPES = {
    "point": lambda df, x: df[df["onePercent"] == x],
    "range": lambda df, x: df[(df["onePercent"] >= x) & (df["onePercent"] <= x + 9)],
    "at_least": lambda df, x: df[df["onePercent"] >= x],
    "at_most": lambda df, x: df[df["onePercent"] <= x],
}


def test_plan_cache_counts_equal_reference(tables):
    """Randomized literals reuse the compiled query and skip the optimizer:
    the same compiles / hits / optimizes as the reference — for e3's
    three-column point, and across the range count's point, range and
    one-sided shapes (an open side is a runtime literal, so ``==``, ``>=``
    and ``<=`` share one compiled query; the two-conjunct range does not).
    The counts, the physical fingerprints, the labels and the explain texts
    equal the reference's at every step."""
    counts = {}
    for key, sess in (("ref", _rsession(tables[0], "kernel")),
                      ("port", _tsession(tables[1], "kernel"))):
        df, _ = _frames(sess)
        for x in (1, 7, 3):
            len(df[(df["ten"] == x) & (df["twentyPercent"] == x % 5)
                   & (df["two"] == x % 2)])
        counts[key] = [(sess.stats["compiles"], sess.stats["hits"],
                        sess.stats["optimizes"])]
    assert counts["port"] == counts["ref"] == [(1, 2, 1)]
    sessions = {"ref": _rsession(tables[0], "kernel"),
                "port": _tsession(tables[1], "kernel")}
    raw = tables[1].to_numpy()["onePercent"]
    want = {"point": lambda x: raw == x,
            "range": lambda x: (raw >= x) & (raw <= x + 9),
            "at_least": lambda x: raw >= x, "at_most": lambda x: raw <= x}
    steps = {"ref": [], "port": []}
    for name in ("point", "range", "at_least", "at_most", "point", "at_least"):
        for x in (11, 42):
            for key, sess in sessions.items():
                df, _ = _frames(sess)
                sel = RANGE_SHAPES[name](df, x)
                n = len(sel)
                assert n == int(want[name](x).sum()), (key, name, x)
                phys = sess.last_physical
                text = sess.explain((RP if key == "ref" else TP).Agg(
                    sel._plan, [(RP if key == "ref" else TP).AggSpec(
                        "count", "count", None)]))
                steps[key].append((name, x, sess.stats["compiles"],
                                   sess.stats["hits"], sess.stats["optimizes"],
                                   phys.fingerprint(), phys.label(), text))
    assert steps["port"] == steps["ref"]
    # one compiled query per conjunct count: point, >= and <= share one
    assert steps["port"][-1][2:5] == (2, 10, 4)


def test_point_and_range_share_compiled_query(tables):
    raw = tables[1].to_numpy()
    sess = _tsession(tables[1], "kernel")
    df, _ = _frames(sess)
    assert len(df[df["onePercent"] == 3]) == int((raw["onePercent"] == 3).sum())
    assert len(df[(df["onePercent"] >= 10) & (df["onePercent"] <= 12)]) == \
        int(((raw["onePercent"] >= 10) & (raw["onePercent"] <= 12)).sum())
    assert len(df[df["onePercent"] == 77]) == int((raw["onePercent"] == 77).sum())
    # the range has 2 conjuncts against the point's 1: another plan shape
    # and another compiled query (as the reference); == after == hits
    assert sess.stats["compiles"] == 2


def test_graceful_fallback_non_range_predicates(tables):
    raw = tables[1].to_numpy()
    sess = _tsession(tables[1], "kernel")
    df, _ = _frames(sess)
    assert len(df[(df["ten"] == 3) | (df["two"] == 0)]) == \
        int(((raw["ten"] == 3) | (raw["two"] == 0)).sum())
    assert isinstance(sess.last_physical, PH.MaskCount)
    assert len(df[df["ten"] != 3]) == int((raw["ten"] != 3).sum())
    assert isinstance(sess.last_physical, PH.MaskCount)
    assert len(df[df["onePercent"] < 10]) == int((raw["onePercent"] < 10).sum())
    assert isinstance(sess.last_physical, PH.MaskCount)
    # a string column without a dictionary lane stays on the mask path too
    assert len(df[df["stringu1"] == "Aaaaaaab"]) == 1
    assert isinstance(sess.last_physical, PH.MaskCount)


def test_group_sum_overflow_falls_back_exactly(tables):
    """unique1 at 8192 rows can sum past 2^24: the gate must refuse the f32
    kernel and take the generic integer path, equal to the reference."""
    want = _rsession(tables[0], "gspmd")
    rdf, _ = _frames(want)
    expected = rdf.groupby("two")["unique1"].agg("sum")
    ops.reset_dispatch_counts()
    for mode in ("gspmd", "kernel"):
        df, _ = _frames(_tsession(tables[1], mode))
        _assert_same(df.groupby("two")["unique1"].agg("sum"), expected, mode)
    assert ops.DISPATCH_COUNTS.get("segment_agg", 0) == 0


def test_multi_agg_single_kernel_launch(tables):
    """agg({a: sum, b: mean, c: count}) fuses into ONE segment_agg launch
    and equals the reference bit for bit (float32 mean included)."""
    rdf, _ = _frames(_rsession(tables[0], "gspmd"))
    want = rdf.groupby("ten").agg({"four": "sum", "twenty": "mean", "two": "count"})
    sess = _tsession(tables[1], "kernel")
    df, _ = _frames(sess)
    ops.reset_dispatch_counts()
    got = df.groupby("ten").agg({"four": "sum", "twenty": "mean", "two": "count"})
    assert ops.DISPATCH_COUNTS.get("segment_agg", 0) == 1
    assert isinstance(sess.last_physical, PH.KernelSegmentAgg)
    _assert_same(got, want, "multi-agg")


def test_int32_unsafe_columns_fall_back():
    n = 2_000
    vals = np.arange(n, dtype=np.int64)
    t = TTable({"k": torch.from_numpy(vals),
                "ten": torch.from_numpy((vals % 10).astype(np.int32))},
               {"k": TMeta(np.dtype(np.int64), 0, 2**40, n),
                "ten": TMeta(np.dtype(np.int32), 0, 9, 10)})
    sess = TSession(mode="kernel", device="cpu")
    sess.create_dataset("big", t, dataverse="w")
    df = TFrame("w", "big", session=sess)
    ops.reset_dispatch_counts()
    assert len(df[df["k"] >= 5]) == n - 5
    assert isinstance(sess.last_physical, PH.MaskCount)
    assert len(df.merge(df, left_on="k", right_on="k")) == n
    assert ops.DISPATCH_COUNTS.get("merge_join_count", 0) == 0
    assert ops.DISPATCH_COUNTS.get("filter_count", 0) == 0
    assert len(df[df["ten"] == 3]) == int((vals % 10 == 3).sum())
    assert isinstance(sess.last_physical, PH.KernelRangeCount)


def test_group_sum_provenance_traced_through_rename():
    """A Project rename must not borrow a small column's exactness proof."""
    n = 2_000
    g = (np.arange(n) % 4).astype(np.int32)
    small = (np.arange(n) % 3).astype(np.int32)
    big = np.arange(n, dtype=np.int32)
    meta = {"g": (0, 3, 4), "x": (0, 2, 3), "huge": (0, 2**30, n)}
    rt = RTable({"g": g, "x": small, "huge": big},
                {k: RMeta(np.dtype(np.int32), *v) for k, v in meta.items()})
    tt = TTable({"g": torch.from_numpy(g), "x": torch.from_numpy(small),
                 "huge": torch.from_numpy(big)},
                {k: TMeta(np.dtype(np.int32), *v) for k, v in meta.items()})
    rs = RSession(mode="gspmd")
    rs.create_dataset("t", rt, dataverse="pv")
    want = rs.execute(RP.GroupAgg(
        RP.Project(RP.Scan("t", "pv"), [("g", RCol("g")), ("x", RCol("huge"))]),
        ["g"], [RP.AggSpec("s", "sum", "x")]))
    sess = TSession(mode="kernel", device="cpu")
    sess.create_dataset("t", tt, dataverse="pv")
    ops.reset_dispatch_counts()
    got = sess.execute(TP.GroupAgg(
        TP.Project(TP.Scan("t", "pv"), [("g", TCol("g")), ("x", TCol("huge"))]),
        ["g"], [TP.AggSpec("s", "sum", "x")]))
    assert ops.DISPATCH_COUNTS.get("segment_agg", 0) == 0
    _assert_same(got, want, "rename")


def test_ddl_invalidates_plan_cache():
    sess = TSession(mode="kernel", device="cpu")
    sess.create_dataset("d", tw.generate(2_000, seed=1), dataverse="w")
    assert len(TFrame("w", "d", session=sess)) == 2_000
    sess.create_dataset("d", tw.generate(5_000, seed=1), dataverse="w")
    assert len(TFrame("w", "d", session=sess)) == 5_000
    assert sess.stats["compiles"] == 2


@pytest.mark.parametrize("lo,hi", [(100, 5000), (4095, 4096), (8000, 8191)])
def test_clustered_range_skips_blocks_like_reference(lo, hi):
    """unique2 is sequential, so its zone maps prove most blocks empty: the
    count's filter_count grid and the group-by's segment_agg grid visit the
    surviving blocks only — the same blocks the reference keeps — and the
    answers equal the reference's."""
    n = 6 * 4096 + 123
    rsess = _rsession(rw.generate(n, seed=3), "kernel")
    tsess = _tsession(tw.generate(n, seed=3), "kernel")
    out = {}
    for key, sess in (("ref", rsess), ("port", tsess)):
        df, _ = _frames(sess)
        rows = df[(df["unique2"] >= lo) & (df["unique2"] <= hi)]
        cnt = len(rows)
        cnt_blocks = sess.last_physical.block_ids
        grp = rows.groupby("ten").agg("count")
        # (block ids, zone block, n_shards, blocks_per_shard, rows_per_shard)
        out[key] = (cnt, cnt_blocks, grp, sess.last_physical.comp_blocks[0])
    assert out["port"][0] == out["ref"][0] == hi - lo + 1
    assert out["port"][1] == out["ref"][1] is not None
    assert out["port"][3] == out["ref"][3]
    assert out["port"][3][0] == out["port"][1]
    _assert_same(out["port"][2], out["ref"][2], "range group count")


def test_explain_shows_the_kernel_plan(tables):
    sess = _tsession(tables[1], "kernel")
    text = sess.explain(TP.Agg(
        TP.Filter(TP.Scan("data", "bench"), (TCol("ten") == 2) & (TCol("two") == 0)),
        [TP.AggSpec("count", "count", None)]))
    assert "KernelRangeCount" in text and "filter_count kernel" in text
    assert sess.stats["compiles"] == 0  # explain compiles nothing


def test_session_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: Session() runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSession()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSession(mode="kernel", device="cuda")


@pytest.mark.parametrize("call", [
    lambda: make_production_mesh(device="cpu"),
    lambda: make_production_mesh(multi_pod=True, device="cpu"),
])
def test_features_of_later_slices_raise(call):
    """The pod meshes of the dry-run (A11), the last feature that raised,
    have landed: the reference's (16, 16) over ("data", "model") and (2,
    16, 16) over ("pod", "data", "model"), every shard on the device asked
    for; the pod axis joins the data axes. Without a device they need the
    card."""
    from repro_torch.launch.mesh import MeshAxes

    mesh = call()
    multi = "pod" in mesh.shape
    want = {"pod": 2, "data": 16, "model": 16} if multi else {"data": 16, "model": 16}
    assert mesh.shape == want and list(mesh.shape) == list(want)
    assert mesh.devices.shape == tuple(want.values())
    assert mesh.size == (512 if multi else 256)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    axes = MeshAxes.for_mesh(mesh)
    assert axes.data == (("pod", "data") if multi else ("data",))
    assert axes.data_size(mesh) == (32 if multi else 16)
    assert axes.model_size(mesh) == 16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_production_mesh()


def test_mesh_session_takes_shard_map_on_auto(tables):
    """A mesh of more than one shard makes "auto" mean shard_map (one
    shard: gspmd), as in the reference. On the pod mesh of the CPU the
    engine row-shards a table over the 16 data shards, and a session
    there answers as the meshless session and numpy do."""
    from repro_torch.launch.mesh import make_local_mesh

    assert TSession(mesh=make_local_mesh(2, device="cpu")).mode == "shard_map"
    assert TSession(mesh=make_local_mesh(1, device="cpu")).mode == "gspmd"
    assert TSession(mode="kernel",
                    mesh=make_local_mesh(2, device="cpu")).mode == "kernel"
    pod = make_production_mesh(device="cpu")
    assert TSession(mesh=pod).mode == "shard_map"
    t = tables[1]
    raw = {k: v.numpy() for k, v in t.columns.items()}
    flat = _tsession(t, "gspmd")
    for mode in ("shard_map", "kernel"):
        sess = _tsession(t, mode, mesh=pod)
        for name in ("1_count", "3_filter_count", "4_group_count", "6_max",
                     "8_group_max", "11_range_count", "12_join_count"):
            fn = EXPRESSIONS[name]
            got = fn(*_frames(sess), np.random.default_rng(3))
            _assert_same(got, fn(*_frames(flat), np.random.default_rng(3)),
                         f"{name}[{mode}] on the pod mesh")
        df = _frames(sess)[0]
        assert len(df[df["ten"] == 4]) == int((raw["ten"] == 4).sum())
        assert df["unique1"].max() == raw["unique1"].max()


def test_string_dictionary_fast_path_raises_in_kernel_mode(tables):
    """string ==/IN/group-by on a dictionary lane no longer raise: the
    kernel planner lowers ``==`` onto filter_count over ``__dict_string4``
    (the literal bound to its dictionary id), ``IN`` onto one launch per
    member, and a group-by on a string key runs over dictionary ids in both
    modes and decodes them to the encoded (G, 16) rows — each equal to the
    reference's."""
    rdf, _ = _frames(_rsession(tables[0], "kernel"))
    for mode in ("gspmd", "kernel"):
        sess = _tsession(tables[1], mode)
        df, _ = _frames(sess)
        assert len(df[df["string4"] == "HHHHxxxx"]) == \
            len(rdf[rdf["string4"] == "HHHHxxxx"]) == N_ROWS // 4
        if mode == "kernel":
            assert isinstance(sess.last_physical, PH.KernelRangeCount)
            assert sess.last_physical.cols == ("__dict_string4",)
        assert len(df[df["string4"].isin(["AAAAxxxx", "OOOOxxxx"])]) == \
            len(rdf[rdf["string4"].isin(["AAAAxxxx", "OOOOxxxx"])]) == N_ROWS // 2
        _assert_same(df.groupby("string4").agg("count"),
                     rdf.groupby("string4").agg("count"), f"{mode} group")


def test_collect_and_describe_equal_reference(tables):
    rdf, _ = _frames(_rsession(tables[0], "gspmd"))
    df, _ = _frames(_tsession(tables[1], "kernel"))
    _assert_same(df[df["ten"] == 3][["unique1", "stringu2"]].collect(),
                 rdf[rdf["ten"] == 3][["unique1", "stringu2"]].collect(), "collect")
    got, want = df[["two", "twenty"]].describe(), rdf[["two", "twenty"]].describe()
    assert got == want
    assert tsession.resolve_device("cpu") == torch.device("cpu")
