"""Streaming ingestion on the port (``repro_torch.engine.lsm`` /
``ingest``): the scenarios of tests/test_lsm.py replayed on both packages in
one process — the same numpy-seeded inputs, gspmd, shard_map and kernel
mode, the port on ``device="cpu"`` (kernel mode runs each kernel's plain
version there). Results are held bit for bit, dtypes included, against
the reference, before and after compaction; compile, hit and launch counts
equal the reference's (shard_map: the reference's one-device mesh against
the port's one-shard mesh). The port's 2- and 8-shard meshes, in
shard_map and kernel mode, give the same results with a launch per
shard."""
import functools

import numpy as np
import pytest

from torch_replay import (PORT, REF, assert_same, counts, host_rows,
                          scaled_launches)

BASE_ROWS = 3_000
PUSH_ROWS = 700


def _deferred(pk):
    return pk.lsm.CompactionPolicy(size_ratio=10.0, max_runs=64)


def _fed_session(pk, mode, n_pushes=2, shards=None):
    sess = pk.session(mode, shards=shards)
    sess.create_dataset("Live", pk.wisconsin.generate(BASE_ROWS, seed=3),
                        dataverse="d", indexes=["onePercent"], primary="unique2")
    sess.create_dataset("Dim", pk.wisconsin.generate(500, seed=7), dataverse="d")
    feed = pk.Feed(sess, "Live", "d", flush_rows=PUSH_ROWS, policy=_deferred(pk))
    for i in range(n_pushes):
        rows = host_rows(pk.wisconsin.generate(PUSH_ROWS, seed=20 + i))
        rows["unique2"] = rows["unique2"] + BASE_ROWS + i * PUSH_ROWS
        feed.push(rows)
    return sess, feed


def _query_suite(pk, sess):
    df = pk.AFrame("d", "Live", session=sess)
    dim = pk.AFrame("d", "Dim", session=sess)
    return {
        "len": len(df),
        "filter_count": len(df[(df["ten"] == 3) & (df["two"] == 1)]),
        "indexed_range": len(df[(df["onePercent"] >= 10) & (df["onePercent"] <= 30)]),
        "group_count": df.groupby("ten").agg("count"),
        "group_mix": df.groupby("twenty").agg(
            {"four": "sum", "ten": "mean", "two": "max", "onePercent": "min"}),
        "scalar_max": df["unique2"].max(),
        "scalar_min": df["unique1"].min(),
        "scalar_sum": df["four"].sum(),
        "sort_head": df.sort_values("unique1", ascending=False).head(7),
        "head": df.head(5),
        "join_count": len(df.merge(dim, left_on="unique1", right_on="unique1")),
        "project_head": df[["two", "four", "stringu1"]].head(4),
    }


def _suite_before_after(pk, mode, shards=None):
    sess, feed = _fed_session(pk, mode, shards=shards)
    assert feed.stats["flushes"] == 2 and feed.stats["compactions"] == 0
    pk.ops.reset_dispatch_counts()
    before = _query_suite(pk, sess)
    launches = dict(pk.ops.DISPATCH_COUNTS)
    c_before = counts(sess)
    feed.compact()
    assert feed.stats["compactions"] == 1
    return (before, _query_suite(pk, sess), launches, c_before,
            counts(sess), dict(feed.stats))


@functools.lru_cache(maxsize=None)
def _ref_suite(mode):
    return _suite_before_after(REF, mode)


@pytest.mark.parametrize("mode", ["gspmd", "shard_map", "kernel"])
def test_queries_identical_before_and_after_compaction(mode):
    """The LSM read invariant on the port, held against the reference: base
    ∪ runs and the compacted dataset answer every query family bit for bit,
    with the reference's launch, compile and hit counts."""
    out = {"ref": _ref_suite(mode), "port": _suite_before_after(PORT, mode)}
    for k in out["ref"][0]:
        assert_same(out["port"][0][k], out["ref"][0][k], f"{mode}:{k}:before")
        assert_same(out["port"][1][k], out["ref"][1][k], f"{mode}:{k}:after")
        assert_same(out["port"][0][k], out["port"][1][k], f"{mode}:{k}")
    assert out["port"][2:] == out["ref"][2:]


@pytest.mark.parametrize("shards", [2, 8])
@pytest.mark.parametrize("mode", ["shard_map", "kernel"])
def test_queries_on_sharded_meshes(mode, shards):
    """The same suite on 2- and 8-shard port meshes: the reference's
    results before and after compaction, every kernel launched once per
    shard (a top-k once more, over the gathered candidates)."""
    want = _ref_suite(mode)
    got = _suite_before_after(PORT, mode, shards=shards)
    for k in want[0]:
        assert_same(got[0][k], want[0][k], f"{mode}/{shards}:{k}:before")
        assert_same(got[1][k], want[1][k], f"{mode}/{shards}:{k}:after")
    assert got[2] == scaled_launches(want[2], shards, meshless=mode != "shard_map")
    assert got[5] == want[5]


def test_plan_cache_variants_keep_their_literal_slots():
    """Two variants of one optimized plan share its Lit objects: compiling
    the two-component variant (the range reaches the run) must not re-slot
    the literals the cached one-component variant reads when a later
    binding reuses it. Equal to the reference and to numpy."""
    ranges = [(8192, 8192), (8192, 11_264), (9000, 9500), (0, 3072)]
    got = {}
    for pk in (REF, PORT):
        sess = pk.session()
        ids = np.arange(20_000, dtype=np.int32)
        sess.create_dataset("C", pk.Table({"id": ids, "ts": ids.copy()}),
                            dataverse="d", primary="id")
        feed = pk.Feed(sess, "C", "d", flush_rows=10**9, policy=_deferred(pk))
        run = np.arange(10_240, 11_264, dtype=np.int32) + 10_000
        feed.push({"id": run, "ts": run - 10_000 + 1})
        feed.flush()
        df = pk.AFrame("d", "C", session=sess)
        got[pk.name] = [len(df[(df["ts"] >= lo) & (df["ts"] <= hi)])
                        for lo, hi in ranges]
    ts = np.concatenate([np.arange(20_000), np.arange(10_241, 11_265)])
    want = [int(((ts >= lo) & (ts <= hi)).sum()) for lo, hi in ranges]
    assert got["ref"] == want
    assert got["port"] == want


def test_union_plan_on_lowered_path():
    """Pre-compaction plans fan out per LSM component, as the reference's."""
    PH = PORT.PH
    sess, _ = _fed_session(PORT, "gspmd")
    df = PORT.AFrame("d", "Live", session=sess)
    len(df)
    opt = sess.last_optimized
    assert isinstance(opt, PORT.P.UnionScalar) and len(opt.children) == 3
    df.sort_values("unique1").head(3)
    assert any(isinstance(n, PH.PrunedUnionRuns)
               for n in PH.walk(sess.last_physical))
    len(df[(df["onePercent"] >= 5) & (df["onePercent"] <= 9)])
    probes = [n for n in PH.walk(sess.last_physical)
              if isinstance(n, PH.IndexOnlyCount)]
    assert {n.dataset for n in probes} == {"Live", "Live@run0", "Live@run1"}


@pytest.mark.parametrize("pk", [REF, PORT], ids=["ref", "port"])
def test_kernel_mode_launches_per_component(pk):
    """One filter_count and one segment_agg launch per component (3)."""
    sess, _ = _fed_session(pk, "kernel")
    df = pk.AFrame("d", "Live", session=sess)
    pk.ops.reset_dispatch_counts()
    len(df[(df["ten"] == 2) & (df["two"] == 0)])
    assert pk.ops.DISPATCH_COUNTS.get("filter_count", 0) == 3
    pk.ops.reset_dispatch_counts()
    df.groupby("ten").agg("count")
    assert pk.ops.DISPATCH_COUNTS.get("segment_agg", 0) == 3


def test_plan_cache_counts_across_flushes_and_compaction():
    """Every flush and the compaction change the component set and the
    stats epoch: compiles and hits move exactly as the reference's."""
    seen = {}
    for pk in (REF, PORT):
        sess, feed = _fed_session(pk, "kernel", n_pushes=0)
        df = pk.AFrame("d", "Live", session=sess)
        steps = []
        for i in range(3):
            for x in (1, 4):
                len(df[(df["ten"] == x) & (df["two"] == x % 2)])
                df.groupby("twenty").agg("count")
                steps.append(counts(sess))
            rows = host_rows(pk.wisconsin.generate(PUSH_ROWS, seed=60 + i))
            rows["unique2"] = rows["unique2"] + BASE_ROWS + i * PUSH_ROWS
            feed.push(rows)
        feed.compact()
        len(df[(df["ten"] == 2) & (df["two"] == 0)])
        steps.append(counts(sess))
        seen[pk.name] = steps
    assert seen["port"] == seen["ref"]


def test_run_components_and_metadata_preserved():
    sess, feed = _fed_session(PORT, "gspmd")
    ds = sess.catalog.get("d", "Live")
    assert len(ds.runs) == 2
    run = sess.catalog.get("d", "Live@run0")
    assert run is ds.runs[0]
    assert run.closed and run.live_rows == PUSH_ROWS
    assert run.table.num_rows % PORT.lsm.RUN_BLOCK == 0
    assert "__valid__" in run.table.columns
    ix = run.index_on("onePercent")
    assert ix is not None and ix.kind == "secondary" and ix.zone_min is not None
    assert bool((ix.sorted_keys[1:] >= ix.sorted_keys[:-1]).all())
    assert run.primary_index is not None
    assert run.table.meta["unique2"].sorted_ascending
    feed.compact()
    ds = sess.catalog.get("d", "Live")
    assert not ds.runs and ds.closed
    assert ds.primary_index.column == "unique2"
    assert ds.table.meta["unique2"].sorted_ascending
    assert ds.index_on("onePercent").zone_min is not None
    assert ds.table.meta["unique2"].hi == BASE_ROWS + 2 * PUSH_ROWS - 1
    with pytest.raises(KeyError):
        sess.catalog.get("d", "Live@run0")


def test_group_domain_widens_with_runs():
    got = {}
    for pk in (REF, PORT):
        sess = pk.session()
        sess.create_dataset("G", pk.Table({
            "k": np.arange(8, dtype=np.int32) % 4,
            "v": np.arange(8, dtype=np.int32)}), dataverse="d")
        feed = pk.Feed(sess, "G", "d", flush_rows=4, policy=_deferred(pk))
        feed.push({"k": np.array([7, 7, 9, 9], np.int32),
                   "v": np.array([1, 2, 3, 4], np.int32)})
        before = pk.AFrame("d", "G", session=sess).groupby("k").agg("count")
        feed.compact()
        after = pk.AFrame("d", "G", session=sess).groupby("k").agg("count")
        assert_same(before, after, pk.name)
        got[pk.name] = before
    assert_same(got["port"], got["ref"], "widened_groups")
    assert set(got["port"]["k"].tolist()) == {0, 1, 2, 3, 7, 9}


def test_empty_flush_is_noop_and_stats_counters():
    sess, feed = _fed_session(PORT, "gspmd", n_pushes=1)
    stats0 = dict(feed.stats)
    feed.flush()
    assert feed.stats == stats0
    assert feed.stats["runs"] == 1 and feed.stats["run_rows"] == PUSH_ROWS
    rows = host_rows(PORT.wisconsin.generate(10, seed=99))
    rows["unique2"] = rows["unique2"] + 10_000
    feed.push(rows)
    df = PORT.AFrame("d", "Live", session=sess)
    assert feed.stats["flushes"] == 1 and len(df) == BASE_ROWS + PUSH_ROWS
    feed.flush()
    assert feed.stats["flushes"] == 2 and len(df) == BASE_ROWS + PUSH_ROWS + 10
    feed.compact()
    assert feed.stats["runs"] == 0 and feed.stats["run_rows"] == 0


def test_compaction_policy_triggers():
    t = PORT.wisconsin.generate(1_000, seed=1)
    sess = PORT.session()
    sess.create_dataset("A", t, dataverse="d")
    feed = PORT.Feed(sess, "A", "d", flush_rows=100,
                     policy=PORT.lsm.CompactionPolicy(size_ratio=0.0))
    feed.push({k: v[:100] for k, v in host_rows(t).items()})
    assert feed.stats["flushes"] == 1 and feed.stats["compactions"] == 1
    assert not sess.catalog.get("d", "A").runs
    sess2 = PORT.session()
    sess2.create_dataset("B", t, dataverse="d")
    feed2 = PORT.Feed(sess2, "B", "d", flush_rows=10,
                      policy=PORT.lsm.CompactionPolicy(size_ratio=100.0,
                                                       max_runs=2))
    for _ in range(3):
        feed2.push({k: v[:10] for k, v in host_rows(t).items()})
    assert feed2.stats["flushes"] == 3 and feed2.stats["compactions"] == 1


def test_push_schema_validation():
    _, feed = _fed_session(PORT, "gspmd", n_pushes=0)
    good = host_rows(PORT.wisconsin.generate(20, seed=0))
    cases = [
        ("missing columns.*'ten'", lambda b: b.pop("ten")),
        ("unexpected columns.*'bogus'",
         lambda b: b.__setitem__("bogus", np.zeros(20, np.int32))),
        ("ragged", lambda b: b.__setitem__("ten", b["ten"][:5])),
        ("not safely castable",
         lambda b: b.__setitem__("ten", b["ten"].astype(np.float64))),
        ("fixed width",
         lambda b: b.__setitem__("stringu1", b["stringu1"][:, :8])),
        ("expected 2-d",
         lambda b: b.__setitem__("stringu1", np.zeros(20, np.int32))),
        ("lossy narrowing",
         lambda b: b.__setitem__("unique2", np.full(20, 2**31 + 5, np.int64))),
    ]
    for match, spoil in cases:
        bad = dict(good)
        spoil(bad)
        with pytest.raises(ValueError, match=match):
            feed.push(bad)
    assert feed.stats["ingested"] == 0
    ok = dict(good)
    ok["ten"] = ok["ten"].astype(np.int64)
    ok["unique2"] = good["unique2"] + 50_000
    feed.push(ok)
    assert feed.stats["ingested"] == 20


def test_compaction_keeps_join_guard_for_duplicated_keys():
    k = np.arange(100, dtype=np.int32)
    sess = PORT.session()
    sess.create_dataset("R", PORT.Table({"k": k, "v": k * 2}), dataverse="d")
    sess.create_dataset("L", PORT.Table({"k": k.copy(), "w": k * 3}),
                        dataverse="d")
    feed = PORT.Feed(sess, "R", "d", flush_rows=100, policy=_deferred(PORT))
    feed.push({"k": k.copy(), "v": k * 5})
    feed.compact()
    dl = PORT.AFrame("d", "L", session=sess)
    dr = PORT.AFrame("d", "R", session=sess)
    with pytest.raises(NotImplementedError, match="non-unique key"):
        dl.merge(dr, left_on="k", right_on="k").head(200)
    assert len(dl.merge(dr, left_on="k", right_on="k")) == 200


def _view_plan(pk):
    P = pk.P
    return P.GroupAgg(P.Scan("Live", "d"), ["ten"], [
        P.AggSpec("count", "count", None),
        P.AggSpec("sum_four", "sum", "four"),
        P.AggSpec("mean_twenty", "mean", "twenty"),
        P.AggSpec("max_onePercent", "max", "onePercent"),
        P.AggSpec("min_unique1", "min", "unique1")])


@pytest.mark.parametrize("mode", ["gspmd", "kernel"])
def test_view_incremental_equals_recompute(mode):
    """The view equals a recompute and the reference's view, with the
    reference's refresh and kernel-batch statistics, through compaction."""
    got = {}
    for pk in (REF, PORT):
        sess, feed = _fed_session(pk, mode, n_pushes=0)
        plan = _view_plan(pk)
        view = sess.create_view("by_ten", plan)
        for i in range(3):
            rows = host_rows(pk.wisconsin.generate(PUSH_ROWS, seed=40 + i))
            rows["unique2"] = rows["unique2"] + BASE_ROWS + i * PUSH_ROWS
            feed.push(rows)
        assert_same(sess.read_view("by_ten"), sess.execute(plan), pk.name)
        assert view.stats["refreshes"] == 4
        assert view.stats["kernel_batches"] >= 1
        feed.compact()
        assert_same(sess.read_view("by_ten"), sess.execute(plan),
                    f"{pk.name}:compacted")
        got[pk.name] = (sess.read_view("by_ten"), dict(view.stats))
    assert_same(got["port"][0], got["ref"][0], "view")
    assert got["port"][1] == got["ref"][1]


def test_view_with_filter_predicate():
    got = {}
    for pk in (REF, PORT):
        sess, feed = _fed_session(pk, "gspmd", n_pushes=0)
        df = pk.AFrame("d", "Live", session=sess)
        plan = df[df["two"] == 1].groupby("ten").agg_plan({"four": "sum"})
        sess.create_view("odd_by_ten", plan)
        rows = host_rows(pk.wisconsin.generate(PUSH_ROWS, seed=50))
        rows["unique2"] = rows["unique2"] + BASE_ROWS
        feed.push(rows)
        got[pk.name] = sess.read_view("odd_by_ten")
        assert_same(got[pk.name], sess.execute(plan), pk.name)
    assert_same(got["port"], got["ref"], "filtered_view")


def test_view_rejects_unsupported_plans():
    sess, _ = _fed_session(PORT, "gspmd", n_pushes=0)
    P = PORT.P
    with pytest.raises(ValueError, match="group-by"):
        sess.create_view("v", PORT.AFrame("d", "Live", session=sess)._plan)
    with pytest.raises(ValueError, match="group-by"):
        sess.create_view("v", P.GroupAgg(P.Scan("Live", "d"), ["ten", "two"],
                                         [P.AggSpec("count", "count", None)]))


def test_view_device_defaults_to_the_card(monkeypatch):
    """A view built directly runs its deltas where the session would: the
    card unless the caller names another device, and it raises without
    one rather than fall back to the CPU."""
    import torch

    plan = _view_plan(PORT)
    view = PORT.lsm.MaterializedView.from_plan("v", plan, device="cpu")
    assert view.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT.lsm.MaterializedView.from_plan("v", plan)


def test_view_random_push_sequences_match_recompute():
    """Seeded form of the reference's hypothesis case: random small batches
    under a compacting policy, the view against a numpy recompute and the
    engine's own query."""
    P = PORT.P
    for seed in range(4):
        rng = np.random.default_rng(seed)
        n0 = int(rng.integers(1, 40))
        base = {"k": rng.integers(0, 13, n0).astype(np.int32),
                "v": rng.integers(-50, 51, n0).astype(np.int32)}
        sess = PORT.session()
        sess.create_dataset("H", PORT.Table(base), dataverse="d")
        plan = P.GroupAgg(P.Scan("H", "d"), ["k"], [
            P.AggSpec("count", "count", None), P.AggSpec("sum_v", "sum", "v"),
            P.AggSpec("mean_v", "mean", "v"), P.AggSpec("max_v", "max", "v"),
            P.AggSpec("min_v", "min", "v")])
        sess.create_view("hv", plan)
        feed = PORT.Feed(sess, "H", "d", flush_rows=1,
                         policy=PORT.lsm.CompactionPolicy(size_ratio=2.0,
                                                          max_runs=3))
        ks, vs = [base["k"]], [base["v"]]
        for _ in range(int(rng.integers(1, 6))):
            m = int(rng.integers(1, 30))
            b = {"k": rng.integers(0, 13, m).astype(np.int32),
                 "v": rng.integers(-50, 51, m).astype(np.int32)}
            feed.push(b)
            ks.append(b["k"])
            vs.append(b["v"])
        k, v = np.concatenate(ks), np.concatenate(vs)
        got = sess.read_view("hv")
        keys = np.unique(k)
        np.testing.assert_array_equal(got["k"], keys)
        for i, kk in enumerate(keys):
            sel = v[k == kk]
            assert got["count"][i] == sel.size and got["sum_v"][i] == sel.sum()
            assert got["max_v"][i] == sel.max() and got["min_v"][i] == sel.min()
        assert_same(got, sess.execute(plan), f"seed {seed}")
        assert len(PORT.AFrame("d", "H", session=sess)) == k.size


def test_open_dataset_feed_roundtrip():
    got = {}
    for pk in (REF, PORT):
        sess = pk.session()
        sess.create_dataset("O", pk.wisconsin.generate(500, seed=2),
                            dataverse="d", closed=False)
        feed = pk.Feed(sess, "O", "d", flush_rows=100, policy=_deferred(pk))
        rows = host_rows(pk.wisconsin.generate(100, seed=9))
        rows["unique2"] = rows["unique2"] + 500
        feed.push(rows)
        df = pk.AFrame("d", "O", session=sess)
        before = (len(df), df["four"].sum(), df["unique1"].max())
        feed.compact()
        df = pk.AFrame("d", "O", session=sess)
        assert (len(df), df["four"].sum(), df["unique1"].max()) == before
        got[pk.name] = before
    assert got["port"] == got["ref"]
    assert got["port"][0] == 600


def test_component_and_view_stats_equal_reference():
    """The statistics the planner reads, per component (base and runs, with
    the index kinds, tombstones and shadowed rows) and of a view, equal the
    reference's harvest."""
    from repro.core import stats as rstats
    from repro_torch.core import stats as tstats

    got = {}
    for pk, st in ((REF, rstats), (PORT, tstats)):
        sess, feed = _fed_session(pk, "gspmd", n_pushes=1)
        view = sess.create_view("by_ten", _view_plan(pk))
        feed.delete(np.arange(0, 50, dtype=np.int32))
        feed.flush()
        out = []
        for comp in sess.catalog.components("d", "Live"):
            s = st.component_stats(sess.catalog, "d", comp.name)
            out.append((s.address, s.rows, s.padded_rows, s.kind, s.is_run,
                        s.tombstones, s.shadowed, s.index_on("onePercent"),
                        s.index_on("unique2"), s.column("unique2").span))
        v = st.view_stats(view)
        out.append((v.address, v.rows, v.padded_rows, v.kind,
                    v.column("ten").span, v.column("ten").distinct))
        got[pk.name] = out
    assert got["port"] == got["ref"]
