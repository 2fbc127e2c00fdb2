"""Mutations through anti-matter on the port (``Feed.upsert`` /
``Feed.delete``, newest-wins): the scenarios of tests/test_mutation.py
replayed on both packages in one process — the same numpy-seeded inputs,
gspmd, shard_map and kernel mode, the port on ``device="cpu"``
(shard_map: the reference's one-device mesh, the port's one-shard mesh).
Every query family over a mutated, uncompacted dataset is held bit for
bit, dtypes included, against the reference and against its own compacted
answer, and again on 2- and 8-shard port meshes; the reference's
hypothesis interleavings run here as seeded random sequences against the
same newest-wins oracle, the port also on 8 shards."""
import functools

import numpy as np
import pytest

from torch_replay import (PORT, REF, assert_same, counts, host_rows,
                          scaled_launches)

BASE_ROWS = 3_000
PUSH_ROWS = 700


def _deferred(pk):
    return pk.lsm.CompactionPolicy(size_ratio=100.0, max_runs=64)


def _mutated_session(pk, mode, shards=None):
    """Base + appended run + a mutation run upserting into both older
    components and deleting the dataset's extremes."""
    sess = pk.session(mode, shards=shards)
    sess.create_dataset("Live", pk.wisconsin.generate(BASE_ROWS, seed=3),
                        dataverse="d", indexes=["onePercent"], primary="unique2")
    sess.create_dataset("Dim", pk.wisconsin.generate(500, seed=7), dataverse="d")
    feed = pk.Feed(sess, "Live", "d", flush_rows=10**9, policy=_deferred(pk))
    rows = host_rows(pk.wisconsin.generate(PUSH_ROWS, seed=20))
    rows["unique2"] = rows["unique2"] + BASE_ROWS
    feed.push(rows)
    feed.flush()
    up = host_rows(pk.wisconsin.generate(200, seed=33))
    up["unique2"] = np.concatenate([
        np.arange(100, 250, dtype=up["unique2"].dtype),
        np.arange(BASE_ROWS + 10, BASE_ROWS + 60, dtype=up["unique2"].dtype)])
    feed.upsert(up)
    feed.delete(np.arange(BASE_ROWS + PUSH_ROWS - 40, BASE_ROWS + PUSH_ROWS,
                          dtype=np.int32))
    feed.delete(np.arange(0, 90, 7, dtype=np.int32))
    feed.flush()
    return sess, feed


def _query_suite(pk, sess):
    df = pk.AFrame("d", "Live", session=sess)
    dim = pk.AFrame("d", "Dim", session=sess)
    return {
        "len": len(df),
        "filter_count": len(df[(df["ten"] == 3) & (df["two"] == 1)]),
        "indexed_range": len(df[(df["onePercent"] >= 10) & (df["onePercent"] <= 30)]),
        "primary_range": len(df[(df["unique2"] >= 50) & (df["unique2"] <= 400)]),
        "pruning_range": len(df[(df["unique2"] >= BASE_ROWS + 100)
                                & (df["unique2"] <= BASE_ROWS + 300)]),
        "group_count": df.groupby("ten").agg("count"),
        "group_mix": df.groupby("twenty").agg(
            {"four": "sum", "ten": "mean", "two": "max", "onePercent": "min"}),
        "group_extremes": df.groupby("ten").agg(
            {"unique1": "max", "unique2": "min"}),
        "scalar_max": df["unique2"].max(),
        "scalar_min": df["unique1"].min(),
        "scalar_sum": df["four"].sum(),
        "sort_head": df.sort_values("unique1", ascending=False).head(7),
        "head": df.head(5),
        "join_count": len(df.merge(dim, left_on="unique1", right_on="unique1")),
        "project_head": df[["two", "four", "stringu1"]].head(4),
    }


def _suite_before_after(pk, mode, shards=None):
    sess, feed = _mutated_session(pk, mode, shards)
    assert feed.stats["tombstones"] > 0 and feed.stats["compactions"] == 0
    pk.ops.reset_dispatch_counts()
    before = _query_suite(pk, sess)
    launches = dict(pk.ops.DISPATCH_COUNTS)
    c_before = counts(sess)
    feed.compact()
    return before, _query_suite(pk, sess), launches, c_before, counts(sess)


@functools.lru_cache(maxsize=None)
def _ref_suite(mode):
    return _suite_before_after(REF, mode)


@pytest.mark.parametrize("mode", ["gspmd", "shard_map", "kernel"])
def test_mutated_queries_identical_before_and_after_compaction(mode):
    """The acceptance criterion, held against the reference: base ∪ runs
    with anti-matter answers every query family bit for bit as the
    compacted dataset and as the reference, with its launch, compile and
    hit counts, zone-map pruning on."""
    out = {"ref": _ref_suite(mode), "port": _suite_before_after(PORT, mode)}
    for k in out["ref"][0]:
        assert_same(out["port"][0][k], out["ref"][0][k], f"{mode}:{k}:before")
        assert_same(out["port"][1][k], out["port"][0][k], f"{mode}:{k}")
    assert out["port"][2:] == out["ref"][2:]
    assert out["port"][0]["scalar_max"] == BASE_ROWS + PUSH_ROWS - 41


@pytest.mark.parametrize("shards", [2, 8])
@pytest.mark.parametrize("mode", ["shard_map", "kernel"])
def test_mutated_queries_on_sharded_meshes(mode, shards):
    """The mutated suite on 2- and 8-shard port meshes: the reference's
    results before and after compaction, kernels launched per shard."""
    want = _ref_suite(mode)
    got = _suite_before_after(PORT, mode, shards)
    for k in want[0]:
        assert_same(got[0][k], want[0][k], f"{mode}/{shards}:{k}:before")
        assert_same(got[1][k], want[0][k], f"{mode}/{shards}:{k}:after")
    assert got[2] == scaled_launches(want[2], shards, meshless=mode != "shard_map")


def test_newest_wins_semantics():
    sess = PORT.session()
    k = np.arange(10, dtype=np.int32)
    sess.create_dataset("T", PORT.Table({"k": k, "v": (k * 10).astype(np.int32)}),
                        dataverse="d", primary="k")
    feed = PORT.Feed(sess, "T", "d", flush_rows=10**9, policy=_deferred(PORT))
    df = PORT.AFrame("d", "T", session=sess)
    feed.push({"k": np.array([3, 3], np.int32), "v": np.array([1, 2], np.int32)})
    feed.flush()
    assert len(df[df["k"] == 3]) == 3
    feed.upsert({"k": np.array([3, 3], np.int32),
                 "v": np.array([111, 222], np.int32)})
    feed.flush()
    assert len(df[df["k"] == 3]) == 1
    assert df[df["k"] == 3].collect()["v"].tolist() == [222]
    feed.delete(np.array([3], np.int32))
    feed.flush()
    assert len(df[df["k"] == 3]) == 0
    feed.push({"k": np.array([3], np.int32), "v": np.array([9], np.int32)})
    feed.flush()
    assert df[df["k"] == 3].collect()["v"].tolist() == [9]
    feed.push({"k": np.array([7], np.int32), "v": np.array([700], np.int32)})
    feed.delete(np.array([7], np.int32))
    feed.push({"k": np.array([7], np.int32), "v": np.array([71], np.int32)})
    feed.flush()
    assert df[df["k"] == 7].collect()["v"].tolist() == [71]
    feed.compact()
    assert df[df["k"] == 7].collect()["v"].tolist() == [71]
    assert df[df["k"] == 3].collect()["v"].tolist() == [9]


def test_mutations_require_primary_key_and_valid_keys():
    sess = PORT.session()
    sess.create_dataset("NoPk", PORT.Table({"a": np.arange(5, dtype=np.int32)}),
                        dataverse="d")
    feed = PORT.Feed(sess, "NoPk", "d")
    with pytest.raises(ValueError, match="primary key"):
        feed.upsert({"a": np.array([1], np.int32)})
    with pytest.raises(ValueError, match="primary key"):
        feed.delete(np.array([1], np.int32))
    sess.create_dataset("T", PORT.Table({"k": np.arange(5, dtype=np.int32)}),
                        dataverse="d", primary="k")
    feed = PORT.Feed(sess, "T", "d", policy=_deferred(PORT))
    with pytest.raises(ValueError, match="1-d"):
        feed.delete(np.zeros((2, 2), np.int32))
    with pytest.raises(ValueError, match="lossy narrowing"):
        feed.delete(np.array([2**31 + 7], np.int64))
    feed.delete(np.array([999], np.int64))
    feed.flush()
    assert len(PORT.AFrame("d", "T", session=sess)) == 5


def test_pruned_run_anti_matter_still_subtracts():
    """A run whose matter span misses the predicate is pruned, but its
    tombstones keep annihilating into the base: pruned == unpruned ==
    reference, with the reference's prune report."""
    k = np.arange(50, dtype=np.int32)
    results = {}
    for pk in (REF, PORT):
        for prune in (True, False):
            sess = pk.session(enable_prune=prune)
            sess.create_dataset("Z", pk.Table({"k": k.copy(),
                                               "v": (k * 2).astype(np.int32)}),
                                dataverse="d", primary="k")
            feed = pk.Feed(sess, "Z", "d", flush_rows=10**9,
                           policy=_deferred(pk))
            feed.delete(np.array([1, 2], np.int32))
            feed.push({"k": np.arange(1000, 1005, dtype=np.int32),
                       "v": np.zeros(5, np.int32)})
            feed.flush()
            df = pk.AFrame("d", "Z", session=sess)
            n = len(df[(df["k"] >= 0) & (df["k"] <= 10)])
            rep = dict(sess.last_prune_report)
            results[(pk.name, prune)] = (n, rep)
    assert results[("port", True)] == results[("ref", True)]
    assert results[("port", False)] == results[("ref", False)]
    assert results[("port", True)][0] == results[("port", False)][0] == 9
    assert results[("port", True)][1]["tombstones_retained"] >= 2


def test_subtract_scalars_on_index_only_path():
    PH = PORT.PH
    k = np.arange(5_000, dtype=np.int32)
    sess = PORT.session()
    sess.create_dataset("S", PORT.Table({"k": k, "v": (k * 2).astype(np.int32)}),
                        dataverse="d", primary="k")
    feed = PORT.Feed(sess, "S", "d", flush_rows=10**9, policy=_deferred(PORT))
    feed.delete(np.array([5, 6, 7], np.int32))
    feed.flush()
    feed.delete(np.array([7, 8], np.int32))  # key 7 tombstoned twice
    feed.flush()
    df = PORT.AFrame("d", "S", session=sess)
    assert len(df[(df["k"] >= 0) & (df["k"] <= 10)]) == 7
    phys = sess.last_physical
    subs = [x for x in PH.walk(phys) if isinstance(x, PH.SubtractScalars)]
    assert subs and any(isinstance(x, PH.ShadowProbeCount)
                        for x in PH.walk(phys))
    assert any("anti-matter subtraction" in x.note for x in subs)
    sess2 = PORT.session()
    sess2.create_dataset("S2", PORT.Table({"k": k.copy(),
                                           "v": (k % 100).astype(np.int32)}),
                         dataverse="d", primary="k", indexes=["v"])
    feed2 = PORT.Feed(sess2, "S2", "d", flush_rows=10**9, policy=_deferred(PORT))
    feed2.delete(np.array([42], np.int32))
    feed2.flush()
    df2 = PORT.AFrame("d", "S2", session=sess2)
    assert len(df2[(df2["v"] >= 40) & (df2["v"] <= 44)]) == 5 * 50 - 1
    assert not [x for x in PH.walk(sess2.last_physical)
                if isinstance(x, PH.IndexOnlyCount) and x.dataset == "S2"]


def test_stats_discount_annihilated_rows():
    from repro_torch.core.stats import harvest

    n = 1_000
    k = np.arange(n, dtype=np.int32)
    sess = PORT.session()
    sess.create_dataset("D", PORT.Table({"k": k, "v": k.copy()}), dataverse="d",
                        primary="k")
    feed = PORT.Feed(sess, "D", "d", flush_rows=10**9, policy=_deferred(PORT))
    feed.delete(np.arange(0, 100, dtype=np.int32))
    feed.flush()
    ds = sess.catalog.get("d", "D")
    assert ds.annihilated_rows == 100 and ds.num_live_rows == n - 100
    st = harvest(ds)
    assert st.rows == n - 100 and st.shadowed == 100
    run_st = harvest(sess.catalog.get("d", "D@run0"))
    assert run_st.tombstones == 100 and run_st.rows == 0
    feed.delete(np.arange(0, 100, dtype=np.int32))
    feed.flush()
    assert ds.annihilated_rows == 100
    assert len(PORT.AFrame("d", "D", session=sess)) == n - 100
    assert PORT.lsm.should_compact(ds, PORT.lsm.CompactionPolicy(size_ratio=0.2))
    assert not PORT.lsm.should_compact(ds, PORT.lsm.CompactionPolicy(size_ratio=0.5))


def _leveled_feed(pk, policy, n_flushes, base_rows=100, batch=10):
    sess = pk.session()
    sess.create_dataset("L", pk.Table({"k": np.arange(base_rows, dtype=np.int32),
                                       "v": np.zeros(base_rows, np.int32)}),
                        dataverse="d", primary="k")
    feed = pk.Feed(sess, "L", "d", flush_rows=batch, policy=policy)
    for i in range(n_flushes):
        feed.push({"k": np.arange(base_rows + i * batch,
                                  base_rows + (i + 1) * batch, dtype=np.int32),
                   "v": np.zeros(batch, np.int32)})
    return sess, feed


def test_leveled_policy_trigger_boundaries():
    lsm = PORT.lsm
    pol = lsm.LeveledCompactionPolicy(size_ratio=1000.0, max_runs=64,
                                      level0_runs=3, level_ratio=2)
    sess, feed = _leveled_feed(PORT, pol, 2)
    assert feed.stats["level_merges"] == 0
    assert [r.level for r in sess.catalog.get("d", "L").runs] == [0, 0]
    sess, feed = _leveled_feed(PORT, pol, 3)
    ds = sess.catalog.get("d", "L")
    assert feed.stats["level_merges"] == 1 and [r.level for r in ds.runs] == [1]
    assert ds.runs[0].num_live_rows == 30
    assert [r.name for r in ds.runs] == ["L@run3"]
    sess, feed = _leveled_feed(PORT, pol, 6)
    ds = sess.catalog.get("d", "L")
    assert [r.level for r in ds.runs] == [2] and feed.stats["level_merges"] == 3
    assert len(PORT.AFrame("d", "L", session=sess)) == 160
    sess, feed = _leveled_feed(PORT, lsm.LeveledCompactionPolicy(
        size_ratio=0.5, max_runs=64, level0_runs=10), 5)
    assert feed.stats["compactions"] == 1 and not sess.catalog.get("d", "L").runs
    sess, feed = _leveled_feed(PORT, lsm.LeveledCompactionPolicy(size_ratio=0.0), 3)
    assert feed.stats["compactions"] == 3 and feed.stats["level_merges"] == 0


def test_leveled_merge_preserves_mutation_results():
    got = {}
    for pk in (REF, PORT):
        n = 200
        sess = pk.session()
        sess.create_dataset("M", pk.Table({"k": np.arange(n, dtype=np.int32),
                                           "v": np.arange(n, dtype=np.int32)}),
                            dataverse="d", primary="k")
        pol = pk.lsm.LeveledCompactionPolicy(size_ratio=1000.0, max_runs=64,
                                             level0_runs=2, level_ratio=2)
        feed = pk.Feed(sess, "M", "d", flush_rows=10**9, policy=pol)
        df = pk.AFrame("d", "M", session=sess)
        rng = np.random.default_rng(0)
        expect = {int(k): int(k) for k in range(n)}
        for i in range(6):
            ks = rng.integers(0, n, 5).astype(np.int32)
            if i % 3 == 2:
                feed.delete(ks)
                for kk in ks.tolist():
                    expect.pop(kk, None)
            else:
                vs = rng.integers(1000, 2000, 5).astype(np.int32)
                feed.upsert({"k": ks, "v": vs})
                expect.update(dict(zip(ks.tolist(), vs.tolist())))
            feed.flush()
        assert feed.stats["level_merges"] >= 1
        assert len(df) == len(expect) and df["v"].sum() == sum(expect.values())
        rows = df.sort_values("k").collect()
        np.testing.assert_array_equal(rows["k"], sorted(expect))
        np.testing.assert_array_equal(rows["v"], [expect[kk] for kk in sorted(expect)])
        feed.compact()
        assert len(df) == len(expect) and df["v"].sum() == sum(expect.values())
        got[pk.name] = (rows, dict(feed.stats))
    assert_same(got["port"][0], got["ref"][0], "leveled")
    assert got["port"][1] == got["ref"][1]


def _view_session(pk):
    sess = pk.session()
    n = 60
    k = np.arange(n, dtype=np.int32)
    sess.create_dataset("V", pk.Table({"k": k, "g": (k % 4).astype(np.int32),
                                       "v": (k * 2).astype(np.int32)}),
                        dataverse="d", primary="k")
    P = pk.P
    plan = P.GroupAgg(P.Scan("V", "d"), ["g"], [
        P.AggSpec("count", "count", None), P.AggSpec("sum_v", "sum", "v"),
        P.AggSpec("mean_v", "mean", "v"), P.AggSpec("max_v", "max", "v"),
        P.AggSpec("min_v", "min", "v")])
    return sess, plan, n


def test_view_retraction_counts_sums_and_extremes():
    got = {}
    for pk in (REF, PORT):
        sess, plan, n = _view_session(pk)
        view = sess.create_view("by_g", plan)
        feed = pk.Feed(sess, "V", "d", flush_rows=10**9, policy=_deferred(pk))
        feed.delete(np.array([59, 3], np.int32))
        feed.upsert({"k": np.array([56, 8], np.int32),
                     "g": np.array([0, 0], np.int32),
                     "v": np.array([0, 5000], np.int32)})
        feed.flush()
        steps = [sess.read_view("by_g")]
        assert_same(steps[-1], sess.execute(plan), f"{pk.name}:retracted")
        assert view.stats["retractions"] == 1
        assert view.stats["rows_retracted"] == 4
        assert view.stats["extremum_recomputes"] >= 1
        feed.compact()
        assert_same(sess.read_view("by_g"), sess.execute(plan), pk.name)
        feed.delete(np.arange(1, n, 4, dtype=np.int32))  # all of group 1
        feed.flush()
        steps.append(sess.read_view("by_g"))
        assert 1 not in steps[-1]["g"].tolist()
        assert_same(steps[-1], sess.execute(plan), f"{pk.name}:emptied")
        feed.push({"k": np.array([n + 1], np.int32), "g": np.array([1], np.int32),
                   "v": np.array([-7], np.int32)})
        feed.flush()
        steps.append(sess.read_view("by_g"))
        assert_same(steps[-1], sess.execute(plan), f"{pk.name}:reborn")
        got[pk.name] = (steps, dict(view.stats))
    for a, b in zip(got["port"][0], got["ref"][0]):
        assert_same(a, b, "view steps")
    assert got["port"][1] == got["ref"][1]


def test_view_with_predicate_retracts_filtered_rows_only():
    sess = PORT.session()
    k = np.arange(40, dtype=np.int32)
    sess.create_dataset("F", PORT.Table({"k": k, "g": (k % 2).astype(np.int32),
                                         "v": k.copy()}),
                        dataverse="d", primary="k")
    df = PORT.AFrame("d", "F", session=sess)
    plan = df[df["v"] >= 10].groupby("g").agg_plan({"v": "sum"})
    sess.create_view("f", plan)
    feed = PORT.Feed(sess, "F", "d", flush_rows=10**9, policy=_deferred(PORT))
    feed.delete(np.array([5, 20], np.int32))
    feed.flush()
    assert_same(sess.read_view("f"), sess.execute(plan), "filtered_retract")


def _oracle_apply(rows, kind, payload):
    if kind == "push":
        rows.extend(payload)
    elif kind == "upsert":
        for kk, vv in payload:
            rows[:] = [r for r in rows if r[0] != kk]
            rows.append((kk, vv))
    elif kind == "delete":
        dead = set(payload)
        rows[:] = [r for r in rows if r[0] not in dead]


def _random_ops(rng):
    ops = []
    for _ in range(int(rng.integers(1, 8))):
        kind = ["push", "upsert", "delete", "flush", "compact"][int(rng.integers(5))]
        if kind in ("push", "upsert"):
            m = int(rng.integers(1, 7))
            ops.append((kind, list(zip(rng.integers(0, 31, m).tolist(),
                                       rng.integers(-40, 41, m).tolist()))))
        elif kind == "delete":
            ops.append((kind, rng.integers(0, 31, int(rng.integers(1, 6))).tolist()))
        else:
            ops.append((kind, None))
    return ops


@pytest.mark.parametrize("seed", range(4))
def test_mutation_interleavings_match_newest_wins_oracle(seed):
    """Random push/upsert/delete/flush/compact interleavings against a
    newest-wins oracle, on both packages in gspmd, shard_map and kernel
    mode (the port also on an 8-shard mesh): the surviving rows equal the
    oracle before and after compaction, and count / group max / sum agree
    across every session."""
    ops = _random_ops(np.random.default_rng(seed))
    base = [(kk, kk * 3) for kk in range(8)]
    oracle = list(base)
    engines = {}
    setups = [(pk, mode, None) for pk in (REF, PORT)
              for mode in ("gspmd", "shard_map", "kernel")]
    setups += [(PORT, mode, 8) for mode in ("shard_map", "kernel")]
    for pk, mode, shards in setups:
        sess = pk.session(mode, shards=shards)
        sess.create_dataset("H", pk.Table({
            "k": np.array([r[0] for r in base], np.int32),
            "v": np.array([r[1] for r in base], np.int32)}),
            dataverse="d", primary="k")
        engines[(pk.name, mode, shards)] = (pk, sess, pk.Feed(
            sess, "H", "d", flush_rows=10**9, policy=_deferred(pk)))
    for kind, payload in ops:
        for _, _, feed in engines.values():
            if kind in ("push", "upsert"):
                getattr(feed, kind)({
                    "k": np.array([r[0] for r in payload], np.int32),
                    "v": np.array([r[1] for r in payload], np.int32)})
            elif kind == "delete":
                feed.delete(np.array(payload, np.int32))
            else:
                getattr(feed, kind)()
        if kind in ("push", "upsert", "delete"):
            _oracle_apply(oracle, kind, payload)
    want = sorted(oracle)
    results = {}
    for key, (pk, sess, feed) in engines.items():
        feed.flush()
        df = pk.AFrame("d", "H", session=sess)
        got = df.sort_values("k").collect()
        assert sorted(zip(got["k"].tolist(), got["v"].tolist())) == want, key
        results[key] = {"count_lo": len(df[df["k"] <= 10]),
                        "group": df.groupby("k").agg({"v": "max"}) if want else None,
                        "sum": df["v"].sum()}
        feed.compact()
        got = df.sort_values("k").collect()
        assert sorted(zip(got["k"].tolist(), got["v"].tolist())) == want, key
    for key, res in results.items():
        for name, value in res.items():
            if value is not None:
                assert_same(value, results[("ref", "gspmd", None)][name],
                            f"{key}:{name}")


def test_open_dataset_mutations_roundtrip():
    got = {}
    for pk in (REF, PORT):
        n = 300
        k = np.arange(n, dtype=np.int32)
        sess = pk.session()
        sess.create_dataset("O", pk.Table({"k": k, "v": (k * 2).astype(np.int32)}),
                            dataverse="d", closed=False, primary="k")
        feed = pk.Feed(sess, "O", "d", flush_rows=10**9, policy=_deferred(pk))
        feed.upsert({"k": np.array([10], np.int32), "v": np.array([9999], np.int32)})
        feed.delete(np.array([20, 21], np.int32))
        feed.flush()
        df = pk.AFrame("d", "O", session=sess)
        before = (len(df), df["v"].sum(), df["v"].max())
        feed.compact()
        assert (len(df), df["v"].sum(), df["v"].max()) == before
        got[pk.name] = before
    assert got["port"] == got["ref"] and got["port"][0] == 298
