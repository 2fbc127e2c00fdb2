"""The live-engine scenarios of tests/test_lsm.py, tests/test_mutation.py,
tests/test_concurrency.py and tests/test_block_skip.py's sharded section,
written once over a package namespace ``pk`` (``torch_replay.pkg``'s
surface: ``session(mode, **kw)``, ``Feed``, ``lsm``, ``P``, ``AFrame``,
``ops``, ``Table``, ``wisconsin``, ``FaultPlan``), so that the reference's
meshless session, the port's one-process mesh and the port's sessions on
``torch.distributed`` ranks (tests/rank_workers.py) run the same calls
with the same numpy-seeded inputs.

This module imports numpy only, so rank bodies load no jax. Each scenario
returns what it observed; ``pk.observe(sess, label)``, where the
namespace has one, records the session's layout after each flush and
compaction (tests/test_torch_rank_live.py holds it to I1 and I2)."""
import numpy as np

PUSH_ROWS = 700


def _observe(pk, sess, label, dv="d", name="Live"):
    hook = getattr(pk, "observe", None)
    if hook is not None:
        hook(sess, label, dv, name)


def host_rows(table) -> dict:
    return {k: np.asarray(v) for k, v in table.columns.items()}


def _deferred(pk, ratio=10.0):
    return pk.lsm.CompactionPolicy(size_ratio=ratio, max_runs=64)


# -- tests/test_lsm.py ---------------------------------------------------------------


def fed_session(pk, mode, base_rows, n_pushes=2):
    sess = pk.session(mode)
    sess.create_dataset("Live", pk.wisconsin.generate(base_rows, seed=3),
                        dataverse="d", indexes=["onePercent"], primary="unique2")
    sess.create_dataset("Dim", pk.wisconsin.generate(500, seed=7), dataverse="d")
    feed = pk.Feed(sess, "Live", "d", flush_rows=PUSH_ROWS, policy=_deferred(pk))
    for i in range(n_pushes):
        rows = host_rows(pk.wisconsin.generate(PUSH_ROWS, seed=20 + i))
        rows["unique2"] = rows["unique2"] + base_rows + i * PUSH_ROWS
        feed.push(rows)
        _observe(pk, sess, f"push {i}")
    return sess, feed


def query_suite(pk, sess, base_rows, mutated=False):
    df = pk.AFrame("d", "Live", session=sess)
    dim = pk.AFrame("d", "Dim", session=sess)
    out = {
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
    if mutated:
        out["primary_range"] = len(df[(df["unique2"] >= 50)
                                      & (df["unique2"] <= 400)])
        out["pruning_range"] = len(df[(df["unique2"] >= base_rows + 100)
                                      & (df["unique2"] <= base_rows + 300)])
        out["group_extremes"] = df.groupby("ten").agg(
            {"unique1": "max", "unique2": "min"})
    return out


def counts(sess) -> tuple:
    return tuple(sess.stats[k] for k in ("compiles", "hits", "optimizes",
                                          "plans"))


def lookups(pk, sess, keys) -> dict:
    clu = pk.AFrame("d", "Live", session=sess)
    out = {}
    for k in keys:
        got = clu.get(int(k))
        out[int(k)] = None if got is None else \
            {c: np.asarray(v) for c, v in got.items()}
    return out


def persisted(pk, sess, name="P3") -> dict:
    """``persist`` of a filter over the dataset's components, then queries
    over it."""
    df = pk.AFrame("d", "Live", session=sess)
    df[(df["ten"] == 3) & (df["two"] == 1)].persist(name, dataverse="d")
    p = pk.AFrame("d", name, session=sess)
    return {"len": len(p), "group": p.groupby("twenty").agg("count"),
            "max": p["unique1"].max(),
            "rows": p.sort_values("unique2").head(6)}


def explain_union(pk, sess) -> str:
    P = pk.P
    plan = P.GroupAgg(P.Filter(P.Scan("Live", "d"),
                               (pk.expr.Col("ten") >= 2) & (pk.expr.Col("ten") <= 5)),
                      ["twenty"], [P.AggSpec("count", "count", None)])
    return sess.explain(plan)


def lsm_suite(pk, mode, base_rows):
    """tests/test_lsm.py's suite before and after compaction, with its
    launch and plan-cache counts and the feed's stats, then a persisted
    filter over the compacted base."""
    sess, feed = fed_session(pk, mode, base_rows)
    pk.ops.reset_dispatch_counts()
    before = query_suite(pk, sess, base_rows)
    launches = dict(pk.ops.DISPATCH_COUNTS)
    got = {"before": before, "launches": launches, "counts": counts(sess)}
    feed.compact()
    _observe(pk, sess, "compacted")
    got["after"] = query_suite(pk, sess, base_rows)
    got["counts_after"] = counts(sess)
    got["stats"] = dict(feed.stats)
    got["persist_after"] = persisted(pk, sess, "P3c")
    return got


def lsm_extras(pk, mode, base_rows):
    """Over tests/test_lsm.py's fed session (base and two runs) and a
    delete-only run (a run with no matter row: no string in its
    dictionary lanes): point lookups of base, run, deleted and absent
    keys, a persisted filter over base ∪ runs and an explain over the
    union."""
    sess, feed = fed_session(pk, mode, base_rows)
    feed.delete(np.array([1, base_rows + 5], np.int32))
    feed.flush()
    _observe(pk, sess, "delete-only run")
    keys = [0, 1, base_rows // 2, base_rows - 1, base_rows + 3, base_rows + 5,
            base_rows + 2 * PUSH_ROWS - 1, base_rows + 2 * PUSH_ROWS, -4]
    return {"get": lookups(pk, sess, keys), "explain": explain_union(pk, sess),
            "persist": persisted(pk, sess)}


def launches_per_component(pk, base_rows):
    """tests/test_lsm.py::test_kernel_mode_launches_per_component."""
    sess, _ = fed_session(pk, "kernel", base_rows)
    df = pk.AFrame("d", "Live", session=sess)
    pk.ops.reset_dispatch_counts()
    len(df[(df["ten"] == 2) & (df["two"] == 0)])
    fc = pk.ops.DISPATCH_COUNTS.get("filter_count", 0)
    pk.ops.reset_dispatch_counts()
    df.groupby("ten").agg("count")
    return {"filter_count": fc,
            "segment_agg": pk.ops.DISPATCH_COUNTS.get("segment_agg", 0)}


def _view_plan(pk):
    P = pk.P
    return P.GroupAgg(P.Scan("Live", "d"), ["ten"], [
        P.AggSpec("count", "count", None), P.AggSpec("sum_four", "sum", "four"),
        P.AggSpec("max_onePercent", "max", "onePercent")])


def view_incremental(pk, mode, base_rows):
    """tests/test_lsm.py::test_view_incremental_equals_recompute."""
    sess, feed = fed_session(pk, mode, base_rows, n_pushes=0)
    plan = _view_plan(pk)
    view = sess.create_view("by_ten", plan)
    for i in range(3):
        rows = host_rows(pk.wisconsin.generate(PUSH_ROWS, seed=40 + i))
        rows["unique2"] = rows["unique2"] + base_rows + i * PUSH_ROWS
        feed.push(rows)
    got = {"view": sess.read_view("by_ten"), "recompute": sess.execute(plan)}
    feed.compact()
    _observe(pk, sess, "view compacted")
    got["view_after"] = sess.read_view("by_ten")
    got["recompute_after"] = sess.execute(plan)
    got["stats"] = dict(view.stats)
    return got


def policy_triggers(pk):
    """tests/test_lsm.py::test_compaction_policy_triggers."""
    t = pk.wisconsin.generate(1_000, seed=1)
    sess = pk.session("gspmd")
    sess.create_dataset("A", t, dataverse="d")
    feed = pk.Feed(sess, "A", "d", flush_rows=100,
                   policy=pk.lsm.CompactionPolicy(size_ratio=0.0))
    feed.push({k: v[:100] for k, v in host_rows(t).items()})
    out = {"first": (feed.stats["flushes"], feed.stats["compactions"],
                     len(sess.catalog.get("d", "A").runs)),
           "len_first": len(pk.AFrame("d", "A", session=sess))}
    sess2 = pk.session("gspmd")
    sess2.create_dataset("B", t, dataverse="d")
    feed2 = pk.Feed(sess2, "B", "d", flush_rows=10,
                    policy=pk.lsm.CompactionPolicy(size_ratio=100.0, max_runs=2))
    for _ in range(3):
        feed2.push({k: v[:10] for k, v in host_rows(t).items()})
    out["second"] = (feed2.stats["flushes"], feed2.stats["compactions"])
    out["len_second"] = len(pk.AFrame("d", "B", session=sess2))
    return out


# -- tests/test_mutation.py ---------------------------------------------------------


def mutated_session(pk, mode, base_rows):
    sess = pk.session(mode)
    sess.create_dataset("Live", pk.wisconsin.generate(base_rows, seed=3),
                        dataverse="d", indexes=["onePercent"], primary="unique2")
    sess.create_dataset("Dim", pk.wisconsin.generate(500, seed=7), dataverse="d")
    feed = pk.Feed(sess, "Live", "d", flush_rows=10**9,
                   policy=_deferred(pk, 100.0))
    rows = host_rows(pk.wisconsin.generate(PUSH_ROWS, seed=20))
    rows["unique2"] = rows["unique2"] + base_rows
    feed.push(rows)
    feed.flush()
    _observe(pk, sess, "push")
    up = host_rows(pk.wisconsin.generate(200, seed=33))
    up["unique2"] = np.concatenate([
        np.arange(100, 250, dtype=up["unique2"].dtype),
        np.arange(base_rows + 10, base_rows + 60, dtype=up["unique2"].dtype)])
    feed.upsert(up)
    feed.delete(np.arange(base_rows + PUSH_ROWS - 40, base_rows + PUSH_ROWS,
                          dtype=np.int32))
    feed.delete(np.arange(0, 90, 7, dtype=np.int32))
    feed.flush()
    _observe(pk, sess, "mutations")
    return sess, feed


def mutated_suite(pk, mode, base_rows):
    """tests/test_mutation.py's mutated suite before and after compaction,
    with point lookups of upserted, deleted, run and absent keys."""
    sess, feed = mutated_session(pk, mode, base_rows)
    pk.ops.reset_dispatch_counts()
    before = query_suite(pk, sess, base_rows, mutated=True)
    launches = dict(pk.ops.DISPATCH_COUNTS)
    keys = [7, 8, 120, base_rows + 20, base_rows + PUSH_ROWS - 1,
            base_rows + 5, 10**8]
    got = {"before": before, "launches": launches, "counts": counts(sess),
           "tombstones": feed.stats["tombstones"]}
    got["get_before"] = lookups(pk, sess, keys)
    got["persist"] = persisted(pk, sess)
    feed.compact()
    _observe(pk, sess, "compacted")
    got["after"] = query_suite(pk, sess, base_rows, mutated=True)
    got["get_after"] = lookups(pk, sess, keys)
    return got


def newest_wins(pk):
    """tests/test_mutation.py::test_newest_wins_semantics."""
    sess = pk.session("gspmd")
    k = np.arange(10, dtype=np.int32)
    sess.create_dataset("T", pk.Table({"k": k, "v": (k * 10).astype(np.int32)}),
                        dataverse="d", primary="k")
    feed = pk.Feed(sess, "T", "d", flush_rows=10**9, policy=_deferred(pk, 100.0))
    df = pk.AFrame("d", "T", session=sess)
    seen = []
    feed.push({"k": np.array([3, 3], np.int32), "v": np.array([1, 2], np.int32)})
    feed.flush()
    seen.append(len(df[df["k"] == 3]))
    feed.upsert({"k": np.array([3, 3], np.int32),
                 "v": np.array([111, 222], np.int32)})
    feed.flush()
    seen.append(len(df[df["k"] == 3]))
    seen.append(df[df["k"] == 3].collect()["v"].tolist())
    feed.delete(np.array([3], np.int32))
    feed.flush()
    seen.append(len(df[df["k"] == 3]))
    feed.push({"k": np.array([3], np.int32), "v": np.array([9], np.int32)})
    feed.flush()
    seen.append(df[df["k"] == 3].collect()["v"].tolist())
    feed.push({"k": np.array([7], np.int32), "v": np.array([700], np.int32)})
    feed.delete(np.array([7], np.int32))
    feed.push({"k": np.array([7], np.int32), "v": np.array([71], np.int32)})
    feed.flush()
    seen.append(df[df["k"] == 7].collect()["v"].tolist())
    feed.compact()
    seen.append(df[df["k"] == 7].collect()["v"].tolist())
    seen.append(df[df["k"] == 3].collect()["v"].tolist())
    return seen


def leveled_mutations(pk):
    """tests/test_mutation.py::test_leveled_merge_preserves_mutation_results."""
    n = 200
    sess = pk.session("gspmd")
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
        _observe(pk, sess, f"leveled {i}", name="M")
    out = {"len": len(df), "sum": df["v"].sum(),
           "rows": df.sort_values("k").collect(),
           "levels": [r.level for r in sess.catalog.get("d", "M").runs]}
    feed.compact()
    out["len_after"], out["sum_after"] = len(df), df["v"].sum()
    out["stats"] = dict(feed.stats)
    out["expect"] = expect
    return out


def view_retraction(pk):
    """tests/test_mutation.py::test_view_retraction_counts_sums_and_extremes."""
    sess = pk.session("gspmd")
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
    view = sess.create_view("by_g", plan)
    feed = pk.Feed(sess, "V", "d", flush_rows=10**9, policy=_deferred(pk, 100.0))
    feed.delete(np.array([59, 3], np.int32))
    feed.upsert({"k": np.array([56, 8], np.int32),
                 "g": np.array([0, 0], np.int32),
                 "v": np.array([0, 5000], np.int32)})
    feed.flush()
    steps = [(sess.read_view("by_g"), sess.execute(plan), dict(view.stats))]
    feed.compact()
    steps.append((sess.read_view("by_g"), sess.execute(plan), dict(view.stats)))
    feed.delete(np.arange(1, n, 4, dtype=np.int32))  # all of group 1
    feed.flush()
    steps.append((sess.read_view("by_g"), sess.execute(plan), dict(view.stats)))
    feed.push({"k": np.array([n + 1], np.int32), "g": np.array([1], np.int32),
               "v": np.array([-7], np.int32)})
    feed.flush()
    steps.append((sess.read_view("by_g"), sess.execute(plan), dict(view.stats)))
    return steps


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


def interleavings(pk, mode, seed):
    """tests/test_mutation.py::test_mutation_interleavings_match_newest_wins_oracle
    for one seed and one mode: the surviving rows before and after the
    compaction, the aggregates, and the oracle."""
    ops = _random_ops(np.random.default_rng(seed))
    base = [(kk, kk * 3) for kk in range(8)]
    oracle = list(base)
    sess = pk.session(mode)
    sess.create_dataset("H", pk.Table({
        "k": np.array([r[0] for r in base], np.int32),
        "v": np.array([r[1] for r in base], np.int32)}),
        dataverse="d", primary="k")
    feed = pk.Feed(sess, "H", "d", flush_rows=10**9, policy=_deferred(pk, 100.0))
    for kind, payload in ops:
        if kind in ("push", "upsert"):
            getattr(feed, kind)({"k": np.array([r[0] for r in payload], np.int32),
                                 "v": np.array([r[1] for r in payload], np.int32)})
        elif kind == "delete":
            feed.delete(np.array(payload, np.int32))
        else:
            getattr(feed, kind)()
        if kind in ("push", "upsert", "delete"):
            _oracle_apply(oracle, kind, payload)
    feed.flush()
    df = pk.AFrame("d", "H", session=sess)
    got = df.sort_values("k").collect()
    out = {"want": sorted(oracle),
           "rows": sorted(zip(got["k"].tolist(), got["v"].tolist())),
           "count_lo": len(df[df["k"] <= 10]),
           "group": df.groupby("k").agg({"v": "max"}) if oracle else None,
           "sum": df["v"].sum()}
    feed.compact()
    got = df.sort_values("k").collect()
    out["rows_after"] = sorted(zip(got["k"].tolist(), got["v"].tolist()))
    return out


# -- tests/test_concurrency.py -------------------------------------------------------


def _crows(keys):
    keys = np.asarray(keys, dtype=np.int32)
    vals = 1 + (keys.astype(np.int64) * 7 % 100).astype(np.int32)
    return {"k": keys, "v": vals, "g": (keys % 5).astype(np.int32)}


def _csetup(pk, n=48):
    sess = pk.session("gspmd")
    rows = _crows(np.arange(n))
    sess.create_dataset("Live", pk.Table(dict(rows)), dataverse="d", primary="k")
    oracle = {int(k): (int(v), int(g))
              for k, v, g in zip(rows["k"], rows["v"], rows["g"])}
    return sess, oracle


def _expected(oracle):
    gsum = {}
    for v, g in oracle.values():
        gsum[g] = gsum.get(g, 0) + v
    return {"len": len(oracle), "sum": sum(v for v, _ in oracle.values()),
            "g2_count": sum(1 for _, g in oracle.values() if g == 2),
            "gsum": {g: s for g, s in gsum.items() if s != 0}}


def _cobserve(df):
    out = df.groupby("g").agg({"v": "sum"})
    vname = next(c for c in out if c != "g")
    return {"len": len(df), "sum": int(df["v"].sum()),
            "g2_count": len(df[df["g"] == 2]),
            "gsum": {int(g): int(s) for g, s in zip(out["g"].tolist(),
                                                    out[vname].tolist()) if s}}


def bg_folds(pk):
    """tests/test_concurrency.py's
    test_background_compactor_folds_runs_and_preserves_results."""
    sess, oracle = _csetup(pk)
    df = pk.AFrame("d", "Live", session=sess)
    with pk.lsm.BackgroundCompactor(
            sess, policy=pk.lsm.LeveledCompactionPolicy(
                size_ratio=100.0, max_runs=64, level0_runs=2,
                level_ratio=2)) as bc:
        feed = pk.Feed(sess, "Live", "d", flush_rows=8,
                       policy=_deferred(pk, 100.0), compactor=bc)
        for i in range(6):
            rows = _crows(np.arange(48 + 8 * i, 48 + 8 * (i + 1)))
            feed.push(rows)
            for k, v, g in zip(rows["k"], rows["v"], rows["g"]):
                oracle[int(k)] = (int(v), int(g))
        idle = bc.wait_idle(30.0)
        _observe(pk, sess, "bg folded")
        out = {"idle": idle, "level_merges": bc.stats["level_merges"],
               "runs": len(sess.catalog.get("d", "Live").runs)}
    out["got"], out["want"] = _cobserve(df), _expected(oracle)
    return out


def bg_fault(pk):
    """tests/test_concurrency.py's
    test_background_compactor_retries_through_injected_fault."""
    sess, oracle = _csetup(pk)
    sess.fault_plan = pk.FaultPlan.once("mid-merge")
    with pk.lsm.BackgroundCompactor(
            sess, policy=pk.lsm.CompactionPolicy(size_ratio=0.0),
            backoff_s=0.001) as bc:
        feed = pk.Feed(sess, "Live", "d", flush_rows=8,
                       policy=_deferred(pk, 100.0), compactor=bc)
        rows = _crows(np.arange(48, 56))
        feed.push(rows)
        for k, v, g in zip(rows["k"], rows["v"], rows["g"]):
            oracle[int(k)] = (int(v), int(g))
        idle = bc.wait_idle(30.0)
        out = {"idle": idle, "faults": bc.stats["faults"],
               "retries": bc.stats["retries"]}
    out["runs"] = len(sess.catalog.get("d", "Live").runs)
    out["got"], out["want"] = _cobserve(pk.AFrame("d", "Live", session=sess)), \
        _expected(oracle)
    out["fired"] = list(sess.fault_plan.fired)
    return out


# -- tests/test_block_skip.py's sharded section ------------------------------------

N = 20_000
# the reference's boundary grid (tests/test_block_skip.py:558-560), in
# 512-row units
SKIP_GRID = [(0, 0), (0, 6), (4, 1), (7, 3), (15, 4), (16, 0), (16, 6),
             (19, 2), (38, 5), (40, 3), (43, 6)]


def skip_pairs(seed=11, n=8):
    """The grid plus ``n`` (qlo, qw) pairs drawn from a numpy seed, the same
    on every rank."""
    rng = np.random.default_rng(seed)
    return SKIP_GRID + [(int(a), int(b)) for a, b in
                        zip(rng.integers(0, 44, n), rng.integers(0, 7, n))]


def clustered(pk, n=N, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.arange(n, dtype=np.int32)
    return pk.Table({"id": ids, "ts": ids.copy(),
                     "val": rng.integers(0, 100, n).astype(np.int32)})


def mutated(pk, sess):
    sess.create_dataset("Mut", clustered(pk), dataverse="m", primary="id")
    feed = pk.Feed(sess, "Mut", "m", flush_rows=10**9,
                   policy=pk.lsm.CompactionPolicy(size_ratio=100.0, max_runs=64))
    ids = np.arange(20_480, 21_504, dtype=np.int32)
    feed.push({"id": ids, "ts": ids.copy(), "val": np.zeros(len(ids), np.int32)})
    feed.flush()
    feed.delete(np.array([8200, 8300], np.int32))
    feed.upsert({"id": np.array([8400], np.int32),
                 "ts": np.array([8400], np.int32),
                 "val": np.array([7], np.int32)})
    feed.flush()
    _observe(pk, sess, "mutated", "m", "Mut")
    return sess


def rc(df, lo, hi):
    return len(df[(df["ts"] >= lo) & (df["ts"] <= hi)])


def block_skip(pk, mode, tel=None):
    """tests/test_block_skip.py:521 in one mode: the range counts of
    ``skip_pairs`` with block skipping on and off, the prune report of the
    1-block-selective range and (with ``tel``, the package's telemetry)
    the filter_count blocks it skipped."""
    sess = mutated(pk, pk.session(mode, enable_index=False))
    df = pk.AFrame("m", "Mut", session=sess)
    out = {}
    for qlo, qw in skip_pairs():
        lo, hi = qlo * 512, (qlo + qw) * 512
        for skip in (True, False):
            sess.enable_block_skip = skip
            out[(qlo, qw, skip)] = rc(df, lo, hi)
        sess.enable_block_skip = True
    before = None if tel is None else \
        (tel.counter_value("kernel.blocks_skipped_total",
                           kernel="filter_count") or 0)
    out["selective"] = rc(df, 8192, 8700)
    out["report"] = dict(sess.last_prune_report)
    if tel is not None:
        out["fc_skipped"] = (tel.counter_value("kernel.blocks_skipped_total",
                                               kernel="filter_count") or 0) - before
    return out


def routed_lookup(pk):
    """tests/test_block_skip.py:583: ``get`` on the mutated set (gspmd)."""
    sess = mutated(pk, pk.session("gspmd", enable_index=False))
    df = pk.AFrame("m", "Mut", session=sess)
    out = {}
    for key in (123, 8200, 8400, 20_500, 10**8):
        got = df.get(key)
        ph = sess.last_physical
        out[key] = (None if got is None else
                    {c: np.asarray(v) for c, v in got.items()},
                    ph.shards, ph.probed, ph.shard_probes, ph.note,
                    ph.label(), dict(sess.last_prune_report))
    return out


BASE_S, PUSH_S = 20_000, 1_024


def _rows_of(pk, n, seed, lo):
    r = host_rows(pk.wisconsin.generate(n, seed=seed))
    r["unique2"] = np.arange(lo, lo + n, dtype=r["unique2"].dtype)
    return r


def string_build(pk, sess):
    sess.create_dataset("S", pk.wisconsin.generate(BASE_S, seed=5),
                        dataverse="s8", primary="unique2")
    feed = pk.Feed(sess, "S", "s8", flush_rows=10**9,
                   policy=pk.lsm.CompactionPolicy(size_ratio=10.0, max_runs=64))
    feed.push(_rows_of(pk, PUSH_S, 31, BASE_S))
    feed.flush()
    feed.upsert(_rows_of(pk, 200, 77, 500))
    feed.delete(np.arange(0, 128, dtype=np.int64))
    feed.flush()
    _observe(pk, sess, "strings", "s8", "S")
    return sess, feed


def string_probe(pk, sess):
    df = pk.AFrame("s8", "S", session=sess)
    g = df.groupby("string4").agg({"four": "sum"})
    return (len(df[df["string4"] == "OOOOxxxx"]),
            len(df[df["string4"].isin(["AAAAxxxx", "VVVVxxxx", "no"])]),
            tuple(pk.table.decode_strings(np.asarray(g["string4"]))),
            tuple(np.asarray(g["sum_four"]).tolist()),
            str(np.asarray(g["sum_four"]).dtype))


def strings(pk, mode, tel=None):
    """tests/test_block_skip.py:642 in one mode: the string probe with skip
    on and off over the fed, mutated set, the clustered ``CL`` set's
    selective equality, then the probe after the compaction."""
    sess, feed = string_build(pk, pk.session(mode, enable_index=False))
    out = {}
    for skip in (True, False):
        sess.enable_block_skip = skip
        out[skip] = string_probe(pk, sess)
    sess.enable_block_skip = True
    n2 = 32_768  # 8 shards x 4096: one zone block per shard
    tags = ["T%02d" % (i // 4096) for i in range(n2)]
    sess.create_dataset("CL", pk.Table({"k": np.arange(n2, dtype=np.int32),
                                        "tag": pk.table.encode_strings(tags)}),
                        dataverse="s8", primary="k")
    dfc = pk.AFrame("s8", "CL", session=sess)
    before = None if tel is None else \
        (tel.counter_value("kernel.blocks_skipped_total",
                           kernel="filter_count") or 0)
    out["cl"] = len(dfc[dfc["tag"] == "T03"])
    out["cl_report"] = dict(sess.last_prune_report)
    if tel is not None:
        out["fc_skipped"] = (tel.counter_value("kernel.blocks_skipped_total",
                                               kernel="filter_count") or 0) - before
    feed.compact()
    _observe(pk, sess, "strings compacted", "s8", "S")
    out["compacted"] = string_probe(pk, sess)
    return out
