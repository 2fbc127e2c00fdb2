"""tests/test_planner.py replayed on the port (``repro_torch``, every
session on the CPU; shard_map on a one-shard mesh). Cost-based physical
planning: the unified statistics layer, bind-time
zone-map run pruning, and the three-level plan cache keyed by
(logical fingerprint, stats_epoch, prune signature)."""
import numpy as np
import pytest
from repro_torch.launch.mesh import make_local_mesh

from repro_torch.core import physical as PH
from repro_torch.core import plan as P
from repro_torch.core.stats import component_stats, view_stats
from repro_torch.data import wisconsin
from repro_torch.engine import lsm
from repro_torch.engine.ingest import Feed
from repro_torch.engine.session import Session
from repro_torch.engine.table import Table

BASE_ROWS = 3_000
PUSH_ROWS = 600

DEFERRED = lsm.CompactionPolicy(size_ratio=100.0, max_runs=64)  # never auto


def _session(mode, **kw):
    if mode == "shard_map":
        return Session(mesh=make_local_mesh(1, device="cpu"),
                       mode="shard_map", **kw)
    return Session(device="cpu", mode=mode, **kw)


def _fed_session(mode, n_pushes=3, **kw):
    """unique2 keys increase monotonically across pushes, so each run holds a
    disjoint key span — the timestamped-feed pattern zone maps shine on."""
    sess = _session(mode, **kw)
    t = wisconsin.generate(BASE_ROWS, seed=3)
    sess.create_dataset("Live", t, dataverse="d", indexes=["onePercent"],
                        primary="unique2")
    feed = Feed(sess, "Live", "d", flush_rows=PUSH_ROWS, policy=DEFERRED)
    for i in range(n_pushes):
        extra = wisconsin.generate(PUSH_ROWS, seed=20 + i)
        rows = {k: np.asarray(v) for k, v in extra.columns.items()}
        rows["unique2"] = rows["unique2"] + BASE_ROWS + i * PUSH_ROWS
        feed.push(rows)
    return sess, feed


def _run_span(i):
    lo = BASE_ROWS + i * PUSH_ROWS
    return lo, lo + PUSH_ROWS - 1


def _range_count(df, lo, hi):
    return len(df[(df["unique2"] >= lo) & (df["unique2"] <= hi)])


# -- unified statistics layer ------------------------------------------------


def test_stats_harvested_uniformly_from_base_runs_and_views():
    sess, feed = _fed_session("gspmd")
    base = component_stats(sess.catalog, "d", "Live")
    assert base.kind == "dataset" and base.rows == BASE_ROWS
    assert base.span("unique2") == (0, BASE_ROWS - 1)
    assert base.index_on("onePercent") == "secondary"
    assert base.index_on("unique2") == "primary"
    run = component_stats(sess.catalog, "d", "Live@run1")
    assert run.kind == "run" and run.rows == PUSH_ROWS
    assert run.span("unique2") == _run_span(1)  # the run's zone span
    assert run.padded_rows % lsm.RUN_BLOCK == 0
    assert run.index_on("onePercent") == "secondary"  # built at flush time
    # views harvest through the same shape
    plan = P.GroupAgg(P.Scan("Live", "d"), ["ten"],
                      [P.AggSpec("count", "count", None)])
    view = sess.create_view("by_ten", plan)
    vs = view_stats(view)
    assert vs.kind == "view" and vs.rows == 10
    assert vs.span("ten") == (0, 9)


def test_stats_epoch_bumps_on_ddl_flush_and_compaction():
    sess, feed = _fed_session("gspmd", n_pushes=0)
    e0 = sess.catalog.stats_epoch
    extra = wisconsin.generate(PUSH_ROWS, seed=9)
    rows = {k: np.asarray(v) for k, v in extra.columns.items()}
    rows["unique2"] = rows["unique2"] + BASE_ROWS
    feed.push(rows)  # flush
    e1 = sess.catalog.stats_epoch
    assert e1 > e0
    feed.compact()
    e2 = sess.catalog.stats_epoch
    assert e2 > e1
    sess.create_dataset("Other", wisconsin.generate(100, seed=1), dataverse="d")
    assert sess.catalog.stats_epoch > e2


# -- plan-cache invalidation (regression: stale executables on flush/compact) -


def test_flush_rebinds_pruned_plans_and_compaction_drops_stale_runs():
    """A cached executable bakes in the LSM component set; flushing must
    rebind (the new run's rows must be visible) and compaction must never
    let a stale plan read a dropped run."""
    sess, feed = _fed_session("gspmd", n_pushes=1)
    df_lo, df_hi = _run_span(0)
    df = __import__("repro_torch.core.frame", fromlist=["AFrame"]).AFrame(
        "d", "Live", session=sess)
    assert _range_count(df, df_lo, df_hi) == PUSH_ROWS
    assert sess.last_prune_report["pruned"] == 1  # base pruned, run0 probed
    compiles0 = sess.stats["compiles"]

    # flush a second run: epoch bump forces a rebind; the same query now
    # sees three components and still prunes down to run0
    extra = wisconsin.generate(PUSH_ROWS, seed=21)
    rows = {k: np.asarray(v) for k, v in extra.columns.items()}
    rows["unique2"] = rows["unique2"] + BASE_ROWS + PUSH_ROWS
    feed.push(rows)
    assert _range_count(df, df_lo, df_hi) == PUSH_ROWS
    assert sess.stats["compiles"] > compiles0  # stale executable not reused
    assert sess.last_prune_report["pruned"] == 2
    lo1, hi1 = _run_span(1)
    assert _range_count(df, lo1, hi1) == PUSH_ROWS  # new run's rows visible

    # compaction drops every run: a stale cached executable would KeyError
    # on "Live@run0" — the epoch key makes it unreachable instead
    feed.compact()
    assert not sess.catalog.get("d", "Live").runs
    assert _range_count(df, df_lo, df_hi) == PUSH_ROWS
    # no union left: the plan reads the single compacted base, nothing prunes
    assert sess.last_prune_report["components"] == 0
    assert sess.last_prune_report["pruned"] == 0


def test_same_prune_signature_reuses_executable_new_signature_rebinds():
    """Randomized literals that keep the surviving-run set hit the cached
    executable; literals that change which runs the zone maps prune rebuild
    only the physical plan (one compile per signature)."""
    sess, feed = _fed_session("gspmd", n_pushes=2)
    df = __import__("repro_torch.core.frame", fromlist=["AFrame"]).AFrame(
        "d", "Live", session=sess)
    lo0, hi0 = _run_span(0)
    lo1, hi1 = _run_span(1)
    assert _range_count(df, lo0, hi0) == PUSH_ROWS
    compiles0, plans0 = sess.stats["compiles"], sess.stats["plans"]
    # same shape, different literals, SAME surviving set (still only run0)
    assert _range_count(df, lo0 + 5, hi0 - 5) == PUSH_ROWS - 10
    assert sess.stats["compiles"] == compiles0
    assert sess.stats["plans"] == plans0          # planner skipped too
    assert sess.stats["hits"] >= 1
    # different literals, DIFFERENT surviving set (run1): new physical plan
    assert _range_count(df, lo1, hi1) == PUSH_ROWS
    assert sess.stats["plans"] == plans0 + 1
    # ...but the executable is deduplicated by physical fingerprint when the
    # surviving component is the same *shape* (one index probe): it may
    # compile fresh only because the component address differs
    assert sess.last_prune_report["pruned"] == 2


def test_all_components_pruned_keeps_identity_result():
    """A predicate outside every zone span: the planner keeps one component
    so the merged identity (count 0, ±inf extremes) is computed on-device,
    bit-identical to unpruned execution."""
    for prune in (True, False):
        sess, _ = _fed_session("gspmd", n_pushes=2, enable_prune=prune)
        df = __import__("repro_torch.core.frame", fromlist=["AFrame"]).AFrame(
            "d", "Live", session=sess)
        n = _range_count(df, 10_000_000, 10_000_100)
        assert n == 0, prune


# -- pruning equivalence (property): pruned == unpruned in all three modes ---


@pytest.mark.parametrize("mode", ["gspmd", "shard_map", "kernel"])
def test_selective_predicate_prunes_and_matches_unpruned(mode):
    """Acceptance: a selective range predicate over a fed dataset prunes ≥1
    LSM run via zone maps and answers bit-identically to the unpruned
    execution — in every session mode."""
    sess_p, _ = _fed_session(mode, n_pushes=3, enable_prune=True)
    sess_u, _ = _fed_session(mode, n_pushes=3, enable_prune=False)
    from repro_torch.core.frame import AFrame

    dfp = AFrame("d", "Live", session=sess_p)
    dfu = AFrame("d", "Live", session=sess_u)
    lo, hi = _run_span(1)
    got, want = _range_count(dfp, lo, hi), _range_count(dfu, lo, hi)
    assert got == want == PUSH_ROWS
    assert sess_p.last_prune_report["pruned"] >= 1
    assert sess_u.last_prune_report["pruned"] == 0
    # table-producing and grouped families over the same pruned union
    sel_p = dfp[(dfp["unique2"] >= lo) & (dfp["unique2"] <= hi)]
    sel_u = dfu[(dfu["unique2"] >= lo) & (dfu["unique2"] <= hi)]
    for a, b in ((sel_p.sort_values("unique1").head(9),
                  sel_u.sort_values("unique1").head(9)),
                 (sel_p.groupby("ten").agg({"four": "sum"}),
                  sel_u.groupby("ten").agg({"four": "sum"}))):
        assert set(a) == set(b)
        for k in a:
            av, bv = np.asarray(a[k]), np.asarray(b[k])
            assert av.dtype == bv.dtype
            np.testing.assert_array_equal(av, bv, err_msg=f"{mode}:{k}")
    assert sess_p.last_prune_report["pruned"] >= 1  # grouped path pruned too


def test_explain_shows_costed_plan_with_pruned_runs():
    """Acceptance: explain() renders the physical plan with cost estimates
    and the zone-span rationale for every pruned run."""
    sess, _ = _fed_session("gspmd", n_pushes=3)
    from repro_torch.core.frame import AFrame

    df = AFrame("d", "Live", session=sess)
    lo, hi = _run_span(1)
    text = df[(df["unique2"] >= lo) & (df["unique2"] <= hi)].explain()
    assert "PRUNED" in text and "zone span" in text
    assert "cost=" in text and "total estimated cost" in text
    assert text.count("✂") >= 1
    # the scalar count plan shows per-component access paths and the merge
    plan = P.Agg(df[(df["unique2"] >= lo) & (df["unique2"] <= hi)]._plan,
                 [P.AggSpec("count", "count", None)])
    text = sess.explain(plan)
    assert "MergeScalars" in text and "PRUNED" in text


def test_pruning_equivalence_property():
    """Property test over randomized feeds, predicates, and all three modes:
    pruned == unpruned == numpy oracle, whatever the zone spans do."""
    hypothesis = pytest.importorskip("hypothesis")
    from hypothesis import example, given, settings, strategies as st

    modes = ["gspmd", "shard_map", "kernel"]

    batch = st.lists(st.tuples(st.integers(0, 400), st.integers(-50, 50)),
                     min_size=1, max_size=40)

    # ROADMAP C5: the base alone survives the pruning and holds 4 rows,
    # fewer than head(7) asks for; the port returns all of them, sorted
    @example(batches=[[(1, 0)]], a=0, b=0, seed=212, mode="gspmd")
    @example(batches=[[(1, 0)]], a=0, b=0, seed=212, mode="shard_map")
    @example(batches=[[(1, 0)]], a=0, b=0, seed=212, mode="kernel")
    @settings(max_examples=15, deadline=None)
    @given(st.lists(batch, min_size=1, max_size=4),
           st.integers(-20, 450), st.integers(-20, 450),
           st.integers(0, 2**31 - 1), st.sampled_from(modes))
    def run(batches, a, b, seed, mode):
        lo, hi = min(a, b), max(a, b)
        rng = np.random.default_rng(seed)
        n0 = int(rng.integers(4, 60))
        base = {"k": rng.integers(0, 120, n0).astype(np.int32),
                "v": rng.integers(-50, 51, n0).astype(np.int32)}
        sessions = {}
        for prune in (True, False):
            sess = _session(mode, enable_prune=prune)
            sess.create_dataset("H", Table({k: v.copy() for k, v in base.items()}),
                                dataverse="d")
            feed = Feed(sess, "H", "d", flush_rows=1, policy=DEFERRED)
            for bt in batches:
                feed.push({"k": np.array([x[0] for x in bt], np.int32),
                           "v": np.array([x[1] for x in bt], np.int32)})
            sessions[prune] = sess
        all_k = np.concatenate([base["k"]]
                               + [np.array([x[0] for x in bt], np.int32)
                                  for bt in batches])
        all_v = np.concatenate([base["v"]]
                               + [np.array([x[1] for x in bt], np.int32)
                                  for bt in batches])
        oracle_mask = (all_k >= lo) & (all_k <= hi)
        from repro_torch.core.frame import AFrame

        results = {}
        for prune, sess in sessions.items():
            df = AFrame("d", "H", session=sess)
            sel = df[(df["k"] >= lo) & (df["k"] <= hi)]
            results[prune] = {
                "count": len(sel),
                "sum": sel["v"].sum() if oracle_mask.any() else None,
                "rows": sel.sort_values("v").head(7),
            }
        assert results[True]["count"] == results[False]["count"] \
            == int(oracle_mask.sum())
        if oracle_mask.any():
            assert results[True]["sum"] == results[False]["sum"] \
                == int(all_v[oracle_mask].sum())
        for k in results[True]["rows"]:
            np.testing.assert_array_equal(results[True]["rows"][k],
                                          results[False]["rows"][k])

    run()


def test_renamed_column_never_prunes_or_probes_stored_namesake():
    """Regression: a Project rebinding a stored name (df['k'] = df['v']) must
    not let the pruner test the predicate against the STORED k's zone span,
    nor let the count path probe/kernel-read the stored k — both would
    silently return wrong results."""
    from repro_torch.core.expr import Col
    from repro_torch.core.frame import AFrame

    n = 100
    base = {"k": np.arange(n, dtype=np.int32),             # stored k: 0..99
            "v": np.full(n, 500, dtype=np.int32)}          # actual values: 500
    for mode in ("gspmd", "kernel"):
        sess = _session(mode)
        sess.create_dataset("T", Table(dict(base)), dataverse="d",
                            indexes=["k"])
        feed = Feed(sess, "T", "d", flush_rows=50, policy=DEFERRED)
        feed.push({"k": np.arange(1000, 1050, dtype=np.int32),
                   "v": np.full(50, 500, dtype=np.int32)})
        # rename v AS k, then count k >= 400: every row matches (v == 500)
        plan = P.Agg(
            P.Filter(P.Project(P.Scan("T", "d"),
                               [("k", Col("v"))]),
                     Col("k") >= 400),
            [P.AggSpec("count", "count", None)])
        assert sess.execute(plan) == n + 50, mode
        assert sess.last_prune_report["pruned"] == 0, mode
        # no candidate may have read the stored k by the predicate's name
        assert not any(isinstance(p, (PH.IndexOnlyCount, PH.KernelRangeCount))
                       for p in PH.walk(sess.last_physical)), mode


def test_index_probe_survives_column_pruning_project():
    """Regression: the narrow identity Project that column pruning inserts
    must not cost the streaming filter out of its IndexProbe access path."""
    from repro_torch.core.frame import AFrame

    sess = _session("gspmd")
    sess.create_dataset("W", wisconsin.generate(1_000, seed=1), dataverse="d",
                        indexes=["onePercent"])
    df = AFrame("d", "W", session=sess)
    sel = df[(df["onePercent"] >= 10) & (df["onePercent"] <= 20)]
    out = sel["four"].sum()  # Agg prunes columns → Filter(Project(Scan))
    opt = sess.last_optimized
    assert any(isinstance(n, P.Project) for n in P.walk(opt))  # pruned cols
    probes = [n for n in PH.walk(sess.last_physical)
              if isinstance(n, PH.IndexProbe)]
    assert probes and probes[0].index_col == "onePercent"
    t = wisconsin.generate(1_000, seed=1)
    raw = {k: np.asarray(v) for k, v in t.columns.items()}
    m = (raw["onePercent"] >= 10) & (raw["onePercent"] <= 20)
    assert out == int(raw["four"][m].sum())


# -- cost model / executable sharing -----------------------------------------


def test_point_and_range_share_physical_executable_with_pruning():
    """A point == and a >=/<= range on the same indexed column map to the
    same physical shape; with runs in play, executables are shared per
    (physical fingerprint, epoch) across the prune-signature level."""
    sess, _ = _fed_session("gspmd", n_pushes=1)
    from repro_torch.core.frame import AFrame

    df = AFrame("d", "Live", session=sess)
    n1 = len(df[df["onePercent"] == 7])
    compiles = sess.stats["compiles"]
    n2 = len(df[(df["onePercent"] >= 7) & (df["onePercent"] <= 7)])
    assert n1 == n2
    assert sess.stats["compiles"] == compiles  # physical-fingerprint dedup
    assert sess.stats["hits"] >= 1


def test_compiler_has_no_mode_branches_in_lowerings():
    """Acceptance: mode selection lives in the planner / lowering-strategy
    layer; operator lowerings never branch on the execution mode."""
    import inspect

    from repro_torch.core import compiler

    for fn in (compiler._lower_stream, compiler._lower_groupagg,
               compiler._lower_kernel_segment_agg, compiler._lower_terminal,
               compiler._lower_kernel_range_count,
               compiler._lower_index_only_count, compiler._lower_join_count):
        src = inspect.getsource(fn)
        assert "ctx.mode" not in src and "use_kernels" not in src \
            and "distributed" not in src, fn.__name__


@pytest.mark.parametrize("mode", ["gspmd", "kernel", "shard_map"])
def test_head_past_the_row_count_returns_every_row_sorted(mode):
    """ROADMAP C5: ``sort_values("v").head(7)`` over 4 rows is the 4 rows,
    sorted (pandas' head), in every mode; the reference raises at
    ``jax.lax.top_k`` instead — a deliberate difference."""
    from repro_torch.core.frame import AFrame

    v = np.array([5, -3, 9, 0], np.int32)
    sess = _session(mode)
    sess.create_dataset("F", Table({"k": np.arange(4, dtype=np.int32),
                                    "v": v}), dataverse="d")
    df = AFrame("d", "F", session=sess)
    got = df.sort_values("v").head(7)
    order = np.argsort(v, kind="stable")
    assert set(got) == {"k", "v"}
    for col, want in (("k", order.astype(np.int32)), ("v", v[order])):
        a = np.asarray(got[col])
        assert a.dtype == want.dtype, col
        np.testing.assert_array_equal(a, want, err_msg=f"{mode}:{col}")
