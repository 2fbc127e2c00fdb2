"""tests/test_telemetry.py replayed on the port (``repro_torch``, every
session on the CPU). Telemetry layer tests: registry semantics (labels, snapshots,
normalization, disabled-mode no-ops), the Session.stats/timings back-compat
views, thread-safety of the counter mirror under the BackgroundCompactor,
the retired-manifest GC-visibility gauges, and the planner's stall-imminent
signal."""
import gc
import re
import threading

import numpy as np
import torch

from repro_torch.core import plan as P
from repro_torch.core.frame import AFrame
from repro_torch.engine import lsm
from repro_torch.engine.ingest import Feed
from repro_torch.engine.session import Session
from repro_torch.engine.table import Table
from repro_torch.runtime import telemetry as tel

NO_COMPACT = lsm.CompactionPolicy(size_ratio=100.0, max_runs=64)


def _table(n=512):
    k = np.arange(n, dtype=np.int32)
    return Table({"k": k, "v": (k * 3).astype(np.int32)})


def _fed(sess, name="T", dv="t", n=512, runs=0, run_rows=64):
    sess.create_dataset(name, _table(n), dataverse=dv, primary="k")
    feed = Feed(sess, name, dv, flush_rows=10**9, policy=NO_COMPACT)
    for i in range(runs):
        lo = 10_000 + i * run_rows
        ks = np.arange(lo, lo + run_rows, dtype=np.int32)
        feed.push({"k": ks, "v": np.zeros(run_rows, np.int32)})
        feed.flush()
    return feed


# -- registry unit tests ------------------------------------------------------


def test_series_key_sorts_labels():
    assert tel.series_key("m", {}) == "m"
    assert tel.series_key("m", {"b": 2, "a": 1}) == "m{a=1,b=2}"


def test_counters_gauges_histograms_roundtrip():
    r = tel.MetricsRegistry()
    r.inc("c", kind="x")
    r.inc("c", 2, kind="x")
    r.set_gauge("g", 7.5)
    r.observe("h", 0.003)
    r.observe("h", 4.0)
    assert r.counter_value("c", kind="x") == 3
    assert r.counter_value("c", kind="missing") == 0
    assert r.gauge_value("g") == 7.5
    snap = r.snapshot()
    assert snap["counters"]["c{kind=x}"] == 3
    h = snap["histograms"]["h"]
    assert h["count"] == 2 and abs(h["sum"] - 4.003) < 1e-9
    assert h["min"] == 0.003 and h["max"] == 4.0
    assert sum(h["buckets"].values()) == 2
    # normalized form keeps the event count, zeroes every timing field
    hn = r.snapshot(normalize=True)["histograms"]["h"]
    assert hn == {"count": 2, "sum": 0.0, "min": 0.0, "max": 0.0}
    # snapshots are JSON-serializable as-is
    r.to_json()


def test_spans_nest_and_feed_histograms():
    r = tel.MetricsRegistry()
    with r.span("outer", q="1"):
        with r.span("inner"):
            pass
    spans = r.spans()
    assert [s["name"] for s in spans] == ["inner", "outer"]
    assert spans[0]["parent"] == "outer"
    assert spans[1]["parent"] is None
    assert spans[1]["labels"] == {"q": "1"}
    assert all(s["duration"] >= 0.0 for s in spans)
    assert r.snapshot()["histograms"]["outer_seconds{q=1}"]["count"] == 1
    # normalize zeroes span timings
    ns = r.snapshot(normalize=True)["spans"]
    assert all(s["start"] == 0.0 and s["duration"] == 0.0 for s in ns)


def test_disabled_mode_is_noop_for_spans_and_histograms():
    r = tel.MetricsRegistry(enabled=False)
    s = r.span("phase")
    assert s is tel.NOOP_SPAN  # shared singleton: no allocation per span
    with s:
        pass
    r.observe("h", 1.0)
    snap = r.snapshot()
    assert snap["histograms"] == {} and snap["spans"] == []
    # counters/gauges still record: they back the engine's stats surfaces
    r.inc("c")
    r.set_gauge("g", 1)
    assert r.counter_value("c") == 1 and r.gauge_value("g") == 1


def test_global_disable_keeps_session_stats_working():
    tel.set_enabled(False)
    try:
        sess = Session(device="cpu")
        sess.create_dataset("D", _table(), dataverse="off", primary="k")
        df = AFrame("off", "D", session=sess)
        assert len(df[(df["k"] >= 0) & (df["k"] <= 9)]) == 10
        assert sess.stats["compiles"] == 1 and sess.stats["optimizes"] == 1
        assert sess.point_lookup("off", "D", 5)["v"][0] == 15
        assert sess.stats["point_lookups"] == 1
        # no span landed while disabled
        assert not [s for s in tel.registry().spans("session.execute")
                    if s["labels"].get("sid") == sess.sid]
    finally:
        tel.set_enabled(True)


def test_registry_thread_safety():
    r = tel.MetricsRegistry()

    def work():
        for _ in range(2000):
            r.inc("t", worker="w")
            with r.span("s"):
                pass

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert r.counter_value("t", worker="w") == 16_000
    assert r.snapshot()["histograms"]["s_seconds"]["count"] == 16_000


# -- Session.stats / Session.timings as registry views ------------------------


def test_stats_view_seeded_and_counts_like_the_old_dict():
    sess = Session(device="cpu")
    # every key present and zero up front — including point_lookups, which
    # the old dict left unseeded (the .get() inconsistency)
    assert dict(sess.stats) == {"compiles": 0, "hits": 0, "optimizes": 0,
                                "plans": 0, "pruned_components": 0,
                                "point_lookups": 0}
    sess.create_dataset("S", _table(), dataverse="sv", primary="k")
    df = AFrame("sv", "S", session=sess)
    assert len(df[(df["k"] >= 3) & (df["k"] <= 30)]) == 28
    assert sess.stats["compiles"] == 1 and sess.stats["hits"] == 0
    assert len(df[(df["k"] >= 5) & (df["k"] <= 40)]) == 36
    assert sess.stats["hits"] == 1  # variant-level rebind
    assert sess.stats["compiles"] == 1
    # two sessions do not bleed into each other (the sid label)
    other = Session(device="cpu")
    assert other.stats["compiles"] == 0


def test_timings_view_tracks_last_timers():
    sess = Session(device="cpu")
    assert "last_execute" not in sess.timings
    sess.create_dataset("S", _table(), dataverse="tv", primary="k")
    assert sess.timings["last_create"] >= 0.0
    df = AFrame("tv", "S", session=sess)
    len(df[df["k"] >= 0])
    assert sess.timings["last_execute"] >= 0.0
    sess.point_lookup("tv", "S", 7)
    assert sess.timings["last_point_lookup"] >= 0.0
    assert set(sess.timings) == {"last_execute", "last_point_lookup",
                                 "last_create"}


def test_query_phase_spans_recorded():
    sess = Session(device="cpu")
    sess.create_dataset("S", _table(), dataverse="sp", primary="k")
    df = AFrame("sp", "S", session=sess)
    len(df[(df["k"] >= 0) & (df["k"] <= 9)])
    mine = [s for s in tel.registry().spans()
            if s["labels"].get("sid") == sess.sid]
    names = {s["name"] for s in mine}
    assert {"session.execute", "session.execute.run", "session.optimize",
            "session.plan", "session.prune", "session.compile"} <= names
    run = next(s for s in mine if s["name"] == "session.execute.run")
    assert run["parent"] == "session.execute"


def test_snapshot_determinism_across_sessions_normalized():
    """The same deterministic workload in two sessions yields identical
    normalized snapshots once the per-session sid label is masked."""

    def workload():
        sess = Session(device="cpu")
        sess.create_dataset("D", _table(), dataverse="det", primary="k")
        df = AFrame("det", "D", session=sess)
        len(df[(df["k"] >= 0) & (df["k"] <= 50)])
        len(df[(df["k"] >= 1) & (df["k"] <= 60)])
        sess.point_lookup("det", "D", 3)
        return sess.sid

    def capture(sid):
        tag = re.compile(r"(?<=[{,])sid=%s(?=[,}])" % re.escape(sid))
        snap = tel.snapshot(normalize=True, include_spans=False)
        out = {}
        for section in ("counters", "gauges", "histograms"):
            for k, v in snap[section].items():
                if tag.search(k):
                    out[tag.sub("sid=#", k)] = v
        return out

    a = capture(workload())
    b = capture(workload())
    assert a and a == b


# -- LSM / compactor mirrors --------------------------------------------------


def test_compactor_counters_mirror_stats_through_injected_fault():
    from repro_torch.runtime.fault import FaultPlan

    before = {k: tel.counter_value(f"lsm.compactor.{k}_total")
              for k in ("faults", "retries", "compactions", "level_merges",
                        "conflicts", "giveups", "errors")}
    sess = Session(device="cpu")
    sess.create_dataset("F", _table(256), dataverse="bc", primary="k")
    sess.fault_plan = FaultPlan.once("mid-merge")
    with lsm.BackgroundCompactor(
            sess, policy=lsm.CompactionPolicy(size_ratio=0.0),
            backoff_s=0.001) as bc:
        feed = Feed(sess, "F", "bc", flush_rows=8,
                    policy=NO_COMPACT, compactor=bc)
        ks = np.arange(1000, 1008, dtype=np.int32)
        feed.push({"k": ks, "v": np.zeros(8, np.int32)})
        assert bc.wait_idle(30.0)
        assert bc.stats["faults"] >= 1 and bc.stats["retries"] >= 1
        # the registry mirror moved in lockstep with the stats dict
        for key, n0 in before.items():
            assert tel.counter_value(f"lsm.compactor.{key}_total") - n0 \
                == bc.stats[key], key


def test_flush_and_compaction_series():
    n0 = tel.counter_value("lsm.compaction.attempts_total", kind="full")
    sess = Session(device="cpu")
    feed = _fed(sess, name="L", dv="ls", runs=2)
    ds_label = "ls.L"
    assert tel.counter_value("ingest.flushes_total", dataset=ds_label) \
        == feed.stats["flushes"] == 2
    assert tel.counter_value("lsm.runs_built_total", dataset=ds_label) == 2
    assert tel.gauge_value("ingest.resident_runs", dataset=ds_label) == 2
    # the write-stall series exists (and is zero) without any stall
    assert tel.gauge_value("ingest.stall_seconds_total",
                           dataset=ds_label) == 0.0
    feed.compact()
    assert tel.counter_value("lsm.compaction.attempts_total",
                             kind="full") == n0 + 1
    assert tel.counter_value("lsm.compactions_total", kind="full") >= 1


def test_retired_manifest_gauges_lifecycle():
    """GC visibility: device bytes reachable only through
    retired manifests are measured while a snapshot pins them, and drop to
    zero once the pin is released and the manifests are collected."""
    sess = Session(device="cpu")
    feed = _fed(sess, name="G", dv="gc", runs=2)
    snap = sess.catalog.snapshot()  # pins the pre-compaction manifest
    feed.compact()                  # retires it
    gs = sess.catalog.gc_stats()
    assert gs["manifests_retired"] >= 1
    assert gs["manifests_retired_pinned"] >= 1
    assert gs["retired_components"] >= 1
    assert gs["retired_component_bytes"] > 0
    assert tel.gauge_value("catalog.retired_component_bytes") \
        == gs["retired_component_bytes"]
    snap.release()
    del snap
    gc.collect()  # weak tracking: nothing retains the retired manifest now
    gs2 = sess.catalog.gc_stats()
    assert gs2["manifests_retired"] == 0
    assert gs2["retired_component_bytes"] == 0
    assert tel.gauge_value("catalog.retired_component_bytes") == 0


def test_retired_component_reclamation_lifecycle():
    """Active reclamation: a pinned snapshot holds the
    retired components' device buffers alive; the moment the last pin is
    released the catalog itself deletes them — no reliance on the Python GC
    — the retired-bytes gauge falls back to zero, the reclaimed counters
    advance, and the buffers really are released (the port drops the
    catalog's references to the tensors, where the reference deletes its
    jax arrays)."""
    
    c0 = tel.counter_value("catalog.reclaimed_components_total")
    b0 = tel.counter_value("catalog.reclaimed_bytes_total")
    sess = Session(device="cpu")
    feed = _fed(sess, name="R", dv="rc", runs=2)
    snap = sess.catalog.snapshot()  # pins the pre-compaction manifest
    pinned = list(snap.components("rc", "R"))
    feed.compact()  # retires the pinned manifest; its runs become garbage
    gs = sess.catalog.gc_stats()
    assert gs["retired_component_bytes"] > 0  # held ONLY by the pin
    # the pinned reader still sees live buffers
    for ds in pinned:
        assert ds.table.columns
        for a in ds.table.columns.values():
            assert isinstance(a, torch.Tensor) and a.numel() >= 0
    retired_runs = [ds for ds in pinned if "@run" in ds.name]
    assert retired_runs
    snap.release()  # last pin gone -> catalog reclaims eagerly, no gc.collect
    gs2 = sess.catalog.gc_stats()
    assert gs2["manifests_retired"] == 0
    assert gs2["retired_component_bytes"] == 0
    assert tel.gauge_value("catalog.retired_component_bytes") == 0
    assert tel.counter_value("catalog.reclaimed_components_total") > c0
    assert tel.counter_value("catalog.reclaimed_bytes_total") > b0
    for ds in retired_runs:  # buffers of compacted-away runs: released
        assert not ds.table.columns and ds.anti_keys_arr is None
    # the post-compaction base is untouched and queries still work
    df = AFrame("rc", "R", session=sess)
    assert len(df[df["v"] >= 0]) == 512 + 2 * 64


# -- planner stall-imminent signal -------------------------------------------


def test_stall_imminent_note_and_prune_report_gauge():
    from repro_torch.core.physical_planner import (STALL_COMPONENT_CAP,
                                             STALL_WARN_FRAC)

    sess = Session(device="cpu", enable_index=False)
    _fed(sess, name="W", dv="st", runs=8)  # 9 components: pressure 0.75
    df = AFrame("st", "W", session=sess)
    plan = P.Agg(df[(df["v"] >= 0) & (df["v"] <= 10)]._plan,
                 [P.AggSpec("count", "count", None)])
    text = sess.explain(plan)
    assert "stall imminent" in text
    sess.execute(plan)
    rep = sess.last_prune_report
    assert rep["stall_imminent"]
    assert abs(rep["stall_pressure"] - 9 / STALL_COMPONENT_CAP) < 1e-9
    assert rep["stall_pressure"] >= STALL_WARN_FRAC
    assert tel.gauge_value("planner.stall_pressure") >= STALL_WARN_FRAC


def test_no_stall_note_below_warn_fraction():
    sess = Session(device="cpu")
    _fed(sess, name="C", dv="st2", runs=2)  # 3 components: pressure 0.25
    df = AFrame("st2", "C", session=sess)
    plan = P.Agg(df[(df["v"] >= 0) & (df["v"] <= 10)]._plan,
                 [P.AggSpec("count", "count", None)])
    text = sess.explain(plan)
    assert "stall imminent" not in text
    sess.execute(plan)
    assert not sess.last_prune_report["stall_imminent"]
    assert sess.last_prune_report["stall_pressure"] <= 0.5


# -- kernel launch counters ---------------------------------------------------


def test_kernel_launch_counters():
    sess = Session(device="cpu", mode="kernel", enable_index=False)
    sess.create_dataset("K", _table(8192), dataverse="kn", primary="k")
    df = AFrame("kn", "K", session=sess)
    before = sum(tel.registry().counters("kernel.launches_total").values())
    assert len(df[(df["k"] >= 0) & (df["k"] <= 100)]) == 101
    after = sum(tel.registry().counters("kernel.launches_total").values())
    assert after > before
    launches = tel.registry().counters("kernel.launches_total{")
    assert any("kernel=filter_count" in k for k in launches)
    grid = tel.registry().counters("kernel.grid_blocks_total")
    assert any("kernel=filter_count" in k for k in grid)
