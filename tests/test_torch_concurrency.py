"""Concurrent serving on the port: background compaction off the ingest
path, readers that never block on a running merge, write-stall
backpressure and per-dataverse compactor isolation — the scenarios of
tests/test_concurrency.py that inject no fault, on ``device="cpu"``. Every
reader observation equals a plain-dict oracle, as in the reference, and a
seeded stress run races a real compactor in gspmd and kernel mode. The
fault-injected scenarios (``FaultPlan``, ``recover``) wait for the
durability slice (ROADMAP A8); ``shard_map`` for A9."""
import threading
import time

import numpy as np
import pytest

from torch_replay import PORT

from repro_torch.core.physical_planner import STALL_WARN_FRAC
from repro_torch.engine import lsm
from repro_torch.engine.ingest import Feed, stall_delay
from repro_torch.runtime import telemetry as tel

DEFERRED = lsm.CompactionPolicy(size_ratio=100.0, max_runs=64)


def _rows(keys, rng=None):
    keys = np.asarray(keys, dtype=np.int32)
    if rng is None:
        vals = 1 + (keys.astype(np.int64) * 7 % 100).astype(np.int32)
    else:
        vals = rng.integers(1, 101, size=len(keys), dtype=np.int32)
    return {"k": keys, "v": vals, "g": (keys % 5).astype(np.int32)}


def _setup(mode="gspmd", n=48, catalog=None):
    sess = PORT.session(mode, **({"catalog": catalog} if catalog else {}))
    rows = _rows(np.arange(n))
    sess.create_dataset("Live", PORT.Table(dict(rows)), dataverse="d",
                        primary="k")
    oracle = {int(k): (int(v), int(g))
              for k, v, g in zip(rows["k"], rows["v"], rows["g"])}
    return sess, oracle


def _apply(oracle, rows=None, deletes=()):
    if rows is not None:
        for k, v, g in zip(rows["k"], rows["v"], rows["g"]):
            oracle[int(k)] = (int(v), int(g))
    for k in deletes:
        oracle.pop(int(k), None)


def _expected(oracle):
    gsum = {}
    for v, g in oracle.values():
        gsum[g] = gsum.get(g, 0) + v
    return {"len": len(oracle), "sum": sum(v for v, _ in oracle.values()),
            "g2_count": sum(1 for _, g in oracle.values() if g == 2),
            "gsum": {g: s for g, s in gsum.items() if s != 0}}


def _observe(df):
    out = df.groupby("g").agg({"v": "sum"})
    vname = next(c for c in out if c != "g")
    return {"len": len(df), "sum": int(df["v"].sum()),
            "g2_count": len(df[df["g"] == 2]),
            "gsum": {int(g): int(s) for g, s in zip(out["g"].tolist(),
                                                    out[vname].tolist()) if s}}


def test_background_compactor_folds_runs_and_preserves_results():
    sess, oracle = _setup()
    df = PORT.AFrame("d", "Live", session=sess)
    with lsm.BackgroundCompactor(sess, policy=lsm.LeveledCompactionPolicy(
            size_ratio=100.0, max_runs=64, level0_runs=2, level_ratio=2)) as bc:
        feed = Feed(sess, "Live", "d", flush_rows=8, policy=DEFERRED, compactor=bc)
        for i in range(6):
            rows = _rows(np.arange(48 + 8 * i, 48 + 8 * (i + 1)))
            feed.push(rows)
            _apply(oracle, rows)
        assert bc.wait_idle(30.0)
        assert bc.stats["level_merges"] >= 1
        assert len(sess.catalog.get("d", "Live").runs) < 6
    assert _observe(df) == _expected(oracle)


def test_no_reader_blocks_on_running_compaction(monkeypatch):
    """A reader landing mid-merge answers from its pinned snapshot at once
    while the worker spends over a second building the new base."""
    sess, oracle = _setup(n=200)
    feed = Feed(sess, "Live", "d", flush_rows=20, policy=DEFERRED)
    for i in range(3):
        rows = _rows(np.arange(200 + 20 * i, 220 + 20 * i))
        feed.push(rows)
        _apply(oracle, rows)
    reader = PORT.session(catalog=sess.catalog)
    df = PORT.AFrame("d", "Live", session=reader)
    assert _observe(df) == _expected(oracle)  # warm the reader's caches
    started = threading.Event()
    real = lsm._visible_columns

    def slow_visible(*a, **kw):
        started.set()
        time.sleep(0.35)
        return real(*a, **kw)

    monkeypatch.setattr(lsm, "_visible_columns", slow_visible)
    with lsm.BackgroundCompactor(
            sess, policy=lsm.CompactionPolicy(size_ratio=0.0)) as bc:
        bc.notify("d", "Live")
        assert started.wait(10.0)
        t0 = time.perf_counter()
        assert _observe(df) == _expected(oracle)
        dt = time.perf_counter() - t0
        assert dt < 0.3, f"reader blocked {dt:.2f}s on a running compaction"
        assert bc.wait_idle(30.0)
        assert bc.stats["compactions"] >= 1
    monkeypatch.setattr(lsm, "_visible_columns", real)
    assert len(sess.catalog.get("d", "Live").runs) == 0
    assert _observe(df) == _expected(oracle)


def test_write_stall_backpressures_writer_not_readers():
    sess, oracle = _setup()
    with lsm.BackgroundCompactor(sess, policy=DEFERRED) as bc:
        feed = Feed(sess, "Live", "d", flush_rows=8, policy=DEFERRED,
                    compactor=bc, stall_runs=2, stall_timeout_s=0.15)
        for i in range(3):
            rows = _rows(np.arange(48 + 8 * i, 56 + 8 * i))
            feed.push(rows)
            _apply(oracle, rows)
        assert feed.stats["stalls"] >= 1 and feed.stats["stall_s"] > 0.0
        reader = PORT.session(catalog=sess.catalog)
        assert _observe(PORT.AFrame("d", "Live", session=reader)) == \
            _expected(oracle)


def test_proportional_stall_delay_curve():
    assert stall_delay(0.0, 0.1) == 0.0
    assert stall_delay(STALL_WARN_FRAC - 0.01, 0.1) == 0.0
    assert stall_delay(STALL_WARN_FRAC, 0.1) == 0.0
    assert 0.0 < stall_delay((STALL_WARN_FRAC + 1.0) / 2, 0.1) < 0.1
    assert stall_delay(1.0, 0.1) == pytest.approx(0.1)
    assert stall_delay(5.0, 0.1) == pytest.approx(0.1)
    assert stall_delay(1.0, 0.0) == 0.0
    samples = [stall_delay(p, 0.1) for p in np.linspace(0, 2, 41)]
    assert all(b >= a for a, b in zip(samples, samples[1:]))


def test_proportional_stall_slows_writer_before_hard_cap():
    sess, oracle = _setup()
    with lsm.BackgroundCompactor(sess, policy=DEFERRED) as bc:
        feed = Feed(sess, "Live", "d", flush_rows=8, policy=DEFERRED,
                    compactor=bc, stall_runs=8, stall_timeout_s=0.15,
                    stall_delay_s=0.02)
        for i in range(7):
            rows = _rows(np.arange(48 + 8 * i, 56 + 8 * i))
            feed.push(rows)
            _apply(oracle, rows)
        assert feed.stats["stalls"] == 0 and feed.stats["soft_stalls"] >= 1
        assert feed.stats["stall_s"] > 0.0
        reader = PORT.session(catalog=sess.catalog)
        assert _observe(PORT.AFrame("d", "Live", session=reader)) == \
            _expected(oracle)


def test_per_dataverse_compactor_isolation(monkeypatch):
    """A stalled merge in one dataverse never delays another's: one worker
    thread per dataverse, created at first notify."""
    sess, _ = _setup()
    sess.create_dataset("Other", PORT.Table(dict(_rows(np.arange(48)))),
                        dataverse="d2", primary="k")
    release, entered = threading.Event(), threading.Event()
    real = lsm._visible_columns

    def gated_visible(comp, *a, **kw):
        if comp.dataverse == "d":
            entered.set()
            assert release.wait(30.0)
        return real(comp, *a, **kw)

    monkeypatch.setattr(lsm, "_visible_columns", gated_visible)
    with lsm.BackgroundCompactor(
            sess, policy=lsm.CompactionPolicy(size_ratio=0.0)) as bc:
        Feed(sess, "Live", "d", flush_rows=8, policy=DEFERRED,
             compactor=bc).push(_rows(np.arange(48, 56)))
        assert entered.wait(10.0)
        assert tel.gauge_value("lsm.compactor.workers") == 1
        Feed(sess, "Other", "d2", flush_rows=8, policy=DEFERRED,
             compactor=bc).push(_rows(np.arange(48, 56)))
        deadline = time.time() + 15.0
        while time.time() < deadline and sess.catalog.get("d2", "Other").runs:
            time.sleep(0.02)
        assert not sess.catalog.get("d2", "Other").runs
        assert tel.gauge_value("lsm.compactor.workers") == 2
        assert len(sess.catalog.get("d", "Live").runs) == 1
        release.set()
        assert bc.wait_idle(30.0)
    assert not sess.catalog.get("d", "Live").runs


@pytest.mark.parametrize("mode", ["gspmd", "kernel"])
def test_stress_concurrent_ops_match_oracle(mode):
    """The reference's oracle-replay stress without faults: a random op
    sequence against a writer with a leveled compactor racing, a reader
    session observing after every flush."""
    rng = np.random.default_rng(0)
    sess, oracle = _setup(mode)
    shadow = dict(oracle)
    df = PORT.AFrame("d", "Live", session=PORT.session(mode, catalog=sess.catalog))
    next_k = 48
    with lsm.BackgroundCompactor(sess, policy=lsm.LeveledCompactionPolicy(
            size_ratio=6.0, max_runs=64, level0_runs=2, level_ratio=2),
            backoff_s=0.001) as bc:
        feed = Feed(sess, "Live", "d", flush_rows=10**9, policy=DEFERRED,
                    compactor=bc)
        ops = rng.choice(["push", "upsert", "delete", "flush"], size=9,
                         p=[0.35, 0.2, 0.15, 0.3])
        for op in list(ops) + ["flush"]:
            if op == "push":
                n = int(rng.integers(1, 10))
                rows = _rows(np.arange(next_k, next_k + n), rng)
                next_k += n
                feed.push(rows)
                _apply(shadow, rows)
            elif op == "upsert":
                pick = rng.choice(sorted(shadow), size=6, replace=False)
                ups = _rows(np.sort(pick), rng)
                feed.upsert(ups)
                _apply(shadow, ups)
            elif op == "delete":
                pick = np.sort(rng.choice(sorted(shadow), size=4,
                                          replace=False)).astype(np.int32)
                feed.delete(pick)
                _apply(shadow, deletes=pick)
            else:
                feed.flush()
                assert _observe(df) == _expected(shadow)
        assert bc.wait_idle(30.0)
        assert _observe(df) == _expected(shadow)
