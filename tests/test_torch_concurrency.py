"""Concurrent serving on the port: background compaction off the ingest
path, readers that never block on a running merge, write-stall
backpressure, per-dataverse compactor isolation, storage fault injection
at every named crash point and hard/soft state recovery — the scenarios of
tests/test_concurrency.py, on ``device="cpu"``. Every reader observation
equals a plain-dict oracle, as in the reference; the crash-point and
soft-state recovery scenarios also run through the reference on the same
schedule, and each reader observation and fired fault equals the
reference's (in gspmd and in shard_map: the reference's one-device mesh,
the port's one-shard mesh). Seeded stress runs (a copy of the reference's
driver, on the port's sessions) race a real compactor in gspmd, shard_map
and kernel mode and on an 8-shard mesh, with and without an injected
crash."""
import threading
import time

import numpy as np
import pytest

from torch_replay import PORT, REF

from repro.runtime import fault as ref_fault
from repro_torch.core.physical_planner import STALL_WARN_FRAC
from repro_torch.engine import lsm
from repro_torch.engine.ingest import Feed, stall_delay
from repro_torch.runtime import telemetry as tel
from repro_torch.runtime import fault
from repro_torch.runtime.fault import STORAGE_FAULT_POINTS, FaultPlan, StorageFault

DEFERRED = lsm.CompactionPolicy(size_ratio=100.0, max_runs=64)
PKGS = ((REF, ref_fault), (PORT, fault))


def _rows(keys, rng=None):
    keys = np.asarray(keys, dtype=np.int32)
    if rng is None:
        vals = 1 + (keys.astype(np.int64) * 7 % 100).astype(np.int32)
    else:
        vals = rng.integers(1, 101, size=len(keys), dtype=np.int32)
    return {"k": keys, "v": vals, "g": (keys % 5).astype(np.int32)}


def _setup(mode="gspmd", n=48, catalog=None, indexes=(), pk=PORT,
           shards=None):
    sess = pk.session(mode, shards=shards,
                      **({"catalog": catalog} if catalog else {}))
    rows = _rows(np.arange(n))
    sess.create_dataset("Live", pk.Table(dict(rows)), dataverse="d",
                        primary="k", indexes=list(indexes))
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


def test_background_compactor_retries_through_injected_fault():
    """A mid-merge crash on the worker thread is absorbed by its bounded
    retry loop: the writer never sees it, and the fold still lands."""
    sess, oracle = _setup()
    sess.fault_plan = FaultPlan.once("mid-merge")
    with lsm.BackgroundCompactor(
            sess, policy=lsm.CompactionPolicy(size_ratio=0.0),
            backoff_s=0.001) as bc:
        feed = Feed(sess, "Live", "d", flush_rows=8, policy=DEFERRED,
                    compactor=bc)
        rows = _rows(np.arange(48, 56))
        feed.push(rows)  # no StorageFault reaches the writer
        _apply(oracle, rows)
        assert bc.wait_idle(30.0)
        assert bc.stats["faults"] >= 1 and bc.stats["retries"] >= 1
    assert not sess.catalog.get("d", "Live").runs  # the fold landed
    assert _observe(PORT.AFrame("d", "Live", session=sess)) == _expected(oracle)
    assert sess.fault_plan.fired == [("mid-merge", 0)]


def _crash_at(pk, flt, point, mode="gspmd"):
    """One package's run of the crash scenario: every reader observation,
    each held to the oracle, and the faults that fired."""
    sess, oracle = _setup(mode, pk=pk)
    feed = pk.Feed(sess, "Live", "d", flush_rows=10**9,
                   policy=pk.lsm.CompactionPolicy(size_ratio=0.0))
    df = pk.AFrame("d", "Live", session=sess)
    seen = []

    def check():
        seen.append(_observe(df))
        assert seen[-1] == _expected(oracle)

    feed.push(_rows(np.arange(48, 56)))
    feed.flush()
    _apply(oracle, _rows(np.arange(48, 56)))
    check()

    fresh = _rows(np.arange(56, 61))
    ups = {"k": np.arange(10, 16, dtype=np.int32),
           "v": np.full(6, 77, dtype=np.int32),
           "g": (np.arange(10, 16) % 5).astype(np.int32)}
    dels = np.array([3, 4, 50], dtype=np.int32)
    feed.push(fresh)
    feed.upsert(ups)
    feed.delete(dels)

    sess.fault_plan = flt.FaultPlan.once(point)
    with pytest.raises(flt.StorageFault):
        feed.flush()
    fired = list(sess.fault_plan.fired)
    sess.fault_plan = None

    def land():
        _apply(oracle, fresh)
        _apply(oracle, ups, deletes=dels)

    if point in ("flush", "pre-swap"):
        check()  # nothing published
        feed.flush()  # the buffer is the WAL: the replay applies once
        land()
        check()
    else:
        land()  # the swap committed before the crash
        check()
        pk.lsm.recover(sess, "d", "Live")
        check()
        if point == "post-swap":
            feed.drop_buffer()  # committed: replaying would double-apply

    feed.push(_rows(np.arange(61, 66)))
    feed.delete(np.array([56], dtype=np.int32))
    feed.flush()
    _apply(oracle, _rows(np.arange(61, 66)), deletes=[56])
    check()
    seen.append((len(df[df["k"] == 3]), len(df[df["k"] == 10])))
    assert seen[-1] == (0, 1)
    return seen, fired


@pytest.mark.parametrize("mode", ["gspmd", "shard_map"])
@pytest.mark.parametrize("point", STORAGE_FAULT_POINTS)
def test_crash_at_every_point_keeps_readers_bit_identical(point, mode):
    """A crash at ANY fault point leaves the manifest fully old or fully
    new, readers equal to the matching oracle state throughout, and
    recover() plus the buffer-as-WAL discipline resume ingestion exactly
    once — with the same observations and fired fault as the reference
    on the same schedule."""
    (want, want_fired), (got, got_fired) = (_crash_at(pk, flt, point, mode)
                                            for pk, flt in PKGS)
    assert got_fired == want_fired == [(point, 0)]
    assert got == want


def _recover_soft(pk):
    """One package's run of the soft-state wipe and recover(): the suite's
    answers before and after."""
    sess, oracle = _setup(indexes=["v"], pk=pk)
    feed = pk.Feed(sess, "Live", "d", flush_rows=10**9,
                   policy=pk.lsm.CompactionPolicy(size_ratio=100.0, max_runs=64))
    feed.push(_rows(np.arange(48, 60)))
    feed.upsert({"k": np.arange(5, 9, dtype=np.int32),
                 "v": np.full(4, 55, dtype=np.int32),
                 "g": (np.arange(5, 9) % 5).astype(np.int32)})
    feed.delete(np.array([20, 21], dtype=np.int32))
    feed.flush()
    df = pk.AFrame("d", "Live", session=sess)

    def suite():
        obs = _observe(df)
        obs["v_range"] = len(df[(df["v"] >= 10) & (df["v"] <= 60)])
        obs["probe"] = (len(df[df["k"] == 20]), len(df[df["k"] == 5]))
        return obs

    before = suite()
    comps = sess.catalog.components("d", "Live")
    assert any(c.anti_keys_arr is not None for c in comps)
    for comp in comps:
        comp.live_rows = 0
        comp.annihilated_rows = 10 ** 6
        comp.annihilated_keys = set()
        comp.host_keys = None
        comp.block_zones = None
        if comp.anti_keys_arr is not None:
            comp.anti_keys_arr = comp.anti_keys_arr[:0]
        for info in comp.indexes.values():
            if info.kind == "secondary":
                info.sorted_keys = info.row_ids = None
                info.zone_min = info.zone_max = None
    pk.lsm.recover(sess, "d", "Live")
    after = suite()
    assert after == before
    for comp in comps:
        assert comp.host_keys is not None
        assert all(info.sorted_keys is not None
                   for info in comp.indexes.values())
    assert any(len(c.anti_keys_arr) for c in comps
               if c.anti_keys_arr is not None)
    return before, after


def test_recover_rebuilds_corrupted_soft_state_bit_identical():
    """Hard state suffices: wipe every piece of soft state and recover()
    rebuilds it, on the session device, so every answer is unchanged and
    equal to the reference's after its own wipe and recover()."""
    want, got = (_recover_soft(pk) for pk, _ in PKGS)
    assert got == want


def _stress(mode, seed, n_ops=9, fault=None, fault_at=0, shards=None):
    """The reference's oracle-replay stress: a random op sequence against a
    writer with a leveled compactor racing, a reader session observing
    after every flush, and optionally one injected crash on the writer
    path (worker-side crashes are absorbed by its retry loop)."""
    rng = np.random.default_rng(seed)
    sess, oracle = _setup(mode, shards=shards)
    shadow = dict(oracle)  # oracle ∪ buffered-but-unflushed ops
    df = PORT.AFrame("d", "Live", session=PORT.session(
        mode, shards=shards, catalog=sess.catalog))
    next_k = 48
    flush_i = 0
    with lsm.BackgroundCompactor(sess, policy=lsm.LeveledCompactionPolicy(
            size_ratio=6.0, max_runs=64, level0_runs=2, level_ratio=2),
            backoff_s=0.001) as bc:
        feed = Feed(sess, "Live", "d", flush_rows=10**9, policy=DEFERRED,
                    compactor=bc)
        ops = rng.choice(["push", "upsert", "delete", "flush"], size=n_ops,
                         p=[0.35, 0.2, 0.15, 0.3])
        for op in list(ops) + ["flush"]:
            if op == "push":
                n = int(rng.integers(1, 10))
                rows = _rows(np.arange(next_k, next_k + n), rng)
                next_k += n
                feed.push(rows)
                _apply(shadow, rows)
            elif op == "upsert":
                keys = sorted(shadow)
                if not keys:
                    continue
                pick = rng.choice(keys, size=min(6, len(keys)), replace=False)
                ups = _rows(np.sort(pick), rng)
                feed.upsert(ups)
                _apply(shadow, ups)
            elif op == "delete":
                keys = sorted(shadow)
                if not keys:
                    continue
                pick = np.sort(rng.choice(keys, size=min(4, len(keys)),
                                          replace=False)).astype(np.int32)
                feed.delete(pick)
                _apply(shadow, deletes=pick)
            else:
                if fault is not None and flush_i == fault_at:
                    sess.fault_plan = FaultPlan(schedule={fault: (0,)})
                try:
                    feed.flush()
                except StorageFault:
                    pt = sess.fault_plan.fired[-1][0]
                    sess.fault_plan = None
                    if pt == "post-swap":
                        # committed: repair soft state, don't replay
                        lsm.recover(sess, "d", "Live")
                        feed.drop_buffer()
                    else:
                        feed.flush()  # nothing landed: replay the buffer
                sess.fault_plan = None
                flush_i += 1
                assert _observe(df) == _expected(shadow), \
                    f"[{mode} seed={seed}] reader diverged after flush {flush_i}"
        assert bc.wait_idle(30.0)
        final = _expected(dict(shadow))
        assert _observe(df) == final
        df2 = PORT.AFrame("d", "Live", session=PORT.session(
            mode, shards=shards, catalog=sess.catalog))
        assert _observe(df2) == final


@pytest.mark.parametrize("mode", ["gspmd", "shard_map", "kernel"])
def test_stress_concurrent_ops_match_oracle(mode):
    """The stress run without faults."""
    _stress(mode, 0)


@pytest.mark.parametrize("mode", ["gspmd", "shard_map", "kernel"])
@pytest.mark.parametrize("fault", STORAGE_FAULT_POINTS)
def test_stress_with_injected_crash_matches_oracle(mode, fault):
    _stress(mode, seed=2, fault=fault, fault_at=1)


@pytest.mark.parametrize("mode", ["shard_map", "kernel"])
@pytest.mark.parametrize("fault", (None,) + STORAGE_FAULT_POINTS)
def test_stress_on_an_8_shard_mesh(mode, fault):
    """The stress run on an 8-shard mesh (writer and reader share it):
    every reader observation equals the oracle, with and without a crash;
    the background compactor builds its new bases sharded."""
    _stress(mode, seed=2, fault=fault, fault_at=1, shards=8)


def test_stress_hypothesis_random_schedules():
    """Property form of the stress run at the reference's settings:
    random seeds, op counts and crash points."""
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=8, deadline=None)
    @given(seed=st.integers(0, 10**6), n_ops=st.integers(4, 12),
           fault=st.sampled_from((None,) + STORAGE_FAULT_POINTS),
           fault_at=st.integers(0, 2))
    def run(seed, n_ops, fault, fault_at):
        _stress("gspmd", seed, n_ops=n_ops, fault=fault, fault_at=fault_at)

    run()
