"""tests/test_durability.py's scenarios and tests/test_concurrency.py's
soft-state recovery (:346), written once over a package surface ``pk``, so
that the same code runs on a rank mesh (``rank_workers.durable_pk``), on
the port's one-process mesh and on the reference (built by
tests/test_torch_rank_durable.py).

``pk`` carries ``session(mode, **kw)``, ``open(path, mode, **kw)``
(``Session.open`` on the pk's mesh), ``Table``, ``Feed``, ``lsm``,
``AFrame``, ``P``, ``tel``, ``FaultPlan``, ``StorageFault``, ``once(fn)``
(``fn`` on one process only, the others waiting for it: a file is
changed once) and ``observe(sess, label, name="ds")`` (a rank logs what
it holds of dataset d.<name>). Each scenario returns what its test
holds: rows as numpy arrays, counts, the names of the errors raised.
numpy only here: a rank process loads this module without jax.
"""
import numpy as np

DS_DIR = ("data", "d", "ds")


def create(pk, sess):
    t = pk.Table({"id": np.arange(16, dtype=np.int32),
                  "v": np.arange(16, dtype=np.float32),
                  "g": (np.arange(16, dtype=np.int32) % 3)})
    sess.create_dataset("ds", t, dataverse="d", primary="id", indexes=["g"])


def feed(pk, sess, **kw):
    kw.setdefault("policy", pk.lsm.CompactionPolicy(size_ratio=100.0,
                                                    max_runs=64))
    return pk.Feed(sess, "ds", "d", flush_rows=10**9, **kw)


def apply(f, kind, payload):
    if kind == "flush":
        f.flush()
    elif kind == "delete":
        f.delete(payload)
    else:
        getattr(f, kind)(payload)


def rows(pk, sess) -> dict:
    got = pk.AFrame("d", "ds", session=sess).collect()
    order = np.argsort(np.asarray(got["id"]), kind="stable")
    return {k: np.asarray(v)[order] for k, v in got.items()}


def push(f, lo, hi, v=None):
    n = hi - lo
    f.push({"id": np.arange(lo, hi, dtype=np.int32),
            "v": np.arange(n, dtype=np.float32) if v is None
            else np.full(n, v, np.float32),
            "g": np.zeros(n, np.int32)})


def run_batches(pk, sess, batches):
    """The batches until the first injected crash; the acked mutations
    (flushes are not acks)."""
    f = feed(pk, sess)
    acked = []
    for kind, payload in batches:
        try:
            apply(f, kind, payload)
        except pk.StorageFault:
            return acked, True
        if kind != "flush":
            acked.append((kind, payload))
    return acked, False


def oracle_rows(pk, mode, acked) -> dict:
    """A memory-only session applying exactly the acked batches."""
    sess = pk.session(mode)
    create(pk, sess)
    f = feed(pk, sess)
    for kind, payload in acked:
        apply(f, kind, payload)
    f.flush()
    return rows(pk, sess)


def write_scenario(pk, d, mode, batches) -> None:
    """The batches, the last two left in the WAL (unflushed)."""
    sess = pk.session(mode, storage=str(d))
    create(pk, sess)
    f = feed(pk, sess)
    for kind, payload in batches:
        apply(f, kind, payload)
    sess.close()


def _raised(fn) -> str | None:
    try:
        fn()
    except Exception as e:   # the name of what was raised, held by the test
        return type(e).__name__
    return None


def roundtrip(pk, root, mode, batches) -> dict:
    """Rows before the close and after the reopen, point lookups, the plan
    cache's counts after the same queries."""
    d = root / f"roundtrip-{mode}"
    sess = pk.session(mode, storage=str(d))
    create(pk, sess)
    f = feed(pk, sess)
    for kind, payload in batches:
        apply(f, kind, payload)
    f.flush()
    before = rows(pk, sess)
    sess.close()
    re = pk.open(d, mode)
    out = {"before": before, "after": rows(pk, re),
           "replayed": re.recovery_report["wal_replayed_batches"],
           "get": [re.point_lookup("d", "ds", k) for k in (1, 2, 99)],
           "counts": (re.stats["compiles"], re.stats["hits"])}
    pk.observe(re, f"roundtrip-{mode}")
    re.close()
    return out


def crash(pk, root, mode, point, batches) -> dict:
    """Crash at ``point`` (armed after the initial commit), reopen: the
    rows, the acked batches' kinds and the memory-only oracle's rows."""
    d = root / f"crash-{mode}-{point}"
    sess = pk.session(mode, storage=str(d))
    create(pk, sess)
    sess.fault_plan = pk.FaultPlan.once(point)
    acked, crashed = run_batches(pk, sess, batches)
    sess.close()
    replay = None
    if point == "mid-replay":
        replay = _raised(lambda: pk.open(d, mode, fault_plan=pk.FaultPlan.once(
            "mid-replay")))
    re = pk.open(d, mode)
    out = {"rows": rows(pk, re), "acked": [k for k, _ in acked],
           "crashed": crashed, "replay_raised": replay}
    pk.observe(re, f"crash-{mode}-{point}")
    out["oracle"] = oracle_rows(pk, mode, acked)
    re.close()
    return out


def torn_segment(pk, root) -> dict:
    """A torn run-segment write stays invisible: a tmp is left, the reopen
    replays the batch and sweeps the tmp."""
    d = root / "torn"
    sess = pk.session(storage=str(d))
    create(pk, sess)
    f = feed(pk, sess)
    # arrival 0 is the push's WAL append; arrival 1 the run-segment write
    sess.fault_plan = pk.FaultPlan.once("torn-write", arrival=1)
    push(f, 16, 24)
    raised = _raised(f.flush)
    seg_dir = d.joinpath(*DS_DIR, "seg")
    left = bool(list(seg_dir.glob("*.tmp")))
    sess.close()
    re = pk.open(d)
    out = {"raised": raised, "tmp_left": left,
           "replayed": re.recovery_report["wal_replayed_batches"],
           "ids": rows(pk, re)["id"],
           "tmp_swept": not list(seg_dir.glob("*.tmp"))}
    re.close()
    return out


def corrupt_segment(pk, root) -> dict:
    """A flipped bit in the run's segment: the reopen quarantines it and the
    previous generation (the base alone) serves, durably."""
    d = root / "corrupt"
    sess = pk.session(storage=str(d))
    create(pk, sess)                    # generation 1: base only
    f = feed(pk, sess)
    push(f, 16, 24)
    f.flush()                           # generation 2: base + run
    sess.close()
    seg_dir = d.joinpath(*DS_DIR, "seg")

    def flip():
        run_seg = next(p for p in seg_dir.iterdir() if p.name.startswith("run"))
        blob = bytearray(run_seg.read_bytes())
        blob[len(blob) // 2] ^= 0xFF    # flip a payload bit
        run_seg.write_bytes(bytes(blob))

    pk.once(flip)
    before = pk.tel.counter_value("storage.corruption_total") or 0
    re = pk.open(d)
    rep = re.recovery_report
    out = {"fallbacks": rep["datasets"]["d.ds"]["manifest_fallbacks"],
           "quarantined": rep["datasets"]["d.ds"]["quarantined"],
           "events": rep["corruption_events"],
           "counted": (pk.tel.counter_value("storage.corruption_total") or 0)
           - before,
           "quarantine_dir": sorted(p.name for p in (d / "quarantine").iterdir()),
           "ids": rows(pk, re)["id"]}
    re.close()
    again = pk.open(d)
    out["ids_again"] = rows(pk, again)["id"]
    again.close()
    return out


def empty_flush(pk, root) -> dict:
    d = root / "empty"
    sess = pk.session(storage=str(d))
    create(pk, sess)
    f = feed(pk, sess)
    ds_dir = d.joinpath(*DS_DIR)
    gens = sorted(p.name for p in ds_dir.glob("MANIFEST.*.json"))
    f.flush()
    f.flush()
    out = {"gens": gens,
           "gens_after": sorted(p.name for p in ds_dir.glob("MANIFEST.*.json")),
           "wal_seq": sess.storage.wal_seq("d", "ds")}
    sess.close()
    return out


def replay_skips(pk, root) -> dict:
    """A crash between the manifest commit and the WAL truncate: the
    covered record stays in the log, fenced by the manifest's wal_upto."""
    d = root / "skips"
    sess = pk.session(storage=str(d))
    create(pk, sess)
    f = feed(pk, sess)
    push(f, 16, 24)
    sess.fault_plan = pk.FaultPlan.once("pre-wal-truncate")
    raised = _raised(f.flush)
    sess.close()
    re = pk.open(d)
    out = {"raised": raised,
           "wal_bytes": d.joinpath(*DS_DIR, "wal.log").stat().st_size,
           "replayed": re.recovery_report["wal_replayed_batches"],
           "ids": rows(pk, re)["id"]}
    re.close()
    return out


def write_interleaved(pk, d) -> None:
    """upsert → delete → upsert of one key, then a delete, acked and never
    flushed: all four live only in the WAL."""
    sess = pk.session(storage=str(d))
    create(pk, sess)
    f = feed(pk, sess)
    k, g = np.array([100], dtype=np.int32), np.array([0], dtype=np.int32)
    f.upsert({"id": k, "v": np.array([1.0], np.float32), "g": g})
    f.delete(k)
    f.upsert({"id": k, "v": np.array([2.0], np.float32), "g": g})
    f.delete(np.array([7], dtype=np.int32))
    sess.close()


def interleaved(pk, root) -> dict:
    """Replay applies the tail in arrival order: the last upsert wins. The
    store stays for the reference to replay."""
    d = root / "interleaved"
    write_interleaved(pk, d)
    re = pk.open(d)
    out = {"replayed": re.recovery_report["wal_replayed_batches"],
           "get100": re.point_lookup("d", "ds", 100),
           "get7": re.point_lookup("d", "ds", 7), "rows": rows(pk, re)}
    re.close()
    return out


def double_open(pk, root) -> dict:
    d = root / "double"
    sess = pk.session(storage=str(d))
    create(pk, sess)
    raised = _raised(lambda: pk.open(d))
    sess.close()
    re = pk.open(d)
    n = len(rows(pk, re)["id"])
    re.close()
    return {"raised": raised, "rows_after": n}


def soft_state(comps) -> dict:
    """Every component's soft state as host values."""
    def host(t):   # a torch tensor, or the reference's array
        return None if t is None else np.asarray(t.cpu() if hasattr(t, "cpu")
                                                 else t)

    out = {}
    for i, c in enumerate(comps):
        out[f"{i}.live"] = c.num_live_rows
        out[f"{i}.anti_rows"] = c.anti_rows
        out[f"{i}.annihilated"] = (c.annihilated_rows,
                                   sorted(c.annihilated_keys))
        out[f"{i}.host_keys"] = c.host_keys
        out[f"{i}.host_anti"] = c.host_anti_keys
        out[f"{i}.anti_arr"] = host(c.anti_keys_arr)
        for k, ix in c.indexes.items():
            for f in ("sorted_keys", "row_ids", "zone_min", "zone_max"):
                out[f"{i}.{k}.{f}"] = host(getattr(ix, f))
        for k, v in (c.block_zones.spans.items() if c.block_zones else ()):
            out[f"{i}.zones.{k}"] = v.copy()
    return out


def lazy_rebuild(pk, root, batches) -> dict:
    """A lazy open leaves every payload None; the first query rebuilds the
    state before the close; an eager open builds the same."""
    d = root / "lazy"
    sess = pk.session(storage=str(d))
    create(pk, sess)
    f = feed(pk, sess)
    for kind, payload in batches:
        apply(f, kind, payload)
    f.flush()
    expect, soft = rows(pk, sess), soft_state(sess.catalog.components("d", "ds"))
    sess.close()
    re = pk.open(d, lazy=True)
    comps = re.catalog.components("d", "ds")
    out = {"expect": expect, "soft": soft,
           "stale": bool(re.catalog.stale),
           "all_stale": all(c.soft_stale for c in comps),
           "payloads_none": all(ix.sorted_keys is None and c.block_zones is None
                                for c in comps for ix in c.indexes.values())}
    before = pk.tel.counter_value("storage.lazy_rebuilds_total") or 0
    out["lazy_rows"] = rows(pk, re)
    pk.observe(re, "lazy")
    out["rebuilds"] = (pk.tel.counter_value("storage.lazy_rebuilds_total")
                       or 0) - before
    out["stale_after"] = bool(re.catalog.stale) or any(c.soft_stale
                                                      for c in comps)
    out["lazy_soft"] = soft_state(comps)
    out["get1"] = re.point_lookup("d", "ds", 1)
    re.close()
    eager = pk.open(d, lazy=False)
    out["eager_stale"] = bool(eager.catalog.stale)
    out["eager_soft"] = soft_state(eager.catalog.components("d", "ds"))
    out["eager_rows"] = rows(pk, eager)
    eager.close()
    return out


def _first_query(pk, sess):
    return len(pk.AFrame("d", "ds", session=sess))


def _first_explain(pk, sess):
    df = pk.AFrame("d", "ds", session=sess)
    return sess.explain(df[df["g"] == 1]._plan) is not None


def _first_lookup(pk, sess):
    return sess.point_lookup("d", "ds", 1)["v"][0]


def _first_view(pk, sess):
    plan = pk.P.GroupAgg(pk.P.Scan("ds", "d"), ["g"],
                         [pk.P.AggSpec("count", "count", None)])
    sess.create_view("by_g", plan)
    return sess.read_view("by_g")


def _first_flush(pk, sess):
    f = feed(pk, sess)
    f.delete(np.array([4], dtype=np.int32))
    f.flush()
    return len(pk.AFrame("d", "ds", session=sess))


def _first_compact(pk, sess):
    feed(pk, sess).compact()
    return len(sess.catalog.components("d", "ds"))


FIRST_BINDS = {"query": _first_query, "explain": _first_explain,
               "point_lookup": _first_lookup, "view": _first_view,
               "flush": _first_flush, "compact": _first_compact}


def first_binds(pk, root, batches) -> dict:
    """Every bind site rebuilds a lazily mounted chain once, then answers."""
    out = {}
    for site, fn in FIRST_BINDS.items():
        d = root / f"bind-{site}"
        sess = pk.session(storage=str(d))
        create(pk, sess)
        f = feed(pk, sess)
        for kind, payload in batches:
            apply(f, kind, payload)
        f.flush()
        sess.close()
        re = pk.open(d, lazy=True)
        stale = bool(re.catalog.stale)
        got = fn(pk, re)
        out[site] = {"stale_before": stale, "answer": got,
                     "stale_after": bool(re.catalog.stale) or any(
                         c.soft_stale for c in re.catalog.components("d", "ds")),
                     "rows": rows(pk, re)}
        re.close()
    return out


def telemetry_series(pk, root) -> dict:
    d = root / "telemetry"
    sess = pk.session(storage=str(d))
    create(pk, sess)
    sess.close()
    re = pk.open(d)
    out = {"replayed_series": pk.tel.counter_value(
        "storage.wal_replayed_batches_total") is not None,
        "corruption_series": pk.tel.counter_value(
            "storage.corruption_total") is not None,
        "seconds": re.recovery_report["seconds"] >= 0.0}
    re.close()
    return out


def compaction_gc(pk, root) -> dict:
    """Four flushes, each compacted: dead segments unlinked, the reopen
    serves the same rows."""
    d = root / "gc"
    sess = pk.session(storage=str(d))
    create(pk, sess)
    f = feed(pk, sess, policy=pk.lsm.CompactionPolicy(size_ratio=0.0))
    for i in range(4):
        push(f, 100 + 8 * i, 108 + 8 * i, v=float(i))
        f.flush()
    out = {"expect": rows(pk, sess),
           "segs": sorted(p.name for p in d.joinpath(*DS_DIR, "seg").iterdir()),
           "keep": sess.storage.keep_manifests}
    sess.close()
    re = pk.open(d)
    out["rows"] = rows(pk, re)
    pk.observe(re, "gc")
    re.close()
    return out


def tree_scenario(pk, d, mode, batches) -> None:
    """The batches (the last two left in the WAL), then an explicit
    compaction: the tree two writers of the same calls must share."""
    sess = pk.session(mode, storage=str(d))
    create(pk, sess)
    f = feed(pk, sess)
    for kind, payload in batches:
        apply(f, kind, payload)
    f.compact()
    sess.close()


# -- tests/test_concurrency.py:346 ---------------------------------------------


def _crows(keys):
    keys = np.asarray(keys, dtype=np.int32)
    vals = 1 + (keys.astype(np.int64) * 7 % 100).astype(np.int32)
    return {"k": keys, "v": vals, "g": (keys % 5).astype(np.int32)}


def _cobserve(df):
    out = df.groupby("g").agg({"v": "sum"})
    vname = next(c for c in out if c != "g")
    return {"len": len(df), "sum": int(df["v"].sum()),
            "g2_count": len(df[df["g"] == 2]),
            "gsum": {int(g): int(s) for g, s in zip(out["g"].tolist(),
                                                    out[vname].tolist()) if s}}


def soft_recover(pk) -> dict:
    """Wipe every piece of soft state and ``lsm.recover``: the suite's
    answers before and after, and whether every payload came back."""
    sess = pk.session("gspmd")
    sess.create_dataset("Live", pk.Table(dict(_crows(np.arange(48)))),
                        dataverse="d", primary="k", indexes=["v"])
    f = pk.Feed(sess, "Live", "d", flush_rows=10**9,
                policy=pk.lsm.CompactionPolicy(size_ratio=100.0, max_runs=64))
    f.push(_crows(np.arange(48, 60)))
    f.upsert({"k": np.arange(5, 9, dtype=np.int32),
              "v": np.full(4, 55, dtype=np.int32),
              "g": (np.arange(5, 9) % 5).astype(np.int32)})
    f.delete(np.array([20, 21], dtype=np.int32))
    f.flush()
    df = pk.AFrame("d", "Live", session=sess)

    def suite():
        obs = _cobserve(df)
        obs["v_range"] = len(df[(df["v"] >= 10) & (df["v"] <= 60)])
        obs["probe"] = (len(df[df["k"] == 20]), len(df[df["k"] == 5]))
        return obs

    before = suite()
    comps = sess.catalog.components("d", "Live")
    soft = soft_state(comps)
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
    pk.observe(sess, "recovered", "Live")
    return {"before": before, "after": suite(), "soft": soft,
            "soft_after": soft_state(comps),
            "anti": any(len(c.anti_keys_arr) for c in comps
                        if c.anti_keys_arr is not None)}
