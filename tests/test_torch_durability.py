"""Durable storage on the port (runtime/durable.py, Session.open, the feed
WAL, lazy soft-state rebuild), replaying tests/test_durability.py through
both packages on ``device="cpu"``.

The reference's scenario (``BATCHES``: an append run, an upsert/delete run
over both older components, then acked-but-unflushed batches) runs through
each package into its own directory; the port's recovered rows equal the
reference's bit for bit, dtypes included, for the round trip and for every
I/O crash point in gspmd, shard_map (the reference's one-device mesh, the
port's one-shard mesh) and kernel mode. The on-disk format is shared: a
store written by either package opens in the other with the same rows, and
the two packages write the same file tree. A store written without a mesh
reopens on an 8-shard port mesh (re-sharded at mount) with the same rows,
and the crash matrix holds there too."""
import pathlib
import shutil

import numpy as np
import pytest

from test_durability import BATCHES
from torch_replay import PORT, REF, assert_same, counts

from repro.runtime import durable as ref_durable
from repro.runtime import fault as ref_fault
from repro_torch.runtime import durable, fault
from repro_torch.runtime import telemetry as tel
from repro_torch.runtime.durable import (StorageCorruption, StorageLockError,
                                         read_segment, write_segment)
from repro_torch.runtime.fault import IO_FAULT_POINTS

MODES = ["gspmd", "shard_map", "kernel"]
PKGS = {"ref": (REF, ref_fault), "port": (PORT, fault)}


def _create(pk, sess):
    t = pk.Table({"id": np.arange(16, dtype=np.int32),
                  "v": np.arange(16, dtype=np.float32),
                  "g": (np.arange(16, dtype=np.int32) % 3)})
    sess.create_dataset("ds", t, dataverse="d", primary="id", indexes=["g"])


def _feed(pk, sess, **kw):
    kw.setdefault("policy", pk.lsm.CompactionPolicy(size_ratio=100.0,
                                                    max_runs=64))
    return pk.Feed(sess, "ds", "d", flush_rows=10**9, **kw)


def _apply(feed, kind, payload):
    if kind == "flush":
        feed.flush()
    elif kind == "delete":
        feed.delete(payload)
    else:
        getattr(feed, kind)(payload)


def _run_batches(pk, sess, fault_mod):
    """BATCHES until the first injected crash; the acked mutation batches
    (flushes are not acks)."""
    feed = _feed(pk, sess)
    acked = []
    for kind, payload in BATCHES:
        try:
            _apply(feed, kind, payload)
        except fault_mod.StorageFault:
            return acked, True
        if kind != "flush":
            acked.append((kind, payload))
    return acked, False


def _rows(pk, sess):
    got = pk.AFrame("d", "ds", session=sess).collect()
    order = np.argsort(np.asarray(got["id"]), kind="stable")
    return {k: np.asarray(v)[order] for k, v in got.items()}


def _oracle(pk, mode, acked, shards=None):
    """A memory-only session applying exactly the acked batches."""
    sess = pk.session(mode, shards=shards)
    _create(pk, sess)
    feed = _feed(pk, sess)
    for kind, payload in acked:
        _apply(feed, kind, payload)
    feed.flush()
    return _rows(pk, sess)


def _ids(pk, path):
    sess = pk.Session.open(str(path), **_kw(pk))
    try:
        return _rows(pk, sess)["id"]
    finally:
        sess.close()


def _kw(pk, mode=None, shards=None):
    """``Session.open`` arguments: the mode, and the mesh ``pk.session``
    builds for it (shard_map, or ``shards`` on the port)."""
    kw = {} if mode is None else {"mode": mode}
    if mode == "shard_map" or shards:
        kw["mesh"] = pk.session(mode or "gspmd", shards=shards).mesh
    elif pk is PORT:
        kw["device"] = "cpu"
    return kw


def _push(feed, lo, hi, v=None, g=None):
    n = hi - lo
    feed.push({"id": np.arange(lo, hi, dtype=np.int32),
               "v": np.arange(n, dtype=np.float32) if v is None
               else np.full(n, v, np.float32),
               "g": np.zeros(n, np.int32) if g is None else g})


def _soft_state(comps) -> dict:
    """Every component's soft state, flattened to host values (the state
    before a close that the rebuild must reproduce)."""
    def host(t):
        return None if t is None else t.cpu().numpy()

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


def _assert_soft_equal(got: dict, want: dict, label: str) -> None:
    assert got.keys() == want.keys(), label
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray) or isinstance(g, np.ndarray):
            assert g is not None and w is not None, (label, k)
            assert g.dtype == w.dtype, (label, k, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=f"{label}:{k}")
        else:
            assert g == w, (label, k, g, w)


# -- round trip --------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_reopen_roundtrip_bit_identical(tmp_path, mode):
    """tests/test_durability.py's round trip through both packages: rows
    before close and after reopen equal the reference's, dtypes included;
    point lookups agree; after the same queries the plan caches count the
    same compiles and hits."""
    got = {}
    for name, (pk, _) in PKGS.items():
        d = tmp_path / name
        sess = pk.session(mode, storage=str(d))
        _create(pk, sess)
        feed = _feed(pk, sess)
        for kind, payload in BATCHES:
            _apply(feed, kind, payload)
        feed.flush()
        before = _rows(pk, sess)
        sess.close()
        re = pk.Session.open(str(d), **_kw(pk, mode))
        after = _rows(pk, re)
        assert_same(after, before, f"roundtrip[{name},{mode}]")
        assert re.recovery_report["wal_replayed_batches"] == 0
        got[name] = (after, re.point_lookup("d", "ds", 1),
                     re.point_lookup("d", "ds", 2),
                     re.point_lookup("d", "ds", 99), counts(re))
        re.close()
    ref, port = got["ref"], got["port"]
    assert_same(port[0], ref[0], f"roundtrip[{mode}] port vs reference")
    assert_same(port[1], ref[1], "lookup upserted")
    assert port[1]["v"][0] == 100.0
    assert port[2] is None and ref[2] is None
    assert port[3] is None and ref[3] is None
    assert port[4] == ref[4]


# -- crash-restart equivalence: every I/O point × mode -----------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("point", IO_FAULT_POINTS)
def test_crash_restart_equivalence(tmp_path, mode, point):
    """Kill at the I/O crash point, reopen: the visible rows equal a
    memory-only session that applied exactly the acked batches, and equal
    the reference's recovery of the same crash bit for bit."""
    assert IO_FAULT_POINTS == ref_fault.IO_FAULT_POINTS
    got = {}
    for name, (pk, fault_mod) in PKGS.items():
        d = str(tmp_path / name)
        sess = pk.session(mode, storage=d)
        _create(pk, sess)
        sess.fault_plan = fault_mod.FaultPlan.once(point)  # after the commit
        acked, crashed = _run_batches(pk, sess, fault_mod)
        sess.close()
        if point == "mid-replay":
            with pytest.raises(fault_mod.StorageFault):
                pk.Session.open(d, fault_plan=fault_mod.FaultPlan.once(
                    "mid-replay"), **_kw(pk, mode))
            crashed = True
        assert crashed or point == "torn-write", point
        re = pk.Session.open(d, **_kw(pk, mode))
        rows = _rows(pk, re)
        assert_same(rows, _oracle(pk, mode, acked), f"crash[{name},{point}]")
        assert len(rows["id"]) == len(set(rows["id"].tolist()))
        got[name] = (rows, [k for k, _ in acked])
        re.close()
    assert got["port"][1] == got["ref"][1]
    assert_same(got["port"][0], got["ref"][0],
                f"crash[{point},{mode}] port vs reference")


# -- the single-mode tests of tests/test_durability.py, on both packages ------

@pytest.mark.parametrize("name", ["ref", "port"])
def test_torn_segment_write_stays_invisible(tmp_path, name):
    pk, fault_mod = PKGS[name]
    sess = pk.session(storage=str(tmp_path))
    _create(pk, sess)
    feed = _feed(pk, sess)
    # arrival 0 is the push's WAL append; arrival 1 the run-segment write
    sess.fault_plan = fault_mod.FaultPlan.once("torn-write", arrival=1)
    _push(feed, 16, 24)
    with pytest.raises(fault_mod.StorageFault):
        feed.flush()
    seg_dir = tmp_path / "data" / "d" / "ds" / "seg"
    assert list(seg_dir.glob("*.tmp")), "torn write should leave a tmp file"
    sess.close()
    re = pk.Session.open(str(tmp_path), **_kw(pk))
    assert re.recovery_report["wal_replayed_batches"] == 1
    np.testing.assert_array_equal(_rows(pk, re)["id"],
                                  np.arange(24, dtype=np.int32))
    assert not list(seg_dir.glob("*.tmp")), "sweep should drop torn tmps"
    re.close()


def test_corrupt_segment_quarantined_previous_generation_serves(tmp_path):
    sess = PORT.session(storage=str(tmp_path))
    _create(PORT, sess)                 # generation 1: base only
    feed = _feed(PORT, sess)
    _push(feed, 16, 24)
    feed.flush()                        # generation 2: base + run
    sess.close()
    seg_dir = tmp_path / "data" / "d" / "ds" / "seg"
    run_seg = next(p for p in seg_dir.iterdir() if p.name.startswith("run"))
    blob = bytearray(run_seg.read_bytes())
    blob[len(blob) // 2] ^= 0xFF        # flip a payload bit
    run_seg.write_bytes(bytes(blob))

    before = tel.counter_value("storage.corruption_total") or 0
    re = PORT.Session.open(str(tmp_path), device="cpu")
    rep = re.recovery_report["datasets"]["d.ds"]
    assert rep["manifest_fallbacks"] >= 1 and rep["quarantined"]
    assert re.recovery_report["corruption_events"] >= 1
    assert (tel.counter_value("storage.corruption_total") or 0) > before
    assert list((tmp_path / "quarantine").iterdir())
    np.testing.assert_array_equal(_rows(PORT, re)["id"],
                                  np.arange(16, dtype=np.int32))
    re.close()
    # the fallback is durable, and the reference reads the same store
    np.testing.assert_array_equal(_ids(PORT, tmp_path),
                                  np.arange(16, dtype=np.int32))
    np.testing.assert_array_equal(_ids(REF, tmp_path),
                                  np.arange(16, dtype=np.int32))


def test_segment_checksum_rejects_bit_flip(tmp_path):
    """The port's segment writer gives the reference's bytes, reads them
    back, and refuses a flipped bit."""
    path, ref_path = tmp_path / "x.seg", tmp_path / "y.seg"
    arrays = {"a": np.arange(10, dtype=np.int64),
              "s": np.arange(32, dtype=np.uint8).reshape(2, 16),
              "b": np.array([True, False])}
    write_segment(path, arrays, {"k": 1}, lambda point: None)
    ref_durable.write_segment(ref_path, arrays, {"k": 1}, lambda point: None)
    assert path.read_bytes() == ref_path.read_bytes()
    got, meta = read_segment(path)
    for k, a in arrays.items():
        assert got[k].dtype == a.dtype
        np.testing.assert_array_equal(got[k], a)
    assert meta["k"] == 1
    blob = bytearray(path.read_bytes())
    blob[-3] ^= 0x01
    path.write_bytes(bytes(blob))
    with pytest.raises(StorageCorruption):
        read_segment(path)


def test_empty_buffer_flush_is_noop(tmp_path):
    sess = PORT.session(storage=str(tmp_path))
    _create(PORT, sess)
    feed = _feed(PORT, sess)
    ds_dir = tmp_path / "data" / "d" / "ds"
    gens_before = sorted(p.name for p in ds_dir.glob("MANIFEST.*.json"))
    feed.flush()
    feed.flush()
    assert sorted(p.name for p in ds_dir.glob("MANIFEST.*.json")) == gens_before
    assert sess.storage.wal_seq("d", "ds") == 0
    sess.close()


@pytest.mark.parametrize("name", ["ref", "port"])
def test_replay_skips_already_flushed_batches(tmp_path, name):
    """A crash between manifest commit and WAL truncate: the covered record
    stays in the log, fenced by the manifest's wal_upto."""
    pk, fault_mod = PKGS[name]
    sess = pk.session(storage=str(tmp_path))
    _create(pk, sess)
    feed = _feed(pk, sess)
    _push(feed, 16, 24)
    sess.fault_plan = fault_mod.FaultPlan.once("pre-wal-truncate")
    with pytest.raises(fault_mod.StorageFault):
        feed.flush()
    sess.close()
    assert (tmp_path / "data" / "d" / "ds" / "wal.log").stat().st_size > 0
    re = pk.Session.open(str(tmp_path), **_kw(pk))
    assert re.recovery_report["wal_replayed_batches"] == 0
    np.testing.assert_array_equal(_rows(pk, re)["id"],
                                  np.arange(24, dtype=np.int32))
    re.close()


def test_interleaved_upsert_delete_replay_order(tmp_path):
    """Replay applies the tail in arrival order: upsert → delete → upsert
    of one key lands on the last value."""
    sess = PORT.session(storage=str(tmp_path))
    _create(PORT, sess)
    feed = _feed(PORT, sess)
    k, g = np.array([100], dtype=np.int32), np.array([0], dtype=np.int32)
    feed.upsert({"id": k, "v": np.array([1.0], np.float32), "g": g})
    feed.delete(k)
    feed.upsert({"id": k, "v": np.array([2.0], np.float32), "g": g})
    feed.delete(np.array([7], dtype=np.int32))
    sess.close()   # acked, never flushed: all four live only in the WAL
    copy = tmp_path.parent / (tmp_path.name + "_ref")
    shutil.copytree(tmp_path, copy)
    rows = {}
    for pk, d in ((PORT, tmp_path), (REF, copy)):  # the reference replays
        re = pk.Session.open(str(d), **_kw(pk))     # the port's log alike
        assert re.recovery_report["wal_replayed_batches"] == 4
        assert re.point_lookup("d", "ds", 100)["v"][0] == 2.0
        assert re.point_lookup("d", "ds", 7) is None
        rows[pk.name] = _rows(pk, re)
        re.close()
    assert_same(rows["port"], rows["ref"], "replayed")


def test_double_open_raises_lock_error(tmp_path):
    sess = PORT.session(storage=str(tmp_path))
    _create(PORT, sess)
    with pytest.raises(StorageLockError):
        PORT.Session.open(str(tmp_path), device="cpu")
    with pytest.raises(ref_durable.StorageLockError):  # one lock, both packages
        REF.Session.open(str(tmp_path))
    sess.close()
    PORT.Session.open(str(tmp_path), device="cpu").close()


def test_lazy_rebuild_defers_to_first_bind(tmp_path):
    """A lazy open mounts the hard columns and leaves every payload None;
    the first query rebuilds indexes, zone maps, host key copies, anti
    arrays and bookkeeping — the state before the close, bit for bit —
    and an eager open builds the same."""
    sess = PORT.session(storage=str(tmp_path))
    _create(PORT, sess)
    feed = _feed(PORT, sess)
    for kind, payload in BATCHES:
        _apply(feed, kind, payload)
    feed.flush()
    expect = _rows(PORT, sess)
    soft = _soft_state(sess.catalog.components("d", "ds"))
    sess.close()

    re = PORT.Session.open(str(tmp_path), lazy=True, device="cpu")
    assert re.catalog.stale, "lazy open must defer the soft rebuild"
    comps = re.catalog.components("d", "ds")
    assert all(c.soft_stale for c in comps)
    assert all(ix.sorted_keys is None and c.block_zones is None
               for c in comps for ix in c.indexes.values())
    before = tel.counter_value("storage.lazy_rebuilds_total") or 0
    assert_same(_rows(PORT, re), expect, "lazy")     # first bind rebuilds
    assert not re.catalog.stale and not any(c.soft_stale for c in comps)
    assert (tel.counter_value("storage.lazy_rebuilds_total") or 0) == before + 1
    _assert_soft_equal(_soft_state(comps), soft, "lazy")
    assert re.point_lookup("d", "ds", 1)["v"][0] == 100.0
    re.close()

    eager = PORT.Session.open(str(tmp_path), lazy=False, device="cpu")
    assert not eager.catalog.stale
    _assert_soft_equal(_soft_state(eager.catalog.components("d", "ds")),
                       soft, "eager")
    assert_same(_rows(PORT, eager), expect, "eager")
    eager.close()


def _first_bind_query(sess, pk):
    return len(pk.AFrame("d", "ds", session=sess))


def _first_bind_explain(sess, pk):
    df = pk.AFrame("d", "ds", session=sess)
    return sess.explain(df[df["g"] == 1]._plan) is not None


def _first_bind_lookup(sess, pk):
    return sess.point_lookup("d", "ds", 1)["v"][0]


def _first_bind_view(sess, pk):
    plan = pk.P.GroupAgg(pk.P.Scan("ds", "d"), ["g"],
                         [pk.P.AggSpec("count", "count", None)])
    sess.create_view("by_g", plan)
    return sess.read_view("by_g")


def _first_bind_flush(sess, pk):
    feed = _feed(pk, sess)
    feed.delete(np.array([4], dtype=np.int32))
    feed.flush()
    return len(pk.AFrame("d", "ds", session=sess))


def _first_bind_compact(sess, pk):
    _feed(pk, sess).compact()
    return len(sess.catalog.components("d", "ds"))


FIRST_BINDS = {"query": _first_bind_query, "explain": _first_bind_explain,
               "point_lookup": _first_bind_lookup, "view": _first_bind_view,
               "flush": _first_bind_flush, "compact": _first_bind_compact}


@pytest.mark.parametrize("site", sorted(FIRST_BINDS))
def test_each_bind_site_rebuilds_a_lazy_mount(tmp_path, site):
    """Every bind site of the reference (query, explain, point lookup, view
    seed, flush, compaction) rebuilds a lazily mounted chain once before
    it reads soft state, and answers as the reference's does."""
    got = {}
    for name, (pk, _) in PKGS.items():
        d = str(tmp_path / name)
        sess = pk.session(storage=d)
        _create(pk, sess)
        feed = _feed(pk, sess)
        for kind, payload in BATCHES:
            _apply(feed, kind, payload)
        feed.flush()
        sess.close()
        re = pk.Session.open(d, lazy=True, **_kw(pk))
        assert re.catalog.stale
        out = FIRST_BINDS[site](re, pk)
        assert not re.catalog.stale
        assert not any(c.soft_stale
                       for c in re.catalog.components("d", "ds"))
        got[name] = (out, _rows(pk, re))
        re.close()
    assert_same(got["port"][0], got["ref"][0], site)
    assert_same(got["port"][1], got["ref"][1], site)


def test_recovery_telemetry_series_present(tmp_path):
    sess = PORT.session(storage=str(tmp_path))
    _create(PORT, sess)
    sess.close()
    re = PORT.Session.open(str(tmp_path), device="cpu")
    assert tel.counter_value("storage.wal_replayed_batches_total") is not None
    assert tel.counter_value("storage.corruption_total") is not None
    assert re.recovery_report["seconds"] >= 0.0
    re.close()


def test_compaction_gc_unlinks_dead_segments(tmp_path):
    sess = PORT.session(storage=str(tmp_path))
    _create(PORT, sess)
    feed = _feed(PORT, sess, policy=PORT.lsm.CompactionPolicy(size_ratio=0.0))
    for i in range(4):
        _push(feed, 100 + 8 * i, 108 + 8 * i, v=float(i))
        feed.flush()
    expect = _rows(PORT, sess)
    segs = {p.name for p in (tmp_path / "data" / "d" / "ds" / "seg").iterdir()}
    assert len(segs) <= 2 * sess.storage.keep_manifests
    sess.close()
    re = PORT.Session.open(str(tmp_path), device="cpu")
    assert_same(_rows(PORT, re), expect, "post-gc")
    re.close()


# -- across packages ---------------------------------------------------------

def _write_scenario(pk, d, mode):
    """BATCHES with the last two left in the WAL (unflushed)."""
    sess = pk.session(mode, storage=str(d))
    _create(pk, sess)
    feed = _feed(pk, sess)
    for kind, payload in BATCHES:
        _apply(feed, kind, payload)
    sess.close()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_store_opens_across_packages(tmp_path, mode, writer, reader):
    """A store one package wrote (segments, manifests and a WAL tail) opens
    in the other with the rows the writer's own reopen serves, bit for bit,
    and the reader's next flush commits a generation the writer reads."""
    wpk, rpk = PKGS[writer][0], PKGS[reader][0]
    own, other = tmp_path / "own", tmp_path / "other"
    _write_scenario(wpk, own, mode)
    _write_scenario(wpk, other, mode)
    mine = wpk.Session.open(str(own), **_kw(wpk, mode))
    theirs = rpk.Session.open(str(other), **_kw(rpk, mode))
    assert theirs.recovery_report["wal_replayed_batches"] == 2
    assert_same(_rows(rpk, theirs), _rows(wpk, mine), f"{writer}->{reader}")
    feed = _feed(rpk, theirs)
    feed.delete(np.array([0], dtype=np.int32))
    feed.flush()
    want = _rows(rpk, theirs)
    mine.close()
    theirs.close()
    back = wpk.Session.open(str(other), **_kw(wpk, mode))
    assert_same(_rows(wpk, back), want, f"{reader}->{writer}")
    back.close()


def _wal_records(path: pathlib.Path) -> list:
    """The WAL's records with each npz member's DOS modification time and
    date zeroed (zipfile stamps the wall clock), and the record CRC that
    covers them dropped: the one field two writers of the same batches may
    not share."""
    blob = bytearray(path.read_bytes())
    header, crc = durable._WAL_HEADER, durable._WAL_CRC
    out, off = [], 0
    while off < len(blob):
        magic, seq, kind, plen = header.unpack_from(blob, off)
        payload = bytearray(blob[off + header.size:off + header.size + plen])
        for sig, at in ((b"PK\x03\x04", 10), (b"PK\x01\x02", 12)):
            i = payload.find(sig)
            while i >= 0:
                payload[i + at:i + at + 4] = b"\0\0\0\0"
                i = payload.find(sig, i + 4)
        out.append((magic, seq, kind, plen, bytes(payload)))
        off += header.size + plen + crc.size
    return out


@pytest.mark.parametrize("mode", MODES)
def test_store_trees_identical_across_packages(tmp_path, mode):
    """After the same scenario the two packages' store trees hold the same
    files with the same bytes (LOCK aside); in the WAL, the npz members'
    zip time stamps are the wall clock's (ROADMAP, reference caveats)."""
    trees = {}
    for name, (pk, _) in PKGS.items():
        d = tmp_path / name
        _write_scenario(pk, d, mode)
        trees[name] = {str(p.relative_to(d)): p for p in d.rglob("*")
                       if p.is_file() and p.name != "LOCK"}
    ref, port = trees["ref"], trees["port"]
    assert sorted(port) == sorted(ref)
    assert any(k.endswith(".seg") for k in ref) and "data/d/ds/wal.log" in ref
    for k in ref:
        if k.endswith("wal.log"):
            assert _wal_records(port[k]) == _wal_records(ref[k])
            assert len(_wal_records(ref[k])) == 2
        else:
            assert port[k].read_bytes() == ref[k].read_bytes(), k


# -- a mesh of 8 shards -------------------------------------------------------

@pytest.mark.parametrize("mode", ["shard_map", "kernel"])
def test_meshless_store_reopens_on_an_8_shard_mesh(tmp_path, mode):
    """A store one package wrote without a mesh (segments and a WAL tail)
    reopens on an 8-shard port mesh: every component is re-sharded at
    mount, the rows and point lookups equal a meshless reopen's, and a
    flush made on the mesh commits a generation the writer reads back."""
    for writer in ("ref", "port"):
        wpk = PKGS[writer][0]
        own, other = tmp_path / f"{writer}-own", tmp_path / f"{writer}-mesh"
        _write_scenario(wpk, own, "gspmd")
        _write_scenario(wpk, other, "gspmd")
        flat = wpk.Session.open(str(own), **_kw(wpk, "gspmd"))
        mesh = PORT.Session.open(str(other), **_kw(PORT, mode, shards=8))
        assert mesh.recovery_report["wal_replayed_batches"] == 2
        assert mesh.n_shards == 8
        comps = mesh.catalog.components("d", "ds")
        assert all(c.table.num_rows % 8 == 0 and c.block_zones.n_shards == 8
                   for c in comps)
        assert_same(_rows(PORT, mesh), _rows(wpk, flat), f"{writer}->mesh")
        for key in (0, 1, 2, 5, 99):
            a, b = mesh.point_lookup("d", "ds", key), flat.point_lookup("d", "ds", key)
            assert (a is None) == (b is None), key
            if a is not None:
                assert_same(a, {k: np.asarray(v) for k, v in b.items()}, key)
        feed = _feed(PORT, mesh)
        feed.delete(np.array([3], dtype=np.int32))
        feed.flush()
        want = _rows(PORT, mesh)
        flat.close()
        mesh.close()
        back = wpk.Session.open(str(other), **_kw(wpk, "gspmd"))
        assert_same(_rows(wpk, back), want, f"mesh->{writer}")
        back.close()


@pytest.mark.parametrize("point", IO_FAULT_POINTS)
def test_crash_restart_on_an_8_shard_mesh(tmp_path, point):
    """The crash matrix on an 8-shard mesh, kernel mode: the recovered rows
    equal a memory-only 8-shard session of the acked batches and the
    reference's one-device recovery of the same crash."""
    got = {}
    for name, shards in (("ref", None), ("port", 8)):
        pk, fault_mod = PKGS[name]
        d = str(tmp_path / name)
        sess = pk.session("kernel", shards=shards, storage=d)
        _create(pk, sess)
        sess.fault_plan = fault_mod.FaultPlan.once(point)
        acked, crashed = _run_batches(pk, sess, fault_mod)
        sess.close()
        if point == "mid-replay":
            with pytest.raises(fault_mod.StorageFault):
                pk.Session.open(d, fault_plan=fault_mod.FaultPlan.once(
                    "mid-replay"), **_kw(pk, "kernel", shards))
        re = pk.Session.open(d, **_kw(pk, "kernel", shards))
        rows = _rows(pk, re)
        assert_same(rows, _oracle(pk, "kernel", acked, shards),
                    f"crash[{name},{point}]")
        got[name] = rows
        re.close()
    assert_same(got["port"], got["ref"], f"crash[{point}] 8 shards vs reference")
