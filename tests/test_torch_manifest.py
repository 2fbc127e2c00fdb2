"""Manifests and snapshot isolation on the port (``repro_torch.core.catalog``):
the scenarios of tests/test_manifest.py — atomic publish-then-retire
swaps, LSN monotonicity, pinned snapshots, stable component addresses
across compaction, reader sessions over a shared catalog and the
open_widen dtype contract — replayed on both packages in one process, plus
the port's reclamation of retired components (a pinned snapshot keeps
them readable). The reference's FaultTolerantLoop case belongs with
training (ROADMAP A10)."""
import numpy as np
import pytest
import torch

from torch_replay import PORT, REF

from repro_torch.core.catalog import Manifest, open_widen


def _fresh(pk, n=50, flush_rows=10):
    sess = pk.session()
    sess.create_dataset(
        "Live", pk.Table({"k": np.arange(n, dtype=np.int32),
                          "v": (np.arange(n, dtype=np.int32) * 3) % 17}),
        dataverse="d", primary="k")
    feed = pk.Feed(sess, "Live", "d", flush_rows=flush_rows,
                   policy=pk.lsm.CompactionPolicy(size_ratio=100.0,
                                                  max_runs=64))
    return sess, feed


def _push(feed, lo, n=10):
    feed.push({"k": np.arange(lo, lo + n, dtype=np.int32),
               "v": (np.arange(lo, lo + n, dtype=np.int32) * 3) % 17})


def test_flush_publishes_new_manifest_and_retires_old():
    sess, feed = _fresh(PORT)
    ds = sess.catalog.get("d", "Live")
    m0 = ds.manifest
    assert isinstance(m0, Manifest) and m0.runs == () and not m0.retired
    _push(feed, 50)
    m1 = sess.catalog.get("d", "Live").manifest
    assert m1 is not m0 and m1.lsn > m0.lsn
    assert m0.retired and not m1.retired
    assert [r.name for r in m1.runs] == ["Live@run0"]
    assert m0.components == (ds,)


def test_lsn_and_run_addresses_equal_reference():
    """LSNs strictly increase across flushes and compaction, uids are never
    recycled, and every step's (LSN, component names) equals the
    reference's."""
    seen = {}
    for pk in (REF, PORT):
        sess, feed = _fresh(pk)
        steps = []

        def mark():
            m = sess.catalog.get("d", "Live").manifest
            steps.append((m.lsn, [c.name for c in m.components]))
        mark()
        for i in range(3):
            _push(feed, 50 + 10 * i)
            mark()
        feed.compact()
        mark()
        _push(feed, 90)
        mark()
        seen[pk.name] = steps
    assert seen["port"] == seen["ref"]
    lsns = [lsn for lsn, _ in seen["port"]]
    assert lsns == sorted(lsns) and len(set(lsns)) == len(lsns)
    assert seen["port"][-1][1] == ["Live", "Live@run3"]


def test_snapshot_pins_old_manifest_across_flush_and_compaction():
    sess, feed = _fresh(PORT)
    _push(feed, 50)
    snap = sess.catalog.snapshot()
    pinned = snap.manifest("d", "Live")
    assert pinned.pins == 1
    before = [c.name for c in snap.components("d", "Live")]
    _push(feed, 60)
    feed.compact()
    assert [c.name for c in sess.catalog.components("d", "Live")] == ["Live"]
    assert [c.name for c in snap.components("d", "Live")] == before
    assert snap.get("d", "Live@run0") is pinned.runs[0]
    assert pinned.retired
    snap.release()
    assert pinned.pins == 0
    snap.release()  # idempotent
    assert pinned.pins == 0


def test_pinned_components_stay_readable_until_release():
    """Reclamation drops the tensors of retired engine-owned components —
    but never while a snapshot pins them: a reader bound before the
    compaction still reads every row."""
    sess, feed = _fresh(PORT)
    _push(feed, 50)
    snap = sess.catalog.snapshot()
    run = snap.get("d", "Live@run0")
    _push(feed, 60)
    feed.compact()
    gc = sess.catalog.gc_stats()
    assert gc["manifests_retired_pinned"] >= 1 and gc["retired_component_bytes"] > 0
    assert torch.equal(run.table.columns["k"][:10],
                       torch.arange(50, 60, dtype=torch.int32))
    snap.release()
    assert not run.table.columns  # reclaimed: the catalog let go of them
    assert sess.catalog.gc_stats()["retired_component_bytes"] == 0
    df = PORT.AFrame("d", "Live", session=sess)
    assert len(df) == 70


def test_snapshot_does_not_see_later_datasets():
    sess, _ = _fresh(PORT)
    with sess.catalog.snapshot() as snap:
        sess.create_dataset("Late", PORT.Table({"k": np.arange(5)}), dataverse="d")
        with pytest.raises(KeyError):
            snap.get("d", "Late")
    assert sess.catalog.get("d", "Late") is not None


def test_dataset_runs_property_is_a_read_only_view():
    sess, feed = _fresh(PORT)
    _push(feed, 50)
    ds = sess.catalog.get("d", "Live")
    runs = ds.runs
    runs.append("garbage")
    assert [r.name for r in ds.runs] == ["Live@run0"]


def test_get_component_address_error_paths():
    sess, feed = _fresh(PORT)
    _push(feed, 50)
    cat = sess.catalog
    assert cat.get("d", "Live@run0").uid == 0
    for bad in (("d", "Live@run99"), ("d", "Live@run"), ("d", "Live@runx"),
                ("d", "Live@foo"), ("d", "Nope@run0"), ("nope", "Live@run0")):
        with pytest.raises(KeyError):
            cat.get(*bad)
    with cat.snapshot() as snap:
        with pytest.raises(KeyError):
            snap.get("d", "Live@run99")
        with pytest.raises(KeyError):
            snap.get("d", "Nope@run0")


def test_stable_address_survives_level_merge():
    sess, feed = _fresh(PORT, flush_rows=10)
    for i in range(4):
        _push(feed, 50 + 10 * i)
    cat = sess.catalog
    survivor = cat.get("d", "Live@run3")
    merged_away = [cat.get("d", f"Live@run{i}") for i in range(3)]
    PORT.lsm.merge_runs(sess, cat.get("d", "Live"), 0, 3, level=1)
    assert cat.get("d", "Live@run3") is survivor
    assert [r.name for r in cat.get("d", "Live").runs] == ["Live@run4", "Live@run3"]
    assert cat.get("d", "Live@run4").uid == 4
    for i in range(3):
        with pytest.raises(KeyError):
            cat.get("d", f"Live@run{i}")
    assert all(m.name == f"Live@run{i}" for i, m in enumerate(merged_away))
    assert len(PORT.AFrame("d", "Live", session=sess)) == 90


def test_reader_session_shares_catalog_and_sees_writes():
    sess, feed = _fresh(PORT)
    reader = PORT.Session(catalog=sess.catalog, device="cpu", mode="kernel")
    df = PORT.AFrame("d", "Live", session=reader)
    assert len(df) == 50
    _push(feed, 50)
    assert len(df) == 60
    feed.compact()
    assert len(df) == 60


def test_open_widen_casts_integers_to_float32():
    t = PORT.Table({"k": np.arange(8, dtype=np.int64),
                    "f": np.ones(8, dtype=np.float64),
                    "s": np.zeros((8, 16), dtype=np.uint8)})
    w = open_widen(t)
    assert w.columns["k"].dtype == torch.float32
    assert w.meta["k"].dtype == np.dtype(np.float32)
    assert w.columns["f"].dtype == torch.float64
    assert w.columns["s"].dtype == torch.uint8
    np.testing.assert_array_equal(w.columns["k"].numpy(),
                                  np.arange(8, dtype=np.float32))


def test_catalog_and_snapshot_names_equal_reference():
    """``Catalog.names()`` and ``Snapshot.names()`` list the
    ``"dataverse.name"`` keys in registration order; a snapshot keeps the
    names it pinned, not a dataset created or dropped after it."""
    seen = {}
    for pk in (REF, PORT):
        sess, _ = _fresh(pk)
        sess.create_dataset("Dim", pk.Table({"k": np.arange(5, dtype=np.int32)}),
                            dataverse="e")
        snap = sess.catalog.snapshot()
        sess.create_dataset("Late", pk.Table({"k": np.arange(3, dtype=np.int32)}),
                            dataverse="d")
        sess.catalog.drop("e", "Dim")
        seen[pk is PORT] = (sess.catalog.names(), snap.names())
        snap.release()
    assert seen[True] == seen[False]
    assert seen[True] == (["d.Live", "d.Late"], ["d.Live", "e.Dim"])
