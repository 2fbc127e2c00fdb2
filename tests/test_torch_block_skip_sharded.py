"""Block skipping, point lookups and the string fast path on an 8-shard
port mesh (CPU): the scenarios of tests/test_block_skip.py's sharded
section, held against a numpy oracle and the port's meshless session. The
reference runs those scenarios on 8 forced host devices, where its own
sharded gathers fail inside the installed jax, so here the reference is
held where it is host-side numpy: the per-shard zone layouts
(``compute_block_zones(table, 4096, S)``), ``BlockZones.shard_lists``,
``ops.shard_block_arrays`` and the point-lookup router ``_route_key``,
each called in this process and compared bit for bit."""
import types

import numpy as np
import pytest
import torch

from repro.core import stats as rstats
from repro.engine import session as rsession
from repro.engine import table as rtable
from repro.kernels import ops as rops
from repro_torch.core import stats as tstats
from repro_torch.core.frame import AFrame
from repro_torch.data import wisconsin
from repro_torch.engine import lsm
from repro_torch.engine import session as tsession
from repro_torch.engine import table as ttable
from repro_torch.engine.ingest import Feed
from repro_torch.engine.session import Session
from repro_torch.engine.table import Table, decode_strings, encode_strings
from repro_torch.kernels import ops as tops
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.runtime import telemetry as tel

N = 20_000
MODES = ("gspmd", "shard_map", "kernel")


def _mesh():
    return make_local_mesh(8, device="cpu")


def clustered(n=N, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.arange(n, dtype=np.int32)
    return Table({"id": torch.from_numpy(ids), "ts": torch.from_numpy(ids.copy()),
                  "val": torch.from_numpy(rng.integers(0, 100, n).astype(np.int32))})


def mutated(sess):
    sess.create_dataset("Mut", clustered(), dataverse="m", primary="id")
    feed = Feed(sess, "Mut", "m", flush_rows=10**9,
                policy=lsm.CompactionPolicy(size_ratio=100.0, max_runs=64))
    ids = np.arange(20_480, 21_504, dtype=np.int32)
    feed.push({"id": ids, "ts": ids.copy(), "val": np.zeros(len(ids), np.int32)})
    feed.flush()
    feed.delete(np.array([8200, 8300], np.int32))
    feed.upsert({"id": np.array([8400], np.int32),
                 "ts": np.array([8400], np.int32),
                 "val": np.array([7], np.int32)})
    feed.flush()
    return sess


def rc(df, lo, hi):
    return len(df[(df["ts"] >= lo) & (df["ts"] <= hi)])


@pytest.fixture(scope="module")
def mutated_sessions():
    sessions = {"unsharded": mutated(Session(device="cpu", enable_index=False))}
    for mode in MODES:
        sessions[mode] = mutated(Session(mesh=_mesh(), mode=mode,
                                         enable_index=False))
    return sessions


ALIVE = np.array(sorted((set(range(N)) | set(range(20_480, 21_504)))
                        - {8200, 8300}))

# shard edges (2,500-row partitions), zone-block edges, the appended run's
# span, the tombstoned block, and off-the-end empties (in 512-row units)
GRID = [(0, 0), (0, 6), (4, 1), (7, 3), (15, 4), (16, 0), (16, 6), (19, 2),
        (38, 5), (40, 3), (43, 6)]


@pytest.mark.parametrize("qlo,qw", GRID)
def test_sharded_block_skip_equivalence(mutated_sessions, qlo, qw):
    """Sharded-with-block-skip == unsharded == skip-disabled, in all three
    modes, over a mutated, uncompacted dataset, against numpy."""
    lo, hi = qlo * 512, (qlo + qw) * 512
    want = int(((ALIVE >= lo) & (ALIVE <= hi)).sum())
    for label, sess in mutated_sessions.items():
        df = AFrame("m", "Mut", session=sess)
        try:
            for skip in (True, False):
                sess.enable_block_skip = skip
                assert rc(df, lo, hi) == want, (label, skip, lo, hi)
        finally:
            sess.enable_block_skip = True


def test_sharded_block_skip_property(mutated_sessions):
    """The same property, hypothesis sweeping the predicate range."""
    from hypothesis import given, settings, strategies as st

    @settings(deadline=None, max_examples=8, database=None)
    @given(st.integers(0, 43), st.integers(0, 6))
    def check(qlo, qw):
        test_sharded_block_skip_equivalence(mutated_sessions, qlo, qw)

    check()


def test_sharded_kernel_grid_skips_per_shard(mutated_sessions):
    """A one-block-selective predicate on the 8-shard mesh: only the owning
    shard's block is scanned, each shard's launch reads its own row of the
    block matrix (the rest all -1), and the telemetry counts the skips."""
    k = mutated_sessions["kernel"]
    df = AFrame("m", "Mut", session=k)
    before = tel.counter_value("kernel.blocks_skipped_total",
                               kernel="filter_count") or 0
    tops.reset_dispatch_counts()
    assert rc(df, 8192, 8700) == 507
    rep = k.last_prune_report
    assert rep["blocks_skipped"] > 0 and rep["shards"] == 8, rep
    assert (tel.counter_value("kernel.blocks_skipped_total",
                              kernel="filter_count") or 0) > before
    # base ∪ two runs, one launch per shard each (pruned runs launch none)
    assert tops.DISPATCH_COUNTS["filter_count"] % 8 == 0
    text = k.explain(AFrame("m", "Mut", session=k)[
        (df["ts"] >= 8192) & (df["ts"] <= 8700)]._plan)
    assert "8 shards, per-shard 0/0/0/1/0/0/0/0 of 1" in text


def test_sharded_point_lookup_routes_to_owning_shard(mutated_sessions):
    """``get(key)`` on an 8-shard mesh searches only the owning row
    partition's slice of the clustered key copy, newest-wins correct
    against tombstoned and upserted keys; every answer equals the
    meshless session's."""
    sess = mutated_sessions["gspmd"]
    df = AFrame("m", "Mut", session=sess)
    flat = AFrame("m", "Mut", session=mutated_sessions["unsharded"])
    row = df.get(123)                         # base matter, shard 0
    assert int(row["id"][0]) == 123
    ph = sess.last_physical
    assert ph.shards == 8
    assert 1 <= ph.shard_probes < ph.probed * 8, (ph.probed, ph.shard_probes)
    rep = sess.last_prune_report
    assert rep["shards"] == 8 and rep["shard_probes"] >= 1
    assert "shard-routed" in ph.label()
    assert df.get(8200) is None               # run1's tombstone annihilates
    assert "anti-matter" in sess.last_physical.note
    assert int(df.get(8400)["val"][0]) == 7   # upserted matter wins
    assert int(df.get(20_500)["ts"][0]) == 20_500
    assert df.get(10**8) is None              # absent: every span short-circuits
    assert sess.last_physical.probed == 0
    for key in (0, 123, 2499, 2500, 8200, 8300, 8400, 19_999, 20_480, 21_503):
        a, b = df.get(key), flat.get(key)
        assert (a is None) == (b is None), key
        if a is not None:
            for c in b:
                np.testing.assert_array_equal(a[c], b[c])


def test_lookup_between_shard_spans_still_sees_the_tombstone():
    """A key inside a run's key span but between its shards' spans is not
    searched in that run's matter, yet the run's own tombstone for it still
    hides every older occurrence."""
    sess = Session(mesh=make_local_mesh(2, device="cpu"), mode="shard_map")
    sess.create_dataset("T", clustered(4096), dataverse="m", primary="id")
    feed = Feed(sess, "T", "m", flush_rows=10**9,
                policy=lsm.CompactionPolicy(size_ratio=100.0, max_runs=64))
    # one run: matter keys 10 and 4000 (the two shards of the run hold one
    # each after padding), a tombstone for 2000 (base matter)
    feed.push({"id": np.array([10, 4000], np.int32),
               "ts": np.array([10, 4000], np.int32),
               "val": np.array([1, 1], np.int32)})
    feed.delete(np.array([2000], np.int32))
    feed.flush()
    df = AFrame("m", "T", session=sess)
    assert df.get(2000) is None
    assert "anti-matter" in sess.last_physical.note


STRING_BASE, STRING_PUSH = 20_000, 1_024


def _rows_of(n, seed, lo):
    t = wisconsin.generate(n, seed=seed)
    r = {k: v.numpy() for k, v in t.columns.items()}
    r["unique2"] = np.arange(lo, lo + n, dtype=r["unique2"].dtype)
    return r


def _string_session(sess):
    sess.create_dataset("S", wisconsin.generate(STRING_BASE, seed=5),
                        dataverse="s8", primary="unique2")
    feed = Feed(sess, "S", "s8", flush_rows=10**9,
                policy=lsm.CompactionPolicy(size_ratio=10.0, max_runs=64))
    feed.push(_rows_of(STRING_PUSH, 31, STRING_BASE))
    feed.flush()
    feed.upsert(_rows_of(200, 77, 500))
    feed.delete(np.arange(0, 128, dtype=np.int64))
    feed.flush()
    return sess, feed


def _string_probe(sess):
    df = AFrame("s8", "S", session=sess)
    g = df.groupby("string4").agg({"four": "sum"})
    return (len(df[df["string4"] == "OOOOxxxx"]),
            len(df[df["string4"].isin(["AAAAxxxx", "VVVVxxxx", "no"])]),
            tuple(decode_strings(np.asarray(g["string4"]))),
            tuple(np.asarray(g["sum_four"]).tolist()),
            str(np.asarray(g["sum_four"]).dtype))


def test_sharded_string_fastpath_equivalence():
    """String ==/IN/group-by over a fed, mutated, uncompacted dataset on the
    8-shard mesh: equal in all three modes to the meshless session, with
    skipping on and off, and after compaction; a selective equality on a
    clustered string column skips blocks per shard."""
    built = {"unsharded": _string_session(Session(device="cpu",
                                                  enable_index=False))}
    for mode in MODES:
        built[mode] = _string_session(Session(mesh=_mesh(), mode=mode,
                                              enable_index=False))
    want = _string_probe(built["unsharded"][0])
    for label, (sess, _) in built.items():
        try:
            for skip in (True, False):
                sess.enable_block_skip = skip
                assert _string_probe(sess) == want, (label, skip)
        finally:
            sess.enable_block_skip = True
    k = built["kernel"][0]
    n2 = 32_768  # 8 shards x 4096: one zone block per shard
    tags = ["T%02d" % (i // 4096) for i in range(n2)]
    k.create_dataset("CL", Table({"k": torch.arange(n2, dtype=torch.int32),
                                  "tag": encode_strings(tags)}),
                     dataverse="s8", primary="k")
    dfc = AFrame("s8", "CL", session=k)
    assert len(dfc[dfc["tag"] == "T03"]) == 4096
    rep = k.last_prune_report
    assert rep["shards"] == 8 and rep["blocks_skipped"] > 0, rep
    for label, (sess, feed) in built.items():
        feed.compact()
        assert _string_probe(sess) == want, label


# -- the host-side layouts, bit for bit against the reference ----------------


def _layout_tables(n, seed=0):
    rng = np.random.default_rng(seed)
    cols = {"id": np.arange(n, dtype=np.int32),
            "val": rng.integers(-50, 50, n).astype(np.int32),
            "f": np.where(rng.random(n) < 0.05, np.nan,
                          rng.normal(size=n)).astype(np.float32),
            "__valid__": rng.random(n) < 0.95,
            "__antimatter__": rng.random(n) < 0.02}
    return (rtable.Table(cols),
            ttable.Table({k: torch.from_numpy(v.copy()) for k, v in cols.items()}))


@pytest.mark.parametrize("n,s", [(20_000, 1), (20_000, 2), (20_000, 8),
                                 (20_001, 8), (16_384, 4)])
def test_zone_layout_equals_reference(n, s):
    """Per-shard zone maps (sentinel-padded trailing blocks, matter only,
    NaN as dead) and the harvested layout equal the reference's; rows that
    do not split evenly fall back to one shard in both."""
    rt, tt = _layout_tables(n)
    want = rtable.compute_block_zones(rt, 4096, s)
    got = ttable.compute_block_zones(tt, 4096, s)
    assert sorted(got) == sorted(want)
    for c in want:
        assert got[c].dtype == want[c].dtype
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)
    rb, tb = rstats.harvest_block_zones(rt, s), tstats.harvest_block_zones(tt, s)
    assert (tb.block, tb.n_blocks, tb.n_shards, tb.rows_per_shard,
            tb.blocks_per_shard) == (rb.block, rb.n_blocks, rb.n_shards,
                                     rb.rows_per_shard, rb.blocks_per_shard)
    ids = tuple(range(0, rb.n_blocks, 3))
    assert tb.shard_lists(ids) == rb.shard_lists(ids)


@pytest.mark.parametrize("s,bp,rps", [(8, 1, 2500), (2, 3, 10_000),
                                      (4, 2, 4096), (8, 3, 10_000)])
@pytest.mark.parametrize("block", [4096, 2048])
def test_shard_block_arrays_equal_reference(s, bp, rps, block):
    """The per-shard kernel-block matrix: -1 pads at the end of each row,
    width >= 1, an all -1 row for a shard with no survivor."""
    rng = np.random.default_rng(s * bp + block)
    for _ in range(5):
        ids = tuple(sorted(rng.choice(s * bp, size=rng.integers(0, s * bp + 1),
                                      replace=False).tolist()))
        want = rops.shard_block_arrays(ids, 4096, block, s, bp, rps)
        got = tops.shard_block_arrays(ids, 4096, block, s, bp, rps)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    empty = tops.shard_block_arrays((), 4096, block, s, bp, rps)
    assert empty.shape == (s, 1) and (empty == -1).all()


@pytest.mark.parametrize("s", [1, 2, 8])
def test_route_key_equals_reference(s):
    """The point-lookup router: the owning shards' window of the clustered
    key copy, per key, equal to the reference's."""
    n = 20_000
    keys = np.sort(np.random.default_rng(s).choice(60_000, n, replace=False)
                   ).astype(np.int32)
    rt = rtable.Table({"k": keys})
    tt = ttable.Table({"k": torch.from_numpy(keys.copy())})
    rcomp = types.SimpleNamespace(block_zones=rstats.harvest_block_zones(rt, s))
    tcomp = types.SimpleNamespace(block_zones=tstats.harvest_block_zones(tt, s))
    probes = list(keys[::997]) + [-5, 0, 60_000, 1 + int(keys[2500])]
    for key in probes:
        assert tsession._route_key(tcomp, "k", key, n) == \
            rsession._route_key(rcomp, "k", key, n), key
