"""tests/test_block_skip.py replayed on the port (``repro_torch``, every
session on the CPU: kernel mode runs the kernels' plain versions): block-
level zone-map skipping (the second pruning level: run → block), the
point-lookup fast path and the read-amplification cost term. Left out:
the reference's Pallas-backend and interpret-flag tests (the port has no
backend switch: the operand's device picks the kernel), and its
eight-device subprocess scenarios, which
``tests/test_torch_block_skip_sharded.py`` replays on the port's mesh.

The acceptance property: block-skipped results are bit-identical to
unskipped in gspmd, shard_map, and kernel modes — including over mutated,
uncompacted datasets — with the kernel grid (or stream gather) provably
touching fewer blocks on selective predicates over clustered columns.
"""
import numpy as np
import pytest
from repro_torch.launch.mesh import make_local_mesh

from repro_torch.core import physical as PH
from repro_torch.core import plan as P
from repro_torch.core.frame import AFrame
from repro_torch.core.stats import ZONE_BLOCK_ROWS
from repro_torch.engine import lsm
from repro_torch.engine.ingest import Feed
from repro_torch.engine.session import Session
from repro_torch.engine.table import Table
from repro_torch.kernels import ops

N = 20_000  # 5 zone blocks of 4096


def _session(mode, **kw):
    if mode == "shard_map":
        return Session(mesh=make_local_mesh(1, device="cpu"),
                       mode="shard_map", **kw)
    return Session(device="cpu", mode=mode, **kw)


def _clustered_table(n=N, seed=0):
    """id primary (clustered), ts == id (time-ordered), val random — the
    timestamped-event layout block skipping shines on."""
    rng = np.random.default_rng(seed)
    ids = np.arange(n, dtype=np.int32)
    return Table({"id": ids, "ts": ids.copy(),
                  "val": rng.integers(0, 100, n).astype(np.int32)})


def _range_count(df, col, lo, hi):
    return len(df[(df[col] >= lo) & (df[col] <= hi)])


# -- constants stay in lockstep ----------------------------------------------


def test_zone_block_granularity_pinned():
    from repro_torch.kernels.filter_count import BLOCK as FC_BLOCK
    from repro_torch.kernels.segment_agg import BLOCK as SA_BLOCK

    assert ZONE_BLOCK_ROWS == ops.ZONE_BLOCK_ROWS == FC_BLOCK
    assert ZONE_BLOCK_ROWS % SA_BLOCK == 0  # zone blocks expand cleanly


# -- end-to-end equivalence + blocks-touched accounting ----------------------


@pytest.mark.parametrize("mode", ["gspmd", "shard_map", "kernel"])
def test_block_skip_matches_unskipped_and_touches_fewer_blocks(mode):
    sess = _session(mode, enable_index=False)
    sess.create_dataset("Ev", _clustered_table(), dataverse="b", primary="id")
    df = AFrame("b", "Ev", session=sess)
    lo, hi = 8192, 8700  # inside zone block 2 of 5
    n_skip = _range_count(df, "ts", lo, hi)
    rep = sess.last_prune_report
    assert n_skip == hi - lo + 1
    assert rep["blocks_total"] == 5
    assert rep["blocks_scanned"] == 1
    assert rep["blocks_skipped"] == 4
    if mode == "kernel":
        assert isinstance(sess.last_physical, PH.KernelRangeCount)
        assert sess.last_physical.block_ids == (2,)
    sess.enable_block_skip = False
    assert _range_count(df, "ts", lo, hi) == n_skip
    assert sess.last_prune_report["blocks_scanned"] == 5
    sess.enable_block_skip = True
    # a range off every block's span floors at one block and still counts 0
    assert _range_count(df, "ts", 10 * N, 11 * N) == 0
    assert sess.last_prune_report["blocks_scanned"] == 1


def test_block_skip_table_results_identical():
    """Materializing paths (collect/head over a filtered scan) gather only
    surviving blocks — same rows, same order."""
    sess = Session(device="cpu", enable_index=False)
    sess.create_dataset("Ev", _clustered_table(), dataverse="b", primary="id")
    df = AFrame("b", "Ev", session=sess)
    sel = df[(df["ts"] >= 4000) & (df["ts"] <= 4500)]  # straddles blocks 0/1
    got = sel.collect()
    sess.enable_block_skip = False
    want = sel.collect()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(got["ts"]) == 501


def test_groupagg_kernel_grid_hoists_block_list():
    """A filtered group-by on the kernel path hoists the surviving-block
    list into the segment_agg grid (no stream gather) and matches gspmd."""
    t = _clustered_table()
    results = {}
    for mode in ("gspmd", "kernel"):
        sess = Session(device="cpu", mode=mode, enable_index=False)
        sess.create_dataset("Ev", t, dataverse="g", primary="id")
        df = AFrame("g", "Ev", session=sess)
        results[mode] = df[(df["ts"] >= 8192) & (df["ts"] <= 12287)] \
            .groupby("val").agg("count")
        if mode == "kernel":
            assert isinstance(sess.last_physical, PH.KernelSegmentAgg)
            blocks = [b for b in sess.last_physical.comp_blocks
                      if b is not None]
            assert blocks and blocks[0][0] == (2,)
            assert "skipped" in sess.last_physical.note
    for k in results["gspmd"]:
        np.testing.assert_array_equal(
            np.asarray(results["gspmd"][k]), np.asarray(results["kernel"][k]),
            err_msg=k)


def test_block_skip_plan_cache_keyed_by_surviving_blocks():
    """Literals that keep the surviving-block set reuse the executable;
    literals that move to another block rebuild (the block list is static
    plan structure) — and both count correctly."""
    sess = Session(device="cpu", mode="kernel", enable_index=False)
    sess.create_dataset("Ev", _clustered_table(), dataverse="c", primary="id")
    df = AFrame("c", "Ev", session=sess)
    assert _range_count(df, "ts", 100, 200) == 101      # block 0: compile
    c0 = sess.stats["compiles"]
    assert _range_count(df, "ts", 300, 420) == 121      # still block 0: hit
    assert sess.stats["compiles"] == c0
    assert sess.stats["hits"] >= 1
    assert _range_count(df, "ts", 8200, 8300) == 101    # block 2: new variant
    assert sess.stats["compiles"] == c0 + 1


def test_shared_scan_object_keeps_branch_constraints_apart():
    """Derived frames share the base frame's Scan OBJECT: a join of two
    differently-filtered views must not alias both branches' predicates
    onto one scan (the optimizer uniquifies the plan into a tree before
    per-occurrence identity keying). Regression: the merged constraints
    ts<=100 AND ts>=8192 would keep zero blocks and count 0."""
    sess = Session(device="cpu", enable_index=False)
    sess.create_dataset("Ev", _clustered_table(), dataverse="sh",
                        primary="id")
    df = AFrame("sh", "Ev", session=sess)
    left = df[df["ts"] <= 100]
    right = df[df["ts"] >= 8192]
    got = len(left.merge(right, left_on="val", right_on="val"))
    sess.enable_block_skip = False
    want = len(left.merge(right, left_on="val", right_on="val"))
    sess.enable_block_skip = True
    assert got == want > 0

    # run-level pruning rides the same constraint map: over a fed dataset
    # the aliased conjuncts would wrongly prune the right branch's run
    sess2, _ = _mutated_fed("gspmd")
    df2 = AFrame("m", "Mut", session=sess2)
    l2 = df2[df2["ts"] <= 100]
    r2 = df2[df2["ts"] >= 20_480]
    got2 = len(l2.merge(r2, left_on="val", right_on="val"))
    sess2.enable_prune = False
    want2 = len(l2.merge(r2, left_on="val", right_on="val"))
    sess2.enable_prune = True
    assert got2 == want2 > 0


def test_no_block_skip_through_positional_operators():
    """A Limit or Window between the filter and the scan consumes rows
    positionally — the outer filter's conjuncts must NOT block-gather the
    scan (regression for the constraint-descent rule)."""
    sess = Session(device="cpu", enable_index=False)
    sess.create_dataset("Ev", _clustered_table(), dataverse="pos",
                        primary="id")
    df = AFrame("pos", "Ev", session=sess)
    cond = (df["ts"] >= 8192).expr

    # Filter(Limit(Scan)): the first 10 rows all have ts < 8192 — skipping
    # to block 2 would wrongly let 10 high-ts rows through
    out = sess.execute(P.Filter(P.Limit(P.Scan("Ev", "pos"), 10), cond))
    assert len(out["ts"]) == 0

    # Filter(Window(Scan)) cumsum: window state accumulates over ALL rows
    # before the filter — gathered blocks would restart the running sum
    wf = df.window(order_by="id").cumsum("val")
    filtered = AFrame._from_plan(wf, P.Filter(wf._plan, cond))
    got = filtered.collect()
    sess.enable_block_skip = False
    want = filtered.collect()
    sess.enable_block_skip = True
    np.testing.assert_array_equal(got["cumsum_val"], want["cumsum_val"])
    assert got["cumsum_val"][0] > 0  # the pre-8192 prefix contributed


# -- mutated, uncompacted datasets -------------------------------------------


def _mutated_fed(mode, **kw):
    """Base keys 0..19999 (clustered); run0 appends 20480..21503; run1
    deletes two keys inside block 2 and upserts one. Tombstones live in
    newer runs whose matter spans never overlap the queried block."""
    sess = _session(mode, enable_index=False, **kw)
    sess.create_dataset("Mut", _clustered_table(), dataverse="m",
                        primary="id")
    feed = Feed(sess, "Mut", "m", flush_rows=10**9,
                policy=lsm.CompactionPolicy(size_ratio=100.0, max_runs=64))
    ids = np.arange(20_480, 21_504, dtype=np.int32)
    feed.push({"id": ids, "ts": ids.copy(),
               "val": np.zeros(len(ids), np.int32)})
    feed.flush()
    feed.delete(np.array([8200, 8300], np.int32))
    feed.upsert({"id": np.array([8400], np.int32),
                 "ts": np.array([8400], np.int32),
                 "val": np.array([7], np.int32)})
    feed.flush()
    return sess, feed


@pytest.mark.parametrize("mode", ["gspmd", "shard_map", "kernel"])
def test_block_skip_mutation_safe_and_tombstones_retained(mode):
    """Skipped blocks in pruned components still contribute tombstones: the
    queried block's matter must shrink by the two deletes (and keep the
    upserted key exactly once), with every other block skipped."""
    sess, feed = _mutated_fed(mode)
    df = AFrame("m", "Mut", session=sess)
    lo, hi = 8192, 8700
    want = (hi - lo + 1) - 2  # two deletes; the upsert replaces, not adds
    got = _range_count(df, "ts", lo, hi)
    assert got == want, (mode, got, want)
    rep = sess.last_prune_report
    assert rep["blocks_skipped"] > 0
    sess.enable_block_skip = False
    assert _range_count(df, "ts", lo, hi) == want
    sess.enable_block_skip = True
    feed.compact()
    assert _range_count(df, "ts", lo, hi) == want  # LSM invariant holds


# -- hypothesis: skipped ≡ unskipped, all modes, mutated + compacted ---------


@pytest.fixture(scope="module")
def property_sessions():
    out = {}
    for mode in ("gspmd", "shard_map", "kernel"):
        sess, feed = _mutated_fed(mode)
        out[mode] = sess
    compacted, feed_c = _mutated_fed("gspmd")
    feed_c.compact()
    out["compacted"] = compacted
    # newest-wins oracle over the final key set
    alive = set(range(N)) | set(range(20_480, 21_504))
    alive -= {8200, 8300}
    out["oracle_keys"] = np.array(sorted(alive))
    return out


def test_block_skip_equivalence_property(property_sessions):
    hypothesis = pytest.importorskip("hypothesis")
    given, settings = hypothesis.given, hypothesis.settings
    st = hypothesis.strategies

    @settings(deadline=None, max_examples=12)
    @given(st.integers(0, 22_000), st.integers(0, 3_000))
    def check(lo, width):
        hi = lo + width
        keys = property_sessions["oracle_keys"]
        want = int(((keys >= lo) & (keys <= hi)).sum())
        for label in ("gspmd", "shard_map", "kernel", "compacted"):
            sess = property_sessions[label]
            df = AFrame("m", "Mut", session=sess)
            try:
                for skip in (True, False):
                    sess.enable_block_skip = skip
                    got = _range_count(df, "ts", lo, hi)
                    assert got == want, (label, skip, lo, hi, got, want)
            finally:
                sess.enable_block_skip = True

    check()


# -- explain golden -----------------------------------------------------------


def _normalize(text):
    import re

    text = re.sub(r"\[cost=[^\]]*\]", "[cost]", text)
    text = re.sub(r"cost=[\d,]+", "cost=#", text)
    text = re.sub(r"total estimated cost: [\d,]+", "total estimated cost: #",
                  text)
    return text


GOLDEN_BLOCK_SKIP = """\
KernelRangeCount e.Ev [ts, ts] [filter_count kernel] [blocks 1/5]  [cost]
· zone maps: 1/5 block(s) scanned, 4 skipped — chosen over MaskCount cost=#
total estimated cost: #"""


def test_explain_golden_block_skip_rationale():
    sess = Session(device="cpu", mode="kernel", enable_index=False)
    sess.create_dataset("Ev", _clustered_table(), dataverse="e", primary="id")
    df = AFrame("e", "Ev", session=sess)
    plan = P.Agg(df[(df["ts"] >= 8192) & (df["ts"] <= 8700)]._plan,
                 [P.AggSpec("count", "count", None)])
    assert _normalize(sess.explain(plan)) == GOLDEN_BLOCK_SKIP
    # and the generic stream path renders the same rationale on its scan
    sess2 = Session(device="cpu", mode="gspmd", enable_index=False)
    sess2.create_dataset("Ev", _clustered_table(), dataverse="e",
                         primary="id")
    df2 = AFrame("e", "Ev", session=sess2)
    text = sess2.explain(P.Agg(
        df2[(df2["ts"] >= 8192) & (df2["ts"] <= 8700)]._plan,
        [P.AggSpec("count", "count", None)]))
    assert "[blocks 1/5]" in text
    assert "zone maps: 1/5 block(s) scanned, 4 skipped" in text


# -- point-lookup fast path ---------------------------------------------------


def test_point_lookup_newest_wins_anti_matter_aware():
    sess, feed = _mutated_fed("gspmd")
    df = AFrame("m", "Mut", session=sess)
    compiles = sess.stats["compiles"]

    row = df.get(123)                      # base matter
    assert row["val"].shape == (1,) and int(row["id"][0]) == 123
    assert isinstance(sess.last_physical, PH.PointLookup)

    assert df.get(8200) is None            # deleted by run1's tombstone
    assert "anti-matter" in sess.last_physical.note

    row = df.get(8400)                     # upserted: run1's matter wins
    assert int(row["val"][0]) == 7 and row["val"].shape == (1,)

    row = df.get(20_500)                   # run0 matter
    assert int(row["ts"][0]) == 20_500

    assert df.get(10**8) is None           # absent everywhere
    assert sess.last_physical.probed == 0  # every span short-circuited

    assert sess.stats["compiles"] == compiles  # never touched the query path
    text = df.explain_get(8400)
    assert "PointLookup" in text and "newest-wins" in text
    # after compaction the same lookups resolve from the folded base
    feed.compact()
    assert df.get(8200) is None
    assert int(df.get(8400)["val"][0]) == 7


def test_point_lookup_requires_primary_and_bare_frame():
    sess = Session(device="cpu")
    t = _clustered_table(1000)
    sess.create_dataset("NoPk", t, dataverse="p")
    df = AFrame("p", "NoPk", session=sess)
    with pytest.raises(ValueError, match="primary"):
        df.get(5)
    sess.create_dataset("Pk", t, dataverse="p", primary="id")
    df2 = AFrame("p", "Pk", session=sess)
    with pytest.raises(ValueError, match="point lookup"):
        df2[df2["val"] >= 0].get(5)


# -- float zone maps ----------------------------------------------------------


def test_float_zone_maps_nan_safe_with_empty_sentinel():
    """Float columns harvest NaN-safe per-block spans; all-NaN (and pad)
    blocks carry the [+inf, -inf] empty sentinel, so they fail every
    predicate test and are always skipped."""
    from repro_torch.core.stats import harvest_block_zones

    n = 2 * ZONE_BLOCK_ROWS + 100  # trailing partial block
    ids = np.arange(n, dtype=np.int32)
    fts = ids.astype(np.float32)
    fts[0] = np.nan                          # dead row must not widen block 0
    fts[ZONE_BLOCK_ROWS:2 * ZONE_BLOCK_ROWS] = np.nan  # block 1 all dead
    bz = harvest_block_zones(Table({"id": ids, "fts": fts}))
    sp = np.asarray(bz.span_of("fts"))
    assert sp.shape == (3, 2)
    assert not np.isnan(sp).any()
    assert sp[0, 0] == 1.0 and sp[0, 1] == float(ZONE_BLOCK_ROWS - 1)
    assert sp[1, 0] == np.inf and sp[1, 1] == -np.inf  # empty sentinel
    assert sp[2, 0] == float(2 * ZONE_BLOCK_ROWS)
    assert sp[2, 1] == float(n - 1)


@pytest.mark.parametrize("mode", ["gspmd", "shard_map"])
def test_float_block_skip_matches_unskipped(mode):
    """A range predicate over a clustered FLOAT column prunes blocks off the
    float zone maps and stays bit-identical to the unskipped scan — NaN rows
    simply never match."""
    rng = np.random.default_rng(9)
    ids = np.arange(N, dtype=np.int32)
    fts = ids.astype(np.float32)
    fts[7] = np.nan  # a dead row inside block 0
    t = Table({"id": ids, "fts": fts,
               "val": rng.integers(0, 100, N).astype(np.int32)})
    sess = _session(mode, enable_index=False)
    sess.create_dataset("Ev", t, dataverse="f", primary="id")
    df = AFrame("f", "Ev", session=sess)
    got = _range_count(df, "fts", 8192.0, 8700.0)
    rep = sess.last_prune_report
    assert got == 509
    assert rep["blocks_scanned"] == 1 and rep["blocks_skipped"] == 4
    sess.enable_block_skip = False
    assert _range_count(df, "fts", 8192.0, 8700.0) == got
    sess.enable_block_skip = True
    # the NaN row is invisible to every range — including one over block 0
