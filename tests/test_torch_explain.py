"""``explain`` on the port (``repro_torch.core.physical.format_plan``): the
golden texts of tests/test_explain.py — run pruning, retained anti-matter,
the index-only subtraction, ``explain(analyze=True)`` — replayed on the
port, whose texts also equal the reference's line for line (costs
included, measured times scrubbed), in gspmd, shard_map (the reference's
one-device mesh, the port's one-shard mesh) and kernel mode. ``profile``
returns what ``execute`` returns, on 2- and 8-shard port meshes too."""
import re

import numpy as np
import pytest

from test_explain import (GOLDEN_ANALYZE_TABLE, GOLDEN_SCALAR, GOLDEN_TABLE,
                          _normalize, _normalize_analyze)
from torch_replay import PORT, REF, assert_same


def _mutated_fed_session(pk, mode="gspmd", shards=None):
    """Base keys 0..1999, run0 appends 2000..2999, run1 deletes {100, 150}
    and appends 3000..3499 (as tests/test_explain.py)."""
    sess = pk.session(mode, shards=shards)
    k = np.arange(2000, dtype=np.int32)
    sess.create_dataset("Events", pk.Table({"k": k, "v": (k * 2).astype(np.int32)}),
                        dataverse="g", primary="k")
    feed = pk.Feed(sess, "Events", "g", flush_rows=10**9,
                   policy=pk.lsm.CompactionPolicy(size_ratio=100.0, max_runs=64))
    feed.push({"k": np.arange(2000, 3000, dtype=np.int32),
               "v": np.zeros(1000, np.int32)})
    feed.flush()
    feed.delete(np.array([100, 150], np.int32))
    feed.push({"k": np.arange(3000, 3500, dtype=np.int32),
               "v": np.zeros(500, np.int32)})
    feed.flush()
    return sess


def _range(df):
    return df[(df["k"] >= 0) & (df["k"] <= 200)]


@pytest.mark.parametrize("mode", ["gspmd", "shard_map", "kernel"])
def test_explain_goldens_equal_reference(mode):
    texts = {}
    for pk in (REF, PORT):
        sess = _mutated_fed_session(pk, mode)
        df = pk.AFrame("g", "Events", session=sess)
        plan = pk.P.Agg(_range(df)._plan, [pk.P.AggSpec("count", "count", None)])
        texts[pk.name] = (sess.explain(plan), sess.explain(_range(df)._plan),
                          _range(df).explain(), len(_range(df)))
    assert texts["port"] == texts["ref"]
    scalar, table, frame, n = texts["port"]
    if mode == "gspmd":
        assert _normalize(scalar) == GOLDEN_SCALAR
    assert _normalize(table) == GOLDEN_TABLE
    assert frame == table and n == 199


def test_explain_no_mutation_no_subtraction_notes():
    sess = PORT.session()
    k = np.arange(1000, dtype=np.int32)
    sess.create_dataset("Clean", PORT.Table({"k": k, "v": k.copy()}),
                        dataverse="g", primary="k")
    feed = PORT.Feed(sess, "Clean", "g", flush_rows=10**9,
                     policy=PORT.lsm.CompactionPolicy(size_ratio=100.0, max_runs=64))
    feed.push({"k": np.arange(1000, 1500, dtype=np.int32),
               "v": np.zeros(500, np.int32)})
    feed.flush()
    df = PORT.AFrame("g", "Clean", session=sess)
    text = sess.explain(PORT.P.Agg(df[(df["k"] >= 0) & (df["k"] <= 100)]._plan,
                                   [PORT.P.AggSpec("count", "count", None)]))
    assert "anti-matter" not in text and "ShadowProbeCount" not in text
    assert "PRUNED" in text


def test_explain_analyze_golden_table():
    sess = _mutated_fed_session(PORT)
    text = _range(PORT.AFrame("g", "Events", session=sess)).explain(analyze=True)
    assert _normalize_analyze(text) == GOLDEN_ANALYZE_TABLE


@pytest.mark.parametrize("mode", ["gspmd", "shard_map", "kernel"])
def test_explain_analyze_modes(mode):
    """Measured time and actual rows beside the estimates on every operator
    line, in both modes; the scrubbed text equals the reference's."""
    scrub = {}
    for pk in (REF, PORT):
        sess = _mutated_fed_session(pk, mode)
        sel = _range(pk.AFrame("g", "Events", session=sess))
        prof = sel.profile()
        assert len(prof["result"]["k"]) == 199
        op_lines = [l for l in prof["text"].splitlines()
                    if "cost=" in l and "rows≈" in l]
        assert op_lines and all("self=" in l and "total=" in l and "rows=" in l
                                for l in op_lines)
        plan = pk.P.Agg(sel._plan, [pk.P.AggSpec("count", "count", None)])
        sprof = sess.profile(plan)
        assert sprof["result"] == 199 and "rows=1" in sprof["text"]
        assert sess.explain(plan, analyze=True).count("self=") >= 1
        scrub[pk.name] = [re.sub(r"\d+\.\d\dms", "#", t)
                          for t in (prof["text"], sprof["text"])]
    assert scrub["port"] == scrub["ref"]


def test_profile_result_matches_execute():
    sess = _mutated_fed_session(PORT, "kernel")
    sel = _range(PORT.AFrame("g", "Events", session=sess))
    prof = sel.profile()
    assert_same(prof["result"], sess.execute(sel._plan), "profile")
    assert prof["prune_report"]["pruned"] == 2


@pytest.mark.parametrize("shards", [2, 8])
@pytest.mark.parametrize("mode", ["shard_map", "kernel"])
def test_explain_analyze_on_sharded_meshes(mode, shards):
    """On 2- and 8-shard meshes every operator line carries its measured
    fields, the measured rows are exact, and profile returns what execute
    returns; the prune report counts the mesh's shards."""
    sess = _mutated_fed_session(PORT, mode, shards)
    sel = _range(PORT.AFrame("g", "Events", session=sess))
    prof = sel.profile()
    assert "rows=199" in prof["text"]
    op_lines = [l for l in prof["text"].splitlines()
                if "cost=" in l and "rows≈" in l]
    assert op_lines and all("self=" in l and "rows=" in l for l in op_lines)
    assert_same(prof["result"], sess.execute(sel._plan), "profile")
    assert prof["prune_report"]["pruned"] == 2
    assert prof["prune_report"]["shards"] == shards
    plan = PORT.P.Agg(sel._plan, [PORT.P.AggSpec("count", "count", None)])
    assert sess.profile(plan)["result"] == 199
