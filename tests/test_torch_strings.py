"""The string fast path on the port: the scenarios of tests/test_strings.py
replayed on both packages in one process — the same numpy-seeded inputs,
gspmd, shard_map (the reference's one-device mesh, the port's one-shard
mesh) and kernel mode, the port on ``device="cpu"`` (kernel mode runs each
kernel's plain version there).

String ``==`` lowers onto ``KernelRangeCount`` over the ``__dict_<col>``
id lane, ``IN`` onto a ``MergeScalars`` of one ``KernelRangeCount`` per
member, and a string group-by onto ``KernelSegmentAgg`` over union-
dictionary ids (``DictRemapCols`` below the union concat). Results are held
bit for bit, dtypes included, against the reference and a numpy oracle;
plans, fingerprints, explain texts, prune reports, compile / hit counts and
``filter_count`` / ``segment_agg`` dispatch counts equal the reference's,
uncompacted, after a run merge and after compaction. On an 8-shard port
mesh the same suite equals the numpy oracle and the meshless session."""
import numpy as np
import pytest

from torch_replay import PORT, REF, assert_same, counts, host_rows

MODES = ("gspmd", "shard_map", "kernel")
BASE = 2000
PUSH = 600
_STR4 = ["AAAAxxxx", "HHHHxxxx", "OOOOxxxx", "VVVVxxxx"]


def _deferred(pk):
    return pk.lsm.CompactionPolicy(size_ratio=10.0, max_runs=64)


def _enc(values):
    """Encoded (n, 16) uint8 rows as numpy, the same bytes in both packages."""
    return np.asarray(REF.table.encode_strings(values))


def _kernel_counts(pk):
    return tuple(pk.ops.DISPATCH_COUNTS.get(k, 0)
                 for k in ("filter_count", "segment_agg"))


def _planned_launches(pk, phys) -> tuple:
    """The kernel launches a physical plan makes per run: one filter_count
    per KernelRangeCount; per KernelSegmentAgg component one segment_agg for
    the sum family and one per extreme family."""
    fc = sa = 0
    for n in pk.PH.walk(phys):
        if isinstance(n, pk.PH.KernelRangeCount):
            fc += 1
        elif isinstance(n, pk.PH.KernelSegmentAgg):
            ops = {s.op for s in n.aggs}
            families = 1 + len(ops & {"max", "min"})
            sa += len(n.children) * families
    return fc, sa


def _run(pk, sess, query, log):
    """Run one query; log its plan fingerprint, the kernel dispatches it
    counted and the launches its plan implies."""
    pk.ops.reset_dispatch_counts()
    out = query()
    log.append((sess.last_physical.fingerprint(),
                (_kernel_counts(pk), _planned_launches(pk, sess.last_physical))))
    return out


def _dispatched(log) -> tuple:
    return tuple(map(sum, zip(*(made for _, (made, _) in log))))


def _check_log(port_log, ref_log, label):
    """Equal plans, and the port launched exactly what each plan implies."""
    assert [fp for fp, _ in port_log] == [fp for fp, _ in ref_log], label
    for _, (made, planned) in port_log:
        assert made == planned, (label, made, planned)


def _plan_facts(pk, sess):
    """What the planner chose: fingerprint, explain text and prune report."""
    phys = sess.last_physical
    return phys.fingerprint(), pk.PH.format_plan(phys), sess.last_prune_report


# -- lane unit tests ----------------------------------------------------------


def test_pack_prefix_order_preserving_int32():
    vals = ["", "A", "AAAA", "AAAAzzzz", "HHHH", "ZZZZZZZZ", "aaaa", "zzzz"]
    got = PORT.table.pack_prefix(PORT.table.encode_strings(vals)).numpy()
    want = REF.table.pack_prefix(REF.table.encode_strings(vals))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).all()
    order = np.argsort(got, kind="stable")
    assert [vals[i] for i in order] == sorted(vals, key=lambda s: s.ljust(4))


def test_lanes_materialize_and_stay_hidden():
    out = {}
    for pk in (REF, PORT):
        sess = pk.session()
        sess.create_dataset("W", pk.wisconsin.generate(512, seed=0),
                            dataverse="lane", primary="unique2")
        ds = sess.catalog.get("lane", "W")
        df = pk.AFrame("lane", "W", session=sess)
        out[pk.name] = (ds.table.column_names(),
                        ds.table.meta["string4"].dict_values,
                        df._current_columns(), df.head(4))
    names, dict_values, visible, head = out["port"]
    assert names == out["ref"][0]
    assert "__pfx_string4" in names and "__dict_string4" in names
    assert "__dict_stringu1" not in names    # 512 distinct > 256
    assert dict_values == out["ref"][1] == tuple(_STR4)
    assert visible == out["ref"][2]
    assert not any(c.startswith("__") for c in visible + list(head))
    assert_same(head, out["ref"][3], "head")


# -- the acceptance property --------------------------------------------------


def _push_rows(pk, n, seed, key_lo):
    rows = host_rows(pk.wisconsin.generate(n, seed=seed))
    rows["unique2"] = np.arange(key_lo, key_lo + n,
                                dtype=rows["unique2"].dtype)
    return rows


def _build(pk, mode, shards=None):
    """Base + two pushed runs + an upsert run + a delete: the uncompacted
    tree holds anti-matter and per-run dictionaries built independently."""
    sess = pk.session(mode, shards=shards)
    sess.create_dataset("Live", pk.wisconsin.generate(BASE, seed=3),
                        dataverse="s", primary="unique2")
    feed = pk.Feed(sess, "Live", "s", flush_rows=PUSH, policy=_deferred(pk))
    for i in range(2):
        feed.push(_push_rows(pk, PUSH, 20 + i, BASE + i * PUSH))
    feed.upsert(_push_rows(pk, 100, 99, 100))
    feed.delete(np.arange(0, 50, dtype=np.int64))
    feed.flush()
    return sess, feed


def _oracle():
    """numpy replay of _build's visible rows: (string4 values, four)."""
    rows = {}

    def absorb(t_rows):
        s4 = REF.table.decode_strings(t_rows["string4"])
        for i, k in enumerate(t_rows["unique2"].tolist()):
            rows[k] = (s4[i], int(t_rows["four"][i]))

    absorb(host_rows(REF.wisconsin.generate(BASE, seed=3)))
    for i in range(2):
        absorb(_push_rows(REF, PUSH, 20 + i, BASE + i * PUSH))
    absorb(_push_rows(REF, 100, 99, 100))
    for k in range(50):
        rows.pop(k, None)
    vals = np.array([v for v, _ in rows.values()])
    fours = np.array([f for _, f in rows.values()])
    return vals, fours


def _suite(pk, sess, lit, members, log):
    df = pk.AFrame("s", "Live", session=sess)
    queries = {
        "eq": lambda: len(df[df["string4"] == lit]),
        "eq_miss": lambda: len(df[df["string4"] == "ZZZZnope"]),
        "isin": lambda: len(df[df["string4"].isin(members)]),
        "group": lambda: df.groupby("string4").agg({"four": "sum"}),
        "group_count": lambda: df.groupby("string4").agg("count"),
    }
    return {k: _run(pk, sess, q, log) for k, q in queries.items()}


def _assert_suites(got, want, label):
    for k in want:
        assert_same(got[k], want[k], f"{label}:{k}")


@pytest.mark.parametrize("mode", MODES)
def test_string_fastpath_mutated_equivalence_property(mode):
    """Over a fed, mutated, uncompacted dataset: string ``==``, ``IN`` and
    group-by equal the reference and the numpy oracle bit for bit with the
    reference's compile / hit / launch counts, for the reference's literal
    sweep; then a run merge (dictionary-id remap) and a compaction move no
    result, and the merged dictionary is the reference's."""
    from hypothesis import given, settings, strategies as st

    vals, fours = _oracle()
    keys = sorted(set(vals))
    built = {pk.name: _build(pk, mode) for pk in (REF, PORT)}
    # the reference counts a kernel dispatch when it traces a plan shape,
    # the port at every launch: equal on a first run; later runs are held to
    # the launches their plans imply (``_check_log``)
    first = {}
    for pk in (REF, PORT):
        log = []
        _suite(pk, built[pk.name][0], _STR4[0], _STR4[:1], log)
        first[pk.name] = _dispatched(log)
    assert first["port"] == first["ref"]
    # kernel mode: == over the four components, the absent literal over the
    # one left after run pruning, the one IN member over four; one
    # segment_agg per component and group-by
    assert first["port"] == ((9, 8) if mode == "kernel" else (0, 0))

    def check_one(li, mi):
        lit = (_STR4 + ["ZZZZnope"])[li]
        members = [m for j, m in enumerate(_STR4 + ["QQQQnope"])
                   if (mi >> j) & 1]
        outs, logs = {}, {}
        for pk in (REF, PORT):
            sess = built[pk.name][0]
            logs[pk.name] = []
            outs[pk.name] = (_suite(pk, sess, lit, members, logs[pk.name]),
                             counts(sess))
        got = outs["port"][0]
        assert got["eq"] == int((vals == lit).sum()), lit
        assert got["eq_miss"] == 0
        assert got["isin"] == int(np.isin(vals, members).sum()), members
        for k, col, want in (
                ("group", "sum_four", [fours[vals == g].sum() for g in keys]),
                ("group_count", "count", [(vals == g).sum() for g in keys])):
            assert PORT.table.decode_strings(got[k]["string4"]) == keys
            np.testing.assert_array_equal(got[k][col].astype(np.int64), want)
        _assert_suites(got, outs["ref"][0], f"{mode}:{lit}:{members}")
        assert outs["port"][1] == outs["ref"][1], (lit, members)
        _check_log(logs["port"], logs["ref"], (lit, members))

    @settings(deadline=None, max_examples=10, database=None)
    @given(st.integers(0, 4), st.integers(0, 31))
    def check(li, mi):
        check_one(li, mi)

    check()

    steps, logs = {}, {}
    for pk in (REF, PORT):
        sess, feed = built[pk.name]
        log = logs[pk.name] = []
        before = _suite(pk, sess, _STR4[1], _STR4[:2], log)
        ds = sess.catalog.get("s", "Live")
        assert len(ds.manifest.runs) >= 2
        pk.lsm.merge_runs(sess, ds, 0, 2, level=1)
        merged_dict = sess.catalog.get("s", "Live").manifest.runs[0] \
            .table.meta["string4"].dict_values
        merged = _suite(pk, sess, _STR4[1], _STR4[:2], log)
        feed.compact()
        steps[pk.name] = (before, merged,
                          _suite(pk, sess, _STR4[1], _STR4[:2], log),
                          merged_dict, counts(sess))
    _check_log(logs["port"], logs["ref"], "merge and compaction")
    for i, label in enumerate(("before", "merged", "compacted")):
        _assert_suites(steps["port"][i], steps["ref"][i], f"{mode}:{label}")
        _assert_suites(steps["port"][i], steps["port"][0], f"{mode}:{label}")
    assert steps["port"][3:] == steps["ref"][3:]


@pytest.mark.parametrize("mode", ["shard_map", "kernel"])
def test_string_fastpath_on_an_8_shard_mesh(mode):
    """The mutated equivalence on an 8-shard port mesh: string ``==``,
    ``IN`` and group-by equal the numpy oracle and the meshless session
    (uncompacted, after a run merge, after compaction), with one launch
    per shard where kernel mode launches."""
    vals, fours = _oracle()
    keys = sorted(set(vals))
    built = {"mesh": _build(PORT, mode, shards=8),
             "flat": _build(PORT, "gspmd")}
    for li, mi in ((0, 1), (1, 3), (2, 0), (3, 31), (4, 21), (0, 16)):
        lit = (_STR4 + ["ZZZZnope"])[li]
        members = [m for j, m in enumerate(_STR4 + ["QQQQnope"])
                   if (mi >> j) & 1]
        log = []
        got = _suite(PORT, built["mesh"][0], lit, members, log)
        want = _suite(PORT, built["flat"][0], lit, members, [])
        assert got["eq"] == int((vals == lit).sum()), lit
        assert got["isin"] == int(np.isin(vals, members).sum()), members
        np.testing.assert_array_equal(
            got["group"]["sum_four"].astype(np.int64),
            [fours[vals == g].sum() for g in keys])
        _assert_suites(got, want, f"8 shards:{lit}:{members}")
        for _, (made, planned) in log:
            assert made == tuple(8 * p for p in planned), (made, planned)
    steps = {}
    for name, (sess, feed) in built.items():
        ds = sess.catalog.get("s", "Live")
        PORT.lsm.merge_runs(sess, ds, 0, 2, level=1)
        merged = _suite(PORT, sess, _STR4[1], _STR4[:2], [])
        feed.compact()
        steps[name] = (merged, _suite(PORT, sess, _STR4[1], _STR4[:2], []))
    for i in range(2):
        _assert_suites(steps["mesh"][i], steps["flat"][i], f"8 shards:{i}")


def test_dict_remap_across_merge_disjoint_dictionaries():
    """Two runs with DISJOINT value sets: the merged run's dictionary is the
    sorted union and both runs' local ids are remapped — equality counts and
    group-bys stay exact through merge and compaction, as the reference's."""
    out, logs = {}, {}
    for pk in (REF, PORT):
        sess = pk.session("kernel")
        base = pk.Table({"k": np.arange(256, dtype=np.int32),
                         "tag": _enc(["mm"] * 256),
                         "v": np.ones(256, np.int32)})
        sess.create_dataset("T", base, dataverse="rm", primary="k")
        feed = pk.Feed(sess, "T", "rm", flush_rows=10**9, policy=_deferred(pk))
        for lo, tags in ((1000, ["aa", "bb"]), (2000, ["yy", "zz"])):
            feed.push({"k": np.arange(lo, lo + 128, dtype=np.int32),
                       "tag": _enc(tags * 64), "v": np.full(128, 2, np.int32)})
            feed.flush()
        df = pk.AFrame("rm", "T", session=sess)
        log = logs[pk.name] = []

        def probe():
            return tuple(_run(pk, sess, q, log) for q in (
                lambda: len(df[df["tag"] == "bb"]),
                lambda: len(df[df["tag"] == "mm"]),
                lambda: len(df[df["tag"].isin(["aa", "zz", "nope"])]),
                lambda: df.groupby("tag").agg({"v": "sum"})))

        want = probe()
        ds = sess.catalog.get("rm", "T")
        pk.lsm.merge_runs(sess, ds, 0, 2, level=1)
        merged = sess.catalog.get("rm", "T").manifest.runs[0]
        md = merged.table.meta["tag"].dict_values
        after_merge = probe()
        feed.compact()
        out[pk.name] = (want, md, after_merge, probe(), counts(sess))
    want, md = out["port"][:2]
    assert want[:3] == (64, 256, 128)
    assert md == out["ref"][1] == ("aa", "bb", "yy", "zz")
    for i in (0, 2, 3):
        for j in range(4):
            assert_same(out["port"][i][j], out["ref"][i][j], f"probe{i}:{j}")
            assert_same(out["port"][i][j], want[j], f"stable{i}:{j}")
    assert out["port"][4] == out["ref"][4]
    _check_log(logs["port"], logs["ref"], "disjoint dictionaries")
    assert _dispatched(logs["port"][:4]) == _dispatched(logs["ref"][:4])


@pytest.mark.parametrize("mode", MODES)
def test_non_canonical_literal_spellings_bind_same_dict_id(mode):
    """A trailing-space literal binds the same dict id as its stripped
    spelling; two IN members that canonicalize alike count once."""
    n = 4 * 4096
    t = {"k": np.arange(n, dtype=np.int32),
         "string4": _enc([_STR4[i // 4096] for i in range(n)])}
    padded = _STR4[2] + "        "
    out = {}
    for pk in (REF, PORT):
        sess = pk.session(mode)
        sess.create_dataset("P", pk.Table(t), dataverse="pad", closed=True)
        df = pk.AFrame("pad", "P", session=sess)
        pk.ops.reset_dispatch_counts()
        eq = len(df[df["string4"] == padded])
        eq_facts = _plan_facts(pk, sess)
        dup = len(df[df["string4"].isin([padded, _STR4[2], _STR4[0]])])
        out[pk.name] = (eq, dup, eq_facts, _plan_facts(pk, sess),
                        _kernel_counts(pk), counts(sess))
    assert out["port"][:2] == (4096, 2 * 4096)
    assert out["port"] == out["ref"]
    if mode == "kernel":
        assert "KernelRangeCount" in out["port"][2][1]
        assert "__dict_string4" in out["port"][3][1]


# -- kernel lowering + pruning ------------------------------------------------


def _clustered(pk, tags, dataverse):
    n = len(tags)
    sess = pk.session("kernel", enable_index=False)
    sess.create_dataset("C", pk.Table({"k": np.arange(n, dtype=np.int32),
                                       "tag": _enc(tags),
                                       "v": np.ones(n, np.int32)}),
                        dataverse=dataverse, primary="k")
    return sess, pk.AFrame(dataverse, "C", session=sess)


def test_string_eq_lowers_onto_filter_count_with_block_skip():
    """A selective string ``==`` on a clustered column takes the dict lane
    (KernelRangeCount, one filter_count launch) and its zone map skips the
    all-"AA" block; an absent literal binds the empty range and the
    min-one-block guard still scans one block — as the reference."""
    out = {}
    for pk in (REF, PORT):
        sess, df = _clustered(pk, ["AA"] * 4096 + ["ZZ"] * 4096, "bs")
        pk.ops.reset_dispatch_counts()
        hit = len(df[df["tag"] == "ZZ"])
        hit_facts = (_plan_facts(pk, sess), _kernel_counts(pk))
        miss = len(df[df["tag"] == "QQ"])
        out[pk.name] = (hit, miss, hit_facts, _plan_facts(pk, sess),
                        _kernel_counts(pk), counts(sess))
    assert out["port"][:2] == (4096, 0)
    (fp, text, rep), launches = out["port"][2]
    assert "KernelRangeCount" in text and "__dict_tag" in text
    assert launches == (1, 0) and rep["blocks_skipped"] == 1
    assert out["port"][3][2]["blocks_scanned"] == 1
    assert out["port"] == out["ref"]


def test_string_isin_lowers_as_merged_rangecounts():
    """IN over a clustered dict-encoded column: one KernelRangeCount per
    member, each over its own block list (the absent member binds the empty
    range and keeps one block), partial counts summed — as the reference."""
    out = {}
    for pk in (REF, PORT):
        sess, df = _clustered(pk, ["AA"] * 4096 + ["MM"] * 4096
                              + ["ZZ"] * 4096, "ki")
        pk.ops.reset_dispatch_counts()
        got = len(df[df["tag"].isin(["AA", "ZZ", "missing!"])])
        ms = [n for n in pk.PH.walk(sess.last_physical)
              if isinstance(n, pk.PH.MergeScalars)]
        out[pk.name] = (got, _plan_facts(pk, sess), _kernel_counts(pk),
                        [c.block_ids for c in ms[0].children], counts(sess))
    got, (_, text, rep), launches, member_blocks, _ = out["port"]
    assert got == 8192 and launches == (3, 0)
    assert member_blocks == [(0,), (2,), (0,)]
    assert rep["blocks_skipped"] > 0 and "3 filter_count launch(es)" in text
    assert out["port"] == out["ref"]


def test_string_isin_rebind_replans_member_grids():
    """A rebind with other members must not reuse another binding's
    per-member block grids: the port computes each member's block list from
    the bound values at bind time (``Pruner.decide``), so the lists are in
    the prune signature and every binding counts exactly. The reference
    plans the lists from the cached plan's FIRST literals and reuses their
    grids, so its ``["MM", "ZZ", ...]`` after ``["AA", "ZZ", ...]`` counts
    MM only in AA's block (ROADMAP, reference caveats)."""
    tags = ["AA"] * 4096 + ["MM"] * 4096 + ["ZZ"] * 4096
    host = np.array(tags)
    bindings = (["AA", "ZZ", "missing!"], ["MM", "ZZ", "missing!"],
                ["ZZ", "AA", "nope"], ["AA", "ZZ", "missing!"],
                ["ZZ", "ZZ", "AA"], ["MM", "AA", "ZZ"])
    out = {}
    for pk in (REF, PORT):
        sess, df = _clustered(pk, tags, "kr")
        steps = []
        for members in bindings:
            pk.ops.reset_dispatch_counts()
            got = len(df[df["tag"].isin(members)])
            ms = [n for n in pk.PH.walk(sess.last_physical)
                  if isinstance(n, pk.PH.MergeScalars)]
            steps.append((got, [c.block_ids for c in ms[0].children]))
        out[pk.name] = steps
    want = [int(np.isin(host, m).sum()) for m in bindings]
    assert [g for g, _ in out["port"]] == want
    assert [b for _, b in out["port"]] == [
        [(0,), (2,), (0,)], [(1,), (2,), (0,)], [(2,), (0,), (0,)],
        [(0,), (2,), (0,)], [(2,), (0,), (0,)], [(1,), (0,), (2,)]]
    assert out["port"][0] == out["ref"][0]
    assert out["ref"][1][0] == 4096 != want[1]  # the reference's stale grid


def test_string_groupby_lowers_onto_segment_agg():
    out = {}
    for pk in (REF, PORT):
        sess = pk.session("kernel")
        sess.create_dataset("W", pk.wisconsin.generate(2048, seed=7),
                            dataverse="kg", primary="unique2")
        df = pk.AFrame("kg", "W", session=sess)
        pk.ops.reset_dispatch_counts()
        res = df.groupby("string4").agg({"four": "sum"})
        segs = [n for n in pk.PH.walk(sess.last_physical)
                if isinstance(n, pk.PH.KernelSegmentAgg)]
        out[pk.name] = (res, _kernel_counts(pk), segs[0].key_values,
                        _plan_facts(pk, sess))
    assert_same(out["port"][0], out["ref"][0], "group")
    assert PORT.table.decode_strings(out["port"][0]["string4"]) == _STR4
    assert out["port"][1] == (0, 1)
    assert out["port"][2] == out["ref"][2] == tuple(_STR4)
    assert out["port"][3] == out["ref"][3]
    assert "DictRemap string4 via __dict_string4" in out["port"][3][1]


def test_string_selectivity_estimates_from_dictionary():
    """explain() renders the bound dict id beside the literal (``id 1/4``)
    and estimates n/4 rows, as the reference; IN counts exactly."""
    n = 4096
    out = {}
    for pk in (REF, PORT):
        sess = pk.session("kernel", enable_index=False)
        sess.create_dataset("W", pk.wisconsin.generate(n, seed=1),
                            dataverse="sel", primary="unique2")
        df = pk.AFrame("sel", "W", session=sess)
        plan = pk.P.Agg(df[df["string4"] == "HHHHxxxx"]._plan,
                        [pk.P.AggSpec("count", "count", None)])
        text = sess.explain(plan)
        eq = sess.execute(plan)
        krc = [nd for nd in pk.PH.walk(sess.last_physical)
               if isinstance(nd, pk.PH.KernelRangeCount)]
        plan2 = pk.P.Agg(df[df["string4"].isin(_STR4[:2])]._plan,
                         [pk.P.AggSpec("count", "count", None)])
        out[pk.name] = (text, eq, krc[0].est_rows, sess.execute(plan2),
                        counts(sess))
    text, eq, est, isin = out["port"][:4]
    assert "string4 == 'HHHHxxxx'" in text and "id 1/4" in text
    assert eq == n // 4 and abs(est - n / 4) <= n / 16 and isin == n // 2
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("mode", MODES)
def test_high_cardinality_prefix_pruning(mode):
    """A column past DICT_THRESHOLD gets no dict lane; its prefix lane still
    prunes the run whose prefix span excludes the literal."""
    assert PORT.table.DICT_THRESHOLD == REF.table.DICT_THRESHOLD == 256

    def mk(lo, pre):
        return {"k": np.arange(lo, lo + 512, dtype=np.int32),
                "name": _enc([f"{pre}{i:05d}" for i in range(512)])}

    out = {}
    for pk in (REF, PORT):
        sess = pk.session(mode, enable_index=False)
        sess.create_dataset("H", pk.Table(mk(0, "alpha")), dataverse="pp",
                            primary="k")
        feed = pk.Feed(sess, "H", "pp", flush_rows=10**9, policy=_deferred(pk))
        feed.push(mk(5000, "omega"))
        feed.flush()
        names = sess.catalog.get("pp", "H").table.column_names()
        df = pk.AFrame("pp", "H", session=sess)
        hit = len(df[df["name"] == "omega00007"])
        recs = [pc.column for nd in pk.PH.walk(sess.last_physical)
                for pc in (getattr(nd, "pruned", None) or ())]
        facts = _plan_facts(pk, sess)
        out[pk.name] = (names, hit, recs, facts,
                        len(df[df["name"] == "zzzzz"]), counts(sess))
    assert "__dict_name" not in out["port"][0]
    assert out["port"][1] == 1 and "__pfx_name" in out["port"][2]
    assert out["port"][4] == 0
    assert out["port"] == out["ref"]
