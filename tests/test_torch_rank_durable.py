"""The durable store across ``torch.distributed`` ranks: ``Session(storage=)``,
``Session.open``, ``lsm.recover`` and the lazy rebuild through ``Session``
on a ``RankMesh`` of 4 gloo ranks on the CPU, the ranks sharing ONE store
in the on-disk format both packages write.

One spawn of ranks (``rank_workers.durable_replays``) replays, in kernel,
shard_map and gspmd mode, tests/test_durability.py (``durable_scenarios``):
the round trip and the crash matrix over every ``IO_FAULT_POINTS`` in each
mode; the torn segment, the corrupt segment quarantined with the previous
generation serving, the empty flush, replay skipping flushed batches,
interleaved upsert / delete replay order, the double-open lock, the lazy
rebuild at first bind (and at each bind site), the telemetry series and
compaction GC; and tests/test_concurrency.py:346 (soft state rebuilt bit
for bit). Each result is held to the reference's meshless session and to
the port's one-process 4-shard mesh on the same inputs, dtypes included;
the layouts the ranks logged to the same manifest on every rank (LSN,
components, uids) and to ``ceil(rows / 4)`` rows of every component a
rank. The shared format: a store the ranks wrote opens without a mesh in
the port and in the reference; a store either package wrote without a mesh
opens on the ranks; after the scenario and a compaction the ranks' file
tree equals the meshless port's. A second spawn, of 2 ranks, holds a
rank session entered from another thread to its refusal (ROADMAP A9b-2f).
"""
import shutil
import types

import numpy as np
import pytest

import durable_scenarios as S
import rank_workers
from rank_workers import run_ranks
from repro.runtime import fault as ref_fault
from repro.runtime import telemetry as ref_tel
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.runtime import durable
from repro_torch.runtime import telemetry as tel
from repro_torch.runtime.fault import IO_FAULT_POINTS, FaultPlan, StorageFault
from test_durability import BATCHES
from test_torch_durability import _wal_records
from torch_replay import PORT, REF, assert_same

RANKS = 4
TIMEOUT = 240     # s: the ranks' start and every scenario, on shared cores
MODES = rank_workers.DURABLE_MODES
POINTS = IO_FAULT_POINTS
SITES = sorted(S.FIRST_BINDS)


def _pk(base, *, open_kw, tel_mod, fault_mod, name):
    """``durable_scenarios``' surface for a meshless package: ``base`` is
    torch_replay's REF or PORT."""
    def session(mode="gspmd", **kw):
        return base.session(mode, **kw)

    def open_(path, mode="gspmd", **kw):
        return base.Session.open(str(path), **open_kw(mode), **kw)

    return types.SimpleNamespace(
        name=name, P=base.P, AFrame=base.AFrame, lsm=base.lsm, Feed=base.Feed,
        Table=base.Table, tel=tel_mod, FaultPlan=fault_mod.FaultPlan,
        StorageFault=fault_mod.StorageFault, once=lambda fn: fn(), observe=lambda *a, **kw: None,
        session=session, open=open_, log=[])


def _ref_kw(mode):
    return {"mode": mode, **({"mesh": REF.session("shard_map").mesh}
                             if mode == "shard_map" else {})}


RPK = _pk(REF, open_kw=_ref_kw, tel_mod=ref_tel, fault_mod=ref_fault,
          name="ref")
FLAT = _pk(PORT, open_kw=lambda mode: {"mode": mode, **(
    {"mesh": make_local_mesh(1, device="cpu")} if mode == "shard_map"
    else {"device": "cpu"})}, tel_mod=tel,
    fault_mod=types.SimpleNamespace(FaultPlan=FaultPlan,
                                    StorageFault=StorageFault), name="port")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("rank_durable")


@pytest.fixture(scope="module")
def ranks4(root):
    """The 4-rank replays; before them, the stores the meshless writers
    leave for the ranks to open."""
    froms = {}
    for pk in (RPK, FLAT):
        d = root / f"from-{pk.name}"
        S.write_scenario(pk, d, "gspmd", BATCHES)
        froms[pk.name] = str(d)
    return run_ranks("durable_replays", RANKS,
                     {"root": str(root), "batches": BATCHES, "points": POINTS,
                      "from": froms}, TIMEOUT)


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    return rank_workers.durable_run(make_local_mesh(RANKS, device="cpu"),
                                    tmp_path_factory.mktemp("one_process"),
                                    BATCHES, POINTS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's meshless run of a scenario, computed once."""
    base = tmp_path_factory.mktemp("ref_durable")
    cache = {}

    def get(name, *args):
        key = (name,) + tuple(a for a in args if a is not BATCHES)
        if key not in cache:
            fn = getattr(S, name)
            cache[key] = fn(RPK, *args) if name == "soft_recover" \
                else fn(RPK, base, *args)
        return cache[key]

    return get


def _ranks(ranks4, *key):
    for rank, out in enumerate(ranks4):
        yield rank, out[key]


def _same_lookup(got, want, label):
    assert (got is None) == (want is None), label
    if want is not None:
        assert_same(got, {k: np.asarray(v) for k, v in want.items()}, label)


def _soft_equal(got: dict, want: dict, label) -> None:
    assert got.keys() == want.keys(), label
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray) or isinstance(g, np.ndarray):
            assert g is not None and w is not None, (label, k)
            assert g.dtype == w.dtype, (label, k, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=f"{label}:{k}")
        else:
            assert g == w, (label, k, g, w)


# -- the reference's durability suite on the ranks ---------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_reopen_roundtrip_on_ranks(ranks4, one_process, ref, mode):
    """The round trip: rows before the close and after the reopen equal the
    reference's, dtypes included; point lookups and the plan cache's
    counts after the same queries equal the one-process mesh's."""
    want = ref("roundtrip", mode, BATCHES)
    mine = one_process[("roundtrip", mode)]
    for rank, got in _ranks(ranks4, "roundtrip", mode):
        label = (rank, mode)
        assert_same(got["before"], want["before"], label)
        assert_same(got["after"], want["after"], label)
        assert got["replayed"] == want["replayed"] == 0
        for g, w in zip(got["get"], want["get"]):
            _same_lookup(g, w, label)
        assert got["get"][0]["v"][0] == 100.0
        assert got["counts"] == mine["counts"], label


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("point", POINTS)
def test_crash_restart_on_ranks(ranks4, one_process, ref, mode, point):
    """Kill at the I/O crash point (the fault fires on the writer rank and
    every rank raises at the same call), reopen on the ranks: the visible
    rows equal a memory-only rank session of exactly the acked batches
    (acked on every rank), the reference's recovery of the same crash and
    the one-process mesh's."""
    want = ref("crash", mode, point, BATCHES)
    mine = one_process[("crash", mode, point)]
    for rank, got in _ranks(ranks4, "crash", mode, point):
        label = (rank, mode, point)
        crashed = got["crashed"] or got["replay_raised"] == "StorageFault"
        assert crashed or point == "torn-write", label
        assert got["acked"] == want["acked"] == mine["acked"], label
        assert_same(got["rows"], got["oracle"], label)
        assert_same(got["rows"], want["rows"], label)
        assert_same(got["rows"], mine["rows"], label)
        assert len(set(got["rows"]["id"].tolist())) == len(got["rows"]["id"])
        assert (got["replay_raised"] == "StorageFault") == \
            (point == "mid-replay"), label


def test_torn_segment_write_stays_invisible_on_ranks(ranks4, ref):
    want = ref("torn_segment")
    for rank, got in _ranks(ranks4, "torn"):
        assert got["raised"] == "StorageFault" and got["tmp_left"], rank
        assert got["replayed"] == want["replayed"] == 1
        np.testing.assert_array_equal(got["ids"], np.arange(24, dtype=np.int32))
        assert got["tmp_swept"], rank


def test_corrupt_segment_quarantined_previous_generation_serves_on_ranks(
        ranks4, root):
    """A flipped bit in the ranks' run segment: every rank's reopen reports
    the fallback and serves the base alone, durably; the meshless port and
    the reference read the same store."""
    for rank, got in _ranks(ranks4, "corrupt"):
        assert got["fallbacks"] >= 1 and got["quarantined"], rank
        assert got["events"] >= 1 and got["counted"] >= 1, rank
        assert got["quarantine_dir"], rank
        np.testing.assert_array_equal(got["ids"], np.arange(16, dtype=np.int32))
        np.testing.assert_array_equal(got["ids_again"],
                                      np.arange(16, dtype=np.int32))
    assert len({str(g["quarantined"]) for _, g in _ranks(ranks4, "corrupt")}) == 1
    for pk in (FLAT, RPK):
        re = pk.open(root / "ranks" / "corrupt")
        np.testing.assert_array_equal(np.asarray(S.rows(pk, re)["id"]),
                                      np.arange(16, dtype=np.int32))
        re.close()


def test_empty_buffer_flush_is_noop_on_ranks(ranks4):
    for rank, got in _ranks(ranks4, "empty"):
        assert got["gens"] == got["gens_after"] and got["gens"], rank
        assert got["wal_seq"] == 0, rank


def test_replay_skips_already_flushed_batches_on_ranks(ranks4, ref):
    want = ref("replay_skips")
    for rank, got in _ranks(ranks4, "skips"):
        assert got["raised"] == want["raised"] == "StorageFault", rank
        assert got["wal_bytes"] > 0 and got["replayed"] == want["replayed"] == 0
        assert_same({"id": got["ids"]}, {"id": np.asarray(want["ids"])}, rank)


def test_interleaved_upsert_delete_replay_order_on_ranks(ranks4, root):
    """The tail replays in arrival order on the ranks; the reference
    replays a log the ranks wrote alike."""
    left = root / "ranks" / "interleaved-left"
    re = RPK.open(left)
    assert re.recovery_report["wal_replayed_batches"] == 4
    want = S.rows(RPK, re)
    re.close()
    for rank, got in _ranks(ranks4, "interleaved"):
        assert got["replayed"] == 4, rank
        assert got["get100"]["v"][0] == 2.0 and got["get7"] is None, rank
        assert_same(got["rows"], want, rank)


def test_double_open_raises_lock_error_on_ranks(ranks4):
    """A second session on the same ranks opening the same directory raises
    StorageLockError on every rank; after the close the store reopens."""
    for rank, got in _ranks(ranks4, "double"):
        assert got == {"raised": "StorageLockError", "rows_after": 16}, rank


def test_lazy_rebuild_defers_to_first_bind_on_ranks(ranks4, ref):
    """A lazy open mounts the hard columns and leaves every payload None;
    the first query rebuilds every rank's soft state as it was before the
    close (its own shard's index payloads, the gathered zone maps, host
    key copies and anti arrays); an eager open builds the same."""
    want = ref("lazy_rebuild", BATCHES)
    for rank, got in _ranks(ranks4, "lazy"):
        assert got["stale"] and got["all_stale"] and got["payloads_none"]
        assert_same(got["expect"], want["expect"], rank)
        assert_same(got["lazy_rows"], got["expect"], rank)
        assert got["rebuilds"] == 1 and not got["stale_after"], rank
        _soft_equal(got["lazy_soft"], got["soft"], (rank, "lazy"))
        assert got["get1"]["v"][0] == 100.0
        assert not got["eager_stale"]
        _soft_equal(got["eager_soft"], got["soft"], (rank, "eager"))
        assert_same(got["eager_rows"], got["expect"], rank)


@pytest.mark.parametrize("site", SITES)
def test_each_bind_site_rebuilds_a_lazy_mount_on_ranks(ranks4, ref, site):
    want = ref("first_binds", BATCHES)[site]
    for rank, out in _ranks(ranks4, "binds"):
        got = out[site]
        assert got["stale_before"] and not got["stale_after"], (rank, site)
        assert_same(got["answer"], want["answer"], (rank, site))
        assert_same(got["rows"], want["rows"], (rank, site))


def test_recovery_telemetry_series_present_on_ranks(ranks4):
    for rank, got in _ranks(ranks4, "telemetry"):
        assert all(got.values()), (rank, got)


def test_compaction_gc_unlinks_dead_segments_on_ranks(ranks4, ref):
    want = ref("compaction_gc")
    for rank, got in _ranks(ranks4, "gc"):
        assert len(got["segs"]) <= 2 * got["keep"], rank
        assert got["segs"] == want["segs"], rank
        assert_same(got["expect"], want["expect"], rank)
        assert_same(got["rows"], got["expect"], rank)


def test_recover_rebuilds_soft_state_bit_identical_on_ranks(ranks4, ref):
    """tests/test_concurrency.py:346: every piece of soft state wiped,
    ``lsm.recover`` on the ranks rebuilds it bit for bit; the answers equal
    the reference's."""
    want = ref("soft_recover")
    for rank, got in _ranks(ranks4, "soft"):
        assert got["before"] == got["after"] == want["before"], rank
        _soft_equal(got["soft_after"], got["soft"], rank)
        assert got["anti"], rank


def _same_tree(got, want, label):
    """Equal nested results: dicts and sequences element by element,
    arrays with their dtypes, scalars with their types."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), label
        for k in want:
            _same_tree(got[k], want[k], (label, k))
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), label
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, (label, i))
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, label
        np.testing.assert_array_equal(got, want, err_msg=str(label))
    else:
        assert type(got) is type(want) and got == want, (label, got, want)


# what each single-mode scenario must share with the one-process mesh
ONE_PROCESS = {
    "torn": lambda r: (r["ids"], r["replayed"]),
    "corrupt": lambda r: (r["ids"], r["ids_again"], r["fallbacks"],
                          r["quarantined"]),
    "empty": lambda r: r,
    "skips": lambda r: (r["ids"], r["replayed"]),
    "interleaved": lambda r: r,
    "double": lambda r: r,
    "lazy": lambda r: (r["expect"], r["lazy_rows"], r["eager_rows"],
                       r["get1"], r["rebuilds"]),
    "binds": lambda r: {site: (v["answer"], v["rows"]) for site, v in r.items()},
    "gc": lambda r: (r["expect"], r["rows"], r["segs"]),
    "soft": lambda r: (r["before"], r["after"]),
}


@pytest.mark.parametrize("scenario", sorted(ONE_PROCESS))
def test_every_scenario_equals_the_one_process_mesh(ranks4, one_process,
                                                    scenario):
    """Each single-mode scenario's rows, counts and reports on every rank
    equal the port's one-process 4-shard mesh's, dtypes included."""
    view = ONE_PROCESS[scenario]
    want = view(one_process[(scenario,)])
    for rank, got in _ranks(ranks4, scenario):
        _same_tree(view(got), want, (rank, scenario))


def _logs(ranks4):
    keys = [k for k in ranks4[0] if k[-1] == "log"]
    assert keys
    for key in keys:
        yield key, [out[key] for out in ranks4]


def test_every_rank_holds_the_same_manifest_and_its_own_rows(ranks4,
                                                             one_process):
    """After every reopen each rank holds the same manifest (LSN, component
    names, uids, levels, kill-sets), the one-process mesh's, and only
    ``ceil(rows / 4)`` rows of each component."""
    seen = 0
    for key, logs in _logs(ranks4):
        mine = one_process.get(key)
        for i, entries in enumerate(zip(*logs)):
            label, first = entries[0]
            head = (first["lsn"], [(c["name"], c["uid"], c["level"], c["kills"])
                                   for c in first["components"]])
            for rank, (lab, lay) in enumerate(entries):
                assert lab == label
                assert (lay["lsn"], [(c["name"], c["uid"], c["level"], c["kills"])
                                     for c in lay["components"]]) == head, \
                    (key, label, rank)
                for c in lay["components"]:
                    assert c["held"] == [-(-c["global_rows"] // RANKS)], \
                        (key, label, rank, c["name"])
                    assert c["global_rows"] % RANKS == 0
                seen += 1
            if mine is not None:
                m = mine[i][1]
                assert (m["lsn"], [c["name"] for c in m["components"]]) == \
                    (head[0], [c[0] for c in head[1]]), (key, label)
    assert seen >= RANKS * (len(MODES) * (1 + len(POINTS)) + 4)


# -- one store in the shared on-disk format ----------------------------------------------


@pytest.mark.parametrize("reader", ["port", "ref"])
def test_a_rank_store_opens_without_a_mesh(ranks4, root, tmp_path, ref,
                                           reader):
    """The store the ranks wrote (segments, manifests, a WAL tail of two
    batches) opens in the port without a mesh and in the reference, with
    the rows the reference's own store of the same calls serves."""
    pk = {"port": FLAT, "ref": RPK}[reader]
    d = tmp_path / "left"
    shutil.copytree(root / "ranks" / "left", d)
    want_dir = tmp_path / "ref-own"
    S.write_scenario(RPK, want_dir, "gspmd", BATCHES)
    own = RPK.open(want_dir)
    want = S.rows(RPK, own)
    own.close()
    re = pk.open(d)
    assert re.recovery_report["wal_replayed_batches"] == 2
    assert_same(S.rows(pk, re), want, reader)
    re.close()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_a_meshless_store_opens_on_ranks(ranks4, root, tmp_path, writer):
    """A store either package wrote without a mesh opens on the ranks with
    the rows and point lookups its writer's own reopen serves, and the
    delete the ranks flushed there reads back in the writer."""
    pk = {"port": FLAT, "ref": RPK}[writer]
    own = tmp_path / "own"
    S.write_scenario(pk, own, "gspmd", BATCHES)
    flat = pk.open(own)
    want = S.rows(pk, flat)
    lookups = {k: flat.point_lookup("d", "ds", k) for k in (0, 1, 2, 5, 99)}
    flat.close()
    back = pk.open(root / f"from-{writer}")
    after = S.rows(pk, back)
    back.close()
    for rank, got in _ranks(ranks4, "from", writer):
        assert got["replayed"] == 2, rank
        assert_same(got["rows"], want, (rank, writer))
        for k, w in lookups.items():
            _same_lookup(got["get"][k], w, (rank, writer, k))
        assert_same(got["after"], after, (rank, writer))


def test_the_rank_tree_equals_the_meshless_tree(ranks4, root, tmp_path):
    """After the reference's scenario (the last two batches left in the
    WAL) and an explicit compaction, the tree the ranks wrote holds the
    meshless port's files: the same names, segments equal array by array
    and in their metadata (``read_segment``: no shard pad, no added mask),
    the same manifest records, the same WAL records (zip time stamps
    zeroed)."""
    flat = tmp_path / "tree"
    S.tree_scenario(FLAT, flat, "kernel", BATCHES)
    trees = {}
    for name, d in (("ranks", root / "ranks" / "tree"), ("flat", flat)):
        trees[name] = {str(p.relative_to(d)): p for p in d.rglob("*")
                       if p.is_file() and p.name != "LOCK"}
    got, want = trees["ranks"], trees["flat"]
    assert sorted(got) == sorted(want)
    assert sum(k.endswith(".seg") for k in want) >= 2
    for k, p in want.items():
        if k.endswith(".seg"):
            (ga, gm), (wa, wm) = durable.read_segment(got[k]), \
                durable.read_segment(p)
            assert gm == wm, k
            assert list(ga) == list(wa), k
            for col in wa:
                assert ga[col].dtype == wa[col].dtype, (k, col)
                np.testing.assert_array_equal(ga[col], wa[col])
        elif k.endswith("wal.log"):
            assert _wal_records(got[k]) == _wal_records(p)
        else:
            assert got[k].read_bytes() == p.read_bytes(), k


# -- reader threads ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def threads2():
    return run_ranks("durable_threads", 2, {}, TIMEOUT)


def test_reader_threads_on_a_rank_mesh_refuse(threads2):
    """A query and a feed entered from a thread that did not make the rank
    session raise NotImplementedError naming ROADMAP A9b-2f; the
    background compactor's worker still builds, and its merge publishes."""
    for rank, got in enumerate(threads2):
        for what in ("query", "push"):
            kind, msg = got[what]
            assert kind == "refused" and "A9b-2f" in msg, (rank, what, msg)
        assert got["idle"] and got["compactions"] >= 1, rank
        assert got["components"] == 1, rank
        np.testing.assert_array_equal(got["rows"]["id"],
                                      np.arange(24, dtype=np.int32))
