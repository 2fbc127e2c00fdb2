"""The DataFrame engine across ``torch.distributed`` ranks: ``Session`` on
a ``RankMesh`` of gloo ranks on the CPU, each rank holding only its row
shard of every table, every operator merged over the data axes' process
group.

Three spawns of ranks (``rank_workers.run_ranks``), each body running many
checks and returning what it saw; the parent holds it to the one-process
S-shard mesh of the port, to the reference's meshless session and to the
reference on 8 forced host devices:

  * the 8-device probe (``engine_probe.sharded_probe``) on 8 ranks: every
    rank's JSON equals the one-process 8-shard mesh's (``port8``) and
    meets the reference's (``ref8``) by tests/test_torch_distributed.py's
    rules — expressions, explain texts, prune reports, dispatch sets, the
    hash repartition with and without drops;
  * tests/test_distributed.py's three engine tests (:24, :54, :89)
    replayed on 8 ranks, with their assertions;
  * 10,001 rows (uneven shards) and 3 rows (a shard of padding alone) on
    4 ranks, in shard_map, kernel and gspmd mode: the invariants of
    ``engine/session.py`` — I1 (each rank holds ceil(n / S) rows of each
    column; zone maps and index zones are the one-process layout), I2
    (explain texts, prune reports and operator choices equal on every
    rank and to the one-process mesh's), I3 (the 12 expressions, dtypes
    included, equal the reference's meshless session on every rank;
    point lookups of keys each rank owns and of absent keys equal the
    reference's meshless lookup) — and the feed, views, persist,
    compaction and a durable store's round trip running there.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import rank_workers
from engine_probe import EXPRESSIONS
from rank_workers import run_ranks
from repro.core.frame import AFrame as RFrame
from repro.data import wisconsin as rw
from repro.engine.session import Session as RSession
from repro_torch.core.frame import AFrame as TFrame
from repro_torch.data import wisconsin as tw
from repro_torch.engine.session import Session as TSession
from repro_torch.launch.mesh import make_local_mesh
from test_torch_distributed import (explain_meets_ref8, exprs_meet_ref8,  # noqa: F401
                                    port8, ref8, repartition_meets_ref8)

# join timeouts (s): the ranks' start (spawn, torch and the port imported)
# and their bodies, on ranks that share the host's cores
TIMEOUT = {"probe": 150, "replays": 120, "checks": 240}
CHECK_ROWS = (10_001, 3)    # uneven shards; one shard of padding alone
CHECK_RANKS = 4
ROUNDS = 2
SEED = 7


def _same(got, want, label):
    """tests/test_kernel_mode.py's comparison: the same keys, dtypes and
    values; a scalar of the same Python type and value."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), label
        for k in want:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.dtype == w.dtype, (label, k, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=f"{label}:{k}")
    elif want is None:
        assert got is None, label
    else:
        assert type(got) is type(want) and got == want, (label, got, want)


def _frames(sess):
    F = TFrame if isinstance(sess, TSession) else RFrame
    return F("bench", "data", session=sess), F("bench", "data_r", session=sess)


# -- the 8-device probe on 8 ranks -------------------------------------------------


@pytest.fixture(scope="module")
def probe8_ranks():
    return run_ranks("engine_probe", 8, None, TIMEOUT["probe"])


def test_probe_on_8_ranks_equals_the_one_process_mesh(probe8_ranks, port8):
    """I2 and I3 on 8 ranks: every rank's answers (dtypes included),
    explain texts, prune reports, dispatch sets and repartition totals
    equal the one-process 8-shard mesh's."""
    for rank, got in enumerate(probe8_ranks):
        assert got == port8, rank


def test_probe_on_8_ranks_meets_the_8_device_reference(probe8_ranks, ref8):
    for got in probe8_ranks:
        exprs_meet_ref8(got, ref8)
        explain_meets_ref8(got, ref8)
        repartition_meets_ref8(got, ref8)


# -- tests/test_distributed.py's engine tests on 8 ranks ----------------------------


@pytest.fixture(scope="module")
def replays8():
    raw = {k: v.numpy() for k, v in tw.generate(10_000, seed=1).columns.items()}
    return run_ranks("engine_replays", 8, None, TIMEOUT["replays"]), raw


def test_dataframe_shard_map_equivalence_on_ranks(replays8):
    """tests/test_distributed.py::test_dataframe_shard_map_equivalence
    (indexes and a primary key) with each of 8 ranks holding 1,250 rows."""
    ranks, raw = replays8
    for r in ranks:
        got = r["shard_map"]
        assert got["len"] == 10_000
        assert got["n3"] == int(((raw["ten"] == 3) & (raw["twentyPercent"] == 2)
                                 & (raw["two"] == 1)).sum())
        assert got["max"] == raw["unique1"].max()
        assert got["groups"]["count"].sum() == 10_000
        assert len(got["groups"]["count"]) == 100
        assert list(got["top5"]["unique1"]) == sorted(raw["unique1"])[-5:][::-1]
        assert got["range"] == int(((raw["onePercent"] >= 10)
                                    & (raw["onePercent"] <= 30)).sum())
        assert got["join"] == 10_000
        assert {s[0] for s in got["rows"].values()} == {1_250}


def test_dataframe_kernel_mode_sharded_equivalence_on_ranks(replays8):
    """tests/test_distributed.py::test_dataframe_kernel_mode_sharded_equivalence:
    each rank launches every kernel family over its own shard (once for
    filter_count, segment_agg and merge_join_count; block_topk once, then
    once for the merge of the gathered candidates)."""
    ranks, raw = replays8
    for r in ranks:
        got = r["kernel"]
        assert got["n3k"] == int(((raw["ten"] == 3) & (raw["twentyPercent"] == 3)
                                  & (raw["two"] == 1)).sum())
        assert got["groups"]["count"].sum() == 10_000
        assert len(got["groups"]["count"]) == 100
        assert list(got["top5"]["unique1"]) == sorted(raw["unique1"])[-5:][::-1]
        assert got["range"] == int(((raw["onePercent"] >= 10)
                                    & (raw["onePercent"] <= 30)).sum())
        assert got["join"] == 10_000
        for k in ("filter_count", "segment_agg", "topk", "merge_join_count"):
            assert got["dispatch"].get(k, 0) >= 1, k
        assert got["dispatch"]["topk"] == 2
        assert {s[0] for s in got["rows"].values()} == {1_250}


def test_hash_repartition_join_on_ranks(replays8):
    """tests/test_distributed.py::test_hash_repartition_join: the
    all-to-all over 8 ranks, unique keys without drops and ten's 800-fold
    duplicates counted whole."""
    ranks, _ = replays8
    for r in ranks:
        assert r["hash"] == [8_000, 0]
        want = sum(int(c) ** 2 for c in r["ten_counts"])
        assert r["hash_dup"][0] == want and r["hash_dup"][1] == 0
        np.testing.assert_array_equal(r["ten_counts"], np.full(10, 800))


# -- uneven and padding-only shards on 4 ranks --------------------------------------


@pytest.fixture(scope="module")
def checks4(tmp_path_factory):
    store = str(tmp_path_factory.mktemp("rank_store"))
    ranks = run_ranks("engine_checks", CHECK_RANKS,
                      {"rows": CHECK_ROWS, "seed": SEED, "rounds": ROUNDS,
                       "store": store}, TIMEOUT["checks"])
    return ranks


def _one_process(n: int, mode: str):
    """The port's one-process 4-shard mesh: the rank body's checks over
    the same table."""
    return rank_workers.engine_run(make_local_mesh(CHECK_RANKS, device="cpu"),
                                   mode, tw.generate(n, seed=SEED), ROUNDS,
                                   CHECK_RANKS)


@pytest.fixture(scope="module")
def one_process():
    return {(n, mode): _one_process(n, mode) for n in CHECK_ROWS
            for mode in rank_workers.ENGINE_MODES}


def _reference(n: int) -> dict:
    """The reference's meshless session over the same table: the 12
    expressions and the point lookups. Where the reference raises (top_k
    of more rows than the table has, ROADMAP C5) the port's meshless
    session answers instead."""
    t = rw.generate(n, seed=SEED)
    ref = RSession(mode="gspmd")
    port = TSession(mode="gspmd", device="cpu")
    for sess, table in ((ref, t), (port, tw.generate(n, seed=SEED))):
        for name in ("data", "data_r"):
            sess.create_dataset(name, table, dataverse="bench")
        sess.create_dataset("clu", table, dataverse="bench", primary="unique2",
                            indexes=["onePercent"])
    want = {}
    for name, fn in sorted(EXPRESSIONS.items()):
        for r in range(ROUNDS):
            try:
                want[(name, r)] = fn(*_frames(ref), np.random.default_rng(100 + r))
            except ValueError:
                assert n < 5 and name == "9_sort_head", (n, name)
                want[(name, r)] = fn(*_frames(port), np.random.default_rng(100 + r))
    clu = RFrame("bench", "clu", session=ref)
    for key in rank_workers.engine_lookup_keys(n, CHECK_RANKS):
        got = clu.get(key)
        want[("get", key)] = None if got is None else \
            {k: np.asarray(v) for k, v in got.items()}
    return want


@pytest.fixture(scope="module")
def reference():
    return {n: _reference(n) for n in CHECK_ROWS}


@pytest.mark.parametrize("n", CHECK_ROWS)
def test_rank_answers_equal_the_meshless_reference(checks4, reference, n):
    """I3: on every rank and in every mode, the 12 expressions over two
    rounds of literals equal the reference's meshless session, dtypes
    included; so do point lookups of each rank's first key, the last key
    and two absent keys."""
    for rank, out in enumerate(checks4):
        for mode in rank_workers.ENGINE_MODES:
            got = out[(n, mode)]
            for key, want in reference[n].items():
                _same(got[key], want, (n, mode, rank, key))


@pytest.mark.parametrize("n", CHECK_ROWS)
def test_rank_plans_equal_the_one_process_mesh(checks4, one_process, n):
    """I2: every rank picks the operators, explains the plans and reports
    the pruning the one-process 4-shard mesh does, in every mode (the
    clustered ranges skip blocks on each shard's own grid, and the kernel
    block accounting reads the same totals), and the plans' answers agree; so do the operators beyond the 12 expressions (a
    stream delivered whole, a full sort, windows, a string group-by,
    sums, measured rows)."""
    for rank, out in enumerate(checks4):
        for mode in rank_workers.ENGINE_MODES:
            got, (want, _) = out[(n, mode)], one_process[(n, mode)]
            for key, w in want.items():
                label = (n, mode, rank, key)
                if key[-1] in ("op", "explain", "report", "blocks"):
                    assert got[key] == w, label
                else:
                    _same(got[key], w, label)
    if n > 4_096:   # a zone block a shard: the ranges skip some
        for mode in rank_workers.ENGINE_MODES:
            for plan in (("group_count",), ("max",), ("range_count", "no index")):
                rep = checks4[0][(n, mode)][plan + ("report",)]
                assert rep["shards"] == CHECK_RANKS, (mode, plan, rep)
                assert rep["blocks_skipped"] > 0, (mode, plan, rep)
        # the kernels' per-shard block lists: filter_count's and
        # segment_agg's scanned and skipped blocks over every shard
        kernel = checks4[0][(n, "kernel")]
        assert kernel[("range_count", "no index", "blocks")] == [2, 0, 2, 0]
        assert kernel[("group_count", "no index", "blocks")] == [0, 4, 0, 4]


@pytest.mark.parametrize("n", CHECK_ROWS)
def test_each_rank_holds_only_its_rows(checks4, one_process, n):
    """I1: each column a rank holds is ceil(n / S) rows long (the padded
    table is S times that), and the zone maps, index zones and column
    meta every rank holds equal the one-process mesh's; ``head_dict`` is
    the whole table's first rows on every rank, and ``select`` keeps the
    shard."""
    rps = -(-n // CHECK_RANKS)
    for rank, out in enumerate(checks4):
        for mode in rank_workers.ENGINE_MODES:
            got, want = out[(n, mode, "layout")], one_process[(n, mode)][1]
            for name, g in got.items():
                w = want[name]
                label = (n, mode, rank, name)
                assert {s[0] for s in g["shapes"].values()} == {rps}, label
                assert {k: s[1:] for k, s in g["shapes"].items()} == \
                    {k: s[1:] for k, s in w["shapes"].items()}, label
                assert g["global_rows"] == w["global_rows"] == rps * CHECK_RANKS
                assert g["zones"][:3] == w["zones"][:3], label
                assert g["zones"][3].keys() == w["zones"][3].keys(), label
                for col, span in g["zones"][3].items():
                    np.testing.assert_array_equal(span, w["zones"][3][col])
                assert g["index_zones"].keys() == w["index_zones"].keys()
                for ix, (lo, hi) in g["index_zones"].items():
                    np.testing.assert_array_equal(lo, w["index_zones"][ix][0])
                    np.testing.assert_array_equal(hi, w["index_zones"][ix][1])
                assert g["meta"] == w["meta"], label
                _same(g["head"], w["head"], label + ("head_dict",))
                assert g["select"] == (w["select"][0], (rps,)), label


def test_live_and_durable_paths_run_on_a_rank_mesh(checks4):
    """The feed, views, persist and compaction run on a rank mesh (over the
    3-row table: a push of two rows and a delete of one, a view equal to
    its recompute, a persisted filter, a compaction), and so does the
    durable store: the 3-row table written through ``storage=`` into the
    one store the ranks share comes back from ``Session.open`` on the
    ranks with the rows it held, equal to the reference's meshless
    session's, each rank holding one row of each column."""
    n = CHECK_ROWS[-1]
    t = rw.generate(n, seed=SEED)
    ref = RSession(mode="kernel")
    ref.create_dataset("clu", t, dataverse="bench", primary="unique2",
                       indexes=["onePercent"])
    want = RFrame("bench", "clu", session=ref).collect()
    for out in checks4:
        paths = out["paths"]
        assert set(paths) == {"feed", "view", "persist", "compact",
                              "storage", "open"}
        kind, stored = paths["storage"]
        assert kind == "ran", stored
        _same(stored, want, "storage")
        kind, (rows, held) = paths["open"]
        assert kind == "ran", rows
        _same(rows, want, "open")
        assert {s[0] for s in held.values()} == {-(-n // CHECK_RANKS)}, held
        assert paths["feed"] == ("ran", (n + 2 - 1, 1))
        kind, (view, recompute) = paths["view"]
        assert kind == "ran"
        _same(view, recompute, "view")
        assert paths["persist"] == ("ran", n + 2 - 1)
        assert paths["compact"] == ("ran", n + 2 - 1)


def test_the_rank_bodies_import_no_jax():
    """The rank bodies and the modules that give them the expressions and
    the durable store's scenarios load no jax and nothing of the
    reference, the durable bodies' package surface included."""
    code = ("import sys, rank_workers, engine_probe, durable_scenarios; "
            "rank_workers._engine(); rank_workers.durable_pk(None); "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    here = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=f"{here.parent / 'src'}{os.pathsep}{here}")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=here)
    assert r.returncode == 0, r.stdout + r.stderr
