"""The live engine across ``torch.distributed`` ranks: feeds, upserts and
deletes, LSM runs, full, leveled and background compaction, views and
persist through ``Session`` on a ``RankMesh`` of 4 gloo ranks on the CPU,
each rank holding only its shard of every component.

One spawn of ranks (``rank_workers.live_replays``) replays, over a
10,001-row base (uneven shards; runs whose shards hold only pads or only
tombstones), in kernel, shard_map and gspmd mode, the scenarios of
``live_scenarios``: tests/test_lsm.py's
``test_queries_identical_before_and_after_compaction``,
``test_kernel_mode_launches_per_component``,
``test_view_incremental_equals_recompute`` and
``test_compaction_policy_triggers``; tests/test_mutation.py's
``test_mutated_queries_identical_before_and_after_compaction``,
``test_newest_wins_semantics``,
``test_leveled_merge_preserves_mutation_results``,
``test_view_retraction_counts_sums_and_extremes`` and
``test_mutation_interleavings_match_newest_wins_oracle`` (seeded); and
tests/test_concurrency.py's two background-compactor tests. Each result
is held to the reference's meshless session, run here on the same inputs,
and to the port's one-process 4-shard mesh; the layouts the ranks logged
after every flush and compaction are held to I1 (``ceil(rows / S)`` rows
of every component a rank, the one-process mesh's zone maps, index zones
and meta) and I2 (every rank's manifest the same: LSN, components, uids,
kill-sets). A "pre-swap" fault armed on one rank aborts the flush on every
rank, and the retry commits on all of them."""
import functools

import numpy as np
import pytest

import live_scenarios as L
import rank_workers
from rank_workers import run_ranks
from repro.runtime import fault as ref_fault
from repro_torch.launch.mesh import make_local_mesh
from torch_replay import REF, assert_same

RANKS = 4
BASE_ROWS = 10_001
TIMEOUT = 300     # s: the ranks' start and every scenario, on shared cores
MODES = rank_workers.LIVE_MODES
# background compaction publishes when the ranks agree, the one-process
# mesh when its worker is done: their layouts differ, their answers do not
TIMING_DEPENDENT = (("bg_folds",), ("bg_fault",))


@pytest.fixture(scope="module")
def live4():
    return run_ranks("live_replays", RANKS, {"base_rows": BASE_ROWS}, TIMEOUT)


@pytest.fixture(scope="module")
def one_process():
    return rank_workers.live_run(make_local_mesh(RANKS, device="cpu"), BASE_ROWS)


REF.FaultPlan = ref_fault.FaultPlan


@functools.lru_cache(maxsize=None)
def ref(name: str, *args):
    return getattr(L, name)(REF, *args)


def rank_launches(launches: dict, meshless: bool) -> dict:
    """A rank's launches from the reference's counts of the same suite:
    filter_count, segment_agg and merge_join_count once per component and
    query, as a meshless run; a top-k selects over the rank's rows and
    again over the gathered candidates (twice a query, as the reference's
    one-device mesh counts it)."""
    return {k: v * 2 if k == "topk" and meshless else v
            for k, v in launches.items()}


def _every(live4):
    for rank, out in enumerate(live4):
        yield rank, out


@pytest.mark.parametrize("mode", MODES)
def test_queries_identical_before_and_after_compaction_on_ranks(live4, mode):
    """tests/test_lsm.py's suite over base ∪ two runs and after the
    compaction, on every rank: the reference's answers (dtypes included),
    launch, compile and hit counts and feed stats; a filter persisted over
    the compacted base (each rank keeps its rows of the stream) answers as
    the reference's."""
    want = ref("lsm_suite", mode, BASE_ROWS)
    for rank, out in _every(live4):
        got = out[("lsm", mode)]
        for k in want["before"]:
            assert_same(got["before"][k], want["before"][k], (rank, mode, k))
            assert_same(got["after"][k], want["after"][k], (rank, mode, k))
            assert_same(got["before"][k], got["after"][k], (rank, mode, k))
        assert got["launches"] == rank_launches(want["launches"],
                                                meshless=mode != "shard_map")
        assert (got["counts"], got["counts_after"], got["stats"]) == \
            (want["counts"], want["counts_after"], want["stats"])
        for k, v in want["persist_after"].items():   # one component: no move
            assert_same(got["persist_after"][k], v, (rank, mode, k))


@pytest.mark.parametrize("mode", MODES)
def test_lookups_persist_and_explain_over_runs_on_ranks(live4, one_process,
                                                        mode):
    """Point lookups of base, run and absent keys and a persisted filter
    over base ∪ runs equal the reference's; the explain text of a group-by
    over the union equals the one-process mesh's."""
    want = ref("lsm_extras", mode, BASE_ROWS)
    for rank, out in _every(live4):
        got = out[("extras", mode)]
        for key, row in want["get"].items():
            if row is None:
                assert got["get"][key] is None, (rank, key)
            else:
                assert_same(got["get"][key], row, (rank, mode, key))
        for k, v in want["persist"].items():
            assert_same(got["persist"][k], v, (rank, mode, k))
        assert got["explain"] == one_process[("extras", mode)]["explain"]


def test_kernel_mode_launches_per_component_on_ranks(live4):
    """One filter_count and one segment_agg launch per component (3), on
    every rank, over its own rows."""
    for _, out in _every(live4):
        assert out[("launches",)] == {"filter_count": 3, "segment_agg": 3}


@pytest.mark.parametrize("mode", MODES)
def test_view_incremental_equals_recompute_on_ranks(live4, mode):
    want = ref("view_incremental", mode, BASE_ROWS)
    for rank, out in _every(live4):
        got = out[("view", mode)]
        assert_same(got["view"], got["recompute"], (rank, mode))
        assert_same(got["view_after"], got["recompute_after"], (rank, mode))
        for k in ("view", "view_after"):
            assert_same(got[k], want[k], (rank, mode, k))
        assert got["stats"] == want["stats"]
        assert got["stats"]["refreshes"] == 4 and \
            got["stats"]["kernel_batches"] >= 1


def test_compaction_policy_triggers_on_ranks(live4):
    want = ref("policy_triggers")
    for _, out in _every(live4):
        got = out[("policy",)]
        assert got == want
        assert got["first"] == (1, 1, 0) and got["second"] == (3, 1)


@pytest.mark.parametrize("mode", MODES)
def test_mutated_queries_identical_before_and_after_compaction_on_ranks(live4,
                                                                        mode):
    """tests/test_mutation.py's suite over base, a run and a mutation run
    (upserts into both, deletes of the extremes): the reference's answers
    before the compaction and the same after it, its launch and plan-cache
    counts, point lookups of upserted, deleted, run and absent keys, and a
    persisted filter."""
    want = ref("mutated_suite", mode, BASE_ROWS)
    for rank, out in _every(live4):
        got = out[("mutated", mode)]
        assert got["tombstones"] > 0
        for k in want["before"]:
            assert_same(got["before"][k], want["before"][k], (rank, mode, k))
            assert_same(got["after"][k], got["before"][k], (rank, mode, k))
        assert got["before"]["scalar_max"] == BASE_ROWS + L.PUSH_ROWS - 41
        assert got["launches"] == rank_launches(want["launches"],
                                                meshless=mode != "shard_map")
        assert got["counts"] == want["counts"]
        for state in ("get_before", "get_after"):
            for key, row in want[state].items():
                if row is None:
                    assert got[state][key] is None, (rank, state, key)
                else:
                    assert_same(got[state][key], row, (rank, state, key))
        for k, v in want["persist"].items():
            assert_same(got["persist"][k], v, (rank, mode, k))


def test_newest_wins_semantics_on_ranks(live4):
    want = ref("newest_wins")
    assert want == [3, 1, [222], 0, [9], [71], [71], [9]]
    for _, out in _every(live4):
        assert out[("newest",)] == want


def test_leveled_merge_preserves_mutation_results_on_ranks(live4):
    want = ref("leveled_mutations")
    for rank, out in _every(live4):
        got = out[("leveled",)]
        expect = got["expect"]
        assert got["stats"]["level_merges"] >= 1
        assert got["len"] == got["len_after"] == len(expect)
        assert got["sum"] == got["sum_after"] == sum(expect.values())
        np.testing.assert_array_equal(got["rows"]["k"], sorted(expect))
        assert_same(got["rows"], want["rows"], rank)
        assert got["stats"] == want["stats"] and got["levels"] == want["levels"]


def test_view_retraction_counts_sums_and_extremes_on_ranks(live4):
    want = ref("view_retraction")
    for rank, out in _every(live4):
        steps = out[("retraction",)]
        for (view, recompute, stats), (wview, _, wstats) in zip(steps, want):
            assert_same(view, recompute, rank)
            assert_same(view, wview, rank)
            assert stats == wstats
        assert steps[0][2]["retractions"] == 1
        assert steps[0][2]["rows_retracted"] == 4
        assert steps[0][2]["extremum_recomputes"] >= 1
        assert 1 not in steps[2][0]["g"].tolist()


@pytest.mark.parametrize("seed", range(4))
def test_mutation_interleavings_match_newest_wins_oracle_on_ranks(live4, seed):
    """Seeded push / upsert / delete / flush / compact interleavings in
    every mode: the surviving rows equal the oracle before and after the
    compaction, and count, group max and sum equal the reference's."""
    want = ref("interleavings", "gspmd", seed)
    assert want["rows"] == want["want"]
    for rank, out in _every(live4):
        for mode in MODES:
            got = out[("interleave", mode, seed)]
            assert got["rows"] == got["rows_after"] == want["want"], (rank, mode)
            for k in ("count_lo", "group", "sum"):
                if want[k] is not None:
                    assert_same(got[k], want[k], (rank, mode, seed, k))


def test_background_compactor_folds_runs_and_preserves_results_on_ranks(live4):
    """The rank compactor: merges planned on the caller's thread, built on
    the twin groups, published at wait_idle on every rank alike."""
    for _, out in _every(live4):
        got = out[("bg_folds",)]
        assert got["idle"] and got["level_merges"] >= 1 and got["runs"] < 6
        assert got["got"] == got["want"]


def test_background_compactor_retries_through_injected_fault_on_ranks(live4):
    for _, out in _every(live4):
        got = out[("bg_fault",)]
        assert got["idle"] and got["faults"] >= 1 and got["retries"] >= 1
        assert got["runs"] == 0 and got["got"] == got["want"]
        assert got["fired"] == [("mid-merge", 0)]


def _logs(out):
    return {k[:-1]: v for k, v in out.items()
            if isinstance(k, tuple) and k[-1] == "log"}


def test_each_rank_holds_only_its_rows_through_ingest(live4, one_process):
    """I1 after every flush, merge and compaction of every scenario: each
    rank holds ceil(rows / S) rows of every component, on its device, and
    the zone maps, index zones and column meta equal the one-process
    mesh's."""
    want = _logs(one_process)
    checked = 0
    for rank, out in _every(live4):
        for key, log in _logs(out).items():
            for (label, got), (_, w) in zip(log, want[key]):
                for c, wc in zip(got["components"], w["components"]):
                    where = (rank, key, label, c["name"])
                    rps = -(-c["global_rows"] // RANKS)
                    assert c["held"] == [rps], where
                    assert c["device"] == ["cpu"], where
                    if key in TIMING_DEPENDENT:
                        continue
                    assert c["global_rows"] == wc["global_rows"], where
                    assert c["columns"] == wc["columns"], where
                    assert c["meta"] == wc["meta"], where
                    zc, zw = c["zones"], wc["zones"]
                    assert zc[:3] == zw[:3], where
                    for col, span in zc[3].items():
                        np.testing.assert_array_equal(span, zw[3][col])
                    assert c["index_zones"].keys() == wc["index_zones"].keys()
                    for ix, (lo, hi) in c["index_zones"].items():
                        np.testing.assert_array_equal(lo, wc["index_zones"][ix][0])
                        np.testing.assert_array_equal(hi, wc["index_zones"][ix][1])
                    checked += 1
    assert checked > 100


def _manifest(layout):
    return (layout["lsn"], [(c["name"], c["uid"], c["level"], c["live"],
                             c["anti"], c["kills"]) for c in layout["components"]])


def test_every_rank_holds_the_same_manifest(live4, one_process):
    """I2 after every step: the same manifest on every rank (LSN, the
    components in order, their uids, levels, live and anti rows, kill-sets
    and host key copies), and the one-process mesh's where no background
    worker decides when a merge lands."""
    want = _logs(one_process)
    first = _logs(live4[0])
    assert sum(len(log) for log in first.values()) > 20
    for rank, out in _every(live4):
        logs = _logs(out)
        assert logs.keys() == first.keys()
        for key, log in logs.items():
            assert len(log) == len(first[key]), key
            for (label, got), (_, f) in zip(log, first[key]):
                assert _manifest(got) == _manifest(f), (rank, key, label)
                for c, fc in zip(got["components"], f["components"]):
                    if c["host_keys"] is not None:
                        np.testing.assert_array_equal(c["host_keys"],
                                                      fc["host_keys"])
                if key not in TIMING_DEPENDENT:
                    w = dict(want[key])[label]
                    assert _manifest(got) == _manifest(w), (rank, key, label)


def test_pre_swap_fault_on_one_rank_commits_on_none(live4):
    """A "pre-swap" fault armed on rank 0 alone: the flush raises on every
    rank (rank 0 its own fault, the others the vote's), every manifest is
    left as it was, and the retried flush commits on all of them."""
    for rank, out in _every(live4):
        f = out["fault"]
        assert f["raised"] is not None, rank
        assert _manifest(f["aborted"]) == _manifest(f["before"]), rank
        committed = _manifest(f["committed"])
        assert committed[0] > f["before"]["lsn"]
        assert len(committed[1]) == len(_manifest(f["before"])[1]) + 1
        assert committed == _manifest(live4[0]["fault"]["committed"])
        assert f["len"] == BASE_ROWS + 2 * L.PUSH_ROWS
    assert live4[0]["fault"]["fired"] == [("pre-swap", 0)]
    assert "peer" in live4[1]["fault"]["raised"]


def test_the_live_rank_bodies_import_no_jax():
    """The live scenarios and the rank bodies' package surface load no jax
    and nothing of the reference."""
    import os
    import pathlib
    import subprocess
    import sys

    code = ("import sys, rank_workers, live_scenarios; "
            "rank_workers.live_pk(None); "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    here = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=f"{here.parent / 'src'}{os.pathsep}{here}")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=here)
    assert r.returncode == 0, r.stdout + r.stderr
