"""tests/test_block_skip.py's three sharded tests (:521, :583, :642), which
fail inside the installed jax on 8 forced host devices, replayed on 8 gloo
ranks of the port: a fed, mutated, uncompacted dataset (and, for the
strings, its compaction) in gspmd, shard_map and kernel mode, each rank
holding only its shard of every component (``rank_workers.live_block_skip``
over ``live_scenarios``). Every rank's answers are held to the
reference's meshless session and to the port's one-process 8-shard mesh,
with the reference's own assertions: blocks skipped per shard, the
kernel's skipped-block counter, the point lookup routed to its owning
shard and newest-wins across tombstones and upserts."""
import functools

import numpy as np
import pytest

import live_scenarios as L
import rank_workers
from rank_workers import run_ranks
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.runtime import telemetry as tel
from torch_replay import REF

RANKS = 8
TIMEOUT = 240     # s: eight ranks' start and the scenarios, on shared cores
MODES = rank_workers.LIVE_MODES
ALIVE = np.array(sorted((set(range(L.N)) | set(range(20_480, 21_504)))
                        - {8200, 8300}))


@pytest.fixture(scope="module")
def skip8():
    return run_ranks("live_block_skip", RANKS, None, TIMEOUT)


@pytest.fixture(scope="module")
def port8():
    pk = rank_workers.live_pk(make_local_mesh(RANKS, device="cpu"))
    out = {}
    for mode in MODES:
        pk.log = []
        out[("skip", mode)] = L.block_skip(pk, mode, tel)
        out[("strings", mode)] = L.strings(pk, mode, tel)
        out[("log", mode)] = list(pk.log)
    out["lookup"] = L.routed_lookup(pk)
    return out


@functools.lru_cache(maxsize=None)
def ref(name: str, *args):
    """The reference's meshless session (gspmd, indexes off)."""
    return getattr(L, name)(REF, *args)


@pytest.mark.parametrize("mode", MODES)
def test_sharded_block_skip_equivalence_on_ranks(skip8, port8, mode):
    """tests/test_block_skip.py:521 on 8 ranks: every range of the
    reference's boundary grid and of 8 seeded pairs, with block skipping
    on and off, equals numpy, the reference's meshless session and the
    one-process 8-shard mesh; the 1-block-selective range skips blocks
    (the prune report, and the kernel's skipped-block counter in kernel
    mode) as the one-process mesh does."""
    want = ref("block_skip", "gspmd")
    for rank, out in enumerate(skip8):
        got = out[("skip", mode)]
        for qlo, qw in L.skip_pairs():
            lo, hi = qlo * 512, (qlo + qw) * 512
            n = int(((ALIVE >= lo) & (ALIVE <= hi)).sum())
            for skip in (True, False):
                key = (qlo, qw, skip)
                assert got[key] == want[key] == port8[("skip", mode)][key] == n, \
                    (rank, mode, key)
        assert got["selective"] == 507
        assert got["report"] == port8[("skip", mode)]["report"]
        assert got["report"]["shards"] == RANKS
        assert got["report"]["blocks_skipped"] > 0, got["report"]
        if mode == "kernel":
            assert got["fc_skipped"] > 0
            assert got["fc_skipped"] == port8[("skip", mode)]["fc_skipped"]


def test_sharded_point_lookup_routes_to_owning_shard_on_ranks(skip8, port8):
    """tests/test_block_skip.py:583 on 8 ranks: ``get`` of base matter (the
    owning shard probed alone), a tombstoned key, an upserted key, run-0
    matter and an absent key; rows equal the reference's meshless lookup
    and the one-process mesh's, plans and prune reports the latter's."""
    want = ref("routed_lookup")
    for rank, out in enumerate(skip8):
        got = out["lookup"]
        for key, (row, *plan) in got.items():
            wrow = want[key][0]
            assert (row is None) == (wrow is None), (rank, key)
            if row is not None:
                for c in wrow:
                    np.testing.assert_array_equal(row[c], wrow[c])
                    assert row[c].dtype == wrow[c].dtype
            assert plan == list(port8["lookup"][key][1:]), (rank, key)
        row, shards, probed, shard_probes, note, label, rep = got[123]
        assert int(row["id"][0]) == 123
        assert shards == RANKS and 1 <= shard_probes < probed * RANKS
        assert rep["shards"] == RANKS and rep["shard_probes"] >= 1
        assert "shard-routed" in label
        assert got[8200][0] is None and "anti-matter" in got[8200][4]
        assert int(got[8400][0]["val"][0]) == 7
        assert int(got[20_500][0]["ts"][0]) == 20_500
        assert got[10**8][0] is None and got[10**8][2] == 0


@pytest.mark.parametrize("mode", MODES)
def test_sharded_string_fastpath_equivalence_on_ranks(skip8, port8, mode):
    """tests/test_block_skip.py:642 on 8 ranks: string ==, IN and group-by
    over the fed, mutated, uncompacted set with skipping on and off, and
    after the compaction, equal the reference's meshless session and the
    one-process mesh; the clustered CL set's selective equality skips
    per-shard blocks."""
    want = ref("strings", "gspmd")
    for rank, out in enumerate(skip8):
        got = out[("strings", mode)]
        for skip in (True, False):
            assert got[skip] == want[True] == port8[("strings", mode)][skip]
        assert got["compacted"] == want[True]
        assert got["cl"] == 4096 == want["cl"]
        assert got["cl_report"] == port8[("strings", mode)]["cl_report"]
        assert got["cl_report"]["shards"] == RANKS
        assert got["cl_report"]["blocks_skipped"] > 0
        if mode == "kernel":
            assert got["fc_skipped"] > 0


@pytest.mark.parametrize("mode", MODES)
def test_each_of_8_ranks_holds_its_shard_of_every_component(skip8, port8,
                                                           mode):
    """I1 and I2 on the 8 ranks: after every flush and the compaction each
    rank holds ceil(rows / 8) rows of every component, the zone maps equal
    the one-process mesh's, and the manifest (LSN, uids, kill-sets) is the
    same on every rank and the one-process mesh's."""
    want = port8[("log", mode)]
    for rank, out in enumerate(skip8):
        log = out[("log", mode)]
        assert [x[0] for x in log] == [x[0] for x in want]
        for (label, got), (_, w) in zip(log, want):
            assert got["lsn"] == w["lsn"], (rank, label)
            for c, wc in zip(got["components"], w["components"]):
                assert c["held"] == [-(-wc["global_rows"] // RANKS)]
                for k in ("name", "uid", "kills", "live", "anti", "meta",
                          "global_rows", "columns"):
                    assert c[k] == wc[k], (rank, label, k)
                assert c["zones"][:3] == wc["zones"][:3]
                for col, span in c["zones"][3].items():
                    np.testing.assert_array_equal(span, wc["zones"][3][col])
