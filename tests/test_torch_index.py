"""Indexes and point lookups on the port (``repro_torch.engine.index``,
``Session.point_lookup``): the sorted-index primitives against
``repro.engine.index`` on the same seeded keys (ties, padding rows, open
and closed sides), the index access paths the planner picks against the
reference's choices (tests/test_kernel_mode.py:175: the index-only count
still wins over kernel fusion), a presorted join build side, and
``AFrame.get`` / ``explain_get`` over a mutated fed dataset — newest wins,
tombstones kill, and no query is compiled."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_replay import PORT, REF, assert_same, counts, host_rows

from repro.engine import index as rix
from repro_torch.engine import index as tix


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_index_primitives_equal_reference(dtype):
    rng = np.random.default_rng(4)
    n = 5_000
    keys = rng.integers(0, 300, n).astype(dtype)  # many ties
    valid = rng.random(n) > 0.2
    ri = rix.build_index_local(jnp.asarray(keys), jnp.asarray(valid), "k")
    ti = tix.build_index_local(torch.from_numpy(keys), torch.from_numpy(valid), "k")
    for name in ("sorted_keys", "row_ids", "zone_min", "zone_max"):
        want, got = np.asarray(getattr(ri, name)), getattr(ti, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    nv = int(valid.sum())
    anti = np.unique(rng.integers(0, 320, 40)).astype(dtype)
    for lo, hi in ((10, 40), (None, 17), (250, None), (None, None), (90, 80)):
        rlo = None if lo is None else jnp.asarray(np.asarray(lo, dtype))
        rhi = None if hi is None else jnp.asarray(np.asarray(hi, dtype))
        tlo = None if lo is None else torch.tensor(lo, dtype=torch.from_numpy(keys).dtype)
        thi = None if hi is None else torch.tensor(hi, dtype=torch.from_numpy(keys).dtype)
        want = rix.index_count_local(ri.sorted_keys, jnp.int32(nv), rlo, rhi)
        got = tix.index_count_local(ti.sorted_keys, torch.tensor(nv, dtype=torch.int32),
                                    tlo, thi)
        assert got.dtype == torch.int32 and int(got) == int(want), (lo, hi)
        want = rix.shadow_count_local(ri.sorted_keys, jnp.int32(nv),
                                      jnp.asarray(anti), rlo, rhi)
        got = tix.shadow_count_local(ti.sorted_keys, torch.tensor(nv, dtype=torch.int32),
                                     torch.from_numpy(anti), tlo, thi)
        assert got.dtype == torch.int32 and int(got) == int(want), (lo, hi)
        wrows, wtake = rix.index_head_rows_local(ri, jnp.int32(nv), rlo, rhi, 7)
        grows, gtake = tix.index_head_rows_local(ti, nv, tlo, thi, 7)
        np.testing.assert_array_equal(grows.numpy(), np.asarray(wrows))
        assert int(gtake) == int(wtake)


def _indexed(pk, mode, n=8_192):
    sess = pk.session(mode)
    sess.create_dataset("data", pk.wisconsin.generate(n, seed=5), dataverse="ix",
                        closed=True, indexes=["onePercent", "unique1"])
    return sess, pk.AFrame("ix", "data", session=sess)


@pytest.mark.parametrize("mode", ["gspmd", "kernel"])
def test_index_access_paths_equal_reference(mode):
    """An indexed range count stays index-only (and, in kernel mode, wins
    over kernel fusion on cost), an indexed filter streams through an
    IndexProbe, and the counts, plans and explain texts equal the
    reference's."""
    got = {}
    for pk in (REF, PORT):
        sess, df = _indexed(pk, mode)
        n = len(df[(df["onePercent"] >= 10) & (df["onePercent"] <= 30)])
        phys = sess.last_physical
        assert isinstance(phys, pk.PH.IndexOnlyCount)
        if mode == "kernel":
            assert "chosen over" in phys.note
        rows = df[(df["onePercent"] >= 3) & (df["onePercent"] <= 4)
                  & (df["two"] == 1)].head(6)
        probe = [x for x in pk.PH.walk(sess.last_physical)
                 if isinstance(x, pk.PH.IndexProbe)]
        text = sess.explain(pk.P.Agg(
            df[(df["onePercent"] >= 10) & (df["onePercent"] <= 30)]._plan,
            [pk.P.AggSpec("count", "count", None)]))
        got[pk.name] = (n, phys.note, len(probe), rows, text, counts(sess))
    assert got["port"][:3] == got["ref"][:3]
    assert_same(got["port"][3], got["ref"][3], "probe rows")
    assert got["port"][4:] == got["ref"][4:]


@pytest.mark.parametrize("mode", ["gspmd", "kernel"])
def test_presorted_join_build_side_equals_reference(mode):
    """A join count whose build side is a bare indexed scan reads the
    index's sorted keys instead of sorting (the merge_join kernel's right
    operand in kernel mode)."""
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 2_000, 4_096).astype(np.int32)  # duplicates
    got = {}
    for pk in (REF, PORT):
        sess = pk.session(mode)
        sess.create_dataset("keys", pk.Table({"k": keys.copy()}),
                            dataverse="ix", indexes=["k"])
        sess.create_dataset("probe", pk.wisconsin.generate(3_000, seed=8),
                            dataverse="ix")
        probe = pk.AFrame("ix", "probe", session=sess)
        build = pk.AFrame("ix", "keys", session=sess)
        n = len(probe.merge(build, left_on="unique1", right_on="k"))
        phys = sess.last_physical
        got[pk.name] = (n, phys.presorted, phys.kernel, phys.label())
    assert got["port"] == got["ref"]
    assert got["port"][1]


def _fed_for_lookup(pk):
    sess = pk.session("kernel")
    sess.create_dataset("Live", pk.wisconsin.generate(2_000, seed=3),
                        dataverse="d", primary="unique2")
    feed = pk.Feed(sess, "Live", "d", flush_rows=10**9,
                   policy=pk.lsm.CompactionPolicy(size_ratio=100.0, max_runs=64))
    rows = host_rows(pk.wisconsin.generate(300, seed=21))
    rows["unique2"] = rows["unique2"] + 2_000
    feed.push(rows)
    feed.flush()
    up = host_rows(pk.wisconsin.generate(3, seed=22))
    up["unique2"] = np.array([5, 2_010, 2_299], np.int32)
    feed.upsert(up)
    feed.delete(np.array([7, 2_020], np.int32))
    feed.flush()
    return sess, feed


def test_point_lookups_equal_reference_and_compile_nothing():
    keys = (5, 6, 7, 2_010, 2_020, 2_299, 1_999, 99_999, -3)
    got = {}
    for pk in (REF, PORT):
        sess, feed = _fed_for_lookup(pk)
        df = pk.AFrame("d", "Live", session=sess)
        before = counts(sess)
        seen = []
        for k in keys:
            seen.append((df.get(k), df.explain_get(k),
                         dict(sess.last_prune_report)))
        assert counts(sess) == before  # no compile, no plan-cache traffic
        assert sess.stats["point_lookups"] == 2 * len(keys)
        feed.compact()
        seen.append([df.get(k) for k in keys])
        got[pk.name] = seen
    for (gr, gt, grep), (wr, wt, wrep) in zip(got["port"][:-1], got["ref"][:-1]):
        assert (gr is None) == (wr is None)
        if wr is not None:
            assert_same(gr, wr, "lookup")
        assert gt == wt
        assert grep == wrep
    for gr, wr in zip(got["port"][-1], got["ref"][-1]):
        assert (gr is None) == (wr is None)
        if wr is not None:
            assert_same(gr, wr, "lookup after compaction")
    assert got["port"][2][0] is None and got["port"][3][0]["unique2"].tolist() == [2_010]


def test_point_lookup_needs_a_primary_key_and_a_bare_frame():
    sess = PORT.session()
    sess.create_dataset("T", PORT.Table({"a": np.arange(5, dtype=np.int32)}),
                        dataverse="d")
    df = PORT.AFrame("d", "T", session=sess)
    with pytest.raises(ValueError, match="primary key"):
        df.get(1)
    with pytest.raises(ValueError, match="pending operations"):
        df[df["a"] > 1].get(1)
