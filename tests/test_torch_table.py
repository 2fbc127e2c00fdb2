"""The port's storage layer against the JAX reference: the Wisconsin
generator, column metadata, derived string lanes, zone maps and the table
helpers must equal the reference's column for column, dtypes included, and
``from_numpy`` must carry a reference table into the port unchanged."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.data import wisconsin as rw
from repro.engine import session as rsession
from repro.engine import table as rt
from repro_torch.data import wisconsin as tw
from repro_torch.engine import session as tsession
from repro_torch.engine import table as tt
from torch_replay import PORT, REF


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_tables_equal(port, ref):
    assert list(port.columns) == list(ref.columns)
    for k in ref.columns:
        a, b = _np(port.columns[k]), _np(ref.columns[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert port.num_rows == ref.num_rows
    assert {k: dataclasses.asdict(m) for k, m in port.meta.items()} == \
        {k: dataclasses.asdict(m) for k, m in ref.meta.items()}


@pytest.mark.parametrize("n,seed", [(1, 0), (4097, 3), (10_000, 11)])
def test_wisconsin_generate_equals_reference(n, seed):
    _assert_tables_equal(tw.generate(n, seed=seed), rw.generate(n, seed=seed))


def test_collected_stats_and_string_lanes_equal_reference():
    """Prefix lanes, dictionary lanes (string4: 4 values) and the distinct
    counts of high-cardinality strings, as the reference's load builds."""
    port = tsession._collect_stats(tw.generate(3000, seed=2))
    ref = rsession._collect_stats(rw.generate(3000, seed=2))
    _assert_tables_equal(port, ref)
    assert "__dict_string4" in port.columns
    assert "__dict_stringu1" not in port.columns  # 3000 distinct > threshold


def test_collected_stats_respect_validity_and_fill_numeric_bounds():
    rng = np.random.default_rng(4)
    n = 700
    strs = rw.encode_strings([f"s{i % 5}" for i in range(n)])
    cols = {"x": rng.integers(-50, 50, n).astype(np.int32),
            "f": np.where(rng.random(n) > 0.1, rng.normal(size=n), np.nan)
            .astype(np.float32),
            "s": np.asarray(strs)}
    ref = rt.pad_to_block(rt.Table(cols), 256)
    port = tt.pad_to_block(tt.Table({k: torch.from_numpy(v) for k, v in cols.items()}),
                           256)
    _assert_tables_equal(tsession._collect_stats(port),
                         rsession._collect_stats(ref))


@pytest.mark.parametrize("block", [256, 4096])
def test_block_zones_equal_reference(block):
    rng = np.random.default_rng(block)
    n = 3000
    cols = {"a": rng.integers(0, 1000, n).astype(np.int32),
            "b": np.sort(rng.integers(-10, 10, n)).astype(np.int32),
            "f": np.where(rng.random(n) > 0.2, rng.normal(size=n), np.nan)
            .astype(np.float32)}
    ref = rt.pad_to_block(rt.Table(cols), 1024)
    port = tt.pad_to_block(tt.Table({k: torch.from_numpy(v) for k, v in cols.items()}),
                           1024)
    _assert_tables_equal(port, ref)
    want = rt.compute_block_zones(ref, block)
    got = tt.compute_block_zones(port, block)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_string_helpers_equal_reference():
    vals = ["", "abc", "AAAAxxxx", "a" * 20, "trailing  ", "Z"]
    enc = tt.encode_strings(vals)
    assert enc.dtype == torch.uint8
    np.testing.assert_array_equal(enc.numpy(), rt.encode_strings(vals))
    assert tt.decode_strings(enc) == rt.decode_strings(rt.encode_strings(vals))
    np.testing.assert_array_equal(tt.pack_prefix(enc).numpy(),
                                  rt.pack_prefix(rt.encode_strings(vals)))
    assert [tt.canon_string(v) for v in vals] == [rt.canon_string(v) for v in vals]


def test_from_numpy_round_trips_a_reference_table():
    ref = rsession._collect_stats(rw.generate(2000, seed=9))
    port = tt.from_numpy({k: np.asarray(v) for k, v in ref.columns.items()},
                         {k: dataclasses.asdict(m) for k, m in ref.meta.items()},
                         device="cpu")
    _assert_tables_equal(port, ref)
    assert port.device == torch.device("cpu")


def test_concat_tables_equals_reference():
    a, b = rw.generate(100, seed=1), rw.generate(50, seed=2)
    ta, tb = tw.generate(100, seed=1), tw.generate(50, seed=2)
    _assert_tables_equal(tt.concat_tables(ta, tb), rt.concat_tables(a, b))


def test_block_zones_skip_anti_matter_and_index_copies():
    """Block zones are taken over matter rows only (valid and not
    anti-matter) and never over ``__ix*`` index copies, as the reference's:
    the ten anti-matter rows at the head of block 0 carry key 100,000 and
    must not widen its span, nor the dead tail block 1's."""
    n = 8192
    k = np.arange(n, dtype=np.int32)
    k[:10] = 100_000
    anti = np.zeros(n, bool)
    anti[:10] = True
    valid = np.ones(n, bool)
    valid[-100:] = False
    v = np.linspace(-1, 1, n, dtype=np.float32)
    v[:10] = 50.0
    v[20] = np.nan
    cols = {"k": k, "v": v, "__valid__": valid, "__antimatter__": anti,
            "__ix_k__": np.sort(k)}
    want = rt.compute_block_zones(rt.Table(cols), 4096)
    got = tt.compute_block_zones(
        tt.Table({c: torch.from_numpy(a) for c, a in cols.items()}), 4096)
    assert set(got) == set(want) == {"k", "v"}
    for c in want:
        assert got[c].dtype == want[c].dtype, c
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)
    np.testing.assert_array_equal(got["k"], [[10, 4095], [4096, 8091]])


def test_clustered_range_over_an_upsert_run_skips_reference_blocks():
    """An upsert run holds its anti-matter after the matter prefix: the
    anti rows' keys (the upserted ones, 0..4999) fill the run's second
    block. A clustered range over the low keys must skip that block as the
    reference does — the zone span of its matter is [4096, 4999]. (The
    LSM also marks its anti rows ``__valid__`` False, so the run's spans
    hold without the anti-matter mask too; the mask matters for a table
    that flags anti-matter on valid rows, as the test above.)"""
    out = {}
    for pk in (REF, PORT):
        sess = pk.session("kernel", enable_index=False)  # the kernel path
        base = {"k": np.arange(8192, dtype=np.int32),
                "v": np.ones(8192, np.int32)}
        sess.create_dataset("U", pk.Table(base), dataverse="c2", primary="k")
        feed = pk.Feed(sess, "U", "c2", flush_rows=10**9,
                       policy=pk.lsm.CompactionPolicy(size_ratio=10.0,
                                                      max_runs=64))
        feed.upsert({"k": np.arange(5000, dtype=np.int32),
                     "v": np.full(5000, 2, np.int32)})
        feed.flush()
        df = pk.AFrame("c2", "U", session=sess)
        n = len(df[(df["k"] >= 0) & (df["k"] <= 100)])
        rep = sess.last_prune_report
        runs = [p for p in pk.PH.walk(sess.last_physical)
                if getattr(p, "dataset", None) == "U@run0"]
        out[pk.name] = (n, rep["blocks_scanned"], rep["blocks_skipped"],
                        [r.block_ids for r in runs], sess.stats["compiles"])
    assert out["port"] == out["ref"]
    assert out["port"][0] == 101 and out["port"][2] > 0
    assert out["port"][3] == [(0,)]


@pytest.mark.parametrize("names,k", [(["unique1", "string4"], 5),
                                     (["ten"], 0), (["two", "unique2"], 10_000)])
def test_select_and_head_dict_equal_reference(names, k):
    """``Table.select`` keeps the named columns, their meta and the row
    count; ``head_dict(k)`` gives each column's first k rows as numpy (k
    past the length: every row), as the reference's."""
    ref = rsession._collect_stats(rw.generate(2000, seed=4))
    port = tt.from_numpy({c: np.asarray(v) for c, v in ref.columns.items()},
                         {c: dataclasses.asdict(m) for c, m in ref.meta.items()},
                         device="cpu")
    _assert_tables_equal(port.select(names), ref.select(names))
    got, want = port.head_dict(k), ref.head_dict(k)
    assert list(got) == list(want)
    for c in want:
        assert isinstance(got[c], np.ndarray)
        assert got[c].dtype == want[c].dtype, c
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)
