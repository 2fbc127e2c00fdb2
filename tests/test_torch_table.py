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
