"""The multi-device engine on the port (``repro_torch.engine.distributed``,
``launch/mesh.py``): a mesh of S row shards, all on one device (the CPU
here), every operator shard-local with an explicit merge.

Held against the reference three ways:
  * each ``dist_*`` operator on 1-, 2- and 8-shard port meshes against the
    reference's operator on a 1-device jax mesh in this process, on the
    same seeded numpy inputs (integers exactly, float sums at rtol 1e-6:
    a psum adds f32 partials in another order than one device does);
  * the three green reference tests of tests/test_distributed.py replayed
    on the port's 8-shard mesh;
  * the reference run on 8 forced host devices in a subprocess (as
    tests/test_distributed.py::run_script does), printing JSON: the port's
    8-shard sessions give its results (dtypes included), explain texts with
    their per-shard notes, prune reports, hash-repartition totals and drops,
    and the kernel families dispatched."""
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RMesh

from repro.engine import distributed as RD
from repro.engine import index as rindex
from repro.engine import physical as rphys
from repro_torch.engine import distributed as D
from repro_torch.engine import index as tindex
from repro_torch.engine import physical as tphys
from repro_torch.kernels import ops as tops
from repro_torch.launch.mesh import MeshAxes, make_local_mesh

from engine_probe import sharded_probe
from torch_replay import PORT, assert_same

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHARDS = (1, 2, 8)
N = 16_000           # 2,000 rows a shard at S = 8
AXES = ("data",)
FLOAT_RTOL = 1e-6    # float psums: f32 partials added in another order


@pytest.fixture(scope="module")
def rmesh():
    return RMesh(np.array(jax.devices()[:1]), AXES)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    cols = {k: np.asarray(v) for k, v in
            PORT.wisconsin.generate(N, seed=3).columns.items()}
    cols["f"] = rng.normal(size=N).astype(np.float32)
    return cols, rng.random(N) < 0.7


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mesh(s):
    return make_local_mesh(s, device="cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


_REF_CACHE: dict = {}


def _ref(key, fn):
    """The reference's result for one operator case, computed once and
    held against every shard count (a jax shard_map call compiles each
    time it is built)."""
    if key not in _REF_CACHE:
        _REF_CACHE[key] = jax.tree_util.tree_map(np.asarray, fn())
    return _REF_CACHE[key]


def _same_array(got, want, label, rtol=0.0):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype, (label, got.dtype, want.dtype)
    if rtol:
        np.testing.assert_allclose(got, want, rtol=rtol, err_msg=label)
    else:
        np.testing.assert_array_equal(got, want, err_msg=label)


# -- mesh and collectives -------------------------------------------------------


def test_local_mesh_layout():
    mesh = make_local_mesh(8, 2, device="cpu")
    assert mesh.shape == {"data": 8, "model": 2}
    assert mesh.axis_names == ("data", "model") and mesh.size == 16
    assert mesh.devices.shape == (8, 2)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    axes = MeshAxes.for_mesh(mesh)
    assert axes.data == ("data",) and axes.data_size(mesh) == 8
    assert axes.model_size(mesh) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_local_mesh(8)


@pytest.mark.parametrize("s", SHARDS)
def test_collectives(s):
    """One partial per shard in shard order: psum / pmax / pmin reduce in
    the partials' dtype, all_gather concatenates, all_to_all transposes the
    (S, ...) blocks; shard views are views of the one tensor."""
    x = torch.arange(s * 6, dtype=torch.int32)
    views = D.shard_views(x, s)
    assert all(v.data_ptr() == x[i * 6:].data_ptr() for i, v in enumerate(views))
    parts = [v.sum(dtype=torch.int32) for v in views]
    assert D.psum(parts).dtype == torch.int32
    assert int(D.psum(parts)) == int(x.sum())
    assert int(D.pmax([v.max() for v in views])) == s * 6 - 1
    assert int(D.pmin([v.min() for v in views])) == 0
    assert torch.equal(D.all_gather(views), x)
    blocks = [torch.arange(s * 2).view(s, 2) + 100 * src for src in range(s)]
    got = D.all_to_all(blocks)
    for d in range(s):
        want = torch.cat([blocks[src][d] for src in range(s)])
        assert torch.equal(got[d], want)
    # a length that does not split evenly pads with dead rows
    odd = D.shard_views(torch.ones(s * 6 + 1, dtype=torch.bool), s)
    assert sum(int(v.sum()) for v in odd) == s * 6 + 1


# -- the operators against the reference's, on a 1-device jax mesh -------------


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("op", ["count", "sum", "max", "min", "mean"])
@pytest.mark.parametrize("col", ["unique1", "f"])
def test_dist_agg(rmesh, data, s, op, col):
    cols, mask = data
    want = _ref(("agg", op, col),
                lambda: RD.dist_agg(rmesh, AXES, op, cols[col], mask))
    got = D.dist_agg(_mesh(s), AXES, op, _t(cols[col]), _t(mask))
    float_sum = op == "mean" or (op == "sum" and col == "f")
    _same_array(got, want, f"{s}:{op}:{col}", FLOAT_RTOL if float_sum else 0.0)
    if op == "count":
        _same_array(D.dist_count(_mesh(s), AXES, _t(mask)),
                    _ref("count", lambda: RD.dist_count(rmesh, AXES, mask)),
                    f"{s}:count")


@pytest.mark.parametrize("s", SHARDS)
def test_dist_group_agg(rmesh, data, s):
    """psum / pmax / pmin merges, mean as psum(sum) / psum(count); the Wisconsin
    sums are integers below 2^24, so every result is exact."""
    cols, mask = data
    aggs = [("count", "count", None), ("sum_four", "sum", "four"),
            ("mean_two", "mean", "two"), ("max_u1", "max", "unique1"),
            ("min_u2", "min", "unique2"), ("max_f", "max", "f")]
    vals = ("four", "two", "unique1", "unique2", "f")
    want, wm = _ref("group", lambda: RD.dist_group_agg(
        rmesh, AXES, cols["ten"], mask, 0, 12, aggs, {c: cols[c] for c in vals}))
    got, gm = D.dist_group_agg(_mesh(s), AXES, _t(cols["ten"]), _t(mask), 0,
                               12, aggs, {c: _t(cols[c]) for c in vals})
    _same_array(gm, wm, "gmask")
    live = _np(wm)
    for k in want:
        _same_array(_np(got[k])[live], np.asarray(want[k])[live], k)


def _live_rows(env, mask):
    m = _np(mask)
    return {k: _np(v)[m] for k, v in env.items()}, m


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("key,k,asc", [("unique1", 7, False),
                                       ("ten", 9, True), ("f", 5, False)])
def test_dist_topk(rmesh, data, s, kernel, key, k, asc):
    """Shard-major candidates keep "ties to the lower row" (``ten`` is all
    ties); the kernel selection primitive (block_topk) merges the same."""
    cols, mask = data
    names = ("unique1", "ten", "f", "stringu1")
    rsel = rphys.kernel_topk_select() if kernel else rphys._select_topk
    tsel = tphys.kernel_topk_select() if kernel else tphys._select_topk
    want = _ref(("topk", kernel, key), lambda: RD.dist_topk(
        rmesh, AXES, {n: cols[n] for n in names}, mask, key, k, asc,
        select=rsel))
    got = D.dist_topk(_mesh(s), AXES, {n: _t(cols[n]) for n in names},
                      _t(mask), key, k, asc, select=tsel)
    wl, wm = _live_rows(*want)
    gl, gm = _live_rows(*got)
    np.testing.assert_array_equal(gm, wm)
    assert_same(gl, wl, f"topk {s} {key}")


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("n", [1, 9, 3000])
def test_dist_limit(rmesh, data, s, n):
    """The first n live rows in shard-major order = row order."""
    cols, mask = data
    sparse = mask & (cols["ten"] == 3)
    names = ("unique2", "stringu1")
    want = _ref(("limit", n), lambda: RD.dist_limit(
        rmesh, AXES, {c: cols[c] for c in names}, sparse, n))
    got = D.dist_limit(_mesh(s), AXES, {c: _t(cols[c]) for c in names},
                       _t(sparse), n)
    wl, wm = _live_rows(*want)
    gl, gm = _live_rows(*got)
    np.testing.assert_array_equal(gm, wm)
    assert_same(gl, wl, f"limit {s} {n}")


def _index_keys(keys, valid, s, ref=False):
    """A per-shard sorted index (pad rows at each shard's +inf tail)."""
    if ref:
        return np.asarray(rindex.build_index_local(keys, valid, "k").sorted_keys)
    return tindex.build_index(_t(keys), _t(valid), "k", n_shards=s).sorted_keys


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("presorted", [False, True])
@pytest.mark.parametrize("kernel", [False, True])
def test_dist_join_count(rmesh, data, s, presorted, kernel):
    """Gathered build side, shard-local probes, psum; int32 as the
    reference's x64-off result, and equal to numpy."""
    cols, mask = data
    lk, rk = cols["unique1"], cols["onePercent"]
    rm = cols["two"] == 0
    want_np = sum(int(((lk == v) & mask).sum()) * int(((rk == v) & rm).sum())
                  for v in np.unique(rk[rm]))
    r_in = _index_keys(rk, rm, 1, ref=True) if presorted else rk
    t_in = _index_keys(rk, rm, s) if presorted else _t(rk)
    rfn = RD.dist_kernel_join_count if kernel else RD.dist_join_count
    tfn = D.dist_kernel_join_count if kernel else D.dist_join_count
    want = _ref(("join", presorted, kernel), lambda: rfn(
        rmesh, AXES, lk, mask, r_in, rm, presorted_right=presorted))
    got = tfn(_mesh(s), AXES, _t(lk), _t(mask), t_in, _t(rm),
              presorted_right=presorted)
    _same_array(got, want, "join count")
    assert int(got) == want_np


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("col,cf", [("unique1", 2.0), ("ten", 12.0)])
def test_hash_repartition_counts(rmesh, data, s, col, cf):
    cols, mask = data
    k = cols[col]
    want = _ref(("hash", col), lambda: RD.hash_repartition_counts(
        rmesh, AXES, k, mask, k, mask, capacity_factor=cf))
    got = D.hash_repartition_counts(_mesh(s), AXES, _t(k), _t(mask), _t(k),
                                    _t(mask), capacity_factor=cf)
    for g, w in zip(got, want):
        _same_array(g, w, f"hash {s} {col}")
    assert int(got[1]) == 0
    assert int(got[0]) == sum(int(((k == v) & mask).sum()) ** 2
                              for v in np.unique(k[mask]))


def test_hash_repartition_drops_over_capacity(data):
    """Buckets past their capacity drop rows and count them: the drops
    plus what was kept account for every live row."""
    cols, mask = data
    k = _t(cols["ten"])
    total, drops = D.hash_repartition_counts(_mesh(8), AXES, k, _t(mask), k,
                                             _t(mask), capacity_factor=1.0)
    assert int(drops) > 0 and total.dtype == torch.int32


def _shard_blocks(s, rps, block, keep):
    """A -1-padded per-shard kernel-block matrix: shard ``i`` keeps the
    local blocks ``keep(i, nb)`` (an empty list: an all -1 row)."""
    nb = -(-rps // block)
    per = [keep(i, nb) for i in range(s)]
    m = max(1, max(len(p) for p in per))
    out = np.full((s, m), -1, np.int32)
    for i, p in enumerate(per):
        out[i, :len(p)] = p
    return out


def _block_rows(sb, rps, block, n):
    rows = np.zeros(n, bool)
    for s, ids in enumerate(sb):
        for b in ids[ids >= 0]:
            rows[s * rps + b * block: s * rps + min((b + 1) * block, rps)] = True
    return rows


N_BLOCKS = 20_000    # 10,000 rows a shard at S = 2: three filter_count tiles


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("blocks", [None, "listed"])
def test_dist_kernel_filter_count(rmesh, s, blocks):
    """filter_count once per shard over unstacked column views; with a
    per-shard block matrix (an all -1 row included) each shard scans only
    its own listed tiles."""
    from repro_torch.kernels.filter_count import BLOCK

    rng = np.random.default_rng(4)
    cols = [rng.integers(0, 10, N_BLOCKS).astype(np.int32) for _ in range(2)]
    valid = (rng.random(N_BLOCKS) < 0.9).astype(np.int32)
    bounds = np.array([[2, 6], [0, 4], [1, 1]], np.int32)
    mat = np.stack(cols + [valid])
    hit = np.all((mat >= bounds[:, :1]) & (mat <= bounds[:, 1:]), axis=0)
    tcols = [_t(c) for c in (*cols, valid)]
    if blocks is None:
        want = _ref("fc", lambda: RD.dist_kernel_filter_count(
            rmesh, AXES, mat, bounds))
        got = D.dist_kernel_filter_count(_mesh(s), AXES, tcols, _t(bounds))
        _same_array(got, want, "filter_count")
        assert int(got) == int(hit.sum())
        return
    rps = N_BLOCKS // s
    sb = _shard_blocks(s, rps, BLOCK,
                       lambda i, nb: [] if i == s - 1 and s > 1
                       else list(range(i % 2, nb, 2)))
    got = D.dist_kernel_filter_count(_mesh(s), AXES, tcols, _t(bounds),
                                     shard_blocks=sb)
    assert int(got) == int((hit & _block_rows(sb, rps, BLOCK, N_BLOCKS)).sum())
    if s == 1:  # one shard: the same survivors as a global block list
        ids = tuple(int(b) for b in sb[0] if b >= 0)
        _same_array(got, RD.dist_kernel_filter_count(
            rmesh, AXES, mat, bounds, block_ids=ids), "global ids")


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("blocks", [None, "listed"])
def test_dist_kernel_group_agg(rmesh, s, op, blocks):
    from repro_torch.kernels.segment_agg import BLOCK

    rng = np.random.default_rng(5)
    gids = rng.integers(-1, 7, N_BLOCKS).astype(np.int32)
    values = rng.integers(0, 50, (N_BLOCKS, 2)).astype(np.float32)
    if blocks is None:
        want = _ref(("sa", op), lambda: RD.dist_kernel_group_agg(
            rmesh, AXES, gids, values, 7, op=op))
        got = D.dist_kernel_group_agg(_mesh(s), AXES, _t(gids), _t(values),
                                      7, op=op)
        _same_array(got, want, f"segment_agg {op}")
        return
    rps = N_BLOCKS // s
    sb = _shard_blocks(s, rps, BLOCK,
                       lambda i, nb: [] if i == 0 and s > 1
                       else list(range(0, nb, 3)))
    got = D.dist_kernel_group_agg(_mesh(s), AXES, _t(gids), _t(values), 7,
                                  op=op, shard_blocks=sb)
    rows = _block_rows(sb, rps, BLOCK, N_BLOCKS)
    want = RD.dist_kernel_group_agg(rmesh, AXES, np.where(rows, gids, -1),
                                    values, 7, op=op)
    _same_array(got, want, f"segment_agg {op} listed")


@pytest.mark.parametrize("s", SHARDS)
def test_dist_index_and_shadow_count(rmesh, data, s):
    """Per-shard binary searches over a per-shard sorted index, psum."""
    cols, mask = data
    keys = cols["unique1"]
    anti = np.unique(keys[::97])
    r_ix = np.asarray(rindex.build_index_local(keys, mask, "k").sorted_keys)
    t_ix = tindex.build_index(_t(keys), _t(mask), "k", n_shards=s).sorted_keys
    for lo, hi in ((100, 5000), (None, 800), (15_000, None)):
        want = _ref(("index", lo, hi), lambda: RD.dist_index_count(
            rmesh, AXES, r_ix, mask, lo, hi))
        got = D.dist_index_count(_mesh(s), AXES, t_ix, _t(mask), lo, hi)
        _same_array(got, want, f"index {lo} {hi}")
        want = _ref(("shadow", lo, hi), lambda: RD.dist_shadow_count(
            rmesh, AXES, r_ix, mask, anti, lo, hi))
        got = D.dist_shadow_count(_mesh(s), AXES, t_ix, _t(mask), _t(anti),
                                  lo, hi)
        _same_array(got, want, f"shadow {lo} {hi}")


# -- the reference's green multi-device tests, on the port's 8-shard mesh -------


def _port_session(mode, n, seed, **create):
    from repro_torch.core.frame import AFrame
    from repro_torch.engine.session import Session

    t = PORT.wisconsin.generate(n, seed=seed)
    raw = {k: v.numpy() for k, v in t.columns.items()}
    sess = Session(mesh=_mesh(8), mode=mode)
    sess.create_dataset("Data", t, dataverse="demo", **create)
    return sess, AFrame("demo", "Data", session=sess), raw


def test_dataframe_shard_map_equivalence():
    """tests/test_distributed.py::test_dataframe_shard_map_equivalence."""
    from repro_torch.core.frame import AFrame

    sess, df, raw = _port_session("shard_map", 10_000, 1,
                                  indexes=["onePercent", "unique1"],
                                  primary="unique2")
    assert len(df) == 10_000
    n = len(df[(df["ten"] == 3) & (df["twentyPercent"] == 2) & (df["two"] == 1)])
    assert n == int(((raw["ten"] == 3) & (raw["twentyPercent"] == 2)
                     & (raw["two"] == 1)).sum())
    assert df["unique1"].max() == raw["unique1"].max()
    g = df.groupby("oddOnePercent").agg("count")
    assert g["count"].sum() == 10_000 and len(g["count"]) == 100
    sh = df.sort_values("unique1", ascending=False).head(5)
    assert list(sh["unique1"]) == sorted(raw["unique1"])[-5:][::-1]
    n = len(df[(df["onePercent"] >= 10) & (df["onePercent"] <= 30)])
    assert n == int(((raw["onePercent"] >= 10) & (raw["onePercent"] <= 30)).sum())
    df2 = AFrame("demo", "Data", session=sess)
    assert len(df.merge(df2, left_on="unique1", right_on="unique1")) == 10_000


def test_dataframe_kernel_mode_sharded_equivalence():
    """tests/test_distributed.py::test_dataframe_kernel_mode_sharded_equivalence:
    every kernel family runs once per shard."""
    from repro_torch.core.frame import AFrame

    sess, df, raw = _port_session("kernel", 10_000, 1)
    tops.reset_dispatch_counts()
    n = len(df[(df["ten"] == 3) & (df["twentyPercent"] == 3) & (df["two"] == 1)])
    assert n == int(((raw["ten"] == 3) & (raw["twentyPercent"] == 3)
                     & (raw["two"] == 1)).sum())
    assert tops.DISPATCH_COUNTS["filter_count"] == 8
    g = df.groupby("oddOnePercent").agg("count")
    assert g["count"].sum() == 10_000 and len(g["count"]) == 100
    assert tops.DISPATCH_COUNTS["segment_agg"] == 8
    sh = df.sort_values("unique1", ascending=False).head(5)
    assert list(sh["unique1"]) == sorted(raw["unique1"])[-5:][::-1]
    assert tops.DISPATCH_COUNTS["topk"] == 8 + 1   # per shard, then the merge
    n = len(df[(df["onePercent"] >= 10) & (df["onePercent"] <= 30)])
    assert n == int(((raw["onePercent"] >= 10) & (raw["onePercent"] <= 30)).sum())
    df2 = AFrame("demo", "Data", session=sess)
    assert len(df.merge(df2, left_on="unique1", right_on="unique1")) == 10_000
    assert tops.DISPATCH_COUNTS["merge_join_count"] == 8


def test_hash_repartition_join():
    """tests/test_distributed.py::test_hash_repartition_join."""
    sess, _, _ = _port_session("shard_map", 8_000, 2)
    ds = sess.catalog.get("demo", "Data")
    k, m = ds.table.columns["unique1"], ds.table.valid
    total, drops = D.hash_repartition_counts(sess.mesh, AXES, k, m, k, m)
    assert int(total) == 8_000 and int(drops) == 0
    k2 = ds.table.columns["ten"]
    total2, _ = D.hash_repartition_counts(sess.mesh, AXES, k2, m, k2, m,
                                          capacity_factor=12.0)
    want = sum(int((k2.numpy() == v).sum()) ** 2 for v in range(10))
    assert int(total2) == want


# -- the reference on 8 forced host devices, in a subprocess ---------------------


_REF8 = r"""
import json, sys
import numpy as np
sys.path.insert(0, TESTS)
from engine_probe import sharded_probe
from repro.core import plan as P
from repro.core.expr import Col
from repro.core.frame import AFrame
from repro.data import wisconsin
from repro.engine import distributed as D
from repro.engine.session import Session
from repro.kernels import ops
from repro.launch.mesh import make_local_mesh

mesh = make_local_mesh(data=8, model=1)
out = sharded_probe(Session, AFrame, P, Col, wisconsin, ops, D, mesh)
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref8():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    body = _REF8.replace("TESTS", repr(str(ROOT / "tests")))
    r = subprocess.run([sys.executable, "-c", body], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr[-3000:]}"
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("JSON")][-1]
    return json.loads(line[4:])


@pytest.fixture(scope="module")
def port8():
    from repro_torch.core import plan as P
    from repro_torch.core.expr import Col
    from repro_torch.core.frame import AFrame
    from repro_torch.engine.session import Session

    return json.loads(json.dumps(sharded_probe(
        Session, AFrame, P, Col, PORT.wisconsin, tops, D, _mesh(8))))


def _clustered_oracle(name):
    """numpy answers of the block-skipping plans of ``sharded_probe``."""
    raw = {k: v.numpy() for k, v in
           PORT.wisconsin.generate(10_000, seed=5).columns.items()}
    sel = (raw["unique2"] >= 1000) & (raw["unique2"] <= 3000)
    if name == "range_count":
        return [int(sel.sum()), "int"]
    if name == "max":
        return [int(raw["unique1"][sel].max()), "int"]
    counts = np.bincount(raw["ten"][sel], minlength=10)
    return {"ten": [list(range(10)), "int32"],
            "count": [counts.tolist(), "int32"]}


def exprs_meet_ref8(port8, ref8) -> None:
    """The rules the 8-device reference's expressions hold a probe to
    (a probe of the one-process mesh here, of the rank mesh in
    tests/test_torch_rank_engine.py)."""
    assert sorted(port8["exprs"]) == sorted(ref8["exprs"])
    gathered_fails = 0
    for k, want in ref8["exprs"].items():
        if isinstance(want, list) and want[0] == "error":
            assert want[1] == "ShardingTypeError", (k, want)
            gathered_fails += 1
            assert port8["exprs"][k] == _clustered_oracle(k.split(":")[1]), k
        else:
            assert port8["exprs"][k] == want, k
    assert port8["exprs"]["kernel:range_count"] == \
        _clustered_oracle("range_count")
    assert gathered_fails < len(ref8["exprs"]) // 2


def explain_meets_ref8(port8, ref8) -> None:
    for k, want in ref8["explain"].items():
        assert port8["explain"][k] == want, k
    assert any("8 shards, per-shard" in t for t in port8["explain"].values())
    for k, want in ref8["report"].items():
        assert port8["report"][k] == want, k
    assert port8["report"]["kernel:range_count"]["shards"] == 8
    assert port8["report"]["kernel:range_count"]["blocks_skipped"] > 0


def repartition_meets_ref8(port8, ref8) -> None:
    assert port8["hash"] == ref8["hash"] == [10_000, 0]
    assert port8["hash_small"] == ref8["hash_small"]
    assert ref8["hash_small"][1] > 0            # drops over capacity
    assert port8["dispatch"] == ref8["dispatch"]


def test_sharded_results_equal_the_8_device_reference(ref8, port8):
    """The 12 expressions and the block-skipping plans in shard_map and
    kernel mode: values and dtypes equal the reference's on 8 devices.
    Where the reference's own sharded block gather fails inside the
    installed jax (``ShardingTypeError``: a gathered length not divisible
    by the mesh), the port's answer is held against numpy instead."""
    exprs_meet_ref8(port8, ref8)


def test_sharded_explain_equals_the_8_device_reference(ref8, port8):
    """Explain texts (per-shard zone-map notes included) and prune reports
    equal the reference's."""
    explain_meets_ref8(port8, ref8)


def test_sharded_repartition_and_dispatch_equal_the_8_device_reference(
        ref8, port8):
    repartition_meets_ref8(port8, ref8)


def test_gspmd_on_a_sharded_mesh_searches_indexes_per_shard():
    """gspmd mode over row-sharded tables: the plain lowering's index-only
    count searches each shard's sorted index on its own (the index is
    sorted per shard), equal to numpy; so do a join and a lookup."""
    from repro_torch.core.frame import AFrame
    from repro_torch.engine.session import Session

    t = PORT.wisconsin.generate(10_000, seed=1)
    raw = {k: v.numpy() for k, v in t.columns.items()}
    sess = Session(mesh=_mesh(8), mode="gspmd")
    sess.create_dataset("Data", t, dataverse="demo",
                        indexes=["onePercent", "unique1"], primary="unique2")
    df = AFrame("demo", "Data", session=sess)
    n = len(df[(df["onePercent"] >= 10) & (df["onePercent"] <= 30)])
    assert type(sess.last_physical).__name__ == "IndexOnlyCount"
    assert n == int(((raw["onePercent"] >= 10) & (raw["onePercent"] <= 30)).sum())
    df2 = AFrame("demo", "Data", session=sess)
    assert len(df.merge(df2, left_on="unique1", right_on="unique1")) == 10_000
    assert int(df.get(4321)["unique2"][0]) == 4321
