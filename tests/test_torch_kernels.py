"""The port's relational kernels against the JAX reference: each kernel's
plain PyTorch version (what its wrapper runs on CPU tensors) against
``repro.kernels.ref`` and the Pallas kernel in interpret mode, on the
``tests/test_kernels.py`` sweep shapes plus block-id lists, ties and blocks
with fewer than k live rows, -1-padded per-shard id lists (``block_ids_arr``)
and join keys in long runs cut by the prefixes. Counts and indices are
exact; segment_agg is exact on integer-valued data and within the
reference's own tolerance (rtol 1e-5, atol 1e-3) on normal data. A numpy
model of merge_join's tile windows and per-thread walk holds the CUDA
kernel's rule to the reference. The CUDA kernels themselves run only on
the card: tests/test_torch_cuda.py and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref
from repro.kernels.filter_count import filter_count as pallas_filter_count
from repro.kernels.merge_join import merge_join_count as pallas_merge_join
from repro.kernels.segment_agg import segment_agg as pallas_segment_agg
from repro.kernels.topk_mask import block_topk as pallas_block_topk
from repro.kernels.topk_mask import topk_merge as pallas_topk_merge
from repro_torch.kernels import _build, ops
from repro_torch.kernels import filter_count as fc
from repro_torch.kernels import merge_join as mj
from repro_torch.kernels import segment_agg as sa
from repro_torch.kernels import topk_mask as tk


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n,k,block,ids", [
    (1000, 1, 256, None), (5000, 3, 512, None), (8192, 2, 4096, None),
    (300, 4, 128, None), (5000, 3, 512, (0, 3, 4, 9)), (8192, 2, 4096, (1,))])
def test_filter_count_matches_reference(n, k, block, ids):
    rng = np.random.default_rng(n + k)
    cols = rng.integers(0, 50, (k, n)).astype(np.int32)
    bounds = np.sort(rng.integers(0, 50, (k, 2)), axis=1).astype(np.int32)
    nv = int(n * 0.9)
    got = fc.filter_count(_t(cols), _t(bounds), nv, block=block, block_ids=ids)
    assert got.dtype == torch.int32 and got.shape == ()
    want = ref.filter_count(jnp.asarray(cols), jnp.asarray(bounds), nv,
                            block_ids=ids, block=block)
    pallas = pallas_filter_count(jnp.asarray(cols), jnp.asarray(bounds), nv,
                                 block=block, block_ids=ids)
    assert int(got) == int(want) == int(pallas)


@pytest.mark.parametrize("n,c,g,block,ids", [
    (1000, 1, 7, 256, None), (4096, 4, 20, 1024, None), (513, 3, 100, 256, None),
    (4096, 2, 20, 1024, (0, 2))])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_segment_agg_matches_reference(n, c, g, block, ids, op):
    rng = np.random.default_rng(n + c + g)
    vals = rng.normal(size=(n, c)).astype(np.float32)
    gids = rng.integers(-1, g + 1, n).astype(np.int32)  # includes out-of-range ids
    nv = n - 5
    got = sa.segment_agg(_t(vals), _t(gids), g, nv, op=op, block=block,
                         block_ids=ids)
    assert got.dtype == torch.float32 and got.shape == (g, c)
    want = ref.segment_agg(jnp.asarray(vals), jnp.asarray(gids), g, nv, op,
                           block_ids=ids, block=block)
    pallas = pallas_segment_agg(jnp.asarray(vals), jnp.asarray(gids), g, nv,
                                op=op, block=block, block_ids=ids)
    if op == "sum":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-5, atol=1e-3)
    else:  # extremes select one input value: exact, identity in empty groups
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


def test_segment_agg_exact_on_integer_data():
    """The planner routes here only under the f32-exactness proof: integer
    values whose group sums stay below 2^24 must come back bit-exact."""
    rng = np.random.default_rng(3)
    n, g = 8192, 13
    vals = rng.integers(-1000, 1000, (n, 3)).astype(np.float32)
    gids = rng.integers(0, g, n).astype(np.int32)
    got = sa.segment_agg(_t(vals), _t(gids), g, n)
    pallas = pallas_segment_agg(jnp.asarray(vals), jnp.asarray(gids), g, n)
    want = np.zeros((g, 3), np.int64)
    np.add.at(want, gids, vals.astype(np.int64))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("nl,nr,dom", [(500, 700, 50), (2048, 2048, 5000),
                                       (100, 4000, 10)])
def test_merge_join_matches_reference(nl, nr, dom):
    rng = np.random.default_rng(nl + nr)
    l = np.sort(rng.integers(0, dom, nl)).astype(np.int32)
    r = np.sort(rng.integers(0, dom, nr)).astype(np.int32)
    got = mj.merge_join_count(_t(l), _t(r), nl - 3, nr - 7)
    assert got.dtype == torch.int32
    want = ref.merge_join_count(jnp.asarray(l), jnp.asarray(r), nl - 3, nr - 7)
    pallas = pallas_merge_join(jnp.asarray(l), jnp.asarray(r), nl - 3, nr - 7,
                               block=128)
    assert int(got) == int(want) == int(pallas)


# -1-padded per-shard id lists (block_ids_arr), in the kernel's own block
# units: trailing pads, pads mid-list, and a list of pads only
ARR_IDS = [(0, 3, 4, -1, -1), (2, -1, 0, -1, 5), (-1, -1), (1,)]


@pytest.mark.parametrize("ids", ARR_IDS)
@pytest.mark.parametrize("n,k,block", [(5000, 3, 512), (2900, 1, 512)])
def test_filter_count_block_ids_arr_matches_reference(n, k, block, ids):
    rng = np.random.default_rng(n + k + len(ids))
    cols = rng.integers(0, 50, (k, n)).astype(np.int32)
    bounds = np.sort(rng.integers(0, 50, (k, 2)), axis=1).astype(np.int32)
    arr = np.asarray(ids, np.int32)
    nv = n - 37
    got = fc.filter_count(_t(cols), _t(bounds), nv, block=block,
                          block_ids_arr=_t(arr))
    assert got.dtype == torch.int32 and got.shape == ()
    want = ref.filter_count(jnp.asarray(cols), jnp.asarray(bounds), nv,
                            block=block, block_ids_arr=jnp.asarray(arr))
    pallas = pallas_filter_count(jnp.asarray(cols), jnp.asarray(bounds), nv,
                                 block=block, block_ids_arr=jnp.asarray(arr))
    assert int(got) == int(want) == int(pallas)
    if all(i < 0 for i in ids):
        assert int(got) == 0


@pytest.mark.parametrize("ids", ARR_IDS)
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_segment_agg_block_ids_arr_matches_reference(op, ids):
    n, c, g, block = 2900, 2, 20, 512  # the last block ragged, cut by n_valid
    rng = np.random.default_rng(len(ids) + c)
    vals = rng.normal(size=(n, c)).astype(np.float32)
    gids = rng.integers(-1, g + 1, n).astype(np.int32)
    arr = np.asarray(ids, np.int32)
    nv = n - 101
    got = sa.segment_agg(_t(vals), _t(gids), g, nv, op=op, block=block,
                         block_ids_arr=_t(arr))
    assert got.dtype == torch.float32 and got.shape == (g, c)
    want = ref.segment_agg(jnp.asarray(vals), jnp.asarray(gids), g, nv, op,
                           block=block, block_ids_arr=jnp.asarray(arr))
    pallas = pallas_segment_agg(jnp.asarray(vals), jnp.asarray(gids), g, nv,
                                op=op, block=block,
                                block_ids_arr=jnp.asarray(arr))
    if op == "sum":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-5, atol=1e-3)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    if all(i < 0 for i in ids):  # nothing visited: the identity everywhere
        assert bool((got == sa.IDENTITY[op]).all())


@pytest.mark.parametrize("ids", [(0, 1, -1, 3), (-1,)])
def test_ops_pass_block_ids_arr_through(ids):
    """The ops take block_ids_arr as it is (kernel-block units, no
    expansion), as repro.kernels.ops does; it excludes block_ids."""
    rng = np.random.default_rng(5)
    n = 3 * ops.ZONE_BLOCK_ROWS + 100
    cols = rng.integers(0, 9, (2, n)).astype(np.int32)
    bounds = np.array([[2, 6], [0, 4]], np.int32)
    vals = rng.integers(0, 7, (n, 1)).astype(np.float32)
    gids = rng.integers(0, 9, n).astype(np.int32)
    arr = np.asarray(ids, np.int32)
    ops.reset_dispatch_counts()
    got_fc = ops.filter_count(_t(cols), _t(bounds), n, block_ids_arr=_t(arr))
    got_sa = ops.segment_agg(_t(vals), _t(gids), 9, n, "max",
                             block_ids_arr=_t(arr))
    assert ops.DISPATCH_COUNTS == {"filter_count": 1, "segment_agg": 1}
    want_fc = rops.filter_count(jnp.asarray(cols), jnp.asarray(bounds), n,
                                block_ids_arr=jnp.asarray(arr))
    want_sa = rops.segment_agg(jnp.asarray(vals), jnp.asarray(gids), 9, n,
                               "max", block_ids_arr=jnp.asarray(arr))
    assert int(got_fc) == int(want_fc)
    np.testing.assert_array_equal(got_sa.numpy(), np.asarray(want_sa))
    with pytest.raises(ValueError, match="exclusive"):
        ops.filter_count(_t(cols), _t(bounds), n, block_ids=(0,),
                         block_ids_arr=_t(arr))
    with pytest.raises(ValueError, match="exclusive"):
        ops.segment_agg(_t(vals), _t(gids), 9, n, block_ids=(0,),
                        block_ids_arr=_t(arr))


def _runs(rng, n, lengths):
    """n sorted keys in runs of the given lengths (cycled), as int32."""
    out, key = [], 0
    while len(out) < n:
        for ln in lengths:
            key += int(rng.integers(1, 3))
            out.extend([key] * ln)
    return np.asarray(out[:n], np.int32)


# sorted key pairs with runs of equal keys; the prefixes nl / nr cut runs
JOIN_RUNS = {
    # runs of 3..700 keys, many crossing 128- and 2048-key tile edges
    "runs across tiles": lambda rng: (_runs(rng, 5000, [3, 700, 1, 129, 40]),
                                      _runs(rng, 4000, [2, 300, 1, 77, 5]), 4990, 3999),
    # nl and nr stop inside runs (the left one inside a tile)
    "prefixes cut runs": lambda rng: (_runs(rng, 3000, [50, 200]),
                                      _runs(rng, 3000, [60, 90]), 2100, 1533),
    # one key throughout: every pair matches
    "all equal": lambda rng: (np.full(2500, 7, np.int32),
                              np.full(3100, 7, np.int32), 2431, 3001),
}


@pytest.mark.parametrize("case", sorted(JOIN_RUNS))
def test_merge_join_runs_match_reference(case):
    l, r, nl, nr = JOIN_RUNS[case](np.random.default_rng(len(case)))
    got = mj.merge_join_count(_t(l), _t(r), nl, nr)
    want = ref.merge_join_count(jnp.asarray(l), jnp.asarray(r), nl, nr)
    pallas = pallas_merge_join(jnp.asarray(l), jnp.asarray(r), nl, nr,
                               block=128)
    assert int(got) == int(want) == int(pallas)


# -- a numpy model of csrc/merge_join.cu's rule ------------------------------

JOIN_TILE = 2048      # csrc/merge_join.cu kTile (merge_join.tile() on the card)
WINDOW_CAP = 6144     # csrc/merge_join.cu kWinCap
KEYS_PER_THREAD = 8   # csrc/merge_join.cu kKeys
LINEAR_STEPS = 4      # csrc/merge_join.cu kLinear


def _warp_search(r, n, x, upper):
    """The 32-way search: first p in [0, n) with r[p] > x (upper) or
    r[p] >= x, else n; lanes 0..30 test pivots, lane 31 stands for n."""
    def hit(p):
        return r[p] > x if upper else r[p] >= x
    a, b = 0, n
    while b - a > 31:
        c = next(k for k in range(32) if k == 31 or hit(a + (b - a) * (k + 1) // 32))
        a, b = (a + (b - a) * c // 32 + 1 if c > 0 else a,
                a + (b - a) * (c + 1) // 32 if c < 31 else b)
    return next(p for p in range(a, a + 32) if p >= b or hit(p))


def _search(R, lo, hi, g, x, upper):
    """First p in [lo, hi) with R[p] > x (upper) or R[p] >= x, else hi,
    from the guess g: steps of 1, 2, 4, ... from g toward the answer, then
    a binary search inside the last step."""
    def hit(p):
        return R[p] > x if upper else R[p] >= x
    a, b = lo, hi
    if g < hi:
        s = 1
        if hit(g):
            b = g
            while g - s >= lo:
                if not hit(g - s):
                    a = g - s + 1
                    break
                b, s = g - s, 2 * s
        else:
            a = g + 1
            while g + s < hi:
                if hit(g + s):
                    b = g + s
                    break
                a, s = g + s + 1, 2 * s
    while a < b:
        m = (a + b) // 2
        a, b = (a, m) if hit(m) else (m + 1, b)
    return a


def _advance(R, j, hi, x, upper):
    """From j, the first position in [j, hi) whose key is not below x
    (upper: not equal to x): up to LINEAR_STEPS linear steps, then the
    search."""
    for _ in range(LINEAR_STEPS):
        if j >= hi or (R[j] != x if upper else R[j] >= x):
            return j
        j += 1
    return _search(R, j, hi, j, x, upper)


def _model_join(l, r, nl, nr):
    """(int32 count, tiles staged in shared memory, tiles searched in
    device memory) by the kernel's rule."""
    total, staged, searched = 0, 0, 0
    nl, nr = max(0, min(nl, len(l))), max(0, min(nr, len(r)))
    for base in range(0, nl, JOIN_TILE):
        end = min(base + JOIN_TILE, nl)
        wlo = _warp_search(r, nr, l[base], False)
        whi = _warp_search(r, nr, l[end - 1], True)
        if -(-(whi - (wlo & ~3)) // 4) * 4 <= WINDOW_CAP:
            staged += 1
        else:
            searched += 1
        for first in range(base, end, KEYS_PER_THREAD):
            # the first key's guess: its place in the tile scaled to the window
            guess = min(wlo + (first - base) * (whi - wlo) // (end - base), whi)
            j = wlo
            for i in range(first, min(first + KEYS_PER_THREAD, end)):
                if i > first and l[i] == l[i - 1]:
                    total += run
                    continue
                p = _search(r, wlo, whi, guess, l[i], False) if i == first \
                    else _advance(r, j, whi, l[i], False)
                j = _advance(r, p, whi, l[i], True)
                run = j - p
                total += run
    return np.int64(total).astype(np.int32), staged, searched


@pytest.mark.parametrize("case", sorted(JOIN_RUNS) + ["unique", "windows past the cap"])
def test_merge_join_partition_rule_matches_reference(case):
    rng = np.random.default_rng(len(case))
    if case == "unique":
        l = np.sort(rng.permutation(9000)[:6000]).astype(np.int32)
        r = np.sort(rng.permutation(9000)[:7000]).astype(np.int32)
        nl, nr = 6000, 6990
    elif case == "windows past the cap":  # a dense right run under a tile
        l = np.sort(rng.integers(0, 40, 4500)).astype(np.int32)
        r = np.sort(rng.integers(0, 3, 7000)).astype(np.int32)
        nl, nr = 4500, 7000
    else:
        l, r, nl, nr = JOIN_RUNS[case](rng)
    got, staged, searched = _model_join(l, r, nl, nr)
    want = ref.merge_join_count(jnp.asarray(l), jnp.asarray(r), nl, nr)
    assert int(got) == int(want)
    assert int(mj.merge_join_count(_t(l), _t(r), nl, nr)) == int(want)
    if case in ("unique", "runs across tiles"):
        assert searched == 0 and staged > 1
    if case == "windows past the cap":
        assert searched > 0


def test_merge_join_count_wraps_like_int32():
    """A count past 2^31 (50,000 x 50,000 equal keys): the model sums in
    int64 and keeps the low 32 bits, as the plain version's int32 sum."""
    l = np.full(50_000, 3, np.int32)
    got, _, searched = _model_join(l, l, 50_000, 50_000)
    assert searched == 25
    want = np.int64(50_000 * 50_000).astype(np.int32)
    assert int(got) == int(want) < 0
    assert int(mj.merge_join_count(_t(l), _t(l), 50_000, 50_000)) == int(want)


def test_sort_join_keys_and_kernel_join_on_masked_keys():
    rng = np.random.default_rng(9)
    lk, rk = rng.integers(0, 40, 3000), rng.integers(0, 40, 2000)
    lm, rm = rng.random(3000) > 0.3, rng.random(2000) > 0.5
    ls = ops.sort_join_keys(_t(lk), _t(lm))
    rs = ops.sort_join_keys(_t(rk), _t(rm))
    assert ls.dtype == torch.int32
    assert int(ls[int(lm.sum()):].min()) == ops.INT32_MAX  # sentinel tail
    got = ops.merge_join_count(ls, rs, int(lm.sum()), int(rm.sum()))
    want = sum(int((rk[rm] == v).sum()) for v in lk[lm])
    assert int(got) == want


@pytest.mark.parametrize("n,k,block,ties", [(2048, 5, 512, False),
                                            (4096, 1, 1024, False),
                                            (1024, 8, 256, False),
                                            (4096, 6, 512, True)])
def test_block_topk_matches_reference(n, k, block, ties):
    rng = np.random.default_rng(n + k)
    sc = (rng.integers(0, 4, n) if ties else rng.normal(size=n)).astype(np.float32)
    mask = rng.random(n) > 0.2
    v, i = tk.block_topk(_t(sc), _t(mask), n, k, block=block)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    rv, ri = ref.block_topk(jnp.asarray(sc), jnp.asarray(mask), k, block)
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))  # ties: lower index
    pv, pi = pallas_block_topk(jnp.asarray(sc), jnp.asarray(mask), n, k,
                               block=block)
    np.testing.assert_array_equal(v.numpy(), np.asarray(pv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(pi))


def test_block_topk_fewer_live_rows_than_k():
    """The documented difference: a block with fewer than k live rows pads
    with -inf candidates. The port (like ref.block_topk) gives them distinct
    next indices; the Pallas kernel repeats base + 0. Finite candidates
    agree exactly."""
    n, k, block = 1024, 5, 256
    sc = np.arange(n, dtype=np.float32)
    mask = np.zeros(n, bool)
    mask[[3, 7, 300, 301, 302, 303, 304, 305]] = True  # block 0: 2 live rows
    v, i = tk.block_topk(_t(sc), _t(mask), n, k, block=block)
    rv, ri = ref.block_topk(jnp.asarray(sc), jnp.asarray(mask), k, block)
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    pv, pi = pallas_block_topk(jnp.asarray(sc), jnp.asarray(mask), n, k,
                               block=block)
    pv, pi = np.asarray(pv), np.asarray(pi)
    finite = np.isfinite(pv)
    np.testing.assert_array_equal(v.numpy(), pv)
    np.testing.assert_array_equal(i.numpy()[finite], pi[finite])
    assert list(i.numpy()[0]) == [7, 3, 0, 1, 2]
    assert list(pi[0]) == [7, 3, 0, 0, 0]


@pytest.mark.parametrize("n,k,block", [(2048, 5, 512), (1000, 8, 256)])
def test_topk_merge_matches_pallas_merge(n, k, block):
    rng = np.random.default_rng(n)
    sc = rng.integers(0, 30, n).astype(np.float32)  # heavy ties across blocks
    mask = rng.random(n) > 0.2
    nv = n - 11
    v, i = tk.topk_merge(_t(sc), _t(mask), nv, k, block=block)
    pv, pi = pallas_topk_merge(jnp.asarray(sc), jnp.asarray(mask), nv, k,
                               block=block)
    np.testing.assert_array_equal(v.numpy(), np.asarray(pv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(pi))
    live = np.where(mask & (np.arange(n) < nv), sc, -np.inf)
    np.testing.assert_array_equal(
        i.numpy(), np.argsort(-live, kind="stable")[:k])


def test_expand_block_ids_matches_reference():
    from repro.kernels import ops as rops

    for ids, n in [((0, 2, 5), 6 * 4096), ((3,), 4 * 4096 - 100), ((0,), 10)]:
        assert ops._expand_block_ids(ids, 4096, 2048, n) == \
            rops._expand_block_ids(ids, 4096, 2048, n)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that claims to live on a CUDA card."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("call", [
    lambda t: fc.filter_count(t(np.zeros((1, 8), np.int32)),
                              t(np.zeros((1, 2), np.int32)), 8),
    lambda t: sa.segment_agg(t(np.zeros((8, 1), np.float32)),
                             t(np.zeros(8, np.int32)), 2, 8),
    lambda t: tk.block_topk(t(np.zeros(8, np.float32)), t(np.ones(8, bool)), 8, 2),
    lambda t: mj.merge_join_count(t(np.zeros(8, np.int32)),
                                  t(np.zeros(8, np.int32)), 8, 8),
])
def test_cuda_tensor_never_reaches_the_plain_version(call, monkeypatch):
    """A CUDA tensor goes to the kernel or raises: here there is no card
    and no nvcc, so the launch path must fail loudly, not fall back."""
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", "/nonexistent-build-dir")
    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(_build, "_lib", None)

    def fake(a):
        return torch.Tensor._make_subclass(_FakeCuda, _t(a))
    before = dict(_build.LAUNCHES)
    with pytest.raises((RuntimeError, ValueError)):
        call(fake)
    assert _build.LAUNCHES == before


def test_unsupported_device_raises():
    meta = torch.empty((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fc.filter_count(meta, meta, 8)
