"""The port's relational kernels against the JAX reference: each kernel's
plain PyTorch version (what its wrapper runs on CPU tensors) against
``repro.kernels.ref`` and the Pallas kernel in interpret mode, on the
``tests/test_kernels.py`` sweep shapes plus block-id lists, ties and blocks
with fewer than k live rows. Counts and indices are exact; segment_agg is
exact on integer-valued data and within the reference's own tolerance
(rtol 1e-5, atol 1e-3) on normal data. The CUDA kernels themselves run
only on the card: tests/test_torch_cuda.py and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
