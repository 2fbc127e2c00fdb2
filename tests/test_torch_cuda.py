"""The CUDA kernels on the card, each against its plain PyTorch version at
small shapes: the relational kernels exactly, the attention kernels on
unit-scale inputs at the reference's tolerances (2e-4 float32, 2e-2 bf16:
sums in another order, and the bf16 output rounded from float32), each
output relative to its value plus its row's largest |value| (as
tests/test_torch_flash.py, which shows a wrong q head fails that check).
Marked ``cuda``: run on a machine with an NVIDIA card
with ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``;
elsewhere it skips. Imports neither jax nor the JAX package, so it runs
where only PyTorch is installed."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import filter_count as fc
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import merge_join as mj
from repro_torch.kernels import segment_agg as sa
from repro_torch.kernels import topk_mask as tk


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """On the card: every kernel against its plain version (exact)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    n = 100_000
    cols = torch.from_numpy(rng.integers(0, 50, (3, n)).astype(np.int32)).to(dev)
    b = torch.tensor([[0, 20], [5, 40], [10, 10]], dtype=torch.int32, device=dev)
    assert int(fc.filter_count(cols, b, n - 9)) == \
        int(fc.filter_count_plain(cols, b, n - 9))
    vals = torch.from_numpy(rng.integers(0, 9, (n, 2)).astype(np.float32)).to(dev)
    gids = torch.from_numpy(rng.integers(-1, 30, n).astype(np.int32)).to(dev)
    for op in ("sum", "max", "min"):
        assert torch.equal(sa.segment_agg(vals, gids, 29, n, op=op),
                           sa.segment_agg_plain(vals, gids, 29, n, op=op))
    s = torch.from_numpy(rng.integers(0, 7, n).astype(np.float32)).to(dev)
    m = torch.from_numpy(rng.random(n) > 0.5).to(dev)
    for got, want in zip(tk.block_topk(s, m, n, 5), tk.block_topk_plain(s, m, n, 5)):
        assert torch.equal(got, want)
    keys = torch.sort(torch.from_numpy(rng.integers(0, 999, n).astype(np.int32))
                      .to(dev)).values
    assert int(mj.merge_join_count(keys, keys, n, n - 4)) == \
        int(mj.merge_join_count_plain(keys, keys, n, n - 4))


@pytest.mark.cuda
def test_cuda_block_ids_arr_and_join_runs_match_plain_versions():
    """On the card, against the plain versions, exactly: filter_count and
    segment_agg (sum / max / min, integer-valued) over -1-padded id lists
    (pads mid-list, trailing, pads only); segment_agg at an n that is not a
    multiple of 4, on operands off 16-byte alignment, with a copy of the
    cells per warp and with G x C past shared memory; merge_join_count on long runs crossing tiles, prefixes
    cutting runs, all-equal keys (windows past shared memory) and a count
    past 2^31 (int32 wrap, as the plain version's int32 sum)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    n = 100_003
    cols = torch.from_numpy(rng.integers(0, 50, (2, n)).astype(np.int32)).to(dev)
    b = torch.tensor([[0, 20], [5, 40]], dtype=torch.int32, device=dev)
    vals = torch.from_numpy(rng.integers(-9, 9, (n, 3)).astype(np.float32)).to(dev)
    gids = torch.from_numpy(rng.integers(-1, 30, n).astype(np.int32)).to(dev)
    for ids in ([3, 0, -1, 24, -1], [-1, 7, 48, -1], [-1, -1], [24]):
        arr = torch.tensor(ids, dtype=torch.int32, device=dev)
        assert int(fc.filter_count(cols, b, n - 9, block_ids_arr=arr)) == \
            int(fc.filter_count_plain(cols, b, n - 9, block_ids_arr=arr))
        for op in ("sum", "max", "min"):
            assert torch.equal(
                sa.segment_agg(vals, gids, 29, n - 9, op=op, block_ids_arr=arr),
                sa.segment_agg_plain(vals, gids, 29, n - 9, op=op, block_ids_arr=arr))
    mid = torch.from_numpy(rng.integers(0, 1000, n).astype(np.int32)).to(dev)
    big = torch.from_numpy(rng.integers(0, 3000, n).astype(np.int32)).to(dev)
    # one float past an aligned start: the kernel takes 4-byte loads
    off = torch.cat([torch.zeros(1, device=dev), vals[:, 0]])[1:, None]
    goff = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev), gids])[1:]
    assert off.data_ptr() % 16 and goff.data_ptr() % 16
    for v, g, G in ((vals[:, :1].contiguous(), gids, 29),
                    (vals[:, :2].contiguous(), gids, 29),
                    (off, goff, 29),
                    (vals, mid, 1000),   # 3,000 cells: a copy per warp
                    (vals, big, 3000)):  # 9,000 cells: past shared memory
        for op in ("sum", "max", "min"):
            assert torch.equal(sa.segment_agg(v, g, G, n, op=op),
                               sa.segment_agg_plain(v, g, G, n, op=op))

    def runs(m, lengths):  # m sorted keys in runs of the given lengths
        reps = np.resize(lengths, int(m / np.mean(lengths)) + len(lengths))
        keys = np.repeat(np.cumsum(rng.integers(1, 3, len(reps))), reps)[:m]
        return torch.from_numpy(keys.astype(np.int32)).to(dev)

    left, right = runs(300_000, [3, 700, 1, 2049, 40]), runs(200_000, [2, 300, 9000])
    same = torch.full((60_000,), 5, dtype=torch.int32, device=dev)
    for l, r, nl, nr in ((left, right, 299_990, 199_999),
                         (left, right, 150_001, 77_777),
                         (same, same[:20_000], 60_000, 19_999),
                         (same[:50_000], same[:50_000], 50_000, 50_000)):
        got = mj.merge_join_count(l, r, nl, nr)
        assert got.dtype == torch.int32
        assert int(got) == int(mj.merge_join_count_plain(l, r, nl, nr))
    assert int(mj.merge_join_count(same[:50_000], same[:50_000], 50_000, 50_000)) \
        == int(np.int64(50_000 * 50_000).astype(np.int32))
    # the tile test_torch_kernels.py's numpy model of the join takes
    assert mj.tile() == 2048


def _assert_row_close(got, want, tol):
    g, w = got.cpu().float(), want.cpu().float()
    bound = tol * (w.abs() + w.abs().amax(dim=-1, keepdim=True))
    err = (g - w).abs()
    assert bool((err <= bound).all()), f"max abs err {float(err.max())} (tolerance {tol})"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)])
def test_cuda_attention_kernels_match_plain_versions(dtype, tol):
    """flash_mha_fwd and flash_decode on the card against their plain
    versions: D 16 and 64, MHA and GQA, causal and not, a ragged S, and
    decode lengths 0, 1 and S."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dev, dtype)

    for B, H, KV, S, D in [(2, 4, 4, 128, 16), (2, 8, 2, 100, 64),
                           (1, 4, 1, 257, 64)]:
        q, k, v = t(B, H, S, D), t(B, KV, S, D), t(B, KV, S, D)
        for causal in (True, False):
            out, lse = fa.flash_mha_fwd(q, k, v, causal=causal)
            pout, plse = fa.flash_mha_fwd_plain(q.cpu(), k.cpu(), v.cpu(),
                                                causal=causal)
            torch.cuda.synchronize()
            assert out.dtype == dtype and lse.dtype == torch.float32
            _assert_row_close(out, pout, tol)
            torch.testing.assert_close(lse.cpu(), plse, rtol=tol, atol=tol)
    for B, H, KV, S, D in [(3, 8, 8, 300, 64), (3, 8, 2, 128, 16),
                           (2, 6, 2, 64, 64)]:
        q, k, v = t(B, H, D), t(B, KV, S, D), t(B, KV, S, D)
        lens = torch.tensor([0, 1, S][:B], dtype=torch.int32, device=dev)
        got = da.flash_decode(q, k, v, lens)
        want = da.flash_decode_plain(q.cpu(), k.cpu(), v.cpu(), lens.cpu())
        torch.cuda.synchronize()
        _assert_row_close(got, want, tol)


def _refused(bad, want, tol) -> bool:
    """The row-scaled check refuses ``bad``: it is not within tolerance."""
    g, w = bad.cpu().float(), want.cpu().float()
    bound = tol * (w.abs() + w.abs().amax(dim=-1, keepdim=True))
    return not bool(((g - w).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_cuda_bf16_flash_strided_and_contiguous(D):
    """The tensor-core kernel on the model path's layout ((B,H,S,D) views
    of (B,S,H,D) tensors) and on contiguous inputs: GQA, a ragged S, causal
    and not, each against the plain version, with the planted faults (q
    from the neighbouring head; q = 0) refused by the same check."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(D)
    tol = 2e-2

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dev, torch.bfloat16)

    for B, H, KV, S in [(2, 8, 2, 128), (1, 4, 4, 200), (3, 4, 1, 77)]:
        strided = [t(B, S, n, D).transpose(1, 2) for n in (H, KV, KV)]
        for q, k, v in (strided, [x.contiguous() for x in strided]):
            for causal in (True, False):
                out, lse = fa.flash_mha_fwd(q, k, v, causal=causal)
                pout, plse = fa.flash_mha_fwd_plain(q, k, v, causal=causal)
                torch.cuda.synchronize()
                assert out.dtype == torch.bfloat16 and out.shape == q.shape
                _assert_row_close(out, pout, tol)
                torch.testing.assert_close(lse, plse, rtol=tol, atol=tol)
                for bad in (q.roll(1, dims=1), torch.zeros_like(q)):
                    assert _refused(fa.flash_mha_fwd_plain(bad, k, v, causal=causal)[0],
                                    pout, tol)


@pytest.mark.cuda
def test_cuda_bf16_flash_past_one_grid_dimension():
    """B*H = 65,600 (q, k, v) heads in one launch: the grid is 1-D."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn((8200, 16, 8, 16), generator=gen, device=dev)
               .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
    out, _ = fa.flash_mha_fwd(q, k, v, causal=True)
    want, _ = fa.flash_mha_fwd_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    _assert_row_close(out, want, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)])
def test_cuda_decode_split_at_length_boundaries(dtype, tol):
    """The split cache walk at lengths 0, 1, each side of a slice boundary
    and S, and with every length = S; planted faults refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    for B, H, KV, S, D in [(8, 8, 8, 1000, 64), (8, 8, 2, 700, 128),
                           (8, 4, 1, 300, 16)]:
        q = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32)).to(dev, dtype)
        k, v = (torch.from_numpy(rng.normal(size=(B, KV, S, D)).astype(np.float32))
                .to(dev, dtype) for _ in range(2))
        split = da.split_size(B, KV, S)
        assert -(-S // split) > 1
        mixed = [0, 1, split - 1, split, split + 1, S - 1, S, 2 * split + 1]
        for lens in (mixed, [S] * B):
            lt = torch.tensor(lens, dtype=torch.int32, device=dev)
            got = da.flash_decode(q, k, v, lt)
            want = da.flash_decode_plain(q, k, v, lt)
            torch.cuda.synchronize()
            _assert_row_close(got, want, tol)
            for bad in (q.roll(1, dims=1), torch.zeros_like(q)):
                assert _refused(da.flash_decode_plain(bad, k, v, lt), want, tol)
