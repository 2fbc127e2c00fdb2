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


@pytest.mark.cuda
def test_cuda_filter_count_columns_alignment_and_cap():
    """filter_count on the card, exactly against the plain version: a
    column list and the stacked matrix, n_valid < n, a matrix whose rows sit
    at other 16-byte phases (n % 4 != 0: 4-byte loads), static and
    -1-padded tile lists over a column list, 17 columns (past the pointer
    struct) as a list and as a matrix, and listed tiles wholly past
    n_valid."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(15)
    n = 100_003
    cols = [torch.from_numpy(rng.integers(0, 50, n).astype(np.int32)).to(dev)
            for _ in range(17)]
    b = torch.from_numpy(np.sort(rng.integers(0, 50, (17, 2)), axis=1)
                         .astype(np.int32))
    b[3:] = torch.tensor([0, 49], dtype=torch.int32)  # the first 3 select
    b = b.to(dev)
    mat3 = torch.stack(cols[:3])
    assert any(mat3[i].data_ptr() % 16 for i in range(3))
    for nv in (n, n - 4097, 5):
        want = int(fc.filter_count_plain(mat3, b[:3], nv))
        assert int(fc.filter_count(mat3, b[:3], nv)) == want
        assert int(fc.filter_count(cols[:3], b[:3], nv)) == want
        assert int(fc.filter_count(mat3[:, :n - 3].contiguous(), b[:3], nv)) == \
            int(fc.filter_count_plain(mat3[:, :n - 3], b[:3], nv))
    for ids in ((0, 3, 24), (24,)):
        assert int(fc.filter_count(cols[:2], b[:2], n - 9, block_ids=ids)) == \
            int(fc.filter_count_plain(cols[:2], b[:2], n - 9, block_ids=ids))
    for ids in ([3, 0, -1, 24, -1], [-1, -1]):
        arr = torch.tensor(ids, dtype=torch.int32, device=dev)
        assert int(fc.filter_count(cols[:2], b[:2], n - 9, block_ids_arr=arr)) == \
            int(fc.filter_count_plain(cols[:2], b[:2], n - 9, block_ids_arr=arr))
    want = int(fc.filter_count_plain(cols, b, n - 2))
    assert want > 0
    assert int(fc.filter_count(cols, b, n - 2)) == want
    assert int(fc.filter_count(torch.stack(cols), b, n - 2)) == want
    # listed tiles wholly past n_valid (n_valid % 4 != 0) count nothing;
    # every row passes b[3:5], so a row counted twice shows (16-byte path:
    # a column list, and a matrix at n % 4 == 0)
    for every in (cols[3:5], torch.stack([c[:100_000] for c in cols[3:5]])):
        for nv in (5, fc.num_rows(every) - 4097):
            for ids in ((0, 3, 24), (0, 23, 24)):
                want = int(fc.filter_count_plain(every, b[3:5], nv, block_ids=ids))
                assert want > 0
                assert int(fc.filter_count(every, b[3:5], nv, block_ids=ids)) == want
            arr = torch.tensor([3, -1, 24, 0, -1], dtype=torch.int32, device=dev)
            assert int(fc.filter_count(every, b[3:5], nv, block_ids_arr=arr)) == \
                int(fc.filter_count_plain(every, b[3:5], nv, block_ids_arr=arr))


@pytest.mark.cuda
def test_cuda_block_topk_and_merge_match_plain_versions():
    """block_topk and the merge kernel on the card, exactly against the
    plain versions: ties at every k of the register kernel (1-16) and at
    k = 17 (the rounds kernel), fewer live
    rows than k, a ragged last tile, n_valid < n, scores and mask from
    offset views (off 16 and 4 bytes), the top rows planted behind the
    first ones, and scores rising with the row."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(16)
    n = 50_001
    s = torch.from_numpy(rng.integers(0, 6, n).astype(np.float32)).to(dev)
    m = torch.from_numpy(rng.random(n) > 0.4).to(dev)
    sparse = torch.zeros(n, dtype=torch.bool, device=dev)
    sparse[::3000] = True
    cases = [(s, m, n, k) for k in (1, 2, 3, 5, 8, 11, 16, 17)]
    # ranks 1-3 of each tile in its first rows, ranks 4-5 in rows of later
    # steps; every other score 0 (ties); and scores rising with the row
    planted = torch.zeros(n, device=dev)
    for b in range(0, n - 4096, 4096):
        planted[[b, b + 1, b + 2, b + 516, b + 517]] = torch.tensor(
            [100.0, 99, 98, 97, 96], device=dev)
    every = torch.ones(n, dtype=torch.bool, device=dev)
    cases += [(s, sparse, n, 5), (s, m, n - 4100, 8), (s[1:], m[1:], n - 1, 8),
              (s[:n - 3], m[:n - 3], n - 3, 16), (s, m, n, 100),
              (planted, every, n, 5),
              (torch.arange(n, dtype=torch.float32, device=dev), every, n, 5)]
    for args in cases:
        got = tk.block_topk(*args)
        want = tk.block_topk_plain(*args)
        for g, w in zip(got, want):
            assert torch.equal(g, w), args[2:]
        for g, w in zip(tk.merge_candidates(*got), tk.merge_candidates_plain(*got)):
            assert torch.equal(g, w), args[2:]
        for g, w in zip(tk.topk_merge(*args), tk.merge_candidates_plain(*want)):
            assert torch.equal(g, w), args[2:]


def _matter_case(dev, n_matter=10_001, n_anti=37, block=1024, k=2, seed=3):
    """A run's layout as the compiler passes it: k predicate columns plus
    the matter column (1 = visible matter; anti rows after the matter
    prefix and the block padding are 0), n_valid % 4 != 0."""
    rng = np.random.default_rng(seed)
    n = -(-(n_matter + n_anti) // block) * block
    cols = [torch.from_numpy(rng.integers(0, 40, n).astype(np.int32)).to(dev)
            for _ in range(k)]
    matter = np.zeros(n, np.int32)
    matter[:n_matter] = rng.random(n_matter) > 0.1  # some shadowed matter
    cols.append(torch.from_numpy(matter).to(dev))
    bounds = torch.tensor([[3, 30]] * k + [[1, 1]], dtype=torch.int32,
                          device=dev)
    return cols, bounds, n


@pytest.mark.cuda
def test_cuda_filter_count_with_matter_column():
    """filter_count over predicate columns plus the matter column, whole
    length and with a tile list, against its plain version (exact)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    dev = torch.device("cuda")
    for k, n_matter in ((1, 10_001), (2, 4_097), (3, 777)):
        cols, bounds, n = _matter_case(dev, n_matter=n_matter, k=k)
        for n_valid in (n, n - 3, n_matter + 5):
            assert n_valid % 4 != 0 or n_valid == n
            got = fc.filter_count(cols, bounds, n_valid)
            want = fc.filter_count_plain(cols, bounds, n_valid)
            assert got.dtype == torch.int32 and int(got) == int(want)
        ids = tuple(range(0, -(-n // fc.BLOCK), 2))
        assert int(fc.filter_count(cols, bounds, n, block_ids=ids)) == \
            int(fc.filter_count_plain(cols, bounds, n, block_ids=ids))


@pytest.mark.cuda
def test_cuda_fed_session_kernel_counts_equal_gspmd():
    """One fed, mutated session on the card: kernel mode (the CUDA kernels,
    one filter_count and one segment_agg launch per component) answers
    every count as gspmd mode over the same catalog, before and after
    compaction."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    from repro_torch.core.frame import AFrame
    from repro_torch.data import wisconsin
    from repro_torch.engine import lsm
    from repro_torch.engine.ingest import Feed
    from repro_torch.engine.session import Session
    from repro_torch.kernels import _build

    kern = Session(mode="kernel")
    kern.create_dataset("Live", wisconsin.generate(50_000, seed=3),
                        dataverse="d", indexes=["onePercent"], primary="unique2")
    gsp = Session(mode="gspmd", catalog=kern.catalog)
    feed = Feed(kern, "Live", "d", flush_rows=10**9,
                policy=lsm.CompactionPolicy(size_ratio=10.0, max_runs=64))
    extra = {k: v.numpy() for k, v in wisconsin.generate(5_000, seed=4).columns.items()}
    extra["unique2"] = extra["unique2"] + 50_000
    feed.push(extra)
    feed.flush()
    up = {k: v.numpy() for k, v in wisconsin.generate(2_000, seed=5).columns.items()}
    up["unique2"] = np.arange(100, 2_100, dtype=np.int32)
    feed.upsert(up)
    feed.delete(np.arange(40_000, 41_000, dtype=np.int32))
    feed.flush()

    def counts(sess):
        df = AFrame("d", "Live", session=sess)
        return (len(df), len(df[(df["ten"] == 3) & (df["two"] == 1)]),
                len(df[(df["onePercent"] >= 10) & (df["onePercent"] <= 30)]),
                len(df[(df["unique2"] >= 50) & (df["unique2"] <= 45_000)]),
                {k: v.tolist() for k, v in df.groupby("ten").agg("count").items()})

    _build.reset_launches()
    got = counts(kern)
    assert _build.LAUNCHES.get("filter_count", 0) >= 3
    assert _build.LAUNCHES.get("segment_agg", 0) == 3
    assert got == counts(gsp)
    feed.compact()
    assert counts(kern) == counts(gsp) == got


@pytest.mark.cuda
def test_cuda_durable_round_trip_mounts_on_the_card(tmp_path):
    """A small durable store on the card: written through a kernel-mode
    session, reopened lazily with every mounted column a CUDA tensor, its
    index payloads rebuilt on the card at the first query, and every count
    answered as before the close through the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    from repro_torch.core.frame import AFrame
    from repro_torch.data import wisconsin
    from repro_torch.engine import lsm
    from repro_torch.engine.ingest import Feed
    from repro_torch.engine.session import Session
    from repro_torch.kernels import _build

    def counts(sess):
        df = AFrame("d", "Live", session=sess)
        return (len(df), len(df[(df["ten"] == 3) & (df["two"] == 1)]),
                {k: v.tolist() for k, v in df.groupby("ten").agg("count").items()})

    sess = Session(mode="kernel", storage=str(tmp_path))
    sess.create_dataset("Live", wisconsin.generate(20_000, seed=3),
                        dataverse="d", indexes=["onePercent"], primary="unique2")
    feed = Feed(sess, "Live", "d", flush_rows=10**9,
                policy=lsm.CompactionPolicy(size_ratio=10.0, max_runs=64))
    up = {k: v.numpy() for k, v in wisconsin.generate(1_000, seed=5).columns.items()}
    up["unique2"] = np.arange(100, 1_100, dtype=np.int32)
    feed.upsert(up)
    feed.delete(np.arange(5_000, 5_500, dtype=np.int32))
    feed.flush()
    feed.delete(np.arange(7_000, 7_010, dtype=np.int32))  # the WAL tail
    sess.close()

    re = Session.open(str(tmp_path), mode="kernel")
    comps = re.catalog.components("d", "Live")
    assert len(comps) == 3  # base, the flushed run, the replayed tail
    for c in comps:
        assert all(t.is_cuda for t in c.table.columns.values())
    _build.reset_launches()
    got = counts(re)
    assert _build.LAUNCHES.get("filter_count", 0) >= 2
    assert _build.LAUNCHES.get("segment_agg", 0) == 3
    for c in comps:
        assert not c.soft_stale
        for ix in c.indexes.values():
            assert ix.sorted_keys.is_cuda and ix.row_ids.is_cuda
    want = counts(Session(mode="gspmd", catalog=re.catalog))
    assert got == want
    assert re.point_lookup("d", "Live", 5_100) is None
    assert int(re.point_lookup("d", "Live", 100)["unique2"][0]) == 100
    re.close()


@pytest.mark.cuda
def test_cuda_durable_round_trip_on_a_one_rank_nccl_mesh(tmp_path):
    """The durable store through a kernel session on a one-rank NCCL group
    on the card: written, closed with a delete in the WAL, reopened lazily
    on the rank with every mounted column a CUDA tensor; the counts,
    through the kernels, and the point lookups equal a meshless reopen of
    a copy of the same store."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    import shutil

    from repro_torch.core.frame import AFrame
    from repro_torch.data import wisconsin
    from repro_torch.engine import lsm
    from repro_torch.engine.ingest import Feed
    from repro_torch.engine.session import Session
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import close_rank_mesh, init_rank_mesh

    def counts(sess):
        df = AFrame("d", "Live", session=sess)
        return (len(df), len(df[(df["ten"] == 3) & (df["two"] == 1)]),
                {k: v.tolist() for k, v in df.groupby("ten").agg("count").items()},
                df.get(5_100), df.get(100)["unique2"].tolist())

    d = tmp_path / "store"
    mesh = init_rank_mesh(1, 1, None, rank=0, world_size=1, local_rank=0,
                          init_method="file://" + str(tmp_path / "rendezvous"))
    try:
        sess = Session(mode="kernel", mesh=mesh, storage=str(d))
        sess.create_dataset("Live", wisconsin.generate(20_000, seed=3),
                            dataverse="d", indexes=["onePercent"],
                            primary="unique2")
        feed = Feed(sess, "Live", "d", flush_rows=10**9,
                    policy=lsm.CompactionPolicy(size_ratio=10.0, max_runs=64))
        up = {k: v.numpy() for k, v in
              wisconsin.generate(1_000, seed=5).columns.items()}
        up["unique2"] = np.arange(100, 1_100, dtype=np.int32)
        feed.upsert(up)
        feed.delete(np.arange(5_000, 5_500, dtype=np.int32))
        feed.flush()
        feed.delete(np.arange(7_000, 7_010, dtype=np.int32))  # the WAL tail
        sess.close()
        shutil.copytree(d, tmp_path / "copy")
        re = Session.open(str(d), mode="kernel", mesh=mesh)
        comps = re.catalog.components("d", "Live")
        assert len(comps) == 3  # base, the flushed run, the replayed tail
        for c in comps:
            assert all(t.is_cuda for t in c.table.columns.values())
        _build.reset_launches()
        got = counts(re)
        assert _build.LAUNCHES.get("filter_count", 0) >= 2
        assert _build.LAUNCHES.get("segment_agg", 0) >= 3
        re.close()
    finally:
        close_rank_mesh()
    flat = Session.open(str(tmp_path / "copy"), mode="kernel")
    want = counts(flat)
    flat.close()
    assert got[:3] == want[:3] and got[3] is None and want[3] is None
    assert got[4] == want[4] == [100]


@pytest.mark.cuda
def test_cuda_per_shard_kernels_on_unaligned_views_and_empty_rows():
    """The per-shard launches of the multi-device engine, on the card,
    against the plain versions, exactly: 8 shard views of one table whose
    rows per shard put every view at another 16-byte phase (filter_count
    over column lists, segment_agg, block_topk + merge), a shard-block
    matrix with an all -1 row (that shard scans nothing), and the
    distributed compositions against their one-shard answers."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    from repro_torch.engine import distributed as D
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh

    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    s, rps = 8, 20_001                     # 80,004-byte shards: phases 0/4/8/12
    n = s * rps
    cols = [torch.from_numpy(rng.integers(0, 20, n).astype(np.int32)).to(dev)
            for _ in range(3)]
    b = torch.tensor([[2, 15], [0, 9], [4, 4]], dtype=torch.int32, device=dev)
    views = [D.shard_views(c, s) for c in cols]
    phases = {(views[0][i].data_ptr() % 16) for i in range(s)}
    assert phases == {0, 4, 8, 12}
    for i in range(s):
        local = [v[i] for v in views]
        assert int(fc.filter_count(local, b, rps)) == \
            int(fc.filter_count_plain(local, b, rps))
    vals = torch.from_numpy(rng.integers(0, 9, (n, 2)).astype(np.float32)).to(dev)
    gids = torch.from_numpy(rng.integers(-1, 30, n).astype(np.int32)).to(dev)
    score = torch.from_numpy(rng.integers(0, 500, n).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.random(n) > 0.3).to(dev)
    for g, v, sc, m in zip(D.shard_views(gids, s), D.shard_views(vals, s),
                           D.shard_views(score, s), D.shard_views(mask, s)):
        for op in ("sum", "max", "min"):
            assert torch.equal(sa.segment_agg(v, g, 30, rps, op=op),
                               sa.segment_agg_plain(v, g, 30, rps, op=op))
        cand = tk.block_topk(sc, m, rps, 9)
        for got, want in zip(cand, tk.block_topk_plain(sc, m, rps, 9)):
            assert torch.equal(got, want)
        for got, want in zip(tk.merge_candidates(*cand),
                             tk.merge_candidates_plain(*cand)):
            assert torch.equal(got, want)
    # a block matrix with an all -1 row, in each kernel's own block units
    sb_fc = ops.shard_block_arrays((0, 3, 9, 10, 20), 4096, fc.BLOCK, s, 5, rps)
    sb_sa = ops.shard_block_arrays((0, 3, 9, 10, 20), 4096, sa.BLOCK, s, 5, rps)
    assert (sb_fc[3] == -1).all() and (sb_fc[5] == -1).all()
    ids_fc = torch.from_numpy(sb_fc).to(dev)
    ids_sa = torch.from_numpy(sb_sa).to(dev)
    for i in range(s):
        local = [v[i] for v in views]
        assert int(fc.filter_count(local, b, rps, block_ids_arr=ids_fc[i])) == \
            int(fc.filter_count_plain(local, b, rps, block_ids_arr=ids_fc[i]))
        v, g = D.shard_views(vals, s)[i], D.shard_views(gids, s)[i]
        for op in ("sum", "max", "min"):
            assert torch.equal(
                sa.segment_agg(v, g, 30, rps, op=op, block_ids_arr=ids_sa[i]),
                sa.segment_agg_plain(v, g, 30, rps, op=op,
                                     block_ids_arr=ids_sa[i]))
    m8, m1 = make_local_mesh(s), make_local_mesh(1)
    assert int(D.dist_kernel_filter_count(m8, ("data",), cols, b)) == \
        int(D.dist_kernel_filter_count(m1, ("data",), cols, b))
    for op in ("sum", "max", "min"):
        assert torch.equal(
            D.dist_kernel_group_agg(m8, ("data",), gids, vals, 30, op=op),
            D.dist_kernel_group_agg(m1, ("data",), gids, vals, 30, op=op))
    keys = torch.from_numpy(rng.integers(0, 4000, n).astype(np.int32)).to(dev)
    assert int(D.dist_kernel_join_count(m8, ("data",), keys, mask, keys, mask)) \
        == int(D.dist_kernel_join_count(m1, ("data",), keys, mask, keys, mask))


@pytest.mark.cuda
def test_cuda_sharded_session_equals_meshless():
    """An 8-shard kernel-mode session on the card answers the Wisconsin
    counts, group-by, top-k and join as the meshless one, each kernel
    launched once per shard."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    from repro_torch.core.frame import AFrame
    from repro_torch.data import wisconsin
    from repro_torch.engine.session import Session
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_local_mesh

    t = wisconsin.generate(40_008, seed=2)

    def run(sess):
        sess.create_dataset("W", t, dataverse="d")
        df = AFrame("d", "W", session=sess)
        return (len(df[(df["ten"] == 3) & (df["two"] == 1)]),
                {k: v.tolist() for k, v in
                 df.groupby("oddOnePercent").agg("count").items()},
                df.sort_values("unique1", ascending=False).head(5)["unique1"].tolist(),
                len(df.merge(AFrame("d", "W", session=sess),
                             left_on="unique1", right_on="unique1")))

    want = run(Session(mode="kernel"))
    _build.reset_launches()
    assert run(Session(mode="kernel", mesh=make_local_mesh(8))) == want
    assert _build.LAUNCHES["filter_count"] == 8
    assert _build.LAUNCHES["segment_agg"] == 8
    assert _build.LAUNCHES["merge_join_count"] == 8
    assert _build.LAUNCHES["block_topk"] == 9


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("D", [64, 128])
def test_cuda_decode_reads_the_strided_cache_view(dtype, tol, D):
    """The decode path's layout: k and v the (B,KV,S,D) views of a layer's
    (B,S,KV,D) cache (the cache itself a slice of the (L,B,S,KV,D) one),
    q a (B,H,D) view of (B,1,H,D). The kernel on those views equals the
    plain version at lengths 0, 1, each side of a slice edge and S (ROADMAP
    C4: before the kernel took strides it read them as contiguous)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(D)
    B, H, KV, S, L = 8, 8, 2, 700, 3
    cache = torch.randn((2, L, B, S, KV, D), generator=gen, device=dev).to(dtype)
    k, v = cache[0, 1].transpose(1, 2), cache[1, 1].transpose(1, 2)
    q = torch.randn((B, 1, H, D), generator=gen, device=dev).to(dtype)[:, 0]
    assert not k.is_contiguous() and k.stride(2) == KV * D
    split = da.split_size(B, KV, S)
    lens = torch.tensor([0, 1, split - 1, split, split + 1, S - 1, S, S],
                        dtype=torch.int32, device=dev)
    got = da.flash_decode(q, k, v, lens)
    want = da.flash_decode_plain(q, k, v, lens)
    torch.cuda.synchronize()
    _assert_row_close(got, want, tol)
    _assert_row_close(da.flash_decode(q, k.contiguous(), v.contiguous(), lens),
                      want, tol)
    for bad in (q.roll(1, dims=1), torch.zeros_like(q)):
        assert _refused(da.flash_decode_plain(bad, k, v, lens), want, tol)
    # a view the kernel cannot read in place is refused, never copied
    shifted = cache.reshape(-1)[1:1 + B * S * KV * D].view(B, S, KV, D)
    with pytest.raises(ValueError, match="16-byte aligned"):
        da.flash_decode(q, shifted.transpose(1, 2), v, lens)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-moe-16b",
                                  "llava-next-mistral-7b", "whisper-base"])
def test_cuda_decode_step_kernel_equals_plain(arch):
    """One reduced-config decode step per family that reaches
    ``decode_attention``, on the card under ``attn_impl="flash"``: the
    logits equal those of the same step with ``flash_decode`` swapped for
    its plain version (bf16, 2e-2 of the row scale), the caches written
    are equal bit for bit, and ``flash_decode`` launches once per layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.serve import make_batch
    from repro_torch.models.registry import get_api

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(arch).reduced(), attn_impl="flash")
    api = get_api(cfg)
    model = api.init(cfg, torch.Generator(device=dev).manual_seed(0))
    batch = make_batch(cfg, 4, 12, np.random.default_rng(0), dev)
    tok = batch["tokens"][:, :1]
    with torch.no_grad():
        cache, _ = api.prefill(model, batch, cfg, 20)
        plain_cache = {k: v.clone() for k, v in cache.items()}
        _build.reset_launches()
        cache, logits = api.decode(model, cache, tok, cfg)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["flash_decode"] == cfg.n_layers
        real = ops._da.flash_decode
        ops._da.flash_decode = da.flash_decode_plain
        try:
            plain_cache, plain_logits = api.decode(model, plain_cache, tok, cfg)
        finally:
            ops._da.flash_decode = real
    _assert_row_close(logits[:, 0], plain_logits[:, 0], 2e-2)
    for key in ("k", "v"):
        assert torch.equal(cache[key], plain_cache[key]), key


def _grads_close(got, want, tol) -> bool:
    """Each gradient within ``tol`` x its own largest |value|."""
    return all(bool(torch.isfinite(g).all()) and
               float((g.float() - w.float()).abs().max())
               <= tol * float(w.float().abs().max())
               for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("S", [100, 129, 300])
def test_cuda_flash_backward_matches_plain(dtype, tol, D, S):
    """The B7 kernel against its plain version on the card: GQA (G = 2,
    and G = 4 on a second layout), causal and not, ragged S on both sides
    of the bf16 kernels' tiles (100: one 128-row block, part of its second
    64-row half; 129: a second block holding one row, a ragged lse row
    offset; 300: three blocks), strided (B,S,H,D) views; each gradient
    within ``tol`` x its scale (float32: the same float32 sums in another
    order; bf16: p and ds meet the second products rounded to bf16). The
    same check refuses planted faults (dk and dv without one q head of the
    group; dq at twice its scale), and two launches give the same bits (no
    atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(D + S)
    for B, H, KV in ((2, 4, 2), (1, 8, 2)):
        q, do = (torch.randn((B, S, H, D), generator=g, device=dev).to(dtype)
                 .transpose(1, 2) for _ in range(2))
        k, v = (torch.randn((B, S, KV, D), generator=g, device=dev).to(dtype)
                .transpose(1, 2) for _ in range(2))
        for causal in (True, False):
            out, lse = fa.flash_mha_fwd(q, k, v, causal=causal)
            got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
            want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal)
            assert [t.dtype for t in got] == [dtype] * 3
            assert [t.shape for t in got] == [q.shape, k.shape, v.shape]
            assert _grads_close(got, want, tol), (H, KV, causal)
            again = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
            assert all(torch.equal(a, b) for a, b in zip(got, again))
            dropped = do.clone()
            dropped[:, 1] = 0  # head 1's terms missing from its group's dk, dv
            bad = fa.flash_attention_bwd_plain(q, k, v, out, lse, dropped,
                                               causal=causal)
            assert not _grads_close(bad[1:], want[1:], tol)
            assert not _grads_close((2 * want[0],), want[:1], tol)


@pytest.mark.cuda
def test_cuda_train_step_flash_equals_blocked():
    """One reduced qwen3 train step on the card under attn_impl="flash"
    (flash_mha_fwd twice a layer with remat, flash_attention_bwd once)
    against the same step on the blocked path from the same weights: loss
    and grad norm within 2e-2 relative (bf16 compute; the paths round
    attention at other places)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import make_batch
    from repro_torch.models import optim, steps

    dev = torch.device("cuda")
    base = get_config("qwen3-1.7b").reduced()
    batch = make_batch(base, 2, 64, np.random.default_rng(0), dev)
    out = {}
    for impl in ("flash", "blocked"):
        cfg = dataclasses.replace(base, attn_impl=impl)
        model, state = steps.init_train_state(
            cfg, torch.Generator(device=dev).manual_seed(0))
        step = steps.make_train_step(cfg, optim.OptimConfig(warmup_steps=0))
        _build.reset_launches()
        _, _, m = step(model, state, batch)
        torch.cuda.synchronize()
        out[impl] = m
        if impl == "flash":
            assert _build.LAUNCHES["flash_mha_fwd"] == 2 * cfg.n_layers
            assert _build.LAUNCHES["flash_attention_bwd"] == cfg.n_layers
    for key in ("loss", "grad_norm"):
        a, b = float(out["flash"][key]), float(out["blocked"][key])
        assert abs(a - b) <= 2e-2 * abs(b), (key, a, b)


@pytest.mark.cuda
def test_cuda_topk_head_past_the_row_count():
    """ROADMAP C5 on the card: ``sort_values("v").head(7)`` over 4 rows in
    kernel mode returns the 4 rows sorted, as gspmd and numpy; the block
    kernel is never asked for more rows than the stream has."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    from repro_torch.core.frame import AFrame
    from repro_torch.engine.session import Session
    from repro_torch.engine.table import Table
    from repro_torch.kernels import _build

    v = np.array([5, -3, 9, 0], np.int32)
    got = {}
    for mode in ("kernel", "gspmd"):
        sess = Session(mode=mode)
        sess.create_dataset("F", Table({"k": np.arange(4, dtype=np.int32), "v": v}),
                            dataverse="d")
        _build.reset_launches()
        got[mode] = AFrame("d", "F", session=sess).sort_values("v").head(7)
        if mode == "kernel":
            assert _build.LAUNCHES["block_topk"] >= 1
    order = np.argsort(v, kind="stable")
    for mode, res in got.items():
        np.testing.assert_array_equal(np.asarray(res["v"]), v[order], err_msg=mode)
        np.testing.assert_array_equal(np.asarray(res["k"]), order, err_msg=mode)


@pytest.mark.cuda
def test_cuda_checkpoint_round_trip(tmp_path):
    """A reduced qwen3's train state on the card through a checkpoint: the
    snapshot is taken before ``save`` returns (the model changed in place
    at once does not leak into it), a restore onto the card (the default
    device) gives every leaf bit for bit, and the in-place writer puts the
    model and its AdamW state back exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    from repro_torch.configs import get_config
    from repro_torch.launch.train import ModelState
    from repro_torch.models import convert, steps
    from repro_torch.runtime.checkpoint import CheckpointManager

    dev = torch.device("cuda")
    cfg = get_config("qwen3-1.7b").reduced()
    model, opt = steps.init_train_state(cfg, torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        for t in opt["m"].values():
            t.normal_()
    opt["step"] += 5
    want = {n: p.detach().clone() for n, p in model.named_parameters()}
    want_m = {n: t.clone() for n, t in opt["m"].items()}
    cm = CheckpointManager(tmp_path, async_save=True)
    state = ModelState(cfg)
    cm.save(5, state.tree(model, opt))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
        for t in opt["m"].values():
            t.zero_()
    opt["step"] += 1
    step, tree = cm.restore(None, convert.train_state_like(model, opt, cfg))
    assert step == 5 and tree["opt"]["step"].device.type == "cuda"
    assert int(tree["opt"]["step"]) == 5
    state.restore(cm, model, opt)
    for n, p in model.named_parameters():
        assert torch.equal(p, want[n]), n
    for n, t in opt["m"].items():
        assert torch.equal(t, want_m[n]), n
    assert int(opt["step"]) == 5


@pytest.mark.cuda
def test_cuda_fault_loop_two_steps(tmp_path):
    """Two train steps of a reduced qwen3 on the card under attn_impl="flash"
    through ``launch/train.run``, a checkpoint after every step and a
    straggler at step 1: the rollback waits for step 1's async save and
    restores it, the flash kernels launch for the two steps run only, and
    the losses equal, bit for bit, those of a run without the failure
    from the same seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    from repro_torch.runtime.fault import FailureInjector

    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(), attn_impl="flash")
    _build.reset_launches()
    out = train.run(cfg, 2, 2, 64, tmp_path, 1, injector=FailureInjector({1: "straggler"}))
    torch.cuda.synchronize()
    assert out["events"] == [(1, "Straggler: injected straggler at step 1")]
    assert [s for s, _ in out["log"]] == [0, 1]
    assert _build.LAUNCHES["flash_mha_fwd"] == 2 * 2 * cfg.n_layers
    assert _build.LAUNCHES["flash_attention_bwd"] == 2 * cfg.n_layers
    assert [s["step"] for s in out["loop"].spans if s["span"] == "rollback"] == [1]
    again = train.run(cfg, 2, 2, 64, tmp_path / "again", 1)
    assert [l for _, l in again["log"]] == [l for _, l in out["log"]]


# -- the model mesh on the card (models/sharding.py) ---------------------------------


def _mesh(dev, data, model):
    from repro_torch.launch.mesh import make_local_mesh

    return make_local_mesh(data, model, device=dev)


@pytest.mark.cuda
def test_cuda_moe_expert_parallel_equals_cpu():
    """deepseek-moe-16b's reduced MoE layer (4 experts, top 2), seeded on
    the CPU and copied to the card, expert-parallel on a data 2 x model 4
    mesh of the card against the same call on a CPU mesh: y and the aux
    loss within 1e-4 (float32; GEMMs sum in other orders)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.sharding import sharding_ctx

    cfg = get_config("deepseek-moe-16b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))
    layer = moe.init_moe(cfg, cfg.moe, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 16, cfg.d_model)).astype(np.float32))
    out = {}
    for dev in (torch.device("cpu"), torch.device("cuda")):
        lay = copy.deepcopy(layer).to(dev)
        with torch.no_grad(), sharding_ctx(_mesh(dev, 2, 4)):
            y, aux = moe.moe_ffn(x.to(dev), lay, cfg, cfg.moe)
        out[dev.type] = (y.cpu(), float(aux))
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=1e-4)
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-4 * abs(out["cpu"][1])


@pytest.mark.cuda
def test_cuda_shardmap_decode_equals_cpu():
    """A reduced qwen3 (float32 weights, bf16 cache) prefills 8 tokens of a
    20-row cache, then decodes at pos 8, 9, 10 (rank 1's first row) and 11
    with the shardmap decode on a data 2 x model 2 mesh, on the card and on
    the CPU from the same weights: logits within 2e-2, argmax equal, the
    cache within 2e-2 (bf16 compute rounds apart on the two devices)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.models.sharding import sharding_ctx

    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              decode_cache_update="shardmap")
    api = registry.get_api(cfg)
    model = api.init(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32))
    new = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 2, 1)).astype(np.int32))
    out = {}
    for dev in (torch.device("cpu"), torch.device("cuda")):
        m = copy.deepcopy(model).to(dev)
        logits = []
        with torch.no_grad():
            cache, _ = api.prefill(m, {"tokens": toks.to(dev)}, cfg, 20)
            with sharding_ctx(_mesh(dev, 2, 2)):
                for t in range(4):
                    cache, lg = api.decode(m, cache, new[t].to(dev), cfg)
                    logits.append(lg[:, -1].float().cpu())
        out[dev.type] = (torch.stack(logits), cache["k"].float().cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=0, atol=2e-2)
    assert torch.equal(out["cuda"][0].argmax(-1), out["cpu"][0].argmax(-1))
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=0, atol=2e-2)


@pytest.mark.cuda
def test_cuda_compressed_psum_equals_cpu_bit_for_bit():
    """The int8 all-reduce over 8 shards, twice (the second with the first's
    error state), on the card and on the CPU: every mean and error tensor
    equal bit for bit (the divisors are device tensors on both)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    from repro_torch.runtime import compress

    rng = np.random.default_rng(0)
    shards = [{"w": rng.normal(size=(257, 3)).astype(np.float32),
               "b": (rng.normal(size=(31,)) * 1e-3).astype(np.float32),
               "ties": np.array([127.0, 2.5, -0.5, 126.5], np.float32) * (i + 1),
               "zero": np.zeros((4, 4), np.float32)} for i in range(8)]
    out = {}
    for dev in ("cpu", "cuda"):
        g = [{k: torch.from_numpy(v).to(dev) for k, v in s.items()} for s in shards]
        err = [compress.init_error_state(x) for x in g]
        means = []
        for _ in range(2):
            mean, err = compress.compressed_psum(g, err)
            means.append(mean)
        out[dev] = (means, err)
    for (mc, ec), (mg, eg) in [(out["cpu"], out["cuda"])]:
        for a, b in zip(mc, mg):
            for k in a:
                assert torch.equal(a[k].view(torch.int32), b[k].cpu().view(torch.int32)), k
        for a, b in zip(ec, eg):
            for k in a:
                assert torch.equal(a[k].view(torch.int32), b[k].cpu().view(torch.int32)), k


@pytest.mark.cuda
def test_cuda_moe_counts_and_fractions_equal_bincount_and_one_hot():
    """The MoE routing statistics as the meta device can run them: the
    expert counts by scatter-add equal ``torch.bincount``'s bit for bit
    (dtype too), and the fractions by comparison equal ``F.one_hot``'s,
    on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    import torch.nn.functional as F

    from repro_torch.models import moe

    for E, k in ((4, 2), (64, 6)):
        idx = torch.from_numpy(np.random.default_rng(E).integers(
            0, E, (4096, k))).to("cuda")
        got = moe._expert_counts(idx, E)
        want = torch.bincount(idx.reshape(-1), minlength=E)
        assert got.dtype == want.dtype and torch.equal(got, want)
        assert torch.equal(moe._frac(idx, E),
                           F.one_hot(idx, E).float().sum(dim=1).mean(dim=0))


@pytest.mark.cuda
def test_cuda_rank_engine_two_gloo_ranks_equal_the_cpu():
    """The DataFrame engine on a mesh of two gloo ranks sharing the card,
    each holding its half of every table on the card: the 12 expressions
    in shard_map, kernel (the CUDA kernels, launched by each rank over its
    own shard) and gspmd mode give the answers, dtypes included, of a
    meshless session on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    from engine_probe import EXPRESSIONS
    from rank_workers import ENGINE_MODES, run_ranks
    from repro_torch.core.frame import AFrame
    from repro_torch.data import wisconsin
    from repro_torch.engine.session import Session

    rows, seed, rounds = 10_001, 7, 2
    ranks = run_ranks("engine_answers", 2, {"rows": rows, "seed": seed,
                                            "rounds": rounds, "device": "cuda"},
                      240)
    cpu = Session(mode="gspmd", device="cpu")
    t = wisconsin.generate(rows, seed=seed)
    for name in ("data", "data_r"):
        cpu.create_dataset(name, t, dataverse="bench")
    df, dr = AFrame("bench", "data", session=cpu), AFrame("bench", "data_r", session=cpu)
    for name, fn in sorted(EXPRESSIONS.items()):
        for r in range(rounds):
            want = fn(df, dr, np.random.default_rng(100 + r))
            for rank, got in enumerate(ranks):
                for mode in ENGINE_MODES:
                    g = got[(mode, name, r)]
                    label = (rank, mode, name, r)
                    if isinstance(want, dict):
                        assert set(g) == set(want), label
                        for k in want:
                            assert g[k].dtype == want[k].dtype, (label, k)
                            np.testing.assert_array_equal(g[k], want[k])
                    else:
                        assert type(g) is type(want) and g == want, label



def _same_tree(got, want, label):
    """Equal nested answers: dicts, lists and tuples element by element,
    arrays with their dtypes, scalars with their types."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), label
        for k in want:
            _same_tree(got[k], want[k], (label, k))
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), label
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, (label, i))
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, label
        np.testing.assert_array_equal(got, want, err_msg=str(label))
    else:
        assert type(got) is type(want) and got == want, (label, got, want)


@pytest.mark.cuda
def test_cuda_rank_live_two_gloo_ranks_equal_the_cpu_ranks():
    """The live engine on two gloo ranks sharing the card: a flush of
    pushes, a flush of upserts and deletes and the compaction, in kernel
    (the CUDA kernels over each rank's rows) and gspmd mode, give the
    answers, dtypes included, point lookups and persisted answers of the
    same two ranks on the CPU, and after every flush and the compaction
    each rank's columns of every component are CUDA tensors of
    ceil(rows / 2) rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on the card)")
    from rank_workers import run_ranks

    payload = {"base_rows": 10_001}
    card = run_ranks("live_card", 2, dict(payload, device="cuda"), 300)
    cpu = run_ranks("live_card", 2, dict(payload, device="cpu"), 300)
    for rank, (got, want) in enumerate(zip(card, cpu)):
        for mode in ("kernel", "gspmd"):
            _same_tree(got[mode], want[mode], (rank, mode))
        assert len(got["log"]) == len(want["log"]) > 0
        for (label, g), (_, w) in zip(got["log"], want["log"]):
            assert g["lsn"] == w["lsn"], (rank, label)
            for c, cw in zip(g["components"], w["components"]):
                assert c["device"] == ["cuda:0"], (rank, label, c["name"])
                assert c["held"] == [-(-c["global_rows"] // 2)]
                assert (c["name"], c["uid"], c["kills"]) == \
                    (cw["name"], cw["uid"], cw["kills"])
