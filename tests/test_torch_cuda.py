"""The CUDA kernels on the card, each against its plain PyTorch version at
small shapes (exact). Marked ``cuda``: run on a machine with an NVIDIA card
with ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``;
elsewhere it skips. Imports neither jax nor the JAX package, so it runs
where only PyTorch is installed."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import filter_count as fc
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
