"""The attention kernels' layout and split rules, on the CPU, against the JAX
reference on the same numpy-seeded inputs.

- ``flash_mha_fwd`` takes strided views: the (B,H,S,D) transposes of
  (B,S,H,D) projections give what contiguous inputs give, and
  ``attention_core`` hands the op such views without copying them.
- ``check_layout`` accepts the layouts the bf16 kernel reads in place and
  refuses the rest (the CUDA wrapper calls it before every launch).
- ``flash_decode`` splits the cache walk: a model of the kernel's rule —
  slices of ``split_size`` slots bounded by the length (all S for a length
  of 0), row groups with their own online-softmax states, empty states
  (m = -inf, l = 0) merged without NaN, slices wholly past the length left
  out — matches ``repro.kernels.ref.decode_attention``.

Tolerances are ``tests/test_torch_flash.py``'s: 2e-4 in float32, 2e-2 in
bf16, each output relative to its value plus its row's largest |value|."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
NEG = -1e30


def _row_close(got, want, tol: float) -> None:
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    bound = tol * (np.abs(w) + np.abs(w).max(axis=-1, keepdims=True))
    assert np.all(np.abs(g - w) <= bound), \
        f"max abs err {np.abs(g - w).max()} (tolerance {tol})"


def _bshd(rng, shape, dtype):
    """A (B,S,H,D) array rounded to ``dtype``: numpy for JAX, torch for the
    port."""
    a = rng.normal(size=shape).astype(np.float32)
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return t.float().numpy(), t


@pytest.mark.parametrize("B,H,KV,S,D", [(2, 4, 4, 64, 16), (2, 8, 2, 100, 32),
                                        (1, 4, 1, 130, 64), (1, 2, 2, 70, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_strided_views_match_contiguous_and_reference(B, H, KV, S, D,
                                                            causal, dtype):
    rng = np.random.default_rng(B * 1000 + S + D)
    (nq, q), (nk, k), (nv, v) = (_bshd(rng, (B, S, n, D), dtype)
                                 for n in (H, KV, KV))
    qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    assert not qs.is_contiguous()
    fa.check_layout(qs, ks, vs)
    out, lse = fa.flash_mha_fwd(qs, ks, vs, causal=causal)
    cout, clse = fa.flash_mha_fwd(qs.contiguous(), ks.contiguous(),
                                  vs.contiguous(), causal=causal)
    assert out.shape == (B, H, S, D) and lse.shape == (B, H, S)
    torch.testing.assert_close(out, cout, rtol=0, atol=0)
    torch.testing.assert_close(lse, clse, rtol=0, atol=0)
    ops.reset_dispatch_counts()
    torch.testing.assert_close(ops.flash_attention(qs, ks, vs, causal), cout,
                               rtol=0, atol=0)
    assert ops.DISPATCH_COUNTS["flash_attention"] == 1
    # the function the reference's model path runs, on the same values
    want_o, want_lse = ref_ops._xla_flash_fwd(
        *(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (nq, nk, nv)),
        causal, 512)
    _row_close(out.float().numpy(), want_o, TOL[dtype])
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_attention_core_passes_views_without_copies(monkeypatch):
    """The flash branch hands the op the transposed projections themselves
    (views sharing their storage), and reshapes the result back."""
    cfg = dataclasses.replace(get_config("paper-lm").reduced(), attn_impl="flash")
    rng = np.random.default_rng(3)
    B, S, H, KV, D = 2, 24, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = torch.from_numpy(rng.normal(size=(B, S, H, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, S, KV, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, S, KV, D)).astype(np.float32))
    seen = []
    real = ops.flash_attention

    def spy(qq, kk, vv, causal):
        seen.append([(t.data_ptr(), t.stride()) for t in (qq, kk, vv)])
        return real(qq, kk, vv, causal)

    monkeypatch.setattr(ops, "flash_attention", spy)
    pos = torch.arange(S)
    got = tattn.attention_core(q, k, v, pos, pos, cfg, causal=True)
    assert seen == [[(t.data_ptr(), t.transpose(1, 2).stride()) for t in (q, k, v)]]
    want = tattn._blocked_attention(q, k, v, pos, pos, causal=True, window=0,
                                    chunk_q=cfg.chunk_q)
    assert got.shape == (B, S, H, D)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_check_layout_accepts_what_the_kernel_reads(dtype):
    x = torch.zeros(2, 40, 8, 64, dtype=dtype)
    fa.check_layout(x, x.transpose(1, 2), x[:, 8:24].transpose(1, 2))
    # a dim of length 1 may carry any stride: it is never stepped
    fa.check_layout(torch.zeros(1, 3, 4, 16, dtype=dtype).as_strided(
        (1, 3, 4, 16), (7, 64, 16, 1)))
    for d in fa.HEAD_DIMS:
        fa.check_layout(torch.zeros(1, 5, 2, d, dtype=dtype).transpose(1, 2))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_check_layout_refuses_what_it_cannot(dtype):
    x = torch.zeros(2, 64, 4, 64, dtype=dtype)
    with pytest.raises(ValueError, match="stride 1"):
        fa.check_layout(x.transpose(1, 3))
    # rows of 66 elements: not a multiple of 16 bytes in either dtype
    padded = torch.zeros(2, 64, 4, 66, dtype=dtype)[..., :64]
    with pytest.raises(ValueError, match="16 bytes"):
        fa.check_layout(padded.transpose(1, 2))
    flat = torch.zeros(2 * 64 * 4 * 64 + 1, dtype=dtype)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.check_layout(flat[1:].view(2, 64, 4, 64))
    with pytest.raises(ValueError, match="head dim"):
        fa.check_layout(torch.zeros(1, 2, 8, 48, dtype=dtype))
    # the wrapper's only device check: k and v on q's device
    with pytest.raises(ValueError, match="must all lie on cpu"):
        fa.check_layout(x, torch.zeros(2, 64, 4, 64, dtype=dtype,
                                       device="meta"))



@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_layout_check_takes_the_cache_views(dtype):
    """The decode wrapper's check (``check_layout`` under its own name):
    the (B,KV,S,D) views of a layer of an (L,B,S,KV,D) cache and the
    (B,H,D) view of (B,1,H,D) projections pass; a cache layer whose rows
    are not 16-byte strided or whose base is off 16 bytes is refused,
    the message naming flash_decode (ROADMAP C4)."""
    cache = torch.zeros(3, 2, 40, 4, 64, dtype=dtype)
    q = torch.zeros(2, 1, 8, 64, dtype=dtype)[:, 0]
    fa.check_layout(q, cache[1].transpose(1, 2), cache[2].transpose(1, 2),
                    name="flash_decode")
    padded = torch.zeros(2, 40, 4, 66, dtype=dtype)[..., :64]
    with pytest.raises(ValueError, match="^flash_decode: strides"):
        fa.check_layout(q, padded.transpose(1, 2), name="flash_decode")
    flat = torch.zeros(2 * 40 * 4 * 64 + 1, dtype=dtype)
    with pytest.raises(ValueError, match="^flash_decode: base address"):
        fa.check_layout(q, flat[1:].view(2, 40, 4, 64).transpose(1, 2),
                        name="flash_decode")

# -- decode: the split-and-merge rule ------------------------------------------

ROW_GROUPS = 16  # row groups per slice in the model (a block's 4 warps x 4)


def _merge(a, b):
    """Merge two online-softmax states (m, l, acc); either may be empty
    (m = -inf, l = 0, acc = 0), as the kernel's merge_state."""
    (m1, l1, a1), (m2, l2, a2) = a, b
    mx = max(m1, m2)
    r = 0.0 if mx == -np.inf else mx
    f1, f2 = np.exp(m1 - r), np.exp(m2 - r)
    return mx, l1 * f1 + l2 * f2, a1 * f1 + a2 * f2


def _split_decode(q, k, v, lengths, split):
    """The kernel's rule in numpy float64: q (B,H,D), k/v (B,KV,S,D)."""
    B, H, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    out = np.zeros((B, H, D))
    empty = (-np.inf, 0.0, np.zeros(D))
    for b in range(B):
        n = int(lengths[b])
        walk = min(n, S) if n > 0 else S
        n_split = -(-S // split)
        for h in range(H):
            parts = []
            for sp in range(n_split):
                s0, s1 = sp * split, min((sp + 1) * split, walk)
                if s0 >= s1:
                    continue  # wholly past the length: left out
                groups = [empty] * ROW_GROUPS  # some stay empty
                for pos in range(s0, s1):
                    s = (q[b, h] @ k[b, h // G, pos] / np.sqrt(D)) if n > 0 else NEG
                    i = (pos - s0) % ROW_GROUPS
                    groups[i] = _merge(groups[i], (s, 1.0, v[b, h // G, pos]))
                state = empty
                for gs in groups:
                    state = _merge(state, gs)
                parts.append(state)
            m, l, acc = empty
            for p in parts:
                m, l, acc = _merge((m, l, acc), p)
            assert np.isfinite(acc).all() and l > 0
            out[b, h] = acc / max(l, 1e-30)
    return out


@pytest.mark.parametrize("B,H,KV,S,D", [(8, 4, 2, 200, 16), (7, 2, 1, 130, 32)])
def test_decode_split_rule_matches_reference(B, H, KV, S, D):
    rng = np.random.default_rng(S + D)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(B, KV, S, D)).astype(np.float32)
    v = rng.normal(size=(B, KV, S, D)).astype(np.float32)
    split = da.split_size(B, KV, S)
    assert 1 < -(-S // split), "the shape must have several slices"
    # 0 (all S, uniform), 1 and split - 1 (later slices wholly past the
    # length), the slice boundaries, S
    lens = np.array([0, 1, split - 1, split, split + 1, S, S - 1, 2 * split + 3],
                    np.int32)[:B]
    got = _split_decode(q.astype(np.float64), k.astype(np.float64),
                        v.astype(np.float64), lens, split)
    want = np.asarray(ref.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), jnp.asarray(lens)))
    _row_close(got, want, TOL["float32"])
    # the plain version (the wrapper on CPU tensors) agrees with both
    plain = da.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(lens))
    _row_close(plain.numpy(), want, TOL["float32"])


def test_decode_split_size():
    # the timing shape: 8 slices of 512 slots, 2,048 blocks
    assert da.split_size(32, 8, 4096) == 512
    for B, KV, S in [(1, 1, 1), (3, 8, 300), (32, 2, 4096), (1, 1, 10 ** 7),
                     (4096, 8, 128)]:
        split = da.split_size(B, KV, S)
        n = -(-S // split)
        assert split % da.SPLIT_ROWS == 0 and 1 <= n <= 65535
        assert (n - 1) * split < S  # no slice starts past the cache
