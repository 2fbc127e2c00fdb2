"""The port's attention kernels against the JAX reference: each kernel's
plain PyTorch version (what its wrapper runs on CPU tensors) against the
Pallas kernel in interpret mode, on ``tests/test_kernels.py``'s sweeps, and
against the jnp functions the reference actually runs
(``repro.kernels.ops._xla_flash_fwd``, ``repro.kernels.ref``).

Inputs are drawn at unit scale, so the scores (std 1 after the 1/sqrt(D)
scale) move the softmax far from uniform and a wrong score shows in the
output. Tolerances are the reference's (tests/test_kernels.py:82, :165),
2e-4 in float32 and 2e-2 in bf16, where the two sides round the bf16
output of a float32 computation summed in different orders; an output is
held to them relative to its own value and to the largest |value| of its
row, since attention outputs are weighted means of V whose scale falls
with the length. ``test_tolerance_catches_a_wrong_q_head`` shows that a
fault the size of a wrong q head fails that check. The CUDA kernels run
only on the card: tests/test_torch_cuda.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro.kernels.decode_attention import flash_decode as pallas_decode
from repro.kernels.flash_attention import flash_mha_fwd as pallas_flash
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _inputs(rng, shapes, dtype):
    arrs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    # the same rounded values on both sides
    th = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))
          for a in jx]
    return jx, th


def _row_close(got, want, tol: float) -> bool:
    """|got - want| <= tol * (|want| + the row's largest |want|), rows on
    the last axis."""
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    bound = tol * (np.abs(w) + np.abs(w).max(axis=-1, keepdims=True))
    return bool(np.all(np.abs(g - w) <= bound))


def _close(got: torch.Tensor, want, tol: float):
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    assert _row_close(g, w, tol), f"max abs err {np.abs(g - w).max()} (tolerance {tol})"


def _close_lse(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,H,KV,S,D,bq,bk", [
    (1, 2, 2, 128, 16, 32, 32),    # MHA
    (2, 4, 2, 256, 32, 64, 128),   # GQA, uneven blocks
    (1, 8, 1, 64, 64, 64, 16),     # MQA, single q block
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas(B, H, KV, S, D, bq, bk, causal, dtype):
    rng = np.random.default_rng(B * 100 + H * 10 + S)
    (jq, jk, jv), (q, k, v) = _inputs(
        rng, [(B, H, S, D), (B, KV, S, D), (B, KV, S, D)], dtype)
    want_o, want_lse = pallas_flash(jq, jk, jv, causal=causal, bq=bq, bk=bk)
    out, lse = fa.flash_mha_fwd_plain(q, k, v, causal=causal, bq=bq)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    _close(out, want_o, TOL[dtype])
    _close_lse(lse, want_lse, TOL[dtype])


@pytest.mark.parametrize("B,H,KV,Sq,D,bq", [
    (2, 4, 2, 128, 32, 32),
    (1, 4, 4, 100, 16, 32),        # ragged: the Pallas body asserts Sq % bq == 0
    (2, 6, 3, 77, 64, 512),        # one chunk shorter than bq
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_xla_twin(B, H, KV, Sq, D, bq, causal):
    """The function the reference's model path runs with attn_impl="flash"
    (kernels/ops.py: backend="xla" by default)."""
    rng = np.random.default_rng(Sq + D)
    (jq, jk, jv), (q, k, v) = _inputs(
        rng, [(B, H, Sq, D), (B, KV, Sq, D), (B, KV, Sq, D)], "float32")
    want_o, want_lse = ref_ops._xla_flash_fwd(jq, jk, jv, causal, bq)
    out, lse = fa.flash_mha_fwd_plain(q, k, v, causal=causal, bq=bq)
    _close(out, want_o, 2e-4)
    _close_lse(lse, want_lse, 2e-4)
    # the wrapper (its default chunk) and the op (autograd.Function) give
    # the same output, and the op ticks its count
    _close(fa.flash_mha_fwd(q, k, v, causal=causal)[0], want_o, 2e-4)
    ops.reset_dispatch_counts()
    _close(ops.flash_attention(q, k, v, causal), want_o, 2e-4)
    assert ops.DISPATCH_COUNTS["flash_attention"] == 1


def test_flash_op_cpu_gradient_is_plain_backward():
    """Under autograd the op's gradients on CPU tensors are the plain
    backward's (B7's plain version) on the saved out and lse."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(1, 2, 8, 16)).astype(np.float32))
    q.requires_grad_(True)
    out = ops.flash_attention(q, q.detach(), q.detach(), True)
    do = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    out.backward(do)
    o, lse = fa.flash_mha_fwd_plain(q.detach(), q.detach(), q.detach())
    want = fa.flash_attention_bwd_plain(q.detach(), q.detach(), q.detach(),
                                        o, lse, do)[0]
    torch.testing.assert_close(q.grad, want, rtol=0, atol=0)


@pytest.mark.parametrize("B,H,KV,S,D,bk", [(2, 4, 2, 256, 32, 64),
                                           (1, 8, 8, 128, 64, 128),
                                           (3, 6, 2, 512, 16, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_reference(B, H, KV, S, D, bk, dtype):
    rng = np.random.default_rng(B + H + S)
    (jq, jk, jv), (q, k, v) = _inputs(
        rng, [(B, H, D), (B, KV, S, D), (B, KV, S, D)], dtype)
    # lengths 1 and S, then random ones
    lens = np.concatenate([[1, S], rng.integers(1, S, B)])[:B].astype(np.int32)
    tl = torch.from_numpy(lens)
    got = da.flash_decode(q, k, v, tl)
    assert got.dtype == q.dtype and got.shape == (B, H, D)
    tol = TOL[dtype]
    _close(got, ref.decode_attention(jq, jk, jv, jnp.asarray(lens)), tol)
    _close(got, pallas_decode(jq, jk, jv, jnp.asarray(lens), bk=bk), tol)
    ops.reset_dispatch_counts()
    _close(ops.flash_decode(q, k, v, tl), ref_ops.flash_decode(
        jq, jk, jv, jnp.asarray(lens)), tol)
    assert ops.DISPATCH_COUNTS["flash_decode"] == 1


def test_decode_length_zero_is_uniform_mean():
    """Every slot masked alike: the reference's softmax is uniform, so the
    output is the mean of V over all S slots."""
    rng = np.random.default_rng(5)
    (jq, jk, jv), (q, k, v) = _inputs(
        rng, [(2, 4, 16), (2, 2, 64, 16), (2, 2, 64, 16)], "float32")
    lens = np.array([0, 7], np.int32)
    got = da.flash_decode(q, k, v, torch.from_numpy(lens))
    _close(got, ref.decode_attention(jq, jk, jv, jnp.asarray(lens)), 2e-4)
    mean = v[0].mean(dim=1)                        # (KV, D)
    _close(got[0], mean.repeat_interleave(2, dim=0).numpy(), 2e-4)


@pytest.mark.parametrize("kernel", ["flash_mha_fwd", "flash_decode"])
def test_tolerance_catches_a_wrong_q_head(kernel):
    """The bf16 check fails on an output computed from the neighbouring q
    head (a head-indexing fault), and on one computed with q = 0 (the scores
    skipped: a uniform mean of V)."""
    rng = np.random.default_rng(9)
    B, H, KV, S, D = 2, 8, 2, 256, 64
    qshape = (B, H, S, D) if kernel == "flash_mha_fwd" else (B, H, D)
    _, (q, k, v) = _inputs(rng, [qshape, (B, KV, S, D), (B, KV, S, D)], "bfloat16")
    if kernel == "flash_mha_fwd":
        def run(x):
            return fa.flash_mha_fwd_plain(x, k, v, causal=True)[0].float().numpy()
    else:
        lens = torch.tensor([S, S // 3], dtype=torch.int32)

        def run(x):
            return da.flash_decode_plain(x, k, v, lens).float().numpy()
    want = run(q)
    assert _row_close(run(q), want, TOL["bfloat16"])
    assert not _row_close(run(torch.roll(q, 1, dims=1)), want, TOL["bfloat16"])
    assert not _row_close(run(torch.zeros_like(q)), want, TOL["bfloat16"])


def test_wrappers_refuse_bad_operands():
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="GQA"):
        fa.flash_mha_fwd(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16))
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        fa.flash_mha_fwd(q, q.double(), q.double())
    with pytest.raises(ValueError, match="lengths"):
        da.flash_decode(torch.zeros(1, 4, 16), torch.zeros(1, 2, 8, 16),
                        torch.zeros(1, 2, 8, 16), torch.zeros(1, dtype=torch.int64))


# -- the backward (B7): the op under autograd against jax.vjp of the
# reference's custom_vjp on its jnp twin (repro/kernels/ops.py:297-361)


def _vjp_case(rng, B, H, KV, S, D, dtype):
    shapes = [(B, H, S, D), (B, KV, S, D), (B, KV, S, D), (B, H, S, D)]
    return _inputs(rng, shapes, dtype)


def _grad_close(got: torch.Tensor, want, tol: float, what: str):
    """Within ``tol`` x the gradient's own largest |value|."""
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    assert g.shape == w.shape, what
    np.testing.assert_allclose(g, w, rtol=0, atol=tol * np.abs(w).max(),
                               err_msg=what)


@pytest.mark.parametrize("KV", [4, 2, 1])          # G = 1, 2, 4 (H = 4)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [96, 100])            # a multiple of bq = 32, and not
@pytest.mark.parametrize("D", [16, 64])
def test_flash_backward_matches_reference_vjp(KV, causal, S, D):
    """dq, dk, dv of ``ops.flash_attention`` (the plain backward on CPU
    tensors) == ``jax.vjp`` of the reference's ``flash_attention(...,
    bq=32, "xla")`` with the same cotangent, float32: 1e-4 x each
    gradient's scale (both sides sum the same float32 terms in other
    orders and chunkings)."""
    rng = np.random.default_rng(S * 7 + D + KV)
    (jq, jk, jv, jdo), (q, k, v, do) = _vjp_case(rng, 2, 4, KV, S, D, "float32")
    out, vjp = jax.vjp(lambda a, b, c: ref_ops.flash_attention(
        a, b, c, causal, 32, "xla"), jq, jk, jv)
    want = vjp(jdo)
    for t in (q, k, v):
        t.requires_grad_(True)
    got = ops.flash_attention(q, k, v, causal)
    _close(got.detach(), out, 2e-4)
    got.backward(do)
    for name, t, w in zip("qkv", (q, k, v), want):
        assert t.grad.dtype == t.dtype
        _grad_close(t.grad, w, 1e-4, f"d{name}")


def test_flash_backward_matches_reference_vjp_bf16():
    """bf16 in, bf16 gradients out: both sides recompute in float32 from
    the bf16 inputs and their bf16 forward output, so they differ by the
    rounding of that output and of the result: 2e-2 x each gradient's
    scale."""
    rng = np.random.default_rng(5)
    (jq, jk, jv, jdo), (q, k, v, do) = _vjp_case(rng, 2, 8, 2, 100, 64,
                                                 "bfloat16")
    _, vjp = jax.vjp(lambda a, b, c: ref_ops.flash_attention(
        a, b, c, True, 32, "xla"), jq, jk, jv)
    want = vjp(jdo)
    for t in (q, k, v):
        t.requires_grad_(True)
    ops.flash_attention(q, k, v, True).backward(do)
    for name, t, w in zip("qkv", (q, k, v), want):
        assert t.grad.dtype == torch.bfloat16
        _grad_close(t.grad, w, 2e-2, f"d{name}")


def test_flash_vjp_matches_oracle_grads():
    """tests/test_kernels.py:96-105 on the port: the gradients of
    sum(tanh(flash)) against those of the reference's dense oracle
    ``ref.mha``, at the reference's tolerance 1e-3."""
    rng = np.random.default_rng(0)
    arrs = [rng.normal(size=s).astype(np.float32) * 0.4
            for s in ((1, 4, 96, 16), (1, 2, 96, 16), (1, 2, 96, 16))]
    g = lambda a, b, c: jnp.sum(jnp.tanh(ref.mha(a, b, c, causal=True)))
    want = jax.grad(g, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    torch.tanh(ops.flash_attention(*ts, True)).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-3, atol=1e-3)


def test_flash_backward_reads_strided_views_and_copies_odd_gradients():
    """The model path's layout: q, k, v the (B,H,S,D) views of (B,S,H,D)
    projections, the gradient of the output the view of a contiguous
    (B,S,H,D) tensor; gradients equal those of contiguous inputs. A
    gradient the kernel cannot read in place (a broadcast, stride 0) is
    copied first and gives the same result."""
    rng = np.random.default_rng(9)
    base = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((2, 40, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16))]
    views = [b.clone().requires_grad_(True) for b in base]
    flat = [b.transpose(1, 2).contiguous().requires_grad_(True) for b in base]
    do = torch.from_numpy(rng.normal(size=(2, 40, 4, 16)).astype(np.float32))
    ops.flash_attention(*(v.transpose(1, 2) for v in views), True) \
        .backward(do.transpose(1, 2))
    ops.flash_attention(*flat, True).backward(do.transpose(1, 2).contiguous())
    for v, f in zip(views, flat):
        torch.testing.assert_close(v.grad.transpose(1, 2), f.grad)
    q = flat[0].detach().requires_grad_(True)
    ops.flash_attention(q, flat[1].detach(), flat[2].detach(), True) \
        .sum().backward()
    assert fa.layout_problem(torch.ones(()).expand(2, 4, 40, 16)) is not None
    q2 = flat[0].detach().requires_grad_(True)
    ops.flash_attention(q2, flat[1].detach(), flat[2].detach(), True) \
        .backward(torch.ones(()).expand(2, 4, 40, 16))
    torch.testing.assert_close(q.grad, q2.grad)
    assert ops.DISPATCH_COUNTS["flash_attention_bwd"] >= 4
