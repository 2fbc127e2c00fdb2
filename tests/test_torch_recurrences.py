"""The recurrences, the MoE dispatch, ``decode_attention`` and the layers
of the port's serving slice against the JAX reference: replays of
tests/test_recurrences.py (each port function on numpy-seeded inputs,
against its own other form and against the reference's function on the
same inputs), ``decode_attention`` under ``attn_impl="flash"`` (the plain
``flash_decode`` on the CPU) against its einsum path and the reference,
and ``layer_norm`` and the gelu MLP. The JAX functions are jitted once
per shape. Tolerances are stated per test: float32 1e-4 (the reference's
own bound between chunked and sequential forms), bf16 2e-2 to 5e-2.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jl
import repro_torch.models.layers as tl
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro.models.config import ArchConfig as JArchConfig
from repro.models.config import MoESpec as JMoESpec
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm
from repro_torch.models.config import ArchConfig, MoESpec
from repro_torch.models.convert import from_jax
from test_torch_families import TOL, cfgs, close, ref_params

BF16 = TOL["bfloat16"]


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


# -- replays of tests/test_recurrences.py (float32: the algorithms) ---------------


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


def _wkv_inputs(rng, B, S, H, N):
    r, k, v = (rng.normal(size=(B, S, H, N)) * 0.5 for _ in range(3))
    lw = -np.exp(rng.normal(size=(B, S, H, N)) * 0.3 - 0.6)
    u = rng.normal(size=(H, N)) * 0.3
    return [np.asarray(a, np.float32) for a in (r, k, v, lw, u)]


@pytest.mark.parametrize("B,S,H,N,chunk", [(2, 64, 3, 8, 16), (1, 48, 2, 16, 16),
                                           (2, 33, 1, 4, 16)])
def test_wkv6_chunked_matches_sequential(B, S, H, N, chunk):
    """Chunked == sequential on the port (1e-4, the reference's bound), and
    the port's chunked form == the reference's on the same inputs."""
    xs = _wkv_inputs(np.random.default_rng(0), B, S, H, N)
    o1, s1 = trwkv.wkv6_chunked(*_t(*xs), chunk=chunk)
    o2, s2 = trwkv.wkv6_sequential(*_t(*xs))
    close(o1, o2.numpy(), 1e-4)
    close(s1, s2.numpy(), 1e-4)
    jo, js = jrwkv.wkv6_chunked(*map(jnp.asarray, xs), chunk=chunk)
    close(o1, np.asarray(jo), 1e-4)
    close(s1, np.asarray(js), 1e-4)


def test_wkv6_state_carry():
    """A split sequence == the whole (the state carried), on the port
    (1e-5, the reference's bound) and against the reference's split run."""
    r, k, v, lw, u = _t(*_wkv_inputs(np.random.default_rng(1), 1, 32, 2, 8))
    o_full, s_full = trwkv.wkv6_sequential(r, k, v, lw, u)
    o1, s1 = trwkv.wkv6_sequential(r[:, :16], k[:, :16], v[:, :16], lw[:, :16], u)
    o2, s2 = trwkv.wkv6_sequential(r[:, 16:], k[:, 16:], v[:, 16:], lw[:, 16:], u,
                                   state0=s1)
    close(torch.cat([o1, o2], 1), o_full.numpy(), 1e-5)
    close(s2, s_full.numpy(), 1e-5)
    js = [jnp.asarray(a.numpy()) for a in (r, k, v, lw, u)]
    _, j1 = jrwkv.wkv6_sequential(*(a[:, :16] for a in js[:4]), js[4])
    _, j2 = jrwkv.wkv6_sequential(*(a[:, 16:] for a in js[:4]), js[4], state0=j1)
    close(s2, np.asarray(j2), 1e-5)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [(2, 64, 3, 8, 8, 16),
                                             (1, 50, 2, 16, 4, 32)])
def test_ssd_chunked_matches_sequential(B, S, H, P, N, chunk):
    """Chunked == sequential on the port (1e-4), and == the reference's
    chunked form, including the padded tail (S = 50, chunk 32)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, S, H, P)) * 0.5
    Bc, Cc = (rng.normal(size=(B, S, N)) * 0.5 for _ in range(2))
    la = -np.log1p(np.exp(rng.normal(size=(B, S, H))))
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H))))
    xs = [np.asarray(a, np.float32) for a in (x, Bc, Cc, la, dt)]
    o1, s1 = tssm.ssd_chunked(*_t(*xs), chunk=chunk)
    o2, s2 = tssm.ssd_sequential(*_t(*xs))
    close(o1, o2.numpy(), 1e-4)
    close(s1, s2.numpy(), 1e-4)
    jo, js = jssm.ssd_chunked(*map(jnp.asarray, xs), chunk=chunk)
    close(o1, np.asarray(jo), 1e-4)
    close(s1, np.asarray(js), 1e-4)



def test_ssd_chunked_stays_finite_where_the_reference_overflows():
    """A log-decay of -2 a step: within a 64-step chunk the masked (s > t)
    exponents reach +126, past float32. The port masks before the
    exponential and equals the sequential form (1e-4); the reference's
    exp-then-mask gives inf * 0 = NaN there (ROADMAP, reference caveats),
    which is what the published zamba2 widths meet."""
    rng = np.random.default_rng(5)
    B, S, H, P, N = 1, 64, 2, 4, 4
    x = rng.normal(size=(B, S, H, P)) * 0.5
    Bc, Cc = (rng.normal(size=(B, S, N)) * 0.5 for _ in range(2))
    la, dt = np.full((B, S, H), -2.0), np.full((B, S, H), 0.5)
    xs = [np.asarray(a, np.float32) for a in (x, Bc, Cc, la, dt)]
    o1, s1 = tssm.ssd_chunked(*_t(*xs))
    o2, s2 = tssm.ssd_sequential(*_t(*xs))
    assert bool(torch.isfinite(o1).all()) and bool(torch.isfinite(s1).all())
    close(o1, o2.numpy(), 1e-4)
    close(s1, s2.numpy(), 1e-4)
    jo, _ = jax.jit(jssm.ssd_chunked)(*map(jnp.asarray, xs))
    assert np.isnan(np.asarray(jo)).any()

def _moe_cfgs(cf):
    kw = dict(name="m", family="moe", n_layers=2, d_model=32, n_heads=2,
              n_kv_heads=2, d_ff=64, vocab=64, d_head=16)
    spec = dict(num_experts=4, top_k=2, num_shared=1, d_ff_expert=16,
                capacity_factor=cf)
    return (JArchConfig(**kw, moe=JMoESpec(**spec)),
            ArchConfig(**kw, moe=MoESpec(**spec)))


def _moe_weights(seed=0):
    rng = np.random.default_rng(seed)
    d, fe, E = 32, 16, 4
    return {"router": rng.normal(size=(d, E)) / np.sqrt(d),
            "w1": rng.normal(size=(E, d, fe)) / np.sqrt(d),
            "w3": rng.normal(size=(E, d, fe)) / np.sqrt(d),
            "w2": rng.normal(size=(E, fe, d)) / np.sqrt(fe)}


def _identity(v):
    return v


def _ref_moe(x, w, spec):
    """The reference's ``_local_moe`` (one rank, every expert), jitted."""
    fn = jax.jit(functools.partial(jmoe._local_moe, spec=spec, e_local=4,
                                   rank=0, psum=_identity, pmean=_identity))
    return fn(jnp.asarray(x), *(jnp.asarray(w[k], jnp.float32)
                                for k in ("router", "w1", "w3", "w2")))


def _port_moe(x, w, spec, e_local=4, rank=0, sl=slice(None)):
    return tmoe._local_moe(
        torch.from_numpy(x), *(torch.from_numpy(np.asarray(w[k][sl] if k != "router"
                                                           else w[k], np.float32))
                               for k in ("router", "w1", "w3", "w2")),
        spec=spec, e_local=e_local, rank=rank, psum=_identity, pmean=_identity)


def _dense_oracle(x, w, spec):
    """Every expert for every token, weighted by the same top-k gates."""
    xf = x.reshape(-1, x.shape[-1])
    logits = xf @ w["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, :spec.top_k]
    gates = np.take_along_axis(probs, idx, -1)
    gates /= gates.sum(-1, keepdims=True)
    h = np.einsum("td,edf->tef", xf, w["w1"])
    g = h / (1 + np.exp(-h)) * np.einsum("td,edf->tef", xf, w["w3"])
    y_all = np.einsum("tef,efd->ted", g, w["w2"])
    full = np.zeros((xf.shape[0], spec.num_experts))
    np.put_along_axis(full, idx, gates, -1)
    return np.einsum("te,ted->td", full, y_all).reshape(x.shape)


def test_moe_matches_dense_oracle_when_dropless():
    """capacity_factor 16 drops nothing: the sort-based dispatch equals
    every expert weighted by the top-k gates (1e-4), and equals the
    reference's ``_local_moe`` on the same weights."""
    jcfg, tcfg = _moe_cfgs(16.0)
    w = _moe_weights()
    x = np.random.default_rng(1).normal(size=(2, 8, 32)).astype(np.float32)
    y, aux = _port_moe(x, w, tcfg.moe)
    close(y, _dense_oracle(x.astype(np.float64), w, tcfg.moe), 1e-4)
    jy, jaux = _ref_moe(x, w, jcfg.moe)
    close(y, np.asarray(jy), 1e-4)
    close(aux, np.asarray(jaux), 1e-5)


def test_moe_capacity_drops_bounded():
    """capacity_factor 0.5 drops choices: finite, norm within 1.5x the
    dropless output, and the same drops as the reference (1e-4)."""
    jcfg, tcfg = _moe_cfgs(0.5)
    w = _moe_weights()
    x = np.random.default_rng(1).normal(size=(2, 32, 32)).astype(np.float32)
    y, _ = _port_moe(x, w, tcfg.moe)
    assert bool(torch.isfinite(y).all())
    dropless = _dense_oracle(x.astype(np.float64), w, tcfg.moe)
    assert float(torch.linalg.norm(y)) <= float(np.linalg.norm(dropless)) * 1.5
    assert not np.allclose(y.numpy(), dropless, atol=1e-3)  # something dropped
    jy, _ = _ref_moe(x, w, jcfg.moe)
    close(y, np.asarray(jy), 1e-4)


def test_moe_ep_rank_partition_sums_to_whole():
    """Two ranks of two local experts each sum to the single-rank output
    (the psum identity of the expert-parallel path), 1e-4."""
    _, tcfg = _moe_cfgs(16.0)
    w = _moe_weights()
    x = np.random.default_rng(1).normal(size=(1, 16, 32)).astype(np.float32)
    full, _ = _port_moe(x, w, tcfg.moe)
    parts = [_port_moe(x, w, tcfg.moe, e_local=2, rank=r,
                       sl=slice(2 * r, 2 * r + 2))[0] for r in range(2)]
    close(parts[0] + parts[1], full.numpy(), 1e-4)


def test_capacity_floor_and_top_k_ties():
    """The decode floor of 4 slots, ``_capacity`` equal to the reference's
    over a sweep, and ties in the router's top-k going to the lower expert
    index, as ``jax.lax.top_k`` orders them."""
    assert tmoe._capacity(2, MoESpec(num_experts=64, top_k=6)) == 4
    for tokens in (1, 2, 7, 64, 1000, 32768):
        for cf in (0.5, 1.25, 8.0):
            ts = MoESpec(num_experts=64, top_k=6, capacity_factor=cf)
            js = JMoESpec(num_experts=64, top_k=6, capacity_factor=cf)
            assert tmoe._capacity(tokens, ts) == jmoe._capacity(tokens, js)
    probs = np.array([[0.2, 0.3, 0.2, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.1, 0.4, 0.4]], np.float32)
    vals, idx = tmoe._top_k(torch.from_numpy(probs), 3)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


# -- decode_attention: flash (plain flash_decode on the CPU) vs the einsum ---------


@pytest.mark.parametrize("pos", [0, 5, 15])
def test_decode_attention_flash_equals_einsum(pos):
    """GQA (4 q heads over 2 kv heads), a 16-slot cache, pos 0, inside, and
    at the cache's end: ``flash_decode`` over the (B,KV,S,hd) views of the
    updated cache gives the einsum path's output (bf16, 2e-2: the einsum
    path rounds its probabilities to bf16, the kernel's plain version does
    not) and the reference's; the caches written are equal bit for bit."""
    jcfg, tcfg = cfgs("qwen3-1.7b")
    params = ref_params(jcfg)
    blk = from_jax(params, tcfg, device="cpu").layers[0].attn
    rng = np.random.default_rng(pos)
    x = rng.normal(size=(2, 1, tcfg.d_model)).astype(np.float32)
    ck0 = rng.normal(size=(2, 16, tcfg.n_kv_heads, tcfg.d_head)).astype(np.float32)
    cv0 = rng.normal(size=ck0.shape).astype(np.float32)
    outs = {}
    for impl in ("blocked", "flash"):
        cfg = dataclasses.replace(tcfg, attn_impl=impl)
        ck = torch.from_numpy(ck0).bfloat16()
        cv = torch.from_numpy(cv0).bfloat16()
        ops.reset_dispatch_counts()
        with torch.no_grad():
            out, ck2, cv2 = tattn.decode_attention(
                torch.from_numpy(x).bfloat16(), blk, cfg, ck, cv,
                torch.tensor(pos, dtype=torch.int32))
        assert ck2 is ck and cv2 is cv  # written in place
        assert ops.DISPATCH_COUNTS.get("flash_decode", 0) == (impl == "flash")
        outs[impl] = (out, ck, cv)
    close(outs["flash"][0], outs["blocked"][0].float().numpy(), 2e-2)
    assert torch.equal(outs["flash"][1], outs["blocked"][1])
    assert torch.equal(outs["flash"][2], outs["blocked"][2])
    lp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), params["layers"])
    jout, jck, _ = jattn.decode_attention(
        jnp.asarray(x, jnp.bfloat16), lp["attn"], jcfg, jnp.asarray(ck0, jnp.bfloat16),
        jnp.asarray(cv0, jnp.bfloat16), jnp.asarray(pos, jnp.int32))
    close(outs["flash"][0], _np(jout), BF16)
    np.testing.assert_array_equal(outs["flash"][1].float().numpy(), _np(jck))


# -- the layers the slice adds ------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_gelu_mlp_match_reference(dtype):
    """``layer_norm`` (the reference's E[x^2] - mu^2 clamped at 0) and the
    ungated gelu MLP (tanh approximation) against the reference: 1e-4 in
    float32 (rows of mean 5 and spread 3: the E[x^2] - mu^2 form loses a
    few bits to cancellation), one bf16 ulp of the output scale (2e-2) in
    bf16. A constant row of 2.0 (its variance exactly 0 in both) is held
    to the reference; one of 7.3, whose variance may round below 0, must
    give the bias, finite, in the port (the reference's value there is
    rounding noise times 1/sqrt(eps))."""
    rng = np.random.default_rng(3)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 2e-2
    x = (rng.normal(size=(3, 7, 32)) * 3 + 5).astype(np.float32)
    x[0, 0] = 2.0
    scale, bias = (rng.normal(size=32).astype(np.float32) for _ in range(2))
    jx = jnp.asarray(x, jd)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(td)
    got = tl.layer_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias))
    want = jl.layer_norm(jx, jnp.asarray(scale), jnp.asarray(bias))
    assert got.dtype == td and bool(torch.isfinite(got).all())
    close(got, _np(want), tol)
    flat = torch.full((1, 32), 7.3).to(td)
    got = tl.layer_norm(flat, torch.from_numpy(scale), torch.from_numpy(bias))
    assert bool(torch.isfinite(got).all())
    close(got[0], bias, 1e-3 if dtype == "float32" else 2e-2)
    p = jl.init_mlp(jax.random.key(1), 32, 64, gated=False)
    mod = tl.init_mlp(32, 64, torch.Generator().manual_seed(0), gated=False)
    for k, v in p.items():
        getattr(mod, k).data.copy_(torch.from_numpy(np.array(v)))
    h = rng.normal(size=(2, 5, 32)).astype(np.float32)
    jh = jnp.asarray(h, jd)
    th = torch.from_numpy(np.array(jh.astype(jnp.float32))).to(td)
    close(tl.mlp(th, mod), _np(jl.mlp(jh, p)), 1e-4 if dtype == "float32" else 5e-2)
