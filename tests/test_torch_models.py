"""The port's dense LM against the JAX reference, with the reference's
weights carried across by ``repro_torch.models.convert``: the layers, both
attention cores, and ``lm_prefill``'s last-token logits and KV cache.

Each test runs twice:
  * ``float32`` — ``COMPUTE_DTYPE`` set to float32 in both packages' layer
    modules (monkeypatch; no file of the reference changes). Both sides do
    the same float32 arithmetic in different orders: 1e-4.
  * ``bfloat16`` — the working type. XLA and PyTorch round bf16 at other
    places (XLA fuses the norm/rope/silu chains and rounds once, PyTorch
    rounds after each op), so activations differ by a few bf16 ulps
    (2^-8 relative) and the differences compound over layers: 5e-2 on
    values of order 1.

The KV cache is stored in bf16 by both packages, so in float32 compute a
cache entry may still round to the neighbouring bf16 value: it is held to
one bf16 ulp (at most 2^-7 relative) plus 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jl
from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import lm_from_jax

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
VARIANTS = {"base": {}, "gqa": {"n_kv_heads": 2}, "qkv_bias": {"qkv_bias": True},
            "qk_norm": {"qk_norm": True}, "tied": {"tie_embeddings": True}}


@pytest.fixture(params=["float32", "bfloat16"])
def dtype(request, monkeypatch):
    if request.param == "float32":
        monkeypatch.setattr(jl, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(tl, "COMPUTE_DTYPE", torch.float32)
    return request.param


def _cfgs(variant: str, impl: str = "blocked"):
    """The same reduced paper-lm in both packages' config types."""
    kw = dict(VARIANTS[variant], attn_impl=impl)
    return (dataclasses.replace(jget_config("paper-lm").reduced(), **kw),
            dataclasses.replace(get_config("paper-lm").reduced(), **kw))


def _params(jcfg, seed: int = 0) -> dict:
    """Reference weights as numpy, with norm scales and biases (ones and
    zeros at init) perturbed so they are exercised."""
    params = jtf.init_lm(jax.random.key(seed), jcfg)
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)
    rng = np.random.default_rng(seed)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = jax.tree_util.keystr(path)
        if any(s in name for s in ("ln1", "ln2", "final_norm", "q_norm",
                                   "k_norm", "'bq'", "'bk'", "'bv'")):
            leaf += rng.normal(scale=0.1, size=leaf.shape).astype(np.float32)
    return params


def _close(got: torch.Tensor, want, tol: float, rtol: float | None = None):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol if rtol is None else rtol, atol=tol)


def _tokens(cfg, B=3, S=24, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def test_layers_match_reference(dtype):
    rng = np.random.default_rng(3)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    x = rng.normal(size=(2, 10, 4, 16)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=16)).astype(np.float32)
    jx = jnp.asarray(x, jd)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(td)
    tol = TOL[dtype]
    _close(tl.rms_norm(tx, torch.from_numpy(scale)),
           jl.rms_norm(jx, jnp.asarray(scale)), tol)
    pos = np.arange(10)
    _close(tl.apply_rope(tx, torch.from_numpy(pos), 1e4),
           jl.apply_rope(jx, jnp.asarray(pos), 1e4), tol)

    p = jl.init_mlp(jax.random.key(1), 16, 32)
    np_p = {k: np.array(v) for k, v in p.items()}
    mod = tl.init_mlp(16, 32, torch.Generator().manual_seed(0))
    for k, v in np_p.items():
        getattr(mod, k).data.copy_(torch.from_numpy(v))
    h = rng.normal(size=(2, 10, 16)).astype(np.float32)
    jh = jnp.asarray(h, jd)
    th = torch.from_numpy(np.array(jh.astype(jnp.float32))).to(td)
    _close(tl.mlp(th, mod), jl.mlp(jh, p), tol)

    emb = (rng.normal(size=(50, 16)) * 0.02).astype(np.float32)
    toks = rng.integers(0, 50, (3, 7)).astype(np.int32)
    got = tl.embed_tokens(torch.from_numpy(emb), torch.from_numpy(toks))
    want = jl.embed_tokens(jnp.asarray(emb), jnp.asarray(toks))
    assert got.dtype == td
    _close(got, want, 0.0)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("impl", ["blocked", "flash"])
def test_attention_matches_reference(variant, impl, dtype):
    jcfg, tcfg = _cfgs(variant, impl)
    params = _params(jcfg)
    model = lm_from_jax(params, tcfg, device="cpu")
    lp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), params["layers"])
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 20, tcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    want = jattn.attention(jx, lp["attn"], jcfg)
    got = tattn.attention(tx, model.layers[0].attn, tcfg)
    assert got.dtype == tx.dtype
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("impl", ["blocked", "flash"])
def test_prefill_logits_and_cache_match_reference(variant, impl, dtype):
    jcfg, tcfg = _cfgs(variant, impl)
    params = _params(jcfg)
    model = lm_from_jax(params, tcfg, device="cpu")
    toks = _tokens(tcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jcache, jlogits = jtf.lm_prefill(jparams, {"tokens": jnp.asarray(toks)},
                                     jcfg, max_len=32)
    with torch.no_grad():
        cache, logits = ttf.lm_prefill(model, {"tokens": torch.from_numpy(toks)},
                                       tcfg, max_len=32)
        none, logits_only = ttf.lm_prefill(
            model, {"tokens": torch.from_numpy(toks)}, tcfg, cache=False)
    assert none is None and torch.equal(logits_only, logits)
    assert logits.dtype == torch.float32 and logits.shape == (3, 1, tcfg.vocab)
    tol = TOL[dtype]
    _close(logits, jlogits, tol)
    assert cache["k"].dtype == torch.bfloat16
    assert tuple(cache["k"].shape) == tuple(jcache["k"].shape)
    assert int(cache["pos"]) == int(jcache["pos"]) == toks.shape[1]
    cache_rtol = 2.0 ** -7 if dtype == "float32" else tol
    for key in ("k", "v"):
        _close(cache[key], jcache[key], tol, rtol=cache_rtol)


def test_full_paper_lm_config_is_the_published_one():
    cfg = get_config("paper-lm")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
            cfg.d_ff, cfg.vocab, cfg.rope_theta, cfg.chunk_q) == \
        (8, 512, 8, 8, 64, 2048, 32000, 1e4, 128)
    assert cfg.n_params() == jget_config("paper-lm").n_params() == 66_322_944


def test_other_families_wait():
    """Every family serves and trains now (ROADMAP A10.1): each reduced
    architecture's loss is finite, the train and eval steps exist, and the
    flash op has its backward. The pod mesh of the dry-run tools (A11)
    has landed too: the families' specs build on it, on "meta"."""
    from repro_torch.configs import ALL_ARCHS
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import steps
    from repro_torch.models.optim import OptimConfig
    from repro_torch.models.registry import get_api

    for arch in ("paper-lm", *ALL_ARCHS):
        cfg = get_config(arch).reduced()
        assert callable(steps.make_train_step(cfg, OptimConfig()))
        assert callable(steps.make_eval_step(cfg))
        assert get_api(cfg).loss.__name__.endswith("_loss")
    q = torch.zeros((1, 2, 4, 16), requires_grad=True)
    ops.flash_attention(q, q.detach(), q.detach(), True).sum().backward()
    assert q.grad is not None and not q.grad.any()  # constant v: no gradient
    mesh = make_production_mesh(device="meta")
    assert mesh.shape == {"data": 16, "model": 16}
    assert mesh.device == torch.device("meta")


def test_lm_from_jax_without_a_device_needs_the_card(monkeypatch):
    """No device means the CUDA card: without one it raises, and never
    builds the model on the CPU quietly."""
    jcfg, tcfg = _cfgs("base")
    params = _params(jcfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_from_jax(params, tcfg)
    assert lm_from_jax(params, tcfg, device="cpu").embed.device.type == "cpu"


def test_make_cache_without_a_device_needs_the_card(monkeypatch):
    """``make_cache`` (the API's ``make_cache``) follows the same rule: no
    device means the card, and without one it raises. On the CPU it builds
    the reference's cache: the same shapes and dtypes, all zeros."""
    jcfg, tcfg = _cfgs("gqa")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.make_cache(tcfg, 2, 16)
    want = jtf.make_cache(jcfg, 2, 16)
    got = ttf.make_cache(tcfg, 2, 16, device="cpu")
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].device.type == "cpu"
        assert tuple(got[key].shape) == tuple(w.shape)
        assert str(got[key].dtype).removeprefix("torch.") == str(w.dtype)
        assert not got[key].any()
