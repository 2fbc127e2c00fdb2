"""The port's serving path for every model family against the JAX
reference, at the reduced configs: the reference's parameters carried
across by ``repro_torch.models.convert.from_jax`` and the same
numpy-seeded inputs through ``get_api(cfg).prefill / .decode`` of both
packages (the reference's prefill and decode jitted as one program per
configuration, its flash ops on their jnp twins; the port on the CPU, its
kernels' plain versions). The weights are drawn once per architecture by
the port's seeded init and handed to the reference as its pytree
(checked against the reference init's structure and shapes), then
carried back into a fresh port model by ``from_jax``.

Tolerances (absolute and relative alike):
  * bf16 compute, the working type: 5e-2. XLA and PyTorch round bf16 at
    other places (XLA fuses chains and rounds once), so activations differ
    by a few bf16 ulps (2^-8 relative) that compound over the layers, on
    logits and cache entries of order 1.
  * float32 compute (``COMPUTE_DTYPE`` monkeypatched in both packages'
    ``models/layers.py``): 1e-4, and one bf16 ulp (2^-7 relative) on the
    bf16 caches; whisper's encoder runs in bf16 in both packages whatever
    the compute type (``encode`` casts the frames), so it is held to the
    bf16 tolerance.
"""
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jl
import repro_torch.models.layers as tl
from repro.configs import ALL_ARCHS
from repro.configs import get_config as jget_config
from repro.models.registry import get_api as jget_api
from repro_torch.configs import get_config
from repro_torch.models.convert import STACKED, from_jax, lm_from_jax
from repro_torch.models.registry import get_api, prefill_cache_len

TOL = {"bfloat16": 5e-2, "float32": 1e-4}
FAMILY_ARCH = {"dense": "qwen3-1.7b", "moe": "deepseek-moe-16b",
               "vlm": "llava-next-mistral-7b", "rwkv": "rwkv6-1.6b",
               "hybrid": "zamba2-1.2b", "encdec": "whisper-base"}
# leaves that start as ones or zeros (norms, biases, mixes, decays): moved
# off their initial values so that both packages must apply them
_PERTURB = re.compile(r"\['(\w*ln\w*|\w*norm\w*|b[qkv]|\w+_b|dt_bias|A_log|D|u|"
                      r"w0|mu_\w+)'\]$")


def cfgs(arch: str, **kw):
    """The reduced config of ``arch`` in both packages' config types."""
    return (dataclasses.replace(jget_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _tree(mod) -> dict:
    """A port module's parameters as the reference's pytree (numpy leaves;
    the blocks of a stacked key stacked on a leading axis)."""
    out = {n: p.detach().numpy().copy() for n, p in mod._parameters.items()
           if p is not None}
    for n, m in mod._modules.items():
        if n in STACKED:
            blocks = [_tree(b) for b in m]
            out[n] = jax.tree_util.tree_map(lambda *a: np.stack(a), *blocks)
        else:
            out[n] = _tree(m)
    return out


@functools.cache
def _params(arch: str, seed: int) -> dict:
    jcfg, tcfg = cfgs(arch)
    params = _tree(get_api(tcfg).init(tcfg, torch.Generator().manual_seed(seed)))
    rng = np.random.default_rng(seed)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        if _PERTURB.search(jax.tree_util.keystr(path)):
            leaf += rng.normal(scale=0.05, size=leaf.shape).astype(np.float32)
    want = jax.eval_shape(lambda k: jget_api(jcfg).init(k, jcfg),
                          jax.random.key(0))
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(want), arch
    for a, w in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(want)):
        assert a.shape == w.shape and w.dtype == jnp.float32, arch
    return params


def ref_params(jcfg, seed: int = 0) -> dict:
    """Weights in the reference's pytree layout (numpy, read-only by
    convention): seeded random ones drawn by the port's own init, with the
    norm scales, biases, mixes and decays moved by N(0, 0.05) off their
    ones and zeros so that both packages must apply them. Checked against
    the reference init's tree structure, shapes and dtypes
    (``jax.eval_shape``); drawing them with ``jax.random`` instead would
    cost a compile per config for no other check."""
    return _params(jcfg.name.removesuffix("-smoke"), seed)


def batches(cfg, B: int, S: int, seed: int = 1):
    """The same numpy-drawn batch for both packages: tokens (B, S) int32,
    and frames / patches in bf16 for encdec / vlm."""
    rng = np.random.default_rng(seed)
    nb = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        nb["frames"] = rng.normal(size=(B, cfg.enc_len, cfg.d_model))
    if cfg.family == "vlm":
        nb["patches"] = rng.normal(size=(B, cfg.num_patches, cfg.patch_dim))
    jb = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.bfloat16)
          for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) if k == "tokens"
          else torch.from_numpy(v.astype(np.float32)).bfloat16()
          for k, v in nb.items()}
    return jb, tb


@functools.cache
def ref_serve(jcfg, dtype: str):
    """The reference's prefill (cache depth 24) then one decode step,
    jitted as one program per config and compute dtype (a jitted function
    keeps the ``COMPUTE_DTYPE`` it was traced under). Returns (prefill logits, cache after
    prefill, decode logits, cache after decode)."""
    api = jget_api(jcfg)

    def run(params, batch, nxt):
        c1, l1 = api.prefill(params, batch, jcfg, 24)
        c2, l2 = api.decode(params, c1, nxt, jcfg)
        return l1, c1, l2, c2
    return jax.jit(run)


def close(got, want, tol: float, rtol: float | None = None, what: str = ""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol if rtol is None else rtol,
                               err_msg=what)


def set_dtype(monkeypatch, dtype: str) -> None:
    if dtype == "float32":
        monkeypatch.setattr(jl, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(tl, "COMPUTE_DTYPE", torch.float32)


def _tol(jcfg, dtype: str, cached: bool = False):
    """(atol, rtol) for a comparison: see the module docstring."""
    if dtype == "bfloat16" or jcfg.family == "encdec":
        return TOL["bfloat16"], TOL["bfloat16"]
    return TOL["float32"], 2.0 ** -7 if cached else TOL["float32"]


_RUNS: dict = {}


def serve_both(arch: str, dtype: str = "bfloat16", impl: str = "blocked",
               monkeypatch=None):
    """Prefill 16 tokens (cache depth 24) and one decode step through both
    packages on the same weights and inputs; the reference's results are
    kept per (arch, dtype, impl). Returns (jcfg, {"ref": ..., "port": ...})
    with numpy logits and caches after each phase."""
    if monkeypatch is not None:
        set_dtype(monkeypatch, dtype)
    key = (arch, dtype, impl)
    jcfg, tcfg = cfgs(arch, attn_impl=impl)
    params = ref_params(jcfg)
    jb, tb = batches(jcfg, 2, 16)
    nxt = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 1)).astype(np.int32)
    if key not in _RUNS:
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        l1, c1, l2, c2 = ref_serve(jcfg, dtype)(jp, jb, jnp.asarray(nxt))

        def f32(c):
            return {k: np.asarray(v.astype(jnp.float32)) for k, v in c.items()}
        _RUNS[key] = {"prefill": (np.asarray(l1), f32(c1)),
                      "decode": (np.asarray(l2), f32(c2))}
    model = from_jax(params, tcfg, device="cpu")
    api = get_api(tcfg)
    with torch.no_grad():
        c1, l1 = api.prefill(model, tb, tcfg, 24)
        snap = {k: v.float().clone().numpy() for k, v in c1.items()}
        c2, l2 = api.decode(model, c1, torch.from_numpy(nxt), tcfg)
    port = {"prefill": (l1.numpy(), snap),
            "decode": (l2.numpy(), {k: v.float().numpy() for k, v in c2.items()})}
    return jcfg, {"ref": _RUNS[key], "port": port}


def _assert_phase(jcfg, runs, phase: str, dtype: str) -> None:
    (jl_, jc), (tl_, tc) = runs["ref"][phase], runs["port"][phase]
    atol, rtol = _tol(jcfg, dtype)
    assert tl_.shape == jl_.shape and tl_.dtype == np.float32
    close(tl_, jl_, atol, rtol, f"{phase} logits")
    assert set(tc) == set(jc)
    catol, crtol = _tol(jcfg, dtype, cached=True)
    for k in jc:
        assert tc[k].shape == jc[k].shape, k
        close(tc[k], jc[k], catol, crtol, f"{phase} cache {k}")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_prefill_cache_and_logits_match_reference(arch):
    jcfg, runs = serve_both(arch)
    _assert_phase(jcfg, runs, "prefill", "bfloat16")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decode_step_logits_and_cache_match_reference(arch):
    jcfg, runs = serve_both(arch)
    _assert_phase(jcfg, runs, "decode", "bfloat16")
    assert int(runs["port"]["decode"][1]["pos"]) == \
        prefill_cache_len(cfgs(arch)[1], 16) + 1


@pytest.mark.parametrize("family", list(FAMILY_ARCH))
@pytest.mark.parametrize("dtype,impl", [("float32", "blocked"),
                                        ("bfloat16", "flash")])
def test_family_variants_match_reference(family, dtype, impl, monkeypatch):
    """Per family: float32 compute (the algorithm, at 1e-4), and bf16
    under ``attn_impl="flash"`` (prefill through ``flash_attention``,
    decode through ``flash_decode``, here their plain versions, against
    the reference's flash prefill and its einsum decode)."""
    jcfg, runs = serve_both(FAMILY_ARCH[family], dtype, impl, monkeypatch)
    for phase in ("prefill", "decode"):
        _assert_phase(jcfg, runs, phase, dtype)


def _port_batch(tcfg, S: int):
    return batches(tcfg, 2, S)[1]


@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("impl", ["blocked", "flash"])
def test_port_prefill_then_decode_equals_longer_prefill(arch, impl):
    """tests/test_models.py::test_arch_serve_consistency on the port:
    prefill(16) + decode(1) gives prefill(17)'s last logits (0.1, the
    reference's bound, for bf16 paths that differ in rounding)."""
    jcfg, tcfg = cfgs(arch, attn_impl=impl)
    model = from_jax(ref_params(jcfg), tcfg, device="cpu")
    api = get_api(tcfg)
    batch = _port_batch(tcfg, 17)
    with torch.no_grad():
        _, full = api.prefill(model, batch, tcfg, 24)
        cache, _ = api.prefill(model, dict(batch, tokens=batch["tokens"][:, :16]),
                               tcfg, 24)
        cache, dec = api.decode(model, cache, batch["tokens"][:, 16:17], tcfg)
    d = float((full[:, -1] - dec[:, -1]).abs().max())
    assert d < 0.1, f"{arch}: prefill/decode mismatch {d}"


@pytest.mark.parametrize("family", list(FAMILY_ARCH))
def test_make_cache_matches_reference_and_needs_a_device(family, monkeypatch):
    """``make_cache`` gives the reference's zeros (shapes and dtypes); with
    no device it means the card, and without one it raises."""
    jcfg, tcfg = cfgs(FAMILY_ARCH[family])
    want = jget_api(jcfg).make_cache(jcfg, 2, 24)
    got = get_api(tcfg).make_cache(tcfg, 2, 24, device="cpu")
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k
        assert not got[k].any()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_api(tcfg).make_cache(tcfg, 2, 24)


@pytest.mark.parametrize("family", list(FAMILY_ARCH))
def test_loss_waits_for_training(family):
    """Training has landed (ROADMAP A10.1): every family's ``loss`` gives a
    finite float32 scalar that autograd differentiates into every
    parameter. tests/test_torch_train.py holds the values and gradients
    to the reference's."""
    jcfg, tcfg = cfgs(FAMILY_ARCH[family])
    model = from_jax(ref_params(jcfg), tcfg, device="cpu")
    _, tb = batches(jcfg, 2, 8)
    loss, metrics = get_api(tcfg).loss(model, tb, tcfg)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert bool(torch.isfinite(loss)) and "ce" in metrics
    loss.backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())


def test_convert_refuses_keys_without_a_home():
    """A reference key with no port parameter, or a port parameter with no
    reference key, raises, as does a layer count that differs."""
    jcfg, tcfg = cfgs("deepseek-moe-16b")
    params = ref_params(jcfg)
    extra = dict(params, layers=dict(params["layers"],
                                     stray=np.zeros((1, 2), np.float32)))
    with pytest.raises(ValueError, match="stray"):
        from_jax(extra, tcfg, device="cpu")
    missing = {k: v for k, v in params.items() if k != "first_layers"}
    with pytest.raises(ValueError, match="first_layers"):
        from_jax(missing, tcfg, device="cpu")
    more = dataclasses.replace(tcfg, n_layers=tcfg.n_layers + 1)
    with pytest.raises(ValueError, match="reference layers"):
        from_jax(params, more, device="cpu")
    with pytest.raises(ValueError, match="transformer LM"):
        lm_from_jax(ref_params(cfgs("rwkv6-1.6b")[0]),
                    cfgs("rwkv6-1.6b")[1], device="cpu")
