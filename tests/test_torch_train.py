"""The port's training slice (ROADMAP A10.1) against the JAX reference on
the CPU: every family's loss and gradients, one full train step, AdamW and
its schedule, the chunked cross entropy and ``cast_once``, at the reduced
configs. The weights are the numpy-seeded ones of
``tests/test_torch_families.py`` (drawn by the port's init, handed to the
reference as its pytree, carried back by ``convert.from_jax``); the port's
gradients, updated weights and AdamW moments go back out through
``convert.to_jax`` and are compared leaf by leaf with the reference's
trees. The reference's functions are jitted once per configuration.

Tolerances (each leaf is held to its own scale, ``max |leaf|``):
  * float32 compute (``COMPUTE_DTYPE`` monkeypatched in both packages):
    loss 1e-5 relative; gradients 1e-4 x the leaf's scale. Both sides sum
    in float32 in different orders (XLA fuses and reassociates), which
    moves the last bits of every product over a few layers.
  * bf16 compute, the working type: loss 2e-2 relative; each gradient
    leaf's L2 distance within 1e-1 of its L2 norm. Activations differ by a
    few bf16 ulps, as in the serving tests; their gradients compound them
    (measured up to 6% on the smallest leaves: the SSD skip D, MoE norms),
    and a token whose top-k router ties differently sends its gradient to
    other experts. A dropped or wrong term moves a leaf by O(1).
    Whisper's encoder runs in bf16 whatever the compute type, so its
    family is held to these in float32 as well.
  * a train step: the loss, metrics, grad norm and lr to 1e-5 relative;
    each leaf's update (new minus old parameters) within 1e-2 of its L2
    norm — the first AdamW steps move an element by about lr whatever the
    size of its gradient, so an element whose gradient is rounding noise
    near 0 may move either way in either package; the moments to 1e-4 x
    their scale.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS
from repro.configs import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import optim as joptim
from repro.models import steps as jsteps
from repro.models.registry import get_api as jget_api
from repro_torch.configs import get_config
from repro_torch.models import layers as tlayers
from repro_torch.models import optim as toptim
from repro_torch.models import steps as tsteps
from repro_torch.models.config import SHAPES, cell_applicable
from repro_torch.models.convert import from_jax, to_jax
from repro_torch.models.registry import get_api
from test_torch_families import FAMILY_ARCH, batches, cfgs, ref_params, set_dtype

LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
SEQ = 24   # 23 predicted positions: one chunk of the reduced loss_chunk 16 and a remainder


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced models' ops are tiny: one intra-op thread a worker runs
    them some 40x faster than eight threads contending with the other
    test workers for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(jcfg, dtype: str) -> str:
    return "bfloat16" if jcfg.family == "encdec" else dtype


def _leaves(tree) -> list:
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _scale(a) -> float:
    return float(np.abs(np.asarray(a, np.float32)).max()) if np.size(a) else 0.0


def assert_tree_close(got: dict, want, tol: float, what: str,
                      atol: float = 0.0, norm: bool = False) -> None:
    """Same structure; every leaf within ``tol`` x its scale (plus
    ``atol``): its own largest |value|, or 1e-3 x the whole tree's where
    that is larger (a leaf whose true gradient is 0, such as a key bias
    under softmax, holds only rounding noise). ``norm``: the leaf's L2
    distance within ``tol`` x its L2 norm (the same floor) instead of
    elementwise."""
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want), what
    floor = 1e-3 * max(_scale(w) for w in jax.tree_util.tree_leaves(want))
    for (path, g), w in zip(_leaves(got), jax.tree_util.tree_leaves(want)):
        w = np.asarray(w, np.float32)
        where = f"{what} {jax.tree_util.keystr(path)}"
        assert g.shape == w.shape, where
        if norm:
            ref = max(float(np.linalg.norm(w)), floor * np.sqrt(w.size))
            err = float(np.linalg.norm(g - w))
            assert err <= atol + tol * ref, f"{where}: |g - w| {err:.3g}, |w| {ref:.3g}"
        else:
            np.testing.assert_allclose(
                g, w, rtol=0, atol=atol + tol * max(_scale(w), floor),
                err_msg=f"{where} (scale {_scale(w):.3g})")


@functools.cache
def _ref_value_and_grad(jcfg, dtype: str, cast: bool):
    api = jget_api(jcfg)

    def loss_fn(p, batch):
        return api.loss(jsteps.cast_once(p, jcfg) if cast else p, batch, jcfg)
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _both(arch: str, dtype: str, monkeypatch, cast: bool = False, **kw):
    """Loss, metrics and gradients of the same batch through both packages
    -> (jcfg, (ref loss, ref metrics, ref grads), (port loss, port
    metrics, port grads as the reference's tree))."""
    set_dtype(monkeypatch, dtype)
    jcfg, tcfg = cfgs(arch, cast_params_once=cast, **kw)
    params = ref_params(jcfg)
    jb, tb = batches(jcfg, 2, SEQ)
    (jloss, jmet), jgrads = _ref_value_and_grad(jcfg, dtype, cast)(
        jax.tree_util.tree_map(jnp.asarray, params), jb)
    model = from_jax(params, tcfg, device="cpu")
    with tsteps.cast_once(model, tcfg):
        loss, met = get_api(tcfg).loss(model, tb, tcfg)
        loss.backward()
    grads = to_jax(model, tcfg, {n: p.grad for n, p in model.named_parameters()})
    return jcfg, (jloss, jmet, jgrads), (loss, met, grads)


def _check(jcfg, dtype, ref, port):
    (jloss, jmet, jgrads), (loss, met, grads) = ref, port
    t = _tol(jcfg, dtype)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_TOL[t])
    assert set(met) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]),
                                   rtol=LOSS_TOL[t], atol=1e-6, err_msg=k)
    assert_tree_close(grads, jgrads, GRAD_TOL[t], f"{jcfg.name} grads",
                      norm=t == "bfloat16")


@pytest.mark.parametrize("family", list(FAMILY_ARCH))
def test_loss_and_grads_match_reference_float32(family, monkeypatch):
    jcfg, ref, port = _both(FAMILY_ARCH[family], "float32", monkeypatch)
    _check(jcfg, "float32", ref, port)


@pytest.mark.parametrize("family", list(FAMILY_ARCH))
def test_loss_and_grads_match_reference_bf16(family, monkeypatch):
    jcfg, ref, port = _both(FAMILY_ARCH[family], "bfloat16", monkeypatch)
    _check(jcfg, "bfloat16", ref, port)


@pytest.mark.parametrize("family", ["dense", "moe", "vlm", "encdec"])
def test_loss_and_grads_flash_path(family, monkeypatch):
    """attn_impl="flash": the attention's backward is the B7 op (its plain
    version on the CPU) against the reference's custom_vjp on its jnp
    twin."""
    jcfg, ref, port = _both(FAMILY_ARCH[family], "float32", monkeypatch,
                            attn_impl="flash")
    _check(jcfg, "float32", ref, port)


@pytest.mark.parametrize("cast", [False, True])
def test_cast_once_matches_reference(cast, monkeypatch):
    """``cast_params_once``: the bf16 copies feed the forward and the
    gradients reach the float32 parameters, as the reference's
    ``cast_once``; off, nothing is swapped."""
    jcfg, ref, port = _both("qwen3-1.7b", "bfloat16", monkeypatch, cast=cast)
    _check(jcfg, "bfloat16", ref, port)
    _, tcfg = cfgs("qwen3-1.7b", cast_params_once=cast)
    model = from_jax(ref_params(jcfg), tcfg, device="cpu")
    wq = model.layers[0].attn.wq
    with tsteps.cast_once(model, tcfg):
        inside = model.layers[0].attn.wq
        assert (inside.dtype == torch.bfloat16) == cast
        assert model.final_norm.dtype == torch.float32  # 1-D: never cast
    assert model.layers[0].attn.wq is wq


# -- one full train step -----------------------------------------------------

STEP_CFG = dict(lr=1e-2, warmup_steps=2, total_steps=10)


@functools.cache
def _ref_train_step(jcfg, dtype: str):
    return jax.jit(jsteps.make_train_step(jcfg, joptim.OptimConfig(**STEP_CFG)))


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_train_step_matches_reference(family, monkeypatch):
    """Two train steps from the same weights and batch: loss, metrics,
    grad norm, lr, the updated parameters, m, v and step after each."""
    set_dtype(monkeypatch, "float32")
    jcfg, tcfg = cfgs(FAMILY_ARCH[family])
    params = ref_params(jcfg)
    jb, tb = batches(jcfg, 2, SEQ)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jopt = joptim.init_opt_state(jp)
    model = from_jax(params, tcfg, device="cpu")
    opt = toptim.init_opt_state(model)
    step = tsteps.make_train_step(tcfg, toptim.OptimConfig(**STEP_CFG))
    jstep = _ref_train_step(jcfg, "float32")
    prev = params
    for i in range(2):
        jp, jopt, jm = jstep(jp, jopt, jb)
        model, opt, m = step(model, opt, tb)
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {i} {k}")
        before = jax.tree_util.tree_map(np.asarray, prev)
        assert_tree_close(
            jax.tree_util.tree_map(np.subtract, to_jax(model, tcfg), before),
            jax.tree_util.tree_map(lambda a, b: np.asarray(a) - b, jp, before),
            1e-2, f"step {i} updates", norm=True)
        prev = jp
        for mom in ("m", "v"):
            assert_tree_close(to_jax(model, tcfg, opt[mom]), jopt[mom], 1e-4,
                              f"step {i} {mom}")
        assert opt["step"].dtype == torch.int32 and int(opt["step"]) == i + 1
        assert int(jopt["step"]) == i + 1
        assert all(p.grad is None for p in model.parameters())


def test_eval_step_matches_reference(monkeypatch):
    set_dtype(monkeypatch, "float32")
    jcfg, tcfg = cfgs("deepseek-moe-16b")
    params = ref_params(jcfg)
    jb, tb = batches(jcfg, 2, SEQ)
    want = jax.jit(jsteps.make_eval_step(jcfg))(
        jax.tree_util.tree_map(jnp.asarray, params), jb)
    got = tsteps.make_eval_step(tcfg)(from_jax(params, tcfg, device="cpu"), tb)
    assert set(got) == set(want)
    for k in want:
        assert not got[k].requires_grad
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


# -- AdamW and the schedule on random trees -----------------------------------

OPT = joptim.OptimConfig(lr=1e-3, warmup_steps=10, total_steps=100)
SHAPES_TREE = {"w": (6, 5), "b": (5,), "emb": (3, 4, 2), "s": (1,)}


class _Tree(torch.nn.Module):
    def __init__(self, arrays: dict):
        super().__init__()
        for k, a in arrays.items():
            setattr(self, k, torch.nn.Parameter(torch.from_numpy(a.copy())))


@pytest.mark.parametrize("step0", [0, 9, 10, 55, 99, 100])
def test_adamw_update_matches_reference(step0):
    """One update from a state at ``step0`` (the update runs step0 + 1):
    the first step, warmup's last, its end, mid-cosine, the last step and
    past it; a vector and a (1,) parameter take no weight decay."""
    rng = np.random.default_rng(step0)
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES_TREE.items()}
    g = {k: (rng.normal(size=s) * 3).astype(np.float32) for k, s in SHAPES_TREE.items()}
    m = {k: rng.normal(size=s).astype(np.float32) * 0.1 for k, s in SHAPES_TREE.items()}
    v = {k: rng.random(size=s).astype(np.float32) * 0.1 for k, s in SHAPES_TREE.items()}
    jstate = {"m": m, "v": v, "step": jnp.asarray(step0, jnp.int32)}
    jp, js, jmet = joptim.adamw_update(p, g, jstate, OPT)
    tree = _Tree(p)
    for k, a in g.items():
        getattr(tree, k).grad = torch.from_numpy(a.copy())
    state = {"m": {k: torch.from_numpy(a.copy()) for k, a in m.items()},
             "v": {k: torch.from_numpy(a.copy()) for k, a in v.items()},
             "step": torch.tensor(step0, dtype=torch.int32)}
    met = toptim.adamw_update(tree, state, toptim.OptimConfig(**dataclasses.asdict(OPT)))
    for k in p:
        np.testing.assert_allclose(getattr(tree, k).detach().numpy(), jp[k],
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(state["m"][k].numpy(), js["m"][k], rtol=1e-6,
                                   atol=1e-8, err_msg=f"m {k}")
        np.testing.assert_allclose(state["v"][k].numpy(), js["v"][k], rtol=1e-6,
                                   atol=1e-8, err_msg=f"v {k}")
    assert int(state["step"]) == int(js["step"]) == step0 + 1
    np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]), rtol=1e-6)


@pytest.mark.parametrize("step", [0, 5, 10, 55, 100, 150])
def test_schedule_matches_reference(step):
    got = toptim.schedule(toptim.OptimConfig(**dataclasses.asdict(OPT)),
                          torch.tensor(step, dtype=torch.int32))
    want = joptim.schedule(OPT, jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-12)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(3)
    g = {k: (rng.normal(size=s) * 4).astype(np.float32) for k, s in SHAPES_TREE.items()}
    jg, jn = joptim.clip_by_global_norm(g, 1.0)
    tg = [torch.from_numpy(a.copy()) for a in g.values()]
    n = toptim.clip_by_global_norm(tg, 1.0)
    np.testing.assert_allclose(float(n), float(jn), rtol=1e-6)
    for t, k in zip(tg, g):
        np.testing.assert_allclose(t.numpy(), jg[k], rtol=1e-6, atol=1e-7)


# -- the chunked cross entropy -----------------------------------------------


@pytest.mark.parametrize("S,chunk", [(37, 16), (16, 16), (5, 16)])
def test_chunked_ce_loss_matches_reference(S, chunk):
    """Value and gradients (hidden and head), with a remainder chunk (37 =
    2 x 16 + 5), one exact chunk, and a chunk longer than S."""
    rng = np.random.default_rng(S)
    h = rng.normal(size=(2, S, 8)).astype(np.float32)
    head = rng.normal(size=(8, 50)).astype(np.float32)
    lab = rng.integers(0, 50, (2, S)).astype(np.int32)

    def jloss(h, head):
        return jlayers.chunked_ce_loss(h, head, jnp.asarray(lab), chunk=chunk)
    want, (wh, whead) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(head))
    th = torch.from_numpy(h).requires_grad_(True)
    thead = torch.from_numpy(head).requires_grad_(True)
    got = tlayers.chunked_ce_loss(th, thead, torch.from_numpy(lab),
                                  chunk=chunk)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), wh, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(thead.grad.numpy(), whead, rtol=1e-4, atol=1e-5)


def test_chunked_ce_loss_recomputes_each_chunk():
    """Each chunk runs under a checkpoint: its float32 logits are not kept
    for the backward (a saved-tensor hook sees no (B, chunk, V) tensor)."""
    h = torch.randn(2, 40, 8, requires_grad=True)
    head = torch.randn(8, 64, requires_grad=True)
    lab = torch.randint(0, 64, (2, 40))
    shapes = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: shapes.append(tuple(t.shape)) or t, lambda t: t):
        loss = tlayers.chunked_ce_loss(h, head, lab, chunk=16)
    assert not any(s[-1] == 64 and len(s) == 3 for s in shapes), shapes
    loss.backward()
    assert h.grad is not None and head.grad is not None


# -- replays of tests/test_models.py -----------------------------------------


def _smoke_batch(cfg, B=2, S=32, seed=1):
    """tests/test_models.py's _smoke_batch, drawn with numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(B, cfg.enc_len, cfg.d_model)).astype(np.float32)).bfloat16()
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.normal(
            size=(B, cfg.num_patches, cfg.patch_dim)).astype(np.float32)).bfloat16()
    return batch


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_arch_train_smoke(arch):
    cfg = get_config(arch).reduced()
    model, opt = tsteps.init_train_state(
        cfg, torch.Generator(device="cpu").manual_seed(0))
    before = [p.detach().clone() for p in model.parameters()]
    step = tsteps.make_train_step(cfg, toptim.OptimConfig(total_steps=10))
    model, opt, m = step(model, opt, _smoke_batch(cfg))
    assert np.isfinite(float(m["loss"])), m
    assert np.isfinite(float(m["grad_norm"]))
    delta = sum(float((a - b).abs().sum())
                for a, b in zip(before, model.parameters()))
    assert delta > 0


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_arch_serve_consistency(arch):
    """prefill(n) + decode(1) logits == prefill(n+1) last logits."""
    cfg = get_config(arch).reduced()
    api = get_api(cfg)
    model = api.init(cfg, torch.Generator(device="cpu").manual_seed(0))
    batch = _smoke_batch(cfg, B=2, S=17)
    part = dict(batch, tokens=batch["tokens"][:, :16])
    with torch.no_grad():
        _, logits_full = api.prefill(model, batch, cfg, 24)
        cache, _ = api.prefill(model, part, cfg, 24)
        _, logits_dec = api.decode(model, cache, batch["tokens"][:, 16:17], cfg)
    d = float((logits_full[:, -1] - logits_dec[:, -1]).abs().max())
    assert d < 0.1, f"{arch}: prefill/decode mismatch {d}"


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_arch_loss_decreases(arch):
    cfg = get_config(arch).reduced()
    model, opt = tsteps.init_train_state(
        cfg, torch.Generator(device="cpu").manual_seed(0))
    batch = _smoke_batch(cfg, B=2, S=32)
    step = tsteps.make_train_step(cfg, toptim.OptimConfig(
        lr=3e-3, warmup_steps=0, total_steps=100))
    losses = []
    for _ in range(8):
        model, opt, m = step(model, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], f"{arch}: no learning {losses}"


def test_full_configs_match_assignment():
    """The exact published numbers (tests/test_models.py:81-105), on the
    port's configs."""
    expect = {
        "deepseek-moe-16b": (28, 2048, 16, 16, 1408, 102400),
        "moonshot-v1-16b-a3b": (48, 2048, 16, 16, 1408, 163840),
        "qwen2.5-14b": (48, 5120, 40, 8, 13824, 152064),
        "qwen2-72b": (80, 8192, 64, 8, 29568, 152064),
        "qwen3-1.7b": (28, 2048, 16, 8, 6144, 151936),
        "command-r-35b": (40, 8192, 64, 8, 22528, 256000),
        "rwkv6-1.6b": (24, 2048, 32, 32, 7168, 65536),
        "whisper-base": (6, 512, 8, 8, 2048, 51865),
        "llava-next-mistral-7b": (32, 4096, 32, 8, 14336, 32000),
        "zamba2-1.2b": (38, 2048, 32, 32, 8192, 32000),
    }
    for arch, (L, d, h, kv, ff, V) in expect.items():
        c = get_config(arch)
        assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff, c.vocab) \
            == (L, d, h, kv, ff, V), arch
    assert get_config("deepseek-moe-16b").moe.num_experts == 64
    assert get_config("deepseek-moe-16b").moe.top_k == 6
    assert get_config("moonshot-v1-16b-a3b").moe.num_shared == 2
    assert get_config("qwen3-1.7b").qk_norm
    assert get_config("qwen2-72b").qkv_bias
    assert get_config("zamba2-1.2b").ssm_state == 64


def test_long_500k_applicability():
    runs = {a: cell_applicable(get_config(a), SHAPES["long_500k"])[0]
            for a in ALL_ARCHS}
    assert runs["rwkv6-1.6b"] and runs["zamba2-1.2b"]
    assert not runs["qwen2-72b"] and not runs["whisper-base"]
    assert sum(runs.values()) == 2


def test_param_counts_are_sane():
    approx = {"qwen2-72b": 72e9, "qwen2.5-14b": 14e9, "qwen3-1.7b": 1.7e9,
              "command-r-35b": 35e9, "rwkv6-1.6b": 1.6e9,
              "deepseek-moe-16b": 16e9, "moonshot-v1-16b-a3b": 27e9,
              "llava-next-mistral-7b": 7e9, "zamba2-1.2b": 1.2e9}
    for arch, want in approx.items():
        got = get_config(arch).n_params()
        assert 0.5 * want < got < 1.7 * want, (arch, got, want)
        assert got == jget_config(arch).n_params(), arch
    active = get_config("moonshot-v1-16b-a3b").n_active_params()
    assert 1.5e9 < active < 6e9, active


def test_to_jax_round_trips_from_jax():
    """``to_jax`` is ``from_jax``'s inverse, bit for bit, and lays out a
    named dict of tensors (gradients, moments) the same way; a missing name
    raises."""
    jcfg, tcfg = cfgs("deepseek-moe-16b")
    params = ref_params(jcfg)
    model = from_jax(params, tcfg, device="cpu")
    back = to_jax(model, tcfg)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    doubled = to_jax(model, tcfg, {n: 2 * p for n, p in model.named_parameters()})
    for a, b in zip(jax.tree_util.tree_leaves(doubled), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, 2 * b)
    with pytest.raises(ValueError, match="no value"):
        to_jax(model, tcfg, {})
