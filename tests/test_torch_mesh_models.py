"""The model paths on the port's one-device mesh (ROADMAP A9b, the one-card
half) against the JAX reference on the CPU.

The reference's own mesh tests (tests/test_distributed.py) cannot build
their jax meshes in the installed jax, so each path is held to what runs:
the reference's meshless paths (its own tests' baselines), its per-rank
bodies called by hand, and its ``compressed_psum`` under
``jax.vmap(axis_name=...)``. Tolerances:

* ``compressed_psum``: bit for bit (both round half to even, divide in
  float32 and sum int32 payloads exactly).
* expert-parallel ``moe_ffn`` on (data 2, model 4): within 2e-4 of the
  reference's meshless layer (its test's bound; float32 sums in another
  order); each rank's partial within 1e-6 of the reference's
  ``_local_moe(..., rank=r, e_local=2)`` on the same row block.
* the shardmap decode on (2, 2): the reference test's bounds against the
  reference's one-hot decode (max |logit diff| < 8e-2, equal argmax,
  cache k within 0.06: bf16 compute), at every step over a shard
  boundary, with and without a sliding window.
* the data-parallel train step on (4, 2): the loss within 5e-3 of the
  reference's unsharded step (its test's bound); every gradient leaf
  within 2e-2 (bf16 compute) / 1e-5 (float32 compute) relative L2 of the
  port's meshless step: the shards sum their tokens in other orders, and
  bf16 rounds activations per GEMM shape.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro.models import optim as joptim
from repro.models import steps as jsteps
from repro.models.config import ArchConfig as JArchConfig
from repro.models.config import MoESpec as JMoESpec
from repro.models.registry import get_api as jget_api
from repro.runtime import checkpoint as jckpt
from repro.runtime import compress as JC
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import launcher_mesh, make_local_mesh
from repro_torch.models import attention as tattn
from repro_torch.models import convert
from repro_torch.models import moe as tmoe
from repro_torch.models import optim as toptim
from repro_torch.models import steps as tsteps
from repro_torch.models.config import ArchConfig, MoESpec
from repro_torch.models.registry import get_api
from repro_torch.models.sharding import NamedSharding, P, sharding_ctx
from repro_torch.runtime import compress as TC
from repro_torch.runtime.checkpoint import CheckpointManager
from test_torch_families import ref_params, set_dtype


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced models' ops are tiny: one intra-op thread a worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(data: int, model: int):
    return make_local_mesh(data, model, device="cpu")


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


# -- compressed_psum -------------------------------------------------------------------


def _shard_grads(seed: int, n: int = 8) -> dict:
    """tests/test_distributed.py's (8, 128) gradients (default_rng(0) for
    seed 0), a tiny leaf, an all-zero one and exact .5 ties, stacked over
    the shards."""
    rng = np.random.default_rng(seed)
    ties = np.tile(np.array([127.0, 2.5, 3.5, -0.5, -1.5, 0.5, 126.5, -126.5],
                            np.float32), (n, 1))
    return {"w": rng.normal(size=(n, 128)).astype(np.float32),
            "layers": {"b": (rng.normal(size=(n, 31)) * 1e-3).astype(np.float32),
                       "zero": np.zeros((n, 4, 4), np.float32)},
            "ties": ties}


def _shard(tree: dict, i: int) -> dict:
    return {k: _shard(v, i) if isinstance(v, dict) else torch.from_numpy(v[i].copy())
            for k, v in tree.items()}


def _ref_compressed(g: dict, e: dict):
    f = lambda g, e: JC.compressed_psum(g, e, "data")  # noqa: E731
    return jax.vmap(f, axis_name="data")(
        jax.tree_util.tree_map(jnp.asarray, g), jax.tree_util.tree_map(jnp.asarray, e))


def test_compressed_psum_bit_equal_to_reference_under_vmap():
    n = 8
    g = _shard_grads(0, n)
    e = jax.tree_util.tree_map(np.zeros_like, g)
    te = [TC.init_error_state(_shard(g, i)) for i in range(n)]
    for step in range(3):
        jm, je = _ref_compressed(g, e)
        tm, te = TC.compressed_psum([_shard(g, i) for i in range(n)], te)
        jl, tl = jax.tree_util.tree_leaves(jm), jax.tree_util.tree_leaves(tm)
        for a, b in zip(jl, tl):
            a = np.asarray(a)
            for i in range(n):   # every shard holds the same mean
                assert np.array_equal(_bits(a[i]), _bits(b.numpy())), step
        for i in range(n):
            for a, b in zip(jax.tree_util.tree_leaves(je),
                            jax.tree_util.tree_leaves(te[i])):
                assert np.array_equal(_bits(np.asarray(a)[i]), _bits(b.numpy()))
        e = jax.tree_util.tree_map(np.asarray, je)
        g = _shard_grads(step + 1, n)
    # the reference test's own check: the mean within 0.02 of numpy's
    g = _shard_grads(0, n)
    tm, _ = TC.compressed_psum([_shard(g, i) for i in range(n)],
                               [TC.init_error_state(_shard(g, i)) for i in range(n)])
    assert np.abs(tm["w"].numpy() - g["w"].mean(axis=0)).max() < 0.02


def test_compressed_psum_refuses_mismatched_trees():
    g = {"w": torch.ones(3)}
    with pytest.raises(ValueError):
        TC.compressed_psum([g, g], [TC.init_error_state(g)])
    with pytest.raises(ValueError):
        TC.compressed_psum([g, {"v": torch.ones(3)}],
                           [TC.init_error_state(g)] * 2)


# -- expert-parallel MoE ---------------------------------------------------------------


def _moe_cfgs(capacity_factor: float = 16.0, gather: str = "f32"):
    """tests/test_distributed.py:157-167's config in both packages."""
    kw = dict(name="m", family="moe", n_layers=1, d_model=32, n_heads=2,
              n_kv_heads=2, d_ff=64, vocab=64, d_head=16, moe_gather_dtype=gather)
    spec = dict(num_experts=8, top_k=2, num_shared=1, d_ff_expert=16,
                capacity_factor=capacity_factor)
    return (JArchConfig(**kw, moe=JMoESpec(**spec)),
            ArchConfig(**kw, moe=MoESpec(**spec)))


def _moe_layer(capacity_factor: float = 16.0, gather: str = "f32"):
    jcfg, tcfg = _moe_cfgs(capacity_factor, gather)
    jp = jmoe.init_moe(jax.random.key(0), jcfg, jcfg.moe)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    layer = tmoe.init_moe(tcfg, tcfg.moe, torch.Generator().manual_seed(0))
    convert._load(layer, tree, "moe")
    x = np.array(jax.random.normal(jax.random.key(1), (4, 8, 32), jnp.float32))
    return jcfg, tcfg, jp, layer, x


def _ref_rank_partials(jp, jcfg, x: np.ndarray, blocks: int, ranks: int,
                       cast=None) -> list:
    """The reference's per-rank bodies by hand: [block][rank] partial y."""
    E = jcfg.moe.num_experts
    el = E // ranks
    ex = jp["experts"]
    ws = {k: ex[k] if cast is None else ex[k].astype(cast) for k in ex}
    out = []
    for xb in np.split(x, blocks):
        out.append([np.asarray(jmoe._local_moe(
            jnp.asarray(xb), jp["router"], ws["w1"][r * el:(r + 1) * el],
            ws["w3"][r * el:(r + 1) * el], ws["w2"][r * el:(r + 1) * el],
            spec=jcfg.moe, e_local=el, rank=r, psum=lambda v: v,
            pmean=lambda v: v)[0]) for r in range(ranks)])
    return out


def test_moe_ep_matches_reference_local_path():
    jcfg, tcfg, jp, layer, x = _moe_layer()
    y1, aux1 = jmoe.moe_ffn(jnp.asarray(x), jp, jcfg, jcfg.moe)   # no ctx
    calls = []
    real = tmoe._dispatch

    def spy(*a, **kw):
        calls.append(kw["rank"])
        return real(*a, **kw)

    tmoe._dispatch = spy
    try:
        with torch.no_grad(), sharding_ctx(cpu_mesh(2, 4)):
            y2, aux2 = tmoe.moe_ffn(torch.from_numpy(x), layer, tcfg, tcfg.moe)
    finally:
        tmoe._dispatch = real
    assert calls == [0, 1, 2, 3, 0, 1, 2, 3]   # 2 data blocks x 4 model ranks
    np.testing.assert_allclose(y2.numpy(), np.asarray(y1), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(aux2), float(aux1), rtol=2e-4)


@pytest.mark.parametrize("capacity_factor", [16.0, 1.0])
def test_moe_ep_rank_partials_match_reference_bodies(capacity_factor):
    """Each rank's partial (its own experts, offset and capacity over its
    block's tokens; at capacity_factor 1.0 tokens are dropped) equals the
    reference's ``_local_moe`` body called with ``rank=r, e_local=2``."""
    jcfg, tcfg, jp, layer, x = _moe_layer(capacity_factor)
    want = _ref_rank_partials(jp, jcfg, x, blocks=2, ranks=4)
    ex = layer.experts
    for b, xb in enumerate(np.split(x, 2)):
        for r in range(4):
            with torch.no_grad():
                got, _ = tmoe._local_moe(
                    torch.from_numpy(xb), layer.router, ex.w1[2 * r:2 * r + 2],
                    ex.w3[2 * r:2 * r + 2], ex.w2[2 * r:2 * r + 2],
                    spec=tcfg.moe, e_local=2, rank=r, psum=lambda v: v,
                    pmean=lambda v: v)
            np.testing.assert_allclose(got.numpy(), want[b][r], rtol=1e-6,
                                       atol=1e-6, err_msg=f"block {b} rank {r}")
    # the layer under the mesh is the psum of those partials, plus shared
    shared = np.asarray(jmoe.mlp(jnp.asarray(x), jp["shared"]))
    want_y = np.concatenate([sum(parts) for parts in want]) + shared
    with torch.no_grad(), sharding_ctx(cpu_mesh(2, 4)):
        y, _ = tmoe.moe_ffn(torch.from_numpy(x), layer, tcfg, tcfg.moe)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-5, atol=1e-5)


def test_moe_ep_gathers_bf16_experts():
    """``moe_gather_dtype="bf16"`` casts the expert weights before the
    ranks run, as the reference's EP branch does."""
    jcfg, tcfg, jp, layer, x = _moe_layer(gather="bf16")
    want = _ref_rank_partials(jp, jcfg, x, blocks=2, ranks=4, cast=jnp.bfloat16)
    shared = np.asarray(jmoe.mlp(jnp.asarray(x), jp["shared"]))
    want_y = np.concatenate([sum(parts) for parts in want]) + shared
    with torch.no_grad(), sharding_ctx(cpu_mesh(2, 4)):
        y, _ = tmoe.moe_ffn(torch.from_numpy(x), layer, tcfg, tcfg.moe)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        y_f32, _ = tmoe.moe_ffn(torch.from_numpy(x), layer, tcfg, tcfg.moe)
    assert not np.allclose(y.numpy(), y_f32.numpy(), rtol=0, atol=1e-7)


def test_moe_without_expert_parallelism_is_the_meshless_layer():
    """A model extent that does not divide E (or is 1): the reference's
    GSPMD layer over the whole batch, one capacity."""
    jcfg, tcfg, jp, layer, x = _moe_layer(capacity_factor=1.0)
    y1, aux1 = jmoe.moe_ffn(jnp.asarray(x), jp, jcfg, jcfg.moe)
    for mesh in (cpu_mesh(2, 3), cpu_mesh(4, 1)):
        with torch.no_grad(), sharding_ctx(mesh):
            y2, aux2 = tmoe.moe_ffn(torch.from_numpy(x), layer, tcfg, tcfg.moe)
        np.testing.assert_allclose(y2.numpy(), np.asarray(y1), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(float(aux2), float(aux1), rtol=2e-4)


# -- the shardmap decode ------------------------------------------------------------------


def _decode_case(window: int, prefill: int, steps: int, dtype: str, monkeypatch):
    """The reference's one-hot decode and the port's shardmap decode on
    (data 2, model 2), from the same weights and prompt, teacher-forced on
    the same tokens. Returns [(ref logits, port logits, ref k, port k)]
    per step."""
    set_dtype(monkeypatch, dtype)
    jcfg = dataclasses.replace(jget_config("qwen3-1.7b").reduced(),
                               sliding_window=window)
    tcfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                               sliding_window=window, decode_cache_update="shardmap")
    params = ref_params(jcfg)
    japi, tapi = jget_api(jcfg), get_api(tcfg)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (2, prefill)).astype(np.int32)
    new = rng.integers(0, jcfg.vocab, (steps, 2, 1)).astype(np.int32)
    max_len = 20
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jcache, _ = jax.jit(lambda p, b: japi.prefill(p, b, jcfg, max_len))(
        jparams, {"tokens": jnp.asarray(toks)})
    jdec = jax.jit(lambda p, c, t: japi.decode(p, c, t, jcfg))
    model = convert.from_jax(params, tcfg, device="cpu")
    out = []
    with torch.no_grad():
        tcache, _ = tapi.prefill(model, {"tokens": torch.from_numpy(toks)}, tcfg,
                                 max_len)
        for t in range(steps):
            jcache, jl = jdec(jparams, jcache, jnp.asarray(new[t]))
            with sharding_ctx(cpu_mesh(2, 2)):
                tcache, tl = tapi.decode(model, tcache, torch.from_numpy(new[t]), tcfg)
            out.append((np.asarray(jl, np.float32), tl.float().numpy(),
                        np.asarray(jcache["k"], np.float32), tcache["k"].float().numpy()))
    return out


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_shardmap_decode_matches_reference_onehot(window, dtype, monkeypatch):
    """Prefill 8 of a 20-row cache (rank 0 owns rows 0-9, rank 1 10-19),
    then decode at pos 8, 9, 10 (the boundary: the first row of rank 1)
    and 11."""
    calls = []
    real = tattn._decode_attention_smap

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tattn, "_decode_attention_smap", spy)
    runs = _decode_case(window, prefill=8, steps=4, dtype=dtype,
                        monkeypatch=monkeypatch)
    assert len(calls) == 4 * get_config("qwen3-1.7b").reduced().n_layers
    for step, (jl, tl, jk, tk) in enumerate(runs):
        assert np.abs(jl - tl).max() < 8e-2, (step, np.abs(jl - tl).max())
        assert (jl[:, -1].argmax(-1) == tl[:, -1].argmax(-1)).all(), step
        np.testing.assert_allclose(tk, jk, atol=0.06, err_msg=f"step {step}")


def test_shardmap_decode_writes_only_the_owning_rank(monkeypatch):
    """Each step writes exactly one cache row per layer and batch row, at
    pos, on whichever rank owns it; the rest of the cache is untouched."""
    tcfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                               decode_cache_update="shardmap")
    model = get_api(tcfg).init(tcfg, torch.Generator().manual_seed(0))
    api = get_api(tcfg)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab, (4, 9)).astype(np.int32))
    with torch.no_grad():
        cache, _ = api.prefill(model, {"tokens": toks}, tcfg, 20)
        for pos in (9, 10):
            before = cache["k"].clone()
            with sharding_ctx(cpu_mesh(2, 2)):
                cache, _ = api.decode(model, cache, toks[:, :1], tcfg)
            changed = (cache["k"] != before).any(dim=(0, 3, 4))   # (B, S)
            assert changed[:, pos].all() and not changed[:, :pos].any() \
                and not changed[:, pos + 1:].any(), pos
            assert int(cache["pos"]) == pos + 1


# -- the data-parallel train step --------------------------------------------------------


def _captured(monkeypatch) -> dict:
    """Every gradient the step hands to ``adamw_update``, before the clip."""
    grads = {}
    real = tsteps.adamw_update

    def capture(model, *a, **kw):
        grads.clear()
        grads.update({n: p.grad.detach().clone()
                      for n, p in model.named_parameters()})
        return real(model, *a, **kw)

    monkeypatch.setattr(tsteps, "adamw_update", capture)
    return grads


def _port_step(tcfg, params, tokens, mesh, monkeypatch):
    model = convert.from_jax(params, tcfg, device="cpu")
    state = toptim.init_opt_state(model)
    grads = _captured(monkeypatch)
    step = tsteps.make_train_step(tcfg, toptim.OptimConfig(total_steps=10))
    batch = {"tokens": torch.from_numpy(tokens)}
    if mesh is None:
        _, _, m = step(model, state, batch)
    else:
        with sharding_ctx(mesh):
            _, _, m = step(model, state, batch)
    return {k: float(v) for k, v in m.items()}, dict(grads), model


def _rel_l2(got: dict, want: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(got[n] - want[n])
                     / torch.linalg.vector_norm(want[n]).clamp_min(1e-30))
            for n in want}


DP_GRAD_TOL = {"bfloat16": 2e-2, "float32": 1e-5}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dp_train_step_matches_reference_and_meshless(dtype, monkeypatch):
    """tests/test_distributed.py:134-143: the same batch (8 x 32) on one
    device and on a (data 4, model 2) mesh."""
    set_dtype(monkeypatch, dtype)
    jcfg, tcfg = jget_config("qwen3-1.7b").reduced(), get_config("qwen3-1.7b").reduced()
    params = ref_params(jcfg)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (8, 32)).astype(np.int32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    _, _, jm = jax.jit(jsteps.make_train_step(jcfg, joptim.OptimConfig(total_steps=10)))(
        jparams, joptim.init_opt_state(jparams), {"tokens": jnp.asarray(tokens)})
    m1, g1, _ = _port_step(tcfg, params, tokens, None, monkeypatch)
    m2, g2, _ = _port_step(tcfg, params, tokens, cpu_mesh(4, 2), monkeypatch)
    assert abs(m2["loss"] - float(jm["loss"])) < 5e-3, (m2["loss"], float(jm["loss"]))
    assert abs(m1["loss"] - m2["loss"]) < 5e-3
    rel = _rel_l2(g2, g1)
    worst = max(rel, key=rel.get)
    assert rel[worst] < DP_GRAD_TOL[dtype], (worst, rel[worst])
    assert abs(m2["grad_norm"] - m1["grad_norm"]) / m1["grad_norm"] < DP_GRAD_TOL[dtype]
    assert m2["lr"] == m1["lr"]


def test_dp_train_step_runs_each_shard_on_its_block(monkeypatch):
    """Four losses of 2 rows each, one per data shard, and a merge of four
    gradient trees weighted 1/4; a planted merge that drops a shard or
    sums where it should average moves the gradients past the tolerance."""
    set_dtype(monkeypatch, "float32")
    jcfg, tcfg = jget_config("qwen3-1.7b").reduced(), get_config("qwen3-1.7b").reduced()
    params = ref_params(jcfg)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (8, 32)).astype(np.int32)
    _, g1, _ = _port_step(tcfg, params, tokens, None, monkeypatch)
    seen = []
    real_merge = tsteps.merge_grads

    def merge(parts, weights):
        seen.append((len(parts), list(weights)))
        return real_merge(parts, weights)

    monkeypatch.setattr(tsteps, "merge_grads", merge)
    _, g2, _ = _port_step(tcfg, params, tokens, cpu_mesh(4, 2), monkeypatch)
    assert seen == [(4, [0.25] * 4)]
    assert max(_rel_l2(g2, g1).values()) < DP_GRAD_TOL["float32"]
    for fault in (lambda p, w: real_merge(p[:1] + p[2:], w[:1] + w[2:]),
                  lambda p, w: real_merge(p, [1.0] * len(p))):
        monkeypatch.setattr(tsteps, "merge_grads", fault)
        _, gf, _ = _port_step(tcfg, params, tokens, cpu_mesh(4, 2), monkeypatch)
        assert max(_rel_l2(gf, g1).values()) > 0.1


def test_dp_step_with_an_indivisible_batch_is_the_meshless_step(monkeypatch):
    """6 rows over 4 data shards: the batch stays whole (sanitize_pspec's
    rule), so the step is the meshless one."""
    set_dtype(monkeypatch, "float32")
    jcfg, tcfg = jget_config("qwen3-1.7b").reduced(), get_config("qwen3-1.7b").reduced()
    params = ref_params(jcfg)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (6, 16)).astype(np.int32)
    m1, g1, _ = _port_step(tcfg, params, tokens, None, monkeypatch)
    m2, g2, _ = _port_step(tcfg, params, tokens, cpu_mesh(4, 2), monkeypatch)
    assert m1 == m2
    assert all(torch.equal(g1[n], g2[n]) for n in g1)


def _dropping(arch: str):
    """The reduced config at capacity factor 1.0 (the reduced one is
    dropless at 8.0): tokens are dropped at capacity."""
    out = []
    for c in (jget_config(arch).reduced(), get_config(arch).reduced()):
        out.append(dataclasses.replace(
            c, moe=dataclasses.replace(c.moe, capacity_factor=1.0)))
    return out


def test_dp_moe_step_without_ep_equals_meshless(monkeypatch):
    """deepseek-moe-16b (reduced, capacity 1.0) on (data 4, model 1): no expert
    parallelism, so the reference's GSPMD layer runs over the whole batch
    with one capacity and drops; the step's first pass gathers each
    block's expert counts (the later blocks' ranks start after the
    earlier ones') and routing fractions (the aux loss): loss, aux and
    every gradient equal the meshless step's (float32, 1e-5)."""
    set_dtype(monkeypatch, "float32")
    jcfg, tcfg = _dropping("deepseek-moe-16b")
    params = ref_params(jcfg)
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab, (8, 16)).astype(np.int32)
    routed = []
    real_route = tmoe._route

    def route(*a, **kw):
        out = real_route(*a, **kw)
        routed.append(out[2])
        return out

    monkeypatch.setattr(tmoe, "_route", route)
    m1, g1, _ = _port_step(tcfg, params, tokens, None, monkeypatch)
    # the case drops tokens: the global capacity is what makes it equal
    cap = tmoe._capacity(8 * 16, tcfg.moe)
    assert any(int(torch.bincount(i.reshape(-1)).max()) > cap for i in routed)
    m2, g2, _ = _port_step(tcfg, params, tokens, cpu_mesh(4, 1), monkeypatch)
    for k in ("loss", "ce", "aux", "grad_norm"):
        assert abs(m2[k] - m1[k]) <= 1e-5 * abs(m1[k]), (k, m1[k], m2[k])
    rel = _rel_l2(g2, g1)
    assert max(rel.values()) < 1e-5, max(rel, key=rel.get)


def test_dp_moe_step_with_ep_equals_the_whole_batch_under_the_mesh(monkeypatch):
    """deepseek-moe-16b (reduced, capacity 1.0) on (data 2, model 2): expert-parallel,
    each block's ranks with their block's capacity. The data-parallel step
    equals the loss and gradients of the whole batch run through the layers
    under the same mesh (the reference's shard_map semantics), float32,
    1e-5."""
    set_dtype(monkeypatch, "float32")
    jcfg, tcfg = _dropping("deepseek-moe-16b")
    params = ref_params(jcfg)
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab, (4, 16)).astype(np.int32)
    mesh = cpu_mesh(2, 2)
    m2, g2, _ = _port_step(tcfg, params, tokens, mesh, monkeypatch)
    model = convert.from_jax(params, tcfg, device="cpu")
    with sharding_ctx(mesh):
        loss, met = get_api(tcfg).loss(model, {"tokens": torch.from_numpy(tokens)}, tcfg)
        loss.backward()
    g1 = {n: p.grad for n, p in model.named_parameters()}
    loss, aux = float(loss.detach()), float(met["aux"].detach())
    assert abs(m2["loss"] - loss) <= 1e-5 * abs(loss)
    assert abs(m2["aux"] - aux) <= 1e-5 * abs(aux)
    rel = _rel_l2(g2, g1)
    assert max(rel.values()) < 1e-5, max(rel, key=rel.get)


# -- the elastic restore ---------------------------------------------------------------------


def test_restore_with_shardings_of_a_reference_checkpoint(tmp_path):
    """tests/test_distributed.py's elastic restore: a checkpoint the
    reference wrote restores onto a mesh, whatever layout saved it."""
    w = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    cm = jckpt.CheckpointManager(tmp_path, async_save=False)
    cm.save(1, {"w": jnp.asarray(w), "opt": {"m": jnp.ones(3), "step": jnp.int32(4)}})
    mesh = cpu_mesh(8, 1)
    like = {"w": torch.empty(8, 8, device="meta"),
            "opt": {"m": torch.empty(3, device="meta"),
                    "step": torch.empty((), dtype=torch.int32, device="meta")}}
    port = CheckpointManager(tmp_path)
    for shardings in ({"w": NamedSharding(mesh, P("data", None)), "opt": None},
                      NamedSharding(mesh, P()),
                      {"w": NamedSharding(mesh, P("data", "model")),
                       "opt": {"m": NamedSharding(mesh, P("model")), "step": None}}):
        step, t = port.restore(None, like, device="cpu", shardings=shardings)
        assert step == 1
        np.testing.assert_array_equal(t["w"].numpy(), w)
        assert t["w"].device == mesh.device and int(t["opt"]["step"]) == 4
    # a spec the mesh does not divide still lands whole; one too long raises
    port.restore(None, like, device="cpu",
                 shardings={"w": NamedSharding(cpu_mesh(3, 1), P("data", "data")),
                            "opt": None})
    with pytest.raises(ValueError, match="longer"):
        port.restore(None, like, device="cpu",
                     shardings={"w": NamedSharding(mesh, P(None, None, "data")),
                                "opt": None})


# -- the launchers ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-moe-16b"])
def test_serve_with_local_devices(arch, capsys, monkeypatch):
    ranks = []
    real = tmoe._dispatch
    monkeypatch.setattr(tmoe, "_dispatch",
                        lambda *a, **kw: ranks.append(kw["rank"]) or real(*a, **kw))
    assert tserve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch",
                        "4", "--prompt", "8", "--new-tokens", "3",
                        "--local-devices", "4"]) == 0
    out = capsys.readouterr().out
    assert "mesh: {'data': 2, 'model': 2}" in out and "decode 2 steps" in out
    if arch == "deepseek-moe-16b":
        assert set(ranks) == {0, 1}   # expert-parallel over the model ranks


def test_train_with_local_devices_and_resume(tmp_path, capsys, monkeypatch):
    seen = []
    real_merge = tsteps.merge_grads
    monkeypatch.setattr(tsteps, "merge_grads",
                        lambda p, w: seen.append(len(p)) or real_merge(p, w))
    argv = ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
            "--global-batch", "4", "--seq", "16", "--ckpt-every", "1",
            "--ckpt-dir", str(tmp_path), "--local-devices", "4"]
    assert ttrain.main(argv + ["--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "mesh: {'data': 2, 'model': 2} (4 shards)" in out
    assert seen == [2, 2]   # two data shards a step
    assert ttrain.main(argv + ["--steps", "3", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed at step 2" in out and seen == [2, 2, 2]


@pytest.mark.parametrize("argv", [["--multi-pod"], ["--local-devices", "512"]])
def test_pod_mesh_waits_for_a11(tmp_path, argv, capsys, monkeypatch):
    """The pod meshes have landed (A11): ``launcher_mesh`` builds (16, 16)
    from 512 devices and (2, 16, 16) under ``multi_pod``, as the
    reference's launchers do, and both launchers run on them: the train
    step data-parallel over the 16 or 32 data shards, the serve path
    whole on the pod mesh."""
    assert launcher_mesh(512, "cpu").shape == {"data": 16, "model": 16}
    assert launcher_mesh(0, "cpu", multi_pod=True).shape == \
        {"pod": 2, "data": 16, "model": 16}
    multi = argv == ["--multi-pod"]
    shards = 32 if multi else 16
    seen = []
    real_merge = tsteps.merge_grads
    monkeypatch.setattr(tsteps, "merge_grads",
                        lambda p, w: seen.append(len(p)) or real_merge(p, w))
    assert ttrain.main(["--device", "cpu", "--ckpt-dir", str(tmp_path),
                        "--reduced", "--steps", "1", "--seq", "8",
                        "--global-batch", str(shards)] + argv) == 0
    assert seen == [shards]
    assert f"({16 * shards} shards)" in capsys.readouterr().out
    if not multi:
        assert tserve.main(["--device", "cpu", "--reduced", "--batch", "16",
                            "--prompt", "8", "--new-tokens", "2"] + argv) == 0
        assert "mesh: {'data': 16, 'model': 16}" in capsys.readouterr().out
