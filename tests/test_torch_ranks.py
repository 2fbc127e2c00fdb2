"""The model mesh across ``torch.distributed`` ranks (``launch/mesh.py``
``init_rank_mesh``, ``sharding.place_params``) on gloo ranks on the CPU,
against the JAX reference and the port's one-process mesh.

The reference's four mesh tests (tests/test_distributed.py: the DP train
step, EP MoE, the shardmap decode, ``compressed_psum``) cannot build their
jax meshes in the installed jax; each is replayed here on real ranks, held
to its own bound against the reference's meshless path, which runs in this
process on one CPU device:

* DP train step, data 4 x model 2 (8 ranks), qwen3-1.7b reduced: the loss
  within 5e-3 of the reference's meshless loss; loss, grad norm and every
  rank's gradient blocks against the port's one-process (4, 2) step within
  TRAIN_TOL (bf16: the limits ``chip_smoke.py`` phase 11 holds a flash step
  to, as row- and vocab-parallel partials round to bf16 before their sum
  and GEMMs run at other shapes; float32 compute: 1e-5, the same
  arithmetic in another order);
* EP MoE, data 2 x model 4: ``rtol = atol = 2e-4``;
* the shardmap decode, data 2 x model 2: max |logit diff| < 8e-2, equal
  argmax, cache k within 0.06;
* ``compressed_psum``, data 8 x model 1: within 0.02 of the mean, and bit
  for bit the one-process mesh's (integer sums do not depend on order).

Beside them: each rank's blocks equal the rule table's numpy slices and
its parameter bytes fall to (sharded) / 8 + (replicated); the global-norm
clip on 8 ranks equals the meshless clip; the seam's collectives against
their list forms; the elastic checkpoint restore (and ``constrain`` on a
DTensor). tests/test_torch_ranks_paths.py holds the other paths and the
launchers under ``torchrun``.

Each test spawns its ranks through ``rank_workers.run_ranks`` (a
FileStore rendezvous, a join timeout of its own) and finishes in well under a
minute.
"""
import dataclasses
import functools
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rank_workers import run_ranks
from repro.configs import get_config as jget_config
from repro.launch.mesh import MeshAxes as JMeshAxes
from repro.models import moe as jmoe
from repro.models import optim as joptim
from repro.models import sharding as jsharding
from repro.models import steps as jsteps
from repro.models.registry import get_api as jget_api
from repro.runtime import checkpoint as jckpt
from repro.runtime import compress as JC
from repro_torch.configs import get_config
from repro_torch.engine import distributed as D
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import convert
from repro_torch.models import optim as toptim
from repro_torch.models import steps as tsteps
from repro_torch.models.sharding import sharding_ctx
from repro_torch.runtime import compress as TC
from test_torch_families import ref_params, set_dtype
from test_torch_mesh_models import _moe_cfgs, _shard

ROOT = pathlib.Path(__file__).resolve().parents[1]
# join timeouts (s): a rank's start (spawn, torch and the port imported)
# takes 3-8 s on a loaded host, the bodies under 2 s; eight ranks start on
# eight cores beside the suite's other workers
SPAWN_TIMEOUT = {4: 60, 8: 90}
TRAIN_TOL = {"bfloat16": {"loss": 1e-3, "grad_norm": 1e-2, "grads": 0.1},
             "float32": {"loss": 1e-5, "grad_norm": 1e-5, "grads": 1e-5}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def _block(full: np.ndarray, spec, shape: dict, coords: dict) -> np.ndarray:
    """The numpy slice of ``full`` that ``spec`` gives the rank at
    ``coords`` (row-major over a tuple entry's axes)."""
    idx = []
    for d, entry in enumerate(spec):
        if entry is None:
            idx.append(slice(None))
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        i, ext = 0, 1
        for nm in names:
            i, ext = i * shape[nm] + coords[nm], ext * shape[nm]
        n = full.shape[d] // ext
        idx.append(slice(i * n, (i + 1) * n))
    return full[tuple(idx)]


def _leaf(tree: dict, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _table_specs(arch: str, params: dict, shape: dict) -> dict:
    """``{port parameter name: its spec}``: the reference's rule table
    (``repro.models.sharding.param_specs``) over its own pytree,
    sanitized by its own rule at the mesh extents ``shape``."""
    specs = jsharding.param_specs(params, JMeshAxes())
    mesh = types.SimpleNamespace(shape=shape)
    model = convert.from_jax(params, get_config(arch).reduced(), device="cpu")
    out = {}
    for name, path in convert.reference_paths(model).items():
        full, spec = _leaf(params, path), _leaf(specs, path)
        spec = tuple(jsharding.sanitize_pspec(spec, full.shape, mesh))
        out[name] = spec + (None,) * (full.ndim - len(spec))
    return out


def _table_split(arch: str, params: dict, shape: dict) -> set:
    """The parameters the rule table splits over model at ``shape``."""
    return {n for n, spec in _table_specs(arch, params, shape).items()
            if "model" in spec}


def _table_blocks(arch: str, params: dict, shape: dict, coords: dict) -> dict:
    """Every port parameter's expected block at ``coords``: the
    reference's rule table (``repro.models.sharding.param_specs``) over
    its own pytree, sanitized by its own rule, sliced in numpy; layer i
    of a stacked leaf at index i."""
    model = convert.from_jax(params, get_config(arch).reduced(), device="cpu")
    paths = convert.reference_paths(model)
    out = {}
    for name, spec in _table_specs(arch, params, shape).items():
        blk = _block(_leaf(params, paths[name]), spec, shape, coords)
        if name.split(".", 1)[0] in convert.STACKED:
            blk = blk[int(name.split(".")[1])]
        out[name] = blk
    return out


# -- the seam ------------------------------------------------------------------------


def test_seam_collectives_match_list_forms():
    """On data 2 x model 2, each collective of ``engine/distributed.py`` on
    a rank's part over each axis equals its list form on the same
    partials (float and int32), and each books the list form's kind, part
    count and bytes with the cost counters."""
    rng = np.random.default_rng(3)
    payload = {"float32": rng.normal(size=(4, 4, 6)).astype(np.float32),
               "int32": rng.integers(-50, 50, (4, 4, 6)).astype(np.int32)}
    res = run_ranks("seam", 4, payload, SPAWN_TIMEOUT[4])
    for r, out in enumerate(res):
        for axis in ("data", "model"):
            # the ranks of r's group, in group order (rank = 2 d + m)
            d, m = out["coords"]["data"], out["coords"]["model"]
            group = [2 * i + m for i in range(2)] if axis == "data" \
                else [2 * d + i for i in range(2)]
            assert out[(axis, "index")] == group.index(r)
            for dt in ("float32", "int32"):
                parts = [torch.from_numpy(payload[dt][g]) for g in group]
                want = {"psum": D.psum(parts), "pmax": D.pmax(parts),
                        "pmin": D.pmin(parts), "all_gather": D.all_gather(parts),
                        "all_gather1": D.all_gather(parts, dim=1),
                        "all_to_all": D.all_to_all([p[:2] for p in parts])[
                            group.index(r)],
                        "reduce_scatter": D.psum([p[:4] for p in parts]).chunk(2)[
                            group.index(r)]}
                for op, w in want.items():
                    got = out[(axis, dt, op)]
                    assert got.dtype == w.dtype, (axis, dt, op)
                    # two parts: a float sum is one rounding in either order
                    assert torch.equal(got, w), (axis, dt, op)
            parts = [torch.from_numpy(payload["float32"][g]) for g in group]
            assert torch.equal(out[(axis, "float32", "pmean")], D.pmean(parts))
        whole = D.psum([torch.from_numpy(p) for p in payload["float32"]])
        torch.testing.assert_close(out[("all", "psum")], whole, rtol=1e-6,
                                   atol=1e-6)
        kinds = {k for k, _, _, _ in out["booked"]}
        assert kinds == {"all-reduce", "all-gather", "all-to-all",
                         "reduce-scatter"}
        assert all(p in (2, 4) for _, p, _, _ in out["booked"])
        assert ("all-reduce", 2, 4 * 6 * 4, 4 * 6 * 4) in out["booked"]


# -- placement ----------------------------------------------------------------------------


# the families placed by the whole table since tensor parallelism over
# model reached them: one spawn places all four on data 2 x model 2
TP_FAMILIES = ("rwkv6-1.6b", "zamba2-1.2b", "whisper-base", "llava-next-mistral-7b")


@functools.cache
def _tp_placements() -> dict:
    families = [(get_config(a).reduced(), ref_params(jget_config(a).reduced()))
                for a in TP_FAMILIES]
    res = run_ranks("placements", 4, (families, (2, 2)), SPAWN_TIMEOUT[4])
    return {a: [out[cfg.name] for out in res]
            for a, (cfg, _) in zip(TP_FAMILIES, families)}


@pytest.mark.parametrize("arch,data,model", [("qwen3-1.7b", 4, 2),
                                             ("deepseek-moe-16b", 2, 4)]
                         + [(a, 2, 2) for a in TP_FAMILIES])
def test_placed_blocks_equal_rule_table_slices(arch, data, model):
    """``convert.from_jax`` of the reference's weights, then
    ``place_params``: every rank's block of every parameter equals, bit
    for bit, the numpy slice the reference's rule table assigns it
    (experts over model on the MoE; rwkv's time mix, the hybrid's
    ``ssm/w_in`` in its contiguous column blocks and ``ssm/w_out``,
    whisper's and llava's attention and MLPs over model), and no rank
    holds a whole copy of a weight the table splits where the extents
    divide."""
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    params = ref_params(jcfg)
    if arch in TP_FAMILIES:
        res = _tp_placements()[arch]
    else:
        res = run_ranks("placement", data * model, (tcfg, params, (data, model)),
                        SPAWN_TIMEOUT[data * model])
    shape = {"data": data, "model": model}
    for out in res:
        want = _table_blocks(arch, params, shape, out["coords"])
        assert set(out["local"]) == set(want)
        for n, w in want.items():
            got = out["local"][n]
            assert tuple(got.shape) == w.shape, n
            assert torch.equal(got, torch.from_numpy(np.ascontiguousarray(w))), n
            pl = out["placements"][n]
            if any(e is not None for e in pl.spec):
                assert got.numel() < np.prod(pl.shape), n
    if arch == "deepseek-moe-16b":
        E = tcfg.moe.num_experts
        for out in res:
            assert out["local"]["layers.0.moe.experts.w1"].shape[0] == E // model


def test_rank_parameter_bytes_fall_to_an_eighth():
    """qwen3-1.7b (reduced) on data 4 x model 2: each rank holds at most
    (the bytes of the weights the table splits) / 8 + (the bytes of the
    whole ones): every split weight of the dense family is split over
    both."""
    jcfg, tcfg = jget_config("qwen3-1.7b").reduced(), get_config("qwen3-1.7b").reduced()
    params = ref_params(jcfg)
    res = run_ranks("placement", 8, (tcfg, params, (4, 2)), SPAWN_TIMEOUT[8])
    pls = res[0]["placements"]
    split = sum(4 * np.prod(pl.shape) for pl in pls.values()
                if any(e is not None for e in pl.spec))
    whole = sum(4 * np.prod(pl.shape) for pl in pls.values()
                if all(e is None for e in pl.spec))
    assert whole < split / 50
    for out in res:
        assert out["bytes"] <= split / 8 + whole, (out["bytes"], split, whole)


# -- the DP train step (tests/test_distributed.py:115) -------------------------------------


def _one_process_step(tcfg, params, tokens, monkeypatch, mesh):
    model = convert.from_jax(params, tcfg, device="cpu")
    state = toptim.init_opt_state(model)
    grads = {}
    real = tsteps.adamw_update

    def capture(m, *a, **kw):
        grads.update({n: p.grad.detach().clone() for n, p in m.named_parameters()})
        return real(m, *a, **kw)

    monkeypatch.setattr(tsteps, "adamw_update", capture)
    step = tsteps.make_train_step(tcfg, toptim.OptimConfig(total_steps=10))
    with sharding_ctx(mesh):
        _, _, m = step(model, state, {"tokens": torch.from_numpy(tokens)})
    monkeypatch.setattr(tsteps, "adamw_update", real)
    return ({k: float(v) for k, v in m.items()}, grads,
            {n: p.detach().clone() for n, p in model.named_parameters()})


def _hold_step(res, mesh_shape, m1, g1, w1, tol):
    from repro_torch.models.sharding import local_slice

    worst = 0.0
    for out in res:
        m2 = out["metrics"]
        assert abs(m2["loss"] - m1["loss"]) / abs(m1["loss"]) < tol["loss"]
        assert abs(m2["grad_norm"] - m1["grad_norm"]) / m1["grad_norm"] \
            < tol["grad_norm"]
        assert m2["lr"] == m1["lr"]
        mesh = types.SimpleNamespace(
            extent=lambda e: np.prod([mesh_shape[n] for n in
                                      (e if isinstance(e, tuple) else (e,))]),
            index=lambda e, c=out["coords"]: _index(e, c, mesh_shape))
        for n, g in out["grads"].items():
            spec = out["placements"][n].spec
            worst = max(worst, _rel(g, local_slice(g1[n], spec, mesh)))
            # the update ran on the blocks: AdamW's first step moves an
            # element by about lr (3e-6 in warmup), whatever its gradient
            assert torch.allclose(out["params"][n],
                                  local_slice(w1[n], spec, mesh), atol=1e-5), n
    return worst


def _index(entry, coords, shape):
    i = 0
    for nm in entry if isinstance(entry, tuple) else (entry,):
        i = i * shape[nm] + coords[nm]
    return i


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dp_train_step_on_ranks(dtype, monkeypatch):
    """tests/test_distributed.py:115-143 on data 4 x model 2 (8 ranks): the
    same 8 x 32 batch; each data rank its 2 rows, the weights placed (FSDP
    over data, TP over model). The loss within 5e-3 of the reference's
    meshless loss; loss, grad norm and every gradient block within
    TRAIN_TOL of the port's one-process (4, 2) step."""
    set_dtype(monkeypatch, dtype)
    jcfg, tcfg = jget_config("qwen3-1.7b").reduced(), get_config("qwen3-1.7b").reduced()
    params = ref_params(jcfg)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (8, 32)).astype(np.int32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    _, _, jm = jax.jit(jsteps.make_train_step(jcfg, joptim.OptimConfig(total_steps=10)))(
        jparams, joptim.init_opt_state(jparams), {"tokens": jnp.asarray(tokens)})
    m1, g1, w1 = _one_process_step(tcfg, params, tokens, monkeypatch,
                                   make_local_mesh(4, 2, device="cpu"))
    res = run_ranks("train_step", 8, (tcfg, params, tokens, (4, 2),
                                      dtype == "float32"), SPAWN_TIMEOUT[8])
    for out in res:
        out["coords"] = {"data": res.index(out) // 2, "model": res.index(out) % 2}
        assert abs(out["metrics"]["loss"] - float(jm["loss"])) < 5e-3
    worst = _hold_step(res, {"data": 4, "model": 2}, m1, g1, w1, TRAIN_TOL[dtype])
    assert worst < TRAIN_TOL[dtype]["grads"], worst


def test_global_norm_clip_on_ranks():
    """Whole random gradients (norm well above ``clip_norm``) for every
    parameter of the placed qwen3-1.7b (reduced) on data 4 x model 2: each
    rank clips its blocks by the norm over every rank (a split block and a
    whole tensor counted once each), which equals the meshless clip's
    norm and scale."""
    jcfg, tcfg = jget_config("qwen3-1.7b").reduced(), get_config("qwen3-1.7b").reduced()
    params = ref_params(jcfg)
    model = convert.from_jax(params, tcfg, device="cpu")
    rng = np.random.default_rng(5)
    grads = {n: rng.normal(size=p.shape).astype(np.float32)
             for n, p in model.named_parameters()}
    whole = [torch.from_numpy(g.copy()) for g in grads.values()]
    norm = float(toptim.clip_by_global_norm(whole, 1.0))
    assert norm > 100.0
    clipped = dict(zip(grads, whole))
    res = run_ranks("clip", 8, (tcfg, params, grads, 1.0), SPAWN_TIMEOUT[8])
    for r, out in enumerate(res):
        assert abs(out["norm"] - norm) / norm < 1e-6, (out["norm"], norm)
        coords = {"data": r // 2, "model": r % 2}
        for n, g in out["clipped"].items():
            want = _block(clipped[n].numpy(), out["spec"][n],
                          {"data": 4, "model": 2}, coords)
            np.testing.assert_allclose(g.numpy(), want, rtol=1e-5, atol=1e-9)


# -- EP MoE (tests/test_distributed.py:148) ------------------------------------------------


def test_moe_ep_on_ranks():
    """tests/test_distributed.py:148-169 on data 2 x model 4 (8 ranks): each
    rank stores 2 of the 8 experts and runs its data rank's rows; y within
    rtol = atol = 2e-4 of the reference's meshless ``moe_ffn``, the aux
    loss the reference's (global batch)."""
    jcfg, tcfg = _moe_cfgs()
    jp = jmoe.init_moe(jax.random.key(0), jcfg, jcfg.moe)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    x = np.array(jax.random.normal(jax.random.key(1), (4, 8, 32), jnp.float32))
    y1, aux1 = jmoe.moe_ffn(jnp.asarray(x), jp, jcfg, jcfg.moe)
    res = run_ranks("moe_layer", 8, (tcfg, tree, x), SPAWN_TIMEOUT[8])
    y1 = np.asarray(y1)
    for out in res:
        d = out["coords"]["data"]
        assert out["experts"] == (2, 16, 16)   # E / 4 experts, d / 2 (FSDP)
        np.testing.assert_allclose(out["y"].numpy(), y1[2 * d:2 * d + 2],
                                   rtol=2e-4, atol=2e-4)
        assert abs(out["aux"] - float(aux1)) < 1e-5


# -- the shardmap decode (tests/test_distributed.py:195) -----------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_shardmap_decode_on_ranks(dtype, monkeypatch):
    """tests/test_distributed.py:195-219 on data 2 x model 2: the
    reference's meshless prefill (16 tokens into a 20-deep cache) and its
    one-hot decode of one token; on the ranks, each holds its batch rows
    and its 10 sequence rows of every head and decodes the token with
    ``decode_cache_update="shardmap"``: logits within 8e-2, cache k within
    0.06 (the reference test's bounds), ``pos`` 17, and equal argmax: on
    every row in float32 compute, and in bf16 on every row whose
    reference top-2 margin exceeds the 8e-2 logit bound (here one row's
    top two sit one bf16 ulp apart, 2.671875 / 2.6875, a tie the bf16
    partial sums of TP may break either way). A prefill on the rank mesh
    lays its cache out the same way (within the same bounds of the
    reference's)."""
    set_dtype(monkeypatch, dtype)
    jcfg, tcfg = jget_config("qwen3-1.7b").reduced(), get_config("qwen3-1.7b").reduced()
    params = ref_params(jcfg)
    api = jget_api(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    cache, first = api.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg, 20)
    new = np.ones((2, 1), np.int32)
    c1, l1 = api.decode(jparams, cache, jnp.asarray(new), jcfg)
    smap = dataclasses.replace(tcfg, decode_cache_update="shardmap")
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    res = run_ranks("smap_decode", 4, (smap, params, f32(cache["k"]),
                                       f32(cache["v"]), int(cache["pos"]), new,
                                       toks, 20, dtype == "float32"),
                    SPAWN_TIMEOUT[4])
    l1, first, ck1, ck0 = f32(l1), f32(first), f32(c1["k"]), f32(cache["k"])
    top2 = np.sort(l1[:, -1], axis=-1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0] > 8e-2) | (dtype == "float32")
    assert sure.any()
    for out in res:
        b, s = slice(*out["rows"]), slice(*out["seq"])
        lg = out["logits"].numpy()
        assert np.abs(lg - l1[b]).max() < 8e-2
        same = lg[:, -1].argmax(-1) == l1[b, -1].argmax(-1)
        assert same[sure[b]].all()
        np.testing.assert_allclose(out["k"].numpy(), ck1[:, b, s], atol=0.06)
        assert out["pos"] == 17
        np.testing.assert_allclose(out["prefill_k"].numpy(), ck0[:, b, s],
                                   atol=0.06)
        assert np.abs(out["prefill_logits"].numpy() - first[b]).max() < 8e-2


# -- compressed_psum (tests/test_distributed.py:223) ----------------------------------------


def test_compressed_psum_on_ranks():
    """tests/test_distributed.py:223-247 on data 8 x model 1: each rank
    its row of the (8, 128) gradients (and the port test's tiny, zero and
    tied leaves); the mean within 0.02 of the exact one, and every rank's
    mean and new error bit for bit the one-process mesh's and the
    reference's (under ``jax.vmap``)."""
    g = {"w": np.random.default_rng(0).normal(size=(8, 128)).astype(np.float32),
         "layers": {"b": (np.random.default_rng(1).normal(size=(8, 31)) * 1e-3)
                    .astype(np.float32)},
         "ties": np.tile(np.array([127.0, 2.5, 3.5, -0.5, -1.5, 0.5, 126.5,
                                   -126.5], np.float32), (8, 1))}
    flat = {"w": g["w"], "b": g["layers"]["b"], "ties": g["ties"]}
    res = run_ranks("compressed", 8, flat, SPAWN_TIMEOUT[8])
    shards = [_shard(flat, i) for i in range(8)]
    mean1, err1 = TC.compressed_psum(shards, [TC.init_error_state(t) for t in shards])
    jf = lambda x: JC.compressed_psum(x, JC.init_error_state(x), "data")  # noqa: E731
    jmean, jerr = jax.vmap(jf, axis_name="data")(
        jax.tree_util.tree_map(jnp.asarray, flat))
    want = g["w"].mean(axis=0)
    for r, out in enumerate(res):
        assert np.abs(out["mean"]["w"].numpy() - want).max() < 0.02
        for k in flat:
            bits = out["mean"][k].numpy().view(np.uint32)
            assert (bits == mean1[k].numpy().view(np.uint32)).all(), k
            assert (bits == np.asarray(jmean[k])[r].view(np.uint32)).all(), k
            assert torch.equal(out["err"][k], err1[r][k]), k
            assert (out["err"][k].numpy().view(np.uint32)
                    == np.asarray(jerr[k])[r].view(np.uint32)).all(), k


# -- elastic restore (tests/test_distributed.py:172) ----------------------------------------


def test_elastic_checkpoint_restore_on_ranks(tmp_path):
    """An (8, 8) weight saved from data 4 x model 1 (each rank's (2, 8)
    block, a DTensor), restored onto data 2 x model 2 of the same 4 ranks
    with P("data", None): each rank keeps its (4, 8) block, a DTensor over
    the (2, 2) mesh, and the whole tensor is the saved one. Rank 0 wrote
    the full tensor: the step's files are the reference's, byte for
    byte."""
    res = run_ranks("elastic", 4, str(tmp_path / "ranks"), SPAWN_TIMEOUT[4])
    full = np.arange(64.0).reshape(8, 8)
    for out in res:
        assert out["step"] == 1 and out["mesh"] == (2, 2)
        assert out["names"] == ("data", "model")
        d = out["coords"]["data"]
        np.testing.assert_array_equal(out["local"].numpy(), full[4 * d:4 * d + 4])
        np.testing.assert_array_equal(out["whole"].numpy(), full)
        assert "Shard(dim=0)" in out["placements"]
        m = out["coords"]["model"]   # constrain(w, None, "model"): columns
        np.testing.assert_array_equal(out["moved"].numpy(), full[:, 4 * m:4 * m + 4])
        assert out["moved_placements"] == "(Replicate(), Shard(dim=1))"
    jckpt.CheckpointManager(tmp_path / "ref", async_save=False).save(
        1, {"w": jnp.arange(64.0).reshape(8, 8)})
    for f in ("leaf_0.npy", "meta.json"):
        assert (tmp_path / "ranks" / "step_1" / f).read_bytes() == \
            (tmp_path / "ref" / "step_1" / f).read_bytes(), f
