"""The model mesh across ``torch.distributed`` ranks, beyond the
reference's four replays (tests/test_torch_ranks.py): the train step
where the model extent does not divide the heads, the MoE step with and
without expert parallelism, tensor parallelism over model for rwkv, the
hybrid, whisper and vlm (train steps, prefill and decode, the SSD mixer
with planted faults, an elastic checkpoint; one spawn for all of it), the
multi-pod rank layout, and both launchers under ``torchrun``. Each rank
test holds the ranks to the port's one-process mesh (float32 compute:
1e-5) through ``rank_workers.run_ranks`` (a FileStore rendezvous, a
join timeout of its own), the serving test also to the JAX package's
meshless paths; the launchers to a single-process run."""
import dataclasses
import json
import os
import sys
import subprocess
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rank_workers import run_ranks
from repro.configs import get_config as jget_config
from repro.models.registry import get_api as jget_api
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import convert
from repro_torch.models import optim as toptim
from repro_torch.models import steps as tsteps
from repro_torch.models.registry import get_api
from repro_torch.models.sharding import sharding_ctx
from test_torch_families import _tol, close, ref_params, set_dtype
from test_torch_ranks import (ROOT, SPAWN_TIMEOUT, TRAIN_TOL, _hold_step,
                              _index, _one_process_step, _rel, _table_split)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_step_with_heads_the_model_extent_does_not_divide(monkeypatch):
    """qwen3-1.7b (reduced: 4 heads, 2 KV heads) on data 2 x model 4: the
    KV heads do not split over 4 ranks, so the attention weights stay
    whole over model (as ``sanitize_pspec`` keeps an extent it does not
    divide) while the MLP and the vocab split; in float32 compute the
    step equals the one-process (2, 4) step to 1e-5."""
    set_dtype(monkeypatch, "float32")
    jcfg, tcfg = jget_config("qwen3-1.7b").reduced(), get_config("qwen3-1.7b").reduced()
    params = ref_params(jcfg)
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab, (4, 16)).astype(np.int32)
    m1, g1, w1 = _one_process_step(tcfg, params, tokens, monkeypatch,
                                   make_local_mesh(2, 4, device="cpu"))
    res = run_ranks("train_step", 8, (tcfg, params, tokens, (2, 4), True),
                    SPAWN_TIMEOUT[8])
    for r, out in enumerate(res):
        out["coords"] = {"data": r // 4, "model": r % 4}
        pls = out["placements"]
        assert pls["layers.0.attn.wq"].model_dim is None
        assert pls["layers.0.attn.wq"].data_dim == 0
        assert pls["layers.0.mlp.w1"].model_dim == 1
        assert pls["lm_head"].model_dim == 1
    worst = _hold_step(res, {"data": 2, "model": 4}, m1, g1, w1,
                       TRAIN_TOL["float32"])
    assert worst < TRAIN_TOL["float32"]["grads"], worst


@pytest.mark.parametrize("data,model", [(2, 2), (4, 1)])
def test_moe_train_step_on_ranks(data, model, monkeypatch):
    """deepseek-moe-16b (reduced, capacity 1.0: tokens drop) in float32:
    on (2, 2) expert-parallel (2 experts a rank, each rank's capacity from
    its own tokens), on (4, 1) the GSPMD layer (the global batch's
    capacity, each rank's ranks within an expert after the earlier
    ranks' tokens, gathered in the one forward); both against the
    one-process mesh's step (whose first pass gathers them)."""
    set_dtype(monkeypatch, "float32")
    tcfg = get_config("deepseek-moe-16b").reduced()
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                             capacity_factor=1.0))
    params = ref_params(jget_config("deepseek-moe-16b").reduced())
    tokens = np.random.default_rng(2).integers(0, tcfg.vocab, (8, 16)).astype(np.int32)
    m1, g1, w1 = _one_process_step(tcfg, params, tokens, monkeypatch,
                                   make_local_mesh(data, model, device="cpu"))
    res = run_ranks("train_step", data * model,
                    (tcfg, params, tokens, (data, model), True),
                    SPAWN_TIMEOUT[data * model])
    for r, out in enumerate(res):
        out["coords"] = {"data": r // model, "model": r % model}
    worst = _hold_step(res, {"data": data, "model": model}, m1, g1, w1,
                       TRAIN_TOL["float32"])
    assert worst < TRAIN_TOL["float32"]["grads"], worst


# -- tensor parallelism over model for rwkv, the hybrid, whisper and vlm ---------------------

TP_ARCHS = ["rwkv6-1.6b", "zamba2-1.2b", "whisper-base", "llava-next-mistral-7b"]
SERVE_LEN, SERVE_STEPS = 24, 4   # cache depth (test_torch_families'), decode steps
TP_TIMEOUT = 180                 # s: the one spawn of four ranks, every family


def _family_batch(cfg, rows: int, seed: int) -> dict:
    """tokens (rows, 16) int32, with frames or patches (float64 numpy, the
    ranks and the parent cast them to bf16)."""
    rng = np.random.default_rng(seed)
    nb = {"tokens": rng.integers(0, cfg.vocab, (rows, 16)).astype(np.int32)}
    if cfg.family == "encdec":
        nb["frames"] = rng.normal(size=(rows, cfg.enc_len, cfg.d_model))
    if cfg.family == "vlm":
        nb["patches"] = rng.normal(size=(rows, cfg.num_patches, cfg.patch_dim))
    return nb


def _torch_batch(nb: dict) -> dict:
    return {k: torch.from_numpy(v) if k == "tokens"
            else torch.from_numpy(v.astype(np.float32)).bfloat16()
            for k, v in nb.items()}


def _new_tokens(cfg) -> np.ndarray:
    return np.random.default_rng(7).integers(
        0, cfg.vocab, (SERVE_STEPS, 4, 1)).astype(np.int32)


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """ONE spawn of data 2 x model 2 gloo ranks (``rank_workers.tp_families``)
    for every test of this block: each family's train step and its
    prefill + SERVE_STEPS decode steps, zamba2's SSD mixer with and
    without planted faults, and zamba2's elastic checkpoint. Returns
    (the ranks' results, the payload)."""
    families = []
    for arch in TP_ARCHS:
        tcfg = get_config(arch).reduced()
        families.append((tcfg, ref_params(jget_config(arch).reduced()),
                         _family_batch(tcfg, 4, 2), _family_batch(tcfg, 4, 1),
                         _new_tokens(tcfg)))
    z = get_config("zamba2-1.2b").reduced()
    zp = ref_params(jget_config("zamba2-1.2b").reduced())
    rng = np.random.default_rng(9)
    x = rng.normal(size=(4, 12, z.d_model)).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32)
    ckpt = tmp_path_factory.mktemp("tp_elastic")
    payload = {"families": families, "max_len": SERVE_LEN, "mixer": (z, zp, x, r),
               "elastic": (z, zp, _family_batch(z, 4, 3), str(ckpt))}
    return run_ranks("tp_families", 4, payload, TP_TIMEOUT), payload


def _coords(r: int) -> dict:
    return {"data": r // 2, "model": r % 2}


def _view_mesh(shape: dict, coords: dict):
    """What ``sharding.local_slice`` reads of a rank mesh, for the rank at
    ``coords``."""
    return types.SimpleNamespace(
        extent=lambda e: int(np.prod([shape[n] for n in
                                      (e if isinstance(e, tuple) else (e,))])),
        index=lambda e: _index(e, coords, shape))


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_families_train_tensor_parallel_on_ranks(arch, tp_runs, monkeypatch):
    """rwkv, the hybrid, whisper and vlm on data 2 x model 2, float32
    compute, their weights placed by the reference's rule table: every
    weight the table splits over model (sanitized: the extents divide) is
    split over model (``model_dim``), no other; the step's loss, grad
    norm and every gradient block equal the port's one-process (2, 2)
    step to 1e-5 (whisper: TRAIN_TOL["bfloat16"], its encoder computes in
    bf16 whatever the compute type, and row-parallel partials round
    there before their sum). Whisper's key biases are held apart: their
    exact gradient is zero (a bias on every key shifts a row's scores
    alike, which the softmax ignores), so both steps' are rounding noise,
    each held below 1e-5 of the global gradient norm."""
    set_dtype(monkeypatch, "float32")
    tcfg = get_config(arch).reduced()
    params = ref_params(jget_config(arch).reduced())
    res, payload = tp_runs
    nb = next(f[2] for f in payload["families"] if f[0].name == tcfg.name)
    model = convert.from_jax(params, tcfg, device="cpu")
    state = toptim.init_opt_state(model)
    g1 = {}
    real = tsteps.adamw_update

    def capture(m, *a, **kw):
        g1.update({n: p.grad.detach().clone() for n, p in m.named_parameters()})
        return real(m, *a, **kw)

    monkeypatch.setattr(tsteps, "adamw_update", capture)
    step = tsteps.make_train_step(tcfg, toptim.OptimConfig(total_steps=10))
    with sharding_ctx(make_local_mesh(2, 2, device="cpu")):
        _, _, m1 = step(model, state, _torch_batch(nb))
    m1 = {k: float(v) for k, v in m1.items()}
    w1 = {n: p.detach().clone() for n, p in model.named_parameters()}
    split = _table_split(arch, params, {"data": 2, "model": 2})
    assert split
    noise = [n for n in g1 if n.endswith(".bk")]
    assert (tcfg.family == "encdec") == bool(noise)
    outs = []
    for r, out in enumerate(res):
        out = dict(out["train"][tcfg.name], coords=_coords(r))
        for n, pl in out["placements"].items():
            assert (pl.model_dim is not None) == (n in split), n
        for n in noise:
            for g in (out["grads"].pop(n), g1[n]):
                assert float(g.norm()) < 1e-5 * m1["grad_norm"], (n, float(g.norm()))
        outs.append(out)
    tol = TRAIN_TOL["bfloat16" if tcfg.family == "encdec" else "float32"]
    worst = _hold_step(outs, {"data": 2, "model": 2}, m1, g1, w1, tol)
    assert worst < tol["grads"], (arch, worst)


def _rank_cache(cfg, key: str, full: np.ndarray, r: int, M: int) -> np.ndarray:
    """Model rank ``r``'s part of a whole cache entry: its heads (its di
    channels and every B / C one of the hybrid's conv ring)."""
    heads = {"att_state": 2, "state": 2, "attn_k": 3, "attn_v": 3, "k": 3,
             "v": 3, "xk": 3, "xv": 3}
    if key == "conv":
        di, N = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
        n = di // M
        return np.concatenate([full[..., r * n:(r + 1) * n],
                               full[..., di:di + 2 * N]], axis=-1)
    if key not in heads:
        return full
    return np.split(full, M, axis=heads[key])[r]


def _serve_meshless(tcfg, params, nb, new) -> tuple[list, list]:
    """The port on the one-process (2, 2) mesh: prefill, then each decode
    step of ``new``; (logits per call, [cache after the prefill, after
    the last step]) in float32 numpy."""
    model = convert.from_jax(params, tcfg, device="cpu")
    api = get_api(tcfg)

    def snap(c):
        return {k: v.float().numpy().copy() for k, v in c.items()}

    with sharding_ctx(make_local_mesh(2, 2, device="cpu")), torch.no_grad():
        c, lg = api.prefill(model, _torch_batch(nb), tcfg, SERVE_LEN)
        logits, caches = [lg.numpy()], [snap(c)]
        for t in new:
            c, lg = api.decode(model, c, torch.from_numpy(t), tcfg)
            logits.append(lg.numpy())
        caches.append(snap(c))
    return logits, caches


def _serve_reference(jcfg, params, nb, new) -> tuple[list, list]:
    """The JAX package's meshless prefill and decode steps (each jitted
    once), as :func:`_serve_meshless` returns them."""
    api = jget_api(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jb = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.bfloat16)
          for k, v in nb.items()}
    pre = jax.jit(lambda p, b: api.prefill(p, b, jcfg, SERVE_LEN))
    dec = jax.jit(lambda p, c, t: api.decode(p, c, t, jcfg))

    def snap(c):
        return {k: np.asarray(v.astype(jnp.float32)) for k, v in c.items()}

    c, lg = pre(jp, jb)
    logits, caches = [np.asarray(lg)], [snap(c)]
    for t in new:
        c, lg = dec(jp, c, jnp.asarray(t))
        logits.append(np.asarray(lg))
    caches.append(snap(c))
    return logits, caches


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_families_serve_tensor_parallel_on_ranks(arch, tp_runs, monkeypatch):
    """Prefill (16 tokens, cache depth 24) and SERVE_STEPS decode steps of
    rwkv, the hybrid, whisper and vlm on data 2 x model 2, float32
    compute, each data rank its two of the four rows: every call's logits
    and each model rank's heads of the cache after the prefill and after
    the last step equal the port's one-process (2, 2) mesh's (1e-5 on
    logits; whisper's bf16 encoder, and any cache entry, within the
    tolerance test_torch_families holds that family to), and the JAX
    package's meshless prefill and decode at the tolerance
    tests/test_torch_families.py holds that family to."""
    set_dtype(monkeypatch, "float32")
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    params = ref_params(jcfg)
    res, payload = tp_runs
    _, _, _, nb, new = next(f for f in payload["families"] if f[0].name == tcfg.name)
    one = _serve_meshless(tcfg, params, nb, new)
    ref = _serve_reference(jcfg, params, nb, new)
    atol, rtol = _tol(jcfg, "float32")
    catol, crtol = _tol(jcfg, "float32", cached=True)
    one_tol = (atol, rtol) if tcfg.family == "encdec" else (1e-5, 1e-5)
    for r, out in enumerate(res):
        got = out["serve"][tcfg.name]
        d, m = _coords(r)["data"], _coords(r)["model"]
        rows = slice(2 * d, 2 * d + 2)
        assert len(got["logits"]) == SERVE_STEPS + 1
        for i, lg in enumerate(got["logits"]):
            close(lg, one[0][i][rows], *one_tol, f"{arch} rank {r} call {i} vs mesh")
            close(lg, ref[0][i][rows], atol, rtol, f"{arch} rank {r} call {i} vs ref")
        for i, cache in enumerate(got["caches"]):
            assert set(cache) == set(one[1][i]) == set(ref[1][i])
            for k, v in cache.items():
                if k == "pos":
                    assert int(v) == int(ref[1][i][k]), (arch, i)
                    continue
                for want, tol in ((one[1][i][k], (catol, crtol)),
                                  (ref[1][i][k], (catol, crtol))):
                    w = _rank_cache(tcfg, k, want, m, 2)[:, rows]
                    assert tuple(v.shape) == w.shape, (arch, k)
                    close(v, w, *tol, f"{arch} rank {r} cache {k} phase {i}")


def test_ssd_mixer_tensor_parallel_with_planted_faults(tp_runs):
    """zamba2's SSD mixer (reduced: 8 heads, w_in (64, 296) cut into two
    148-column blocks that do not line up with the heads) on data 2 x
    model 2, float32: the output, the input's gradient and every weight's
    gradient block equal the whole mixer's to 1e-5. Planted: the gated
    norm over a rank's 64 channels alone (not the model-axis sum over
    128) moves the output and the gradients; ``w_in``'s gather without the
    sum in its backward (the B and C columns each rank reads) moves
    ``w_in``'s gradient."""
    from repro_torch.models import ssm as tssm
    from repro_torch.models.sharding import local_slice

    res, payload = tp_runs
    z, zp, x, rr = payload["mixer"]
    blk = convert.from_jax(zp, z, device="cpu").layers[0].ssm
    xt = torch.from_numpy(x).requires_grad_()
    out, _ = tssm.ssm_mixer(xt, blk, z)
    (out * torch.from_numpy(rr)).sum().backward()
    grads = {n: p.grad for n, p in blk.named_parameters()}
    mesh_shape = {"data": 2, "model": 2}

    def worst(run, r) -> dict:
        c = _coords(r)
        mesh = _view_mesh(mesh_shape, c)
        rows = slice(2 * c["data"], 2 * c["data"] + 2)
        gw = {n: _rel(g, local_slice(grads[n], run["placements"][n].spec, mesh))
              for n, g in run["grads"].items()}
        return {"out": _rel(run["out"], out.detach()[rows]),
                "dx": _rel(run["dx"], xt.grad[rows]), **gw}

    for r, out_r in enumerate(res):
        pls = out_r["mixer"][None]["placements"]
        assert pls["w_in"].model_dim == 1 and pls["w_out"].model_dim == 0
        good = worst(out_r["mixer"][None], r)
        assert max(good.values()) < 1e-5, (r, good)
        norm = worst(out_r["mixer"]["local_norm"], r)
        assert norm["out"] > 1e-2 and norm["w_in"] > 1e-2, (r, norm)
        bc = worst(out_r["mixer"]["unsummed_bc"], r)
        assert bc["out"] < 1e-5 and bc["w_in"] > 1e-2, (r, bc)


def test_zamba2_elastic_checkpoint_on_ranks(tp_runs):
    """zamba2 (reduced) after a train step on data 2 x model 2, saved
    through ``launch.train.ModelState`` (rank 0 writes the whole state),
    restored onto data 1 x model 4 of the same ranks into a model placed
    from other weights: every parameter and moment whole equals the saved
    one bit for bit, and each rank's blocks are the new layout's (w_in's
    74-column blocks cut again from the 148-column ones). The step's
    files are the reference's tree: the JAX package's CheckpointManager
    restores them into its own train state's structure, the parameters
    bit-equal to the saved ones."""
    from repro.runtime.checkpoint import CheckpointManager as JCheckpointManager
    from repro_torch.models.sharding import local_slice

    res, payload = tp_runs
    z, zp, _, ckpt = payload["elastic"]
    saved = res[0]["elastic"]["saved"]
    for r, out in enumerate(res):
        e = out["elastic"]
        assert e["step"] == 1 and e["coords"] == {"data": 0, "model": r}
        (sp, so), (rp, ro) = e["saved"], e["restored"]
        for n, t in saved[0].items():
            assert torch.equal(sp[n], t) and torch.equal(rp[n], t), n
            for k in ("m", "v"):
                assert torch.equal(so[k][n], saved[1][k][n]), (k, n)
                assert torch.equal(ro[k][n], saved[1][k][n]), (k, n)
        assert int(ro["step"]) == int(saved[1]["step"]) == 1
        mesh = _view_mesh({"data": 1, "model": 4}, e["coords"])
        for n, t in e["local"].items():
            spec = e["placements"][n].spec
            assert torch.equal(t, local_slice(saved[0][n], spec, mesh)), n
            assert torch.equal(e["m"][n], local_slice(saved[1]["m"][n], spec, mesh)), n
        w_in = e["local"]["layers.0.ssm.w_in"]
        assert tuple(w_in.shape) == (z.d_model, 74)
        assert torch.equal(w_in, saved[0]["layers.0.ssm.w_in"][:, 74 * r:74 * (r + 1)])
    like = {"params": jax.tree_util.tree_map(jnp.zeros_like, zp)}
    like["opt"] = {"m": like["params"], "v": like["params"],
                   "step": jnp.zeros((), jnp.int32)}
    step, tree = JCheckpointManager(ckpt).restore(None, like)
    assert step == 1 and int(tree["opt"]["step"]) == 1
    back = convert.from_jax(jax.tree_util.tree_map(np.asarray, tree["params"]),
                            z, device="cpu")
    for n, p in back.named_parameters():
        assert torch.equal(p, saved[0][n]), n


def test_pod_rank_mesh_axes_and_groups():
    """``init_rank_mesh(2, 2, pod=2)`` on 8 ranks: the reference's axis
    order ("pod", "data", "model"), each rank's coordinates, the process
    group of each axis and of the data-axis tuple ("pod", "data"): a psum
    of the rank ids over each equals the sum of the ranks that share the
    other coordinates."""
    res = run_ranks("pod_mesh", 8, None, SPAWN_TIMEOUT[8])
    for r, out in enumerate(res):
        p, d, m = r // 4, (r // 2) % 2, r % 2
        assert out["names"] == ("pod", "data", "model") and out["size"] == 8
        assert out["coords"] == {"pod": p, "data": d, "model": m}
        assert out["axes"].data == ("pod", "data") and out["axes"].model == "model"
        assert out["index"] == 2 * p + d
        assert out["sums"] == {
            "pod": sum(4 * i + 2 * d + m for i in range(2)),
            "data": sum(4 * p + 2 * i + m for i in range(2)),
            "model": sum(4 * p + 2 * d + i for i in range(2)),
            ("pod", "data"): sum(4 * i + 2 * j + m for i in range(2)
                                 for j in range(2))}


# -- the launcher under torchrun ------------------------------------------------------------


def test_launch_train_under_torchrun(tmp_path):
    """``torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train
    --device cpu`` (gloo): the rank mesh is data 1 x model 2 (the
    launchers' rule), the weights placed; it trains, checkpoints in the
    reference's format (the single-process run's leaves), and a second
    run resumes from the last step. The final loss is a single-process
    run's within 5e-3 (the DP test's bound: bf16 partials over model)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    common = ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
              "--global-batch", "4", "--seq", "16", "--ckpt-every", "2"]

    def launch(args, n=2):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc-per-node={n}", "-m", "repro_torch.launch.train"] \
            if n > 1 else [sys.executable, "-m", "repro_torch.launch.train"]
        r = subprocess.run(cmd + common + args, capture_output=True, text=True,
                           timeout=150, env=env, cwd=tmp_path)
        assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
        return r.stdout

    out = launch(["--steps", "3", "--ckpt-dir", str(tmp_path / "c")])
    assert "rank mesh: data 1 x model 2 (gloo, weights placed)" in out
    out2 = launch(["--steps", "4", "--resume", "--ckpt-dir", str(tmp_path / "c")])
    assert "resumed at step 3" in out2
    meta = json.loads((tmp_path / "c" / "step_4" / "meta.json").read_text())
    one = launch(["--steps", "4", "--ckpt-dir", str(tmp_path / "one")], n=1)
    meta1 = json.loads((tmp_path / "one" / "step_4" / "meta.json").read_text())
    assert meta["num_leaves"] == meta1["num_leaves"]

    def final(text):
        return float(text.split("final loss ")[1].split(";")[0])

    assert abs(final(out2) - final(one)) < 5e-3


def test_launch_serve_under_torchrun(tmp_path):
    """``torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve
    --device cpu``: deepseek-moe-16b (reduced) on data 2 x model 2 gloo
    ranks, its weights placed (experts over model), each data rank serving
    two of the four requests; request 0's greedy continuation equals a
    single-process run's."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    args = ["-m", "repro_torch.launch.serve", "--arch", "deepseek-moe-16b",
            "--reduced", "--device", "cpu", "--batch", "4", "--prompt", "8",
            "--new-tokens", "4"]
    outs = []
    for cmd in ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node=4"], [sys.executable]):
        r = subprocess.run(cmd + args, capture_output=True, text=True,
                           timeout=150, env=env, cwd=tmp_path)
        assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
        outs.append(r.stdout)
    assert "mesh: {'data': 2, 'model': 2} (gloo ranks, weights placed)" in outs[0]

    def continuation(text):
        lines = [x for x in text.splitlines() if x.startswith("request 0")]
        assert len(lines) == 1, text
        return lines[0]

    assert continuation(outs[0]) == continuation(outs[1])
