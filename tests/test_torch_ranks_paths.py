"""The model mesh across ``torch.distributed`` ranks, beyond the
reference's four replays (tests/test_torch_ranks.py): the train step
where the model extent does not divide the heads, the MoE step with and
without expert parallelism, the families that take FSDP alone, the
multi-pod rank layout, and both launchers under ``torchrun``. Each rank
test holds the ranks to the port's one-process mesh (float32 compute:
1e-5) through ``rank_workers.run_ranks`` (a FileStore rendezvous, a
join timeout of its own); the launchers to a single-process run."""
import dataclasses
import json
import os
import sys
import subprocess

import numpy as np
import pytest
import torch

from rank_workers import run_ranks
from repro.configs import get_config as jget_config
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import convert
from repro_torch.models import optim as toptim
from repro_torch.models import steps as tsteps
from repro_torch.models.sharding import sharding_ctx
from test_torch_families import ref_params, set_dtype
from test_torch_ranks import (ROOT, SPAWN_TIMEOUT, TRAIN_TOL, _hold_step,
                              _one_process_step)


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


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b", "whisper-base",
                                  "llava-next-mistral-7b"])
def test_fsdp_only_families_train_on_ranks(arch, monkeypatch):
    """The families that keep their weights whole over model (rwkv, the
    hybrid, whisper, vlm) on data 2 x model 2, float32 compute: FSDP over
    data only (no block split over model), each data rank its rows; the
    step's loss, grad norm and every gradient block equal the port's
    one-process (2, 2) step to 1e-5."""
    set_dtype(monkeypatch, "float32")
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    params = ref_params(jcfg)
    nb = {"tokens": np.random.default_rng(2).integers(
        0, tcfg.vocab, (4, 16)).astype(np.int32)}
    if tcfg.family == "encdec":
        nb["frames"] = np.random.default_rng(3).normal(
            size=(4, tcfg.enc_len, tcfg.d_model))
    if tcfg.family == "vlm":
        nb["patches"] = np.random.default_rng(3).normal(
            size=(4, tcfg.num_patches, tcfg.patch_dim))
    tb = {k: torch.from_numpy(v) if k == "tokens"
          else torch.from_numpy(v.astype(np.float32)).bfloat16()
          for k, v in nb.items()}
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
        _, _, m1 = step(model, state, tb)
    m1 = {k: float(v) for k, v in m1.items()}
    w1 = {n: p.detach().clone() for n, p in model.named_parameters()}
    res = run_ranks("family_steps", 4, [(tcfg, params, nb)], SPAWN_TIMEOUT[4])
    for r, out in enumerate(res):
        out = out[tcfg.name]
        out["coords"] = {"data": r // 2, "model": r % 2}
        assert all(pl.model_dim is None for pl in out["placements"].values())
        assert any(pl.data_dim is not None for pl in out["placements"].values())
        res[r] = out
    worst = _hold_step(res, {"data": 2, "model": 2}, m1, g1, w1,
                       TRAIN_TOL["float32"])
    assert worst < TRAIN_TOL["float32"]["grads"], (arch, worst)


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
