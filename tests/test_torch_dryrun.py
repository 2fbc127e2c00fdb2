"""The dry-run and cost tools of the port (``launch/dryrun.py``,
``launch/hlocost.py``) against the reference's, on the CPU.

* ``registry.batch_specs`` / ``decode_specs`` / ``shape_adjusted_cfg``
  equal the reference's shapes and dtypes for every arch x shape at
  published width (meta tensors: nothing is allocated).
* The cost model's totals (flops, bytes, collectives, peak of live bytes)
  on "meta" equal its totals on the CPU for each family's reduced train,
  prefill and decode step, meshless and on a data 2 x model 2 mesh.
* Its matmul flops against the reference's ``hlocost`` dot flops on the
  same reduced meshless steps, jitted on the CPU (a test-side subclass of
  ``HloCostModel`` keeps only dots and the loops and calls around them):
  prefill and decode equal exactly; a train step within
  ``TRAIN_MATMUL_TOL``, because the port's checkpointed cross-entropy
  chunk recomputes its logits in the backward where XLA's compiled step
  keeps the forward's (+2.3% to +4.4% measured). Total flops within a
  factor ``TOTAL_RATIO`` below the reference's: the reference counts
  XLA's fusions, which recompute broadcasts and conversions inside each
  fusion, the port each eager op once (0.52 to 0.92 measured).
* One linear layer and one attention layer (blocked, and flash charged
  by its kernel cost) at exactly 2·M·N·K per product.
* The collectives of the data-parallel train step, the expert-parallel
  MoE and the shardmap decode equal counts derived here from the model.
* The kernels' meta branches (shapes, dtypes, strides; no launch) and
  their ``cost(...)`` formulas.
* ``lower_cell`` / ``main`` at reduced width and small shapes, ``ok`` on
  both pod meshes, and the reference's skip of ``long_500k`` on a
  full-attention arch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS
from repro.configs import get_config as jget_config
from repro.launch.hlocost import HloCostModel
from repro.models import registry as jreg
from repro.models import steps as jsteps
from repro.models.config import SHAPES as JSHAPES
from repro.models.config import cell_applicable as jcell_applicable
from repro.models.optim import OptimConfig as JOptimConfig
from repro.models.optim import init_opt_state as jinit_opt_state
from repro_torch import configs as tconfigs
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import dryrun, hlocost, serve
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import attention as tattn
from repro_torch.models import config as tconfig
from repro_torch.models import moe as tmoe
from repro_torch.models import registry, steps
from repro_torch.models.config import SHAPES
from repro_torch.models.optim import OptimConfig, init_opt_state
from repro_torch.models.sharding import sharding_ctx
from test_torch_families import FAMILY_ARCH

B, S = 2, 32               # the reduced steps' batch
TRAIN_MATMUL_TOL = 0.05    # |port / reference - 1| of a train step's matmul flops
TOTAL_RATIO = (0.5, 1.0)   # port / reference total flops
META = torch.device("meta")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _flat(tree, pre="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}/{k}"))
        return out
    return {pre: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_registry_specs_equal_reference(arch):
    for name, jshape in JSHAPES.items():
        shape = SHAPES[name]
        assert dataclasses.astuple(shape) == (jshape.name, jshape.seq_len,
                                              jshape.global_batch, jshape.kind)
        jc = jreg.shape_adjusted_cfg(jget_config(arch), jshape)
        tc = registry.shape_adjusted_cfg(get_config(arch), shape)
        assert tc.sliding_window == jc.sliding_window, (arch, name)
        if shape.kind == "decode":
            jt, jcache = jreg.decode_specs(jc, jshape.global_batch, jshape.seq_len)
            tt, tcache = registry.decode_specs(tc, shape.global_batch, shape.seq_len)
            want, got = _flat({"t": jt, "c": jcache}), _flat({"t": tt, "c": tcache})
            assert all(t.device == META for t in (*tt.values(), *tcache.values()))
        else:
            want = _flat(jreg.batch_specs(jc, jshape.global_batch, jshape.seq_len))
            tb = registry.batch_specs(tc, shape.global_batch, shape.seq_len)
            got = _flat(tb)
            assert all(t.device == META for t in tb.values())
        assert got == want, (arch, name)


# -- the cost model: meta == CPU ----------------------------------------------------

def _model(cfg, dev):
    gen = registry._MetaGenerator() if dev == "meta" else \
        torch.Generator(device=dev).manual_seed(0)
    return registry.get_api(cfg).init(cfg, gen)


def _batch(cfg, dev):
    """The launchers' seeded batch (numpy), moved to ``dev``."""
    batch = serve.make_batch(cfg, B, S, np.random.default_rng(0), "cpu")
    return {k: v.to(dev) for k, v in batch.items()}


def _step_cost(cfg, dev, kind, mesh):
    """The counter's totals over one ``kind`` step of ``cfg`` on ``dev``
    (a decode step after a prefill of S tokens), meshless or on a data 2
    x model 2 mesh of ``dev``."""
    model = _model(cfg, dev)
    batch = _batch(cfg, dev)
    ctx = sharding_ctx(make_local_mesh(2, 2, device=dev)) if mesh else \
        contextlib.nullcontext()
    with ctx:
        if kind == "train":
            step = steps.make_train_step(cfg, OptimConfig())
            return hlocost.analyze(step, model, init_opt_state(model), batch,
                                   device=dev)[0]
        max_len = registry.prefill_cache_len(cfg, S) + 4
        prefill = steps.make_prefill_step(cfg, max_len=max_len)
        if kind == "prefill":
            return hlocost.analyze(prefill, model, batch, device=dev)[0]
        cache, tok = prefill(model, batch)
        return hlocost.analyze(steps.make_decode_step(cfg), model, cache, tok,
                               device=dev)[0]


@pytest.mark.parametrize("mesh", [False, True], ids=["meshless", "mesh2x2"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_meta_totals_equal_cpu(family, kind, mesh):
    cfg = get_config(FAMILY_ARCH[family]).reduced()
    cpu = _step_cost(cfg, "cpu", kind, mesh)
    meta = _step_cost(cfg, "meta", kind, mesh)
    assert meta == cpu
    assert cpu["flops"] > cpu["matmul_flops"] > 0 and cpu["bytes"] > 0
    assert cpu["peak_bytes"] > 0


# -- the cost model against the reference's hlocost ---------------------------------

class _DotFlops(HloCostModel):
    """The reference's walk with only dots adding flops (loops, fusions
    and calls still carry them up with their trip counts)."""

    KEEP = {"dot", "while", "fusion", "call", "async-start", "conditional"}

    def _add_op(self, t, op, shapes):
        if op.opcode in self.KEEP:
            super()._add_op(t, op, shapes)


def _reference_flops(jc, kind) -> tuple[float, float]:
    params = jax.eval_shape(lambda k: jreg.get_api(jc).init(k, jc), jax.random.key(0))
    if kind == "train":
        fn = jax.jit(jsteps.make_train_step(jc, JOptimConfig()))
        lowered = fn.lower(params, jax.eval_shape(jinit_opt_state, params),
                           jreg.batch_specs(jc, B, S))
    elif kind == "prefill":
        fn = jax.jit(jsteps.make_prefill_step(
            jc, max_len=jreg.prefill_cache_len(jc, S)))
        lowered = fn.lower(params, jreg.batch_specs(jc, B, S))
    else:
        tok, cache = jreg.decode_specs(jc, B, S)
        lowered = jax.jit(jsteps.make_decode_step(jc)).lower(params, cache,
                                                             tok["tokens"])
    hlo = lowered.compile().as_text()
    return _DotFlops(hlo).totals()["flops"], HloCostModel(hlo).totals()["flops"]


def _meta_step(cfg, kind):
    model = _model(cfg, "meta")
    if kind == "train":
        return hlocost.analyze(steps.make_train_step(cfg, OptimConfig()), model,
                               init_opt_state(model), registry.batch_specs(cfg, B, S),
                               device="meta")[0]
    if kind == "prefill":
        step = steps.make_prefill_step(cfg, max_len=registry.prefill_cache_len(cfg, S))
        return hlocost.analyze(step, model, registry.batch_specs(cfg, B, S),
                               device="meta")[0]
    tok, cache = registry.decode_specs(cfg, B, S)
    return hlocost.analyze(steps.make_decode_step(cfg), model, cache,
                           tok["tokens"], device="meta")[0]


@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_matmul_flops_match_reference_hlocost(family):
    arch = FAMILY_ARCH[family]
    for kind in ("train", "prefill", "decode"):
        ref_dot, ref_total = _reference_flops(jget_config(arch).reduced(), kind)
        got = _meta_step(get_config(arch).reduced(), kind)
        if kind == "train":
            assert abs(got["matmul_flops"] / ref_dot - 1) <= TRAIN_MATMUL_TOL, \
                (kind, got["matmul_flops"], ref_dot)
        else:
            assert got["matmul_flops"] == ref_dot, (kind, got["matmul_flops"], ref_dot)
        ratio = got["flops"] / ref_total
        assert TOTAL_RATIO[0] <= ratio <= TOTAL_RATIO[1], (kind, ratio)


def test_linear_and_attention_layers_are_2mnk():
    cfg = get_config("qwen3-1.7b").reduced()
    x = torch.empty((3, 20, cfg.d_model), device=META)
    w = torch.empty((cfg.d_model, 48), device=META)
    got, _ = hlocost.analyze(lambda: x @ w, device="meta")
    assert got["matmul_flops"] == 2 * 3 * 20 * cfg.d_model * 48
    assert got["bytes"] == 4 * (x.numel() + w.numel() + 3 * 20 * 48)

    layer = tattn.init_attention(cfg, registry._MetaGenerator())
    T, H, KV, hd, d = 3 * 20, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
    proj = 2 * T * d * H * hd + 2 * 2 * T * d * KV * hd + 2 * T * H * hd * d
    core = 2 * 2 * 3 * H * 20 * 20 * hd   # scores and P.V over every key
    got, _ = hlocost.analyze(tattn.attention, x, layer, cfg, device="meta")
    assert got["matmul_flops"] == proj + core
    flash = dataclasses.replace(cfg, attn_impl="flash")
    got, _ = hlocost.analyze(tattn.attention, x, layer, flash, device="meta")
    assert got["matmul_flops"] == proj
    charge = fa.flash_mha_fwd_cost(torch.empty((3, H, 20, hd), device=META),
                                   torch.empty((3, KV, 20, hd), device=META))
    assert got["kernels"] == {"flash_mha_fwd": {"count": 1, **charge}}
    assert charge["flops"] == core / 2    # causal: half the pairs


# -- collectives at the seam ----------------------------------------------------------

def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def test_dp_step_books_one_psum_per_gradient_leaf():
    """The data-parallel train step on data 2 x model 2: one all-reduce
    per gradient leaf of its bytes (``merge_grads``) and one per metric
    (4 bytes each): nothing else crosses the seam."""
    cfg = get_config("qwen3-1.7b").reduced()
    model = _model(cfg, "meta")
    params = list(model.parameters())
    with sharding_ctx(make_local_mesh(2, 2, device="meta")):
        got, (_, _, metrics) = hlocost.analyze(
            steps.make_train_step(cfg, OptimConfig()), model,
            init_opt_state(model), registry.batch_specs(cfg, 4, 16), device="meta")
    n_metrics = len([k for k in metrics if k not in ("grad_norm", "lr")])
    nbytes = sum(_nbytes(p) for p in params) + 4 * n_metrics
    want = {"count": len(params) + n_metrics, "bytes": nbytes,
            "mesh_bytes": 2 * nbytes}          # two data shards a call
    assert got["collectives"]["by_kind"] == {"all-reduce": want}
    assert got["collectives"]["wire_bytes_per_device"] == 2 * want["bytes"]
    assert got["collectives"]["mesh_wire_bytes"] == 2 * want["mesh_bytes"]


def test_ep_moe_and_shardmap_decode_collectives():
    """The expert-parallel MoE prefill on data 2 x model 2: per MoE layer
    one psum over the ranks per data block (that block's output) and two
    pmeans for the aux loss (E float32 each). The shardmap decode: per
    attention layer and data block one pmax and two psums of the online
    softmax's float32 (m, l, o)."""
    cfg = get_config("deepseek-moe-16b").reduced()
    model = _model(cfg, "meta")
    n_moe = sum(isinstance(m, tmoe.MoE) for m in model.modules())
    E, d, Bm, Sm = cfg.moe.num_experts, cfg.d_model, 4, 16
    step = steps.make_prefill_step(cfg, max_len=Sm + 2)
    with sharding_ctx(make_local_mesh(2, 2, device="meta")):
        got, _ = hlocost.analyze(step, model, registry.batch_specs(cfg, Bm, Sm),
                                 device="meta")
    block = (Bm // 2) * Sm * d * 2        # bf16 activations
    assert n_moe > 0
    nbytes = n_moe * (2 * block + 2 * 4 * E)
    assert got["collectives"]["by_kind"] == {"all-reduce": {
        "count": n_moe * (2 + 2), "bytes": nbytes, "mesh_bytes": 2 * nbytes}}

    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              decode_cache_update="shardmap")
    model = _model(cfg, "meta")
    tok, cache = registry.decode_specs(cfg, 4, 16)
    KV, G, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.d_head
    with sharding_ctx(make_local_mesh(2, 2, device="meta")):
        got, _ = hlocost.analyze(steps.make_decode_step(cfg), model, cache,
                                 tok["tokens"], device="meta")
    ml = 2 * KV * G * 4                    # (b, KV, G, 1) float32, b = 2
    o = 2 * KV * G * hd * 4                # (b, 1, KV, G, hd) float32
    nbytes = cfg.n_layers * 2 * (2 * ml + o)
    assert got["collectives"]["by_kind"] == {"all-reduce": {
        "count": cfg.n_layers * 2 * 3, "bytes": nbytes, "mesh_bytes": 2 * nbytes}}


@pytest.mark.parametrize("E,k", [(4, 2), (64, 6)])
def test_moe_routing_statistics_run_on_meta(E, k):
    """The MoE routing statistics the data-parallel step gathers: expert
    counts by scatter-add (``torch.bincount`` has no meta kernel) and
    fractions by comparison (``F.one_hot`` checks its ids on the CPU's
    host), equal to those two bit for bit, and shaped alike on meta."""
    import torch.nn.functional as F

    idx = torch.from_numpy(np.random.default_rng(E).integers(0, E, (512, k)))
    got = tmoe._expert_counts(idx, E)
    want = torch.bincount(idx.reshape(-1), minlength=E)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(tmoe._frac(idx, E),
                       F.one_hot(idx, E).float().sum(dim=1).mean(dim=0))
    meta = idx.to("meta")
    assert tmoe._expert_counts(meta, E).shape == (E,)
    assert tmoe._frac(meta, E).shape == (E,)


# -- the kernels on meta, and their costs -------------------------------------------

def test_kernel_meta_branches_and_costs(monkeypatch):
    monkeypatch.setattr(_build, "function", lambda *a, **k: pytest.fail("launched"))
    before = dict(_build.LAUNCHES)
    Bq, H, KV, Sq, D = 2, 8, 4, 96, 64
    q = torch.empty((Bq, Sq, H, D), dtype=torch.bfloat16, device=META).transpose(1, 2)
    k = torch.empty((Bq, Sq, KV, D), dtype=torch.bfloat16, device=META).transpose(1, 2)
    out, lse = fa.flash_mha_fwd(q, k, k, causal=True)
    assert out.shape == q.shape and out.dtype == q.dtype and out.device == META
    assert out.stride() == (Sq * H * D, D, H * D, 1)     # (B,H,S,D) view of (B,S,H,D)
    assert lse.shape == (Bq, H, Sq) and lse.dtype == torch.float32 and lse.is_contiguous()
    dq, dk, dv = fa.flash_attention_bwd(q, k, k, out, lse, out, causal=True)
    assert dq.shape == q.shape and dq.stride() == out.stride()
    for g in (dk, dv):
        assert g.shape == k.shape and g.stride() == (Sq * KV * D, D, KV * D, 1)
        assert g.dtype == torch.bfloat16 and g.device == META
    qd = torch.empty((Bq, H, D), dtype=torch.bfloat16, device=META)
    lens = torch.empty((Bq,), dtype=torch.int32, device=META)
    o = da.flash_decode(qd, k, k, lens)
    assert o.shape == (Bq, H, D) and o.dtype == torch.bfloat16 and o.device == META
    assert _build.LAUNCHES == before

    pairs = Bq * H * Sq * Sq
    fwd = {"flops": 4 * pairs * D / 2,
           "bytes": (2 * q.numel() + 2 * k.numel()) * 2 + Bq * H * Sq * 4}
    assert fa.flash_mha_fwd_cost(q, k, causal=True) == fwd
    assert fa.flash_mha_fwd_cost(q, k, causal=False)["flops"] == 4 * pairs * D
    assert fa.flash_attention_bwd_cost(q, k, causal=True) == {
        "flops": 2.5 * fwd["flops"],
        "bytes": (4 * q.numel() + 4 * k.numel()) * 2 + Bq * H * Sq * 4}
    walked = Bq * Sq
    assert da.flash_decode_cost(qd, k, None) == {
        "flops": 4 * walked * H * D,
        "bytes": (2 * walked * KV * D + 2 * qd.numel()) * 2 + Bq * 4,
        "walked": walked}
    lengths = torch.tensor([0, 7], dtype=torch.int32)
    got = da.flash_decode_cost(qd, k, lengths)
    assert (got["walked"], got["flops"]) == (Sq + 7, 4 * (Sq + 7) * H * D)


# -- the dry-run ----------------------------------------------------------------------

SMALL = {"train_4k": (16, 32), "prefill_32k": (64, 32), "decode_32k": (64, 32),
         "long_500k": (128, 1)}     # (seq, batch) of each kind at reduced width


@pytest.fixture
def reduced_cells(monkeypatch):
    """lower_cell at reduced width on small shapes of the same kinds."""
    real = tconfigs.get_config
    monkeypatch.setattr(tconfigs, "get_config", lambda a: real(a).reduced())
    for name, (seq, batch) in SMALL.items():
        monkeypatch.setitem(tconfig.SHAPES, name, dataclasses.replace(
            SHAPES[name], seq_len=seq, global_batch=batch))


@pytest.mark.parametrize("arch,shape", [("qwen3-1.7b", "train_4k"),
                                        ("deepseek-moe-16b", "prefill_32k"),
                                        ("llava-next-mistral-7b", "decode_32k"),
                                        ("zamba2-1.2b", "long_500k")])
def test_lower_cell_on_both_pod_meshes(reduced_cells, tmp_path, capsys, arch, shape):
    assert dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "both",
                        "--out", str(tmp_path)]) == 0
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 2 and all(": ok meta run=" in line for line in printed)
    for mesh, chips in (("pod", 256), ("multipod", 512)):
        rec = json.loads((tmp_path / mesh / f"{arch}__{shape}.json").read_text())
        assert rec["status"] == "ok" and rec["chips"] == chips
        assert rec["method"] == dryrun.METHOD
        r = rec["roofline"]
        assert r["compute_s"] == rec["hlo_model"]["flops"] / dryrun.PEAK_FLOPS
        assert r["memory_s"] == rec["hlo_model"]["bytes"] / dryrun.HBM_BW
        assert rec["hlo_model"]["flops"] == rec["mesh_totals"]["flops"] / chips
        coll = rec["collectives"]
        for key, bytes_key, over in (("wire_bytes_per_device", "bytes", 1),
                                     ("wire_bytes_per_chip_mean", "mesh_bytes", chips)):
            assert coll[key] == sum(hlocost.WIRE_MULT[k] * v[bytes_key]
                                    for k, v in coll["by_kind"].items()) / over
        assert r["collective_s"] == coll["wire_bytes_per_chip_mean"] / dryrun.NET_BW
        assert 0 < r["useful_flop_ratio"] <= 1
        mem = rec["memory_analysis"]
        assert mem["argument_size_in_bytes"] > 0 and mem["peak_live_bytes_whole_mesh"] > 0
    if shape == "train_4k":   # data-parallel over 16 and 32 shards
        assert rec["collectives"]["by_kind"]["all-reduce"]["count"] > 0


def test_lower_cell_skips_as_the_reference(reduced_cells):
    for arch in ALL_ARCHS:
        ok, why = jcell_applicable(jget_config(arch), JSHAPES["long_500k"])
        if ok:
            continue
        rec = dryrun.lower_cell(arch, "long_500k", False)
        assert rec == {"arch": arch, "shape": "long_500k", "mesh": "pod",
                       "status": "skipped", "reason": why}
