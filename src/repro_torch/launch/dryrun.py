"""Multi-pod dry-run: run every (architecture x input shape x mesh) cell's
step once on the "meta" device, over the pod meshes, and derive its
roofline terms (counterpart of ``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k --mesh both
    python -m repro_torch.launch.dryrun --all [--mesh pod|multipod|both] [--skip-done]

No card is needed: the model, its AdamW state, the batch and the cache
are meta tensors (shapes and dtypes, no data), and the step runs eagerly
under the cost model of ``launch/hlocost.py`` inside
``sharding_ctx(make_production_mesh(..., device="meta"))``: (16, 16)
over ("data", "model"), 256 shards, or (2, 16, 16) over ("pod", "data",
"model"), 512. Each cell writes ``results/dryrun_torch/<mesh>/<arch>__<shape>.json``.

What the records share with the reference's, and what differs (each
record's ``method`` says it too):

  * The reference lowers each cell through XLA's SPMD partitioner and
    reads per-chip flops and bytes off the partitioned HLO. The port has
    no partitioner: dense tensor parallelism is the identity
    (``models/sharding.py`` ``constrain``), a meshed prefill or decode
    runs its batch whole, and only the data-parallel train step, the
    expert ranks and the shardmap decode split their work over the
    shards. So per-chip flops and bytes are the mesh step's totals
    divided by the chips: the even split a partitioner would aim at.
  * ``collective_s`` counts what the step calls at the collective seam
    (``engine/distributed.py``), which is where NCCL will sit: no weight
    all-gathers or tensor-parallel reductions, which the port does not do.
    It is ``wire_bytes_per_chip_mean``: the wire bytes of every call's
    group, summed, over the chips (the one-process mesh runs each data
    block's collective as a call of its own, where a real mesh runs them
    at once on disjoint groups), so that all three terms are the mesh's
    totals split evenly. The record also keeps ``wire_bytes_per_device``,
    what a device taking part in every call sends: for the data-parallel
    train step, each GPU's ring all-reduce of the whole gradient, as the
    port's own design (no weight sharding) would run it.
  * ``memory_analysis`` holds per-chip argument and output bytes from the
    sanitized PartitionSpecs, and the meta run's peak of live bytes, which
    is the whole one-process mesh's.
  * ``lower_s`` is the meta run's seconds; there is no compile step.

The hardware model is one NVIDIA H100 SXM from NVIDIA's data sheet (the
reference's is a TPU v5e): 989e12 dense bf16 flop/s on the tensor cores,
67e12 float32 flop/s outside them, 3.35e12 B/s of HBM3, and 50e9 B/s per
GPU for collectives: a DGX H100 gives each GPU one 400 Gb/s NIC, and
every group along a 16-wide mesh axis spans more than one 8-GPU NVLink
node, so the NIC is the ring's slowest link. These are model terms at
data-sheet peaks, not measured times.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time
import traceback

import torch

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# -- NVIDIA H100 SXM hardware model (NVIDIA's data sheet; dense, no sparsity) --
PEAK_FLOPS = 989e12        # bf16 flop/s on the tensor cores
FP32_FLOPS = 67e12         # float32 flop/s outside the tensor cores
HBM_BW = 3.35e12           # HBM3 bytes/s
NET_BW = 50e9              # bytes/s per GPU across nodes: one 400 Gb/s NIC

METHOD = {
    "device": "meta: shapes and dtypes only, nothing computed; the step "
              "runs once eagerly under launch/hlocost.py's counter",
    "per_chip": "the mesh step's totals / chips (the even split a "
                "partitioner would aim at): the port has no SPMD "
                "partitioner; dense tensor parallelism is the identity, a "
                "meshed prefill or decode runs its batch whole, and only "
                "the data-parallel train step, the expert ranks and the "
                "shardmap decode split their work over the shards",
    "collectives": "only what the step calls at engine/distributed.py's "
                   "seam; no weight all-gathers or tensor-parallel "
                   "reductions, which the port does not do. collective_s is "
                   "wire_bytes_per_chip_mean: every call's group's wire "
                   "bytes, summed, over the chips (one call per data block "
                   "of the one-process mesh stands for concurrent calls on "
                   "disjoint groups), the even split the flops and bytes "
                   "use. wire_bytes_per_device is what a device taking part "
                   "in every call sends: for the data-parallel step each "
                   "GPU's all-reduce of the whole gradient, the port's own "
                   "design without weight sharding",
    "memory_analysis": "argument and output bytes per chip from the "
                       "sanitized PartitionSpecs; peak_live_bytes_whole_mesh "
                       "is the meta run's peak of the bytes the step "
                       "allocates, over the whole one-process mesh",
    "hardware": "NVIDIA H100 SXM data sheet: 989e12 bf16 flop/s, 3.35e12 "
                "B/s HBM3, 50e9 B/s per GPU for collectives (one 400 Gb/s "
                "NIC per GPU, DGX H100); model terms, not measured times",
}


def _mesh_tag(multi_pod: bool) -> str:
    return "multipod" if multi_pod else "pod"


def _typed(cfg, overrides: dict | None):
    if not overrides:
        return cfg
    typed = {}
    for k, v in overrides.items():
        cur = getattr(cfg, k)
        typed[k] = type(cur)(v) if cur is not None and not isinstance(cur, str) else v
    return dataclasses.replace(cfg, **typed)


def _per_chip_bytes(tree, spec_tree, mesh) -> int:
    """Bytes one chip holds of ``tree`` under ``spec_tree`` (sanitized
    against the shapes): each leaf over the extents of the axes it is
    split along."""
    from repro_torch.models.sharding import P, sanitize_spec_tree

    clean = sanitize_spec_tree(spec_tree, tree, mesh)
    total = 0

    def walk(t, s):
        nonlocal total
        if isinstance(s, P):
            split = 1
            for entry in s:
                for name in (entry if isinstance(entry, tuple) else (entry,)):
                    split *= mesh.shape.get(name, 1) if name else 1
            total += t.numel() * t.element_size() // split
        elif isinstance(s, dict):
            for k in s:
                walk(t[k], s[k])
        else:
            for a, b in zip(t, s):
                walk(a, b)

    walk(tree, clean)
    return total


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               overrides: dict | None = None) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch import hlocost
    from repro_torch.launch.mesh import MeshAxes, make_production_mesh
    from repro_torch.models import convert, registry, steps
    from repro_torch.models.config import SHAPES, cell_applicable
    from repro_torch.models.optim import OptimConfig, init_opt_state
    from repro_torch.models.sharding import P, param_specs, sharding_ctx

    cfg = _typed(get_config(arch), overrides)
    shape = SHAPES[shape_name]
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": _mesh_tag(multi_pod),
                "status": "skipped", "reason": why}
    cfg = registry.shape_adjusted_cfg(cfg, shape)
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    axes = MeshAxes.for_mesh(mesh)
    chips = mesh.size
    api = registry.get_api(cfg)

    model = api.init(cfg, registry._MetaGenerator())
    if shape.kind != "train" and cfg.serve_params_dtype == "bf16":
        with torch.no_grad():
            for name, p in model.named_parameters():
                if convert.leaf_ndim(name, p) >= 2:
                    p.data = p.data.to(torch.bfloat16)
    params = convert.params_like(model)
    pspecs = param_specs(params, axes)
    params_chip = _per_chip_bytes(params, pspecs, mesh)
    B = shape.global_batch
    tok_specs = {"tokens": P(axes.data, None)}
    t0 = time.time()
    with sharding_ctx(mesh, axes):
        if shape.kind == "train":
            opt = init_opt_state(model)
            batch = registry.batch_specs(cfg, B, shape.seq_len)
            # AdamW's m and v beside every (float32) parameter, under its
            # spec, and the int32 step
            opt_chip = 2 * params_chip + 4
            args = (model, opt, batch)
            step = steps.make_train_step(cfg, OptimConfig())
            in_chip = params_chip + opt_chip + _per_chip_bytes(
                batch, registry.batch_pspecs(cfg, axes), mesh)
        elif shape.kind == "prefill":
            clen = registry.prefill_cache_len(cfg, shape.seq_len)
            batch = registry.batch_specs(cfg, B, shape.seq_len)
            args = (model, batch)
            step = steps.make_prefill_step(cfg, api, max_len=clen)
            in_chip = params_chip + _per_chip_bytes(
                batch, registry.batch_pspecs(cfg, axes), mesh)
        else:  # decode: one new token against a seq_len-deep cache
            tok, cache = registry.decode_specs(cfg, B, shape.seq_len)
            cspecs = registry.cache_pspecs(cfg, axes)
            args = (model, cache, tok["tokens"])
            step = steps.make_decode_step(cfg, api)
            in_chip = params_chip + _per_chip_bytes(cache, cspecs, mesh) \
                + _per_chip_bytes(tok, tok_specs, mesh)
        totals, result = hlocost.analyze(step, *args, device="meta")
    lower_s = time.time() - t0

    if shape.kind == "train":   # the parameters and AdamW's state, in place
        out_chip = alias_chip = params_chip + opt_chip
    else:                       # the cache (a decode writes it in place), tokens
        cache, nxt = result
        cache_chip = _per_chip_bytes(cache, registry.cache_pspecs(cfg, axes), mesh)
        out_chip = cache_chip + _per_chip_bytes({"tokens": nxt}, tok_specs, mesh)
        alias_chip = cache_chip if shape.kind == "decode" else 0
    mem_rec = {"argument_size_in_bytes": in_chip,
               "output_size_in_bytes": out_chip,
               "alias_size_in_bytes": alias_chip,
               "peak_live_bytes_whole_mesh": totals["peak_bytes"]}

    flops = totals["flops"] / chips
    bytes_acc = totals["bytes"] / chips
    coll = dict(totals["collectives"],
                wire_bytes_per_chip_mean=totals["collectives"]["mesh_wire_bytes"] / chips)
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_acc / HBM_BW
    collective_s = coll["wire_bytes_per_chip_mean"] / NET_BW
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)), key=lambda kv: kv[1])[0]

    # MODEL_FLOPS: 6·N·D train, 2·N·D forward (prefill), 2·N·B decode
    n_params = cfg.n_active_params() if cfg.moe else cfg.n_params()
    if shape.kind == "train":
        model_flops = 6 * n_params * B * shape.seq_len
    elif shape.kind == "prefill":
        model_flops = 2 * n_params * B * shape.seq_len
    else:
        model_flops = 2 * n_params * B
    model_flops_per_chip = model_flops / chips
    useful_ratio = model_flops_per_chip / flops if flops else 0.0

    return {
        "arch": arch, "shape": shape_name, "mesh": _mesh_tag(multi_pod),
        "status": "ok", "chips": chips, "lower_s": round(lower_s, 1),
        "memory_analysis": mem_rec,
        "hlo_model": {"flops": flops, "bytes": bytes_acc},
        "collectives": coll,
        "kernels": totals["kernels"],
        "mesh_totals": {k: totals[k] for k in ("flops", "matmul_flops", "bytes")},
        "roofline": {
            "compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s, "dominant": dominant,
            "model_flops_total": model_flops,
            "model_flops_per_chip": model_flops_per_chip,
            "useful_flop_ratio": useful_ratio,
        },
        "method": METHOD,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: pathlib.Path,
             overrides: dict | None = None) -> dict:
    rec = lower_cell(arch, shape_name, multi_pod, overrides)
    if overrides:
        rec["overrides"] = overrides
    out = out_dir / _mesh_tag(multi_pod) / f"{arch}__{shape_name}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=2))
    return rec


def summary(rec: dict) -> str:
    """The line ``main`` prints for one cell."""
    extra = ""
    if rec["status"] == "ok":
        r = rec["roofline"]
        extra = (f" meta run={rec['lower_s']}s dominant={r['dominant']}"
                 f" terms=({r['compute_s']:.4f},{r['memory_s']:.4f},"
                 f"{r['collective_s']:.4f})s useful={r['useful_flop_ratio']:.2f}")
    return f"[{rec['mesh']}] {rec['arch']} × {rec['shape']}: {rec['status']}{extra}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="ArchConfig override, e.g. --set attn_impl=flash")
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)
    meshes = [False, True] if args.mesh == "both" else [args.mesh == "multipod"]
    overrides = dict(kv.split("=", 1) for kv in args.set) or None

    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        for mp in meshes:
            print(summary(run_cell(args.arch, args.shape, mp, out_dir, overrides)),
                  flush=True)
        return 0

    # --all: one fresh subprocess per cell, as the reference runs them
    from repro_torch.configs import ALL_ARCHS
    from repro_torch.models.config import SHAPES

    src = str(pathlib.Path(__file__).resolve().parents[2])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p)}
    failures = []
    for mp in meshes:
        for arch in ALL_ARCHS:
            for shape_name in SHAPES:
                dest = out_dir / _mesh_tag(mp) / f"{arch}__{shape_name}.json"
                if args.skip_done and dest.exists():
                    try:
                        if json.loads(dest.read_text()).get("status") in ("ok", "skipped"):
                            continue
                    except (OSError, ValueError):
                        pass
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape_name,
                       "--mesh", _mesh_tag(mp), "--out", str(out_dir)]
                t0 = time.time()
                r = subprocess.run(cmd, capture_output=True, text=True, env=env)
                sys.stdout.write(r.stdout)
                if r.returncode != 0:
                    failures.append((arch, shape_name, _mesh_tag(mp)))
                    dest.parent.mkdir(parents=True, exist_ok=True)
                    dest.write_text(json.dumps({
                        "arch": arch, "shape": shape_name, "mesh": _mesh_tag(mp),
                        "status": "error", "stderr": r.stderr[-4000:],
                        "elapsed_s": round(time.time() - t0, 1)}, indent=2))
                    sys.stdout.write(f"[{_mesh_tag(mp)}] {arch} × {shape_name}: ERROR\n")
                sys.stdout.flush()
    if failures:
        print(f"{len(failures)} failures: {failures}")
        return 1
    print("all cells ok")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
