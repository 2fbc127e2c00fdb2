"""Training launcher (port of ``repro.launch.train``): a model's train steps
through the fault-tolerant loop with checkpoints, on one device.

    python -m repro_torch.launch.train --arch qwen3-1.7b \\
        [--steps 100 --global-batch 8 --seq 128 --ckpt-dir DIR \\
         --ckpt-every 25 --resume --reduced --device cpu]

The device is the CUDA card unless ``--device`` names another; without a
card the default raises. Off the card a config above 5e8 parameters is
reduced, as the reference reduces it off a TPU. Weights are seeded random
(``torch.Generator``, seed 0); step i's batch is drawn by
``np.random.default_rng(777 + i)`` (tokens (B, S) int32, with frames or
patches in bf16 for the encdec and vlm families), so a rollback replays
the same data. Checkpoints (the reference's format, ``runtime/checkpoint.py``)
go to ``--ckpt-dir``, by default ``repro_torch_ckpt`` under the temporary
directory (``TMPDIR``); ``--resume`` restores the latest one in place.
The attention core is the config's (``attn_impl``, "blocked" as in the
reference): :func:`run` takes any config, a flash one included.

``--local-devices N`` trains on a mesh of N shards of the one device
(``make_local_mesh(data=N // mp, model=mp)``, mp = 2 when N is even and
above 1, as the reference builds it from its N forced host devices):
the loop runs inside ``sharding_ctx``, so each step is data-parallel over
the data shards and an MoE layer expert-parallel over the model ranks
(``models/sharding.py``), and ``--resume`` restores the parameters with
their shardings. Every shard holds every weight. N >= 512 asks for the
pod mesh (data 16 x model 16), and ``--multi-pod`` for the multi-pod one
(pod 2 x data 16 x model 16: 32 data shards), as the reference's launcher
builds them (``launch/mesh.py`` ``launcher_mesh``).

Under ``torchrun`` (``WORLD_SIZE`` > 1 in the environment) each process
is one rank of a rank mesh over the same rule, data N // mp x model mp
(``launch/mesh.py`` ``init_rank_mesh``; NCCL, one rank a card, or gloo
with ``--device cpu``), and ``sharding.place_params`` keeps on each rank
only its shard of every weight the rule table shards: FSDP over data, TP
and experts over model, every family. Each rank draws the same seeded weights and batches and takes its
data rows; rank 0 prints and writes the checkpoints (whole tensors, the
reference's format), and a resume gives each rank its shards back::

    torchrun --standalone --nproc-per-node 8 -m repro_torch.launch.train \
        --arch qwen3-1.7b --steps 100
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch import serve
from repro_torch.launch.mesh import (Mesh, MeshAxes, RankMesh, close_rank_mesh,
                                     launcher_mesh, rank_launcher_mesh, reporter)
from repro_torch.models import convert, sharding
from repro_torch.models.config import ArchConfig
from repro_torch.models.optim import OptimConfig, init_opt_state
from repro_torch.models.sharding import param_shardings, sharding_ctx
from repro_torch.models.steps import init_train_state, make_train_step
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.fault import (FailureInjector, FaultTolerantLoop,
                                       TrainLoopConfig)


class ModelState:
    """How :class:`FaultTolerantLoop` checkpoints the port's in-place train
    steps (``steps.make_train_step``): a checkpoint holds
    ``convert.train_state_tree`` (the reference's stacked train state, a
    host snapshot), and a rollback restores it on the host and writes it
    back into the same model and AdamW state, every leaf (the int32 step
    too: the schedule reads it). With a ``mesh`` the parameters are
    restored with their shardings (onto the mesh's device), the rest on
    the host, as the reference's launcher restores them. On a rank mesh a
    checkpoint holds the whole state (every rank gathers it, rank 0
    writes it) and a rollback reads it whole and keeps each rank's
    blocks."""

    def __init__(self, cfg: ArchConfig, mesh: Mesh | RankMesh | None = None):
        self.cfg = cfg
        self.mesh = mesh

    def tree(self, model, opt_state):
        if isinstance(self.mesh, RankMesh):
            params, opt_state = sharding.whole_state(model, opt_state, self.mesh)
            return convert.train_state_tree(model, opt_state, self.cfg,
                                            params=params)
        return convert.train_state_tree(model, opt_state, self.cfg)

    def restore(self, ckpt: CheckpointManager, model, opt_state):
        if isinstance(self.mesh, RankMesh):
            params, whole = sharding.whole_like(model, opt_state)
            like = convert.train_state_like(model, whole, self.cfg, params=params)
            step, tree = ckpt.restore(None, like, device="cpu")
            convert.load_train_state(tree, model, whole, self.cfg, params=params)
            sharding.load_blocks(model, opt_state, params, whole, self.mesh)
            return step, model, opt_state
        like = convert.train_state_like(model, opt_state, self.cfg)
        shardings = None if self.mesh is None else {
            "params": param_shardings(like["params"], self.mesh,
                                      MeshAxes.for_mesh(self.mesh)),
            "opt": None}
        step, tree = ckpt.restore(None, like, device="cpu", shardings=shardings)
        convert.load_train_state(tree, model, opt_state, self.cfg)
        return step, model, opt_state


def data_factory(cfg: ArchConfig, batch: int, seq: int, device):
    """``factory(start)``: an endless iterator of step start's batch, then
    start + 1's, ..., each drawn by ``default_rng(777 + i)``."""
    def factory(start: int):
        def gen():
            i = start
            while True:
                yield serve.make_batch(cfg, batch, seq,
                                       np.random.default_rng(777 + i), device)
                i += 1
        return gen()
    return factory


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


def run(cfg: ArchConfig, steps: int, global_batch: int, seq: int,
        ckpt_dir, ckpt_every: int = 25, resume: bool = False,
        injector: FailureInjector | None = None, device=None,
        mesh: Mesh | None = None) -> dict:
    """Train ``cfg`` for ``steps`` steps through the fault-tolerant loop
    (``OptimConfig(total_steps=steps)``, ``CheckpointManager(ckpt_dir,
    keep=3)``, a checkpoint every ``ckpt_every`` steps, failures from
    ``injector``) from seeded random weights (seed 0) on ``device``
    (``None``: the card); ``resume`` first restores the latest checkpoint
    into them. With a ``mesh`` the loop runs inside its sharding context;
    on a rank mesh the weights are placed first. Prints (rank 0 alone on a
    rank mesh) the log every 10% of the run and the events;
    returns the model, the AdamW state, the log, the events, the step it
    started at, the loop and the checkpoint manager."""
    dev = resolve_device(device) if mesh is None else mesh.device
    model, opt = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0))
    say = reporter(mesh)
    if isinstance(mesh, RankMesh):
        sharding.place_params(model, cfg, mesh)
        opt = init_opt_state(model)
    state = ModelState(cfg, mesh)
    ckpt = CheckpointManager(ckpt_dir, keep=3)
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            stack.enter_context(sharding_ctx(mesh))
        start = 0
        if resume and ckpt.latest_step() is not None:
            start, model, opt = state.restore(ckpt, model, opt)
            say(f"resumed at step {start}", flush=True)
        step_fn = make_train_step(cfg, OptimConfig(total_steps=steps))
        loop = FaultTolerantLoop(step_fn, ckpt, TrainLoopConfig(ckpt_every=ckpt_every),
                                 injector, state)
        model, opt, log = loop.run(model, opt,
                                   data_factory(cfg, global_batch, seq, dev),
                                   steps, start_step=start)
    for s, l in log[:: max(len(log) // 10, 1)]:
        say(f"step {s:5d}  loss {l:.4f}", flush=True)
    final = f"final loss {log[-1][1]:.4f}" if log else f"no step left after {start}"
    say(f"done; {final}; events: {loop.events or 'none'}", flush=True)
    return {"model": model, "opt_state": opt, "log": log, "events": loop.events,
            "start": start, "loop": loop, "ckpt": ckpt}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="paper-lm")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--local-devices", type=int, default=0,
                    help="a mesh of N shards of the one device")
    ap.add_argument("--ckpt-dir", default=default_ckpt_dir())
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    mesh = None
    ranks = int(os.environ.get("WORLD_SIZE", "1"))
    if ranks > 1:
        if args.multi_pod or args.local_devices:
            ap.error("under torchrun the ranks are the mesh: no --local-devices "
                     "or --multi-pod")
        mesh = rank_launcher_mesh(ranks, args.device)
    elif args.multi_pod or args.local_devices:
        mesh = launcher_mesh(args.local_devices, args.device, args.multi_pod)
    try:
        device = resolve_device(args.device) if mesh is None else mesh.device
        say = reporter(mesh)
        cfg = get_config(args.arch)
        if args.reduced or (device.type != "cuda" and cfg.n_params() > 5e8):
            cfg = cfg.reduced()
            say(f"[{device.type}] using reduced config {cfg.name}")
        where = "" if mesh is None else f"; mesh: {mesh.shape} ({mesh.size} shards)"
        if isinstance(mesh, RankMesh):
            where = (f"; rank mesh: data {mesh.shape['data']} x model "
                     f"{mesh.shape['model']} ({mesh.backend}, weights placed)")
        say(f"device: {device}{where}")
        run(cfg, args.steps, args.global_batch, args.seq, args.ckpt_dir,
            args.ckpt_every, args.resume, device=device, mesh=mesh)
    finally:
        if isinstance(mesh, RankMesh):
            close_rank_mesh()
    return 0


if __name__ == "__main__":
    sys.exit(main())
