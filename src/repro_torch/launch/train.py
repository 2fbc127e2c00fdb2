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

The reference's pod mesh (``--multi-pod``) and forced host devices
(``--local-devices``) have no counterpart on one card: they raise, naming
ROADMAP A9b and A11; ``models/sharding.py`` is not ported.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch import serve
from repro_torch.models import convert
from repro_torch.models.config import ArchConfig
from repro_torch.models.optim import OptimConfig
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
    too: the schedule reads it)."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg

    def tree(self, model, opt_state):
        return convert.train_state_tree(model, opt_state, self.cfg)

    def restore(self, ckpt: CheckpointManager, model, opt_state):
        like = convert.train_state_like(model, opt_state, self.cfg)
        step, tree = ckpt.restore(None, like, device="cpu")
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
        injector: FailureInjector | None = None, device=None) -> dict:
    """Train ``cfg`` for ``steps`` steps through the fault-tolerant loop
    (``OptimConfig(total_steps=steps)``, ``CheckpointManager(ckpt_dir,
    keep=3)``, a checkpoint every ``ckpt_every`` steps, failures from
    ``injector``) from seeded random weights (seed 0) on ``device``
    (``None``: the card); ``resume`` first restores the latest checkpoint
    into them. Prints the log every 10% of the run and the events;
    returns the model, the AdamW state, the log, the events, the step it
    started at, the loop and the checkpoint manager."""
    dev = resolve_device(device)
    model, opt = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0))
    state = ModelState(cfg)
    ckpt = CheckpointManager(ckpt_dir, keep=3)
    start = 0
    if resume and ckpt.latest_step() is not None:
        start, model, opt = state.restore(ckpt, model, opt)
        print(f"resumed at step {start}", flush=True)
    step_fn = make_train_step(cfg, OptimConfig(total_steps=steps))
    loop = FaultTolerantLoop(step_fn, ckpt, TrainLoopConfig(ckpt_every=ckpt_every),
                             injector, state)
    model, opt, log = loop.run(model, opt,
                               data_factory(cfg, global_batch, seq, dev),
                               steps, start_step=start)
    for s, l in log[:: max(len(log) // 10, 1)]:
        print(f"step {s:5d}  loss {l:.4f}", flush=True)
    final = f"final loss {log[-1][1]:.4f}" if log else f"no step left after {start}"
    print(f"done; {final}; events: {loop.events or 'none'}", flush=True)
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
                    help="force N host devices (the reference's CPU dry runs)")
    ap.add_argument("--ckpt-dir", default=default_ckpt_dir())
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.multi_pod or args.local_devices:
        raise NotImplementedError(
            "--multi-pod and --local-devices shard training over a mesh of "
            "devices: ROADMAP A9b (several cards) and A11 (the pod mesh)")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced or (device.type != "cuda" and cfg.n_params() > 5e8):
        cfg = cfg.reduced()
        print(f"[{device.type}] using reduced config {cfg.name}")
    print(f"device: {device} (one device; models/sharding.py waits for A9b)")
    run(cfg, args.steps, args.global_batch, args.seq, args.ckpt_dir,
        args.ckpt_every, args.resume, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
