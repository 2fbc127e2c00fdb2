"""Training with the full substrate on the port: fault-tolerant
loop, checkpoint / restart, NaN rollback, deterministic data order — a
scaled-down run of what ``launch/train.py`` does.

The injector's "nan" poisons a batch's floating leaves only, as the
reference's does; an LM batch holds int32 tokens alone, so that failure
changes nothing and records no event (the reference's behaviour too).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm \\
          [--steps 60] [--resume] [--device cpu]
"""
import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.train import ModelState
from repro_torch.models.optim import OptimConfig, init_opt_state
from repro_torch.models.registry import get_api
from repro_torch.models.steps import make_train_step
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.fault import (FailureInjector, FaultTolerantLoop,
                                       TrainLoopConfig)


def main(argv=None, model=None) -> int:
    """``model``: the initial weights (default: seeded random ones from
    the port's init, seed 0)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="paper-lm")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-failures", action="store_true", default=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    print(f"training {cfg.name}: {cfg.n_params()/1e6:.1f}M params, "
          f"{args.steps} steps of {args.batch}×{args.seq} tokens")

    if model is None:
        model = get_api(cfg).init(cfg, torch.Generator(device=device).manual_seed(0))
    opt = init_opt_state(model)
    step_fn = make_train_step(
        cfg, OptimConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps))

    def data_factory(start_step):
        def gen():
            i = start_step
            while True:  # deterministic per-step batches => exact rollback
                rng = np.random.default_rng(1234 + i)
                yield {"tokens": torch.from_numpy(rng.integers(
                    0, cfg.vocab, (args.batch, args.seq)).astype(np.int32)).to(device)}
                i += 1
        return gen()

    state = ModelState(cfg)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        start, model, opt = state.restore(ckpt, model, opt)
        print(f"resumed from checkpoint step {start}")

    injector = FailureInjector({args.steps // 3: "node",
                                2 * args.steps // 3: "nan"}
                               if args.inject_failures else {})
    loop = FaultTolerantLoop(step_fn, ckpt, TrainLoopConfig(ckpt_every=10),
                             injector, state)
    model, opt, log = loop.run(model, opt, data_factory, args.steps,
                               start_step=start)
    for s, l in log[:: max(len(log) // 8, 1)]:
        print(f"  step {s:4d}  loss {l:.4f}")
    print(f"final loss {log[-1][1]:.4f}; recoveries: {loop.events or 'none'}")
    print(f"checkpoints kept: {ckpt.steps()} under {args.ckpt_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
