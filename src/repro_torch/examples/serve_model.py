"""End-to-end serving on the port: batched requests through prefill
and greedy decode (``launch/serve.py``'s ``generate``).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_model \\
          [--arch paper-lm] [--tokens 32] [--device cpu]
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch import serve
from repro_torch.models.registry import get_api


def main(argv=None, model=None) -> int:
    """``model``: the weights to serve (default: seeded random ones from
    the port's init, seed 0)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="paper-lm")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (not reduced) config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    print(f"serving {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"({cfg.n_params()/1e6:.1f}M params)")
    if model is None:
        model = get_api(cfg).init(cfg, torch.Generator(device=device).manual_seed(0))
    batch = serve.make_batch(cfg, args.batch, args.prompt,
                             np.random.default_rng(0), device)
    out = serve.generate(cfg, model, batch, args.tokens)
    t_prefill, t_decode = out["prefill_s"], out["decode_s"]
    print(f"prefill: {args.batch}×{args.prompt} tokens in {t_prefill*1e3:.1f}ms "
          f"({args.batch*args.prompt/t_prefill:.0f} tok/s)")
    print(f"decode:  {args.tokens-1} steps × batch {args.batch} in "
          f"{t_decode*1e3:.1f}ms ({args.batch*(args.tokens-1)/t_decode:.0f} tok/s)")
    print(f"sample continuation (request 0): "
          f"{out['tokens'][0, :16].cpu().tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
