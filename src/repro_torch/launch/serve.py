"""Serving launcher (port of ``repro.launch.serve``): a batch of requests
through prefill and greedy decode on one device, with the prefill time,
the decode time and tokens/s, and request 0's continuation.

    python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        [--batch 8 --prompt 64 --new-tokens 32 --reduced --device cpu]

The device is the CUDA card unless ``--device`` names another; without a
card the default raises. Off the card a config above 5e8 parameters is
reduced, as the reference reduces it off a TPU. The attention core is
the config's (``attn_impl``, "blocked" as in the reference); the flash
kernels serve through :func:`generate` with a flash config. Weights are seeded random
(``torch.Generator``, seed 0), the prompts drawn by numpy (seed 0). The
cache is deep enough for the prompt (with vlm's patch prefix,
``registry.prefill_cache_len``) and every new token.

``--local-devices N`` serves on a mesh of N shards of the one device, as
``launch/train.py`` builds it (data N // mp x model mp, mp = 2 when N is
even and above 1): prefill and decode run inside ``sharding_ctx``, so an
MoE layer is expert-parallel over the model ranks and a config with
``decode_cache_update="shardmap"`` splits the cache's sequence over them
(``models/sharding.py``); N >= 512 serves on the pod mesh (data 16 x
model 16), as the reference's launcher does. Every shard holds every
weight.

Under ``torchrun`` (``WORLD_SIZE`` > 1) the processes are the ranks of a
rank mesh by the same rule (``launch/mesh.py`` ``rank_launcher_mesh``:
NCCL, one rank a card, or gloo with ``--device cpu``), the weights are
placed (``sharding.place_params``: each rank keeps its shard of every
weight the rule table shards), each data rank serves its rows of the
batch (the batch must split over the data ranks), and rank 0 reports::

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch qwen3-1.7b --batch 8
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (RankMesh, close_rank_mesh, launcher_mesh,
                                     rank_launcher_mesh, reporter)
from repro_torch.models import registry
from repro_torch.models.config import ArchConfig
from repro_torch.models.sharding import place_params, sharding_ctx
from repro_torch.models.steps import make_decode_step, make_prefill_step


def make_batch(cfg: ArchConfig, batch: int, prompt: int,
               rng: np.random.Generator, device) -> dict:
    """Prompt tokens (B, prompt) int32, with the stub frontends' inputs:
    frames (B, enc_len, d) for encdec, patches (B, P, patch_dim) for vlm,
    both bf16."""
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (batch, prompt)).astype(np.int32))}
    if cfg.family == "encdec":
        out["frames"] = torch.from_numpy(rng.normal(
            size=(batch, cfg.enc_len, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        out["patches"] = torch.from_numpy(rng.normal(
            size=(batch, cfg.num_patches, cfg.patch_dim)).astype(np.float32))
    return {k: v.to(device, torch.bfloat16 if v.is_floating_point() else None)
            for k, v in out.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg: ArchConfig, model, batch: dict, new_tokens: int) -> dict:
    """Prefill, then ``new_tokens - 1`` greedy decode steps (the prefill
    gives the first new token). Returns the (B, new_tokens) int32 tokens
    and the prefill and decode seconds (host clock, device synchronised)."""
    api = registry.get_api(cfg)
    max_len = registry.prefill_cache_len(cfg, batch["tokens"].shape[1]) \
        + new_tokens
    prefill = make_prefill_step(cfg, api, max_len=max_len)
    decode = make_decode_step(cfg, api)
    device = batch["tokens"].device
    _sync(device)
    t0 = time.perf_counter()
    cache, tok = prefill(model, batch)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    toks = [tok]
    t0 = time.perf_counter()
    for _ in range(new_tokens - 1):
        cache, tok = decode(model, cache, tok)
        toks.append(tok)
    _sync(device)
    return {"tokens": torch.cat(toks, dim=1), "prefill_s": prefill_s,
            "decode_s": time.perf_counter() - t0, "cache": cache}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="paper-lm")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--local-devices", type=int, default=0,
                    help="a mesh of N shards of the one device")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    ranks = int(os.environ.get("WORLD_SIZE", "1"))
    if ranks > 1:
        if args.local_devices:
            ap.error("under torchrun the ranks are the mesh: no --local-devices")
        mesh = rank_launcher_mesh(ranks, args.device)
    else:
        mesh = launcher_mesh(args.local_devices, args.device) \
            if args.local_devices else None
    try:
        return _serve(args, mesh)
    finally:
        if isinstance(mesh, RankMesh):
            close_rank_mesh()


def _serve(args, mesh) -> int:
    ranked = isinstance(mesh, RankMesh)
    say = reporter(mesh)
    device = resolve_device(args.device) if mesh is None else mesh.device
    cfg = get_config(args.arch)
    if args.reduced or (device.type != "cuda" and cfg.n_params() > 5e8):
        cfg = cfg.reduced()
        say(f"[{device.type}] using reduced config {cfg.name}")
    api = registry.get_api(cfg)
    model = api.init(cfg, torch.Generator(device=device).manual_seed(0))
    batch = make_batch(cfg, args.batch, args.prompt,
                       np.random.default_rng(0), device)
    say(f"device: {device}; {cfg.name}, attn_impl={cfg.attn_impl}")
    if ranked:
        n = mesh.shape["data"]
        if args.batch % n:
            raise ValueError(f"a batch of {args.batch} does not split over "
                             f"{n} data ranks")
        place_params(model, cfg, mesh)
        batch = {k: v.chunk(n)[mesh.coords["data"]] for k, v in batch.items()}
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            say(f"mesh: {mesh.shape}" + (f" ({mesh.backend} ranks, weights "
                                         "placed)" if ranked else ""))
            stack.enter_context(sharding_ctx(mesh))
        out = generate(cfg, model, batch, args.new_tokens)
    say(f"prefill {args.batch}×{args.prompt}: "
        f"{out['prefill_s'] * 1e3:.1f}ms")
    n = args.new_tokens - 1
    rate = args.batch * n / out["decode_s"] if out["decode_s"] > 0 else 0.0
    say(f"decode {n} steps: {out['decode_s'] * 1e3:.1f}ms ({rate:.0f} tok/s)")
    say("request 0 continuation:", out["tokens"][0, :16].cpu().tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
