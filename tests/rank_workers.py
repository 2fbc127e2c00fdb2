"""Rank bodies for tests/test_torch_ranks.py, and the harness that runs
them: N ``gloo`` ranks on the CPU spawned by ``torch.multiprocessing``.

This module imports torch and the port only (never jax or the reference),
so each spawned rank starts light; the test module computes the
reference's numbers in the parent and hands the ranks numpy inputs.
Every rank writes its result with ``torch.save`` into the run's
directory; :func:`run_ranks` returns them in rank order.
"""
from __future__ import annotations

import contextlib
import pathlib
import socket
import tempfile
import time

import numpy as np
import torch
import torch.multiprocessing as mp


def free_port() -> int:
    """A port on 127.0.0.1 that was free a moment ago (bound to 0, then
    released): every test rendezvous on its own, as xdist runs several
    test files at once."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, body: str, out: str,
               payload) -> None:
    torch.set_num_threads(1)  # N ranks share the host's cores
    from repro_torch.launch.mesh import close_rank_mesh

    try:
        result = globals()[body](rank, world, f"tcp://127.0.0.1:{port}",
                                 payload)
        torch.save(result, pathlib.Path(out) / f"rank{rank}.pt")
    finally:
        close_rank_mesh()


def run_ranks(body: str, world: int, payload, timeout: float) -> list:
    """Run ``body(rank, world, init_method, payload)`` (a function of this
    module) on ``world`` gloo ranks, one spawned process each, and return
    their results in rank order. A rank that raises fails the call with
    its traceback (the first to fail; the others are killed); ranks not
    done after ``timeout`` seconds are killed and ``TimeoutError`` is
    raised, so a hung rendezvous fails the test instead of stalling the
    suite."""
    with tempfile.TemporaryDirectory(prefix="ranks_") as out:
        ctx = mp.spawn(_rank_main, args=(world, free_port(), body, out, payload),
                       nprocs=world, join=False)
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{body} on {world} ranks: not done "
                                       f"after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)
        alive = [p.pid for p in ctx.processes if p.is_alive()]
        if alive:
            raise RuntimeError(f"{body}: ranks {alive} still alive")
        return [torch.load(pathlib.Path(out) / f"rank{r}.pt", weights_only=False)
                for r in range(world)]


# -- helpers the bodies share ------------------------------------------------------


def _mesh(data: int, model: int, rank: int, world: int, init: str):
    from repro_torch.launch.mesh import init_rank_mesh

    return init_rank_mesh(data, model, "cpu", rank=rank, world_size=world,
                          init_method=init)


@contextlib.contextmanager
def _float32(on: bool):
    """Compute in float32 (the reference's and the port's layers) when
    ``on``."""
    from repro_torch.models import layers

    prev = layers.COMPUTE_DTYPE
    if on:
        layers.COMPUTE_DTYPE = torch.float32
    try:
        yield
    finally:
        layers.COMPUTE_DTYPE = prev


def _placed_model(cfg, params: dict, mesh):
    from repro_torch.models import convert, sharding

    model = convert.from_jax(params, cfg, device="cpu")
    return sharding.place_params(model, cfg, mesh)


def _captured_grads(steps_mod, grads: dict):
    """Wrap ``steps.adamw_update`` to copy every gradient before the
    update consumes it."""
    real = steps_mod.adamw_update

    def capture(model, *a, **kw):
        grads.update({n: p.grad.detach().clone()
                      for n, p in model.named_parameters()})
        return real(model, *a, **kw)

    steps_mod.adamw_update = capture


# -- rank bodies -----------------------------------------------------------------------


def seam(rank, world, init, payload):
    """Each of the seam's collectives on this rank's part of the payload's
    partials (float and int), over a data 2 x model 2 mesh's axes and
    every rank."""
    from repro_torch.engine import distributed as D
    from repro_torch.runtime import costs

    mesh = _mesh(2, 2, rank, world, init)
    out = {}
    booked = []

    class Counter:
        def opaque(self):
            return contextlib.nullcontext()

        def collective(self, kind, parts, read, received, result):
            booked.append((kind, parts, read, received))

    costs.COUNTERS.append(Counter())
    try:
        for axis in ("data", "model"):
            g = mesh.group(axis)
            idx = mesh.coords[axis]
            for dt in ("float32", "int32"):
                part = torch.from_numpy(payload[dt][rank])
                out[(axis, dt, "psum")] = D.psum(part, group=g)
                out[(axis, dt, "pmax")] = D.pmax(part, group=g)
                out[(axis, dt, "pmin")] = D.pmin(part, group=g)
                out[(axis, dt, "all_gather")] = D.all_gather(part, group=g)
                out[(axis, dt, "all_gather1")] = D.all_gather(part, group=g, dim=1)
                out[(axis, dt, "all_to_all")] = D.all_to_all(part[:2], group=g)
                out[(axis, dt, "reduce_scatter")] = D.reduce_scatter(
                    part[:4], g)
            out[(axis, "float32", "pmean")] = D.pmean(
                torch.from_numpy(payload["float32"][rank]), group=g)
            out[(axis, "index")] = idx
        out[("all", "psum")] = D.psum(torch.from_numpy(payload["float32"][rank]),
                                      group=torch.distributed.group.WORLD)
    finally:
        costs.COUNTERS.pop()
    out["booked"] = booked
    out["coords"] = dict(mesh.coords)
    return out


def placement(rank, world, init, payload):
    """``convert.from_jax`` of the reference's numpy weights, then
    ``place_params``: this rank's block of every parameter, the
    placements, and the parameter bytes held."""
    from repro_torch.models import sharding

    cfg, params, (data, model) = payload
    mesh = _mesh(data, model, rank, world, init)
    m = _placed_model(cfg, params, mesh)
    return {"local": {n: p.detach().clone() for n, p in m.named_parameters()},
            "placements": sharding.placements(m),
            "coords": dict(mesh.coords),
            "bytes": sum(p.numel() * p.element_size() for p in m.parameters())}


def _train_step(cfg, params, batch: dict, mesh, f32: bool) -> dict:
    from repro_torch.models import optim, sharding, steps

    with _float32(f32):
        m = _placed_model(cfg, params, mesh)
        state = optim.init_opt_state(m)
        grads: dict = {}
        _captured_grads(steps, grads)
        step = steps.make_train_step(cfg, optim.OptimConfig(total_steps=10))
        with sharding.sharding_ctx(mesh):
            _, _, met = step(m, state, batch)
    return {"metrics": {k: float(v) for k, v in met.items()}, "grads": grads,
            "params": {n: p.detach().clone() for n, p in m.named_parameters()},
            "placements": sharding.placements(m)}


def train_step(rank, world, init, payload):
    """One train step (``steps.make_train_step``) of the placed model on
    this data rank's rows, inside the rank mesh's sharding context: the
    metrics and this rank's gradient blocks."""
    cfg, params, tokens, (data, model), f32 = payload
    mesh = _mesh(data, model, rank, world, init)
    return _train_step(cfg, params, {"tokens": torch.from_numpy(tokens)}, mesh,
                       f32)


def family_steps(rank, world, init, payload):
    """:func:`train_step` for each (config, weights, numpy batch) of the
    payload on one data 2 x model 2 mesh, in float32 compute; the
    batch's frames and patches in bf16, as the families take them."""
    mesh = _mesh(2, 2, rank, world, init)
    out = {}
    for cfg, params, nb in payload:
        batch = {k: torch.from_numpy(v) if k == "tokens"
                 else torch.from_numpy(v.astype(np.float32)).bfloat16()
                 for k, v in nb.items()}
        out[cfg.name] = _train_step(cfg, params, batch, mesh, True)
    return out


def pod_mesh(rank, world, init, payload):
    """A pod 2 x data 2 x model 2 mesh: this rank's coordinates, and a
    ``psum`` of the rank ids over each axis's group and over the
    data-axis tuple's."""
    from repro_torch.engine import distributed as D
    from repro_torch.launch.mesh import MeshAxes, init_rank_mesh

    mesh = init_rank_mesh(2, 2, "cpu", pod=2, rank=rank, world_size=world,
                          init_method=init)
    me = torch.tensor([rank])
    sums = {ax: int(D.psum(me, group=mesh.group(ax)))
            for ax in ("pod", "data", "model", ("pod", "data"))}
    axes = MeshAxes.for_mesh(mesh)
    return {"coords": dict(mesh.coords), "sums": sums, "axes": axes,
            "index": mesh.index(("pod", "data")), "size": mesh.size,
            "names": mesh.axis_names}


def clip(rank, world, init, payload):
    """``optim.clip_by_global_norm`` of this rank's blocks of the
    payload's whole gradients (one per parameter of the placed model),
    spread as the parameters are: the norm and the clipped blocks."""
    from repro_torch.models import optim, sharding

    cfg, params, grads, max_norm = payload
    mesh = _mesh(4, 2, rank, world, init)
    m = _placed_model(cfg, params, mesh)
    pls = sharding.placements(m)
    where = sharding.spread(m)
    names = [n for n, _ in m.named_parameters()]
    local = [sharding.local_slice(torch.from_numpy(grads[n]), pls[n].spec,
                                  mesh).clone() for n in names]
    with sharding.sharding_ctx(mesh):
        norm = optim.clip_by_global_norm(local, max_norm,
                                         [where[n] for n in names])
    return {"norm": float(norm), "clipped": dict(zip(names, local)),
            "spec": {n: pls[n].spec for n in names}}


def moe_layer(rank, world, init, payload):
    """tests/test_distributed.py:148's layer on data 2 x model 4: its
    weights placed (experts over model), ``moe_ffn`` on this data rank's
    rows of x."""
    from repro_torch.models import convert, moe, sharding

    cfg, tree, x = payload
    mesh = _mesh(2, 4, rank, world, init)
    layer = moe.init_moe(cfg, cfg.moe, torch.Generator().manual_seed(0))
    convert._load(layer, tree, "moe")
    sharding.place_params(layer, cfg, mesh)
    rows = np.split(x, 2)[mesh.coords["data"]]
    with sharding.sharding_ctx(mesh):
        y, aux = moe.moe_ffn(torch.from_numpy(rows), layer, cfg, cfg.moe)
    return {"y": y.detach(), "aux": float(aux.detach()), "coords": dict(mesh.coords),
            "experts": tuple(layer.experts.w1.shape)}


def smap_decode(rank, world, init, payload):
    """The shardmap decode on data 2 x model 2: this rank's rows of the
    reference's prefill cache (its batch rows, its sequence rows of every
    head), one decode step; then a prefill on the rank mesh, which lays
    its cache out the same way."""
    cfg, params, k, v, pos, new, toks, max_len, f32 = payload
    mesh = _mesh(2, 2, rank, world, init)
    with _float32(f32):
        return _smap_decode(cfg, params, k, v, pos, new, toks, max_len, mesh)


def _smap_decode(cfg, params, k, v, pos, new, toks, max_len, mesh):
    from repro_torch.models import sharding
    from repro_torch.models.registry import get_api

    m = _placed_model(cfg, params, mesh)
    api = get_api(cfg)
    d, r = mesh.coords["data"], mesh.coords["model"]
    B, S = k.shape[1], k.shape[2]
    b = slice(d * B // 2, (d + 1) * B // 2)
    s = slice(r * S // 2, (r + 1) * S // 2)

    def bf16(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)

    cache = {"k": bf16(k[:, b, s]), "v": bf16(v[:, b, s]),
             "pos": torch.tensor(pos, dtype=torch.int32)}
    with sharding.sharding_ctx(mesh):
        c2, logits = api.decode(m, cache, torch.from_numpy(new[b]), cfg)
        c3, first = api.prefill(m, {"tokens": torch.from_numpy(toks[b])}, cfg,
                                max_len)
    return {"logits": logits, "k": c2["k"].float(), "pos": int(c2["pos"]),
            "prefill_k": c3["k"].float(), "prefill_logits": first,
            "rows": (b.start, b.stop), "seq": (s.start, s.stop)}


def compressed(rank, world, init, payload):
    """``compressed_psum`` over data 8 x model 1: this rank's row of the
    gradients, a zero error state."""
    from repro_torch.runtime import compress

    mesh = _mesh(8, 1, rank, world, init)
    g = {k: torch.from_numpy(v[rank].copy()) for k, v in payload.items()}
    mean, err = compress.compressed_psum(g, compress.init_error_state(g),
                                         group=mesh.group("data"))
    return {"mean": mean, "err": err}


def elastic(rank, world, init, payload):
    """tests/test_distributed.py:172 on ranks: an (8, 8) weight saved from
    a data 4 x model 1 layout (this rank's (2, 8) block, a DTensor), then
    restored onto a data 2 x model 2 mesh of the same ranks."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.sharding import (NamedSharding, P, constrain,
                                             sharding_ctx)
    from repro_torch.runtime.checkpoint import CheckpointManager

    directory = payload
    mesh4 = _mesh(4, 1, rank, world, init)
    full = torch.arange(64.0).reshape(8, 8)
    sh4 = NamedSharding(mesh4, P("data", None))
    w = DTensor.from_local(full[2 * rank:2 * rank + 2].clone(),
                           mesh4.device_mesh, sh4.placements, run_check=False)
    cm = CheckpointManager(directory, async_save=False)
    cm.save(1, {"w": w})
    mesh22 = _mesh(2, 2, rank, world, init)
    sh = {"w": NamedSharding(mesh22, P("data", None))}
    step, t = cm.restore(None, {"w": w}, shardings=sh)
    # a DTensor activation under the context: constrain redistributes it
    with sharding_ctx(mesh22):
        moved = constrain(t["w"], None, "model")
    return {"step": step, "mesh": tuple(t["w"].device_mesh.shape),
            "names": t["w"].device_mesh.mesh_dim_names,
            "local": t["w"].to_local().clone(), "whole": t["w"].full_tensor(),
            "coords": dict(mesh22.coords), "placements": str(t["w"].placements),
            "moved": moved.to_local().clone(), "moved_placements":
            str(moved.placements)}
