"""Rank bodies for tests/test_torch_ranks.py, tests/test_torch_ranks_paths.py
and tests/test_torch_rank_engine.py, and the harness that runs them: N
``gloo`` ranks on the CPU spawned by ``torch.multiprocessing``.

This module imports torch and the port only (never jax or the reference),
so each spawned rank starts light; the test module computes the
reference's numbers in the parent and hands the ranks numpy inputs.
Every rank writes its result with ``torch.save`` into the run's
directory; :func:`run_ranks` returns them in rank order. The ranks meet
through a ``FileStore`` in that directory (``file://<dir>/store``): no
port is looked for, so runs that xdist starts side by side cannot meet
on one.
"""
from __future__ import annotations

import contextlib
import pathlib
import tempfile
import time

import numpy as np
import torch
import torch.multiprocessing as mp


def _rank_main(rank: int, world: int, init: str, body: str, out: str,
               payload) -> None:
    torch.set_num_threads(1)  # N ranks share the host's cores
    from repro_torch.launch.mesh import close_rank_mesh

    try:
        result = globals()[body](rank, world, init, payload)
        torch.save(result, pathlib.Path(out) / f"rank{rank}.pt")
        # every rank done before any tears its connections down
        torch.distributed.barrier()
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
        init = "file://" + str(pathlib.Path(out) / "store")
        ctx = mp.spawn(_rank_main, args=(world, init, body, out, payload),
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


@contextlib.contextmanager
def _captured_grads(steps_mod, grads: dict):
    """``steps.adamw_update`` wrapped to copy every gradient before the
    update consumes it, inside the block."""
    real = steps_mod.adamw_update

    def capture(model, *a, **kw):
        grads.update({n: p.grad.detach().clone()
                      for n, p in model.named_parameters()})
        return real(model, *a, **kw)

    steps_mod.adamw_update = capture
    try:
        yield grads
    finally:
        steps_mod.adamw_update = real


@contextlib.contextmanager
def _patched(module, name: str, value):
    """``module.name`` set to ``value`` inside the block."""
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, real)


def _tensors(nb: dict) -> dict:
    """A numpy batch as the families take it: tokens int32, frames and
    patches in bf16."""
    return {k: torch.from_numpy(v) if k == "tokens"
            else torch.from_numpy(v.astype(np.float32)).bfloat16()
            for k, v in nb.items()}


def _rows(t: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """This data rank's block of rows of ``t`` along ``dim``."""
    return t.chunk(mesh.shape["data"], dim=dim)[mesh.coords["data"]]


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


def _blocks(cfg, params, mesh) -> dict:
    """``convert.from_jax`` of the reference's numpy weights, then
    ``place_params``: this rank's block of every parameter, the
    placements, and the parameter bytes held."""
    from repro_torch.models import sharding

    m = _placed_model(cfg, params, mesh)
    return {"local": {n: p.detach().clone() for n, p in m.named_parameters()},
            "placements": sharding.placements(m),
            "coords": dict(mesh.coords),
            "bytes": sum(p.numel() * p.element_size() for p in m.parameters())}


def placement(rank, world, init, payload):
    """:func:`_blocks` of the payload's (config, weights) on a mesh of its
    extents."""
    cfg, params, (data, model) = payload
    return _blocks(cfg, params, _mesh(data, model, rank, world, init))


def _train_step(cfg, params, batch: dict, mesh, f32: bool) -> dict:
    from repro_torch.models import optim, sharding, steps

    with _float32(f32), _captured_grads(steps, {}) as grads:
        m = _placed_model(cfg, params, mesh)
        state = optim.init_opt_state(m)
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


def placements(rank, world, init, payload):
    """:func:`_blocks` of each (config, weights) of the payload on one
    mesh of its extents: ``{config name: result}``."""
    families, (data, model) = payload
    mesh = _mesh(data, model, rank, world, init)
    return {cfg.name: _blocks(cfg, params, mesh) for cfg, params in families}


def _serve_steps(cfg, params, nb: dict, new: np.ndarray, max_len: int,
                 mesh) -> dict:
    """The placed model in float32 compute on this data rank's rows: a
    prefill (cache depth ``max_len``), then one decode step per row of
    ``new`` ((steps, B, 1) tokens); each call's logits and the cache after
    the prefill and after the last step, in float32."""
    from repro_torch.models import sharding
    from repro_torch.models.registry import get_api

    def snap(c):
        return {k: v.float().clone() for k, v in c.items()}

    with _float32(True):
        m = _placed_model(cfg, params, mesh)
        api = get_api(cfg)
        batch = {k: _rows(v, mesh) for k, v in _tensors(nb).items()}
        toks = _rows(torch.from_numpy(new), mesh, dim=1)
        with sharding.sharding_ctx(mesh), torch.no_grad():
            c, lg = api.prefill(m, batch, cfg, max_len)
            logits, caches = [lg], [snap(c)]
            for t in toks:
                c, lg = api.decode(m, c, t, cfg)
                logits.append(lg)
            caches.append(snap(c))
    return {"logits": logits, "caches": caches}


class _UnsummedGather(torch.autograd.Function):
    """A planted fault for the SSD mixer's ``w_in``: the all-gather over
    model, its backward this rank's block of its own gradient (the B and C
    columns every rank reads not summed)."""

    @staticmethod
    def forward(ctx, t, dim, group):
        from repro_torch.engine import distributed as D

        ctx.dim, ctx.n, ctx.i = dim, group.size(), group.rank()
        return D.all_gather(t.detach(), group=group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.i].contiguous(), None, None


def _unsummed_w_in(mod, name, dtype=None):
    from repro_torch.models import sharding

    w = sharding.weight(mod, name, dtype)
    return _UnsummedGather.apply(w, mod._placed[name].model_dim,
                                 sharding.current_ctx().group("model"))


def _mixer_run(cfg, params, x: np.ndarray, r: np.ndarray, mesh,
               plant: str | None) -> dict:
    """Layer 0's SSD mixer of the placed hybrid on this data rank's rows of
    ``x`` (float32), ``sum(out * r)`` backpropagated: the output, the
    input's gradient and the mixer's gradient blocks, with ``plant``
    ("local_norm": the gated norm over the rank's channels alone;
    "unsummed_bc": ``w_in``'s gather without the sum in its backward)."""
    from repro_torch.models import layers, sharding, ssm

    m = _placed_model(cfg, params, mesh)
    blk = m.layers[0].ssm
    xt = _rows(torch.from_numpy(x), mesh).requires_grad_()
    rt = _rows(torch.from_numpy(r), mesh)
    fault = {None: contextlib.nullcontext(),
             "local_norm": _patched(ssm, "_gated_norm", lambda h, scale, c, _:
                                    layers.rms_norm(h, scale, c.norm_eps)),
             "unsummed_bc": _patched(ssm, "model_gathered", _unsummed_w_in)}[plant]
    with sharding.sharding_ctx(mesh), fault:
        out, _ = ssm.ssm_mixer(xt, blk, cfg)
        (out * rt).sum().backward()
        sharding.reduce_grads(blk)
    return {"out": out.detach(), "dx": xt.grad,
            "grads": {n: p.grad for n, p in blk.named_parameters()},
            "placements": sharding.placements(blk)}


def _elastic_family(cfg, params, nb: dict, directory: str, rank, world,
                    init) -> dict:
    """A train step of the placed model on data 2 x model 2, its state
    checkpointed through ``launch.train.ModelState`` (rank 0 writes the
    whole tensors), then restored onto data 1 x model 4 of the same ranks
    into a model placed from the untrained weights: the whole state before
    the save and after the restore, and the restored blocks."""
    from repro_torch.launch.train import ModelState
    from repro_torch.models import optim, sharding, steps
    from repro_torch.runtime.checkpoint import CheckpointManager

    with _float32(True):
        mesh = _mesh(2, 2, rank, world, init)
        m = _placed_model(cfg, params, mesh)
        state = optim.init_opt_state(m)
        step = steps.make_train_step(cfg, optim.OptimConfig(total_steps=10))
        with sharding.sharding_ctx(mesh):
            step(m, state, _tensors(nb))
        saved = sharding.whole_state(m, state, mesh)
        cm = CheckpointManager(directory, async_save=False)
        cm.save(1, ModelState(cfg, mesh).tree(m, state))
        cm.wait()
        mesh4 = _mesh(1, 4, rank, world, init)
        m4 = _placed_model(cfg, params, mesh4)
        s4 = optim.init_opt_state(m4)
        got, m4, s4 = ModelState(cfg, mesh4).restore(cm, m4, s4)
        restored = sharding.whole_state(m4, s4, mesh4)
    return {"saved": saved, "restored": restored, "step": got,
            "local": {n: p.detach().clone() for n, p in m4.named_parameters()},
            "m": {n: t.clone() for n, t in s4["m"].items()},
            "placements": sharding.placements(m4), "coords": dict(mesh4.coords)}


def tp_families(rank, world, init, payload):
    """The families on one data 2 x model 2 mesh, float32 compute: for
    each (config, weights, train batch, serve batch, decode tokens) of
    ``payload["families"]`` a train step (:func:`_train_step`) and a
    prefill with decode steps (:func:`_serve_steps`); layer 0's SSD mixer
    of ``payload["mixer"]`` (config, weights, x, r) as it is and with each
    planted fault; and :func:`_elastic_family` of ``payload["elastic"]``
    (config, weights, batch, directory)."""
    mesh = _mesh(2, 2, rank, world, init)
    out: dict = {"train": {}, "serve": {}, "mixer": {}}
    for cfg, params, nb, sb, new in payload["families"]:
        out["train"][cfg.name] = _train_step(cfg, params, _tensors(nb), mesh, True)
        out["serve"][cfg.name] = _serve_steps(cfg, params, sb, new,
                                              payload["max_len"], mesh)
    for plant in (None, "local_norm", "unsummed_bc"):
        out["mixer"][plant] = _mixer_run(*payload["mixer"], mesh, plant)
    out["elastic"] = _elastic_family(*payload["elastic"], rank, world, init)
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


# -- the DataFrame engine on ranks (tests/test_torch_rank_engine.py) -------------------


def _engine():
    from repro_torch.core import plan as P
    from repro_torch.core.expr import Col
    from repro_torch.core.frame import AFrame
    from repro_torch.data import wisconsin
    from repro_torch.engine import distributed as D
    from repro_torch.engine.session import Session
    from repro_torch.kernels import ops
    return Session, AFrame, P, Col, wisconsin, ops, D


def engine_probe(rank, world, init, payload):
    """``engine_probe.sharded_probe`` with the port's Session on a
    ``world``-rank mesh (its JSON, as the one-process mesh's is taken)."""
    import json

    from engine_probe import sharded_probe

    mesh = _mesh(world, 1, rank, world, init)
    return json.loads(json.dumps(sharded_probe(*_engine(), mesh)))


def engine_replays(rank, world, init, payload):
    """The bodies of tests/test_distributed.py:24, :54 and :89 on a
    ``world``-rank mesh: the values they assert on (the test asserts), and
    the rows this rank holds."""
    Session, AFrame, _, _, wisconsin, ops, D = _engine()
    mesh = _mesh(world, 1, rank, world, init)
    out = {}
    t = wisconsin.generate(10_000, seed=1)
    for mode in ("shard_map", "kernel"):
        sess = Session(mesh=mesh, mode=mode)
        if mode == "shard_map":
            sess.create_dataset("Data", t, dataverse="demo",
                                indexes=["onePercent", "unique1"],
                                primary="unique2")
        else:
            sess.create_dataset("Data", t, dataverse="demo")
        df = AFrame("demo", "Data", session=sess)
        ops.reset_dispatch_counts()
        r = {"len": len(df) if mode == "shard_map" else None,
             "n3": len(df[(df["ten"] == 3) & (df["twentyPercent"] == 2)
                          & (df["two"] == 1)]),
             "n3k": len(df[(df["ten"] == 3) & (df["twentyPercent"] == 3)
                           & (df["two"] == 1)]),
             "max": df["unique1"].max(),
             "groups": df.groupby("oddOnePercent").agg("count"),
             "top5": df.sort_values("unique1", ascending=False).head(5),
             "range": len(df[(df["onePercent"] >= 10) & (df["onePercent"] <= 30)]),
             "join": len(df.merge(AFrame("demo", "Data", session=sess),
                                  left_on="unique1", right_on="unique1")),
             "dispatch": dict(ops.DISPATCH_COUNTS),
             "rows": {k: tuple(v.shape) for k, v in
                      sess.catalog.get("demo", "Data").table.columns.items()}}
        out[mode] = r
    sess = Session(mesh=mesh, mode="shard_map")
    t = wisconsin.generate(8_000, seed=2)
    sess.create_dataset("Data", t, dataverse="d")
    ds = sess.catalog.get("d", "Data")
    k, m = ds.table.columns["unique1"], ds.table.valid
    k2 = ds.table.columns["ten"]
    out["hash"] = [int(x) for x in D.hash_repartition_counts(
        mesh, ("data",), k, m, k, m)]
    out["hash_dup"] = [int(x) for x in D.hash_repartition_counts(
        mesh, ("data",), k2, m, k2, m, capacity_factor=12.0)]
    out["ten_counts"] = np.bincount(t.columns["ten"].numpy(), minlength=10)
    return out


ENGINE_MODES = ("shard_map", "kernel", "gspmd")


def engine_session(Session, mesh, mode: str, t):
    """The datasets every engine check runs over: ``data`` and ``data_r``
    (the 12 expressions), and ``clu`` clustered by unique2 with a
    secondary index on onePercent (ranges that skip blocks, index zones,
    point lookups)."""
    sess = Session(mesh=mesh, mode=mode)
    for name in ("data", "data_r"):
        sess.create_dataset(name, t, dataverse="bench")
    sess.create_dataset("clu", t, dataverse="bench", primary="unique2",
                        indexes=["onePercent"])
    return sess


def engine_plans(P, Col, n: int) -> dict:
    """Plans over ``clu`` whose explain texts and prune reports every rank
    must share: a clustered range (blocks skipped per shard) counted,
    grouped and maxed, and an index range count."""
    scan = P.Filter(P.Scan("clu", "bench"), (Col("unique2") >= n // 10)
                    & (Col("unique2") <= n // 3))
    ix = P.Filter(P.Scan("clu", "bench"), (Col("onePercent") >= 10)
                  & (Col("onePercent") <= 30))
    return {"range_count": P.Agg(scan, [P.AggSpec("count", "count", None)]),
            "group_count": P.GroupAgg(scan, ["ten"],
                                      [P.AggSpec("count", "count", None)]),
            "max": P.Agg(scan, [P.AggSpec("max_unique1", "max", "unique1")]),
            "index_count": P.Agg(ix, [P.AggSpec("count", "count", None)])}


def engine_layout(sess) -> dict:
    """What one session's datasets hold: each column's shape, the zone
    maps (spans and layout) and every index's zones."""
    out = {}
    for name in ("data", "clu"):
        ds = sess.catalog.get("bench", name)
        bz = ds.block_zones
        out[name] = {
            "shapes": {k: tuple(v.shape) for k, v in ds.table.columns.items()},
            "global_rows": ds.table.global_rows,
            "zones": (bz.n_shards, bz.rows_per_shard, bz.n_blocks,
                      {k: np.asarray(v) for k, v in bz.spans.items()}),
            "index_zones": {k: (ix.zone_min.numpy(), ix.zone_max.numpy())
                            for k, ix in ds.indexes.items()},
            "head": ds.table.head_dict(5),
            "select": (ds.table.select(["unique1"]).global_rows,
                       tuple(ds.table.select(["unique1"]).columns["unique1"].shape)),
            "meta": {k: repr(m) for k, m in ds.table.meta.items()}}
    return out


def engine_blocks(fn):
    """``fn()`` and the kernel block accounting it added: scanned and
    skipped blocks of filter_count and segment_agg (telemetry counters)."""
    from repro_torch.runtime import telemetry as tel

    series = [(m, k) for m in ("kernel.blocks_scanned_total",
                               "kernel.blocks_skipped_total")
              for k in ("filter_count", "segment_agg")]
    before = [tel.counter_value(m, kernel=k) for m, k in series]
    out = fn()
    return out, [tel.counter_value(m, kernel=k) - b
                 for (m, k), b in zip(series, before)]


def engine_others(df) -> dict:
    """Operators beyond the 12 expressions, each over row shards on a rank
    mesh: a stream delivered whole, a full sort, windows (ordered, and
    partitioned), a string group-by (dictionary lanes), float and integer
    sums, and ``explain(analyze=True)``'s measured rows."""
    seven = df[df["onePercent"] == 7]
    return {
        "collect": df[df["ten"] == 3][["unique1", "ten"]].collect(),
        "sort": seven.sort_values("unique1")[["unique1", "unique2"]].collect(),
        "cumsum": seven.window(order_by="unique2").cumsum("unique1").collect(),
        "row_number": df[df["twenty"] == 3].window(
            order_by="unique1", partition_by="four").row_number().collect(),
        "string_group": df.groupby("string4").agg("count"),
        "mean": df["unique1"].mean(),
        "sum": df["ten"].sum(),
        "analyze_rows": df[df["ten"] == 2].explain(analyze=True).count("rows"),
    }


def engine_lookup_keys(n: int, shards: int) -> list:
    """Keys of clu's primary (unique2 = the row number): the first row of
    each shard, the last row, and two absent keys."""
    rps = -(-n // shards)
    return sorted({min(s * rps, n - 1) for s in range(shards)} | {n - 1}) \
        + [n, -5]


def engine_run(mesh, mode: str, t, rounds: int, shards: int):
    """One mode's checks on ``mesh`` (a rank mesh, or the one-process mesh
    they are held to) over table ``t``: the 12 expressions over ``rounds``
    rounds (answer, operator, prune report), the plans of
    ``engine_plans`` (explain text, answer, prune report), the same
    clustered ranges with the indexes off (the kernels then take each
    shard's block list, and the kernel block accounting is read), the
    operators of ``engine_others`` and point lookups. Returns (the
    results, ``engine_layout`` of the session)."""
    from engine_probe import EXPRESSIONS

    Session, AFrame, P, Col, *_ = _engine()
    n = len(t)
    sess = engine_session(Session, mesh, mode, t)
    df = AFrame("bench", "data", session=sess)
    dr = AFrame("bench", "data_r", session=sess)
    got = {}
    for name, fn in sorted(EXPRESSIONS.items()):
        for r in range(rounds):
            got[(name, r)] = fn(df, dr, np.random.default_rng(100 + r))
            got[(name, r, "op")] = type(sess.last_physical).__name__
            got[(name, r, "report")] = sess.last_prune_report
    plans = engine_plans(P, Col, n)
    for name, plan in plans.items():
        got[(name, "explain")] = sess.explain(plan)
        got[(name, "answer")] = sess.execute(plan)
        got[(name, "report")] = sess.last_prune_report
    noix = Session(mesh=mesh, mode=mode, enable_index=False)
    noix.create_dataset("clu", t, dataverse="bench", primary="unique2")
    for name in ("range_count", "group_count"):
        got[(name, "no index", "explain")] = noix.explain(plans[name])
        got[(name, "no index", "answer")], got[(name, "no index", "blocks")] = \
            engine_blocks(lambda name=name: noix.execute(plans[name]))
        got[(name, "no index", "report")] = noix.last_prune_report
    for name, v in engine_others(df).items():
        got[(name, "other")] = v
    clu = AFrame("bench", "clu", session=sess)
    for key in engine_lookup_keys(n, shards):
        got[("get", key)] = clu.get(key)
        got[("get", key, "explain")] = clu.explain_get(key)
    return got, engine_layout(sess)


def engine_checks(rank, world, init, payload):
    """On a ``world``-rank mesh, for each table size of ``payload``:
    ``engine_run`` in every mode, then the live paths over the last table
    (feed, view, persist, compaction) and its round trip through one
    durable store the ranks share (``storage=``, then ``Session.open``)."""
    from repro_torch.engine import lsm
    from repro_torch.engine.ingest import Feed

    Session, AFrame, *_, wisconsin, _, _ = _engine()
    mesh = _mesh(world, 1, rank, world, init)
    out = {}
    for n in payload["rows"]:
        t = wisconsin.generate(n, seed=payload["seed"])
        for mode in ENGINE_MODES:
            out[(n, mode)], out[(n, mode, "layout")] = engine_run(
                mesh, mode, t, payload["rounds"], world)
    sess = engine_session(Session, mesh, "kernel", t)
    clu = AFrame("bench", "clu", session=sess)
    n = len(t)

    def feed():
        rows = {k: v.numpy()[:2] for k, v in t.columns.items()}
        rows["unique2"] = rows["unique2"] + n
        f = Feed(sess, "clu", "bench", flush_rows=10**9,
                 policy=lsm.CompactionPolicy(size_ratio=100.0))
        f.push(rows)
        f.delete(np.array([0], np.int32))
        f.flush()
        return len(clu), len(sess.catalog.get("bench", "clu").runs)

    def view():
        plan = clu.groupby("ten").agg_plan({"four": "sum"})
        sess.create_view("v", plan)
        return sess.read_view("v"), sess.execute(plan)

    def stored():
        s = Session(mesh=mesh, mode="kernel", storage=payload["store"])
        s.create_dataset("clu", t, dataverse="bench", primary="unique2",
                         indexes=["onePercent"])
        rows = AFrame("bench", "clu", session=s).collect()
        s.close()
        return rows

    def reopened():
        s = Session.open(payload["store"], mesh=mesh, mode="kernel")
        rows = AFrame("bench", "clu", session=s).collect()
        held = {k: tuple(v.shape) for k, v in
                s.catalog.get("bench", "clu").table.columns.items()}
        s.close()
        return rows, held

    paths = {
        "feed": feed,
        "view": view,
        "persist": lambda: len(clu[clu["ten"] >= 0].persist("p")),
        "compact": lambda: (lsm.compact(sess, sess.catalog.get("bench", "clu")),
                            len(clu))[1],
        "storage": stored,
        "open": reopened,
    }
    out["paths"] = {what: ("ran", fn()) for what, fn in paths.items()}
    return out


def engine_answers(rank, world, init, payload):
    """The 12 expressions over ``payload["rounds"]`` rounds in every mode on
    a ``world``-rank mesh whose ranks share ``payload["device"]``: "cuda"
    (gloo ranks on the one card) or "cpu"."""
    from engine_probe import EXPRESSIONS
    from repro_torch.launch.mesh import init_rank_mesh

    Session, AFrame, *_, wisconsin, _, _ = _engine()
    if payload["device"] == "cuda":
        torch.cuda.set_device(0)
        mesh = init_rank_mesh(world, 1, None, rank=rank, world_size=world,
                              local_rank=0, init_method=init, backend="gloo")
    else:
        mesh = _mesh(world, 1, rank, world, init)
    t = wisconsin.generate(payload["rows"], seed=payload["seed"])
    out = {}
    for mode in ENGINE_MODES:
        sess = engine_session(Session, mesh, mode, t)
        df = AFrame("bench", "data", session=sess)
        dr = AFrame("bench", "data_r", session=sess)
        for name, fn in sorted(EXPRESSIONS.items()):
            for r in range(payload["rounds"]):
                out[(mode, name, r)] = fn(df, dr, np.random.default_rng(100 + r))
    return out


# -- the live engine on ranks (tests/test_torch_rank_live.py) --------------------------


def live_pk(mesh):
    """The port's package surface (``live_scenarios``' ``pk``) with every
    session on ``mesh`` (a rank mesh, or the one-process mesh the ranks
    are held to), and an ``observe`` hook that appends each dataset
    layout to ``pk.log`` (``live_layout``)."""
    import types

    from repro_torch.core import expr
    from repro_torch.core import plan as P
    from repro_torch.core.frame import AFrame
    from repro_torch.data import wisconsin
    from repro_torch.engine import lsm, table
    from repro_torch.engine.ingest import Feed
    from repro_torch.engine.session import Session
    from repro_torch.engine.table import Table
    from repro_torch.kernels import ops
    from repro_torch.runtime.fault import FaultPlan

    pk = types.SimpleNamespace(P=P, AFrame=AFrame, wisconsin=wisconsin, lsm=lsm,
                               Feed=Feed, Table=Table, ops=ops, table=table,
                               expr=expr, FaultPlan=FaultPlan, log=[])
    pk.session = lambda mode="gspmd", **kw: Session(mesh=mesh, mode=mode, **kw)
    pk.observe = lambda sess, label, dv, name: pk.log.append(
        (label, live_layout(sess, dv, name)))
    return pk


def live_layout(sess, dv: str, name: str) -> dict:
    """What a session holds of one dataset: its manifest (LSN, component
    names and uids, kill-sets, live and anti rows) and, for each
    component, the rows each column holds here, the padded table's rows,
    the zone maps and every index's zones."""
    m = sess.catalog.manifest(dv, name)
    comps = []
    for c in m.components:
        bz = c.block_zones
        comps.append({
            "name": c.name, "uid": c.uid, "level": c.level,
            "live": c.live_rows, "anti": c.anti_rows,
            "kills": sorted(c.annihilated_keys),
            "held": sorted({int(v.shape[0]) for v in c.table.columns.values()}),
            "global_rows": c.table.global_rows,
            "columns": list(c.table.columns),
            "device": sorted({str(v.device) for v in c.table.columns.values()}),
            "zones": None if bz is None else (
                bz.n_shards, bz.rows_per_shard, bz.n_blocks,
                {k: np.asarray(v) for k, v in bz.spans.items()}),
            "index_zones": {k: (ix.zone_min.cpu().numpy(),
                                ix.zone_max.cpu().numpy())
                            for k, ix in c.indexes.items()},
            "meta": {k: repr(v) for k, v in c.table.meta.items()},
            "host_keys": None if c.host_keys is None else c.host_keys.copy(),
        })
    return {"lsn": m.lsn, "components": comps}


LIVE_MODES = ("kernel", "shard_map", "gspmd")


def live_run(mesh, base_rows: int) -> dict:
    """live_scenarios' 4-rank replays on ``mesh``: each scenario's result
    and the layouts it logged (``observe``)."""
    import live_scenarios as L

    pk = live_pk(mesh)
    out = {}

    def run(key, fn, *args):
        pk.log = []
        out[key] = fn(*args)
        out[key + ("log",)] = list(pk.log)

    for mode in LIVE_MODES:
        run(("lsm", mode), L.lsm_suite, pk, mode, base_rows)
        run(("extras", mode), L.lsm_extras, pk, mode, base_rows)
        run(("view", mode), L.view_incremental, pk, mode, base_rows)
        run(("mutated", mode), L.mutated_suite, pk, mode, base_rows)
        for seed in range(4):
            run(("interleave", mode, seed), L.interleavings, pk, mode, seed)
    run(("launches",), L.launches_per_component, pk, base_rows)
    run(("policy",), L.policy_triggers, pk)
    run(("newest",), L.newest_wins, pk)
    run(("leveled",), L.leveled_mutations, pk)
    run(("retraction",), L.view_retraction, pk)
    run(("bg_folds",), L.bg_folds, pk)
    run(("bg_fault",), L.bg_fault, pk)
    return out


def live_replays(rank, world, init, payload):
    """``live_run`` on a ``world``-rank mesh, then the one-rank "pre-swap"
    fault: armed on rank 0 only, a flush raises on every rank and leaves
    every rank's manifest as it was; the retry commits on all of them."""
    import live_scenarios as L
    from repro_torch.runtime.fault import FaultPlan, StorageFault

    mesh = _mesh(world, 1, rank, world, init)
    out = live_run(mesh, payload["base_rows"])
    pk = live_pk(mesh)
    sess, feed = L.fed_session(pk, "kernel", payload["base_rows"], n_pushes=1)
    before = live_layout(sess, "d", "Live")
    if rank == 0:
        sess.fault_plan = FaultPlan.once("pre-swap")
    rows = L.host_rows(pk.wisconsin.generate(L.PUSH_ROWS, seed=21))
    rows["unique2"] = rows["unique2"] + payload["base_rows"] + L.PUSH_ROWS
    try:
        feed.push(rows)
        raised = None
    except StorageFault as e:
        raised = str(e)
    aborted = live_layout(sess, "d", "Live")
    feed.flush()
    out["fault"] = {"raised": raised, "before": before, "aborted": aborted,
                    "committed": live_layout(sess, "d", "Live"),
                    "len": len(pk.AFrame("d", "Live", session=sess)),
                    "fired": list(sess.fault_plan.fired) if rank == 0 else []}
    return out


def live_block_skip(rank, world, init, payload):
    """tests/test_block_skip.py's three sharded tests (:521, :583, :642) on
    a ``world``-rank mesh, every mode."""
    import live_scenarios as L
    from repro_torch.runtime import telemetry as tel

    pk = live_pk(_mesh(world, 1, rank, world, init))
    out = {}
    for mode in LIVE_MODES:
        pk.log = []
        out[("skip", mode)] = L.block_skip(pk, mode, tel)
        out[("strings", mode)] = L.strings(pk, mode, tel)
        out[("log", mode)] = list(pk.log)
    out["lookup"] = L.routed_lookup(pk)
    return out


def live_card(rank, world, init, payload):
    """tests/test_mutation.py's mutated suite (a flush of pushes, a flush
    of upserts and deletes, the compaction) in kernel and gspmd mode on a
    ``world``-rank mesh whose ranks share ``payload["device"]``: "cuda"
    (gloo ranks on the one card) or "cpu"; the answers and the layouts
    logged after each flush and the compaction."""
    import live_scenarios as L
    from repro_torch.launch.mesh import init_rank_mesh

    if payload["device"] == "cuda":
        torch.cuda.set_device(0)
        mesh = init_rank_mesh(world, 1, None, rank=rank, world_size=world,
                              local_rank=0, init_method=init, backend="gloo")
    else:
        mesh = _mesh(world, 1, rank, world, init)
    pk = live_pk(mesh)
    out = {mode: L.mutated_suite(pk, mode, payload["base_rows"])
           for mode in ("kernel", "gspmd")}
    out["log"] = list(pk.log)
    return out


# -- the durable store on ranks (tests/test_torch_rank_durable.py) -----------------------


def durable_pk(mesh):
    """``durable_scenarios``' package surface with every session on
    ``mesh`` (a rank mesh, or the one-process mesh the ranks are held
    to); ``observe`` logs ``live_layout`` to ``pk.log``."""
    import types

    from repro_torch.core import plan as P
    from repro_torch.core.frame import AFrame
    from repro_torch.engine import lsm
    from repro_torch.engine.ingest import Feed
    from repro_torch.engine.session import Session
    from repro_torch.engine.table import Table
    from repro_torch.launch.mesh import is_rank_mesh, is_writer
    from repro_torch.runtime import telemetry as tel
    from repro_torch.runtime.fault import FaultPlan, StorageFault

    def once(fn):
        if is_writer(mesh):
            fn()
        if is_rank_mesh(mesh):
            torch.distributed.barrier()

    pk = types.SimpleNamespace(P=P, AFrame=AFrame, lsm=lsm, Feed=Feed,
                               Table=Table, tel=tel, FaultPlan=FaultPlan,
                               StorageFault=StorageFault, once=once, log=[])
    pk.session = lambda mode="gspmd", **kw: Session(mesh=mesh, mode=mode, **kw)
    pk.open = lambda path, mode="gspmd", **kw: Session.open(
        str(path), mesh=mesh, mode=mode, **kw)
    pk.observe = lambda sess, label, name="ds": pk.log.append(
        (label, live_layout(sess, "d", name)))
    return pk


DURABLE_MODES = ("kernel", "shard_map", "gspmd")


def durable_run(mesh, root, batches, points) -> dict:
    """``durable_scenarios``' replays on ``mesh`` with their stores under
    ``root`` (one store a scenario, shared by the ranks): each result and
    the layouts it logged."""
    import durable_scenarios as S

    pk = durable_pk(mesh)
    out = {}

    def run(key, fn, *args):
        pk.log = []
        out[key] = fn(pk, *args)
        out[key + ("log",)] = list(pk.log)

    for mode in DURABLE_MODES:
        run(("roundtrip", mode), S.roundtrip, root, mode, batches)
        for point in points:
            run(("crash", mode, point), S.crash, root, mode, point, batches)
    run(("torn",), S.torn_segment, root)
    run(("corrupt",), S.corrupt_segment, root)
    run(("empty",), S.empty_flush, root)
    run(("skips",), S.replay_skips, root)
    run(("interleaved",), S.interleaved, root)
    run(("double",), S.double_open, root)
    run(("lazy",), S.lazy_rebuild, root, batches)
    run(("binds",), S.first_binds, root, batches)
    run(("telemetry",), S.telemetry_series, root)
    run(("gc",), S.compaction_gc, root)
    run(("soft",), S.soft_recover)
    return out


def durable_opens(pk, d) -> dict:
    """A store another writer left (segments and a WAL tail) opened on
    ``pk``'s mesh: the rows, point lookups and replayed batches, then the
    rows after a delete flushed here (which its writer reads back)."""
    import durable_scenarios as S

    re = pk.open(d, "kernel")
    out = {"replayed": re.recovery_report["wal_replayed_batches"],
           "rows": S.rows(pk, re),
           "get": {k: re.point_lookup("d", "ds", k) for k in (0, 1, 2, 5, 99)}}
    pk.observe(re, f"open {d.name}")
    f = S.feed(pk, re)
    f.delete(np.array([3], dtype=np.int32))
    f.flush()
    out["after"] = S.rows(pk, re)
    re.close()
    return out


def durable_replays(rank, world, init, payload):
    """``durable_run`` on a ``world``-rank mesh, then the shared format:
    the stores the reference and the meshless port wrote
    (``payload["from"]``) opened on the ranks, and the stores the ranks
    leave for meshless sessions to open (the batches with their WAL tail;
    the interleaved mutations, all in the WAL; the batches then compacted,
    whose tree a meshless writer must match)."""
    import pathlib

    import durable_scenarios as S

    mesh = _mesh(world, 1, rank, world, init)
    root = pathlib.Path(payload["root"]) / "ranks"
    out = durable_run(mesh, root, payload["batches"], payload["points"])
    pk = durable_pk(mesh)
    for writer, d in payload["from"].items():
        pk.log = []
        out[("from", writer)] = durable_opens(pk, pathlib.Path(d))
        out[("from", writer, "log")] = list(pk.log)
    S.write_scenario(pk, root / "left", "kernel", payload["batches"])
    S.write_interleaved(pk, root / "interleaved-left")
    S.tree_scenario(pk, root / "tree", "kernel", payload["batches"])
    return out


def durable_threads(rank, world, init, payload):
    """A rank session entered from a thread that did not make it refuses
    (reader threads on a rank mesh, ROADMAP A9b-2f), a feed's included;
    the background compactor's worker still builds, and its merge
    publishes."""
    import threading

    import durable_scenarios as S

    mesh = _mesh(world, 1, rank, world, init)
    pk = durable_pk(mesh)
    sess = pk.session("kernel")
    S.create(pk, sess)
    got = {}

    def reader():
        for what, fn in (("query", lambda: len(pk.AFrame("d", "ds", session=sess))),
                         ("push", lambda: S.push(S.feed(pk, sess), 16, 18))):
            try:
                got[what] = ("ran", fn())
            except NotImplementedError as e:
                got[what] = ("refused", str(e))

    t = threading.Thread(target=reader)
    t.start()
    t.join()
    with pk.lsm.BackgroundCompactor(
            sess, policy=pk.lsm.CompactionPolicy(size_ratio=0.0)) as bc:
        f = S.feed(pk, sess, compactor=bc)
        S.push(f, 16, 24)
        f.flush()
        got["idle"] = bc.wait_idle(60.0)
        got["compactions"] = bc.stats["compactions"]
    got["rows"] = S.rows(pk, sess)
    got["components"] = len(sess.catalog.components("d", "ds"))
    return got
