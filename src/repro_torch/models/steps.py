"""Step functions (port of ``repro.models.steps``): the train and eval
steps, and the greedy prefill and decode steps ``launch/serve.py`` drives
(each returns the argmax of the last logits as (B, 1) int32, the next
step's input).

The reference's steps are pure functions that return new parameters and
optimizer state; the port's train step updates the model's parameters and
the state's moments in place (``models/optim.py``) and returns them with
the metrics, so the calls read alike.

Under a sharding context with more than one data shard
(``models/sharding.py``) the train step is data-parallel: the batch splits
into the shards' row blocks, each shard takes its block's loss and its
gradients (a tree of its own), :func:`merge_grads` merges them into the
global batch's mean gradient (``psum`` of each shard's gradients times
its share of the rows), and the clip and AdamW run once on the merged
tree. The metrics are the global batch's. An MoE model's step first runs
every block forward without gradients to gather the routing statistics
the aux loss and the capacity read across the shards (``moe._mesh_moe``).

On a rank mesh (``launch/mesh.RankMesh``, weights placed by
``sharding.place_params``) each data rank takes its own row block and
backpropagates its share of the loss; the gradient merge is the
reduce-scatter of every gathered weight's gradient and an all-reduce of
the rest (``sharding.reduce_grads``), the routing statistics are
collectives inside the one forward (``moe._rank_moe``), and AdamW updates
each rank's shards, its clip reading the global norm over every rank.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from repro_torch.engine import distributed as D
from repro_torch.models.config import ArchConfig
from repro_torch.models.convert import leaf_ndim
from repro_torch.models.optim import OptimConfig, adamw_update, init_opt_state
from repro_torch.models.registry import ModelAPI, get_api
from repro_torch.models.sharding import current_ctx, reduce_grads


@contextlib.contextmanager
def cast_once(model: nn.Module, cfg: ArchConfig):
    """Under ``cfg.cast_params_once``, every float32 parameter whose leaf
    in the reference's pytree has ndim >= 2 (``convert.leaf_ndim``, as the
    reference's ``cast_once`` casts its stacked leaves) reads as its bf16
    copy inside the block: one cast a step, where the layers otherwise cast
    each weight at every use. The copies are made by a differentiable
    cast, so a backward run inside the block reaches the float32 masters.
    Without the flag the block changes nothing."""
    swapped = []
    if cfg.cast_params_once:
        for prefix, mod in model.named_modules():
            for name, p in list(mod._parameters.items()):
                full = f"{prefix}.{name}" if prefix else name
                if p is not None and p.dtype == torch.float32 \
                        and leaf_ndim(full, p) >= 2:
                    mod._parameters[name] = p.to(torch.bfloat16)
                    swapped.append((mod, name, p))
    try:
        yield model
    finally:
        for mod, name, p in swapped:
            mod._parameters[name] = p


def data_blocks(batch: dict, n: int) -> list[dict]:
    """The batch's ``n`` contiguous row blocks (views), every entry split
    along its first dim."""
    parts = {k: v.chunk(n) for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(n)]


def merge_grads(parts: list[list[torch.Tensor]],
                weights: list[float]) -> list[torch.Tensor]:
    """The data shards' gradients (``parts[i]``: shard i's, one tensor per
    parameter) merged into the global batch's: ``psum`` over the shards,
    in shard order, of each gradient times its shard's weight. Each
    shard's tensors are scaled in place and let go leaf by leaf, so the
    merge holds the shards' trees and one merged leaf at a time."""
    out = []
    for j in range(len(parts[0])):
        out.append(D.psum([part[j].mul_(w) for part, w in zip(parts, weights)]))
        for part in parts:
            part[j] = None
    return out


def make_train_step(cfg: ArchConfig, opt_cfg: OptimConfig):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: the family's loss and its backward (inside ``cast_once``),
    then ``adamw_update``; the parameters and the state change in place
    and the gradients are dropped after the update. ``metrics`` holds the
    loss, the family's metrics ("ce", and "aux" for the transformers),
    "grad_norm" (before the clip) and "lr", as 0-d float32 tensors. Under
    a context with data shards the step is data-parallel (module
    docstring)."""
    api = get_api(cfg)

    def train_step(model, opt_state, batch):
        model.zero_grad(set_to_none=True)
        ctx = current_ctx()
        n = 1 if ctx is None else ctx.data_blocks(batch["tokens"].shape[0])
        if ctx is not None and ctx.ranked:
            metrics = _rank_grads(model, batch, ctx)
        elif n == 1:
            with cast_once(model, cfg):
                loss, metrics = api.loss(model, batch, cfg)
                loss.backward()
            metrics = {"loss": loss, **metrics}
        else:
            metrics = _data_parallel_grads(model, batch, ctx, n)
        opt_metrics = adamw_update(model, opt_state, opt_cfg)
        model.zero_grad(set_to_none=True)
        return model, opt_state, {**{k: v.detach() for k, v in metrics.items()},
                                  **opt_metrics}

    def _rank_grads(model, batch, ctx) -> dict:
        """A rank mesh's step: this data rank's row block (the whole batch
        where the data extent does not divide it), its loss times its
        share of the rows backpropagated, so the reduce-scatters of the
        gathered weights and ``reduce_grads``'s all-reduce sum the ranks'
        gradients into the global batch's mean (``merge_grads``'s token
        weights); the metrics are ``psum``-ed over the data axes with the
        same weights."""
        rows = batch["tokens"].shape[0]
        n = ctx.split(rows)
        if n > 1:
            batch = data_blocks(batch, n)[ctx.data_rank]
        w = batch["tokens"].shape[0] / rows if n > 1 else 1.0 / ctx.data_size
        ctx.batch_split = n > 1
        try:
            with cast_once(model, cfg):
                loss, metrics = api.loss(model, batch, cfg)
                (loss * w).backward()
        finally:
            ctx.batch_split = True
        reduce_grads(model)
        g = ctx.group("data")
        return {k: D.psum(v.detach() * w, group=g)
                for k, v in {"loss": loss, **metrics}.items()}

    def _data_parallel_grads(model, batch, ctx, n) -> dict:
        blocks = data_blocks(batch, n)
        rows = batch["tokens"].shape[0]
        weights = [b["tokens"].shape[0] / rows for b in blocks]
        params = list(model.parameters())
        ctx.gathered = {}
        if cfg.moe is not None:
            with torch.no_grad():
                for i, b in enumerate(blocks):
                    with ctx.data_shard(i, gathering=True), cast_once(model, cfg):
                        api.loss(model, b, cfg)
        parts, mets = [], []
        try:
            for i, b in enumerate(blocks):
                with ctx.data_shard(i), cast_once(model, cfg):
                    loss, metrics = api.loss(model, b, cfg)
                    parts.append(list(torch.autograd.grad(loss, params)))
                mets.append({"loss": loss.detach(),
                             **{k: v.detach() for k, v in metrics.items()}})
        finally:
            ctx.gathered = {}
        for p, g in zip(params, merge_grads(parts, weights)):
            p.grad = g
        return {k: D.psum([m[k] * w for m, w in zip(mets, weights)])
                for k in mets[0]}

    return train_step


def make_eval_step(cfg: ArchConfig):
    """``eval_step(model, batch) -> {"loss", ...}`` without gradients."""
    api = get_api(cfg)

    @torch.no_grad()
    def eval_step(model, batch):
        loss, metrics = api.loss(model, batch, cfg)
        return {"loss": loss, **metrics}

    return eval_step


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]


def make_prefill_step(cfg: ArchConfig, api: ModelAPI | None = None,
                      max_len: int | None = None):
    """``prefill_step(model, batch) -> (cache, next tokens (B, 1) int32)``."""
    api = api or get_api(cfg)

    @torch.no_grad()
    def prefill_step(model, batch):
        cache, logits = api.prefill(model, batch, cfg, max_len)
        return cache, _greedy(logits)

    return prefill_step


def make_decode_step(cfg: ArchConfig, api: ModelAPI | None = None):
    """``decode_step(model, cache, tokens) -> (cache, next tokens)``; the
    cache given is consumed (written in place)."""
    api = api or get_api(cfg)

    @torch.no_grad()
    def decode_step(model, cache, tokens):
        cache, logits = api.decode(model, cache, tokens, cfg)
        return cache, _greedy(logits)

    return decode_step


def init_train_state(cfg: ArchConfig,
                     generator: torch.Generator) -> tuple[nn.Module, dict]:
    """Random weights from ``generator`` (on its device) and a zero AdamW
    state beside them (the reference: ``init_train_state(key, cfg)``)."""
    model = get_api(cfg).init(cfg, generator)
    return model, init_opt_state(model)
