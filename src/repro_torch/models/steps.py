"""Step functions (port of ``repro.models.steps``): the train and eval
steps, and the greedy prefill and decode steps ``launch/serve.py`` drives
(each returns the argmax of the last logits as (B, 1) int32, the next
step's input).

The reference's steps are pure functions that return new parameters and
optimizer state; the port's train step updates the model's parameters and
the state's moments in place (``models/optim.py``) and returns them with
the metrics, so the calls read alike.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from repro_torch.models.config import ArchConfig
from repro_torch.models.convert import leaf_ndim
from repro_torch.models.optim import OptimConfig, adamw_update, init_opt_state
from repro_torch.models.registry import ModelAPI, get_api


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


def make_train_step(cfg: ArchConfig, opt_cfg: OptimConfig):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: the family's loss and its backward (inside ``cast_once``),
    then ``adamw_update``; the parameters and the state change in place
    and the gradients are dropped after the update. ``metrics`` holds the
    loss, the family's metrics ("ce", and "aux" for the transformers),
    "grad_norm" (before the clip) and "lr", as 0-d float32 tensors."""
    api = get_api(cfg)

    def train_step(model, opt_state, batch):
        model.zero_grad(set_to_none=True)
        with cast_once(model, cfg):
            loss, metrics = api.loss(model, batch, cfg)
            loss.backward()
        opt_metrics = adamw_update(model, opt_state, opt_cfg)
        model.zero_grad(set_to_none=True)
        return model, opt_state, {"loss": loss.detach(),
                                  **{k: v.detach() for k, v in metrics.items()},
                                  **opt_metrics}

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
