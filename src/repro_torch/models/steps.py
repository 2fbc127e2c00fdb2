"""Step functions (port of ``repro.models.steps``, the serving half): the
prefill and decode steps ``launch/serve.py`` drives, each greedy — the
argmax of the last logits as (B, 1) int32, the next step's input.

The train and eval steps wait for ROADMAP A10 (training), and with them
the reference's ``cast_once``, which only its train step calls.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import ModelAPI, get_api


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


def _training(*a, **kw):
    raise NotImplementedError(
        "the train and eval steps wait for ROADMAP A10 (training: losses, "
        "optim, the flash backward B7)")


make_train_step = make_eval_step = init_train_state = _training
