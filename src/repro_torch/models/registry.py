"""Uniform model API per architecture family (port of
``repro.models.registry.get_api``; the abstract specs and PartitionSpecs of
the reference serve its XLA dry-run and mesh and have no counterpart here).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init: Callable
    loss: Callable
    prefill: Callable
    decode: Callable
    make_cache: Callable


def _waits(what: str, item: str) -> Callable:
    def raise_(*a, **kw):
        raise NotImplementedError(f"{what} waits for ROADMAP {item}")
    return raise_


_FAMILY_ITEMS = {
    "moe": "A10 (MoE transformer: models/moe.py)",
    "vlm": "A10 (VLM transformer: patch prefix)",
    "rwkv": "A10 (models/rwkv.py)",
    "hybrid": "A10 (models/hybrid.py, models/ssm.py)",
    "encdec": "A10 (models/whisper.py)",
}


def get_api(cfg: ArchConfig) -> ModelAPI:
    if cfg.family == "dense":
        return ModelAPI(transformer.init_lm,
                        _waits("lm_loss", "A10 (training)"),
                        transformer.lm_prefill,
                        _waits("lm_decode_step", "A10 (serving: decode, "
                               "launch/serve.py)"),
                        transformer.make_cache)
    if cfg.family in _FAMILY_ITEMS:
        raise NotImplementedError(
            f"the {cfg.family!r} family waits for ROADMAP "
            f"{_FAMILY_ITEMS[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family}")
