"""Uniform model API per architecture family (port of
``repro.models.registry``): ``get_api(cfg)`` gives init / loss / prefill /
decode / make_cache for the family. The reference's abstract specs,
PartitionSpecs and ``shape_adjusted_cfg`` serve its XLA dry-run and mesh
(their only callers) and have no counterpart here.

Signatures (the port's, beside the reference's):
  * ``init(cfg, generator)`` — random weights on the generator's device
    (the reference: ``init(key, cfg)``);
  * ``prefill(model, batch, cfg, max_len=None) -> (cache, logits (B,1,V))``;
  * ``decode(model, cache, tokens (B,1), cfg) -> (cache, logits (B,1,V))``,
    writing the cache's buffers in place (the reference donates them);
  * ``make_cache(cfg, batch, max_len, device=None)`` — ``None`` means the
    card, and raises without one;
  * ``loss`` raises: training waits for ROADMAP A10.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models import hybrid, rwkv, transformer, whisper
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init: Callable
    loss: Callable
    prefill: Callable
    decode: Callable
    make_cache: Callable


def _waits(what: str) -> Callable:
    def raise_(*a, **kw):
        raise NotImplementedError(
            f"{what} waits for ROADMAP A10 (training: the losses, steps, "
            "optim, the flash backward B7)")
    return raise_


def get_api(cfg: ArchConfig) -> ModelAPI:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return ModelAPI(transformer.init_lm, _waits("lm_loss"),
                        transformer.lm_prefill, transformer.lm_decode_step,
                        transformer.make_cache)
    if fam == "rwkv":
        return ModelAPI(rwkv.init_rwkv_lm, _waits("rwkv_loss"),
                        rwkv.rwkv_prefill, rwkv.rwkv_decode_step,
                        rwkv.make_cache)
    if fam == "hybrid":
        return ModelAPI(hybrid.init_hybrid, _waits("hybrid_loss"),
                        hybrid.hybrid_prefill, hybrid.hybrid_decode_step,
                        hybrid.make_cache)
    if fam == "encdec":
        return ModelAPI(whisper.init_whisper, _waits("whisper_loss"),
                        whisper.whisper_prefill, whisper.whisper_decode_step,
                        whisper.make_cache)
    raise ValueError(f"unknown family {fam}")


def prefill_cache_len(cfg: ArchConfig, seq: int) -> int:
    """Cache depth a prefill of ``seq`` tokens produces (vlm prepends its
    projected patch prefix to the context)."""
    return seq + (cfg.num_patches if cfg.family == "vlm" else 0)
