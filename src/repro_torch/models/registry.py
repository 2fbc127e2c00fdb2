"""Uniform model API per architecture family (port of
``repro.models.registry``): ``get_api(cfg)`` gives init / loss / prefill /
decode / make_cache for the family; ``abstract_params`` (the model on the
"meta" device, nothing allocated, as the reference's pytree) and the
PartitionSpecs of the mesh (``params_pspecs``, ``batch_pspecs``,
``cache_pspecs``), and what the dry-run (``launch/dryrun.py``) lowers a
cell with: ``shape_adjusted_cfg`` and the inputs of a cell on "meta",
``batch_specs`` and ``decode_specs`` (the reference's ShapeDtypeStructs).

Signatures (the port's, beside the reference's):
  * ``init(cfg, generator)`` — random weights on the generator's device
    (the reference: ``init(key, cfg)``);
  * ``loss(model, batch, cfg) -> (loss, metrics)``, 0-d float32 tensors
    that autograd can differentiate;
  * ``prefill(model, batch, cfg, max_len=None) -> (cache, logits (B,1,V))``;
  * ``decode(model, cache, tokens (B,1), cfg) -> (cache, logits (B,1,V))``,
    writing the cache's buffers in place (the reference donates them);
  * ``make_cache(cfg, batch, max_len, device=None)`` — ``None`` means the
    card, and raises without one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.launch.mesh import MeshAxes
from repro_torch.models import convert, hybrid, rwkv, transformer, whisper
from repro_torch.models.config import ArchConfig, ShapeSpec
from repro_torch.models.sharding import P, param_specs


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init: Callable
    loss: Callable
    prefill: Callable
    decode: Callable
    make_cache: Callable


def get_api(cfg: ArchConfig) -> ModelAPI:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return ModelAPI(transformer.init_lm, transformer.lm_loss,
                        transformer.lm_prefill, transformer.lm_decode_step,
                        transformer.make_cache)
    if fam == "rwkv":
        return ModelAPI(rwkv.init_rwkv_lm, rwkv.rwkv_loss, rwkv.rwkv_prefill,
                        rwkv.rwkv_decode_step, rwkv.make_cache)
    if fam == "hybrid":
        return ModelAPI(hybrid.init_hybrid, hybrid.hybrid_loss,
                        hybrid.hybrid_prefill, hybrid.hybrid_decode_step,
                        hybrid.make_cache)
    if fam == "encdec":
        return ModelAPI(whisper.init_whisper, whisper.whisper_loss,
                        whisper.whisper_prefill, whisper.whisper_decode_step,
                        whisper.make_cache)
    raise ValueError(f"unknown family {fam}")


def prefill_cache_len(cfg: ArchConfig, seq: int) -> int:
    """Cache depth a prefill of ``seq`` tokens produces (vlm prepends its
    projected patch prefix to the context)."""
    return seq + (cfg.num_patches if cfg.family == "vlm" else 0)


def shape_adjusted_cfg(cfg: ArchConfig, shape: ShapeSpec) -> ArchConfig:
    """Per-shape config tweaks: zamba2's shared attention gets a 4k sliding
    window at 500k context (the reference's deviation for sub-quadratic
    serving)."""
    if cfg.family == "hybrid" and shape.seq_len > 100_000:
        return dataclasses.replace(cfg, sliding_window=4096)
    return cfg


# -- a cell's inputs on "meta" ----------------------------------------------------

_META = torch.device("meta")


def batch_specs(cfg: ArchConfig, batch: int, seq: int) -> dict:
    """The train / prefill batch as meta tensors: tokens (B, S) int32, with
    frames (B, enc_len, d) for encdec and patches (B, P, patch_dim) for
    vlm, both bf16."""
    specs = {"tokens": torch.empty((batch, seq), dtype=torch.int32,
                                   device=_META)}
    if cfg.family == "encdec":
        specs["frames"] = torch.empty((batch, cfg.enc_len, cfg.d_model),
                                      dtype=torch.bfloat16, device=_META)
    if cfg.family == "vlm":
        specs["patches"] = torch.empty((batch, cfg.num_patches, cfg.patch_dim),
                                       dtype=torch.bfloat16, device=_META)
    return specs


def decode_specs(cfg: ArchConfig, batch: int, cache_len: int) -> tuple[dict, dict]:
    """(token spec, cache) of a decode cell: tokens (B, 1) int32 and the
    family's cache ``cache_len`` deep, both on "meta"."""
    tokens = torch.empty((batch, 1), dtype=torch.int32, device=_META)
    cache = get_api(cfg).make_cache(cfg, batch, cache_len, device=_META)
    return {"tokens": tokens}, cache


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the "meta" device: ``init`` builds
    the model's shapes and dtypes without allocating."""

    @property
    def device(self):
        return torch.device("meta")


def abstract_params(cfg: ArchConfig) -> Any:
    """The reference's ``eval_shape`` over init: the family's model built
    on the "meta" device, as the reference's pytree of meta tensors."""
    return convert.params_like(get_api(cfg).init(cfg, _MetaGenerator()))


# -- PartitionSpecs ----------------------------------------------------------------


def batch_pspecs(cfg: ArchConfig, axes: MeshAxes) -> dict:
    D = axes.data if len(axes.data) > 1 else axes.data[0]
    specs = {"tokens": P(D, None)}
    if cfg.family == "encdec":
        specs["frames"] = P(D, None, None)
    if cfg.family == "vlm":
        specs["patches"] = P(D, None, None)
    return specs


def cache_pspecs(cfg: ArchConfig, axes: MeshAxes) -> dict:
    """Decode-cache shardings: batch over data; the model axis goes where
    ``cfg.cache_shard_dim`` says: "seq" (the cache's sequence dim, what
    the shardmap decode splits) or "head" (head_dim)."""
    D = axes.data if len(axes.data) > 1 else axes.data[0]
    M = axes.model
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        if cfg.cache_shard_dim == "head":
            spec = P(None, D, None, None, M)
        else:
            spec = P(None, D, M, None, None)
        return {"k": spec, "v": spec, "pos": P()}
    if fam == "rwkv":
        return {"att_x": P(None, D, None), "att_state": P(None, D, M, None, None),
                "ffn_x": P(None, D, None), "pos": P()}
    if fam == "hybrid":
        return {"conv": P(None, D, None, M), "state": P(None, D, M, None, None),
                "attn_k": P(None, D, None, M, None),
                "attn_v": P(None, D, None, M, None), "pos": P()}
    if fam == "encdec":
        return {"k": P(None, D, M, None, None), "v": P(None, D, M, None, None),
                "xk": P(None, D, None, None, None), "xv": P(None, D, None, None, None),
                "pos": P()}
    raise ValueError(fam)


def params_pspecs(cfg: ArchConfig, axes: MeshAxes) -> Any:
    return param_specs(abstract_params(cfg), axes)
