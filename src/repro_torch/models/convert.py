"""Carry the JAX package's parameters into the port's modules
(:func:`from_jax`) and back out as its pytree (:func:`to_jax`); lay a
train state out as the reference's (:func:`train_state_tree`, what a
checkpoint of either package holds) and write one back in place
(:func:`load_train_state`).

The reference keeps parameters as a dict pytree with every layer's arrays
stacked on a leading L axis (``params["layers"]["attn"]["wq"]`` is
(L, d, H*hd); MoE experts (L, E, d, fe)). The caller hands that pytree over
with numpy arrays at the leaves (``jax.tree_util.tree_map(np.asarray,
params)``), so this module never imports JAX.

Layout: the one place it is decided. Both packages compute ``x @ w`` with
projection weights stored (in, out); the port keeps that layout in plain
``nn.Parameter``s rather than ``nn.Linear`` (whose weight is (out, in)), so
no weight is transposed on the way across. Every port module names its
parameters and submodules as the reference names its keys, and a stacked
key (``layers``, ``first_layers``, ``enc_layers``, ``dec_layers``) is an
``nn.ModuleList`` whose block i takes index i of every leaf below it.
Arrays that are stacked in the port too (experts (E, d, fe), the hybrid's
per-invocation ``inv_proj`` (n_inv, d, d)) are copied whole. A key of the
reference with no home in the port, or a port parameter with no reference
key, raises.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import LM

STACKED = ("layers", "first_layers", "enc_layers", "dec_layers")


def leaf_ndim(name: str, p: torch.Tensor) -> int:
    """The ndim of parameter ``name`` (a ``named_parameters()`` name) as a
    leaf of the reference's pytree: one more than its own inside a stacked
    key, whose leaves carry the layer axis. The reference's AdamW decays,
    and its ``cast_once`` casts, every leaf with ndim >= 2 — so a
    per-layer norm scale or bias, an (L, d) leaf there, counts as 2-D."""
    return p.ndim + (name.split(".", 1)[0] in STACKED)


def _copy(dst: nn.Parameter, src, where: str) -> None:
    src = np.array(src, dtype=np.float32)  # a writable copy
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{where}: shape {src.shape} does not fit "
                         f"{tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(src))


def _names(mod: nn.Module) -> set:
    return {n for n, p in mod._parameters.items() if p is not None} \
        | set(mod._modules)


def _load(mod: nn.Module, tree: dict, where: str, index=None) -> None:
    if _names(mod) != set(tree):
        raise ValueError(f"{where}: reference keys {sorted(tree)} != port's "
                         f"{sorted(_names(mod))}")
    for key, sub in tree.items():
        dst = getattr(mod, key)
        at = f"{where}/{key}"
        if key in STACKED:
            n = len(next(iter(_leaves(sub))))
            if len(dst) != n:
                raise ValueError(f"{at}: {n} reference layers, {len(dst)} "
                                 "in the port")
            for i, blk in enumerate(dst):
                _load(blk, sub, f"{at}[{i}]", i)
        elif isinstance(sub, dict):
            _load(dst, sub, at, index)
        else:
            _copy(dst, sub if index is None else sub[index], at)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _layout(mod: nn.Module, prefix: str = "") -> dict:
    """The reference's pytree of ``mod`` with, at each leaf, a numpy object
    array of the port's parameter names that fill it: 0-d for a parameter
    of its own, (L,) for a stacked key (block i at index i)."""
    out = {}
    for n, p in mod._parameters.items():
        if p is not None:
            out[n] = np.array(prefix + n, dtype=object)
    for n, m in mod._modules.items():
        if n in STACKED:
            out[n] = _stack([_layout(b, f"{prefix}{n}.{i}.")
                             for i, b in enumerate(m)])
        else:
            out[n] = _layout(m, f"{prefix}{n}.")
    return out


def reference_paths(model: nn.Module) -> dict:
    """``{parameter name: its leaf's path in the reference's pytree}``
    ("layers.0.attn.wq" -> "layers/attn/wq"): what the sharding rules
    match."""
    out = {}

    def walk(tree: dict, path: tuple) -> None:
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                out.update((n, "/".join(path + (k,))) for n in v.flat)

    walk(_layout(model), ())
    return out


def _stack(blocks: list) -> dict:
    return {k: _stack([b[k] for b in blocks]) if isinstance(blocks[0][k], dict)
            else np.stack([b[k] for b in blocks]) for k in blocks[0]}


def _map(fn, layout: dict) -> dict:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in layout.items()}


def _gather(names: np.ndarray, values: dict, dtype=None) -> np.ndarray:
    """One leaf of the reference's tree on the host: each named tensor
    copied (synchronously) into its slot of one fresh array, of ``dtype``
    or the tensors' own (a dtype numpy cannot hold raises)."""
    first = values[names.flat[0]]
    if dtype is None:
        dtype = torch.empty(0, dtype=first.dtype).numpy().dtype
    out = np.empty(names.shape + tuple(first.shape), dtype)
    for idx in np.ndindex(names.shape):
        torch.from_numpy(out[idx + (...,)]).copy_(values[names[idx]].detach())
    return out


def _values(model: nn.Module, cfg: ArchConfig, values) -> dict:
    params = dict(model.named_parameters())
    if values is None:
        return params
    missing = set(params) - set(values)
    if missing:
        raise ValueError(f"{cfg.name}: no value for {sorted(missing)}")
    return values


def to_jax(model: nn.Module, cfg: ArchConfig, values=None) -> dict:
    """The inverse of :func:`from_jax`: the model's parameters as the
    reference's pytree, numpy float32 leaves in its stacked layout (block i
    of a stacked key at index i of every leaf below it). ``values``, a dict
    keyed by the names of ``model.named_parameters()`` (the parameters'
    gradients, AdamW's ``m`` or ``v``), lays those tensors out instead.
    ``cfg`` names the model in errors, as for :func:`from_jax`."""
    values = _values(model, cfg, values)
    return _map(lambda names: _gather(names, values, np.float32), _layout(model))


def train_state_tree(model: nn.Module, opt_state: dict, cfg: ArchConfig,
                     params: dict | None = None) -> dict:
    """The train state as the reference's pytree, ``{"params": ...,
    "opt": {"m": ..., "v": ..., "step": int32 0-d}}`` in its stacked
    layout: fresh host arrays in the tensors' own dtypes (a dtype numpy
    cannot hold raises), filled one leaf at a time. What a checkpoint of
    either package holds. ``params`` (keyed as ``model.named_parameters()``)
    stands in for the model's own tensors: a rank mesh's whole ones."""
    layout = _layout(model)

    def tree(values):
        values = _values(model, cfg, values)
        return _map(lambda names: _gather(names, values), layout)

    return {"params": tree(params),
            "opt": {"m": tree(opt_state["m"]), "v": tree(opt_state["v"]),
                    "step": _gather(np.array("step", dtype=object), opt_state)}}


def _like(layout: dict, values: dict) -> dict:
    def meta(names):
        t = values[names.flat[0]]
        return torch.empty(names.shape + tuple(t.shape), dtype=t.dtype,
                           device="meta")
    return _map(meta, layout)


def params_like(model: nn.Module) -> dict:
    """The model's parameters as the reference's pytree of tensors on the
    "meta" device (shapes and dtypes, no data): what the sharding rules
    read (``sharding.param_specs``)."""
    return _like(_layout(model), dict(model.named_parameters()))


def train_state_like(model: nn.Module, opt_state: dict, cfg: ArchConfig,
                     params: dict | None = None) -> dict:
    """:func:`train_state_tree`'s structure, shapes and dtypes as tensors
    on the "meta" device (no data, no copy): the ``like`` of a restore
    (``params`` as there)."""
    layout = _layout(model)

    def like(values):
        return _like(layout, _values(model, cfg, values))

    return {"params": like(params),
            "opt": {"m": like(opt_state["m"]), "v": like(opt_state["v"]),
                    "step": torch.empty((), dtype=opt_state["step"].dtype,
                                        device="meta")}}


def _scatter(names: np.ndarray, src: torch.Tensor, values: dict,
             where: str) -> None:
    """The inverse of :func:`_gather`, in place: slot ``idx`` of ``src``
    into the tensor it names. Shapes and dtypes must agree (nothing is
    cast)."""
    for idx in np.ndindex(names.shape):
        dst, s = values[names[idx]], src[idx]
        if s.dtype != dst.dtype or tuple(s.shape) != tuple(dst.shape):
            raise ValueError(f"{where} -> {names[idx]}: {s.dtype} "
                             f"{tuple(s.shape)} into {dst.dtype} "
                             f"{tuple(dst.shape)}")
        dst.copy_(s)


@torch.no_grad()
def load_train_state(tree: dict, model: nn.Module, opt_state: dict,
                     cfg: ArchConfig,
                     params: dict | None = None) -> tuple[nn.Module, dict]:
    """The inverse of :func:`train_state_tree`, in place: every parameter
    (or ``params``' tensor of its name), AdamW moment and the step take
    their values from ``tree`` (tensors on any device; stacked leaf i into
    block i). Keys, shapes and dtypes must agree (``ValueError``: nothing
    is cast). Returns ``(model, opt_state)``."""
    layout = _layout(model)

    def load(sub: dict, lay: dict, values: dict, where: str):
        if set(sub) != set(lay):
            raise ValueError(f"{where}: keys {sorted(sub)} != the model's "
                             f"{sorted(lay)}")
        for k, names in lay.items():
            if isinstance(names, dict):
                load(sub[k], names, values, f"{where}/{k}")
            else:
                _scatter(names, sub[k], values, f"{where}/{k}")

    load(tree["params"], layout,
         dict(model.named_parameters()) if params is None else params,
         f"{cfg.name} params")
    load(tree["opt"]["m"], layout, opt_state["m"], f"{cfg.name} opt/m")
    load(tree["opt"]["v"], layout, opt_state["v"], f"{cfg.name} opt/v")
    _scatter(np.array("step", dtype=object), tree["opt"]["step"], opt_state,
             f"{cfg.name} opt/step")
    return model, opt_state


def from_jax(params: dict, cfg: ArchConfig, device=None) -> nn.Module:
    """The family's port model holding the reference pytree's weights, on
    ``device``: ``None`` means the CUDA card, and raises without one (as
    ``Session()``); pass ``device="cpu"`` to build it on the CPU."""
    from repro_torch.models.registry import get_api

    dev = resolve_device(device)
    model = get_api(cfg).init(cfg, torch.Generator(device=dev).manual_seed(0))
    _load(model, params, cfg.name)
    return model


def lm_from_jax(params: dict, cfg: ArchConfig, device=None) -> LM:
    """:func:`from_jax` for the transformer families (dense, moe, vlm)."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"lm_from_jax builds a transformer LM, not the "
                         f"{cfg.family!r} family")
    return from_jax(params, cfg, device)
