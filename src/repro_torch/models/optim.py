"""AdamW with a global-norm clip and a warmup-cosine schedule (port of
``repro.models.optim``), as plain functions over tensors.

``torch.optim`` is not used: the state keeps the reference's shape,
``{"m": {name: tensor}, "v": {name: tensor}, "step": int32 0-d tensor}``
with one float32 moment per parameter, keyed by the parameter's name in
``model.named_parameters()`` (``convert.to_jax`` lays such a dict out as
the reference's pytree). The update follows the reference's arithmetic:
the bias corrections in float32 from the int32 step, decoupled weight
decay on parameters whose leaf in the reference's stacked pytree has
``ndim >= 2`` (``convert.leaf_ndim``: a per-layer norm scale or bias
decays, as there; the final norm does not), ``p - lr * delta`` in float32
cast back to the parameter's dtype, the clip by a float32 global norm.

Where the reference returns new trees, the port updates the parameters, the
gradients (clipped) and the moments in place (``torch._foreach_*`` over
each dtype's list), under ``torch.no_grad()``: at qwen3-1.7b's 2.03B
parameters the moments and the gradients are 24 GB beside the 8.1 GB of
weights, and a second copy of any of them would not fit the card's 80 GB
beside the activations.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.engine import distributed as D
from repro_torch.models.convert import leaf_ndim
from repro_torch.models.sharding import current_ctx, spread


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def init_opt_state(model: nn.Module) -> dict:
    """Zero float32 moments beside every parameter, on its device, and the
    int32 step 0."""
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    return {"m": {n: torch.zeros_like(p, dtype=torch.float32)
                  for n, p in params.items()},
            "v": {n: torch.zeros_like(p, dtype=torch.float32)
                  for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def schedule(cfg: OptimConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_ratio * lr``
    at ``total_steps``; float32, on the step's device."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


_SPREADS = ("data", "model", "all")


def global_norm(tensors, spreads=None) -> torch.Tensor:
    """The float32 L2 norm over all the tensors (the norm of their
    norms). On a rank mesh ``spreads`` gives, per tensor, the axes over
    which the ranks hold distinct blocks of it (``sharding.spread``:
    "data", "model", "all", or None for a whole one): the squared norms of
    each kind are ``psum``-ed over those axes only, so every block, and
    every whole tensor, is counted once."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    if spreads is None:
        return torch.linalg.vector_norm(torch.stack(norms))
    ctx = current_ctx()
    sq = {k: torch.zeros((), dtype=torch.float32, device=norms[0].device)
          for k in (None,) + _SPREADS}
    for n, k in zip(norms, spreads):
        sq[k] = sq[k] + n.square()
    total = sq[None]
    for k in _SPREADS:   # the same order on every rank
        total = total + D.psum(sq[k], group=ctx.group(k))
    return total.sqrt()


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, spreads=None) -> torch.Tensor:
    """Scale ``grads`` in place by min(1, max_norm / norm); returns the
    norm before the clip (``spreads``: :func:`global_norm`'s)."""
    grads = list(grads)
    norm = global_norm(grads, spreads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    torch._foreach_mul_(grads, scale)
    return norm


@torch.no_grad()
def adamw_update(model: nn.Module, state: dict, cfg: OptimConfig) -> dict:
    """One AdamW step from the gradients in ``p.grad``, writing the
    parameters and ``state``'s moments and step in place (on a rank mesh:
    this rank's blocks of each, the clip by the norm over every rank). The gradients
    are consumed: clipped in place, then their float32 buffers hold each
    parameter's update (the caller drops them after the step). Returns
    ``{"grad_norm", "lr"}`` (0-d float32 tensors), as the reference's
    metrics."""
    params = dict(model.named_parameters())
    grads = [p.grad for p in params.values()]
    if any(g is None for g in grads):
        missing = [n for n, p in params.items() if p.grad is None]
        raise ValueError(f"adamw_update: no gradient for {missing}")
    ctx = current_ctx()
    spreads = None
    if ctx is not None and ctx.ranked:
        where = spread(model)
        spreads = [where.get(n) for n in params]
    gnorm = clip_by_global_norm(grads, cfg.clip_norm, spreads)
    state["step"] += 1
    step = state["step"].float()
    lr = schedule(cfg, state["step"])
    b1, b2 = cfg.betas
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=step.device), step)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=step.device), step)
    names = list(params)
    m = [state["m"][n] for n in names]
    v = [state["v"][n] for n in names]
    g32 = [g.float() for g in grads]  # the gradients themselves when float32
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, g32, alpha=1 - b1)           # b1 m + (1 - b1) g
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, g32, g32, value=1 - b2)  # b2 v + (1 - b2) g^2
    for n, p, mi, vi in zip(names, params.values(), m, v):
        # delta = (m / bc1) / (sqrt(v / bc2) + eps) [+ wd p]; reuses the
        # gradient's buffer (dead after the moments) when it is float32
        g = p.grad
        delta = torch.div(vi, bc2, out=g if g.dtype == torch.float32 else None)
        delta.sqrt_().add_(cfg.eps)
        delta = torch.div(mi / bc1, delta, out=delta)
        if leaf_ndim(n, p) >= 2:
            delta.add_(p.float(), alpha=cfg.weight_decay)
        delta.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p.float() - delta)
    return {"grad_norm": gnorm, "lr": lr}
