"""Group decomposition for the hybrid stack (port of
``repro.models.hybrid_groups``): the zamba2 layer loop is ``n_invocations``
groups, each one shared-attention application followed by the group's SSD
blocks."""
from __future__ import annotations

from repro_torch.models.config import ArchConfig


def group_bounds(cfg: ArchConfig) -> list[tuple[int, int]]:
    """[(start, end)) layer ranges; a shared-attn invocation precedes each."""
    out = []
    s = 0
    while s < cfg.n_layers:
        out.append((s, min(s + cfg.attn_every, cfg.n_layers)))
        s += cfg.attn_every
    return out
