"""The port's device rule, shared by every entry point: ``None`` means the
CUDA card, and without one the entry point raises rather than quietly
running on the CPU; ``device="cpu"`` asks for the CPU (the tests do)."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; without one, raise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless told "
            "otherwise; pass device='cpu' to run on the CPU")
    return dev
