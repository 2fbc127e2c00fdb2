"""Assigned architectures (public-literature configs) + the paper's own LM.

Each module exports CONFIG: ArchConfig with the exact published numbers from
the assignment block; ``get_config(name)`` resolves by id.
"""
from __future__ import annotations

import importlib

ALL_ARCHS = [
    "deepseek-moe-16b",
    "moonshot-v1-16b-a3b",
    "qwen2.5-14b",
    "qwen2-72b",
    "qwen3-1.7b",
    "command-r-35b",
    "rwkv6-1.6b",
    "whisper-base",
    "llava-next-mistral-7b",
    "zamba2-1.2b",
]

_MODULES = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen2-72b": "qwen2_72b",
    "qwen3-1.7b": "qwen3_1_7b",
    "command-r-35b": "command_r_35b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "whisper-base": "whisper_base",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "zamba2-1.2b": "zamba2_1_2b",
    "paper-lm": "paper_lm",
}


def get_config(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
