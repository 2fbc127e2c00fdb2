"""Qwen3-1.7B [hf:Qwen/Qwen3-*] — qk_norm, GQA, no bias."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=6144, vocab=151936, d_head=128,
    qk_norm=True, rope_theta=1_000_000.0,
)
