"""Qwen2.5-14B [hf:Qwen/Qwen2.5-*] — dense GQA with QKV bias."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=13824, vocab=152064, d_head=128,
    qkv_bias=True, rope_theta=1_000_000.0,
)
