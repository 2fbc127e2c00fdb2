"""RWKV6 "Finch" 1.6B [arXiv:2404.05892; unverified] — attention-free,
data-dependent decay."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="rwkv",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65536,
    rwkv_head_dim=64, rwkv_lora=64,
)
