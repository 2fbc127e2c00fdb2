"""Zamba2-1.2B [arXiv:2411.15242; hf] — Mamba2 (SSD) backbone + ONE
shared-weight attention block (input: concat(hidden, embedding), 2·d wide)
applied every 6 blocks, each invocation with its own output linear."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    attn_every=6,
)
