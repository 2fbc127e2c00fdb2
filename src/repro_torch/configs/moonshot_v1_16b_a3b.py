"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B] — kimi/moonlight,
64 routed experts top-6 + 2 shared, deepseek-moe-style."""
from repro_torch.models.config import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=163840, d_head=128,
    rope_theta=50_000.0,
    moe=MoESpec(num_experts=64, top_k=6, num_shared=2, d_ff_expert=1408,
                first_dense_layers=1),
)
