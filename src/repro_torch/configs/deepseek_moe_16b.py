"""DeepSeek-MoE 16B [arXiv:2401.06066; hf] — fine-grained MoE: 2 shared +
64 routed experts, top-6, first layer dense."""
from repro_torch.models.config import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400, d_head=128,
    rope_theta=10_000.0,
    moe=MoESpec(num_experts=64, top_k=6, num_shared=2, d_ff_expert=1408,
                first_dense_layers=1),
)
