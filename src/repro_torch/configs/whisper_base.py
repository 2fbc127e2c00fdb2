"""Whisper-base [arXiv:2212.04356; unverified] — enc-dec; conv frontend is a
STUB (input_specs supplies precomputed (B, 1500, 512) frame embeddings)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="encdec",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, d_head=64,
    qkv_bias=True, tie_embeddings=True,
    enc_layers=6, enc_len=1500,
)
