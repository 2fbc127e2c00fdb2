"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf;
unverified] — anyres vision tower is a STUB (input_specs supplies CLIP-L
patch embeddings, 576 patches, 1024-d); backbone is the Mistral-7B GQA
decoder."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, d_head=128,
    rope_theta=1_000_000.0,
    num_patches=576, patch_dim=1024,
)
