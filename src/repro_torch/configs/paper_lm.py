"""The paper's own "model UDF" stand-in: a ~100M dense LM used by the
sentiment-pipeline example and the model-UDF benchmark (AFrame §III-C applies
sklearn/CoreNLP models; our engine UDFs are JAX models)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="paper-lm", family="dense",
    n_layers=8, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=32000, d_head=64,
    rope_theta=10_000.0, loss_chunk=512, chunk_q=128,
)
