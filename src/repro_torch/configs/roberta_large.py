"""RoBERTa-large-sized stand-in (355M: 24L, d=1024, ff=4096)."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="roberta-large", family="dense", n_layers=24, d_model=1024,
    n_heads=16, kv_heads=16, d_ff=4096, vocab=50265, head_dim=64,
    norm="layernorm", mlp="gelu", tie_embeddings=True,
    remat="layer",
)
SMOKE = dataclasses.replace(
    CONFIG, name="roberta-large-smoke", n_layers=2, d_model=64, n_heads=4,
    kv_heads=4, d_ff=128, vocab=512, head_dim=16, block_q=16, block_k=16)
