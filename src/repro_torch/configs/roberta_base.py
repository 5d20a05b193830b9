"""RoBERTa-base-sized decoder stand-in for paper Tables 1/5/8 accounting
(125M params: 12L, d=768, ff=3072, vocab 50265) — layernorm, gelu and a
tied embedding head."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="roberta-base", family="dense", n_layers=12, d_model=768,
    n_heads=12, kv_heads=12, d_ff=3072, vocab=50265, head_dim=64,
    norm="layernorm", mlp="gelu", tie_embeddings=True,
    remat="layer",
)
SMOKE = dataclasses.replace(
    CONFIG, name="roberta-base-smoke", n_layers=2, d_model=64, n_heads=4,
    kv_heads=4, d_ff=128, vocab=512, head_dim=16, block_q=16, block_k=16)
