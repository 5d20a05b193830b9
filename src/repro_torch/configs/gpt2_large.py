"""GPT-2 large-sized stand-in (774M: 36L, d=1280, ff=5120) — paper Table 10."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gpt2-large", family="dense", n_layers=36, d_model=1280,
    n_heads=20, kv_heads=20, d_ff=5120, vocab=50257, head_dim=64,
    norm="layernorm", mlp="gelu", tie_embeddings=True,
    remat="layer",
)
SMOKE = dataclasses.replace(
    CONFIG, name="gpt2-large-smoke", n_layers=2, d_model=64, n_heads=4,
    kv_heads=4, d_ff=128, vocab=512, head_dim=16, block_q=16, block_k=16)
