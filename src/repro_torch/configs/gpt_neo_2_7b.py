"""GPT-Neo 2.7B-sized stand-in (32L, d=2560, ff=10240) — paper Table 11."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gpt-neo-2.7b", family="dense", n_layers=32, d_model=2560,
    n_heads=20, kv_heads=20, d_ff=10240, vocab=50257, head_dim=128,
    norm="layernorm", mlp="gelu", tie_embeddings=True,
    remat="layer",
)
SMOKE = dataclasses.replace(
    CONFIG, name="gpt-neo-smoke", n_layers=2, d_model=64, n_heads=4,
    kv_heads=4, d_ff=128, vocab=512, head_dim=16, block_q=16, block_k=16)
