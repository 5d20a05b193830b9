"""Qwen2-0.5B [arXiv:2407.10671; hf] — dense GQA with QKV bias."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b", family="dense", n_layers=24, d_model=896,
    n_heads=14, kv_heads=2, d_ff=4864, vocab=151936, head_dim=64,
    qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=True,
    remat="layer",
)
SMOKE = dataclasses.replace(
    CONFIG, name="qwen2-smoke", n_layers=2, d_model=56, n_heads=7,
    kv_heads=1, d_ff=96, vocab=512, head_dim=8, block_q=16, block_k=16)
