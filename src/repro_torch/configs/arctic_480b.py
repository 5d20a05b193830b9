"""Snowflake Arctic (480B) [hf:Snowflake/snowflake-arctic-base] —
128 routed experts top-2 in parallel with a dense residual FFN."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe", n_layers=35, d_model=7168,
    n_heads=56, kv_heads=8, d_ff=4864, vocab=32000, head_dim=128,
    n_experts=128, top_k=2, moe_d_ff=4864, dense_residual=True,
    remat="layer",
    grad_accum=8,
)
SMOKE = dataclasses.replace(
    CONFIG, name="arctic-smoke", n_layers=2, d_model=64, n_heads=8,
    kv_heads=2, d_ff=48, vocab=512, head_dim=8, n_experts=8, top_k=2,
    moe_d_ff=48, block_q=16, block_k=16)
