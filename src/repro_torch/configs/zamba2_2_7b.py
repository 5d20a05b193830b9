"""Zamba2-2.7B [arXiv:2411.15242; hf] — Mamba2 stack + shared attention
block every 6 layers (54 = 9 super-blocks).  d_inner = 2*2560 = 5120,
80 SSM heads of dim 64, state 64."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, kv_heads=32, d_ff=10240, vocab=32000, head_dim=80,
    ssm_state=64, ssm_heads=80, ssm_head_dim=64, conv_width=4,
    attn_every=6, expand=2,
    remat="layer",
    grad_accum=2,
)
SMOKE = dataclasses.replace(
    CONFIG, name="zamba2-smoke", n_layers=4, d_model=64, n_heads=4,
    kv_heads=4, d_ff=128, vocab=512, head_dim=16, ssm_state=16,
    ssm_heads=8, ssm_head_dim=16, attn_every=2, block_q=16, block_k=16)
