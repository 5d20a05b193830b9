"""DeepSeekMoE-16B [arXiv:2401.06066; hf] — fine-grained 64 routed top-6
+ 2 shared experts, expert d_ff=1408.  (The release's dense layer 0 is
modeled as MoE like the rest — recorded in DESIGN.md.)"""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
    n_heads=16, kv_heads=16, d_ff=1408, vocab=102400, head_dim=128,
    n_experts=64, top_k=6, n_shared_experts=2, moe_d_ff=1408,
    remat="layer",
    grad_accum=2,
)
SMOKE = dataclasses.replace(
    CONFIG, name="deepseek-moe-smoke", n_layers=2, d_model=64, n_heads=4,
    kv_heads=4, d_ff=32, vocab=512, head_dim=16, n_experts=8, top_k=2,
    n_shared_experts=1, moe_d_ff=32, block_q=16, block_k=16)
