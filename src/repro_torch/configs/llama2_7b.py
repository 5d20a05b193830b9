"""LLaMA2-7B — the paper's main memory-profiling model (Table 12)."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama2-7b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, kv_heads=32, d_ff=11008, vocab=32000, head_dim=128,
    remat="layer",
)
SMOKE = dataclasses.replace(
    CONFIG, name="llama2-smoke", n_layers=2, d_model=64, n_heads=4,
    kv_heads=4, d_ff=128, vocab=512, head_dim=16, block_q=16, block_k=16)
