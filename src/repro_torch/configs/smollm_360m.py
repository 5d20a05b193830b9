"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-360M] — small llama-arch GQA."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m", family="dense", n_layers=32, d_model=960,
    n_heads=15, kv_heads=5, d_ff=2560, vocab=49152, head_dim=64,
    remat="layer",
    grad_accum=2,
)
SMOKE = dataclasses.replace(
    CONFIG, name="smollm-smoke", n_layers=2, d_model=48, n_heads=3,
    kv_heads=1, d_ff=96, vocab=512, head_dim=16, block_q=16, block_k=16)
