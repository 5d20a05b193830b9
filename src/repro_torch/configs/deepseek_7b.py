"""DeepSeek-7B (base) [arXiv:2401.02954; hf] — llama-arch MHA."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b", family="dense", n_layers=30, d_model=4096,
    n_heads=32, kv_heads=32, d_ff=11008, vocab=102400, head_dim=128,
    remat="layer",
)
SMOKE = dataclasses.replace(
    CONFIG, name="deepseek-smoke", n_layers=2, d_model=64, n_heads=4,
    kv_heads=4, d_ff=128, vocab=512, head_dim=16, block_q=16, block_k=16)
