"""InternVL2-26B [arXiv:2404.16821; hf] — InternLM2-20B LM backbone;
the InternViT frontend is a STUB (input_specs supplies 256 patch
embeddings per image)."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm", n_layers=48, d_model=6144,
    n_heads=48, kv_heads=8, d_ff=16384, vocab=92553, head_dim=128,
    vision_tokens=256,
    remat="layer",
    grad_accum=2,
)
SMOKE = dataclasses.replace(
    CONFIG, name="internvl2-smoke", n_layers=2, d_model=64, n_heads=4,
    kv_heads=2, d_ff=128, vocab=512, head_dim=16, vision_tokens=8,
    block_q=16, block_k=16)
