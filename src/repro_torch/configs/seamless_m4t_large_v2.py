"""SeamlessM4T-large-v2 backbone [arXiv:2308.11596; hf] — enc-dec
24+24 layers; the audio frontend is a STUB (input_specs supplies
precomputed frame embeddings)."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec", n_layers=48,
    d_model=1024, n_heads=16, kv_heads=16, d_ff=8192, vocab=256206,
    head_dim=64, enc_layers=24, dec_layers=24, norm="layernorm",
    remat="layer",
)
SMOKE = dataclasses.replace(
    CONFIG, name="seamless-smoke", n_layers=4, d_model=64, n_heads=4,
    kv_heads=4, d_ff=128, vocab=512, head_dim=16, enc_layers=2,
    dec_layers=2, block_q=16, block_k=16)
