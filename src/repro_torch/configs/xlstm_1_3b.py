"""xLSTM-1.3B [arXiv:2405.04517; unverified] — mLSTM + sLSTM blocks,
7:1 ratio (one sLSTM per 8-layer super-block), matrix-memory decode.

As configured (d_model 2048, expand 2, 4 heads) the model holds
3,529,631,912 parameters, not 1.3 B: 42 mLSTM layers of 75.5 M (q, k and
v each 4096 x 4096), 6 sLSTM layers of 25.2 M, and the untied embedding
and head of 103 M each."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="xlstm", n_layers=48, d_model=2048,
    n_heads=4, kv_heads=4, d_ff=0, vocab=50304, expand=2, slstm_every=8,
    remat="layer",
    grad_accum=2,
)
SMOKE = dataclasses.replace(
    CONFIG, name="xlstm-smoke", n_layers=4, d_model=32, n_heads=4,
    kv_heads=4, vocab=512, slstm_every=2, block_q=16, block_k=16)
