"""Architecture config schema (a copy of ``repro.configs.base.ArchConfig``).

Every ported architecture gets a module in this package exposing
``CONFIG`` (the exact published config) and ``SMOKE`` (a reduced config of
the same family for CPU tests).  The field set, defaults and derived
properties match the JAX package's, so one config describes the same
model in both.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | encdec | vlm | xlstm
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # defaults to d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    mlp: str = "swiglu"              # swiglu | gelu
    max_seq_len: int = 524_288       # rope table upper bound
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0        # deepseek-moe fine-grained shared experts
    moe_d_ff: int = 0                # per-expert hidden size
    dense_residual: bool = False     # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    first_layer_dense: bool = False  # deepseek-moe layer 0 is dense

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    conv_width: int = 4
    attn_every: int = 6              # zamba2: shared attention applied every N blocks
    expand: int = 2

    # --- xLSTM ---
    slstm_every: int = 8             # one sLSTM block per this many layers

    # --- enc-dec ---
    enc_layers: int = 0
    dec_layers: int = 0

    # --- VLM ---
    vision_tokens: int = 0           # patch embeddings prepended (stub frontend)

    # --- attention impl knobs (perf hillclimbing) ---
    attention_impl: str = "chunked"  # chunked | full | pallas
    attention_balanced: bool = False # causal load-balanced schedule
    block_q: int = 512
    block_k: int = 512
    ce_chunk: int = 512              # chunked cross-entropy block (0 = naive)
    remat: str = "none"              # none | layer  (activation checkpointing)
    grad_accum: int = 1              # microbatches per step (activation peak / N)
    vocab_pad_multiple: int = 128    # pad embed/head vocab dim for TP divisibility

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab + m - 1) // m * m if m else self.vocab

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context? (SSM/hybrid/linear-attn)"""
        return self.family in ("hybrid", "xlstm")
