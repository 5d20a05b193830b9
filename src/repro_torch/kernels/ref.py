"""Plain PyTorch versions of the attention kernels.

Each function computes what its CUDA kernel in ``csrc/flash_attention.cu``
computes, in the JAX package's own arithmetic: fp32 scores, masked scores
filled with the finite ``-1e30`` (never ``-inf``), a full fp32 softmax,
probabilities cast to the input dtype before the product with V, output in
q's dtype.  The wrappers in ``kernels.flash_attention`` call these on CPU
tensors; the CPU tests hold them against the JAX package, and
``chip_smoke.py`` holds each kernel against them on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.layers import _repeat_kv

NEG = -1e30


def _softmax_pv(sc: torch.Tensor, v: torch.Tensor, eq: str,
                dtype: torch.dtype) -> torch.Tensor:
    probs = torch.softmax(sc, dim=-1).to(dtype)
    return torch.einsum(eq, probs, v)


def flash_attention_ref(q, k, v, starts: Optional[torch.Tensor] = None,
                        causal: bool = True) -> torch.Tensor:
    """Prefill attention.  q (B,S,H,hd); k/v (B,S,KV,hd); starts (B,) int.

    Key j is visible to query i iff ``j <= i`` (causal) and
    ``j >= starts[b]`` (left pad) — the masking of
    ``repro.models.layers.chunked_causal_attention(..., k_valid=)``.
    Rows at pad positions see no key and come out as finite garbage, as in
    JAX; callers read valid rows only."""
    b, s, h, hd = q.shape
    n_rep = h // k.shape[2]
    kk, vv = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    scale = 1.0 / math.sqrt(hd)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, kk).float() * scale
    pos = torch.arange(s, device=q.device)
    valid = torch.ones((b, s, s), dtype=torch.bool, device=q.device)
    if causal:
        valid = valid & (pos[None, :, None] >= pos[None, None, :])
    if starts is not None:
        valid = valid & (pos[None, None, :] >= starts.long()[:, None, None])
    sc = torch.where(valid[:, None], sc, torch.full_like(sc, NEG))
    return _softmax_pv(sc, vv, "bhqk,bkhd->bqhd", q.dtype)


def flash_decode_ref(q, k, v, lengths: torch.Tensor,
                     starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One query per row against a contiguous cache.

    q (B,H,hd); k/v (B,S,KV,hd); keys at positions ``[starts[b],
    lengths[b])`` attend (``repro.models.layers.gqa_decode_attention``'s
    softmax with starts = pad, lengths = position + 1)."""
    b, s, kvh, hd = k.shape
    n_rep = q.shape[1] // kvh
    kk, vv = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    scale = 1.0 / math.sqrt(hd)
    sc = torch.einsum("bhd,bkhd->bhk", q, kk).float() * scale
    pos = torch.arange(s, device=q.device)[None, :]
    valid = pos < lengths.long()[:, None]
    if starts is not None:
        valid = valid & (pos >= starts.long()[:, None])
    sc = torch.where(valid[:, None, :], sc, torch.full_like(sc, NEG))
    return _softmax_pv(sc, vv, "bhk,bkhd->bhd", q.dtype)


def paged_flash_decode_ref(q, k_pool, v_pool, block_tables: torch.Tensor,
                           lengths: torch.Tensor,
                           starts: Optional[torch.Tensor] = None):
    """One query per row against a paged cache.

    q (B,H,hd); pools (n_blocks, block_size, KV, hd); block_tables
    (B, max_blocks) int.  Gathers each row's pages into a contiguous view
    and attends as :func:`flash_decode_ref` — the pure-jnp attention of
    ``repro.models.transformer.paged_decode_step``."""
    _, bs, kvh, hd = k_pool.shape
    b, max_blocks = block_tables.shape
    cap = max_blocks * bs
    tables = block_tables.long()
    kk = k_pool[tables].reshape(b, cap, kvh, hd)
    vv = v_pool[tables].reshape(b, cap, kvh, hd)
    return flash_decode_ref(q, kk, vv, lengths, starts)
