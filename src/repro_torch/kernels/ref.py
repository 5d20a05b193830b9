"""Plain PyTorch versions of the hand-written kernels.

Attention (``csrc/flash_attention.cu``), in the JAX package's own
arithmetic: fp32 scores, masked scores filled with the finite ``-1e30``
(never ``-inf``), a full fp32 softmax, probabilities cast to the input
dtype before the product with V, output in q's dtype.

Fused optimizer updates (``csrc/fused_update.cu``), one leaf at a time, in
the reference's operation order (``repro.kernels.ref``, ``repro.optim``):
fp32 math, each output stored in its input's dtype (rounded to nearest
even for bfloat16).  Each operation is one eager op, so nothing is
contracted into a fused multiply-add; the bias corrections divide by a
0-d tensor on the leaf's device, which PyTorch divides elementwise (a
Python-float divisor may be turned into a multiply by its reciprocal on
CUDA).  These are also the unfused updates of ``repro_torch.optim``.

Dequant matmul (``csrc/dequant_matmul.cu``): the codec's own decode of
the view, rounded through the template dtype and ``x.dtype``, then one
fp32 product cast to ``x.dtype``.

The wrappers call these on CPU tensors; the CPU tests hold them against
the JAX package, and ``chip_smoke.py`` holds each kernel against them on
the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.layers import NEG, _repeat_kv


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


# ------------------------------------------------------- fused updates

def _divisor(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def fused_adamw_ref(p, g, m, v, *, lr, b1, b2, eps, weight_decay, c1, c2):
    """Elementwise AdamW with bias-corrected moments; returns new
    (p, m, v), each in its input's dtype."""
    g32 = g.float()
    m_ = b1 * m.float() + (1.0 - b1) * g32
    v_ = b2 * v.float() + (1.0 - b2) * torch.square(g32)
    mhat = m_ / _divisor(c1, m_)
    vhat = v_ / _divisor(c2, v_)
    p32 = p.float()
    step = lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p32)
    return (p32 - step).to(p.dtype), m_.to(m.dtype), v_.to(v.dtype)


def fused_sgdm_ref(p, g, mu, *, lr, momentum, weight_decay):
    """Heavy-ball SGD, weight decay folded into the gradient; returns new
    (p, mu)."""
    p32 = p.float()
    g32 = g.float() + weight_decay * p32
    mu_ = momentum * mu.float() + g32
    return (p32 - lr * mu_).to(p.dtype), mu_.to(mu.dtype)


def fused_adagrad_ref(p, g, a, *, lr, eps, weight_decay):
    """AdaGrad, weight decay folded into the gradient before squaring;
    returns new (p, a)."""
    p32 = p.float()
    g32 = g.float() + weight_decay * p32
    a_ = a.float() + torch.square(g32)
    step = lr * g32 / (torch.sqrt(a_) + eps)
    return (p32 - step).to(p.dtype), a_.to(a.dtype)


# ------------------------------------------------------- dequant matmul

def dequant_matmul_ref(x: torch.Tensor, w) -> torch.Tensor:
    """``x (M, K) @ dequant(w)`` for a ``dist.quant.QuantView`` ``w``:
    decode with the codec (template dtype), round through ``x.dtype`` (the
    model's ``w.astype(x.dtype)``), fp32 product, cast to ``x.dtype`` —
    ``repro.kernels.ref.dequant_matmul_ref`` for the dtypes the model
    pairs."""
    w32 = w.decode().to(x.dtype).float()
    return (x.float() @ w32).to(x.dtype)
