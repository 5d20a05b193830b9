"""Shared layers over param dicts (PyTorch port of ``repro.models.layers``).

Conventions match the JAX package: params are nested dicts of tensors,
activations (B, S, D), attention heads (B, S, H, hd), weights ``x @ W``
(in, out).  Init helpers take an explicit ``torch.Generator``; they draw
other numbers than ``jax.random`` from the same seed, so tests that compare
the two frameworks bridge the JAX params instead of re-initialising.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.dist import quant as Q
from repro_torch.dist.quant import QuantView


# ------------------------------------------------------------------ linear

def linear(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a weight tensor (cast to ``x.dtype`` at use, as in JAX)
    or a codec view (``dist.quant.QuantView``), whose product goes through
    ``kernels.dequant_matmul`` — on the card a hand-written kernel that
    decodes the codes inside the product."""
    if isinstance(w, QuantView):
        # imported on use: the kernels' plain versions import this module
        from repro_torch.kernels.dequant_matmul import dequant_matmul
        y = dequant_matmul(x.reshape(-1, x.shape[-1]), w)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    return x @ w.to(x.dtype)


def weight(w):
    """A 2-d weight for :func:`linear`: the tensor itself, or a codec
    record (quantized residency) as its ``QuantView``."""
    return Q.view_of(w) if Q.is_quantized(w) else w


def decoded(w) -> torch.Tensor:
    """A leaf used whole (elementwise, or in a product of its own): the
    tensor itself, or a frozen layer's codec view (quantized residency)
    decoded here, inside the layer's forward (and again in its
    checkpointed recompute), so no decoded copy outlives its use."""
    return w.decode() if isinstance(w, QuantView) else w


def embed_lookup(tok, tokens: torch.Tensor) -> torch.Tensor:
    """Rows ``tokens`` of the embedding table; of a codec record, the
    gathered rows of its codes and scales, decoded."""
    return Q.gather_rows(tok, tokens) if Q.is_quantized(tok) else tok[tokens]


# ---------------------------------------------------------------- init utils
#
# ``lead`` prepends dims to every leaf: ``lead=(n_layers,)`` draws a whole
# stack of layers at once, in the stacked layout the model keeps.

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               scale: Optional[float] = None, *, lead=(), device=None,
               dtype=torch.float32) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn((*lead, in_dim, out_dim), generator=gen, device=device,
                    dtype=dtype)
    return w.mul_(scale)


def embed_init(gen: torch.Generator, vocab: int, dim: int, *, device=None,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, device=device, dtype=dtype)
    return w.mul_(0.02)


def rmsnorm_init(dim: int, *, lead=(), device=None, dtype=torch.float32):
    return {"scale": torch.ones((*lead, dim), device=device, dtype=dtype)}


def layernorm_init(dim: int, *, lead=(), device=None, dtype=torch.float32):
    return {"scale": torch.ones((*lead, dim), device=device, dtype=dtype),
            "bias": torch.zeros((*lead, dim), device=device, dtype=dtype)}


def gqa_attention_init(gen, d_model: int, n_heads: int, kv_heads: int,
                       head_dim: Optional[int] = None, qkv_bias: bool = False,
                       *, lead=(), device=None, dtype=torch.float32):
    hd = head_dim or d_model // n_heads
    kw = dict(lead=lead, device=device, dtype=dtype)
    p = {
        "wq": dense_init(gen, d_model, n_heads * hd, **kw),
        "wk": dense_init(gen, d_model, kv_heads * hd, **kw),
        "wv": dense_init(gen, d_model, kv_heads * hd, **kw),
        "wo": dense_init(gen, n_heads * hd, d_model, **kw),
    }
    if qkv_bias:
        zkw = dict(device=device, dtype=dtype)
        p["bq"] = torch.zeros((*lead, n_heads * hd), **zkw)
        p["bk"] = torch.zeros((*lead, kv_heads * hd), **zkw)
        p["bv"] = torch.zeros((*lead, kv_heads * hd), **zkw)
    return p


def swiglu_init(gen, d_model: int, d_ff: int, *, lead=(), device=None,
                dtype=torch.float32):
    kw = dict(lead=lead, device=device, dtype=dtype)
    return {"w_gate": dense_init(gen, d_model, d_ff, **kw),
            "w_up": dense_init(gen, d_model, d_ff, **kw),
            "w_down": dense_init(gen, d_ff, d_model, **kw)}


def gelu_mlp_init(gen, d_model: int, d_ff: int, *, lead=(), device=None,
                  dtype=torch.float32):
    kw = dict(lead=lead, device=device, dtype=dtype)
    zkw = dict(device=device, dtype=dtype)
    return {"w_up": dense_init(gen, d_model, d_ff, **kw),
            "b_up": torch.zeros((*lead, d_ff), **zkw),
            "w_down": dense_init(gen, d_ff, d_model, **kw),
            "b_down": torch.zeros((*lead, d_model), **zkw)}


# --------------------------------------------------------------------- norms

def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * p["scale"].float()
    return out.to(x.dtype)


def layernorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps) * p["scale"].float() \
        + p["bias"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------- RoPE

def rope_frequencies(head_dim: int, max_len: int, theta: float = 10000.0,
                     device=None):
    """(cos, sin), each (max_len, hd/2) float32 — split-half RoPE tables."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (max_len, hd/2); positions: (B, S) or None.

    cos/sin are cast to ``x.dtype`` before the multiply, as in JAX."""
    if positions is None:
        c = cos[: x.shape[1]][None, :, None, :]
        s = sin[: x.shape[1]][None, :, None, :]
    else:
        c = cos[positions][:, :, None, :]
        s = sin[positions][:, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    c = c.to(x.dtype)
    s = s.to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, KV*n_rep, hd) by head repetition (GQA).

    Used by the plain attention versions only: the kernels map each query
    head to its kv head by index and never repeat kv in memory."""
    if n_rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(
        b, s, kv * n_rep, hd)


# ------------------------------------------------------ training attention
#
# The reference trains through the pure-jnp ``chunked_causal_attention``
# (``attention_impl="chunked"`` by default); its Pallas flash kernel has no
# backward, so the port's training forward has no kernel here either.

NEG = -1e30


def full_causal_attention(q, k, v):
    """Reference O(S^2)-memory attention.  q/k/v: (B, S, H, hd)."""
    b, s, h, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    scores = torch.where(mask[None, None], scores,
                         torch.full_like(scores, NEG))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _q_block_attention(q_block, k, v, qi: int, block_q: int, block_k: int,
                       nk: int, scale: float, causal: bool = True):
    """Online softmax of one query block over the kv blocks it can see
    (every one of the ``nk`` blocks when not ``causal``).

    Kv blocks wholly in its future are skipped: in the reference they
    contribute exact zeros (``exp(-1e30 - m) == 0``, ``corr == 1``), so
    skipping them changes no bit of the result."""
    b, bq, h, hd = q_block.shape
    m = torch.full((b, h, bq), NEG, dtype=torch.float32, device=q_block.device)
    l = torch.zeros((b, h, bq), dtype=torch.float32, device=q_block.device)
    acc = torch.zeros((b, h, bq, hd), dtype=torch.float32,
                      device=q_block.device)
    q_pos = qi * block_q + torch.arange(block_q, device=q_block.device)
    last = (qi * block_q + block_q - 1) // block_k if causal else nk - 1
    for kj in range(min(nk, last + 1)):
        k_block = k[:, kj * block_k:(kj + 1) * block_k]
        v_block = v[:, kj * block_k:(kj + 1) * block_k]
        sc = torch.einsum("bqhd,bkhd->bhqk", q_block, k_block).float() * scale
        if causal:
            k_pos = kj * block_k + torch.arange(block_k,
                                                device=q_block.device)
            seen = q_pos[:, None] >= k_pos[None, :]
            sc = torch.where(seen[None, None], sc, torch.full_like(sc, NEG))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(q_block.dtype), v_block).float()
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q_block.dtype)


def chunked_causal_attention(q, k, v, block_q: int = 512, block_k: int = 512,
                             balanced: bool = False):
    """Flash-style online-softmax causal attention in plain torch (the
    reference's default training attention).  q/k/v: (B, S, H, hd), kv
    heads already repeated.

    Each query block runs under ``torch.utils.checkpoint``, so its block
    score matrices are recomputed in the backward instead of saved — the
    reference's ``jax.checkpoint`` around ``per_q``.

    ``balanced=True`` is the reference's causal load-balancing schedule,
    which needs as many q blocks as kv blocks.  The reference pairs q
    blocks ``(i, n-1-i)`` so that a fixed-length ``lax.scan`` of ``n+1``
    steps does no fully masked block product; each block of a pair still
    sums kv blocks ``0..i`` in order.  This loop already stops at the
    diagonal for every q block, in that order, so eager torch needs no
    pairing: both schedules run the same per-block loop here.  (At an odd
    block count the reference's stitching hands each block above the
    middle the output of the block below it; this computes the
    attention.)"""
    b, s, h, hd = q.shape
    nq = max(1, s // block_q)
    nk = max(1, s // block_k)
    if balanced and nq != nk:
        raise ValueError("the balanced schedule expects equal q/kv block "
                         f"counts, got {nq} and {nk}")
    block_q = s // nq
    block_k = s // nk
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for qi in range(nq):
        q_block = q[:, qi * block_q:(qi + 1) * block_q]
        args = (q_block, k, v, qi, block_q, block_k, nk, scale)
        if torch.is_grad_enabled():
            o = checkpoint(_q_block_attention, *args, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            o = _q_block_attention(*args)
        outs.append(o)                                   # (B, H, bq, hd)
    out = torch.cat(outs, dim=2)                         # (B, H, S, hd)
    return out.transpose(1, 2).reshape(b, s, h, hd)


def _divisor_at_most(n: int, block: int) -> int:
    """The largest divisor of ``n`` not above ``block``."""
    return next(c for c in range(min(block, n), 0, -1) if n % c == 0)


def chunked_attention(q, k, v, block_q: int = 512, block_k: int = 512,
                      causal: bool = True, balanced: bool = False):
    """The reference's ``chunked_attention``: ``causal=True`` is
    :func:`chunked_causal_attention`; ``causal=False`` the same online
    softmax over every key, unmasked (an encoder's self attention, or a
    decoder's cross attention over ``Sk`` memory keys, Sk != S allowed).
    q (B, S, H, hd), k/v (B, Sk, H, hd), kv heads already repeated.

    The non-causal blocks are the reference's: the largest divisor of S
    (of Sk) not above ``block_q`` (``block_k``).  Each query block runs
    under ``torch.utils.checkpoint``, as ``jax.checkpoint`` wraps the
    reference's ``per_q``."""
    if causal:
        return chunked_causal_attention(q, k, v, block_q, block_k, balanced)
    b, s, h, hd = q.shape
    sk = k.shape[1]
    bq, bk = _divisor_at_most(s, block_q), _divisor_at_most(sk, block_k)
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for qi in range(s // bq):
        args = (q[:, qi * bq:(qi + 1) * bq], k, v, qi, bq, bk, sk // bk,
                scale, False)
        if torch.is_grad_enabled():
            o = checkpoint(_q_block_attention, *args, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            o = _q_block_attention(*args)
        outs.append(o)                                   # (B, H, bq, hd)
    return torch.cat(outs, dim=2).transpose(1, 2).reshape(b, s, h, hd)


def gqa_attention(p, x: torch.Tensor, cfg, cos, sin, impl: str = "chunked",
                  balanced: bool = False) -> torch.Tensor:
    """Training causal self-attention with grouped-query KV heads (the
    reference's ``gqa_attention``).  Weights are cast to ``x.dtype`` at
    use, or are codec views (:func:`linear`).  ``impl="pallas"`` raises:
    the reference's flash kernel has no backward, so no training path runs
    it."""
    if impl == "pallas":
        raise NotImplementedError(
            "attention_impl='pallas' has no backward in the reference; the "
            "training forward runs 'chunked' or 'full'")
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = linear(x, p["wq"])
    k = linear(x, p["wk"])
    v = linear(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = apply_rope(q.reshape(b, s, cfg.n_heads, hd), cos, sin)
    k = apply_rope(k.reshape(b, s, cfg.kv_heads, hd), cos, sin)
    v = v.reshape(b, s, cfg.kv_heads, hd)
    n_rep = cfg.n_heads // cfg.kv_heads
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    if impl == "full":
        o = full_causal_attention(q, k, v)
    else:
        # the reference calls it with its default 512-wide blocks, not
        # cfg.block_q/block_k
        o = chunked_causal_attention(q, k, v, balanced=balanced)
    return linear(o.reshape(b, s, cfg.n_heads * hd), p["wo"])


# ----------------------------------------------------------------------- MLP
#
# Weights are cast to the activation dtype at use, as in JAX (a no-op when
# they already match, as on the serving path, whose engines cast once), or
# are codec views (:func:`linear`).

def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(linear(x, p["w_gate"]))
    u = linear(x, p["w_up"])
    return linear(g * u, p["w_down"])


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(linear(x, p["w_up"]) + p["b_up"].to(x.dtype),
               approximate="tanh")
    return linear(h, p["w_down"]) + p["b_down"].to(x.dtype)
