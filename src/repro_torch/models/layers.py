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


# ----------------------------------------------------------------------- MLP

def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ p["w_gate"])
    u = x @ p["w_up"]
    return (g * u) @ p["w_down"]


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
    return h @ p["w_down"] + p["b_down"]
