"""Zamba2-style hybrid: stacked Mamba2 blocks + one SHARED attention block
applied after every ``attn_every`` Mamba layers (port of
``repro.models.zamba2``), serving path.

The same param dict and cache layouts as the reference.  ``init``,
``init_cache``, ``prefill`` and ``decode_step``; the prefill's scans go
through ``kernels.ssm_scan`` (on CUDA tensors a hand-written kernel), the
shared block's attention through ``kernels.flash_attention``
(``flash_attention`` in the prefill, ``flash_decode`` in decode).  Decode
runs each Mamba2 step in plain torch (the reference has no kernel for it).

Differences from JAX, all deliberate (those of ``models.transformer``'s
serving functions): caches are updated in place and also returned, and
``"pos"`` is a host int.  As in the reference, the prefill masks no left
pad (pad tokens run through the SSM states and the shared attention).

Training (``apply``, ``loss_fn``, ``unit_spec``, ``lomo_pieces``) waits
for hybrid training.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.common.pytree import tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention, flash_decode
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M

PyTree = Any
FP32_LEAVES = M.FP32_LEAVES


def init(cfg: ArchConfig, generator: torch.Generator, device="cpu",
         dtype=torch.float32) -> PyTree:
    """Random params from ``generator`` with the reference's shapes and
    scales (other numbers than ``jax.random`` from the same seed); the
    per-layer leaves stacked on a leading ``n_layers`` dim."""
    if cfg.n_layers % cfg.attn_every:
        raise ValueError("n_layers must divide into super-blocks")
    kw = dict(device=device, dtype=dtype)
    stk = dict(lead=(cfg.n_layers,), **kw)
    return {
        "embed": {"tok": L.embed_init(generator, cfg.vocab_padded,
                                      cfg.d_model, **kw)},
        "layers": {"ln": L.rmsnorm_init(cfg.d_model, **stk),
                   "mamba": M.mamba2_init(generator, cfg, **stk)},
        "shared": {
            "ln1": L.rmsnorm_init(cfg.d_model, **kw),
            "attn": L.gqa_attention_init(generator, cfg.d_model, cfg.n_heads,
                                         cfg.kv_heads, cfg.head_dim, **kw),
            "ln2": L.rmsnorm_init(cfg.d_model, **kw),
            "mlp": L.swiglu_init(generator, cfg.d_model, cfg.d_ff, **kw),
        },
        "head": {"final_norm": L.rmsnorm_init(cfg.d_model, **kw),
                 "w": L.dense_init(generator, cfg.d_model, cfg.vocab_padded,
                                   **kw)},
    }


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu") -> PyTree:
    """ssm (L,B,H,P,N) fp32; conv (L,B,W-1,d_inner+2N); one k/v cache
    (n_sb,B,max_len,KV,hd) per application of the shared block; pos."""
    di = M.d_inner(cfg)
    h, n = cfg.ssm_heads, cfg.ssm_state
    n_sb = cfg.n_layers // cfg.attn_every
    kv = (n_sb, batch, max_len, cfg.kv_heads, cfg.head_dim)
    return {
        "ssm": torch.zeros((cfg.n_layers, batch, h, di // h, n),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((cfg.n_layers, batch, cfg.conv_width - 1,
                             di + 2 * n), dtype=dtype, device=device),
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "pos": 0,
    }


def _layer(params, i: int) -> PyTree:
    return tree_map(lambda x: x[i], params["layers"])


def _qkv(cfg: ArchConfig, p, hn: torch.Tensor):
    b, s, _ = hn.shape
    return ((hn @ p["wq"].to(hn.dtype)).reshape(b, s, cfg.n_heads,
                                                cfg.head_dim),
            (hn @ p["wk"].to(hn.dtype)).reshape(b, s, cfg.kv_heads,
                                                cfg.head_dim),
            (hn @ p["wv"].to(hn.dtype)).reshape(b, s, cfg.kv_heads,
                                                cfg.head_dim))


def _shared_tail(shared, h: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """The shared block after its attention: output projection, residual,
    then the MLP with its own norm and residual."""
    b, s = o.shape[:2]
    h = h + o.reshape(b, s, -1) @ shared["attn"]["wo"].to(h.dtype)
    return h + L.swiglu(shared["mlp"], L.rmsnorm(shared["ln2"], h))


def _logits(params, h: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(params["head"]["final_norm"], h)
    return (h @ params["head"]["w"].to(h.dtype)).float()


def prefill(cfg: ArchConfig, params: PyTree, batch, cache: PyTree,
            compute_dtype=torch.bfloat16):
    """Prompt pass: per super-block, ``attn_every`` Mamba2 prefill steps
    (chunked scan; each fills its layer's SSM and conv state), then the
    shared block, whose causal attention fills that application's KV
    cache.  ``batch``: {"tokens": (B, S) int}; needs S >= conv_width - 1.
    Returns ``(logits (B, 1, V) float32, cache)``."""
    h = params["embed"]["tok"][batch["tokens"]].to(compute_dtype)
    b, s, _ = h.shape
    cos, sin = L.rope_frequencies(cfg.head_dim, s, cfg.rope_theta, h.device)
    shared = params["shared"]
    for sb in range(cfg.n_layers // cfg.attn_every):
        for i in range(sb * cfg.attn_every, (sb + 1) * cfg.attn_every):
            p = _layer(params, i)
            y, ssm, conv = M.mamba2_prefill(p["mamba"],
                                            L.rmsnorm(p["ln"], h), cfg)
            h = h + y
            cache["ssm"][i] = ssm
            cache["conv"][i] = conv
        q, k, v = _qkv(cfg, shared["attn"], L.rmsnorm(shared["ln1"], h))
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
        cache["k"][sb, :, :s] = k
        cache["v"][sb, :, :s] = v
        h = _shared_tail(shared, h, flash_attention(q, k, v, starts=None,
                                                    causal=True))
    cache["pos"] = s
    return _logits(params, h[:, -1:]), cache


def decode_step(cfg: ArchConfig, params: PyTree, cache: PyTree, tokens,
                compute_dtype=torch.bfloat16):
    """One new token per sequence.  tokens: (B, 1) int.  Advances every
    layer's SSM and conv state and writes the shared block's new k/v at
    ``pos`` of each application's cache, in place; attention covers keys
    ``[0, pos]``.  Returns ``(logits (B, 1, V) float32, cache)``."""
    h = params["embed"]["tok"][tokens].to(compute_dtype)
    b = h.shape[0]
    max_len = cache["k"].shape[2]
    pos = int(cache["pos"])
    if pos >= max_len:
        raise ValueError(f"decode past the cache: pos {pos} >= {max_len}")
    cos, sin = L.rope_frequencies(cfg.head_dim, max_len, cfg.rope_theta,
                                  h.device)
    positions = torch.full((b, 1), pos, dtype=torch.long, device=h.device)
    lengths = torch.full((b,), pos + 1, dtype=torch.int32, device=h.device)
    shared = params["shared"]
    for sb in range(cfg.n_layers // cfg.attn_every):
        for i in range(sb * cfg.attn_every, (sb + 1) * cfg.attn_every):
            p = _layer(params, i)
            y, ssm, conv = M.mamba2_decode(p["mamba"], L.rmsnorm(p["ln"], h),
                                           cfg, cache["ssm"][i],
                                           cache["conv"][i])
            h = h + y
            cache["ssm"][i] = ssm
            cache["conv"][i] = conv
        q, k, v = _qkv(cfg, shared["attn"], L.rmsnorm(shared["ln1"], h))
        q = L.apply_rope(q, cos, sin, positions)
        k = L.apply_rope(k, cos, sin, positions)
        cache["k"][sb, :, pos] = k[:, 0]
        cache["v"][sb, :, pos] = v[:, 0]
        o = flash_decode(q[:, 0], cache["k"][sb].to(h.dtype),
                         cache["v"][sb].to(h.dtype), lengths)
        h = _shared_tail(shared, h, o[:, None])
    cache["pos"] = pos + 1
    return _logits(params, h), cache
