"""Dense decoder-only transformer LM (GQA + RoPE + SwiGLU), and the vlm
family's LM backbone.

Port of ``repro.models.transformer`` with the same param dict and cache
layouts.  The vlm family (internvl2-26b) prepends ``vision_tokens`` stub
patch embeddings (``batch["vision_embeds"]``, (B, vt, D)) to the token
embeddings; the loss reads the text positions only, and serving keeps
the vision prefix valid in front of each row's left pad (the kernels'
``prefix``).  Training: ``unit_spec``, ``apply`` and ``loss_fn`` (the chunked
plain-torch attention and cross-entropy, as the reference trains; the
HiFT cut detaches below the active group), and ``lomo_pieces``, the same
loss in segments for the fused-backward strategies.  Serving: ``init``,
``head_weight``, ``init_cache``, ``prefill``, ``decode_step`` and
``paged_decode_step``, whose every attention goes through
``repro_torch.kernels.flash_attention``: on CUDA tensors a hand-written
kernel, on CPU tensors its plain version.  The projections, MLP and head
stay ``torch.matmul``.

Differences of the serving functions from JAX, all deliberate:

- params must already be in the compute dtype (the engines cast once at
  construction; JAX keeps fp32 params and casts at every use);
- caches and page pools are updated in place (JAX returns new arrays,
  donated by the engine's jit), and are also returned for the same call
  shape;
- the contiguous cache's ``"pos"`` is a host int, so decode needs no
  device-to-host read to index the cache.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.common.pytree import tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.dist import quant as Q
from repro_torch.kernels.flash_attention import (flash_attention, flash_decode,
                                                 paged_flash_decode)
from repro_torch.models import layers as L
from repro_torch.models.base import (Unit, dense_unit, run_layers,
                                     stacked_units)

PyTree = Any


def _norm_fns(cfg: ArchConfig):
    if cfg.norm == "layernorm":
        return L.layernorm_init, L.layernorm
    return L.rmsnorm_init, L.rmsnorm


def _mlp_fns(cfg: ArchConfig):
    if cfg.mlp == "gelu":
        return L.gelu_mlp_init, L.gelu_mlp
    return L.swiglu_init, L.swiglu


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in ("dense", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not this module's "
            "(dense and vlm)")


# ------------------------------------------------------------------ init

def init(cfg: ArchConfig, generator: torch.Generator, device="cpu",
         dtype=torch.float32) -> PyTree:
    """Random params from ``generator`` (same shapes and scales as the JAX
    ``init``: normal/sqrt(fan_in) dense weights, 0.02 embedding, unit norm
    scales, zero biases), per-layer leaves stacked on a leading
    ``n_layers`` dim.  Draws happen in a fixed order on ``device``, so one
    seed gives one model per device type (and other numbers than
    ``jax.random``)."""
    _check_family(cfg)
    norm_init, _ = _norm_fns(cfg)
    mlp_init, _ = _mlp_fns(cfg)
    kw = dict(device=device, dtype=dtype)
    stk = dict(lead=(cfg.n_layers,), **kw)
    embed = {"tok": L.embed_init(generator, cfg.vocab_padded, cfg.d_model,
                                 **kw)}
    layers = {
        "ln1": norm_init(cfg.d_model, **stk),
        "attn": L.gqa_attention_init(generator, cfg.d_model, cfg.n_heads,
                                     cfg.kv_heads, cfg.head_dim, cfg.qkv_bias,
                                     **stk),
        "ln2": norm_init(cfg.d_model, **stk),
        "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, **stk),
    }
    head = {"final_norm": norm_init(cfg.d_model, **kw)}
    if not cfg.tie_embeddings:
        head["w"] = L.dense_init(generator, cfg.d_model, cfg.vocab_padded,
                                 **kw)
    return {"embed": embed, "layers": layers, "head": head}


def head_weight(cfg: ArchConfig, params):
    """(D, V): separate head weight, or the tied embedding transposed.  A
    codec record (quantized residency) comes as its ``QuantView``; a tied
    quantized embedding is decoded whole, since its (1, 128) scale blocks
    run along D and the dequant-matmul kernel's along V."""
    if cfg.tie_embeddings:
        tok = params["embed"]["tok"]
        return (Q.dequantize_leaf(tok) if Q.is_quantized(tok) else tok).T
    return L.weight(params["head"]["w"])


def _rope(cfg: ArchConfig, max_len: int, device):
    return L.rope_frequencies(cfg.head_dim, max_len, cfg.rope_theta, device)


def _qkv(cfg: ArchConfig, p, hn: torch.Tensor):
    """Projections of one layer: (B,S,H,hd), (B,S,KV,hd), (B,S,KV,hd)."""
    b, s, _ = hn.shape
    q = hn @ p["wq"]
    k = hn @ p["wk"]
    v = hn @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return (q.reshape(b, s, cfg.n_heads, cfg.head_dim),
            k.reshape(b, s, cfg.kv_heads, cfg.head_dim),
            v.reshape(b, s, cfg.kv_heads, cfg.head_dim))


def _embed_in(cfg: ArchConfig, embed_p, batch) -> torch.Tensor:
    """Token embeddings (B, S, D), with the vlm family's ``vision_embeds``
    (B, vt, D) in front (cast to the table's dtype, as the reference)."""
    h = L.embed_lookup(embed_p["tok"], batch["tokens"])
    if cfg.vision_tokens > 0:
        vis = batch["vision_embeds"].to(device=h.device, dtype=h.dtype)
        h = torch.cat([vis, h], dim=1)
    return h


def _layer(params, i: int) -> PyTree:
    return tree_map(lambda x: x[i], params["layers"])


def _logits(cfg: ArchConfig, params, h: torch.Tensor) -> torch.Tensor:
    h = _norm_fns(cfg)[1](params["head"]["final_norm"], h)
    return (h @ head_weight(cfg, params)).float()


# ---------------------------------------------------------------- training

def unit_spec(cfg: ArchConfig) -> list[Unit]:
    return ([dense_unit("embed")] + stacked_units("layers", cfg.n_layers)
            + [dense_unit("head")])


def _block(cfg: ArchConfig, cos, sin):
    _, norm = _norm_fns(cfg)
    _, mlp = _mlp_fns(cfg)

    def step(h, p):
        h = h + L.gqa_attention(p["attn"], norm(p["ln1"], h), cfg, cos, sin,
                                impl=cfg.attention_impl,
                                balanced=cfg.attention_balanced)
        return h + mlp(p["mlp"], norm(p["ln2"], h))
    return step


def apply(cfg: ArchConfig, params: PyTree, batch, cut: Optional[int] = None,
          compute_dtype=torch.bfloat16, return_hidden: bool = False):
    """Training forward -> logits (B, S, V) float32 (or the final hidden
    states with ``return_hidden``).

    ``params["layers"]`` is the stacked sub-tree or a
    ``models.base.LayerStack`` (a grouped strategy's frozen and active
    pieces).  Any leaf may be a codec record (quantized residency): the
    embedding decodes the gathered rows, each layer its norm rows, and
    every projection and the head multiply through the dequant-matmul
    kernel (``layers.linear``).  ``cut``: the HiFT backward cut.  None =
    FPFT (gradients may reach the embedding).  ``cut=c >= 0``: the embedding and the first c
    layers are frozen — the embedding's output is detached whatever ``c``
    is, layers below ``c`` run without a graph, and the activation entering
    layer ``c`` is detached, so the backward never descends below the
    active group.  The vlm family's logits cover the vision positions too,
    as the reference's; its loss reads the text positions only."""
    _check_family(cfg)
    h = _embed_in(cfg, params["embed"], batch).to(compute_dtype)
    cos, sin = _rope(cfg, h.shape[1], h.device)
    if cut is not None:
        h = h.detach()
    h = run_layers(_block(cfg, cos, sin), params["layers"], h, cut=cut,
                   remat=cfg.remat == "layer")
    h = _norm_fns(cfg)[1](params["head"]["final_norm"], h)
    if return_hidden:
        return h
    return L.linear(h, head_weight(cfg, params)).float()


def loss_fn(cfg: ArchConfig, params: PyTree, batch, cut: Optional[int] = None,
            compute_dtype=torch.bfloat16):
    """Next-token cross-entropy (chunked: never materializes (B, S, V)),
    over the text positions (past the vlm family's vision prefix)."""
    from repro_torch.models.losses import chunked_next_token_xent
    h = apply(cfg, params, batch, cut=cut, compute_dtype=compute_dtype,
              return_hidden=True)[:, cfg.vision_tokens:]
    return chunked_next_token_xent(h, head_weight(cfg, params),
                                   batch["labels"], chunk=cfg.ce_chunk or None)


def lomo_pieces(cfg: ArchConfig, compute_dtype=torch.bfloat16):
    """Segmented forward for the fused-backward strategies (``lomo``,
    ``adalomo``): ``(embed_fn, block_fn, head_loss_fn)`` such that

        h0   = embed_fn(params["embed"], batch)
        h    = block_fn(layer i of params["layers"], h)   # i = 0..n-1
        loss = head_loss_fn(params["head"], params["embed"], h, batch)

    is ``loss_fn(cfg, params, batch)`` with the same ops: the embedding
    lookup and cast, ``_block`` with the same rope table, the final norm
    and the chunked cross-entropy against ``head_weight``.  The embedding
    reaches ``head_loss_fn`` because a tied head reads it."""
    _check_family(cfg)
    _, norm = _norm_fns(cfg)

    def embed_fn(embed_p, batch):
        return _embed_in(cfg, embed_p, batch).to(compute_dtype)

    def block_fn(layer_p, h):
        cos, sin = _rope(cfg, h.shape[1], h.device)
        return _block(cfg, cos, sin)(h, layer_p)

    def head_loss_fn(head_p, embed_p, h, batch):
        from repro_torch.models.losses import chunked_next_token_xent
        h = norm(head_p["final_norm"], h)[:, cfg.vision_tokens:]
        w = head_weight(cfg, {"embed": embed_p, "head": head_p})
        return chunked_next_token_xent(h, w, batch["labels"],
                                       chunk=cfg.ce_chunk or None)

    return embed_fn, block_fn, head_loss_fn


# ---------------------------------------------------------------- serving

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu") -> PyTree:
    shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": 0,
            "pad": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _pad_valid(cfg: ArchConfig, pad: torch.Tensor, s: int) -> torch.Tensor:
    """(B, S) key-validity mask from per-row left-pad counts (the JAX
    helper; the kernels take ``pad`` itself as each row's first valid key)."""
    idx = torch.arange(s, device=pad.device)
    vt = cfg.vision_tokens
    return (idx[None, :] < vt) | (idx[None, :] >= vt + pad[:, None])


def prefill(cfg: ArchConfig, params: PyTree, batch, cache: PyTree,
            compute_dtype=torch.bfloat16):
    """Run the full prompt, fill the KV cache, return last-token logits.

    ``batch``: {"tokens": (B, S) int, optional "pad": (B,) int left-pad
    counts; for the vlm family "vision_embeds" (B, vt, D)}.  Pad keys are
    masked out of every attention (the kernels skip keys ``[vt, vt +
    pad[b])``: the vision prefix stays valid) and ``pad`` is stored in the
    cache for decode.  The cache holds the vt + S positions.  Returns
    ``(logits (B, 1, V) float32, cache)``.
    """
    _check_family(cfg)
    h = _embed_in(cfg, params["embed"], batch).to(compute_dtype)
    b, s, _ = h.shape
    cos, sin = _rope(cfg, s, h.device)
    _, norm = _norm_fns(cfg)
    _, mlp = _mlp_fns(cfg)
    pad = batch.get("pad")
    if pad is not None:
        pad = pad.to(device=h.device, dtype=torch.int32)
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        q, k, v = _qkv(cfg, p["attn"], norm(p["ln1"], h))
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
        o = flash_attention(q, k, v, starts=pad, causal=True,
                            prefix=cfg.vision_tokens)
        h = h + o.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["attn"]["wo"]
        h = h + mlp(p["mlp"], norm(p["ln2"], h))
    cache["pos"] = s
    cache["pad"] = pad if pad is not None else torch.zeros(
        (b,), dtype=torch.int32, device=h.device)
    return _logits(cfg, params, h[:, -1:]), cache


def decode_step(cfg: ArchConfig, params: PyTree, cache: PyTree, tokens,
                compute_dtype=torch.bfloat16):
    """One new token per sequence with a pre-filled contiguous cache.

    tokens: (B, 1) int.  Writes the new k/v at ``cache["pos"]`` in place
    and attends over keys ``[0, vt)`` and ``[vt + pad[b], pos]`` (vt: the
    vlm family's vision prefix, 0 otherwise).  Returns
    ``(logits (B, 1, V) float32, cache)`` with ``pos`` advanced."""
    _check_family(cfg)
    h = params["embed"]["tok"][tokens].to(compute_dtype)
    b = h.shape[0]
    max_len = cache["k"].shape[2]
    pos = int(cache["pos"])
    if pos >= max_len:
        raise ValueError(f"decode past the cache: pos {pos} >= {max_len}")
    cos, sin = _rope(cfg, max_len, h.device)
    positions = torch.full((b, 1), pos, dtype=torch.long, device=h.device)
    lengths = torch.full((b,), pos + 1, dtype=torch.int32, device=h.device)
    pad = cache.get("pad")
    _, norm = _norm_fns(cfg)
    _, mlp = _mlp_fns(cfg)
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        q, k, v = _qkv(cfg, p["attn"], norm(p["ln1"], h))
        q = L.apply_rope(q, cos, sin, positions)
        k = L.apply_rope(k, cos, sin, positions)
        cache["k"][i, :, pos] = k[:, 0]
        cache["v"][i, :, pos] = v[:, 0]
        o = flash_decode(q[:, 0], cache["k"][i].to(h.dtype),
                         cache["v"][i].to(h.dtype), lengths, starts=pad,
                         prefix=cfg.vision_tokens)
        h = h + o.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ p["attn"]["wo"]
        h = h + mlp(p["mlp"], norm(p["ln2"], h))
    cache["pos"] = pos + 1
    return _logits(cfg, params, h), cache


def paged_decode_step(cfg: ArchConfig, params: PyTree, k_pool, v_pool,
                      block_tables, lengths, pad, tokens,
                      compute_dtype=torch.float32):
    """One decode step against a PAGED KV cache (``serve.kv_cache``).

    k_pool/v_pool: (L, n_blocks, block_size, KV, hd) shared page pools;
    block_tables: (B, max_blocks) int logical -> physical page map (unused
    entries point at the null page 0); lengths: (B,) int per-slot decode
    position (rows already filled); pad: (B,) int left-pad counts;
    tokens: (B, 1) int.  The new k/v row is written into each slot's
    current page in place; attention covers logical keys
    ``[pad[b], lengths[b]]``.  Returns ``(logits (B, 1, V), k_pool,
    v_pool)``; lengths are not advanced (the engine owns them).  The vlm
    family raises: the reference's continuous engine cannot serve it (its
    ``_start`` builds no ``vision_embeds``), so no paged cache holds a
    vision prefix.
    """
    _check_family(cfg)
    if cfg.vision_tokens:
        raise NotImplementedError(
            f"{cfg.name}: the paged decode has no vision prefix")
    _, _, block_size, _, _ = k_pool.shape
    b, max_blocks = block_tables.shape
    h = params["embed"]["tok"][tokens].to(compute_dtype)
    dev = h.device
    lengths = lengths.to(device=dev, dtype=torch.long)
    tables = block_tables.to(device=dev, dtype=torch.int32)
    pad = pad.to(device=dev, dtype=torch.int32)
    cos, sin = _rope(cfg, max_blocks * block_size, dev)
    positions = lengths[:, None]
    phys = tables.long().gather(1, (lengths // block_size)[:, None])[:, 0]
    offs = lengths % block_size
    ends = (lengths + 1).to(torch.int32)
    _, norm = _norm_fns(cfg)
    _, mlp = _mlp_fns(cfg)
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        q, k, v = _qkv(cfg, p["attn"], norm(p["ln1"], h))
        q = L.apply_rope(q, cos, sin, positions)
        k = L.apply_rope(k, cos, sin, positions)
        k_pool[i][phys, offs] = k[:, 0].to(k_pool.dtype)
        v_pool[i][phys, offs] = v[:, 0].to(v_pool.dtype)
        o = paged_flash_decode(q[:, 0], k_pool[i].to(h.dtype),
                               v_pool[i].to(h.dtype), tables, ends,
                               starts=pad)
        h = h + o.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ p["attn"]["wo"]
        h = h + mlp(p["mlp"], norm(p["ln2"], h))
    return _logits(cfg, params, h), k_pool, v_pool
