"""Encoder-decoder transformer backbone (seamless-m4t-large-v2), port of
``repro.models.encdec`` with the same param dict and cache layouts.

The modality frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings ``src_embeds`` (B, S_enc, d_model); the text
decoder is a causal transformer with cross attention over the encoder's
output (the *memory*).  GELU MLPs and layernorm throughout; the cross
attention has ``n_heads`` kv heads.

HiFT unit order (bottom to top): [embed] + enc[0..E-1] + dec[0..D-1] +
[head].  A cut at or above ``enc_layers`` freezes the whole encoder: it
runs without a graph and its memory is detached.

Training: ``init``, ``unit_spec``, ``unit_first_depth``, ``encode``,
``apply``, ``loss_fn`` and ``lomo_pieces`` (two stages, the encoder then
the decoder, the memory handed over as the decoder's ``side``).  The
encoder's and the cross attention train through the plain non-causal
``layers.chunked_attention``, the decoder's self attention through the
plain causal one, as the reference trains (its flash kernel has no
backward).  Serving: ``init_cache``, ``prefill`` and ``decode_step``,
whose every attention goes through ``repro_torch.kernels.flash_attention``
(on CUDA tensors a hand-written kernel, on CPU tensors its plain version):

- the encoder's self attention: the prefill kernel, non-causal;
- the decoder prompt's self attention: the prefill kernel, causal, with no
  pad mask (the reference masks no left pad for encdec);
- the prompt's cross attention: the prefill kernel, non-causal, over the
  ``S_enc`` memory keys;
- a decode step's self attention: the decode kernel over the layer's
  cache, keys ``[0, pos]``;
- a decode step's cross attention: the decode kernel over K and V
  recomputed from ``cache["memory"]`` every step, as the reference does.

Serving's conventions are ``models.transformer``'s: params already in the
compute dtype, the self-attention cache updated in place, a host int
``"pos"``.  The memory is stored in the cache's dtype (rounded once in
bf16, as the reference rounds it).
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch.common.pytree import tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention, flash_decode
from repro_torch.models import layers as L
from repro_torch.models.base import (LomoPieces, Unit, dense_unit, run_layers,
                                     stacked_units)

PyTree = Any


# ------------------------------------------------------------------ init

def _enc_layers(cfg: ArchConfig, gen, kw) -> PyTree:
    stk = dict(lead=(cfg.enc_layers,), **kw)
    return {
        "ln1": L.layernorm_init(cfg.d_model, **stk),
        "attn": L.gqa_attention_init(gen, cfg.d_model, cfg.n_heads,
                                     cfg.kv_heads, cfg.head_dim, **stk),
        "ln2": L.layernorm_init(cfg.d_model, **stk),
        "mlp": L.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, **stk),
    }


def _dec_layers(cfg: ArchConfig, gen, kw) -> PyTree:
    stk = dict(lead=(cfg.dec_layers,), **kw)
    return {
        "ln1": L.layernorm_init(cfg.d_model, **stk),
        "self_attn": L.gqa_attention_init(gen, cfg.d_model, cfg.n_heads,
                                          cfg.kv_heads, cfg.head_dim, **stk),
        "ln_x": L.layernorm_init(cfg.d_model, **stk),
        "cross_attn": L.gqa_attention_init(gen, cfg.d_model, cfg.n_heads,
                                           cfg.n_heads, cfg.head_dim, **stk),
        "ln2": L.layernorm_init(cfg.d_model, **stk),
        "mlp": L.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, **stk),
    }


def init(cfg: ArchConfig, generator: torch.Generator, device="cpu",
         dtype=torch.float32) -> PyTree:
    """Random params from ``generator`` with the reference's keys, shapes
    and scales (other numbers than ``jax.random`` from the same seed), each
    stack's per-layer leaves on a leading ``enc_layers`` / ``dec_layers``
    dim."""
    kw = dict(device=device, dtype=dtype)
    return {
        "embed": {
            "src_proj": L.dense_init(generator, cfg.d_model, cfg.d_model,
                                     **kw),
            "tok": L.embed_init(generator, cfg.vocab_padded, cfg.d_model,
                                **kw),
        },
        "enc": _enc_layers(cfg, generator, kw),
        "dec": _dec_layers(cfg, generator, kw),
        "head": {
            "final_norm": L.layernorm_init(cfg.d_model, **kw),
            "w": L.dense_init(generator, cfg.d_model, cfg.vocab_padded, **kw),
        },
    }


def unit_spec(cfg: ArchConfig) -> list[Unit]:
    return ([dense_unit("embed")] + stacked_units("enc", cfg.enc_layers)
            + stacked_units("dec", cfg.dec_layers) + [dense_unit("head")])


def unit_first_depth(cfg: ArchConfig, unit: Unit) -> int:
    if unit.key == "embed":
        return 0
    if unit.key == "enc":
        return unit.index
    if unit.key == "dec":
        return cfg.enc_layers + unit.index
    return cfg.enc_layers + cfg.dec_layers  # head


# ---------------------------------------------------------------- training

def _rope(cfg: ArchConfig, n: int, device):
    return L.rope_frequencies(cfg.head_dim, n, cfg.rope_theta, device)


def _bidir_attention(p, x: torch.Tensor, cfg: ArchConfig, cos, sin):
    """The encoder's self attention: RoPE on q and k, no mask."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = L.linear(x, p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = L.linear(x, p["wk"]).reshape(b, s, cfg.kv_heads, hd)
    v = L.linear(x, p["wv"]).reshape(b, s, cfg.kv_heads, hd)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    n_rep = cfg.n_heads // cfg.kv_heads
    o = L.chunked_attention(q, L._repeat_kv(k, n_rep), L._repeat_kv(v, n_rep),
                            cfg.block_q, cfg.block_k, causal=False)
    return L.linear(o.reshape(b, s, cfg.n_heads * hd), p["wo"])


def _cross_attention(p, x: torch.Tensor, memory: torch.Tensor,
                     cfg: ArchConfig):
    """The decoder's cross attention over the memory: no RoPE, no mask,
    ``n_heads`` kv heads.  One query (s == 1) takes the reference's full
    softmax, more the non-causal chunked attention."""
    b, s, _ = x.shape
    sm = memory.shape[1]
    hd = cfg.head_dim
    q = L.linear(x, p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = L.linear(memory, p["wk"]).reshape(b, sm, cfg.n_heads, hd)
    v = L.linear(memory, p["wv"]).reshape(b, sm, cfg.n_heads, hd)
    if s == 1:
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (
            1.0 / math.sqrt(hd))
        probs = torch.softmax(sc, dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    else:
        o = L.chunked_attention(q, k, v, cfg.block_q, cfg.block_k,
                                causal=False)
    return L.linear(o.reshape(b, s, cfg.n_heads * hd), p["wo"])


def _enc_step(cfg: ArchConfig, cos, sin):
    def step(h, p):
        h = h + _bidir_attention(p["attn"], L.layernorm(p["ln1"], h), cfg,
                                 cos, sin)
        return h + L.gelu_mlp(p["mlp"], L.layernorm(p["ln2"], h))
    return step


def _dec_step(cfg: ArchConfig, cos, sin, memory: torch.Tensor):
    def step(h, p):
        h = h + L.gqa_attention(p["self_attn"], L.layernorm(p["ln1"], h), cfg,
                                cos, sin, impl=cfg.attention_impl,
                                balanced=cfg.attention_balanced)
        h = h + _cross_attention(p["cross_attn"], L.layernorm(p["ln_x"], h),
                                 memory, cfg)
        return h + L.gelu_mlp(p["mlp"], L.layernorm(p["ln2"], h))
    return step


def _src_in(embed_p, src_embeds: torch.Tensor, compute_dtype):
    return L.linear(src_embeds.to(compute_dtype),
                    L.weight(embed_p["src_proj"]))


def encode(cfg: ArchConfig, params: PyTree, src_embeds: torch.Tensor,
           cut: Optional[int] = None, compute_dtype=torch.bfloat16):
    """The encoder's output (B, S_enc, D).  ``cut``: the HiFT cut inside
    the encoder (``models.base.run_layers``); the projected input is
    detached whenever a cut is given."""
    h = _src_in(params["embed"], src_embeds, compute_dtype)
    cos, sin = _rope(cfg, h.shape[1], h.device)
    if cut is not None:
        h = h.detach()
    return run_layers(_enc_step(cfg, cos, sin), params["enc"], h, cut=cut,
                      remat=cfg.remat == "layer")


def apply(cfg: ArchConfig, params: PyTree, batch, cut: Optional[int] = None,
          compute_dtype=torch.bfloat16, return_hidden: bool = False):
    """Training forward -> logits (B, S_dec, V) float32 (or the final
    hidden states with ``return_hidden``).  ``batch``: {"src_embeds" (B,
    S_enc, D), "tokens" (B, S_dec), "labels"}.  ``params["enc"]`` and
    ``params["dec"]`` are stacked sub-trees or ``models.base.LayerStack``s.

    ``cut`` (the HiFT backward cut, in ``unit_first_depth``'s depths):
    ``cut <= enc_layers`` cuts inside the encoder; above it the whole
    encoder runs without a graph, its memory is detached and the decoder
    is cut at ``cut - enc_layers``.  The token embedding is detached
    whenever a cut is given."""
    enc_cut = dec_cut = None
    if cut is not None:
        if cut <= cfg.enc_layers:
            enc_cut = cut
        else:
            enc_cut = cfg.enc_layers           # the whole encoder frozen
            dec_cut = cut - cfg.enc_layers
    memory = encode(cfg, params, batch["src_embeds"], cut=enc_cut,
                    compute_dtype=compute_dtype)
    if cut is not None and cut >= cfg.enc_layers:
        memory = memory.detach()
    h = L.embed_lookup(params["embed"]["tok"],
                       batch["tokens"]).to(compute_dtype)
    if cut is not None:
        h = h.detach()
    cos, sin = _rope(cfg, h.shape[1], h.device)
    h = run_layers(_dec_step(cfg, cos, sin, memory), params["dec"], h,
                   cut=dec_cut, remat=cfg.remat == "layer")
    h = L.layernorm(params["head"]["final_norm"], h)
    if return_hidden:
        return h
    return L.linear(h, L.weight(params["head"]["w"])).float()


def loss_fn(cfg: ArchConfig, params: PyTree, batch, cut: Optional[int] = None,
            compute_dtype=torch.bfloat16):
    """Next-token cross-entropy of the decoder (chunked: never
    materializes (B, S, V)) through the untied head."""
    from repro_torch.models.losses import chunked_next_token_xent
    h = apply(cfg, params, batch, cut=cut, compute_dtype=compute_dtype,
              return_hidden=True)
    return chunked_next_token_xent(h, L.weight(params["head"]["w"]),
                                   batch["labels"], chunk=cfg.ce_chunk or None)


def lomo_pieces(cfg: ArchConfig, compute_dtype=torch.bfloat16) -> LomoPieces:
    """Segmented forward for the fused-backward strategies: two stages, the
    encoder then the decoder.  The decoder's init embeds the target tokens
    and hands the encoder's output over as the stage's ``side``, so each
    decoder layer's cross attention reads it without saving it a layer;
    the reverse walk sums its cotangent over the decoder's layers and
    seeds the encoder's walk with it.  The embedding takes gradient from
    both inits (``src_proj`` from the encoder's, ``tok`` from the
    decoder's)."""
    from repro_torch.models.losses import chunked_next_token_xent

    def enc_init(embed_p, prev, batch):
        del prev
        return _src_in(embed_p, batch["src_embeds"], compute_dtype), None

    def enc_block(layer_p, shared_p, side, h):
        del shared_p, side
        cos, sin = _rope(cfg, h.shape[1], h.device)
        return _enc_step(cfg, cos, sin)(h, layer_p)

    def dec_init(embed_p, memory, batch):
        h = L.embed_lookup(embed_p["tok"], batch["tokens"]).to(compute_dtype)
        return h, memory

    def dec_block(layer_p, shared_p, memory, h):
        del shared_p
        cos, sin = _rope(cfg, h.shape[1], h.device)
        return _dec_step(cfg, cos, sin, memory)(h, layer_p)

    def head_loss(head_p, embed_p, h, batch):
        del embed_p  # untied head
        h = L.layernorm(head_p["final_norm"], h)
        return chunked_next_token_xent(h, L.weight(head_p["w"]),
                                       batch["labels"],
                                       chunk=cfg.ce_chunk or None)

    return LomoPieces(
        stage_keys=("enc", "dec"),
        stage_fns=(enc_block, dec_block),
        stage_inits=(enc_init, dec_init),
        head_loss_fn=head_loss,
        split=lambda params: (params["embed"],
                              (params["enc"], params["dec"]), None,
                              params["head"]),
        merge=lambda ep, stages, sp, hp: {"embed": ep, "enc": stages[0],
                                          "dec": stages[1], "head": hp})


# ---------------------------------------------------------------- serving

def init_cache(cfg: ArchConfig, batch: int, max_len: int, enc_len: int,
               dtype=torch.bfloat16, device="cpu") -> PyTree:
    shape = (cfg.dec_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "memory": torch.zeros((batch, enc_len, cfg.d_model), dtype=dtype,
                                  device=device),
            "pos": 0}


def _layer(stack: PyTree, i: int) -> PyTree:
    return tree_map(lambda x: x[i], stack)


def _heads(x: torch.Tensor, w: torch.Tensor, n: int, hd: int):
    b, s, _ = x.shape
    return (x @ w).reshape(b, s, n, hd)


def _logits(params, h: torch.Tensor) -> torch.Tensor:
    h = L.layernorm(params["head"]["final_norm"], h)
    return (h @ params["head"]["w"]).float()


def _serve_encode(cfg: ArchConfig, params: PyTree, src_embeds: torch.Tensor,
                  compute_dtype) -> torch.Tensor:
    """The encoder's forward with its self attention through the prefill
    kernel, non-causal."""
    h = src_embeds.to(compute_dtype) @ params["embed"]["src_proj"]
    b, s, _ = h.shape
    hd = cfg.head_dim
    cos, sin = _rope(cfg, s, h.device)
    for i in range(cfg.enc_layers):
        p = _layer(params["enc"], i)
        hn = L.layernorm(p["ln1"], h)
        q = L.apply_rope(_heads(hn, p["attn"]["wq"], cfg.n_heads, hd),
                         cos, sin)
        k = L.apply_rope(_heads(hn, p["attn"]["wk"], cfg.kv_heads, hd),
                         cos, sin)
        v = _heads(hn, p["attn"]["wv"], cfg.kv_heads, hd)
        o = flash_attention(q, k, v, causal=False)
        h = h + o.reshape(b, s, cfg.n_heads * hd) @ p["attn"]["wo"]
        h = h + L.gelu_mlp(p["mlp"], L.layernorm(p["ln2"], h))
    return h


def _memory_kv(cfg: ArchConfig, p, memory: torch.Tensor):
    hd = cfg.head_dim
    return (_heads(memory, p["wk"], cfg.n_heads, hd),
            _heads(memory, p["wv"], cfg.n_heads, hd))


def prefill(cfg: ArchConfig, params: PyTree, batch, cache: PyTree,
            compute_dtype=torch.bfloat16):
    """Encode the source and run the decoder's prompt, filling the
    self-attention cache and storing the memory.  ``batch``: {"src_embeds"
    (B, S_enc, D), "tokens" (B, S) int}; pad tokens attend and are
    attended to, as in the reference.  Returns ``(logits (B, 1, V)
    float32, cache)``."""
    memory = _serve_encode(cfg, params, batch["src_embeds"], compute_dtype)
    h = params["embed"]["tok"][batch["tokens"]].to(compute_dtype)
    b, s, _ = h.shape
    hd = cfg.head_dim
    cos, sin = _rope(cfg, s, h.device)
    for i in range(cfg.dec_layers):
        p = _layer(params["dec"], i)
        hn = L.layernorm(p["ln1"], h)
        pa = p["self_attn"]
        q = L.apply_rope(_heads(hn, pa["wq"], cfg.n_heads, hd), cos, sin)
        k = L.apply_rope(_heads(hn, pa["wk"], cfg.kv_heads, hd), cos, sin)
        v = _heads(hn, pa["wv"], cfg.kv_heads, hd)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
        o = flash_attention(q, k, v, causal=True)
        h = h + o.reshape(b, s, cfg.n_heads * hd) @ pa["wo"]
        px = p["cross_attn"]
        qx = _heads(L.layernorm(p["ln_x"], h), px["wq"], cfg.n_heads, hd)
        kx, vx = _memory_kv(cfg, px, memory)
        o = flash_attention(qx, kx, vx, causal=False)
        h = h + o.reshape(b, s, cfg.n_heads * hd) @ px["wo"]
        h = h + L.gelu_mlp(p["mlp"], L.layernorm(p["ln2"], h))
    cache["memory"] = memory.to(cache["memory"].dtype)
    cache["pos"] = s
    return _logits(params, h[:, -1:]), cache


def decode_step(cfg: ArchConfig, params: PyTree, cache: PyTree, tokens,
                compute_dtype=torch.bfloat16):
    """One new token per sequence: the self attention over keys ``[0,
    pos]`` of the layer's cache and the cross attention over every memory
    key, both through the decode kernel.  tokens (B, 1) int.  Returns
    ``(logits (B, 1, V) float32, cache)`` with ``pos`` advanced."""
    h = params["embed"]["tok"][tokens].to(compute_dtype)
    memory = cache["memory"].to(compute_dtype)
    b = h.shape[0]
    hd = cfg.head_dim
    max_len = cache["k"].shape[2]
    pos = int(cache["pos"])
    if pos >= max_len:
        raise ValueError(f"decode past the cache: pos {pos} >= {max_len}")
    cos, sin = _rope(cfg, max_len, h.device)
    positions = torch.full((b, 1), pos, dtype=torch.long, device=h.device)
    lengths = torch.full((b,), pos + 1, dtype=torch.int32, device=h.device)
    mem_lengths = torch.full((b,), memory.shape[1], dtype=torch.int32,
                             device=h.device)
    for i in range(cfg.dec_layers):
        p = _layer(params["dec"], i)
        hn = L.layernorm(p["ln1"], h)
        pa = p["self_attn"]
        q = L.apply_rope(_heads(hn, pa["wq"], cfg.n_heads, hd), cos, sin,
                         positions)
        k = L.apply_rope(_heads(hn, pa["wk"], cfg.kv_heads, hd), cos, sin,
                         positions)
        cache["k"][i, :, pos] = k[:, 0]
        cache["v"][i, :, pos] = _heads(hn, pa["wv"], cfg.kv_heads, hd)[:, 0]
        o = flash_decode(q[:, 0], cache["k"][i].to(h.dtype),
                         cache["v"][i].to(h.dtype), lengths)
        h = h + o.reshape(b, 1, cfg.n_heads * hd) @ pa["wo"]
        px = p["cross_attn"]
        qx = _heads(L.layernorm(p["ln_x"], h), px["wq"], cfg.n_heads, hd)
        kx, vx = _memory_kv(cfg, px, memory)
        o = flash_decode(qx[:, 0], kx, vx, mem_lengths)
        h = h + o.reshape(b, 1, cfg.n_heads * hd) @ px["wo"]
        h = h + L.gelu_mlp(p["mlp"], L.layernorm(p["ln2"], h))
    cache["pos"] = pos + 1
    return _logits(params, h), cache
