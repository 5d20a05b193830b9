"""Zamba2-style hybrid: stacked Mamba2 blocks + one SHARED attention block
applied after every ``attn_every`` Mamba layers (port of
``repro.models.zamba2``).

The same param dict and cache layouts as the reference.

Training: ``unit_spec`` ([embed] + the Mamba layers + [shared] + [head]),
``apply``, ``loss_fn``, ``unit_first_depth`` and ``lomo_pieces``.  Each
Mamba2 block trains through the plain chunked scan
(``mamba2.mamba2_forward``) on every device, the shared block's attention
through the plain chunked attention, as the reference trains.  The
shared block's params are first used at depth ``attn_every``, so the HiFT
cut is rounded down to a super-block, as in the reference: super-block 0
runs below the cut whenever the shared unit trains without the embedding,
and its application of the shared block gets no gradient (HiFT's shared
gradient is not FPFT's; the tests hold the port to the reference's).
Any leaf may be a codec record (quantized residency): the embedding
decodes its gathered rows, every projection and the head multiply
through the dequant-matmul kernel (``layers.linear``), and the rest is
decoded one layer at a time.

Serving: ``init``, ``init_cache``, ``prefill`` and ``decode_step``; the
prefill's scans go through ``kernels.ssm_scan`` (on CUDA tensors a
hand-written kernel), the shared block's attention through
``kernels.flash_attention`` (``flash_attention`` in the prefill,
``flash_decode`` in decode).  Decode runs each Mamba2 step in plain torch
(the reference has no kernel for it).  Differences of the serving
functions from JAX, all deliberate (those of ``models.transformer``'s):
caches are updated in place and also returned, and ``"pos"`` is a host
int.  As in the reference, the prefill masks no left pad (pad tokens run
through the SSM states and the shared attention).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.pytree import tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.dist import quant as Q
from repro_torch.kernels.flash_attention import flash_attention, flash_decode
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.base import (LomoPieces, Unit, dense_unit, layer_at,
                                     stacked_units)

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


# ---------------------------------------------------------------- training

def unit_spec(cfg: ArchConfig) -> list[Unit]:
    return ([dense_unit("embed")] + stacked_units("layers", cfg.n_layers)
            + [dense_unit("shared"), dense_unit("head")])


def unit_first_depth(cfg: ArchConfig, unit: Unit) -> int:
    """Depth (in Mamba-layer index) at which a unit's params are first
    used: the shared block after super-block 0, at ``attn_every``."""
    if unit.key == "embed":
        return 0
    if unit.kind == "stacked":
        return unit.index
    if unit.key == "shared":
        return cfg.attn_every
    return cfg.n_layers        # head


def _views(tree: PyTree) -> PyTree:
    """A whole-leaf segment with each codec record as its view (the shared
    block's projections multiply through the dequant-matmul kernel)."""
    return tree_map(L.weight, tree, is_leaf=Q.is_quantized)


def _super_block(cfg: ArchConfig, shared, cos, sin):
    """``block(h, layers) -> h``: ``attn_every`` Mamba2 layers (pre-norm,
    residual), then one application of the shared attention + MLP block.
    ``shared`` has its codec records already as views."""

    def block(h, layers):
        for p in layers:
            h = h + M.mamba2_forward(p["mamba"], L.rmsnorm(p["ln"], h), cfg)
        h = h + L.gqa_attention(shared["attn"], L.rmsnorm(shared["ln1"], h),
                                cfg, cos, sin, impl=cfg.attention_impl,
                                balanced=cfg.attention_balanced)
        return h + L.swiglu(shared["mlp"], L.rmsnorm(shared["ln2"], h))
    return block


def _sb_layers(cfg: ArchConfig, layers, sb: int) -> list:
    """The layers of super-block ``sb``, one at a time from whichever piece
    of a ``LayerStack`` holds each (a super-block may straddle two)."""
    ae = cfg.attn_every
    return [layer_at(layers, i) for i in range(sb * ae, (sb + 1) * ae)]


def apply(cfg: ArchConfig, params: PyTree, batch, cut: Optional[int] = None,
          compute_dtype=torch.bfloat16, return_hidden: bool = False):
    """Training forward -> logits (B, S, V) float32 (or the final hidden
    states with ``return_hidden``).

    ``params["layers"]`` is the stacked sub-tree or a
    ``models.base.LayerStack``.  ``cut``: the HiFT backward cut, rounded
    down to a super-block as the reference rounds it (``sb_cut = min(cut
    // attn_every, n_sb)``).  None = FPFT.  Otherwise the embedding's
    output is detached, super-blocks below ``sb_cut`` run without a graph
    and the activation entering super-block ``sb_cut`` is detached.  Each
    super-block that records a graph runs under
    ``torch.utils.checkpoint`` when the config asks for
    ``remat="layer"``."""
    h = L.embed_lookup(params["embed"]["tok"],
                       batch["tokens"]).to(compute_dtype)
    cos, sin = L.rope_frequencies(cfg.head_dim, h.shape[1], cfg.rope_theta,
                                  h.device)
    block = _super_block(cfg, _views(params["shared"]), cos, sin)
    n_sb = cfg.n_layers // cfg.attn_every
    sb_cut = 0
    if cut is not None:
        h = h.detach()
        sb_cut = min(cut // cfg.attn_every, n_sb)
    remat = cfg.remat == "layer"
    for sb in range(n_sb):
        layers = _sb_layers(cfg, params["layers"], sb)
        if sb < sb_cut:
            with torch.no_grad():
                h = block(h, layers)
            continue
        if sb == sb_cut and sb_cut:
            h = h.detach()
        if remat and torch.is_grad_enabled():
            h = checkpoint(block, h, layers, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = block(h, layers)
    h = L.rmsnorm(params["head"]["final_norm"], h)
    if return_hidden:
        return h
    return L.linear(h, L.weight(params["head"]["w"])).float()


def loss_fn(cfg: ArchConfig, params: PyTree, batch, cut: Optional[int] = None,
            compute_dtype=torch.bfloat16):
    """Next-token cross-entropy (chunked: never materializes (B, S, V))."""
    from repro_torch.models.losses import chunked_next_token_xent
    h = apply(cfg, params, batch, cut=cut, compute_dtype=compute_dtype,
              return_hidden=True)
    return chunked_next_token_xent(h, L.weight(params["head"]["w"]),
                                   batch["labels"], chunk=cfg.ce_chunk or None)


def lomo_pieces(cfg: ArchConfig, compute_dtype=torch.bfloat16) -> LomoPieces:
    """Segmented forward for the fused-backward strategies.

    The fused grain is one SUPER-BLOCK (``attn_every`` Mamba layers + one
    application of the shared block), because the shared block's weights
    are reused inside every super-block, so ``liveness_m = attn_every``.
    The shared segment rides ``shared_key``: each super-block's reverse
    step contributes its application's gradient, the strategy sums them
    over the sweep and applies one update (the gradient a plain backward
    gives reused weights, all ``n_sb`` applications).  ``split`` reshapes
    ``layers`` from ``(L, ...)`` to ``(n_sb, attn_every, ...)`` as VIEWS
    (``Tensor.view``, which raises rather than copy): ``lomo`` and
    ``adalomo`` update those slices in place."""
    from repro_torch.models.losses import chunked_next_token_xent
    n_sb, ae = cfg.n_layers // cfg.attn_every, cfg.attn_every

    def embed_init(embed_p, prev, batch):
        del prev
        return L.embed_lookup(embed_p["tok"],
                              batch["tokens"]).to(compute_dtype), None

    def block(sb_p, shared, side, h):
        del side
        cos, sin = L.rope_frequencies(cfg.head_dim, h.shape[1],
                                      cfg.rope_theta, h.device)
        return _super_block(cfg, _views(shared), cos, sin)(
            h, [layer_at(sb_p, j) for j in range(ae)])

    def head_loss(head_p, embed_p, h, batch):
        del embed_p  # untied head
        h = L.rmsnorm(head_p["final_norm"], h)
        return chunked_next_token_xent(h, L.weight(head_p["w"]),
                                       batch["labels"],
                                       chunk=cfg.ce_chunk or None)

    def split(params):
        sb = tree_map(lambda x: x.view((n_sb, ae) + tuple(x.shape[1:])),
                      params["layers"])
        return params["embed"], (sb,), params["shared"], params["head"]

    def merge(ep, stages, sp, hp):
        layers = tree_map(
            lambda x: x.view((x.shape[0] * x.shape[1],) + tuple(x.shape[2:])),
            stages[0])
        return {"embed": ep, "layers": layers, "shared": sp, "head": hp}

    return LomoPieces(stage_keys=("layers",), stage_fns=(block,),
                      stage_inits=(embed_init,), head_loss_fn=head_loss,
                      split=split, merge=merge, shared_key="shared",
                      liveness_m=ae)


# ---------------------------------------------------------------- serving

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
