"""Mixture-of-Experts transformer LM (port of ``repro.models.moe``).

Covers deepseek-moe-16b (2 shared + 64 routed experts, top-6,
fine-grained) and arctic-480b (128 routed top-2 + a dense residual FFN in
parallel), with the reference's param dict and cache layouts.

Dispatch (:func:`moe_ffn`) is the reference's sort-based one with a fixed
per-expert capacity ``C``: the (token, slot) routes are stably sorted by
expert, packed into an (E, C, d) buffer (routes past an expert's capacity
are dropped), run through batched expert products (``torch.bmm``: the
reference computes them as plain ``einsum`` outside any Pallas kernel),
and combined back weighted by the normalised router gates.  Decode runs
the dropless :func:`moe_ffn_exact`, which gathers each token's K experts'
weights (fine at decode batch sizes; never used on the prefill or
training path, as in the reference).

Training: ``unit_spec`` ([embed] + layers + [head]), ``apply``,
``loss_fn`` and ``lomo_pieces`` (one MoE layer a piece), through
``models.base.run_layers``.  Attention trains through the plain chunked
attention, as the reference trains.  Under quantized residency the
attention, shared-expert, dense-residual, router and head weights
multiply through the dequant-matmul kernel (``layers.linear``); each
frozen layer's expert stacks come as codec views
(``dist.quant.layer_of``) that the layer's forward decodes by the codec's
plain decode, one layer at a time, as the reference decodes in its jitted
step.  Serving: ``init``, ``init_cache``, ``prefill``
(``kernels.flash_attention``, no pad mask, as the reference's moe
prefill) and ``decode_step`` (``kernels.flash_decode``).

Differences from JAX, all deliberate:

- the combine is deterministic: instead of a scatter-add of the sorted
  routes into the tokens (``index_add_`` is atomic and unordered on
  CUDA), each route's contribution is gathered back to its (token, slot)
  and a token's K contributions are summed in increasing expert order,
  the order in which the reference's CPU scatter adds them;
- the buffer is filled by writing each kept route to its own slot; a
  dropped route adds zeros at ``expert * C`` in the reference, which
  leaves that slot's value as it is;
- ``moe_ffn_spmd`` sums the model ranks' outputs with one all-reduce
  (the reference's ``psum`` inside ``shard_map``), and its backward sums
  the gradients of the tokens, router logits and expert stacks over the
  model group, so each rank holds the whole gradient for the data-axis
  reduce that follows;
- serving's param and cache conventions are ``models.transformer``'s
  (params already in the compute dtype, caches updated in place, a host
  int ``"pos"``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.common.pytree import tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.dist.quant import QuantView
from repro_torch.kernels.flash_attention import flash_attention, flash_decode
from repro_torch.models import layers as L
from repro_torch.models.base import (LomoPieces, Unit, dense_unit, run_layers,
                                     stacked_units)

PyTree = Any

# (token, slot) expert ids of every dispatch while recording (a list), or
# None: how a run shows which routes differ between two devices
_ROUTES: Optional[list] = None


@contextlib.contextmanager
def recording_routes():
    """Collect the ``expert_ids`` (N, K) of every :func:`moe_ffn` and
    :func:`moe_ffn_exact` call inside the block, in call order (a
    checkpointed layer's recomputation records again)."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = prev


# ------------------------------------------------------------------ MoE core

def moe_ffn_init(gen: torch.Generator, cfg: ArchConfig, *, lead=(),
                 device=None, dtype=torch.float32) -> PyTree:
    """Router (d, E) and the expert stacks (E, d, ff), (E, ff, d) drawn as
    normal / sqrt(fan_in) and scaled in place (no second copy of a stack);
    the shared experts' SwiGLU of width ``moe_d_ff * n_shared_experts``."""
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    kw = dict(lead=lead, device=device, dtype=dtype)

    def stack(rows, cols):
        w = torch.randn((*lead, E, rows, cols), generator=gen, device=device,
                        dtype=dtype)
        return w.mul_(1.0 / math.sqrt(rows))

    p = {"router": L.dense_init(gen, d, E, **kw),
         "w_gate": stack(d, ff), "w_up": stack(d, ff),
         "w_down": stack(ff, d)}
    if cfg.n_shared_experts > 0:
        p["shared"] = L.swiglu_init(gen, d, ff * cfg.n_shared_experts, **kw)
    return p


def _route(p, xt: torch.Tensor, cfg: ArchConfig):
    """Top-k routing of tokens xt (N, d): normalised gates (N, K) fp32 and
    expert ids (N, K), the reference's fp32 softmax and ``top_k``."""
    return _gates(L.linear(xt, p["router"]).float(), cfg)


def _gates(logits: torch.Tensor, cfg: ArchConfig):
    """Normalised top-k gates and expert ids of fp32 router logits."""
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, cfg.top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    if _ROUTES is not None:
        _ROUTES.append(expert_ids.detach().clone())
    return gate_vals, expert_ids


def _stack(w, dtype) -> torch.Tensor:
    """An expert stack (E, rows, cols) in ``dtype``: a frozen layer's codec
    view decoded here, inside the layer's forward (and again in its
    checkpointed recompute), so no decoded stack outlives its use."""
    return (w.decode() if isinstance(w, QuantView) else w).to(dtype)


def capacity(n: int, cfg: ArchConfig) -> int:
    """Per-expert buffer rows for ``n`` tokens: the reference's
    ``int(math.ceil(n * K / E * capacity_factor))`` in Python floats."""
    return int(math.ceil(n * cfg.top_k / cfg.n_experts
                         * cfg.capacity_factor))


def _dispatch(xt: torch.Tensor, gate_vals: torch.Tensor,
              expert_ids: torch.Tensor, wg, wu, wd, cfg: ArchConfig,
              e_base: int, e_local: int) -> torch.Tensor:
    """The routed experts' output (n, d) over the expert range [e_base,
    e_base + e_local): sort-based packing with the capacity of all n
    tokens over all E experts, routes to other experts parked past the
    range (they add nothing); ``wg``/``wu``/``wd`` hold the range's
    stacks.  The whole range (``moe_ffn``, and ``moe_ffn_spmd`` at tp = 1)
    parks nothing and runs none of the parking ops."""
    n, d = xt.shape
    K = cfg.top_k
    part = not (e_base == 0 and e_local == cfg.n_experts)
    # ---- sort-based dispatch (stable: ties keep token order) ----
    C = capacity(n, cfg)
    flat_expert = expert_ids.reshape(-1)
    if part:
        flat_expert = flat_expert - e_base                    # local ids
        mine = (flat_expert >= 0) & (flat_expert < e_local)
        flat_expert = torch.where(mine, flat_expert, e_local)  # park foreign
    sorted_expert, order = torch.sort(flat_expert, stable=True)
    counts = torch.bincount(sorted_expert, minlength=e_local + part)
    seg_start = torch.cumsum(counts, 0) - counts
    within = torch.arange(n * K, device=xt.device) - seg_start[sorted_expert]
    keep = within < C
    if part:
        keep = keep & (sorted_expert < e_local)
    slot = sorted_expert * C + torch.where(keep, within, 0)
    sorted_token = order // K
    # the buffer row of every slot: the token routed there, or row n (of
    # zeros); dropped and foreign routes write to a spare last slot (no
    # host sync)
    row_token = torch.full((e_local * C + 1,), n, dtype=torch.long,
                           device=xt.device)
    row_token[torch.where(keep, slot, e_local * C)] = sorted_token
    xpad = torch.cat([xt, xt.new_zeros((1, d))])
    buffer = xpad[row_token[:-1]].reshape(e_local, C, d)

    # ---- expert FFN (batched products) ----
    g = F.silu(torch.bmm(buffer, _stack(wg, xt.dtype)))
    u = torch.bmm(buffer, _stack(wu, xt.dtype))
    out_buf = torch.bmm(g * u, _stack(wd, xt.dtype)).reshape(e_local * C, d)

    # ---- combine: each route back to its (token, slot), summed over the
    # token's slots in increasing expert order ----
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n * K, device=xt.device)
    keep_nk = keep[inv].reshape(n, K)
    gate = (gate_vals * keep_nk).to(xt.dtype)                 # (N, K)
    if part:
        # a foreign route reads row 0 (its gate is 0)
        slot = torch.where(sorted_expert < e_local, slot, 0)
    contrib = out_buf[slot[inv]].reshape(n, K, d) * gate[..., None]
    by_expert = torch.argsort(expert_ids, dim=-1)
    contrib = contrib.gather(1, by_expert[..., None].expand(n, K, d))
    out = contrib[:, 0]
    for k in range(1, K):
        out = out + contrib[:, k]
    return out


def moe_ffn(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D): top-k routing with capacity drop."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gate_vals, expert_ids = _route(p, xt, cfg)
    out = _dispatch(xt, gate_vals, expert_ids, p["w_gate"], p["w_up"],
                    p["w_down"], cfg, 0, cfg.n_experts)
    if cfg.n_shared_experts > 0:
        out = out + L.swiglu(p["shared"], xt)
    return out.reshape(b, s, d)


def _local_dispatch_ffn(xt, logits, wg, wu, wd, cfg: ArchConfig,
                        e_base: int, e_local: int) -> torch.Tensor:
    """Dispatch xt (n, d) to THIS rank's experts [e_base, e_base +
    e_local) (the reference's signature): routes from the fp32 router
    ``logits``, the local capacity of n tokens, foreign ids parked; the
    stacks ``wg``/``wu``/``wd`` hold the rank's experts only."""
    gate_vals, expert_ids = _gates(logits, cfg)
    return _dispatch(xt, gate_vals, expert_ids, wg, wu, wd, cfg, e_base,
                     e_local)


class _ModelSum(torch.autograd.Function):
    """All-reduce (sum) over the model group forward; the identity
    backward (everything after the sum is replicated over the group)."""

    @staticmethod
    def forward(ctx, t, mesh):
        from repro_torch.dist.shardings import model_sum_
        return model_sum_(t.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ModelCopy(torch.autograd.Function):
    """The identity forward; the backward sums the gradient over the model
    group (each rank's copy feeds only its own experts)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.dist.shardings import model_sum_
        return model_sum_(g.contiguous().clone(), ctx.mesh), None


def moe_ffn_spmd(p, x, cfg: ArchConfig):
    """Expert parallelism over the active context's model axis.

    Tokens arrive as the rank's data rows (a plain tensor; a DTensor's
    local shard, re-wrapped on the way out); each of the ``tp`` model
    ranks owns ``E / tp`` experts, packs only its own assignments with the
    local capacity ``C = ceil(n_local * K / E * capacity_factor)`` and
    runs them; one all-reduce over the model group sums the ranks'
    outputs, and the shared experts are added after it.  Under autograd the
    tokens, router logits and expert stacks enter through an operator
    whose backward sums over the model group, so every rank ends with the
    whole gradient.  Falls back to :func:`moe_ffn` where ``tp`` does not
    divide ``E``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import ctx as dctx
    from repro_torch.dist import shardings as S

    mesh, maxis = dctx.mesh(), dctx.model_axis()
    tp = S.sizes(mesh).get(maxis, 1) if maxis is not None else 1
    if cfg.n_experts % tp != 0:
        return moe_ffn(p, x, cfg)
    like = x if isinstance(x, DTensor) else None
    if like is not None:
        x = x.to_local()
    e_local = cfg.n_experts // tp
    e_base = (mesh.get_local_rank(maxis) * e_local) if tp > 1 else 0
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    logits = L.linear(xt, p["router"]).float()
    stacks = [p[k] for k in ("w_gate", "w_up", "w_down")]
    if tp > 1:
        if torch.is_grad_enabled():
            xt = _ModelCopy.apply(xt, mesh)
            logits = _ModelCopy.apply(logits, mesh)
            stacks = [_ModelCopy.apply(w, mesh) for w in stacks]
        stacks = [w[e_base:e_base + e_local] for w in stacks]
    out = _local_dispatch_ffn(xt, logits, *stacks, cfg, e_base, e_local)
    if tp > 1:
        out = _ModelSum.apply(out, mesh)
    if cfg.n_shared_experts > 0:
        out = out + L.swiglu(p["shared"], x.reshape(b * s, d))
    out = out.reshape(b, s, d)
    if like is not None:
        out = DTensor.from_local(out, like.device_mesh, like.placements,
                                 run_check=False)
    return out


def moe_ffn_auto(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The expert-parallel :func:`moe_ffn_spmd` under an active sharding
    context (``dist.ctx``; a strategy step under ``mesh=`` opens one),
    else :func:`moe_ffn`."""
    from repro_torch.dist import ctx as dctx
    if dctx.active():
        return moe_ffn_spmd(p, x, cfg)
    return moe_ffn(p, x, cfg)


def moe_ffn_exact(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Dropless MoE by a per-token gather of its K experts' weights (N, K,
    d, ff): exact (no capacity), for decode, where N is small."""
    b, s, d = x.shape
    n = b * s
    xt = x.reshape(n, d)
    gate_vals, expert_ids = _route(p, xt, cfg)
    wg = p["w_gate"][expert_ids].to(x.dtype)
    wu = p["w_up"][expert_ids].to(x.dtype)
    wd = p["w_down"][expert_ids].to(x.dtype)
    g = F.silu(torch.einsum("nd,nkdf->nkf", xt, wg))
    u = torch.einsum("nd,nkdf->nkf", xt, wu)
    y = torch.einsum("nkf,nkfd->nkd", g * u, wd)
    out = torch.einsum("nkd,nk->nd", y, gate_vals.to(x.dtype))
    if cfg.n_shared_experts > 0:
        out = out + L.swiglu(p["shared"], xt)
    return out.reshape(b, s, d)


# --------------------------------------------------------------------- model

def init(cfg: ArchConfig, generator: torch.Generator, device="cpu",
         dtype=torch.float32) -> PyTree:
    """Random params from ``generator`` with the reference's shapes and
    scales (other numbers than ``jax.random`` from the same seed), the
    per-layer leaves stacked on a leading ``n_layers`` dim."""
    kw = dict(device=device, dtype=dtype)
    stk = dict(lead=(cfg.n_layers,), **kw)
    layers = {
        "ln1": L.rmsnorm_init(cfg.d_model, **stk),
        "attn": L.gqa_attention_init(generator, cfg.d_model, cfg.n_heads,
                                     cfg.kv_heads, cfg.head_dim, cfg.qkv_bias,
                                     **stk),
        "ln2": L.rmsnorm_init(cfg.d_model, **stk),
        "moe": moe_ffn_init(generator, cfg, **stk),
    }
    if cfg.dense_residual:
        layers["dense_mlp"] = L.swiglu_init(generator, cfg.d_model, cfg.d_ff,
                                            **stk)
    return {
        "embed": {"tok": L.embed_init(generator, cfg.vocab_padded,
                                      cfg.d_model, **kw)},
        "layers": layers,
        "head": {"final_norm": L.rmsnorm_init(cfg.d_model, **kw),
                 "w": L.dense_init(generator, cfg.d_model, cfg.vocab_padded,
                                   **kw)},
    }


def unit_spec(cfg: ArchConfig) -> list[Unit]:
    return ([dense_unit("embed")] + stacked_units("layers", cfg.n_layers)
            + [dense_unit("head")])


def _ffn(p, hn: torch.Tensor, cfg: ArchConfig, moe_fn) -> torch.Tensor:
    """The MoE FFN, plus arctic's parallel dense residual FFN."""
    ff = moe_fn(p["moe"], hn, cfg)
    if cfg.dense_residual:
        ff = ff + L.swiglu(p["dense_mlp"], hn)
    return ff


def _block(cfg: ArchConfig, cos, sin):
    def step(h, p):
        h = h + L.gqa_attention(p["attn"], L.rmsnorm(p["ln1"], h), cfg, cos,
                                sin, impl=cfg.attention_impl,
                                balanced=cfg.attention_balanced)
        return h + _ffn(p, L.rmsnorm(p["ln2"], h), cfg, moe_ffn_auto)
    return step


def _rope(cfg: ArchConfig, max_len: int, device):
    return L.rope_frequencies(cfg.head_dim, max_len, cfg.rope_theta, device)


def apply(cfg: ArchConfig, params: PyTree, batch, cut: Optional[int] = None,
          compute_dtype=torch.bfloat16, return_hidden: bool = False):
    """Training forward -> logits (B, S, V) float32 (or the final hidden
    states with ``return_hidden``).  ``params["layers"]`` is the stacked
    sub-tree or a ``models.base.LayerStack``; ``cut`` is the HiFT backward
    cut (``models.base.run_layers``)."""
    h = L.embed_lookup(params["embed"]["tok"],
                       batch["tokens"]).to(compute_dtype)
    cos, sin = _rope(cfg, h.shape[1], h.device)
    if cut is not None:
        h = h.detach()
    h = run_layers(_block(cfg, cos, sin), params["layers"], h, cut=cut,
                   remat=cfg.remat == "layer")
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
    """Segmented forward for the fused-backward strategies: one MoE layer
    (attention, router, experts, shared experts or dense residual) is one
    piece, so its whole gradient is consumed in one reverse step."""
    from repro_torch.models.losses import chunked_next_token_xent

    def embed_init(embed_p, prev, batch):
        del prev
        return L.embed_lookup(embed_p["tok"],
                              batch["tokens"]).to(compute_dtype), None

    def block(layer_p, shared_p, side, h):
        del shared_p, side
        cos, sin = _rope(cfg, h.shape[1], h.device)
        return _block(cfg, cos, sin)(h, layer_p)

    def head_loss(head_p, embed_p, h, batch):
        del embed_p  # untied head
        h = L.rmsnorm(head_p["final_norm"], h)
        return chunked_next_token_xent(h, L.weight(head_p["w"]),
                                       batch["labels"],
                                       chunk=cfg.ce_chunk or None)

    return LomoPieces(
        stage_keys=("layers",), stage_fns=(block,),
        stage_inits=(embed_init,), head_loss_fn=head_loss,
        split=lambda params: (params["embed"], (params["layers"],), None,
                              params["head"]),
        merge=lambda ep, stages, sp, hp: {"embed": ep, "layers": stages[0],
                                          "head": hp})


# ---------------------------------------------------------------- serving

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu") -> PyTree:
    shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": 0}


def _layer(params, i: int) -> PyTree:
    return tree_map(lambda x: x[i], params["layers"])


def _qkv(cfg: ArchConfig, p, hn: torch.Tensor):
    b, s, _ = hn.shape
    q, k, v = hn @ p["wq"], hn @ p["wk"], hn @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, s, cfg.n_heads, cfg.head_dim),
            k.reshape(b, s, cfg.kv_heads, cfg.head_dim),
            v.reshape(b, s, cfg.kv_heads, cfg.head_dim))


def _logits(params, h: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(params["head"]["final_norm"], h)
    return (h @ params["head"]["w"]).float()


def prefill(cfg: ArchConfig, params: PyTree, batch, cache: PyTree,
            compute_dtype=torch.bfloat16):
    """Prompt pass filling the KV cache: causal attention through the
    prefill kernel (no pad mask, as the reference's moe prefill), the
    capacity dispatch.  ``batch``: {"tokens": (B, S) int}.  Returns
    ``(logits (B, 1, V) float32, cache)``."""
    h = params["embed"]["tok"][batch["tokens"]].to(compute_dtype)
    b, s, _ = h.shape
    cos, sin = _rope(cfg, s, h.device)
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        q, k, v = _qkv(cfg, p["attn"], L.rmsnorm(p["ln1"], h))
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
        o = flash_attention(q, k, v, starts=None, causal=True)
        h = h + o.reshape(b, s, -1) @ p["attn"]["wo"]
        h = h + _ffn(p, L.rmsnorm(p["ln2"], h), cfg, moe_ffn_auto)
    cache["pos"] = s
    return _logits(params, h[:, -1:]), cache


def decode_step(cfg: ArchConfig, params: PyTree, cache: PyTree, tokens,
                compute_dtype=torch.bfloat16):
    """One new token per sequence: attention over keys ``[0, pos]``
    through the decode kernel, the dropless expert gather.  tokens (B, 1)
    int.  Returns ``(logits (B, 1, V) float32, cache)``."""
    h = params["embed"]["tok"][tokens].to(compute_dtype)
    b = h.shape[0]
    max_len = cache["k"].shape[2]
    pos = int(cache["pos"])
    if pos >= max_len:
        raise ValueError(f"decode past the cache: pos {pos} >= {max_len}")
    cos, sin = _rope(cfg, max_len, h.device)
    positions = torch.full((b, 1), pos, dtype=torch.long, device=h.device)
    lengths = torch.full((b,), pos + 1, dtype=torch.int32, device=h.device)
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        q, k, v = _qkv(cfg, p["attn"], L.rmsnorm(p["ln1"], h))
        q = L.apply_rope(q, cos, sin, positions)
        k = L.apply_rope(k, cos, sin, positions)
        cache["k"][i, :, pos] = k[:, 0]
        cache["v"][i, :, pos] = v[:, 0]
        o = flash_decode(q[:, 0], cache["k"][i].to(h.dtype),
                         cache["v"][i].to(h.dtype), lengths)
        h = h + o.reshape(b, 1, -1) @ p["attn"]["wo"]
        h = h + _ffn(p, L.rmsnorm(p["ln2"], h), cfg, moe_ffn_exact)
    cache["pos"] = pos + 1
    return _logits(params, h), cache
