"""xLSTM LM: mLSTM (matrix memory, chunk-parallel) and sLSTM (scalar
memory, sequential) blocks, ratio (slstm_every-1):1 (port of
``repro.models.xlstm``), served and trained.

mLSTM recurrence per head (state C: (hd + 1) x hd, its last row the
normalizer n):
    C_t = f_t C_{t-1} + i_t v_t k_t^T        n_t = f_t n_{t-1} + i_t k_t
    y_t = (C_t q_t) / max(|n_t . q_t|, 1)
The prompt pass folds the heads into the batch and appends a ones-channel
to v for the normalizer, and runs the gated chunked scan
``kernels.ssm_scan`` at (P, N) = (hd + 1, hd): on CUDA tensors the
hand-written wide-state kernel (``csrc/ssm_scan_wide.cu``, (1025, 1024)
at xlstm-1.3b), on CPU tensors its plain version.  The kernel loads x's
rows of P elements one element at a time, so the model passes x as it is,
unpadded.  Decode (``mlstm_decode``) is plain torch, as in the reference.
The sLSTM is a Python time loop, as the reference's ``lax.scan``; its four
recurrent products are one stacked (H, dh, 4 dh) product (each output's
sum is unchanged) and its four gate sums one add.

The same param dict and cache layouts as the reference: the mLSTM layers
stacked on a leading ``n_m`` dim, the sLSTM layers on ``n_sb``.
Differences of the serving functions from JAX, all deliberate: caches are
updated in place and also returned, ``"pos"`` is a host int, and on the
card the prefill's state is the kernel's fp32 state, where the reference
returns its scan's state in x's dtype (in bf16 serving it rounds the
state entering decode to bf16).  As in the reference, the prefill masks
no left pad: pad tokens (token 0) run through both recurrences.

Training: ``apply``, ``loss_fn`` and ``lomo_pieces``, with the
reference's ``unit_spec`` and ``unit_first_depth``.  Each mLSTM block
trains through ``mlstm_forward``: the prompt pass's ops with the plain
chunked scan (``mamba2.gated_chunked_scan``) under
``torch.utils.checkpoint``, as the reference trains through its jnp scan
under ``jax.checkpoint``; the wide kernel has no backward.  The sLSTM
trains through its Python time loop under autograd.  The HiFT cut is
rounded down to a super-block, as in the reference.  Any leaf may be a
codec record (quantized residency): the embedding decodes its gathered
rows, every 2-d projection and the head multiply through the
dequant-matmul kernel (``layers.linear``), the sLSTM's recurrent weights
are decoded at use and the ``(L, d)`` stacks come decoded.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common.pytree import tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.base import LomoPieces, Unit, dense_unit, layer_at

PyTree = Any
# leaves the reference reads in fp32 whatever the compute dtype: the forget
# gate's bias (added to the fp32 gate) and the sLSTM's recurrent weights
# (multiplied by its fp32 state)
FP32_LEAVES = ("b_f", "r_z", "r_i", "r_f", "r_o")


def _n_sb(cfg: ArchConfig) -> int:
    if cfg.n_layers % cfg.slstm_every:
        raise ValueError("n_layers must divide into super-blocks of "
                         f"slstm_every = {cfg.slstm_every}")
    return cfg.n_layers // cfg.slstm_every


def _dims(cfg: ArchConfig) -> tuple[int, int, int]:
    """(d_inner, heads, head dim) of the mLSTM."""
    di = cfg.expand * cfg.d_model
    return di, cfg.n_heads, di // cfg.n_heads


# ------------------------------------------------------------------- mLSTM

def mlstm_init(gen: torch.Generator, cfg: ArchConfig, *, lead=(),
               device=None, dtype=torch.float32) -> PyTree:
    d = cfg.d_model
    di, H, _ = _dims(cfg)
    kw = dict(lead=lead, device=device, dtype=dtype)
    return {
        "ln": L.rmsnorm_init(d, **kw),
        "w_up": L.dense_init(gen, d, di, **kw),
        "w_gate": L.dense_init(gen, d, di, **kw),
        "wq": L.dense_init(gen, di, di, **kw),
        "wk": L.dense_init(gen, di, di, **kw),
        "wv": L.dense_init(gen, di, di, **kw),
        "w_i": L.dense_init(gen, di, H, **kw),
        "w_f": L.dense_init(gen, di, H, **kw),
        # bias toward remembering
        "b_f": torch.full((*lead, H), 3.0, device=device, dtype=dtype),
        "out_norm": L.rmsnorm_init(di, **kw),
        "w_down": L.dense_init(gen, di, d, **kw),
    }


def _mlstm_qkvgates(p, hn: torch.Tensor, cfg: ArchConfig):
    b, s, _ = hn.shape
    _, H, hd = _dims(cfg)
    x_in = L.linear(hn, p["w_up"])
    z = L.linear(hn, p["w_gate"])
    q = L.linear(x_in, p["wq"]).reshape(b, s, H, hd) / math.sqrt(hd)
    k = L.linear(x_in, p["wk"]).reshape(b, s, H, hd)
    v = L.linear(x_in, p["wv"]).reshape(b, s, H, hd)
    i_gate = torch.sigmoid(L.linear(x_in, p["w_i"]).float())
    f_raw = L.linear(x_in, p["w_f"]).float() + p["b_f"].float()
    return x_in, z, q, k, v, i_gate, F.logsigmoid(f_raw)


def _with_ones(v: torch.Tensor) -> torch.Tensor:
    """v with the normalizer's ones-channel appended to its last dim."""
    return torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)


def _mlstm_mix(p, h: torch.Tensor, cfg: ArchConfig, scan):
    """One mLSTM block up to its output projection: the norm, the
    projections and gates, the heads folded into the batch (per-head k and
    q act as the scan's b and c, v gains the normalizer's ones-channel),
    ``scan(x, a_log, b, c) -> (y, state)``, the normalized readout, the
    output norm and gate.  Returns (y (B, S, di), the scan's state)."""
    b, s, _ = h.shape
    di, H, hd = _dims(cfg)
    hn = L.rmsnorm(p["ln"], h)
    _, z, q, k, v, i_gate, f_log = _mlstm_qkvgates(p, hn, cfg)
    x_scaled = _with_ones(v) * i_gate[..., None].to(v.dtype)   # (B,S,H,hd+1)
    xs = x_scaled.transpose(1, 2).reshape(b * H, s, 1, hd + 1)
    a_log = f_log.transpose(1, 2).reshape(b * H, s, 1)
    bm = k.transpose(1, 2).reshape(b * H, s, hd)
    cm = q.transpose(1, 2).reshape(b * H, s, hd)
    y_aug, state = scan(xs, a_log, bm, cm)
    y_aug = y_aug.reshape(b, H, s, hd + 1)
    y = (y_aug[..., :hd]
         / torch.clamp(y_aug[..., hd:].abs(), min=1.0)).to(h.dtype)
    y = y.transpose(1, 2).reshape(b, s, di)
    return L.rmsnorm(p["out_norm"], y) * F.silu(z), state


def mlstm_prefill(p, h: torch.Tensor, cfg: ArchConfig):
    """The prompt pass of one mLSTM block (the reference's
    ``prefill.mlstm_prefill``) through ``kernels.ssm_scan``.  h: (B, S,
    D).  Returns (h + the block's output, the final state C (B, H, hd + 1,
    hd) fp32)."""
    _, H, hd = _dims(cfg)
    y, state = _mlstm_mix(p, h, cfg, ssm_scan)
    return (h + y @ p["w_down"].to(h.dtype),
            state.reshape(h.shape[0], H, hd + 1, hd))


def mlstm_forward(p, h: torch.Tensor, cfg: ArchConfig, chunk: int = 128):
    """The training forward of one mLSTM block (the reference's
    ``mlstm_forward``), h: (B, S, D) -> (B, S, D).  The prompt pass's ops
    with the plain chunked scan, run under ``torch.utils.checkpoint`` when
    grad is enabled, as the reference wraps its scan in
    ``jax.checkpoint``: the scan's chunk states are recomputed in the
    backward instead of saved."""

    def scan(*args):
        return M.gated_chunked_scan(*args, chunk=chunk)[0]

    def train_scan(*args):
        if torch.is_grad_enabled():
            return checkpoint(scan, *args, use_reentrant=False,
                              preserve_rng_state=False), None
        return scan(*args), None

    y, _ = _mlstm_mix(p, h, cfg, train_scan)
    return h + L.linear(y, p["w_down"])


def mlstm_decode(p, h: torch.Tensor, cfg: ArchConfig, C: torch.Tensor):
    """One-token step.  h: (B, 1, D); C: (B, H, hd + 1, hd) fp32, updated
    in place (``C f + i v k^T``, as the reference computes it) and
    returned."""
    b = h.shape[0]
    di, _, hd = _dims(cfg)
    hn = L.rmsnorm(p["ln"], h)
    _, z, q, k, v, i_gate, f_log = _mlstm_qkvgates(p, hn, cfg)
    f = torch.exp(f_log[:, 0])                               # (B, H)
    i_g = i_gate[:, 0]                                       # (B, H)
    outer = torch.einsum("bhp,bhn->bhpn", _with_ones(v)[:, 0].float(),
                         k[:, 0].float())
    C.mul_(f[..., None, None]).add_(i_g[..., None, None] * outer)
    y_aug = torch.einsum("bhpn,bhn->bhp", C, q[:, 0].float())
    y = y_aug[..., :hd] / torch.clamp(y_aug[..., hd:].abs(), min=1.0)
    y = y.reshape(b, 1, di).to(h.dtype)
    y = L.rmsnorm(p["out_norm"], y) * F.silu(z)
    return h + y @ p["w_down"].to(h.dtype), C


# ------------------------------------------------------------------- sLSTM

def slstm_init(gen: torch.Generator, cfg: ArchConfig, *, lead=(),
               device=None, dtype=torch.float32) -> PyTree:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    kw = dict(lead=lead, device=device, dtype=dtype)

    def r():
        w = torch.randn((*lead, H, dh, dh), generator=gen, device=device,
                        dtype=dtype)
        return w.mul_(1.0 / math.sqrt(dh))

    return {
        "ln": L.rmsnorm_init(d, **kw),
        "w_zifo": L.dense_init(gen, d, 4 * d, **kw),
        "r_z": r(), "r_i": r(), "r_f": r(), "r_o": r(),
        "b_zifo": torch.zeros((*lead, 4 * d), device=device, dtype=dtype),
        "w_out": L.dense_init(gen, d, d, **kw),
    }


def _slstm_scan(p, x_gates: torch.Tensor, cfg: ArchConfig, state: dict):
    """x_gates: (B, S, 4d) precomputed input contributions; state: dict(c,
    n, h, m) each (B, H, dh) fp32.  Sequential over S, in fp32.  Returns
    (ys (B, S, d) fp32, the new state)."""
    b, s, _ = x_gates.shape
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    # r_z | r_i | r_f | r_o: one (H, dh, 4 dh) product a step
    r = torch.cat([L.decoded(p[k]).float()
                   for k in ("r_z", "r_i", "r_f", "r_o")], -1)
    xg = x_gates.float().reshape(b, s, 4, H, dh)
    c, n, hprev, m = state["c"], state["n"], state["h"], state["m"]
    ys = []
    for t in range(s):
        # (H, B, 4 dh) -> (B, 4, H, dh): the four gates' sums in one add
        rec = torch.bmm(hprev.transpose(0, 1), r).view(H, b, 4, dh)
        g = xg[:, t] + rec.permute(1, 2, 0, 3)
        z = torch.tanh(g[:, 0])
        i_t = g[:, 1]
        o = torch.sigmoid(g[:, 3])
        fm = F.logsigmoid(g[:, 2]) + m
        m_new = torch.maximum(fm, i_t)                       # stabilizer
        i_p = torch.exp(i_t - m_new)
        f_p = torch.exp(fm - m_new)
        c = f_p * c + i_p * z
        n = f_p * n + i_p
        hprev = o * c / torch.clamp(n, min=1e-6)
        m = m_new
        ys.append(hprev)
    return (torch.stack(ys, dim=1).reshape(b, s, d),
            {"c": c, "n": n, "h": hprev, "m": m})


def slstm_forward(p, h: torch.Tensor, cfg: ArchConfig, state=None):
    """One sLSTM block over (B, S, D) from ``state`` (zeros if None).
    Returns (h + the block's output, the new state)."""
    hn = L.rmsnorm(p["ln"], h)
    xg = L.linear(hn, p["w_zifo"]) + p["b_zifo"].to(h.dtype)
    if state is None:
        state = slstm_zero_state(cfg, h.shape[0], h.device)
    ys, st = _slstm_scan(p, xg, cfg, state)
    return h + L.linear(ys.to(h.dtype), p["w_out"]), st


def slstm_zero_state(cfg: ArchConfig, batch: int, device="cpu") -> dict:
    dh = cfg.d_model // cfg.n_heads
    return {k: torch.zeros((batch, cfg.n_heads, dh), dtype=torch.float32,
                           device=device) for k in ("c", "n", "h", "m")}


# -------------------------------------------------------------------- model

def init(cfg: ArchConfig, generator: torch.Generator, device="cpu",
         dtype=torch.float32) -> PyTree:
    """Random params from ``generator`` with the reference's shapes and
    scales (other numbers than ``jax.random`` from the same seed)."""
    n_sb = _n_sb(cfg)
    n_m = n_sb * (cfg.slstm_every - 1)
    kw = dict(device=device, dtype=dtype)
    return {
        "embed": {"tok": L.embed_init(generator, cfg.vocab_padded,
                                      cfg.d_model, **kw)},
        "mlstm": mlstm_init(generator, cfg, lead=(n_m,), **kw),
        "slstm": slstm_init(generator, cfg, lead=(n_sb,), **kw),
        "head": {"final_norm": L.rmsnorm_init(cfg.d_model, **kw),
                 "w": L.dense_init(generator, cfg.d_model, cfg.vocab_padded,
                                   **kw)},
    }


def unit_spec(cfg: ArchConfig) -> list[Unit]:
    """[embed], then per super-block its mLSTM layers and its sLSTM layer,
    then [head]."""
    m_per = cfg.slstm_every - 1
    units = [dense_unit("embed")]
    for sb in range(_n_sb(cfg)):
        units += [Unit("stacked", "mlstm", sb * m_per + j)
                  for j in range(m_per)]
        units.append(Unit("stacked", "slstm", sb))
    return units + [dense_unit("head")]


def unit_first_depth(cfg: ArchConfig, unit: Unit) -> int:
    """The layer depth at which a unit's params are first used."""
    m_per = cfg.slstm_every - 1
    if unit.key == "embed":
        return 0
    if unit.key == "mlstm":
        sb, j = divmod(unit.index, m_per)
        return sb * cfg.slstm_every + j
    if unit.key == "slstm":
        return unit.index * cfg.slstm_every + m_per
    return cfg.n_layers        # head


# ---------------------------------------------------------------- training

def _super_block(cfg: ArchConfig):
    """``block(h, mlstm_layers, slstm_layer) -> h``: the super-block's
    ``slstm_every - 1`` mLSTM blocks, then its sLSTM block."""

    def block(h, mlstm_layers, slstm_layer):
        for p in mlstm_layers:
            h = mlstm_forward(p, h, cfg)
        return slstm_forward(slstm_layer, h, cfg)[0]
    return block


def _sb_layers(cfg: ArchConfig, params: PyTree, sb: int):
    """Super-block ``sb``'s mLSTM layers and its sLSTM layer, one at a time
    from whichever piece of a ``LayerStack`` holds each (a HiFT group may
    straddle a super-block)."""
    m_per = cfg.slstm_every - 1
    return ([layer_at(params["mlstm"], i)
             for i in range(sb * m_per, (sb + 1) * m_per)],
            layer_at(params["slstm"], sb))


def apply(cfg: ArchConfig, params: PyTree, batch, cut: Optional[int] = None,
          compute_dtype=torch.bfloat16, return_hidden: bool = False):
    """Training forward -> logits (B, S, V) float32 (or the final hidden
    states with ``return_hidden``).

    ``params["mlstm"]`` and ``params["slstm"]`` are each the stacked
    sub-tree or a ``models.base.LayerStack``.  ``cut``: the HiFT backward
    cut, rounded down to a super-block as the reference rounds it
    (``sb_cut = min(cut // slstm_every, n_sb)``).  None = FPFT.  Otherwise
    the embedding's output is detached, super-blocks below ``sb_cut`` run
    without a graph and the activation entering super-block ``sb_cut`` is
    detached.  Each super-block that records a graph runs under
    ``torch.utils.checkpoint`` when the config asks for
    ``remat="layer"``."""
    h = L.embed_lookup(params["embed"]["tok"],
                       batch["tokens"]).to(compute_dtype)
    n_sb = _n_sb(cfg)
    sb_cut = 0
    if cut is not None:
        h = h.detach()
        sb_cut = min(cut // cfg.slstm_every, n_sb)
    block = _super_block(cfg)
    remat = cfg.remat == "layer"
    for sb in range(n_sb):
        layers = _sb_layers(cfg, params, sb)
        if sb < sb_cut:
            with torch.no_grad():
                h = block(h, *layers)
            continue
        if sb == sb_cut and sb_cut:
            h = h.detach()
        if remat and torch.is_grad_enabled():
            h = checkpoint(block, h, *layers, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = block(h, *layers)
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

    The fused grain is one SUPER-BLOCK (``slstm_every - 1`` mLSTM blocks
    and one sLSTM block), as in the reference: the two stacked segments
    interleave at that period, so a grain's slice is the tree
    ``{"mlstm": (m_per, ...), "slstm": (...)}`` and ``liveness_m =
    slstm_every``.  ``split`` reshapes ``mlstm`` from ``(n_m, ...)`` to
    ``(n_sb, m_per, ...)`` as VIEWS (``Tensor.view``, which raises rather
    than copy): ``lomo`` and ``adalomo`` update those slices in place.
    No shared segment; the head is untied."""
    from repro_torch.models.losses import chunked_next_token_xent
    n_sb, m_per = _n_sb(cfg), cfg.slstm_every - 1
    sb_block = _super_block(cfg)

    def embed_init(embed_p, prev, batch):
        del prev
        return L.embed_lookup(embed_p["tok"],
                              batch["tokens"]).to(compute_dtype), None

    def block(sb_p, shared_p, side, h):
        del shared_p, side
        return sb_block(h, [layer_at(sb_p["mlstm"], j) for j in range(m_per)],
                        sb_p["slstm"])

    def head_loss(head_p, embed_p, h, batch):
        del embed_p  # untied head
        h = L.rmsnorm(head_p["final_norm"], h)
        return chunked_next_token_xent(h, L.weight(head_p["w"]),
                                       batch["labels"],
                                       chunk=cfg.ce_chunk or None)

    def split(params):
        m_sb = tree_map(lambda x: x.view((n_sb, m_per) + tuple(x.shape[1:])),
                        params["mlstm"])
        return (params["embed"], ({"mlstm": m_sb, "slstm": params["slstm"]},),
                None, params["head"])

    def merge(ep, stages, sp, hp):
        del sp
        mlstm = tree_map(
            lambda x: x.view((x.shape[0] * x.shape[1],) + tuple(x.shape[2:])),
            stages[0]["mlstm"])
        return {"embed": ep, "mlstm": mlstm, "slstm": stages[0]["slstm"],
                "head": hp}

    return LomoPieces(stage_keys=("blocks",), stage_fns=(block,),
                      stage_inits=(embed_init,), head_loss_fn=head_loss,
                      split=split, merge=merge, liveness_m=cfg.slstm_every)


# ---------------------------------------------------------------- serving

def init_cache(cfg: ArchConfig, batch: int, max_len: int = 0,
               dtype=torch.bfloat16, device="cpu") -> PyTree:
    """Constant-size state (``max_len`` and ``dtype`` are unused, as in
    the reference): mlstm_C (n_m, B, H, hd + 1, hd) fp32; the sLSTM's c,
    n, h, m each (n_sb, B, H, dh) fp32; pos."""
    del max_len, dtype
    n_sb = _n_sb(cfg)
    n_m = n_sb * (cfg.slstm_every - 1)
    _, H, hd = _dims(cfg)
    dh = cfg.d_model // H
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "mlstm_C": torch.zeros((n_m, batch, H, hd + 1, hd), **f32),
        "slstm": {k: torch.zeros((n_sb, batch, H, dh), **f32)
                  for k in ("c", "n", "h", "m")},
        "pos": 0,
    }


def _layer(tree: PyTree, i: int) -> PyTree:
    return tree_map(lambda x: x[i], tree)


def _slstm_state(cache: PyTree, sb: int) -> dict:
    return {k: v[sb] for k, v in cache["slstm"].items()}


def _store_slstm(cache: PyTree, sb: int, state: dict) -> None:
    for k, v in state.items():
        cache["slstm"][k][sb] = v


def _logits(params, h: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(params["head"]["final_norm"], h)
    return (h @ params["head"]["w"].to(h.dtype)).float()


def prefill(cfg: ArchConfig, params: PyTree, batch, cache: PyTree,
            compute_dtype=torch.bfloat16):
    """Prompt pass: per super-block, ``slstm_every - 1`` mLSTM blocks
    (each fills its layer's ``mlstm_C`` with its scan's final state), then
    the sLSTM block from the cache's state.  ``batch``: {"tokens": (B, S)
    int}.  Returns ``(logits (B, 1, V) float32, cache)``."""
    h = params["embed"]["tok"][batch["tokens"]].to(compute_dtype)
    m_per = cfg.slstm_every - 1
    for sb in range(_n_sb(cfg)):
        for i in range(sb * m_per, (sb + 1) * m_per):
            h, C = mlstm_prefill(_layer(params["mlstm"], i), h, cfg)
            cache["mlstm_C"][i] = C
        h, st = slstm_forward(_layer(params["slstm"], sb), h, cfg,
                              _slstm_state(cache, sb))
        _store_slstm(cache, sb, st)
    cache["pos"] = h.shape[1]
    return _logits(params, h[:, -1:]), cache


def decode_step(cfg: ArchConfig, params: PyTree, cache: PyTree, tokens,
                compute_dtype=torch.bfloat16):
    """One new token per sequence.  tokens: (B, 1) int.  Advances every
    layer's state in place.  Returns ``(logits (B, 1, V) float32,
    cache)``."""
    h = params["embed"]["tok"][tokens].to(compute_dtype)
    m_per = cfg.slstm_every - 1
    for sb in range(_n_sb(cfg)):
        for i in range(sb * m_per, (sb + 1) * m_per):
            h, _ = mlstm_decode(_layer(params["mlstm"], i), h, cfg,
                                cache["mlstm_C"][i])
        h, st = slstm_forward(_layer(params["slstm"], sb), h, cfg,
                              _slstm_state(cache, sb))
        _store_slstm(cache, sb, st)
    cache["pos"] = int(cache["pos"]) + 1
    return _logits(params, h), cache
