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

Gated linear scan (``csrc/ssm_scan.cu``): ``ssm_scan_ref`` is the
reference's sequential oracle; ``gated_chunked_scan_ref`` is
``repro.models.mamba2.gated_chunked_scan`` line for line, its bf16
roundings included (the kernel computes in fp32 throughout).

The wrappers call these on CPU tensors; the CPU tests hold them against
the JAX package, and ``chip_smoke.py`` holds each kernel against them on
the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import NEG, _repeat_kv


def _softmax_pv(sc: torch.Tensor, v: torch.Tensor, eq: str,
                dtype: torch.dtype) -> torch.Tensor:
    probs = torch.softmax(sc, dim=-1).to(dtype)
    return torch.einsum(eq, probs, v)


def _valid_keys(pos: torch.Tensor, starts: torch.Tensor,
                prefix: int) -> torch.Tensor:
    """(B, S) key validity: ``j >= prefix + starts[b]``, or ``j < prefix``
    (the always-valid prefix in front of the left pad; the vlm mask of
    ``repro.models.transformer._pad_valid``)."""
    valid = pos[None, :] >= starts.long()[:, None] + prefix
    return valid | (pos[None, :] < prefix) if prefix else valid


def flash_attention_ref(q, k, v, starts: Optional[torch.Tensor] = None,
                        causal: bool = True, prefix: int = 0) -> torch.Tensor:
    """Prefill attention.  q (B,S,H,hd); k/v (B,Sk,KV,hd); starts (B,) int.

    Key j is visible to query i iff ``j <= i`` (causal, where Sk == S) and
    key j is valid (``j >= prefix + starts[b]`` or ``j < prefix``: the left
    pad sits behind a ``prefix`` of vision tokens) — the masking of
    ``repro.models.layers.chunked_causal_attention(..., k_valid=)``; a
    non-causal call with Sk != S (cross attention) sees every key.
    Rows at pad positions may see no key and come out as finite garbage,
    as in JAX; callers read valid rows only."""
    b, s, h, hd = q.shape
    sk = k.shape[1]
    n_rep = h // k.shape[2]
    kk, vv = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    scale = 1.0 / math.sqrt(hd)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, kk).float() * scale
    pos = torch.arange(sk, device=q.device)
    valid = torch.ones((b, s, sk), dtype=torch.bool, device=q.device)
    if causal:
        valid = valid & (pos[None, :s, None] >= pos[None, None, :])
    if starts is not None:
        valid = valid & _valid_keys(pos, starts, prefix)[:, None, :]
    sc = torch.where(valid[:, None], sc, torch.full_like(sc, NEG))
    return _softmax_pv(sc, vv, "bhqk,bkhd->bqhd", q.dtype)


def flash_decode_ref(q, k, v, lengths: torch.Tensor,
                     starts: Optional[torch.Tensor] = None,
                     prefix: int = 0) -> torch.Tensor:
    """One query per row against a contiguous cache.

    q (B,H,hd); k/v (B,S,KV,hd); keys at positions ``[0, prefix)`` and
    ``[prefix + starts[b], lengths[b])`` attend
    (``repro.models.layers.gqa_decode_attention``'s softmax with starts =
    pad, prefix = vision_tokens, lengths = position + 1)."""
    b, s, kvh, hd = k.shape
    n_rep = q.shape[1] // kvh
    kk, vv = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    scale = 1.0 / math.sqrt(hd)
    sc = torch.einsum("bhd,bkhd->bhk", q, kk).float() * scale
    pos = torch.arange(s, device=q.device)[None, :]
    valid = pos < lengths.long()[:, None]
    if starts is not None:
        valid = valid & _valid_keys(pos[0], starts, prefix)
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


# ------------------------------------------------------- gated linear scan

def ssm_scan_ref(x, a, b, c):
    """Sequential gated linear scan per head (``repro.kernels.ref.
    ssm_scan_ref``).  x (B,S,H,P) scaled inputs; a (B,S,H) decays in
    (0, 1]; b/c (B,S,N).  ``h_t = a_t h_{t-1} + x_t (x) b_t``,
    ``y_t = h_t . c_t``, from a zero state, in fp32.  Returns
    (y (B,S,H,P) in x's dtype, h_final (B,H,P,N) fp32)."""
    bt, s, hh, p = x.shape
    n = b.shape[-1]
    h = torch.zeros((bt, hh, p, n), dtype=torch.float32, device=x.device)
    a32, x32, b32, c32 = a.float(), x.float(), b.float(), c.float()
    ys = []
    for t in range(s):
        h = h * a32[:, t, :, None, None] \
            + x32[:, t, :, :, None] * b32[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", h, c32[:, t]))
    y = torch.stack(ys, dim=1) if ys else x32.new_zeros(x.shape)
    return y.to(x.dtype), h


def _segsum(a_log: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): the sum of a_log over (j, i] for i >= j,
    -inf above the diagonal (masked before the exp, as the reference)."""
    t = a_log.shape[-1]
    cum = torch.cumsum(a_log, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones((t, t), dtype=torch.bool, device=a_log.device).tril()
    return torch.where(mask, diff, torch.full_like(diff, -math.inf))


def scan_chunking(s: int, chunk: int) -> tuple[int, int]:
    """(chunk length, number of chunks) of the reference's rule
    ``nc = max(1, S // chunk)``, ``Lc = S // nc``.  Where ``Lc`` does not
    divide S (the reference rejects such an S) the last chunk is short."""
    lc = s // max(1, s // chunk)
    return lc, -(-s // lc)


def gated_chunked_scan_ref(x, a_log, b, c, chunk: int = 128, h0=None):
    """The chunked scan of ``repro.models.mamba2.gated_chunked_scan``, line
    for line: intra-chunk scores ``(C B^T) * exp(segsum)``, chunk states,
    a sequential scan over chunks, the entering state's output.  Every
    product and the carried state round to x's dtype where the reference
    rounds (bf16 in, bf16 out of each einsum; the 3-operand einsums in
    JAX's contraction order).

    x (Bt,S,H,P); a_log (Bt,S,H) log decays; b/c (Bt,S,N); h0 (Bt,H,P,N)
    or None.  A short last chunk is zero rows: x = b = c = 0 adds nothing
    and a_log = 0 decays nothing.  Returns (y in x's dtype, the final state
    in x's dtype, as the reference returns it)."""
    bt, s, hh, p = x.shape
    n = b.shape[-1]
    lc, nc = scan_chunking(s, chunk)
    pad = nc * lc - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a_log = F.pad(a_log, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    dt = x.dtype
    xc = x.reshape(bt, nc, lc, hh, p)
    bc = b.reshape(bt, nc, lc, n)
    cc = c.reshape(bt, nc, lc, n)
    # the decays in fp32, as the reference; fp64 inputs stay fp64
    acc = torch.promote_types(a_log.dtype, torch.float32)
    al = a_log.reshape(bt, nc, lc, hh).to(acc).movedim(-1, 2)  # (Bt,nc,H,Lc)

    # intra-chunk (attention-like)
    lmat = torch.exp(_segsum(al))                        # (Bt,nc,H,Lc,Lc)
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)     # b's dtype
    scores = scores[:, :, None] * lmat                   # promotes to fp32
    y_intra = torch.einsum("bchij,bcjhp->bcihp", scores.to(dt), xc.to(dt))

    # chunk states: (B_j * decay_j) first, then the product with x
    cum = torch.cumsum(al, dim=-1)
    total = cum[..., -1:]
    decay_to_end = torch.exp(total - cum).to(dt)         # (Bt,nc,H,Lc)
    db = bc.to(dt)[..., None] * decay_to_end.permute(0, 1, 3, 2)[:, :, :, None]
    states = torch.einsum("bcjnh,bcjhp->bchpn", db, xc.to(dt))

    # inter-chunk scan, emitting the state entering each chunk
    chunk_decay = torch.exp(total[..., 0])               # (Bt,nc,H)
    h = torch.zeros((bt, hh, p, n), dtype=dt, device=x.device) \
        if h0 is None else h0.to(dt)
    h_enter = []
    for ci in range(nc):
        h_enter.append(h)
        h = h * chunk_decay[:, ci, :, None, None].to(h.dtype) + states[:, ci]
    h_enter = torch.stack(h_enter, dim=1)                # (Bt,nc,H,P,N)

    # the entering state's output: (h . C_i) first, then the decay
    decay_from_start = torch.exp(cum).to(dt)             # (Bt,nc,H,Lc)
    hc = torch.einsum("bchpn,bcin->bchpi", h_enter, cc.to(dt))
    y_inter = hc.permute(0, 1, 4, 2, 3) * \
        decay_from_start.permute(0, 1, 3, 2)[..., None]
    y = (y_intra + y_inter).reshape(bt, nc * lc, hh, p)[:, :s]
    return y, h
