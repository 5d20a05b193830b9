"""Cross-entropy losses (port of ``repro.models.losses``).

``chunked_next_token_xent`` never materializes the full (B, S, V) logits:
the sequence is cut into blocks, each block's logits are reduced to
(logsumexp, gold logit) per token, and each block runs under
``torch.utils.checkpoint`` so its logits are recomputed in the backward
(the reference's ``jax.checkpoint``).  Peak logits memory is
O(B * chunk * V) instead of O(B * S * V).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import linear


def _block_xent(h_blk, w_head, tgt_blk):
    """h_blk (B, T, D); w_head (D, V), a tensor or a codec view (the frozen
    head under quantized residency, whose product is the dequant-matmul
    kernel's on the card); tgt_blk (B, T), -1 = ignore.
    Returns (nll (B, T) fp32, mask (B, T) fp32).  The gold logit is a
    gather, which equals the reference's one-hot contraction exactly (every
    other term of that sum is an exact zero)."""
    logits = linear(h_blk, w_head).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, tgt_blk.clamp(min=0)[..., None])[..., 0]
    mask = (tgt_blk >= 0).float()
    return (logz - gold) * mask, mask


def _block_sums(w_head, h_blk, tgt_blk):
    nll, mask = _block_xent(h_blk, w_head, tgt_blk)
    return nll.sum(), mask.sum()


def chunked_next_token_xent(h, w_head, labels, chunk: Optional[int] = 512):
    """Next-token CE: position t predicts labels[:, t+1].

    h (B, S, D) final hidden states (after the final norm); labels (B, S).
    Targets are the labels shifted left with a -1 (ignore) pad, so S stays
    whole; a chunk that does not divide S falls to the largest divisor of S
    below it, as in the reference."""
    b, s, _ = h.shape
    tgt = torch.cat([labels[:, 1:],
                     torch.full((b, 1), -1, dtype=labels.dtype,
                                device=labels.device)], dim=1)
    if chunk and s % chunk != 0:
        chunk = next((c for c in range(min(chunk, s), 0, -1) if s % c == 0),
                     None)
    if not chunk or s <= chunk:
        nll, mask = _block_xent(h, w_head, tgt)
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(s // chunk):
        hb = h[:, i * chunk:(i + 1) * chunk]
        tb = tgt[:, i * chunk:(i + 1) * chunk]
        if torch.is_grad_enabled():
            nll, m = checkpoint(_block_sums, w_head, hb, tb,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            nll, m = _block_sums(w_head, hb, tb)
        tot = tot + nll
        cnt = cnt + m
    return tot / torch.clamp(cnt, min=1.0)
