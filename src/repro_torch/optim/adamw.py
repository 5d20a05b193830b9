"""AdamW (decoupled weight decay) — the paper's primary optimizer (port of
``repro.optim.adamw``)."""
from __future__ import annotations

from repro_torch.kernels import fused_update, ref
from repro_torch.optim.base import (Optimizer, bias_correction,
                                    clip_by_global_norm, leaves,
                                    moment_dtype_of, new_count, rebuild,
                                    zeros_like_tree)


def adamw(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, grad_clip: float = 0.0,
          use_fused: bool = False, moment_dtype=None) -> Optimizer:
    """AdamW with bias correction.  State = {m, v, count}.

    ``use_fused`` routes the update through the fused kernel
    (``kernels.fused_update.fused_adamw_update``: one pass over
    param + m + v per dtype bucket, in place on the card).  Unfused, the
    update is the same arithmetic as eager torch ops, leaf by leaf.
    ``moment_dtype`` is the resident dtype of m and v (float32 by
    default); the math is fp32 and re-rounds on store either way."""
    mdt = moment_dtype_of(moment_dtype)

    def init(params):
        return {"m": zeros_like_tree(params, mdt),
                "v": zeros_like_tree(params, mdt), "count": new_count()}

    def update(grads, state, params, lr):
        grads = clip_by_global_norm(grads, grad_clip)
        count = state["count"] + 1
        kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                  c1=bias_correction(b1, count), c2=bias_correction(b2, count))
        paths, (p, g, m, v) = leaves(params, grads, state["m"], state["v"])
        if use_fused:
            p, m, v = fused_update.fused_adamw_update(p, g, m, v, **kw)
        else:
            out = [ref.fused_adamw_ref(*a, **kw) for a in zip(p, g, m, v)]
            p, m, v = ([o[i] for o in out] for i in range(3))
        return rebuild(paths, p), {"m": rebuild(paths, m),
                                   "v": rebuild(paths, v), "count": count}

    return Optimizer("adamw", init, update,
                     state_bytes_per_param=2.0 * mdt.itemsize,
                     stream_safe=not grad_clip and not use_fused,
                     grad_clip=grad_clip)
