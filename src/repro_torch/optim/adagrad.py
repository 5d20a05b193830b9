"""AdaGrad (Duchi et al., 2010) — port of ``repro.optim.adagrad``."""
from __future__ import annotations

from repro_torch.kernels import fused_update, ref
from repro_torch.optim.base import (Optimizer, clip_by_global_norm, leaves,
                                    moment_dtype_of, new_count, rebuild,
                                    zeros_like_tree)


def adagrad(eps: float = 1e-10, weight_decay: float = 0.0,
            grad_clip: float = 0.0, use_fused: bool = False,
            moment_dtype=None) -> Optimizer:
    """``use_fused`` routes the update through
    ``kernels.fused_update.fused_adagrad_update``; ``moment_dtype`` sets
    the resident accumulator dtype."""
    mdt = moment_dtype_of(moment_dtype)

    def init(params):
        return {"accum": zeros_like_tree(params, mdt), "count": new_count()}

    def update(grads, state, params, lr):
        grads = clip_by_global_norm(grads, grad_clip)
        kw = dict(lr=lr, eps=eps, weight_decay=weight_decay)
        paths, (p, g, a) = leaves(params, grads, state["accum"])
        if use_fused:
            p, a = fused_update.fused_adagrad_update(p, g, a, **kw)
        else:
            out = [ref.fused_adagrad_ref(*x, **kw) for x in zip(p, g, a)]
            p, a = [o[0] for o in out], [o[1] for o in out]
        return rebuild(paths, p), {"accum": rebuild(paths, a),
                                   "count": state["count"] + 1}

    return Optimizer("adagrad", init, update,
                     state_bytes_per_param=float(mdt.itemsize),
                     stream_safe=not grad_clip and not use_fused,
                     grad_clip=grad_clip)
