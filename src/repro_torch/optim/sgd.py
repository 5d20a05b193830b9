"""SGD and SGD with momentum (port of ``repro.optim.sgd``)."""
from __future__ import annotations

from repro_torch.kernels import fused_update, ref
from repro_torch.optim.base import (Optimizer, clip_by_global_norm, leaves,
                                    moment_dtype_of, new_count, rebuild,
                                    zeros_like_tree)


def sgd(weight_decay: float = 0.0, grad_clip: float = 0.0) -> Optimizer:
    """Plain SGD: no optimizer state but the step count."""

    def init(params):
        return {"count": new_count()}

    def update(grads, state, params, lr):
        grads = clip_by_global_norm(grads, grad_clip)
        paths, (p, g) = leaves(params, grads)
        new = []
        for pp, gg in zip(p, g):
            p32 = pp.float()
            step = lr * (gg.float() + weight_decay * p32)
            new.append((p32 - step).to(pp.dtype))
        return rebuild(paths, new), {"count": state["count"] + 1}

    return Optimizer("sgd", init, update, state_bytes_per_param=0.0,
                     stream_safe=not grad_clip,
                     grad_clip=grad_clip)


def sgdm(momentum: float = 0.9, weight_decay: float = 0.0,
         grad_clip: float = 0.0, use_fused: bool = False,
         moment_dtype=None) -> Optimizer:
    """SGD with heavy-ball momentum (one moment per param).  ``use_fused``
    routes the update through ``kernels.fused_update.fused_sgdm_update``;
    ``moment_dtype`` sets the resident momentum dtype."""
    mdt = moment_dtype_of(moment_dtype)

    def init(params):
        return {"mu": zeros_like_tree(params, mdt), "count": new_count()}

    def update(grads, state, params, lr):
        grads = clip_by_global_norm(grads, grad_clip)
        kw = dict(lr=lr, momentum=momentum, weight_decay=weight_decay)
        paths, (p, g, mu) = leaves(params, grads, state["mu"])
        if use_fused:
            p, mu = fused_update.fused_sgdm_update(p, g, mu, **kw)
        else:
            out = [ref.fused_sgdm_ref(*a, **kw) for a in zip(p, g, mu)]
            p, mu = [o[0] for o in out], [o[1] for o in out]
        return rebuild(paths, p), {"mu": rebuild(paths, mu),
                                   "count": state["count"] + 1}

    return Optimizer("sgdm", init, update,
                     state_bytes_per_param=float(mdt.itemsize),
                     stream_safe=not grad_clip and not use_fused,
                     grad_clip=grad_clip)
