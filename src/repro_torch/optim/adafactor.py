"""Adafactor (Shazeer & Stern, 2018) with factored second moments (port of
``repro.optim.adafactor``).

For an (r, c) matrix the second moment is stored as row and column vectors
(r + c floats instead of r*c), which is why the paper's #Sta column for
Adafactor is ~0.2 MB even for 7B models.  There is no fused kernel: the
reference has none either, so the update is plain torch on every device.
"""
from __future__ import annotations

import torch

from repro_torch.common.pytree import tree_map
from repro_torch.optim.base import (Optimizer, clip_by_global_norm, leaves,
                                    new_count, rebuild)


def _factored(shape) -> bool:
    return len(shape) >= 2


def beta2_at(count, decay_rate: float = 0.8) -> torch.Tensor:
    """Adafactor's step-dependent decay ``1 - t^-decay_rate`` for 1-based
    ``count``, in float32 on the host as the reference computes it."""
    t = torch.as_tensor(count).to(torch.float32)
    return 1.0 - t ** (-decay_rate)


def moment_init(p: torch.Tensor, stacked: bool = False) -> dict:
    """Second-moment slot for ONE param leaf, on its device: factored
    row/col vectors (``{"vr", "vc"}``) when the leaf is a matrix, a full
    ``{"v"}`` buffer otherwise.

    ``stacked=True`` makes the factoring decision on the per-layer shape
    (the leading dim a layer stack).  The optimizer path uses
    ``stacked=False``, as the reference's does, so a HiFT group's stacked
    slice ``(L, r, c)`` gets ``vr (L, r)`` and ``vc (L, c)``, and a stacked
    bias ``(L, d)`` is factored across its layers."""
    shape = p.shape[1:] if stacked else p.shape
    kw = dict(dtype=torch.float32, device=p.device)
    if _factored(shape):
        return {"vr": torch.zeros(p.shape[:-1], **kw),
                "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **kw)}
    return {"v": torch.zeros(p.shape, **kw)}


def leaf_update(p, g, mom, lr, beta2, *, eps1: float = 1e-30,
                clip_threshold: float = 1.0, weight_decay: float = 0.0,
                matrix_rms: bool = False, relative_step: bool = False,
                eps2: float = 1e-3):
    """One Adafactor update on one leaf -> ``(new_p, new_mom)``, in the
    reference's operation order (fp32 math, ``new_p`` in ``p``'s dtype).

    Dispatches on the moment structure (``vr``/``vc`` factored over the
    last two dims, ``v`` full).  ``matrix_rms=True`` takes the update-RMS
    clip per trailing matrix instead of over the whole leaf;
    ``relative_step=True`` scales the step by ``max(eps2, RMS(p))``."""
    beta2 = float(beta2)
    one_m = float(1.0 - torch.tensor(beta2, dtype=torch.float32))
    g32 = g.float()
    gsq = torch.square(g32) + eps1
    if "vr" in mom:
        vr = beta2 * mom["vr"] + one_m * gsq.mean(dim=-1)
        vc = beta2 * mom["vc"] + one_m * gsq.mean(dim=-2)
        denom = vr.mean(dim=-1, keepdim=True)
        # rank-1 approximation of the second moment: vr/denom (x) vc
        u = g32 / (torch.sqrt(vr / denom)[..., None]
                   * torch.sqrt(vc.unsqueeze(-2)))
        new_mom = {"vr": vr, "vc": vc}
        rms_axes = (-2, -1) if matrix_rms else None
    else:
        v = beta2 * mom["v"] + one_m * gsq
        u = g32 / torch.sqrt(v)
        new_mom = {"v": v}
        rms_axes = (-1,) if (matrix_rms and g.ndim >= 1) else None

    def mean_sq(x):
        sq = torch.square(x)
        return sq.mean() if rms_axes is None else sq.mean(dim=rms_axes,
                                                          keepdim=True)

    rms_u = torch.sqrt(mean_sq(u) + 1e-12)
    u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
    p32 = p.float()
    alpha = lr
    if relative_step:
        alpha = lr * torch.clamp(torch.sqrt(mean_sq(p32)), min=eps2)
    step = alpha * (u + weight_decay * p32)
    return (p32 - step).to(p.dtype), new_mom


def adafactor(eps1: float = 1e-30, eps2: float = 1e-3,
              clip_threshold: float = 1.0, weight_decay: float = 0.0,
              grad_clip: float = 0.0, decay_rate: float = 0.8,
              relative_step: bool = False) -> Optimizer:
    """State = ``{"moments": {leaf path: {"vr","vc"} | {"v"}}, "count"}``,
    the moments fp32 on the params' device, the count a CPU int64."""

    def init(params):
        return {"moments": tree_map(moment_init, params),
                "count": new_count()}

    def update(grads, state, params, lr):
        grads = clip_by_global_norm(grads, grad_clip)
        count = state["count"] + 1
        beta2 = beta2_at(count, decay_rate)
        paths, (p, g) = leaves(params, grads)
        moms = [_moment_at(state["moments"], path) for path in paths]
        out = [leaf_update(pp, gg, mm, lr, beta2, eps1=eps1,
                           clip_threshold=clip_threshold,
                           weight_decay=weight_decay,
                           relative_step=relative_step, eps2=eps2)
               for pp, gg, mm in zip(p, g, moms)]
        return (rebuild(paths, [o[0] for o in out]),
                {"moments": rebuild(paths, [o[1] for o in out]),
                 "count": count})

    return Optimizer("adafactor", init, update, state_bytes_per_param=0.01,
                     grad_clip=grad_clip)


def _moment_at(moments, path: str) -> dict:
    node = moments
    for part in path.split("/"):
        node = node[part]
    return node
