"""Wrappers of the fused optimizer-update kernels (``csrc/fused_update.cu``).

Port of ``repro.kernels.ops.fused_{adamw,sgdm,adagrad}_update`` and the
Pallas kernels behind them (``fused_adamw_pallas``, ``fused_sgdm_pallas``,
``fused_adagrad_pallas``).  Each wrapper takes lists of leaves (params,
grads, moments — equal shapes, one list per stream) and:

- on CPU tensors, returns new leaves from its plain PyTorch version in
  ``kernels.ref``; the inputs are left untouched;
- on CUDA tensors, checks device, dtype, shape and contiguity, buckets the
  leaves by (param, grad, moment) dtype and launches the kernel once per
  bucket (and per 32 leaves) on ``torch.cuda.current_stream()``, updating
  params and moments IN PLACE; it returns the same tensors.  It raises if
  a launch is refused and never falls back to the plain version;
- counts its kernel launches in its ``launches`` attribute (and nowhere
  else), so a run can show that it went through the kernel.

``lr``, ``c1`` and ``c2`` are host floats (the step count stays on the
host), so an update reads nothing back from the device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_LEAVES = 32          # kMaxLeaves of the kernel's parameter table
_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_PN = ctypes.POINTER(ctypes.c_longlong)
_I = ctypes.c_int
_F = ctypes.c_float

_SIGNATURES = {
    # p[], g[], m[], v[], n[], count, dp, dg, ds,
    # lr, b1, 1-b1, b2, 1-b2, eps, wd, c1, c2, stream
    "fused_adamw": [_PP] * 4 + [_PN] + [_I] * 4 + [_F] * 9 + [_P],
    # p[], g[], mu[], n[], count, dp, dg, ds, lr, momentum, wd, stream
    "fused_sgdm": [_PP] * 3 + [_PN] + [_I] * 4 + [_F] * 3 + [_P],
    # p[], g[], accum[], n[], count, dp, dg, ds, lr, eps, wd, stream
    "fused_adagrad": [_PP] * 3 + [_PN] + [_I] * 4 + [_F] * 3 + [_P],
}


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    lib = build.load("fused_update")
    fn = getattr(lib, name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def _on_cpu(name: str, params: Sequence[torch.Tensor]) -> bool:
    """True when the leaves lie on the CPU (take the plain version); CUDA
    leaves go to the kernel; anything else raises."""
    devs = {t.device.type for t in params}
    if devs <= {"cpu"}:
        return True
    if devs != {"cuda"}:
        raise ValueError(f"{name}: no kernel for devices {sorted(devs)}")
    return False


def _check(name: str, streams: dict) -> None:
    """Every stream has one leaf per param, of the param's shape, on its
    device, contiguous and in a supported dtype."""
    params = streams["p"]
    for what, leaves in streams.items():
        if len(leaves) != len(params):
            raise ValueError(f"{name}: {len(leaves)} {what} leaves for "
                             f"{len(params)} params")
        for t, p in zip(leaves, params):
            if t.device != p.device:
                raise ValueError(f"{name}: a {what} leaf is on {t.device}, "
                                 f"its param on {p.device}")
            if t.shape != p.shape:
                raise ValueError(f"{name}: {what} {tuple(t.shape)} != param "
                                 f"{tuple(p.shape)}")
            if t.dtype not in _DTYPES:
                raise ValueError(f"{name}: dtype {t.dtype} not supported "
                                 "(float32, bfloat16)")
            if not t.is_contiguous():
                raise ValueError(f"{name}: {what} leaves must be contiguous")
    moments = list(streams.values())[2:]
    for other in moments[1:]:
        if any(a.dtype != b.dtype for a, b in zip(moments[0], other)):
            raise ValueError(f"{name}: the moments of a leaf differ in dtype")


def _buckets(streams: dict) -> list[tuple[tuple, list[int]]]:
    """Leaf indices grouped by (param, grad, moment) dtype codes, at most
    MAX_LEAVES per launch."""
    keys = {}
    moment = list(streams.values())[2]
    for i, (p, g, s) in enumerate(zip(streams["p"], streams["g"], moment)):
        key = (_DTYPES[p.dtype], _DTYPES[g.dtype], _DTYPES[s.dtype])
        keys.setdefault(key, []).append(i)
    return [(key, idxs[j:j + MAX_LEAVES])
            for key, idxs in sorted(keys.items())
            for j in range(0, len(idxs), MAX_LEAVES)]


def _launch(name: str, streams: dict, *scalars) -> int:
    """One kernel launch per bucket; returns the number of launches."""
    _check(name, streams)
    n_launch = 0
    stream = torch.cuda.current_stream().cuda_stream
    for (dp, dg, ds), idxs in _buckets(streams):
        ptrs = [(ctypes.c_void_p * len(idxs))(*[leaves[i].data_ptr()
                                                for i in idxs])
                for leaves in streams.values()]
        ns = (ctypes.c_longlong * len(idxs))(
            *[streams["p"][i].numel() for i in idxs])
        err = _fn(name)(*ptrs, ns, len(idxs), dp, dg, ds, *scalars, stream)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                               f"cudaError {err}")
        n_launch += 1
    return n_launch


def fused_adamw_update(params: Sequence[torch.Tensor],
                       grads: Sequence[torch.Tensor],
                       m: Sequence[torch.Tensor], v: Sequence[torch.Tensor], *,
                       lr: float, b1: float, b2: float, eps: float,
                       weight_decay: float, c1: float, c2: float):
    """Bias-corrected AdamW over lists of leaves; returns (params, m, v)."""
    if _on_cpu("fused_adamw_update", params):
        out = [ref.fused_adamw_ref(p, g, mm, vv, lr=lr, b1=b1, b2=b2,
                                   eps=eps, weight_decay=weight_decay,
                                   c1=c1, c2=c2)
               for p, g, mm, vv in zip(params, grads, m, v)]
        return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out]
    fused_adamw_update.launches += _launch(
        "fused_adamw", {"p": params, "g": grads, "m": m, "v": v},
        lr, b1, 1.0 - b1, b2, 1.0 - b2, eps, weight_decay, c1, c2)
    return list(params), list(m), list(v)


def fused_sgdm_update(params: Sequence[torch.Tensor],
                      grads: Sequence[torch.Tensor],
                      mu: Sequence[torch.Tensor], *, lr: float,
                      momentum: float, weight_decay: float):
    """Heavy-ball SGD over lists of leaves; returns (params, mu)."""
    if _on_cpu("fused_sgdm_update", params):
        out = [ref.fused_sgdm_ref(p, g, u, lr=lr, momentum=momentum,
                                  weight_decay=weight_decay)
               for p, g, u in zip(params, grads, mu)]
        return [o[0] for o in out], [o[1] for o in out]
    fused_sgdm_update.launches += _launch(
        "fused_sgdm", {"p": params, "g": grads, "mu": mu},
        lr, momentum, weight_decay)
    return list(params), list(mu)


def fused_adagrad_update(params: Sequence[torch.Tensor],
                         grads: Sequence[torch.Tensor],
                         accum: Sequence[torch.Tensor], *, lr: float,
                         eps: float, weight_decay: float):
    """AdaGrad over lists of leaves; returns (params, accum)."""
    if _on_cpu("fused_adagrad_update", params):
        out = [ref.fused_adagrad_ref(p, g, a, lr=lr, eps=eps,
                                     weight_decay=weight_decay)
               for p, g, a in zip(params, grads, accum)]
        return [o[0] for o in out], [o[1] for o in out]
    fused_adagrad_update.launches += _launch(
        "fused_adagrad", {"p": params, "g": grads, "accum": accum},
        lr, eps, weight_decay)
    return list(params), list(accum)


fused_adamw_update.launches = 0
fused_sgdm_update.launches = 0
fused_adagrad_update.launches = 0
KERNELS = (fused_adamw_update, fused_sgdm_update, fused_adagrad_update)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0
