"""Wrapper of the dequant-matmul kernel (``csrc/dequant_matmul.cu``).

Port of ``repro.kernels.ops.dequant_matmul`` and the Pallas kernel behind
it (``fused_dequant_matmul``): ``x (M, K) @ dequant(W)`` for a codec view
``W`` (``dist.quant.QuantView``, int8 or NF4, scale tile rows 1 or 8),
fp32 accumulation, the result in ``x.dtype``.  The decoded weight rounds
through the template dtype and through ``x.dtype``, as the reference's
``dequantize_leaf`` then the model's ``w.astype(x.dtype)`` do.

:func:`dequant_matmul` is differentiable in ``x`` only (the codes are
frozen and get no gradient):

- on CPU tensors its forward is the plain version
  (``kernels.ref.dequant_matmul_ref``);
- on CUDA tensors it checks device, dtypes, shapes and contiguity and
  launches the kernel on ``torch.cuda.current_stream()``, or raises; it
  never falls back to the plain version, and counts its launches in
  ``dequant_matmul.launches`` (and nowhere else); bf16 ``x`` runs on the
  tensor cores and is counted in ``dequant_matmul.launches_tc`` as well,
  fp32 ``x`` runs on the CUDA cores;
- its backward is ``dy @ dequant(W)^T``: the reference differentiates
  ``dequantize_leaf`` + ``dot`` with XLA outside any Pallas kernel, so
  here the one weight is decoded with ``dist.quant`` and multiplied by
  ``torch.matmul``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_FORMATS = {torch.int8: 0, torch.uint8: 1}
_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("dequant_matmul").dequant_matmul
    # x, q, s, out, m, k, n, ldq, lds, fmt, tile_rows, x_bf16, round_bf16,
    # stream
    fn.argtypes = [_P] * 4 + [_I] * 9 + [_P]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, w) -> None:
    k, n = w.shape
    if x.ndim != 2 or x.shape[1] != k:
        raise ValueError(f"dequant_matmul: x {tuple(x.shape)} does not "
                         f"contract with the weight {(k, n)}")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise ValueError(f"dequant_matmul: x {x.dtype}, template {w.dtype}: "
                         "float32 and bfloat16 only")
    if w.q.dtype not in _FORMATS or w.s.dtype != torch.float32:
        raise ValueError(f"dequant_matmul: codes {w.q.dtype}, scales "
                         f"{w.s.dtype} (int8 or uint8 codes, fp32 scales)")
    width = n if w.q.dtype == torch.int8 else -(-n // 2)
    grid = (-(-k // w.tile_rows), -(-n // 128))
    if tuple(w.q.shape) != (k, width) or tuple(w.s.shape) != grid:
        raise ValueError(f"dequant_matmul: codes {tuple(w.q.shape)} / scales "
                         f"{tuple(w.s.shape)} do not encode {(k, n)} with "
                         f"tile rows {w.tile_rows}")
    if w.tile_rows not in (1, 8):
        raise ValueError(f"dequant_matmul: tile rows {w.tile_rows}")
    for t in (x, w.q, w.s):
        if t.device != x.device:
            raise ValueError("dequant_matmul: x and the weight lie on "
                             f"{x.device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError("dequant_matmul: tensors must be contiguous")


def _launch(x: torch.Tensor, w) -> torch.Tensor:
    """One launch of the kernel; returns ``out``."""
    _check(x, w)
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    bf16 = torch.bfloat16
    err = _fn()(x.data_ptr(), w.q.data_ptr(), w.s.data_ptr(), out.data_ptr(),
                m, k, n, w.q.shape[1], w.s.shape[1], _FORMATS[w.q.dtype],
                w.tile_rows, int(x.dtype == bf16),
                int(bf16 in (x.dtype, w.dtype)),
                torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dequant_matmul: CUDA kernel launch failed with "
                           f"cudaError {err}")
    dequant_matmul.launches += 1
    if x.dtype == bf16:
        dequant_matmul.launches_tc += 1
    return out


def _forward(x: torch.Tensor, w) -> torch.Tensor:
    devs = {x.device.type, w.q.device.type}
    if devs == {"cpu"}:
        return ref.dequant_matmul_ref(x, w)
    if devs != {"cuda"}:
        raise ValueError(f"dequant_matmul: no kernel for devices "
                         f"{sorted(devs)}")
    return _launch(x.contiguous(), w)


class _DequantMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.w = w
        return _forward(x, w)

    @staticmethod
    def backward(ctx, dy):
        w = ctx.w.decode().to(dy.dtype)
        return dy @ w.T, None


def dequant_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x (M, K) @ dequant(w)`` -> ``(M, N)`` in ``x.dtype``."""
    return _DequantMatmul.apply(x, w)


dequant_matmul.launches = 0
dequant_matmul.launches_tc = 0
KERNELS = (dequant_matmul,)


def reset_launches() -> None:
    dequant_matmul.launches = 0
    dequant_matmul.launches_tc = 0
