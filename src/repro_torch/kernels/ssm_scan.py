"""Wrapper of the chunked SSM scan kernels (``csrc/ssm_scan.cu``,
``csrc/ssm_scan_wide.cu``).

Port of ``repro.kernels.ssm_scan.ssm_scan_pallas``: the gated linear scan
``h_t = exp(a_log_t) h_{t-1} + x_t (x) b_t``, ``y_t = h_t . c_t`` from a
zero state, which is the contract of ``repro.models.mamba2.
gated_chunked_scan`` (the Mamba2 SSD core).  :func:`ssm_scan`:

- on CPU tensors, returns the plain version ``kernels.ref.
  gated_chunked_scan_ref`` (the reference's chunked scan line for line,
  its bf16 roundings included), its state cast to fp32;
- on CUDA tensors, checks device, dtypes, shapes, alignment and
  contiguity, allocates the outputs with ``torch.empty`` and launches the
  kernel of the call's (P, N) on ``torch.cuda.current_stream()``, or
  raises.  It never falls back to the plain version.  (P, N) = (64, 64),
  Mamba2's heads, goes to ``csrc/ssm_scan.cu``; (1025, 1024), the mLSTM
  of xlstm-1.3b (its head dim and the normalizer's ones-channel), to the
  wide-state kernel of ``csrc/ssm_scan_wide.cu``, which keeps the state in
  fp32 slices of 32 rows (the normalizer row in a block of its own),
  streams b and c through a ring of shared-memory stages by cp.async,
  runs C h^T and the state update as TF32 products on the tensor cores
  (three passes in fp32, two in bf16) and takes its long sums in fp64
  (its decayed scores into a workspace this wrapper allocates); any other
  (P, N) raises.  The (64, 64) kernel runs its products on the tensor
  cores: fp32 as three TF32 products each (fp32 accuracy), bf16 as bf16
  products with fp32 sums, its fp32 operands (the decayed scores, the
  state, ``x exp(total - cum)``) each entering as a bf16 pair hi + lo; the
  chunk's cumulative decay is summed in fp64, the state is fp32, and y is
  rounded to x's dtype once.  It splits P across blocks and walks the
  sequence in 64-row chunks (the result does not depend on the chunk
  length beyond rounding), so ``chunk`` only sets the plain version's
  chunking.  An entering state ``h0`` has no kernel (no serving path
  passes one) and raises.  The kernel has no backward (nor has the
  Pallas kernel: the reference trains through its jnp scan), so under
  grad mode an input that requires grad raises too, rather than return a
  ``y`` that silently carries no gradient; training runs
  ``models.mamba2.gated_chunked_scan``;
- counts the (64, 64) kernel's launches in ``ssm_scan.launches`` (and
  nowhere else), the bf16 ones in ``ssm_scan.launches_bf16`` as well, and
  the wide kernel's in ``ssm_scan.launches_wide`` (its bf16 ones in
  ``ssm_scan.launches_wide_bf16`` as well).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WIDE = (1025, 1024)                    # (P, N) of ssm_scan_wide.cu
_SHAPES = ((64, 64), WIDE)            # (P, N) instances of the kernels
_LC_WIDE = 64                         # the wide kernel's chunk rows
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("ssm_scan").ssm_scan_fwd
    # x, a_log, b, c, y, h_final, B, S, H, P, N, dtype, stream
    fn.argtypes = [_P] * 6 + [_I] * 6 + [_P]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _wide_fn():
    fn = build.load("ssm_scan_wide").ssm_scan_wide_fwd
    # x, a_log, b, c, y, h_final, work, B, S, H, P, N, dtype, stream
    fn.argtypes = [_P] * 7 + [_I] * 6 + [_P]
    fn.restype = ctypes.c_int
    return fn


def wide_work_floats(bt: int, s: int, h: int) -> int:
    """Floats of the wide kernel's workspace: per (batch row, head, 64-row
    chunk) its decayed scores (64 x 64 fp32, rows padded to 68 so that
    each is 16-byte aligned) and decays (2 x 64 + 1 fp64)."""
    return bt * h * -(-s // _LC_WIDE) * (_LC_WIDE * (_LC_WIDE + 4)
                                         + 2 * (2 * _LC_WIDE + 1))


def _check(x, a_log, b, c) -> None:
    if x.dim() != 4:
        raise ValueError(f"ssm_scan: x must be (B,S,H,P), got {tuple(x.shape)}")
    bt, s, h, p = x.shape
    n = b.shape[-1]
    if a_log.shape != (bt, s, h):
        raise ValueError(f"ssm_scan: a_log {tuple(a_log.shape)} does not fit "
                         f"x {tuple(x.shape)}")
    if b.shape != (bt, s, n) or c.shape != (bt, s, n):
        raise ValueError(f"ssm_scan: b {tuple(b.shape)}, c {tuple(c.shape)} "
                         f"must be ({bt}, {s}, N)")
    if x.dtype not in _DTYPES:
        raise ValueError(f"ssm_scan: dtype {x.dtype} not supported "
                         "(float32, bfloat16)")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"ssm_scan: x, b, c dtypes differ ({x.dtype}, "
                         f"{b.dtype}, {c.dtype})")
    if (p, n) not in _SHAPES:
        raise ValueError(f"ssm_scan: (P, N) = {(p, n)} not supported on CUDA "
                         f"({_SHAPES})")


def ssm_scan(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, chunk: int = 128,
             h0: Optional[torch.Tensor] = None):
    """x (B,S,H,P) pre-scaled inputs; a_log (B,S,H) log decays (<= 0);
    b/c (B,S,N).  Returns (y (B,S,H,P) in x's dtype, h_final (B,H,P,N)
    fp32).  ``chunk`` sets only the CPU plain version's chunking; the
    kernel walks its own 64-row chunks."""
    if x.device.type == "cpu":
        y, h = ref.gated_chunked_scan_ref(x, a_log, b, c, chunk=chunk, h0=h0)
        return y, h.float()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, a_log, b, c)):
        raise RuntimeError(
            "ssm_scan: the CUDA kernel has no backward; an input requires "
            "grad under grad mode (train through models.mamba2."
            "gated_chunked_scan, or call this under torch.no_grad())")
    if h0 is not None:
        raise NotImplementedError("ssm_scan: an entering state h0 has no "
                                  "CUDA kernel")
    _check(x, a_log, b, c)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan: no kernel for device {x.device}")
    bt, s, h, p = x.shape
    n = b.shape[-1]
    a32 = a_log.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    for what, t in {"x": x, "a_log": a32, "b": b, "c": c, "y": y}.items():
        if t.device != x.device:
            raise ValueError(f"ssm_scan: {what} is on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan: {what} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"ssm_scan: {what} must be 16-byte aligned")
    if x.numel() == 0:                  # no kernel runs: the state stays 0
        return y, torch.zeros((bt, h, p, n), dtype=torch.float32,
                              device=x.device)
    hf = torch.empty((bt, h, p, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    bf16 = x.dtype == torch.bfloat16
    if (p, n) == WIDE:
        work = torch.empty(wide_work_floats(bt, s, h), dtype=torch.float32,
                           device=x.device)
        err = _wide_fn()(x.data_ptr(), a32.data_ptr(), b.data_ptr(),
                         c.data_ptr(), y.data_ptr(), hf.data_ptr(),
                         work.data_ptr(), bt, s, h, p, n, _DTYPES[x.dtype],
                         stream)
    else:
        err = _fn()(x.data_ptr(), a32.data_ptr(), b.data_ptr(), c.data_ptr(),
                    y.data_ptr(), hf.data_ptr(), bt, s, h, p, n,
                    _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan: CUDA kernel launch failed with "
                           f"cudaError {err}")
    if (p, n) == WIDE:
        ssm_scan.launches_wide += 1
        ssm_scan.launches_wide_bf16 += bf16
    else:
        ssm_scan.launches += 1
        ssm_scan.launches_bf16 += bf16
    return y, hf


def reset_launches() -> None:
    ssm_scan.launches = 0
    ssm_scan.launches_bf16 = 0
    ssm_scan.launches_wide = 0
    ssm_scan.launches_wide_bf16 = 0


reset_launches()
