"""Wrappers of the hand-written attention kernels (``csrc/flash_attention.cu``).

Port of ``repro.kernels.flash_attention`` (``flash_attention_pallas``,
``flash_decode_pallas``, ``paged_flash_decode_pallas``).  Each wrapper:

- on CPU tensors, returns its plain PyTorch version from ``kernels.ref``;
- on CUDA tensors, checks device, dtype, shape, alignment and contiguity,
  allocates the output with ``torch.empty``, launches the kernel on
  ``torch.cuda.current_stream()`` and raises if the launch is refused.
  It never falls back to the plain version;
- counts its kernel launches in its ``launches`` attribute (and nowhere
  else), so a run can show that it went through the kernel.  The prefill
  has two kernels: bf16 runs on the tensor cores and is counted in
  ``flash_attention.launches_tc`` as well; fp32 runs on the CUDA cores.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 80, 128)
# the paged kernel keeps a row's block table in shared memory, beside its
# 16.6 KB of static shared memory, within the 48 KB a launch gets by default
_MAX_TABLE = 7680
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_SIGNATURES = {
    # q, k, v, starts, out, B, S, H, KV, hd, dtype, causal, scale, stream
    "flash_attention_fwd": [_P] * 5 + [_I] * 7 + [_F, _P],
    # q, k, v, starts, lengths, out, B, S, H, KV, hd, dtype, scale, stream
    "flash_decode_fwd": [_P] * 6 + [_I] * 6 + [_F, _P],
    # q, k_pool, v_pool, tables, starts, lengths, out,
    # B, H, KV, hd, block_size, max_blocks, dtype, scale, stream
    "paged_flash_decode_fwd": [_P] * 7 + [_I] * 7 + [_F, _P],
}


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    lib = build.load("flash_attention")
    fn = getattr(lib, name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def _plain(name: str, q: torch.Tensor) -> bool:
    """True for CPU tensors (take the plain version); CUDA tensors go to
    the kernel; anything else raises."""
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    return False


def _check(name: str, tensors: dict, device: torch.device) -> None:
    for what, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {what} is on {t.device}, q on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")


def _check_qkv(name: str, q, k, v, n_heads: int, kv_heads: int,
               hd: int) -> None:
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported "
                         "(float32, bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v dtypes differ "
                         f"({q.dtype}, {k.dtype}, {v.dtype})")
    if k.shape != v.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} != v {tuple(v.shape)}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not supported on CUDA "
                         f"({_HEAD_DIMS})")
    if kv_heads <= 0 or n_heads % kv_heads:
        raise ValueError(f"{name}: {n_heads} heads over {kv_heads} kv heads")


def _index(name: str, t: Optional[torch.Tensor], b: int, device):
    if t is None:
        return None
    if t.shape != (b,):
        raise ValueError(f"{name}: expected ({b},) indices, got "
                         f"{tuple(t.shape)}")
    return t.to(device=device, dtype=torch.int32).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(name: str, fn_name: str, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    err = _fn(fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {err}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    starts: Optional[torch.Tensor] = None,
                    causal: bool = True) -> torch.Tensor:
    """Prefill attention.  q (B,S,H,hd); k/v (B,S,KV,hd) with KV | H;
    starts (B,) int left-pad counts (keys before starts[b] are masked) or
    None.  Returns (B,S,H,hd) in q's dtype."""
    if _plain("flash_attention", q):
        return ref.flash_attention_ref(q, k, v, starts, causal)
    b, s, h, hd = q.shape
    if k.dim() != 4 or k.shape[:2] != (b, s) or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not fit "
                         f"q {tuple(q.shape)}")
    kvh = k.shape[2]
    _check_qkv("flash_attention", q, k, v, h, kvh, hd)
    starts = _index("flash_attention", starts, b, q.device)
    out = torch.empty_like(q)
    _check("flash_attention", {"q": q, "k": k, "v": v, "out": out},
           q.device)
    if q.numel() == 0:
        return out
    _launch("flash_attention", "flash_attention_fwd",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(starts),
            out.data_ptr(), b, s, h, kvh, hd, _DTYPES[q.dtype], int(causal),
            1.0 / math.sqrt(hd))
    flash_attention.launches += 1
    if q.dtype == torch.bfloat16:
        flash_attention.launches_tc += 1
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor,
                 starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One query per row over a contiguous cache.  q (B,H,hd); k/v
    (B,S,KV,hd); keys at positions [starts[b], lengths[b]) attend (lengths
    above S are clipped to S on CUDA).  Returns (B,H,hd)."""
    if _plain("flash_decode", q):
        return ref.flash_decode_ref(q, k, v, lengths, starts)
    b, h, hd = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"flash_decode: cache {tuple(k.shape)} does not "
                         f"fit q {tuple(q.shape)}")
    s, kvh = k.shape[1], k.shape[2]
    _check_qkv("flash_decode", q, k, v, h, kvh, hd)
    lengths = _index("flash_decode", lengths, b, q.device)
    starts = _index("flash_decode", starts, b, q.device)
    out = torch.empty_like(q)
    _check("flash_decode", {"q": q, "k": k, "v": v, "out": out}, q.device)
    if q.numel() == 0:
        return out
    _launch("flash_decode", "flash_decode_fwd",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(starts),
            lengths.data_ptr(), out.data_ptr(), b, s, h, kvh, hd,
            _DTYPES[q.dtype], 1.0 / math.sqrt(hd))
    flash_decode.launches += 1
    return out


def paged_flash_decode(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor,
                       starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One query per row over a paged cache.  q (B,H,hd); pools
    (n_blocks, block_size, KV, hd); block_tables (B, max_blocks) int
    logical -> physical page map (unused entries must still name a real
    page); keys at logical positions [starts[b], lengths[b]) attend.
    Returns (B,H,hd)."""
    if _plain("paged_flash_decode", q):
        return ref.paged_flash_decode_ref(q, k_pool, v_pool, block_tables,
                                          lengths, starts)
    b, h, hd = q.shape
    if k_pool.dim() != 4 or k_pool.shape[3] != hd:
        raise ValueError(f"paged_flash_decode: pool {tuple(k_pool.shape)} "
                         f"does not fit q {tuple(q.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError("paged_flash_decode: block_tables must be "
                         f"({b}, max_blocks), got {tuple(block_tables.shape)}")
    _, bs, kvh, _ = k_pool.shape
    _check_qkv("paged_flash_decode", q, k_pool, v_pool, h, kvh, hd)
    if block_tables.shape[1] > _MAX_TABLE:
        raise ValueError(f"paged_flash_decode: {block_tables.shape[1]} pages "
                         f"per row exceed the kernel's {_MAX_TABLE}")
    tables = block_tables.to(device=q.device, dtype=torch.int32).contiguous()
    lengths = _index("paged_flash_decode", lengths, b, q.device)
    starts = _index("paged_flash_decode", starts, b, q.device)
    out = torch.empty_like(q)
    _check("paged_flash_decode", {"q": q, "k_pool": k_pool, "v_pool": v_pool,
                                  "out": out}, q.device)
    if q.numel() == 0:
        return out
    _launch("paged_flash_decode", "paged_flash_decode_fwd",
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), _ptr(starts), lengths.data_ptr(),
            out.data_ptr(), b, h, kvh, hd, bs, tables.shape[1],
            _DTYPES[q.dtype], 1.0 / math.sqrt(hd))
    paged_flash_decode.launches += 1
    return out


flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_decode.launches = 0
paged_flash_decode.launches = 0
KERNELS = (flash_attention, flash_decode, paged_flash_decode)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0
    flash_attention.launches_tc = 0
