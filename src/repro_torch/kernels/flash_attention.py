"""Wrappers of the hand-written attention kernels (``csrc/flash_attention.cu``).

Port of ``repro.kernels.flash_attention`` (``flash_attention_pallas``,
``flash_decode_pallas``, ``paged_flash_decode_pallas``).  Each wrapper:

- on CPU tensors, returns its plain PyTorch version from ``kernels.ref``;
- on CUDA tensors, checks device, dtype, shape, alignment and contiguity,
  allocates the output with ``torch.empty``, launches the kernel on
  ``torch.cuda.current_stream()`` and raises if the launch is refused.
  It never falls back to the plain version;
- counts its kernel launches in its ``launches`` attribute (and nowhere
  else), one a call, so a run can show that it went through the kernel.
  The prefill has two kernels, both on the tensor cores: bf16 through
  ``wgmma``, counted in ``flash_attention.launches_tc`` as well, and fp32
  as three-pass TF32 ``mma.sync`` (fp32 accuracy; ``launches`` minus
  ``launches_tc``).  The decodes split each row's key window over blocks
  (``split_plan``); a call whose window needs more than one split also
  runs a combine kernel and counts in ``launches_split`` as well.
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
_SPLIT_KEYS = 32        # a split is whole ring tiles of the decode kernel
_MIN_SPLIT = 64         # and at least this many keys
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_SIGNATURES = {
    # q, k, v, starts, out, B, S, Sk, H, KV, hd, dtype, causal, prefix,
    # scale, stream
    "flash_attention_fwd": [_P] * 5 + [_I] * 9 + [_F, _P],
    # q, k, v, starts, lengths, out, part,
    # B, S, H, KV, hd, dtype, prefix, n_split, chunk, scale, stream
    "flash_decode_fwd": [_P] * 7 + [_I] * 9 + [_F, _P],
    # q, k_pool, v_pool, tables, starts, lengths, out, part,
    # B, H, KV, hd, block_size, max_blocks, dtype, n_split, chunk, scale, stream
    "paged_flash_decode_fwd": [_P] * 8 + [_I] * 9 + [_F, _P],
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


def _fit(name: str, q, k, v, kv_heads: int) -> None:
    """Shapes and devices every path needs: k and v alike and on q's
    device, and the kv heads dividing the query heads."""
    if k.shape != v.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} != v {tuple(v.shape)}")
    for what, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name}: {what} is on {t.device}, q on "
                             f"{q.device}")
    if kv_heads <= 0 or q.shape[-2] % kv_heads:
        raise ValueError(f"{name}: {q.shape[-2]} heads over {kv_heads} kv "
                         "heads")


def _check_kernel(name: str, q, k, v, hd: int) -> None:
    """What the CUDA kernels take: dtype and head dim."""
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported "
                         "(float32, bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v dtypes differ "
                         f"({q.dtype}, {k.dtype}, {v.dtype})")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not supported on CUDA "
                         f"({_HEAD_DIMS})")


def _check_prefix(name: str, prefix: int, s: int) -> int:
    prefix = int(prefix)
    if not 0 <= prefix <= s:
        raise ValueError(f"{name}: prefix {prefix} outside [0, {s}]")
    return prefix


def _check_index(name: str, t: Optional[torch.Tensor], b: int) -> None:
    if t is not None and tuple(t.shape) != (b,):
        raise ValueError(f"{name}: expected ({b},) indices, got "
                         f"{tuple(t.shape)}")


def _index(t: Optional[torch.Tensor], device):
    if t is None:
        return None
    return t.to(device=device, dtype=torch.int32).contiguous()


def split_plan(cap: int, blocks: int, sms: int) -> tuple[int, int]:
    """(n_split, chunk) of a decode: split c takes the keys of each row's
    window in [c * chunk, (c + 1) * chunk).  ``cap`` is the most keys a
    window can hold (the cache's S, or max_blocks x block_size), so the
    host needs no device read; ``blocks`` the blocks of one split (B x KV).
    The longest row is cut into enough pieces for two blocks an SM, each
    piece whole 32-key ring tiles and at least 64 keys."""
    want = max(1, -(-2 * sms // max(blocks, 1)))
    chunk = max(_MIN_SPLIT, -(-cap // want))
    chunk = -(-chunk // _SPLIT_KEYS) * _SPLIT_KEYS
    return max(1, -(-cap // chunk)), chunk


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _decode_launch(fn, fn_name: str, q, cap: int, kvh: int, ptrs: tuple,
                   ints: tuple) -> None:
    """Plans the splits, allocates the combine's scratch (fp32 acc, m and
    l of each split, head and row) and launches: the C entry takes
    ``ptrs`` (ending with out), the scratch, ``ints`` (ending with the
    dtype code, and the prefix for the contiguous cache), n_split, chunk
    and the scale."""
    b, h, hd = q.shape
    n_split, chunk = split_plan(cap, b * kvh, _sm_count(q.device.index or 0))
    part = None
    if n_split > 1:
        part = torch.empty(b * h * n_split * (hd + 2), dtype=torch.float32,
                           device=q.device)
    _launch(fn.__name__, fn_name, *ptrs, _ptr(part), *ints, n_split, chunk,
            1.0 / math.sqrt(hd))
    fn.launches += 1
    if n_split > 1:
        fn.launches_split += 1


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
                    causal: bool = True, prefix: int = 0) -> torch.Tensor:
    """Prefill attention.  q (B,S,H,hd); k/v (B,Sk,KV,hd) with KV | H;
    starts (B,) int left-pad counts or None; ``prefix``: the always-valid
    keys in front of the pad (a vlm's vision tokens).  Key j of row b is
    masked iff ``prefix <= j < prefix + starts[b]``.  ``causal=True``
    needs ``Sk == S``; a non-causal call attends over any ``Sk >= 1`` keys
    (an encoder-decoder's cross attention over its encoder's memory), with
    no ``starts`` or ``prefix`` where ``Sk != S``.  Returns (B,S,H,hd) in
    q's dtype."""
    plain = _plain("flash_attention", q)
    b, s, h, hd = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != hd or \
            k.shape[1] < 1:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not fit "
                         f"q {tuple(q.shape)}")
    sk, kvh = k.shape[1], k.shape[2]
    if sk != s:
        if causal:
            raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                             f"fit q {tuple(q.shape)}: causal attention "
                             "needs as many keys as queries")
        if starts is not None or prefix:
            raise ValueError("flash_attention: starts and prefix index the "
                             "queries' own keys; a call over another key "
                             f"length ({sk} keys for {s}) takes neither")
    _fit("flash_attention", q, k, v, kvh)
    _check_index("flash_attention", starts, b)
    prefix = _check_prefix("flash_attention", prefix, s)
    if plain:
        return ref.flash_attention_ref(q, k, v, starts, causal, prefix)
    _check_kernel("flash_attention", q, k, v, hd)
    starts = _index(starts, q.device)
    out = torch.empty_like(q)
    _check("flash_attention", {"q": q, "k": k, "v": v, "out": out},
           q.device)
    if q.numel() == 0:
        return out
    _launch("flash_attention", "flash_attention_fwd",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(starts),
            out.data_ptr(), b, s, sk, h, kvh, hd, _DTYPES[q.dtype],
            int(causal), prefix, 1.0 / math.sqrt(hd))
    flash_attention.launches += 1
    if q.dtype == torch.bfloat16:
        flash_attention.launches_tc += 1
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor,
                 starts: Optional[torch.Tensor] = None,
                 prefix: int = 0) -> torch.Tensor:
    """One query per row over a contiguous cache.  q (B,H,hd); k/v
    (B,S,KV,hd); keys at positions [0, prefix) and [prefix + starts[b],
    lengths[b]) attend (lengths above S are clipped to S on CUDA).
    Returns (B,H,hd)."""
    plain = _plain("flash_decode", q)
    b, h, hd = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"flash_decode: cache {tuple(k.shape)} does not "
                         f"fit q {tuple(q.shape)}")
    s, kvh = k.shape[1], k.shape[2]
    _fit("flash_decode", q, k, v, kvh)
    _check_index("flash_decode", lengths, b)
    _check_index("flash_decode", starts, b)
    prefix = _check_prefix("flash_decode", prefix, s)
    if plain:
        return ref.flash_decode_ref(q, k, v, lengths, starts, prefix)
    _check_kernel("flash_decode", q, k, v, hd)
    lengths, starts = _index(lengths, q.device), _index(starts, q.device)
    out = torch.empty_like(q)
    _check("flash_decode", {"q": q, "k": k, "v": v, "out": out}, q.device)
    if q.numel() == 0:
        return out
    _decode_launch(flash_decode, "flash_decode_fwd", q, s, kvh,
                   (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(starts),
                    lengths.data_ptr(), out.data_ptr()),
                   (b, s, h, kvh, hd, _DTYPES[q.dtype], prefix))
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
    plain = _plain("paged_flash_decode", q)
    b, h, hd = q.shape
    if k_pool.dim() != 4 or k_pool.shape[3] != hd:
        raise ValueError(f"paged_flash_decode: pool {tuple(k_pool.shape)} "
                         f"does not fit q {tuple(q.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError("paged_flash_decode: block_tables must be "
                         f"({b}, max_blocks), got {tuple(block_tables.shape)}")
    _, bs, kvh, _ = k_pool.shape
    _fit("paged_flash_decode", q, k_pool, v_pool, kvh)
    _check_index("paged_flash_decode", lengths, b)
    _check_index("paged_flash_decode", starts, b)
    if plain:
        return ref.paged_flash_decode_ref(q, k_pool, v_pool, block_tables,
                                          lengths, starts)
    _check_kernel("paged_flash_decode", q, k_pool, v_pool, hd)
    tables = _index(block_tables, q.device)
    lengths, starts = _index(lengths, q.device), _index(starts, q.device)
    out = torch.empty_like(q)
    _check("paged_flash_decode", {"q": q, "k_pool": k_pool, "v_pool": v_pool,
                                  "out": out}, q.device)
    if q.numel() == 0:
        return out
    max_blocks = tables.shape[1]
    _decode_launch(paged_flash_decode, "paged_flash_decode_fwd", q,
                   max_blocks * bs, kvh,
                   (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                    tables.data_ptr(), _ptr(starts), lengths.data_ptr(),
                    out.data_ptr()),
                   (b, h, kvh, hd, bs, max_blocks, _DTYPES[q.dtype]))
    return out


flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_decode.launches = 0
flash_decode.launches_split = 0
paged_flash_decode.launches = 0
paged_flash_decode.launches_split = 0
KERNELS = (flash_attention, flash_decode, paged_flash_decode)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0
    flash_attention.launches_tc = 0
    flash_decode.launches_split = paged_flash_decode.launches_split = 0
