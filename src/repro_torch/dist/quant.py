"""Blockwise int8 / NF4 codecs for resident parameter trees (port of
``repro.dist.quant``).

A quantized leaf is the same record as in the reference, the dict
``{"q": codes, "s": scales, "t": template}``:

- ``q`` — int8 codes (leaf shape) or NF4 codes packed 2-per-uint8 along
  the last dim (``shape[:-1] + (ceil(c/2),)``); ``q.dtype`` names the
  format;
- ``s`` — fp32 scales, one per (8, 128) tile of the trailing two dims for
  ndim >= 3 leaves, one per (1, 128) row-block for 2-d leaves, so every
  record slices on dim 0 with the indices of the leaf it encodes;
- ``t`` — a zero-size ``(shape[0], 0, shape[-1])`` template carrying the
  original dtype and the true last-dim width.

Only floating leaves with ndim >= 2 are encoded.  Encoding is the
reference's arithmetic op for op (fp32 absmax, true divisions by 0-d
tensors, round half to even, NF4 midpoints compared in fp32), so codes and
scales equal the reference's bit for bit on the CPU and on the card.

The port adds a *view* (:class:`QuantView`): one matrix of a record —
codes, scales, the tile rows of the leaf it came from and its true shape
and dtype.  Layer ``i`` of a stacked ``(L, K, N)`` record has a 2-d
``q[i]`` but per-(8, 128) tile scales, which the record alone cannot say
once sliced; the view carries it.  The forward hands views to
``kernels.dequant_matmul`` and decodes nothing else beyond the layer in
hand.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.common.pytree import flatten_with_paths, is_record, tree_map

PyTree = Any

QUANT_FORMATS = ("int8", "nf4")

# QLoRA's NF4 codebook (the reference's exact float32 values)
NF4_CODEBOOK = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.3344709873199463, 0.42563003301620483, 0.5626170039176941,
    0.7229568362236023, 1.0,
)
# decision boundaries: float64 midpoints, compared in fp32 as JAX does
_NF4_MIDPOINTS = tuple(
    (NF4_CODEBOOK[i] + NF4_CODEBOOK[i + 1]) / 2 for i in range(15))

_LANE = 128        # lane tile (last dim)
_SUBLANE = 8       # sublane tile (second-to-last dim) for ndim >= 3
_TINY = 1e-30      # scale floor: all-zero tiles must not divide by zero
_CHUNK = 1 << 26   # elements encoded at a time (bounds the temporaries)


def _tile_rows(ndim: int) -> int:
    return _SUBLANE if ndim >= 3 else 1


def quantizable(x) -> bool:
    """True if the codec applies to this leaf (a floating tensor, ndim >=
    2)."""
    return (isinstance(x, torch.Tensor) and x.ndim >= 2
            and x.is_floating_point())


is_quantized = is_record       # the tree ``is_leaf`` for codec records


def quant_format(leaf) -> str:
    return "int8" if leaf["q"].dtype == torch.int8 else "nf4"


def quant_shape(leaf) -> tuple[int, ...]:
    """Original (decoded) shape of a record."""
    q, t = leaf["q"], leaf["t"]
    if q.dtype == torch.int8:
        return tuple(q.shape)
    return tuple(q.shape[:-1]) + (t.shape[-1],)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d fp32 tensor on ``like``'s device: a division by it is a true
    elementwise division on the card too (a Python-float divisor may become
    a multiply by its reciprocal there)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _tile_absmax(x32: torch.Tensor, tile_r: int) -> torch.Tensor:
    """Per-tile absolute max over (tile_r, 128) tiles of the last 2 dims."""
    *lead, r, c = x32.shape
    rp, cp = -r % tile_r, -c % _LANE
    xp = F.pad(x32, (0, cp, 0, rp))
    grid = xp.reshape(*lead, (r + rp) // tile_r, tile_r, (c + cp) // _LANE,
                      _LANE)
    return grid.abs().amax(dim=(-3, -1))


def expand_scales(s: torch.Tensor, shape, tile_r: int) -> torch.Tensor:
    """Broadcast a per-tile scale grid back over ``shape`` (crop-exact)."""
    r, c = shape[-2], shape[-1]
    lead = tuple(s.shape[:-2])
    e = s[..., :, None, :, None].expand(
        *lead, s.shape[-2], tile_r, s.shape[-1], _LANE)
    e = e.reshape(*lead, s.shape[-2] * tile_r, s.shape[-1] * _LANE)
    return e[..., :r, :c]


def _nf4_encode(y: torch.Tensor) -> torch.Tensor:
    """Nearest-codebook index: the number of midpoints at or below y."""
    idx = torch.zeros(y.shape, dtype=torch.uint8, device=y.device)
    for m in _NF4_MIDPOINTS:
        idx += (y >= _scalar(m, y)).to(torch.uint8)
    return idx


def nf4_decode(idx: torch.Tensor) -> torch.Tensor:
    """Codebook values (fp32) of nibble indices."""
    book = torch.tensor(NF4_CODEBOOK, dtype=torch.float32, device=idx.device)
    return book[idx.long()]


def _pack_nf4(idx: torch.Tensor) -> torch.Tensor:
    """Pack nibbles 2-per-byte along the last dim (pad code 7 = 0.0)."""
    if idx.shape[-1] % 2:
        idx = F.pad(idx, (0, 1), value=7)
    return idx[..., 0::2] | (idx[..., 1::2] << 4)


def unpack_nf4(q: torch.Tensor, c: int) -> torch.Tensor:
    """Inverse of ``_pack_nf4``, cropped to the true width ``c``."""
    inter = torch.stack([q & 0xF, (q >> 4) & 0xF], dim=-1)
    return inter.reshape(*q.shape[:-1], 2 * q.shape[-1])[..., :c]


def _encode(x: torch.Tensor, fmt: str, tile_r: int):
    x32 = x.float()
    absmax = torch.maximum(_tile_absmax(x32, tile_r), _scalar(_TINY, x32))
    if fmt == "int8":
        scale = absmax / _scalar(127.0, x32)
        y = x32 / expand_scales(scale, x.shape, tile_r)
        q = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    else:
        scale = absmax
        y = x32 / expand_scales(scale, x.shape, tile_r)
        q = _pack_nf4(_nf4_encode(y))
    return q, scale


def quantize_leaf(x: torch.Tensor, fmt: str) -> dict:
    """Encode one eligible leaf to ``{"q", "s", "t"}`` on its device.

    Rows of dim 0 are encoded a chunk at a time: no tile spans two of
    them, so the result is the whole leaf's, with bounded temporaries."""
    if fmt not in QUANT_FORMATS:
        raise ValueError(f"unknown quant format {fmt!r}; "
                         f"expected one of {QUANT_FORMATS}")
    tile_r = _tile_rows(x.ndim)
    step = max(1, _CHUNK // max(math.prod(x.shape[1:]), 1))
    parts = [_encode(x[lo:lo + step], fmt, tile_r)
             for lo in range(0, x.shape[0], step)]
    q = torch.cat([p[0] for p in parts]) if len(parts) > 1 else parts[0][0]
    s = torch.cat([p[1] for p in parts]) if len(parts) > 1 else parts[0][1]
    t = torch.zeros((x.shape[0], 0, x.shape[-1]), dtype=x.dtype,
                    device=x.device)
    return {"q": q, "s": s, "t": t}


def _decode(q: torch.Tensor, s: torch.Tensor, shape, tile_r: int,
            dtype: torch.dtype) -> torch.Tensor:
    se = expand_scales(s, shape, tile_r)
    if q.dtype == torch.int8:
        w = q.float() * se
    else:
        w = nf4_decode(unpack_nf4(q, shape[-1])) * se
    return w.to(dtype)


def dequantize_leaf(leaf) -> torch.Tensor:
    """Reconstruct a leaf in its original shape and dtype."""
    shape = quant_shape(leaf)
    return _decode(leaf["q"], leaf["s"], shape, _tile_rows(len(shape)),
                   leaf["t"].dtype)


def quantize_tree(tree: PyTree, fmt: str) -> PyTree:
    """Encode every eligible leaf; other leaves (and records) pass
    through."""
    return tree_map(lambda x: quantize_leaf(x, fmt) if quantizable(x) else x,
                    tree, is_leaf=is_quantized)


def dequantize_tree(tree: PyTree) -> PyTree:
    """Inverse of :func:`quantize_tree` (identity on plain leaves)."""
    return tree_map(lambda x: dequantize_leaf(x) if is_quantized(x) else x,
                    tree, is_leaf=is_quantized)


# ------------------------------------------------------------------ views

@dataclasses.dataclass(frozen=True)
class QuantView:
    """One 2-d matrix of a codec record: ``q`` (K, N) int8 or (K,
    ceil(N/2)) packed NF4, ``s`` its scale grid, ``tile_rows`` (8 for a
    layer of a stacked ndim >= 3 leaf, 1 for a 2-d leaf), the true
    ``shape`` (K, N) and the template ``dtype``.  A layer of a 4-d stack
    (the moe family's experts) is a view of shape (E, K, N) with leading
    dims on ``q`` and ``s``: only ``decode`` takes it."""
    q: torch.Tensor
    s: torch.Tensor
    tile_rows: int
    shape: tuple
    dtype: torch.dtype

    @property
    def fmt(self) -> str:
        return "int8" if self.q.dtype == torch.int8 else "nf4"

    @property
    def device(self) -> torch.device:
        return self.q.device

    def decode(self) -> torch.Tensor:
        """The decoded matrix in the template dtype, as the reference's
        ``dequantize_leaf`` gives it."""
        return _decode(self.q, self.s, self.shape, self.tile_rows,
                       self.dtype)


def view_of(leaf) -> QuantView:
    """The view of a whole 2-d record (a head or embedding table)."""
    shape = quant_shape(leaf)
    if len(shape) != 2:
        raise ValueError(f"view_of takes a 2-d record, got shape {shape}")
    return QuantView(leaf["q"], leaf["s"], 1, shape, leaf["t"].dtype)


def layer_of(leaf, i: int):
    """Layer ``i`` of a stacked record: the :class:`QuantView` of its
    matrix for an ``(L, K, N)`` leaf (and of its ``(E, d, ff)`` stack for
    a deeper leaf, the moe family's experts, which decode it at use: the
    (8, 128) scale tiles lie on the trailing two dims), the decoded row
    (template dtype) for a 2-d ``(L, d)`` stack (norm scales and biases,
    used elementwise)."""
    shape = quant_shape(leaf)
    if len(shape) == 2:
        row = QuantView(leaf["q"][i:i + 1], leaf["s"][i:i + 1], 1,
                        (1, shape[1]), leaf["t"].dtype)
        return row.decode()[0]
    return QuantView(leaf["q"][i], leaf["s"][i], _SUBLANE, shape[1:],
                     leaf["t"].dtype)


def gather_rows(leaf, idx: torch.Tensor) -> torch.Tensor:
    """``dequantize_leaf(leaf)[idx]`` for a 2-d record (an embedding
    lookup), decoding only the gathered rows."""
    shape = quant_shape(leaf)
    flat = idx.reshape(-1)
    rows = QuantView(leaf["q"][flat], leaf["s"][flat], 1,
                     (flat.numel(), shape[1]), leaf["t"].dtype)
    return rows.decode().reshape(*idx.shape, shape[1])


# ------------------------------------------------------------- accounting

def quant_leaf_bytes(shape: tuple[int, ...], itemsize: int, fmt: str,
                     floating: bool = True) -> int:
    """Resident bytes of one leaf after quantization (shape math only)."""
    n = math.prod(shape) if shape else 1
    if not floating or len(shape) < 2:
        return n * itemsize
    r, c = shape[-2], shape[-1]
    lead = math.prod(shape[:-2]) if len(shape) > 2 else 1
    tile_r = _tile_rows(len(shape))
    scales = lead * math.ceil(r / tile_r) * math.ceil(c / _LANE) * 4
    if fmt == "int8":
        codes = n
    elif fmt == "nf4":
        codes = lead * r * math.ceil(c / 2)
    else:
        raise ValueError(f"unknown quant format {fmt!r}; "
                         f"expected one of {QUANT_FORMATS}")
    return codes + scales


def tree_logical_size(tree: PyTree) -> int:
    """Element count of the original tree (a record counts as the leaf it
    encodes)."""
    sizes = []
    tree_map(lambda x: sizes.append(math.prod(quant_shape(x))
                                    if is_quantized(x) else x.numel()),
             tree, is_leaf=is_quantized)
    return sum(sizes)


def quant_bytes(tree: PyTree) -> int:
    """Resident bytes of a (possibly partly) quantized tree."""
    return sum(t.numel() * t.element_size()
               for t in flatten_with_paths(tree).values())
