"""Analytical accelerator-memory accounting — paper Appendix B and Tables
8-12 (port of ``repro.core.memory_model``).

zeta_1 = bytes of weight parameters, zeta_2 = optimizer state, zeta_3 =
gradients.  FPFT(AdamW, fp32) = 4*zeta_1; HiFT = zeta_1 + 3*zeta_1/k
(only the active group's grads + moments are resident).

Operates on SHAPE trees, so a full-size config is analyzed without
allocating anything: :func:`param_shapes` builds one on the ``meta``
device (any torch tensors will do).  Reproduces the paper's
#Para/#Gra/#Sta/#PGS columns for any (model, optimizer, precision, m);
``chip_smoke.py`` prints these figures beside the peaks it measures.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import torch

from repro_torch.common.pytree import flatten_with_paths
from repro_torch.core.grouping import Group, make_groups
from repro_torch.dist.quant import QUANT_FORMATS, quant_leaf_bytes
from repro_torch.models.base import Unit

# optimizers whose moment trees take QuantConfig's ``moment_dtype``
# narrowing (the same set core.registry.FUSED_OPTIMIZERS names)
_MOMENT_OPTIMIZERS = ("adamw", "sgdm", "adagrad")

PyTree = Any

_STATE_MULT = {  # optimizer state floats per fp32 param
    "adamw": 2.0,
    "sgdm": 1.0,
    "sgd": 0.0,
    "adagrad": 1.0,
    "adafactor": 0.0,   # sub-linear; computed exactly below
}


def _size(leaf) -> int:
    return int(math.prod(leaf.shape)) if len(leaf.shape) else 1


def param_shapes(cfg) -> PyTree:
    """The family's param tree of ``cfg`` on the ``meta`` device: shapes
    and dtypes, no storage."""
    from repro_torch.models import get_family
    return get_family(cfg).init(cfg, torch.Generator(), device="meta")


@dataclasses.dataclass(frozen=True)
class MemoryReport:
    n_params: int
    peak_trainable: int
    para_mb: float          # resident weights (#Para)
    grad_mb: float          # gradients (#Gra)
    state_mb: float         # optimizer states (#Sta)
    pgs_gb: float           # #PGS = para + grad + state (+ EF residuals)
    ef_mb: float = 0.0      # cross-pod EF residuals (0 unless ef_pods >= 2)

    def as_row(self) -> str:
        return (f"{self.n_params/1e6:9.2f}M {self.peak_trainable/1e6:9.2f}M "
                f"{self.para_mb:10.2f} {self.grad_mb:10.2f} {self.state_mb:10.2f} "
                f"{self.pgs_gb:8.2f}")


class _Accountant:
    """Maps HiFT groups to param counts from a flat {path: leaf} shape
    dict."""

    def __init__(self, shapes: PyTree, units: Sequence[Unit]):
        self.flat = flatten_with_paths(shapes)
        self.units = list(units)
        # stacked segment lengths
        self.stack_len: dict[str, int] = {}
        for u in units:
            if u.kind == "stacked":
                self.stack_len[u.key] = max(self.stack_len.get(u.key, 0),
                                            u.index + 1)

    def key_size(self, key: str) -> int:
        return sum(_size(l) for p, l in self.flat.items()
                   if p == key or p.startswith(key + "/"))

    def group_params(self, g: Group) -> int:
        total = sum(self.key_size(k) for k in g.dense_keys)
        for key, lo, hi in g.stacked_ranges:
            total += self.key_size(key) * (hi - lo) // self.stack_len[key]
        return total

    def group_adafactor_bytes(self, g: Group) -> int:
        stacked = {k: (lo, hi) for k, lo, hi in g.stacked_ranges}
        total = 0
        for p, l in self.flat.items():
            top = p.split("/")[0]
            n_layers = 1
            if top in stacked:
                lo, hi = stacked[top]
                n_layers = hi - lo
                shape = tuple(l.shape[1:])
            elif top in g.dense_keys:
                shape = tuple(l.shape)
            else:
                continue
            if len(shape) >= 2:
                total += (shape[-2] + shape[-1]) * 4 * n_layers
            else:
                total += int(math.prod(shape or (1,))) * 4 * n_layers
        return total

    def total(self) -> int:
        return sum(_size(l) for l in self.flat.values())

    def quant_resident_bytes(self, fmt: str, itemsize: int) -> int:
        """Resident bytes of the whole tree codec-encoded: per-leaf
        ``dist.quant.quant_leaf_bytes`` (codes + per-tile scales for
        quantizable leaves; ``itemsize`` bytes/element for the scalars and
        1-d leaves that pass through at the resident precision)."""
        return sum(quant_leaf_bytes(tuple(l.shape), itemsize, fmt,
                                    floating=l.dtype.is_floating_point)
                   for l in self.flat.values())

    def whole(self) -> Group:
        """Every unit as one group (FPFT's and AdaLomo's state)."""
        return Group(0, tuple(self.units),
                     tuple(u.key for u in self.units if u.kind == "dense"),
                     tuple((key, 0, ln) for key, ln in self.stack_len.items()))


def analyze(shapes: PyTree, units: Sequence[Unit], *, optimizer: str = "adamw",
            precision: str = "fp32", mode: str = "hift", m: int = 1,
            ef_pods: int = 0, stream_depth: int = 2,
            stream_chunk_bytes: int = 1 << 20,
            frozen_quant: Optional[str] = None,
            moment_dtype: str = "fp32") -> MemoryReport:
    """shapes: a params tree or :func:`param_shapes`.
    precision: fp32 | mixed | mixed_hi.
    mode: fpft | fpft_streamed | hift | hift_pipelined | mezo | lomo |
    adalomo.
    frozen_quant: None | "int8" | "nf4" — price the resident weight tree
    codec-encoded (``dist.quant``: codes + per-tile fp32 scales); the
    active update path still needs a full-precision master, so the fp32
    ``master`` term (bundle-resident) is always added;
    ``precision="mixed"`` (a resident fp32 master per param) contradicts
    quantized residency and is rejected.
    moment_dtype: "fp32" | "bf16" — resident bytes per optimizer moment
    element; only the moment-carrying optimizers (adamw/sgdm/adagrad)
    accept "bf16".
    ef_pods >= 2: price the compressed cross-pod reduce's error-feedback
    residual tree, one fp32 copy of the gradient tree that crosses the
    wire per pod (fpft modes: the full tree; hift modes: the active group,
    ``stream_depth`` of them when pipelined).
    stream_depth / stream_chunk_bytes: ``fpft_streamed`` holds
    ``stream_depth`` chunks of ``stream_chunk_bytes`` per streamed state
    tree; ``hift_pipelined`` holds ``stream_depth`` bundles on the device.

    Per mode:
      - fpft: everything trainable, full grad tree, full optimizer state.
      - fpft_streamed: everything trainable and the full grad tree, but
        the optimizer state is host-resident and only the bounded window
        of it (and of the Mixed^Hi masters) is on the device.
      - hift: one group of m units trainable; grads + state for it only.
      - hift_pipelined: as hift, with up to ``stream_depth`` bundles (and
        the masters riding them) on the device; gradients stay one group.
      - mezo: everything trainable, no gradients, no optimizer state.
      - lomo: everything trainable, no optimizer state, gradients bounded
        by one fused grain of ``m`` units.
      - adalomo: lomo's gradients, plus Adafactor-style factored second
        moments for the whole model (r+c fp32 stats per (r, c) matrix, per
        layer for stacked segments), whatever ``optimizer`` says."""
    acc = _Accountant(shapes, units)
    n = acc.total()
    groups = make_groups(acc.units, m)
    hift_modes = ("hift", "hift_pipelined")
    fused_modes = ("lomo", "adalomo")

    if moment_dtype in ("fp32", "float32"):
        mbytes = 4
    elif moment_dtype in ("bf16", "bfloat16"):
        if optimizer not in _MOMENT_OPTIMIZERS:
            raise ValueError(
                "moment_dtype='bf16' applies to the moment-carrying "
                f"optimizers {_MOMENT_OPTIMIZERS}, not {optimizer!r}")
        mbytes = 2
    else:
        raise ValueError(f"moment_dtype must be fp32 or bf16, "
                         f"got {moment_dtype!r}")
    if frozen_quant is not None:
        if frozen_quant not in QUANT_FORMATS:
            raise ValueError(f"frozen_quant must be one of {QUANT_FORMATS} "
                             f"or None, got {frozen_quant!r}")
        if precision == "mixed":
            raise ValueError(
                "frozen_quant with precision='mixed' contradicts itself: "
                "mixed keeps a resident fp32 master per param; use fp32 or "
                "mixed_hi")
        if precision not in ("fp32", "mixed_hi"):
            raise ValueError(precision)

    if mode in ("fpft", "fpft_streamed"):
        peak, gsize = n, n
    elif mode in hift_modes:
        peak = max(acc.group_params(g) for g in groups)
        gsize = peak
    elif mode == "mezo":
        peak, gsize = n, 0
    elif mode in fused_modes:
        peak = n
        gsize = max(acc.group_params(g) for g in groups)
    else:
        raise ValueError(mode)
    if stream_depth < 1 or stream_chunk_bytes <= 0:
        raise ValueError(f"stream window must be positive, got "
                         f"depth={stream_depth} x {stream_chunk_bytes} bytes")
    # device-resident optimizer bundles: the pipelined schedule holds the
    # active group's plus up to depth-1 in flight; serial holds one
    resident_bundles = min(stream_depth, len(groups)) \
        if mode == "hift_pipelined" else 1
    # the streamed window, in fp32-equivalent param elements
    window_elems = stream_depth * stream_chunk_bytes // 4
    # fp32 master copies under Mixed^Hi ride in the bundles: whatever is
    # being updated at one instant x resident bundles
    if mode in ("mezo",) + fused_modes:
        master = gsize
    elif mode == "fpft_streamed":
        master = min(n, window_elems)
    else:
        master = peak * resident_bundles

    # --- weights resident (#Para) ---
    if frozen_quant is not None:
        # codec-encoded resident tree + the active fp32 master that rides
        # the optimizer bundle (the update path never reads codes)
        itemsize = 2 if precision == "mixed_hi" else 4
        para = acc.quant_resident_bytes(frozen_quant, itemsize) + 4 * master
    elif precision == "fp32":
        para = 4 * n
    elif precision == "mixed":
        para = 4 * n + 2 * n            # fp32 master + bf16 compute copy
    elif precision == "mixed_hi":
        para = 2 * n + 4 * master       # bf16 resident + fp32 master of active
    else:
        raise ValueError(precision)

    grad = 4 * gsize                     # fp32 grads live at peak

    if mode in ("mezo", "lomo"):
        state = 0                        # no optimizer state by construction
    elif mode == "adalomo":
        state = acc.group_adafactor_bytes(acc.whole())
    elif optimizer == "adafactor":
        if mode in ("fpft", "fpft_streamed"):
            # the full (sub-linear) state: fpft_streamed rejects adafactor
            # at construction, and this keeps the report conservative
            state = acc.group_adafactor_bytes(acc.whole())
        else:
            state = max(acc.group_adafactor_bytes(g)
                        for g in groups) * resident_bundles
    elif mode == "fpft_streamed":
        # host-resident moments: the device holds the bounded window
        full = int(_STATE_MULT[optimizer] * mbytes * n)
        window = int(_STATE_MULT[optimizer] * mbytes * window_elems)
        state = min(full, window)
    else:
        state = int(_STATE_MULT[optimizer] * mbytes * peak * resident_bundles) \
            if mode in hift_modes else int(_STATE_MULT[optimizer] * mbytes * n)

    ef = 0
    if ef_pods and ef_pods >= 2:
        if mode in ("fpft", "fpft_streamed"):
            ef = 4 * ef_pods * n
        elif mode in hift_modes:
            ef = 4 * ef_pods * peak * resident_bundles
        else:
            raise ValueError(
                f"ef_pods: mode {mode!r} has no gradient tree to compress "
                "(cross-pod EF applies to fpft / hift modes)")

    return MemoryReport(
        n_params=n, peak_trainable=peak,
        para_mb=para / 2**20, grad_mb=grad / 2**20, state_mb=state / 2**20,
        pgs_gb=(para + grad + state + ef) / 2**30, ef_mb=ef / 2**20,
    )


def paper_equation_check(zeta1_gb: float, k: int) -> tuple[float, float, float]:
    """Eq. 11-13: (fpft_gb, hift_gb, saved_gb) for AdamW fp32."""
    fpft = 4 * zeta1_gb
    hift = (k + 3) / k * zeta1_gb
    return fpft, hift, fpft - hift
