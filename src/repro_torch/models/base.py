"""HiFT unit machinery and the layer loop (port of ``repro.models.base``).

A *unit* is the paper's layering granularity: the embedding is the bottom
unit, each transformer block one unit, the head (+ final norm) the top
unit.  HiFT groups are contiguous spans of units.  Params keep the
reference's STACKED layers (leading dim = n_layers); a unit addresses
either a top-level key (dense unit, ``"embed"``) or one index of a stacked
segment (``("layers", 17)``).

:func:`run_layers` replaces ``scan_layers``: a Python loop over layer
slices.  Layers below the HiFT cut run under ``torch.no_grad()``, so
autograd keeps nothing for them; each layer at or above the cut runs under
``torch.utils.checkpoint`` when the config asks for ``remat="layer"``.

A grouped strategy trains one slice of a stacked segment and keeps the
rest frozen.  :class:`LayerStack` presents the pieces (frozen prefix,
active slice, frozen suffix) as one indexable stack, so the forward takes
layer ``i`` from whichever piece holds it and never concatenates the
segment — a ``torch.cat`` of llama2-7b's stacked layers would copy 25 GB
of fp32 on every step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.pytree import flatten_with_paths, tree_map
from repro_torch.dist.quant import is_quantized, layer_of

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Unit:
    kind: str                 # "dense" | "stacked"
    key: str                  # top-level param key ("embed", "layers", ...)
    index: Optional[int] = None  # layer index within a stacked segment

    def label(self) -> str:
        return self.key if self.kind == "dense" else f"{self.key}[{self.index}]"


def dense_unit(key: str) -> Unit:
    return Unit("dense", key)


def stacked_units(key: str, n: int) -> list[Unit]:
    return [Unit("stacked", key, i) for i in range(n)]


def default_unit_first_depth(cfg, unit: Unit) -> int:
    """Depth at which a unit is first used, the reference's default rule:
    the embedding at 0, stacked layer ``i`` at ``i``, the head at
    ``n_layers``."""
    if unit.key == "embed":
        return 0
    if unit.kind == "stacked":
        return unit.index
    return cfg.n_layers


def unit_first_depth(cfg, unit: Unit) -> int:
    """The family's own ``unit_first_depth`` where its module has one (the
    hybrid family's shared block: after super-block 0), else the default
    rule (``repro.models.unit_first_depth``)."""
    from repro_torch.models import get_family   # the families import us
    fn = getattr(get_family(cfg), "unit_first_depth", None)
    return fn(cfg, unit) if fn else default_unit_first_depth(cfg, unit)


def stack_len(tree: PyTree) -> int:
    """Leading (layer) dim of a stacked sub-tree."""
    leaves = list(flatten_with_paths(tree).values())
    return int(leaves[0].shape[0]) if leaves else 0


class LayerStack:
    """Consecutive pieces of one stacked segment, indexable as a whole.

    ``pieces`` are stacked sub-trees of equal structure; layer ``i`` of the
    stack is layer ``i - offset`` of the piece that holds it.  Nothing is
    copied: each layer is a view into its piece."""

    def __init__(self, pieces: Sequence[PyTree]):
        self.pieces = [(stack_len(p), p) for p in pieces]
        self.pieces = [(n, p) for n, p in self.pieces if n > 0]

    def __len__(self) -> int:
        return sum(n for n, _ in self.pieces)

    def layer(self, i: int) -> PyTree:
        for n, piece in self.pieces:
            if i < n:
                return _slice_layer(piece, i)
            i -= n
        raise IndexError("layer index out of range")


def _slice_layer(stack: PyTree, i: int) -> PyTree:
    """Layer ``i`` of a stacked sub-tree: plain slices, and for codec
    records (quantized residency) a layer view of each matrix and the
    decoded row of each ``(L, d)`` stack — nothing beyond the layer is
    decoded."""
    return tree_map(lambda x: layer_of(x, i) if is_quantized(x) else x[i],
                    stack, is_leaf=is_quantized)


# ---------------------------------------------------- fused-backward pieces

@dataclasses.dataclass(frozen=True)
class LomoPieces:
    """Segmented forward contract for the fused-backward strategies
    (``lomo`` / ``adalomo`` in ``repro_torch.core.strategy``), the
    reference's ``LomoPieces``.

    The strategy runs each stage's forward without a graph, saving only
    each layer's INPUT, then walks the layers in reverse: one layer is
    recomputed under autograd, its gradient is consumed (SGD- or
    Adafactor-updated in place) and dropped before the next layer's
    exists.  The pieces must reproduce the family's ``loss_fn`` exactly
    (same ops), i.e. for every ``params``/``batch``::

        ep, stages, sp, hp = pieces.split(params)
        h, side = pieces.stage_inits[0](ep, None, batch)
        for i in range(len(pieces.stage_keys)):
            if i > 0:
                h, side = pieces.stage_inits[i](ep, h, batch)
            for j in range(stack_len(stages[i])):
                h = pieces.stage_fns[i](layer_at(stages[i], j), sp, side, h)
        loss = pieces.head_loss_fn(hp, ep, h, batch)   # == loss_fn(...)

    Fields: ``stage_keys`` (forward order of the stacked trunk stages);
    ``stage_fns[i]``: ``block(layer_p, shared_p, side, h) -> h`` for one
    layer of stage i (``shared_p``: a segment reused by every block, None
    for dense; ``side``: a per-stage constant activation, None for dense);
    ``stage_inits[i]``: ``(embed_p, prev_stage_out, batch) -> (h0,
    side)``; ``head_loss_fn``: ``(head_p, embed_p, h_final, batch) ->
    loss``; ``split``: ``params -> (embed_p, stages, shared_p, head_p)``,
    restructuring only leading dims, so it applies verbatim to AdaLomo's
    param-shaped moment tree; ``merge``: its inverse; ``liveness_m``: the
    consecutive units whose gradients are live in one fused grain."""
    stage_keys: tuple
    stage_fns: tuple
    stage_inits: tuple
    head_loss_fn: Callable
    split: Callable
    merge: Callable
    shared_key: Optional[str] = None
    liveness_m: int = 1

    @classmethod
    def from_embed_block_head(cls, embed_fn: Callable, block_fn: Callable,
                              head_loss_fn: Callable) -> "LomoPieces":
        """Adapt the dense 3-tuple contract (``transformer.lomo_pieces``:
        ``embed_fn(embed_p, batch)``, ``block_fn(layer_p, h)``,
        ``head_loss_fn(head_p, embed_p, h, batch)``) over an
        ``{"embed", "layers", "head"}`` tree to the staged protocol."""
        return cls(
            stage_keys=("layers",),
            stage_fns=(lambda lp, sp, side, h: block_fn(lp, h),),
            stage_inits=(lambda ep, prev, batch: (embed_fn(ep, batch),
                                                  None),),
            head_loss_fn=head_loss_fn,
            split=lambda params: (params["embed"], (params["layers"],), None,
                                  params["head"]),
            merge=lambda ep, stages, sp, hp: {"embed": ep,
                                              "layers": stages[0],
                                              "head": hp},
        )


def n_layers_of(layers) -> int:
    return len(layers) if isinstance(layers, LayerStack) else stack_len(layers)


def layer_at(layers, i: int) -> PyTree:
    if isinstance(layers, LayerStack):
        return layers.layer(i)
    return _slice_layer(layers, i)


def run_layers(step: Callable, layers, h: torch.Tensor,
               cut: Optional[int] = None, remat: bool = False):
    """Run ``h`` through every layer of ``layers`` (a stacked sub-tree or a
    :class:`LayerStack`); ``step(h, layer_params) -> h``.

    ``cut``: the HiFT backward cut.  Layers ``< cut`` run under
    ``torch.no_grad()`` and the activation entering layer ``cut`` is
    detached — the reference's ``stop_gradient`` before layer ``cut`` — so
    no cotangent flows below the active group.  ``remat``: each layer that
    does record a graph runs under ``torch.utils.checkpoint`` (non
    re-entrant), storing only its input and recomputing the rest in the
    backward, as the reference's ``jax.checkpoint`` does."""
    n = n_layers_of(layers)
    cut = None if cut is None or cut <= 0 else min(cut, n)
    for i in range(n):
        p = layer_at(layers, i)
        if cut is not None and i < cut:
            with torch.no_grad():
                h = step(h, p)
            continue
        if i == cut:
            h = h.detach()
        if remat and torch.is_grad_enabled():
            h = checkpoint(step, h, p, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = step(h, p)
    return h
