"""HiFT grouping and visit orders (port of ``repro.core.grouping``, paper
§3, Algorithm 1).

Units come from the model's ``unit_spec``; groups are contiguous spans of
m units.  The visit order (bottom2up / top2down / random-once) permutes
the order in which groups are trained; group membership never changes.

Slices are views: :func:`split_params` copies nothing, and
:func:`merge_params` presents a stacked segment's frozen and active pieces
as one ``models.base.LayerStack`` instead of concatenating them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np

from repro_torch.common.pytree import tree_map
from repro_torch.models.base import LayerStack, Unit

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Group:
    """One HiFT group: dense unit keys + contiguous ranges of stacked
    segments."""
    index: int
    units: tuple[Unit, ...]
    dense_keys: tuple[str, ...]                       # fully-owned keys
    stacked_ranges: tuple[tuple[str, int, int], ...]  # (key, lo, hi)

    def label(self) -> str:
        parts = list(self.dense_keys)
        parts += [f"{k}[{lo}:{hi}]" for k, lo, hi in self.stacked_ranges]
        return f"g{self.index}(" + ",".join(parts) + ")"


def make_groups(units: Sequence[Unit], m: int) -> list[Group]:
    """Partition ordered units into ceil(n/m) groups of m consecutive
    units."""
    if m <= 0:
        raise ValueError("m must be >= 1")
    groups = []
    for gi, start in enumerate(range(0, len(units), m)):
        chunk = tuple(units[start:start + m])
        dense = tuple(u.key for u in chunk if u.kind == "dense")
        ranges: dict[str, list[int]] = {}
        for u in chunk:
            if u.kind == "stacked":
                ranges.setdefault(u.key, []).append(u.index)
        stacked = []
        for key, idxs in ranges.items():
            lo, hi = min(idxs), max(idxs) + 1
            if sorted(idxs) != list(range(lo, hi)):
                raise ValueError(f"non-contiguous unit indices for {key}: "
                                 f"{idxs}")
            stacked.append((key, lo, hi))
        groups.append(Group(gi, chunk, dense, tuple(stacked)))
    return groups


def order_groups(groups: Sequence[Group], strategy: str,
                 seed: int = 0) -> list[int]:
    """Visit order over group indices.  'random' shuffles ONCE before
    training (``np.random.RandomState(seed)``, so the order equals the
    reference's) and keeps that order for the whole run."""
    idx = list(range(len(groups)))
    if strategy == "bottom2up":
        return idx
    if strategy == "top2down":
        return idx[::-1]
    if strategy == "random":
        rng = np.random.RandomState(seed)
        rng.shuffle(idx)
        return idx
    raise ValueError(f"unknown strategy {strategy!r}")


def split_params(params: PyTree, group: Group) -> tuple[PyTree, PyTree]:
    """(active, frozen) for a group.  Stacked segments are sliced (views of
    the resident tensors); the frozen side holds the pre/post remainders
    under reserved keys."""
    active: dict = {}
    frozen: dict = {}
    taken = {k: (lo, hi) for k, lo, hi in group.stacked_ranges}
    for key, sub in params.items():
        if key in group.dense_keys:
            active[key] = sub
        elif key in taken:
            lo, hi = taken[key]
            active[key] = tree_map(lambda x: x[lo:hi], sub)
            frozen[f"{key}__pre"] = tree_map(lambda x: x[:lo], sub)
            frozen[f"{key}__post"] = tree_map(lambda x: x[hi:], sub)
        else:
            frozen[key] = sub
    return active, frozen


def merge_params(active: PyTree, frozen: PyTree, group: Group) -> PyTree:
    """Inverse of :func:`split_params` for the forward: the full tree, with
    each split stacked segment as a ``LayerStack`` of (pre, active, post).
    The reference concatenates the slices; here nothing is copied, and
    gradients w.r.t. ``active`` flow through the layer views."""
    out: dict = {}
    taken = {k for k, _, _ in group.stacked_ranges}
    for key, sub in active.items():
        if key in taken:
            out[key] = LayerStack([frozen[f"{key}__pre"], sub,
                                   frozen[f"{key}__post"]])
        else:
            out[key] = sub
    for key, sub in frozen.items():
        if key.endswith("__pre") or key.endswith("__post"):
            continue
        out[key] = sub
    return out


def group_cut(cfg, group: Group, unit_first_depth) -> Optional[int]:
    """Backward-cut depth for this group: the min first-use depth over its
    units.  None (= FPFT-style full backward) when the embed unit is
    active."""
    depths = []
    for u in group.units:
        if u.key == "embed":
            return None
        depths.append(unit_first_depth(cfg, u))
    return min(depths) if depths else None
