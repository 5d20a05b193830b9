"""Path utilities over parameter trees (nested dicts of tensors).

The port's counterpart of ``repro.common.pytree``: the same '/'-joined
path convention, so a leaf's path names the same parameter in both
packages.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import torch

PyTree = Any


def flatten_with_paths(tree: PyTree, prefix: str = "") -> dict[str, Any]:
    """Flatten nested dicts into {'a/b/c': leaf} (insertion order)."""
    if not isinstance(tree, Mapping):
        return {prefix: tree}
    out: dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out.update(flatten_with_paths(v, path))
    return out


def unflatten_from_paths(flat: Mapping[str, Any]) -> PyTree:
    """Inverse of :func:`flatten_with_paths`."""
    out: dict = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out


def tree_map(fn: Callable, tree: PyTree,
             is_leaf: Optional[Callable] = None) -> PyTree:
    """``fn`` over every leaf.  ``is_leaf(node)`` True stops the descent
    there (``dist.quant.is_quantized`` treats a codec record as one leaf,
    as the reference's ``jax.tree.map(..., is_leaf=is_quantized)``)."""
    if isinstance(tree, Mapping) and not (is_leaf and is_leaf(tree)):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    return fn(tree)


def tree_size(tree: PyTree) -> int:
    """Total number of scalar parameters."""
    return sum(int(x.numel()) for x in flatten_with_paths(tree).values())


def tree_bytes(tree: PyTree) -> int:
    return sum(int(x.numel()) * x.element_size()
               for x in flatten_with_paths(tree).values())


def is_record(node) -> bool:
    """True for a ``{"q", "s", "t"}`` codec record (``dist.quant``)."""
    return isinstance(node, Mapping) and set(node.keys()) == {"q", "s", "t"}


def tree_cast(tree: PyTree, dtype: torch.dtype) -> PyTree:
    """Cast floating leaves to ``dtype``; integer leaves pass through, and
    so do codec records (``dist.quant``), whose template's dtype is the
    record's own."""
    return tree_map(lambda x: x if is_record(x) or not x.is_floating_point()
                    else x.to(dtype), tree, is_leaf=is_record)
