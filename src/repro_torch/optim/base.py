"""Optimizer substrate: functional (init, update) pairs over tensor dicts
(port of ``repro.optim.base``).

``update(grads, state, params, lr)`` returns ``(new_params, new_state)``.
The learning rate is an explicit host float because HiFT's *delayed*
schedule advances it once per group cycle, outside the optimizer.  State
mirrors the param tree, so a HiFT per-group step holds state for its
group's sub-tree only — the paper's k-fold optimizer-state saving.  No
``torch.optim``: a HiFT bundle is one group's state dict.

Every optimizer keeps its step ``count`` as a CPU int64 tensor, so the
bias corrections are host floats and an update reads nothing back from the
device.  The update is functional on CPU tensors (new tensors out, inputs
untouched); on CUDA tensors the fused updates write params and moments in
place (the counterpart of the reference's buffer donation).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.common.pytree import (flatten_with_paths, tree_map,
                                       unflatten_from_paths)

PyTree = Any


class Optimizer(NamedTuple):
    name: str
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree, float], tuple[PyTree, PyTree]]
    # bytes of optimizer state per parameter (the analytic memory model)
    state_bytes_per_param: float = 0.0
    # True when update() is elementwise with no cross-leaf coupling (no
    # global-norm clip), the contract a chunk-streamed update relies on
    stream_safe: bool = False
    # the global-norm clip threshold the update applies (0 = none)
    grad_clip: float = 0.0


def moment_dtype_of(moment_dtype) -> torch.dtype:
    """``None`` -> float32; a torch dtype or its name ("bfloat16")."""
    if moment_dtype is None:
        return torch.float32
    if isinstance(moment_dtype, str):
        return getattr(torch, moment_dtype)
    return moment_dtype


def new_count() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64)


def leaves(*trees) -> tuple[list[str], list[list]]:
    """Paths of the first tree and each tree's leaves in that order."""
    paths = list(flatten_with_paths(trees[0]))
    flats = [flatten_with_paths(t) for t in trees]
    return paths, [[f[p] for p in paths] for f in flats]


def rebuild(paths: list[str], flat: list) -> PyTree:
    return unflatten_from_paths(dict(zip(paths, flat)))


def zeros_like_tree(params: PyTree, dtype: torch.dtype) -> PyTree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=dtype,
                                          device=p.device), params)


def global_sq_norm(tree: PyTree) -> torch.Tensor:
    """Sum of squared leaf elements in fp32 (the global grad norm,
    squared)."""
    return sum(torch.sum(torch.square(g.float()))
               for g in flatten_with_paths(tree).values())


def clip_scale(max_norm: float, sq: torch.Tensor) -> torch.Tensor:
    """``min(1, max_norm/||g||)`` from a precomputed squared norm."""
    return torch.clamp(max_norm / (torch.sqrt(sq) + 1e-12), max=1.0)


def clip_by_global_norm(grads: PyTree, max_norm: float) -> PyTree:
    if max_norm is None or max_norm <= 0:
        return grads
    scale = clip_scale(max_norm, global_sq_norm(grads))
    return tree_map(lambda g: (g * scale).to(g.dtype), grads)


def bias_correction(beta: float, count: torch.Tensor) -> float:
    """``1 - beta ** count`` in float32 on the host, as the reference
    computes it (``1.0 - b1 ** count.astype(f32)``)."""
    one = torch.tensor(1.0, dtype=torch.float32)
    b = torch.tensor(beta, dtype=torch.float32)
    return float(one - b ** count.to(torch.float32))


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.9  # SGDM
    grad_clip: float = 1.0
    # MeZO
    mezo_eps: float = 1e-3
