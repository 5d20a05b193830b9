"""JAX param trees (as numpy) <-> torch param dicts.

The port keeps the JAX package's layout (same keys, ``layers`` leaves
stacked with a leading ``n_layers`` dim, ``x @ W`` orientation), so a
conversion is a copy of each leaf.  bfloat16 has no numpy dtype of its own
outside ``ml_dtypes``, so it crosses as a ``uint16`` view of the same bits:
a round trip is bit-exact for float32 and bfloat16 alike.

:func:`state_to_torch` carries a whole training state across: a JAX
``TrainState.to_tree()`` becomes the port's ``TrainState``, so a run can
start in one package and continue in the other.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.common.pytree import tree_map

PyTree = Any


def _leaf_to_torch(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def _leaf_to_numpy(t: torch.Tensor, bf16_dtype) -> np.ndarray:
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        return bits.view(bf16_dtype) if bf16_dtype is not None else bits
    return t.numpy()


def to_torch(tree: PyTree, device="cpu") -> PyTree:
    """Nested dicts of array-likes (numpy or JAX arrays) -> torch tensors."""
    return tree_map(lambda x: _leaf_to_torch(x, device), tree)


def to_numpy(tree: PyTree, bf16_dtype: Optional[Any] = None) -> PyTree:
    """Torch tensors -> numpy arrays.  bfloat16 leaves come back as their
    ``uint16`` bits, or as ``bf16_dtype`` (a numpy bfloat16 type such as
    ``jnp.bfloat16``) when the caller has one."""
    return tree_map(lambda t: _leaf_to_numpy(t, bf16_dtype), tree)


def _state_leaf(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if np.issubdtype(a.dtype, np.integer):
        # optimizer step counts stay on the host, as the port keeps them
        return torch.from_numpy(np.array(a, dtype=np.int64))
    return _leaf_to_torch(a, device)


def state_to_torch(tree: dict, device="cpu"):
    """A JAX ``TrainState.to_tree()`` (leaves as JAX or numpy arrays) ->
    the port's ``TrainState``: params and every floating leaf of the
    optimizer state (FPFT's state tree, or the grouped strategies'
    ``{str(group): bundle}``) on ``device``, step counts as CPU int64
    tensors, ``step`` an int, ``extra["order"]`` (HiFT's visit order) an
    int64 numpy array and ``extra["rng"]`` (MeZO's key) a uint32 one."""
    from repro_torch.core.strategy import TrainState
    extra = dict(tree.get("extra") or {})
    if "order" in extra:
        extra["order"] = np.asarray(extra["order"], np.int64)
    if "rng" in extra:
        extra["rng"] = np.asarray(extra["rng"], np.uint32)
    return TrainState(
        params=to_torch(tree["params"], device),
        opt_state=tree_map(lambda x: _state_leaf(x, device),
                           tree.get("opt_state") or {}),
        step=int(np.asarray(tree["step"])), extra=extra)
