"""Ambient sharding context for a training step (port of
``repro.dist.ctx``).

The strategies open :func:`activation_sharding` around each step under a
``mesh=``; model code asks :func:`active` (the moe layer takes its
expert-parallel path then) and may call the ``constrain_*`` helpers at
layer boundaries.  Each helper is the identity outside a context and on a
plain tensor; inside one it redistributes a DTensor's leading dim over the
context's axes.  In the port a step's activations are the rank's own
rows of the batch (plain tensors), so inside a strategy step the helpers
are the identity too; a DTensor handed in by a caller is laid out as the
reference's ``with_sharding_constraint`` lays it out.

:func:`data_mean` is the one reduction the port's model-side code needs:
the mean over the data axes of a gradient (or loss) computed from the
rank's rows, the identity outside a context.  After
:func:`weigh_by_targets` it weighs each rank by its share of the
labelled targets, so that the ranks' per-token means combine into the
reference's per-token mean over the whole batch.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.common.pytree import tree_map

PyTree = Any

_STATE: dict = {"mesh": None, "batch_axes": (), "model_axis": None,
                "weight": 1.0}


def active() -> bool:
    return _STATE["mesh"] is not None


def mesh():
    return _STATE["mesh"]


def model_axis() -> Optional[str]:
    return _STATE["model_axis"]


@contextlib.contextmanager
def activation_sharding(mesh, batch_axes: Sequence[str],
                        model_axis: Optional[str] = "model"):
    """Activate the context: batch dims over ``batch_axes``, expert dims
    over ``model_axis`` (dropped when the mesh has no such axis).
    Nestable; restores the previous state."""
    if model_axis is not None and model_axis not in mesh.mesh_dim_names:
        model_axis = None
    prev = dict(_STATE)
    _STATE.update(mesh=mesh, batch_axes=tuple(batch_axes),
                  model_axis=model_axis, weight=1.0)
    try:
        yield
    finally:
        _STATE.update(prev)


def _axes_size(mesh, axes) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    n = 1
    for a in (axes if isinstance(axes, (tuple, list)) else (axes,)):
        n *= sizes.get(a, 1)
    return n


def _constrain_leading(x: PyTree, axes) -> PyTree:
    """Redistribute every DTensor leaf's leading dim over ``axes``
    (replicated elsewhere); plain tensors, 0-d/1-d leaves and leading dims
    that do not divide are left as they are."""
    if not active() or not axes:
        return x
    m = _STATE["mesh"]
    n = _axes_size(m, axes)
    if n <= 1:
        return x
    axes = axes if isinstance(axes, (tuple, list)) else (axes,)

    def one(leaf):
        if not isinstance(leaf, DTensor) or leaf.ndim < 2:
            return leaf
        if leaf.shape[0] % n != 0 or leaf.shape[0] < n:
            return leaf
        spec = tuple(Shard(0) if name in axes else Replicate()
                     for name in m.mesh_dim_names)
        return leaf.redistribute(m, spec)

    return tree_map(one, x)


def constrain_layer_io(h: PyTree) -> PyTree:
    """Residual-stream activations at layer boundaries: the batch dim over
    the data axes."""
    return _constrain_leading(h, _STATE["batch_axes"])


def constrain_tokens(xt: PyTree) -> PyTree:
    """Token-major activations (the (N, D) moe dispatch view)."""
    return _constrain_leading(xt, _STATE["batch_axes"])


def constrain_expert(buf: PyTree) -> PyTree:
    """Expert-major buffers ((E, C, D)): the expert dim over the model
    axis."""
    return _constrain_leading(buf, _STATE["model_axis"])


def weigh_by_targets(labels: torch.Tensor) -> None:
    """Weigh this rank in :func:`data_mean` by ``n / mean(n)``, ``n`` the
    labelled targets of its rows (``labels[:, 1:] >= 0``: the families'
    next-token loss, a mean over them) and ``mean(n)`` that over the data
    axes.  The weighted mean of the ranks' losses is then the loss of
    the whole batch, however the labels' mask falls across the ranks; with
    equal counts the weight is exactly 1.  A collective over the data
    axes; a no-op outside a context or on one data rank."""
    if not active():
        return
    from repro_torch.dist import shardings as S
    m = _STATE["mesh"]
    if S.data_size(m) == 1:
        return
    n = (labels[:, 1:] >= 0).sum().to(torch.float64)
    mean = float(S.data_mean_(n.clone(), m))
    _STATE["weight"] = float(n) / mean if mean > 0 else 1.0


def data_mean(tree: PyTree) -> PyTree:
    """The mean over the context's data axes of every tensor of ``tree``
    (None passes), each rank weighted as :func:`weigh_by_targets` set;
    the identity outside a context."""
    if not active() or tree is None:
        return tree
    from repro_torch.dist import shardings as S
    m = _STATE["mesh"]
    if S.data_size(m) == 1:
        return tree
    w = _STATE["weight"]

    def one(t):
        t32 = t.detach().to(torch.float32, copy=True)
        if w != 1.0:
            t32.mul_(w)
        return S.data_mean_(t32, m).to(t.dtype)

    return tree_map(one, tree)
