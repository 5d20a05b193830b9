"""Elastic TrainState resize: restore a state onto another mesh (port of
``repro.dist.elastic``).

A checkpoint is mesh-independent (``train.checkpoint`` writes every leaf
whole), but a live state, or a restored one headed for another mesh
shape, carries placement.  :func:`resize_state` is the one move: gather
every leaf to the host, then lay the tree out on the target, through a
strategy built for the new mesh (params, optimizer moments, AdaLomo's
factored statistics, FPFT's EF residuals: what that strategy's ``init``
would give them) or through a bare mesh (the params take the structural
rule; everything else stays on the host until a strategy places it).

This is the path behind ``checkpoint.restore_state(..., strategy=)``:
train 3 steps on a 2x2 mesh, restore onto 1x4 or 4x1, keep training.
HiFT's queue position, per-group bundles and optimizer moments survive
because they are ordinary TrainState leaves.

The gather is ``DTensor.full_tensor()`` on every sharded leaf, a
collective: every rank of the old mesh calls it, in the same order.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.distributed.tensor import DTensor

from repro_torch.common.pytree import tree_map

PyTree = Any


def gather_to_host(tree: PyTree) -> PyTree:
    """Every tensor leaf whole, on the host (DTensors through
    ``full_tensor()``, a collective)."""
    from repro_torch.dist import shardings as S

    def one(t):
        if isinstance(t, DTensor):
            t = S.gather({"x": t})["x"]
        return t.detach().cpu() if isinstance(t, torch.Tensor) else t

    return tree_map(one, tree)


def resize_state(state, *, strategy=None, mesh=None):
    """``state`` (a ``TrainState``) re-laid out for a new mesh.

    - ``strategy``: an instance built for the TARGET mesh; the state lands
      where that strategy keeps it (``Strategy.place_state``) and can be
      stepped at once;
    - ``mesh``: the params take the structural rule
      (``dist.shardings.param_shardings``) as DTensors on the mesh's
      device; the rest stays on the host.

    With neither, the state is gathered to the host (a no-mesh
    restore)."""
    from repro_torch.core.strategy import TrainState
    from repro_torch.dist import shardings as S

    host = TrainState.from_tree(gather_to_host(state.to_tree()))
    if strategy is not None:
        return strategy.place_state(host)
    if mesh is not None and mesh.size() > 1:
        params = tree_map(lambda t: t.to(mesh.device_type), host.params)
        return TrainState(S.shard(params, S.param_shardings(params, mesh),
                                  mesh),
                          host.opt_state, host.step, host.extra)
    return host
