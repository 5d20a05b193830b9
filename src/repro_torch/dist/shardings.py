"""Placement rules on the (data, model) ``DeviceMesh`` (port of
``repro.dist.shardings``).

A *spec* is a tuple of DTensor placements, one per mesh dim
(``Shard(d)`` or ``Replicate()``); a spec tree mirrors a tensor tree.  The
rules are the reference's, structural (shape-driven), so they apply to
every family's tree:

- params and optimizer moments: the largest dim the model size divides
  shards over ``model`` (ties: the last such dim), never a stacked leaf's
  leading dim (ndim >= 3); everything else replicates, and every leaf
  replicates over the data axes;
- a grouped strategy's resident tree (frozen majority) replicates;
- batches: the leading dim over the data axes (``pod`` folds into data),
  replicated when it does not divide;
- a cross-pod EF residual tree ``(pods,) + shape``: the pods dim never
  shards, the rest follows the param rule;
- a bundle ``{"opt", "master"?, "ef"?}``: the param rule leaf-wise, its
  ``"ef"`` the pods-leading rule;
- the streamed chunk window: a 1-d chunk over ``model`` when it divides;
- decode caches, layout-agnostic: the data axes on the first non-leading
  dim they divide, ``model`` on the largest remaining dim it divides.

The strategies place a bundle, FPFT's moments and EF residuals with
:func:`mirror_specs`: each leaf takes the specs of the param it mirrors,
so a ``param_sharding_fn`` override carries to it and a leaf that is not
param-shaped (a quantized moment's scales) replicates, as an update on
local shards needs.  Without an override it gives what
:func:`bundle_shardings` gives; the structural bundle, optimizer-state,
residual and chunk-window rules are the reference's, held to it by the
tests.

The reference composes these rules into ``(in_shardings,
out_shardings)`` pairs for its jitted steps (``group_step_shardings``,
``fpft_step_shardings``, ``fpft_crosspod_step_shardings``,
``fpft_grad_shardings``, ``fpft_crosspod_grad_shardings``,
``mezo_step_shardings``, ``lomo_step_shardings``,
``adalomo_step_shardings``).  The port has no jit to hand them to: a step
places its arguments itself with the helpers below (gather the params to
full tensors for the forward, take the rank's rows of the batch, reduce
each gradient over the data axes and keep the rank's shard for the
update), so none of the compositions has a counterpart.  The serving
pair, :func:`prefill_step_shardings` and :func:`decode_step_shardings`,
is kept as spec trees, held to the reference's; the engines
(``serve.engine``) split the rows by the batch rule and keep each rank's
rows' cache whole (ROADMAP, deliberate differences).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.common.pytree import (flatten_with_paths, tree_map,
                                       unflatten_from_paths)

PyTree = Any

_MODEL_AXIS = "model"
_DATA_AXES = ("pod", "data")


def _names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def sizes(mesh) -> dict[str, int]:
    return dict(zip(_names(mesh), mesh.mesh.shape))


def data_axes(mesh) -> tuple[str, ...]:
    """Mesh axes that carry the batch dimension (``pod`` folds into
    data)."""
    return tuple(a for a in _names(mesh) if a in _DATA_AXES)


def data_size(mesh) -> int:
    s = sizes(mesh)
    n = 1
    for a in data_axes(mesh):
        n *= s[a]
    return n


def model_size(mesh) -> int:
    return sizes(mesh).get(_MODEL_AXIS, 1)


def _model_dim(shape, size: int, skip: Optional[int] = None
               ) -> Optional[int]:
    """Largest dim divisible by the model-axis size (ties -> last dim)."""
    best = None
    for i, d in enumerate(shape):
        if i == skip or d < size or d % size != 0:
            continue
        if best is None or d >= shape[best]:
            best = i
    return best


def _spec(mesh, dim_axes: dict) -> tuple:
    """The placements that shard tensor dim ``d`` over each mesh axis of
    ``dim_axes[d]`` (an axis name or a tuple of names)."""
    out = [Replicate()] * len(_names(mesh))
    for d, axes in dim_axes.items():
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            out[_names(mesh).index(a)] = Shard(d)
    return tuple(out)


def replicated_spec(mesh) -> tuple:
    return _spec(mesh, {})


def param_spec(shape, mesh) -> tuple:
    """The param rule for one leaf of ``shape``."""
    size = model_size(mesh)
    if size > 1 and len(shape) >= 1:
        skip = 0 if len(shape) >= 3 else None
        dim = _model_dim(tuple(shape), size, skip=skip)
        if dim is not None:
            return _spec(mesh, {dim: _MODEL_AXIS})
    return replicated_spec(mesh)


def param_shardings(params: PyTree, mesh) -> PyTree:
    """Tensor-parallel placement of a param (or param-shaped) tree."""
    return tree_map(lambda t: param_spec(t.shape, mesh), params)


def replicated(tree: PyTree, mesh) -> PyTree:
    """Every leaf replicated (the grouped strategies' resident tree)."""
    return tree_map(lambda _: replicated_spec(mesh), tree)


def opt_state_shardings(state: PyTree, params: PyTree, mesh) -> PyTree:
    """Optimizer state mirrors the param rule; scalars replicate."""
    del params
    return param_shardings(state, mesh)


def batch_shardings(batch: PyTree, mesh) -> PyTree:
    """The leading (batch) dim over the data axes when it divides."""
    axes, n = data_axes(mesh), data_size(mesh)

    def one(t):
        if axes and t.ndim >= 1 and t.shape[0] >= n and t.shape[0] % n == 0:
            return _spec(mesh, {0: axes})
        return replicated_spec(mesh)

    return tree_map(one, batch)


def crosspod_residual_shardings(residuals: PyTree, mesh) -> PyTree:
    """A stacked per-pod EF residual tree: the pods dim never shards, the
    trailing dims take the param rule of the gradient they correct."""
    def one(t):
        inner = param_spec(t.shape[1:], mesh)
        return tuple(Shard(p.dim + 1) if isinstance(p, Shard) else p
                     for p in inner)

    return tree_map(one, residuals)


def bundle_shardings(bundle: PyTree, mesh) -> PyTree:
    """A grouped strategy's bundle: the param rule leaf-wise, ``"ef"`` the
    pods-leading rule."""
    if isinstance(bundle, dict) and "ef" in bundle:
        out = param_shardings({k: v for k, v in bundle.items() if k != "ef"},
                              mesh)
        out["ef"] = crosspod_residual_shardings(bundle["ef"], mesh)
        return out
    return param_shardings(bundle, mesh)


def chunk_window_shardings(chunks: PyTree, mesh) -> PyTree:
    """A 1-d stream chunk shards over ``model`` when its length divides."""
    size = model_size(mesh)

    def one(t):
        if size > 1 and t.ndim == 1 and t.shape[0] >= size \
                and t.shape[0] % size == 0:
            return _spec(mesh, {0: _MODEL_AXIS})
        return replicated_spec(mesh)

    return tree_map(one, chunks)


def cache_shardings(cache: PyTree, mesh) -> PyTree:
    """Decode caches, layout-agnostic: leaves may be (n_layers, B, ...) or
    (B, ...).  The first non-leading dim the data size divides takes the
    data axes (the batch dim of a layers-first layout), then the largest
    remaining non-leading dim the model size divides takes ``model``;
    leaves of fewer than 2 dims (``pos``) replicate."""
    axes, dsize, msize = data_axes(mesh), data_size(mesh), model_size(mesh)

    def one(t):
        ndim = getattr(t, "ndim", 0)
        if ndim < 2:
            return replicated_spec(mesh)
        dim_axes: dict = {}
        if axes and dsize > 1:
            for i in range(1, ndim):
                if t.shape[i] >= dsize and t.shape[i] % dsize == 0:
                    dim_axes[i] = axes
                    break
        if msize > 1:
            cands = [i for i in range(1, ndim) if i not in dim_axes
                     and t.shape[i] >= msize and t.shape[i] % msize == 0]
            if cands:
                dim_axes[max(cands, key=lambda i: t.shape[i])] = _MODEL_AXIS
        return _spec(mesh, dim_axes)

    return tree_map(one, cache)


def prefill_step_shardings(mesh, params: PyTree, batch: PyTree,
                           cache: PyTree, logits: PyTree):
    """``(in, out)`` spec trees of the serving prefill ``prefill(params,
    batch, cache) -> (logits, cache)``: params as the trainer places them,
    the prompts and logits by the batch rule, the cache by the cache rule,
    the same in and out."""
    c = cache_shardings(cache, mesh)
    return ((param_shardings(params, mesh), batch_shardings(batch, mesh), c),
            (batch_shardings(logits, mesh), c))


def decode_step_shardings(mesh, params: PyTree, cache: PyTree,
                          tokens: PyTree, logits: PyTree):
    """``(in, out)`` spec trees of the serving decode step ``decode(params,
    cache, tokens) -> (logits, cache)``: the cache the same in and out,
    tokens and logits by the batch rule."""
    c = cache_shardings(cache, mesh)
    return ((param_shardings(params, mesh), c, batch_shardings(tokens, mesh)),
            (batch_shardings(logits, mesh), c))


def mirror_specs(tree: PyTree, like_shapes: dict, like_specs: dict,
                 mesh) -> PyTree:
    """Specs for a tree whose leaves mirror a param tree's (a bundle's
    moments and master; ``"ef"`` residuals with a leading pods dim): a
    leaf takes the spec of the param whose path ends its own path and
    whose shape it has (or has behind one leading dim, shifted by one);
    any other leaf (a step count) replicates."""
    def find(path, shape):
        parts = path.split("/")
        for i in range(len(parts)):
            key = "/".join(parts[i:])
            if key not in like_specs:
                continue
            if tuple(shape) == like_shapes[key]:
                return like_specs[key]
            if tuple(shape[1:]) == like_shapes[key]:
                return tuple(Shard(p.dim + 1) if isinstance(p, Shard) else p
                             for p in like_specs[key])
        return replicated_spec(mesh)

    return unflatten_from_paths({p: find(p, t.shape) for p, t in
                                 flatten_with_paths(tree).items()})


# ------------------------------------------------------------ local pieces

def _coord(mesh) -> list[int]:
    c = mesh.get_coordinate()
    if c is None:
        raise RuntimeError("this rank is not in the mesh")
    return list(c)


def local_slice(full: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's shard of a full tensor under ``spec`` (a view; mesh dims
    in order, so a dim sharded over (pod, data) splits pod-major)."""
    t = full
    shape = mesh.mesh.shape
    for i, (p, c) in enumerate(zip(spec, _coord(mesh))):
        if isinstance(p, Shard):
            n = t.shape[p.dim] // shape[i]
            t = t.narrow(p.dim, c * n, n)
    return t


def shard(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """Full tensors -> DTensors under ``specs`` (each rank keeps its slice,
    copied contiguous; no communication).  Non-floating 0-d leaves (step
    counts) stay plain tensors."""
    flat_s = flatten_with_paths(specs)

    def one(path, t):
        if t.ndim == 0:
            return t
        loc = local_slice(t, flat_s[path], mesh).contiguous()
        return DTensor.from_local(loc, mesh, flat_s[path], run_check=False,
                                  shape=t.shape, stride=_stride(t.shape))

    return unflatten_from_paths({p: one(p, t) for p, t in
                                 flatten_with_paths(tree).items()})


def _stride(shape) -> tuple:
    out, s = [], 1
    for d in reversed(tuple(shape)):
        out.append(s)
        s *= d
    return tuple(reversed(out))


def is_sharded(t) -> bool:
    return isinstance(t, DTensor)


def local(tree: PyTree) -> PyTree:
    """Each DTensor leaf's local shard (other leaves as they are)."""
    return tree_map(lambda t: t.to_local() if isinstance(t, DTensor) else t,
                    tree)


def specs_of(tree: PyTree) -> PyTree:
    """Each DTensor leaf's placements (None for a plain leaf)."""
    return tree_map(lambda t: tuple(t.placements)
                    if isinstance(t, DTensor) else None, tree)


def rewrap(local_tree: PyTree, like: PyTree) -> PyTree:
    """DTensors of ``local_tree``'s shards with the mesh, placements and
    global shape of ``like``'s leaf at the same path (plain where ``like``
    is plain)."""
    flat_like = flatten_with_paths(like)

    def one(path, t):
        ref = flat_like.get(path)
        if not isinstance(ref, DTensor):
            return t
        return wrap(t, ref.device_mesh, tuple(ref.placements), ref.shape)

    return unflatten_from_paths({p: one(p, t) for p, t in
                                 flatten_with_paths(local_tree).items()})


def reshard_like(full: PyTree, like: PyTree) -> PyTree:
    """Full tensors -> DTensors with the mesh and placements of ``like``'s
    leaf at the same path (each rank keeps its slice; plain where ``like``
    is plain).  A device tensor shaped like a host-resident leaf lands on
    the device mesh (:func:`device_mesh_of`)."""
    flat_like = flatten_with_paths(like)

    def one(path, t):
        ref = flat_like.get(path)
        if not isinstance(ref, DTensor):
            return t
        spec, mesh = tuple(ref.placements), ref.device_mesh
        if t.device.type != mesh.device_type:
            mesh = device_mesh_of(mesh)
        loc = local_slice(t, spec, mesh).contiguous()
        return wrap(loc, mesh, spec, ref.shape)

    return unflatten_from_paths({p: one(p, t) for p, t in
                                 flatten_with_paths(full).items()})


def wrap(loc: torch.Tensor, mesh, spec: tuple, shape) -> DTensor:
    return DTensor.from_local(loc, mesh, spec, run_check=False,
                              shape=torch.Size(shape),
                              stride=_stride(shape))


def wrap_tree(local_tree: PyTree, specs: PyTree, shapes: dict,
              mesh) -> PyTree:
    """DTensors of local shards under ``specs``, with the global shapes
    ``shapes`` ({path: shape}); 0-d leaves stay plain."""
    flat_s = flatten_with_paths(specs)
    return unflatten_from_paths({
        p: t if t.ndim == 0 else wrap(t, mesh, flat_s[p], shapes[p])
        for p, t in flatten_with_paths(local_tree).items()})


def local_tree(full_tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """This rank's contiguous shards of a tree of full tensors."""
    flat_s = flatten_with_paths(specs)
    return unflatten_from_paths({
        p: t if t.ndim == 0 else
        local_slice(t, flat_s[p], mesh).contiguous()
        for p, t in flatten_with_paths(full_tree).items()})


# --------------------------------------------------------------- host mesh

def host_mesh(mesh):
    """The mesh that host-resident shards of ``mesh``'s DTensors live on:
    ``mesh`` itself when its tensors are CPU tensors, else a CPU mesh of
    the same ranks and names that holds placements only (no process
    groups: a host shard is moved back to the device before any
    collective touches it)."""
    if mesh.device_type == "cpu":
        return mesh
    cached = getattr(mesh, "_host_mesh", None)
    if cached is None:
        from torch.distributed.device_mesh import DeviceMesh
        cached = DeviceMesh("cpu", mesh.mesh,
                            mesh_dim_names=mesh.mesh_dim_names,
                            _init_backend=False)
        cached._device_mesh = mesh
        mesh._host_mesh = cached
    return cached


def device_mesh_of(mesh):
    """Inverse of :func:`host_mesh`."""
    return getattr(mesh, "_device_mesh", mesh)


def on_device(t: DTensor) -> DTensor:
    """A DTensor whose shard lies on its device mesh's device."""
    dev_mesh = device_mesh_of(t.device_mesh)
    if dev_mesh is t.device_mesh:
        return t
    loc = t.to_local().to(dev_mesh.device_type, non_blocking=True)
    return wrap(loc, dev_mesh, tuple(t.placements), t.shape)


# ----------------------------------------------------------- collectives

def gather(tree: PyTree) -> PyTree:
    """Every DTensor leaf as its full tensor (an all-gather over the axes
    it shards; a replicated leaf's local tensor as it is, no copy).  A
    collective: every rank of the mesh calls it with the same tree."""
    def one(t):
        if not isinstance(t, DTensor):
            return t
        host = t.device_mesh is not device_mesh_of(t.device_mesh)
        if all(isinstance(p, Replicate) for p in t.placements):
            return t.to_local()
        full = on_device(t).full_tensor()
        return full.cpu() if host else full

    return tree_map(one, tree)


def data_mean_(t: torch.Tensor, mesh) -> torch.Tensor:
    """In place: the mean of ``t`` over the data axes (a sum all-reduce
    per axis, then a divide; gloo has no average)."""
    n = data_size(mesh)
    if n == 1:
        return t
    for a in data_axes(mesh):
        if sizes(mesh)[a] > 1:
            dist.all_reduce(t, group=mesh.get_group(a))
    return t.div_(n)


def model_sum_(t: torch.Tensor, mesh) -> torch.Tensor:
    """In place: the sum of ``t`` over the model axis."""
    if model_size(mesh) > 1:
        dist.all_reduce(t, group=mesh.get_group(_MODEL_AXIS))
    return t


def data_shard(batch: PyTree, mesh) -> PyTree:
    """This rank's rows of a global batch (the batch rule; a leaf whose
    leading dim does not divide stays whole on every rank)."""
    specs = batch_shardings(batch, mesh)
    return local_tree(batch, specs, mesh)


def data_gather(t: torch.Tensor, mesh) -> torch.Tensor:
    """Inverse of :func:`data_shard` for one tensor split by the batch
    rule: every data rank's rows, in the global order, on every rank (an
    all-gather over each data axis above 1, the innermost first).  A
    collective over the data axes."""
    for a in reversed(data_axes(mesh)):
        n = sizes(mesh)[a]
        if n > 1:
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t.contiguous(), group=mesh.get_group(a))
            t = torch.cat(parts)
    return t
