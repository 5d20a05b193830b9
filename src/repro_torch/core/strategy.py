"""Strategy API for HiFT and FPFT training (port of
``repro.core.strategy``).

    strategy = make_strategy("hift", cfg, optimizer, hift=HiFTConfig(m=1),
                             device="cuda")
    state = strategy.init(params)                   # -> TrainState
    state, metrics = strategy.step(state, batch)    # state in, state out

Construction captures everything static (config, model family, optimizer,
device); all training state — params, optimizer bundles, the step counter,
HiFT's visit order — lives in :class:`TrainState`.

Ported strategies (registered in ``repro_torch.core.registry``):

- ``hift``: the paper's Algorithm 1 — one group of m units per step in a
  fixed visit order, per-group optimizer bundles offloaded to pinned host
  memory between visits, Mixed^Hi fp32 masters for the active group only;
- ``hift_pipelined``: ``hift`` with the bundle pipeline on
  (``core.pipeline``): the next group's bundle uploads on a side CUDA
  stream while the current step computes, and the offload drains beside
  the next step; bit-identical to ``hift``, at most ``pipeline_depth``
  bundles on the device;
- ``lisa``: LiSA-style layer sampling — the grouped machinery, with the
  active group re-sampled every ``switch_every`` steps (numpy's
  ``RandomState``, so it samples the reference's groups); pipelined too
  under ``pipeline_depth >= 2``;
- ``fpft``: the full-parameter baseline (all params every step);
- ``fpft_streamed``: ``fpft`` with the optimizer moments in pinned host
  memory, streamed chunk by chunk through a bounded device window during
  the update (``core.pipeline.ChunkStream``); bit-identical to ``fpft``
  with the same stream-safe optimizer;
- ``mezo``: zeroth-order SPSA (``optim.mezo``), two forward passes and no
  gradient, the params perturbed in place; the key rides in
  ``extra["rng"]``;
- ``lomo``: LOMO's fused backward, each layer's gradient consumed by an
  in-place SGD (+ global clip) update as soon as it exists, so no full
  gradient tree is ever resident;
- ``adalomo``: the same fused backward with Adafactor's factored update
  per layer, the factored moments the only optimizer state.

How a grouped step avoids the reference's full-tree copies on the card:
the forward takes each layer from whichever tree holds it
(``grouping.merge_params`` -> ``LayerStack``), only the active leaves
require grad (``torch.autograd.grad`` over them, so no ``.grad`` is left
behind and autograd never holds the frozen tree's gradients), and the
updated group lands in the resident tree in place (:func:`write_back`).

Quantized resident state (:class:`QuantConfig`): under
``frozen="int8"|"nf4"`` HiFT keeps its resident tree codec-encoded
(``dist.quant``) between steps.  Where the reference decodes the whole
frozen tree inside its jitted step, the port decodes nothing beyond the
layer in hand: every frozen projection and the frozen head multiply
through the dequant-matmul kernel, which decodes inside the product.  The
active group trains from an fp32 master in its bundle and is re-encoded
after its update.  ``moments="bf16"`` (HiFT and FPFT) stores the optimizer
moments in bf16.

Cross-pod data parallelism (:class:`CrossPodConfig`, reference
``core/strategy.py:181-306``): the batch splits into ``pods`` chunks whose
gradients are taken one at a time, each passed through the int8
error-feedback codec (``dist.compress``) and summed in fp32; the per-pod
fp32 residuals ride the active group's bundle under ``"ef"`` (grouped
strategies) or ``extra["ef_residual"]`` (``fpft``, ``fpft_streamed``), so
they offload, pipeline and checkpoint with everything else.  ``lomo``,
``adalomo`` and ``mezo`` have no whole gradient tree to compress and
refuse it.

Sharded steps (``mesh=``, a ``torch.distributed`` ``DeviceMesh`` from
``launch.mesh.mesh_from_spec``; one process a device): params and
optimizer state are DTensors under the placement rules of
``dist.shardings`` (``param_sharding_fn(tree, mesh) -> spec tree``
overrides the param rule).  A step gathers the params it reads to full
tensors, runs the forward and backward on the rank's rows of the batch,
takes the mean of each gradient over the data axes, and keeps the rank's
shard of it for the update, which runs on local shards (the fused update
kernels included).  An optimizer whose update couples a leaf's elements
or all leaves (``adafactor``, any ``grad_clip``) updates whole tensors
under a model axis above 1 instead: FPFT gathers the params and the state
and keeps each rank's shard of the result, a grouped strategy keeps the
bundle whole.  The grouped strategies keep their resident tree
replicated, as the reference does, codec records included; the active
group's bundle is sharded over ``model``.  Under quantized residency the
in-step specs are those of the dense tree the active records decode to:
the forward runs on the gathered master, and the updated master is
gathered before it is re-encoded, so the codes are the whole leaf's.
``fpft_streamed`` streams the rank's shards of its moments, held in
pinned host memory on the host mesh; ``lomo``/``adalomo`` with
``stream=`` move each segment's shards through their window.  ``mezo``,
``lomo`` and ``adalomo`` step on the gathered tree (every rank draws the
same noise, reduces each gradient over the data axes as soon as it
exists) and keep their shards.  Each step opens the activation context
(``dist.ctx``), so the moe layer takes its expert-parallel path.  On a
mesh of one rank a step computes exactly what it computes with no mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import (flatten_with_paths, tree_cast,
                                       tree_map, tree_size,
                                       unflatten_from_paths)
from repro_torch.core.grouping import (Group, group_cut, make_groups,
                                       merge_params, order_groups,
                                       split_params)
from repro_torch.core.pipeline import (BundlePipeline, ChunkLayout,
                                       ChunkStream, PipelineStats,
                                       SideStreams, device_put, host_put,
                                       pinned_trees)
from repro_torch.core.registry import register_strategy
from repro_torch.core.scheduler import LRSchedule
from repro_torch.dist import ctx as dctx
from repro_torch.dist import shardings as S
from repro_torch.dist.compress import compress_decompress, init_residuals
from repro_torch.dist.quant import (QUANT_FORMATS, dequantize_tree,
                                    is_quantized, quant_shape, quantize_tree,
                                    tree_logical_size)
from repro_torch.models import get_family
from repro_torch.models.base import (LomoPieces, layer_at, stack_len,
                                     unit_first_depth)
from repro_torch.optim.adafactor import (_moment_at, beta2_at, leaf_update,
                                         moment_init)
from repro_torch.optim.base import (Optimizer, clip_scale, global_sq_norm,
                                    leaves, new_count, rebuild)
from repro_torch.optim.mezo import mezo_step, prng_key
from repro_torch.optim.mixed_precision import FP32, Policy

PyTree = Any
Metrics = dict


# --------------------------------------------------------------- placement
#
# host_put / device_put live in repro_torch.core.pipeline (with the
# BundlePipeline that schedules them off the compute stream); re-exported
# here, their earlier home.


def write_back(params: PyTree, new_active: PyTree, group: Group) -> PyTree:
    """Fold the updated active sub-tree back into the full param tree.

    A stacked leaf that the fused update already wrote in place is left as
    it is; on the card any other is copied into the resident slice
    (``copy_``), so the full tree is never rebuilt; on the CPU the leaf is
    rebuilt functionally and the input tree stays untouched.  A codec
    record folds as its three leaves: the re-encoded group's codes and
    scales are copied into slices of the resident ``q`` and ``s``."""
    taken = {k: lo for k, lo, _ in group.stacked_ranges}

    def fold(full: torch.Tensor, new: torch.Tensor, lo: int) -> torch.Tensor:
        dst = full[lo:lo + new.shape[0]]
        if new.data_ptr() == dst.data_ptr() and new.dtype == dst.dtype:
            return full
        if full.device.type == "cuda":
            with torch.no_grad():
                dst.copy_(new)
            return full
        return torch.cat([full[:lo], new.to(full.dtype),
                          full[lo + new.shape[0]:]])

    out = dict(params)
    for key, sub in new_active.items():
        if key in taken:
            flat_full = flatten_with_paths(params[key])
            flat_new = flatten_with_paths(sub)
            out[key] = unflatten_from_paths(
                {p: fold(flat_full[p], flat_new[p], taken[key])
                 for p in flat_full})
        else:
            out[key] = sub
    return out


def _any_sharded(tree: PyTree) -> bool:
    return any(S.is_sharded(t) for t in flatten_with_paths(tree).values())


def _batch_to(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _value_and_grad(loss_of: Callable, params: PyTree):
    """(loss, grads) of ``loss_of(params)`` w.r.t. every leaf of
    ``params`` — the reference's ``jax.value_and_grad``.  The leaves are
    re-wrapped as fresh autograd leaves sharing their storage, so nothing
    outside ``params`` records a graph and no ``.grad`` is left behind."""
    paths, (flat,) = leaves(params)
    req = [t.detach().requires_grad_(True) for t in flat]
    loss = loss_of(rebuild(paths, req))
    grads = torch.autograd.grad(loss, req)
    return loss.detach(), rebuild(paths, list(grads))


# ----------------------------------------------------------------- configs

@dataclasses.dataclass
class HiFTConfig:
    m: int = 1                        # layers (units) per group
    strategy: str = "bottom2up"       # visit ORDER: bottom2up | top2down | random
    seed: int = 0
    use_cut: bool = True              # detach below the active group
    offload_optimizer: bool = True    # keep inactive opt state on host
    pipeline_depth: int = 1           # max device-resident bundles; >= 2
                                      # moves bundle transfers to side
                                      # streams (core.pipeline) — bit-
                                      # identical to the serial schedule


@dataclasses.dataclass
class LiSAConfig:
    m: int = 1                        # units per sampled group
    switch_every: int = 5             # steps between re-sampling the group
    seed: int = 0
    use_cut: bool = True
    offload_optimizer: bool = True
    pipeline_depth: int = 1           # as HiFTConfig: the sample is a pure
                                      # function of (seed, step), so step+1's
                                      # group can be prefetched too


@dataclasses.dataclass
class MeZOConfig:
    eps: float = 1e-3                 # SPSA perturbation scale
    seed: int = 0                     # default rng when init() gets none


@dataclasses.dataclass
class LOMOConfig:
    grad_clip: float = 1.0            # global-norm clip threshold (0 = off);
                                      # >0 adds the paper's second backward
                                      # sweep to compute the norm first
    weight_decay: float = 0.0         # decoupled, as in optim.sgd


@dataclasses.dataclass
class AdaLomoConfig:
    grad_clip: float = 0.0            # global-norm clip (0 = off, the
                                      # default: the per-matrix update-RMS
                                      # clip below already bounds steps);
                                      # >0 adds LOMO's norm-only sweep
    weight_decay: float = 0.0         # decoupled, inside the leaf update
    eps1: float = 1e-30               # Adafactor's gradient-square epsilon
    clip_threshold: float = 1.0       # per-matrix update-RMS clip d
    decay_rate: float = 0.8           # beta2 schedule 1 - t^-decay_rate
    relative_step: bool = False       # alpha = lr * max(eps2, RMS(p)), RMS
                                      # per trailing matrix (matrix_rms), so
                                      # fused and fallback paths agree
    eps2: float = 1e-3                # relative-step LR floor


@dataclasses.dataclass
class CrossPodConfig:
    """Cross-pod data parallelism: the global batch splits into ``pods``
    equal chunks whose partial gradients are reduced into one update.  With
    ``compress`` each pod's partial passes through the int8 error-feedback
    codec (``dist.compress``) before the reduce, and the per-pod fp32
    residuals become training state (FPFT: ``extra["ef_residual"]``;
    grouped strategies: the active group's bundle under ``"ef"``)."""
    pods: int = 2
    compress: bool = True


@dataclasses.dataclass
class StreamConfig:
    """Chunk-granular state streaming (``core.pipeline.ChunkStream``).

    ``chunk_bytes`` is the byte budget of one stream chunk, measured in the
    layout's base tree (the params; congruent trees of wider dtypes move
    proportionally more bytes a chunk).  ``depth`` is the most chunks of
    each streamed tree on the device: depth-1 chunks of lookahead upload
    while the active chunk's update runs.  Consumed by ``fpft_streamed``
    and by the segment streaming of ``lomo``/``adalomo`` (``depth`` is
    then their segment window; ``chunk_bytes`` does not apply)."""
    chunk_bytes: int = 1 << 20
    depth: int = 2

    def __post_init__(self):
        if self.chunk_bytes <= 0:
            raise ValueError(
                f"stream chunk_bytes must be > 0, got {self.chunk_bytes}")
        if self.depth < 2:
            raise ValueError(
                f"stream depth must be >= 2, got {self.depth}; the serial "
                "(resident) path is plain 'fpft'")


@dataclasses.dataclass
class QuantConfig:
    """Quantized resident state (the reference's ``QuantConfig``).

    ``frozen``: the codec of the grouped strategies' resident tree,
    ``"int8"`` or ``"nf4"`` (``dist.quant``); the tree stays encoded
    between steps and the active group's fp32 master rides its bundle, so
    codec rounding never compounds across revisits.  ``moments``:
    ``"bf16"`` stores the optimizer moments in bf16 (every update computes
    in fp32); ``make_runner`` wires it when the optimizer is given by
    name."""
    frozen: Optional[str] = None
    moments: Optional[str] = None

    def __post_init__(self):
        if self.frozen is not None and self.frozen not in QUANT_FORMATS:
            raise ValueError(
                f"QuantConfig.frozen must be one of {QUANT_FORMATS} or "
                f"None, got {self.frozen!r}")
        if self.moments is not None and self.moments not in ("bf16",
                                                             "bfloat16"):
            raise ValueError(
                "QuantConfig.moments supports 'bf16' (fp32 is the default "
                f"resident moment dtype), got {self.moments!r}")
        if self.frozen is None and self.moments is None:
            raise ValueError(
                "empty QuantConfig: set frozen='int8'|'nf4' and/or "
                "moments='bf16'")

    @property
    def moment_dtype(self) -> Optional[torch.dtype]:
        """The dtype ``moments`` resolves to (None = fp32 default)."""
        return torch.bfloat16 if self.moments else None


def crosspod_reduce(loss_and_grad: Callable, params: PyTree, batch,
                    residuals: PyTree, cross_pod: CrossPodConfig):
    """The cross-pod gradient reduce, with the int8 error-feedback codec
    on the wire when ``cross_pod.compress``.

    The batch splits into ``pods`` equal leading-dim chunks, one a pod;
    each pod's gradient is computed in turn (``loss_and_grad(chunk) ->
    (loss, grads)``), so only one pod's gradient tree is live beside the
    fp32 sum.  Compressed, pod i's partial round-trips through
    ``dist.compress`` with slice i of the stacked ``residuals`` (EF-SGD),
    leaf by leaf.  Returns ``(grads, new_residuals, mean_loss)``: ``sum /
    pods`` in each param's dtype, the new stacked residuals (``residuals``
    as given when compression is off) and the pods' mean loss in fp32.
    On the card the residuals are updated in place (the step consumes its
    input state); on the CPU new ones are returned."""
    pods = cross_pod.pods

    def chunk(x):
        if x.shape[0] % pods:
            raise ValueError(
                f"cross-pod reduce needs a batch divisible by pods={pods}; "
                f"got leading dim {x.shape[0]}")
        return x.reshape((pods, x.shape[0] // pods) + tuple(x.shape[1:]))

    pod_batch = {k: chunk(v) for k, v in batch.items()}
    flat_r = flatten_with_paths(residuals) if cross_pod.compress else {}
    in_place = any(t.device.type == "cuda" for t in flat_r.values())
    new_res = {p: [] for p in flat_r}
    g_sum, l_sum = None, None
    for i in range(pods):
        loss, g = loss_and_grad({k: v[i] for k, v in pod_batch.items()})
        g = flatten_with_paths(g)
        for p in g:
            if cross_pod.compress:
                g[p], r = compress_decompress(g[p], flat_r[p][i])
                if in_place:
                    flat_r[p][i].copy_(r)
                else:
                    new_res[p].append(r)
                del r
            if g_sum is None:
                g[p] = g[p].float()
            else:
                g_sum[p].add_(g[p].float())
        g_sum = g if g_sum is None else g_sum
        l_sum = loss.float() if l_sum is None else l_sum + loss.float()
        del g
    flat_p = flatten_with_paths(params)
    grads = unflatten_from_paths({p: x.div_(pods).to(flat_p[p].dtype)
                                  for p, x in g_sum.items()})
    if cross_pod.compress and not in_place:
        residuals = unflatten_from_paths({
            p: torch.stack(rs) for p, rs in new_res.items()})
    return grads, residuals, l_sum / pods


# -------------------------------------------------------------- TrainState

@dataclasses.dataclass(frozen=True)
class TrainState:
    """The one checkpointable object.

    ``opt_state`` layout is strategy-owned: FPFT holds one optimizer state
    tree, grouped strategies hold ``{str(group_index): bundle}``.
    ``extra`` carries small strategy extras (HiFT's visit order)."""
    params: PyTree
    opt_state: PyTree
    step: Any = 0
    extra: PyTree = dataclasses.field(default_factory=dict)

    def to_tree(self) -> dict:
        """``{"params", "opt_state", "step", "extra"}`` with ``step`` a host
        ``np.int64``.  Synchronises the card first, so bundles still being
        copied to the host are complete when read."""
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return {"params": self.params, "opt_state": self.opt_state,
                "step": np.int64(int(self.step)), "extra": self.extra}

    @classmethod
    def from_tree(cls, tree: dict) -> "TrainState":
        """Inverse of :meth:`to_tree`."""
        return cls(params=tree["params"],
                   opt_state=tree.get("opt_state") or {},
                   step=int(np.asarray(tree["step"])),
                   extra=tree.get("extra") or {})


# ------------------------------------------------------------ Strategy base

class Strategy:
    """Protocol base.  Subclasses implement ``init`` and ``step``.

    **Purity.**  Construction captures everything static; ``init`` is a
    function of ``params`` and ``step`` of ``(state, batch)``.  On the CPU
    both are pure: a step returns new tensors and leaves its input state
    untouched, so re-stepping an old state gives the same result.  On the
    card the step updates the active params and optimizer state in place
    (the reference donates the same buffers on accelerators), so the
    input state is consumed, and a state built from tensors already on the
    card trains those tensors; sequential drivers like ``Runner`` are
    unaffected."""

    name = "base"
    k = 1   # steps per LR cycle (HiFT: number of groups; others: 1)
    offload_optimizer = False   # optimizer state on the host between steps
    # how core.memory_model prices this strategy: analyze(mode=memory_mode,
    # m=memory_m, stream_depth=memory_stream_depth,
    # stream_chunk_bytes=memory_stream_chunk_bytes)
    memory_mode = "fpft"
    memory_m = 1
    memory_stream_depth = 2
    memory_stream_chunk_bytes = 1 << 20
    # what QuantConfig may ask of a strategy: a frozen resident tree to
    # encode (grouped strategies), a moment tree to narrow
    supports_quant_frozen = False
    supports_quant_moments = False
    # whether the step takes a CrossPodConfig (a whole gradient tree to
    # reduce), and why not, appended to the refusal when non-empty
    supports_cross_pod = False
    cross_pod_unsupported_reason = ""

    def __init__(self, cfg, optimizer: Optional[Optimizer], *,
                 schedule: Optional[LRSchedule] = None, policy: Policy = FP32,
                 loss_fn: Optional[Callable] = None, device="cuda",
                 mesh=None, param_sharding_fn: Optional[Callable] = None,
                 cross_pod: Optional[CrossPodConfig] = None,
                 quant: Optional[QuantConfig] = None):
        if cross_pod is not None and not self.supports_cross_pod:
            msg = f"strategy {self.name!r} does not support cross_pod"
            if self.cross_pod_unsupported_reason:
                msg = f"{msg}: {self.cross_pod_unsupported_reason}"
            raise ValueError(msg)
        self.cross_pod = cross_pod
        self.mesh = mesh
        self.param_sharding_fn = param_sharding_fn
        if quant is not None:
            if quant.frozen and not self.supports_quant_frozen:
                raise ValueError(
                    f"strategy {self.name!r} does not support "
                    f"quant.frozen={quant.frozen!r}: only the grouped "
                    "strategies keep a frozen resident tree to encode")
            if quant.moments and not self.supports_quant_moments:
                raise ValueError(
                    f"strategy {self.name!r} does not support "
                    "quant.moments: it keeps no optimizer moment tree")
        self.quant = quant
        self.cfg = cfg
        self.model = get_family(cfg)
        self.optimizer = optimizer
        self.schedule = schedule if schedule is not None else LRSchedule()
        self.policy = policy
        self.loss_fn = loss_fn or self.model.loss_fn
        # the family's loss is a mean over labelled targets; a caller's
        # loss_fn is averaged over the data ranks as it is
        self._token_mean_loss = loss_fn is None
        self.device = resolve_device(device)
        if mesh is not None:
            self._check_mesh()

    # ------------------------------------------------------------ sharding

    def _check_mesh(self) -> None:
        """The mesh's devices must be the strategy's: every option of the
        reference runs under a mesh here too."""
        mesh = self.mesh
        if mesh.device_type != self.device.type:
            raise ValueError(
                f"mesh of {mesh.device_type!r} devices for a strategy on "
                f"{self.device.type!r}; init_distributed(device=...) and "
                "make_runner(device=...) must agree")

    @property
    def _coupled_update(self) -> bool:
        """True when the update must see whole tensors: a model axis above
        1 and an optimizer that couples a leaf's elements (Adafactor's
        factored moments) or all leaves (a global-norm clip)."""
        opt = self.optimizer
        return (self.mesh is not None and S.model_size(self.mesh) > 1
                and opt is not None
                and (opt.name == "adafactor" or bool(opt.grad_clip)))

    def param_shardings(self, tree: PyTree) -> PyTree:
        """The spec tree (``dist.shardings``) a params-shaped tree takes in
        a step: ``param_sharding_fn(tree, mesh)`` when given, else the
        structural rule."""
        if self.param_sharding_fn is not None:
            return self.param_sharding_fn(tree, self.mesh)
        return S.param_shardings(tree, self.mesh)

    def resident_param_shardings(self, tree: PyTree) -> PyTree:
        """Where the full param tree lives between steps (the in-step
        placement; the grouped strategies replicate it)."""
        return self.param_shardings(tree)

    @property
    def _cross_pod_on(self) -> bool:
        return self.cross_pod is not None and self.cross_pod.pods > 1

    def place_params(self, params: PyTree) -> PyTree:
        """``params`` on the device; under a mesh as DTensors on their
        resident placement (each rank keeps its slice)."""
        params = self._place(params)
        if self.mesh is None:
            return params
        return S.shard(params, self.resident_param_shardings(params),
                       self.mesh)

    def _rows(self, batch: dict) -> dict:
        """The batch on the device, as this rank's rows under a mesh (in
        the step's context, where the family's own loss weighs the rank
        by its labelled targets: ``dist.ctx.weigh_by_targets``)."""
        batch = _batch_to(batch, self.device)
        if self.mesh is None:
            return batch
        rows = S.data_shard(batch, self.mesh)
        if self._token_mean_loss and "labels" in rows:
            dctx.weigh_by_targets(rows["labels"])
        return rows

    def _ctx(self):
        """The activation context a step runs in (none without a mesh)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return dctx.activation_sharding(self.mesh, S.data_axes(self.mesh))

    def _grads(self, loss_of: Callable, params: PyTree, batch,
               residuals: PyTree = None):
        """``(grads, residuals, loss)`` of ``loss_of(params, rows)`` over
        the whole ``batch`` (host or device tensors): under a mesh each
        rank differentiates its rows and the loss and gradients are
        averaged over the data axes; under ``cross_pod`` through
        :func:`crosspod_reduce`, one pod chunk at a time."""
        def lg(b):
            loss, g = _value_and_grad(lambda p: loss_of(p, self._rows(b)),
                                      params)
            return dctx.data_mean(loss), dctx.data_mean(g)

        if self._cross_pod_on:
            return crosspod_reduce(lg, params, _batch_to(batch, self.device),
                                   residuals, self.cross_pod)
        loss, grads = lg(batch)
        return grads, residuals, loss

    def init(self, params: PyTree, rng=None) -> TrainState:
        """The strategy's :class:`TrainState` of ``params``.  ``rng`` (a
        2-word uint32 key, the reference's ``PRNGKey``) seeds the
        stochastic strategies (MeZO); the others ignore it."""
        raise NotImplementedError

    def step(self, state: TrainState, batch) -> tuple[TrainState, Metrics]:
        """Advance one training step: the next state and a metrics dict
        with at least ``{"loss", "lr", "strategy"}`` (``loss`` a 0-d
        tensor on the device; a pipelined grouped step on the card
        returns it already read to the host)."""
        raise NotImplementedError

    def lr_at(self, step: int) -> float:
        return self.schedule.delayed(step, self.k)

    def _place(self, params: PyTree) -> PyTree:
        return tree_map(lambda t: t.to(self.device), params)

    def place_state(self, state: TrainState) -> TrainState:
        """A restored state (``train.checkpoint.restore``, or another
        runner's ``to_tree``) with each leaf where this strategy keeps it:
        params on the device in their stored dtype (codec records as
        records); floating optimizer leaves on the device, or in pinned
        host memory where bundles are offloaded on the card; step counts
        as CPU int64; HiFT's ``extra["order"]`` as an int64 numpy
        array and MeZO's ``extra["rng"]`` as a 2-word uint32 numpy array
        (the reference's key).  Synchronises the card first, so host
        buffers that another runner's side streams still write are
        complete."""
        pinned = self.offload_optimizer and self.device.type == "cuda"
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        tree = state.to_tree()
        if _any_sharded(tree):
            # a live sharded state: its full tensors first (a collective)
            state = TrainState.from_tree(S.gather(tree))

        def opt_leaf(t):
            if not t.is_floating_point():
                return t.to(torch.int64)
            return t.pin_memory() if pinned else t.to(self.device)

        extra = dict(state.extra or {})
        if "order" in extra:
            extra["order"] = np.asarray(extra["order"], np.int64)
        if "rng" in extra:
            extra["rng"] = np.asarray(extra["rng"], np.uint32)
        if "ef_residual" in extra:
            extra["ef_residual"] = self._place(extra["ef_residual"])
        placed = TrainState(
            params=tree_map(lambda t: t.to(self.device), state.params),
            opt_state=tree_map(opt_leaf, state.opt_state),
            step=int(state.step), extra=extra)
        return self._sharded(placed)

    def _sharded(self, state: TrainState) -> TrainState:
        """``state`` (full tensors on the device) under this strategy's
        placements: the identity without a mesh."""
        return state if self.mesh is None else self._shard_state(state)

    def _shard_state(self, state: TrainState) -> TrainState:
        """A placed state of full tensors -> DTensors where this strategy
        keeps them under its mesh: here the params on their resident
        placement (a grouped strategy's bundles are sharded at their
        group's next visit)."""
        return dataclasses.replace(state, params=S.shard(
            state.params, self.resident_param_shardings(state.params),
            self.mesh))

    def peak_trainable_params(self, params: PyTree) -> int:
        """Max #params trainable in any single step (paper Fig. 6e)."""
        return tree_size(params)

    def peak_grad_params(self, params: PyTree) -> int:
        """Max #params whose gradient is live at any instant of a step
        (the paper's zeta_3 granularity).  Default: everything trainable
        at once; MeZO has none, the fused backward one grain."""
        return self.peak_trainable_params(params)


# --------------------------------------------------- grouped-step machinery

class _GroupedStrategy(Strategy):
    """Shared machinery for strategies that train ONE Group per step:
    lazy per-group optimizer bundles, host offload, Mixed^Hi masters."""

    use_cut = True
    offload_optimizer = True
    memory_mode = "hift"
    supports_quant_frozen = True
    supports_quant_moments = True
    supports_cross_pod = True

    @property
    def _quant_frozen(self) -> Optional[str]:
        return self.quant.frozen if self.quant is not None else None

    def resident_param_shardings(self, tree: PyTree) -> PyTree:
        # between steps the tree is mostly frozen weights: replicated, so a
        # step's frozen majority moves no data
        return S.replicated(tree, self.mesh)

    def _setup_groups(self, m: int) -> None:
        self.units = self.model.unit_spec(self.cfg)
        self.groups = make_groups(self.units, m)
        self.k = len(self.groups)
        self.memory_m = m
        self._pipeline: Optional[BundlePipeline] = None

    def _setup_pipeline(self, depth: int) -> None:
        """Turn the bundle pipeline (``core.pipeline``) on when ``depth``
        >= 2 and there is something to overlap (offloading on, more than
        one group).  The memory accounting becomes mode ``hift_pipelined``
        with a ``depth``-bundle device window."""
        if depth <= 1 or not self.offload_optimizer or self.k <= 1:
            return
        self._pipeline = BundlePipeline(depth, device=self.device)
        self.memory_mode = "hift_pipelined"
        self.memory_stream_depth = depth

    @property
    def pipeline_stats(self) -> Optional[PipelineStats]:
        """The bundle pipeline's counters, or None when serial."""
        return self._pipeline.stats if self._pipeline is not None else None

    def _resident_params(self, params: PyTree) -> PyTree:
        """The policy-cast resident tree on the device: bf16 under Mixed^Hi
        (fp32 masters ride the bundles), fp32 under fp32 and mixed, the
        policy's param dtype otherwise — then, under
        ``QuantConfig(frozen=...)``, codec-encoded on the device."""
        params = self._place(params)
        policy = self.policy
        if policy.master_active_group_only:
            params = tree_cast(params, torch.bfloat16)
        elif not (policy.master_fp32 or policy.name == "fp32"):
            params = tree_cast(params, policy.param_dtype)
        if self._quant_frozen is not None:
            params = quantize_tree(params, self._quant_frozen)
        if self.mesh is not None:
            params = S.shard(params, S.replicated(params, self.mesh),
                             self.mesh)
        return params

    def _cut(self, group: Group) -> Optional[int]:
        if not self.use_cut:
            return None
        return group_cut(self.cfg, group, unit_first_depth)

    def _init_bundle(self, active: PyTree) -> PyTree:
        """A group's optimizer bundle, created on its first visit (on the
        device).  Under quantized residency it carries an fp32 master
        decoded from the group's first-visit codes; under Mixed^Hi one cast
        from the group's bf16 params."""
        if self._quant_frozen is not None:
            master = tree_cast(dequantize_tree(active), torch.float32)
            bundle = {"opt": self.optimizer.init(master), "master": master}
        elif self.policy.master_active_group_only:
            master = tree_cast(active, torch.float32)
            bundle = {"opt": self.optimizer.init(master), "master": master}
        else:
            bundle = {"opt": self.optimizer.init(active)}
        if self._cross_pod_on and self.cross_pod.compress:
            # the group's per-pod EF residuals ride its bundle, so offload,
            # pipelining and checkpoints cover them
            bundle["ef"] = init_residuals(bundle.get("master", active),
                                          self.cross_pod.pods)
        return bundle

    def _train_group(self, gi: int, active: PyTree, frozen: PyTree,
                     bundle: PyTree, batch, lr: float,
                     local: Callable = lambda tree: tree,
                     full: Callable = lambda tree: tree):
        """One group's step on full ``active``/``frozen`` trees; returns
        the full updated active tree.  Under a mesh ``bundle`` holds the
        rank's shards (its ``"ef"`` the full residuals), ``local(tree)``
        takes the rank's shard of a tree shaped like the group's dense
        params and ``full(tree)`` gathers such shards back: the gradients
        and the params are cut before the update, which runs on shards,
        and the master the forward reads and the updated params are
        gathered."""
        group = self.groups[gi]
        cut = self._cut(group)
        cfg, opt, policy = self.cfg, self.optimizer, self.policy

        def loss_of(a, rows):
            return self.loss_fn(cfg, merge_params(a, frozen, group), rows,
                                cut=cut, compute_dtype=policy.compute_dtype)

        qf = self._quant_frozen
        # under quantized residency the active group computes from its
        # whole master (the frozen records stay encoded; the forward
        # multiplies through their views)
        work = active if qf is None else tree_cast(full(bundle["master"]),
                                                   policy.param_dtype)
        grads, ef, loss = self._grads(loss_of, work, batch, bundle.get("ef"))
        grads = local(grads)
        ef = {"ef": ef} if "ef" in bundle else {}
        if "master" in bundle:
            # grads are w.r.t. the working params; the fp32 master takes the
            # update and the resident slice its cast, re-encoded if quant
            # from the whole leaf (a shard's bounds would cut scale tiles)
            new_master, new_st = opt.update(grads, bundle["opt"],
                                            bundle["master"], lr)
            new_active = full(tree_cast(new_master, policy.param_dtype))
            if qf is not None:
                new_active = quantize_tree(new_active, qf)
            return new_active, {"opt": new_st, "master": new_master,
                                **ef}, loss
        new_active, new_st = opt.update(grads, bundle["opt"], local(active),
                                        lr)
        return full(new_active), {"opt": new_st, **ef}, loss

    def _step_specs(self, active: PyTree) -> tuple[PyTree, dict]:
        """``(specs, shapes)`` of the active group in a sharded step: the
        param rule (or ``param_sharding_fn``) on the dense tree the group
        trains — under quantized residency the master-shaped tree its
        records decode to, as meta tensors — and its global shapes by path.
        Every leaf replicates where the update couples elements
        (``_coupled_update``): the bundle stays whole."""
        dense = tree_map(
            lambda r: torch.empty(quant_shape(r), dtype=r["t"].dtype,
                                  device="meta") if is_quantized(r) else r,
            active, is_leaf=is_quantized)
        specs = (S.replicated(dense, self.mesh) if self._coupled_update
                 else self.param_shardings(dense))
        return specs, {p: tuple(t.shape) for p, t in
                       flatten_with_paths(dense).items()}

    def _bundle_specs(self, bundle: PyTree, shapes: dict,
                      a_specs: PyTree) -> PyTree:
        """A bundle's specs: its moments and master mirror the active
        group's in-step specs (``_step_specs``), its ``"ef"`` the same
        shifted past the pods dim."""
        return S.mirror_specs(bundle, shapes, flatten_with_paths(a_specs),
                              self.mesh)

    def _group_step(self, state: TrainState, batch, gi: int, lr: float,
                    next_gis: Optional[list] = None):
        group = self.groups[gi]
        mesh = self.mesh
        # under a mesh the resident tree is replicated: its local tensors
        # are the full tree
        params = state.params if mesh is None else S.local(state.params)
        active, frozen = split_params(params, group)
        key = str(gi)
        stored = state.opt_state.get(key)
        pipe = self._pipeline
        if stored is None:
            bundle = self._init_bundle(active)
        elif not self.offload_optimizer:
            bundle = stored
        elif pipe is not None:
            # usually a hit on the copy prefetched during the previous step
            bundle = pipe.fetch(key, stored)
        else:
            bundle = device_put(stored, self.device)
        local = full = lambda tree: tree      # noqa: E731
        if mesh is not None:
            a_specs, shapes = self._step_specs(active)
            if not _any_sharded(bundle):
                # a new bundle, or a restored host one: shard it
                bundle = S.shard(bundle,
                                 self._bundle_specs(bundle, shapes, a_specs),
                                 mesh)
            like = bundle
            bundle = S.local(bundle)
            if "ef" in like:
                bundle["ef"] = S.gather(like["ef"])
            local = lambda tree: S.local_tree(tree, a_specs, mesh)  # noqa
            # shards back to full tensors (a replicated leaf's own tensor:
            # at a model size of 1 nothing is copied)
            full = lambda tree: S.gather(  # noqa: E731
                S.wrap_tree(tree, a_specs, shapes, mesh))
        with self._ctx():
            new_active, new_bundle, loss = self._train_group(
                gi, active, frozen, bundle, batch, lr, local=local,
                full=full)
        if mesh is not None:
            ef = new_bundle.pop("ef", None)
            new_bundle = S.rewrap(new_bundle, like)
            if ef is not None:
                new_bundle["ef"] = S.reshard_like(ef, like["ef"])
        if pipe is not None and next_gis:
            # the step above is enqueued, not done: start the coming
            # groups' uploads now so they run beside its compute (depth-1
            # visits ahead; the budget blocks or evicts past that).
            # First visits have no bundle yet; a revisit of gi inside the
            # window is skipped (its bundle is the one this step updates).
            seen = {gi}
            for ngi in next_gis:
                if ngi in seen:
                    continue
                seen.add(ngi)
                nbundle = state.opt_state.get(str(ngi))
                if nbundle is not None and not pipe.holds(str(ngi), nbundle):
                    pipe.prefetch(str(ngi), nbundle)
        if pipe is not None and pipe.on_card:
            # read the loss before the offload is enqueued: a read after it
            # waits behind the bundle's device-to-host copies in the copy
            # engine, holding the host — and the next step — until they
            # drain (measured on the card: chip_smoke.py train_pipelined)
            loss = loss.cpu()
        if self.offload_optimizer:
            new_bundle = (pipe.offload(key, new_bundle, into=stored)
                          if pipe is not None
                          else host_put(new_bundle, into=stored))
        opt_state = dict(state.opt_state)
        opt_state[key] = new_bundle
        new_params = write_back(params, new_active, group)
        if mesh is not None:
            new_params = S.rewrap(new_params, state.params)
        return new_params, opt_state, loss

    def peak_trainable_params(self, params: PyTree) -> int:
        # a codec record counts as the leaf it encodes
        return max(tree_logical_size(split_params(params, g)[0])
                   for g in self.groups)

    def group_at(self, state: TrainState, step: Optional[int] = None) -> Group:
        raise NotImplementedError


# ------------------------------------------------------------------- HiFT

@register_strategy("hift")
class HiFTStrategy(_GroupedStrategy):
    """Paper Algorithm 1.  Per training step exactly ONE group is active:
    gradients and optimizer state exist only for its sub-tree, the
    backward is cut below it, inactive bundles stay on the host, and the
    LR advances once per sweep."""

    name = "hift"

    def __init__(self, cfg, optimizer, *, hift: Optional[HiFTConfig] = None,
                 **kw):
        super().__init__(cfg, optimizer, **kw)
        self.hift = hift if hift is not None else HiFTConfig()
        self.use_cut = self.hift.use_cut
        self.offload_optimizer = self.hift.offload_optimizer
        self._setup_groups(self.hift.m)
        self._setup_pipeline(self.hift.pipeline_depth)
        self.order = order_groups(self.groups, self.hift.strategy,
                                  self.hift.seed)

    def init(self, params: PyTree, rng=None) -> TrainState:
        return TrainState(self._resident_params(params), {}, 0,
                          {"order": np.asarray(self.order, np.int64)})

    def _order_at(self, state: TrainState) -> list[int]:
        # the visit order is state: it survives a restore into a runner
        # built with another seed
        order = state.extra.get("order") if state.extra else None
        if order is None:
            return list(self.order)
        return [int(x) for x in np.asarray(order).reshape(-1)]

    def group_at(self, state: TrainState, step: Optional[int] = None) -> Group:
        step = int(state.step) if step is None else step
        return self.groups[self._order_at(state)[step % self.k]]

    def step(self, state: TrainState, batch) -> tuple[TrainState, Metrics]:
        step = int(state.step)
        order = self._order_at(state)
        gi = order[step % self.k]
        # the sweep order makes the next depth-1 groups knowable now: the
        # pipeline prefetches them while this step computes
        next_gis = ([order[(step + d) % self.k]
                     for d in range(1, self._pipeline.depth)]
                    if self._pipeline else None)
        lr = self.schedule.delayed(step, self.k)
        params, opt_state, loss = self._group_step(state, batch, gi, lr,
                                                   next_gis=next_gis)
        new_state = TrainState(params, opt_state, step + 1, state.extra)
        return new_state, {"loss": loss, "lr": lr, "strategy": self.name,
                           "group": self.groups[gi].label()}


@register_strategy("hift_pipelined")
class PipelinedHiFTStrategy(HiFTStrategy):
    """HiFT with the bundle pipeline on by default (``core.pipeline``):
    group g+1's bundle uploads on a side stream while group g's step
    computes, and g's offload drains beside g+1 — bit-identical states,
    the transfers off the compute stream.  At most ``pipeline_depth``
    (default 2) bundles are on the device (``memory_model`` mode
    ``hift_pipelined``).  Checkpoints are interchangeable with plain
    ``hift``: the pipeline is a transfer cache, not state."""

    name = "hift_pipelined"

    def __init__(self, cfg, optimizer, *, hift: Optional[HiFTConfig] = None,
                 **kw):
        hift = hift if hift is not None else HiFTConfig()
        if hift.pipeline_depth < 2:
            hift = dataclasses.replace(hift, pipeline_depth=2)
        super().__init__(cfg, optimizer, hift=hift, **kw)


# ------------------------------------------------------------------- LiSA

@register_strategy("lisa")
class LiSAStrategy(_GroupedStrategy):
    """Random layer-subset fine-tuning, LiSA-style: every ``switch_every``
    steps the active group is re-sampled uniformly (with replacement)
    instead of swept in HiFT's fixed order.  The sample is a pure function
    of ``(seed, step)`` — numpy's ``RandomState``, seeded as the reference
    seeds it, so both packages sample the same groups — and checkpoint
    resume replays the schedule exactly; the per-group bundles persist
    across activations.  The state carries no visit order."""

    name = "lisa"

    def __init__(self, cfg, optimizer, *, lisa: Optional[LiSAConfig] = None,
                 **kw):
        super().__init__(cfg, optimizer, **kw)
        self.lisa = lisa if lisa is not None else LiSAConfig()
        self.use_cut = self.lisa.use_cut
        self.offload_optimizer = self.lisa.offload_optimizer
        self._setup_groups(self.lisa.m)
        self._setup_pipeline(self.lisa.pipeline_depth)

    def lr_at(self, step: int) -> float:
        # LiSA trains on a plain per-step schedule (no sweep structure)
        return self.schedule.at_cycle(step)

    def group_index_at(self, step: int) -> int:
        period = step // max(self.lisa.switch_every, 1)
        mix = (self.lisa.seed * 1_000_003 + period) % (2**31 - 1)
        return int(np.random.RandomState(mix).randint(self.k))

    def group_at(self, state: TrainState, step: Optional[int] = None) -> Group:
        step = int(state.step) if step is None else step
        return self.groups[self.group_index_at(step)]

    def init(self, params: PyTree, rng=None) -> TrainState:
        return TrainState(self._resident_params(params), {}, 0, {})

    def step(self, state: TrainState, batch) -> tuple[TrainState, Metrics]:
        step = int(state.step)
        gi = self.group_index_at(step)
        # the next depth-1 samples are knowable now; the pipeline skips the
        # prefetch when the sampler lands back on gi inside the window
        next_gis = ([self.group_index_at(step + d)
                     for d in range(1, self._pipeline.depth)]
                    if self._pipeline else None)
        lr = self.lr_at(step)
        params, opt_state, loss = self._group_step(state, batch, gi, lr,
                                                   next_gis=next_gis)
        new_state = TrainState(params, opt_state, step + 1, state.extra)
        return new_state, {"loss": loss, "lr": lr, "strategy": self.name,
                           "group": self.groups[gi].label()}


# ------------------------------------------------------------------- FPFT

@register_strategy("fpft")
class FPFTStrategy(Strategy):
    """Standard full-parameter fine-tuning — the paper's baseline."""

    name = "fpft"
    # every param trains every step (no frozen tree to encode), but the
    # moment tree may be narrowed
    supports_quant_moments = True
    supports_cross_pod = True

    def init(self, params: PyTree, rng=None) -> TrainState:
        params = self._place(params)
        if self.policy.name == "bf16":
            params = tree_cast(params, self.policy.param_dtype)
        extra = {}
        if self._cross_pod_on and self.cross_pod.compress:
            # per-pod EF residuals are training state: they checkpoint (and
            # resize) with everything else
            extra["ef_residual"] = init_residuals(params, self.cross_pod.pods)
        return self._sharded(TrainState(params, self.optimizer.init(params),
                                        0, extra))

    def _mirror(self, tree: PyTree, params: PyTree, specs: PyTree) -> PyTree:
        return S.mirror_specs(tree, {p: tuple(t.shape) for p, t in
                                     flatten_with_paths(params).items()},
                              flatten_with_paths(specs), self.mesh)

    def _shard_state(self, state: TrainState) -> TrainState:
        """The params under the param rule, the optimizer state and EF
        residuals mirroring it."""
        specs = self.param_shardings(state.params)
        extra = dict(state.extra or {})
        if "ef_residual" in extra:
            extra["ef_residual"] = S.shard(
                extra["ef_residual"],
                self._mirror(extra["ef_residual"], state.params, specs),
                self.mesh)
        return TrainState(
            S.shard(state.params, specs, self.mesh),
            S.shard(state.opt_state,
                    self._mirror(state.opt_state, state.params, specs),
                    self.mesh),
            state.step, extra)

    def _update(self, params: PyTree, grads: PyTree, opt_state: PyTree,
                lr: float):
        return self.optimizer.update(grads, opt_state, params, lr)

    def step(self, state: TrainState, batch) -> tuple[TrainState, Metrics]:
        step = int(state.step)
        lr = self.schedule.at_cycle(step)
        cfg, dtype, mesh = self.cfg, self.policy.compute_dtype, self.mesh
        extra = state.extra
        res = (extra or {}).get("ef_residual")
        params = state.params
        whole = params if mesh is None else S.gather(params)
        with self._ctx():
            grads, new_res, loss = self._grads(
                lambda p, rows: self.loss_fn(cfg, p, rows,
                                             compute_dtype=dtype),
                whole, batch,
                res if mesh is None or res is None else S.gather(res))
        if res is not None:
            extra = dict(extra)
            extra["ef_residual"] = S.reshard_like(new_res, res)
        if mesh is None:
            params, opt_state = self._update(params, grads, state.opt_state,
                                             lr)
        elif self._coupled_update:
            # the update couples elements across shards: it runs on the
            # whole params and state, and each rank keeps its shard
            new_p, new_o = self._update(whole, grads,
                                        S.gather(state.opt_state), lr)
            params = S.reshard_like(new_p, params)
            opt_state = S.reshard_like(new_o, state.opt_state)
        else:
            grads = S.local_tree(grads, S.specs_of(params), mesh)
            new_p, new_o = self._update(S.local(params), grads,
                                        S.local(state.opt_state), lr)
            params = S.rewrap(new_p, params)
            opt_state = S.rewrap(new_o, state.opt_state)
        return (TrainState(params, opt_state, step + 1, extra),
                {"loss": loss, "lr": lr, "strategy": self.name})


# --------------------------------------------------------- FPFT (streamed)

@register_strategy("fpft_streamed")
class StreamedFPFTStrategy(FPFTStrategy):
    """ChunkFT-style full-parameter fine-tuning: FPFT's update with the
    optimizer moments in host memory (pinned, on the card), streamed
    through a bounded device window during the update.

    A step is a backward over the whole tree, then a loop over the
    :class:`ChunkLayout` of the params: for chunk i the stream uploads the
    congruent moment slices (``m``/``v`` for AdamW) while chunks
    ``i+1..i+depth-1`` upload behind them on the side stream, one
    elementwise ``optimizer.update`` advances the chunk, and the updated
    moments drain back to the host.  Optimizer state on the device is
    bounded by ``depth * chunk_bytes`` per streamed tree (``memory_model``
    mode ``fpft_streamed``) instead of the whole moment trees.

    Requires a stream-safe optimizer (``Optimizer.stream_safe``): an
    elementwise update with no cross-leaf coupling, so the per-chunk update
    is the resident one's arithmetic — bit-identical to ``fpft``, and
    checkpoints are interchangeable with it.  A global grad clip and the
    fused kernels (which bucket whole trees) are rejected at construction.

    On the card the step writes in place: each updated param chunk is
    copied into its param views and each moment chunk into its host views,
    so no second copy of the params or of the moments exists; a packed
    chunk (small leaves) moves piece by piece.  On the CPU the step is
    pure, as the reference's.  Scalar state (AdamW's ``count``) rides
    every chunk call and keeps the last one's value — each chunk sees the
    same pre-step count, as the resident update does.

    Under ``mesh=`` the params take FPFT's placements and the moments are
    the rank's shards, mirroring the params' specs, held pinned as
    DTensors on the host mesh; a step builds its layout over the rank's
    local params and streams their chunks.  The reference chunks the
    global tree and splits each window over ``model``
    (``chunk_window_shardings``); the update is elementwise, so both give
    the same values (ROADMAP, deliberate differences).  The state stays
    checkpoint-interchangeable with ``fpft`` under the same mesh."""

    name = "fpft_streamed"
    memory_mode = "fpft_streamed"

    def __init__(self, cfg, optimizer, *, stream: Optional[StreamConfig] = None,
                 **kw):
        super().__init__(cfg, optimizer, **kw)
        self.stream = stream if stream is not None else StreamConfig()
        if not getattr(optimizer, "stream_safe", False):
            raise ValueError(
                "fpft_streamed needs a stream-safe optimizer (elementwise "
                "update with no cross-leaf coupling; Optimizer.stream_safe) "
                f"— got {getattr(optimizer, 'name', optimizer)!r} with "
                "stream_safe=False.  Turn off grad_clip / the fused-kernel "
                "path, or use the resident 'fpft' strategy")
        self.memory_stream_depth = self.stream.depth
        self.memory_stream_chunk_bytes = self.stream.chunk_bytes
        self._streams = (SideStreams(self.device)
                         if self.device.type == "cuda" else None)
        # the last step's ChunkStream counters (observability only)
        self.stream_stats: Optional[PipelineStats] = None

    @staticmethod
    def _split_state(opt_state: PyTree, params: PyTree) -> tuple[dict, dict]:
        """Partition ``opt_state`` into params-congruent subtrees (the same
        paths and leaf shapes — AdamW's ``m``/``v``; these stream) and the
        rest (scalars like ``count``; these ride every chunk call)."""
        pshapes = {p: tuple(t.shape)
                   for p, t in flatten_with_paths(params).items()}
        streamed, resident = {}, {}
        for key, sub in opt_state.items():
            shapes = ({p: tuple(t.shape)
                       for p, t in flatten_with_paths(sub).items()}
                      if isinstance(sub, dict) else None)
            (streamed if shapes == pshapes else resident)[key] = sub
        return streamed, resident

    def _pinned(self, streamed: dict) -> dict:
        """Empty pinned host trees like ``streamed``'s, in one buffer
        (``core.pipeline.pinned_trees``)."""
        keys = sorted(streamed)
        return dict(zip(keys, pinned_trees([streamed[k] for k in keys])))

    def _on_host_mesh(self, host: dict, params: PyTree) -> dict:
        """Under a mesh, pinned trees of the rank's shards as DTensors on
        the host mesh (``dist.shardings.host_mesh``), each leaf with the
        placements and global shape of ``params``' leaf at its path; the
        trees as they are without a mesh."""
        if self.mesh is None:
            return host
        flat_p = flatten_with_paths(params)

        def one(path, t):
            ref = flat_p[path]
            return S.wrap(t, S.host_mesh(ref.device_mesh),
                          tuple(ref.placements), ref.shape)

        return {key: unflatten_from_paths({
            p: one(p, t) for p, t in flatten_with_paths(tree).items()})
            for key, tree in host.items()}

    def init(self, params: PyTree, rng=None) -> TrainState:
        if self.device.type == "cpu":
            return super().init(params)    # host_put is the identity here
        params = self._place(params)
        if self.policy.name == "bf16":
            params = tree_cast(params, self.policy.param_dtype)
        extra = {}
        if self._cross_pod_on and self.cross_pod.compress:
            extra["ef_residual"] = init_residuals(params, self.cross_pod.pods)
        # under a mesh the params and residuals take FPFT's placements and
        # the moments are made for the rank's shards
        state = self._sharded(TrainState(params, {}, 0, extra))
        own = S.local(state.params)
        # the card: the moment trees' layout from an init on meta tensors,
        # then each leaf's state made on the device and copied into its
        # pinned view, so no device copy of a whole moment tree exists
        meta = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"), own)
        streamed, resident = self._split_state(self.optimizer.init(meta),
                                               meta)
        host = self._pinned(streamed)
        views = {k: flatten_with_paths(t) for k, t in host.items()}
        for path, leaf in flatten_with_paths(own).items():
            one = {"x": leaf}
            st, _ = self._split_state(self.optimizer.init(one), one)
            for key, view in views.items():
                view[path].copy_(st[key]["x"], non_blocking=True)
        return dataclasses.replace(state, opt_state={
            **resident, **self._on_host_mesh(host, state.params)})

    def place_state(self, state: TrainState) -> TrainState:
        """As :meth:`Strategy.place_state`, with the streamed moment trees
        in one pinned buffer on the card (under a mesh the rank's shards,
        on the host mesh)."""
        streamed, resident = self._split_state(state.opt_state, state.params)
        card = self.device.type == "cuda"
        if card:
            streamed = _gathered(streamed)
        placed = super().place_state(dataclasses.replace(
            state, opt_state=resident if card else state.opt_state))
        if not card:
            return placed
        if self.mesh is not None:
            specs = S.specs_of(placed.params)
            streamed = {key: S.local_tree(tree, specs, self.mesh)
                        for key, tree in streamed.items()}
        host = self._pinned(streamed)
        for key, tree in host.items():
            src = flatten_with_paths(streamed[key])
            for path, view in flatten_with_paths(tree).items():
                view.copy_(src[path])
        return dataclasses.replace(placed, opt_state={
            **placed.opt_state, **self._on_host_mesh(host, placed.params)})

    def _streamed_update(self, params: PyTree, grads: PyTree,
                         opt_state: PyTree, lr: float):
        """The chunked update sweep; returns ``(new_params,
        new_opt_state)``, bit-identical to ``optimizer.update(grads,
        opt_state, params, lr)``."""
        layout = ChunkLayout.build(params, self.stream.chunk_bytes)
        streamed, resident = self._split_state(opt_state, params)
        skeys = sorted(streamed)
        stream = ChunkStream(layout, depth=self.stream.depth,
                             device=self.device, streams=self._streams)
        stream.begin(*(streamed[key] for key in skeys))
        card = self.device.type == "cuda"
        flat_p, flat_g = layout.flat(params), layout.flat(grads)
        p_chunks, new_resident = [], dict(resident)
        for i in range(layout.num_chunks):
            schunks = stream.fetch(i)
            st = {key: {"_c": c} for key, c in zip(skeys, schunks)}
            st.update(resident)
            new_p, new_st = self.optimizer.update(
                {"_c": layout.extract(flat_g, i)}, st,
                {"_c": layout.extract(flat_p, i)}, lr)
            if card:
                layout.write(flat_p, i, new_p["_c"])
            else:
                p_chunks.append(new_p["_c"])
            for key in resident:
                new_resident[key] = new_st[key]
            stream.offload(i, tuple(new_st[key]["_c"] for key in skeys))
        self.stream_stats = stream.stats
        new_opt = dict(new_resident)
        new_opt.update(zip(skeys, stream.end()))
        return (params if card else layout.combine(p_chunks)), new_opt

    def _update(self, params: PyTree, grads: PyTree, opt_state: PyTree,
                lr: float):
        return self._streamed_update(params, grads, opt_state, lr)


# ------------------------------------------------------------------- MeZO

@register_strategy("mezo")
class MeZOStrategy(Strategy):
    """Zeroth-order SPSA fine-tuning (MeZO, Malladi et al. 2023): two
    forward passes, no backward, no optimizer state — memory ~= inference
    (``optim.mezo``).  ``opt_state`` stays empty and the key rides in
    ``extra["rng"]`` (the reference's 2-word uint32 key); each step's z is
    regenerated from ``(key, step)``, so resume is exact.  The step
    perturbs the params in place on the card; on the CPU it perturbs a
    copy, leaving its input state untouched.

    ``noise``: a seam that holds the port to the reference and the card to
    the CPU, ``noise(rng, step) -> (path, index) -> z``; it replaces the
    generator of ``optim.mezo.mezo_step`` and is never the default."""

    name = "mezo"
    memory_mode = "mezo"

    def __init__(self, cfg, optimizer=None, *,
                 mezo: Optional[MeZOConfig] = None,
                 noise: Optional[Callable] = None, **kw):
        super().__init__(cfg, optimizer, **kw)
        self.mezo = mezo if mezo is not None else MeZOConfig()
        self._noise = noise
        self._stacked = tuple(u.key for u in self.model.unit_spec(cfg)
                              if u.kind == "stacked")

    def init(self, params: PyTree, rng=None) -> TrainState:
        if rng is None:
            rng = prng_key(self.mezo.seed)
        return TrainState(self.place_params(params), {}, 0,
                          {"rng": np.asarray(rng, np.uint32)})

    def step(self, state: TrainState, batch) -> tuple[TrainState, Metrics]:
        step = int(state.step)
        rng = np.asarray(state.extra["rng"], np.uint32)
        lr = self.schedule.at_cycle(step)
        cfg, dtype = self.cfg, self.policy.compute_dtype
        # under a mesh every rank perturbs the gathered tree with the same
        # z, averages its rows' losses over the data axes, and keeps its
        # shard of the update
        with self._ctx():
            params, loss = mezo_step(
                lambda p, b: dctx.data_mean(
                    self.loss_fn(cfg, p, b, compute_dtype=dtype)),
                _own(_gathered(state.params)), self._rows(batch),
                (*(int(w) for w in rng), step), lr, self.mezo.eps,
                stacked=self._stacked,
                noise=self._noise(rng, step) if self._noise else None)
        params = S.reshard_like(params, state.params)
        return (TrainState(params, state.opt_state, step + 1, state.extra),
                {"loss": loss, "lr": lr, "strategy": self.name})

    def peak_grad_params(self, params: PyTree) -> int:
        return 0            # two forward passes, no backward at all


def _gathered(tree: PyTree) -> PyTree:
    """The full tensors of a (possibly) sharded tree."""
    return S.gather(tree) if _any_sharded(tree) else tree


def _own(tree: PyTree) -> PyTree:
    """The tree a step may update in place: the tree itself on the card
    (the step consumes its input state), a copy on the CPU (the step is
    pure there)."""
    leaves_ = list(flatten_with_paths(tree).values())
    if leaves_ and leaves_[0].device.type == "cpu":
        return tree_map(torch.clone, tree)
    return tree


# ----------------------------------------------------- fused backward: LOMO
#
# The reference's fused backward is a forward scan that saves each layer's
# input and a hand-rolled reverse scan whose body runs one layer's vjp and
# consumes its gradient at once.  Here: the forward runs without a graph,
# saving each layer's input; one graph covers the head and the loss; the
# reverse loop recomputes one layer under autograd, takes its gradient
# with ``torch.autograd.grad``, updates the layer's slice of the stacked
# leaves in place and drops the graph.  At any instant one layer's
# gradient and graph are live.  Under ``grad_clip > 0`` a norm-only sweep
# runs first (the head's graph retained for the second), and the clip
# scale stays a device tensor: nothing is read back inside a step.

def _sq(tree: PyTree):
    """Squared norm of a gradient tree (0 for None)."""
    return global_sq_norm(tree) if tree is not None else 0.0


def _tadd(a, b):
    """Leafwise add of two trees (or tensors), None-transparent."""
    if a is None:
        return b
    if b is None:
        return a
    if isinstance(a, torch.Tensor):
        return a + b
    fb = flatten_with_paths(b)
    return unflatten_from_paths({p: x + fb[p] for p, x in
                                 flatten_with_paths(a).items()})


class _Leaves:
    """Autograd leaves sharing ``tree``'s storage (``tree`` may be None).
    Gradients come from ``torch.autograd.grad``, so no ``.grad`` is left
    behind and an in-place update of ``tree`` after the call is safe."""

    def __init__(self, tree: PyTree):
        self.paths, self.list, self.tree = [], [], None
        if tree is not None:
            self.paths, (flat,) = leaves(tree)
            self.list = [t.detach().requires_grad_(True) for t in flat]
            self.tree = rebuild(self.paths, self.list)

    def grads(self, gs) -> Optional[PyTree]:
        """The tree of ``gs`` (one per leaf, None = unused, a zero); None
        when no leaf was used."""
        if not self.paths or all(g is None for g in gs):
            return None
        return rebuild(self.paths, [torch.zeros_like(t) if g is None else g
                                    for t, g in zip(self.list, gs)])


def _save_inputs(fn: Callable, stack: PyTree, h: torch.Tensor):
    """Run ``h`` through every layer of ``stack`` (``fn(layer_p, h)``)
    without a graph: ``(each layer's input, the output)``."""
    saved = []
    with torch.no_grad():
        for j in range(stack_len(stack)):
            saved.append(h)
            h = fn(layer_at(stack, j), h)
    return saved, h


def _head(head_loss_fn: Callable, hp: PyTree, emb: _Leaves,
          h: torch.Tensor, batch):
    """The one graph over ``(head_p, embed_p, h_out)``: ``(loss, vjp)``
    with ``vjp(retain) -> (g_head, g_embed_from_head, dh)``;
    ``g_embed_from_head`` is None for an untied head."""
    head = _Leaves(hp)
    h = h.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = head_loss_fn(head.tree, emb.tree, h, batch)

    def vjp(retain: bool):
        nh, ne = len(head.list), len(emb.list)
        gs = torch.autograd.grad(loss, head.list + emb.list + [h],
                                 allow_unused=True, retain_graph=retain)
        return (dctx.data_mean(head.grads(gs[:nh])),
                dctx.data_mean(emb.grads(gs[nh:nh + ne])), gs[-1])

    return dctx.data_mean(loss.detach()), vjp


def _sgd_tree(params: PyTree, grads: Optional[PyTree], lr, scale,
              weight_decay: float) -> None:
    """In place on each leaf of ``params``: the exact update of
    ``optim.sgd`` with pre-scaled (clipped) gradients, ``p - lr * (g *
    scale + weight_decay * p)`` in fp32.  ``grads`` None is a zero
    gradient: only the decay moves ``p``."""
    flat_g = flatten_with_paths(grads) if grads is not None else {}
    with torch.no_grad():
        for path, p in flatten_with_paths(params).items():
            g = flat_g.get(path)
            if g is None and not weight_decay:
                continue
            p32 = p.float()
            if g is None:
                u = weight_decay * p32
            else:
                u = (g * scale).to(g.dtype).float()
                if weight_decay:
                    u = u + weight_decay * p32
            p.copy_(p32 - lr * u)


def _lomo_fused_body(cfg, pieces, grad_clip: float,
                     weight_decay: float) -> Callable:
    """The fused step for families exposing the dense 3-tuple
    ``lomo_pieces``: ``step(params, batch, lr) -> (params, loss,
    grad_norm)``, updating ``params`` in place.

    The tied head's order is the reference's: the head-side embedding
    gradient is consumed first, as its own SGD increment carrying the
    weight decay (``ep_mid``); the gather-side increment comes after the
    reverse sweep, without decay (SGD is linear in the gradient, so the
    two increments are one step).  The reported norm drops their cross
    term (exact for untied heads); the clip scale never uses it — the
    norm-only sweep sums the two embedding gradients elementwise, keeping
    the head-side one live beside one layer's gradient."""
    embed_fn, block_fn, head_loss_fn = pieces

    def step(params, batch, lr):
        ep, lp, hp = params["embed"], params["layers"], params["head"]
        emb = _Leaves(ep)
        with torch.enable_grad():
            h0 = embed_fn(emb.tree, batch)
        resid, h = _save_inputs(block_fn, lp, h0.detach())
        loss, head_vjp = _head(head_loss_fn, hp, emb, h, batch)
        del h

        def layer_vjp(i, dh):
            lyr = _Leaves(layer_at(lp, i))
            x = resid[i].detach().requires_grad_(True)
            with torch.enable_grad():
                out = block_fn(lyr.tree, x)
            *g, dx = torch.autograd.grad(out, lyr.list + [x], dh)
            return dctx.data_mean(lyr.grads(g)), dx

        def gather_vjp(dh0, retain):
            return dctx.data_mean(emb.grads(torch.autograd.grad(
                h0, emb.list, dh0, allow_unused=True, retain_graph=retain)))

        def norm_sweep():
            g_head, g_emb_h, dh = head_vjp(True)
            sq = _sq(g_head)
            del g_head
            for i in reversed(range(len(resid))):
                g, dh = layer_vjp(i, dh)
                sq = sq + _sq(g)
                del g
            return sq + _sq(_tadd(gather_vjp(dh, True), g_emb_h))

        def update_sweep(scale):
            g_head, g_emb_h, dh = head_vjp(False)
            _sgd_tree(hp, g_head, lr, scale, weight_decay)
            sq = _sq(g_head)
            del g_head
            sq_emb_h = _sq(g_emb_h)
            _sgd_tree(ep, g_emb_h, lr, scale, weight_decay)    # ep_mid
            del g_emb_h
            for i in reversed(range(len(resid))):
                g, dh = layer_vjp(i, dh)
                sq = sq + _sq(g)
                _sgd_tree(layer_at(lp, i), g, lr, scale, weight_decay)
                del g
            g_gather = gather_vjp(dh, False)
            _sgd_tree(ep, g_gather, lr, scale, 0.0)
            return sq + sq_emb_h + _sq(g_gather)

        if grad_clip and grad_clip > 0:
            sq = norm_sweep()
            update_sweep(clip_scale(grad_clip, sq))
        else:
            sq = update_sweep(1.0)
        return params, loss, torch.sqrt(sq)

    return step


# ------------------------------------------- staged pieces (LomoPieces)
#
# The generalized fused-backward driver for the staged ``LomoPieces``
# protocol (dense AdaLomo through ``from_embed_block_head``; the later
# families).  One forward saves per-stage layer inputs; the reverse walk
# recomputes one layer at a time and hands its gradient to a ``consume``
# callback (SGD update, Adafactor update, or norm-only reduction), so
# gradient residency stays one fused grain plus the small accumulating
# segments (embed, shared, the side cotangent).


def _pieces_forward(pieces: LomoPieces, ep, stages, sp, hp, batch):
    """The segmented forward: ``(loss, head_vjp, emb, saved)`` with
    ``saved[i]`` stage i's layer inputs, its side input and the graph of
    its ``stage_inits`` over ``(embed_p, prev_stage_out)``."""
    emb = _Leaves(ep)
    saved, prev = [], None
    for i, fn in enumerate(pieces.stage_fns):
        prev_in = None if prev is None else prev.detach().requires_grad_(True)
        with torch.enable_grad():
            h0, side = pieces.stage_inits[i](emb.tree, prev_in, batch)
        side_in = None if side is None else side.detach()
        resid, prev = _save_inputs(
            lambda lp, h, fn=fn, s=side_in: fn(lp, sp, s, h), stages[i],
            h0.detach())
        saved.append(dict(resid=resid, side=side_in, h0=h0, side_out=side,
                          prev_in=prev_in))
    loss, head_vjp = _head(pieces.head_loss_fn, hp, emb, prev, batch)
    return loss, head_vjp, emb, saved


def _pieces_reverse(pieces: LomoPieces, sp, stages, emb: _Leaves, saved,
                    dh, consume: Callable, stage_extra=None,
                    retain: bool = False):
    """Walk every stage's layers last to first, consuming gradients.

    ``consume(i, layer_p, g_layer, extra_slice) -> squared norm`` runs
    with ONE layer's gradient; ``stage_extra[i]`` is a stacked tree sliced
    beside the layer (AdaLomo's moments).  Shared-segment and side
    cotangents accumulate; each stage-init graph chains ``dh`` backwards
    and yields its embedding gradient (``retain`` keeps those graphs for a
    second sweep).  Returns ``(g_embed_from_inits, g_shared, sum of
    consume's values)``."""
    g_emb = g_sh = None
    sq = 0.0
    for i in reversed(range(len(pieces.stage_fns))):
        st, fn = saved[i], pieces.stage_fns[i]
        dside = None
        for j in reversed(range(len(st["resid"]))):
            lp = layer_at(stages[i], j)
            lyr, sh = _Leaves(lp), _Leaves(sp)
            side = (None if st["side"] is None
                    else st["side"].detach().requires_grad_(True))
            x = st["resid"][j].detach().requires_grad_(True)
            with torch.enable_grad():
                out = fn(lyr.tree, sh.tree, side, x)
            ins = lyr.list + sh.list + ([side] if side is not None else [])
            gs = torch.autograd.grad(out, ins + [x], dh, allow_unused=True)
            nl, ns = len(lyr.list), len(sh.list)
            g_layer, dh = dctx.data_mean(lyr.grads(gs[:nl])), gs[-1]
            g_sh = _tadd(g_sh, sh.grads(gs[nl:nl + ns]))
            if side is not None:
                dside = _tadd(dside, gs[nl + ns])
            ex = None if stage_extra is None else layer_at(stage_extra[i], j)
            sq = sq + consume(i, lp, g_layer, ex)
            del g_layer, gs
        outs, cots = [st["h0"]], [dh]
        if st["side_out"] is not None and dside is not None:
            outs.append(st["side_out"])
            cots.append(dside)
        prev = [st["prev_in"]] if st["prev_in"] is not None else []
        gs = torch.autograd.grad(outs, emb.list + prev, cots,
                                 allow_unused=True, retain_graph=retain)
        g_emb = _tadd(g_emb, emb.grads(gs[:len(emb.list)]))
        dh = gs[-1] if prev else None
    return dctx.data_mean(g_emb), dctx.data_mean(g_sh), sq


def _lomo_pieces_body(cfg, pieces: LomoPieces, grad_clip: float,
                      weight_decay: float) -> Callable:
    """The staged fused step with LOMO's SGD update (the same two-sweep
    clipping as ``_lomo_fused_body``).  The embedding (and a shared
    segment) takes one update with its summed gradient after the sweep."""

    def step(params, batch, lr):
        ep, stages, sp, hp = pieces.split(params)
        loss, head_vjp, emb, saved = _pieces_forward(pieces, ep, stages, sp,
                                                     hp, batch)

        def sweep(scale, retain):
            """scale None -> norm only (every gradient reduced, then
            dropped)."""
            update = scale is not None
            g_head, g_emb_head, dh = head_vjp(retain)
            sq = _sq(g_head)
            if update:
                _sgd_tree(hp, g_head, lr, scale, weight_decay)
            del g_head

            def consume(i, lp, g, ex):
                if update:
                    _sgd_tree(lp, g, lr, scale, weight_decay)
                return _sq(g)

            g_emb, g_sh, sq_layers = _pieces_reverse(
                pieces, sp, stages, emb, saved, dh, consume, retain=retain)
            g_emb = _tadd(g_emb, g_emb_head)   # tied heads
            if update:
                _sgd_tree(ep, g_emb, lr, scale, weight_decay)
                if sp is not None:
                    _sgd_tree(sp, g_sh, lr, scale, weight_decay)
            return sq + sq_layers + _sq(g_emb) + _sq(g_sh)

        if grad_clip and grad_clip > 0:
            sq = sweep(None, True)
            sweep(clip_scale(grad_clip, sq), False)
        else:
            sq = sweep(1.0, False)
        return params, loss, torch.sqrt(sq)

    return step


def _segment_pullback(cfg, loss_fn: Callable, compute_dtype, params, batch):
    """The generic fallback's backward: one graph of ``loss_fn`` over the
    top-level segments.  ``(loss, keys, pullback)`` with ``pullback(retain)
    -> {segment: gradient tree or None}`` (None: no leaf used)."""
    keys = list(params)
    segs = {key: _Leaves(params[key]) for key in keys}
    with torch.enable_grad():
        loss = loss_fn(cfg, {key: segs[key].tree for key in keys}, batch,
                       compute_dtype=compute_dtype)

    def pullback(retain: bool) -> dict:
        flat = [t for key in keys for t in segs[key].list]
        gs = torch.autograd.grad(loss, flat, allow_unused=True,
                                 retain_graph=retain)
        out, o = {}, 0
        for key in keys:
            n = len(segs[key].list)
            out[key] = dctx.data_mean(segs[key].grads(gs[o:o + n]))
            o += n
        return out

    return dctx.data_mean(loss.detach()), keys, pullback


def _lomo_generic_body(cfg, loss_fn: Callable, compute_dtype,
                       grad_clip: float, weight_decay: float) -> Callable:
    """Fallback for families without ``lomo_pieces`` (or a custom
    ``loss_fn``): one backward over the tuple of top-level segments,
    consumed in cotangent (head-first) order.  Its one backward returns
    every segment's gradient at once."""

    def step(params, batch, lr):
        loss, keys, pullback = _segment_pullback(cfg, loss_fn, compute_dtype,
                                                 params, batch)

        def sweep(scale, retain):
            grads = pullback(retain)
            sq = 0.0
            for key in reversed(keys):
                sq = sq + _sq(grads[key])
                if scale is not None:
                    _sgd_tree(params[key], grads[key], lr, scale,
                              weight_decay)
                grads[key] = None
            return sq

        if grad_clip and grad_clip > 0:
            sq = sweep(None, True)
            sweep(clip_scale(grad_clip, sq), False)
        else:
            sq = sweep(1.0, False)
        return params, loss, torch.sqrt(sq)

    return step


def lomo_step_body(cfg, policy: Policy = FP32,
                   loss_fn: Optional[Callable] = None,
                   lomo: Optional[LOMOConfig] = None,
                   pieces=None) -> Callable:
    """The LOMO step ``step(params, batch, lr) -> (params, loss,
    grad_norm)``, updating ``params`` in place.  Dispatches to the
    per-layer fused backward when the family exposes ``lomo_pieces`` and
    no custom ``loss_fn`` overrides the forward (staged ``LomoPieces`` ->
    the staged driver, the dense 3-tuple -> its own body), otherwise to
    the segment fallback.  ``pieces``: the family's pieces, already
    resolved by the caller."""
    lomo = lomo if lomo is not None else LOMOConfig()
    model = get_family(cfg)
    if loss_fn is None:
        if pieces is None and hasattr(model, "lomo_pieces"):
            pieces = model.lomo_pieces(cfg,
                                       compute_dtype=policy.compute_dtype)
        if isinstance(pieces, LomoPieces):
            return _lomo_pieces_body(cfg, pieces, lomo.grad_clip,
                                     lomo.weight_decay)
        if pieces is not None:
            return _lomo_fused_body(cfg, pieces, lomo.grad_clip,
                                    lomo.weight_decay)
    return _lomo_generic_body(cfg, loss_fn or model.loss_fn,
                              policy.compute_dtype, lomo.grad_clip,
                              lomo.weight_decay)


# -------------------------------------------------- fused backward: AdaLomo

def adalomo_init_opt_state(cfg, params: PyTree) -> PyTree:
    """AdaLomo's resident optimizer state: Adafactor's factored second
    moments for every leaf plus the step count (a CPU int64).  Stacked
    segments (the family's ``unit_spec``) factor PER LAYER: a ``(L, r,
    c)`` leaf keeps ``vr (L, r)`` and ``vc (L, c)``, a stacked ``(L, d)``
    vector a full per-layer ``v``."""
    model = get_family(cfg)
    stacked = {u.key for u in model.unit_spec(cfg) if u.kind == "stacked"}
    moments = {
        key: tree_map(lambda p, _s=(key in stacked): moment_init(p,
                                                                 stacked=_s),
                      sub)
        for key, sub in params.items()}
    return {"moments": moments, "count": new_count()}


def _ada_tree(params: PyTree, grads: Optional[PyTree], moms: PyTree, lr,
              beta2, scale, acfg: AdaLomoConfig) -> None:
    """In place on ``params`` and ``moms``: one Adafactor update per leaf
    with pre-scaled (clipped) gradients (None = zero).  ``matrix_rms``
    takes the update-RMS clip per trailing matrix, so a whole stacked
    segment (fallback) and its per-layer slices (fused) get the same
    arithmetic."""
    flat_g = flatten_with_paths(grads) if grads is not None else {}
    with torch.no_grad():
        for path, p in flatten_with_paths(params).items():
            g = flat_g.get(path)
            g = torch.zeros_like(p) if g is None else (g * scale).to(g.dtype)
            mom = _moment_at(moms, path)
            new_p, new_m = leaf_update(
                p, g, mom, lr, beta2, eps1=acfg.eps1,
                clip_threshold=acfg.clip_threshold,
                weight_decay=acfg.weight_decay, matrix_rms=True,
                relative_step=acfg.relative_step, eps2=acfg.eps2)
            p.copy_(new_p)
            for k, v in new_m.items():
                mom[k].copy_(v)


def _adalomo_pieces_body(cfg, pieces: LomoPieces,
                         acfg: AdaLomoConfig) -> Callable:
    """The fused AdaLomo step ``step(params, opt_state, batch, lr) ->
    (params, opt_state, loss, grad_norm)``, updating params and moments in
    place: LOMO's reverse walk, each layer's gradient feeding an Adafactor
    update of its slice of the stacked moments.  The head updates as soon
    as its gradient exists; the embedding (and a shared segment), whose
    gradient accumulates over the walk, updates once after it — Adafactor
    is nonlinear in the gradient, so LOMO's increments do not apply."""

    def step(params, opt_state, batch, lr):
        ep, stages, sp, hp = pieces.split(params)
        ep_m, stage_ms, sp_m, hp_m = pieces.split(opt_state["moments"])
        count = opt_state["count"] + 1
        beta2 = beta2_at(count, acfg.decay_rate)
        loss, head_vjp, emb, saved = _pieces_forward(pieces, ep, stages, sp,
                                                     hp, batch)

        def sweep(scale, retain):
            update = scale is not None
            g_head, g_emb_head, dh = head_vjp(retain)
            sq = _sq(g_head)
            if update:
                _ada_tree(hp, g_head, hp_m, lr, beta2, scale, acfg)
            del g_head

            def consume(i, lp, g, mom):
                if update:
                    _ada_tree(lp, g, mom, lr, beta2, scale, acfg)
                return _sq(g)

            g_emb, g_sh, sq_layers = _pieces_reverse(
                pieces, sp, stages, emb, saved, dh, consume,
                stage_extra=stage_ms, retain=retain)
            g_emb = _tadd(g_emb, g_emb_head)
            if update:
                _ada_tree(ep, g_emb, ep_m, lr, beta2, scale, acfg)
                if sp is not None:
                    _ada_tree(sp, g_sh, sp_m, lr, beta2, scale, acfg)
            return sq + sq_layers + _sq(g_emb) + _sq(g_sh)

        if acfg.grad_clip and acfg.grad_clip > 0:
            sq = sweep(None, True)
            sweep(clip_scale(acfg.grad_clip, sq), False)
        else:
            sq = sweep(1.0, False)
        return (params, {"moments": opt_state["moments"], "count": count},
                loss, torch.sqrt(sq))

    return step


def _adalomo_generic_body(cfg, loss_fn: Callable, compute_dtype,
                          acfg: AdaLomoConfig) -> Callable:
    """Fallback for families without ``lomo_pieces`` (or a custom
    ``loss_fn``): LOMO's segment backward with the Adafactor update per
    top-level segment — the fused path's arithmetic (stacked-aware
    moments, per-matrix RMS), coarser gradient liveness."""

    def step(params, opt_state, batch, lr):
        count = opt_state["count"] + 1
        beta2 = beta2_at(count, acfg.decay_rate)
        moms = opt_state["moments"]
        loss, keys, pullback = _segment_pullback(cfg, loss_fn, compute_dtype,
                                                 params, batch)

        def sweep(scale, retain):
            grads = pullback(retain)
            sq = 0.0
            for key in reversed(keys):
                sq = sq + _sq(grads[key])
                if scale is not None:
                    _ada_tree(params[key], grads[key], moms[key], lr, beta2,
                              scale, acfg)
                grads[key] = None
            return sq

        if acfg.grad_clip and acfg.grad_clip > 0:
            sq = sweep(None, True)
            sweep(clip_scale(acfg.grad_clip, sq), False)
        else:
            sq = sweep(1.0, False)
        return (params, {"moments": moms, "count": count}, loss,
                torch.sqrt(sq))

    return step


def adalomo_step_body(cfg, policy: Policy = FP32,
                      loss_fn: Optional[Callable] = None,
                      adalomo: Optional[AdaLomoConfig] = None,
                      pieces=None) -> Callable:
    """The AdaLomo step ``step(params, opt_state, batch, lr) -> (params,
    opt_state, loss, grad_norm)`` with ``opt_state`` from
    :func:`adalomo_init_opt_state`, updating both in place.  Dispatches as
    :func:`lomo_step_body`; the dense 3-tuple is adapted to the staged
    driver (``LomoPieces.from_embed_block_head``)."""
    acfg = adalomo if adalomo is not None else AdaLomoConfig()
    model = get_family(cfg)
    if loss_fn is None:
        if pieces is None and hasattr(model, "lomo_pieces"):
            pieces = model.lomo_pieces(cfg,
                                       compute_dtype=policy.compute_dtype)
        if pieces is not None:
            if not isinstance(pieces, LomoPieces):
                pieces = LomoPieces.from_embed_block_head(*pieces)
            return _adalomo_pieces_body(cfg, pieces, acfg)
    return _adalomo_generic_body(cfg, loss_fn or model.loss_fn,
                                 policy.compute_dtype, acfg)


class _FusedBackwardStrategy(Strategy):
    """Shared machinery of ``lomo`` and ``adalomo``: the one-time
    ``lomo_pieces`` resolution (fused path or segment fallback, and the
    fused grain the memory accounting reads), the gradient-residency
    accounting, and the opt-in segment streaming (under ``mesh=`` each
    segment's shards move through the window, and the step gathers them).

    On the card a step updates the params (and AdaLomo's moments) in
    place; on the CPU it updates copies and leaves its input state
    untouched."""

    # the reference's text, word for word
    cross_pod_unsupported_reason = (
        "the fused backward consumes each piece's gradient inside the "
        "reverse scan, so no whole-gradient tree ever exists for the "
        "cross-pod reduce to compress (a per-piece reduce hook is a "
        "ROADMAP item); use fpft/fpft_streamed — or the grouped "
        "hift/lisa — for compressed cross-pod data parallelism")

    def __init__(self, cfg, optimizer=None, *,
                 stream: Optional[StreamConfig] = None, **kw):
        # quant and cross_pod reach the base class, which rejects them: the
        # fused backward has no frozen tree to encode, no moment tree to
        # narrow and no whole-gradient tree to reduce
        super().__init__(cfg, optimizer, **kw)
        loss_fn = kw.get("loss_fn")
        self._fused = loss_fn is None and hasattr(self.model, "lomo_pieces")
        self._pieces = None
        if self._fused:
            self._pieces = self.model.lomo_pieces(
                cfg, compute_dtype=self.policy.compute_dtype)
            if isinstance(self._pieces, LomoPieces):
                self.memory_m = self._pieces.liveness_m
        self.stream = stream
        self._seg_pipe = (BundlePipeline(stream.depth, device=self.device)
                          if stream is not None else None)

    def _resident(self, params: PyTree) -> PyTree:
        params = self._place(params)
        if self.policy.name == "bf16":
            params = tree_cast(params, self.policy.param_dtype)
        return params

    def _stream_in(self, tree: PyTree, prefix: str) -> PyTree:
        """Upload a dict of segments through the bounded window
        (``stream=StreamConfig(depth=...)``; the identity when streaming
        is off): depth-1 segment uploads stay in flight ahead of the one
        fetched.  Keys are ``prefix:segment``, so params and moments share
        one window.  This bounds transfer staging, not the step's
        residency: the step consumes the whole uploaded tree."""
        pipe = self._seg_pipe
        if pipe is None or not tree:
            return tree
        keys = list(tree)
        out = {}
        for i, key in enumerate(keys):
            for j in range(i, min(i + pipe.depth - 1, len(keys))):
                kj = f"{prefix}:{keys[j]}"
                if not pipe.holds(kj, tree[keys[j]]):
                    pipe.prefetch(kj, tree[keys[j]])
            out[key] = pipe.fetch(f"{prefix}:{key}", tree[key])
        return out

    def _stream_out(self, tree: PyTree, prefix: str,
                    into: PyTree) -> PyTree:
        """Deferred host offload of a step's output segments (the identity
        when streaming is off), into ``into``'s pinned buffers where they
        fit: the copies drain while the next step runs."""
        pipe = self._seg_pipe
        if pipe is None or not tree:
            return tree
        return {key: pipe.offload(f"{prefix}:{key}", sub, into=into.get(key))
                for key, sub in tree.items()}

    def peak_grad_params(self, params: PyTree) -> int:
        if self._fused:
            # one fused grain's gradient at a time (memory_m units)
            units = self.model.unit_spec(self.cfg)
            return max(tree_size(split_params(params, g)[0])
                       for g in make_groups(units, self.memory_m))
        # the fallback's one backward returns every segment's gradient
        return tree_size(params)


@register_strategy("lomo")
class LOMOStrategy(_FusedBackwardStrategy):
    """LOMO (Lv et al. 2023): full-parameter SGD with the update fused into
    the backward.  Numerically one plain SGD step on all parameters
    (gradients at the pre-step params, clipped by global norm), but no
    full gradient tree is ever resident, and the optimizer state is empty
    (``memory_model`` mode ``lomo``).  The optimizer argument is accepted
    for registry uniformity and ignored; SGD's hyper-parameters live in
    :class:`LOMOConfig`.  Metrics add ``grad_norm``."""

    name = "lomo"
    memory_mode = "lomo"

    def __init__(self, cfg, optimizer=None, *,
                 lomo: Optional[LOMOConfig] = None, **kw):
        super().__init__(cfg, optimizer, **kw)
        self.lomo = lomo if lomo is not None else LOMOConfig()
        self._body = lomo_step_body(cfg, policy=self.policy,
                                    loss_fn=kw.get("loss_fn"),
                                    lomo=self.lomo, pieces=self._pieces)

    def init(self, params: PyTree, rng=None) -> TrainState:
        return self._sharded(TrainState(self._resident(params), {}, 0, {}))

    def step(self, state: TrainState, batch) -> tuple[TrainState, Metrics]:
        step = int(state.step)
        lr = self.schedule.at_cycle(step)
        params = _own(_gathered(self._stream_in(state.params, "p")))
        with self._ctx():
            params, loss, gnorm = self._body(params, self._rows(batch), lr)
        params = S.reshard_like(params, state.params)
        params = self._stream_out(params, "p", state.params)
        return (TrainState(params, state.opt_state, step + 1, state.extra),
                {"loss": loss, "lr": lr, "strategy": self.name,
                 "grad_norm": gnorm})


@register_strategy("adalomo")
class AdaLomoStrategy(_FusedBackwardStrategy):
    """AdaLomo (Lv et al. 2023): LOMO's fused backward with Adafactor's
    adaptivity.  Each layer's gradient feeds a factored second-moment
    update (``optim.adafactor.leaf_update`` with ``matrix_rms``) of that
    layer the moment it exists, so no full gradient tree is resident; the
    factored statistics, O(r+c) floats per (r, c) matrix, are the only
    optimizer state (``opt_state = {"moments", "count"}``,
    ``memory_model`` mode ``adalomo``).  Hyper-parameters live in
    :class:`AdaLomoConfig`; the optimizer argument is ignored.  Metrics
    add ``grad_norm``."""

    name = "adalomo"
    memory_mode = "adalomo"

    def __init__(self, cfg, optimizer=None, *,
                 adalomo: Optional[AdaLomoConfig] = None, **kw):
        super().__init__(cfg, optimizer, **kw)
        self.adalomo = adalomo if adalomo is not None else AdaLomoConfig()
        self._body = adalomo_step_body(cfg, policy=self.policy,
                                       loss_fn=kw.get("loss_fn"),
                                       adalomo=self.adalomo,
                                       pieces=self._pieces)

    def init(self, params: PyTree, rng=None) -> TrainState:
        params = self._resident(params)
        return self._sharded(TrainState(
            params, adalomo_init_opt_state(self.cfg, params), 0, {}))

    def _shard_state(self, state: TrainState) -> TrainState:
        # the factored moments take the structural rule on their own shapes
        moments = state.opt_state["moments"]
        return TrainState(
            S.shard(state.params, self.param_shardings(state.params),
                    self.mesh),
            {**state.opt_state, "moments": S.shard(
                moments, S.param_shardings(moments, self.mesh), self.mesh)},
            state.step, state.extra)

    def step(self, state: TrainState, batch) -> tuple[TrainState, Metrics]:
        step = int(state.step)
        lr = self.schedule.at_cycle(step)
        opt = state.opt_state
        params = _own(_gathered(self._stream_in(state.params, "p")))
        moments = _own(_gathered(self._stream_in(opt["moments"], "m")))
        with self._ctx():
            params, new_opt, loss, gnorm = self._body(
                params, {"moments": moments, "count": opt["count"]},
                self._rows(batch), lr)
        params = S.reshard_like(params, state.params)
        new_opt["moments"] = S.reshard_like(new_opt["moments"],
                                            opt["moments"])
        new_opt["moments"] = self._stream_out(new_opt["moments"], "m",
                                              opt["moments"])
        params = self._stream_out(params, "p", state.params)
        return (TrainState(params, new_opt, step + 1, state.extra),
                {"loss": loss, "lr": lr, "strategy": self.name,
                 "grad_norm": gnorm})


# ------------------------------------------------------------------ Runner

class Runner:
    """Mutable facade over ``(strategy, TrainState)`` — the driver
    surface."""

    def __init__(self, strategy: Strategy, params: PyTree, rng=None):
        self.strategy = strategy
        self.state = strategy.init(params, rng)
        self.last_metrics: Metrics = {}

    @property
    def params(self) -> PyTree:
        return self.state.params

    @property
    def step_count(self) -> int:
        return int(self.state.step)

    @property
    def k(self) -> int:
        return self.strategy.k

    @property
    def opt_state(self) -> PyTree:
        return self.state.opt_state

    def train_step(self, batch) -> torch.Tensor:
        self.state, self.last_metrics = self.strategy.step(self.state, batch)
        return self.last_metrics["loss"]

    def lr_for_step(self, step: Optional[int] = None) -> float:
        return self.strategy.lr_at(self.step_count if step is None else step)

    def group_for_step(self, step: Optional[int] = None) -> Group:
        return self.strategy.group_at(self.state, step)

    def peak_trainable_params(self) -> int:
        return self.strategy.peak_trainable_params(self.state.params)

    def total_params(self) -> int:
        return tree_size(self.state.params)

    def state_dict(self) -> dict:
        return self.state.to_tree()

    def load_state_dict(self, state: dict) -> None:
        """Resume from a ``state_dict`` (a runner's, or a checkpoint's of
        either package), placed as the strategy keeps its state
        (:meth:`Strategy.place_state`)."""
        self.state = self.strategy.place_state(TrainState.from_tree(state))

    def __getattr__(self, name: str):
        # delegate static attributes (groups, order, units, cfg, hift, ...)
        if name.startswith("_") or "strategy" not in self.__dict__:
            raise AttributeError(name)
        return getattr(self.__dict__["strategy"], name)
