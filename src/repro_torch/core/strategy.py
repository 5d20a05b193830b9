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
  with the same stream-safe optimizer.

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

Not ported yet (they raise): ``mesh=``, ``cross_pod=``,
``param_sharding_fn=`` and the strategies ``mezo``, ``lomo`` and
``adalomo``.
"""
from __future__ import annotations

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
from repro_torch.dist.quant import (QUANT_FORMATS, dequantize_tree,
                                    quantize_tree, tree_logical_size)
from repro_torch.models import get_family
from repro_torch.models.base import unit_first_depth
from repro_torch.optim.base import Optimizer, leaves, rebuild
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
class StreamConfig:
    """Chunk-granular state streaming (``core.pipeline.ChunkStream``).

    ``chunk_bytes`` is the byte budget of one stream chunk, measured in the
    layout's base tree (the params; congruent trees of wider dtypes move
    proportionally more bytes a chunk).  ``depth`` is the most chunks of
    each streamed tree on the device: depth-1 chunks of lookahead upload
    while the active chunk's update runs.  Consumed by ``fpft_streamed``."""
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

    def __init__(self, cfg, optimizer: Optional[Optimizer], *,
                 schedule: Optional[LRSchedule] = None, policy: Policy = FP32,
                 loss_fn: Optional[Callable] = None, device="cuda",
                 mesh=None, param_sharding_fn: Optional[Callable] = None,
                 cross_pod=None, quant: Optional[QuantConfig] = None):
        for what, val in (("mesh=", mesh), ("cross_pod=", cross_pod),
                          ("param_sharding_fn=", param_sharding_fn)):
            if val is not None:
                raise NotImplementedError(f"{what} is not ported yet")
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
        self.device = resolve_device(device)

    def init(self, params: PyTree) -> TrainState:
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
        array.  Synchronises the card first, so host buffers that another
        runner's side streams still write are complete."""
        pinned = self.offload_optimizer and self.device.type == "cuda"
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

        def opt_leaf(t):
            if not t.is_floating_point():
                return t.to(torch.int64)
            return t.pin_memory() if pinned else t.to(self.device)

        extra = dict(state.extra or {})
        if "order" in extra:
            extra["order"] = np.asarray(extra["order"], np.int64)
        return TrainState(
            params=tree_map(lambda t: t.to(self.device), state.params),
            opt_state=tree_map(opt_leaf, state.opt_state),
            step=int(state.step), extra=extra)

    def peak_trainable_params(self, params: PyTree) -> int:
        """Max #params trainable in any single step (paper Fig. 6e)."""
        return tree_size(params)


# --------------------------------------------------- grouped-step machinery

class _GroupedStrategy(Strategy):
    """Shared machinery for strategies that train ONE Group per step:
    lazy per-group optimizer bundles, host offload, Mixed^Hi masters."""

    use_cut = True
    offload_optimizer = True
    memory_mode = "hift"
    supports_quant_frozen = True
    supports_quant_moments = True

    @property
    def _quant_frozen(self) -> Optional[str]:
        return self.quant.frozen if self.quant is not None else None

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
            return {"opt": self.optimizer.init(master), "master": master}
        if self.policy.master_active_group_only:
            master = tree_cast(active, torch.float32)
            return {"opt": self.optimizer.init(master), "master": master}
        return {"opt": self.optimizer.init(active)}

    def _train_group(self, gi: int, active: PyTree, frozen: PyTree,
                     bundle: PyTree, batch, lr: float):
        group = self.groups[gi]
        cut = self._cut(group)
        cfg, opt, policy = self.cfg, self.optimizer, self.policy

        def loss_of(a):
            return self.loss_fn(cfg, merge_params(a, frozen, group), batch,
                                cut=cut, compute_dtype=policy.compute_dtype)

        qf = self._quant_frozen
        # under quantized residency the active group computes from its
        # master (the frozen records stay encoded; the forward multiplies
        # through their views)
        work = active if qf is None else tree_cast(bundle["master"],
                                                   policy.param_dtype)
        loss, grads = _value_and_grad(loss_of, work)
        if "master" in bundle:
            # grads are w.r.t. the working params; the fp32 master takes the
            # update and the resident slice its cast (re-encoded if quant)
            new_master, new_st = opt.update(grads, bundle["opt"],
                                            bundle["master"], lr)
            new_active = tree_cast(new_master, policy.param_dtype)
            if qf is not None:
                new_active = quantize_tree(new_active, qf)
            return new_active, {"opt": new_st, "master": new_master}, loss
        new_active, new_st = opt.update(grads, bundle["opt"], active, lr)
        return new_active, {"opt": new_st}, loss

    def _group_step(self, state: TrainState, batch, gi: int, lr: float,
                    next_gis: Optional[list] = None):
        group = self.groups[gi]
        active, frozen = split_params(state.params, group)
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
        new_active, new_bundle, loss = self._train_group(
            gi, active, frozen, bundle, _batch_to(batch, self.device), lr)
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
        return write_back(state.params, new_active, group), opt_state, loss

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

    def init(self, params: PyTree) -> TrainState:
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

    def init(self, params: PyTree) -> TrainState:
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

    def init(self, params: PyTree) -> TrainState:
        params = self._place(params)
        if self.policy.name == "bf16":
            params = tree_cast(params, self.policy.param_dtype)
        return TrainState(params, self.optimizer.init(params), 0, {})

    def step(self, state: TrainState, batch) -> tuple[TrainState, Metrics]:
        step = int(state.step)
        lr = self.schedule.at_cycle(step)
        batch = _batch_to(batch, self.device)
        cfg, dtype = self.cfg, self.policy.compute_dtype
        loss, grads = _value_and_grad(
            lambda p: self.loss_fn(cfg, p, batch, compute_dtype=dtype),
            state.params)
        params, opt_state = self.optimizer.update(grads, state.opt_state,
                                                  state.params, lr)
        return (TrainState(params, opt_state, step + 1, state.extra),
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
    same pre-step count, as the resident update does."""

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

    def init(self, params: PyTree) -> TrainState:
        if self.device.type == "cpu":
            return super().init(params)    # host_put is the identity here
        params = self._place(params)
        if self.policy.name == "bf16":
            params = tree_cast(params, self.policy.param_dtype)
        # the card: the moment trees' layout from an init on meta tensors,
        # then each leaf's state made on the device and copied into its
        # pinned view, so no device copy of a whole moment tree exists
        meta = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"), params)
        streamed, resident = self._split_state(self.optimizer.init(meta),
                                               meta)
        host = self._pinned(streamed)
        views = {k: flatten_with_paths(t) for k, t in host.items()}
        for path, leaf in flatten_with_paths(params).items():
            one = {"x": leaf}
            state, _ = self._split_state(self.optimizer.init(one), one)
            for key, view in views.items():
                view[path].copy_(state[key]["x"], non_blocking=True)
        return TrainState(params, {**resident, **host}, 0, {})

    def place_state(self, state: TrainState) -> TrainState:
        """As :meth:`Strategy.place_state`, with the streamed moment trees
        in one pinned buffer on the card."""
        streamed, resident = self._split_state(state.opt_state, state.params)
        placed = super().place_state(dataclasses.replace(
            state, opt_state=resident if self.device.type == "cuda"
            else state.opt_state))
        if self.device.type == "cpu":
            return placed
        host = self._pinned(streamed)
        for key, tree in host.items():
            src = flatten_with_paths(streamed[key])
            for path, view in flatten_with_paths(tree).items():
                view.copy_(src[path])
        return dataclasses.replace(placed,
                                   opt_state={**placed.opt_state, **host})

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

    def step(self, state: TrainState, batch) -> tuple[TrainState, Metrics]:
        step = int(state.step)
        lr = self.schedule.at_cycle(step)
        batch = _batch_to(batch, self.device)
        cfg, dtype = self.cfg, self.policy.compute_dtype
        loss, grads = _value_and_grad(
            lambda p: self.loss_fn(cfg, p, batch, compute_dtype=dtype),
            state.params)
        params, opt_state = self._streamed_update(state.params, grads,
                                                  state.opt_state, lr)
        return (TrainState(params, opt_state, step + 1, state.extra),
                {"loss": loss, "lr": lr, "strategy": self.name})


# ------------------------------------------------------------------ Runner

class Runner:
    """Mutable facade over ``(strategy, TrainState)`` — the driver
    surface."""

    def __init__(self, strategy: Strategy, params: PyTree):
        self.strategy = strategy
        self.state = strategy.init(params)
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
