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
- ``fpft``: the full-parameter baseline (all params every step).

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
``param_sharding_fn=``, the bundle pipeline (``pipeline_depth >= 2``) and
the other strategies (``hift_pipelined``, ``lisa``, ``fpft_streamed``,
``mezo``, ``lomo``, ``adalomo``).
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

def host_put(tree: PyTree, into: Optional[PyTree] = None) -> PyTree:
    """Move a bundle to host memory (the paper's MoveOptimizerState2CPU).

    Each CUDA leaf is copied into a pinned CPU tensor with
    ``non_blocking=True`` on the current stream — into ``into``'s pinned
    leaf at the same path when it has the same shape and dtype (a revisited
    group's host buffers are reused), else into a new one.  Any host read
    of the result must synchronise first.  CPU leaves (the step count, and
    everything when training on the CPU) pass through."""
    old = flatten_with_paths(into) if into is not None else {}
    out = {}
    for path, t in flatten_with_paths(tree).items():
        if t.device.type != "cuda":
            out[path] = t
            continue
        dst = old.get(path)
        if (dst is None or dst.device.type != "cpu" or not dst.is_pinned()
                or dst.shape != t.shape or dst.dtype != t.dtype):
            dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        dst.copy_(t, non_blocking=True)
        out[path] = dst
    return unflatten_from_paths(out)


def device_put(tree: PyTree, device: torch.device) -> PyTree:
    """Floating leaves to ``device`` (asynchronous from pinned memory);
    integer leaves — optimizer step counts — stay on the host."""
    if device.type == "cpu":
        return tree
    return tree_map(lambda t: t.to(device, non_blocking=True)
                    if t.is_floating_point() else t, tree)


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
    pipeline_depth: int = 1           # >= 2 (the bundle pipeline): not ported


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
        tensor on the device)."""
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
        array."""
        pinned = self.offload_optimizer and self.device.type == "cuda"

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
    supports_quant_frozen = True
    supports_quant_moments = True

    @property
    def _quant_frozen(self) -> Optional[str]:
        return self.quant.frozen if self.quant is not None else None

    def _setup_groups(self, m: int) -> None:
        self.units = self.model.unit_spec(self.cfg)
        self.groups = make_groups(self.units, m)
        self.k = len(self.groups)

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

    def _group_step(self, state: TrainState, batch, gi: int, lr: float):
        group = self.groups[gi]
        active, frozen = split_params(state.params, group)
        key = str(gi)
        stored = state.opt_state.get(key)
        if stored is None:
            bundle = self._init_bundle(active)
        elif self.offload_optimizer:
            bundle = device_put(stored, self.device)
        else:
            bundle = stored
        new_active, new_bundle, loss = self._train_group(
            gi, active, frozen, bundle, _batch_to(batch, self.device), lr)
        if self.offload_optimizer:
            new_bundle = host_put(new_bundle, into=stored)
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
        if self.hift.pipeline_depth >= 2:
            raise NotImplementedError("the bundle pipeline (pipeline_depth "
                                      ">= 2) is not ported yet")
        self.use_cut = self.hift.use_cut
        self.offload_optimizer = self.hift.offload_optimizer
        self._setup_groups(self.hift.m)
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
        gi = self._order_at(state)[step % self.k]
        lr = self.schedule.delayed(step, self.k)
        params, opt_state, loss = self._group_step(state, batch, gi, lr)
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
