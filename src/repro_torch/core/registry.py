"""Fine-tuning strategy registry (port of ``repro.core.registry``).

:func:`make_runner` is the entry point for building a training driver:

    runner = make_runner(cfg, "hift", optimizer="adamw",
                         hift=HiFTConfig(m=2), schedule=LRSchedule(2e-3))
    loss = runner.train_step(batch)

It runs on the card (``device="cuda"``, raising when there is none)
unless the caller passes ``device="cpu"``, for every model family: dense,
hybrid (zamba2), vlm (internvl2-26b's backbone), moe (deepseek-moe-16b,
arctic-480b), encdec (seamless-m4t-large-v2) and xlstm (xlstm-1.3b).
Every strategy of the reference is ported: ``hift``, ``hift_pipelined``,
``lisa``, ``fpft``, ``fpft_streamed``, ``mezo``, ``lomo`` and
``adalomo``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

_REGISTRY: dict[str, type] = {}

# optimizers with a fused update kernel (kernels/csrc/fused_update.cu)
FUSED_OPTIMIZERS = ("adamw", "sgdm", "adagrad")
# model families with a ported training path (models/transformer.py,
# models/zamba2.py, models/moe.py, models/encdec.py, models/xlstm.py)
TRAINED_FAMILIES = ("dense", "hybrid", "vlm", "moe", "encdec", "xlstm")


def register_strategy(name: str):
    """Class decorator: add a Strategy class to the registry under
    ``name``."""
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def _ensure_loaded() -> None:
    # the built-ins register as an import side effect
    from repro_torch.core import strategy  # noqa: F401


def strategy_ids() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def get_strategy_cls(name: str) -> type:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise ValueError(f"unknown or not yet ported strategy {name!r}; "
                         f"have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def make_strategy(name: str, cfg, optimizer, **kwargs):
    """Build a Strategy instance (static config only — no training
    state)."""
    return get_strategy_cls(name)(cfg, optimizer, **kwargs)


def make_runner(cfg, strategy: str = "hift", *, params: Any = None,
                optimizer: Any = "adamw", rng: Any = None, seed: int = 0,
                fused_update: Any = None, pipeline_depth: Any = None,
                device="cuda", **kwargs):
    """One factory for the ported fine-tuning strategies.

    ``optimizer`` is a name (``repro_torch.optim.make_optimizer``) or an
    ``Optimizer`` (``mezo``, ``lomo`` and ``adalomo`` ignore it); ``params``
    a tensor dict, by default the family's ``init`` from ``seed`` on
    ``device``.  ``rng``: the 2-word uint32 key of the stochastic
    strategies (MeZO), by default the reference's ``PRNGKey(seed)``.  On
    the card the runner trains the given tensors in place when they
    already lie there in the resident dtype.

    ``fused_update``: route the update through the fused kernels
    (``kernels/csrc/fused_update.cu``).  ``None`` keeps the reference's
    rule: fused for the grouped strategies on the accelerator (here: when
    ``device`` is ``cuda``), unfused otherwise.  It needs the optimizer by
    name, one of ``FUSED_OPTIMIZERS``.

    ``quant``: a ``QuantConfig``.  ``frozen="int8"|"nf4"`` codec-encodes
    HiFT's resident tree; ``moments="bf16"`` rebuilds a by-name optimizer
    with ``moment_dtype=bfloat16``, so it needs the optimizer given by name
    and one of the moment-carrying ``FUSED_OPTIMIZERS``.

    ``pipeline_depth``: the bundle pipeline's depth for ``hift``,
    ``hift_pipelined`` and ``lisa`` (>= 2 moves bundle transfers to side
    streams), the chunk window's depth for ``fpft_streamed``.
    ``stream_window``: ``fpft_streamed``'s chunk size in bytes
    (``StreamConfig.chunk_bytes``).

    ``mesh``: a ``DeviceMesh`` (``repro_torch.launch.mesh.mesh_from_spec``
    after ``init_distributed``): params and optimizer state shard over its
    ``model`` axis and batches over its data axes (``dist.shardings``).
    ``cross_pod``: a ``CrossPodConfig`` (hift, hift_pipelined, lisa, fpft,
    fpft_streamed).  A family outside ``TRAINED_FAMILIES`` raises.
    Remaining kwargs go to the strategy (``schedule``, ``policy``,
    ``loss_fn``, ``param_sharding_fn``, ``hift=``, ``lisa=``, ``stream=``,
    ``mezo=``, ``lomo=``, ``adalomo=``)."""
    import torch

    from repro_torch.common.device import resolve_device
    from repro_torch.core.strategy import (HiFTConfig, LiSAConfig, Runner,
                                           StreamConfig)
    from repro_torch.models import get_family
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.mezo import prng_key

    if cfg.family not in TRAINED_FAMILIES:
        raise NotImplementedError(
            f"training of the {cfg.family!r} family is not ported yet "
            f"(ported: {', '.join(TRAINED_FAMILIES)})")
    device = resolve_device(device)
    stream_window = kwargs.pop("stream_window", None)
    if stream_window is not None:
        if strategy != "fpft_streamed":
            raise ValueError("stream_window sizes fpft_streamed's chunk "
                             f"window; it does not apply to {strategy!r}")
        kwargs["stream"] = dataclasses.replace(
            kwargs.get("stream") or StreamConfig(),
            chunk_bytes=int(stream_window))
    quant = kwargs.pop("quant", None)
    grouped = strategy in ("hift", "hift_pipelined", "lisa")
    if isinstance(optimizer, str):
        fused = (device.type == "cuda" and grouped) \
            if fused_update is None else bool(fused_update)
        okw = {"use_fused": True} if (fused and
                                      optimizer in FUSED_OPTIMIZERS) else {}
        if fused_update and not okw:
            raise ValueError(f"no fused update kernel for {optimizer!r}; "
                             f"have {FUSED_OPTIMIZERS}")
        if quant is not None and quant.moments:
            if optimizer not in FUSED_OPTIMIZERS:
                raise ValueError(
                    "quant.moments applies to the moment-carrying "
                    f"optimizers {FUSED_OPTIMIZERS}, not {optimizer!r} "
                    "(sgd keeps no moments; adafactor's factored stats "
                    "are already sub-fp32-sized)")
            okw["moment_dtype"] = quant.moment_dtype
        optimizer = make_optimizer(optimizer, **okw)
    elif fused_update:
        raise ValueError("fused_update=True needs the optimizer given by "
                         "name so make_runner can rebuild it fused")
    elif quant is not None and quant.moments:
        raise ValueError("quant.moments needs the optimizer given by name "
                         "so make_runner can rebuild it with "
                         "moment_dtype=bf16")
    if quant is not None:
        kwargs["quant"] = quant
    if pipeline_depth is not None:
        if strategy == "hift_pipelined" and pipeline_depth < 2:
            raise ValueError(
                "hift_pipelined IS the pipelined schedule; an explicit "
                f"pipeline_depth={pipeline_depth} would silently re-enable "
                "it — use strategy 'hift' for the serial path")
        if strategy in ("hift", "hift_pipelined"):
            kwargs["hift"] = dataclasses.replace(
                kwargs.get("hift") or HiFTConfig(),
                pipeline_depth=pipeline_depth)
        elif strategy == "lisa":
            kwargs["lisa"] = dataclasses.replace(
                kwargs.get("lisa") or LiSAConfig(),
                pipeline_depth=pipeline_depth)
        elif strategy == "fpft_streamed":
            kwargs["stream"] = dataclasses.replace(
                kwargs.get("stream") or StreamConfig(),
                depth=pipeline_depth)
        else:
            raise ValueError("pipeline_depth applies to the pipelined "
                             "strategies (hift/lisa/fpft_streamed), not "
                             f"{strategy!r}")
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = get_family(cfg).init(cfg, gen, device=device)
    if rng is None:
        rng = prng_key(seed)
    return Runner(make_strategy(strategy, cfg, optimizer, device=device,
                                **kwargs), params, rng=rng)
