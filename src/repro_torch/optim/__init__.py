"""Optimizer registry (port of ``repro.optim``): AdamW, SGD, SGD-momentum
and AdaGrad; Adafactor is not ported yet."""
from repro_torch.optim.adagrad import adagrad
from repro_torch.optim.adamw import adamw
from repro_torch.optim.base import (Optimizer, OptimizerConfig,
                                    clip_by_global_norm)
from repro_torch.optim.mixed_precision import Policy, get_policy
from repro_torch.optim.sgd import sgd, sgdm

_FACTORIES = {
    "adamw": adamw,
    "sgd": sgd,
    "sgdm": sgdm,
    "adagrad": adagrad,
}


def make_optimizer(name: str, **kwargs) -> Optimizer:
    if name == "adafactor":
        raise NotImplementedError("optimizer 'adafactor' is not ported yet")
    if name not in _FACTORIES:
        raise ValueError(f"unknown optimizer {name!r}; have "
                         f"{sorted(_FACTORIES)}")
    return _FACTORIES[name](**kwargs)


__all__ = [
    "adamw", "sgd", "sgdm", "adagrad", "make_optimizer", "Optimizer",
    "OptimizerConfig", "clip_by_global_norm", "Policy", "get_policy",
]
