"""Optimizer registry (port of ``repro.optim``; paper §C: AdamW, SGDM,
SGD, Adafactor, Adagrad)."""
from repro_torch.optim.adafactor import adafactor
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
    "adafactor": adafactor,
}


def make_optimizer(name: str, **kwargs) -> Optimizer:
    if name not in _FACTORIES:
        raise ValueError(f"unknown optimizer {name!r}; have "
                         f"{sorted(_FACTORIES)}")
    return _FACTORIES[name](**kwargs)


__all__ = [
    "adamw", "sgd", "sgdm", "adagrad", "adafactor", "make_optimizer",
    "Optimizer", "OptimizerConfig", "clip_by_global_norm", "Policy",
    "get_policy",
]
