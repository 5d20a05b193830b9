"""Learning-rate schedules with HiFT's DELAYED update (port of
``repro.core.scheduler``, paper §3.1).

The schedule is a pure function of the *cycle* index: eta advances only
after all k groups have been visited once, so every group sees the same
learning rate within one sweep.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class LRSchedule:
    base_lr: float = 1e-5
    warmup_cycles: int = 0
    total_cycles: int = 10_000
    kind: str = "constant"   # constant | linear | cosine
    min_lr: float = 0.0

    def at_cycle(self, cycle: int) -> float:
        if self.warmup_cycles > 0 and cycle < self.warmup_cycles:
            return self.base_lr * (cycle + 1) / self.warmup_cycles
        t = min(max(cycle - self.warmup_cycles, 0),
                max(self.total_cycles - self.warmup_cycles, 1))
        frac = t / max(self.total_cycles - self.warmup_cycles, 1)
        if self.kind == "constant":
            return self.base_lr
        if self.kind == "linear":
            return self.base_lr + (self.min_lr - self.base_lr) * frac
        if self.kind == "cosine":
            return self.min_lr + 0.5 * (self.base_lr - self.min_lr) * (
                1.0 + math.cos(math.pi * frac))
        raise ValueError(self.kind)

    def delayed(self, step: int, k: int) -> float:
        """HiFT delayed LR: eta advances once per full sweep of k groups."""
        return self.at_cycle(step // max(k, 1))
