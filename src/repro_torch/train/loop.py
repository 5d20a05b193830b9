"""Training driver: a strategy ``Runner`` over a data iterator, with the
straggler watchdog (port of ``repro.train.loop``).  Checkpointing is not
ported yet: a ``ckpt_dir`` raises."""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Optional


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None   # checkpointing: not ported yet
    log_every: int = 10
    straggler_factor: float = 3.0


class StragglerWatchdog:
    """Rolling-median step-time monitor (per-host straggler detection)."""

    def __init__(self, factor: float = 3.0, window: int = 32):
        self.factor = factor
        self.window = window
        self.times: list[float] = []
        self.flagged: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        slow = False
        if len(self.times) >= 8:
            med = statistics.median(self.times[-self.window:])
            slow = dt > self.factor * med
            if slow:
                self.flagged.append((step, dt))
        self.times.append(dt)
        return slow


def train(runner, data_iter, loop_cfg: LoopConfig,
          on_step: Optional[Callable[[int, float], None]] = None) -> dict:
    """Run a ``Runner`` (``repro_torch.core.make_runner``) for
    ``total_steps``.  Each step reads one value from the device: its loss,
    which also ends the step's host timing."""
    if loop_cfg.ckpt_dir:
        raise NotImplementedError("checkpointing is not ported yet")
    watchdog = StragglerWatchdog(loop_cfg.straggler_factor)
    losses: list[float] = []
    for step in range(loop_cfg.total_steps):
        batch = next(data_iter)
        t0 = time.time()
        loss = float(runner.train_step(batch))
        dt = time.time() - t0
        losses.append(loss)
        slow = watchdog.observe(step, dt)
        if on_step:
            on_step(step, loss)
        if loop_cfg.log_every and step % loop_cfg.log_every == 0:
            lr = getattr(runner, "lr_for_step", lambda: 0.0)()
            print(f"step {step:5d} loss {loss:.4f} lr {lr:.3e} "
                  f"dt {dt*1e3:7.1f}ms"
                  + (" [STRAGGLER]" if slow else ""), flush=True)
    return {"losses": losses, "stragglers": watchdog.flagged,
            "final_step": loop_cfg.total_steps}
