"""Training loop: a strategy ``Runner`` over a data iterator, with
checkpoints and the straggler watchdog (port of ``repro.train.loop``).

- a checkpoint every ``ckpt_every`` steps (async, atomic, keep-k),
  HiFT's visit order and bundles included, so a restart resumes
  Algorithm 1 mid-sweep, and one at the end;
- ``resume="auto"`` restores the newest complete checkpoint;
- a per-step watchdog flags stragglers (wall-clock > straggler_factor x
  rolling median).
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Optional

from repro_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep: int = 3
    log_every: int = 10
    resume: str = "none"             # none | auto
    straggler_factor: float = 3.0
    async_ckpt: bool = True


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
    """Run a ``Runner`` (``repro_torch.core.make_runner``) up to
    ``total_steps``.  Each step reads one value from the device: its loss,
    which also ends the step's host timing."""
    start_step = 0
    if loop_cfg.resume == "auto" and loop_cfg.ckpt_dir:
        step = ckpt.latest_step(loop_cfg.ckpt_dir)
        if step is not None:
            runner.load_state_dict(ckpt.restore(loop_cfg.ckpt_dir, step))
            start_step = runner.step_count
            print(f"[resume] restored step {start_step} from "
                  f"{loop_cfg.ckpt_dir}")

    watchdog = StragglerWatchdog(loop_cfg.straggler_factor)
    losses: list[float] = []
    pending_writer = None
    saved_final = False
    for step in range(start_step, loop_cfg.total_steps):
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
        if (loop_cfg.ckpt_dir and loop_cfg.ckpt_every
                and (step + 1) % loop_cfg.ckpt_every == 0):
            if pending_writer is not None:
                pending_writer.join()
            pending_writer = ckpt.save(loop_cfg.ckpt_dir, step + 1,
                                       runner.state_dict(), keep=loop_cfg.keep,
                                       async_write=loop_cfg.async_ckpt)
            saved_final = (step + 1) == loop_cfg.total_steps
    if pending_writer is not None:
        pending_writer.join()
    if loop_cfg.ckpt_dir and not saved_final:
        # skipped when total_steps landed exactly on a ckpt_every boundary
        ckpt.save(loop_cfg.ckpt_dir, loop_cfg.total_steps, runner.state_dict(),
                  keep=loop_cfg.keep, async_write=False)
    return {"losses": losses, "stragglers": watchdog.flagged,
            "final_step": loop_cfg.total_steps}
