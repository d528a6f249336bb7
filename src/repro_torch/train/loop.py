"""The training loop (port of ``repro.train.loop``): checkpoint and restore,
preemption, telemetry.

Restart-safe by construction: the state is a function of (seed, step) and
the newest complete checkpoint, and the data stream is counter-based
(:mod:`repro_torch.data.synthetic`), so a restarted run replays the same
steps and ends with the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.data.synthetic import SyntheticStream
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import PreemptionGuard, StepTimer
from repro_torch.train.state import TrainState


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_keep: int = 3
    ckpt_async: bool = True
    log_every: int = 10


def train_loop(step_fn: Callable, state: TrainState, stream: SyntheticStream,
               loop_cfg: LoopConfig, *, log: Callable[[str], None] = print) -> TrainState:
    """Run (or resume) training to ``loop_cfg.total_steps``; returns the final
    state. With ``ckpt_dir``, the newest complete checkpoint there replaces
    ``state`` (its leaves land on the devices of ``state``'s), every
    ``ckpt_every`` steps a checkpoint is written, and SIGTERM/SIGINT writes
    one synchronously and stops after the step in flight."""
    start = 0
    if loop_cfg.ckpt_dir:
        restored, step = ckpt.restore_latest(loop_cfg.ckpt_dir, state)
        if restored is not None:
            state = restored
            start = step
            log(f"[loop] resumed from checkpoint step {step}")

    timer = StepTimer()
    pending = None
    with PreemptionGuard() as guard:
        for step in range(start, loop_cfg.total_steps):
            batch = stream.at_step(step)
            state, metrics = step_fn(state, batch)
            timer.tick()
            if step % loop_cfg.log_every == 0:
                log(f"[loop] step={step} loss={float(metrics['loss']):.4f} "
                    f"gnorm={float(metrics['grad_norm']):.3f} "
                    f"step_time={timer.mean*1e3:.1f}ms")
            should_ckpt = loop_cfg.ckpt_dir and (
                (step + 1) % loop_cfg.ckpt_every == 0 or guard.requested
            )
            if should_ckpt:
                if pending is not None:
                    pending.join()
                pending = ckpt.save(
                    loop_cfg.ckpt_dir, step + 1, state,
                    keep=loop_cfg.ckpt_keep,
                    async_=loop_cfg.ckpt_async and not guard.requested,
                )
            if guard.requested:
                log(f"[loop] preemption: checkpointed at step {step + 1}, exiting")
                break
    if pending is not None:
        pending.join()
    return state
