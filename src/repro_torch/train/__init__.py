"""Training runtime of the port (``repro.train`` on one device): the step,
the loop, checkpoints and fault handling. The sharded step builders and
input specs wait for the sharding slice (ROADMAP.md queue 1's sharding item)."""
from repro_torch.train.checkpoint import (
    available_steps,
    latest_step,
    restore,
    restore_latest,
    save,
)
from repro_torch.train.fault import PreemptionGuard, StepTimer, run_with_restarts
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.state import TrainState
from repro_torch.train.steps import init_state, make_train_step

__all__ = [
    "available_steps", "latest_step", "restore", "restore_latest", "save",
    "PreemptionGuard", "StepTimer", "run_with_restarts",
    "LoopConfig", "train_loop", "TrainState",
    "init_state", "make_train_step",
]
