"""Training state (port of ``repro.train.state``)."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim.adamw import AdamWState


class TrainState(NamedTuple):
    step: torch.Tensor     # 0-d int32, on the host
    params: Any            # the model's parameter tree, on the device
    opt: AdamWState
    rng: torch.Tensor      # a repro_torch.random key, on the host
