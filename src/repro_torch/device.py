"""Device resolution shared by the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. A request for
``cuda`` on a machine without one raises instead of moving quietly to the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``torch.device`` for ``device`` (default ``cuda``); raises if CUDA is
    asked for and unavailable."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU by default, but torch.cuda.is_available() "
            "is False; pass device='cpu' (or --device cpu) to run on the CPU")
    return dev
