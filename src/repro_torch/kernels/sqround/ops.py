"""Stochastic quantization of a matrix to int8 codes (port of
``repro.kernels.sqround.ops``).

``sqround(v, bits, key)`` returns ``(codes, scale)``: the codes are
reproducible bit for bit from the threefry words of ``key``, as the
reference's are from ``jax.random.bits``. On a CUDA tensor it launches the
``sqround`` kernel once; on a CPU tensor it runs the plain version.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch import random as prng
from repro_torch.kernels.sqround.kernel import sqround_cuda
from repro_torch.kernels.sqround.ref import sqround_ref


def sqround(v: torch.Tensor, bits: int, key: torch.Tensor,
            scale: Optional[Union[torch.Tensor, float]] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stochastically round a 2-D float32 tensor to int8 codes in [-K, K].

    ``scale`` defaults to max |v|, or 1.0 when v is all zeros; it is returned
    as a 0-d float32 tensor on v's device."""
    if v.ndim != 2:
        raise ValueError(f"sqround expects a 2-D tensor, got shape {tuple(v.shape)}")
    if v.dtype != torch.float32:
        raise TypeError(f"sqround expects float32 values, got {v.dtype}")
    if scale is None:
        m = v.abs().amax()
        scale = torch.where(m > 0, m, torch.ones_like(m))
    else:
        scale = torch.as_tensor(scale, dtype=torch.float32, device=v.device).reshape(())
    u = prng.bits(key, v.shape, device=v.device)
    if v.is_cuda:
        return sqround_cuda(v.contiguous(), u, scale, bits), scale
    return sqround_ref(v, u, scale, bits), scale
