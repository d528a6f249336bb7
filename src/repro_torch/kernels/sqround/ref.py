"""Plain PyTorch version of the stochastic-rounding quantizer (port of
``repro.kernels.sqround.ref``).

Given values ``v`` (float32), uniform random words ``u`` (uint32, same
shape), a scalar ``scale`` and a bit width ``bits``, the int8 codes are

    scaled = clip(v / scale, -1, 1) * K
    low    = floor(scaled)
    code   = clip(low + [uniform01(u) < scaled - low], -K, K)

with ``uniform01(u) = (u >> 8) * 2^-24`` and K = ``BY_BITS[bits].half_steps``.

The words may come as the port's ``random.bits`` returns them (uint32 values
held in int64) or narrowed to int32 with the same 32 bits, as the kernel
reads them; both give the same codes. ``scale`` is a tensor on ``v``'s
device: a true IEEE division by it, as the reference divides (a Python
float would let PyTorch's CUDA division multiply by a reciprocal instead).
"""
from __future__ import annotations

import torch

from repro_torch.quant.formats import BY_BITS

_M32 = 0xFFFFFFFF


def uniform01_from_bits(u: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from the top 24 bits of each uint32 word."""
    top24 = (u.to(torch.int64) & _M32) >> 8
    return top24.to(torch.float32) * (2.0 ** -24)


def sqround_ref(v: torch.Tensor, u: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    k = BY_BITS[bits].half_steps
    scaled = torch.clamp(v / scale, -1.0, 1.0) * k
    low = torch.floor(scaled)
    p_up = scaled - low
    codes = low + (uniform01_from_bits(u) < p_up).to(torch.float32)
    return torch.clamp(codes, -k, k).to(torch.int8)
