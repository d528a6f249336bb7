"""Plain PyTorch version of the packed low-precision matmul (qmm).

Contract (shared with the CUDA kernel and with ``repro.kernels.qmm``):

    y = x @ dequant(w)ᵀ

* ``x``        — (M, K) float32,
* ``w_packed`` — (N, packed_len(K, bits)) uint8, codes packed along K,
* ``scale``    — (1, N) or (N,) per-output-channel float32 scale (per-tensor
                 is the broadcast special case), or for the group-scaled
                 variant (N, ⌈K/g⌉) scales along the contraction axis,
* ``bits``     — 2 / 4 / 8.

Code c dequantizes to ``scale · c / K``; group-scaled code (n, k) uses
``scale[n, k // g]``. The product accumulates in float32.
"""
from __future__ import annotations

import torch

from repro_torch.quant.formats import BY_BITS
from repro_torch.quant.pack import unpack_codes
from repro_torch.quant.quantize import expand_block_scale


def qmm_ref(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor, bits: int,
            k_dim: int) -> torch.Tensor:
    """Unpack, then a float32 product. Returns (M, N) float32."""
    codes = unpack_codes(w_packed, bits, k_dim)                    # (N, K) int8
    w = codes.to(torch.float32) / BY_BITS[bits].half_steps         # unit scale
    y = torch.matmul(x.to(torch.float32), w.T)
    return y * scale.reshape(1, -1)


def qmm_group_ref(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor, bits: int,
                  k_dim: int, group_size: int) -> torch.Tensor:
    """Group-scaled: scale (N, ⌈K/g⌉) multiplies each code before the
    product, as the reference dequantizes. Returns (M, N) float32."""
    codes = unpack_codes(w_packed, bits, k_dim)                    # (N, K) int8
    w = (codes.to(torch.float32) * expand_block_scale(scale, group_size, k_dim)
         / BY_BITS[bits].half_steps)
    return torch.matmul(x.to(torch.float32), w.T)
