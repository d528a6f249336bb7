"""Bit-packing of integer codes into uint8 words (port of ``repro.quant.pack``).

The layout is the contract the packed matmul shares with the reference:

* packing runs along the last axis (the contraction axis of the matmuls);
* codes are stored biased by +K, so they are non-negative in ``bits`` bits;
* code i of a byte sits at bit ``bits·i`` (8/bits codes per byte);
* the last axis is padded with code 0 (biased K) to a whole number of bytes.

Group-scaled (``per_block``) data packs the same way, its scales carried as a
separate f32 array; :func:`validate_group_packing` keeps every byte inside one
scale group.
"""
from __future__ import annotations

import torch

from repro_torch.quant.formats import BY_BITS


def validate_group_packing(group_size: int, bits: int) -> None:
    """Group-scaled packed storage needs every byte inside one scale group."""
    vpb = 8 // bits
    if group_size % vpb:
        raise ValueError(
            f"per_block group_size {group_size} must be a multiple of the "
            f"packing word ({vpb} values/byte at {bits} bits) so packed bytes "
            f"do not straddle scale groups")


def packed_len(n: int, bits: int) -> int:
    vpb = 8 // bits
    return (n + vpb - 1) // vpb


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack int8 codes in [-K, K] into uint8 words along the last axis."""
    fmt = BY_BITS[bits]
    vpb = fmt.values_per_byte
    n = codes.shape[-1]
    pad = (-n) % vpb
    biased = codes.to(torch.int32) + fmt.half_steps          # in [0, 2K] < 2^bits
    if pad:
        biased = torch.nn.functional.pad(biased, (0, pad), value=fmt.half_steps)
    if vpb == 1:
        return biased.to(torch.uint8)
    groups = biased.view(*biased.shape[:-1], (n + pad) // vpb, vpb)
    out = torch.zeros(groups.shape[:-1], dtype=torch.int32, device=codes.device)
    for i in range(vpb):
        out |= groups[..., i] << (bits * i)
    return out.to(torch.uint8)


def unpack_codes(packed: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes`; int8 codes with last axis length ``n``."""
    fmt = BY_BITS[bits]
    vpb = fmt.values_per_byte
    w = packed.to(torch.int32)
    if vpb == 1:
        biased = w
    else:
        mask = (1 << bits) - 1
        parts = [(w >> (bits * i)) & mask for i in range(vpb)]
        biased = torch.stack(parts, dim=-1).flatten(-2)
    return (biased[..., :n] - fmt.half_steps).to(torch.int8)
