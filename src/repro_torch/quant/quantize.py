"""Stochastic quantization Q_b in PyTorch (port of ``repro.quant.quantize``).

``quantize`` maps a float (or complex) tensor onto the symmetric odd-level
integer grid of :mod:`repro_torch.quant.formats`. With ``key`` given it rounds
stochastically with the uniforms of :mod:`repro_torch.random`, which are the
reference's ``jax.random.uniform`` draws word for word, so codes match the
reference bit for bit. Without a key it rounds to nearest.

Scales: ``per_tensor`` (the paper's single c_v), ``per_channel`` (one scale
per leading index, or per ``channel_axis``) and ``per_block(g)`` (one scale per
g contiguous elements of the last axis, the last group possibly short; the
scale then has the compact shape ``(..., ⌈n/g⌉)``). Complex tensors are
quantized component-wise, real and imaginary parts sharing one scale per
group; the imaginary part draws from the second key of ``split(key)``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch import random as prng
from repro_torch.quant.formats import (
    BY_BITS,
    PER_TENSOR,
    Granularity,
    QuantFormat,
    as_granularity,
)

_REAL_OF = {torch.complex64: torch.float32, torch.complex128: torch.float64}


class QTensor:
    """Integer codes + scale + bit width + granularity.

    ``dequantize()`` returns ``codes * (scale / K)``, expanding per-block
    scales along the last axis. Complex tensors carry codes with a leading
    axis of size 2 (real, imaginary).
    """

    def __init__(self, codes: torch.Tensor, scale: torch.Tensor, bits: int,
                 is_complex: bool = False, granularity: Granularity = PER_TENSOR):
        self.codes = codes
        self.scale = scale
        self.bits = int(bits)
        self.is_complex = bool(is_complex)
        self.granularity = as_granularity(granularity)

    @property
    def fmt(self) -> QuantFormat:
        return BY_BITS[self.bits]

    @property
    def shape(self):
        return self.codes.shape[1:] if self.is_complex else self.codes.shape

    def elementwise_scale(self) -> torch.Tensor:
        """The scale each code dequantizes with, broadcastable to ``shape``."""
        if self.granularity.kind == "per_block":
            return expand_block_scale(self.scale, self.granularity.group_size,
                                      self.shape[-1])
        return self.scale

    def dequantize(self, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        step = self.elementwise_scale() / self.fmt.half_steps
        vals = self.codes.to(torch.float32) * step
        if self.is_complex:
            if dtype is not None:
                vals = vals.to(_REAL_OF[dtype])
            out = torch.complex(vals[0], vals[1])
            return out.to(dtype) if dtype is not None else out
        return vals.to(dtype) if dtype is not None else vals


def _guard_zero(m: torch.Tensor) -> torch.Tensor:
    # an all-zero group would give scale 0 and NaNs on dequantization
    return torch.where(m > 0, m, torch.ones_like(m))


def _max_abs(v: torch.Tensor, dims=None) -> torch.Tensor:
    a = v.abs()
    if dims is None:
        return _guard_zero(a.amax())
    return _guard_zero(a.amax(dim=dims, keepdim=True))


def block_scale(v: torch.Tensor, group_size: int) -> torch.Tensor:
    """Per-block max-abs along the last axis: (..., n) → (..., ⌈n/g⌉)."""
    n = v.shape[-1]
    nb = (n + group_size - 1) // group_size
    pad = nb * group_size - n
    if pad:
        v = torch.nn.functional.pad(v, (0, pad))
    blocks = v.abs().reshape(*v.shape[:-1], nb, group_size)
    return _guard_zero(blocks.amax(dim=-1))


def expand_block_scale(scale: torch.Tensor, group_size: int, n: int) -> torch.Tensor:
    """Inverse broadcast of :func:`block_scale`: (..., ⌈n/g⌉) → (..., n)."""
    return torch.repeat_interleave(scale, group_size, dim=-1)[..., :n]


def _granular_scale(v: torch.Tensor, gran: Granularity) -> torch.Tensor:
    if gran.kind == "per_tensor":
        return _max_abs(v)
    if gran.kind == "per_channel":
        return _max_abs(v, dims=v.ndim - 1)
    return block_scale(v, gran.group_size)


def quantize_codes(
    v: torch.Tensor,
    bits: int,
    key: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
    channel_axis: Optional[int] = None,
    granularity: Union[Granularity, str, None] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize a real tensor to int8 codes in [-K, K]; returns (codes, scale).

    The scale is the per-tensor max-abs, the per-channel max-abs (keepdims)
    when ``channel_axis`` is given or ``granularity`` is per_channel, the
    compact per-block max-abs ``(..., ⌈n/g⌉)`` for per_block, or the ``scale``
    passed in (in the compact per-group shape for per_block). Values are
    clipped to [-scale, scale] first."""
    fmt = BY_BITS[bits]
    k = fmt.half_steps
    gran = as_granularity(granularity)
    if channel_axis is not None:
        if not gran.is_per_tensor:
            raise ValueError("pass either channel_axis or granularity, not both")
        if scale is None:
            dims = tuple(a for a in range(v.ndim) if a != channel_axis)
            scale = _max_abs(v, dims=dims)
        scale_elem = scale
    else:
        if scale is None:
            scale = _granular_scale(v, gran)
        scale_elem = (expand_block_scale(scale, gran.group_size, v.shape[-1])
                      if gran.kind == "per_block" else scale)
    scaled = torch.clamp(v / scale_elem, -1.0, 1.0) * k
    if key is None:
        codes = torch.round(scaled)
    else:
        low = torch.floor(scaled)
        p_up = scaled - low
        u = prng.uniform(key, tuple(v.shape), device=v.device)
        codes = low + (u < p_up).to(torch.float32)
    codes = torch.clamp(codes, -k, k).to(torch.int8)
    return codes, scale


def quantize(
    v: torch.Tensor,
    bits: int,
    key: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
    channel_axis: Optional[int] = None,
    granularity: Union[Granularity, str, None] = None,
) -> QTensor:
    """Quantize a real or complex tensor into a :class:`QTensor`."""
    gran = as_granularity(granularity)
    if v.is_complex():
        re, im = v.real, v.imag
        if scale is None:
            if channel_axis is not None:
                raise NotImplementedError("per-channel complex quantization unused")
            scale = torch.maximum(_granular_scale(re, gran), _granular_scale(im, gran))
        if key is not None:
            kre, kim = prng.split(key)
        else:
            kre = kim = None
        cre, _ = quantize_codes(re, bits, kre, scale, granularity=gran)
        cim, _ = quantize_codes(im, bits, kim, scale, granularity=gran)
        return QTensor(torch.stack([cre, cim]), scale, bits, is_complex=True,
                       granularity=gran)
    codes, scale = quantize_codes(v, bits, key, scale, channel_axis, gran)
    return QTensor(codes, scale, bits, is_complex=False, granularity=gran)


def dequantize_codes(codes: torch.Tensor, scale: torch.Tensor, bits: int,
                     dtype: torch.dtype = torch.float32,
                     granularity: Union[Granularity, str, None] = None) -> torch.Tensor:
    gran = as_granularity(granularity)
    if gran.kind == "per_block":
        scale = expand_block_scale(scale, gran.group_size, codes.shape[-1])
    return (codes.to(torch.float32) * (scale / BY_BITS[bits].half_steps)).to(dtype)


def fake_quantize(
    v: torch.Tensor,
    bits: int,
    key: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
    channel_axis: Optional[int] = None,
    granularity: Union[Granularity, str, None] = None,
) -> torch.Tensor:
    """Quantize-dequantize round trip, dtype-preserving (f32/f64/c64/c128)."""
    return quantize(v, bits, key, scale, channel_axis, granularity).dequantize(v.dtype)
