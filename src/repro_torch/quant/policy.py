"""Quantization policy (port of ``repro.quant.policy``).

A :class:`QuantPolicy` says which tensors carry the low-precision data
representation and at what width: weights, KV cache and gradients on the
model side, ``phi_bits``/``y_bits`` (the paper's b_Φ and b_y) on the CS
solver's, and how many scales the quantized data carries
(``scale_granularity``/``group_size``, see :mod:`repro_torch.quant.formats`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.quant.formats import Granularity, as_granularity

VALID_BITS = (None, 2, 4, 8)


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    weight_bits: Optional[int] = None
    kv_bits: Optional[int] = None
    grad_bits: Optional[int] = None
    stochastic: bool = True
    # CS solver data precision (paper notation b_Phi & b_y)
    phi_bits: Optional[int] = None
    y_bits: Optional[int] = None
    # the string spelling keeps the frozen dataclass hashable and serializable
    scale_granularity: str = "per_tensor"
    group_size: Optional[int] = None

    def __post_init__(self):
        for name in ("weight_bits", "kv_bits", "grad_bits", "phi_bits", "y_bits"):
            v = getattr(self, name)
            if v not in VALID_BITS:
                raise ValueError(f"{name} must be in {VALID_BITS}, got {v}")
        self.granularity  # validates the spelling eagerly

    @property
    def granularity(self) -> Granularity:
        return as_granularity(self.scale_granularity, self.group_size)

    @property
    def quantizes_weights(self) -> bool:
        return self.weight_bits is not None

    @property
    def quantizes_kv(self) -> bool:
        return self.kv_bits is not None

    @property
    def quantizes_grads(self) -> bool:
        return self.grad_bits is not None


FULL_PRECISION = QuantPolicy()
W8 = QuantPolicy(weight_bits=8)
W4 = QuantPolicy(weight_bits=4)
W4KV8 = QuantPolicy(weight_bits=4, kv_bits=8)
W2KV8 = QuantPolicy(weight_bits=2, kv_bits=8)
PAPER_2_8 = QuantPolicy(phi_bits=2, y_bits=8)   # the paper's headline "2&8 bit" IHT
PAPER_4_8 = QuantPolicy(phi_bits=4, y_bits=8)
PAPER_8_8 = QuantPolicy(phi_bits=8, y_bits=8)
