"""Numeric formats for low-precision data representation.

The PyTorch port keeps its own copy of ``repro.quant.formats`` (pure Python;
the port imports nothing of the JAX package).

The paper (Remark 3) uses a symmetric grid with an *odd* number of levels so that
zero is exactly representable and FPGA fixed-point arithmetic stays symmetric:

    levels  L(b) = 2^(b-1) + 1     equally spaced on [-1, 1]
    half-range steps  K(b) = 2^(b-2) ... more precisely K = (L-1)/2 = 2^(b-2) * 2 / 2

i.e. integer code ``k`` in ``[-K, +K]`` with value ``scale * k / K`` where
``K = 2^(b-1) / 2 = 2^(b-2+1)/2``.  Concretely::

    b=2 -> L=3,   K=1,  codes {-1, 0, +1}          (ternary)
    b=4 -> L=9,   K=4,  codes {-4 ... +4}
    b=8 -> L=129, K=64, codes {-64 ... +64}

The inter-level spacing is ``Delta = scale / K = scale / 2^(b-2) / 2`` and matches
Lemma 4's bound ``E||Q(v)-v||_2 <= c_v * sqrt(M) / 2^(b-1)`` exactly
(per-element worst expected error = Delta/2 = scale/2^(b-1)).

Codes always fit two's-complement ``b`` bits (|k| <= 2^(b-2)*2 <= 2^(b-1)-? ...
b=2: |k|<=1 < 2; b=4: |k|<=4 < 8; b=8: |k|<=64 < 128), so packed storage uses
exactly ``b`` bits per value.

Scaling granularity & storage layout
------------------------------------
(guide with examples: ``docs/quantization.md``)


The paper's Q_b uses ONE scale per tensor (c_Φ, c_y). That single scale is what
collapses aggressive bit-widths on high-dynamic-range data (k-space: huge DC
energy, tiny high frequencies — see BENCH_mri.json int4/int2), so the scale may
instead be carried at three :class:`Granularity` levels, always along the
**last axis** (the contraction/packing axis of the matmuls):

* ``per_tensor``            — scale is a scalar. Bit-identical to the historical
  behaviour; what the paper's Lemma 4 / Theorem 3 constants (c_v) assume.
* ``per_channel`` (per_row) — one scale per leading index, i.e. the scale array
  has the tensor's shape with the last axis reduced to 1 (keepdims). For an
  (N, K) weight matrix this is one scale per output channel N.
* ``per_block(g)``          — the last axis is split into ⌈n/g⌉ contiguous
  groups of ``g`` elements (the final group may be short); the scale array has
  shape ``(..., ⌈n/g⌉)``. Element ``v[..., j]`` dequantizes with
  ``scale[..., j // g]``.

Storage layout for packed per_block data: codes are packed along the last axis
exactly as per_tensor (``pack_codes``), and the scale vector rides alongside as
f32 — ``4·⌈n/g⌉`` extra bytes per row, i.e. a ``32/(g·bits)`` relative stream
overhead (g=64 @ 4 bits: +1.6%). ``g`` must be a multiple of the packing word
(``8//bits`` values per byte) so no packed byte straddles two scale groups.

Lemma 4's per-element bound sharpens per block: ``|Q(v)-v| <= scale_blk /
2^(b-1)`` with ``scale_blk = max|v_blk|`` the *local* dynamic range.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

SUPPORTED_BITS = (2, 4, 8)

GRANULARITY_KINDS = ("per_tensor", "per_channel", "per_block")


@dataclasses.dataclass(frozen=True)
class Granularity:
    """How many quantization scales a tensor carries (see module docstring).

    ``kind`` is one of ``per_tensor`` / ``per_channel`` / ``per_block``;
    ``group_size`` is required (and only meaningful) for ``per_block``.
    Hashable and immutable, so it can key caches and travel as plain
    configuration.
    """

    kind: str = "per_tensor"
    group_size: Optional[int] = None

    def __post_init__(self):
        if self.kind not in GRANULARITY_KINDS:
            raise ValueError(
                f"granularity kind must be one of {GRANULARITY_KINDS}, got {self.kind!r}")
        if self.kind == "per_block":
            if not isinstance(self.group_size, int) or self.group_size < 1:
                raise ValueError(
                    f"per_block needs a positive integer group_size, got {self.group_size!r}")
        elif self.group_size is not None:
            raise ValueError(f"group_size only applies to per_block, got kind={self.kind!r}")

    @property
    def is_per_tensor(self) -> bool:
        return self.kind == "per_tensor"

    def n_groups(self, n: int) -> int:
        """Number of scale entries along a last axis of length ``n``."""
        if self.kind == "per_tensor":
            return 1
        if self.kind == "per_channel":
            return 1  # per leading index; the last axis itself holds one group
        return (n + self.group_size - 1) // self.group_size

    def scale_nbytes(self, shape) -> int:
        """Bytes of f32 scale data carried for a tensor of ``shape``."""
        if self.kind == "per_tensor":
            return 4
        lead = 1
        for d in shape[:-1]:
            lead *= d
        return 4 * lead * self.n_groups(shape[-1])

    def __str__(self) -> str:
        if self.kind == "per_block":
            return f"per_block:{self.group_size}"
        return self.kind


PER_TENSOR = Granularity("per_tensor")
PER_CHANNEL = Granularity("per_channel")


def per_block(group_size: int) -> Granularity:
    return Granularity("per_block", group_size)


def as_granularity(
    g: Union[Granularity, str, None],
    group_size: Optional[int] = None,
) -> Granularity:
    """Coerce CLI/config spellings into a :class:`Granularity`.

    Accepts a Granularity (passed through), ``None`` (per_tensor), or a string:
    ``"per_tensor"``, ``"per_channel"`` / ``"per_row"``, ``"per_block"``
    (``group_size`` then required, either via the argument or the
    ``"per_block:64"`` inline form).
    """
    if g is None:
        return PER_TENSOR
    if isinstance(g, Granularity):
        return g
    name = str(g)
    if ":" in name:
        name, _, gs = name.partition(":")
        group_size = int(gs)
    if name == "per_row":
        name = "per_channel"
    if name == "per_block":
        return Granularity("per_block", group_size)
    if group_size is not None:
        raise ValueError(f"group_size given but granularity is {name!r}, not per_block")
    return Granularity(name)


@dataclasses.dataclass(frozen=True)
class QuantFormat:
    """A symmetric odd-level integer format with ``bits`` bits per value."""

    bits: int

    def __post_init__(self):
        if self.bits not in SUPPORTED_BITS:
            raise ValueError(f"bits must be one of {SUPPORTED_BITS}, got {self.bits}")

    @property
    def levels(self) -> int:
        """Number of representable levels (odd)."""
        return 2 ** (self.bits - 1) + 1

    @property
    def half_steps(self) -> int:
        """K: number of positive steps; codes live in [-K, K] (K = 2^(b-1)/2)."""
        return 2 ** (self.bits - 1) // 2

    @property
    def values_per_byte(self) -> int:
        return 8 // self.bits

    @property
    def code_min(self) -> int:
        return -self.half_steps

    @property
    def code_max(self) -> int:
        return self.half_steps

    def expected_error_bound(self, scale: float, m: int) -> float:
        """Lemma 4: E||Q(v) - v||_2 <= c_v * sqrt(M) / 2^(b-1)."""
        return scale * (m ** 0.5) / (2 ** (self.bits - 1))


INT2 = QuantFormat(2)
INT4 = QuantFormat(4)
INT8 = QuantFormat(8)

BY_BITS = {2: INT2, 4: INT4, 8: INT8}
