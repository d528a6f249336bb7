"""Linear-operator backends for the (Q)NIHT loop (port of ``repro.core.operators``).

The solver touches Φ̂ only through ``mv(x)`` (Φ̂x, batched (B, n) → (B, m))
and ``rmv(r)`` (Φ̂†r), so one loop runs on:

* :class:`DenseOperator` — an f32/c64 matrix and ``torch.matmul``; also the
  ``requantize="fixed"`` fake-quantized carrier (quantized values stored as
  dense floats).
* :class:`FakeQuantPairOperator` — Algorithm 1's fresh pair (Φ̂_{2n-1},
  Φ̂_{2n}) per iteration (``requantize="pair"``).
* :class:`PackedStreamingOperator` — packed uint8 codes streamed through the
  ``qmm`` kernel: 4/8/16× fewer operator bytes per application at 8/4/2 bits.

:func:`make_iteration_operators` maps Φ and the quantization knobs onto the
per-iteration (gradient, residual) operator pair, with the reference's key
folding, so that the port draws the same Φ̂ as the reference key for key.
The matrix-free MRI operators are not yet ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import random as prng
from repro_torch.kernels.qmm.ops import (
    PackedOperator,
    pack_operator,
    packed_matvec,
    packed_rmatvec,
)
from repro_torch.quant.formats import Granularity, as_granularity
from repro_torch.quant.quantize import fake_quantize


class DenseOperator:
    """Φ̂ as a dense (m, n) tensor; streams itemsize bytes per entry per application."""

    def __init__(self, mat: torch.Tensor):
        self.mat = mat

    @property
    def shape(self):
        return tuple(self.mat.shape)

    @property
    def dtype(self):
        return self.mat.dtype

    @property
    def nbytes(self) -> int:
        return self.mat.numel() * self.mat.element_size()

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.mat.dtype)
        return torch.matmul(x.to(dt), self.mat.to(dt).T)

    def rmv(self, r: torch.Tensor) -> torch.Tensor:
        m = self.mat.conj() if self.mat.is_complex() else self.mat
        dt = torch.promote_types(r.dtype, m.dtype)
        return torch.matmul(r.to(dt), m.to(dt))


class FakeQuantPairOperator:
    """Fresh stochastic pair (Φ̂_{2n-1}, Φ̂_{2n}) per iteration, from keys
    ``fold_in(key, 2i)`` and ``fold_in(key, 2i + 1)``."""

    def __init__(self, phi: torch.Tensor, bits: int, key: torch.Tensor):
        self.phi = phi
        self.bits = int(bits)
        self.key = key

    @property
    def shape(self):
        return tuple(self.phi.shape)

    @property
    def dtype(self):
        return self.phi.dtype

    @property
    def nbytes(self) -> int:
        return self.phi.numel() * self.phi.element_size()

    def at_iteration(self, i: int) -> tuple[DenseOperator, DenseOperator]:
        k1 = prng.fold_in(self.key, 2 * i)
        k2 = prng.fold_in(self.key, 2 * i + 1)
        return (DenseOperator(fake_quantize(self.phi, self.bits, k1)),
                DenseOperator(fake_quantize(self.phi, self.bits, k2)))


class PackedStreamingOperator:
    """Φ̂ as packed uint8 codes, applied through the ``qmm`` kernels.

    Per-tensor scale (the default): both orientations are packed once from
    one shared quantization, so the codes equal ``fake_quantize(phi, bits,
    key)``'s and every application streams ``bits/32`` of the f32 bytes.
    ``per_channel``/``per_block`` scales follow each orientation's own axes,
    so each orientation (and each part of a complex Φ) is quantized
    separately; the adjoint identity then holds to quantization error, and
    the f32 scales add ``scale_nbytes`` to the stream.
    """

    def __init__(self, packed: PackedOperator):
        self.packed = packed

    @classmethod
    def pack(cls, phi: torch.Tensor, bits: int, key: Optional[torch.Tensor] = None,
             granularity=None) -> "PackedStreamingOperator":
        gran = as_granularity(granularity)
        if gran.is_per_tensor:
            return cls(pack_operator(phi, bits, key, shared=True))
        return cls(pack_operator(phi, bits, key, shared=False, granularity=gran))

    @property
    def bits(self) -> int:
        return self.packed.fwd_re.bits

    @property
    def granularity(self) -> Granularity:
        return self.packed.fwd_re.granularity

    @property
    def scale_nbytes(self) -> int:
        """f32 scale bytes streamed per application (forward orientation)."""
        n = self.packed.fwd_re.scale_nbytes
        if self.packed.is_complex:
            n += self.packed.fwd_im.scale_nbytes
        return n

    @property
    def shape(self):
        return (self.packed.fwd_re.packed.shape[0], self.packed.adj_re.packed.shape[0])

    @property
    def dtype(self):
        return torch.complex64 if self.packed.is_complex else torch.float32

    @property
    def nbytes(self) -> int:
        n = self.packed.fwd_re.nbytes
        if self.packed.is_complex:
            n += self.packed.fwd_im.nbytes
        return n

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return packed_matvec(self.packed, x)

    def rmv(self, r: torch.Tensor) -> torch.Tensor:
        return packed_rmatvec(self.packed, r)


def is_linear_operator(phi) -> bool:
    """True when ``phi`` follows the operator protocol (``mv``/``rmv``)."""
    return hasattr(phi, "mv") and hasattr(phi, "rmv")


def as_operator(phi):
    """Dense (M, N) tensor → :class:`DenseOperator`; operators pass through."""
    return phi if is_linear_operator(phi) else DenseOperator(phi)


def make_iteration_operators(phi, bits_phi, requantize, backend, key, granularity=None):
    """``(phi_true, get_ops)``: ``phi_true`` applies full-precision Φ (for the
    true-residual trace), ``get_ops(i)`` yields iteration i's (gradient,
    residual) operators. Same dispatch and key folding as the reference;
    ``granularity`` reaches only the packed backend."""
    if is_linear_operator(phi):
        return phi, lambda i: (phi, phi)
    phi_true = DenseOperator(phi)
    if backend == "packed":
        op = PackedStreamingOperator.pack(phi, bits_phi, prng.fold_in(key, 0),
                                          granularity=granularity)
        return phi_true, lambda i: (op, op)
    if bits_phi and requantize == "pair":
        return phi_true, FakeQuantPairOperator(phi, bits_phi, key).at_iteration
    if bits_phi:
        op = DenseOperator(fake_quantize(phi, bits_phi, prng.fold_in(key, 0)))
        return phi_true, lambda i: (op, op)
    return phi_true, lambda i: (phi_true, phi_true)
