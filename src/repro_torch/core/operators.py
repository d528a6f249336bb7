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
* :class:`SubsampledFourierOperator` — matrix-free Φ = P_Ω F: an orthonormal
  2D FFT (``torch.fft``) and a k-space sampling mask, the MRI workload
  (paper §5); only the sample indices are stored.
* :class:`WaveletSynthesisOperator` — the orthonormal synthesis W†
  (:mod:`repro_torch.transforms.wavelet`).
* :class:`ComposedOperator` — ``B ∘ A`` with the exact adjoint ``A† ∘ B†``;
  the CS-MRI model Φ = P_Ω F W† is the Fourier factor composed with W†.

Every operator has ``mv``/``rmv`` (batched over a leading axis, one
application for the whole batch), ``shape`` (m, n), ``dtype`` (what ``mv``
returns) and ``nbytes`` (operator bytes one application reads), as in the
reference.

:func:`make_iteration_operators` maps Φ and the quantization knobs onto the
per-iteration (gradient, residual) operator pair, with the reference's key
folding, so that the port draws the same Φ̂ as the reference key for key; a
matrix-free operator passes through as its own pair.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.device import resolve_device
from repro_torch.kernels.qmm.kernel import ROW_LOCAL_ROWS
from repro_torch.kernels.qmm.ops import (
    PackedOperator,
    pack_operator,
    packed_matvec,
    packed_rmatvec,
)
from repro_torch.quant.formats import Granularity, as_granularity
from repro_torch.quant.quantize import fake_quantize
from repro_torch.transforms.wavelet import (
    dwt2,
    idwt2,
    resolve_levels,
    wavelet_filters,
)


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

    @property
    def independent_rows(self) -> int:
        """The most rows of a batch that ``mv``/``rmv`` compute each alone, so
        that row b has the bits of a batch of one: on the card
        :data:`~repro_torch.kernels.qmm.kernel.ROW_LOCAL_ROWS` (``chip_smoke.py``
        holds the kernels to that), on the CPU 1 (the plain version is a
        torch.matmul, which does not promise it)."""
        return ROW_LOCAL_ROWS if self.packed.fwd_re.packed.is_cuda else 1

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return packed_matvec(self.packed, x)

    def rmv(self, r: torch.Tensor) -> torch.Tensor:
        return packed_rmatvec(self.packed, r)


class SubsampledFourierOperator:
    """Matrix-free Φ = P_Ω F: the orthonormal 2D DFT of an r×r image, taken
    at the flat k-space positions Ω (DC at [0, 0]).

    ``mv`` is ``torch.fft.fft2(norm="ortho")`` and a gather; ``rmv`` its exact
    adjoint, a zero-filled scatter and ``ifft2(norm="ortho")``. ``nbytes``
    counts the stored sampling pattern: int32 indices and the 1-bit mask."""

    def __init__(self, indices: torch.Tensor, resolution: int):
        self.indices = indices.to(torch.int32)      # (M,), flat positions in the r×r grid
        self._gather = self.indices.to(torch.int64)
        self.resolution = int(resolution)

    @classmethod
    def from_mask(cls, mask, device=None) -> "SubsampledFourierOperator":
        """From an (r, r) boolean numpy mask; the indices go to ``device``."""
        m = np.asarray(mask, bool)
        if m.ndim != 2 or m.shape[0] != m.shape[1]:
            raise ValueError(f"mask must be a square (r, r) boolean array, got {m.shape}")
        if not m.any():
            raise ValueError("empty sampling mask: no k-space positions selected")
        idx = torch.from_numpy(np.flatnonzero(m.ravel()).astype(np.int32))
        return cls(idx.to(resolve_device(device)), m.shape[0])

    @property
    def shape(self):
        return (int(self.indices.shape[0]), self.resolution * self.resolution)

    @property
    def dtype(self):
        return torch.complex64

    @property
    def nbytes(self) -> int:
        return int(self.indices.shape[0]) * 4 + math.ceil(self.resolution ** 2 / 8)

    def mask(self) -> torch.Tensor:
        """(r, r) boolean k-space sampling mask (from the indices)."""
        r = self.resolution
        out = torch.zeros(r * r, dtype=torch.bool, device=self.indices.device)
        return out.index_fill_(0, self._gather, True).reshape(r, r)

    @property
    def kspace_op(self) -> "SubsampledFourierOperator":
        """The factor owning the k-space geometry (itself)."""
        return self

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        r = self.resolution
        k = torch.fft.fft2(x.reshape(*x.shape[:-1], r, r), norm="ortho").to(self.dtype)
        return k.reshape(*x.shape[:-1], r * r).index_select(-1, self._gather)

    def rmv(self, v: torch.Tensor) -> torch.Tensor:
        r = self.resolution
        full = torch.zeros((*v.shape[:-1], r * r), dtype=self.dtype, device=v.device)
        full.index_copy_(-1, self._gather, v.to(self.dtype))
        img = torch.fft.ifft2(full.reshape(*v.shape[:-1], r, r), norm="ortho")
        return img.reshape(*v.shape[:-1], r * r).to(self.dtype)


class WaveletSynthesisOperator:
    """Matrix-free orthonormal wavelet synthesis W†: coefficients → image.

    ``mv`` is :func:`~repro_torch.transforms.wavelet.idwt2` on the (r²,)
    coefficient vector, ``rmv`` (its exact adjoint, W) the forward
    :func:`~repro_torch.transforms.wavelet.dwt2`; both take complex input
    component-wise. ``nbytes`` counts the 2·L float32 filter taps."""

    def __init__(self, resolution: int, wavelet: str = "haar",
                 levels: Optional[int] = None):
        self.resolution = int(resolution)
        self.wavelet = str(wavelet)
        wavelet_filters(self.wavelet)          # validates the spelling
        self.levels = resolve_levels(self.resolution, self.wavelet, levels)

    @property
    def shape(self):
        n = self.resolution * self.resolution
        return (n, n)

    @property
    def dtype(self):
        return torch.float32

    @property
    def nbytes(self) -> int:
        lo, hi = wavelet_filters(self.wavelet)
        return 4 * (len(lo) + len(hi))

    def mv(self, c: torch.Tensor) -> torch.Tensor:
        r = self.resolution
        img = idwt2(c.reshape(*c.shape[:-1], r, r), self.wavelet, self.levels)
        return img.reshape(*c.shape[:-1], r * r)

    def rmv(self, x: torch.Tensor) -> torch.Tensor:
        r = self.resolution
        co = dwt2(x.reshape(*x.shape[:-1], r, r), self.wavelet, self.levels)
        return co.reshape(*x.shape[:-1], r * r)


class ComposedOperator:
    """``ComposedOperator(B, A)`` applies x ↦ B(A x), with the exact adjoint
    r ↦ A†(B† r). ``shape`` is (B.shape[0], A.shape[1]), ``dtype`` the outer
    factor's, ``nbytes`` the sum of the factors'; ``kspace_op`` surfaces the
    factor that owns the k-space geometry (per-band observation scales)."""

    def __init__(self, outer, inner):
        if outer.shape[1] != inner.shape[0]:
            raise ValueError(
                f"cannot compose: outer expects inputs of size {outer.shape[1]}, "
                f"inner produces size {inner.shape[0]}")
        self.outer = outer
        self.inner = inner

    @property
    def shape(self):
        return (self.outer.shape[0], self.inner.shape[1])

    @property
    def dtype(self):
        return self.outer.dtype

    @property
    def nbytes(self) -> int:
        return self.outer.nbytes + self.inner.nbytes

    @property
    def kspace_op(self):
        """The factor exposing k-space geometry, through nested compositions."""
        for f in (self.outer, self.inner):
            op = getattr(f, "kspace_op", None)
            if op is not None:
                return op
        raise AttributeError("no factor of this composition owns k-space geometry")

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return self.outer.mv(self.inner.mv(x))

    def rmv(self, r: torch.Tensor) -> torch.Tensor:
        return self.inner.rmv(self.outer.rmv(r))


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
