"""Periodized orthonormal 2D discrete wavelet transform (port of
``repro.transforms.wavelet``).

The W of the CS-MRI model Φ = P_Ω F W†: a multi-level DWT with conjugate
quadrature mirror filters and periodized (circular) boundaries, so every level
is a square orthogonal map and the synthesis W† is the exact adjoint of the
analysis W.

Filters: ``"haar"`` (2 taps) and ``"db4"`` (the 4-tap Daubechies filter,
pywt's ``db2``); the high-pass taps are ``hi[t] = (−1)^t · lo[L−1−t]``.

Layout: after ``levels`` steps an ``(r, r)`` array holds the coarsest
approximation in its top-left ``(r >> levels)``-square and each level's detail
blocks around it, as in the reference.

PyTorch idiom in place of the reference's index arithmetic in a ``lax.scan``:
one level along one axis of the active ``m × m`` block is the product with
the ``(m, m)`` analysis matrix A_m, whose row k < m/2 holds ``lo[t]`` at
columns ``(2k + t) mod m`` and row m/2 + k holds ``hi[t]`` there. A level is
then ``A_m · X · A_mᵀ`` on the block, and its inverse ``A_mᵀ · X · A_m``:
two matmuls per level whatever the filter length, where the tap sums would
take some thirty small launches. Every entry of A_m is one of the taps in
float32, as the reference multiplies; the sums may round in another order
(within 1e-6 of the reference). Every function maps over leading axes, real
or complex.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

_SQRT3 = math.sqrt(3.0)
_D4_NORM = 4.0 * math.sqrt(2.0)

# Orthonormal low-pass analysis taps (sum of squares = 1).
WAVELETS = {
    "haar": (1.0 / math.sqrt(2.0), 1.0 / math.sqrt(2.0)),
    "db4": (
        (1.0 + _SQRT3) / _D4_NORM,
        (3.0 + _SQRT3) / _D4_NORM,
        (3.0 - _SQRT3) / _D4_NORM,
        (1.0 - _SQRT3) / _D4_NORM,
    ),
}


def wavelet_filters(wavelet: str) -> tuple[tuple[float, ...], tuple[float, ...]]:
    """(lo, hi) analysis taps; ``hi`` is the QMF mirror of ``lo``."""
    if wavelet not in WAVELETS:
        raise ValueError(
            f"unknown wavelet {wavelet!r} (available: {sorted(WAVELETS)})")
    lo = WAVELETS[wavelet]
    n = len(lo)
    hi = tuple((-1.0) ** t * lo[n - 1 - t] for t in range(n))
    return lo, hi


def max_levels(resolution: int, wavelet: str = "haar") -> int:
    """Deepest valid pyramid: every transformed block must be even-sized and
    at least one filter length wide."""
    flen = len(wavelet_filters(wavelet)[0])
    lv = 0
    m = resolution
    while m % 2 == 0 and m >= flen and m > 1:
        lv += 1
        m //= 2
    return lv


def resolve_levels(resolution: int, wavelet: str, levels: Optional[int]) -> int:
    """``levels``, or the deepest valid pyramid when None; raises when out of range."""
    cap = max_levels(resolution, wavelet)
    if cap < 1:
        raise ValueError(
            f"resolution {resolution} admits no {wavelet!r} level "
            "(needs an even size >= the filter length)")
    if levels is None:
        return cap
    if not 1 <= levels <= cap:
        raise ValueError(
            f"levels must be in [1, {cap}] for resolution {resolution} "
            f"and wavelet {wavelet!r}, got {levels}")
    return levels


@functools.lru_cache(maxsize=64)
def _analysis_matrix(m: int, wavelet: str, dtype: torch.dtype, device: str) -> torch.Tensor:
    """A_m: row k < m/2 is the approximation a[k] = Σ_t lo[t]·x[(2k+t) mod m],
    row m/2 + k the detail with ``hi``; entries are the float32 taps. Cached
    per (size, wavelet, dtype, device); callers must not write to it."""
    lo, hi = wavelet_filters(wavelet)
    a = torch.zeros((m, m), dtype=torch.float32)
    half = m // 2
    for t, (lt, ht) in enumerate(zip(lo, hi)):
        for k in range(half):
            a[k, (2 * k + t) % m] += lt
            a[half + k, (2 * k + t) % m] += ht
    return a.to(dtype=dtype, device=device)


def _matrix(m: int, wavelet: str, like: torch.Tensor) -> torch.Tensor:
    return _analysis_matrix(m, wavelet, like.dtype, str(like.device))


def _square(x: torch.Tensor, who: str) -> int:
    r = x.shape[-1]
    if x.shape[-2] != r:
        raise ValueError(f"{who} expects square arrays, got {tuple(x.shape[-2:])}")
    return r


def dwt2(img: torch.Tensor, wavelet: str = "haar",
         levels: Optional[int] = None) -> torch.Tensor:
    """Multi-level periodized 2D DWT: ``(..., r, r)`` image → same-shape
    pyramid coefficient array. Orthonormal: ``‖dwt2(x)‖₂ = ‖x‖₂``."""
    r = _square(img, "dwt2")
    lv = resolve_levels(r, wavelet, levels)
    out = img.clone()
    for level in range(lv):
        m = r >> level
        a = _matrix(m, wavelet, out)
        out[..., :m, :m] = a @ out[..., :m, :m] @ a.T
    return out


def idwt2(coeffs: torch.Tensor, wavelet: str = "haar",
          levels: Optional[int] = None) -> torch.Tensor:
    """Inverse of :func:`dwt2` (synthesis W†): coefficient pyramid → image;
    being the transpose of an orthonormal map, also its exact adjoint."""
    r = _square(coeffs, "idwt2")
    lv = resolve_levels(r, wavelet, levels)
    out = coeffs.clone()
    for level in reversed(range(lv)):
        m = r >> level
        a = _matrix(m, wavelet, out)
        out[..., :m, :m] = a.T @ out[..., :m, :m] @ a
    return out


def flatten_coeffs(coeffs: torch.Tensor) -> torch.Tensor:
    """Pyramid array ``(..., r, r)`` → coefficient vector ``(..., r²)``."""
    r = coeffs.shape[-1]
    return coeffs.reshape(*coeffs.shape[:-2], r * r)


def unflatten_coeffs(vec: torch.Tensor, resolution: int) -> torch.Tensor:
    """Coefficient vector ``(..., r²)`` → pyramid array ``(..., r, r)``."""
    return vec.reshape(*vec.shape[:-1], resolution, resolution)
