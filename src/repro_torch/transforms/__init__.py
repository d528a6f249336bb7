"""Sparsifying transforms: the W of transform-domain compressed sensing
(port of ``repro.transforms``)."""
from repro_torch.transforms.wavelet import (
    WAVELETS,
    dwt2,
    flatten_coeffs,
    idwt2,
    max_levels,
    unflatten_coeffs,
    wavelet_filters,
)

__all__ = [
    "WAVELETS",
    "dwt2",
    "flatten_coeffs",
    "idwt2",
    "max_levels",
    "unflatten_coeffs",
    "wavelet_filters",
]
