"""Problem generators of the port: Gaussian toy, LOFAR station sky and MRI."""
from repro_torch.sensing.mri import (
    MRIProblem,
    brain_phantom,
    cartesian_mask,
    kspace_band_scales,
    kspace_radial_bands,
    make_mri_problem,
    mri_observations,
    quantize_observations,
    shepp_logan,
    sparsify_image,
    wavelet_coeffs,
)

__all__ = [
    "MRIProblem",
    "brain_phantom",
    "cartesian_mask",
    "kspace_band_scales",
    "kspace_radial_bands",
    "make_mri_problem",
    "mri_observations",
    "quantize_observations",
    "shepp_logan",
    "sparsify_image",
    "wavelet_coeffs",
]
