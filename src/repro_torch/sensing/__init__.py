"""Problem generators of the port: Gaussian toy, LOFAR station sky and MRI,
and the radio astronomer's dirty image and beam (the names of ``repro.sensing``)."""
from repro_torch.sensing.gaussian import CSProblem, make_gaussian_problem
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
from repro_torch.sensing.sky import ascii_render, make_sky, to_image
from repro_torch.sensing.telescope import (
    Station,
    dirty_beam,
    dirty_image,
    measurement_matrix,
    sky_grid,
    tune_extent_for_gamma,
    visibilities,
)

__all__ = [
    "CSProblem",
    "make_gaussian_problem",
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
    "ascii_render",
    "make_sky",
    "to_image",
    "Station",
    "dirty_beam",
    "dirty_image",
    "measurement_matrix",
    "sky_grid",
    "tune_extent_for_gamma",
    "visibilities",
]
