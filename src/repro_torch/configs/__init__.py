"""Configurations of the port (copies of ``repro.configs``' CS and MRI
problems), by the names ``python -m repro_torch.launch.recover --config``
takes."""
from repro_torch.configs import gaussian_toy, lofar_cs302, mri_brain

CONFIGS = {
    "lofar": lofar_cs302.CONFIG,
    "lofar-bench": lofar_cs302.BENCH,
    "lofar-smoke": lofar_cs302.SMOKE,
    "gaussian": gaussian_toy.CONFIG,
    "gaussian-smoke": gaussian_toy.SMOKE,
    "mri": mri_brain.CONFIG,
    "mri-bench": mri_brain.BENCH,
    "mri-smoke": mri_brain.SMOKE,
    "mri-wavelet": mri_brain.WAVELET,
    "mri-wavelet-bench": mri_brain.WAVELET_BENCH,
    "mri-wavelet-smoke": mri_brain.WAVELET_SMOKE,
}
