"""Configurations of the port (copies of ``repro.configs``' CS, MRI and
serving problems): ``CONFIGS`` by the names ``python -m
repro_torch.launch.recover --config`` takes, ``SERVE_CONFIGS`` by those of
``python -m repro_torch.launch.serve --config``."""
from repro_torch.configs import gaussian_toy, lofar_cs302, mri_brain, serve_batch

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

SERVE_CONFIGS = {
    "serve-gaussian": serve_batch.CONFIG,
    "serve-gaussian-packed": serve_batch.PACKED,
    "serve-gaussian-smoke": serve_batch.SMOKE,
    "serve-gaussian-fault": serve_batch.FAULT,
    "serve-gaussian-fault-packed": serve_batch.FAULT_PACKED,
    "serve-continuous": serve_batch.CONTINUOUS,
    "serve-continuous-packed": serve_batch.CONTINUOUS_PACKED,
    "serve-continuous-smoke": serve_batch.CONTINUOUS_SMOKE,
}
