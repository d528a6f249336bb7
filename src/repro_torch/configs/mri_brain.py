"""The paper's MRI problem (§5): brain-image recovery from quantized
subsampled-Fourier (k-space) samples (a copy of ``repro.configs.mri_brain``).

Full experiment: 256×256 image (N = 65536 — a dense partial-Fourier Φ would be
~2 GB complex64, so this config only runs on the matrix-free
``SubsampledFourierOperator`` path), 35 % variable-density Cartesian sampling,
b_y ∈ {2,4,8,32}. ``BENCH`` is the CI-sized 128×128 version (N = 16384, still
far beyond what the dense solver path could hold as fake-quantized f32 pairs),
``SMOKE`` a 64×64 sanity size.

``scale_granularity``/``n_bands`` select the observation quantizer scale:
``"per_tensor"`` is the paper's single c_y; ``"per_band"`` carries one scale
per concentric radial k-space band (see ``repro_torch.sensing.quantize_observations``)
— the 4-byte-per-band overhead that keeps b_y < 8 usable against k-space's
dynamic range.

``sparsity_basis`` picks the recovery model: ``"pixel"`` thresholds the
phantom to its ``n_sparse`` largest pixels (the exact-sparsity toy);
``"haar"``/``"db4"`` keeps the **full** anatomy and recovers its wavelet
coefficients through the composed Φ = P_Ω F W† — the paper's actual brain
scenario. The ``WAVELET*`` configs are that mode with ``n_sparse`` sized for
approximate wavelet sparsity (~12% of N) and per-band observation scaling.
"""
import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MRIConfig:
    name: str
    resolution: int       # image is resolution × resolution (N = resolution²)
    n_sparse: int         # s: kept pixels (pixel basis) / wavelet coefficients
    fraction: float       # sampled fraction of k-space (M = fraction · N)
    density: str          # "uniform" | "variable" Cartesian sampling
    center_fraction: float
    snr_db: Optional[float]
    bits_y: int
    n_iters: int
    phantom: str = "shepp-logan"
    seed: int = 5
    scale_granularity: str = "per_tensor"   # "per_tensor" | "per_band"
    n_bands: int = 16                        # radial bands when per_band
    sparsity_basis: str = "pixel"            # "pixel" | "haar" | "db4"
    wavelet_levels: Optional[int] = None     # None → deepest valid pyramid


CONFIG = MRIConfig(
    name="mri-brain",
    resolution=256,
    n_sparse=2000,
    fraction=0.35,
    density="variable",
    center_fraction=0.04,
    snr_db=None,          # quantization is the noise under study (paper §5)
    bits_y=8,
    n_iters=60,
)

# CI-sized (same physics, smaller grid)
BENCH = dataclasses.replace(CONFIG, name="mri-brain-bench", resolution=128,
                            n_sparse=500, n_iters=40)
SMOKE = dataclasses.replace(CONFIG, name="mri-brain-smoke", resolution=64,
                            n_sparse=120, n_iters=25)

# Full-image wavelet recovery (Φ = P_Ω F W†): the unsparsified phantom,
# s ≈ 12% of N wavelet coefficients, per-band k-space scaling by default.
WAVELET = dataclasses.replace(CONFIG, name="mri-brain-wavelet",
                              sparsity_basis="haar", n_sparse=8000,
                              scale_granularity="per_band")
WAVELET_BENCH = dataclasses.replace(WAVELET, name="mri-brain-wavelet-bench",
                                    resolution=128, n_sparse=2000, n_iters=40)
WAVELET_SMOKE = dataclasses.replace(WAVELET, name="mri-brain-wavelet-smoke",
                                    resolution=64, n_sparse=500, n_iters=25)
