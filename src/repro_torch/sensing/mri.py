"""The MRI workload (paper §5; port of ``repro.sensing.mri``): brain-image
recovery from quantized subsampled-Fourier (k-space) samples.

The scanner samples k-space; Φ = P_Ω F (orthonormal 2D DFT and a sampling
mask) is matrix-free (:class:`~repro_torch.core.operators.SubsampledFourierOperator`):
at 256×256 a dense partial-Fourier Φ would be ~2 GB. Anatomy is sparse in a
wavelet basis, not in pixels, so ``sparsity_basis="haar"|"db4"`` recovers the
whole phantom's wavelet coefficients through Φ = P_Ω F W†, and
``"pixel"`` the s-sparsified phantom through P_Ω F.

* phantoms: :func:`shepp_logan` and the randomized :func:`brain_phantom`;
* :func:`sparsify_image` and :func:`wavelet_coeffs`, the signal in each basis;
* :func:`cartesian_mask`, uniform or variable-density with a fully sampled
  center block, DC at [0, 0];
* :func:`mri_observations` and :func:`quantize_observations` (one scale, or
  one per radial k-space band: :func:`kspace_radial_bands`,
  :func:`kspace_band_scales`);
* :func:`make_mri_problem`, all of it in one call.

Instances are the reference's, key for key: the mask and the brain phantom
are drawn by numpy from a seed that :func:`repro_torch.random.randint`
takes from the key exactly as ``jax.random.randint`` does, so masks and
phantoms equal the reference's bit for bit. Everything is built on the CPU
and moved to ``device``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.core.operators import (
    ComposedOperator,
    SubsampledFourierOperator,
    WaveletSynthesisOperator,
)
from repro_torch.core.threshold import top_s_mask
from repro_torch.device import resolve_device
from repro_torch.quant.formats import BY_BITS
from repro_torch.quant.quantize import fake_quantize, quantize_codes
from repro_torch.transforms.wavelet import dwt2, flatten_coeffs

# Modified Shepp–Logan (Toft): (intensity, a, b, x0, y0, angle_deg) per ellipse.
_SHEPP_LOGAN = (
    (1.00, 0.6900, 0.9200, 0.00, 0.0000, 0.0),
    (-0.80, 0.6624, 0.8740, 0.00, -0.0184, 0.0),
    (-0.20, 0.1100, 0.3100, 0.22, 0.0000, -18.0),
    (-0.20, 0.1600, 0.4100, -0.22, 0.0000, 18.0),
    (0.10, 0.2100, 0.2500, 0.00, 0.3500, 0.0),
    (0.10, 0.0460, 0.0460, 0.00, 0.1000, 0.0),
    (0.10, 0.0460, 0.0460, 0.00, -0.1000, 0.0),
    (0.10, 0.0460, 0.0230, -0.08, -0.6050, 0.0),
    (0.10, 0.0230, 0.0230, 0.00, -0.6060, 0.0),
    (0.10, 0.0230, 0.0460, 0.06, -0.6050, 0.0),
)


def _render_ellipses(resolution: int, ellipses) -> np.ndarray:
    """Sum of constant-intensity ellipses on the [-1, 1]² grid → (r, r) f32."""
    lin = np.linspace(-1.0, 1.0, resolution)
    xx, yy = np.meshgrid(lin, lin, indexing="xy")
    img = np.zeros((resolution, resolution), np.float32)
    for inten, a, b, x0, y0, ang in ellipses:
        th = np.deg2rad(ang)
        xr = (xx - x0) * np.cos(th) + (yy - y0) * np.sin(th)
        yr = -(xx - x0) * np.sin(th) + (yy - y0) * np.cos(th)
        img += np.float32(inten) * ((xr / a) ** 2 + (yr / b) ** 2 <= 1.0)
    return np.clip(img, 0.0, None)


def _seed_from(key: torch.Tensor) -> int:
    """The numpy seed the reference takes from a key: randint(key, (), 0, 2³¹−1)."""
    return int(prng.randint(key, (), 0, 2**31 - 1))


def shepp_logan(resolution: int, device=None) -> torch.Tensor:
    """The modified Shepp–Logan head phantom, (r, r) float32 in [0, 1]."""
    return torch.from_numpy(_render_ellipses(resolution, _SHEPP_LOGAN)).to(
        resolve_device(device))


def brain_phantom(resolution: int, key: torch.Tensor, n_regions: int = 8,
                  device=None) -> torch.Tensor:
    """A randomized brain-like piecewise-constant image, (r, r) float32: a
    bright skull ring and ``n_regions`` random ellipses inside it."""
    rng = np.random.default_rng(_seed_from(key))
    ellipses = [(1.0, 0.72, 0.92, 0.0, 0.0, 0.0),
                (-0.75, 0.67, 0.86, 0.0, 0.0, 0.0)]
    for _ in range(n_regions):
        a = rng.uniform(0.05, 0.35)
        b = rng.uniform(0.05, 0.35)
        x0 = rng.uniform(-0.45, 0.45)
        y0 = rng.uniform(-0.55, 0.55)
        ellipses.append((rng.uniform(-0.2, 0.4), a, b, x0, y0, rng.uniform(0, 180)))
    img = np.clip(_render_ellipses(resolution, ellipses), 0.0, 1.0)
    return torch.from_numpy(img).to(resolve_device(device))


def sparsify_image(img: torch.Tensor, s: int) -> torch.Tensor:
    """The s largest-magnitude pixels as an (r²,) vector; ties go to the
    lower index, as ``lax.top_k`` breaks them."""
    flat = img.reshape(-1)
    return torch.where(top_s_mask(flat, s), flat, torch.zeros_like(flat))


def wavelet_coeffs(img: torch.Tensor, wavelet: str = "haar",
                   levels: Optional[int] = None) -> torch.Tensor:
    """W img: the wavelet coefficient vector (r²,) of an (r, r) image."""
    return flatten_coeffs(dwt2(img, wavelet, levels))


def cartesian_mask(resolution: int, fraction: float, key: torch.Tensor,
                   density: str = "variable", center_fraction: float = 0.04,
                   power: float = 3.0) -> np.ndarray:
    """A Cartesian k-space sampling mask, (r, r) boolean numpy, DC at [0, 0]:
    a fully sampled center block of ``center_fraction`` of k-space, then
    random points, uniform or with density ∝ (1 − d/d_max)^power, up to
    ``fraction`` of the grid."""
    if not 0.0 < fraction <= 1.0:
        raise ValueError(f"fraction must be in (0, 1], got {fraction}")
    if density not in ("uniform", "variable"):
        raise ValueError(f"unknown density {density!r} (use 'uniform' or 'variable')")
    r = resolution
    n_total = max(1, int(round(fraction * r * r)))

    lin = np.arange(r) - r // 2
    xx, yy = np.meshgrid(lin, lin, indexing="ij")
    dist = np.sqrt(xx**2 + yy**2) / np.sqrt(2.0) / (r // 2)

    mask = np.zeros((r, r), bool)
    half_c = max(1, int(round(np.sqrt(center_fraction) * r / 2)))
    c = r // 2
    mask[c - half_c:c + half_c, c - half_c:c + half_c] = True
    if int(mask.sum()) > n_total:
        raise ValueError(
            f"center block ({int(mask.sum())} samples) exceeds the requested "
            f"fraction ({n_total} samples); lower center_fraction below {fraction}")

    n_rand = n_total - int(mask.sum())
    if n_rand > 0:
        free = np.flatnonzero(~mask.ravel())
        if density == "uniform":
            p = np.ones(free.size)
        else:
            p = np.maximum(1.0 - np.clip(dist.ravel()[free], 0.0, 1.0), 1e-3) ** power
        p = p / p.sum()
        rng = np.random.default_rng(_seed_from(key))
        pick = rng.choice(free, size=min(n_rand, free.size), replace=False, p=p)
        mask.flat[pick] = True
    return np.fft.ifftshift(mask)


def kspace_radial_bands(op_or_indices, resolution: Optional[int] = None,
                        n_bands: int = 8) -> torch.Tensor:
    """Radial band index (0 = DC … n_bands−1 = corners) per k-space sample,
    int32, from an operator owning the k-space geometry (through
    ``kspace_op``) or flat DC-at-[0,0] indices with ``resolution``. Bands are
    annuli of equal radial width on the centered grid."""
    op_or_indices = getattr(op_or_indices, "kspace_op", op_or_indices)
    if isinstance(op_or_indices, SubsampledFourierOperator):
        idx, r = op_or_indices.indices, op_or_indices.resolution
    else:
        if resolution is None:
            raise ValueError("resolution required when passing raw indices")
        idx, r = torch.as_tensor(op_or_indices).to(torch.int32), int(resolution)
    if n_bands < 1:
        raise ValueError(f"n_bands must be >= 1, got {n_bands}")
    row, col = idx // r, idx % r
    fr = ((row + r // 2) % r) - r // 2
    fc = ((col + r // 2) % r) - r // 2
    dist = torch.sqrt(fr.to(torch.float32) ** 2 + fc.to(torch.float32) ** 2)
    d_max = torch.sqrt(torch.tensor(2.0, device=idx.device)) * (r / 2.0)
    band = torch.floor(dist / d_max * n_bands).to(torch.int32)
    return torch.clamp(band, 0, n_bands - 1)


def kspace_band_scales(y: torch.Tensor, bands: torch.Tensor, n_bands: int) -> torch.Tensor:
    """Per-band quantizer scale: the largest component magnitude in each band
    (real and imaginary share it); ``y`` (..., M) → (..., n_bands) f32, an
    empty or all-zero band at scale 1."""
    mag = torch.maximum(y.real.abs(), y.imag.abs()) if y.is_complex() else y.abs()
    flat = mag.reshape(-1, mag.shape[-1])
    # magnitudes are >= 0, so a zero start gives each non-empty band its max
    # (and an empty one 0, then 1) without an -inf fill
    s = torch.zeros((flat.shape[0], n_bands), dtype=mag.dtype, device=mag.device)
    s = s.scatter_reduce(-1, bands.to(torch.int64).expand(flat.shape[0], -1), flat,
                         reduce="amax", include_self=True)
    s = torch.where(s > 0, s, torch.ones_like(s))
    return s.reshape(*mag.shape[:-1], n_bands)


def quantize_observations(y: torch.Tensor, bits_y: int, key: torch.Tensor,
                          granularity: str = "per_tensor", op=None,
                          n_bands: int = 8) -> torch.Tensor:
    """The paper's b_y-bit stochastic quantization of the k-space samples
    (real and imaginary parts on one scale). ``per_tensor``: one scale, as
    ``fake_quantize``. ``per_band``: one scale per radial band of ``op``'s
    k-space geometry; every row of a batch folds the same keys, so row b
    reproduces the single-row call bit for bit."""
    if granularity == "per_tensor":
        return fake_quantize(y, bits_y, key)
    if granularity != "per_band":
        raise ValueError(
            f"unknown observation granularity {granularity!r} "
            "(use 'per_tensor' or 'per_band')")
    if op is None:
        raise ValueError("per_band quantization needs the sensing operator "
                         "(op=...) for the k-space band geometry")
    bands = kspace_radial_bands(op, n_bands=n_bands).to(torch.int64)
    scales = kspace_band_scales(y, bands, n_bands)
    kre, kim = prng.split(key)
    half_steps = BY_BITS[bits_y].half_steps

    def one(y_row, scale_row):
        s = scale_row[bands]
        cre, _ = quantize_codes(y_row.real, bits_y, kre, scale=s)
        cim, _ = quantize_codes(y_row.imag, bits_y, kim, scale=s)
        step = s / half_steps
        return torch.complex(cre.to(torch.float32) * step, cim.to(torch.float32) * step)

    if y.ndim == 1:
        return one(y, scales).to(y.dtype)
    flat_y = y.reshape(-1, y.shape[-1])
    flat_s = scales.reshape(-1, n_bands)
    rows = [one(flat_y[b], flat_s[b]) for b in range(flat_y.shape[0])]
    return torch.stack(rows).reshape(y.shape).to(y.dtype)


def mri_observations(op, x: torch.Tensor, snr_db: Optional[float],
                     key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """y = Φx + e with circularly-symmetric complex Gaussian noise at the
    given SNR (None: noiseless); x is (N,) or a batch (B, N). Returns (y, e)."""
    clean = op.mv(x)
    if snr_db is None:
        return clean, torch.zeros_like(clean)
    m = clean.shape[-1]
    sig_pow = (clean * clean.conj()).real.sum(dim=-1, keepdim=True)
    sigma = torch.sqrt(sig_pow / (10.0 ** (snr_db / 10.0)) / m / 2.0)
    kr, ki = prng.split(key)
    shape = tuple(clean.shape)
    e = (sigma * torch.complex(prng.normal(kr, shape, device=clean.device),
                               prng.normal(ki, shape, device=clean.device))).to(clean.dtype)
    return clean + e, e


SPARSITY_BASES = ("pixel", "haar", "db4")


@dataclasses.dataclass
class MRIProblem:
    """One subsampled-Fourier recovery instance (matrix-free Φ throughout).

    ``op`` is what the solver sees (P_Ω F for the pixel basis, P_Ω F W† for a
    wavelet basis) and ``x_true`` lives in that basis; ``image_true`` is the
    image-space truth (the whole phantom for a wavelet basis). Judge a
    recovered x through :meth:`to_image`."""

    op: object
    y: torch.Tensor
    e: torch.Tensor
    x_true: torch.Tensor
    resolution: int
    s: int
    sparsity_basis: str = "pixel"
    image_true: Optional[torch.Tensor] = None
    synthesis: Optional[WaveletSynthesisOperator] = None

    def __post_init__(self):
        if self.image_true is None:
            self.image_true = self.x_true

    def to_image(self, x: torch.Tensor) -> torch.Tensor:
        """Solver-basis vector(s) (…, r²) → image space (W† x for a wavelet
        basis), real part."""
        if self.synthesis is not None:
            x = self.synthesis.mv(x)
        return x.real if x.is_complex() else x


def make_mri_problem(resolution: int, s: int, fraction: float, key: torch.Tensor,
                     density: str = "variable", center_fraction: float = 0.04,
                     snr_db: Optional[float] = None, phantom: str = "shepp-logan",
                     sparsity_basis: str = "pixel", wavelet_levels: Optional[int] = None,
                     device=None) -> MRIProblem:
    """Phantom → truth in the chosen basis → mask → operator → observations,
    as the reference builds them from the same key (``split(key, 3)`` into
    phantom, mask and noise keys). Quantizing y is left to the solver's
    ``bits_y`` or to :func:`quantize_observations`."""
    if sparsity_basis not in SPARSITY_BASES:
        raise ValueError(
            f"unknown sparsity_basis {sparsity_basis!r} (use one of {SPARSITY_BASES})")
    dev = resolve_device(device)
    kimg, kmask, knoise = prng.split(key, 3)
    if phantom == "shepp-logan":
        img = shepp_logan(resolution, device=dev)
    elif phantom == "brain":
        img = brain_phantom(resolution, kimg, device=dev)
    else:
        raise ValueError(f"unknown phantom {phantom!r} (use 'shepp-logan' or 'brain')")
    mask = cartesian_mask(resolution, fraction, kmask, density, center_fraction)
    fourier = SubsampledFourierOperator.from_mask(mask, device=dev)
    if sparsity_basis == "pixel":
        x_true = sparsify_image(img, s)
        y, e = mri_observations(fourier, x_true, snr_db, knoise)
        return MRIProblem(op=fourier, y=y, e=e, x_true=x_true,
                          resolution=resolution, s=s)
    synthesis = WaveletSynthesisOperator(resolution, sparsity_basis, wavelet_levels)
    image_true = img.reshape(-1)
    x_true = wavelet_coeffs(img, sparsity_basis, synthesis.levels)
    y, e = mri_observations(fourier, image_true, snr_db, knoise)
    return MRIProblem(op=ComposedOperator(fourier, synthesis), y=y, e=e,
                      x_true=x_true, resolution=resolution, s=s,
                      sparsity_basis=sparsity_basis, image_true=image_true,
                      synthesis=synthesis)
