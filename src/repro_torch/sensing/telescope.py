"""Radio-interferometer pipeline: station geometry → measurement matrix Φ.

Port of ``repro.sensing.telescope`` (paper supplementary §7):

* L antennas at positions p_i; the ordered pairs (i, k), i ≠ k, form the
  baselines u_ik = (p_i − p_k)/λ₀ (M = L(L−1)),
* the sky is an r×r grid of direction cosines (l, m) ∈ [−d, d]² (N = r²),
* Φ_{z,w} = exp(−j2π ⟨u_z, r_w⟩),
* visibilities y = Φx + e with e ~ CN(0, σ² I),
* the radio astronomer's own products: the dirty image Re(Φ†y)/M and the
  dirty beam, and the extent sweep of supplementary §7.3 (Fig. 7).

:class:`Station` stays numpy and copies the reference's seeded antenna layout,
so Φ is the same matrix in both packages; the noise is drawn from
:mod:`repro_torch.random` under the reference's keys.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.device import resolve_device

C_LIGHT = 299_792_458.0  # m/s


@dataclasses.dataclass(frozen=True)
class Station:
    """An interferometer station configuration (pseudo-LOFAR LBA field)."""

    n_antennas: int = 30
    freq_hz: float = 50e6          # LOFAR low band (15–80 MHz)
    field_radius_m: float = 40.0   # LBA field radius
    seed: int = 302                # deterministic layout
    include_autocorrelations: bool = False

    @property
    def wavelength(self) -> float:
        return C_LIGHT / self.freq_hz

    @property
    def n_baselines(self) -> int:
        l = self.n_antennas
        return l * l if self.include_autocorrelations else l * (l - 1)

    def antenna_positions(self) -> np.ndarray:
        """(L, 2) meters, uniform in the disc, deterministic in ``seed``."""
        rng = np.random.default_rng(self.seed)
        r = self.field_radius_m * np.sqrt(rng.uniform(size=self.n_antennas))
        th = rng.uniform(0, 2 * np.pi, size=self.n_antennas)
        return np.stack([r * np.cos(th), r * np.sin(th)], axis=1)

    def baselines(self) -> np.ndarray:
        """(M, 2) baselines in wavelengths (autocorrelations excluded by default)."""
        p = self.antenna_positions()
        d = (p[:, None, :] - p[None, :, :]) / self.wavelength
        d = d.reshape(-1, 2)
        if not self.include_autocorrelations:
            l = self.n_antennas
            d = d[~np.eye(l, dtype=bool).ravel()]
        return d


def sky_grid(resolution: int, extent: float = 0.4) -> np.ndarray:
    """(r², 2) direction cosines (l, m) on a regular grid over [−d, d]²."""
    lin = np.linspace(-extent, extent, resolution)
    ll, mm = np.meshgrid(lin, lin, indexing="ij")
    return np.stack([ll.ravel(), mm.ravel()], axis=1)


def measurement_matrix(station: Station, resolution: int, extent: float = 0.4,
                       dtype: torch.dtype = torch.complex64, device=None) -> torch.Tensor:
    """Φ ∈ C^{M × r²}: Φ_{z,w} = exp(−j2π ⟨u_z, r_w⟩), built on ``device``.

    The phase is the K=2 product written out elementwise in float32 (no
    library matmul, so no TF32 on the card)."""
    dev = resolve_device(device)
    uv = torch.as_tensor(station.baselines(), dtype=torch.float32, device=dev)
    grid = torch.as_tensor(sky_grid(resolution, extent), dtype=torch.float32, device=dev)
    dot = uv[:, 0:1] * grid[None, :, 0] + uv[:, 1:2] * grid[None, :, 1]
    phase = dot * (-2.0 * math.pi)
    return torch.polar(torch.ones_like(phase), phase).to(dtype)


def visibilities(phi: torch.Tensor, x: torch.Tensor, snr_db: Optional[float],
                 key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """y = Φx + e with circularly-symmetric complex Gaussian noise at the given
    antenna-level SNR (paper §4 uses 0 dB): the real and imaginary parts from
    the two halves of ``split(key)``. Returns (y, e)."""
    clean_y = phi @ x.to(phi.dtype)
    if snr_db is None:
        return clean_y, torch.zeros_like(clean_y)
    m = clean_y.shape[0]
    sig_pow = torch.vdot(clean_y, clean_y).real
    sigma = torch.sqrt(sig_pow / (10.0 ** (snr_db / 10.0)) / m / 2.0)
    kr, ki = prng.split(key)
    re = prng.normal(kr, (m,), device=phi.device)
    im = prng.normal(ki, (m,), device=phi.device)
    e = (sigma * torch.complex(re, im)).to(phi.dtype)
    return clean_y + e, e


def dirty_image(phi: torch.Tensor, y: torch.Tensor, resolution: int) -> torch.Tensor:
    """The back-projection Re(Φ†y)/M as an (r, r) image (the 'dirty image')."""
    x = (phi.conj().T @ y).real / phi.shape[0]
    return x.reshape(resolution, resolution)


def dirty_beam(phi: torch.Tensor, resolution: int) -> torch.Tensor:
    """The point-spread function: the dirty image of a unit source at the
    grid centre."""
    n = resolution * resolution
    center = (resolution // 2) * resolution + resolution // 2
    delta = torch.zeros((n,), dtype=phi.dtype, device=phi.device)
    delta[center] = 1.0
    return dirty_image(phi, phi @ delta, resolution)


def tune_extent_for_gamma(station: Station, resolution: int, extents,
                          target: float = 1.0 / 16.0, device=None):
    """Supplementary §7.3 / Fig. 7: sweep the grid extent d and report γ(d).

    Returns a list of (d, gamma) and the largest d meeting γ ≤ target (or
    None). Each extent's Φ is freed before the next one is built (at LOFAR
    size each is 456 MB)."""
    from repro_torch.core.rip import gamma_full

    results = []
    best = None
    for d in extents:
        phi = measurement_matrix(station, resolution, float(d), device=device)
        g = float(gamma_full(phi))
        del phi
        results.append((float(d), g))
        if g <= target:
            best = float(d) if best is None else max(best, float(d))
    return results, best
