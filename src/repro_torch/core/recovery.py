"""Recovery-quality metrics (port of ``repro.core.recovery``).

* relative recovery error ||x̂ − xˢ||₂ / ||xˢ||₂,
* exact (support) recovery ratio |supp(x̂) ∩ supp(x)| / s,
* source recovery within a pixel radius (the radio-astronomy metric),
* PSNR and SNR.
"""
from __future__ import annotations

import torch

from repro_torch.core.threshold import top_s_mask


def relative_error(x_hat: torch.Tensor, x_true: torch.Tensor) -> torch.Tensor:
    num = torch.linalg.vector_norm(x_hat - x_true.to(x_hat.dtype))
    den = torch.clamp(torch.linalg.vector_norm(x_true), min=1e-30)
    return num / den


def support_recovery(x_hat: torch.Tensor, x_true: torch.Tensor, s: int) -> torch.Tensor:
    """Fraction of the true top-s support recovered in the estimate's top-s."""
    both = top_s_mask(x_true, s) & top_s_mask(x_hat, s)
    return both.sum() / s


def _top_indices(v: torch.Tensor, n: int) -> torch.Tensor:
    return torch.sort(v.abs().reshape(-1), descending=True, stable=True).indices[:n]


def source_recovery(img_hat: torch.Tensor, img_true: torch.Tensor, n_sources: int,
                    tol_radius: int = 1) -> torch.Tensor:
    """True-positive rate of sources: a true source counts as resolved if one
    of the recovered image's top-n peaks lies within ``tol_radius`` pixels
    (Chebyshev distance)."""
    r = img_true.shape[0]
    idx_t = _top_indices(img_true, n_sources)
    idx_h = _top_indices(img_hat, n_sources)
    ti, tj = idx_t // r, idx_t % r
    hi, hj = idx_h // r, idx_h % r
    d = torch.maximum((ti[:, None] - hi[None, :]).abs(), (tj[:, None] - hj[None, :]).abs())
    return (d <= tol_radius).any(dim=1).to(torch.float32).mean()


def psnr(img_hat: torch.Tensor, img_true: torch.Tensor) -> torch.Tensor:
    mse = ((img_hat - img_true).abs() ** 2).mean()
    peak = img_true.abs().max()
    return 10.0 * torch.log10(peak ** 2 / torch.clamp(mse, min=1e-30))


def snr_db(signal: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    ps = torch.vdot(signal.reshape(-1), signal.reshape(-1)).real
    pn = torch.vdot(noise.reshape(-1), noise.reshape(-1)).real
    return 10.0 * torch.log10(ps / torch.clamp(pn, min=1e-30))
