"""Baseline sparse-recovery algorithms the paper compares against (Fig. 4, Fig. 9).

Port of ``repro.core.baselines``:

* :func:`iht` — classic IHT, unit step on a spectrally-normalized matrix.
* :func:`cosamp` — Compressive Sampling Matching Pursuit (Needell & Tropp).
* :func:`fista_l1` — ℓ1 convex relaxation via FISTA (complex soft thresholding).
* :func:`clean` — Högbom CLEAN (radio-astronomy deconvolution, supplementary §7.5).

The reference's ``lax.scan`` loops are Python loops with a static trip count
that read nothing back to the host: traces stay on the device and are
stacked at the end. Top-k picks take the lower index on ties (a stable
descending sort, as ``lax.top_k``), and CLEAN's peak is the first maximum
(``argmax``), its beam shifted by a modular gather on the device in place of
``jnp.roll`` by a traced shift.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.core.threshold import hard_threshold


def _sqnorm(v: torch.Tensor) -> torch.Tensor:
    return (v * v.conj()).real.sum() if v.is_complex() else (v * v).sum()


def _rmv(phi: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return phi.conj().T @ r if phi.is_complex() else phi.T @ r


def _mv(phi: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Φx, with x promoted to Φ's dtype as JAX promotes it."""
    return phi @ x.to(torch.promote_types(phi.dtype, x.dtype))


def _top_indices(v: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest |v|, ties to the lower index (``lax.top_k``)."""
    return torch.sort(v.abs(), descending=True, stable=True).indices[:k]


def spectral_norm(phi: torch.Tensor, iters: int = 30,
                  key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """‖Φ‖₂ by power iteration on Φ†Φ from a normal start vector drawn from
    ``key`` (default ``PRNGKey(7)``)."""
    key = key if key is not None else prng.PRNGKey(7)
    v = prng.normal(key, (phi.shape[1],), device=phi.device)
    if phi.is_complex():
        v = v.to(phi.dtype)
    v = v / torch.sqrt(_sqnorm(v))
    for _ in range(iters):
        w = _rmv(phi, phi @ v)
        v = w / (torch.sqrt(_sqnorm(w)) + 1e-30)
    return torch.sqrt(_sqnorm(phi @ v))


def iht(phi: torch.Tensor, y: torch.Tensor, s: int, n_iters: int = 50,
        real_signal: bool = False):
    """Traditional IHT (µ = 1). It needs ‖Φ‖₂ < 1, so Φ and y are rescaled
    together by 1/(1.01‖Φ‖₂) (Remark 1: that leaves the problem unchanged).
    Returns (x, resid) with resid the (n_iters,) trace ‖y − Φx‖₂."""
    scale = 1.0 / (spectral_norm(phi) * 1.01)
    phi_s = phi * scale
    y_s = y * scale
    x = torch.zeros((phi.shape[1],), dtype=torch.float32 if real_signal else y.dtype,
                    device=y.device)
    resid = []
    for _ in range(n_iters):
        g = _rmv(phi_s, y_s - _mv(phi_s, x))
        a = x.to(g.dtype) + g
        if real_signal and a.is_complex():
            a = a.real
        x = hard_threshold(a.to(x.dtype), s)
        resid.append(torch.sqrt(_sqnorm(y - _mv(phi, x))))
    return x, torch.stack(resid)


def cosamp(phi: torch.Tensor, y: torch.Tensor, s: int, n_iters: int = 20,
           real_signal: bool = False):
    """CoSaMP with fixed-size candidate supports.

    The candidates are the top 2s of the proxy and the current support's s,
    3s gathered columns that may repeat an index: the ridge least-squares
    fit is scattered back by adding (``index_add_``), which keeps each
    repeated column's contribution. Returns (x, resid)."""
    n = phi.shape[1]
    x = torch.zeros((n,), dtype=torch.float32 if real_signal else y.dtype, device=y.device)
    resid = []
    for _ in range(n_iters):
        g = _rmv(phi, y - _mv(phi, x))
        idx = torch.cat([_top_indices(g, 2 * s), _top_indices(x, s)])     # (3s,)
        cols = phi[:, idx]                                                 # (M, 3s)
        a = cols.conj().T @ cols
        ridge = 1e-6 * torch.diagonal(a).sum().real / (3 * s)
        a = a + ridge * torch.eye(3 * s, dtype=a.dtype, device=a.device)
        # solve_ex: the same solve without reading its status back to the host
        b = torch.linalg.solve_ex(a, cols.conj().T @ y.to(cols.dtype)).result
        full = torch.zeros((n,), dtype=b.dtype, device=b.device).index_add_(0, idx, b)
        if real_signal and full.is_complex():
            full = full.real
        x = hard_threshold(full.to(x.dtype), s)
        resid.append(torch.sqrt(_sqnorm(y - _mv(phi, x))))
    return x, torch.stack(resid)


def _fista_momenta(n_iters: int) -> list[float]:
    """(t_k − 1)/t_{k+1} of FISTA's t sequence (t₀ = 1), in float32 as the
    reference carries t: the sequence does not depend on the data, so it is
    computed on the host once and the loop reads nothing back."""
    t = np.float32(1.0)
    out = []
    for _ in range(n_iters):
        t_new = np.float32(0.5) * (np.float32(1.0) + np.sqrt(np.float32(1.0)
                                                             + np.float32(4.0) * t * t))
        out.append(float((t - np.float32(1.0)) / t_new))
        t = t_new
    return out


def fista_l1(phi: torch.Tensor, y: torch.Tensor, lam=None, n_iters: int = 100,
             real_signal: bool = False):
    """FISTA on ½‖y − Φx‖² + λ‖x‖₁ (complex soft thresholding); λ defaults
    to 0.01·max|Φ†y|. Returns (x, resid)."""
    l_lip = spectral_norm(phi) ** 2
    g0 = _rmv(phi, y)
    if lam is None:
        lam = 0.01 * g0.abs().max()
    step_t = 1.0 / (l_lip + 1e-30)
    dtype = torch.float32 if real_signal else g0.dtype
    x = z = torch.zeros((phi.shape[1],), dtype=dtype, device=y.device)
    thresh = step_t * lam
    resid = []
    for momentum in _fista_momenta(n_iters):
        grad = _rmv(phi, _mv(phi, z) - y)
        w = z.to(grad.dtype) - step_t * grad
        if real_signal and w.is_complex():
            w = w.real
        mag = w.abs()
        x_new = (w * torch.clamp_min(mag - thresh, 0.0) / torch.clamp_min(mag, 1e-30)).to(dtype)
        z = x_new + momentum * (x_new - x)
        x = x_new
        resid.append(torch.sqrt(_sqnorm(y - _mv(phi, x))))
    return x, torch.stack(resid)


def _peak_index(resid: torch.Tensor) -> torch.Tensor:
    """Flat index of the first pixel of largest |residual| (a device scalar)."""
    return torch.argmax(resid.abs().reshape(-1))


def clean(dirty_image: torch.Tensor, dirty_beam: torch.Tensor, gain: float = 0.1,
          n_iters: int = 200, threshold: float = 0.0):
    """Högbom CLEAN on an (r, r) dirty image with an (r, r) dirty beam (its
    peak at the centre pixel; shifts are periodic, as ``jnp.roll``'s).

    Each step takes the first pixel of largest |residual|, subtracts gain ×
    its value × the beam centred there, and adds that amount to the
    component image. Returns (comps, resid, peaks), peaks the (n_iters,)
    max |residual| after each step. Supplementary Fig. 9: CLEAN is about the
    first IHT iteration and takes noise for sources at 0 dB SNR."""
    r = dirty_image.shape[0]
    dev = dirty_image.device
    beam = dirty_beam / dirty_beam.abs().max()
    center = r // 2
    ar = torch.arange(r, device=dev)
    resid = dirty_image
    comps = torch.zeros_like(dirty_image)
    peaks = []
    for _ in range(n_iters):
        p = _peak_index(resid)
        pi, pj = p // r, p % r
        peak = torch.take(resid, p)
        amount = torch.where(peak.abs() > threshold, gain * peak, torch.zeros_like(peak))
        # jnp.roll(beam, (pi − c, pj − c)) as a gather: out[i, j] = beam[i − pi + c, j − pj + c]
        rows = (ar - pi + center) % r
        cols = (ar - pj + center) % r
        shifted = beam[rows[:, None], cols[None, :]]
        resid = resid - amount * shifted
        comps.index_put_((pi[None], pj[None]), amount[None], accumulate=True)
        peaks.append(resid.abs().max())
    return comps, resid, torch.stack(peaks)
