"""Restricted-isometry machinery: RICs, γ, Lemma 1 bit bounds, Theorem 3 terms.

Port of ``repro.core.rip`` (paper §3.2, supplementary §7.3):

* the singular values of any column submatrix Φ_Γ interlace inside the
  extreme (nonzero) singular values of Φ, so ``γ̄ = σ_max/σ_min − 1`` on the
  full matrix upper-bounds every γ_|Γ| (paper Fig. 7 plots this γ̄);
* Lemma 1 turns a margin ε = 1/16 − γ̄ into a minimum bit width
  ``b ≥ log₂(2√|Γ| / (ε·α))`` that keeps γ̂ ≤ 1/16 after quantization;
* Theorem 3's error terms ε_s and ε_q come from the RICs.

The matrix functions run on Φ's device (the M×M Gram and ``eigvalsh``; one
batched gather and ``svdvals`` for the sampled RICs); the float formulas are
plain Python, the reference's own.
"""
from __future__ import annotations

import math

import torch

from repro_torch import random as prng
from repro_torch.core.threshold import hard_threshold


def singular_values(phi: torch.Tensor) -> torch.Tensor:
    """Nonzero-part singular values, descending, from the (M×M) Gram's
    eigenvalues (M ≪ N in compressive sensing: the cheap direction)."""
    gram = phi @ phi.conj().T
    ev = torch.linalg.eigvalsh(gram)
    return torch.sqrt(torch.clamp_min(ev.real if ev.is_complex() else ev, 0.0)).flip(0)


def gamma_full(phi: torch.Tensor) -> torch.Tensor:
    """Paper Fig. 7's γ = σ_max/σ_min − 1 over the full matrix's nonzero spectrum."""
    sv = singular_values(phi)
    smax = sv[0]
    smin = sv[min(phi.shape) - 1]
    return smax / torch.clamp_min(smin, 1e-30) - 1.0


def sampled_supports(n: int, s: int, n_samples: int = 32, key=None, device=None) -> torch.Tensor:
    """The (n_samples, s) int64 supports :func:`rics_sampled` draws: each is
    ``choice(k, n, s)`` without replacement for k in ``split(key, n_samples)``
    (``key`` defaults to ``PRNGKey(3)``), the reference's supports bit for bit."""
    key = key if key is not None else prng.PRNGKey(3)
    keys = prng.split(key, n_samples)
    return torch.stack([prng.choice(k, n, s, device=device) for k in keys]).to(torch.int64)


def rics_sampled(phi: torch.Tensor, s: int, n_samples: int = 32, key=None):
    """Empirical RICs: extreme singular values of Φ_Γ over random supports |Γ| = s.

    Returns (α̂_s, β̂_s) = (min over samples of σ_min, max of σ_max), a
    sampled estimate (exact RICs are NP-hard, §2). The supports are
    :func:`sampled_supports`; the n_samples submatrices are one batched
    gather (n_samples, M, s) and one ``svdvals``."""
    idx = sampled_supports(phi.shape[1], s, n_samples, key, device=phi.device)
    subs = phi[:, idx].permute(1, 0, 2)              # (n_samples, M, s)
    sv = torch.linalg.svdvals(subs)                   # descending per sample
    return sv[:, -1].min(), sv[:, 0].max()


def gamma_from_rics(alpha, beta) -> torch.Tensor:
    """γ_s = max(1 − α/β, β/α − 1), a float32 tensor as in the reference."""
    return torch.maximum(torch.as_tensor(1.0 - alpha / beta, dtype=torch.float32),
                         torch.as_tensor(beta / alpha - 1.0, dtype=torch.float32))


def effective_scale(scale) -> float:
    """Collapse a quantizer scale spec to the c_Φ entering Lemma 1's bounds.

    A scalar is the paper's per-tensor scale; a vector of per-group scales
    (per row for ``per_channel``, per block for ``per_block``) enters
    through its root-mean-square, since the Frobenius step of Eqn. 48 prices
    each column at rms(s) ≤ max(s): group scaling never raises the bound."""
    arr = torch.as_tensor(scale, dtype=torch.float32).detach().cpu()
    if arr.ndim == 0:
        return float(arr)
    if arr.numel() == 0:
        raise ValueError("scale vector must be non-empty")
    return float(torch.sqrt(torch.mean(arr * arr)))


def min_bits_lemma1(gamma: float, alpha: float, support_size: int,
                    target: float = 1.0 / 16.0, scale=1.0) -> int:
    """Lemma 1: smallest b with b ≥ log₂(2·c_Φ·√|Γ| / (ε·α)), ε = target − γ.

    ``scale`` is the quantizer's c_Φ (scalar, default 1) or a per-group
    scale vector (see :func:`effective_scale`). Returns 64 when γ already
    exceeds the target (no bit width can help)."""
    eps = target - float(gamma)
    if eps <= 0:
        return 64
    c = effective_scale(scale)
    b = math.log2(2.0 * c * math.sqrt(support_size) / (eps * float(alpha)))
    return max(2, math.ceil(b))


def gamma_hat_bound(gamma: float, alpha: float, support_size: int, bits: int,
                    scale=1.0) -> float:
    """Lemma 1's Eqn. 48: γ̂_|Γ| ≤ γ_|Γ| + c_Φ·√|Γ| / (2^{b−1}·α)."""
    c = effective_scale(scale)
    return float(gamma) + c * math.sqrt(support_size) / (2 ** (bits - 1) * float(alpha))


def eps_s(x: torch.Tensor, s: int, e_norm: float, beta_2s: float) -> torch.Tensor:
    """Theorem 2/3's ε_s = ‖x − xˢ‖₂ + ‖x − xˢ‖₁/√s + ‖e‖₂/β_2s."""
    tail = x - hard_threshold(x, s)
    sq = (tail * tail.conj()).real if tail.is_complex() else tail * tail
    root_s = torch.sqrt(torch.tensor(float(s), device=x.device))
    return torch.sqrt(sq.sum()) + tail.abs().sum() / root_s + e_norm / beta_2s


def eps_q(m: int, beta_2s_hat: float, xs_norm: float, bits_phi: int, bits_y: int,
          c_phi: float = 1.0, c_y: float = 1.0) -> float:
    """Theorem 3's quantization penalty
    ε_q = √M/β̂_2s · (c_Φ‖xˢ‖₂/2^{bΦ−1} + c_y/2^{b_y−1})."""
    return (math.sqrt(m) / beta_2s_hat) * (
        c_phi * xs_norm / 2 ** (bits_phi - 1) + c_y / 2 ** (bits_y - 1))


def corollary1_coeffs(n_antennas: int, beta_2s: float, beta_2s_hat: float):
    """Radio-astronomy error coefficients (Fig. 3): (√L/β_2s, L/β̂_2s)."""
    return math.sqrt(n_antennas) / beta_2s, n_antennas / beta_2s_hat


def theorem3_bound(n_iter: int, xs_norm: float, eps_s_val: float, eps_q_val: float) -> float:
    """E‖x̂ⁿ⁺¹ − xˢ‖ ≤ 2⁻ⁿ‖xˢ‖ + 10ε_s + 5ε_q."""
    return 2.0 ** (-n_iter) * xs_norm + 10.0 * eps_s_val + 5.0 * eps_q_val
