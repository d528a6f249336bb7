"""Gaussian toy problem (paper supplementary §10; port of ``repro.sensing.gaussian``).

Φ and e are i.i.d. Gaussian and x is s-sparse. Instances are the
reference's, key for key: :mod:`repro_torch.random` draws them under the
same ``split(key, 4)``, so the support equals the reference's bit for bit and
Φ, x and e agree to 1e-6 relative (``normal``'s erfinv polynomial).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import random as prng
from repro_torch.device import resolve_device


@dataclasses.dataclass
class CSProblem:
    phi: torch.Tensor
    y: torch.Tensor
    x_true: torch.Tensor
    e: torch.Tensor
    s: int


def make_gaussian_problem(
    m: int = 256,
    n: int = 512,
    s: int = 16,
    snr_db: Optional[float] = 10.0,
    key: Optional[torch.Tensor] = None,
    x_dist: str = "gaussian",
    phi: Optional[torch.Tensor] = None,
    device=None,
) -> CSProblem:
    """Random dense-Gaussian CS instance (Φ_ij ~ N(0, 1)).

    Pass ``phi`` to reuse one measurement matrix across problems (many
    observations of one Φ); only the sparse signal and the noise are drawn
    from ``key`` then. ``key`` defaults to ``PRNGKey(0)``, ``device`` to
    ``cuda``."""
    dev = resolve_device(device)
    key = key if key is not None else prng.PRNGKey(0)
    kphi, kx, kflux, ke = prng.split(key, 4)
    if phi is None:
        phi = prng.normal(kphi, (m, n), device=dev)
    elif tuple(phi.shape) != (m, n):
        raise ValueError(f"shared phi shape {tuple(phi.shape)} != ({m}, {n})")
    else:
        phi = phi.to(dev)
    idx = prng.choice(kx, n, s, device=dev).to(torch.int64)
    if x_dist == "gaussian":
        vals = prng.normal(kflux, (s,), device=dev)
    elif x_dist == "signs":
        vals = torch.sign(prng.normal(kflux, (s,), device=dev))
    else:
        raise ValueError(x_dist)
    x = torch.zeros((n,), dtype=torch.float32, device=dev)
    x[idx] = vals
    clean_y = phi @ x
    if snr_db is None:
        e = torch.zeros((m,), dtype=torch.float32, device=dev)
    else:
        sig_pow = torch.dot(clean_y, clean_y)
        sigma = torch.sqrt(sig_pow / (10.0 ** (snr_db / 10.0)) / m)
        e = sigma * prng.normal(ke, (m,), device=dev)
    return CSProblem(phi=phi, y=clean_y + e, x_true=x, e=e, s=s)
