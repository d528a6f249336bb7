"""Gaussian toy problem (paper supplementary §10; port of ``repro.sensing.gaussian``).

Φ and e are i.i.d. Gaussian and x is s-sparse. Instances come from a
``torch.Generator`` (drawn on the CPU, then moved to ``device``), so they do
not match the reference's ``jax.random`` draws; tests hand the reference's
instances across with :mod:`repro_torch.convert` instead.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

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
    generator: Optional[torch.Generator] = None,
    x_dist: str = "gaussian",
    phi: Optional[torch.Tensor] = None,
    device=None,
) -> CSProblem:
    """Random dense-Gaussian CS instance (Φ_ij ~ N(0, 1)).

    Pass ``phi`` to reuse one measurement matrix across problems (many
    observations of one Φ); only the sparse signal and the noise are drawn then.
    ``device`` defaults to ``cuda``."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    if phi is None:
        phi = torch.randn((m, n), generator=gen, dtype=torch.float32).to(dev)
    elif tuple(phi.shape) != (m, n):
        raise ValueError(f"shared phi shape {tuple(phi.shape)} != ({m}, {n})")
    else:
        phi = phi.to(dev)
    idx = torch.randperm(n, generator=gen)[:s]
    if x_dist == "gaussian":
        vals = torch.randn((s,), generator=gen, dtype=torch.float32)
    elif x_dist == "signs":
        vals = torch.sign(torch.randn((s,), generator=gen, dtype=torch.float32))
    else:
        raise ValueError(x_dist)
    x = torch.zeros((n,), dtype=torch.float32)
    x[idx] = vals
    x = x.to(dev)
    clean_y = phi @ x
    if snr_db is None:
        e = torch.zeros((m,), dtype=torch.float32, device=dev)
    else:
        sig_pow = torch.dot(clean_y, clean_y)
        sigma = torch.sqrt(sig_pow / (10.0 ** (snr_db / 10.0)) / m)
        e = sigma * torch.randn((m,), generator=gen, dtype=torch.float32).to(dev)
    return CSProblem(phi=phi, y=clean_y + e, x_true=x, e=e, s=s)
