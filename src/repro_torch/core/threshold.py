"""Hard thresholding H_s (port of ``repro.core.threshold``), batched over rows.

Ties between equal magnitudes go to the lower index, as ``jax.lax.top_k``
breaks them: the top s come from a stable descending sort, not ``torch.topk``
(whose tie order is unspecified, and differs on CUDA).
"""
from __future__ import annotations

import torch


def top_s_mask(x: torch.Tensor, s: int) -> torch.Tensor:
    """Boolean mask of the s largest |x| along the last axis."""
    mag = x.abs()
    idx = torch.sort(mag, dim=-1, descending=True, stable=True).indices[..., :s]
    mask = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    return mask.scatter_(-1, idx, True)


def hard_threshold(x: torch.Tensor, s: int) -> torch.Tensor:
    """Exact H_s on the last axis: zero all but the s largest |x_i| of each row."""
    if s >= x.shape[-1]:
        return x
    return torch.where(top_s_mask(x, s), x, torch.zeros_like(x))


def support(x: torch.Tensor) -> torch.Tensor:
    """Boolean support mask of x."""
    return x.abs() > 0
