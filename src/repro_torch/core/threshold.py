"""Hard thresholding H_s (port of ``repro.core.threshold``), batched over rows.

* :func:`hard_threshold` — exact, the top s magnitudes of each row. Ties
  between equal magnitudes go to the lower index, as ``jax.lax.top_k`` breaks
  them: the top s come from a stable descending sort, not ``torch.topk``
  (whose tie order is unspecified, and differs on CUDA).
* :func:`hard_threshold_bisect` — the FPGA-style sort-free variant (paper §8):
  a fixed number of bisection steps on the magnitude range finds the
  threshold, then threshold ties are filled in ascending-index order up to s.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.hsthresh.ref import tie_fill_mask


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


def _bisect_bracket(mag: torch.Tensor, s: int, iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Final bisection bracket (lo, hi) per row: count(mag > hi) <= s, and
    every magnitude tied at the threshold lies in (lo, hi]."""
    hi = mag.amax(dim=-1)
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        too_many = (mag > mid.unsqueeze(-1)).sum(dim=-1) > s
        lo = torch.where(too_many, mid, lo)
        hi = torch.where(too_many, hi, mid)
    return lo, hi


def find_threshold_bisect(mag: torch.Tensor, s: int, iters: int = 32) -> torch.Tensor:
    """Per row, t with count(mag > t) <= s after ``iters`` halvings of
    [0, max(mag)] (below f32 resolution at 32)."""
    return _bisect_bracket(mag, s, iters)[1]


def hard_threshold_bisect(x: torch.Tensor, s: int, iters: int = 32) -> torch.Tensor:
    """H_s via the bisection threshold: entries with |x| > t, plus the
    threshold ties (magnitudes in the final bracket) in ascending-index order
    up to support size s, so that tied magnitudes never empty the support."""
    mag = x.abs()
    lo, hi = _bisect_bracket(mag, s, iters)
    strict = mag > hi.unsqueeze(-1)
    tied = (mag > lo.unsqueeze(-1)) & ~strict
    keep = strict | tie_fill_mask(strict, tied, s)
    return torch.where(keep, x, torch.zeros_like(x))
