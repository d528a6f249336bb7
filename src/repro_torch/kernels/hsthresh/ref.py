"""Plain PyTorch version of the streaming hard threshold H_s (port of
``repro.kernels.hsthresh.ref``).

The paper's FPGA (§8) finds the top-s threshold by search; here, as in the
reference, it is two streaming passes and a small selection between them:

  pass 1 (``hist``):  histogram of |x| over ``nbins`` uniform bins in [0, vmax],
  select (torch):     the finest bin edge t with count(|x| > t) <= s,
  pass 2 (``mask``):  y = where(|x| > t, x, 0),

then the threshold-bin ties are filled in ascending-index order up to support
size s (:func:`fill_threshold_bin`), so that a flat input keeps s entries
instead of collapsing to the empty support.

Every function takes a batch along the leading axes and works on the last
axis: ``mag``/``x`` (..., N), ``vmax``/``t`` (...). A vector with 0-d
``vmax`` is the reference's own case. The arithmetic is the reference's, op
for op in IEEE f32, so histograms, thresholds and outputs agree bit for bit.
"""
from __future__ import annotations

import torch


def hist_ref(mag: torch.Tensor, vmax: torch.Tensor, nbins: int) -> torch.Tensor:
    """Counts of |x| in uniform bins over [0, vmax]; (..., nbins) int32."""
    idx = torch.clamp((mag / vmax.unsqueeze(-1) * nbins).to(torch.int32), 0, nbins - 1)
    out = torch.zeros((*mag.shape[:-1], nbins), dtype=torch.int32, device=mag.device)
    return out.scatter_add_(-1, idx.to(torch.int64), torch.ones_like(idx))


def select_threshold(hist: torch.Tensor, vmax: torch.Tensor, s: int) -> torch.Tensor:
    """Smallest bin edge t with count(|x| > t) <= s (edges i·vmax/nbins)."""
    nbins = hist.shape[-1]
    # tail[i]: the number of elements in bins >= i, a bound on count(|x| > edge i)
    tail = hist.flip(-1).cumsum(-1).flip(-1)
    ok = tail <= s                      # monotone non-decreasing along the bins
    # argmax of a bool tensor is refused; on int32 it returns the first maximum
    first_ok = torch.argmax(ok.to(torch.int32), dim=-1)
    idx = torch.where(ok.any(dim=-1), first_ok, torch.full_like(first_ok, nbins))
    return idx.to(torch.float32) * vmax / nbins      # the reference's order


def mask_ref(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() > t.unsqueeze(-1), x, torch.zeros_like(x))


# the longest piece of a row one cumsum call takes: PyTorch's CUDA cumsum
# (torch 2.11) faults on a row of 1.13e9 entries, the length of a stacked
# starcoder2-3b MLP leaf that the training projection thresholds
_SCAN_PIECE = 1 << 28


def _cumsum_last(x: torch.Tensor) -> torch.Tensor:
    """Integer cumsum along the last axis, in pieces of at most _SCAN_PIECE
    with the running total carried over (exact: the same integers)."""
    n = x.shape[-1]
    if n <= _SCAN_PIECE:
        return torch.cumsum(x, dim=-1)
    out = torch.empty_like(x)
    carry = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    for a in range(0, n, _SCAN_PIECE):
        piece = torch.cumsum(x[..., a:a + _SCAN_PIECE], dim=-1) + carry
        out[..., a:a + _SCAN_PIECE] = piece
        carry = piece[..., -1:]
    return out


def tie_fill_mask(strict: torch.Tensor, tied: torch.Tensor, s: int) -> torch.Tensor:
    """Mask of the ``tied`` entries to add to the ``strict`` survivors: the
    first ones by ascending index, up to a total support of s. Shared by the
    histogram H_s here and the bisection one in
    :mod:`repro_torch.core.threshold`."""
    room = s - strict.sum(dim=-1, keepdim=True)
    return tied & (_cumsum_last(tied.to(torch.int32)) <= room)


def fill_threshold_bin(x: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
                       binw: torch.Tensor, s: int) -> torch.Tensor:
    """Top up the strict cut ``y = where(|x| > t, x, 0)`` with threshold-bin
    entries (``t - binw <= |x| <= t``, zeros excluded) in ascending-index
    order until the support reaches s."""
    mag = x.abs()
    strict = mag > t.unsqueeze(-1)
    tied = (mag >= (t - binw).unsqueeze(-1)) & ~strict & (mag > 0)
    return torch.where(tie_fill_mask(strict, tied, s), x, y)


def row_vmax(mag: torch.Tensor) -> torch.Tensor:
    """max |x| along the last axis, at least 1e-30 (an all-zero row bins to 0)."""
    return torch.clamp_min(mag.amax(dim=-1), 1e-30)


def hsthresh_ref(x: torch.Tensor, s: int, nbins: int = 4096) -> torch.Tensor:
    """The whole histogram-select-mask-fill H_s on the last axis."""
    mag = x.abs()
    vmax = row_vmax(mag)
    h = hist_ref(mag, vmax, nbins)
    t = select_threshold(h, vmax, s)
    return fill_threshold_bin(x, mask_ref(x, t), t, vmax / nbins, s)
