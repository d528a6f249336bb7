"""Streaming H_s through histogram, select and mask (port of
``repro.kernels.hsthresh.ops``).

:func:`hsthresh` takes a real vector or a (B, N) batch and works on each row:
one launch of the ``hist`` kernel and one of the ``mask`` kernel for the
whole batch on a CUDA tensor, their plain versions on a CPU tensor. The
threshold pick (:func:`select_threshold`) and the tie fill
(:func:`fill_threshold_bin`) stay plain torch, as they stay jnp in the
reference. There is no padding: the kernels mask the ragged edge.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.hsthresh.kernel import hist_cuda, mask_cuda
from repro_torch.kernels.hsthresh.ref import (
    fill_threshold_bin,
    hist_ref,
    mask_ref,
    row_vmax,
    select_threshold,
)


def hsthresh(x: torch.Tensor, s: int, *, nbins: int = 2048) -> torch.Tensor:
    """Streaming hard threshold on the last axis of a real (N,) or (B, N)
    tensor. Support size <= s per row; equals exact H_s whenever no two
    magnitudes share the threshold bin. Threshold-bin ties are kept in
    ascending-index order up to support size s rather than dropped."""
    if x.is_complex():
        raise TypeError("hsthresh is the real-signal H_s; got a complex tensor")
    single = x.ndim == 1
    xb = (x[None, :] if single else x).to(torch.float32).contiguous()
    mag = xb.abs()
    vmax = row_vmax(mag)
    h = hist_cuda(xb, vmax, nbins) if xb.is_cuda else hist_ref(mag, vmax, nbins)
    t = select_threshold(h, vmax, s)
    y = mask_cuda(xb, t) if xb.is_cuda else mask_ref(xb, t)
    out = fill_threshold_bin(xb, y, t, vmax / nbins, s).to(x.dtype)
    return out[0] if single else out
