"""Streaming H_s through histogram, select and mask (port of
``repro.kernels.hsthresh.ops``).

:func:`hsthresh` takes a real vector or a (B, N) batch and works on each row.
On a CUDA tensor it launches the fused kernel once for the whole batch
(``HSTHRESH``, ``csrc/hsthresh_fused.cu``: histogram, pick, mask and tie
fill in one launch); on a CPU tensor it runs the plain chain
:func:`~repro_torch.kernels.hsthresh.ref.hsthresh_ref` (histogram, select,
mask, fill), as the reference runs jnp off the TPU. There is no padding:
the kernel masks the ragged edge.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.hsthresh.kernel import hsthresh_cuda
from repro_torch.kernels.hsthresh.ref import hsthresh_ref


def hsthresh(x: torch.Tensor, s: int, *, nbins: int = 2048) -> torch.Tensor:
    """Streaming hard threshold on the last axis of a real (N,) or (B, N)
    tensor. Support size <= s per row; equals exact H_s whenever no two
    magnitudes share the threshold bin. Threshold-bin ties are kept in
    ascending-index order up to support size s rather than dropped."""
    if x.is_complex():
        raise TypeError("hsthresh is the real-signal H_s; got a complex tensor")
    single = x.ndim == 1
    xb = (x[None, :] if single else x).to(torch.float32).contiguous()
    y = hsthresh_cuda(xb, s, nbins) if xb.is_cuda else hsthresh_ref(xb, s, nbins)
    out = y.to(x.dtype)
    return out[0] if single else out
