"""ctypes bindings of the Hopper H_s kernels.

* ``csrc/hsthresh.cu`` (:data:`LIBRARY`): ``repro_hist`` (:data:`HIST`)
  replaces ``repro/kernels/hsthresh/kernel.py::hist_pallas`` and
  ``repro_mask`` (:data:`MASK`) replaces ``mask_pallas``. Both take a (B, N)
  batch, one vmax or threshold per row, in one launch (the reference vmaps
  one (1, N) row per call). They are the counterparts of the reference's two
  public kernels; the solver does not call them.
* ``csrc/hsthresh_fused.cu`` (:data:`FUSED_LIBRARY`): ``repro_hsthresh``
  (:data:`HSTHRESH`), the whole H_s (vmax, histogram, pick, mask and tie
  fill) of a (B, N) batch in one launch, one thread-block cluster per row.
  It replaces the chain ``repro/kernels/hsthresh/ops.py::hsthresh`` runs
  around ``hist_pallas`` and ``mask_pallas``, and is what
  :func:`repro_torch.kernels.hsthresh.ops.hsthresh` launches on the card.

Each source is compiled with nvcc into ``build/repro_torch/`` on first use
(:mod:`repro_torch.kernels.cudalib`). There is no fallback: a CUDA tensor
that reaches a wrapper launches its kernel or raises. Each kernel object
counts its launches; ``launches_by_shape`` splits them by (B, N).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.cudalib import CudaKernel, CudaLibrary, check_cuda_tensors

SOURCE = Path(__file__).resolve().parent / "csrc" / "hsthresh.cu"
FUSED_SOURCE = SOURCE.with_name("hsthresh_fused.cu")
MAX_BINS = 12288              # the kernels' shared-memory counters (48 KB)
_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(SOURCE, {
    "repro_hist": [_P, _P, _P, _I, _I, _I, _P],      # x, vmax, out, B, N, nbins, stream
    "repro_mask": [_P, _P, _P, _I, _I, _P],          # x, t, y, B, N, stream
})
FUSED_LIBRARY = CudaLibrary(FUSED_SOURCE, {
    "repro_hsthresh": [_P, _P, _I, _I, _I, _I, _P],  # x, y, B, N, s, nbins, stream
})


def _rows(who: str, x: torch.Tensor, per_row: torch.Tensor, name: str) -> tuple[int, int]:
    check_cuda_tensors(who, ("x", x, torch.float32), (name, per_row, torch.float32))
    if x.ndim != 2:
        raise ValueError(f"{who}: x must be (B, N), got {tuple(x.shape)}")
    b, n = x.shape
    if tuple(per_row.shape) != (b,):
        raise ValueError(f"{who}: {name} must be (B,) = ({b},), got {tuple(per_row.shape)}")
    if b > 65535 or n >= 2**31:
        raise ValueError(f"{who}: (B, N) = ({b}, {n}) exceeds the launch grid")
    return b, n


class HistKernel(CudaKernel):
    def __call__(self, x: torch.Tensor, vmax: torch.Tensor, nbins: int) -> torch.Tensor:
        """(B, nbins) int32 histogram of clamp(int(|x| / vmax · nbins)) per row;
        x (B, N) f32 and vmax (B,) f32, CUDA and contiguous."""
        b, n = _rows("hist_cuda", x, vmax, "vmax")
        if not 0 < nbins <= MAX_BINS:
            raise ValueError(f"hist_cuda: nbins must be in [1, {MAX_BINS}], got {nbins}")
        out = torch.zeros((b, nbins), dtype=torch.int32, device=x.device)
        if b == 0 or n == 0:
            return out
        self.launch(x.device, (b, n), x.data_ptr(), vmax.data_ptr(), out.data_ptr(),
                    b, n, nbins)
        return out


class MaskKernel(CudaKernel):
    def __call__(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """where(|x| > t, x, 0) per row; x (B, N) f32 and t (B,) f32, CUDA and
        contiguous."""
        b, n = _rows("mask_cuda", x, t, "t")
        y = torch.empty_like(x)
        if b == 0 or n == 0:
            return y
        self.launch(x.device, (b, n), x.data_ptr(), t.data_ptr(), y.data_ptr(), b, n)
        return y


class HsthreshKernel(CudaKernel):
    def __call__(self, x: torch.Tensor, s: int, nbins: int) -> torch.Tensor:
        """The streaming H_s of each row of x (B, N) f32, CUDA and contiguous:
        ``hsthresh_ref(x, s, nbins)`` bit for bit, in one launch."""
        check_cuda_tensors("hsthresh_cuda", ("x", x, torch.float32))
        if x.ndim != 2:
            raise ValueError(f"hsthresh_cuda: x must be (B, N), got {tuple(x.shape)}")
        b, n = x.shape
        if b > 65535 or n >= 2**31:
            raise ValueError(f"hsthresh_cuda: (B, N) = ({b}, {n}) exceeds the launch grid")
        if not 0 < nbins <= MAX_BINS:
            raise ValueError(f"hsthresh_cuda: nbins must be in [1, {MAX_BINS}], got {nbins}")
        y = torch.empty_like(x)
        if b == 0 or n == 0:
            return y
        # s past N keeps what N keeps, and any s < 0 what -1 keeps: a 32-bit int
        self.launch(x.device, (b, n), x.data_ptr(), y.data_ptr(), b, n,
                    max(-1, min(int(s), n)), nbins)
        return y


HIST = HistKernel(LIBRARY, "repro_hist")
MASK = MaskKernel(LIBRARY, "repro_mask")
HSTHRESH = HsthreshKernel(FUSED_LIBRARY, "repro_hsthresh")


def hist_cuda(x: torch.Tensor, vmax: torch.Tensor, nbins: int) -> torch.Tensor:
    """Launch the Hopper histogram kernel (see :class:`HistKernel`)."""
    return HIST(x, vmax, nbins)


def mask_cuda(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper mask kernel (see :class:`MaskKernel`)."""
    return MASK(x, t)


def hsthresh_cuda(x: torch.Tensor, s: int, nbins: int) -> torch.Tensor:
    """Launch the fused Hopper H_s kernel (see :class:`HsthreshKernel`)."""
    return HSTHRESH(x, s, nbins)
