"""ctypes binding of the Hopper ``sqround`` kernel (``csrc/sqround.cu``).

``repro_sqround`` replaces ``repro/kernels/sqround/kernel.py::sqround_pallas``:
one elementwise pass over a 2-D float32 ``v`` and its uint32 random words,
with no padding of the rows. The source is compiled with nvcc into
``build/repro_torch/`` on first use (:mod:`repro_torch.kernels.cudalib`).
There is no fallback: a CUDA tensor that reaches :func:`sqround_cuda`
launches the kernel or raises. ``SQROUND.launches`` counts the launches;
``launches_by_shape`` splits them by (R, C).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.cudalib import CudaKernel, CudaLibrary, check_cuda_tensors
from repro_torch.quant.formats import BY_BITS

SOURCE = Path(__file__).resolve().parent / "csrc" / "sqround.cu"
_P = ctypes.c_void_p
LIBRARY = CudaLibrary(SOURCE, {
    # v, u, scale, out, n, K, stream
    "repro_sqround": [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P],
})


def narrow_words(u: torch.Tensor) -> torch.Tensor:
    """The uint32 words as an int32 tensor with the same 32 bits (the port's
    ``random.bits`` holds them in int64); int32 words pass unchanged."""
    if u.dtype == torch.int32:
        return u
    if u.dtype != torch.int64:
        raise TypeError(f"random words must be int64 (uint32 values) or int32, got {u.dtype}")
    return u.to(torch.int32)      # keeps the low 32 bits (two's complement)


class SqroundKernel(CudaKernel):
    def __call__(self, v: torch.Tensor, u: torch.Tensor, scale: torch.Tensor,
                 bits: int) -> torch.Tensor:
        """int8 codes of v (R, C) f32 with words u (R, C) int64 or int32 and a
        one-element f32 scale, all CUDA and contiguous."""
        if bits not in BY_BITS:
            raise ValueError(f"bits must be one of {tuple(BY_BITS)}, got {bits}")
        if v.ndim != 2 or tuple(u.shape) != tuple(v.shape):
            raise ValueError(f"sqround_cuda: v must be (R, C) and u the same shape, got "
                             f"{tuple(v.shape)} and {tuple(u.shape)}")
        if scale.numel() != 1:
            raise ValueError(f"sqround_cuda: scale must have one element, got {scale.numel()}")
        words = narrow_words(u)
        check_cuda_tensors("sqround_cuda", ("v", v, torch.float32), ("u", words, torch.int32),
                           ("scale", scale, torch.float32))
        out = torch.empty(v.shape, dtype=torch.int8, device=v.device)
        if v.numel() == 0:
            return out
        self.launch(v.device, tuple(v.shape), v.data_ptr(), words.data_ptr(), scale.data_ptr(),
                    out.data_ptr(), v.numel(), BY_BITS[bits].half_steps)
        return out


SQROUND = SqroundKernel(LIBRARY, "repro_sqround")


def sqround_cuda(v: torch.Tensor, u: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """Launch the Hopper stochastic-rounding kernel (see :class:`SqroundKernel`)."""
    return SQROUND(v, u, scale, bits)
