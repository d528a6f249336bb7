"""ctypes binding of the Hopper ``qmm`` kernels (``csrc/qmm.cu``).

One library, two entry points:

* ``repro_qmm`` replaces ``repro/kernels/qmm/kernel.py::qmm_pallas``: one
  scale per output row (per_tensor is the broadcast special case);
* ``repro_qmm_group`` replaces ``qmm_group_pallas``: an (N, ⌈K/g⌉) slab of
  scales, one per g contiguous codes along K (``per_block``).

The source is compiled with nvcc into ``build/repro_torch/`` on first use
(:mod:`repro_torch.kernels.cudalib`). There is no fallback: a CUDA tensor that
reaches :func:`qmm_cuda` or :func:`qmm_group_cuda` launches the kernel or
raises. ``QMM.launches`` and ``QMM_GROUP.launches`` count each entry's
launches; ``launches_by_shape`` splits them by the (N, K) of the packed
operand, so the two orientations of Φ̂ read apart.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.cudalib import (
    NVCC_FLAGS,
    CudaKernel,
    CudaLibrary,
    build_dir,
    check_cuda_tensors,
)
from repro_torch.quant.formats import BY_BITS
from repro_torch.quant.pack import packed_len

__all__ = ["NVCC_FLAGS", "SOURCE", "LIBRARY", "QMM", "QMM_GROUP", "build_dir", "qmm_cuda",
           "qmm_group_cuda"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "qmm.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(SOURCE, {
    # x, codes, scale, y, M, N, K, Kp, bits, stream
    "repro_qmm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, codes, scale, y, M, N, K, Kp, bits, group_size, stream
    "repro_qmm_group": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
})


def _check(who, x, w_packed, scale, bits, k_dim):
    """Shared argument checks; returns (M, K, N, Kp)."""
    if bits not in BY_BITS:
        raise ValueError(f"bits must be one of {tuple(BY_BITS)}, got {bits}")
    check_cuda_tensors(who, ("x", x, torch.float32), ("w_packed", w_packed, torch.uint8),
                       ("scale", scale, torch.float32))
    if x.ndim != 2 or w_packed.ndim != 2:
        raise ValueError(f"{who}: x must be (M, K) and w_packed (N, Kp)")
    m, k = x.shape
    n, kp = w_packed.shape
    if k != k_dim or kp != packed_len(k_dim, bits):
        raise ValueError(f"{who}: x is (M, {k}) and w_packed (N, {kp}); "
                         f"k_dim={k_dim} at {bits} bits needs Kp={packed_len(k_dim, bits)}")
    if max(m, n, k, kp) >= 2**31:
        raise ValueError(f"{who}: dimensions must fit a 32-bit int")
    return m, k, n, kp


class QmmKernel(CudaKernel):
    """``repro_qmm``: y = x @ dequant(w)ᵀ with one scale per row of w."""

    def __call__(self, x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor,
                 bits: int, k_dim: int) -> torch.Tensor:
        """x (M, K) f32, w_packed (N, Kp) uint8, scale (1, N) or (N,) f32, all
        CUDA and contiguous."""
        m, k, n, kp = _check("qmm_cuda", x, w_packed, scale, bits, k_dim)
        if scale.numel() != n:
            raise ValueError(f"qmm_cuda: scale has {scale.numel()} entries, N={n}")
        y = torch.empty((m, n), dtype=torch.float32, device=x.device)
        if m == 0 or n == 0:
            return y
        self.launch(x.device, (n, k), x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(),
                    y.data_ptr(), m, n, k, kp, bits)
        return y


class QmmGroupKernel(CudaKernel):
    """``repro_qmm_group``: y = x @ dequant(w)ᵀ with scale (N, ⌈K/g⌉)."""

    def __call__(self, x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor,
                 bits: int, k_dim: int, group_size: int) -> torch.Tensor:
        """x (M, K) f32, w_packed (N, Kp) uint8, scale (N, ⌈K/g⌉) f32, all
        CUDA and contiguous; g a positive multiple of 8 // bits."""
        m, k, n, kp = _check("qmm_group_cuda", x, w_packed, scale, bits, k_dim)
        vpb = BY_BITS[bits].values_per_byte
        if group_size < 1 or group_size % vpb:
            raise ValueError(f"qmm_group_cuda: group_size {group_size} must be a positive "
                             f"multiple of {vpb} at {bits} bits")
        n_groups = (k + group_size - 1) // group_size
        if tuple(scale.shape) != (n, n_groups):
            raise ValueError(f"qmm_group_cuda: scale is {tuple(scale.shape)}, "
                             f"(N, ⌈K/g⌉) = ({n}, {n_groups})")
        y = torch.empty((m, n), dtype=torch.float32, device=x.device)
        if m == 0 or n == 0:
            return y
        self.launch(x.device, (n, k), x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(),
                    y.data_ptr(), m, n, k, kp, bits, group_size)
        return y


QMM = QmmKernel(LIBRARY, "repro_qmm")
QMM_GROUP = QmmGroupKernel(LIBRARY, "repro_qmm_group")


def qmm_cuda(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor, bits: int,
             k_dim: int) -> torch.Tensor:
    """Launch the Hopper per-row-scale kernel (see :class:`QmmKernel`)."""
    return QMM(x, w_packed, scale, bits, k_dim)


def qmm_group_cuda(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor, bits: int,
                   k_dim: int, group_size: int) -> torch.Tensor:
    """Launch the Hopper group-scaled kernel (see :class:`QmmGroupKernel`)."""
    return QMM_GROUP(x, w_packed, scale, bits, k_dim, group_size)
