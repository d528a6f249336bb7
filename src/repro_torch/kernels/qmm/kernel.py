"""ctypes binding of the Hopper ``qmm`` kernels.

Two libraries:

* ``csrc/qmm_wgmma.cu`` (:data:`LIBRARY`), the tensor-core kernel (``wgmma``,
  x split exactly into three bf16 pieces, split-K). ``repro_qmm_tc``
  (:data:`QMM`) replaces ``repro/kernels/qmm/kernel.py::qmm_pallas``: one
  scale per output row (per_tensor is the broadcast special case);
  ``repro_qmm_group_tc`` (:data:`QMM_GROUP`) replaces ``qmm_group_pallas``:
  an (N, ⌈K/g⌉) slab of scales, one per g contiguous codes along K
  (``per_block``), for g a multiple of 16 codes.
* ``csrc/qmm.cu`` (:data:`CORE_LIBRARY`), the CUDA-core row walk, which
  reads the codes byte by byte: ``repro_qmm_group`` (:data:`QMM_GROUP_CORE`)
  for the group sizes the tensor-core kernel does not take (g not a multiple
  of 16), and for any g when the codes do not start on a 16-byte boundary;
  ``repro_qmm`` (:data:`QMM_CORE`), per-row scales for such codes (a
  row-slice view of a packed operand). :func:`qmm_cuda` and
  :func:`qmm_group_cuda` route by the codes' alignment,
  :func:`repro_torch.kernels.qmm.ops.group_kernel` by g and alignment. No
  view is copied into an aligned buffer.

Each source is compiled with nvcc into ``build/repro_torch/`` on first use
(:mod:`repro_torch.kernels.cudalib`). There is no fallback: a CUDA tensor that
reaches a kernel launches it or raises. Each kernel object counts its own
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

__all__ = ["NVCC_FLAGS", "SOURCE", "CORE_SOURCE", "LIBRARY", "CORE_LIBRARY", "QMM",
           "QMM_CORE", "QMM_GROUP", "QMM_GROUP_CORE", "TC_GROUP_MULTIPLE", "build_dir",
           "ROW_LOCAL_ROWS", "qmm_cuda", "qmm_group_cuda", "tc_aligned"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "qmm_wgmma.cu"
CORE_SOURCE = Path(__file__).resolve().parent / "csrc" / "qmm.cu"
TC_GROUP_MULTIPLE = 16          # the tensor-core group kernel takes g = 16·j
# The most x rows of one call for which every qmm kernel gives row b the bits
# of a call on row b alone. Up to 16 rows the tensor-core kernels sum each row
# in one order (B tiles of 16, 24 or 48 columns, the two units of a pair in
# two accumulators); past 16 rows the per-row-scale kernel takes 96 columns
# and one accumulator, which rounds the sums in another order.
ROW_LOCAL_ROWS = 16
_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(SOURCE, {
    # N, Kp -> split-K parts S of a call (the workspace is S·M·N floats)
    "repro_qmm_tc_splits": [_I, _I],
    # x, codes, scale, y, workspace, counters, M, N, K, Kp, bits, stream
    "repro_qmm_tc": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, codes, scale, y, workspace, counters, M, N, K, Kp, bits, group_size, stream
    "repro_qmm_group_tc": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
})
CORE_LIBRARY = CudaLibrary(CORE_SOURCE, {
    # x, codes, scale, y, M, N, K, Kp, bits, stream
    "repro_qmm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, codes, scale, y, M, N, K, Kp, bits, group_size, stream
    "repro_qmm_group": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
})
_ROWS = 128                     # Φ̂ rows of one block of qmm_wgmma.cu
_SPLITS: dict = {}              # (device, N, Kp) -> split-K parts
_SCRATCH: dict = {}             # device -> [workspace f32, tickets int32 (zero between launches)]


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


def tc_aligned(w_packed: torch.Tensor) -> bool:
    """Whether the codes start on a 16-byte boundary, as the tensor-core
    kernel needs (it reads them by TMA and in 16-byte copies aligned to the
    array's start)."""
    return w_packed.data_ptr() % 16 == 0


def _check_aligned(who, w_packed):
    if not tc_aligned(w_packed):
        raise ValueError(f"{who}: w_packed must start on a 16-byte boundary (codes "
                         "that do not take the byte-load route of qmm_cuda)")


def _scratch(device, m, n, kp, lib):
    """The split-K workspace (S·M·N floats) and the zeroed tickets of a call,
    kept per device and grown as needed; launches on one stream share them."""
    key = (device, n, kp)
    parts = _SPLITS.get(key)
    if parts is None:
        parts = lib.repro_qmm_tc_splits(n, kp)
        if parts < 1:
            raise RuntimeError(f"repro_qmm_tc_splits({n}, {kp}) returned {parts}")
        _SPLITS[key] = parts
    buf = _SCRATCH.get(device)
    if buf is None:
        buf = _SCRATCH[device] = [torch.empty(0, dtype=torch.float32, device=device),
                                  torch.zeros(0, dtype=torch.int32, device=device)]
    need_ws = parts * m * n if parts > 1 else 1
    need_t = -(-n // _ROWS) * -(-m // 4)
    if buf[0].numel() < need_ws:
        buf[0] = torch.empty(need_ws, dtype=torch.float32, device=device)
    if buf[1].numel() < need_t:
        buf[1] = torch.zeros(max(need_t, 1024), dtype=torch.int32, device=device)
    return buf[0], buf[1]


class QmmKernel(CudaKernel):
    """``repro_qmm_tc``: y = x @ dequant(w)ᵀ with one scale per row of w."""

    def __call__(self, x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor,
                 bits: int, k_dim: int) -> torch.Tensor:
        """x (M, K) f32, w_packed (N, Kp) uint8, scale (1, N) or (N,) f32, all
        CUDA and contiguous."""
        m, k, n, kp = _check("qmm_cuda", x, w_packed, scale, bits, k_dim)
        _check_aligned("qmm_cuda", w_packed)
        if scale.numel() != n:
            raise ValueError(f"qmm_cuda: scale has {scale.numel()} entries, N={n}")
        y = torch.empty((m, n), dtype=torch.float32, device=x.device)
        if m == 0 or n == 0:
            return y
        ws, counters = _scratch(x.device, m, n, kp, self.build())
        self.launch(x.device, (n, k), x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(),
                    y.data_ptr(), ws.data_ptr(), counters.data_ptr(), m, n, k, kp, bits, out=y)
        return y


class QmmCoreKernel(CudaKernel):
    """``repro_qmm``: y = x @ dequant(w)ᵀ with one scale per row of w, on the
    CUDA-core row walk, which reads the codes bytewise: any start address."""

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
                    y.data_ptr(), m, n, k, kp, bits, out=y)
        return y


class QmmGroupKernel(CudaKernel):
    """A group-scaled entry: y = x @ dequant(w)ᵀ with scale (N, ⌈K/g⌉).

    ``multiple`` is the granule g must be a multiple of, beside the packing
    word: 16 for the tensor-core ``repro_qmm_group_tc``, 1 for the CUDA-core
    ``repro_qmm_group``."""

    def __init__(self, library: CudaLibrary, entry: str, multiple: int, split_k: bool):
        super().__init__(library, entry)
        self.multiple = multiple
        self.split_k = split_k

    def __call__(self, x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor,
                 bits: int, k_dim: int, group_size: int) -> torch.Tensor:
        """x (M, K) f32, w_packed (N, Kp) uint8, scale (N, ⌈K/g⌉) f32, all
        CUDA and contiguous; g a positive multiple of 8 // bits and of
        ``multiple``."""
        m, k, n, kp = _check("qmm_group_cuda", x, w_packed, scale, bits, k_dim)
        vpb = BY_BITS[bits].values_per_byte
        if group_size < 1 or group_size % vpb or group_size % self.multiple:
            raise ValueError(f"qmm_group_cuda: group_size {group_size} must be a positive "
                             f"multiple of {vpb} at {bits} bits and of {self.multiple} for "
                             f"{self.entry}")
        n_groups = (k + group_size - 1) // group_size
        if tuple(scale.shape) != (n, n_groups):
            raise ValueError(f"qmm_group_cuda: scale is {tuple(scale.shape)}, "
                             f"(N, ⌈K/g⌉) = ({n}, {n_groups})")
        y = torch.empty((m, n), dtype=torch.float32, device=x.device)
        if m == 0 or n == 0:
            return y
        ptrs = [x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(), y.data_ptr()]
        if self.split_k:
            _check_aligned("qmm_group_cuda", w_packed)
            ws, counters = _scratch(x.device, m, n, kp, self.build())
            ptrs += [ws.data_ptr(), counters.data_ptr()]
        self.launch(x.device, (n, k), *ptrs, m, n, k, kp, bits, group_size, out=y)
        return y


QMM = QmmKernel(LIBRARY, "repro_qmm_tc")
QMM_CORE = QmmCoreKernel(CORE_LIBRARY, "repro_qmm")
QMM_GROUP = QmmGroupKernel(LIBRARY, "repro_qmm_group_tc", TC_GROUP_MULTIPLE, split_k=True)
QMM_GROUP_CORE = QmmGroupKernel(CORE_LIBRARY, "repro_qmm_group", 1, split_k=False)


def qmm_cuda(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor, bits: int,
             k_dim: int) -> torch.Tensor:
    """Launch the per-row-scale kernel the codes' alignment routes to: the
    tensor-core ``QMM`` (:class:`QmmKernel`) for codes on a 16-byte
    boundary, the byte-load ``QMM_CORE`` (:class:`QmmCoreKernel`) otherwise."""
    return (QMM if tc_aligned(w_packed) else QMM_CORE)(x, w_packed, scale, bits, k_dim)


def qmm_group_cuda(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor, bits: int,
                   k_dim: int, group_size: int) -> torch.Tensor:
    """Launch the tensor-core group-scaled kernel (g a multiple of 16; see
    :class:`QmmGroupKernel`), or, for codes off a 16-byte boundary, the
    byte-load ``QMM_GROUP_CORE``."""
    kernel = QMM_GROUP if tc_aligned(w_packed) else QMM_GROUP_CORE
    return kernel(x, w_packed, scale, bits, k_dim, group_size)
