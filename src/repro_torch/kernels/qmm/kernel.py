"""ctypes binding of the Hopper ``qmm`` kernel (``csrc/qmm.cu``).

Replaces ``repro/kernels/qmm/kernel.py::qmm_pallas``. The source is compiled
with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``build/repro_torch/`` at the repository root on first use, under a name that
carries the hash of the source, and loaded with ``ctypes``. Nothing is built
when this module is imported, and there is no fallback: a CUDA tensor that
reaches :func:`qmm_cuda` launches the kernel or raises.

``QMM.launches`` counts the kernel's launches; it grows by one for every
launch and nowhere else. ``QMM.launches_by_shape`` splits the same count by
the (N, K) of the packed operand, so the two orientations of Φ̂ read apart.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

from repro_torch.quant.formats import BY_BITS
from repro_torch.quant.pack import packed_len

SOURCE = Path(__file__).resolve().parent / "csrc" / "qmm.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_dir() -> Path:
    """``build/repro_torch`` at the root of the checkout (``src/`` layout)."""
    return Path(__file__).resolve().parents[4] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


class QmmKernel:
    """The built library, its launch counter and its build log."""

    def __init__(self, source: Path = SOURCE):
        self.source = source
        self.launches = 0
        self.launches_by_shape: collections.Counter = collections.Counter()
        self.build_log = ""
        self.build_seconds: Optional[float] = None
        self._lib = None

    def reset_counts(self) -> None:
        self.launches = 0
        self.launches_by_shape.clear()

    def library_path(self) -> Path:
        digest = hashlib.sha1(self.source.read_bytes() + " ".join(NVCC_FLAGS).encode())
        return build_dir() / f"qmm_{digest.hexdigest()[:16]}.so"

    def build(self) -> ctypes.CDLL:
        """Compile (once per source hash) and load the library."""
        if self._lib is not None:
            return self._lib
        out = self.library_path()
        t0 = time.perf_counter()
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
            os.close(fd)
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)],
                                  capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed to build {self.source}:\n{self.build_log}")
            os.replace(tmp, out)   # atomic: a concurrent process never loads half a file
        lib = ctypes.CDLL(str(out))
        fn = lib.repro_qmm
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self.build_seconds = time.perf_counter() - t0
        self._lib = lib
        return lib

    def __call__(self, x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor,
                 bits: int, k_dim: int) -> torch.Tensor:
        """y = x @ dequant(w)ᵀ on the card. x (M, K) f32, w_packed (N, Kp)
        uint8, scale (1, N) or (N,) f32, all CUDA and contiguous."""
        if bits not in BY_BITS:
            raise ValueError(f"bits must be one of {tuple(BY_BITS)}, got {bits}")
        for name, t, dt in (("x", x, torch.float32), ("w_packed", w_packed, torch.uint8),
                            ("scale", scale, torch.float32)):
            if not t.is_cuda:
                raise ValueError(f"qmm_cuda: {name} must be a CUDA tensor, got {t.device}")
            if t.dtype != dt:
                raise TypeError(f"qmm_cuda: {name} must be {dt}, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"qmm_cuda: {name} must be contiguous")
        if not (x.device == w_packed.device == scale.device):
            raise ValueError("qmm_cuda: x, w_packed and scale must share one device")
        if x.ndim != 2 or w_packed.ndim != 2:
            raise ValueError("qmm_cuda: x must be (M, K) and w_packed (N, Kp)")
        m, k = x.shape
        n, kp = w_packed.shape
        if k != k_dim or kp != packed_len(k_dim, bits):
            raise ValueError(f"qmm_cuda: x is (M, {k}) and w_packed (N, {kp}); "
                             f"k_dim={k_dim} at {bits} bits needs Kp={packed_len(k_dim, bits)}")
        if scale.numel() != n:
            raise ValueError(f"qmm_cuda: scale has {scale.numel()} entries, N={n}")
        if max(m, n, k, kp) >= 2**31:
            raise ValueError("qmm_cuda: dimensions must fit a 32-bit int")
        y = torch.empty((m, n), dtype=torch.float32, device=x.device)
        if m == 0 or n == 0:
            return y
        lib = self.build()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with torch.cuda.device(x.device):
            err = lib.repro_qmm(x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(),
                                y.data_ptr(), m, n, k, kp, bits, stream)
        if err != 0:
            raise RuntimeError(f"qmm_cuda: kernel launch failed with cudaError {err}")
        self.launches += 1
        self.launches_by_shape[(n, k)] += 1
        return y


QMM = QmmKernel()


def qmm_cuda(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor, bits: int,
             k_dim: int) -> torch.Tensor:
    """Launch the Hopper kernel (see :class:`QmmKernel`)."""
    return QMM(x, w_packed, scale, bits, k_dim)
