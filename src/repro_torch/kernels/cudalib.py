"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface. :class:`CudaLibrary`
compiles it with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``
into ``build/repro_torch/`` at the root of the checkout on first use, under a
name that carries the hash of the source and flags, and loads it with
``ctypes``. Nothing is built when a module is imported, and there is no
fallback: a build that fails raises.

:class:`CudaKernel` is one entry point of such a library with its launch
counter: ``launches`` grows by one for every launch of the kernel and nowhere
else, and ``launches_by_shape`` splits the same count by a shape key the
wrapper chooses. Under :func:`repro_torch.analysis.sanitize.sanitize` a launch
checks the output it was given for NaN and Inf, naming its entry, and every
build or load counts on the active ``CompileCounter``; under
``torch.profiler`` a launch is a span named by its entry.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

from repro_torch.analysis.sanitize import check_kernel_output, record_compile

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_dir() -> Path:
    """``build/repro_torch`` at the root of the checkout (``src/`` layout)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


class CudaLibrary:
    """One CUDA source, its built shared library and its build log.

    ``entries`` maps each ``extern "C"`` function to its ctypes argument
    types; every entry returns the ``cudaError_t`` of its launch as an int."""

    def __init__(self, source: Path, entries: dict[str, Sequence]):
        self.source = Path(source)
        self.entries = dict(entries)
        self.build_log = ""
        self.build_seconds: Optional[float] = None
        self._lib = None

    def library_path(self) -> Path:
        digest = hashlib.sha1(self.source.read_bytes() + " ".join(NVCC_FLAGS).encode())
        return build_dir() / f"{self.source.stem}_{digest.hexdigest()[:16]}.so"

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
            try:
                proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)],
                                      capture_output=True, text=True)
                self.build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed to build {self.source}:\n{self.build_log}")
                os.replace(tmp, out)   # atomic: a concurrent process never loads half a file
            finally:
                if os.path.exists(tmp):    # a failed build (or no nvcc) leaves no file behind
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in self.entries.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        self.build_seconds = time.perf_counter() - t0
        self._lib = lib
        record_compile(self.build_seconds)
        return lib


class CudaKernel:
    """One entry point of a :class:`CudaLibrary` and its launch counter."""

    def __init__(self, library: CudaLibrary, entry: str):
        if entry not in library.entries:
            raise ValueError(f"{library.source.name} has no entry {entry!r}")
        self.library = library
        self.entry = entry
        self.launches = 0
        self.launches_by_shape: collections.Counter = collections.Counter()

    @property
    def _lib(self):
        return self.library._lib

    @property
    def build_log(self) -> str:
        return self.library.build_log

    @property
    def build_seconds(self) -> Optional[float]:
        return self.library.build_seconds

    def library_path(self) -> Path:
        return self.library.library_path()

    def build(self) -> ctypes.CDLL:
        return self.library.build()

    def reset_counts(self) -> None:
        self.launches = 0
        self.launches_by_shape.clear()

    def launch(self, device, shape_key, *args, out: Optional[torch.Tensor] = None) -> None:
        """Call the entry on ``device``'s current stream (the last argument)
        and count the launch; raises if the launch was refused. ``out`` is
        the tensor the kernel writes, which the sanitizer checks."""
        lib = self.build()
        stream = torch.cuda.current_stream(device).cuda_stream
        span = (torch.profiler.record_function(self.entry) if torch.autograd._profiler_enabled()
                else contextlib.nullcontext())
        with span, torch.cuda.device(device):
            err = getattr(lib, self.entry)(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.entry}: kernel launch failed with cudaError {err}")
        self.launches += 1
        self.launches_by_shape[shape_key] += 1
        if out is not None:
            check_kernel_output(self.entry, out)


def check_cuda_tensors(who: str, *specs) -> None:
    """Each spec is (name, tensor, dtype): a contiguous CUDA tensor of that
    dtype, all on one device."""
    devices = set()
    for name, t, dt in specs:
        if not t.is_cuda:
            raise ValueError(f"{who}: {name} must be a CUDA tensor, got {t.device}")
        if t.dtype != dt:
            raise TypeError(f"{who}: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
        devices.add(t.device)
    if len(devices) > 1:
        raise ValueError(f"{who}: {', '.join(s[0] for s in specs)} must share one device")
