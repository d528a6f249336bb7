"""Runtime sanitizer of the port: NaN/Inf tripwires and a kernel-build counter.

Port of ``repro.analysis.sanitize``. Where the reference flips
``jax_debug_nans``/``jax_debug_infs``, the port checks what each operation
produced:

* :func:`sanitize` — a context manager under which any floating or complex
  tensor that an aten operation produces with a NaN (or an Inf) raises
  ``FloatingPointError`` naming the operation (a ``TorchDispatchMode`` that
  reads the outputs of every op). Exempt are allocations not yet written
  (``empty*``), views, and transfers and copies of values that already held
  the NaN or Inf (a transfer is not a computation: the reference's rule).
  The hand-written kernels write through ``ctypes``, which no dispatcher
  sees, so each kernel's launch checks its output while the sanitizer is on
  (:func:`check_kernel_output`, named by its entry, e.g. ``repro_qmm_tc``);
  outside the sanitizer that costs one list test.
* :class:`CompileCounter` — counts the port's compile step: every build or
  load of a CUDA kernel library (:meth:`repro_torch.kernels.cudalib.CudaLibrary.build`),
  with its seconds. ``mark_warm()`` after warm-up; ``compiles_since_warm == 0``
  then means no later work built or loaded a kernel library.

Intentional NaN fills (trace rows of skipped iterations) are built on the
host and transferred (``torch.from_numpy(np.full(...)).to(device)``), as in
the reference. Every check reads its flags back to the host, so a sanitized
run synchronises once per operation: it is a debugging mode.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# counters and tripwires in force, innermost last
_COUNTERS: list["CompileCounter"] = []
_TRIPWIRES: list[tuple[bool, bool]] = []

# operations whose output holds no computed value: fresh allocations
_ALLOCATIONS = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                          "new_empty_strided", "empty_permuted"})
# transfers and copies: they move values, so they trip only where the
# source held no NaN or Inf (a cast that overflows is a computation)
_COPIES = frozenset({"_to_copy", "copy_", "clone", "lift_fresh", "lift_fresh_copy",
                     "_copy_from", "_copy_from_and_resize", "detach", "alias",
                     "_unsafe_view"})


def record_compile(seconds: float) -> None:
    """Count one kernel-library build or load on every active counter."""
    for counter in _COUNTERS:
        counter._record(seconds)


class CompileCounter:
    """Counts kernel-library builds and loads while active (a context manager).

    >>> with CompileCounter() as cc:
    ...     f(x)            # warm-up: builds
    ...     cc.mark_warm()
    ...     f(x); f(x)      # must reuse what is loaded
    >>> assert cc.compiles_since_warm == 0
    """

    def __init__(self) -> None:
        self.compiles = 0
        self.compile_seconds = 0.0
        self._warm_at: Optional[int] = None

    def __enter__(self) -> "CompileCounter":
        _COUNTERS.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _COUNTERS.remove(self)

    def _record(self, seconds: float) -> None:
        self.compiles += 1
        self.compile_seconds += seconds

    def mark_warm(self) -> None:
        """Declare warm-up over; builds after this point are regressions."""
        self._warm_at = self.compiles

    @property
    def compiles_since_warm(self) -> int:
        return self.compiles - (self._warm_at or 0)

    def summary(self) -> str:
        since = "n/a" if self._warm_at is None else str(self.compiles_since_warm)
        return (f"compiles={self.compiles} compiles_after_warmup={since} "
                f"compile_s={self.compile_seconds:.2f}")


def _non_finite(t: torch.Tensor, nans: bool, infs: bool) -> Optional[str]:
    """"NaN" or "Inf" if ``t`` holds one that is checked for, else None (one
    read back to the host)."""
    has_nan, has_inf = torch.stack([torch.isnan(t).any(), torch.isinf(t).any()]).tolist()
    if nans and has_nan:
        return "NaN"
    if infs and has_inf:
        return "Inf"
    return None


def _checked(t) -> bool:
    return (isinstance(t, torch.Tensor) and t.layout == torch.strided
            and t.device.type != "meta" and t.numel() > 0
            and (t.is_floating_point() or t.is_complex()))


def check_kernel_output(entry: str, out: torch.Tensor) -> None:
    """Raise ``FloatingPointError`` naming the kernel ``entry`` if the sanitizer
    is on and ``out``, which the kernel wrote, holds a NaN or an Inf it
    checks for."""
    if not _TRIPWIRES:
        return
    nans, infs = _TRIPWIRES[-1]
    what = _non_finite(out, nans, infs) if _checked(out) else None
    if what:
        raise FloatingPointError(f"{what} produced by the kernel {entry} "
                                 f"(output {tuple(out.shape)} {out.dtype})")


class _Tripwire(TorchDispatchMode):
    """Checks the floating outputs of every aten operation run under it."""

    def __init__(self, nans: bool, infs: bool):
        super().__init__()
        self.nans, self.infs = nans, infs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.is_view or name in _ALLOCATIONS:
            return out
        for t in tree_leaves(out):
            if not _checked(t):
                continue
            what = _non_finite(t, self.nans, self.infs)
            if what is None:
                continue
            if name in _COPIES:
                src = args[1] if name.startswith("copy_") else args[0]
                if _checked(src) and _non_finite(src, self.nans, self.infs) == what:
                    continue
            raise FloatingPointError(f"{what} produced by {func} "
                                     f"(output {tuple(t.shape)} {t.dtype})")
        return out


@contextlib.contextmanager
def sanitize(nans: bool = True, infs: bool = True,
             counter: Optional[CompileCounter] = None):
    """NaN/Inf tripwires and compile counting for the enclosed block.

    Yields the :class:`CompileCounter` (the one passed in, or a fresh one).
    The tripwire and the counter are removed on exit, also when the tripwire
    fires, so nesting and test isolation are safe."""
    own = counter if counter is not None else CompileCounter()
    _TRIPWIRES.append((bool(nans), bool(infs)))
    try:
        with own:
            if nans or infs:
                with _Tripwire(bool(nans), bool(infs)):
                    yield own
            else:
                yield own
    finally:
        _TRIPWIRES.pop()
