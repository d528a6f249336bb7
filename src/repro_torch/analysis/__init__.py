"""Runtime checks of the port (the runtime half of ``repro.analysis``): the
NaN/Inf sanitizer and the kernel-build counter, :mod:`repro_torch.analysis.sanitize`."""
from repro_torch.analysis.sanitize import CompileCounter, sanitize

__all__ = ["CompileCounter", "sanitize"]
