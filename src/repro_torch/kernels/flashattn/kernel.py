"""ctypes binding of the Hopper flash attention kernel (``csrc/flashattn.cu``).

``repro_flash_attention`` replaces
``repro/kernels/flashattn/kernel.py::flash_attention_pallas``: online-softmax
attention over (B, Hq, Sq, D) queries and (B, Hkv, Sk, D) keys and values in
one launch, reading K/V head ``h // (Hq // Hkv)`` in place (no repeated
copies), causal with the bottom-right alignment of ``attention_ref``, and
every Sq and Sk (the ragged edges are masked). The source is compiled with
nvcc into ``build/repro_torch/`` on first use
(:mod:`repro_torch.kernels.cudalib`). There is no fallback: a CUDA tensor
that reaches :func:`flash_attention_cuda` launches the kernel or raises.
``FLASH.launches`` counts the launches; ``launches_by_shape`` splits them by
(B, Hq, Hkv, Sq, Sk, D).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.cudalib import CudaKernel, CudaLibrary, check_cuda_tensors

SOURCE = Path(__file__).resolve().parent / "csrc" / "flashattn.cu"
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(SOURCE, {
    # q, k, v, o, B, Hq, Hkv, Sq, Sk, D, dtype, scale, causal, stream
    "repro_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I,
                              _P],
})


class FlashAttentionKernel(CudaKernel):
    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                 scale: float) -> torch.Tensor:
        """q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), one dtype (float32 or
        bfloat16), CUDA, contiguous and 16-byte aligned, D in HEAD_DIMS;
        returns (B, Hq, Sq, D) in q's dtype."""
        if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
            raise ValueError(f"flash_attention_cuda: q must be (B, Hq, Sq, D) and k, v "
                             f"(B, Hkv, Sk, D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                             f"{tuple(v.shape)}")
        b, hq, sq, d = q.shape
        hkv, sk = k.shape[1], k.shape[2]
        if k.shape[0] != b or k.shape[3] != d:
            raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)} and k {tuple(k.shape)} "
                             "differ in B or D")
        if q.dtype not in DTYPES:
            raise TypeError(f"flash_attention_cuda: dtype must be float32 or bfloat16, "
                            f"got {q.dtype}")
        check_cuda_tensors("flash_attention_cuda", ("q", q, q.dtype), ("k", k, q.dtype),
                           ("v", v, q.dtype))
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention_cuda: {name} must start on a 16-byte "
                                 "boundary (the kernel reads 16-byte vectors); pass a "
                                 "tensor of its own, not a view that starts inside one")
        if d not in HEAD_DIMS:
            raise ValueError(f"flash_attention_cuda: head dim must be one of {HEAD_DIMS}, "
                             f"got {d}")
        if hq % hkv:
            raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
        if causal and sq > sk:
            raise ValueError(f"causal attention needs Sq <= Sk, got Sq={sq} > Sk={sk}")
        if b * hq > 65535 or max(sq, sk) >= 2**31:
            raise ValueError(f"flash_attention_cuda: B·Hq = {b * hq} or S exceeds the grid")
        out = torch.empty_like(q)
        if out.numel() == 0:
            return out
        self.launch(q.device, (b, hq, hkv, sq, sk, d), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), b, hq, hkv, sq, sk, d, DTYPES[q.dtype], float(scale),
                    int(bool(causal)))
        return out


FLASH = FlashAttentionKernel(LIBRARY, "repro_flash_attention")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                         scale: float) -> torch.Tensor:
    """Launch the Hopper flash attention kernel (see :class:`FlashAttentionKernel`)."""
    return FLASH(q, k, v, causal, scale)
