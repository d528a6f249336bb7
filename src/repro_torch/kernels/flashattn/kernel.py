"""ctypes bindings of the Hopper flash attention kernels.

All four replace ``repro/kernels/flashattn/kernel.py::flash_attention_pallas``:
online-softmax attention over (B, Hq, Sq, D) queries and (B, Hkv, Sk, D)
keys and values in one launch, reading K/V head ``h // (Hq // Hkv)`` in place
(no repeated copies), causal with the bottom-right alignment of
``attention_ref``, and every Sq and Sk (the ragged edges are masked).

* ``FLASH`` (``csrc/flashattn.cu``, ``repro_flash_attention``): float32, on
  the CUDA cores, the products in full float32.
* ``FLASH_UNALIGNED`` (``csrc/flashattn.cu``,
  ``repro_flash_attention_unaligned``): the same when q, k or v does not
  start on a 16-byte boundary (a view into a larger tensor), with scalar
  loads; no copy is made.
* ``FLASH_TC`` (``csrc/flashattn_wgmma.cu``, ``repro_flash_attention_tc``):
  bfloat16 and float16 on the tensor cores (``wgmma``, TMA-fed tiles),
  float32 accumulation and softmax, P rounded to the input type for P·V.
* ``FLASH_TC_UNALIGNED`` (``csrc/flashattn_wgmma.cu``,
  ``repro_flash_attention_tc_unaligned``): the same when q, k or v does not
  start on a 16-byte boundary; its producer warpgroup loads the tiles
  itself (TMA needs the boundary), and no copy is made.

Every kernel takes every head dim of the reference's model configs
(``HEAD_DIMS``). :func:`cuda_kernel` is the route. Each source is compiled with nvcc into
``build/repro_torch/`` on first use (:mod:`repro_torch.kernels.cudalib`).
There is no fallback: a CUDA tensor that reaches a wrapper launches its
kernel or raises. ``launches`` counts each kernel's launches;
``launches_by_shape`` splits them by (B, Hq, Hkv, Sq, Sk, D).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.cudalib import CudaKernel, CudaLibrary, check_cuda_tensors

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flashattn.cu"
TC_SOURCE = CSRC / "flashattn_wgmma.cu"
HEAD_DIMS = (8, 16, 32, 64, 128, 160, 256)     # every head dim in src/repro/configs
DTYPES = {torch.float32: 0}                            # FLASH, FLASH_UNALIGNED
TC_DTYPES = {torch.bfloat16: 1, torch.float16: 2}      # FLASH_TC, FLASH_TC_UNALIGNED
_P, _I = ctypes.c_void_p, ctypes.c_int
# q, k, v, o, B, Hq, Hkv, Sq, Sk, D, dtype, scale, causal, stream
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P]
LIBRARY = CudaLibrary(SOURCE, {"repro_flash_attention": _ARGS,
                               "repro_flash_attention_unaligned": _ARGS})
TC_LIBRARY = CudaLibrary(TC_SOURCE, {"repro_flash_attention_tc": _ARGS,
                                     "repro_flash_attention_tc_unaligned": _ARGS})


def aligned(*tensors: torch.Tensor) -> bool:
    """Whether every tensor starts on a 16-byte boundary (TMA tiles and
    16-byte vector loads need it)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


class FlashAttentionKernel(CudaKernel):
    """One flash attention entry: the dtypes and head dims it takes, and
    whether q, k and v must start on a 16-byte boundary."""

    def __init__(self, library: CudaLibrary, entry: str, dtypes: dict,
                 needs_alignment: bool = True):
        super().__init__(library, entry)
        self.dtypes = dict(dtypes)
        self.head_dims = HEAD_DIMS
        self.needs_alignment = needs_alignment

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                 scale: float) -> torch.Tensor:
        """q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), one dtype of
        ``self.dtypes``, CUDA and contiguous (and 16-byte aligned where
        ``self.needs_alignment``), D in ``self.head_dims``; returns (B, Hq,
        Sq, D) in q's dtype."""
        if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
            raise ValueError(f"{self.entry}: q must be (B, Hq, Sq, D) and k, v "
                             f"(B, Hkv, Sk, D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                             f"{tuple(v.shape)}")
        b, hq, sq, d = q.shape
        hkv, sk = k.shape[1], k.shape[2]
        if k.shape[0] != b or k.shape[3] != d:
            raise ValueError(f"{self.entry}: q {tuple(q.shape)} and k {tuple(k.shape)} "
                             "differ in B or D")
        if q.dtype not in self.dtypes:
            raise TypeError(f"{self.entry}: dtype must be one of {tuple(self.dtypes)}, "
                            f"got {q.dtype}")
        if d not in self.head_dims:
            raise ValueError(f"{self.entry}: head dim must be one of {self.head_dims}, "
                             f"got {d}")
        check_cuda_tensors(self.entry, ("q", q, q.dtype), ("k", k, q.dtype),
                           ("v", v, q.dtype))
        for name, t in (("q", q), ("k", k), ("v", v)):
            if self.needs_alignment and not aligned(t):
                raise ValueError(f"{self.entry}: {name} must start on a 16-byte boundary "
                                 "(this kernel reads 16-byte vectors or TMA tiles); "
                                 "flash_attention routes a view that starts off it to "
                                 "FLASH_UNALIGNED or FLASH_TC_UNALIGNED")
        if hq % hkv:
            raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
        if causal and sq > sk:
            raise ValueError(f"causal attention needs Sq <= Sk, got Sq={sq} > Sk={sk}")
        if b * hq > 65535 or max(sq, sk) >= 2**31:
            raise ValueError(f"{self.entry}: B·Hq = {b * hq} or S exceeds the grid")
        out = torch.empty_like(q)
        if out.numel() == 0:
            return out
        self.launch(q.device, (b, hq, hkv, sq, sk, d), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), b, hq, hkv, sq, sk, d, self.dtypes[q.dtype], float(scale),
                    int(bool(causal)), out=out)
        return out


FLASH = FlashAttentionKernel(LIBRARY, "repro_flash_attention", DTYPES)
FLASH_TC = FlashAttentionKernel(TC_LIBRARY, "repro_flash_attention_tc", TC_DTYPES)
FLASH_TC_UNALIGNED = FlashAttentionKernel(TC_LIBRARY, "repro_flash_attention_tc_unaligned",
                                          TC_DTYPES, needs_alignment=False)
FLASH_UNALIGNED = FlashAttentionKernel(LIBRARY, "repro_flash_attention_unaligned", DTYPES,
                                       needs_alignment=False)
KERNELS = (FLASH, FLASH_TC, FLASH_TC_UNALIGNED, FLASH_UNALIGNED)


def cuda_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> FlashAttentionKernel:
    """The card's kernel for these inputs, a fixed route, not a fallback:
    float32 to ``FLASH``, bfloat16 and float16 to ``FLASH_TC``, each to its
    ``_UNALIGNED`` twin when q, k or v starts off a 16-byte boundary."""
    if q.dtype in DTYPES:
        return FLASH if aligned(q, k, v) else FLASH_UNALIGNED
    return FLASH_TC if aligned(q, k, v) else FLASH_TC_UNALIGNED

