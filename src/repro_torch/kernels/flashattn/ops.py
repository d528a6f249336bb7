"""Multi-head attention with GQA (port of ``repro.kernels.flashattn.ops``).

:func:`flash_attention` launches one flash attention kernel on CUDA tensors,
chosen by dtype (``CUDA_KERNELS``): float32 goes to ``FLASH`` (CUDA cores),
bfloat16 and float16 to ``FLASH_TC`` (tensor cores); any other dtype raises.
Two more routes (:func:`~repro_torch.kernels.flashattn.kernel.cuda_kernel`)
take what those two do not: 16-bit inputs at head dims 8, 160 and 256 go to
``FLASH_CORE``, and q, k or v that start off a 16-byte boundary (views into
larger tensors) to ``FLASH_UNALIGNED``, both on the CUDA cores. Every kernel
reads each K/V head in place for its group of query heads. On CPU tensors, of any
float dtype, it repeats K/V across the groups and runs the plain version
(:func:`attention_plain`), as the reference does off the TPU.

Causal attention aligns the diagonal bottom-right (query row i sees keys
j <= i + Sk - Sq), the reference oracle's alignment; for Sq = Sk it is the
Pallas kernel's too. Causal attention with Sq > Sk is refused: some rows would
see no key at all.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flashattn.kernel import FLASH, FLASH_TC, cuda_kernel
from repro_torch.kernels.flashattn.ref import attention_ref

# The card's kernel for each dtype (aligned inputs, FLASH_TC's head dims): a
# fixed route, not a fallback; cuda_kernel refines it by alignment and D.
CUDA_KERNELS = {dtype: kernel for kernel in (FLASH, FLASH_TC) for dtype in kernel.dtypes}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"q must be (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    hq, sq = q.shape[1], q.shape[2]
    hkv, sk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if causal and sq > sk:
        raise ValueError(f"causal attention needs Sq <= Sk, got Sq={sq} > Sk={sk}: rows "
                         "before the first key would attend to nothing")


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                    scale: float) -> torch.Tensor:
    """The plain version of :func:`flash_attention` on any device: K/V repeated
    across the groups, :func:`attention_ref`, cast to q's dtype."""
    b, hq, sq, d = q.shape
    rep = hq // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    sk = k.shape[2]
    out = attention_ref(q.reshape(b * hq, sq, d), k.reshape(b * hq, sk, d),
                        v.reshape(b * hq, sk, d), causal=causal, scale=scale)
    return out.to(q.dtype).reshape(b, hq, sq, d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, Sq, D); k, v (B, Hkv, Sk, D) with Hq % Hkv == 0. Returns
    (B, Hq, Sq, D) in q's dtype; ``scale`` defaults to 1/√D. On the card
    it takes float32, bfloat16 and float16 at D in {8, 16, 32, 64, 128, 160,
    256} (the route: :func:`~repro_torch.kernels.flashattn.kernel.cuda_kernel`)
    and raises for anything else."""
    _check(q, k, v, causal)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.is_cuda:
        if q.dtype not in CUDA_KERNELS:
            raise TypeError(f"flash_attention: the card's kernels take "
                            f"{tuple(CUDA_KERNELS)}, got {q.dtype}")
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        return cuda_kernel(q, k, v)(q, k, v, causal, scale)
    return attention_plain(q, k, v, causal=causal, scale=scale)
