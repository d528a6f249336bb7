"""Quantized gradient compression (port of ``repro.parallel.collectives``'s
``fake_grad_compression``): the paper's unbiased stochastic quantizer Q_b on
the training side. Each gradient leaf is rounded to b-bit integer codes at
one per-tensor scale and dequantized, as a quantized all-reduce's payload
would be; on one device there is no collective, only its numerics.

On the card the rounding is the ``sqround`` kernel. The reference draws
``u = jax.random.uniform(fold_in(key, i), g.shape)``, that is
``(bits >> 9)·2⁻²³``, where ``sqround`` compares against ``(w >> 8)·2⁻²⁴``;
handing the kernel ``w = bits & ~0x1FF`` makes the two the same float, so
the codes are the reference's bit for bit. The scale ``max(max|g|, 1e-30)``
is passed to the kernel explicitly, and the dequantize keeps the order
``codes·scale / K``. A leaf is done in flat chunks of ``CHUNK`` elements
(words drawn by flat index, one kernel launch per chunk) and written back
in place: the largest starcoder2-3b leaf has 1.13e9 entries, whose int64
words alone would be 9 GB.

``quantized_allreduce_mean``, ``make_qgrad_allreduce`` and the shard-local
quantizer wait for the sharding slice (ROADMAP.md queue 1 item 9).
"""
from __future__ import annotations

import torch

from repro_torch import random as prng
from repro_torch.kernels.sqround.kernel import sqround_cuda
from repro_torch.kernels.sqround.ref import sqround_ref
from repro_torch.quant.formats import BY_BITS
from repro_torch.tree import tree_leaves

CHUNK = 1 << 24                 # elements per threefry draw and sqround launch
_LOW_BITS = ~0x1FF              # the 9 bits that jax.random.uniform drops


def _codes(v: torch.Tensor, words: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """int8 codes of a float32 (1, n) chunk from its uniform words (held in
    int64, low 9 bits cleared): the ``sqround`` kernel on the card, its
    plain version on the CPU."""
    if v.is_cuda:
        return sqround_cuda(v, words, scale, bits)
    return sqround_ref(v, words, scale, bits)


def fake_grad_compression(grads, bits: int, key: torch.Tensor):
    """Q_b on every leaf of ``grads``, in place: leaf i (in JAX's leaf order)
    draws from ``fold_in(key, i)``. Returns ``grads``, whose tensors now
    hold the dequantized values in their own dtype."""
    k = BY_BITS[bits].half_steps
    with torch.no_grad():
        for i, g in enumerate(tree_leaves(grads)):
            sub = prng.fold_in(key, i)
            flat = g.view(-1)
            scale = torch.clamp_min(
                torch.linalg.vector_norm(flat, float("inf"), dtype=torch.float32), 1e-30)
            kk = torch.tensor(float(k), dtype=torch.float32, device=g.device)
            for s in range(0, flat.numel(), CHUNK):
                e = min(flat.numel(), s + CHUNK)
                words = prng._bits_flat(sub, s, e, g.device) & _LOW_BITS
                chunk = flat[s:e]
                codes = _codes(chunk.to(torch.float32).view(1, -1), words.view(1, -1), scale,
                               bits)
                chunk.copy_((codes.to(torch.float32) * scale / kk).view(-1))
    return grads
