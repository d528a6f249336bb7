"""Weight-only quantized parameters (port of ``repro.models.quantized``): the
paper's low-precision data representation applied to LM serving.

Decode is the LM analog of IHT: an iterative, bandwidth-bound loop that
re-streams a fixed large operand (weights ↔ measurement matrix) against a
small iterate (activations ↔ residual). Storing weights as packed 2/4/8-bit
codes cuts the streamed bytes by 16/8/4×.

* :class:`QWeight` — packed codes + per-channel scale for an (..., in, out)
  kernel, stored as (..., out, packed_in) codes biased by +K and an
  (..., out, 1) f32 scale: the byte layout of ``repro_torch.kernels.qmm``
  (one scale per output row). Leading dims are kept, so the stacked layer
  weights (L, in, out) quantize in one go and ``qw[l]`` is layer l's.
* :func:`materialize` / :func:`qdense` — dequantize and multiply (the
  reference's computation; on the card the decode products with few rows go
  through ``qmm`` instead, see :func:`repro_torch.models.layers.dense`).
* :func:`quantize_params` — rewrite a parameter tree for serving, with the
  reference's nearest or stochastic codes bit for bit.
* :func:`param_bytes` — stored bytes of a (possibly quantized) tree.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import random as prng
from repro_torch.kernels.qmm.ops import PackedWeights
from repro_torch.quant.formats import BY_BITS, PER_CHANNEL
from repro_torch.quant.pack import pack_codes, unpack_codes
from repro_torch.quant.quantize import quantize_codes
from repro_torch.tree import tree_leaves


class QWeight:
    """An (..., in, out) kernel stored as (..., out, packed_in) codes."""

    def __init__(self, packed: torch.Tensor, scale: torch.Tensor, bits: int, k_dim: int):
        self.packed = packed          # (..., out, packed_len(in, bits)) uint8
        self.scale = scale            # (..., out, 1) f32
        self.bits = int(bits)
        self.k_dim = int(k_dim)       # logical `in` (contraction) dimension

    def __getitem__(self, index) -> "QWeight":
        """The kernel at a leading index (layer l of a stacked weight)."""
        return QWeight(self.packed[index], self.scale[index], self.bits, self.k_dim)

    def to(self, device) -> "QWeight":
        return QWeight(self.packed.to(device), self.scale.to(device), self.bits, self.k_dim)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """Returns the (..., in, out) kernel."""
        codes = unpack_codes(self.packed, self.bits, self.k_dim)   # (..., out, in)
        k = BY_BITS[self.bits].half_steps
        w = codes.to(torch.float32) * (self.scale / k)
        return w.transpose(-1, -2).to(dtype)

    def packed_weights(self) -> PackedWeights:
        """A 2-D kernel as the ``PackedWeights`` that ``qmm`` takes: the same
        bytes, its per-row scales as (1, out)."""
        if self.packed.ndim != 2:
            raise ValueError(f"qmm takes one (out, packed_in) kernel, got codes of shape "
                             f"{tuple(self.packed.shape)}; index the leading dims first")
        return PackedWeights(packed=self.packed, scale=self.scale.reshape(1, -1),
                             bits=self.bits, k_dim=self.k_dim, granularity=PER_CHANNEL)


def quantize_weight(w: torch.Tensor, bits: int, key: Optional[torch.Tensor] = None) -> QWeight:
    """Quantize an (..., in, out) kernel; one scale per (leading dims ×
    out-channel); codes packed along the contraction (in) axis. A stochastic
    rounding draws its uniforms over the flattened (lead·out, in) matrix, as
    the reference does."""
    wt = w.transpose(-1, -2)                 # (..., out, in)
    lead = tuple(wt.shape[:-1])
    k_dim = wt.shape[-1]
    flat = wt.reshape(-1, k_dim)
    codes, scale = quantize_codes(flat, bits, key, channel_axis=0)
    packed = pack_codes(codes, bits)
    return QWeight(packed.reshape(lead + (packed.shape[-1],)),
                   scale.reshape(lead + (1,)).to(torch.float32), bits, k_dim)


def materialize(w, dtype: torch.dtype) -> torch.Tensor:
    """Dense kernel from either a plain tensor or a QWeight."""
    if isinstance(w, QWeight):
        return w.dequantize(dtype)
    return w.to(dtype)


def qdense(p, x: torch.Tensor, dtype=None) -> torch.Tensor:
    dtype = dtype or x.dtype
    y = x @ materialize(p["w"], dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


_SKIP_SUBTREES = ("embed",)            # token-embedding gather stays dense
_QUANT_KEYS = ("w", "wi_gate", "wi_up", "wo")


def quantize_params(params, bits: int, key: Optional[torch.Tensor] = None,
                    stochastic: bool = False):
    """Rewrite eligible kernels (any >=2-D float 'w' / expert stack outside
    norms and the token embedding) as packed QWeights. Nearest rounding by
    default; ``stochastic=True`` with a key draws kernel i's uniforms from
    ``fold_in(key, i)``, i counted from 1 in the tree's order, as the
    reference does. ``"unembed"`` is not ``"embed"``: the unembedding is
    quantized, packed along the vocabulary."""
    counter = [0]

    def next_key():
        counter[0] += 1
        if stochastic and key is not None:
            return prng.fold_in(key, counter[0])
        return None

    def eligible(k, v):
        return (k in _QUANT_KEYS and isinstance(v, torch.Tensor) and v.ndim >= 2
                and v.dtype in (torch.float32, torch.bfloat16))

    def rewrite(path, sub):
        if isinstance(sub, (list, tuple)):
            return type(sub)(rewrite(path + (str(i),), e) for i, e in enumerate(sub))
        if not isinstance(sub, dict):
            return sub
        out = {}
        for k, v in sub.items():
            p = path + (k,)
            if any(s in p for s in _SKIP_SUBTREES):
                out[k] = v
            elif isinstance(v, (dict, list, tuple)):
                out[k] = rewrite(p, v)
            elif eligible(k, v):
                out[k] = quantize_weight(v, bits, next_key())
            else:
                out[k] = v
        return out

    return rewrite((), params)


def tree_to(tree, device):
    """The nested dict/list/tuple with every tensor and QWeight on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device)


def param_bytes(params) -> int:
    """Total stored bytes of a (possibly quantized) param tree."""
    total = 0
    for leaf in tree_leaves(params):
        for t in ((leaf.packed, leaf.scale) if isinstance(leaf, QWeight) else (leaf,)):
            total += t.numel() * t.element_size()
    return total
