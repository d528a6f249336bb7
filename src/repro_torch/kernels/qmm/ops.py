"""The packed path around the ``qmm`` kernel (port of ``repro.kernels.qmm.ops``).

* :func:`pack_weights` — quantize and pack an (N, K) matrix for qmm.
* :func:`qmm` — ``x @ dequant(w)ᵀ``: the Hopper kernel for a CUDA tensor, the
  plain PyTorch version (:func:`qmm_ref`) for a CPU tensor. Block-scaled
  weights (``per_block``) go to the group kernel or :func:`qmm_group_ref`.
  There is no padding: the kernels mask the ragged edges themselves.
* :class:`PackedOperator` / :func:`pack_operator` — Φ̂ in both orientations,
  the pair QNIHT streams every iteration; ``shared=True`` packs one
  quantization in both (the ``requantize="fixed"`` deployment mode).
* :func:`packed_matvec` / :func:`packed_rmatvec` — Φ̂x and Φ̂†r for real or
  complex Φ̂ through 1, 2 or 4 real qmm calls.

The reference's CPU-only ``qmm_fused`` pipeline has no counterpart: on the
card the kernel takes its place, on the CPU the plain version does. ``w_t``
is accepted for the reference's signature and ignored.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import torch

from repro_torch.kernels.qmm.kernel import qmm_cuda, qmm_group_cuda
from repro_torch.kernels.qmm.ref import qmm_group_ref, qmm_ref
from repro_torch.quant.formats import (
    BY_BITS,
    PER_CHANNEL,
    PER_TENSOR,
    Granularity,
    as_granularity,
)
from repro_torch.quant.pack import pack_codes, validate_group_packing
from repro_torch.quant.quantize import quantize, quantize_codes


@dataclasses.dataclass(frozen=True)
class PackedWeights:
    """(N, K) matrix quantized and packed along K.

    ``scale`` is f32 in one of two layouts: (1, N), one scale per output row
    (``per_tensor``, broadcast, and ``per_channel``), or (N, ⌈K/g⌉), one per
    g contiguous codes of a row (``per_block(g)``)."""

    packed: torch.Tensor      # (N, packed_len(K)) uint8
    scale: torch.Tensor       # (1, N) or (N, ⌈K/g⌉) float32
    bits: int
    k_dim: int
    granularity: Granularity = PER_TENSOR

    @property
    def nbytes(self) -> int:
        """Packed code bytes only (the stream the paper's bandwidth law counts)."""
        return self.packed.numel()

    @property
    def scale_nbytes(self) -> int:
        return self.granularity.scale_nbytes((self.packed.shape[0], self.k_dim))


def _resolve_granularity(granularity, per_channel: bool) -> Granularity:
    if granularity is not None:
        return as_granularity(granularity)
    return PER_CHANNEL if per_channel else PER_TENSOR


def pack_weights(
    w: torch.Tensor,
    bits: int,
    key: Optional[torch.Tensor] = None,
    per_channel: bool = True,
    granularity: Union[Granularity, str, None] = None,
) -> PackedWeights:
    """Quantize (stochastically if ``key`` is given) and pack an (N, K) real
    matrix, with one scale per tensor, per output row N, or per g contiguous
    K elements (``per_block(g)``, g a multiple of the packing word)."""
    if w.ndim != 2:
        raise ValueError("pack_weights expects (N, K)")
    gran = _resolve_granularity(granularity, per_channel)
    if gran.kind == "per_block":
        validate_group_packing(gran.group_size, bits)
        codes, scale = quantize_codes(w, bits, key, granularity=gran)
        return PackedWeights(
            packed=pack_codes(codes, bits),
            scale=scale.to(torch.float32).contiguous(),          # (N, ⌈K/g⌉)
            bits=bits,
            k_dim=w.shape[1],
            granularity=gran,
        )
    if gran.kind == "per_channel":
        codes, scale = quantize_codes(w, bits, key, channel_axis=0)
    else:
        codes, scale = quantize_codes(w, bits, key)
        scale = scale.expand(w.shape[0], 1)
    return PackedWeights(
        packed=pack_codes(codes, bits),
        scale=scale.reshape(1, -1).to(torch.float32).contiguous(),
        bits=bits,
        k_dim=w.shape[1],
        granularity=gran,
    )


def qmm(x: torch.Tensor, w: PackedWeights, *, w_t: Optional[PackedWeights] = None) -> torch.Tensor:
    """y = x @ dequant(w)ᵀ, (M, K) → (M, N) float32.

    A CUDA ``x`` launches a Hopper kernel (which raises if it cannot build
    or launch): the group kernel for ``per_block`` weights, else the
    per-row-scale one. A CPU ``x`` runs the matching plain version
    (:func:`qmm_group_ref` or :func:`qmm_ref`). ``w_t`` is ignored."""
    del w_t
    if x.shape[-1] != w.k_dim:
        raise ValueError(f"x K dim {x.shape[-1]} != packed k_dim {w.k_dim}")
    if x.device != w.packed.device:
        raise ValueError(f"x is on {x.device} but the packed weights on {w.packed.device}")
    if w.granularity.kind == "per_block":
        g = w.granularity.group_size
        if x.is_cuda:
            return qmm_group_cuda(x.to(torch.float32).contiguous(), w.packed, w.scale,
                                  w.bits, w.k_dim, g)
        return qmm_group_ref(x, w.packed, w.scale, w.bits, w.k_dim, g)
    if x.is_cuda:
        return qmm_cuda(x.to(torch.float32).contiguous(), w.packed, w.scale, w.bits, w.k_dim)
    return qmm_ref(x, w.packed, w.scale, w.bits, w.k_dim)


def _zero_byte(bits: int) -> int:
    """uint8 word whose every packed code is 0 (biased representation of 0)."""
    fmt = BY_BITS[bits]
    word = 0
    for i in range(fmt.values_per_byte):
        word |= fmt.half_steps << (bits * i)
    return word


class PackedOperator(NamedTuple):
    """A quantized CS measurement matrix in both orientations.

    ``fwd`` computes Φ̂x (Φ̂ as (M, N) packed along N), ``adj`` computes Φ̂†r
    (Φ̂ᵀ as (N, M) packed along M). Complex matrices carry real and
    imaginary parts separately.
    """

    fwd_re: PackedWeights
    fwd_im: Optional[PackedWeights]
    adj_re: PackedWeights
    adj_im: Optional[PackedWeights]

    @property
    def is_complex(self) -> bool:
        return self.fwd_im is not None

    @property
    def nbytes(self) -> int:
        total = self.fwd_re.nbytes + self.adj_re.nbytes
        if self.is_complex:
            total += self.fwd_im.nbytes + self.adj_im.nbytes
        return total

    @property
    def scale_nbytes(self) -> int:
        total = self.fwd_re.scale_nbytes + self.adj_re.scale_nbytes
        if self.is_complex:
            total += self.fwd_im.scale_nbytes + self.adj_im.scale_nbytes
        return total


def _pack_from_codes(codes: torch.Tensor, scale: torch.Tensor, bits: int) -> PackedWeights:
    """PackedWeights from (N, K) int codes and a scalar scale."""
    return PackedWeights(
        packed=pack_codes(codes.contiguous(), bits),
        scale=scale.to(torch.float32).reshape(1, 1).expand(1, codes.shape[0]).contiguous(),
        bits=bits,
        k_dim=codes.shape[1],
    )


def pack_operator(
    phi: torch.Tensor,
    bits: int,
    key: Optional[torch.Tensor] = None,
    per_channel: bool = False,
    shared: bool = False,
    granularity: Union[Granularity, str, None] = None,
) -> PackedOperator:
    """Quantize a dense (M, N) measurement matrix for streaming IHT.

    ``shared=True`` quantizes once (per-tensor scale) and packs the same codes
    in both orientations: the adjoint identity ⟨Φ̂x, r⟩ = ⟨x, Φ̂†r⟩ is exact and
    the codes equal ``fake_quantize(phi, bits, key)``'s. ``shared=False``
    draws an independent quantization per orientation (and per part, for a
    complex Φ) from ``split(key, 2)`` or ``split(key, 4)``; it is the only
    mode for ``per_channel``/``per_block``, whose scales follow each
    orientation's own axes.
    """
    from repro_torch import random as prng

    gran = _resolve_granularity(granularity, per_channel)
    if shared and not gran.is_per_tensor:
        raise ValueError(
            f"pack_operator(shared=True) streams ONE per-tensor quantization "
            f"through both orientations; a {gran} scale is tied to each "
            f"orientation's own axes. Pass shared=False or granularity='per_tensor'.")
    if shared:
        q = quantize(phi, bits, key)
        if q.is_complex:
            cre, cim = q.codes[0], q.codes[1]
            return PackedOperator(
                fwd_re=_pack_from_codes(cre, q.scale, bits),
                fwd_im=_pack_from_codes(cim, q.scale, bits),
                adj_re=_pack_from_codes(cre.T, q.scale, bits),
                adj_im=_pack_from_codes(cim.T, q.scale, bits),
            )
        return PackedOperator(
            fwd_re=_pack_from_codes(q.codes, q.scale, bits),
            fwd_im=None,
            adj_re=_pack_from_codes(q.codes.T, q.scale, bits),
            adj_im=None,
        )
    if phi.is_complex():
        re, im = phi.real, phi.imag
        keys = list(prng.split(key, 4)) if key is not None else [None] * 4
        return PackedOperator(
            fwd_re=pack_weights(re.contiguous(), bits, keys[0], granularity=gran),
            fwd_im=pack_weights(im.contiguous(), bits, keys[1], granularity=gran),
            adj_re=pack_weights(re.T.contiguous(), bits, keys[2], granularity=gran),
            adj_im=pack_weights(im.T.contiguous(), bits, keys[3], granularity=gran),
        )
    keys = list(prng.split(key, 2)) if key is not None else [None, None]
    return PackedOperator(
        fwd_re=pack_weights(phi, bits, keys[0], granularity=gran),
        fwd_im=None,
        adj_re=pack_weights(phi.T.contiguous(), bits, keys[1], granularity=gran),
        adj_im=None,
    )


def _real_f32(v: torch.Tensor) -> torch.Tensor:
    return (v.real if v.is_complex() else v).to(torch.float32).contiguous()


def packed_matvec(op: PackedOperator, x: torch.Tensor) -> torch.Tensor:
    """Φ̂x for real or complex Φ̂; ``x`` is (N,) or a batch (B, N), served by
    one kernel call per real product."""
    single = x.ndim == 1
    xb = x[None, :] if single else x
    if not op.is_complex:
        out = qmm(_real_f32(xb), op.fwd_re)
        return out[0] if single else out
    xr = _real_f32(xb)
    rr = qmm(xr, op.fwd_re)
    ir = qmm(xr, op.fwd_im)
    if not x.is_complex():
        # real input (a real sky through complex Φ̂): the imaginary-part
        # products are zero, so the packed matrices stream once, not twice
        out = torch.complex(rr, ir)
        return out[0] if single else out
    xi = xb.imag.to(torch.float32).contiguous()
    ri = qmm(xi, op.fwd_re)
    ii = qmm(xi, op.fwd_im)
    out = torch.complex(rr - ii, ri + ir)
    return out[0] if single else out


def packed_rmatvec(op: PackedOperator, r: torch.Tensor) -> torch.Tensor:
    """Φ̂†r (conjugate transpose) for real or complex Φ̂; (M,) or (B, M)."""
    single = r.ndim == 1
    rb = r[None, :] if single else r
    if not op.is_complex:
        out = qmm(_real_f32(rb), op.adj_re)
        return out[0] if single else out
    # Φ† = (Re − j·Im)ᵀ ; Φ†r = (Reᵀ r_re + Imᵀ r_im) + j(Reᵀ r_im − Imᵀ r_re)
    rr_ = _real_f32(rb)
    t1 = qmm(rr_, op.adj_re)
    t4 = qmm(rr_, op.adj_im)
    if not r.is_complex():
        out = torch.complex(t1, -t4)
        return out[0] if single else out
    ri_ = rb.imag.to(torch.float32).contiguous()
    t2 = qmm(ri_, op.adj_im)
    t3 = qmm(ri_, op.adj_re)
    out = torch.complex(t1 + t2, t3 - t4)
    return out[0] if single else out
