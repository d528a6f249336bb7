"""Core neural layers (port of ``repro.models.layers``): norms, RoPE, dense
and GQA attention, MLP variants, KV caches (float or int8-quantized: the
paper's Q applied to the "observations").

Parameters are plain nested dicts of tensors; initialization is explicit and
draws from :mod:`repro_torch.random` (the reference's threefry), on the
``device`` given. Routes on the card, each fixed and counted by its kernel:

* :func:`dense` on a :class:`~repro_torch.models.quantized.QWeight` with at
  most ``QMM_MAX_ROWS`` rows of x (the decode loop, short prefills) →
  :func:`qweight_product`, the ``qmm`` kernel on the packed codes as they
  are stored; more rows (long prefills) → materialize + ``torch.matmul``,
  the reference's own computation.
* :func:`chunked_attention` → :func:`attention_kernel`, the
  ``flash_attention`` kernel (bf16 on the tensor cores, f32 on the CUDA
  cores), causal or not, with the reference's ``window`` and ``q_offset``.
  With a gradient (training) it is :class:`KernelAttention`: that kernel
  forward and the reference's flash-style backward as a fixed plain route
  (:func:`attention_backward_plain`, counted in ``ATTENTION_BACKWARD``),
  with the same window and offset. K/V of another dtype than q (the
  vlm's cross-attention: a bf16 query over K/V projected from float32 image
  embeddings) are cast to q's dtype first, a fixed route counted in
  ``ATTENTION_KV_CAST`` (the kernels take one dtype; the reference casts
  all three to float32, and caches the memory's K/V in q's dtype).
* :func:`decode_attention`, the KV-cache quantization, norms, RoPE and the
  MLP activations are plain PyTorch on both devices, as they are einsums and
  elementwise ops in the reference.

On the CPU every route runs its plain version: materialize + matmul, and the
reference's chunked online softmax (:func:`chunked_attention_plain`).

The KV cache's ``length`` is a host integer, so a token is written at a
Python index without a device sync. :func:`cache_update` writes the new
tokens into the cache's tensors in place (the returned cache shares them):
a cache is used by one generation.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import random as prng
from repro_torch.kernels.flashattn.ops import flash_attention
from repro_torch.kernels.qmm.ops import qmm
from repro_torch.models.quantized import QWeight, materialize
from repro_torch.quant.formats import BY_BITS

# The most rows of x a QWeight product sends to qmm on the card (a decode
# step has B rows); past it, materialize + matmul. chip_smoke.py's lm phase
# times a starcoder2-3b layer's six products on both routes: on an H100 qmm
# is ahead up to 512 rows and behind at 1,024 (PERF.md §6).
QMM_MAX_ROWS = 512

# ---------------------------------------------------------------------------
# init helpers


def dense_init(key, in_dim: int, out_dim: int, bias: bool = False, scale: float = 0.02,
               device=None):
    p = {"w": prng.normal(key, (in_dim, out_dim), device=device) * scale}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=torch.float32, device=device)
    return p


def norm_init(d: int, norm_type: str, device=None):
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if norm_type == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


# ---------------------------------------------------------------------------
# apply helpers


def qweight_product(x: torch.Tensor, w: QWeight) -> torch.Tensor:
    """x @ dequant(w) through the ``qmm`` kernel, (..., in) → (..., out)
    float32: the layer's codes and per-row scales as they are stored."""
    pw = w.packed_weights()
    y = qmm(x.reshape(-1, w.k_dim), pw)
    return y.reshape(tuple(x.shape[:-1]) + (y.shape[-1],))


def dense(p, x, dtype=None):
    dtype = dtype or x.dtype
    w = p["w"]
    if isinstance(w, QWeight) and x.is_cuda and x.numel() // x.shape[-1] <= QMM_MAX_ROWS:
        y = qweight_product(x, w).to(dtype)
    else:
        y = x @ materialize(w, dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def apply_norm(p, x, norm_type: str, eps: float):
    xf = x.to(torch.float32)
    if norm_type == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"]
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)   # jnp.var: population
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding (rotate-half). x: (B, S, H, D); positions: (B, S) int."""
    d = x.shape[-1]
    half = d // 2
    freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    ang = positions[..., None].to(torch.float32) * freq          # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def causal_conv(p, x: torch.Tensor, conv_state: Optional[torch.Tensor] = None):
    """Causal depthwise conv over S of x (B, S, C) with ``p["conv_w"]`` (K, C)
    and ``p["conv_b"]``, its K taps summed in order, then the bias, from
    ``conv_state`` (the last K − 1 inputs; zeros if None). Returns (out, the
    new state) in x's dtype: the conv of the RG-LRU and of the SSD blocks."""
    w = p["conv_w"].to(x.dtype)
    k = w.shape[0]
    pad = (torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
           if conv_state is None else conv_state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s, :] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s, :] * w[i]
    out = out + p["conv_b"].to(x.dtype)
    new_state = xp[:, -(k - 1):, :] if k > 1 else pad
    return out, new_state


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10_000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_at(position, d: int, device=None) -> torch.Tensor:
    """Sinusoidal embedding for one position: O(d), table-free."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)
    ang = torch.as_tensor(position, dtype=torch.float32, device=device) / (
        10_000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# attention


def _pick_chunk(s: int, chunk: int) -> int:
    """Largest divisor of s that is <= chunk (handles non-power-of-two seqs,
    e.g. Whisper's 1500-frame encoder memory)."""
    if s <= chunk:
        return s
    for c in range(chunk, 0, -1):
        if s % c == 0:
            return c
    return s


def _attn_mask(q_pos, k_pos, causal, window):
    mask = torch.ones((q_pos.shape[0], q_pos.shape[1], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= q_pos[:, :, None] >= k_pos[None, None, :]
    if window is not None:
        mask &= q_pos[:, :, None] - k_pos[None, None, :] < window
    return mask


def chunked_attention_plain(q, k, v, *, causal: bool, chunk: int = 1024,
                            window: Optional[int] = None, q_offset: int = 0) -> torch.Tensor:
    """The reference's online-softmax attention over (chunk, chunk) blocks,
    in float32, cast to q's dtype: the plain version of
    :func:`chunked_attention`. q (B, Hq, Sq, D); k, v (B, Hkv, Sk, D)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = 1.0 / math.sqrt(d)
    cq, ck = _pick_chunk(sq, chunk), _pick_chunk(sk, chunk)
    nq, nk = sq // cq, sk // ck
    qf = q.to(torch.float32).reshape(b, hq, nq, cq, d)
    kf = k.to(torch.float32).reshape(b, hkv, nk, ck, d)
    vf = v.to(torch.float32).reshape(b, hkv, nk, ck, d)
    if rep > 1:
        kf = kf.repeat_interleave(rep, dim=1)
        vf = vf.repeat_interleave(rep, dim=1)
    q_pos = q_offset + torch.arange(sq, device=q.device).reshape(nq, cq)
    k_pos = torch.arange(sk, device=q.device).reshape(nk, ck)
    m_run = torch.full((b, hq, nq, cq, 1), -1e30, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((b, hq, nq, cq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, nq, cq, d), dtype=torch.float32, device=q.device)
    for j in range(nk):
        s = torch.einsum("bhncd,bhkd->bhnck", qf, kf[:, :, j]) * scale
        s = s.masked_fill(~_attn_mask(q_pos, k_pos[j], causal, window)[None, None], -1e30)
        m_new = torch.maximum(m_run, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m_run - m_new)
        l_run = alpha * l_run + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + torch.einsum("bhnck,bhkd->bhncd", p, vf[:, :, j])
        m_run = m_new
    out = acc / torch.clamp_min(l_run, 1e-30)
    return out.reshape(b, hq, sq, d).to(q.dtype)


def attention_kernel(q, k, v, causal: bool, window: Optional[int] = None,
                     q_offset: int = 0) -> torch.Tensor:
    """The card's route of :func:`chunked_attention`: the ``flash_attention``
    kernel, scale 1/√D, query i at key position q_offset + i, output in q's
    dtype."""
    return flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)


class RouteCounter:
    """Calls of a fixed plain route on the card, counted as a kernel's
    launches are (``launches``, ``reset_counts``)."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def reset_counts(self) -> None:
        self.launches = 0


# The attention backward on the card: a fixed plain route (the reference
# trains through XLA einsums, not a Pallas kernel), counted per call.
ATTENTION_BACKWARD = RouteCounter("attention_backward")
# The card's cast of K/V to q's dtype in chunked_attention, counted per call.
ATTENTION_KV_CAST = RouteCounter("attention_kv_cast")
# entries of one score block of the plain backward (256 MB of float32)
_BWD_BLOCK = 1 << 26


def _logsumexp_plain(qf, kf, q_pos, k_pos, scale, causal, window):
    """Row logsumexp of the masked scores, (b, h, nq, cq): one chunked Q·Kᵀ
    pass with a running max, as the reference's forward keeps it."""
    m_run = torch.full(qf.shape[:-1], -1e30, dtype=torch.float32, device=qf.device)
    l_run = torch.zeros_like(m_run)
    for j in range(kf.shape[2]):
        s = torch.einsum("bhncd,bhkd->bhnck", qf, kf[:, :, j]) * scale
        s = s.masked_fill(~_attn_mask(q_pos, k_pos[j], causal, window)[None, None], -1e30)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        l_run = torch.exp(m_run - m_new) * l_run + torch.exp(s - m_new[..., None]).sum(dim=-1)
        m_run = m_new
    return m_run + torch.log(torch.clamp_min(l_run, 1e-30))


def attention_backward_plain(q, k, v, out, dout, *, causal: bool, chunk: int = 1024,
                             window: Optional[int] = None, q_offset: int = 0):
    """(dq, dk, dv) of the reference's chunked attention, as its flash-style
    custom VJP computes them (``_flash_core_bwd``, float32): the logsumexp
    from one chunked Q·Kᵀ pass, δ = Σ dout·out, then per key chunk
    p = exp(s − lse), dv += pᵀ·dout, ds = p·(dout·vᵀ − δ)·scale, dq += ds·k,
    dk += dsᵀ·q. K/V are repeated over each GQA group, as the reference
    repeats them before the core, and their gradients summed back over it.
    Batch rows go in groups so that one score block stays near 256 MB.
    Query i sits at position q_offset + i and sees the keys of
    :func:`_attn_mask` (causal, within ``window``), in the logsumexp pass and
    in the key loop, as ``_flash_core_bwd`` masks both."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = 1.0 / math.sqrt(d)
    cq, ck = _pick_chunk(sq, chunk), _pick_chunk(sk, chunk)
    nq, nk = sq // cq, sk // ck
    q_pos = q_offset + torch.arange(sq, device=q.device).reshape(nq, cq)
    k_pos = torch.arange(sk, device=q.device).reshape(nk, ck)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    rows = max(1, _BWD_BLOCK // (hq * sq * ck))
    for b0 in range(0, b, rows):
        sl = slice(b0, b0 + rows)
        bb = q[sl].shape[0]
        qf = q[sl].to(torch.float32).reshape(bb, hq, nq, cq, d)
        kf = k[sl].to(torch.float32).reshape(bb, hkv, nk, ck, d)
        vf = v[sl].to(torch.float32).reshape(bb, hkv, nk, ck, d)
        if rep > 1:
            kf = kf.repeat_interleave(rep, dim=1)
            vf = vf.repeat_interleave(rep, dim=1)
        of = out[sl].to(torch.float32).reshape(bb, hq, nq, cq, d)
        gf = dout[sl].to(torch.float32).reshape(bb, hq, nq, cq, d)
        lse = _logsumexp_plain(qf, kf, q_pos, k_pos, scale, causal, window)
        delta = (gf * of).sum(dim=-1, keepdim=True)
        dqf = torch.zeros_like(qf)
        dkf = torch.empty_like(kf)
        dvf = torch.empty_like(vf)
        for j in range(nk):
            kj, vj = kf[:, :, j], vf[:, :, j]
            s = torch.einsum("bhncd,bhkd->bhnck", qf, kj) * scale
            s = s.masked_fill(~_attn_mask(q_pos, k_pos[j], causal, window)[None, None], -1e30)
            p = torch.exp(s - lse[..., None])
            dvf[:, :, j] = torch.einsum("bhnck,bhncd->bhkd", p, gf)
            dp = torch.einsum("bhncd,bhkd->bhnck", gf, vj)
            ds = p * (dp - delta) * scale
            dqf += torch.einsum("bhnck,bhkd->bhncd", ds, kj)
            dkf[:, :, j] = torch.einsum("bhnck,bhncd->bhkd", ds, qf)
        dq[sl] = dqf.reshape(bb, hq, sq, d)
        dk[sl] = dkf.reshape(bb, hkv, rep, sk, d).sum(dim=2)
        dv[sl] = dvf.reshape(bb, hkv, rep, sk, d).sum(dim=2)
    return dq, dk, dv


class KernelAttention(torch.autograd.Function):
    """Attention with a gradient on the card: the forward is the
    ``flash_attention`` kernel (:func:`attention_kernel`), the backward
    :func:`attention_backward_plain` from q, k, v, the kernel's output and
    the output's gradient, counted in ``ATTENTION_BACKWARD``; both with the
    call's window and query offset."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, chunk: int, window: Optional[int] = None,
                q_offset: int = 0):
        out = attention_kernel(q, k, v, causal, window, q_offset)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.chunk, ctx.window, ctx.q_offset = causal, chunk, window, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        ATTENTION_BACKWARD.launches += 1
        dq, dk, dv = attention_backward_plain(q, k, v, out, dout, causal=ctx.causal,
                                              chunk=ctx.chunk, window=ctx.window,
                                              q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None, None


def chunked_attention(
    q: torch.Tensor,             # (B, Hq, Sq, D)
    k: torch.Tensor,             # (B, Hkv, Sk, D)
    v: torch.Tensor,             # (B, Hkv, Sk, D)
    *,
    causal: bool,
    chunk: int = 1024,
    window: Optional[int] = None,   # sliding-window (local) attention
    q_offset: int = 0,              # global position of q[0]
) -> torch.Tensor:
    """Attention with the reference's semantics: query i (at position
    q_offset + i) sees key j when j <= q_offset + i (causal) and
    q_offset + i - j < window. On CUDA tensors it launches the flash
    attention kernel (:func:`attention_kernel`) with that window and offset;
    arguments under which a query row would see no key raise. Where q, k or
    v require a gradient it runs :class:`KernelAttention` (the kernel
    forward, the plain backward), with the same window and offset. K/V of
    another dtype than q are cast to q's first on the card
    (``ATTENTION_KV_CAST``). On the CPU it runs
    :func:`chunked_attention_plain` (float32 throughout, as the reference),
    and autograd differentiates that."""
    if not q.is_cuda:
        return chunked_attention_plain(q, k, v, causal=causal, chunk=chunk, window=window,
                                       q_offset=q_offset)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        ATTENTION_KV_CAST.launches += 1
        k, v = k.to(q.dtype), v.to(q.dtype)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return KernelAttention.apply(q, k, v, causal, chunk, window, q_offset)
    return attention_kernel(q, k, v, causal, window, q_offset)


def decode_attention(
    q: torch.Tensor,            # (B, Hq, 1, D)
    k: torch.Tensor,            # (B, Hkv, S, D)
    v: torch.Tensor,
    *,
    length: int,                # valid cache length: masks the tail
    window: Optional[int] = None,
) -> torch.Tensor:
    """Grouped-GQA decode attention: q is reshaped to (B, Hkv, rep, D) and
    contracted against the unrepeated cache, with float32 logits and
    accumulation (the reference's ``preferred_element_type``)."""
    b, hq, _, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qg = q[:, :, 0, :].reshape(b, hkv, rep, d)
    logits = torch.einsum("bhrd,bhkd->bhrk", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    pos = torch.arange(s, device=q.device)
    mask = pos < length
    if window is not None:
        mask &= pos >= length - window
    logits = logits.masked_fill(~mask, -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhrk,bhkd->bhrd", p.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(b, hq, 1, d).to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache (float or int8 codes — the paper's Q(y) analog)


class KVCache(NamedTuple):
    k: torch.Tensor                  # (B, Hkv, S, D) dtype or int8 codes
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]  # (B, Hkv, S, 1) f32 when quantized
    v_scale: Optional[torch.Tensor]
    length: int                      # tokens filled (a host integer)

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_kv_cache(b: int, hkv: int, s: int, d: int, dtype, kv_bits: Optional[int],
                  device=None) -> KVCache:
    if kv_bits:
        return KVCache(
            k=torch.zeros((b, hkv, s, d), dtype=torch.int8, device=device),
            v=torch.zeros((b, hkv, s, d), dtype=torch.int8, device=device),
            k_scale=torch.ones((b, hkv, s, 1), dtype=torch.float32, device=device),
            v_scale=torch.ones((b, hkv, s, 1), dtype=torch.float32, device=device),
            length=0,
        )
    return KVCache(
        k=torch.zeros((b, hkv, s, d), dtype=dtype, device=device),
        v=torch.zeros((b, hkv, s, d), dtype=dtype, device=device),
        k_scale=None,
        v_scale=None,
        length=0,
    )


def _quantize_kv(x: torch.Tensor, bits: int):
    """Per-(token, head) nearest-rounding quantization (half to even, as
    ``jnp.round``). x: (B, H, T, D)."""
    kk = BY_BITS[bits].half_steps
    scale = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-6)
    codes = torch.clamp(torch.round(x / scale * kk), -kk, kk).to(torch.int8)
    return codes, scale.to(torch.float32)


def _dequantize_kv(codes: torch.Tensor, scale: torch.Tensor, bits: int, dtype):
    kk = BY_BITS[bits].half_steps
    return (codes.to(torch.float32) * (scale / kk)).to(dtype)


def cache_update(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 kv_bits: Optional[int]) -> KVCache:
    """Write T new tokens at cache.length, in place. k_new: (B, Hkv, T, D).
    Raises when they do not fit (the reference's dynamic_update_slice would
    move the write back to fit)."""
    idx, t = cache.length, k_new.shape[2]
    if idx + t > cache.k.shape[2]:
        raise ValueError(f"KV cache of {cache.k.shape[2]} tokens holds {idx}; "
                         f"{t} more do not fit")
    if kv_bits:
        kc, ks = _quantize_kv(k_new.to(torch.float32), kv_bits)
        vc, vs = _quantize_kv(v_new.to(torch.float32), kv_bits)
        cache.k[:, :, idx:idx + t] = kc
        cache.v[:, :, idx:idx + t] = vc
        cache.k_scale[:, :, idx:idx + t] = ks
        cache.v_scale[:, :, idx:idx + t] = vs
    else:
        cache.k[:, :, idx:idx + t] = k_new.to(cache.k.dtype)
        cache.v[:, :, idx:idx + t] = v_new.to(cache.v.dtype)
    return cache._replace(length=idx + t)


def _roll_left(a: Optional[torch.Tensor]) -> None:
    if a is not None:
        a.copy_(torch.roll(a, -1, dims=2))


def cache_update_window(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                        window: int, kv_bits: Optional[int]) -> KVCache:
    """Sliding-window (ring-semantics) cache of fixed size ``window``, in place.

    Slots hold the last min(length, window) tokens in chronological order
    (RoPE is already applied at absolute positions, so order is all we need).
    Prefill (T >= window): keeps the last ``window`` of the new tokens.
    Decode (T == 1): shift-left-by-one when full, then write at the end.
    """
    t = k_new.shape[2]
    if t >= window:
        cache.k.zero_()
        cache.v.zero_()
        out = cache_update(cache._replace(length=0), k_new[:, :, -window:],
                           v_new[:, :, -window:], kv_bits)
        return out._replace(length=cache.length + t)
    if t != 1:
        # prefill shorter than the window: plain append (cache starts empty)
        return cache_update(cache, k_new, v_new, kv_bits)
    if cache.length >= window:
        for a in cache[:4]:
            _roll_left(a)
    out = cache_update(cache._replace(length=min(cache.length, window - 1)), k_new, v_new,
                       kv_bits)
    return out._replace(length=cache.length + 1)


def window_valid_length(cache: KVCache, window: int) -> int:
    return min(cache.length, window)


def cache_kv(cache: KVCache, kv_bits: Optional[int], dtype):
    if kv_bits:
        return (_dequantize_kv(cache.k, cache.k_scale, kv_bits, dtype),
                _dequantize_kv(cache.v, cache.v_scale, kv_bits, dtype))
    return cache.k, cache.v


# ---------------------------------------------------------------------------
# MLP variants


def mlp_init(key, d: int, ff: int, mlp_type: str, device=None):
    ks = prng.split(key, 3)
    if mlp_type == "swiglu":
        return {
            "wi_gate": dense_init(ks[0], d, ff, device=device),
            "wi_up": dense_init(ks[1], d, ff, device=device),
            "wo": dense_init(ks[2], ff, d, device=device),
        }
    return {"wi": dense_init(ks[0], d, ff, device=device),
            "wo": dense_init(ks[1], ff, d, device=device)}


def mlp_apply(p, x, mlp_type: str):
    if mlp_type == "swiglu":
        h = F.silu(dense(p["wi_gate"], x, x.dtype)) * dense(p["wi_up"], x, x.dtype)
    elif mlp_type == "gelu":
        h = F.gelu(dense(p["wi"], x, x.dtype), approximate="tanh")   # jax.nn.gelu's default
    elif mlp_type == "relu2":
        h = torch.square(F.relu(dense(p["wi"], x, x.dtype)))
    else:
        raise ValueError(mlp_type)
    return dense(p["wo"], h, x.dtype)
