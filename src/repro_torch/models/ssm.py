"""Mamba-2's SSD block (port of ``repro.models.ssm``; state-space duality,
Dao & Gu 2024, arXiv 2405.21060), in the minimal chunked-discrete form:

  per head h, scalar decay a_t = exp(Δ_t · A_h)   (A_h = −exp(A_log_h) < 0)
  h_t = a_t · h_{t−1} + Δ_t · x_t Bᵀ_t            (state: (headdim, d_state))
  y_t = C_t · h_t + D_h · x_t

Forward and prefill use the chunked algorithm (an intra-chunk quadratic term
and a recurrence over the chunk-final states, chunk ``cfg.ssm_chunk``);
decode is one O(1) step of the recurrence, so the serving state does not
grow with the context.

Layout: in_proj → (z, x, B, C, Δ); depthwise causal conv on (x, B, C), then
SiLU; gated RMSNorm on y·silu(z); out_proj.

The reference's order of operations is kept: the conv's taps summed in
order, then the bias; softplus as logaddexp(x, 0); the SSD in float32; the
intra-chunk decay masked in its exponent (−1e30 above the diagonal) before
``exp``; y_diag + y_off, then the D skip; the gated norm's product in the
activations' dtype and its RMS in float32 with eps 1e-6. The reference's
three- and four-operand einsums are written as two-operand contractions
(an elementwise product first), so that no intermediate grows past
(B, n_chunks, chunk, chunk, H) and the order of contraction is the same on
every machine. The recurrence over chunks is a loop in the reference's
order. Products go through :func:`~repro_torch.models.layers.dense`: on the
card a ``QWeight`` takes the ``qmm`` kernel for a decode step's B rows and
materialize + matmul past ``QMM_MAX_ROWS``; the rest is plain PyTorch, as
it is XLA in the reference (no Pallas kernel).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import random as prng
from repro_torch.models.layers import causal_conv, dense, dense_init


def ssd_init(key, d_model: int, d_inner: int, d_state: int, n_heads: int, d_conv: int,
             device=None):
    ks = prng.split(key, 5)
    conv_dim = d_inner + 2 * d_state
    return {
        "in_proj": dense_init(ks[0], d_model, 2 * d_inner + 2 * d_state + n_heads,
                              device=device),
        "conv_w": prng.normal(ks[1], (d_conv, conv_dim), device=device) * 0.02,
        "conv_b": torch.zeros((conv_dim,), dtype=torch.float32, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, n_heads, dtype=torch.float32,
                                          device=device)),
        "d_skip": torch.ones((n_heads,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((n_heads,), dtype=torch.float32, device=device),
        "norm_scale": torch.ones((d_inner,), dtype=torch.float32, device=device),
        "out_proj": dense_init(ks[2], d_inner, d_model, device=device),
    }


class SSMState(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, conv_dim) rolling conv inputs
    ssm: torch.Tensor    # (B, H, headdim, d_state) float32 recurrent state


def init_ssm_state(b: int, cfg, device=None) -> SSMState:
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return SSMState(
        conv=torch.zeros((b, cfg.ssm_conv - 1, conv_dim), dtype=torch.float32, device=device),
        ssm=torch.zeros((b, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state),
                        dtype=torch.float32, device=device),
    )


def _split_proj(p, u, d_inner: int, d_state: int):
    """z, x, B, C, Δ of the in-projection of u (B, S, d_model)."""
    zxbcdt = dense(p["in_proj"], u)
    return torch.split(zxbcdt, [d_inner, d_inner, d_state, d_state,
                                zxbcdt.shape[-1] - 2 * d_inner - 2 * d_state], dim=-1)


def _causal_conv(p, xbc, conv_state=None):
    """The depthwise causal conv over (B, S, C), then SiLU: (out, new state)."""
    out, new_state = causal_conv(p, xbc, conv_state)
    return F.silu(out), new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _gated_norm(p, y, z, eps: float = 1e-6):
    g = y * F.silu(z)
    gf = g.to(torch.float32)
    var = torch.mean(gf * gf, dim=-1, keepdim=True)
    return (gf * torch.rsqrt(var + eps) * p["norm_scale"]).to(y.dtype)


def chunk_recurrence(states: torch.Tensor, chunk_decay: torch.Tensor):
    """st_n = st_{n−1} · decay_n + states_n over the chunks (dim 1) from 0, in
    the reference's order: (the state before each chunk (B, nc, H, hd, ds),
    the final state (B, H, hd, ds))."""
    prev = torch.empty_like(states)
    st = torch.zeros_like(states[:, 0])
    for n in range(states.shape[1]):
        prev[:, n] = st
        st = st * chunk_decay[:, n, :, None, None] + states[:, n]
    return prev, st


def ssd_chunked(p, xr, bb, cc, dt, cfg):
    """The chunked SSD on the conv's outputs x (B, S, d_inner), B and C
    (B, S, d_state) and the projection's raw Δ (B, S, H), S a multiple of
    min(chunk, S), from a zero state, in float32: (y (B, S, H, hd) with the D
    skip, the final state (B, H, hd, ds))."""
    b, s, _ = xr.shape
    h, hd, ds = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    ck = min(cfg.ssm_chunk, s)
    nc = s // ck
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"])                  # (B,S,H)
    a = -torch.exp(p["a_log"])                                            # (H,)
    da = dt * a                                                           # log-decay
    xh = xr.to(torch.float32).reshape(b, nc, ck, h, hd)
    bh = bb.to(torch.float32).reshape(b, nc, ck, ds)
    chh = cc.to(torch.float32).reshape(b, nc, ck, ds)
    dth = dt.reshape(b, nc, ck, h)
    cum = torch.cumsum(da.reshape(b, nc, ck, h), dim=2)                   # (B,nc,ck,H)

    # intra-chunk: L[t, τ] = exp(cum_t − cum_τ) for t >= τ, the exponent
    # masked (not the exp: the entries above the diagonal would overflow)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]                   # (B,nc,t,τ,H)
    tri = torch.tril(torch.ones((ck, ck), dtype=torch.bool, device=xr.device))
    l_mat = torch.exp(torch.where(tri[None, None, :, :, None], seg, -1e30))
    scores = torch.einsum("bntd,bnsd->bnts", chh, bh)                     # (B,nc,t,τ)
    w = scores[..., None] * l_mat * dth[:, :, None, :, :]                 # (B,nc,t,τ,H)
    y_diag = torch.einsum("bntsh,bnshp->bnthp", w, xh)

    # chunk-final states: S_n = Σ_τ exp(cum_end − cum_τ)·Δ_τ·x_τ Bᵀ_τ
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)                     # (B,nc,ck,H)
    wx = (decay_to_end * dth)[..., None] * xh                             # (B,nc,ck,H,hd)
    states = torch.einsum("bnshp,bnsd->bnhpd", wx, bh)                    # (B,nc,H,hd,ds)
    prev_states, final = chunk_recurrence(states, torch.exp(cum[:, :, -1, :]))

    # inter-chunk: y_t += C_t · exp(cum_t)·S_{n−1}
    y_off = torch.einsum("bntd,bnhpd->bnthp", chh, prev_states) * torch.exp(cum)[..., None]
    y = (y_diag + y_off).reshape(b, s, h, hd)
    return y + xh.reshape(b, s, h, hd) * p["d_skip"][None, None, :, None], final


def ssd_sequence(p, u: torch.Tensor, cfg):
    """The block over u (B, S, d_model), S a multiple of min(chunk, S), from a
    zero conv state and a zero SSM state: (y (B, S, d_model), the pre-conv
    (x, B, C) inputs (B, S, conv_dim), the final SSM state (B, H, hd, ds)
    float32)."""
    b, s, _ = u.shape
    ds = cfg.ssm_state
    z, xr, bb, cc, dt = _split_proj(p, u, cfg.d_inner, ds)
    xbc_in = torch.cat([xr, bb, cc], dim=-1)
    xbc, _ = _causal_conv(p, xbc_in)
    xr, bb, cc = torch.split(xbc, [cfg.d_inner, ds, ds], dim=-1)
    y, final = ssd_chunked(p, xr, bb, cc, dt, cfg)
    y = _gated_norm(p, y.reshape(b, s, cfg.d_inner).to(u.dtype), z)
    return dense(p["out_proj"], y), xbc_in, final


def ssd_apply(p, u: torch.Tensor, cfg) -> torch.Tensor:
    """Chunked SSD forward. u: (B, S, d_model) → (B, S, d_model). S is
    zero-padded to a multiple of min(chunk, S), as the reference pads (causal:
    the pad cannot reach a real output)."""
    s = u.shape[1]
    ck = min(cfg.ssm_chunk, s)
    pad = -s % ck
    if pad:
        u = F.pad(u, (0, 0, 0, pad))
    y = ssd_sequence(p, u, cfg)[0]
    return y[:, :s] if pad else y


def ssd_decode_step(p, u: torch.Tensor, state: SSMState, cfg):
    """One-token recurrent step. u: (B, 1, d_model) → (y (B, 1, d_model),
    the new state: conv in u's dtype, ssm float32)."""
    b = u.shape[0]
    h, hd, ds = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    z, xr, bb, cc, dt = _split_proj(p, u, cfg.d_inner, ds)
    xbc, conv_new = _causal_conv(p, torch.cat([xr, bb, cc], dim=-1), state.conv)
    xr, bb, cc = torch.split(xbc, [cfg.d_inner, ds, ds], dim=-1)

    dt = _softplus(dt.to(torch.float32) + p["dt_bias"])[:, 0]             # (B,H)
    dec = torch.exp(dt * -torch.exp(p["a_log"]))                          # (B,H)
    xh = xr.to(torch.float32).reshape(b, h, hd)
    bh = bb.to(torch.float32)[:, 0]                                       # (B,ds)
    chh = cc.to(torch.float32)[:, 0]                                      # (B,ds)

    ssm_new = (state.ssm * dec[:, :, None, None]
               + (dt[:, :, None] * xh)[..., None] * bh[:, None, None, :])
    y = torch.einsum("bd,bhpd->bhp", chh, ssm_new)
    y = y + xh * p["d_skip"][None, :, None]
    y = y.reshape(b, 1, cfg.d_inner).to(u.dtype)
    y = _gated_norm(p, y, z)
    return dense(p["out_proj"], y), SSMState(conv=conv_new, ssm=ssm_new)
