"""RecurrentGemma's recurrent block (port of ``repro.models.rglru``): temporal
conv + RG-LRU (arXiv 2402.19427).

RG-LRU recurrence (per channel):
    r_t = σ(W_r x_t),  i_t = σ(W_i x_t)
    a_t = exp(−c · softplus(Λ) · r_t)                    (c = 8)
    h_t = a_t · h_{t−1} + sqrt(1 − a_t²) · (i_t · x_t)

Block layout (Griffin): in-proj to two branches (x, gate); x-branch: conv1d →
RG-LRU; merged: h · gelu(gate) → out-proj.

The reference's order of operations is kept: the conv's taps summed in
order, softplus as logaddexp(x, 0), tanh-GELU (``jax.nn.gelu``'s default),
the gates in float32. Products go through :func:`~repro_torch.models.layers.dense`,
so a ``QWeight`` takes the ``qmm`` kernel on the card for a decode step's B
rows (the gates' products on float32 x, as the reference materializes their
kernels in float32) and materialize + matmul past ``QMM_MAX_ROWS``.

Prefill and forward evaluate the linear recurrence with a log-depth scan
(:func:`linear_scan`, ⌈log₂ S⌉ elementwise steps on (B, S, W) float32 in
plain PyTorch; the reference's ``associative_scan`` is XLA, no Pallas
kernel); decode is one step of the recurrence.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import random as prng
from repro_torch.models.layers import causal_conv, dense, dense_init

_C = 8.0


def rglru_init(key, d_model: int, width: int, d_conv: int, device=None):
    ks = prng.split(key, 6)
    return {
        "in_x": dense_init(ks[0], d_model, width, device=device),
        "in_gate": dense_init(ks[1], d_model, width, device=device),
        "conv_w": prng.normal(ks[2], (d_conv, width), device=device) * 0.02,
        "conv_b": torch.zeros((width,), dtype=torch.float32, device=device),
        "w_r": dense_init(ks[3], width, width, device=device),
        "w_i": dense_init(ks[4], width, width, device=device),
        # Λ init so that a^c is roughly in [0.9, 0.999]
        "lambda_raw": torch.linspace(0.3, 1.5, width, dtype=torch.float32, device=device),
        "out": dense_init(ks[5], width, d_model, device=device),
    }


class RGLRUState(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, width)
    h: torch.Tensor      # (B, width) float32


def init_rglru_state(b: int, width: int, d_conv: int, device=None) -> RGLRUState:
    return RGLRUState(
        conv=torch.zeros((b, d_conv - 1, width), dtype=torch.float32, device=device),
        h=torch.zeros((b, width), dtype=torch.float32, device=device),
    )


def _gates(p, x: torch.Tensor):
    """(a, gated input), float32 (B, S, W)."""
    xf = x.to(torch.float32)
    r = torch.sigmoid(dense(p["w_r"], xf, torch.float32))
    i = torch.sigmoid(dense(p["w_i"], xf, torch.float32))
    softplus = torch.logaddexp(p["lambda_raw"], torch.zeros((), dtype=torch.float32,
                                                            device=xf.device))
    log_a = -_C * softplus * r                                   # (B,S,W) <= 0
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * xf)
    return a, gated_in


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t−1} + b_t along dim 1 from h_{−1} = 0: the associative
    scan of (a1, b1)∘(a2, b2) = (a1a2, a2 b1 + b2), as ⌈log₂ S⌉ doubling
    steps (Hillis–Steele) of elementwise work."""
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < s:
            a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def rglru_sequence(p, u: torch.Tensor, conv_state: Optional[torch.Tensor] = None):
    """The block over a whole sequence u (B, S, d_model) from a conv state
    (zeros if None) and h = 0: (y (B, S, d_model), the new conv state, the
    last h (B, W) float32)."""
    x = dense(p["in_x"], u)
    gate = dense(p["in_gate"], u)
    x, conv_new = causal_conv(p, x, conv_state)
    a, b = _gates(p, x)                                          # (B,S,W) each
    h = linear_scan(a, b)
    y = h.to(u.dtype) * F.gelu(gate, approximate="tanh")          # jax.nn.gelu's default
    return dense(p["out"], y), conv_new, h[:, -1]


def rglru_apply(p, u: torch.Tensor, width: int) -> torch.Tensor:
    """u: (B, S, d_model) → (B, S, d_model) via the scan over S."""
    del width
    return rglru_sequence(p, u)[0]


def rglru_decode_step(p, u: torch.Tensor, state: RGLRUState, width: int):
    """u: (B, 1, d_model) → (y, new_state)."""
    del width
    x = dense(p["in_x"], u)
    gate = dense(p["in_gate"], u)
    x, conv_new = causal_conv(p, x, state.conv)
    a, b = _gates(p, x)                                          # (B,1,W)
    h = a[:, 0] * state.h + b[:, 0]                              # (B,W)
    y = h[:, None, :].to(u.dtype) * F.gelu(gate, approximate="tanh")
    y = dense(p["out"], y)
    return y, RGLRUState(conv=conv_new, h=h)
