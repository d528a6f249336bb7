"""Plain PyTorch version of fused attention (port of
``repro.kernels.flashattn.ref``): softmax(QKᵀ·scale)V in float32 with the
whole score matrix in memory, so for small shapes and for checking.

Causal masking aligns the diagonal bottom-right by default, as the
reference's ``attention_ref`` does (``tril(k = Sk - Sq)``): query row i
attends keys j <= i + (Sk - Sq). For Sq = Sk that is the usual j <= i. With
``off``, query row i sits at key position i + off instead (the reference's
``chunked_attention`` takes ``q_offset``), and with a ``window`` it sees only
keys j with i + off - j < window, as that function's ``_attn_mask``.
"""
from __future__ import annotations

from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                  scale: float, window: Optional[int] = None,
                  off: Optional[int] = None) -> torch.Tensor:
    """q (BH, Sq, D), k and v (BH, Sk, D); returns (BH, Sq, D) float32."""
    qf, kf, vf = (a.to(torch.float32) for a in (q, k, v))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    sq, sk = q.shape[-2], k.shape[-2]
    if causal or window:
        pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq if off is None else off)
        key = torch.arange(sk, device=q.device)[None, :]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= key <= pos
        if window:
            mask &= pos - key < window
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.matmul(p, vf)
