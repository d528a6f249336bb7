"""Plain PyTorch version of fused attention (port of
``repro.kernels.flashattn.ref``): softmax(QKᵀ·scale)V in float32 with the
whole score matrix in memory, so for small shapes and for checking.

Causal masking aligns the diagonal bottom-right, as the reference's
``attention_ref`` does (``tril(k = Sk - Sq)``): query row i attends keys
j <= i + (Sk - Sq). For Sq = Sk that is the usual j <= i.
"""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                  scale: float) -> torch.Tensor:
    """q (BH, Sq, D), k and v (BH, Sk, D); returns (BH, Sq, D) float32."""
    qf, kf, vf = (a.to(torch.float32) for a in (q, k, v))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        sq, sk = q.shape[-2], k.shape[-2]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(sk - sq)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.matmul(p, vf)
