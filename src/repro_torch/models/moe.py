"""Mixture-of-Experts FFN (port of ``repro.models.moe``): top-k routing with a
per-group capacity.

Tokens are taken in groups of ``group_size``; each group routes every token
to its top-k experts, and expert e keeps the first C = ⌊g·k/E·cf⌋ picks in
(token, pick) order, dropping the rest. The reference builds this as
one-hot dispatch and combine tensors, (g, k, E, C) before the sum over k
(1.34e9 entries at g = 4,096, k = 8, E = 128, C = 320); the port computes the
same function with indices: each pick's slot from a stable sort of the
picks by expert, the experts' inputs gathered by the token that holds each
slot, and each token's output gathered back from its picks' slots. Every
detail of the reference's arithmetic is kept: the float32 router, the top-k
of a stable descending order (ties to the lower expert), the gate weights
renormalized over the k picks (kept or not) and rounded to the activations'
dtype, the SwiGLU expert products in that dtype, and the load loss over all
picks.

Expert products (:func:`expert_product`), each a fixed route on the card: a
stack of W4 codes with at most ``QMM_MAX_ROWS`` slots per expert takes
``qmm_batched``, one launch for all experts (``QMM_EXPERTS`` on bf16
activations, ``QMM_BATCHED`` on float32); more slots, or float weights, take
materialize + ``torch.bmm`` (the reference's computation), counted in
``EXPERT_BMM``. On the CPU, the plain versions. Slots fill from 0 upward, so
expert e's slots in use are a prefix of ``rows[e]`` = min(its picks, cap)
(:func:`slots`, on the group's device); the kernel route is handed it and
skips the empty slots' work without the host reading it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import random as prng
from repro_torch.kernels.qmm.ops import qmm_batched
from repro_torch.models.layers import QMM_MAX_ROWS, RouteCounter, dense_init
from repro_torch.models.quantized import QWeight, materialize

# materialize + torch.bmm of the expert products on the card, counted per call
EXPERT_BMM = RouteCounter("expert_bmm")


def moe_init(key, d: int, ff: int, n_experts: int, device=None):
    """The router (d, E) and the experts' SwiGLU kernels, (E, d, ff) twice and
    (E, ff, d), float32, drawn as the reference draws them."""
    ks = prng.split(key, 4)
    scale = 0.02
    return {
        "router": dense_init(ks[0], d, n_experts, device=device),
        "wi_gate": prng.normal(ks[1], (n_experts, d, ff), device=device) * scale,
        "wi_up": prng.normal(ks[2], (n_experts, d, ff), device=device) * scale,
        "wo": prng.normal(ks[3], (n_experts, ff, d), device=device) * scale,
    }


def n_experts_of(p) -> int:
    rw = p["router"]["w"]
    return rw.packed.shape[-2] if isinstance(rw, QWeight) else rw.shape[1]


def expert_product(x: torch.Tensor, w, dtype: torch.dtype,
                   rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E, C, in) times each expert's kernel of ``w`` (E, in, out), a
    tensor or a QWeight stack → (E, C, out) in ``dtype``. On the card a
    QWeight stack with C ≤ QMM_MAX_ROWS launches ``qmm_batched`` once, at
    ``rows`` (E,) slots in use an expert (x's rows past them are zero, as
    :func:`dispatch` leaves them, so the product is the same); anything else
    is materialize + ``torch.bmm``, counted in EXPERT_BMM."""
    if x.is_cuda and isinstance(w, QWeight) and x.shape[1] <= QMM_MAX_ROWS:
        return qmm_batched(x, w.packed, w.scale, w.bits, w.k_dim, rows).to(dtype)
    if x.is_cuda:
        EXPERT_BMM.launches += 1
    return torch.bmm(x.to(dtype), materialize(w, dtype))


def route(xg: torch.Tensor, router_w, top_k: int):
    """The router of one group xg (g, d): float32 probabilities (g, E), and
    the top-k picks of a stable descending order (ties to the lower expert)
    with their gate weights renormalized over the k picks, (g, k) each."""
    logits = xg.to(torch.float32) @ materialize(router_w, torch.float32)
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = order.values[:, :top_k], order.indices[:, :top_k]
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    return probs, gate_vals, gate_idx


def slots(gate_idx: torch.Tensor, n_experts: int, cap: int):
    """Each pick's slot: its place among the picks of its expert in the
    flattened (token, pick) order (the reference's cumsum, ``moe.py:48``),
    kept where it is below ``cap``. Returns (slot, kept, rows): slot and
    kept (g·k,), slot e·cap + place for a kept pick, else E·cap (a row that
    is never read); rows (E,) int32, each expert's kept picks, min(count,
    cap): its slots in use, a prefix."""
    flat = gate_idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices          # by expert, (token, pick) order kept
    counts = torch.zeros(n_experts, dtype=torch.int64, device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, 0) - counts
    place = torch.empty_like(flat)
    place[order] = torch.arange(flat.numel(), device=flat.device) - starts[flat[order]]
    kept = place < cap
    slot = torch.where(kept, flat * cap + place, torch.full_like(flat, n_experts * cap))
    return slot, kept, counts.clamp(max=cap).to(torch.int32)


def dispatch(xg: torch.Tensor, router_w, *, top_k: int, n_experts: int, cap: int, dtype):
    """Route one group xg (g, d) and gather the experts' inputs: xe (E, cap,
    d) in ``dtype``, expert e's slot c holding the token whose kept pick took
    it, zeros where no pick did (the reference's xe, einsum("td,tec->ecd")
    over its 0/1 dispatch tensor). Returns (xe, route): route is (probs,
    gate_vals, gate_idx, slot, kept, rows) for :func:`combine`, the load
    loss and the expert products (rows: :func:`slots`)."""
    g, d = xg.shape
    probs, gate_vals, gate_idx = route(xg, router_w, top_k)
    slot, kept, rows_in_use = slots(gate_idx, n_experts, cap)
    token = torch.arange(g, device=xg.device).repeat_interleave(top_k)
    holder = torch.full((n_experts * cap + 1,), g, dtype=torch.int64, device=xg.device)
    holder[slot] = token                       # slot E·cap takes every dropped pick
    rows = torch.cat([xg.to(dtype), torch.zeros((1, d), dtype=dtype, device=xg.device)])
    xe = rows[holder[:n_experts * cap]].reshape(n_experts, cap, d)
    return xe, (probs, gate_vals, gate_idx, slot, kept, rows_in_use)


def combine(ye: torch.Tensor, slot: torch.Tensor, kept: torch.Tensor,
            gate_vals: torch.Tensor) -> torch.Tensor:
    """Each token's kept picks of the experts' outputs ye (E, cap, d),
    weighted by its gate rounded to ye's dtype (the reference's combine
    tensor is built in that dtype) and summed in float32: (g, d) in ye's
    dtype."""
    e, cap, d = ye.shape
    g, top_k = gate_vals.shape
    out = torch.cat([ye.reshape(e * cap, d), torch.zeros((1, d), dtype=ye.dtype,
                                                          device=ye.device)])
    picked = out[slot].reshape(g, top_k, d)
    weight = (gate_vals.to(ye.dtype) * kept.reshape(g, top_k).to(ye.dtype)).to(torch.float32)
    return (picked.to(torch.float32) * weight[..., None]).sum(1).to(ye.dtype)


def _group_moe(p, xg: torch.Tensor, *, top_k: int, cap: int, dtype):
    """One token group. xg: (g, d) → (y (g, d), the group's load loss)."""
    g = xg.shape[0]
    e = n_experts_of(p)
    xe, (probs, gate_vals, gate_idx, slot, kept, rows) = dispatch(
        xg, p["router"]["w"], top_k=top_k, n_experts=e, cap=cap, dtype=dtype)
    # h's rows past `rows` are silu(0)·0 = 0, as xe's are
    h = (F.silu(expert_product(xe, p["wi_gate"], dtype, rows))
         * expert_product(xe, p["wi_up"], dtype, rows))
    y = combine(expert_product(h, p["wo"], dtype, rows), slot, kept, gate_vals)
    me = probs.mean(0)
    ce = torch.zeros(e, dtype=torch.float32, device=xg.device).scatter_add_(
        0, gate_idx.reshape(-1), torch.ones(g * top_k, dtype=torch.float32,
                                            device=xg.device)) / g
    return y, e * torch.sum(me * ce)


def moe_apply(p, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
              group_size: int = 4096, remat: bool = True):
    """x: (B, S, d) → (B, S, d), aux dict. B·S is padded with zero rows to a
    whole number of groups (the pad rows are routed and counted in the load
    loss, as in the reference); with several groups the load loss is their
    mean. Where autograd records and ``remat``, each group is checkpointed,
    as the reference's ``jax.checkpoint`` on its scan step."""
    b, s, d = x.shape
    n_tok = b * s
    e = n_experts_of(p)
    g = min(group_size, n_tok)
    n_groups = -(-n_tok // g)
    pad = n_groups * g - n_tok
    xf = x.reshape(n_tok, d)
    if pad:
        xf = torch.cat([xf, torch.zeros((pad, d), dtype=x.dtype, device=x.device)])
    cap = max(1, int(g * top_k / e * capacity_factor))

    def group(xg):
        return _group_moe(p, xg, top_k=top_k, cap=cap, dtype=x.dtype)

    ys, loads = [], []
    for xg in xf.reshape(n_groups, g, d):
        if remat and n_groups > 1 and torch.is_grad_enabled():
            y, load = torch.utils.checkpoint.checkpoint(group, xg, use_reentrant=False,
                                                        preserve_rng_state=False)
        else:
            y, load = group(xg)
        ys.append(y)
        loads.append(load)
    out = torch.cat(ys)[:n_tok].reshape(b, s, d)
    load = loads[0] if n_groups == 1 else torch.stack(loads).mean()
    return out, {"moe_load_loss": load}
