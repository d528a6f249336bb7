"""AdamW (port of ``repro.optim.adamw``), leaf by leaf and in place.

The arithmetic is the reference's, in float32 and in its order: the
global-norm clip over every gradient leaf, then per leaf

    g  = g · clip
    m  = b1·m + (1 − b1)·g
    v  = b2·v + (1 − b2)·g·g
    p  = p − lr · ( (m / (1 − b1^t)) / (√(v / (1 − b2^t)) + eps) + wd·p )

with t the post-increment step. Where the reference builds new trees, the
port writes m, v and p in place, over flat chunks of ``CHUNK`` elements, so
that a step needs no full-size temporary: at starcoder2-3b's width m and v
are 13.48 GB each. Divisors are device tensors (PyTorch's CUDA division by a
host scalar multiplies by its reciprocal, another rounding). The step count
lives on the host, as a 0-d int32 tensor.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch.tree import tree_leaves, tree_map

CHUNK = 1 << 26       # elements of one leaf updated per pass (256 MB of float32)


class AdamWState(NamedTuple):
    step: torch.Tensor    # 0-d int32, on the host
    mu: Any
    nu: Any


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def _chunks(t: torch.Tensor):
    flat = t.view(-1)
    for s in range(0, flat.numel(), CHUNK):
        yield flat[s:s + CHUNK]


def _global_norm(leaves) -> torch.Tensor:
    """√(Σ over leaves of Σ g²) in float32, chunk by chunk (no squared copy)."""
    total = None
    for g in leaves:
        for c in _chunks(g):
            cf = c.to(torch.float32)
            part = torch.dot(cf, cf)
            total = part if total is None else total + part
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


def adamw(lr: Union[float, Callable], b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, grad_clip: float = 1.0) -> Optimizer:
    """The reference's AdamW. ``update(grads, state, params)`` writes the new
    m, v and params into their tensors and returns ``(params, state,
    {"grad_norm", "lr"})``, the first two holding those same tensors."""

    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)

        return AdamWState(step=torch.zeros((), dtype=torch.int32),
                          mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    def update(grads, state: AdamWState, params):
        step = state.step + 1
        lr_t = lr(step) if callable(lr) else torch.tensor(lr, dtype=torch.float32)
        flat_g = tree_leaves(grads)
        flat_m, flat_v, flat_p = tree_leaves(state.mu), tree_leaves(state.nu), tree_leaves(params)
        if not flat_g:
            return params, AdamWState(step, state.mu, state.nu), {
                "grad_norm": torch.zeros((), dtype=torch.float32), "lr": lr_t}
        dev = flat_g[0].device

        def on_dev(x) -> torch.Tensor:
            return torch.as_tensor(x, dtype=torch.float32).to(dev)

        with torch.no_grad():
            gnorm = _global_norm(flat_g)
            clip = torch.minimum(on_dev(1.0), on_dev(grad_clip) / torch.clamp_min(gnorm, 1e-9))
            t = step.to(torch.float32)
            bc1 = on_dev(1 - torch.pow(torch.tensor(b1, dtype=torch.float32), t))
            bc2 = on_dev(1 - torch.pow(torch.tensor(b2, dtype=torch.float32), t))
            lr_d = on_dev(lr_t)
            for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p):
                for gc, mc, vc, pc in zip(_chunks(g), _chunks(m), _chunks(v), _chunks(p)):
                    gf = gc.to(torch.float32) * clip
                    mc.mul_(b1).add_(gf * (1 - b1))
                    vc.mul_(b2).add_(gf * (1 - b2) * gf)
                    pf = pc.to(torch.float32)
                    delta = (mc / bc1) / (torch.sqrt(vc / bc2) + eps) + weight_decay * pf
                    pc.copy_(pf - lr_d * delta)
        return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init=init, update=update)


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine to
    ``floor``·peak at ``total``; float32, as the reference's."""
    f32 = torch.float32

    def lr(step):
        s = torch.as_tensor(step).to(f32)
        warm = peak_lr * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        pi_t = torch.tensor(math.pi, dtype=f32) * t
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(pi_t)))
        return torch.where(s < warmup, warm, cos)

    return lr
