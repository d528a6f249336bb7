"""The training step (port of ``repro.train.steps``' ``make_train_step`` and
``init_state``) on one device: loss → gradients → optional Q_b gradient
compression → AdamW → optional IHT projection, the reference's order.

The step works in place: the gradients are the parameters' ``.grad``
tensors, AdamW writes m, v and the parameters into their tensors, and the
projection writes the kept support into the parameters. The gradients are
freed after the update, before the projection, so that the projection's
temporaries have their room. A caller that wants the state before a step
keeps a copy of it.

The sharded builders, the decode and prefill builders and the input specs
wait for the sharding slice (ROADMAP.md queue 1's sharding item).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import random as prng
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import Optimizer
from repro_torch.optim.iht import IHTConfig, maybe_project
from repro_torch.parallel.collectives import fake_grad_compression
from repro_torch.quant.policy import QuantPolicy
from repro_torch.train.state import TrainState
from repro_torch.tree import tree_leaves, tree_map


def _microbatches(batch: dict, n: int) -> list:
    """``batch`` split along its leading axis into n equal microbatches."""
    def part(v, i):
        if v is None or v.ndim == 0:
            return v
        b = v.shape[0] // n
        return v[i * b:(i + 1) * b]

    return [{k: part(v, i) for k, v in batch.items()} for i in range(n)]


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    policy: QuantPolicy = QuantPolicy(),
                    iht: Optional[IHTConfig] = None,
                    accum_steps: int = 1):
    """``step(state, batch) -> (state, metrics)``. The key of the gradient
    compression is ``fold_in(state.rng, state.step)``; the projection runs
    on the optimizer's post-increment step. ``accum_steps > 1`` sums the
    gradients of that many microbatches (each one's activations alone are
    alive) and divides by it, as the reference's scan does."""

    def step(state: TrainState, batch: dict):
        rng = prng.fold_in(state.rng, int(state.step))
        params = state.params
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
            p.requires_grad_(True)
        try:
            if accum_steps > 1:
                loss = None
                for mb in _microbatches(batch, accum_steps):
                    part = M.loss_fn(cfg, params, mb, policy=policy)
                    part.backward()
                    loss = part.detach() if loss is None else loss + part.detach()
                loss = loss / torch.tensor(float(accum_steps), device=loss.device)
            else:
                loss = M.loss_fn(cfg, params, batch, policy=policy)
                loss.backward()
                loss = loss.detach()
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
                         params)
        for p in leaves:
            p.grad = None
        with torch.no_grad():
            if accum_steps > 1:
                for g in tree_leaves(grads):
                    g.div_(torch.tensor(float(accum_steps), dtype=g.dtype, device=g.device))
            if policy.grad_bits:
                fake_grad_compression(grads, policy.grad_bits, rng)
            new_params, new_opt, om = optimizer.update(grads, state.opt, params)
            del grads
            if iht is not None:
                new_params = maybe_project(new_params, int(new_opt.step), iht)
        metrics = {"loss": loss, **om}
        return TrainState(step=state.step + 1, params=new_params, opt=new_opt,
                          rng=state.rng), metrics

    return step


def init_state(cfg: ModelConfig, optimizer: Optimizer, key: torch.Tensor,
               device=None) -> TrainState:
    """Parameters from ``key`` on ``device`` (default ``cuda``), the
    optimizer's zero moments, step 0."""
    params = M.init_params(cfg, key, device=device)
    return TrainState(step=torch.zeros((), dtype=torch.int32), params=params,
                      opt=optimizer.init(params), rng=key)
