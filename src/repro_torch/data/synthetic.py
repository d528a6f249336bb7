"""Deterministic synthetic LM data (port of ``repro.data.synthetic``).

Counter-based generation (``fold_in(key, step)``) makes every batch a pure
function of (seed, step), so a restarted run regenerates the same stream
and nothing but the step counter needs a checkpoint. The "language" is a
Zipf-like unigram with a bigram twist, so the loss can go down.

The tokens are the reference's bit for bit. Its Zipf draw
``floor((vocab ** u − 1) / (vocab − 1) · vocab)`` raises vocab to a float32
power; PyTorch's float32 ``pow`` differs from XLA's in the last bit of about
1.8% of the values and flips tokens, so the port takes the power in float64
and rounds it to float32 (XLA's float32 values to the last bit in all but
~0.06%, and no token of 2²⁰ draws apart at vocab 512 or 49,152). Every
batch is drawn on the host and then moved to the device asked for, so the
card and the CPU get the same tokens.
"""
from __future__ import annotations

from typing import Iterator

import torch

from repro_torch import random as prng
from repro_torch.device import resolve_device


def synthetic_batch(key: torch.Tensor, step: int, batch: int, seq: int, vocab: int,
                    device=None) -> dict:
    """One (tokens, labels) batch of int32 (batch, seq) tensors on ``device``
    (default ``cuda``): next-token labels, a Zipf-like unigram, and with
    probability 1/2 the next token a fixed function of the current one."""
    device = resolve_device(device)
    k1, k2 = prng.split(prng.fold_in(key, step))
    u = prng.uniform(k1, (batch, seq + 1))
    power = torch.pow(torch.tensor(float(vocab), dtype=torch.float64),
                      u.to(torch.float64)).to(torch.float32)
    zipf = torch.floor((power - 1.0) / (vocab - 1) * vocab).to(torch.int32)
    zipf = torch.clamp(zipf, 0, vocab - 1)
    follow = prng.bernoulli(k2, 0.5, (batch, seq + 1))
    rolled = (zipf * 31 + 7) % vocab
    toks = torch.where(follow, torch.roll(rolled, 1, dims=1), zipf)
    return {"tokens": toks[:, :-1].contiguous().to(device),
            "labels": toks[:, 1:].contiguous().to(device)}


class SyntheticStream:
    """Step-indexed batch source on one device (the reference's ``mesh``
    placement waits for the sharding slice)."""

    def __init__(self, seed: int, batch: int, seq: int, vocab: int, device=None):
        self.key = prng.PRNGKey(seed)
        self.batch, self.seq, self.vocab = batch, seq, vocab
        self.device = resolve_device(device)

    def at_step(self, step: int) -> dict:
        return synthetic_batch(self.key, step, self.batch, self.seq, self.vocab, self.device)

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.at_step(step)
            step += 1
