"""Greedy generation: the function of ``examples/serve_quantized.py``, shared
by ``examples/serve_quantized_torch.py`` and ``chip_smoke.py``."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models.model import decode_step, init_cache, prefill
from repro_torch.quant.policy import QuantPolicy

CACHE_SLACK = 8          # cache tokens beyond prompt + generated, as the reference's example


def generate(cfg, params, prompt: torch.Tensor, n_new: int,
             policy: QuantPolicy = QuantPolicy(), *,
             on_step: Optional[Callable[[int, torch.Tensor], None]] = None,
             memory: Optional[torch.Tensor] = None):
    """Greedy tokens after ``prompt`` (B, S): a prefill, then ``n_new - 1``
    decode steps, each taking the argmax of the last logits, in a cache of
    S + n_new + ``CACHE_SLACK`` tokens on the prompt's device (and, with a
    ``memory`` (B, T, d), the encdec and vlm families' cross-attention K/V
    of T rows). Returns the tokens (B, n_new) and the logits each was taken
    from (B, n_new, V). ``on_step(i, logits)``, if given, is called after
    the prefill (i = 0) and after each decode step (i = 1 ...)."""
    b, s = prompt.shape
    mem_len = 0 if memory is None else memory.shape[1]
    cache = init_cache(cfg, b, s + n_new + CACHE_SLACK, policy, mem_len=mem_len,
                       device=prompt.device)
    logits, cache = prefill(cfg, params, prompt, cache, policy=policy, memory=memory)
    steps = [logits]
    if on_step is not None:
        on_step(0, logits)
    toks = [torch.argmax(logits, dim=-1)]
    for i in range(n_new - 1):
        logits, cache = decode_step(cfg, params, toks[-1], cache, policy=policy,
                                    position=s + i)
        steps.append(logits)
        if on_step is not None:
            on_step(i + 1, logits)
        toks.append(torch.argmax(logits, dim=-1))
    return torch.stack(toks, dim=1), torch.stack(steps, dim=1)
