"""Serve a model with weight-only quantization on the PyTorch port — the
paper's low-precision data representation applied to the decode loop (IHT's
LM twin: a bandwidth-bound iteration re-streaming a fixed large operand).

    PYTHONPATH=src python examples/serve_quantized_torch.py [--bits 4] [--device cpu]
    PYTHONPATH=src python examples/serve_quantized_torch.py --arch recurrentgemma_2b --device cpu
    PYTHONPATH=src python examples/serve_quantized_torch.py --arch mamba2_370m --device cpu
    PYTHONPATH=src python examples/serve_quantized_torch.py --arch qwen3_moe_30b --device cpu --bits 4

The port's twin of ``examples/serve_quantized.py``: the same SMOKE config,
the same parameters and prompt (the reference's threefry draws from
PRNGKey(0)), greedy tokens at full precision and under W<bits> + KV8. The
dense archs, the hybrid recurrentgemma_2b (RG-LRU blocks and local
attention) and the attention-free mamba2_370m (SSD blocks; no KV cache for
KV8 to act on) and the mixture-of-experts qwen3_moe_30b (top-k routing
with a capacity; its W<bits> tree is built leaf by leaf with
``init_quantized_params``, the way a full-width model whose float32 tree
does not fit the card is served) run. whisper_tiny and llama32_vision_11b are refused: their
layers read a memory (encoded audio frames, image embeddings) that the
reference's example does not make (``generate(..., memory=...)`` serves
them; ``tests/test_torch_xattn.py`` and ``chip_smoke.py``'s encdec and vlm
phases do). On the GPU (the default device) the decode products go
through the ``qmm`` kernel (a MoE layer's expert stacks through
``qmm_batched``, one launch each) and the prefill's attention through
``flash_attention`` (with the hybrid's window).
"""
import argparse
import time

import torch

from repro_torch import random as prng
from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import (
    generate,
    init_params,
    init_quantized_params,
    param_bytes,
    quantize_params,
)
from repro_torch.quant.policy import QuantPolicy


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1_5_32b")
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    if cfg.family in ("encdec", "vlm"):
        ap.error(f"{args.arch} ({cfg.family}) reads a memory in its cross-attention layers "
                 f"(encoded audio frames or image embeddings), and the reference's "
                 f"examples/serve_quantized.py makes none; serve it with "
                 f"generate(..., memory=...)")
    device = resolve_device(args.device)
    key = prng.PRNGKey(0)
    params = init_params(cfg, key, device=device)
    prompt = prng.randint(key, (2, 16), 0, cfg.vocab_size, device=device)

    out_full, _ = generate(cfg, params, prompt, args.new_tokens, QuantPolicy())

    if cfg.n_experts:
        qparams = init_quantized_params(cfg, key, args.bits, device=device)
    else:
        qparams = quantize_params(params, args.bits)
    qpol = QuantPolicy(weight_bits=args.bits, kv_bits=8)
    t0 = time.perf_counter()
    out_q, _ = generate(cfg, qparams, prompt, args.new_tokens, qpol)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0

    agree = float((out_full == out_q).float().mean())
    # NB: this demo model is random-init (near-uniform logits): greedy-token
    # agreement is a harsh metric here.
    b_full, b_q = param_bytes(params), param_bytes(qparams)
    print(f"model: {cfg.name} | W{args.bits} + KV8 serving on {device}")
    print(f"weight bytes: {b_full:,} -> {b_q:,} ({b_full / b_q:.1f}x fewer streamed)")
    print(f"greedy tokens agree with full precision: {agree:.0%} "
          f"({args.new_tokens} tokens, {dt:.1f}s on {device.type})")
    print("full :", out_full[0][:12].tolist())
    print(f"w{args.bits}   :", out_q[0][:12].tolist())


if __name__ == "__main__":
    main()
