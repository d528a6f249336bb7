#!/usr/bin/env python3
"""How far bf16 arithmetic and the int8 KV cache put an LM's logits from a
float32 truth at full width, on one card.

    python3 scripts/lm_noise_floor.py [--arch recurrentgemma-2b | mamba2-370m |
                                       whisper-tiny | llama-3.2-vision-11b |
                                       qwen3-moe-30b-a3b]

The model and traffic of ``chip_smoke.py``'s ``lm`` phase (starcoder2-3b by
default, all layers, weights from PRNGKey(0), 8 prompts of 1,024 tokens from
PRNGKey(1), 32 greedy decode steps; ``--arch recurrentgemma-2b``: the
``hybrid`` phase's run A; ``--arch mamba2-370m``: the ``ssm`` phase's;
``--arch whisper-tiny``: the ``encdec`` phase's, prompts of 224 tokens over
the encoder's memory of 1,500 stub frames; ``--arch llama-3.2-vision-11b``:
the ``vlm`` phase's, over 1,600 stub image rows; ``--arch
qwen3-moe-30b-a3b``: the ``moe`` phase's, its W4 tree built leaf by leaf),
under W4KV8 (W4 for an attention-free stack, which has no KV cache) and at
full precision (not for qwen3-moe-30b-a3b, whose float32 tree does not fit
the card). The
truth is ``forward`` of the float32 model on the same weights and tokens
(exact K/V); for whisper-tiny, whose ``forward`` leaves out the RoPE that
its prefill and decode apply (as the reference's), it is the float32
serving path with exact K/V, and ``forward_f32_vs_truth`` is that gap; so
it is for qwen3-moe-30b-a3b, whose ``forward`` over prompt + generated
tokens routes other groups than serving does: its ``forward`` runs over the
prompt alone and is held against the prefill's logits
(``prefill_*``).
Each serving variant runs a prefill and the decode steps over the kernel
run's tokens: the kernel routes (``generate``), the plain routes in bf16
with and without the int8 cache, the float32 model with and without it (one
of each without a KV cache), and the bf16 ``forward``. For each pair it
prints max |Δ| over max |reference|, the measure of ``chip_smoke.py``'s
gates, and one JSON object with the card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="starcoder2-3b", help="an LM config of repro_torch.configs")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("lm_noise_floor: needs a GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs

    mods = cs.load_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    prng, m, layers = mods["prng"], mods["lm_model"], mods["lm_layers"]
    policy_of = mods["QuantPolicy"]
    cfg = mods["lm_get_config"](args.arch)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    experts = bool(cfg.n_experts)
    if experts:
        params = None
        qparams = m.init_quantized_params(cfg, prng.PRNGKey(0), 4, device=dev)
    else:
        params = m.init_params(cfg, prng.PRNGKey(0), device=dev)
        qparams = mods["quantize_params"](params, 4)
    s = cs.lm_prompt_len(cfg)
    prompt = prng.randint(prng.PRNGKey(1), (cs.LM_BATCH, s), 0, cfg.vocab_size, device=dev)
    source = cs.lm_stub_source(torch, mods, cfg, cs.LM_BATCH)
    plain = cs.lm_plain_routes(mods, cfg)
    encdec = cfg.family == "encdec"
    out = {}
    w4_label, w4_policy = cs.lm_quantized(mods, cfg)
    variants = [(w4_label, qparams, w4_policy)] + ([] if experts else
                                                   [("full", params, policy_of())])
    for label, tree, policy in variants:
        no_kv = dataclasses.replace(policy, kv_bits=None)
        kv8 = policy.kv_bits is not None

        def memory(c, p=policy, t=tree):
            return cs.lm_memory(mods, c, t, p, source)
        toks, kernel = mods["generate"](cfg, tree, prompt, cs.LM_DECODE_STEPS + 1, policy,
                                        memory=memory(cfg))
        seq = prompt if experts else torch.cat([prompt, toks[:, :-1].to(prompt.dtype)], dim=1)
        runs = {"kernel": kernel}
        forward_f32 = m.forward(cfg32, tree, seq, memory=memory(cfg32))[0][:, s - 1:].float()
        runs["forward_bf16"] = m.forward(cfg, tree, seq, memory=memory(cfg))[0][:, s - 1:]
        with cs.stand_in(layers, **plain), \
                cs.stand_in(mods["lm_moe"], qmm_batched=mods["qmm_batched_ref"]):
            runs["plain"] = cs.lm_teacher_forced(torch, mods, cfg, tree, prompt, toks, policy,
                                                 source)
            if kv8:
                runs["plain_no_kv8"] = cs.lm_teacher_forced(torch, mods, cfg, tree, prompt, toks,
                                                            no_kv, source)
        f32 = "f32_kv8" if kv8 else "f32"
        runs[f32] = cs.lm_teacher_forced(torch, mods, cfg32, tree, prompt, toks, policy, source)
        if kv8:
            runs["f32_no_kv8"] = cs.lm_teacher_forced(torch, mods, cfg32, tree, prompt, toks,
                                                      no_kv, source)
        if encdec or experts:
            runs["truth"] = runs["f32_no_kv8" if kv8 else f32].float()
            runs["forward_f32"] = forward_f32
        else:
            runs["truth"] = forward_f32
        pairs = [(name, "truth") for name in runs if name != "truth"] + [
            ("kernel", "plain"), ("kernel", "forward_bf16"), ("plain", "forward_bf16")]
        if experts:
            # forward ran over the prompt: it is held at the prefill's position alone
            for name in ("kernel", "plain", "truth"):
                runs[f"{name}_prefill"] = runs[name][:, :1]
            pairs = [(name, "truth") for name in ("kernel", "plain", "plain_no_kv8", "f32_kv8")]
            pairs += [("kernel", "plain"), ("kernel_prefill", "forward_bf16"),
                      ("plain_prefill", "forward_bf16"), ("forward_bf16", "truth_prefill"),
                      ("forward_f32", "truth_prefill")]
        out[label] = {f"{a}_vs_{b}": cs.lm_rel(runs[a], runs[b]) for a, b in pairs}
        for key, value in out[label].items():
            print(f"{label:6s} {key:28s} {value:.4g}", flush=True)
        del runs
        torch.cuda.empty_cache()
    print(json.dumps({"card": cs.nvidia_smi_line(), "config": cfg.name, "batch": cs.LM_BATCH,
                      "prompt": s, "decode_steps": cs.LM_DECODE_STEPS, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
