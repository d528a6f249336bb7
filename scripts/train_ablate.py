#!/usr/bin/env python3
"""starcoder2-3b trained at its published widths on one card with and
without the paper's two operators, at several peak learning rates and
depths: the losses of TRAIN_STEPS steps of B = 8 × 1,024 (the train phase
of chip_smoke.py: AdamW with the launcher's schedule, PRNGKey(0), the
synthetic stream of seed 0) under Q8 gradients and IHT at 50%, and under
neither. It backs the open question in PERF.md §7 on why the loss rises
over the first steps at full width.

    python3 scripts/train_ablate.py [--lr 3e-3,3e-4] [--layers 30,2]

Prints one line per run and, last, the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

TRAIN_STEPS = 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lr", default="3e-3", help="peak learning rates, comma-separated")
    ap.add_argument("--layers", default="30", help="depths, comma-separated")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("train_ablate: needs a GPU", file=sys.stderr)
        return 1
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticStream
    from repro_torch.optim import IHTConfig, adamw, cosine_schedule
    from repro_torch.quant.policy import QuantPolicy
    from repro_torch.train import init_state, make_train_step

    base = get_config("starcoder2_3b")
    stream = SyntheticStream(0, 8, 1024, base.vocab_size, device="cuda")
    for layers in (int(x) for x in args.layers.split(",")):
        cfg = dataclasses.replace(base, n_layers=layers)
        for lr in (float(x) for x in args.lr.split(",")):
            for label, bits, iht in (("Q8 + IHT 50%", 8, IHTConfig(sparsity=0.5)),
                                     ("neither", None, None)):
                opt = adamw(cosine_schedule(lr, warmup=20, total=TRAIN_STEPS))
                step = make_train_step(cfg, opt, policy=QuantPolicy(grad_bits=bits), iht=iht)
                state = init_state(cfg, opt, prng.PRNGKey(0), device="cuda")
                losses, norms = [], []
                for i in range(TRAIN_STEPS):
                    state, m = step(state, stream.at_step(i))
                    losses.append(round(float(m["loss"]), 4))
                    norms.append(round(float(m["grad_norm"]), 3))
                print(f"{layers} layers, lr {lr:g}, {label}: losses {losses}, grad norms {norms}",
                      flush=True)
                del state, step, opt
                torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
