#!/usr/bin/env python3
"""The loss trajectory of training at full width on the CPU, from the JAX
reference or from the port, to hold the port's rise or fall of the loss at
full width against the reference's.

starcoder2-3b at its published widths (d = 3,072, d_ff 12,288, vocab
49,152), cut to --layers layers, in --dtype, trained --steps steps of
--batch × --seq tokens of the synthetic stream of seed 0 from PRNGKey(0)
with the launcher's schedule (AdamW, peak lr --lr, cosine with a 20-step
warm-up over --steps), with Q8 gradients and IHT at 50% (--ops both) or
neither (--ops none). --impl reference runs the JAX package, --impl port
runs repro_torch; each imports only its own package and prints one line:
its losses and gradient norms.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/train_witness.py --impl reference
    PYTHONPATH=src python scripts/train_witness.py --impl port

At the defaults (2 layers, B = 2, S = 256, float32) a run holds about
10 GB of host memory.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def run_reference(args, cfg_of):
    import jax

    from repro.configs import get_config
    from repro.data import SyntheticStream
    from repro.optim import IHTConfig, adamw, cosine_schedule
    from repro.quant.policy import QuantPolicy
    from repro.train import init_state, make_train_step

    cfg = cfg_of(get_config(args.arch))
    ops = args.ops == "both"
    opt = adamw(cosine_schedule(args.lr, warmup=20, total=args.steps))
    step = jax.jit(make_train_step(cfg, opt, policy=QuantPolicy(grad_bits=8 if ops else None),
                                   iht=IHTConfig(sparsity=0.5) if ops else None),
                   donate_argnums=0)
    state = init_state(cfg, opt, jax.random.PRNGKey(0))
    stream = SyntheticStream(0, args.batch, args.seq, cfg.vocab_size)
    for i in range(args.steps):
        batch = dict(stream.at_step(i))
        batch["memory"] = None
        state, m = step(state, batch)
        yield float(m["loss"]), float(m["grad_norm"])


def run_port(args, cfg_of):
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticStream
    from repro_torch.optim import IHTConfig, adamw, cosine_schedule
    from repro_torch.quant.policy import QuantPolicy
    from repro_torch.train import init_state, make_train_step

    cfg = cfg_of(get_config(args.arch))
    ops = args.ops == "both"
    opt = adamw(cosine_schedule(args.lr, warmup=20, total=args.steps))
    step = make_train_step(cfg, opt, policy=QuantPolicy(grad_bits=8 if ops else None),
                           iht=IHTConfig(sparsity=0.5) if ops else None)
    state = init_state(cfg, opt, prng.PRNGKey(0), device="cpu")
    stream = SyntheticStream(0, args.batch, args.seq, cfg.vocab_size, device="cpu")
    for i in range(args.steps):
        state, m = step(state, stream.at_step(i))
        yield float(m["loss"]), float(m["grad_norm"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--impl", choices=("reference", "port"), required=True)
    ap.add_argument("--arch", default="starcoder2_3b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ops", choices=("both", "none"), default="both")
    args = ap.parse_args(argv)

    def cfg_of(cfg):
        return dataclasses.replace(cfg, n_layers=args.layers, dtype=args.dtype)

    run = run_reference if args.impl == "reference" else run_port
    t0 = time.perf_counter()
    losses, norms = [], []
    for loss, norm in run(args, cfg_of):
        losses.append(loss)
        norms.append(norm)
    print(json.dumps({"impl": args.impl, "arch": args.arch, "layers": args.layers,
                      "dtype": args.dtype, "batch": args.batch, "seq": args.seq,
                      "lr": args.lr, "ops": args.ops, "losses": losses, "grad_norms": norms,
                      "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
