"""Training launcher (port of ``repro.launch.train``):

    python -m repro_torch.launch.train --arch starcoder2_3b --steps 3 --batch 8 \\
        --seq 1024 --grad-bits 8 --iht-sparsity 0.5
    python -m repro_torch.launch.train --arch recurrentgemma-2b --steps 3 --batch 1 \\
        --seq 4096 --grad-bits 8 --iht-sparsity 0.5

The dense, MoE, hybrid (recurrentgemma-2b) and SSM (mamba2-370m) families
take it. The cross-attention families (whisper-tiny, llama-3.2-vision-11b)
train through ``make_train_step`` on batches that carry a ``memory``; their
stream here has none (the reference's launcher passes ``memory=None``), so
for them it exits 2 with a message that names the missing memory.

The reference's flags, plus ``--device`` (default ``cuda``; ``cpu`` runs the
plain versions of the kernels). ``--smoke`` takes the reduced config. The
state starts from PRNGKey(0) and the data stream from seed 0, as the
reference's; ``--ckpt-dir`` checkpoints every ``--ckpt-every`` steps and a
rerun resumes from the newest complete checkpoint there. One device only:
a ``--mesh`` other than ``1x1`` exits 2 (ROADMAP.md queue 1's sharding item,
"Sharding over several devices").
"""
from __future__ import annotations

import argparse

from repro_torch import random as prng
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticStream
from repro_torch.device import resolve_device
from repro_torch.optim import IHTConfig, adamw, cosine_schedule
from repro_torch.quant.policy import QuantPolicy
from repro_torch.train import LoopConfig, init_state, make_train_step, train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-bits", type=int, default=0,
                    help="quantized gradient compression (paper's Q on comms)")
    ap.add_argument("--iht-sparsity", type=float, default=0.0,
                    help="H_s weight projection (paper's operator as trainer)")
    ap.add_argument("--mesh", default="1x1", help="data x model; only 1x1 is ported")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    if args.mesh != "1x1":
        ap.exit(2, f"train: --mesh {args.mesh} is not ported: training runs on one device; "
                   "sharding training over several devices is the training half of "
                   "ROADMAP.md queue 1's sharding item, \"Sharding over several devices\"\n")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family in ("encdec", "vlm"):
        what = ("stub audio frames (B, encoder_seq, d_model), encoded in loss_fn"
                if cfg.family == "encdec" else "image embeddings (B, n_image_tokens, d_model)")
        ap.exit(2, f"train: the {cfg.family} family ({cfg.name}) reads a memory in its 'xattn' "
                   f"layers: {what}. The synthetic stream carries tokens only, as the "
                   "reference's launcher passes memory=None; train it through "
                   "make_train_step on batches with a 'memory'\n")
    device = resolve_device(args.device)
    policy = QuantPolicy(grad_bits=args.grad_bits or None)
    iht = IHTConfig(sparsity=args.iht_sparsity) if args.iht_sparsity > 0 else None
    opt = adamw(cosine_schedule(args.lr, warmup=20, total=args.steps))
    step = make_train_step(cfg, opt, policy=policy, iht=iht)
    state = init_state(cfg, opt, prng.PRNGKey(0), device=device)
    stream = SyntheticStream(0, args.batch, args.seq, cfg.vocab_size, device=device)
    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every)
    final = train_loop(step, state, stream, loop_cfg)
    print(f"[train] done at step {int(final.step)}")


if __name__ == "__main__":
    main()
