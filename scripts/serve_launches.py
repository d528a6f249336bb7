#!/usr/bin/env python3
"""Device launches per iteration of one 64-row ``serve-gaussian-packed``
chunk under the freeze rule, on one card.

    python3 scripts/serve_launches.py

The chunk is the stream's first (``launch/serve.py``'s ``build_stream``,
seed 0) with its chunk key, solved by ``qniht_batch`` with the config's
``exit_tol`` three ways: on the packed Φ̂ of a ``BatchServer`` (applied in
blocks of ``ROW_LOCAL_ROWS`` rows), on the dense Φ of ``serve-gaussian``
(f32 y, applied one row at a time, as the freeze rule does for an operator
that does not compute its rows alone), and on the dense Φ with the lossless exit
(``exit_tol = 0``: one product for all 64 rows). Launches are torch.profiler's
device events (kernels, memsets, copies) of a solve of 2n iterations less
those of one of n, so that the set-up (ŷ drawn for every row) drops out.
Prints one JSON object with the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

N_ITERS = 4   # profiled iterations beyond the set-up


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("serve_launches: needs a GPU", file=sys.stderr)
        return 1
    from repro_torch import random as prng
    from repro_torch.configs import SERVE_CONFIGS
    from repro_torch.core.niht import qniht_batch
    from repro_torch.launch.serve import build_stream
    from repro_torch.parallel import BatchServer

    cfg, dense = SERVE_CONFIGS["serve-gaussian-packed"], SERVE_CONFIGS["serve-gaussian"]
    key = prng.PRNGKey(cfg.seed)
    phi, stream, _ = build_stream(cfg, key, "cuda")
    srv = BatchServer(phi, cfg.s, cfg.n_iters, key=key, exit_tol=cfg.exit_tol,
                      bits_phi=cfg.bits_phi, bits_y=cfg.bits_y, backend="packed")
    Y, chunk_key = stream[0], prng.fold_in(key, 1000)

    def per_iteration(op, bits_y, exit_tol):
        def launches(n_iters):
            def solve():
                return qniht_batch(op, Y, cfg.s, n_iters, key=chunk_key, bits_y=bits_y,
                                   early_exit=True, exit_tol=exit_tol, with_trace=False)

            solve()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                solve()
                torch.cuda.synchronize()
            return sum(e.count for e in prof.key_averages()
                       if getattr(e, "device_type", None) == DeviceType.CUDA)

        return (launches(2 * N_ITERS) - launches(N_ITERS)) / N_ITERS

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({
        "card": smi.stdout.strip(),
        "rows": int(Y.shape[0]),
        "device_launches_per_iteration": {
            "packed_row_blocks": per_iteration(srv.phi, cfg.bits_y, cfg.exit_tol),
            "dense_row_by_row": per_iteration(phi, dense.bits_y, dense.exit_tol),
            "dense_whole_batch": per_iteration(phi, dense.bits_y, 0.0),
        },
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
