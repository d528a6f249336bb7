#!/usr/bin/env python3
"""``chip_smoke.py``'s knife-edge witness for every request of
``serve-continuous-packed``, on one card.

    python3 scripts/serve_knife_edges.py

Each of the 64 requests is re-stepped on the card beside the exact float64
step and the port's CPU step from the card's state
(``chip_smoke.knife_edge_witness``). Prints, for each request whose CPU step
ever keeps another support, where and why, then one JSON object: the
requests by the iteration at which they part (none: never), the largest
share of its error bound that any card proposal used, and the card's name
and power limit. The serve phase of ``chip_smoke.py`` runs the witness only
for the requests that split from the JAX reference.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("serve_knife_edges: needs a GPU", file=sys.stderr)
        return 1
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    mods = chip_smoke.load_port()
    serve, prng = mods["serve"], mods["prng"]
    cfg = mods["SERVE_CONFIGS"][chip_smoke.SERVE_CONTINUOUS]
    key = prng.PRNGKey(cfg.seed)
    phi, arrivals, _, _ = serve.build_requests(cfg, key, "cuda")
    sch = mods["parallel"].ContinuousScheduler(
        phi, cfg.s, cfg.n_iters, slots=cfg.slots, seg_len=cfg.seg_len, key=key,
        exit_tol=cfg.exit_tol, **serve._solver_kwargs(cfg))
    parted, worst = {}, 0.0
    for _, req in arrivals:
        w = chip_smoke.knife_edge_witness(torch, mods, sch, req.y, req.n_iters or sch.n_iters)
        worst = max(worst, w["card_bound_ratio"])
        if "exact_gap" in w or w["card_bound_ratio"] > 1.0:
            parted[req.rid] = w
            print(f"request {req.rid}: {w}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({
        "card": smi.stdout.strip(), "requests": len(arrivals),
        "parted_at_iteration": {rid: w["iteration"] for rid, w in parted.items()},
        "knife_edges": sorted(rid for rid, w in parted.items() if w["knife_edge"]),
        "largest_card_bound_ratio": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
