#!/usr/bin/env python3
"""How many rows of one ``qmm`` call keep the bits of a call on that row
alone, and what that does to the freeze rule's grouping contract, on one card.

    python3 scripts/qmm_row_local.py

Part 1: the tensor-core kernel on the 2-bit LOFAR CS302 shapes (forward
870×65,536, adjoint 65,536×870, random codes and x) at M = 16, 17, 24, 32
and 64: the rows of the M-row call that equal the M = 1 call on that row bit
for bit. Part 2: the LOFAR CS302 per_tensor packed solve with the freeze
rule (exit_tol = 1e-4), its 8 skies three times over (24 rows) against the
8 single solves, with Φ̂ applied in blocks of ``ROW_LOCAL_ROWS`` rows (the
solver's setting) and, for comparison, in blocks of 64 (one call for all 24
rows). Prints one JSON object with the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("qmm_row_local: needs a GPU", file=sys.stderr)
        return 1
    from repro_torch import random as prng
    from repro_torch.configs.lofar_cs302 import CONFIG as cs
    from repro_torch.core import operators
    from repro_torch.core.niht import qniht, qniht_batch
    from repro_torch.kernels.qmm.ops import pack_weights, qmm
    from repro_torch.launch.recover import lofar_instance

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    kernel = []
    for m in (16, 17, 24, 32, 64):
        for name, shape in (("fwd", (870, 65536)), ("adj", (65536, 870))):
            w = torch.randn(*shape, generator=gen, device=dev)
            pw = pack_weights(w, 2, prng.PRNGKey(2))
            x = torch.randn(m, shape[1], generator=gen, device=dev)
            y = qmm(x, pw)
            rows = torch.cat([qmm(x[b:b + 1].clone(), pw) for b in range(m)])
            same = int((rows == y).all(dim=1).sum())
            kernel.append({"orientation": name, "M": m, "rows_bitwise": same})
            print(f"qmm {name} M={m}: {same} of {m} rows bitwise equal to the M = 1 call",
                  flush=True)

    phi, y, _ = lofar_instance(cs, 0, 8, dev)
    kw = dict(bits_phi=cs.bits_phi, bits_y=cs.bits_y, key=prng.PRNGKey(0), requantize="fixed",
              backend="packed", real_signal=True, nonneg=True, early_exit=True, exit_tol=1e-4)
    singles = [qniht(phi, y[b], cs.n_sources, cs.n_iters, **kw) for b in range(8)]
    tiled = y.repeat(3, 1)
    freeze = []
    solver_rows = operators.ROW_LOCAL_ROWS
    try:
        for rows in (solver_rows, 64):
            operators.ROW_LOCAL_ROWS = rows
            res = qniht_batch(phi, tiled, cs.n_sources, cs.n_iters, **kw)
            same = sum(torch.equal(res.x[b], singles[b % 8].x)
                       and all(torch.equal(t[:, b], u)
                               for t, u in zip(res.trace, singles[b % 8].trace))
                       for b in range(tiled.shape[0]))
            freeze.append({"block_rows": rows, "rows_bitwise": same, "rows": tiled.shape[0]})
            print(f"LOFAR freeze rule, {tiled.shape[0]} rows in blocks of {rows}: {same} rows "
                  "bitwise equal to their single solve", flush=True)
    finally:
        operators.ROW_LOCAL_ROWS = solver_rows
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": card.strip().splitlines()[0] if card.strip() else None,
                      "kernel": kernel, "freeze_rule": freeze}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
