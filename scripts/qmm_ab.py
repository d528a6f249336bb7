#!/usr/bin/env python3
"""Time this checkout's tensor-core ``qmm`` kernel against another checkout's
(for example the parent commit) on one card, in turns.

    python3 scripts/qmm_ab.py --other DIR [--reps 20] [--rounds 2]

DIR is the root of the other checkout (``git archive`` of a commit unpacked
into a directory that ``.gitignore`` lists). Both ``qmm_wgmma.cu`` sources
are built with this checkout's build code and called through this checkout's
wrapper on the same inputs: the main path's 2-bit LOFAR CS302 operand (the
per_tensor packed Φ̂, forward 870×65,536 and adjoint 65,536×870) at M = 1,
8 and 64. Each case is timed other, this, this, other (``--rounds`` times),
as CUDA events over ``--reps`` calls with the L2 cache flushed before each,
and the outputs of the two are compared. Prints one JSON object with the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("qmm_ab: needs a GPU", file=sys.stderr)
        return 1
    from repro_torch import random as prng
    from repro_torch.configs.lofar_cs302 import CONFIG as cs
    from repro_torch.kernels.cudalib import CudaLibrary
    from repro_torch.kernels.qmm import kernel as qk
    from repro_torch.kernels.qmm.ops import pack_operator
    from repro_torch.sensing.telescope import Station, measurement_matrix

    other_src = Path(args.other) / "src/repro_torch/kernels/qmm/csrc/qmm_wgmma.cu"
    other = qk.QmmKernel(CudaLibrary(other_src, qk.LIBRARY.entries), "repro_qmm_tc")
    this = qk.QMM
    dev = torch.device("cuda")
    phi = measurement_matrix(Station(n_antennas=cs.n_antennas, seed=cs.seed), cs.resolution,
                             cs.extent, device=dev)
    op = pack_operator(phi, cs.bits_phi, prng.fold_in(prng.PRNGKey(0), 0), shared=True)
    del phi
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def time_ms(fn):
        fn()
        total = 0.0
        for _ in range(args.reps):
            flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / args.reps

    rows = []
    for name, w in (("lofar_fwd", op.fwd_re), ("lofar_adj", op.adj_re)):
        for m in (1, 8, 64):
            x = torch.randn(m, w.k_dim, generator=gen, device=dev)
            call = {k: (lambda kern=kern: kern(x, w.packed, w.scale, w.bits, w.k_dim))
                    for k, kern in (("other", other), ("this", this))}
            same = torch.equal(call["other"](), call["this"]())
            times = {"other": [], "this": []}
            for _ in range(args.rounds):
                for k in ("other", "this", "this", "other"):
                    times[k].append(time_ms(call[k]))
            row = {"shape": name, "M": m, "bits": w.bits, "bitwise_equal": same,
                   **{f"{k}_ms": sorted(v) for k, v in times.items()}}
            rows.append(row)
            print(f"[qmm_ab] {name} M={m:2d}: other {min(times['other']):.4f} ms, this "
                  f"{min(times['this']):.4f} ms (best of {len(times['this'])}); outputs "
                  f"{'bit for bit equal' if same else 'differ'}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "other": str(other_src), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
