#!/usr/bin/env python3
"""Time ``QMM_EXPERTS`` (``kernels/qmm/csrc/qmm_experts.cu``) at
qwen3-moe-30b-a3b's expert stacks on one card, whole and with one part of
the kernel taken out at a time, to show what holds it back.

    python3 scripts/qmm_experts_parts.py [--reps 20]

The stacks are 128 experts of wi_gate (768 × 2,048) and wo (2,048 × 768),
W4 codes of random weights, bf16 x, at a decode step's C = 1 (about 40% of
the experts with their row in use, as a step routes them, and all) and a
prefill group's C = 320 (all rows). Each variant is a copy of the source
with one text substitution, built beside the real one:

* ``no_mma``: the wgmma groups replaced by a register add (loads, unpacking,
  stores stay);
* ``no_fill``: the codes' unpacking replaced by constants (loads, wgmma and
  stores stay);
* ``no_store``: y's stores of the products skipped;
* ``x_once``: x read only by each m-tile's first code tile (the others
  multiply stale x): the L2 traffic of re-reading x taken out.

The variants compute wrong results; only the real kernel is checked against
the plain version. Times: device time of the kernel (torch.profiler, CUPTI)
and CUDA events around the call, both with the L2 cache flushed before each
call, beside ``torch.bmm`` on the stack materialized to bf16. Prints one
JSON object with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

FILL = "        fill<BITS>(af, cst, b, r0, t, sel, sh);"
MMA = "          wgmma_rs<NB>(acc, af[s], smem_desc(xa + b * L::kXBox + s * 32, 16, 1024), 1);"
STORE = "        a.y[(row0 + ml) * a.N + nn[h]] = ml < mv ? acc[q] * mult[h] : 0.f;"
BYTES = "      const uint32_t bytes = F::kCStage + kBoxes * rows8 * 128u;"
XLOOP = "        for (int b = 0; b < kBoxes; ++b) {"
VARIANTS = {
    "no_mma": [(MMA, "          acc[s % (NB / 2)] += __uint_as_float(af[s][0] & 0x3fffffffu);")],
    "no_fill": [(FILL, "        for (int s = 0; s < 4; ++s)\n"
                       "          for (int u = 0; u < 4; ++u) af[s][u] = 0x3F803F80u + j;")],
    "no_store": [(STORE, "        if (acc[q] == 1234.5f) a.y[0] = mult[h];")],
    "x_once": [(BYTES, "      const uint32_t bytes = F::kCStage + (it.z ? 0u : kBoxes * rows8 * 128u);"),
               (XLOOP, "        for (int b = 0; b < (it.z ? 0 : kBoxes); ++b) {")],
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("qmm_experts_parts: needs a GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels.cudalib import CudaKernel, CudaLibrary
    from repro_torch.kernels.qmm import kernel as qk
    from repro_torch.kernels.qmm.ops import qmm_batched
    from repro_torch.kernels.qmm.ref import qmm_batched_ref
    from repro_torch.models.quantized import materialize, quantize_weight

    dev = torch.device("cuda")
    source = qk.EXPERTS_SOURCE.read_text()
    tmp = Path(tempfile.mkdtemp())
    libs = {"real": qk.EXPERTS_LIBRARY}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"qmm_experts_parts: {name}: the source has changed: {old!r}")
            text = text.replace(old, new)
        (tmp / f"qmm_experts_{name}.cu").write_text(text)
        libs[name] = CudaLibrary(tmp / f"qmm_experts_{name}.cu", qk.EXPERTS_LIBRARY.entries)
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs.values()))
    kernels = {name: CudaKernel(lib, "repro_qmm_experts") for name, lib in libs.items()}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    counters = torch.zeros(2, dtype=torch.int32, device=dev)

    def event_ms(fn):
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

    def device_ms(fn, name):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0) or 0 for e in prof.key_averages()
                 if name in e.key and getattr(e, "device_type", None) == DeviceType.CUDA)
        return us / args.reps / 1e3

    gen = torch.Generator(device=dev).manual_seed(0)
    rows_out = []
    for stack, (n, k) in {"wi_gate": (768, 2048), "wo": (2048, 768)}.items():
        e = 128
        w = quantize_weight(torch.randn(e, k, n, generator=gen, device=dev) * 0.02, 4)
        wb = materialize(w, torch.bfloat16)
        routed = (torch.rand(e, generator=gen, device=dev) < 0.4).to(torch.int32)
        for c, label, rows in ((1, "routed", routed),
                               (1, "all", torch.ones(e, dtype=torch.int32, device=dev)),
                               (320, "all", torch.full((e,), 320, dtype=torch.int32, device=dev))):
            x = torch.randn(e, c, k, generator=gen, device=dev).to(torch.bfloat16)
            x[~(torch.arange(c, device=dev) < rows[:, None])] = 0
            ref = qmm_batched_ref(x.float(), w.packed, w.scale, 4, k, rows)
            err = float((qmm_batched(x, w.packed, w.scale, 4, k, rows) - ref).abs().max())
            row = {"stack": stack, "C": c, "rows": label, "rows_in_use": int(rows.sum()),
                   "real_max_abs_err": err}
            for name, kern in kernels.items():
                y = torch.empty(e, c, n, device=dev)

                def call(kern=kern, y=y):
                    status = kern.library.build().repro_qmm_experts(
                        x.data_ptr(), w.packed.data_ptr(), w.scale.data_ptr(), rows.data_ptr(),
                        y.data_ptr(), counters.data_ptr(), e, c, n, k, k // 2, 4,
                        torch.cuda.current_stream().cuda_stream)
                    if status:
                        raise RuntimeError(f"{name}: cudaError {status}")
                row[name] = {"device_ms": device_ms(call, "qmm_experts_kernel"),
                             "event_ms": event_ms(call)}
            row["bmm"] = {"event_ms": event_ms(lambda: torch.bmm(x, wb))}
            rows_out.append(row)
            print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "rows": rows_out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
