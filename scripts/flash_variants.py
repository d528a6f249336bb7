#!/usr/bin/env python3
"""Take apart where the time of the tensor-core flash attention kernel goes,
by timing edited copies of ``flashattn_wgmma.cu`` beside the real one on one
card (NVIDIA H100).

    python3 scripts/flash_variants.py [--reps 20] [--rounds 2]

Each variant is the source with one change (``VARIANTS``), built with the
port's build code into a temporary directory under ``build/``. Cases, bf16, causal, inputs
drawn on the card from a seed:

* starcoder2-3b's attention (24/2 heads, D = 128, S = 4,096) with q, k and
  v as views 2 elements past a 16-byte boundary, through each variant's
  ``repro_flash_attention_tc_unaligned``, beside the real kernel's aligned
  entry on aligned copies;
* recurrentgemma-2b's (10/1 heads, D = 256, S = 4,096) through each
  variant's aligned entry.

Every case is timed in turns (``--rounds`` times, the variants in order),
as CUDA events over ``--reps`` calls with the L2 cache flushed before each.
Variants that break the arithmetic (``no_shift``, ``stores_only``,
``no_copy``) are timed only; the others are held to the plain version
(|Δ| ≤ 2e-2). For the D = 256 aligned instantiations it reads the SASS
(``cuobjdump``): the highest register the consumers use after their
``setmaxnreg`` and the spill stores. Prints one JSON object with the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

D256_LAUNCH = ("      return launch<T, 256, 64, kTma ? 2 : 1, kTma>(q, k, v, o, B, Hq, Hkv, Sq, Sk, "
               "D, scale,\n")
REGS = ("  static constexpr int kProducer = kTma ? 40 : 64;\n"
        "  static constexpr int kConsumer = kTma ? 232 : 216;\n")
SHIFT_LOOP = "  for (int idx = threadIdx.x; idx < ROWS * kPieces; idx += kProducers) {\n"
SHIFT_BODY = ("      if constexpr (S < 0) {\n        val = w[0];\n      } else {\n"
              "        const uint4 lo = w[0], hi = w[1];\n")
# wgmma m64n32k16 (SS), for the K/V tiles of 32 keys of keys_32_at_256
SS_N32 = (
    '#define FLASH_WGMMA_SS_N32(TY)  \\\n'
    '  asm volatile(  \\\n'
    '      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %18, 0;\\n"  \\\n'
    '      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"  \\\n'
    '      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"  \\\n'
    '      "}, %16, %17, p, 1, 1, 0, 0;\\n}\\n"  \\\n'
    '      :  \\\n'
    '        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \\\n'
    '        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \\\n'
    '      : "l"(desc_a), "l"(desc_b), "r"(accumulate))\n'
    '\n')
QK_N64 = ('  if constexpr (N == 64) {\n'
          '    if constexpr (kHalf) FLASH_WGMMA_SS_N64("f16");\n')
# name -> (what it changes, [(text of the source, its replacement)], keeps the arithmetic)
VARIANTS = {
    "no_shift": ("the unaligned producer copies raw rows but shifts none into place",
                 [(SHIFT_LOOP, SHIFT_LOOP.replace("idx < ROWS * kPieces", "idx < 0"))], False),
    "stores_only": ("the shift pass stores each piece without reading the raw rows",
                    [(SHIFT_BODY, "      if constexpr (true) {\n        val = make_uint4(r, pc, 0u, 0u);"
                                  "\n      } else {\n        const uint4 lo = w[0], hi = w[1];\n")],
                    False),
    "no_copy": ("the bulk copies of raw rows are skipped (their barriers complete at once)",
                [("  mbar_expect_tx(bar, bytes);\n  asm volatile(",
                  "  mbar_expect_tx(bar, 0);\n  if (bytes == 0) asm volatile(")], False),
    "regs_24_240": ("setmaxnreg: producer 24, consumers 240 on the aligned entry",
                    [(REGS, REGS.replace("kTma ? 40", "kTma ? 24").replace("kTma ? 232", "kTma ? 240"))],
                    True),
    "keys_32_at_256": ("K/V tiles of 32 keys (4 stages) at D = 256 on the aligned entry",
                       [(D256_LAUNCH, D256_LAUNCH.replace("256, 64, kTma ? 2 : 1",
                                                          "256, kTma ? 32 : 64, kTma ? 4 : 1")),
                        ("#define FLASH_WGMMA_SS_N64(TY)", SS_N32 + "#define FLASH_WGMMA_SS_N64(TY)"),
                        (QK_N64, '  if constexpr (N == 32) {\n    if constexpr (kHalf) '
                                 'FLASH_WGMMA_SS_N32("f16");\n    else FLASH_WGMMA_SS_N32("bf16");\n'
                                 '  } else ' + QK_N64.lstrip())],
                       True),
}


def sass_report(path: Path) -> dict:
    """For each aligned D = 256 instantiation in the library: the highest
    register after the consumers' setmaxnreg and the spill stores."""
    cuobjdump = Path("/usr/local/cuda/bin/cuobjdump")
    if not cuobjdump.exists():
        return {"not measured": "no cuobjdump"}
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True,
                          text=True).stdout
    out = {}
    for func in re.split(r"\n\s+Function : ", sass)[1:]:
        name = func.split("\n", 1)[0]
        m = re.search(r"flash_tc_kernelI(\w+?)Li256ELi(\d+)ELi(\d+)ELb1E", name)
        if not m:
            continue
        lines = func.split("\n")
        at = [i for i, ln in enumerate(lines) if "SETMAXREG" in ln]
        regs = [int(r) for ln in lines[at[0]:at[1]] for r in re.findall(r"\bR(\d+)\b", ln)]
        out[f"{m.group(1)} keys={m.group(2)} stages={m.group(3)}"] = {
            "consumer_max_register": max(regs), "spill_stores": sum("STL" in ln for ln in lines)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_variants: needs a GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels.cudalib import CudaLibrary
    from repro_torch.kernels.flashattn import kernel as fa
    from repro_torch.kernels.flashattn.ops import attention_plain

    class CopyLibrary(CudaLibrary):
        def library_path(self):
            return self.source.with_suffix(".so")

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    source = fa.TC_LIBRARY.source.read_text()
    libraries = {"kernel": fa.TC_LIBRARY}
    for name, (_, edits, _) in VARIANTS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"variant {name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        path = tmp / f"flashattn_wgmma_{name}.cu"
        path.write_text(text)
        libraries[name] = CopyLibrary(path, fa.TC_LIBRARY.entries)
    with ThreadPoolExecutor(len(libraries)) as pool:
        list(pool.map(lambda lib: lib.build(), libraries.values()))

    def entry(lib, aligned):
        return fa.FlashAttentionKernel(lib, fa.FLASH_TC.entry if aligned else
                                       fa.FLASH_TC_UNALIGNED.entry, fa.TC_DTYPES, aligned)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)

    def qkv(hq, hkv, d, offset):
        out = []
        for h in (hq, hkv, hkv):
            t = torch.randn(1, h, 4096, d, generator=gen, device=dev).to(torch.bfloat16)
            if offset:
                flat = torch.zeros(offset + t.numel(), dtype=t.dtype, device=dev)
                t = flat[offset:].view(t.shape).copy_(t)
            out.append(t)
        return out

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def time_ms(fn):
        fn()
        total = 0.0
        for _ in range(args.reps):
            flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / args.reps

    cases = {"starcoder2_3b views 2 elements in": (qkv(24, 2, 128, 2), 128, False),
             "recurrentgemma_2b aligned": (qkv(10, 1, 256, 0), 256, True)}
    result = {"variants": {n: what for n, (what, _, _) in VARIANTS.items()}, "ms": {},
              "max_abs_err": {}}
    for case, ((q, k, v), d, aligned) in cases.items():
        ref = attention_plain(q, k, v, causal=True, scale=d ** -0.5)
        runs = {}
        kernels = {n: entry(lib, aligned) for n, lib in libraries.items()}
        if not aligned:
            aq, ak, av = (t.clone() for t in (q, k, v))
            runs["kernel, aligned copies"] = (entry(fa.TC_LIBRARY, True), (aq, ak, av))
        runs.update({n: (kern, (q, k, v)) for n, kern in kernels.items()})
        for name, (kern, inputs) in runs.items():
            keeps = name not in VARIANTS or VARIANTS[name][2]
            if keeps:
                err = float((kern(*inputs, True, d ** -0.5).float() - ref.float()).abs().max())
                result["max_abs_err"][f"{case}: {name}"] = err
                if err > 2e-2:
                    raise AssertionError(f"{case}: {name} is off by {err}")
        for rnd in range(args.rounds):
            for name, (kern, inputs) in runs.items():
                ms = time_ms(lambda: kern(*inputs, True, d ** -0.5))
                result["ms"].setdefault(f"{case}: {name}", []).append(ms)
                print(f"[flash_variants] round {rnd} {case}: {name} {ms:.4f} ms", flush=True)
    result["sass_d256"] = {n: sass_report(lib.library_path()) for n, lib in libraries.items()
                           if n in ("kernel", "regs_24_240", "keys_32_at_256")}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    result["device"] = smi.stdout.strip()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
