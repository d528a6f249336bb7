#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU (H100).

Run from the root of a checkout, with one card:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package ``repro``. Phases
(any failure makes the exit code non-zero and suppresses the result line):

1. build the Hopper kernel libraries from ``src/repro_torch/kernels/*/csrc``
   (``qmm_wgmma.cu``: ``qmm`` and ``qmm_group`` on the tensor cores; ``qmm.cu``:
   the CUDA-core row walk, ``qmm_group`` for g not a multiple of 16 and both
   for codes off a 16-byte boundary; ``hsthresh.cu``: ``hist`` and ``mask``;
   ``hsthresh_fused.cu``: the whole H_s in one cluster launch; ``sqround.cu``;
   ``flashattn.cu``, attention on the CUDA cores (float32, 16-bit at head dims
   8/160/256, and views off a 16-byte boundary); ``flashattn_wgmma.cu``,
   bf16/fp16 attention on the tensor cores), one nvcc per source, started
   together;
2. hold the ``qmm`` kernel against its plain PyTorch version ``qmm_ref`` on the card
   (TF32 off, asserted) at bits 2/4/8 × M ∈ {1, 8, 64} × the LOFAR CS302
   forward (870×65,536) and adjoint (65,536×870) shapes of the main path's
   own packed Φ̂, plus a ragged shape; tolerance |Δ| ≤ 1e-5·|ref| +
   1e-5·(|x|@|w|ᵀ), the reference's kernel-vs-oracle bound. Every call must
   launch ``QMM`` of ``qmm_wgmma.cu``. Then the checks a tolerance cannot
   give (``exact_checks``), at the LOFAR shapes, 2 and 8 bits: integer x
   (bit for bit, M ∈ {1, 8, 64}), one-hot rows of Φ̂ with full-mantissa x
   (bit for bit) and batch rows (row b of M = 8 equals M = 1, bit for bit).
   The split's edges (``edge_checks``): x with every |x| in [2⁻¹²⁵, 2⁻¹¹⁰),
   rows whose largest |x| is the largest f32, rows spanning the whole f32
   range and rows whose sums overflow, bits 2 and 8, M ∈ {1, 8}, both
   orientations: the 1e-5 rule in float64 where the plain version is
   finite, inf or nan in the same places where it is not. Codes that start
   1, 2 and 8 bytes past a 16-byte boundary must launch the byte-load
   ``QMM_CORE`` of ``qmm.cu`` once each, and nothing else, within the rule.
   Times the kernel, the plain version and ``torch.matmul`` against the
   pre-dequantized f32 Φ̂ (the dense stream the paper compares against),
   with the L2 cache flushed before every timed call;
3. the main path at full size: LOFAR CS302 (870×65,536 complex Φ, 2-bit Φ̂,
   8-bit y, s=30, 60 iterations) packed, single and ``--batch 8``, with the
   kernel's launch counter set to 0 before and read after each solve; then
   the same solves as fake-quantized ``--requantize fixed`` on the same codes.
   Requires |Δrel_error| ≤ 0.01, ‖Δx‖ ≤ 1e-3·‖x‖ and the launch counts the
   iteration predicts (14 per iteration plus 2 per backtracking step);
   A 32-bit dense NIHT solve of the same sky gives the full-precision baseline;
4. the Gaussian toy (256×512) packed at bits 4 and 8 with ``--batch 8``
   against fake-fixed. The batch-level ‖Δx‖ ≤ 1e-3·‖x‖ is reported, met or
   not; each row must agree to ‖Δx_b‖ ≤ 1e-3·‖x_b‖, or split at a knife-edge
   decision after trajectories that agreed to rounding, and then stay within
   0.01 in rel_error. The same solves with ``qmm_ref`` standing in for the
   kernel are the witness; the instance and the answers go to
   ``gaussian_batch8.npz`` for ``scripts/reference_replay.py``;
5. a torch.profiler trace of one packed single-row LOFAR solve on each path
   (per_tensor, per_block, hsthresh): device time by kernel (``qmm_wgmma_kernel``,
   the CUDA-core ``qmm_kernel``, ``hsthresh_kernel``), the device's busy share
   and the set-up alone (``lofar_*_trace.json``); on the hsthresh path also
   the H_s calls' span on the device timeline and the device launches per
   proposal, beside the same solve with the two-kernel chain standing in;
6. ``qmm_group`` against ``qmm_group_ref`` at the LOFAR forward and adjoint
   shapes of the per_block Φ̂ (g = 64), bits 2/4/8 × M ∈ {1, 8, 64}, plus a
   ragged shape with a short last group; same tolerance, timings and exact
   checks as 2 (power-of-two scales; one-hot within 2 ulp; the split's
   edges; misaligned codes on ``QMM_GROUP_CORE``); every aligned call must
   launch ``QMM_GROUP`` of ``qmm_wgmma.cu``. The ragged shape at g = 8 goes
   through ``qmm`` and must launch the CUDA-core ``QMM_GROUP_CORE`` (``qmm.cu``);
7. ``hist`` and ``mask`` against ``hist_ref``/``mask_ref`` at (1, 65,536),
   (8, 65,536) and (3, 1,001), bit for bit, timed beside their bytes bound
   (their launches in the kernels line are this phase's checking calls: the
   solver no longer calls them);
8. LOFAR CS302 at full size with ``scale_granularity="per_block",
   group_size=64``, single and batch 8: ``qmm_group`` takes exactly the
   launches ``qmm`` takes on the per_tensor path and ``qmm`` none; the same
   solves with ``qmm_group_ref`` standing in on the card are the witness,
   held per row as in 4. One ``per_channel`` single solve goes through
   ``qmm``. The per_block instances go to ``lofar_block.npz`` (full size,
   no Φ) and ``lofar_bench_block.npz`` (with Φ) for
   ``scripts/reference_replay.py lofar-block``;
9. LOFAR CS302 at full size with ``threshold="hsthresh"`` (per_tensor
   packed), single and batch 8: the fused ``HSTHRESH`` launches once per
   proposal for the whole batch, ``hist`` and ``mask`` never, ``qmm`` as on
   the topk path, and the same solves with ``hsthresh_ref`` standing in on
   the card give bit-identical x and trace; iterations whose support
   differs from the ``topk`` solve are counted; the single solve's wall is
   taken five times beside the same solve with the two-kernel chain
   (``hist``, ``mask`` and the plain pick and fill) standing in;
10. the Gaussian toy per_block (g = 64 on ``QMM_GROUP``, and g = 8 on the
    CUDA-core ``QMM_GROUP_CORE``; bits 4 and 8, batch 8) against its
    ``qmm_group_ref`` witness, per row as in 4;
11. ``sqround`` through its entry point at the LOFAR CS302 Φ (the real part
    of the 870×65,536 measurement matrix), the ``kernels_micro`` 512×512 and
    a ragged 333×1,001, bits 2/4/8: one launch per call, codes and scale bit
    for bit equal to ``sqround_ref`` on the same words; timed alone, as the
    whole call (with the threefry draw) and as the plain version, beside the
    9-bytes-per-element bound;
12. ``flash_attention`` through its entry point at starcoder2-3b's attention
    width (24 query heads on 2 KV heads, D = 128, causal): bf16 at S = 4,096
    (held over the whole output against the plain version) and S = 32,768
    (its last 256 rows against the plain version's causal Sq = 256, Sk =
    32,768 call, and every row against the plain version run in 1,024-row
    chunks), fp16 and f32 at S = 4,096, plus ragged and cross-attention f32
    shapes, causal and not; the head dims of the reference's other configs
    (D = 8, 160, 256 in f32, bf16 and fp16, and stablelm-12b's,
    recurrentgemma-2b's and qwen3-moe-235b SMOKE's attention at S = 4,096 in
    bf16); and q, k, v as views
    2 elements into larger tensors. Aligned bf16 and fp16 calls at D ≤ 128
    must launch ``FLASH_TC`` (``flashattn_wgmma.cu``), at D = 8, 160, 256
    ``FLASH_CORE``, f32 calls ``FLASH``, and views off a 16-byte boundary
    ``FLASH_UNALIGNED`` (all three ``flashattn.cu``).
    |Δ| ≤ 2e-4 (f32) and 2e-2 (bf16, fp16), abs and rel, TF32 off; 16-bit
    rows also ‖Δ‖₂ ≤ 2⁻⁷·‖ref‖₂ (one bf16 ulp, relative), which scales with
    the output where 2e-2 does not. Timed beside
    ``scaled_dot_product_attention`` on the same tensors (its flash backend
    for 16-bit inputs) and the bound; the library's own max row ‖Δ‖/‖ref‖
    against the plain version is reported beside the kernel's, not gated;
13. the fused H_s (``HSTHRESH``, ``hsthresh_fused.cu``) against
    ``hsthresh_ref`` at (1, 65,536), (8, 65,536) and (3, 1,001), nbins
    2,048, s = 30, bit for bit (and on rows whose threshold-bin ties
    straddle the cluster's chunk edges), one launch per call; timed as CUDA
    events and as profiler device time beside the two-kernel chain it
    replaces and the plain version, with each call's device launches
    counted.

Every phase that drives a path sets the launch counts of all kernels to 0
just before it and reads them just after.

Before its last line it prints the card's name and power limit and one JSON
line ``{"kernels": [...]}`` (its ``bound_ms`` is the larger of the bytes and
the f32 CUDA-core operations, as since the first slice; ``bytes_bound_ms``,
beside it for ``qmm`` and ``qmm_group``, is the bytes alone at 3.35 TB/s, the
bound a tensor-core kernel is held to at small M); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Details go to ``chip_smoke.json`` and the trace in the directory named by
``--out`` (default ``chip_smoke_out/`` beside this script).

``python3 chip_smoke.py --flash-mutants`` runs none of that. It checks the bf16
checks of phase 12 instead: it plants each fault of ``FLASH_MUTANTS`` in a
copy of ``flashattn_wgmma.cu`` in a temporary directory, builds the copies,
and holds each, beside the real kernel, to the starcoder2-3b checks. It
passes when the real kernel meets every check and every copy fails one, and
writes ``flash_mutants.json`` to ``--out``.
"""
from __future__ import annotations

import collections
import contextlib
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12         # float32 outside the tensor cores
M_VALUES = (1, 8, 64)
GROUP = 64                     # per_block group size (docs/quantization.md's example)
NBINS = 2048                   # the solver's hsthresh bins
HS_SHAPES = ((1, 65536), (8, 65536), (3, 1001))
HS_S = 30                      # the LOFAR CS302 sparsity
EDGE_KINDS = ("tiny", "top", "mixed", "overflow")
CODE_OFFSETS = (1, 2, 8)       # bytes past a 16-byte boundary of the misaligned code views
BF16_FLOP_PER_S = 989e12       # dense bf16 tensor-core peak, H100 SXM data sheet
# starcoder2-3b's attention (src/repro/configs/starcoder2_3b.py) at the
# lengths of src/repro/configs/shapes.py's train_4k and prefill_32k
STARCODER2_3B_HEADS, STARCODER2_3B_KV_HEADS, STARCODER2_3B_HEAD_DIM = 24, 2, 128
TRAIN_4K_LEN, PREFILL_32K_LEN = 4096, 32768
# (query heads, KV heads, head dim) of src/repro/configs/stablelm_12b.py,
# recurrentgemma_2b.py and qwen3_moe_235b.py's SMOKE: the head dims the
# tensor-core kernel does not take
STABLELM_12B_ATTN, RECURRENTGEMMA_2B_ATTN = (32, 8, 160), (10, 1, 256)
QWEN3_MOE_SMOKE_ATTN = (8, 2, 8)
PREFILL_TAIL_ROWS = 256        # rows of the 32k output held against a causal Sq = 256 call
PLAIN_CHUNK_ROWS = 1024        # query rows per plain-version call at 32k
BF16_ROW_REL = 2.0 ** -7       # one bf16 ulp, relative: the most that rounding two nearly
                               # equal rows to bf16 sets them apart, in 2-norm
# Faults planted in copies of flashattn_wgmma.cu by --flash-mutants: name ->
# (what it breaks, [(text of the source, its replacement), ...])
FLASH_MUTANTS = {
    "diagonal_tile": ("causal query tiles past the first skip their diagonal KV tile", [
        ("  if (causal) n_kv = min(n_kv, (min(q0 + kBlockM, Sq) - 1 + off) / kBlockN + 1);\n",
         "  if (causal) n_kv = min(n_kv, (min(q0 + kBlockM, Sq) - 1 + off) / kBlockN + 1);\n"
         "  if (causal && qt > 0) n_kv -= 1;\n")]),
    "own_key": ("the causal mask drops each row's own key (j < i + Sk - Sq)", [
        ("(!causal || key <= row + off)", "(!causal || key < row + off)")]),
    "bf16_acc": ("the f32 O accumulator rounded to bf16 after each KV tile", [
        ("    fence_regs(acc);                                // P V has retired: acc holds tile t\n",
         "    fence_regs(acc);                                // P V has retired: acc holds tile t\n"
         "#pragma unroll\n"
         "    for (int i = 0; i < DP / 2; ++i) acc[i] = __bfloat162float(__float2bfloat16_rn(acc[i]));\n")]),
}


class Phases:
    def __init__(self):
        self.failed = []

    def run(self, name, fn, *args):
        print(f"[chip_smoke] phase {name} ...", flush=True)
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:  # noqa: BLE001 -- a phase failure is reported, then the run fails
            traceback.print_exc()
            self.failed.append(name)
            print(f"[chip_smoke] phase {name} FAILED", flush=True)
            return None
        print(f"[chip_smoke] phase {name} ok ({time.perf_counter() - t0:.1f} s)", flush=True)
        return out


def bound_ms(m, n, k, kp, n_groups=None):
    """Least time for x (M, K) @ dequant(w)ᵀ: codes, scales, x and y moved
    once, or the FMAs at the f32 CUDA-core peak (plus, grouped, one scale
    product per code); and the bytes alone. Returns (ms, bound_by,
    bytes-only ms)."""
    scale_words = n if n_groups is None else n * n_groups
    nbytes = n * kp + 4 * scale_words + 4 * m * k + 4 * m * n
    flops = 2 * m * n * k + (0 if n_groups is None else n * k)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"),
            t_bytes * 1e3)


def time_ms(torch, fn, reps, flush):
    """Mean device time of fn() over reps calls, L2 flushed before each."""
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def device_ms(torch, fn, reps, flush, name):
    """Mean device time per call of fn of the kernels whose name holds
    `name` (torch.profiler, CUPTI), the L2 cache flushed before each call:
    the kernel alone, without the launch and the host's share that the
    event timing of time_ms takes in. None when the profiler sees none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) or 0 for e in prof.key_averages()
             if name in e.key and getattr(e, "device_type", None) == DeviceType.CUDA)
    return us / reps / 1e3 if us else None


def phase_build(libraries):
    """One nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(libraries)) as pool:
        list(pool.map(lambda lib: lib.build(), libraries))
    out = {}
    for lib in libraries:
        ptxas = [ln.strip() for ln in lib.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[chip_smoke] built {lib.library_path().name} in {lib.build_seconds:.1f} s; "
              f"{len(ptxas) // 2} kernel instantiations", flush=True)
        for ln in ptxas[:12]:
            print(f"[chip_smoke]   ptxas {ln}", flush=True)
        spills = [ln for ln in ptxas
                  if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        out[lib.source.name] = {"seconds": lib.build_seconds, "ptxas": ptxas,
                                "lines_with_spills": spills}
    return out


def reset_counts(mods):
    for kernel in mods["KERNELS"]:
        kernel.reset_counts()


def phase_kernel(torch, mods):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    dev = torch.device("cuda")
    QMM, qmm_ref, pack_operator, pack_weights = (mods["QMM"], mods["qmm_ref"],
                                                 mods["pack_operator"], mods["pack_weights"])
    unpack_codes, prng = mods["unpack_codes"], mods["prng"]
    cs = mods["LOFAR"]
    phi = mods["measurement_matrix"](mods["Station"](n_antennas=cs.n_antennas, seed=cs.seed),
                                     cs.resolution, cs.extent, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows, max_err, core_rows, core_launches = [], 0.0, [], 0
    for bits in (2, 4, 8):
        op = pack_operator(phi, bits, prng.fold_in(prng.PRNGKey(0), 0), shared=True)
        ragged = pack_weights(torch.randn(333, 1001, generator=gen, device=dev), bits,
                              prng.PRNGKey(bits), per_channel=True)
        cases = [("lofar_fwd", op.fwd_re, M_VALUES), ("lofar_adj", op.adj_re, M_VALUES),
                 ("ragged", ragged, (5,))]
        for name, w, ms in cases:
            k = w.k_dim
            n, kp = w.packed.shape
            wdeq = unpack_codes(w.packed, bits, k).to(torch.float32) * (
                w.scale.reshape(-1, 1) / (2 ** (bits - 1) // 2))
            for m in ms:
                x = torch.randn(m, k, generator=gen, device=dev)
                routed = mods["cuda_kernel"](w)
                if routed is not QMM or QMM.library.source.name != "qmm_wgmma.cu":
                    raise AssertionError(f"qmm {name}: routed to {routed.entry} of "
                                         f"{routed.library.source.name}")
                before = QMM.launches
                y = mods["qmm"](x, w)
                if QMM.launches != before + 1:
                    raise AssertionError(f"qmm {name} bits={bits} M={m}: QMM was not launched")
                ref = qmm_ref(x, w.packed, w.scale, bits, k)
                torch.cuda.synchronize()
                tol = 1e-5 * ref.abs() + 1e-5 * (x.abs() @ wdeq.abs().T)
                err = (y - ref).abs()
                if not bool((err <= tol).all()):
                    raise AssertionError(f"qmm {name} bits={bits} M={m}: max |Δ| "
                                         f"{float(err.max())} exceeds the tolerance")
                max_err = max(max_err, float(err.max()))
                b_ms, b_by, bb_ms = bound_ms(m, n, k, kp)
                row = {"shape": name, "bits": bits, "M": m, "N": n, "K": k,
                       "max_abs_err": float(err.max()),
                       "ms": time_ms(torch, lambda: QMM(x, w.packed, w.scale, bits, k), 20,
                                     flush),
                       "plain_ms": time_ms(torch, lambda: qmm_ref(x, w.packed, w.scale, bits, k),
                                           5, flush),
                       "library_ms": time_ms(torch, lambda: torch.matmul(x, wdeq.T), 20, flush),
                       "bound_ms": b_ms, "bound_by": b_by, "bytes_bound_ms": bb_ms,
                       "device_ms": (device_ms(torch, lambda: QMM(x, w.packed, w.scale, bits, k),
                                               20, flush, "qmm_wgmma_kernel")
                                     if name != "ragged" and bits == cs.bits_phi else None)}
                rows.append(row)
                print(f"[chip_smoke]   qmm {name:9s} bits={bits} M={m:2d}: max|Δ|={row['max_abs_err']:.3g} "
                      f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
                      f"matmul(f32 Φ̂) {row['library_ms']:.4f} ms  bound {b_ms:.4f} ms ({b_by}), "
                      f"bytes alone {bb_ms:.4f} ms, device (profiler) {row['device_ms']}", flush=True)
            if name != "ragged" and bits == cs.bits_phi:
                mrow, n_launch = misaligned_rows(torch, mods, name, w, bits, wdeq, gen, flush,
                                                 group=False)
                core_rows.append(mrow)
                core_launches += n_launch
            del wdeq
        del op
    del phi, flush
    torch.cuda.empty_cache()
    exact = exact_checks(torch, mods, group=False)
    edges = edge_checks(torch, mods, group=False)
    return {"rows": rows, "max_abs_err": max_err, "entry": QMM.entry,
            "source": QMM.library.source.name, "exact": exact, "edges": edges,
            "misaligned_rows": core_rows, "misaligned_launches": core_launches}


def ulps(torch, got, want):
    """|got - want| in units in the last place of want (f32)."""
    _, e = torch.frexp(want)
    return ((got - want).abs() / torch.ldexp(torch.ones_like(want), e - 24)).max()


def exact_checks(torch, mods, group):
    """The checks a tolerance cannot give, at the LOFAR CS302 forward
    (870×65,536) and adjoint (65,536×870) shapes, 2 and 8 bits, random codes:

    * integer x: qmm with x in {-2..2} (Σ|x|·|c - K_h| < 2²⁴ in every row),
      qmm_group with x in {-1, 0, 1} and power-of-two scales {1/2, 1}: every
      partial sum is exact in f32, so the kernel equals the plain version bit
      for bit, M ∈ {1, 8, 64};
    * one-hot: rows of Φ̂ with a single nonzero code, x with full 24-bit
      mantissas: qmm bit for bit, qmm_group within 2 ulp. A kernel that
      dropped the lo piece of x would miss by ~2⁻¹⁶ relative here while
      passing the 1e-5 rule;
    * batch rows: row b of an M = 8 call equals the M = 1 call on row b,
      bit for bit."""
    dev = torch.device("cuda")
    kern = mods["QMM_GROUP"] if group else mods["QMM"]
    ref = mods["qmm_group_ref"] if group else mods["qmm_ref"]
    cs = mods["LOFAR"]
    n_pix, n_vis = cs.resolution ** 2, cs.n_antennas * (cs.n_antennas - 1)
    gen = torch.Generator(device=dev).manual_seed(5)
    out = []
    for bits in (2, 8):
        kh = 2 ** (bits - 1) // 2
        for shape, (n, k) in (("lofar_fwd", (n_vis, n_pix)), ("lofar_adj", (n_pix, n_vis))):
            extra = (GROUP,) if group else ()
            if group:
                n_groups = (k + GROUP - 1) // GROUP
                scale = 2.0 ** -torch.randint(0, 2, (n, n_groups), generator=gen,
                                              device=dev).float()
            else:
                scale = torch.rand(n, generator=gen, device=dev) + 0.5
            codes = torch.randint(-kh, kh + 1, (n, k), generator=gen, device=dev,
                                  dtype=torch.int32).to(torch.int8)
            packed = mods["pack_codes"](codes, bits)
            for m in M_VALUES:
                lim = 1 if group else 2
                x = torch.randint(-lim, lim + 1, (m, k), generator=gen, device=dev).float()
                if not torch.equal(kern(x, packed, scale, bits, k, *extra),
                                   ref(x, packed, scale, bits, k, *extra)):
                    raise AssertionError(f"{kern.entry} integer {shape} bits={bits} M={m}: "
                                         "not bit for bit")
            onehot = torch.zeros(n, k, dtype=torch.int8, device=dev)
            sign = torch.randint(0, 2, (n,), generator=gen, device=dev) * 2 - 1
            value = torch.randint(1, kh + 1, (n,), generator=gen, device=dev) * sign
            onehot[torch.arange(n, device=dev),
                   torch.randint(0, k, (n,), generator=gen, device=dev)] = value.to(torch.int8)
            packed = mods["pack_codes"](onehot, bits)
            x = torch.randn(8, k, generator=gen, device=dev) * 3.7
            y = kern(x, packed, scale, bits, k, *extra)
            want = ref(x, packed, scale, bits, k, *extra)
            off = float(ulps(torch, y, want))
            if off > (2.0 if group else 0.0):
                raise AssertionError(f"{kern.entry} one-hot {shape} bits={bits}: {off} ulp")
            rows = torch.cat([kern(x[b:b + 1].contiguous(), packed, scale, bits, k, *extra)
                              for b in range(8)])
            if not torch.equal(rows, y):
                raise AssertionError(f"{kern.entry} batch rows {shape} bits={bits}: row b of "
                                     "M = 8 differs from the M = 1 call")
            torch.cuda.synchronize()
            out.append({"shape": shape, "bits": bits, "integer_bitwise": list(M_VALUES),
                        "onehot_ulp": off, "batch_rows_bitwise": True})
            print(f"[chip_smoke]   {kern.entry} exact {shape} bits={bits}: integer x bit for bit "
                  f"at M = {', '.join(map(str, M_VALUES))}; one-hot {off:g} ulp; batch rows "
                  f"bit for bit", flush=True)
            del codes, onehot, packed
    torch.cuda.empty_cache()
    return out


def edge_x(torch, kind, m, k, gen):
    """x at the edges of the tensor-core kernel's three-piece split: every
    |x| in [2⁻¹²⁵, 2⁻¹¹⁰) ("tiny"); rows whose largest |x| is the largest f32
    over x near 2⁸⁰ ("top"); rows spanning 2⁻¹²⁶ to the largest f32
    ("mixed"); rows with two entries of the largest f32, whose sums overflow
    where their codes agree in sign and add up past 1 ("overflow")."""
    dev = gen.device
    fmax = torch.finfo(torch.float32).max
    sign = torch.where(torch.rand(m, k, generator=gen, device=dev) < 0.5, -1.0, 1.0)
    mant = 1.0 + torch.rand(m, k, generator=gen, device=dev)
    rows = torch.arange(m, device=dev)

    def pick(lo, hi):
        return sign * mant * torch.exp2(torch.randint(lo, hi, (m, k), generator=gen,
                                                      device=dev).float())

    def cols():
        return torch.randint(0, k, (m,), generator=gen, device=dev)
    if kind == "tiny":
        return pick(-125, -110)
    if kind == "top":
        x = torch.randn(m, k, generator=gen, device=dev) * 2.0 ** 80
        x[rows, cols()] = fmax * sign[:, 0]
        return x
    if kind == "mixed":
        x = pick(-126, 80)
        x[rows, cols()] = fmax * sign[:, 1]
        x[rows, cols()] = 2.0 ** -126
        return x
    x = torch.randn(m, k, generator=gen, device=dev)
    c0 = cols()
    x[rows, c0] = fmax
    x[rows, (c0 + 1 + cols() % (k - 1)) % k] = fmax
    return x


def edge_checks(torch, mods, group):
    """x at both edges of the split through QMM (QMM_GROUP, g = 64, when
    ``group``) at the LOFAR CS302 forward and adjoint shapes, bits 2 and 8,
    M ∈ {1, 8}, random codes, scales in [0.5, 0.75]: |Δ| ≤ 1e-5·|ref| +
    1e-5·(|x|@|w|ᵀ), computed in float64 so that the tolerance cannot
    overflow to inf, wherever the plain version is finite, and inf or nan in
    the same places where it is not (and the overflow rows must overflow
    somewhere). Returns the largest |Δ| / tolerance per case."""
    dev = torch.device("cuda")
    kern = mods["QMM_GROUP"] if group else mods["QMM"]
    ref = mods["qmm_group_ref"] if group else mods["qmm_ref"]
    cs = mods["LOFAR"]
    n_pix, n_vis = cs.resolution ** 2, cs.n_antennas * (cs.n_antennas - 1)
    gen = torch.Generator(device=dev).manual_seed(6)
    out = []
    for bits in (2, 8):
        kh = 2 ** (bits - 1) // 2
        for shape, (n, k) in (("lofar_fwd", (n_vis, n_pix)), ("lofar_adj", (n_pix, n_vis))):
            codes = torch.randint(-kh, kh + 1, (n, k), generator=gen, device=dev,
                                  dtype=torch.int32).to(torch.int8)
            packed = mods["pack_codes"](codes, bits)
            if group:
                scale = torch.rand(n, (k + GROUP - 1) // GROUP, generator=gen, device=dev)
                scale = scale * 0.25 + 0.5
                wabs = codes.double().abs() * mods["expand_block_scale"](scale, GROUP, k) / kh
                extra = (GROUP,)
            else:
                scale = torch.rand(n, generator=gen, device=dev) * 0.25 + 0.5
                wabs = codes.double().abs() * (scale.double()[:, None] / kh)
                extra = ()
            for m in (1, 8):
                for kind in EDGE_KINDS:
                    x = edge_x(torch, kind, m, k, gen)
                    y = kern(x, packed, scale, bits, k, *extra)
                    want = ref(x, packed, scale, bits, k, *extra)
                    fin = torch.isfinite(want)
                    label = f"{kern.entry} edge {kind} {shape} bits={bits} M={m}"
                    if not torch.equal(torch.isfinite(y), fin):
                        raise AssertionError(f"{label}: inf/nan in "
                                             f"{int((torch.isfinite(y) != fin).sum())} other "
                                             "places than the plain version's")
                    if kind == "overflow" and bool(fin.all()):
                        raise AssertionError(f"{label}: no output overflowed")
                    tol = 1e-5 * want.double().abs() + 1e-5 * (x.double().abs() @ wabs.T)
                    ratio = float(((y.double() - want.double()).abs() / tol)[fin].max())
                    if not ratio <= 1.0:
                        raise AssertionError(f"{label}: |Δ| is {ratio} times the tolerance")
                    out.append({"kind": kind, "shape": shape, "bits": bits, "M": m,
                                "err_over_tol": ratio,
                                "nonfinite": int((~fin).sum())})
            del codes, packed, wabs
    torch.cuda.synchronize()
    worst = max(r["err_over_tol"] for r in out)
    print(f"[chip_smoke]   {kern.entry} split edges ({', '.join(EDGE_KINDS)}; LOFAR fwd and "
          f"adj, bits 2 and 8, M = 1 and 8): within the 1e-5 rule, largest |Δ|/tolerance "
          f"{worst:.3g}; inf/nan where the plain version's", flush=True)
    torch.cuda.empty_cache()
    return out


def codes_at(torch, packed, offset):
    """The same codes as a contiguous view that starts ``offset`` bytes past a
    16-byte boundary of a larger buffer (a row slice of a bigger operand)."""
    buf = torch.zeros(offset + packed.numel() + 16, dtype=torch.uint8, device=packed.device)
    view = buf[offset:offset + packed.numel()].view(packed.shape)
    view.copy_(packed)
    return view


def misaligned_rows(torch, mods, name, w, bits, wdeq, gen, flush, group):
    """The main path's packed operand ``w`` as views 1, 2 and 8 bytes past a
    16-byte boundary, M = 1: ``qmm`` must launch the byte-load QMM_CORE
    (QMM_GROUP_CORE grouped) once per call and no other kernel, within the
    1e-5 rule; offset 1 is timed. Returns (row, checking launches)."""
    core = mods["QMM_GROUP_CORE"] if group else mods["QMM_CORE"]
    ref_fn = mods["qmm_group_ref"] if group else mods["qmm_ref"]
    extra = (GROUP,) if group else ()
    k = w.k_dim
    n, kp = w.packed.shape
    x = torch.randn(1, k, generator=gen, device=torch.device("cuda"))
    launches, row = 0, None
    for offset in CODE_OFFSETS:
        view = mods["PackedWeights"](codes_at(torch, w.packed, offset), w.scale, bits, k,
                                     w.granularity)
        if mods["cuda_kernel"](view) is not core:
            raise AssertionError(f"{name} codes at offset {offset}: not routed to {core.entry}")
        before = [kk.launches for kk in mods["KERNELS"]]
        y = mods["qmm"](x, view)
        moved = {kk.entry: kk.launches - b for kk, b in zip(mods["KERNELS"], before)
                 if kk.launches != b}
        if moved != {core.entry: 1}:
            raise AssertionError(f"{name} codes at offset {offset}: launched {moved}")
        launches += 1
        want = ref_fn(x, view.packed, w.scale, bits, k, *extra)
        err = (y - want).abs()
        if not bool((err <= 1e-5 * want.abs() + 1e-5 * (x.abs() @ wdeq.abs().T)).all()):
            raise AssertionError(f"{name} codes at offset {offset}: max |Δ| "
                                 f"{float(err.max())} exceeds the tolerance")
        if offset == CODE_OFFSETS[0]:
            b_ms, b_by, bb_ms = bound_ms(1, n, k, kp, w.scale.shape[1] if group else None)
            row = {"shape": name, "bits": bits, "M": 1, "N": n, "K": k, "offset": offset,
                   "entry": core.entry, "max_abs_err": float(err.max()),
                   "ms": time_ms(torch, lambda: core(x, view.packed, w.scale, bits, k, *extra),
                                 20, flush),
                   "plain_ms": time_ms(torch, lambda: ref_fn(x, view.packed, w.scale, bits, k,
                                                             *extra), 5, flush),
                   "library_ms": time_ms(torch, lambda: torch.matmul(x, wdeq.T), 20, flush),
                   "bound_ms": b_ms, "bound_by": b_by, "bytes_bound_ms": bb_ms}
    print(f"[chip_smoke]   {core.entry} (codes off a 16-byte boundary, offsets "
          f"{', '.join(map(str, CODE_OFFSETS))}) {name} bits={bits} M=1: within the rule; "
          f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  bound "
          f"{row['bound_ms']:.4f} ms", flush=True)
    return row, launches


def expected_launches(res, n_iters):
    """14 qmm launches per iteration on the complex LOFAR path (R: 2, G: 4,
    µ₀ on the complex Gg: 4, acceptance: 2, trace: 2) plus 2 per backtracking
    step (a step runs while any row of the batch is still backtracking)."""
    bt = res.trace.backtracks
    steps = int(bt.sum()) if bt.ndim == 1 else int(bt.max(dim=1).values.sum())
    return 14 * n_iters + 2 * steps


def phase_lofar(torch, mods):
    QMM, recover_lofar, cs = mods["QMM"], mods["recover_lofar"], mods["LOFAR"]
    out = {}
    by_shape = collections.Counter()
    for batch in (0, 8):
        reset_counts(mods)
        m_p, r_p, _ = recover_lofar(cs, "packed", cs.bits_phi, cs.bits_y, 0, "fixed", batch,
                                  mods["device"])
        launches = QMM.launches
        others = {k.entry: k.launches for k in mods["KERNELS"] if k is not QMM and k.launches}
        by_shape.update(QMM.launches_by_shape)
        want = expected_launches(r_p, cs.n_iters)
        QMM.reset_counts()
        m_f, r_f, _ = recover_lofar(cs, "fake", cs.bits_phi, cs.bits_y, 0, "fixed", batch,
                                  mods["device"])
        fake_launches = QMM.launches
        dx = float(torch.linalg.vector_norm(r_p.x - r_f.x) / torch.linalg.vector_norm(r_f.x))
        key = "rel_error" if not batch else "rel_error_mean"
        d_rel = abs(m_p[key] - m_f[key])
        label = f"lofar batch={batch}" if batch else "lofar single"
        print(f"[chip_smoke]   {label}: packed {key}={m_p[key]:.4f} wall_s={m_p['wall_s']:.3f} | "
              f"fake-fixed {key}={m_f[key]:.4f} wall_s={m_f['wall_s']:.3f} | "
              f"|Δrel|={d_rel:.2e} ‖Δx‖/‖x‖={dx:.2e} | qmm launches {launches} "
              f"(predicted {want}, {launches / cs.n_iters:.2f} per iteration)", flush=True)
        if d_rel > 0.01 or (batch and abs(m_p["rel_error_max"] - m_f["rel_error_max"]) > 0.01):
            raise AssertionError(f"{label}: packed and fake-fixed rel_error differ by {d_rel}")
        if not dx <= 1e-3:
            raise AssertionError(f"{label}: ‖Δx‖/‖x‖ = {dx} between packed and fake-fixed "
                                 "exceeds 1e-3")
        if launches == 0 or launches != want:
            raise AssertionError(f"{label}: {launches} qmm launches, predicted {want}")
        if others:
            raise AssertionError(f"{label}: the per_tensor topk path launched {others}")
        if fake_launches:
            raise AssertionError(f"{label}: the fake-fixed path launched qmm {fake_launches} times")
        out[label] = {"packed": m_p, "fake_fixed": m_f, "dx_rel": dx, "launches": launches,
                      "launches_predicted": want,
                      "backtracks": int(r_p.trace.backtracks.sum())}
    n_pix = cs.resolution ** 2
    n_vis = cs.n_antennas * (cs.n_antennas - 1)
    out["launches_by_orientation"] = {"lofar_fwd": by_shape[(n_vis, n_pix)],
                                      "lofar_adj": by_shape[(n_pix, n_vis)]}
    m_d, _, _ = recover_lofar(cs, "dense", None, None, 0, "fixed", 0, mods["device"])
    print(f"[chip_smoke]   lofar single 32-bit dense NIHT: rel_error={m_d['rel_error']:.4f} "
          f"source_recovery={m_d['source_recovery']:.3f} wall_s={m_d['wall_s']:.3f}", flush=True)
    out["lofar single dense"] = m_d
    out["saved"] = [save_lofar(torch, mods, c, with_phi) for c, with_phi in
                    ((cs, False), (mods["LOFAR_BENCH"], True))]
    return out


def save_lofar(torch, mods, cs, with_phi):
    """One sky of ``cs`` solved dense, fake-fixed and packed, saved with its
    y (and Φ when ``with_phi``) for ``scripts/reference_replay.py lofar``."""
    import numpy as np

    dev = torch.device(mods["device"])
    phi, y, x_true = mods["lofar_instance"](cs, 0, 0, dev)
    config = cs.name.replace("lofar-cs302", "lofar")        # the name recover takes
    saved = {"config": config,
             "y": y.cpu().numpy(), "x_true": x_true.cpu().numpy(), "bits_phi": cs.bits_phi,
             "bits_y": cs.bits_y, "seed": 0}
    if with_phi:
        saved["phi"] = phi.cpu().numpy()
    del phi
    rel = {}
    for backend, name in (("dense", "dense"), ("fake", "fake_fixed"), ("packed", "packed")):
        m, r, xt = mods["recover_lofar"](cs, backend, cs.bits_phi, cs.bits_y, 0, "fixed", 0, dev)
        if not torch.equal(xt, x_true):
            raise AssertionError("recover_lofar drew another sky than the saved one")
        saved[f"x_{name}"] = r.x.real.cpu().numpy()
        rel[name] = m["rel_error"]
    path = mods["out_dir"] / f"{config.replace('-', '_')}_single.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **saved)
    print(f"[chip_smoke]   {cs.name} single, saved to {path.name}: rel_error "
          + " ".join(f"{k}={v:.4f}" for k, v in rel.items()), flush=True)
    return {"config": cs.name, "file": path.name, "rel_error": rel}


def split_iteration(torch, tp, tf, b):
    """Where row b of two solves parts: the first iteration at which the two
    take a different discrete decision (backtracks, support change) or their
    quantized residual ‖ŷ − Φ̂x‖ (the cost NIHT minimizes) differs by more than
    1e-3; and the largest residual difference before it. Trajectories whose
    residuals agree to rounding (≤ 1e-4) up to that iteration have split at a
    decision taken the other way on a knife edge, not drifted apart through a
    wrong product. (The step size µ = ‖g_Γ‖²/‖Φ̂g_Γ‖² is not compared: once x
    sits at the least-squares point of its support, g_Γ is rounding noise and
    so is µ.)"""
    rq = ((tp.resid_q[:, b] - tf.resid_q[:, b]).abs()
          / tf.resid_q[:, b].abs().clamp_min(1e-30))
    parted = ((tp.backtracks[:, b] != tf.backtracks[:, b])
              | (tp.support_changed[:, b] != tf.support_changed[:, b]) | (rq > 1e-3))
    where = torch.nonzero(parted).flatten()
    if where.numel() == 0:
        return None, float(rq.max())
    t = int(where[0])
    return t, float(rq[:t].max()) if t else 0.0


@contextlib.contextmanager
def stand_in(module, **plain):
    """The path with plain versions standing in for kernel wrappers of
    ``module`` on CUDA tensors (a witness: the same code path with the plain
    version's arithmetic in place of the kernel's)."""
    kernels = {name: getattr(module, name) for name in plain}
    for name, fn in plain.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for name, fn in kernels.items():
            setattr(module, name, fn)


def row_dx(torch, a, b):
    return (torch.linalg.vector_norm(a - b, dim=1) / torch.linalg.vector_norm(b, dim=1)).tolist()


def phase_gaussian(torch, mods):
    """Packed vs fake-fixed on the Gaussian toy, batch 8, bits 4 and 8.

    The batch-level ‖Δx‖ ≤ 1e-3·‖x‖ is reported, met or not. What is required
    of each row b: ‖Δx_b‖ ≤ 1e-3·‖x_b‖, or a split at a knife-edge decision
    (trajectories that agree to ≤ 1e-4 in ‖ŷ − Φ̂x‖ until one iteration, see
    split_iteration) after which the row's rel_error stays within 0.01 of
    fake-fixed's. Witness: the same packed solves with ``qmm_ref`` in place
    of the kernel, compared with fake-fixed the same way. The instance and
    all three answers go to ``gaussian_batch8.npz`` for a replay through the
    reference (``scripts/reference_replay.py``)."""
    import numpy as np

    QMM, recover_gaussian, g = mods["QMM"], mods["recover_gaussian"], mods["GAUSS"]
    dev = torch.device(mods["device"])
    phi, Y, X_true = mods["gaussian_batch_instance"](g, 0, 8, dev)
    saved = {"phi": phi.cpu().numpy(), "Y": Y.cpu().numpy(), "X_true": X_true.cpu().numpy()}
    out = {}
    for bits in (4, 8):
        reset_counts(mods)
        m_p, r_p, xt = recover_gaussian(g, "packed", bits, 8, 0, "fixed", 8, dev)
        launches = QMM.launches
        m_f, r_f, _ = recover_gaussian(g, "fake", bits, 8, 0, "fixed", 8, dev)
        with stand_in(mods["qmm_ops"], qmm_cuda=mods["qmm_ref"]):
            reset_counts(mods)
            m_r, r_r, _ = recover_gaussian(g, "packed", bits, 8, 0, "fixed", 8, dev)
            if QMM.launches:
                raise AssertionError("the witness run launched the kernel")
        if not torch.equal(xt, X_true):
            raise AssertionError("recover_gaussian drew another instance than the saved one")
        dx = float(torch.linalg.vector_norm(r_p.x - r_f.x) / torch.linalg.vector_norm(r_f.x))
        dx_w = float(torch.linalg.vector_norm(r_r.x - r_f.x) / torch.linalg.vector_norm(r_f.x))
        rows, rows_w = row_dx(torch, r_p.x, r_f.x), row_dx(torch, r_r.x, r_f.x)
        rel = {k: row_dx(torch, r.x, X_true) for k, r in
               (("kernel", r_p), ("plain", r_r), ("fake", r_f))}
        batch_gate = dx <= 1e-3
        print(f"[chip_smoke]   gaussian bits={bits} batch=8: packed rel_error_mean="
              f"{m_p['rel_error_mean']:.4f} wall_s={m_p['wall_s']:.3f} | fake-fixed "
              f"{m_f['rel_error_mean']:.4f} wall_s={m_f['wall_s']:.3f} | ‖Δx‖/‖x‖={dx:.2e} "
              f"(batch-level 1e-3 {'met' if batch_gate else 'NOT met'}) | witness (qmm_ref "
              f"packed) vs fake-fixed ‖Δx‖/‖x‖={dx_w:.2e} | qmm launches {launches}", flush=True)
        splits = {}
        for b in range(len(rows)):
            if rows[b] <= 1e-3 and rows_w[b] <= 1e-3:
                continue
            t, before = split_iteration(torch, r_p.trace, r_f.trace, b)
            t_w, before_w = split_iteration(torch, r_r.trace, r_f.trace, b)
            d_rel = abs(rel["kernel"][b] - rel["fake"][b])
            print(f"[chip_smoke]     row {b}: kernel ‖Δx_b‖/‖x_b‖={rows[b]:.2e} (agree to "
                  f"{before:.1e} in ‖ŷ − Φ̂x‖ until iteration {t}); witness {rows_w[b]:.2e} "
                  f"(agree to {before_w:.1e} until iteration {t_w}); rel_error kernel "
                  f"{rel['kernel'][b]:.4f} plain {rel['plain'][b]:.4f} fake "
                  f"{rel['fake'][b]:.4f}", flush=True)
            splits[b] = {"dx_rel": rows[b], "split_iteration": t, "agree_before": before,
                         "witness_dx_rel": rows_w[b], "witness_split_iteration": t_w,
                         "witness_agree_before": before_w,
                         "rel_error": {k: v[b] for k, v in rel.items()}}
            if rows[b] <= 1e-3:
                continue
            if t is None or before > 1e-4:
                raise AssertionError(f"gaussian bits={bits} row {b}: ‖Δx_b‖/‖x_b‖ = {rows[b]} "
                                     "> 1e-3 without a split at a discrete decision")
            if d_rel > 0.01:
                raise AssertionError(f"gaussian bits={bits} row {b}: rel_error differs from "
                                     f"fake-fixed's by {d_rel} > 0.01 after the split")
        if launches == 0:
            raise AssertionError(f"gaussian bits={bits}: the kernel was never launched")
        for k, r in (("kernel", r_p), ("plain", r_r), ("fake", r_f)):
            saved[f"x_{k}_bits{bits}"] = r.x.cpu().numpy()
        out[f"bits={bits}"] = {"packed": m_p, "fake_fixed": m_f, "witness": m_r, "dx_rel": dx,
                               "batch_gate_met": batch_gate, "witness_dx_rel": dx_w,
                               "dx_rows": rows, "witness_dx_rows": rows_w, "rel_error_rows": rel,
                               "splits": splits, "launches": launches}
    out_dir = mods["out_dir"]
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(out_dir / "gaussian_batch8.npz", s=g.s, n_iters=g.n_iters, bits_y=8, seed=0,
             **saved)
    return out


def phase_profile(torch, mods):
    """Device time by kernel and the device's busy share over one packed
    single-row LOFAR solve on each path: per_tensor topk, per_block (g = 64),
    hsthresh, and hsthresh with the two-kernel chain standing in
    (torch.profiler, CUPTI), beside the set-up alone (a 0-iteration solve: ŷ
    draw, Φ̂ quantize and pack). On the hsthresh paths each H_s call runs in
    a profiler range "H_s", whose span on the device timeline (its kernels
    and the gaps between them) is reported beside the kernels' own device
    time; device launches are counted per proposal. Reports "not measured"
    when the profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cs, dev = mods["LOFAR"], torch.device(mods["device"])
    gen = torch.Generator().manual_seed(0)
    phi = mods["measurement_matrix"](mods["Station"](n_antennas=cs.n_antennas, seed=cs.seed),
                                     cs.resolution, cs.extent, device=dev)
    x = mods["make_sky"](cs.resolution, cs.n_sources, gen, min_sep=cs.min_sep, device=dev)
    y, _ = mods["visibilities"](phi, x, cs.snr_db, gen)
    base = dict(bits_phi=cs.bits_phi, bits_y=cs.bits_y, key=mods["prng"].PRNGKey(0),
                requantize="fixed", backend="packed", real_signal=True, nonneg=True)
    out_dir = mods["out_dir"]
    out_dir.mkdir(parents=True, exist_ok=True)
    out = {}
    fused = mods["hs_ops"].hsthresh_cuda

    def h_s(hs):
        """hs inside a profiler range named "H_s", so that the trace sums the
        device time of the kernels it launches."""
        def call(x, s, nbins):
            with torch.profiler.record_function("H_s"):
                return hs(x, s, nbins)
        return call
    for path, extra, trace in (
            ("per_tensor", {}, "lofar_packed_trace.json"),
            ("per_block", dict(scale_granularity="per_block", group_size=GROUP),
             "lofar_per_block_trace.json"),
            ("hsthresh", dict(threshold="hsthresh"), "lofar_hsthresh_trace.json"),
            ("hsthresh_chain", dict(threshold="hsthresh"), "lofar_hsthresh_chain_trace.json")):
        kw = {**base, **extra}
        with contextlib.ExitStack() as stack:
            if path.startswith("hsthresh"):
                hs = fused if path == "hsthresh" else (
                    lambda x, s, nbins: hs_chain(mods, x, s, nbins))
                stack.enter_context(stand_in(mods["hs_ops"], hsthresh_cuda=h_s(hs)))
            mods["qniht"](phi, y, cs.n_sources, 2, **kw)      # warm-up (allocator, kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mods["qniht"](phi, y, cs.n_sources, 0, **kw)      # the set-up alone
            torch.cuda.synchronize()
            setup_ms = (time.perf_counter() - t0) * 1e3
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                res = mods["qniht"](phi, y, cs.n_sources, cs.n_iters, **kw)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        proposals = cs.n_iters + backtrack_steps(res)
        h_s_ms = None
        rows = []
        for ev in prof.key_averages():
            if getattr(ev, "device_type", None) != DeviceType.CUDA:
                continue                                  # host-side op rows repeat the time
            if ev.key == "H_s":
                # the range on the device timeline: from the first kernel an
                # H_s call launches to the end of its last, gaps included
                h_s_ms = (getattr(ev, "device_time_total", 0) or 0) / 1e3 or None
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0)
            if us > 0 or ev.count:
                rows.append({"name": ev.key, "device_ms": us / 1e3, "calls": ev.count})
        rows.sort(key=lambda r: -r["device_ms"])
        busy_ms = sum(r["device_ms"] for r in rows)
        device_launches = sum(r["calls"] for r in rows)
        prof.export_chrome_trace(str(out_dir / trace))
        if not rows:
            print(f"[chip_smoke]   profile {path}: no device time seen (not measured)",
                  flush=True)
            out[path] = {"wall_ms": wall_ms, "setup_ms": setup_ms, "device_busy_ms": None,
                         "proposals": proposals, "kernels": []}
            continue
        ours = {name: sum(r["device_ms"] for r in rows if f"{name}_kernel" in r["name"])
                for name in ("qmm_wgmma", "qmm", "hist", "mask", "hsthresh")}
        calls = {name: sum(r["calls"] for r in rows if f"{name}_kernel" in r["name"])
                 for name in ("qmm_wgmma", "qmm", "hsthresh")}
        print(f"[chip_smoke]   profile of one packed LOFAR solve, {path}: wall {wall_ms:.1f} ms "
              f"(set-up alone {setup_ms:.1f} ms), device busy {busy_ms:.1f} ms "
              f"({100 * busy_ms / wall_ms:.1f}%), qmm_wgmma_kernel {ours['qmm_wgmma']:.1f} ms "
              f"({calls['qmm_wgmma']}×), CUDA-core qmm_kernel {ours['qmm']:.1f} ms "
              f"({calls['qmm']}×), hsthresh_kernel {ours['hsthresh']:.2f} ms "
              f"({calls['hsthresh']}×), hist {ours['hist']:.2f} ms, mask {ours['mask']:.2f} ms; "
              f"{device_launches} device launches, {proposals} proposals "
              f"({device_launches / proposals:.1f} per proposal); H_s calls' span on the "
              f"device timeline {'not measured' if h_s_ms is None else f'{h_s_ms:.2f} ms'}",
              flush=True)
        for r in rows[:10]:
            print(f"[chip_smoke]     {r['device_ms']:9.3f} ms  {r['calls']:6d}×  "
                  f"{r['name'][:90]}", flush=True)
        out[path] = {"wall_ms": wall_ms, "setup_ms": setup_ms, "device_busy_ms": busy_ms,
                     "qmm_wgmma_device_ms": ours["qmm_wgmma"],
                     "qmm_wgmma_calls": calls["qmm_wgmma"],
                     "qmm_core_device_ms": ours["qmm"], "hist_device_ms": ours["hist"],
                     "mask_device_ms": ours["mask"], "hsthresh_device_ms": ours["hsthresh"],
                     "hsthresh_calls": calls["hsthresh"], "h_s_span_ms": h_s_ms,
                     "device_launches": device_launches, "proposals": proposals,
                     "kernels": rows[:40]}
    return out


def phase_group_kernel(torch, mods):
    """qmm_group against qmm_group_ref at the per_block LOFAR shapes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    dev = torch.device("cuda")
    QG, ref_fn, prng = mods["QMM_GROUP"], mods["qmm_group_ref"], mods["prng"]
    unpack_codes, expand = mods["unpack_codes"], mods["expand_block_scale"]
    cs = mods["LOFAR"]
    phi = mods["measurement_matrix"](mods["Station"](n_antennas=cs.n_antennas, seed=cs.seed),
                                     cs.resolution, cs.extent, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gran = f"per_block:{GROUP}"
    rows, max_err, core_rows, mis_rows, mis_launches = [], 0.0, [], [], 0
    for bits in (2, 4, 8):
        # the main path's own per-orientation quantization of Φ
        op = mods["pack_operator"](phi, bits, prng.fold_in(prng.PRNGKey(0), 0), shared=False,
                                   granularity=gran)
        ragged = mods["pack_weights"](torch.randn(333, 1001, generator=gen, device=dev), bits,
                                      prng.PRNGKey(bits), granularity=gran)
        cases = [("lofar_fwd", op.fwd_re, M_VALUES), ("lofar_adj", op.adj_re, M_VALUES),
                 ("ragged", ragged, (5,))]
        for name, w, ms in cases:
            k = w.k_dim
            n, kp = w.packed.shape
            n_groups = w.scale.shape[1]
            wdeq = (unpack_codes(w.packed, bits, k).to(torch.float32)
                    * expand(w.scale, GROUP, k) / (2 ** (bits - 1) // 2))
            for m in ms:
                x = torch.randn(m, k, generator=gen, device=dev)
                if mods["cuda_kernel"](w) is not QG or QG.library.source.name != "qmm_wgmma.cu":
                    raise AssertionError(f"qmm_group {name}: not routed to QMM_GROUP")
                before = QG.launches
                y = mods["qmm"](x, w)
                if QG.launches != before + 1:
                    raise AssertionError(f"qmm_group {name} bits={bits} M={m}: QMM_GROUP was "
                                         "not launched")
                ref = ref_fn(x, w.packed, w.scale, bits, k, GROUP)
                torch.cuda.synchronize()
                tol = 1e-5 * ref.abs() + 1e-5 * (x.abs() @ wdeq.abs().T)
                err = (y - ref).abs()
                if not bool((err <= tol).all()):
                    raise AssertionError(f"qmm_group {name} bits={bits} M={m}: max |Δ| "
                                         f"{float(err.max())} exceeds the tolerance")
                max_err = max(max_err, float(err.max()))
                b_ms, b_by, bb_ms = bound_ms(m, n, k, kp, n_groups)
                row = {"shape": name, "bits": bits, "M": m, "N": n, "K": k, "G": n_groups,
                       "max_abs_err": float(err.max()),
                       "ms": time_ms(torch, lambda: QG(x, w.packed, w.scale, bits, k, GROUP),
                                     20, flush),
                       "plain_ms": time_ms(torch, lambda: ref_fn(x, w.packed, w.scale, bits, k,
                                                                 GROUP), 5, flush),
                       "library_ms": time_ms(torch, lambda: torch.matmul(x, wdeq.T), 20, flush),
                       "bound_ms": b_ms, "bound_by": b_by, "bytes_bound_ms": bb_ms,
                       "device_ms": (device_ms(torch, lambda: QG(x, w.packed, w.scale, bits, k,
                                                                 GROUP),
                                               20, flush, "qmm_wgmma_kernel")
                                     if name != "ragged" and bits == cs.bits_phi else None)}
                rows.append(row)
                print(f"[chip_smoke]   qmm_group {name:9s} bits={bits} M={m:2d}: "
                      f"max|Δ|={row['max_abs_err']:.3g} kernel {row['ms']:.4f} ms  plain "
                      f"{row['plain_ms']:.4f} ms  matmul(f32 Φ̂) {row['library_ms']:.4f} ms  "
                      f"bound {b_ms:.4f} ms ({b_by}), bytes alone {bb_ms:.4f} ms, device "
                      f"(profiler) {row['device_ms']}", flush=True)
            if name != "ragged" and bits == cs.bits_phi:
                mrow, n_launch = misaligned_rows(torch, mods, name, w, bits, wdeq, gen, flush,
                                                 group=True)
                mis_rows.append(mrow)
                mis_launches += n_launch
            del wdeq
        del op
        # the CUDA-core route: g = 8 is no multiple of 16 (8 // bits divides it)
        core, g_core = mods["QMM_GROUP_CORE"], 8
        w = mods["pack_weights"](torch.randn(333, 1001, generator=gen, device=dev), bits,
                                 prng.PRNGKey(bits), granularity=f"per_block:{g_core}")
        x = torch.randn(5, 1001, generator=gen, device=dev)
        if mods["cuda_kernel"](w) is not core or core.library.source.name != "qmm.cu":
            raise AssertionError(f"g = {g_core} is not routed to the CUDA-core QMM_GROUP_CORE")
        before = (QG.launches, core.launches)
        y = mods["qmm"](x, w)
        if (QG.launches, core.launches) != (before[0], before[1] + 1):
            raise AssertionError(f"g = {g_core}: launched QMM_GROUP {QG.launches - before[0]}, "
                                 f"QMM_GROUP_CORE {core.launches - before[1]} times")
        ref = ref_fn(x, w.packed, w.scale, bits, 1001, g_core)
        wdeq = (unpack_codes(w.packed, bits, 1001).to(torch.float32)
                * expand(w.scale, g_core, 1001) / (2 ** (bits - 1) // 2))
        err = (y - ref).abs()
        if not bool((err <= 1e-5 * ref.abs() + 1e-5 * (x.abs() @ wdeq.abs().T)).all()):
            raise AssertionError(f"qmm_group core g={g_core} bits={bits}: max |Δ| "
                                 f"{float(err.max())} exceeds the tolerance")
        n, kp = w.packed.shape
        b_ms, b_by, bb_ms = bound_ms(5, n, 1001, kp, w.scale.shape[1])
        core_rows.append({"shape": "ragged", "bits": bits, "M": 5, "N": n, "K": 1001,
                          "G": w.scale.shape[1], "g": g_core, "max_abs_err": float(err.max()),
                          "ms": time_ms(torch, lambda: mods["qmm"](x, w), 20, flush),
                          "plain_ms": time_ms(torch, lambda: ref_fn(x, w.packed, w.scale, bits,
                                                                    1001, g_core), 5, flush),
                          "library_ms": time_ms(torch, lambda: torch.matmul(x, wdeq.T), 20, flush),
                          "bound_ms": b_ms, "bound_by": b_by, "bytes_bound_ms": bb_ms})
        print(f"[chip_smoke]   qmm_group (CUDA-core route) ragged bits={bits} g={g_core}: "
              f"max|Δ|={core_rows[-1]['max_abs_err']:.3g} kernel {core_rows[-1]['ms']:.4f} ms",
              flush=True)
    del phi, flush
    torch.cuda.empty_cache()
    exact = exact_checks(torch, mods, group=True)
    edges = edge_checks(torch, mods, group=True)
    return {"rows": rows, "max_abs_err": max_err, "group_size": GROUP, "entry": QG.entry,
            "source": QG.library.source.name, "exact": exact, "core_rows": core_rows,
            "edges": edges, "misaligned_rows": mis_rows, "misaligned_launches": mis_launches}


def phase_hs_kernels(torch, mods):
    """hist and mask against their plain versions, bit for bit."""
    dev = torch.device("cuda")
    HIST, MASK = mods["HIST"], mods["MASK"]
    ref = mods["hsthresh_ref_mod"]
    gen = torch.Generator(device=dev).manual_seed(3)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows, launches = [], {"hist": 0, "mask": 0}
    for b, n in HS_SHAPES:
        # a projected gradient step's shape of data: nonnegative, half zeros
        x = torch.clamp_min(torch.randn(b, n, generator=gen, device=dev), 0.0)
        vmax = ref.row_vmax(x.abs())
        before = (HIST.launches, MASK.launches)
        h = HIST(x, vmax, NBINS)
        h_ref = ref.hist_ref(x.abs(), vmax, NBINS)
        t = ref.select_threshold(h, vmax, HS_S)
        y, y_ref = MASK(x, t), ref.mask_ref(x, t)
        launches["hist"] += HIST.launches - before[0]
        launches["mask"] += MASK.launches - before[1]
        torch.cuda.synchronize()
        if not torch.equal(h, h_ref):
            raise AssertionError(f"hist ({b}, {n}): differs from hist_ref in "
                                 f"{int((h != h_ref).sum())} bins")
        if not torch.equal(y, y_ref):
            raise AssertionError(f"mask ({b}, {n}): differs from mask_ref")
        hist_bytes = 4 * b * n + 4 * b + 4 * b * NBINS
        mask_bytes = 8 * b * n + 4 * b
        for name, kernel, plain, nbytes in (
                ("hist", lambda: HIST(x, vmax, NBINS), lambda: ref.hist_ref(x.abs(), vmax, NBINS),
                 hist_bytes),
                ("mask", lambda: MASK(x, t), lambda: ref.mask_ref(x, t), mask_bytes)):
            row = {"name": name, "B": b, "N": n, "max_abs_err": 0.0,
                   "ms": time_ms(torch, kernel, 50, flush),
                   "plain_ms": time_ms(torch, plain, 20, flush),
                   "library_ms": None,
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
            rows.append(row)
            print(f"[chip_smoke]   {name} B={b} N={n}: bitwise equal; kernel {row['ms']:.4f} ms "
                  f" plain {row['plain_ms']:.4f} ms  bound {row['bound_ms']:.5f} ms (bytes); "
                  "no single PyTorch call computes it", flush=True)
    del flush
    return {"rows": rows, "launches": launches}


def hs_chain(mods, x, s, nbins):
    """The H_s as the two-kernel chain computes it on the card: the plain
    vmax, the ``hist`` kernel, the plain pick, the ``mask`` kernel and the
    plain tie fill, some 35 device launches per call (the fused kernel's
    predecessor on the solver path, kept here as its yardstick)."""
    ref = mods["hsthresh_ref_mod"]
    vmax = ref.row_vmax(x.abs())
    h = mods["HIST"](x, vmax, nbins)
    t = ref.select_threshold(h, vmax, s)
    y = mods["MASK"](x, t)
    return ref.fill_threshold_bin(x, y, t, vmax / nbins, s)


def profile_calls(torch, fn, reps):
    """Device time (ms) and device launches (kernels, memsets, copies) per
    call of fn, from torch.profiler over reps warm calls; (None, None) when
    the profiler sees no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA]
    us = sum(getattr(e, "self_device_time_total", 0) or 0 for e in evs)
    count = sum(e.count for e in evs)
    return (us / reps / 1e3, count / reps) if count else (None, None)


def phase_fused_hs(torch, mods):
    """The fused H_s against hsthresh_ref, bit for bit, one launch per call;
    timed beside the two-kernel chain it replaces and the plain version."""
    dev = torch.device("cuda")
    HS, ref = mods["HSTHRESH"], mods["hsthresh_ref_mod"]
    gen = torch.Generator(device=dev).manual_seed(13)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows, launches = [], 0
    for b, n in HS_SHAPES:
        x = torch.clamp_min(torch.randn(b, n, generator=gen, device=dev), 0.0)
        # threshold-bin ties straddling the cluster's chunk edges (8,192 apart)
        ties = torch.randn(b, n, generator=gen, device=dev) * 0.1
        for edge in range(0, n, 8192):
            ties[:, max(0, edge - 6):edge + 6] = 1.0
        for label, inp in (("", x), (" ties across chunk edges", ties)):
            before = [k.launches for k in mods["KERNELS"]]
            y = mods["hsthresh_cuda"](inp, HS_S, NBINS)
            moved = {k.entry: k.launches - c for k, c in zip(mods["KERNELS"], before)
                     if k.launches != c}
            if moved != {HS.entry: 1}:
                raise AssertionError(f"fused H_s ({b}, {n}){label}: launched {moved}")
            launches += 1
            want = ref.hsthresh_ref(inp, HS_S, NBINS)
            if not torch.equal(y, want) or not torch.equal(y, hs_chain(mods, inp, HS_S, NBINS)):
                raise AssertionError(f"fused H_s ({b}, {n}){label}: differs from hsthresh_ref "
                                     f"in {int((y != want).sum())} places")
        row = {"name": "hsthresh", "B": b, "N": n, "s": HS_S, "nbins": NBINS, "max_abs_err": 0.0,
               "ms": time_ms(torch, lambda: mods["hsthresh_cuda"](x, HS_S, NBINS), 50, flush),
               "chain_ms": time_ms(torch, lambda: hs_chain(mods, x, HS_S, NBINS), 50, flush),
               "plain_ms": time_ms(torch, lambda: ref.hsthresh_ref(x, HS_S, NBINS), 20, flush),
               "library_ms": None,
               "bound_ms": 8 * b * n / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
               "device_ms": device_ms(torch, lambda: mods["hsthresh_cuda"](x, HS_S, NBINS), 50,
                                      flush, "hsthresh_kernel")}
        row["device_ms_warm"], row["device_launches"] = profile_calls(
            torch, lambda: mods["hsthresh_cuda"](x, HS_S, NBINS), 50)
        row["chain_device_ms_warm"], row["chain_device_launches"] = profile_calls(
            torch, lambda: hs_chain(mods, x, HS_S, NBINS), 50)
        rows.append(row)
        print(f"[chip_smoke]   fused H_s B={b} N={n} s={HS_S}: bitwise equal (and on ties across "
              f"chunk edges); kernel {row['ms']:.4f} ms (device {row['device_ms']}, warm "
              f"{row['device_ms_warm']}; {row['device_launches']} device launches per call) | "
              f"two-kernel chain {row['chain_ms']:.4f} ms (device warm "
              f"{row['chain_device_ms_warm']}; {row['chain_device_launches']} launches per "
              f"call) | plain {row['plain_ms']:.4f} ms | bound {row['bound_ms']:.5f} ms (bytes)",
              flush=True)
    del flush
    return {"rows": rows, "launches": launches}


def as_batch(res):
    """An IHTResult of qniht as a batch of one row (x (1, N), trace (T, 1))."""
    if res.x.ndim == 2:
        return res
    return type(res)(x=res.x[None], trace=type(res.trace)(*(t[:, None] for t in res.trace)))


def backtrack_steps(res):
    """Backtracking steps the batch took: Σ_i max_b n_bt[i, b]."""
    bt = as_batch(res).trace.backtracks
    return int(bt.max(dim=1).values.sum())


def hold_rows(torch, label, r_k, r_w, x_true):
    """Per row b: ‖Δx_b‖ ≤ 1e-3‖x_b‖ between kernel and witness, or a split at
    a knife-edge decision after trajectories that agreed to ≤ 1e-4 in
    ‖ŷ − Φ̂x‖, with rel_error within 0.01. Returns the readings."""
    r_k, r_w = as_batch(r_k), as_batch(r_w)
    x_true = x_true if x_true.ndim == 2 else x_true[None]
    rows = row_dx(torch, r_k.x, r_w.x)
    rel_k, rel_w = row_dx(torch, r_k.x, x_true), row_dx(torch, r_w.x, x_true)
    splits = {}
    for b, dx in enumerate(rows):
        if dx <= 1e-3:
            continue
        t, before = split_iteration(torch, r_k.trace, r_w.trace, b)
        d_rel = abs(rel_k[b] - rel_w[b])
        print(f"[chip_smoke]     {label} row {b}: ‖Δx_b‖/‖x_b‖={dx:.2e} (agree to {before:.1e} "
              f"in ‖ŷ − Φ̂x‖ until iteration {t}); rel_error kernel {rel_k[b]:.4f} witness "
              f"{rel_w[b]:.4f}", flush=True)
        splits[b] = {"dx_rel": dx, "split_iteration": t, "agree_before": before,
                     "rel_error": [rel_k[b], rel_w[b]]}
        if t is None or before > 1e-4:
            raise AssertionError(f"{label} row {b}: ‖Δx_b‖/‖x_b‖ = {dx} > 1e-3 without a "
                                 "split at a discrete decision")
        if d_rel > 0.01:
            raise AssertionError(f"{label} row {b}: rel_error differs from the witness's by "
                                 f"{d_rel} > 0.01 after the split")
    return {"dx_rows": rows, "rel_error_rows": rel_k, "witness_rel_error_rows": rel_w,
            "splits": splits}


def phase_lofar_block(torch, mods, per_tensor):
    """LOFAR CS302 at full size with a per_block (g = 64) packed Φ̂ through
    qmm_group, held per row against the qmm_group_ref witness; one
    per_channel solve through qmm."""
    QMM, QG, cs = mods["QMM"], mods["QMM_GROUP"], mods["LOFAR"]
    recover_lofar, dev = mods["recover_lofar"], mods["device"]
    out = {}
    by_shape = collections.Counter()
    for batch in (0, 8):
        label = f"lofar per_block batch={batch}" if batch else "lofar per_block single"
        reset_counts(mods)
        m_k, r_k, x_true = recover_lofar(cs, "packed", cs.bits_phi, cs.bits_y, 0, "fixed", batch,
                                         dev, "per_block", GROUP)
        launches, qmm_launches = QG.launches, QMM.launches
        by_shape.update(QG.launches_by_shape)
        others = {k.entry: k.launches for k in mods["KERNELS"] if k is not QG and k.launches}
        want = expected_launches(r_k, cs.n_iters)
        with stand_in(mods["qmm_ops"], qmm_group_cuda=mods["qmm_group_ref"]):
            reset_counts(mods)
            m_w, r_w, _ = recover_lofar(cs, "packed", cs.bits_phi, cs.bits_y, 0, "fixed", batch,
                                        dev, "per_block", GROUP)
            if QG.launches:
                raise AssertionError("the witness run launched the group kernel")
        key = "rel_error" if not batch else "rel_error_mean"
        key_pt = "lofar single" if not batch else "lofar batch=8"
        rel_pt = per_tensor[key_pt]["packed"][key] if per_tensor else float("nan")
        print(f"[chip_smoke]   {label}: {key}={m_k[key]:.4f} (per_tensor {rel_pt:.4f}) "
              f"wall_s={m_k['wall_s']:.3f} | witness (qmm_group_ref) {key}={m_w[key]:.4f} "
              f"wall_s={m_w['wall_s']:.3f} | qmm_group launches {launches} (predicted {want}), "
              f"qmm launches {qmm_launches}", flush=True)
        held = hold_rows(torch, label, r_k, r_w, x_true)
        print(f"[chip_smoke]     ‖Δx_b‖/‖x_b‖ kernel vs witness: "
              + " ".join(f"{v:.1e}" for v in held["dx_rows"]), flush=True)
        if launches == 0 or launches != want:
            raise AssertionError(f"{label}: {launches} qmm_group launches, predicted {want}")
        if qmm_launches or others:
            raise AssertionError(f"{label}: the per_block path launched qmm {qmm_launches} "
                                 f"times and {others}")
        out[label] = {"kernel": m_k, "witness": m_w, "launches": launches,
                      "launches_predicted": want, "per_tensor_rel_error": rel_pt, **held}
    n_pix, n_vis = cs.resolution ** 2, cs.n_antennas * (cs.n_antennas - 1)
    out["launches_by_orientation"] = {"lofar_fwd": by_shape[(n_vis, n_pix)],
                                      "lofar_adj": by_shape[(n_pix, n_vis)]}
    reset_counts(mods)
    m_c, r_c, _ = recover_lofar(cs, "packed", cs.bits_phi, cs.bits_y, 0, "fixed", 0, dev,
                                "per_channel")
    want = expected_launches(r_c, cs.n_iters)
    print(f"[chip_smoke]   lofar per_channel single: rel_error={m_c['rel_error']:.4f} "
          f"wall_s={m_c['wall_s']:.3f} | qmm launches {QMM.launches} (predicted {want}), "
          f"qmm_group {QG.launches}", flush=True)
    if QMM.launches != want or QG.launches:
        raise AssertionError(f"lofar per_channel: {QMM.launches} qmm launches (predicted "
                             f"{want}), {QG.launches} qmm_group launches")
    out["lofar per_channel single"] = {"packed": m_c, "launches": QMM.launches}
    out["saved"] = [save_lofar_block(torch, mods, c, with_phi) for c, with_phi in
                    ((cs, False), (mods["LOFAR_BENCH"], True))]
    return out


def save_lofar_block(torch, mods, cs, with_phi):
    """One sky of ``cs`` solved packed per_block (g = 64), saved with y (and Φ
    when ``with_phi``) for ``scripts/reference_replay.py lofar-block``."""
    import numpy as np

    dev = torch.device(mods["device"])
    phi, y, x_true = mods["lofar_instance"](cs, 0, 0, dev)
    config = cs.name.replace("lofar-cs302", "lofar")        # the name recover takes
    saved = {"config": config, "y": y.cpu().numpy(), "x_true": x_true.cpu().numpy(),
             "bits_phi": cs.bits_phi, "bits_y": cs.bits_y, "seed": 0, "group_size": GROUP}
    if with_phi:
        saved["phi"] = phi.cpu().numpy()
    del phi
    m, r, xt = mods["recover_lofar"](cs, "packed", cs.bits_phi, cs.bits_y, 0, "fixed", 0, dev,
                                     "per_block", GROUP)
    if not torch.equal(xt, x_true):
        raise AssertionError("recover_lofar drew another sky than the saved one")
    saved["x_packed"] = r.x.real.cpu().numpy()
    path = mods["out_dir"] / f"{config.replace('-', '_')}_block.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **saved)
    print(f"[chip_smoke]   {cs.name} per_block single, saved to {path.name}: rel_error="
          f"{m['rel_error']:.4f}", flush=True)
    return {"config": cs.name, "file": path.name, "rel_error": m["rel_error"]}


def support_trajectory(torch, mods, phi, Y, threshold):
    """The support after each iteration of a packed per_tensor LOFAR solve
    (n_iters, B, N), through the solver's own set-up and iteration."""
    cs = mods["LOFAR"]
    X, iteration = mods["solver_setup"](
        phi, Y, cs.n_sources, cs.bits_phi, cs.bits_y, mods["prng"].PRNGKey(0), "fixed",
        "packed", threshold, 0.01, 2.0, 30, True, True, False)
    supports = []
    for i in range(cs.n_iters):
        X, _ = iteration(X, i)
        supports.append(X != 0)
    return torch.stack(supports), X


def phase_lofar_hsthresh(torch, mods):
    """LOFAR CS302 at full size with threshold="hsthresh", per_tensor packed,
    through qniht/qniht_batch: the fused H_s launches once per proposal and
    hist and mask never; the same solves with the plain version standing in
    on the card must give the same x and trace bit for bit. The single
    solve's wall is taken five times beside the two-kernel chain's."""
    HIST, MASK, QMM, cs = mods["HIST"], mods["MASK"], mods["QMM"], mods["LOFAR"]
    HS = mods["HSTHRESH"]
    dev = torch.device(mods["device"])
    ref = mods["hsthresh_ref_mod"]
    kw = dict(bits_phi=cs.bits_phi, bits_y=cs.bits_y, key=mods["prng"].PRNGKey(0),
              requantize="fixed", backend="packed", real_signal=True, nonneg=True,
              threshold="hsthresh")
    out = {}
    by_shape = collections.Counter()
    for batch in (0, 8):
        label = f"lofar hsthresh batch={batch}" if batch else "lofar hsthresh single"
        phi, y, x_true = mods["lofar_instance"](cs, 0, batch, dev)
        solve = mods["qniht_batch"] if batch else mods["qniht"]
        reset_counts(mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(phi, y, cs.n_sources, cs.n_iters, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"hsthresh": HS.launches, "hist": HIST.launches, "mask": MASK.launches,
                    "qmm": QMM.launches, "qmm_group": mods["QMM_GROUP"].launches}
        others = {k.entry: k.launches for k in mods["KERNELS"]
                  if k not in (HS, HIST, MASK, QMM, mods["QMM_GROUP"]) and k.launches}
        by_shape.update(HS.launches_by_shape)
        want_hs = cs.n_iters + backtrack_steps(res)
        want_qmm = expected_launches(res, cs.n_iters)
        with stand_in(mods["hs_ops"], hsthresh_cuda=ref.hsthresh_ref):
            reset_counts(mods)
            res_w = solve(phi, y, cs.n_sources, cs.n_iters, **kw)
            if HS.launches or HIST.launches or MASK.launches:
                raise AssertionError("the witness run launched an H_s kernel")
        same = torch.equal(res.x, res_w.x) and all(
            torch.equal(a, b) for a, b in zip(res.trace, res_w.trace))
        rel = row_dx(torch, as_batch(res).x, x_true if batch else x_true[None])
        Y = y if batch else y[None]
        sup_hs, x_hs = support_trajectory(torch, mods, phi, Y, "hsthresh")
        sup_top, x_top = support_trajectory(torch, mods, phi, Y, "topk")
        differ = (sup_hs != sup_top).any(dim=2)                # (n_iters, B)
        rel_top = row_dx(torch, x_top, x_true if batch else x_true[None])
        print(f"[chip_smoke]   {label}: rel_error {' '.join(f'{v:.4f}' for v in rel)} "
              f"(topk on the same codes {' '.join(f'{v:.4f}' for v in rel_top)}) wall_s="
              f"{wall:.3f} | fused H_s {launches['hsthresh']} launches (predicted {want_hs}), "
              f"hist {launches['hist']} mask {launches['mask']}, qmm {launches['qmm']} "
              f"(predicted {want_qmm}) | witness (hsthresh_ref on the card) "
              f"{'bitwise identical' if same else 'DIFFERS'} | iterations whose support "
              f"differs from topk: {int(differ.any(dim=1).sum())} of {cs.n_iters} (per row "
              f"{differ.sum(dim=0).tolist()})", flush=True)
        if not torch.equal(x_hs, res.x if batch else res.x[None]):
            raise AssertionError(f"{label}: the solver's own loop and qniht disagree")
        if not same:
            raise AssertionError(f"{label}: kernel and plain-version solves differ")
        if launches["hsthresh"] != want_hs or launches["hist"] or launches["mask"]:
            raise AssertionError(f"{label}: the fused H_s launched {launches['hsthresh']} times "
                                 f"(predicted {want_hs}), hist {launches['hist']}, mask "
                                 f"{launches['mask']} (predicted 0)")
        if launches["qmm"] != want_qmm or launches["qmm_group"] or others:
            raise AssertionError(f"{label}: qmm launched {launches['qmm']} times (predicted "
                                 f"{want_qmm}), qmm_group {launches['qmm_group']}, {others}")
        out[label] = {"rel_error_rows": rel, "topk_rel_error_rows": rel_top, "wall_s": wall,
                      "launches": launches, "hs_launches_predicted": want_hs,
                      "qmm_launches_predicted": want_qmm, "witness_bitwise": same,
                      "iterations_support_differs": int(differ.any(dim=1).sum()),
                      "iterations_support_differs_per_row": differ.sum(dim=0).tolist()}
        if not batch:
            out["walls"] = hsthresh_walls(torch, mods, solve, phi, y, kw, res)
    out["launches"] = sum(by_shape.values())
    return out


def hsthresh_walls(torch, mods, solve, phi, y, kw, res):
    """The single solve's wall five times with the fused H_s and five times
    with the two-kernel chain standing in, in turns (chain, fused, fused,
    chain, ...); both must give res's x bit for bit."""
    cs = mods["LOFAR"]
    walls = {"fused": [], "chain": []}
    order = ["chain", "fused", "fused", "chain"] * 2 + ["chain", "fused"]
    for which in order:
        with contextlib.ExitStack() as stack:
            if which == "chain":
                stack.enter_context(stand_in(mods["hs_ops"], hsthresh_cuda=lambda x, s, nbins:
                                             hs_chain(mods, x, s, nbins)))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = solve(phi, y, cs.n_sources, cs.n_iters, **kw)
            torch.cuda.synchronize()
            walls[which].append(time.perf_counter() - t0)
        if not torch.equal(r.x, res.x):
            raise AssertionError(f"hsthresh solve with the {which} H_s: x differs")
    summary = {k: {"walls_s": v, "min_s": min(v), "median_s": sorted(v)[len(v) // 2],
                   "max_s": max(v)} for k, v in walls.items()}
    print("[chip_smoke]   lofar hsthresh single, wall over 5 solves each, in turns: "
          + " | ".join(f"{k}: median {w['median_s']:.3f} s (min {w['min_s']:.3f}, max "
                       f"{w['max_s']:.3f})" for k, w in summary.items()), flush=True)
    return summary


def phase_gaussian_block(torch, mods):
    """The Gaussian toy per_block, bits 4 and 8, batch 8, held per row
    against the same solves with qmm_group_ref standing in: g = 64 runs on
    the tensor-core QMM_GROUP, g = 8 (no multiple of 16) on the CUDA-core
    QMM_GROUP_CORE, and each must launch only its own kernel."""
    recover_gaussian, g = mods["recover_gaussian"], mods["GAUSS"]
    dev = torch.device(mods["device"])
    out = {}
    for bits, group_size in ((4, GROUP), (8, GROUP), (4, 8), (8, 8)):
        QG = mods["group_kernel"](group_size)
        label = f"gaussian per_block g={group_size} bits={bits} batch=8"
        reset_counts(mods)
        m_k, r_k, x_true = recover_gaussian(g, "packed", bits, 8, 0, "fixed", 8, dev,
                                            "per_block", group_size)
        launches = QG.launches
        others = {k.entry: k.launches for k in mods["KERNELS"] if k is not QG and k.launches}
        with stand_in(mods["qmm_ops"], qmm_group_cuda=mods["qmm_group_ref"]):
            reset_counts(mods)
            m_w, r_w, _ = recover_gaussian(g, "packed", bits, 8, 0, "fixed", 8, dev,
                                           "per_block", group_size)
            if QG.launches:
                raise AssertionError("the witness run launched the group kernel")
        print(f"[chip_smoke]   {label}: rel_error_mean={m_k['rel_error_mean']:.4f} "
              f"wall_s={m_k['wall_s']:.3f} | witness {m_w['rel_error_mean']:.4f} | "
              f"{QG.entry} launches {launches}", flush=True)
        held = hold_rows(torch, label, r_k, r_w, x_true)
        print(f"[chip_smoke]     ‖Δx_b‖/‖x_b‖ kernel vs witness: "
              + " ".join(f"{v:.1e}" for v in held["dx_rows"]), flush=True)
        if launches == 0 or others:
            raise AssertionError(f"{label}: {launches} {QG.entry} launches, others {others}")
        out[label] = {"kernel": m_k, "witness": m_w, "launches": launches,
                      "entry": QG.entry, **held}
    return out


def phase_sqround(torch, mods):
    """sqround through its entry point at the LOFAR Φ and two small shapes,
    bits 2/4/8, bit for bit against sqround_ref on the same words."""
    SQ, sqround, ref, prng = mods["SQROUND"], mods["sqround"], mods["sqround_ref"], mods["prng"]
    dev = torch.device("cuda")
    cs = mods["LOFAR"]
    phi = mods["measurement_matrix"](mods["Station"](n_antennas=cs.n_antennas, seed=cs.seed),
                                     cs.resolution, cs.extent, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    cases = [("lofar_phi", phi.real.contiguous()),
             ("kernels_micro", torch.randn(512, 512, generator=gen, device=dev)),
             ("ragged", 3.0 * torch.randn(333, 1001, generator=gen, device=dev))]
    del phi
    keys = {bits: prng.fold_in(prng.PRNGKey(0), bits) for bits in (2, 4, 8)}
    reset_counts(mods)
    outs = {(name, bits): sqround(v, bits, keys[bits]) for name, v in cases for bits in keys}
    torch.cuda.synchronize()
    launches, by_shape = SQ.launches, dict(SQ.launches_by_shape)
    others = {k.entry: k.launches for k in mods["KERNELS"] if k is not SQ and k.launches}
    if launches != len(outs) or others:
        raise AssertionError(f"sqround: {launches} launches for {len(outs)} calls, others {others}")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for name, v in cases:
        m = v.abs().amax()
        want_scale = torch.where(m > 0, m, torch.ones_like(m))
        for bits, key in keys.items():
            codes, scale = outs[(name, bits)]
            words = mods["narrow_words"](prng.bits(key, v.shape, device=dev))
            plain = ref(v, words, scale, bits)
            differ = int((codes != plain).sum())
            if differ or not torch.equal(scale, want_scale):
                raise AssertionError(f"sqround {name} bits={bits}: {differ} codes differ from "
                                     f"sqround_ref; scale {float(scale)} (want {float(want_scale)})")
            n = v.numel()
            row = {"shape": name, "bits": bits, "R": v.shape[0], "C": v.shape[1],
                   "max_abs_err": 0.0,
                   "ms": time_ms(torch, lambda: SQ(v, words, scale, bits), 20, flush),
                   "call_ms": time_ms(torch, lambda: sqround(v, bits, key), 3, flush),
                   "plain_ms": time_ms(torch, lambda: ref(v, words, scale, bits), 5, flush),
                   "library_ms": None,
                   "bound_ms": 9 * n / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
            rows.append(row)
            print(f"[chip_smoke]   sqround {name:13s} {v.shape[0]}x{v.shape[1]} bits={bits}: "
                  f"bitwise equal; kernel {row['ms']:.4f} ms  whole call (threefry draw "
                  f"included) {row['call_ms']:.3f} ms  plain {row['plain_ms']:.4f} ms  bound "
                  f"{row['bound_ms']:.4f} ms (bytes); no single PyTorch call computes it",
                  flush=True)
    del cases, outs, flush
    torch.cuda.empty_cache()
    return {"rows": rows, "launches": launches,
            "launches_by_shape": {str(k): n for k, n in by_shape.items()}}


def attention_bound(b, hq, hkv, sq, sk, d, itemsize, causal):
    """(bound ms, bound_by, ms at the f32 CUDA-core peak): q, k, v and o
    moved once, or 4·D flops per visible (query, key) pair (causal: row i
    sees keys j <= i + Sk - Sq) over the peak of the inputs' type."""
    pairs = sq * (sk - sq) + sq * (sq + 1) // 2 if causal else sq * sk
    flops = 4 * b * hq * d * pairs
    nbytes = itemsize * (2 * b * hq * sq * d + 2 * b * hkv * sk * d)
    peak = BF16_FLOP_PER_S if itemsize == 2 else F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            flops / F32_FLOP_PER_S * 1e3)


def attention_gap(torch, out, ref, tol):
    """How far an attention output is from the plain version's: elements off
    by more than tol (abs and rel), rows with ‖Δ‖₂ > 2⁻⁷·‖ref‖₂, max |Δ| and
    the largest ‖Δ‖₂/‖ref‖₂ of a row."""
    err = out.float() - ref.float()
    ref_abs = ref.float().abs()
    over = int((err.abs() > tol + tol * ref_abs).sum())
    err_norm, ref_norm = err.norm(dim=-1), ref_abs.norm(dim=-1)
    return {"over": over, "rows_over": int((err_norm > BF16_ROW_REL * ref_norm).sum()),
            "finite": bool(torch.isfinite(out).all()), "max_abs_err": float(err.abs().max()),
            "max_row_rel": float((err_norm / ref_norm.clamp_min(1e-30)).max())}


def held(torch, label, out, ref, tol, rows):
    """attention_gap, raising where it fails: every element within tol (abs
    and rel), and with ``rows`` (16-bit outputs) every row within 2⁻⁷ in
    2-norm."""
    gap = attention_gap(torch, out, ref, tol)
    if gap["over"] or (rows and gap["rows_over"]) or not gap["finite"]:
        raise AssertionError(f"flash_attention {label}: {gap['over']} elements off by more "
                             f"than {tol} (abs and rel), {gap['rows_over'] if rows else 0} "
                             f"rows off by more than 2^-7 in 2-norm, max |Δ| "
                             f"{gap['max_abs_err']}, max row ‖Δ‖/‖ref‖ {gap['max_row_rel']}")
    return gap


def plain_chunked(torch, plain, q, k, v, scale, flush=None):
    """The plain version of a causal Sq = Sk call, PLAIN_CHUNK_ROWS query rows
    a call (rows a.. see keys < a + chunk), and its device time in ms."""
    s = q.shape[2]
    full = torch.empty_like(q)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if flush is not None:
        flush.zero_()
    start.record()
    for a in range(0, s, PLAIN_CHUNK_ROWS):
        e = a + PLAIN_CHUNK_ROWS
        full[:, :, a:e] = plain(q[:, :, a:e], k[:, :, :e], v[:, :, :e], causal=True,
                                scale=scale)
    end.record()
    end.synchronize()
    return full, start.elapsed_time(end)


def starcoder2_qkv(torch, gen, s, dtype=None):
    """q, k, v of starcoder2-3b's attention at length s, B = 1, in dtype
    (bf16 by default)."""
    return tuple(torch.randn(1, h, s, STARCODER2_3B_HEAD_DIM, generator=gen,
                             device=gen.device).to(dtype or torch.bfloat16)
                 for h in (STARCODER2_3B_HEADS, STARCODER2_3B_KV_HEADS, STARCODER2_3B_KV_HEADS))


def phase_flash(torch, mods):
    """flash_attention through its entry point at starcoder2-3b's width
    (causal; bf16 at S = 4,096 and 32,768, fp16 and f32 at 4,096), at
    stablelm-12b's (D = 160), recurrentgemma-2b's (D = 256) and qwen3-moe
    SMOKE's (D = 8) widths in bf16 at 4,096, starcoder2-3b's bf16 at 4,096 with q, k, v as views off a
    16-byte boundary, and small shapes (f32 ragged and cross; D = 8, 160, 256
    in f32, bf16 and fp16; views 2 elements in), held against the plain
    version; timed beside scaled_dot_product_attention. Each call must
    launch the kernel its case names: FLASH (f32), FLASH_TC (aligned 16-bit,
    D <= 128), FLASH_CORE (aligned 16-bit, D = 8, 160, 256) or
    FLASH_UNALIGNED (views off a 16-byte boundary)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    from torch.nn.attention import SDPBackend, sdpa_kernel

    flash_attention, plain = mods["flash_attention"], mods["attention_plain"]
    routes = {name: mods[name] for name in ("FLASH", "FLASH_TC", "FLASH_CORE",
                                            "FLASH_UNALIGNED")}

    def sdpa(q, k, v):
        """The library call: its flash backend for 16-bit inputs at D <= 128
        (never the math one, which would materialize the S² scores); for
        float32, which that backend refuses, and wider heads, PyTorch's own
        choice, TF32 off. Its kernels read 16-byte vectors and fault on views
        off a 16-byte boundary, so such views are handed to it as aligned
        copies (made outside the timed call)."""
        flash_ok = q.dtype != torch.float32 and q.shape[-1] <= 128
        with (sdpa_kernel([SDPBackend.FLASH_ATTENTION]) if flash_ok
              else contextlib.nullcontext()):
            return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                    enable_gqa=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def qkv(b, hq, hkv, sq, sk, d, dtype, offset=0):
        """q, k, v; with ``offset``, each a view that many elements into a
        larger tensor."""
        out = []
        for h, s in ((hq, sq), (hkv, sk), (hkv, sk)):
            t = torch.randn(b, h, s, d, generator=gen, device=dev).to(dtype)
            if offset:
                flat = torch.zeros(offset + t.numel(), dtype=dtype, device=dev)
                view = flat[offset:].view(t.shape)
                view.copy_(t)
                t = view
            out.append(t)
        return tuple(out)

    hq, hkv, d = STARCODER2_3B_HEADS, STARCODER2_3B_KV_HEADS, STARCODER2_3B_HEAD_DIM
    f32, bf16, fp16 = torch.float32, torch.bfloat16, torch.float16
    # (label, causal, (q, k, v), tolerance, kernel that must run it)
    small = [(f"{name} causal={causal}", causal, qkv(*shape, f32), 2e-4, "FLASH")
             for name, shape in (("ragged", (2, 4, 2, 333, 333, 64)),
                                 ("cross", (1, 4, 2, 64, 256, 32)))
             for causal in (True, False)]
    small += [(f"D={dd} {str(dt)[6:]}", True, qkv(2, 4, 2, 200, 333, dd, dt),
               2e-4 if dt == f32 else 2e-2, "FLASH" if dt == f32 else "FLASH_CORE")
              for dd in (8, 160, 256) for dt in (f32, bf16, fp16)]
    small += [(f"views 2 elements in, D=64 {str(dt)[6:]}", True,
               qkv(1, 4, 2, 130, 130, 64, dt, offset=2), 2e-4 if dt == f32 else 2e-2,
               "FLASH_UNALIGNED") for dt in (f32, bf16, fp16)]
    # (label, S, dtype, (q, k, v), kernel, (Hq, Hkv, D))
    big = [(f"starcoder2_3b S={s} {name}", s, dtype, starcoder2_qkv(torch, gen, s, dtype),
            "FLASH" if dtype == f32 else "FLASH_TC", (hq, hkv, d))
           for s, name, dtype in ((TRAIN_4K_LEN, "bf16", bf16), (PREFILL_32K_LEN, "bf16", bf16),
                                  (TRAIN_4K_LEN, "fp16", fp16), (TRAIN_4K_LEN, "f32", f32))]
    big += [(f"{name} S={TRAIN_4K_LEN} bf16", TRAIN_4K_LEN, bf16,
             qkv(1, heads, kv, TRAIN_4K_LEN, TRAIN_4K_LEN, dd, bf16), "FLASH_CORE",
             (heads, kv, dd))
            for name, heads, kv, dd in (("stablelm_12b", *STABLELM_12B_ATTN),
                                        ("recurrentgemma_2b", *RECURRENTGEMMA_2B_ATTN),
                                        ("qwen3_moe_235b_smoke", *QWEN3_MOE_SMOKE_ATTN))]
    big += [(f"starcoder2_3b S={TRAIN_4K_LEN} bf16 views 2 elements in", TRAIN_4K_LEN, bf16,
             qkv(1, hq, hkv, TRAIN_4K_LEN, TRAIN_4K_LEN, d, bf16, offset=2), "FLASH_UNALIGNED",
             (hq, hkv, d))]
    reset_counts(mods)
    outs, expected = [], collections.Counter()
    for label, causal, t, _, kernel in small:
        outs.append(flash_attention(*t, causal=causal))
        expected[kernel] += 1
    for label, _, _, t, kernel, _ in big:
        outs.append(flash_attention(*t, causal=True))
        expected[kernel] += 1
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in routes.items()}
    others = {k.entry: k.launches for k in mods["KERNELS"]
              if k not in routes.values() and k.launches}
    if launches != {name: expected[name] for name in routes} or others:
        raise AssertionError(f"flash_attention: launches {launches}, expected "
                             f"{dict(expected)}; others {others}")
    by_shape = {k.entry: {str(key): n for key, n in k.launches_by_shape.items()}
                for k in routes.values()}

    for (label, causal, (q, k, v), tol, kernel), out in zip(small, outs):
        err = held(torch, label, out,
                   plain(q, k, v, causal=causal, scale=1.0 / q.shape[-1] ** 0.5), tol,
                   q.dtype != f32)["max_abs_err"]
        print(f"[chip_smoke]   flash_attention {label} {tuple(q.shape)} kv {tuple(k.shape)} "
              f"({routes[kernel].entry}): max|Δ|={err:.3g} (tolerance {tol:g})", flush=True)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for (label, s, dtype, (q, k, v), kernel, (h_q, h_kv, dd)), out in zip(big, outs[len(small):]):
        is_f32 = dtype == f32
        tol = 2e-4 if is_f32 else 2e-2
        scale = 1.0 / dd ** 0.5          # flash_attention's default
        row = {"shape": label, "B": 1, "Hq": h_q, "Hkv": h_kv, "S": s, "D": dd,
               "dtype": str(dtype).replace("torch.", ""), "kernel": routes[kernel].entry,
               "route": kernel}
        if s == TRAIN_4K_LEN:
            ref = plain(q, k, v, causal=True, scale=scale)
            gap = held(torch, label, out, ref, tol, not is_f32)
            row["plain_ms"] = time_ms(torch, lambda: plain(q, k, v, causal=True, scale=scale),
                                      3, flush)
            row["plain_how"] = f"one call ({h_q}·S² f32 scores)"
            reps = 10
        else:
            tail = plain(q[:, :, -PREFILL_TAIL_ROWS:], k, v, causal=True, scale=scale)
            tail_gap = held(torch, f"{label} last {PREFILL_TAIL_ROWS} rows",
                            out[:, :, -PREFILL_TAIL_ROWS:], tail, tol, True)
            row["tail_max_abs_err"] = tail_gap["max_abs_err"]
            row["tail_max_row_rel"] = tail_gap["max_row_rel"]
            del tail
            ref, row["plain_ms"] = plain_chunked(torch, plain, q, k, v, scale, flush)
            row["plain_how"] = f"{s // PLAIN_CHUNK_ROWS} calls of {PLAIN_CHUNK_ROWS} query rows"
            gap = held(torch, f"{label} every row", out, ref, tol, True)
            reps = 3
        row["max_abs_err"], row["max_row_rel"] = gap["max_abs_err"], gap["max_row_rel"]
        row["ms"] = time_ms(torch, lambda: flash_attention(q, k, v, causal=True), reps, flush)
        lq, lk, lv = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
        lib = sdpa(lq, lk, lv)
        row["library_max_abs_diff"] = float((lib.float() - out.float()).abs().max())
        # the library's own distance from the plain version: a witness of what
        # a kernel that rounds P to 16 bits reaches (reported, not gated)
        lib_gap = attention_gap(torch, lib, ref, tol)
        row["library_max_abs_err"] = lib_gap["max_abs_err"]
        row["library_max_row_rel"] = lib_gap["max_row_rel"]
        del lib, ref
        row["library_ms"] = time_ms(torch, lambda: sdpa(lq, lk, lv), 10, flush)
        del lq, lk, lv
        row["bound_ms"], row["bound_by"], row["f32_core_bound_ms"] = attention_bound(
            1, h_q, h_kv, s, s, dd, q.element_size(), True)
        rows.append(row)
        print(f"[chip_smoke]   flash_attention {label} ({h_q}/{h_kv} heads, D={dd}, causal, "
              f"{row['kernel']}): max|Δ|={row['max_abs_err']:.3g} (tolerance {tol:g}), max row "
              f"‖Δ‖/‖ref‖={row['max_row_rel']:.3g}"
              f"{'' if is_f32 else ' (tolerance 2^-7)'} [sdpa {row['library_max_row_rel']:.3g}]; "
              f"kernel {row['ms']:.3f} ms  plain {row['plain_ms']:.3f} ms ({row['plain_how']})  "
              f"sdpa {row['library_ms']:.3f} ms (|Δ| to the kernel "
              f"{row['library_max_abs_diff']:.3g})  bound {row['bound_ms']:.3f} ms "
              f"({row['bound_by']}; {row['f32_core_bound_ms']:.2f} ms at the f32 CUDA-core "
              f"peak)", flush=True)
    del small, big, outs, flush
    torch.cuda.empty_cache()
    return {"rows": rows, "launches": launches, "launches_by_shape": by_shape}


def flash_mutants(torch, mods):
    """Plant each fault of FLASH_MUTANTS in a copy of flashattn_wgmma.cu in a
    temporary directory, build the copies and the real source together, and
    hold each at starcoder2-3b's width (bf16, causal) to phase 12's checks:
    S = 4,096 every row, S = 32,768 the last 256 rows and every row. For each
    check it reports the elementwise 2e-2 rule and the 2⁻⁷ row rule apart."""
    import tempfile

    torch.backends.cuda.matmul.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    plain, FLASH_TC, CudaLibrary = (mods["attention_plain"], mods["FLASH_TC"],
                                    mods["CudaLibrary"])

    class CopyLibrary(CudaLibrary):
        """A copy's library, built beside the copy."""

        def library_path(self):
            return self.source.with_suffix(".so")

    source = FLASH_TC.library.source.read_text()
    with tempfile.TemporaryDirectory() as tmp:
        kernels = {"kernel": FLASH_TC}
        for name, (_, edits) in FLASH_MUTANTS.items():
            text = source
            for old, new in edits:
                if text.count(old) != 1:
                    raise AssertionError(f"mutant {name}: {old!r} is not in "
                                         "flashattn_wgmma.cu once")
                text = text.replace(old, new)
            path = Path(tmp) / f"flashattn_wgmma_{name}.cu"
            path.write_text(text)
            kernels[name] = type(FLASH_TC)(CopyLibrary(path, FLASH_TC.library.entries),
                                           FLASH_TC.entry, FLASH_TC.dtypes)
        phase_build([k.library for k in kernels.values()])

        gen = torch.Generator(device=torch.device("cuda")).manual_seed(5)
        scale = 1.0 / STARCODER2_3B_HEAD_DIM ** 0.5
        results = {name: {} for name in kernels}
        for s in (TRAIN_4K_LEN, PREFILL_32K_LEN):
            q, k, v = starcoder2_qkv(torch, gen, s)
            if s == TRAIN_4K_LEN:
                checks = {f"S={s} every row": (slice(None), plain(q, k, v, causal=True,
                                                                  scale=scale))}
            else:
                tail = plain(q[:, :, -PREFILL_TAIL_ROWS:], k, v, causal=True, scale=scale)
                checks = {f"S={s} last {PREFILL_TAIL_ROWS} rows":
                          (slice(s - PREFILL_TAIL_ROWS, s), tail),
                          f"S={s} every row": (slice(None),
                                               plain_chunked(torch, plain, q, k, v, scale)[0])}
            for name, kernel in kernels.items():
                out = kernel(q, k, v, True, scale)
                for check, (rows, ref) in checks.items():
                    gap = attention_gap(torch, out[:, :, rows], ref, 2e-2)
                    gap["elementwise_2e-2"] = "pass" if gap["over"] == 0 and gap["finite"] \
                        else "FAIL"
                    gap["row_2^-7"] = "pass" if gap["rows_over"] == 0 else "FAIL"
                    results[name][check] = gap
                    print(f"[chip_smoke]   {name:13s} {check:22s} elementwise 2e-2: "
                          f"{gap['elementwise_2e-2']} ({gap['over']} elements over, max|Δ| "
                          f"{gap['max_abs_err']:.3g})  row 2^-7: {gap['row_2^-7']} "
                          f"({gap['rows_over']} rows over, max ‖Δ‖/‖ref‖ "
                          f"{gap['max_row_rel']:.3g})", flush=True)
                del out
            del q, k, v, checks
            torch.cuda.empty_cache()

    def failed(name):
        return any(g["elementwise_2e-2"] == "FAIL" or g["row_2^-7"] == "FAIL"
                   for g in results[name].values())

    missed = [name for name in FLASH_MUTANTS if not failed(name)]
    if failed("kernel") or missed:
        raise AssertionError(f"flash mutants: the real kernel failed a check: "
                             f"{failed('kernel')}; mutants no check caught: {missed}")
    return {"mutants": {n: what for n, (what, _) in FLASH_MUTANTS.items()},
            "results": results}


def load_port() -> dict:
    """Import the port from ``src/`` (the only imports of the program)."""
    sys.path.insert(0, str(SRC))
    from repro_torch import random as prng
    from repro_torch.configs.gaussian_toy import CONFIG as GAUSS
    from repro_torch.configs.lofar_cs302 import BENCH as LOFAR_BENCH, CONFIG as LOFAR
    from repro_torch.core.niht import _solver_setup, qniht_batch
    from repro_torch.kernels.cudalib import CudaLibrary
    from repro_torch.kernels.hsthresh import kernel as hs_kernel, ops as hs_ops
    from repro_torch.kernels.hsthresh import ref as hsthresh_ref_mod
    from repro_torch.kernels.flashattn import kernel as fa_kernel
    from repro_torch.kernels.flashattn.ops import attention_plain, flash_attention
    from repro_torch.kernels.sqround import kernel as sq_kernel
    from repro_torch.kernels.sqround.ops import sqround
    from repro_torch.kernels.sqround.ref import sqround_ref
    from repro_torch.kernels.qmm import kernel as qmm_kernel
    from repro_torch.kernels.qmm.kernel import QMM, QMM_CORE, QMM_GROUP, QMM_GROUP_CORE
    from repro_torch.kernels.qmm import ops as qmm_ops
    from repro_torch.kernels.qmm.ops import (
        PackedWeights,
        cuda_kernel,
        group_kernel,
        pack_operator,
        pack_weights,
        qmm,
    )
    from repro_torch.kernels.qmm.ref import qmm_group_ref, qmm_ref
    from repro_torch.quant.quantize import expand_block_scale
    from repro_torch.launch.recover import (
        gaussian_batch_instance,
        lofar_instance,
        recover_gaussian,
        recover_lofar,
    )
    from repro_torch.quant.pack import pack_codes, unpack_codes
    from repro_torch.core.niht import qniht
    from repro_torch.sensing.sky import make_sky
    from repro_torch.sensing.telescope import Station, measurement_matrix, visibilities

    mods = dict(prng=prng, GAUSS=GAUSS, LOFAR=LOFAR, QMM=QMM, pack_operator=pack_operator,
                pack_weights=pack_weights, qmm_ref=qmm_ref, recover_gaussian=recover_gaussian,
                recover_lofar=recover_lofar, unpack_codes=unpack_codes, Station=Station,
                measurement_matrix=measurement_matrix, make_sky=make_sky,
                visibilities=visibilities, qniht=qniht, qmm_ops=qmm_ops,
                gaussian_batch_instance=gaussian_batch_instance, lofar_instance=lofar_instance,
                LOFAR_BENCH=LOFAR_BENCH, device="cuda", QMM_GROUP=QMM_GROUP,
                qmm_group_ref=qmm_group_ref, expand_block_scale=expand_block_scale,
                HIST=hs_kernel.HIST, MASK=hs_kernel.MASK, hs_ops=hs_ops,
                HSTHRESH=hs_kernel.HSTHRESH, hsthresh_cuda=hs_kernel.hsthresh_cuda,
                QMM_CORE=QMM_CORE, PackedWeights=PackedWeights,
                FLASH_CORE=fa_kernel.FLASH_CORE, FLASH_UNALIGNED=fa_kernel.FLASH_UNALIGNED,
                hsthresh_ref_mod=hsthresh_ref_mod, qniht_batch=qniht_batch,
                solver_setup=_solver_setup, SQROUND=sq_kernel.SQROUND, sqround=sqround,
                sqround_ref=sqround_ref, narrow_words=sq_kernel.narrow_words,
                FLASH=fa_kernel.FLASH, FLASH_TC=fa_kernel.FLASH_TC,
                flash_attention=flash_attention, attention_plain=attention_plain,
                CudaLibrary=CudaLibrary, QMM_GROUP_CORE=QMM_GROUP_CORE, qmm=qmm,
                cuda_kernel=cuda_kernel, group_kernel=group_kernel, pack_codes=pack_codes,
                KERNELS=(QMM, QMM_CORE, QMM_GROUP, QMM_GROUP_CORE, hs_kernel.HIST, hs_kernel.MASK,
                         hs_kernel.HSTHRESH, sq_kernel.SQROUND, fa_kernel.FLASH,
                         fa_kernel.FLASH_TC, fa_kernel.FLASH_CORE, fa_kernel.FLASH_UNALIGNED),
                LIBRARIES=(qmm_kernel.LIBRARY, qmm_kernel.CORE_LIBRARY, hs_kernel.LIBRARY,
                           hs_kernel.FUSED_LIBRARY, sq_kernel.LIBRARY, fa_kernel.LIBRARY,
                           fa_kernel.TC_LIBRARY))
    return mods


def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them ("" if it
    cannot)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout else ""


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=str(ROOT / "chip_smoke_out"),
                    help="directory for chip_smoke.json and the profiler trace")
    ap.add_argument("--flash-mutants", action="store_true",
                    help="only check that planted faults of flashattn_wgmma.cu fail the bf16 "
                         "checks")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1
    mods = load_port()
    mods["out_dir"] = Path(args.out)
    LOFAR = mods["LOFAR"]
    kind = torch.cuda.get_device_name(0)
    print(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda} on {kind}",
          flush=True)
    phases = Phases()
    t0 = time.perf_counter()
    if args.flash_mutants:
        result = phases.run("flash-mutants", flash_mutants, torch, mods)
        mods["out_dir"].mkdir(parents=True, exist_ok=True)
        (mods["out_dir"] / "flash_mutants.json").write_text(json.dumps(result, indent=1))
        print(nvidia_smi_line(), flush=True)
        return 1 if phases.failed else 0
    report = {"device": kind}
    report["build"] = phases.run("build", phase_build, mods["LIBRARIES"])
    report["kernel"] = phases.run("kernel-vs-plain", phase_kernel, torch, mods)
    report["group_kernel"] = phases.run("qmm_group-vs-plain", phase_group_kernel, torch, mods)
    report["hs_kernels"] = phases.run("hist-mask-vs-plain", phase_hs_kernels, torch, mods)
    report["fused_hs"] = phases.run("fused-hsthresh-vs-plain", phase_fused_hs, torch, mods)
    report["lofar"] = phases.run("lofar-main-path", phase_lofar, torch, mods)
    report["lofar_block"] = phases.run("lofar-per-block", phase_lofar_block, torch, mods,
                                       report["lofar"])
    report["lofar_hsthresh"] = phases.run("lofar-hsthresh", phase_lofar_hsthresh, torch, mods)
    report["gaussian"] = phases.run("gaussian", phase_gaussian, torch, mods)
    report["gaussian_block"] = phases.run("gaussian-per-block", phase_gaussian_block, torch,
                                          mods)
    report["sqround"] = phases.run("sqround", phase_sqround, torch, mods)
    report["flash"] = phases.run("flash-attention", phase_flash, torch, mods)
    report["profile"] = phases.run("profile", phase_profile, torch, mods)
    card = nvidia_smi_line()
    report["nvidia_smi"] = card
    report["seconds"] = time.perf_counter() - t0
    out_dir = mods["out_dir"]
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    if phases.failed or not card:
        print(f"[chip_smoke] FAILED phases: {phases.failed or ['nvidia-smi']}", flush=True)
        return 1
    kernels = []
    for name, phase, path, replaces in (
            ("qmm", "kernel", "lofar", "src/repro/kernels/qmm/kernel.py:265"),
            ("qmm_group", "group_kernel", "lofar_block", "src/repro/kernels/qmm/kernel.py:221")):
        by_orientation = report[path]["launches_by_orientation"]
        for shape in ("lofar_fwd", "lofar_adj"):
            row = next(r for r in report[phase]["rows"]
                       if r["shape"] == shape and r["bits"] == LOFAR.bits_phi and r["M"] == 1)
            kernels.append({
                "name": f"{name}[{shape}]",
                "route": "cuda",
                "source": f"src/repro_torch/kernels/qmm/csrc/{report[phase]['source']}",
                "entry": report[phase]["entry"],
                "replaces": replaces,
                "launches": by_orientation[shape],
                "max_abs_err": report[phase]["max_abs_err"],
                "ms": row["ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "bytes_bound_ms": row["bytes_bound_ms"],
                "device_ms": row["device_ms"],
                "library_ms": row["library_ms"],
                "shape": f"{shape} bits={row['bits']} M=1 N={row['N']} K={row['K']}"
                         + (f" g={GROUP}" if name == "qmm_group" else ""),
            })
    for name, phase, source in (("qmm_core", "kernel", "qmm.cu"),
                                ("qmm_group_core", "group_kernel", "qmm.cu")):
        for row in report[phase]["misaligned_rows"]:
            kernels.append({
                "name": f"{name}[{row['shape']} codes at offset {row['offset']}]",
                "route": "cuda",
                "source": f"src/repro_torch/kernels/qmm/csrc/{source}",
                "entry": row["entry"],
                "replaces": ("src/repro/kernels/qmm/kernel.py:265" if name == "qmm_core"
                             else "src/repro/kernels/qmm/kernel.py:221"),
                "launches": report[phase]["misaligned_launches"],
                "max_abs_err": row["max_abs_err"],
                "ms": row["ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "bytes_bound_ms": row["bytes_bound_ms"],
                "library_ms": row["library_ms"],
                "shape": f"{row['shape']} bits={row['bits']} M=1 N={row['N']} K={row['K']}"
                         + (f" g={GROUP}" if name == "qmm_group_core" else "")
                         + "; launches: the misaligned checks of its phase",
            })
    core = next(r for r in report["group_kernel"]["core_rows"] if r["bits"] == 4)
    kernels.append({
        "name": "qmm_group_core[gaussian g=8]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/qmm/csrc/qmm.cu",
        "entry": "repro_qmm_group",
        "replaces": "src/repro/kernels/qmm/kernel.py:221",
        "launches": sum(v["launches"] for k, v in report["gaussian_block"].items()
                        if v["entry"] == "repro_qmm_group"),
        "max_abs_err": max(r["max_abs_err"] for r in report["group_kernel"]["core_rows"]),
        "ms": core["ms"],
        "plain_ms": core["plain_ms"],
        "bound_ms": core["bound_ms"],
        "bound_by": core["bound_by"],
        "bytes_bound_ms": core["bytes_bound_ms"],
        "library_ms": core["library_ms"],
        "shape": f"ragged bits=4 M=5 N={core['N']} K={core['K']} g={core['g']} (timed); "
                 "launches from the Gaussian per_block g=8 solves",
    })
    row = next(r for r in report["fused_hs"]["rows"] if r["B"] == 1)
    kernels.append({
        "name": "hsthresh[lofar]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/hsthresh/csrc/hsthresh_fused.cu",
        "entry": "repro_hsthresh",
        "replaces": "src/repro/kernels/hsthresh/kernel.py:48 and :69 (hist_pallas, "
                    "mask_pallas and the jnp pick and fill between them)",
        "launches": report["lofar_hsthresh"]["launches"],
        "max_abs_err": 0.0,
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
        "device_ms": row["device_ms"],
        "chain_ms": row["chain_ms"],
        "shape": f"B=1 N={row['N']} s={row['s']} nbins={NBINS}",
    })
    for name, replaces in (("hist", "src/repro/kernels/hsthresh/kernel.py:48"),
                           ("mask", "src/repro/kernels/hsthresh/kernel.py:69")):
        row = next(r for r in report["hs_kernels"]["rows"] if r["name"] == name and r["B"] == 1)
        kernels.append({
            "name": f"{name}[lofar]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/hsthresh/csrc/hsthresh.cu",
            "replaces": replaces,
            "launches": report["hs_kernels"]["launches"][name],
            "max_abs_err": 0.0,
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
            "shape": f"B=1 N={row['N']} nbins={NBINS}",
        })
    row = next(r for r in report["sqround"]["rows"]
               if r["shape"] == "lofar_phi" and r["bits"] == LOFAR.bits_phi)
    kernels.append({
        "name": "sqround[lofar_phi]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/sqround/csrc/sqround.cu",
        "replaces": "src/repro/kernels/sqround/kernel.py:49",
        "launches": report["sqround"]["launches"],
        "max_abs_err": 0.0,
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
        "call_ms": row["call_ms"],
        "shape": f"R={row['R']} C={row['C']} bits={row['bits']}",
    })
    flash = report["flash"]
    rows = {r["shape"]: r for r in flash["rows"]}
    for name, key, source, entry in (
            ("flash_attention[starcoder2_3b_prefill_32k]",
             f"starcoder2_3b S={PREFILL_32K_LEN} bf16", "flashattn_wgmma.cu", "FLASH_TC"),
            ("flash_attention_f32[starcoder2_3b_train_4k]",
             f"starcoder2_3b S={TRAIN_4K_LEN} f32", "flashattn.cu", "FLASH"),
            ("flash_attention_core[stablelm_12b_train_4k]",
             f"stablelm_12b S={TRAIN_4K_LEN} bf16", "flashattn.cu", "FLASH_CORE"),
            ("flash_attention_core[recurrentgemma_2b_train_4k]",
             f"recurrentgemma_2b S={TRAIN_4K_LEN} bf16", "flashattn.cu", "FLASH_CORE"),
            ("flash_attention_core[qwen3_moe_235b_smoke_train_4k]",
             f"qwen3_moe_235b_smoke S={TRAIN_4K_LEN} bf16", "flashattn.cu", "FLASH_CORE"),
            ("flash_attention_unaligned[starcoder2_3b_train_4k]",
             f"starcoder2_3b S={TRAIN_4K_LEN} bf16 views 2 elements in", "flashattn.cu",
             "FLASH_UNALIGNED")):
        row = rows[key]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/flashattn/csrc/{source}",
            "entry": row["kernel"],
            "replaces": "src/repro/kernels/flashattn/kernel.py:87",
            "launches": flash["launches"][entry],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "max_row_rel": row["max_row_rel"],
            "library_max_row_rel": row["library_max_row_rel"],
            "f32_core_bound_ms": row["f32_core_bound_ms"],
            "shape": f"B=1 Hq={row['Hq']} Hkv={row['Hkv']} S={row['S']} D={row['D']} "
                     f"{row['dtype']} causal",
        })
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
