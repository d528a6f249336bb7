#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU (H100).

Run from the root of a checkout, with one card:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package ``repro``. Phases
(any failure makes the exit code non-zero and suppresses the result line):

1. build the Hopper kernel libraries from ``src/repro_torch/kernels/*/csrc``
   (``qmm.cu``: ``qmm`` and ``qmm_group``; ``hsthresh.cu``: ``hist`` and
   ``mask``), one nvcc per source, started together;
2. hold the ``qmm`` kernel against its plain PyTorch version ``qmm_ref`` on the card
   (TF32 off, asserted) at bits 2/4/8 × M ∈ {1, 8, 64} × the LOFAR CS302
   forward (870×65,536) and adjoint (65,536×870) shapes of the main path's
   own packed Φ̂, plus a ragged shape; tolerance |Δ| ≤ 1e-5·|ref| +
   1e-5·(|x|@|w|ᵀ), the reference's kernel-vs-oracle bound. Times the kernel,
   the plain version and ``torch.matmul`` against the pre-dequantized f32 Φ̂
   (the dense stream the paper compares against), with the L2 cache flushed
   before every timed call;
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
   (per_tensor, per_block, hsthresh): device time by kernel, the device's
   busy share and the set-up alone (``lofar_*_trace.json``);
6. ``qmm_group`` against ``qmm_group_ref`` at the LOFAR forward and adjoint
   shapes of the per_block Φ̂ (g = 64), bits 2/4/8 × M ∈ {1, 8, 64}, plus a
   ragged shape with a short last group; same tolerance and timings as 2;
7. ``hist`` and ``mask`` against ``hist_ref``/``mask_ref`` at (1, 65,536),
   (8, 65,536) and (3, 1,001), bit for bit, timed beside their bytes bound;
8. LOFAR CS302 at full size with ``scale_granularity="per_block",
   group_size=64``, single and batch 8: ``qmm_group`` takes exactly the
   launches ``qmm`` takes on the per_tensor path and ``qmm`` none; the same
   solves with ``qmm_group_ref`` standing in on the card are the witness,
   held per row as in 4. One ``per_channel`` single solve goes through
   ``qmm``. The per_block instances go to ``lofar_block.npz`` (full size,
   no Φ) and ``lofar_bench_block.npz`` (with Φ) for
   ``scripts/reference_replay.py lofar-block``;
9. LOFAR CS302 at full size with ``threshold="hsthresh"`` (per_tensor
   packed), single and batch 8: ``hist`` and ``mask`` launch once per
   proposal for the whole batch, and the same solves with ``hist_ref``/
   ``mask_ref`` standing in on the card give bit-identical x and trace;
   iterations whose support differs from the ``topk`` solve are counted;
10. the Gaussian toy per_block (g = 64, bits 4 and 8, batch 8) against its
    ``qmm_group_ref`` witness, per row as in 4.

Every phase that drives a path sets the launch counts of all kernels to 0
just before it and reads them just after.

Before its last line it prints the card's name and power limit and one JSON
line ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Details go to ``chip_smoke.json`` and the trace in the directory named by
``--out`` (default ``chip_smoke_out/`` beside this script).
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
    once, or the FMAs (plus, grouped, one scale product per code)."""
    scale_words = n if n_groups is None else n * n_groups
    nbytes = n * kp + 4 * scale_words + 4 * m * k + 4 * m * n
    flops = 2 * m * n * k + (0 if n_groups is None else n * k)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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
    rows, max_err = [], 0.0
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
                y = QMM(x, w.packed, w.scale, bits, k)
                ref = qmm_ref(x, w.packed, w.scale, bits, k)
                torch.cuda.synchronize()
                tol = 1e-5 * ref.abs() + 1e-5 * (x.abs() @ wdeq.abs().T)
                err = (y - ref).abs()
                if not bool((err <= tol).all()):
                    raise AssertionError(f"qmm {name} bits={bits} M={m}: max |Δ| "
                                         f"{float(err.max())} exceeds the tolerance")
                max_err = max(max_err, float(err.max()))
                b_ms, b_by = bound_ms(m, n, k, kp)
                row = {"shape": name, "bits": bits, "M": m, "N": n, "K": k,
                       "max_abs_err": float(err.max()),
                       "ms": time_ms(torch, lambda: QMM(x, w.packed, w.scale, bits, k), 20,
                                     flush),
                       "plain_ms": time_ms(torch, lambda: qmm_ref(x, w.packed, w.scale, bits, k),
                                           5, flush),
                       "library_ms": time_ms(torch, lambda: torch.matmul(x, wdeq.T), 20, flush),
                       "bound_ms": b_ms, "bound_by": b_by}
                rows.append(row)
                print(f"[chip_smoke]   qmm {name:9s} bits={bits} M={m:2d}: max|Δ|={row['max_abs_err']:.3g} "
                      f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
                      f"matmul(f32 Φ̂) {row['library_ms']:.4f} ms  bound {b_ms:.4f} ms ({b_by})",
                      flush=True)
            del wdeq
        del op
    del phi, flush
    torch.cuda.empty_cache()
    return {"rows": rows, "max_abs_err": max_err}


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
    single-row LOFAR solve on each path: per_tensor topk, per_block (g = 64)
    and hsthresh (torch.profiler, CUPTI), beside the set-up alone (a
    0-iteration solve: ŷ draw, Φ̂ quantize and pack). Reports "not measured"
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
    for path, extra, trace in (
            ("per_tensor", {}, "lofar_packed_trace.json"),
            ("per_block", dict(scale_granularity="per_block", group_size=GROUP),
             "lofar_per_block_trace.json"),
            ("hsthresh", dict(threshold="hsthresh"), "lofar_hsthresh_trace.json")):
        kw = {**base, **extra}
        mods["qniht"](phi, y, cs.n_sources, 2, **kw)          # warm-up (allocator, kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mods["qniht"](phi, y, cs.n_sources, 0, **kw)          # the set-up alone
        torch.cuda.synchronize()
        setup_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mods["qniht"](phi, y, cs.n_sources, cs.n_iters, **kw)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = []
        for ev in prof.key_averages():
            if getattr(ev, "device_type", None) != DeviceType.CUDA:
                continue                                  # host-side op rows repeat the time
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0)
            if us > 0:
                rows.append({"name": ev.key, "device_ms": us / 1e3, "calls": ev.count})
        rows.sort(key=lambda r: -r["device_ms"])
        busy_ms = sum(r["device_ms"] for r in rows)
        prof.export_chrome_trace(str(out_dir / trace))
        if not rows:
            print(f"[chip_smoke]   profile {path}: no device time seen (not measured)",
                  flush=True)
            out[path] = {"wall_ms": wall_ms, "setup_ms": setup_ms, "device_busy_ms": None,
                         "kernels": []}
            continue
        ours = {name: sum(r["device_ms"] for r in rows if f"{name}_kernel" in r["name"])
                for name in ("qmm", "hist", "mask")}
        print(f"[chip_smoke]   profile of one packed LOFAR solve, {path}: wall {wall_ms:.1f} ms "
              f"(set-up alone {setup_ms:.1f} ms), device busy {busy_ms:.1f} ms "
              f"({100 * busy_ms / wall_ms:.1f}%), qmm kernels {ours['qmm']:.1f} ms, hist "
              f"{ours['hist']:.2f} ms, mask {ours['mask']:.2f} ms", flush=True)
        for r in rows[:10]:
            print(f"[chip_smoke]     {r['device_ms']:9.3f} ms  {r['calls']:6d}×  "
                  f"{r['name'][:90]}", flush=True)
        out[path] = {"wall_ms": wall_ms, "setup_ms": setup_ms, "device_busy_ms": busy_ms,
                     "qmm_device_ms": ours["qmm"], "hist_device_ms": ours["hist"],
                     "mask_device_ms": ours["mask"], "kernels": rows[:40]}
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
    rows, max_err = [], 0.0
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
                y = QG(x, w.packed, w.scale, bits, k, GROUP)
                ref = ref_fn(x, w.packed, w.scale, bits, k, GROUP)
                torch.cuda.synchronize()
                tol = 1e-5 * ref.abs() + 1e-5 * (x.abs() @ wdeq.abs().T)
                err = (y - ref).abs()
                if not bool((err <= tol).all()):
                    raise AssertionError(f"qmm_group {name} bits={bits} M={m}: max |Δ| "
                                         f"{float(err.max())} exceeds the tolerance")
                max_err = max(max_err, float(err.max()))
                b_ms, b_by = bound_ms(m, n, k, kp, n_groups)
                row = {"shape": name, "bits": bits, "M": m, "N": n, "K": k, "G": n_groups,
                       "max_abs_err": float(err.max()),
                       "ms": time_ms(torch, lambda: QG(x, w.packed, w.scale, bits, k, GROUP),
                                     20, flush),
                       "plain_ms": time_ms(torch, lambda: ref_fn(x, w.packed, w.scale, bits, k,
                                                                 GROUP), 5, flush),
                       "library_ms": time_ms(torch, lambda: torch.matmul(x, wdeq.T), 20, flush),
                       "bound_ms": b_ms, "bound_by": b_by}
                rows.append(row)
                print(f"[chip_smoke]   qmm_group {name:9s} bits={bits} M={m:2d}: "
                      f"max|Δ|={row['max_abs_err']:.3g} kernel {row['ms']:.4f} ms  plain "
                      f"{row['plain_ms']:.4f} ms  matmul(f32 Φ̂) {row['library_ms']:.4f} ms  "
                      f"bound {b_ms:.4f} ms ({b_by})", flush=True)
            del wdeq
        del op
    del phi, flush
    torch.cuda.empty_cache()
    return {"rows": rows, "max_abs_err": max_err, "group_size": GROUP}


def phase_hs_kernels(torch, mods):
    """hist and mask against their plain versions, bit for bit."""
    dev = torch.device("cuda")
    HIST, MASK = mods["HIST"], mods["MASK"]
    ref = mods["hsthresh_ref_mod"]
    gen = torch.Generator(device=dev).manual_seed(3)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for b, n in HS_SHAPES:
        # a projected gradient step's shape of data: nonnegative, half zeros
        x = torch.clamp_min(torch.randn(b, n, generator=gen, device=dev), 0.0)
        vmax = ref.row_vmax(x.abs())
        h = HIST(x, vmax, NBINS)
        h_ref = ref.hist_ref(x.abs(), vmax, NBINS)
        t = ref.select_threshold(h, vmax, 30)
        y, y_ref = MASK(x, t), ref.mask_ref(x, t)
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
    return {"rows": rows}


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
    through qniht/qniht_batch: hist and mask launch once per proposal; the
    same solves with the plain versions standing in on the card must give the
    same x and trace bit for bit."""
    HIST, MASK, QMM, cs = mods["HIST"], mods["MASK"], mods["QMM"], mods["LOFAR"]
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
        launches = {"hist": HIST.launches, "mask": MASK.launches, "qmm": QMM.launches,
                    "qmm_group": mods["QMM_GROUP"].launches}
        by_shape.update(HIST.launches_by_shape)
        want_hs = cs.n_iters + backtrack_steps(res)
        want_qmm = expected_launches(res, cs.n_iters)
        with stand_in(mods["hs_ops"], hist_cuda=lambda x, vmax, nbins: ref.hist_ref(
                x.abs(), vmax, nbins), mask_cuda=ref.mask_ref):
            reset_counts(mods)
            res_w = solve(phi, y, cs.n_sources, cs.n_iters, **kw)
            if HIST.launches or MASK.launches:
                raise AssertionError("the witness run launched hist or mask")
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
              f"{wall:.3f} | hist {launches['hist']} mask {launches['mask']} launches "
              f"(predicted {want_hs}), qmm {launches['qmm']} (predicted {want_qmm}) | witness "
              f"(hist_ref/mask_ref on the card) {'bitwise identical' if same else 'DIFFERS'} | "
              f"iterations whose support differs from topk: {int(differ.any(dim=1).sum())} of "
              f"{cs.n_iters} (per row {differ.sum(dim=0).tolist()})", flush=True)
        if not torch.equal(x_hs, res.x if batch else res.x[None]):
            raise AssertionError(f"{label}: the solver's own loop and qniht disagree")
        if not same:
            raise AssertionError(f"{label}: kernel and plain-version solves differ")
        if launches["hist"] != want_hs or launches["mask"] != want_hs:
            raise AssertionError(f"{label}: hist/mask launched {launches['hist']}/"
                                 f"{launches['mask']} times, predicted {want_hs}")
        if launches["qmm"] != want_qmm or launches["qmm_group"]:
            raise AssertionError(f"{label}: qmm launched {launches['qmm']} times (predicted "
                                 f"{want_qmm}), qmm_group {launches['qmm_group']}")
        out[label] = {"rel_error_rows": rel, "topk_rel_error_rows": rel_top, "wall_s": wall,
                      "launches": launches, "hs_launches_predicted": want_hs,
                      "qmm_launches_predicted": want_qmm, "witness_bitwise": same,
                      "iterations_support_differs": int(differ.any(dim=1).sum()),
                      "iterations_support_differs_per_row": differ.sum(dim=0).tolist()}
    out["launches"] = sum(by_shape.values())
    return out


def phase_gaussian_block(torch, mods):
    """The Gaussian toy per_block (g = 64), bits 4 and 8, batch 8, held per
    row against the same solves with qmm_group_ref standing in."""
    QG, recover_gaussian, g = mods["QMM_GROUP"], mods["recover_gaussian"], mods["GAUSS"]
    dev = torch.device(mods["device"])
    out = {}
    for bits in (4, 8):
        label = f"gaussian per_block bits={bits} batch=8"
        reset_counts(mods)
        m_k, r_k, x_true = recover_gaussian(g, "packed", bits, 8, 0, "fixed", 8, dev,
                                            "per_block", GROUP)
        launches = QG.launches
        others = {k.entry: k.launches for k in mods["KERNELS"] if k is not QG and k.launches}
        with stand_in(mods["qmm_ops"], qmm_group_cuda=mods["qmm_group_ref"]):
            reset_counts(mods)
            m_w, r_w, _ = recover_gaussian(g, "packed", bits, 8, 0, "fixed", 8, dev,
                                           "per_block", GROUP)
            if QG.launches:
                raise AssertionError("the witness run launched the group kernel")
        print(f"[chip_smoke]   {label}: rel_error_mean={m_k['rel_error_mean']:.4f} "
              f"wall_s={m_k['wall_s']:.3f} | witness {m_w['rel_error_mean']:.4f} | "
              f"qmm_group launches {launches}", flush=True)
        held = hold_rows(torch, label, r_k, r_w, x_true)
        print(f"[chip_smoke]     ‖Δx_b‖/‖x_b‖ kernel vs witness: "
              + " ".join(f"{v:.1e}" for v in held["dx_rows"]), flush=True)
        if launches == 0 or others:
            raise AssertionError(f"{label}: {launches} qmm_group launches, others {others}")
        out[label] = {"kernel": m_k, "witness": m_w, "launches": launches, **held}
    return out


def load_port() -> dict:
    """Import the port from ``src/`` (the only imports of the program)."""
    sys.path.insert(0, str(SRC))
    from repro_torch import random as prng
    from repro_torch.configs.gaussian_toy import CONFIG as GAUSS
    from repro_torch.configs.lofar_cs302 import BENCH as LOFAR_BENCH, CONFIG as LOFAR
    from repro_torch.core.niht import _solver_setup, qniht_batch
    from repro_torch.kernels.hsthresh import kernel as hs_kernel, ops as hs_ops
    from repro_torch.kernels.hsthresh import ref as hsthresh_ref_mod
    from repro_torch.kernels.qmm import kernel as qmm_kernel
    from repro_torch.kernels.qmm.kernel import QMM, QMM_GROUP
    from repro_torch.kernels.qmm import ops as qmm_ops
    from repro_torch.kernels.qmm.ops import pack_operator, pack_weights
    from repro_torch.kernels.qmm.ref import qmm_group_ref, qmm_ref
    from repro_torch.quant.quantize import expand_block_scale
    from repro_torch.launch.recover import (
        gaussian_batch_instance,
        lofar_instance,
        recover_gaussian,
        recover_lofar,
    )
    from repro_torch.quant.pack import unpack_codes
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
                hsthresh_ref_mod=hsthresh_ref_mod, qniht_batch=qniht_batch,
                solver_setup=_solver_setup,
                KERNELS=(QMM, QMM_GROUP, hs_kernel.HIST, hs_kernel.MASK),
                LIBRARIES=(qmm_kernel.LIBRARY, hs_kernel.LIBRARY))
    return mods


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=str(ROOT / "chip_smoke_out"),
                    help="directory for chip_smoke.json and the profiler trace")
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
    report = {"device": kind}
    report["build"] = phases.run("build", phase_build, mods["LIBRARIES"])
    report["kernel"] = phases.run("kernel-vs-plain", phase_kernel, torch, mods)
    report["group_kernel"] = phases.run("qmm_group-vs-plain", phase_group_kernel, torch, mods)
    report["hs_kernels"] = phases.run("hist-mask-vs-plain", phase_hs_kernels, torch, mods)
    report["lofar"] = phases.run("lofar-main-path", phase_lofar, torch, mods)
    report["lofar_block"] = phases.run("lofar-per-block", phase_lofar_block, torch, mods,
                                       report["lofar"])
    report["lofar_hsthresh"] = phases.run("lofar-hsthresh", phase_lofar_hsthresh, torch, mods)
    report["gaussian"] = phases.run("gaussian", phase_gaussian, torch, mods)
    report["gaussian_block"] = phases.run("gaussian-per-block", phase_gaussian_block, torch,
                                          mods)
    report["profile"] = phases.run("profile", phase_profile, torch, mods)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout else ""
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
                "source": "src/repro_torch/kernels/qmm/csrc/qmm.cu",
                "replaces": replaces,
                "launches": by_orientation[shape],
                "max_abs_err": report[phase]["max_abs_err"],
                "ms": row["ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                "shape": f"{shape} bits={row['bits']} M=1 N={row['N']} K={row['K']}"
                         + (f" g={GROUP}" if name == "qmm_group" else ""),
            })
    for name, replaces in (("hist", "src/repro/kernels/hsthresh/kernel.py:48"),
                           ("mask", "src/repro/kernels/hsthresh/kernel.py:69")):
        row = next(r for r in report["hs_kernels"]["rows"] if r["name"] == name and r["B"] == 1)
        kernels.append({
            "name": f"{name}[lofar]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/hsthresh/csrc/hsthresh.cu",
            "replaces": replaces,
            "launches": report["lofar_hsthresh"]["launches"],
            "max_abs_err": 0.0,
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
            "shape": f"B=1 N={row['N']} nbins={NBINS}",
        })
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
