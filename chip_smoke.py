#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU (H100).

Run from the root of a checkout, with one card:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package ``repro``. Phases
(any failure makes the exit code non-zero and suppresses the result line):

1. build the Hopper ``qmm`` kernel from ``src/repro_torch/kernels/qmm/csrc``;
2. hold the kernel against its plain PyTorch version ``qmm_ref`` on the card
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
5. a torch.profiler trace of one packed single-row LOFAR solve: device time by
   kernel and the device's busy share (``lofar_packed_trace.json``).

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


def bound_ms(m, n, k, kp):
    nbytes = n * kp + 4 * m * k + 4 * m * n + 4 * n
    flops = 2 * m * n * k
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


def phase_build(QMM):
    QMM.build()
    ptxas = [ln.strip() for ln in QMM.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[chip_smoke] built {QMM.library_path().name} in {QMM.build_seconds:.1f} s; "
          f"{len(ptxas) // 2} kernel instantiations", flush=True)
    for ln in ptxas[:12]:
        print(f"[chip_smoke]   ptxas {ln}", flush=True)
    return {"seconds": QMM.build_seconds, "ptxas": ptxas}


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
        QMM.reset_counts()
        m_p, r_p, _ = recover_lofar(cs, "packed", cs.bits_phi, cs.bits_y, 0, "fixed", batch,
                                  mods["device"])
        launches = QMM.launches
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
def plain_qmm_on_card(ops, qmm_ref):
    """The packed path with the plain version ``qmm_ref`` standing in for the
    kernel on CUDA tensors (the Gaussian phase's second witness: the same
    code path with cuBLAS's summation order in place of the kernel's)."""
    kernel = ops.qmm_cuda
    ops.qmm_cuda = qmm_ref
    try:
        yield
    finally:
        ops.qmm_cuda = kernel


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
        QMM.reset_counts()
        m_p, r_p, xt = recover_gaussian(g, "packed", bits, 8, 0, "fixed", 8, dev)
        launches = QMM.launches
        m_f, r_f, _ = recover_gaussian(g, "fake", bits, 8, 0, "fixed", 8, dev)
        with plain_qmm_on_card(mods["qmm_ops"], mods["qmm_ref"]):
            QMM.reset_counts()
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
    single-row LOFAR solve (torch.profiler, CUPTI). Reports "not measured"
    when the profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cs, dev = mods["LOFAR"], torch.device(mods["device"])
    gen = torch.Generator().manual_seed(0)
    phi = mods["measurement_matrix"](mods["Station"](n_antennas=cs.n_antennas, seed=cs.seed),
                                     cs.resolution, cs.extent, device=dev)
    x = mods["make_sky"](cs.resolution, cs.n_sources, gen, min_sep=cs.min_sep, device=dev)
    y, _ = mods["visibilities"](phi, x, cs.snr_db, gen)
    kw = dict(bits_phi=cs.bits_phi, bits_y=cs.bits_y, key=mods["prng"].PRNGKey(0),
              requantize="fixed", backend="packed", real_signal=True, nonneg=True)
    mods["qniht"](phi, y, cs.n_sources, 2, **kw)          # warm-up (allocator, kernel)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mods["qniht"](phi, y, cs.n_sources, 0, **kw)          # set-up only: ŷ draw, Φ̂ quantize + pack
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
            continue                                      # host-side op rows repeat the time
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            rows.append({"name": ev.key, "device_ms": us / 1e3, "calls": ev.count})
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in rows)
    out_dir = mods["out_dir"]
    out_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_dir / "lofar_packed_trace.json"))
    if not rows:
        print("[chip_smoke]   profile: no device time seen (not measured)", flush=True)
        return {"wall_ms": wall_ms, "setup_ms": setup_ms, "device_busy_ms": None, "kernels": []}
    qmm_ms = sum(r["device_ms"] for r in rows if "qmm_kernel" in r["name"])
    print(f"[chip_smoke]   profile of one packed LOFAR solve: wall {wall_ms:.1f} ms (set-up "
          f"alone {setup_ms:.1f} ms), device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), qmm kernels {qmm_ms:.1f} ms", flush=True)
    for r in rows[:10]:
        print(f"[chip_smoke]     {r['device_ms']:9.3f} ms  {r['calls']:6d}×  {r['name'][:90]}",
              flush=True)
    return {"wall_ms": wall_ms, "setup_ms": setup_ms, "device_busy_ms": busy_ms,
            "qmm_device_ms": qmm_ms, "kernels": rows[:40]}


def load_port() -> dict:
    """Import the port from ``src/`` (the only imports of the program)."""
    sys.path.insert(0, str(SRC))
    from repro_torch import random as prng
    from repro_torch.configs.gaussian_toy import CONFIG as GAUSS
    from repro_torch.configs.lofar_cs302 import BENCH as LOFAR_BENCH, CONFIG as LOFAR
    from repro_torch.kernels.qmm.kernel import QMM
    from repro_torch.kernels.qmm import ops as qmm_ops
    from repro_torch.kernels.qmm.ops import pack_operator, pack_weights
    from repro_torch.kernels.qmm.ref import qmm_ref
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
                LOFAR_BENCH=LOFAR_BENCH, device="cuda")
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
    LOFAR, QMM = mods["LOFAR"], mods["QMM"]
    kind = torch.cuda.get_device_name(0)
    print(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda} on {kind}",
          flush=True)
    phases = Phases()
    t0 = time.perf_counter()
    report = {"device": kind}
    report["build"] = phases.run("build", phase_build, QMM)
    report["kernel"] = phases.run("kernel-vs-plain", phase_kernel, torch, mods)
    report["lofar"] = phases.run("lofar-main-path", phase_lofar, torch, mods)
    report["gaussian"] = phases.run("gaussian", phase_gaussian, torch, mods)
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
    by_orientation = report["lofar"]["launches_by_orientation"]
    kernels = []
    for shape in ("lofar_fwd", "lofar_adj"):
        row = next(r for r in report["kernel"]["rows"]
                   if r["shape"] == shape and r["bits"] == LOFAR.bits_phi and r["M"] == 1)
        kernels.append({
            "name": f"qmm[{shape}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/qmm/csrc/qmm.cu",
            "replaces": "src/repro/kernels/qmm/kernel.py:265",
            "launches": by_orientation[shape],
            "max_abs_err": report["kernel"]["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": f"{shape} bits={row['bits']} M=1 N={row['N']} K={row['K']}",
        })
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
