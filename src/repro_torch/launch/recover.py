"""CS recovery entry point of the port — the paper's end-to-end pipeline on the GPU.

``python -m repro_torch.launch.recover --config lofar --backend packed --bits-phi 2``
simulates the LOFAR station, builds Φ, quantizes it once and recovers the sky
with the packed codes streaming through the Hopper ``qmm`` kernel. It prints
the reference's ``[recover] <config> <label>: rel_error=... wall_s=...`` line.

Backends (``--backend``):

* ``dense``  — full-precision NIHT (dense f32/c64 Φ, ``torch.matmul``).
* ``fake``   — QNIHT with fake quantization: quantized values carried as
  dense floats (``--requantize pair`` redraws Φ̂ each iteration, ``fixed``
  quantizes once).
* ``packed`` — QNIHT streaming packed uint8 codes through ``qmm`` (forces
  ``requantize=fixed``). Same codes as ``fake --requantize fixed`` with the
  same ``--seed``.

``--scale-granularity per_channel|per_block`` (with ``--group-size g`` for
``per_block``) gives the packed Φ̂ one scale per row or per g codes along the
contraction instead of one per tensor; each orientation is then quantized on
its own, and ``per_block`` streams through the group kernel. It needs
``--backend packed``.

``--batch B`` recovers B observations of one Φ̂ at once (``qniht_batch``).
``--device`` defaults to ``cuda``; ``--device cpu`` runs the plain PyTorch
versions on the CPU. Problem instances come from a ``torch.Generator`` seeded
with ``--seed``; the quantization draws from ``repro_torch.random.PRNGKey(seed)``.

The streaming H_s (``threshold="hsthresh"``) has no flag here, as in the
reference's CLI; it is reached through ``qniht``/``qniht_batch``.

Not yet ported: the ``mri*`` configs, ``--devices``, ``--checkpoint-dir`` and
``--scale-granularity per_band`` (the MRI observation scales).
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch import random as prng
from repro_torch.configs.gaussian_toy import CONFIG as GAUSS_CONFIG, SMOKE as GAUSS_SMOKE
from repro_torch.configs.lofar_cs302 import (
    BENCH as LOFAR_BENCH,
    CONFIG as LOFAR_CONFIG,
    SMOKE as LOFAR_SMOKE,
)
from repro_torch.core.niht import niht, qniht, qniht_batch
from repro_torch.core.recovery import relative_error, source_recovery, support_recovery
from repro_torch.device import resolve_device
from repro_torch.sensing.gaussian import make_gaussian_problem
from repro_torch.sensing.sky import make_sky
from repro_torch.sensing.telescope import Station, measurement_matrix, visibilities

CONFIGS = {"lofar": LOFAR_CONFIG, "lofar-bench": LOFAR_BENCH, "lofar-smoke": LOFAR_SMOKE,
           "gaussian": GAUSS_CONFIG, "gaussian-smoke": GAUSS_SMOKE}
NOT_PORTED = ("mri", "mri-bench", "mri-smoke", "mri-wavelet", "mri-wavelet-bench",
              "mri-wavelet-smoke")


def _solver_kwargs(backend, bits_phi, bits_y, key, requantize, granularity="per_tensor",
                   group_size=None):
    if granularity != "per_tensor" and backend != "packed":
        raise ValueError(
            f"--scale-granularity {granularity} scales the packed Φ̂ stream; "
            f"combine it with --backend packed (got --backend {backend})")
    if backend == "dense":
        return {}
    kw = dict(bits_phi=bits_phi, bits_y=bits_y, key=key,
              requantize="fixed" if backend == "packed" else requantize,
              backend="packed" if backend == "packed" else "dense")
    if granularity != "per_tensor":
        kw.update(scale_granularity=granularity, group_size=group_size)
    return kw


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lofar_instance(cs, seed, batch, device):
    """The LOFAR station's Φ and B skies with their visibilities (one sky
    when ``batch`` is 0). Returns (phi, Y, X_true); Y and X_true lose the
    batch axis when ``batch`` is 0."""
    gen = torch.Generator().manual_seed(seed)
    phi = measurement_matrix(Station(n_antennas=cs.n_antennas, seed=cs.seed),
                             cs.resolution, cs.extent, device=device)
    skies = [make_sky(cs.resolution, cs.n_sources, gen, min_sep=cs.min_sep, device=device)
             for _ in range(max(batch, 1))]
    vis = [visibilities(phi, x, cs.snr_db, gen)[0] for x in skies]
    if not batch:
        return phi, vis[0], skies[0]
    return phi, torch.stack(vis), torch.stack(skies)


def recover_lofar(cs, backend, bits_phi, bits_y, seed=0, requantize="pair", batch=0,
                  device=None, granularity="per_tensor", group_size=None):
    """LOFAR sky recovery. Returns (metrics dict, IHTResult, x_true)."""
    dev = resolve_device(device)
    key = prng.PRNGKey(seed)
    kw = _solver_kwargs(backend, bits_phi, bits_y, key, requantize, granularity, group_size)
    phi, y, x = lofar_instance(cs, seed, batch, dev)
    if batch:
        Y, X_true = y, x
        _sync(dev)
        t0 = time.perf_counter()
        res = qniht_batch(phi, Y, cs.n_sources, cs.n_iters, real_signal=True,
                          nonneg=True, **kw)
        _sync(dev)
        wall = time.perf_counter() - t0
        rel = [float(relative_error(res.x[b], X_true[b])) for b in range(batch)]
        return ({"batch": batch, "rel_error_mean": sum(rel) / batch,
                 "rel_error_max": max(rel), "wall_s": wall}, res, X_true)
    _sync(dev)
    t0 = time.perf_counter()
    if backend == "dense":
        res = niht(phi, y, cs.n_sources, cs.n_iters, real_signal=True, nonneg=True)
    else:
        res = qniht(phi, y, cs.n_sources, cs.n_iters, real_signal=True, nonneg=True, **kw)
    _sync(dev)
    wall = time.perf_counter() - t0
    r = cs.resolution
    out = {
        "rel_error": float(relative_error(res.x, x)),
        "support_recovery": float(support_recovery(res.x, x, cs.n_sources)),
        "source_recovery": float(source_recovery(res.x.real.reshape(r, r),
                                                 x.reshape(r, r), cs.n_sources, 1)),
        "wall_s": wall,
        "resid_true": [float(v) for v in res.trace.resid_true[-3:]],
    }
    return out, res, x


def gaussian_batch_instance(g, seed, batch, device):
    """The ``--batch`` Gaussian instance: Φ, then B problems sharing it (fresh
    sparse signals and noise per row). Returns (phi, Y, X_true)."""
    gen = torch.Generator().manual_seed(seed)
    prob = make_gaussian_problem(g.m, g.n, g.s, 20.0, generator=gen, device=device)
    probs = [make_gaussian_problem(g.m, g.n, g.s, 20.0, generator=gen, phi=prob.phi,
                                   device=device) for _ in range(batch)]
    return prob.phi, torch.stack([p.y for p in probs]), torch.stack([p.x_true for p in probs])


def recover_gaussian(g, backend, bits_phi, bits_y, seed=0, requantize="pair", batch=0,
                     device=None, granularity="per_tensor", group_size=None):
    """Gaussian toy recovery. Returns (metrics dict, IHTResult, x_true)."""
    dev = resolve_device(device)
    key = prng.PRNGKey(seed)
    kw = _solver_kwargs(backend, bits_phi, bits_y, key, requantize, granularity, group_size)
    if batch:
        phi, Y, X_true = gaussian_batch_instance(g, seed, batch, dev)
        _sync(dev)
        t0 = time.perf_counter()
        res = qniht_batch(phi, Y, g.s, g.n_iters, **kw)
        _sync(dev)
        wall = time.perf_counter() - t0
        rel = [float(relative_error(res.x[b], X_true[b])) for b in range(batch)]
        return ({"batch": batch, "rel_error_mean": sum(rel) / batch,
                 "rel_error_max": max(rel), "wall_s": wall}, res, X_true)
    prob = make_gaussian_problem(g.m, g.n, g.s, 20.0,
                                 generator=torch.Generator().manual_seed(seed), device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    res = (niht(prob.phi, prob.y, g.s, g.n_iters) if backend == "dense" else
           qniht(prob.phi, prob.y, g.s, g.n_iters, **kw))
    _sync(dev)
    wall = time.perf_counter() - t0
    return ({"rel_error": float(relative_error(res.x, prob.x_true)),
             "support_recovery": float(support_recovery(res.x, prob.x_true, g.s)),
             "wall_s": wall}, res, prob.x_true)


def format_line(config: str, label: str, out: dict) -> str:
    return f"[recover] {config} {label}: " + " ".join(
        f"{k}={v if not isinstance(v, float) else round(v, 4)}" for k, v in out.items())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="lofar-bench", choices=[*CONFIGS, *NOT_PORTED])
    ap.add_argument("--backend", default="fake", choices=["dense", "fake", "packed"])
    ap.add_argument("--bits-phi", type=int, default=2)
    ap.add_argument("--bits-y", type=int, default=8)
    ap.add_argument("--requantize", default="pair", choices=["pair", "fixed"])
    ap.add_argument("--batch", type=int, default=0,
                    help="recover B observations of one Φ̂ at once (qniht_batch)")
    ap.add_argument("--scale-granularity", default=None,
                    choices=["per_tensor", "per_channel", "per_block", "per_band"],
                    help="scale layout of the packed Φ̂ (--backend packed): one per "
                         "tensor, per row, or per --group-size codes along the "
                         "contraction")
    ap.add_argument("--group-size", type=int, default=None,
                    help="per_block group size along the contraction axis (a "
                         "multiple of 8 / --bits-phi)")
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    if args.config in NOT_PORTED:
        ap.exit(2, f"recover: --config {args.config} is not yet ported\n")
    if args.devices is not None:
        ap.exit(2, "recover: --devices is not yet ported\n")
    if args.checkpoint_dir is not None:
        ap.exit(2, "recover: --checkpoint-dir is not yet ported\n")
    if args.scale_granularity == "per_band":
        ap.exit(2, "recover: --scale-granularity per_band is not yet ported\n")
    gran = args.scale_granularity or "per_tensor"
    if gran == "per_block" and args.group_size is None:
        ap.error("--scale-granularity per_block needs --group-size")
    backend = args.backend
    run = recover_lofar if args.config.startswith("lofar") else recover_gaussian
    out, _, _ = run(CONFIGS[args.config], backend, args.bits_phi, args.bits_y, args.seed,
                    args.requantize, args.batch, args.device, gran, args.group_size)
    label = "32bit" if backend == "dense" else f"{args.bits_phi}&{args.bits_y}bit[{backend}]"
    print(format_line(args.config, label, out), flush=True)


if __name__ == "__main__":
    sys.exit(main())
