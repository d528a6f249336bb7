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
versions on the CPU. Everything random draws from
``repro_torch.random.PRNGKey(seed)`` as the reference draws from its key: the
LOFAR sky and its noise from the key (row b of a batch from ``fold_in(key,
b)``), the Gaussian instance from the key (row b from ``fold_in(key, b + 1)``
sharing its Φ), so ``--seed`` solves the reference's instance: positions and
supports bit for bit, y to the tolerance of ``random.normal``.

``--config mri`` (also ``mri-bench``/``mri-smoke``) runs the paper's §5 MRI
workload: a brain phantom recovered from quantized variable-density k-space
samples through the matrix-free Φ = P_Ω F (``torch.fft``), so the backend
knobs do not apply; ``--bits-y`` is the precision under study and the line
reports PSNR in image space. ``--sparsity-basis haar|db4`` recovers the whole
phantom's wavelet coefficients through Φ = P_Ω F W†; ``--config mri-wavelet``
(also ``-bench``/``-smoke``) preselects Haar with per-band scaling.
``--scale-granularity per_band`` quantizes the observations with one scale
per radial k-space band, ``--group-size`` of them. With ``--batch B``, B
randomized brain phantoms share one mask. The MRI instance is the
reference's for the same ``--seed`` (mask and phantoms bit for bit).

``--checkpoint-dir D`` runs the solve in segments of ``--ckpt-every``
iterations with a checkpoint after each
(:func:`repro_torch.launch.resilience.recover_resilient`); SIGTERM or SIGINT
writes a last checkpoint and exits cleanly, and ``--resume`` goes on from
the newest complete checkpoint, to the bits of the uninterrupted run.

``--sanitize`` runs the solve under :func:`repro_torch.analysis.sanitize.sanitize`:
a NaN or Inf produced by any operation or kernel raises ``FloatingPointError``
naming it, and a ``[sanitize] ok ...`` line reports the kernel-library builds.
``--profile-dir D`` writes a ``torch.profiler`` trace (CPU and CUDA activity,
Chrome/Perfetto JSON) of the whole solve to ``D``. ``--full-precision`` is
``--backend dense``.

``--devices N`` (with ``--batch``) splits the batch's rows over N ranks
(:func:`~repro_torch.core.niht.qniht_batch_sharded`, one process per shard
started by :func:`~repro_torch.parallel.dist.spawn_ranks`): every rank builds
the instance, solves its rows, and gathers the rest; only rank 0 prints, and
its line is the one-device run's bit for bit (``early_exit`` is on, as in the
reference, wherever Φ̂ is stationary). ``--dist-backend`` names the process
group's backend: ``nccl`` (the default on the card: one rank per card) or
``gloo`` (the CPU's, and on the card ranks that share the cards). With
``--checkpoint-dir`` the ranks checkpoint together (rank 0 writes), and
``--resume`` goes on at any width. ``--sanitize`` and ``--profile-dir``
act in every rank (rank 0's ``[sanitize]`` line; one trace per rank under
``D/rank_<r>``).

The streaming H_s (``threshold="hsthresh"``) has no flag here, as in the
reference's CLI; it is reached through ``qniht``/``qniht_batch``.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import os
import sys
import time

import torch

from repro_torch import random as prng
from repro_torch.configs import CONFIGS
from repro_torch.core.niht import (
    IHTResult,
    IHTTrace,
    niht,
    qniht,
    qniht_batch,
    qniht_batch_sharded,
)
from repro_torch.core.recovery import (
    psnr,
    relative_error,
    source_recovery,
    support_recovery,
)
from repro_torch.device import resolve_device
from repro_torch.sensing.gaussian import make_gaussian_problem
from repro_torch.sensing.mri import (
    brain_phantom,
    make_mri_problem,
    mri_observations,
    quantize_observations,
    sparsify_image,
)
from repro_torch.sensing.sky import make_sky
from repro_torch.sensing.telescope import Station, measurement_matrix, visibilities


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


def x_digest(x: torch.Tensor) -> str:
    """The first 16 hex digits of the sha256 of x's bytes: equal digests, equal
    bits (the batch lines print it, so runs at two ``--devices`` widths
    compare)."""
    return hashlib.sha256(x.detach().cpu().contiguous().numpy().tobytes()).hexdigest()[:16]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _early_exit(kw) -> bool:
    """``early_exit`` wherever Φ̂ is stationary (not ``requantize='pair'``
    with a quantized Φ̂, which redraws it every iteration)."""
    return not (kw.get("bits_phi") and kw.get("requantize", "pair") == "pair")


def _batch_solver(ckpt, mesh=None):
    """qniht_batch, or its sharded twin on ``mesh`` (``--devices``), or with
    ``ckpt`` (``--checkpoint-dir``) the segmented checkpointed runner: the
    same arguments and the same bits."""
    if not ckpt:
        if mesh is None:
            return qniht_batch

        def sharded(phi, Y, s, n_iters, **kw):
            return qniht_batch_sharded(phi, Y, s, n_iters, mesh=mesh,
                                       early_exit=_early_exit(kw), **kw)
        return sharded
    from repro_torch.launch.resilience import recover_resilient

    def run(phi, Y, s, n_iters, **kw):
        if mesh is not None:
            kw.setdefault("early_exit", _early_exit(kw))
        return recover_resilient(phi, Y, s, n_iters, verbose=True, mesh=mesh, **ckpt, **kw)
    return run


def _single_via_ckpt(ckpt, phi, y, s, n_iters, **kw) -> IHTResult:
    """One problem through the checkpointed runner, as a batch of one row."""
    res = _batch_solver(ckpt)(phi, y[None, :], s, n_iters, **kw)
    return IHTResult(x=res.x[0], trace=IHTTrace(*(t[:, 0] for t in res.trace)))


def lofar_instance(cs, seed, batch, device):
    """The LOFAR station's Φ and B skies with their visibilities (one sky
    when ``batch`` is 0), as the reference draws them: the sky and its noise
    from ``PRNGKey(seed)``, row b of a batch from ``fold_in(key, b)``.
    Returns (phi, Y, X_true); Y and X_true lose the batch axis when
    ``batch`` is 0."""
    key = prng.PRNGKey(seed)
    phi = measurement_matrix(Station(n_antennas=cs.n_antennas, seed=cs.seed),
                             cs.resolution, cs.extent, device=device)
    keys = [prng.fold_in(key, b) for b in range(batch)] if batch else [key]
    skies = [make_sky(cs.resolution, cs.n_sources, k, min_sep=cs.min_sep, device=device)
             for k in keys]
    vis = [visibilities(phi, x, cs.snr_db, k)[0] for x, k in zip(skies, keys)]
    if not batch:
        return phi, vis[0], skies[0]
    return phi, torch.stack(vis), torch.stack(skies)


def recover_lofar(cs, backend, bits_phi, bits_y, seed=0, requantize="pair", batch=0,
                  device=None, granularity="per_tensor", group_size=None, ckpt=None,
                  mesh=None):
    """LOFAR sky recovery. Returns (metrics dict, IHTResult, x_true). ``ckpt``
    (``checkpoint_dir``, ``ckpt_every``, ``resume``) runs it checkpointed;
    ``mesh`` splits a batch's rows over its ranks (on the rank's device)."""
    dev = resolve_device(device)
    key = prng.PRNGKey(seed)
    kw = _solver_kwargs(backend, bits_phi, bits_y, key, requantize, granularity, group_size)
    phi, y, x = lofar_instance(cs, seed, batch, dev)
    if batch:
        Y, X_true = y, x
        _sync(dev)
        t0 = time.perf_counter()
        res = _batch_solver(ckpt, mesh)(phi, Y, cs.n_sources, cs.n_iters, real_signal=True,
                                        nonneg=True, **kw)
        _sync(dev)
        wall = time.perf_counter() - t0
        rel = [float(relative_error(res.x[b], X_true[b])) for b in range(batch)]
        return ({"batch": batch, "rel_error_mean": sum(rel) / batch,
                 "rel_error_max": max(rel), "x_digest": x_digest(res.x), "wall_s": wall},
                res, X_true)
    _sync(dev)
    t0 = time.perf_counter()
    if ckpt:
        res = _single_via_ckpt(ckpt, phi, y, cs.n_sources, cs.n_iters, real_signal=True,
                               nonneg=True, **kw)
    elif backend == "dense":
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
    """The ``--batch`` Gaussian instance: Φ from ``PRNGKey(seed)``, then B
    problems sharing it, row b's sparse signal and noise from ``fold_in(key,
    b + 1)``, as the reference draws them. Returns (phi, Y, X_true)."""
    key = prng.PRNGKey(seed)
    prob = make_gaussian_problem(g.m, g.n, g.s, 20.0, key, device=device)
    probs = [make_gaussian_problem(g.m, g.n, g.s, 20.0, prng.fold_in(key, b + 1),
                                   phi=prob.phi, device=device) for b in range(batch)]
    return prob.phi, torch.stack([p.y for p in probs]), torch.stack([p.x_true for p in probs])


def recover_gaussian(g, backend, bits_phi, bits_y, seed=0, requantize="pair", batch=0,
                     device=None, granularity="per_tensor", group_size=None, ckpt=None,
                     mesh=None):
    """Gaussian toy recovery. Returns (metrics dict, IHTResult, x_true)."""
    dev = resolve_device(device)
    key = prng.PRNGKey(seed)
    kw = _solver_kwargs(backend, bits_phi, bits_y, key, requantize, granularity, group_size)
    if batch:
        phi, Y, X_true = gaussian_batch_instance(g, seed, batch, dev)
        _sync(dev)
        t0 = time.perf_counter()
        res = _batch_solver(ckpt, mesh)(phi, Y, g.s, g.n_iters, **kw)
        _sync(dev)
        wall = time.perf_counter() - t0
        rel = [float(relative_error(res.x[b], X_true[b])) for b in range(batch)]
        return ({"batch": batch, "rel_error_mean": sum(rel) / batch,
                 "rel_error_max": max(rel), "x_digest": x_digest(res.x), "wall_s": wall},
                res, X_true)
    prob = make_gaussian_problem(g.m, g.n, g.s, 20.0, key, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    if ckpt:
        res = _single_via_ckpt(ckpt, prob.phi, prob.y, g.s, g.n_iters, **kw)
    else:
        res = (niht(prob.phi, prob.y, g.s, g.n_iters) if backend == "dense" else
               qniht(prob.phi, prob.y, g.s, g.n_iters, **kw))
    _sync(dev)
    wall = time.perf_counter() - t0
    return ({"rel_error": float(relative_error(res.x, prob.x_true)),
             "support_recovery": float(support_recovery(res.x, prob.x_true, g.s)),
             "wall_s": wall}, res, prob.x_true)


def mri_batch_truth(cfg, key, batch, basis, device):
    """The ``--batch`` MRI truth: B randomized brain phantoms, (B, r²) in
    image space (s-sparsified, with a 1e-3 jitter that breaks the skull
    ring's exact top-s ties, for the pixel basis), as the reference draws
    them."""
    r = cfg.resolution

    def truth(b):
        img = brain_phantom(r, prng.fold_in(key, b), device=device)
        if basis != "pixel":
            return img.reshape(-1)
        jitter = 1e-3 * prng.uniform(prng.fold_in(key, 100 + b), tuple(img.shape),
                                     device=device)
        return sparsify_image(img + jitter, cfg.n_sparse)

    return torch.stack([truth(b) for b in range(batch)])


def mri_instance(cfg, seed, batch, device, bits_y=8, granularity="per_tensor",
                 n_bands=None, sparsity_basis=None):
    """The MRI problem ``recover_mri`` solves: (prob, Y, image truth, solver
    kwargs). ``Y`` is (B, M) for ``batch`` (else prob.y) and already
    quantized for ``per_band``; the kwargs carry ``bits_y``/``key`` for the
    solver's own per_tensor draw."""
    dev = resolve_device(device)
    key = prng.PRNGKey(seed)
    basis = sparsity_basis if sparsity_basis is not None else cfg.sparsity_basis
    prob = make_mri_problem(cfg.resolution, cfg.n_sparse, cfg.fraction, key,
                            density=cfg.density, center_fraction=cfg.center_fraction,
                            snr_db=cfg.snr_db, phantom=cfg.phantom, sparsity_basis=basis,
                            wavelet_levels=cfg.wavelet_levels, device=dev)
    n_bands = n_bands if n_bands is not None else cfg.n_bands
    # wavelet coefficients are signed; only the pixel basis is a nonneg image
    kw = dict(real_signal=True, nonneg=basis == "pixel")
    if batch:
        truth = mri_batch_truth(cfg, key, batch, basis, dev)
        y, _ = mri_observations(getattr(prob.op, "kspace_op", prob.op), truth, cfg.snr_db,
                                prng.fold_in(key, batch))
    else:
        truth, y = prob.image_true, prob.y
    if bits_y and granularity == "per_band":
        y = quantize_observations(y, bits_y, key, granularity="per_band", op=prob.op,
                                  n_bands=n_bands)
    elif bits_y:
        kw.update(bits_y=bits_y, key=key)
    return prob, y, truth, kw


def recover_mri(cfg, bits_y, seed=0, batch=0, device=None, granularity="per_tensor",
                n_bands=None, sparsity_basis=None, ckpt=None, mesh=None):
    """The matrix-free §5 workload: image-space PSNR and relative error of the
    recovered phantom(s). ``bits_y=None`` keeps full-precision observations;
    ``per_band`` quantizes them with one scale per radial k-space band
    (``n_bands``, default the config's). Returns (metrics dict, IHTResult,
    image truth)."""
    dev = resolve_device(device)
    basis = sparsity_basis if sparsity_basis is not None else cfg.sparsity_basis
    prob, y, truth, kw = mri_instance(cfg, seed, batch, dev, bits_y, granularity, n_bands,
                                      basis)
    r = cfg.resolution
    n_bands = n_bands if n_bands is not None else cfg.n_bands
    _sync(dev)
    t0 = time.perf_counter()
    if batch:
        res = _batch_solver(ckpt, mesh)(prob.op, y, cfg.n_sparse, cfg.n_iters, **kw)
    elif ckpt:
        res = _single_via_ckpt(ckpt, prob.op, y, cfg.n_sparse, cfg.n_iters, **kw)
    else:
        res = qniht(prob.op, y, cfg.n_sparse, cfg.n_iters, **kw)
    _sync(dev)
    wall = time.perf_counter() - t0
    img_hat = prob.to_image(res.x)
    if batch:
        ps = [float(psnr(img_hat[b].reshape(r, r), truth[b].reshape(r, r)))
              for b in range(batch)]
        rel = [float(relative_error(img_hat[b], truth[b])) for b in range(batch)]
        return ({"basis": basis, "batch": batch, "m": prob.op.shape[0],
                 "psnr_mean": sum(ps) / batch, "psnr_min": min(ps),
                 "rel_error_mean": sum(rel) / batch, "rel_error_max": max(rel),
                 "x_digest": x_digest(res.x), "wall_s": wall}, res, truth)
    out = {"basis": basis, "m": prob.op.shape[0],
           "psnr": float(psnr(img_hat.reshape(r, r), truth.reshape(r, r))),
           "rel_error": float(relative_error(img_hat, truth)),
           "wall_s": wall, "phi_nbytes": prob.op.nbytes}
    if bits_y and granularity == "per_band":
        out["y_scale_bytes"] = 4 * n_bands
    return out, res, truth


def format_line(config: str, label: str, out: dict) -> str:
    return f"[recover] {config} {label}: " + " ".join(
        f"{k}={v if not isinstance(v, float) else round(v, 4)}" for k, v in out.items())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="lofar-bench", choices=list(CONFIGS))
    ap.add_argument("--backend", default="fake", choices=["dense", "fake", "packed"])
    ap.add_argument("--bits-phi", type=int, default=2)
    ap.add_argument("--bits-y", type=int, default=8)
    ap.add_argument("--full-precision", action="store_true", help="alias for --backend dense")
    ap.add_argument("--requantize", default="pair", choices=["pair", "fixed"])
    ap.add_argument("--batch", type=int, default=0,
                    help="recover B observations of one Φ̂ at once (qniht_batch)")
    ap.add_argument("--scale-granularity", default=None,
                    choices=["per_tensor", "per_channel", "per_block", "per_band"],
                    help="quantizer scale layout: per_channel/per_block for the packed "
                         "Φ̂ (--backend packed), per_band for the MRI observations "
                         "(default: the MRI config's, else per_tensor)")
    ap.add_argument("--group-size", type=int, default=None,
                    help="per_block group size along the contraction axis (a multiple "
                         "of 8 / --bits-phi), or the number of radial k-space bands "
                         "for per_band (default: the MRI config's n_bands)")
    ap.add_argument("--sparsity-basis", default=None, choices=["pixel", "haar", "db4"],
                    help="MRI recovery model: the s-sparse phantom in pixels, or the "
                         "whole phantom's wavelet coefficients through Φ = P_Ω F W† "
                         "(default: the config's)")
    ap.add_argument("--devices", type=int, default=None,
                    help="split the --batch rows over N ranks, one process each "
                         "(qniht_batch_sharded; bit for bit the one-device rows)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="the ranks' process-group backend with --devices N > 1 (default: "
                         "nccl on the card, one rank per card; gloo on the CPU, and on the "
                         "card when ranks share it)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="run the solve in checkpointed segments saved to this "
                         "directory (SIGTERM/SIGINT writes a last checkpoint and exits "
                         "cleanly; the result has the bits of an unsegmented run)")
    ap.add_argument("--ckpt-every", type=int, default=10,
                    help="iterations per segment and checkpoint (with --checkpoint-dir)")
    ap.add_argument("--resume", action="store_true",
                    help="go on from the newest complete checkpoint in --checkpoint-dir "
                         "(a fresh start when there is none)")
    ap.add_argument("--sanitize", action="store_true",
                    help="run the solve under repro_torch.analysis.sanitize: any NaN/Inf "
                         "raises at the producing op or kernel, and a [sanitize] line "
                         "reports the kernel-library builds")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace (CPU and CUDA activity, "
                         "Chrome/Perfetto JSON) of the whole solve to this directory")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    if args.devices is not None:
        if args.devices < 1:
            ap.error("--devices must be >= 1")
        if not args.batch:
            ap.error("--devices shards the batch axis; combine it with --batch B")
    if args.dist_backend and not (args.devices or 0) > 1:
        ap.error("--dist-backend names the backend of the ranks of --devices N > 1")
    if (args.resume or args.ckpt_every != 10) and not args.checkpoint_dir:
        ap.error("--resume/--ckpt-every need --checkpoint-dir")
    if args.ckpt_every < 1:
        ap.error("--ckpt-every must be >= 1")
    ckpt = (dict(checkpoint_dir=args.checkpoint_dir, ckpt_every=args.ckpt_every,
                 resume=args.resume) if args.checkpoint_dir else None)
    if args.sparsity_basis and not args.config.startswith("mri"):
        ap.error("--sparsity-basis selects the MRI recovery model; use an mri config")
    _check_instance_args(ap, args)
    if (args.devices or 0) > 1:
        from repro_torch.parallel.dist import spawn_ranks

        resolve_device(args.device)
        spawn_ranks(_rank_main, args.devices, device=args.device, backend=args.dist_backend,
                    args=(args, ckpt))
        return
    mesh = None
    if args.devices:
        from repro_torch.parallel.batch import make_batch_mesh

        mesh = make_batch_mesh(1, args.device)
    _solve_and_print(args, ckpt, mesh, args.profile_dir)


def _rank_main(mesh, args, ckpt):
    """One rank of ``--devices N``: the whole run on the rank's device, with
    the rows split over the ranks; rank 0 prints, and each rank writes its
    own profile under ``--profile-dir``."""
    prof = (os.path.join(args.profile_dir, f"rank_{mesh.rank}") if args.profile_dir
            else None)
    _solve_and_print(args, ckpt, mesh, prof)


def _solve_and_print(args, ckpt, mesh, profile_dir):
    """The solve the arguments ask for, and its ``[recover]`` line (on rank 0
    of a mesh): a preemption's line instead when SIGTERM/SIGINT stopped a
    checkpointed run."""
    from repro_torch.launch.resilience import Preempted

    backend = "dense" if args.full_precision else args.backend
    cfg = CONFIGS[args.config]
    device = mesh.device if mesh is not None else args.device
    speak = mesh is None or mesh.is_writer
    if args.sanitize:
        from repro_torch.analysis.sanitize import sanitize

        ctx = sanitize()
    else:
        ctx = contextlib.nullcontext()
    counter = None
    try:
        with profiled(profile_dir, device), ctx as counter:
            out, label = _run(args, cfg, backend, ckpt, device, mesh)
    except Preempted as e:
        if speak:
            print(f"[recover] {e}; restart with --resume to continue", flush=True)
        return
    if speak:
        if counter is not None:
            print(f"[sanitize] ok {counter.summary()} debug_nans=on debug_infs=on",
                  flush=True)
        print(format_line(args.config, label, out), flush=True)


@contextlib.contextmanager
def profiled(profile_dir, device):
    """A ``torch.profiler`` trace of the enclosed block, CPU and (on a CUDA
    device) CUDA activity, exported as Chrome/Perfetto JSON to
    ``profile_dir/trace.json``; nothing when ``profile_dir`` is None."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def _check_instance_args(ap, args) -> None:
    """The combinations of instance flags the solve refuses (exit 2)."""
    if args.config.startswith("mri"):
        if args.scale_granularity in ("per_channel", "per_block"):
            ap.error("the MRI Φ is matrix-free (nothing packed to scale); "
                     "use --scale-granularity per_band for the observations")
        return
    gran = args.scale_granularity or "per_tensor"
    if gran == "per_band":
        ap.error("per_band is the MRI observation granularity; use an mri config")
    if gran == "per_block" and args.group_size is None:
        ap.error("--scale-granularity per_block needs --group-size")


def _run(args, cfg, backend, ckpt, device, mesh=None):
    """The solve the arguments ask for: (metrics dict, label)."""
    if args.config.startswith("mri"):
        bits_y = None if backend == "dense" else args.bits_y
        gran = args.scale_granularity or cfg.scale_granularity
        out, _, _ = recover_mri(cfg, bits_y, args.seed, args.batch, device, gran,
                                args.group_size, args.sparsity_basis, ckpt, mesh)
        basis = args.sparsity_basis or cfg.sparsity_basis
        label = ("32bit[matrix-free]" if bits_y is None
                 else f"y@{bits_y}bit[{gran},matrix-free]") + f"[{basis}]"
    else:
        gran = args.scale_granularity or "per_tensor"
        run = recover_lofar if args.config.startswith("lofar") else recover_gaussian
        out, _, _ = run(cfg, backend, args.bits_phi, args.bits_y, args.seed,
                        args.requantize, args.batch, device, gran, args.group_size,
                        ckpt, mesh)
        label = ("32bit" if backend == "dense"
                 else f"{args.bits_phi}&{args.bits_y}bit[{backend}]")
    return out, label


if __name__ == "__main__":
    sys.exit(main())
