"""Batch-recovery serving CLI of the port — the heavy-traffic loop.

    python -m repro_torch.launch.serve --config serve-gaussian-packed
    python -m repro_torch.launch.serve --config serve-continuous-packed \\
        --scheduler continuous --verify

Simulates the production shape of the system on one GPU: a stream of
observations arriving against ONE measurement operator.

* ``--scheduler chunked`` (the ``serve-gaussian*`` configs): fixed-size
  ``(B, M)`` chunks recovered by a
  :class:`~repro_torch.parallel.batch.BatchServer`. With ``backend="packed"``
  the operator is packed once at server construction and every chunk streams
  the same codes through the ``qmm`` kernel. The CLI prints each chunk's
  ``x_digest`` and the first (set-up) against the steady chunk wall.
* ``--scheduler continuous|lockstep`` (the ``serve-continuous*`` configs):
  the continuous-batching scheduler
  (:mod:`repro_torch.parallel.scheduler`) over a bursty single-request
  arrival trace: an admission queue with priorities feeds a slot table whose
  finished rows are harvested and refilled mid-flight (``continuous``) or
  only at full-table drains (``lockstep``). ``--verify`` asserts every answer
  bitwise against its standalone solve; ``--metrics-json`` publishes the
  metrics dict.

``--checkpoint-dir D`` journals each chunk (or request) before its solve and
its result after; SIGTERM/SIGINT stops cleanly at a chunk boundary, and
``--resume`` drains the journaled results and solves the rest, to the
uninterrupted run's bits. ``--device`` defaults to ``cuda``; ``--device cpu``
runs the plain versions.

``--sanitize`` (default: the config's ``sanitize``, on for
``serve-gaussian-fault*``) runs the loop under
:func:`repro_torch.analysis.sanitize.sanitize` with the real residual trace
(``with_trace=True``): a NaN or Inf produced by any operation or kernel
raises, and a ``[sanitize] ok ...`` line reports the kernel-library builds,
with ``compiles_after_warmup`` counted after the first chunk (chunked) or
after the whole run (scheduler). ``--profile-dir D`` writes a
``torch.profiler`` trace (CPU and CUDA activity, Chrome/Perfetto JSON) of the
chunked serving loop to ``D``.

``--devices N`` (N > 1) serves on N ranks, one process each
(:func:`~repro_torch.parallel.dist.spawn_ranks`): every rank builds the same
stream, each chunk's (or the slot table's) rows are split over the ranks
and gathered after each solve (or segment), and only rank 0 prints, writes
the journal and the metrics; the last line reports ``devices=N``.
``--dist-backend`` names the backend: ``nccl`` (the card's default: one
rank per card) or ``gloo`` (the CPU's, and ranks sharing a card). A SIGTERM
is agreed across the ranks at the next chunk (or segment) boundary, and a
journal written at one width resumes at another.

Workloads are the reference's: Φ from ``make_gaussian_problem`` and each
signal's support and signs from ``permutation`` and ``rademacher`` under the
same keys, so supports, signs, arrival ticks, priorities and budgets equal the
reference's bit for bit, and y agrees to 1e-6 relative.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import os
import statistics
import sys
import time

import torch

from repro_torch import random as prng
from repro_torch.configs import SERVE_CONFIGS
from repro_torch.core.recovery import relative_error
from repro_torch.device import resolve_device

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stream_phi(cfg, key, device) -> torch.Tensor:
    """Φ of the reference's ``make_gaussian_problem(m, n, s, None, key)``."""
    from repro_torch.sensing.gaussian import make_gaussian_problem

    return make_gaussian_problem(cfg.m, cfg.n, cfg.s, None, key, device=device).phi


def _signal(cfg, k, decay, device) -> torch.Tensor:
    """s-sparse x: support from ``permutation(k, n)``, amplitudes decay^j,
    signs from ``rademacher(fold_in(k, 1))``."""
    perm = prng.permutation(k, cfg.n, device=device)[: cfg.s]
    amps = torch.pow(torch.tensor(decay, dtype=torch.float32, device=device),
                     torch.arange(cfg.s, dtype=torch.float32, device=device))
    signs = prng.rademacher(prng.fold_in(k, 1), (cfg.s,), dtype=torch.float32, device=device)
    x = torch.zeros(cfg.n, dtype=torch.float32, device=device)
    x[perm.long()] = amps * signs
    return x


def _observe(phi, x, snr, k) -> torch.Tensor:
    y = x @ phi.T
    noise = prng.normal(k, tuple(y.shape), device=y.device) * torch.sqrt(
        torch.mean(y ** 2) / 10 ** (snr / 10))
    return y + noise


def build_stream(cfg, key, device=None):
    """(phi, chunks, truths): ``cfg.n_chunks`` chunks of ``cfg.chunk`` rows
    sharing one Φ. Rows 0..n_hard-1 of each chunk are the *hard burst* —
    geometrically decaying coefficients (``cfg.hard_decay``) observed at
    ``snr_hard_db`` — and the rest flat s-sparse rows at ``snr_easy_db``."""
    dev = resolve_device(device)
    phi = _stream_phi(cfg, key, dev)
    chunks, truths = [], []
    for ci in range(cfg.n_chunks):
        ys, xs = [], []
        for b in range(cfg.chunk):
            kb = prng.fold_in(key, 1 + ci * cfg.chunk + b)
            decay, snr = ((cfg.hard_decay, cfg.snr_hard_db) if b < cfg.n_hard
                          else (1.0, cfg.snr_easy_db))
            x = _signal(cfg, kb, decay, dev)
            xs.append(x)
            ys.append(_observe(phi, x, snr, prng.fold_in(kb, 9)))
        chunks.append(torch.stack(ys))
        truths.append(torch.stack(xs))
    return phi, chunks, truths


def build_requests(cfg, key, device=None):
    """(phi, arrivals, truths, hard_rids) for a ``ContinuousServeConfig``:
    single-request arrivals on a deterministic bursty Poisson clock.

    Arrival ticks come from a numpy generator seeded by ``cfg.seed``
    (Poisson(``arrival_rate``) per tick plus a ``burst_size`` burst every
    ``burst_every`` ticks); request contents follow :func:`build_stream`'s
    hard/easy recipe with request ``rid`` as the row index. Priorities are
    round-robin over ``cfg.priority_classes`` (0 = most urgent) and deadlines
    follow ``cfg.deadline_slack`` (None = no deadlines)."""
    import numpy as np

    from repro_torch.parallel.scheduler import Request

    dev = resolve_device(device)
    phi = _stream_phi(cfg, key, dev)
    rng = np.random.default_rng(cfg.seed)
    hard_stride = max(1, int(round(1.0 / cfg.hard_fraction))) if cfg.hard_fraction > 0 else 0
    arrivals, truths, hard_rids = [], {}, set()
    rid, tick = 0, 0
    while rid < cfg.n_requests:
        n_new = int(rng.poisson(cfg.arrival_rate))
        if cfg.burst_every and tick and tick % cfg.burst_every == 0:
            n_new += cfg.burst_size
        for _ in range(min(n_new, cfg.n_requests - rid)):
            hard = hard_stride and rid % hard_stride == 0
            kb = prng.fold_in(key, 1 + rid)
            decay, snr = ((cfg.hard_decay, cfg.snr_hard_db) if hard
                          else (1.0, cfg.snr_easy_db))
            x = _signal(cfg, kb, decay, dev)
            y = _observe(phi, x, snr, prng.fold_in(kb, 9))
            prio = rid % cfg.priority_classes
            deadline = (None if cfg.deadline_slack is None
                        else tick + cfg.deadline_slack * (prio + 1))
            budget = (cfg.n_iters if hard or cfg.n_iters_easy is None
                      else cfg.n_iters_easy)
            arrivals.append((tick, Request(rid=rid, y=y, priority=prio, deadline=deadline,
                                           n_iters=budget)))
            truths[rid] = x
            if hard:
                hard_rids.add(rid)
            rid += 1
        tick += 1
    return phi, arrivals, truths, hard_rids


def _solver_kwargs(cfg, sanitize=None) -> dict:
    """The solver keywords of a serving config (``sanitize`` defaults to
    ``cfg.sanitize``)."""
    if sanitize is None:
        sanitize = cfg.sanitize
    kw = {}
    if cfg.backend == "packed":
        kw = dict(bits_phi=cfg.bits_phi, bits_y=cfg.bits_y, backend="packed")
    elif cfg.bits_y:
        kw = dict(bits_y=cfg.bits_y)
    if sanitize:
        # a trace of NaN markers would (rightly) trip the tripwire's stacking:
        # sanitized runs pay for the real residual trace, as in the reference
        kw["with_trace"] = True
    return kw


def _sanitizer(sanitize):
    if not sanitize:
        return contextlib.nullcontext()
    from repro_torch.analysis.sanitize import sanitize as sanitize_ctx

    return sanitize_ctx()


def _sanitize_line(counter, speak=True) -> None:
    if counter is not None and speak:
        print(f"[sanitize] ok {counter.summary()} debug_nans=on debug_infs=on", flush=True)


def _mean(xs, digits):
    return round(sum(xs) / len(xs), digits) if xs else None


def serve_scheduled(cfg, policy, devices=None, journal_dir=None, resume=False,
                    verify=False, device=None, sanitize=None, mesh=None):
    """Run the bursty request trace through a
    :class:`~repro_torch.parallel.scheduler.ContinuousScheduler`; returns
    metrics: p50/p99 request latency, items/s, slot occupancy, queue-wait
    and iters-used means, shed counts and mean rel_error of the easy and
    hard requests.

    ``verify=True`` recomputes every completed request's standalone reference
    (:meth:`~repro_torch.parallel.scheduler.ContinuousScheduler.reference_solve`)
    and asserts bitwise equality. ``journal_dir``/``resume`` journal each
    request under its rid and drain completed results on restart.
    ``sanitize`` (default: ``cfg.sanitize``) runs the scheduler under the
    NaN/Inf tripwires, its counter marked warm after the run. ``mesh``
    splits the slot table's rows over its ranks (every rank calls this
    alike, and verifies its share of the answers). A SIGTERM/SIGINT stops
    the run at the next segment boundary (``preempted_at``)."""
    import numpy as np

    from repro_torch.parallel import ContinuousScheduler
    from repro_torch.parallel.dist import barrier
    from repro_torch.train.fault import PreemptionGuard

    dev = mesh.device if mesh is not None else resolve_device(device)
    if sanitize is None:
        sanitize = cfg.sanitize
    key = prng.PRNGKey(cfg.seed)
    phi, arrivals, truths, hard_rids = build_requests(cfg, key, dev)
    _sync(dev)
    t0 = time.perf_counter()
    with _sanitizer(sanitize) as counter, PreemptionGuard() as guard:
        sch = ContinuousScheduler(
            phi, cfg.s, cfg.n_iters, slots=cfg.slots, seg_len=cfg.seg_len,
            policy=policy, queue_depth=cfg.queue_depth, age_every=cfg.age_every,
            mesh=mesh, n_devices=devices if mesh is None else None, key=key,
            exit_tol=cfg.exit_tol, journal_dir=journal_dir, resume=resume,
            **_solver_kwargs(cfg, sanitize))
        reports = sch.run(arrivals, stop=lambda: guard.requested)
        if counter is not None:
            counter.mark_warm()
    wall = time.perf_counter() - t0
    speak = sch.mesh.is_writer
    _sanitize_line(counter, speak)
    if sch.preempted_at is not None and speak:
        print(f"[serve] preempted at tick {sch.preempted_at} "
              f"(journal has {sum(r.status == 'done' for r in reports.values())} results)",
              flush=True)
    done = [r for r in reports.values() if r.status == "done"]
    if verify:
        # each rank checks its share of the answers; the barrier holds rank
        # 0's line until every share has passed
        requests = {req.rid: req for _, req in arrivals}
        for r in done[sch.mesh.rank::sch.mesh.size]:
            req = requests[r.rid]
            ref = sch.reference_solve(req.y, req.n_iters).cpu().numpy()
            if not np.array_equal(ref, np.asarray(r.x)):
                raise AssertionError(f"request {r.rid}: scheduler answer differs from its "
                                     "standalone reference solve")
        barrier(sch.mesh)
        if speak:
            print(f"[serve] verified {len(done)} requests bitwise against "
                  "standalone solves", flush=True)
    lat = sorted(r.latency_s for r in done)
    waits = [r.queue_wait_ticks for r in done if r.queue_wait_ticks is not None]
    iters = [r.iters_used for r in done if r.iters_used is not None]

    def rel(r):
        return float(relative_error(torch.from_numpy(np.asarray(r.x)),
                                    truths[r.rid].cpu()))

    rels_easy = [rel(r) for r in done if r.rid not in hard_rids]
    rels_hard = [rel(r) for r in done if r.rid in hard_rids]
    stats = sch.stats()

    def pct(xs, q):
        if not xs:
            return None
        return round(xs[min(len(xs) - 1, int(q * (len(xs) - 1) + 0.999999))], 4)

    sanitize_fields = {} if counter is None else {"sanitize_compiles": counter.compiles}
    return {
        **sanitize_fields,
        "scheduler": policy,
        "devices": sch.mesh.size,
        "preempted_at": sch.preempted_at,
        "requests": len(reports),
        "completed": len(done),
        "drained": stats["drained"],
        "shed_deadline": stats.get("n_shed_deadline", 0),
        "shed_queue_full": stats.get("n_shed_queue_full", 0),
        "slots": cfg.slots,
        "seg_len": cfg.seg_len,
        "ticks": stats["ticks"],
        "segments_run": stats["segments_run"],
        "segment_lengths": stats["segment_lengths"],
        "slot_occupancy": stats["slot_occupancy"],
        "wall_s": round(wall, 3),
        "items_per_s": round(len(done) / wall, 1) if wall else None,
        "latency_p50_s": pct(lat, 0.50),
        "latency_p99_s": pct(lat, 0.99),
        "queue_wait_ticks_mean": (round(statistics.mean(waits), 2)
                                  if waits else None),
        "iters_used_mean": round(statistics.mean(iters), 1) if iters else None,
        "rel_error_easy_mean": _mean(rels_easy, 4),
        "rel_error_hard_mean": _mean(rels_hard, 4),
    }


def serve(cfg, devices=None, chunks=None, journal_dir=None, resume=False, device=None,
          sanitize=None, profile_dir=None, mesh=None):
    """Run the stream through a BatchServer; returns a metrics dict.

    The loop runs under a :class:`~repro_torch.train.fault.PreemptionGuard`:
    a SIGTERM/SIGINT finishes (and journals) the running chunk, then stops
    cleanly. With ``journal_dir``, each chunk is write-ahead journaled; a
    restarted run with ``resume=True`` re-presents the same stream, drains
    journaled results and solves the rest — its per-chunk ``x_digest`` lines
    equal an uninterrupted run's.

    ``sanitize`` (default: ``cfg.sanitize``) runs the whole loop under the
    NaN/Inf tripwires with a kernel-build counter marked warm after the
    first chunk, its metrics included: the ``[sanitize]`` line and the
    ``sanitize_compiles*`` fields say whether later chunks built or loaded
    anything. ``profile_dir`` writes a ``torch.profiler`` trace of the whole
    loop (set-up chunk included). ``mesh`` splits each chunk's rows over its
    ranks: every rank calls this alike, the stop is agreed across them at
    each chunk boundary, and only rank 0 prints."""
    from repro_torch.launch.recover import profiled
    from repro_torch.parallel import BatchServer
    from repro_torch.train.fault import PreemptionGuard

    from repro_torch.parallel.dist import any_rank

    dev = mesh.device if mesh is not None else resolve_device(device)
    if sanitize is None:
        sanitize = cfg.sanitize
    key = prng.PRNGKey(cfg.seed)
    if chunks is not None:
        cfg = dataclasses.replace(cfg, n_chunks=chunks)
    phi, stream, truths = build_stream(cfg, key, dev)
    walls, rels_easy, rels_hard = [], [], []
    preempted = None
    with profiled(profile_dir, dev), _sanitizer(sanitize) as counter, \
            PreemptionGuard() as guard:
        srv = BatchServer(phi, cfg.s, cfg.n_iters, mesh=mesh,
                          n_devices=devices if mesh is None else None, key=key,
                          exit_tol=cfg.exit_tol, journal_dir=journal_dir,
                          resume=resume, **_solver_kwargs(cfg, sanitize))
        speak = srv.mesh.is_writer
        for ci, Y in enumerate(stream):
            _sync(dev)
            t0 = time.perf_counter()
            res = srv.submit(Y, prng.fold_in(key, 1000 + ci))
            _sync(dev)
            walls.append(time.perf_counter() - t0)
            x = res.x.cpu()
            digest = hashlib.sha256(x.numpy().tobytes()).hexdigest()[:16]
            if speak:
                print(f"[serve] chunk {ci} x_digest={digest}", flush=True)
            truth = truths[ci].cpu()
            for b in range(cfg.chunk):
                r = float(relative_error(x[b], truth[b]))
                (rels_hard if b < cfg.n_hard else rels_easy).append(r)
            if counter is not None and ci == 0:
                # warm-up = chunk 0 end to end, metrics included
                counter.mark_warm()
            # every rank reads the agreed flag, so every rank stops here
            if any_rank(srv.mesh, guard.requested) and ci + 1 < len(stream):
                preempted = ci + 1
                if speak:
                    print(f"[serve] preempted after chunk {ci} "
                          f"(journal has {ci + 1}/{len(stream)} chunks)", flush=True)
                break
    _sanitize_line(counter, speak)
    steady = walls[1:] if len(walls) > 1 else walls
    sanitize_fields = {} if counter is None else {
        "sanitize_compiles": counter.compiles,
        "sanitize_compiles_after_warmup": counter.compiles_since_warm,
    }
    return {
        **sanitize_fields,
        "devices": srv.n_shards,
        "chunks": len(stream),
        "chunks_served": srv.n_chunks,
        "chunks_drained": srv.n_drained,
        "preempted_after": preempted,
        "chunk_rows": cfg.chunk,
        "compile_chunk_s": round(walls[0], 3),
        "steady_chunk_s": round(sum(steady) / len(steady), 3),
        "items_per_s": round(cfg.chunk / (sum(steady) / len(steady)), 1),
        "rel_error_easy_mean": _mean(rels_easy, 4),
        "rel_error_hard_mean": _mean(rels_hard, 4),
        "compile_cache_keys": list(map(list, srv.compile_cache_keys)),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="serve-gaussian-smoke", choices=list(SERVE_CONFIGS))
    ap.add_argument("--scheduler", default="chunked",
                    choices=["chunked", "continuous", "lockstep"],
                    help="chunked = the BatchServer loop over pre-cut chunks "
                         "(serve-gaussian*); continuous|lockstep = the "
                         "ContinuousScheduler over the bursty request trace "
                         "(serve-continuous*) with mid-flight refill on or off")
    ap.add_argument("--metrics-json", default=None,
                    help="also write the metrics dict to this path as JSON "
                         "(atomic publish)")
    ap.add_argument("--verify", action="store_true",
                    help="(scheduler modes) recompute every completed "
                         "request's standalone qniht_batch reference and "
                         "assert bitwise equality")
    ap.add_argument("--devices", type=int, default=None,
                    help="serve on N ranks, one process each, every chunk's (or the slot "
                         "table's) rows split over them (default: one device)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="the ranks' process-group backend with --devices N > 1 (default: "
                         "nccl on the card, one rank per card; gloo on the CPU, and on the "
                         "card when ranks share it)")
    ap.add_argument("--chunks", type=int, default=None,
                    help="override the config's number of stream chunks")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="write-ahead journal directory: each chunk's inputs "
                         "are journaled before its solve and the result after, "
                         "and SIGTERM/SIGINT stops cleanly at a chunk boundary")
    ap.add_argument("--resume", action="store_true",
                    help="drain already-journaled chunk results from "
                         "--checkpoint-dir instead of re-solving them")
    ap.add_argument("--sanitize", action="store_true", default=None,
                    help="run under repro_torch.analysis.sanitize: raise on any NaN/Inf "
                         "and report kernel-library builds after warm-up (default: the "
                         "config's sanitize flag)")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace (CPU and CUDA activity, "
                         "Chrome/Perfetto JSON) of the chunked serving loop to this "
                         "directory")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    if args.devices is not None and args.devices < 1:
        ap.error("--devices must be >= 1")
    if args.dist_backend and not (args.devices or 0) > 1:
        ap.error("--dist-backend names the backend of the ranks of --devices N > 1")
    if args.chunks is not None and args.chunks < 1:
        ap.error("--chunks must be >= 1")
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume needs --checkpoint-dir")
    is_continuous_cfg = args.config.startswith("serve-continuous")
    if (args.scheduler != "chunked") != is_continuous_cfg:
        ap.error("--scheduler continuous|lockstep goes with the "
                 "serve-continuous* configs; chunked with the serve-gaussian* "
                 "ones")
    if args.scheduler != "chunked" and args.profile_dir:
        ap.error("--profile-dir is a chunked-path flag")
    if (args.devices or 0) > 1:
        from repro_torch.parallel.dist import spawn_ranks

        resolve_device(args.device)
        spawn_ranks(_rank_main, args.devices, device=args.device, backend=args.dist_backend,
                    args=(args,))
        return
    _serve_and_print(args, None, args.profile_dir)


def _rank_main(mesh, args):
    """One rank of ``--devices N``: the whole run on the rank's device, rows
    split over the ranks; rank 0 prints and writes, and each rank writes its
    own profile under ``--profile-dir``."""
    prof = (os.path.join(args.profile_dir, f"rank_{mesh.rank}") if args.profile_dir
            else None)
    _serve_and_print(args, mesh, prof)


def _serve_and_print(args, mesh, profile_dir):
    """The run the arguments ask for, its metrics JSON and its last line
    (rank 0 of a mesh alone writes and prints)."""
    cfg = SERVE_CONFIGS[args.config]
    if args.scheduler == "chunked":
        out = serve(cfg, args.devices, args.chunks, journal_dir=args.checkpoint_dir,
                    resume=args.resume, device=args.device, sanitize=args.sanitize,
                    profile_dir=profile_dir, mesh=mesh)
    else:
        out = serve_scheduled(cfg, args.scheduler, devices=args.devices,
                              journal_dir=args.checkpoint_dir, resume=args.resume,
                              verify=args.verify, device=args.device,
                              sanitize=args.sanitize, mesh=mesh)
    if mesh is not None and not mesh.is_writer:
        return
    if args.metrics_json:
        from repro_torch.parallel.journal import write_json_durable

        write_json_durable(args.metrics_json, out)
    print(f"[serve] {cfg.name}: " +
          " ".join(f"{k}={v}" for k, v in out.items()), flush=True)


if __name__ == "__main__":
    sys.exit(main())
