"""Preemption-safe segmented recovery (port of ``repro.launch.resilience``):
checkpointed solves that resume bit for bit.

Every stochastic input of the solver (ŷ, Φ̂) is re-derived from (Y, key) and
each iteration takes its global index, so any iteration boundary is an exact
restart point:

* :func:`recover_resilient` runs ``qniht_batch`` in segments of
  ``ckpt_every`` iterations (:func:`~repro_torch.core.niht.solver_segment`)
  and saves the whole :class:`~repro_torch.core.niht.SolverState` after each
  (:mod:`repro_torch.train.checkpoint`).
* SIGTERM/SIGINT mid-run sets :class:`~repro_torch.train.fault.PreemptionGuard`'s
  flag: the running segment finishes, one synchronous checkpoint is written
  and :class:`Preempted` is raised.
* ``resume=True`` restores the newest complete checkpoint (past torn ones)
  and goes on; the result has the bits of the uninterrupted run.
* ``mesh``/``n_devices`` split the rows over ranks
  (:func:`~repro_torch.parallel.batch.sharded_segment_run`): every rank runs
  this function alike, the stop is agreed across the ranks at every segment
  boundary, rank 0 writes the checkpoints and every rank restores them.
  Checkpoints are elastic: the state is saved stripped of the mesh's
  padding, so a run checkpointed at ``--devices 4`` resumes at 2 or on one
  device, to the same bits.

CLI: ``python -m repro_torch.launch.recover --checkpoint-dir CKPT
--ckpt-every 10 [--resume]``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import random as prng
from repro_torch.core.niht import (
    _SEG_DEFAULTS,
    IHTResult,
    SolverState,
    solver_init,
    solver_result,
)
from repro_torch.core.operators import PackedStreamingOperator
from repro_torch.parallel.batch import make_batch_mesh, one_device_mesh, sharded_segment_run
from repro_torch.parallel.dist import any_rank
from repro_torch.quant.formats import as_granularity
from repro_torch.train.checkpoint import restore_latest, save
from repro_torch.train.fault import PreemptionGuard

__all__ = ["Preempted", "recover_resilient"]


class Preempted(RuntimeError):
    """A solve was interrupted by SIGTERM/SIGINT after a durable checkpoint;
    ``resume=True`` with the same arguments finishes it bit for bit. A
    ``RuntimeError``, so :func:`~repro_torch.train.fault.run_with_restarts`
    retries it by default."""

    def __init__(self, k: int, checkpoint_dir: str):
        super().__init__(
            f"preempted at iteration {k}; checkpoint written to {checkpoint_dir}")
        self.k = k
        self.checkpoint_dir = checkpoint_dir


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def recover_resilient(phi, Y: torch.Tensor, s: int, n_iters: int = 50, *,
                      checkpoint_dir: str, ckpt_every: int = 10, resume: bool = False,
                      mesh=None, n_devices: Optional[int] = None,
                      keep: int = 3, async_save: bool = False,
                      guard: Optional[PreemptionGuard] = None, verbose: bool = False,
                      key: Optional[torch.Tensor] = None, **solver_kw) -> IHTResult:
    """``qniht_batch(phi, Y, s, n_iters, ...)`` with a checkpoint after every
    segment of ``ckpt_every`` iterations.

    Takes the batched solver's keyword configuration (``bits_phi``,
    ``backend`` ...; not ``unroll``). ``guard``: an entered
    :class:`PreemptionGuard` to poll between segments; ``None`` installs one
    for this call. ``async_save`` overlaps the checkpoint writes with the next
    segment; the last checkpoint and a preemption's are synchronous.
    ``mesh`` (or ``n_devices``: :func:`~repro_torch.parallel.batch.make_batch_mesh`)
    splits the rows over ranks, each of which calls this function with the
    same arguments; the default is one device.

    The packed backend is packed once here, not in every segment: the codes
    are a function of (phi, key), so a restarted process packs the same
    stream. The segments then see the packed operator as matrix-free, as in
    the reference, which also makes it the Φ of the trace's ``resid_true``."""
    if ckpt_every < 1:
        raise ValueError(f"ckpt_every must be >= 1, got {ckpt_every}")
    unknown = set(solver_kw) - set(_SEG_DEFAULTS)
    if unknown:
        raise TypeError(f"recover_resilient got unexpected solver kwargs {sorted(unknown)}")
    statics = {**_SEG_DEFAULTS, **solver_kw}
    key = key if key is not None else prng.PRNGKey(0)
    if mesh is None:
        mesh = make_batch_mesh(n_devices, Y.device) if n_devices else one_device_mesh(Y.device)
    verbose = verbose and mesh.is_writer

    # the guard is in place before the first line is printed: a SIGTERM from
    # then on is absorbed at the next segment's end, never the default kill
    g = guard if guard is not None else PreemptionGuard().__enter__()
    try:
        fresh = solver_init(phi, Y, s, n_iters, key=key, **statics)
        state, step = restore_latest(checkpoint_dir, fresh) if resume else (None, None)
        if state is None:
            state = fresh
            if verbose:
                print(f"[resilience] fresh start, n_iters={n_iters}", flush=True)
        elif verbose:
            print(f"[resilience] resumed from step {step} (k={int(state.k)})", flush=True)

        seg_phi, seg_statics = phi, dict(statics)
        if statics["backend"] == "packed":
            _, kphi = prng.split(key)
            seg_phi = PackedStreamingOperator.pack(
                phi, statics["bits_phi"], prng.fold_in(kphi, 0),
                granularity=as_granularity(statics["scale_granularity"],
                                           statics["group_size"]))
            seg_statics.update(bits_phi=None, backend="dense")

        while int(state.k) < n_iters:
            n = min(ckpt_every, n_iters - int(state.k))
            state: SolverState = sharded_segment_run(seg_phi, state, n, mesh=mesh, s=s,
                                                     **seg_statics)
            _sync(state.X)
            k = int(state.k)
            final = k >= n_iters
            # every rank stops at the same segment boundary
            preempt = any_rank(mesh, g.requested)
            # preemption and the horizon both need a durable (synchronous) write
            save(checkpoint_dir, k, state, keep=keep,
                 async_=async_save and not final and not preempt, mesh=mesh)
            if verbose:
                print(f"[resilience] k={k}/{n_iters} checkpointed", flush=True)
            if preempt and not final:
                raise Preempted(k, checkpoint_dir)
    finally:
        if guard is None:
            g.__exit__(None, None, None)
    return solver_result(state)
