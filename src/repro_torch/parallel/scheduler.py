"""Continuous batching for the serving layer: admission queue + slot refill
(port of ``repro.parallel.scheduler``).

:class:`~repro_torch.parallel.batch.BatchServer` serves in *lockstep*: it
solves pre-cut ``(B, M)`` chunks to a uniform horizon, so one slow row holds
``B-1`` finished slots hostage. Rows of NIHT are independent between
iterations (all cross-row structure is the shared Φ̂ stream), so an
early-exited row can be *harvested* at any segment boundary and its slot
*refilled* from a queue.

* :class:`Request` — one observation vector plus scheduling metadata
  (priority class, deadline, request id, iteration budget).
* :class:`AdmissionQueue` — bounded depth with shed-on-overflow, strict
  priority order with FIFO inside a class, and an *aging* rule
  (``age_every``) that promotes long-waiting requests one class per window.
* :class:`ContinuousScheduler` — the refill loop. It owns a live
  :class:`~repro_torch.core.niht.SolverState` of ``slots`` rows and
  repeatedly harvests rows whose ``done`` flag is set (or whose budget is
  spent), splices queued requests into the freed rows
  (:func:`~repro_torch.parallel.batch.refill_rows`), and advances the whole
  table one *segment* of up to ``seg_len`` iterations (:func:`segment_step`),
  on one device or with the slot table's rows split over a mesh of ranks
  (:func:`~repro_torch.parallel.batch.sharded_segment_run`). Every rank then
  runs the same admission and harvest over the whole table: after each
  segment every rank holds the gathered state, so every decision taken on
  the host is the same on every rank, and a stop (SIGTERM) is agreed at each
  segment boundary, so no rank enters a segment another skips.

Time is **logical**: one tick = one segment. Every scheduling decision —
admission, shed, refill order — is a pure function of (arrival trace,
config); wall-clock enters only the latency fields of each
:class:`RequestReport`. The harvest reads ``done`` (and, when a row is
harvested, ``X``) to the host once per segment.

Bit-identity contract: every request's answer equals its **standalone solve
at the same slot width** — ``qniht_batch`` over ``[y, 0, ..., 0]`` of
``slots`` rows with the same key and solver configuration
(:meth:`ContinuousScheduler.reference_solve`), whatever the arrival order,
co-tenants, priorities, slot or refill timing. It rests on stationary
operators (the ``early_exit`` precondition, so :func:`segment_step` can run
every row at its own age with ``k`` reset per segment) and on fixed-width
row independence: at a fixed ``(slots, ·)`` shape row ``b`` is computed
from row ``b``'s data alone, wherever it sits.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.core.niht import _validate, qniht_batch, solver_init, solver_segment
from repro_torch.core.operators import PackedStreamingOperator
from repro_torch.parallel.batch import (
    _operator_device,
    check_mesh,
    make_batch_mesh,
    one_device_mesh,
    refill_rows,
    sharded_segment_run,
)
from repro_torch.parallel.dist import any_rank
from repro_torch.parallel.journal import ChunkJournal
from repro_torch.quant.formats import as_granularity

__all__ = [
    "AdmissionQueue",
    "ContinuousScheduler",
    "Request",
    "RequestReport",
    "segment_step",
]

# Request terminal/lifecycle states. String values land in metrics JSON.
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
SHED_QUEUE_FULL = "shed_queue_full"
SHED_DEADLINE = "shed_deadline"


@dataclasses.dataclass(frozen=True)
class Request:
    """One recovery request: an (M,) observation (numpy or tensor) plus
    scheduling metadata.

    ``priority`` is a class index — **lower is more urgent** (0 beats 2).
    ``deadline`` is the last *tick* at which the request may still be granted
    a slot; a request still queued past it is shed with status
    ``shed_deadline`` (a request already in a slot runs to completion).
    ``None`` = no deadline. ``n_iters`` is the request's own iteration budget,
    at most the scheduler's; ``None`` = the scheduler's.
    """

    rid: int
    y: Any
    priority: int = 0
    deadline: Optional[int] = None
    n_iters: Optional[int] = None


@dataclasses.dataclass
class RequestReport:
    """Lifecycle record of one request — the scheduler's observable output."""

    rid: int
    status: str
    priority: int
    arrival_tick: int
    start_tick: Optional[int] = None
    finish_tick: Optional[int] = None
    #: iterations paid for, segment-granular; None for shed or drained requests
    iters_used: Optional[int] = None
    queue_wait_ticks: Optional[int] = None
    x: Any = None                      # the answer, a numpy copy from the host
    drained: bool = False
    # wall-clock observability (never feeds a scheduling decision)
    wall_enqueued: Optional[float] = None
    wall_started: Optional[float] = None
    wall_finished: Optional[float] = None

    @property
    def latency_s(self) -> Optional[float]:
        """Wall-clock enqueue → result latency (None until finished)."""
        if self.wall_finished is None or self.wall_enqueued is None:
            return None
        return self.wall_finished - self.wall_enqueued


@dataclasses.dataclass
class _QueueEntry:
    seq: int       # global arrival sequence number (FIFO tiebreak)
    enq_tick: int
    req: Request


class AdmissionQueue:
    """Bounded priority queue with FIFO classes, aging, and deadline shed.

    Pop order is the minimum of ``(effective_priority, seq)``: strict
    priority between classes, FIFO inside one. ``effective_priority`` is the
    request's class minus one per ``age_every`` ticks waited; ``age_every=0``
    disables aging (strict priorities, starvation possible).

    Overflow policy: a full queue sheds the *incoming* request unless it is
    strictly more urgent than the least-urgent queued entry, in which case
    that entry is evicted instead (ties keep the incumbent — FIFO).

    Every method is a pure function of its arguments and prior calls — no
    clocks, no randomness.
    """

    def __init__(self, depth: int, age_every: int = 0):
        if depth < 1:
            raise ValueError(f"queue depth must be >= 1, got {depth}")
        if age_every < 0:
            raise ValueError(f"age_every must be >= 0, got {age_every}")
        self.depth = depth
        self.age_every = age_every
        self.entries: list[_QueueEntry] = []

    def __len__(self) -> int:
        return len(self.entries)

    def effective_priority(self, entry: _QueueEntry, tick: int) -> int:
        waited = tick - entry.enq_tick
        aged = waited // self.age_every if self.age_every else 0
        return entry.req.priority - aged

    def offer(self, req: Request, tick: int, seq: int):
        """Try to enqueue; returns ``(admitted, shed_entry)`` where
        ``shed_entry`` is the evicted incumbent (admitted over it), the
        rejected incoming entry (not admitted), or None."""
        entry = _QueueEntry(seq=seq, enq_tick=tick, req=req)
        if len(self.entries) < self.depth:
            self.entries.append(entry)
            return True, None
        worst = max(self.entries,
                    key=lambda e: (self.effective_priority(e, tick), e.seq))
        if req.priority < self.effective_priority(worst, tick):
            self.entries.remove(worst)
            self.entries.append(entry)
            return True, worst
        return False, entry

    def pop(self, tick: int) -> Optional[_QueueEntry]:
        if not self.entries:
            return None
        best = min(self.entries,
                   key=lambda e: (self.effective_priority(e, tick), e.seq))
        self.entries.remove(best)
        return best

    def shed_expired(self, tick: int) -> list[_QueueEntry]:
        """Remove and return entries whose deadline tick has passed."""
        expired = [e for e in self.entries
                   if e.req.deadline is not None and tick > e.req.deadline]
        for e in expired:
            self.entries.remove(e)
        return expired


def segment_step(phi, state, n_steps: int, *, mesh=None, **statics):
    """One refill-loop segment: advance every row of the slot table by up to
    ``n_steps`` iterations — the continuous scheduler's hot loop.

    :func:`~repro_torch.core.niht.solver_segment` with the iteration counter
    **reset to zero**: the rows sit at different logical ages, so the state's
    global ``k`` cannot mean "the iteration every row is at". That is sound
    because the scheduler requires stationary operators (the ``early_exit``
    precondition): the iteration map never reads the index. Trace buffers are
    segment-local scratch. With ``mesh`` the rows are split over its ranks
    (:func:`~repro_torch.parallel.batch.sharded_segment_run`), and every rank
    returns the same gathered state."""
    state = state._replace(k=torch.zeros_like(state.k))
    if mesh is not None:
        return sharded_segment_run(phi, state, n_steps, mesh=mesh, **statics)
    return solver_segment(phi, state, n_steps, **statics)


def _row_tensor(y, dtype, device) -> torch.Tensor:
    y = y if isinstance(y, torch.Tensor) else torch.tensor(np.asarray(y))
    return y.to(dtype=dtype, device=device)


class ContinuousScheduler:
    """Continuous-batching recovery service over one measurement operator,
    on the device of Φ, or with the slot table's rows split over a mesh.

    Construction mirrors :class:`~repro_torch.parallel.batch.BatchServer`
    (pack once, one PRNG key for the whole service) plus the scheduling
    knobs:

    * ``slots`` — rows of the live :class:`SolverState` (the batch width
      every segment solves; also the width of the standalone reference).
    * ``seg_len`` — iterations per segment: the refill granularity.
    * ``queue_depth`` / ``age_every`` — :class:`AdmissionQueue` behaviour.
    * ``policy`` — ``"continuous"`` refills freed slots mid-flight;
      ``"lockstep"`` refills only when EVERY slot is free (the chunked
      baseline in the same engine).

    ``journal_dir`` write-ahead journals each request under its **request
    id** (inputs at splice time, result at harvest); a restarted scheduler
    with ``resume=True`` fed the same arrival trace drains completed requests
    from disk and re-solves in-flight ones; on a mesh only rank 0 writes it.

    ``mesh`` (or ``n_devices``, the first ranks of the process group this
    rank is in: :func:`~repro_torch.parallel.batch.make_batch_mesh`) splits
    the slot table's rows over ranks; every rank of the mesh constructs the
    scheduler alike and runs the same arrival trace, and gets the same
    reports. The default is one device.
    """

    def __init__(self, phi, s: int, n_iters: int = 50, *, slots: int = 8,
                 seg_len: int = 8, policy: str = "continuous",
                 queue_depth: int = 64, age_every: int = 8,
                 mesh=None, n_devices: Optional[int] = None,
                 bits_phi: Optional[int] = None, bits_y: Optional[int] = None,
                 key: Optional[torch.Tensor] = None, requantize: str = "fixed",
                 backend: str = "dense", threshold: str = "topk",
                 c: float = 0.01, shrink_k: float = 2.0,
                 max_backtracks: int = 30, real_signal: bool = False,
                 nonneg: bool = False, with_trace: bool = False,
                 scale_granularity: str = "per_tensor",
                 group_size: Optional[int] = None, exit_tol: float = 0.0,
                 journal_dir: Optional[str] = None, resume: bool = False):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if seg_len < 1:
            raise ValueError(f"seg_len must be >= 1, got {seg_len}")
        if policy not in ("continuous", "lockstep"):
            raise ValueError(
                f"unknown policy {policy!r} (use 'continuous' or 'lockstep')")
        if resume and journal_dir is None:
            raise ValueError("resume=True needs a journal_dir to resume from")
        # early_exit=True is load-bearing twice over: harvest needs the done
        # flags, and its stationarity precondition makes segment_step's
        # k-reset sound
        _validate(phi, bits_phi, bits_y, key, requantize, backend, threshold,
                  real_signal, scale_granularity, group_size, True, exit_tol)
        dev = _operator_device(phi)
        if mesh is None:
            mesh = (make_batch_mesh(n_devices, dev) if n_devices is not None
                    else one_device_mesh(dev))
        self.mesh = check_mesh(mesh)
        self.device = mesh.device
        self.key = key if key is not None else prng.PRNGKey(0)
        self.phi = phi
        self._ref_phi = phi  # user-level operator, before the pack-once translation
        self.slots = slots
        self.seg_len = seg_len
        self.n_iters = n_iters
        self.policy = policy
        self.journal = (ChunkJournal(journal_dir, writer=mesh.is_writer)
                        if journal_dir is not None else None)
        self._resume = bool(resume)
        # the user-level solver config — what reference_solve replays
        self._ref_statics = dict(
            bits_phi=bits_phi, bits_y=bits_y, requantize=requantize,
            backend=backend, threshold=threshold, c=c, shrink_k=shrink_k,
            max_backtracks=max_backtracks, real_signal=real_signal,
            nonneg=nonneg, scale_granularity=scale_granularity,
            group_size=group_size, exit_tol=exit_tol)
        statics = dict(
            s=s, bits_phi=bits_phi, bits_y=bits_y, requantize=requantize,
            backend=backend, threshold=threshold, c=c, shrink_k=shrink_k,
            max_backtracks=max_backtracks, real_signal=real_signal,
            nonneg=nonneg, with_trace=with_trace,
            scale_granularity=scale_granularity, group_size=group_size,
            early_exit=True, exit_tol=exit_tol)
        if backend == "packed":
            # pack once with the key the in-loop pack would fold, as
            # BatchServer does
            _, kphi = prng.split(self.key)
            self.phi = PackedStreamingOperator.pack(
                phi, bits_phi, prng.fold_in(kphi, 0),
                granularity=as_granularity(scale_granularity, group_size))
            statics.update(bits_phi=None, backend="dense", scale_granularity="per_tensor",
                           group_size=None)
        self._statics = statics
        self.s = s

        m = self.phi.shape[0]
        self._m = m
        self._y_dtype = self.phi.dtype
        state = solver_init(
            self.phi, torch.zeros((slots, m), dtype=self._y_dtype, device=self.device), s,
            n_iters=n_iters, key=self.key,
            **{k: v for k, v in statics.items() if k != "s"})
        # blank every slot: pad rows (done=True) with zeroed last-trace rows
        self._state = refill_rows(
            state, list(range(slots)), torch.zeros((slots, m), dtype=self._y_dtype),
            [False] * slots)
        self._ages = np.zeros(slots, np.int64)
        self._horizon = np.full(slots, n_iters, np.int64)  # per-slot budget
        self._slot_rid: list[Optional[int]] = [None] * slots
        self.tick = 0
        self.reports: dict[int, RequestReport] = {}
        #: (tick, event, rid_or_None, detail) decision log — every entry is a
        #: pure function of (arrival trace, config)
        self.log: list[tuple] = []
        self._queue = AdmissionQueue(queue_depth, age_every)
        self._seq = 0
        self.segments_run = 0
        self._segment_lengths: dict[int, int] = {}
        self._occupied_slot_segments = 0
        self.n_drained = 0
        #: the tick at which ``run`` was stopped, or None
        self.preempted_at: Optional[int] = None

    # -- admission ---------------------------------------------------------
    def _admit(self, req: Request, arrival_tick: int) -> None:
        if req.rid in self.reports:
            raise ValueError(f"duplicate request id {req.rid}")
        if tuple(req.y.shape) != (self._m,):
            raise ValueError(
                f"request {req.rid}: y shape {tuple(req.y.shape)} != ({self._m},)")
        if req.n_iters is not None and not 1 <= req.n_iters <= self.n_iters:
            raise ValueError(
                f"request {req.rid}: n_iters {req.n_iters} outside "
                f"[1, {self.n_iters}] (the scheduler's buffers are sized for "
                "its own n_iters)")
        rep = RequestReport(rid=req.rid, status=QUEUED, priority=req.priority,
                            arrival_tick=arrival_tick,
                            wall_enqueued=time.perf_counter())
        self.reports[req.rid] = rep
        if (self.journal is not None and self._resume
                and self.journal.is_complete(req.rid)):
            self.journal.verify_submit(req.rid, self._host_row(req.y)[None], self.key)
            rep.x = self.journal.load_result_full(req.rid)[0]
            rep.status = DONE
            rep.drained = True
            rep.finish_tick = arrival_tick
            rep.queue_wait_ticks = 0
            rep.wall_finished = time.perf_counter()
            self.n_drained += 1
            self.log.append((self.tick, "drain", req.rid, None))
            return
        admitted, shed = self._queue.offer(req, arrival_tick, self._seq)
        self._seq += 1
        if shed is not None:
            srep = self.reports[shed.req.rid] if admitted else rep
            srep.status = SHED_QUEUE_FULL
            srep.finish_tick = self.tick
            srep.wall_finished = time.perf_counter()
            self.log.append((self.tick, "shed_queue_full", shed.req.rid, None))
        if admitted:
            self.log.append((self.tick, "enqueue", req.rid, req.priority))

    def _host_row(self, y) -> np.ndarray:
        """A request's y as the slot table holds it, on the host (journal)."""
        return _row_tensor(y, self._y_dtype, "cpu").numpy()

    # -- the refill loop ---------------------------------------------------
    def _occupied(self) -> list[int]:
        return [b for b in range(self.slots) if self._slot_rid[b] is not None]

    def _harvest_and_refill(self) -> None:
        # 1. harvest: rows whose done flag is set, or whose budget is spent
        done_h = self._state.done.cpu().numpy()
        freed: list[int] = []
        harvested = [b for b in self._occupied()
                     if done_h[b] or self._ages[b] >= self._horizon[b]]
        if harvested:
            X_h = self._state.X.cpu().numpy()
            for b in harvested:
                rid = self._slot_rid[b]
                rep = self.reports[rid]
                rep.x = X_h[b].copy()
                rep.status = DONE
                rep.finish_tick = self.tick
                rep.iters_used = int(min(self._ages[b], self._horizon[b]))
                rep.wall_finished = time.perf_counter()
                if self.journal is not None:
                    self.journal.record_result(rid, rep.x[None])
                self._slot_rid[b] = None
                freed.append(b)
                self.log.append((self.tick, "finish", rid, rep.iters_used))
        # 2. shed queue entries whose deadline passed — reported, never solved late
        for e in self._queue.shed_expired(self.tick):
            rep = self.reports[e.req.rid]
            rep.status = SHED_DEADLINE
            rep.finish_tick = self.tick
            rep.queue_wait_ticks = self.tick - e.enq_tick
            rep.wall_finished = time.perf_counter()
            self.log.append((self.tick, "shed_deadline", e.req.rid, None))
        # 3. refill freed slots from the queue ("lockstep" waits for a full
        # drain: the chunked baseline in the same engine)
        free = [b for b in range(self.slots) if self._slot_rid[b] is None]
        rows, Y_rows, live = [], [], []
        if self.policy == "continuous" or len(free) == self.slots:
            for b in free:
                entry = self._queue.pop(self.tick)
                if entry is None:
                    break
                rep = self.reports[entry.req.rid]
                rep.status = RUNNING
                rep.start_tick = self.tick
                rep.queue_wait_ticks = self.tick - entry.enq_tick
                rep.wall_started = time.perf_counter()
                if self.journal is not None:
                    self.journal.record_submit(
                        entry.req.rid, self._host_row(entry.req.y)[None], self.key,
                        extra={"rid": entry.req.rid,
                               "priority": entry.req.priority,
                               "deadline": entry.req.deadline,
                               "n_iters": entry.req.n_iters,
                               "arrival_tick": rep.arrival_tick})
                self._slot_rid[b] = entry.req.rid
                self._ages[b] = 0
                self._horizon[b] = (entry.req.n_iters
                                    if entry.req.n_iters is not None
                                    else self.n_iters)
                rows.append(b)
                Y_rows.append(_row_tensor(entry.req.y, self._y_dtype, self.device))
                live.append(True)
                self.log.append((self.tick, "start", entry.req.rid, b))
        # 4. blank harvested slots that stayed empty (pad rows: bitwise fixed
        # points the segment never waits on)
        for b in freed:
            if self._slot_rid[b] is None and b not in rows:
                rows.append(b)
                Y_rows.append(torch.zeros(self._m, dtype=self._y_dtype, device=self.device))
                live.append(False)
        if rows:
            self._state = refill_rows(self._state, rows, torch.stack(Y_rows), live)

    def _run_segment(self) -> None:
        occ = self._occupied()
        # horizon clamp: no live row may overshoot its own budget inside a
        # segment (its standalone answer is the iterate AT the budget)
        n_steps = min(self.seg_len,
                      int(min(self._horizon[b] - self._ages[b] for b in occ)))
        self._state = segment_step(self.phi, self._state, n_steps, mesh=self.mesh,
                                   **self._statics)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for b in occ:
            self._ages[b] += n_steps
        self.segments_run += 1
        self._segment_lengths[n_steps] = self._segment_lengths.get(n_steps, 0) + 1
        self._occupied_slot_segments += len(occ)
        self.log.append((self.tick, "segment", None, (n_steps, len(occ))))

    def run(self, arrivals, stop=None) -> dict[int, RequestReport]:
        """Drive an arrival trace to completion; returns ``{rid: report}``.

        ``arrivals`` is an iterable of ``(tick, Request)`` with nondecreasing
        ticks. The loop delivers arrivals due at the current tick, harvests +
        refills, runs one segment when any slot is live, and advances the
        tick; with nothing live it jumps straight to the next arrival.

        ``stop`` (optional, a callable such as a
        :class:`~repro_torch.train.fault.PreemptionGuard`'s flag) is read
        before every segment, and agreed across the mesh's ranks: when any
        rank's is set, every rank ends the run there (``preempted_at`` holds
        the tick). Requests in a slot keep status ``running``: journaled
        but not harvested, a resumed run solves them again.
        """
        arr = list(arrivals)
        for (t0, _), (t1, _) in zip(arr, arr[1:]):
            if t1 < t0:
                raise ValueError("arrival ticks must be nondecreasing")
        ai = 0
        while True:
            while ai < len(arr) and arr[ai][0] <= self.tick:
                self._admit(arr[ai][1], arrival_tick=arr[ai][0])
                ai += 1
            self._harvest_and_refill()
            if not self._occupied():
                if ai >= len(arr) and not self._queue:
                    break
                # idle: jump to the next arrival
                self.tick = max(self.tick + 1,
                                arr[ai][0] if ai < len(arr) else self.tick + 1)
                continue
            if stop is not None and any_rank(self.mesh, stop()):
                self.preempted_at = self.tick
                self.log.append((self.tick, "preempted", None, None))
                break
            self._run_segment()
            self.tick += 1
        return self.reports

    # -- observability -----------------------------------------------------
    def slot_table(self) -> list[Optional[int]]:
        """Current slot → request-id mapping (None = pad row)."""
        return list(self._slot_rid)

    def stats(self) -> dict:
        occ = (self._occupied_slot_segments / (self.segments_run * self.slots)
               if self.segments_run else 0.0)
        by_status: dict[str, int] = {}
        for rep in self.reports.values():
            by_status[rep.status] = by_status.get(rep.status, 0) + 1
        return {
            "policy": self.policy,
            "ticks": self.tick,
            "segments_run": self.segments_run,
            "segment_lengths": dict(sorted(self._segment_lengths.items())),
            "slot_occupancy": round(occ, 4),
            "drained": self.n_drained,
            **{f"n_{k}": v for k, v in sorted(by_status.items())},
        }

    def reference_solve(self, y, n_iters: Optional[int] = None) -> torch.Tensor:
        """The standalone answer the scheduler must reproduce bit for bit:
        the request alone in the slot table — ``qniht_batch`` over ``[y, 0,
        ..., 0]`` of ``slots`` rows with the scheduler's key, the request's
        budget (``n_iters``, default the scheduler's) and the user-level
        solver config (dense Φ with ``backend="packed"``, so the contract
        also covers the pack-once construction)."""
        Yp = torch.zeros((self.slots, self._m), dtype=self._y_dtype, device=self.device)
        Yp[0] = _row_tensor(y, self._y_dtype, self.device)
        phi = self.phi if self._ref_statics["backend"] != "packed" else self._ref_phi
        res = qniht_batch(phi, Yp, self.s,
                          n_iters if n_iters is not None else self.n_iters,
                          key=self.key, early_exit=True, with_trace=False,
                          **self._ref_statics)
        return res.x[0]
