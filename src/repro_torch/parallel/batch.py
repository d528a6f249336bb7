"""Batch recovery for serving: the chunked server, and the batch's rows split
over a mesh of ranks (port of ``repro.parallel.batch``).

NIHT iterations for independent observations of one Φ̂ never interact: all
cross-row structure in ``qniht_batch`` is the shared operator stream, while
step sizes, supports, backtracking and convergence are per row. This module
holds the serving loop's pieces that rest on that:

* :func:`pad_batch`, :func:`pad_state` and :func:`strip_state` — zero pad
  rows (``Y = 0, X = 0, done = True``: x = 0 is a bitwise fixed point of the
  iteration for y = 0) and their removal;
* :func:`refill_rows` — splice fresh observations into rows of a live
  :class:`~repro_torch.core.niht.SolverState`, every other row bitwise
  untouched (the continuous-batching refill of
  :mod:`repro_torch.parallel.scheduler`);
* :func:`make_batch_mesh` — the serving mesh
  (:class:`~repro_torch.parallel.dist.BatchMesh`): one device, or the ranks
  of a ``torch.distributed`` process group
  (:func:`~repro_torch.parallel.dist.spawn_ranks`);
* :func:`sharded_qniht_run` and :func:`sharded_segment_run` — the solve and
  the segment with the rows split over a mesh: every rank pads the global
  batch to the mesh width, solves its own contiguous block of rows
  (:func:`owned_rows`, :func:`shard_state`) on its own device with no
  collective inside an iteration, and the ranks ``all_gather`` the blocks
  (:func:`gather_state`) and strip the padding. Φ̂ (or the matrix-free
  operator) and the key are on every rank, so each rank draws what the
  one-device solve draws. A rank whose rows have all converged stops
  (``early_exit``);
* :class:`BatchServer` — the multi-chunk server: Φ̂ packed once at
  construction, a stream of equally shaped ``(B, M)`` chunks solved with
  per-chunk keys over a mesh, optionally write-ahead journaled.

Bit-identity across widths: torch's batched products and sums (on the CPU,
and cuBLAS and cuFFT on the card) choose their order of summation by the
batch's width, not by the other rows' values. So a rank solves its block as
a batch of the one-device width, with every row outside its block a pad row,
and row b meets the shapes of the one-device solve; under the freeze rule
(``exit_tol > 0``) the solver already computes every row alone, and a rank
solves only its own rows. Row b is then the one-device row b bit for bit, at
every width, and a state checkpointed at one width resumes at another. On the
CPU the products also choose their order by the number of intra-op threads;
ranks run one thread each, so the one-device run they equal is a one-thread
run.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import random as prng
from repro_torch.core.niht import (
    _SEG_DEFAULTS,
    IHTResult,
    IHTTrace,
    SolverState,
    _qniht_core,
    _validate,
    solver_segment,
)
from repro_torch.core.operators import PackedStreamingOperator
from repro_torch.device import resolve_device
from repro_torch.parallel.dist import SPAWN_HINT, BatchMesh, all_gather_rows, narrow, world_mesh
from repro_torch.parallel.journal import ChunkJournal
from repro_torch.quant.formats import as_granularity


def make_batch_mesh(n_devices: Optional[int] = None, device=None,
                    backend: Optional[str] = None) -> BatchMesh:
    """The serving mesh.

    Outside a process group it is one device, ``device`` (default ``cuda``),
    and ``n_devices`` may be None or 1: more raises a ``ValueError`` that
    names :func:`~repro_torch.parallel.dist.spawn_ranks` and the CLIs'
    ``--devices``. Inside a rank it is the first ``n_devices`` ranks of the
    process group (default: all of them), each on its own device of
    ``device``'s type; every rank must call it, and a rank past
    ``n_devices`` gets a mesh it is not a member of. ``backend``, if given,
    must be the group's."""
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if not (dist.is_available() and dist.is_initialized()):
        if n_devices is not None and n_devices > 1:
            raise ValueError(f"a mesh of {n_devices} devices is a process group of "
                             f"{n_devices} ranks, and this process is in none: {SPAWN_HINT}")
        return one_device_mesh(device)
    mesh = world_mesh(device if device is not None else "cuda")
    if backend is not None and backend != mesh.backend:
        raise ValueError(f"the process group's backend is {mesh.backend!r}, not {backend!r}")
    if n_devices is not None and n_devices > mesh.size:
        raise ValueError(f"n_devices={n_devices} but the process group has {mesh.size} ranks")
    return narrow(mesh, n_devices if n_devices is not None else mesh.size)


def one_device_mesh(device=None) -> BatchMesh:
    """The mesh of one device (default ``cuda``), in a process group or not."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return BatchMesh(size=1, rank=0, device=dev)


def check_mesh(mesh) -> BatchMesh:
    """``mesh``, if it is a :class:`BatchMesh` (else ``TypeError``)."""
    if not isinstance(mesh, BatchMesh):
        raise TypeError(f"mesh must be a BatchMesh (make_batch_mesh), got {type(mesh).__name__}")
    return mesh


def _solver_mesh(mesh, n_devices, device) -> BatchMesh:
    """``mesh``, or :func:`make_batch_mesh` of ``n_devices``; this rank must
    be in it, on ``device``."""
    mesh = check_mesh(mesh) if mesh is not None else make_batch_mesh(n_devices, device)
    if not mesh.member:
        raise ValueError(f"this rank is outside the mesh of {mesh.size} ranks")
    if torch.device(device) != mesh.device:
        raise ValueError(f"the mesh's device is {mesh.device}, but the rows lie on {device}")
    return mesh


def _operator_device(phi) -> Optional[torch.device]:
    """The device of a dense Φ or a packed operator's codes (None for
    another operator)."""
    if isinstance(phi, torch.Tensor):
        return phi.device
    packed = getattr(phi, "packed", None)
    return packed.fwd_re.packed.device if packed is not None else None


def _pad_rows(a: torch.Tensor, p: int, fill=0) -> torch.Tensor:
    return torch.cat([a, torch.full((p,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                                    device=a.device)])


def pad_batch(Y: torch.Tensor, n_shards: int) -> tuple[torch.Tensor, int]:
    """Zero-pad rows of (B, M) ``Y`` up to a multiple of ``n_shards``.

    Returns ``(Y_padded, B)``. Zero rows are free riders: NIHT accepts x = 0
    for y = 0 at the first iteration."""
    b = Y.shape[0]
    b_pad = -(-b // n_shards) * n_shards
    if b_pad == b:
        return Y, b
    return _pad_rows(Y, b_pad - b), b


def pad_state(state: SolverState, n_shards: int) -> tuple[SolverState, int]:
    """Zero-pad a :class:`SolverState`'s rows up to a multiple of ``n_shards``.

    Returns ``(state_padded, B)``. Pad rows are ``Y = 0, X = 0, done = True``:
    x = 0 is a bitwise fixed point of the iteration for y = 0, so a pad row
    never changes and never holds up the early exit; padding to any width and
    stripping back is the identity on the real rows."""
    b = state.Y.shape[0]
    b_pad = -(-b // n_shards) * n_shards
    if b_pad == b:
        return state, b
    p = b_pad - b

    def trace_cols(t):
        return torch.cat([t, torch.zeros((t.shape[0], p) + tuple(t.shape[2:]), dtype=t.dtype,
                                         device=t.device)], dim=1)

    return SolverState(
        k=state.k,
        X=_pad_rows(state.X, p),
        done=_pad_rows(state.done, p, True),
        streak=_pad_rows(state.streak, p),
        last=IHTTrace(*(_pad_rows(t, p) for t in state.last)),
        trace=IHTTrace(*(trace_cols(t) for t in state.trace)),
        Y=_pad_rows(state.Y, p),
        key=state.key,
    ), b


def strip_state(state: SolverState, b: int) -> SolverState:
    """Drop pad rows again (inverse of :func:`pad_state` on the real rows)."""
    if state.Y.shape[0] == b:
        return state
    return _take_rows(state, slice(None, b))


def refill_rows(state: SolverState, rows, Y_rows, live) -> SolverState:
    """Splice fresh observations into ``rows`` of a :class:`SolverState`,
    leaving every other row **bitwise untouched** — the continuous-batching
    refill primitive (:mod:`repro_torch.parallel.scheduler`).

    ``rows`` is a sequence of distinct row indices, ``Y_rows`` the matching
    ``(len(rows), M)`` observation block (tensor or numpy), and ``live`` a
    boolean per row: ``True`` re-initializes the row for a new request
    (``X = 0``, ``done = False``, fresh streak and trace), ``False`` turns it
    into a pad row (``Y`` must be zero; ``done = True``).

    A spliced row matches :func:`~repro_torch.core.niht.solver_init`'s row-0
    state except ``last``'s residual markers, which are zeroed rather than
    NaN (the marker means "not recorded yet"; it never feeds ``X``).

    Purity: every leaf is spliced into a clone, so the input state keeps all
    its bits, as JAX's functional ``.at[]`` scatters leave theirs
    (``solver_segment`` hands its input's ``Y`` to the state it returns, so
    a write in place would also rewrite the previous state's)."""
    rows = [int(r) for r in rows]
    if len(set(rows)) != len(rows):
        raise ValueError(f"refill_rows needs distinct rows, got {rows}")
    b = state.Y.shape[0]
    if any(r < 0 or r >= b for r in rows):
        raise ValueError(f"rows {rows} out of range for B={b}")
    if not isinstance(Y_rows, torch.Tensor):
        Y_rows = torch.from_numpy(np.asarray(Y_rows))
    Y_rows = Y_rows.to(dtype=state.Y.dtype, device=state.Y.device)
    if tuple(Y_rows.shape) != (len(rows), state.Y.shape[1]):
        raise ValueError(
            f"Y_rows shape {tuple(Y_rows.shape)} != {(len(rows), state.Y.shape[1])}")
    live = [bool(v) for v in live]
    if len(live) != len(rows):
        raise ValueError(f"live must be one flag per row, got {len(live)}")
    dev = state.Y.device
    idx = torch.tensor(rows, dtype=torch.int64, device=dev)

    def zero_rows(a):
        out = a.clone()
        out[idx] = 0
        return out

    def zero_cols(t):
        out = t.clone()
        out[:, idx] = 0
        return out

    done = state.done.clone()
    done[idx] = ~torch.tensor(live, dtype=torch.bool, device=dev)
    Y = state.Y.clone()
    Y[idx] = Y_rows
    return SolverState(
        k=state.k,
        X=zero_rows(state.X),
        done=done,
        streak=zero_rows(state.streak),
        last=IHTTrace(*(zero_rows(t) for t in state.last)),
        trace=IHTTrace(*(zero_cols(t) for t in state.trace)),
        Y=Y,
        key=state.key,
    )


def owned_rows(b_pad: int, mesh: BatchMesh) -> slice:
    """The rows of a batch padded to the mesh's width (:func:`pad_batch`)
    that this rank solves: its contiguous block of ``b_pad / size`` rows, in
    rank order (the reference's ``P("batch")`` split)."""
    per = b_pad // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def _take_rows(state: SolverState, rows: slice) -> SolverState:
    return SolverState(
        k=state.k, X=state.X[rows], done=state.done[rows], streak=state.streak[rows],
        last=IHTTrace(*(t[rows] for t in state.last)),
        trace=IHTTrace(*(t[:, rows] for t in state.trace)),
        Y=state.Y[rows], key=state.key)


def _only_rows(Y: torch.Tensor, rows: slice) -> torch.Tensor:
    """``Y`` with every row outside ``rows`` zeroed (a pad row)."""
    out = torch.zeros_like(Y)
    out[rows] = Y[rows]
    return out


def shard_state(state: SolverState, mesh: BatchMesh, row_local: bool) -> tuple:
    """This rank's share of a stripped :class:`SolverState` on ``mesh`` (the
    counterpart of the reference's ``state_shardings``: a state of any
    width, from a segment or a checkpoint, is placed on the mesh it goes on
    with). Returns ``(local_state, B)``.

    ``row_local`` (the freeze rule computes every row alone): the rank's rows
    of the state padded to the mesh width. Otherwise the state at its own
    width with every row outside the rank's block a pad row, so that each
    row meets the shapes of the one-device solve."""
    state_p, b = pad_state(state, mesh.size)
    rows = owned_rows(state_p.Y.shape[0], mesh)
    if row_local:
        return _take_rows(state_p, rows), b
    foreign = [r for r in range(b) if not rows.start <= r < rows.stop]
    if not foreign:
        return state, b
    blank = torch.zeros((len(foreign), state.Y.shape[1]), dtype=state.Y.dtype,
                        device=state.Y.device)
    return refill_rows(state, foreign, blank, [False] * len(foreign)), b


def gather_state(local: SolverState, mesh: BatchMesh, b: int, row_local: bool,
                 Y: torch.Tensor) -> SolverState:
    """The inverse of :func:`shard_state` after a segment: every rank's block
    gathered (one ``all_gather``), the padding stripped, ``Y`` the global
    observations. Every rank returns the same state."""
    b_pad = -(-b // mesh.size) * mesh.size
    if not row_local:
        local = _take_rows(pad_state(local, mesh.size)[0], owned_rows(b_pad, mesh))
    leaves = [local.X, local.done, local.streak, *local.last, *local.trace]
    out = all_gather_rows(mesh, leaves, [0] * 8 + [1] * 5)
    return strip_state(SolverState(
        k=local.k, X=out[0], done=out[1], streak=out[2], last=IHTTrace(*out[3:8]),
        trace=IHTTrace(*out[8:]), Y=pad_batch(Y, mesh.size)[0], key=local.key), b)


def sharded_qniht_run(phi, Y: torch.Tensor, key, *, mesh=None, n_devices=None,
                      **statics) -> IHTResult:
    """Pad, solve this rank's rows, ``all_gather``, strip: the backend of
    :func:`repro_torch.core.niht.qniht_batch_sharded` (call that instead: it
    validates the solver configuration first). Every rank of the mesh calls
    it with the same arguments and returns the same global result."""
    mesh = _solver_mesh(mesh, n_devices, Y.device)
    statics.pop("unroll", None)      # the reference's scan knob, no effect here
    if mesh.size == 1:
        return _qniht_core(phi, Y, key=key, **statics)
    row_local = statics["exit_tol"] > 0.0
    Y_pad, b = pad_batch(Y, mesh.size)
    rows = owned_rows(Y_pad.shape[0], mesh)
    res = _qniht_core(phi, Y_pad[rows] if row_local else _only_rows(Y, rows), key=key,
                      **statics)
    x, trace = res.x, res.trace
    if not row_local:
        p = Y_pad.shape[0] - b
        x = _pad_rows(x, p)[rows]
        trace = [torch.cat([t, torch.zeros((t.shape[0], p), dtype=t.dtype, device=t.device)],
                           dim=1)[:, rows] for t in trace]
    x, *trace = all_gather_rows(mesh, [x, *trace], [0] + [1] * 5)
    return IHTResult(x=x[:b], trace=IHTTrace(*(t[:, :b] for t in trace)))


def sharded_segment_run(phi, state: SolverState, n_steps: int, *, mesh=None,
                        n_devices: Optional[int] = None, **statics) -> SolverState:
    """:func:`~repro_torch.core.niht.solver_segment` with the state's rows
    split over a mesh: the segment engine of the preemption-safe driver
    (:mod:`repro_torch.launch.resilience`) and of the continuous scheduler.

    The returned (and checkpointed) state is stripped of the padding and
    never records the mesh it ran on: save at ``--devices 4``, resume at
    ``--devices 2`` or on one device, to the same bits. Every rank of the
    mesh calls it with the same state and returns the same state."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    statics = {**_SEG_DEFAULTS, **statics}
    mesh = _solver_mesh(mesh, n_devices, state.Y.device)
    if mesh.size == 1:
        return solver_segment(phi, state, n_steps, **statics)
    row_local = statics["exit_tol"] > 0.0
    local, b = shard_state(state, mesh, row_local)
    out = solver_segment(phi, local, n_steps, **statics)
    return gather_state(out, mesh, b, row_local, state.Y)


class BatchServer:
    """Multi-chunk recovery service: the chunked serving loop, over a mesh.

    Holds one measurement operator and one solver configuration, and solves a
    stream of equally shaped ``(B, M)`` observation chunks, each chunk's rows
    split over ``mesh`` (default :func:`make_batch_mesh` of ``n_devices``
    on the device of Φ: one device, or inside a rank the process group's
    ranks, each of which runs the server on the same stream). Amortization
    contract:

    * **pack once** — with ``backend="packed"``, Φ̂ is quantized and packed at
      construction (keyed as the solver would: ``fold_in(kφ, 0)`` of the
      construction key's second split half), on every rank, and every chunk
      streams the same codes through the ``qmm`` kernels as a matrix-free
      operator, so no chunk quantizes or packs Φ̂;
    * **per-chunk keys** — ``submit(Y, key=k)`` draws the chunk's observation
      quantization from ``k`` (default: the construction key).

    ``compile_cache_keys`` records the distinct chunk shapes seen (the
    reference compiles once per shape; here nothing is compiled per shape).

    Bit-identity: with construction key K and ``submit(Y, key=K)``, row ``b``
    equals ``qniht_batch(phi, Y, ..., key=K)`` of the user-level backend
    configuration bit for bit, at every mesh width.

    Restartability: with ``journal_dir`` set, every chunk is write-ahead
    journaled (:class:`~repro_torch.parallel.journal.ChunkJournal`, written
    by rank 0 only) — inputs before the solve, result after. A restarted
    server with the same ``journal_dir`` and ``resume=True``, fed the same
    deterministic stream, drains completed chunks from disk on every rank
    (``n_drained`` counts them) and replays in-flight ones; the ``x`` stream
    is bit-identical to the uninterrupted run's, whatever the widths of the
    two runs. Drained chunks carry a NaN/zero placeholder trace.
    """

    def __init__(self, phi, s: int, n_iters: int = 50, *, mesh=None,
                 n_devices: Optional[int] = None,
                 bits_phi: Optional[int] = None, bits_y: Optional[int] = None,
                 key: Optional[torch.Tensor] = None, requantize: str = "fixed",
                 backend: str = "dense", threshold: str = "topk",
                 c: float = 0.01, shrink_k: float = 2.0, max_backtracks: int = 30,
                 real_signal: bool = False, nonneg: bool = False,
                 with_trace: bool = False,
                 scale_granularity: str = "per_tensor",
                 group_size: Optional[int] = None, early_exit: bool = True,
                 exit_tol: float = 0.0, unroll: int = 1,
                 journal_dir: Optional[str] = None, resume: bool = False):
        _validate(phi, bits_phi, bits_y, key, requantize, backend, threshold,
                  real_signal, scale_granularity, group_size, early_exit,
                  exit_tol, unroll)
        if resume and journal_dir is None:
            raise ValueError("resume=True needs a journal_dir to resume from")
        dev = _operator_device(phi)
        self.mesh = check_mesh(mesh) if mesh is not None else make_batch_mesh(n_devices, dev)
        if dev is not None and self.mesh.device != dev:
            raise ValueError(f"the mesh's device is {self.mesh.device}, but Φ lies on {dev}")
        self.key = key if key is not None else prng.PRNGKey(0)
        self.phi = phi
        self.journal = (ChunkJournal(journal_dir, writer=self.mesh.is_writer)
                        if journal_dir is not None else None)
        self._resume = bool(resume)
        self.n_chunks = 0
        self.n_items = 0
        self.n_drained = 0
        self._shapes: set = set()
        statics = dict(
            s=s, n_iters=n_iters, bits_phi=bits_phi, bits_y=bits_y,
            requantize=requantize, backend=backend, threshold=threshold, c=c,
            shrink_k=shrink_k, max_backtracks=max_backtracks,
            real_signal=real_signal, nonneg=nonneg, with_trace=with_trace,
            scale_granularity=scale_granularity, group_size=group_size,
            early_exit=early_exit, exit_tol=exit_tol, unroll=unroll,
        )
        if backend == "packed":
            # pack once with the key the in-loop pack would fold, then serve
            # through the operator path: no chunk re-quantizes Φ̂
            _, kphi = prng.split(self.key)
            self.phi = PackedStreamingOperator.pack(
                phi, bits_phi, prng.fold_in(kphi, 0),
                granularity=as_granularity(scale_granularity, group_size))
            statics.update(bits_phi=None, backend="dense", scale_granularity="per_tensor",
                           group_size=None)
        self._statics = statics

    def submit(self, Y: torch.Tensor, key: Optional[torch.Tensor] = None,
               row_mask=None) -> IHTResult:
        """Solve one (B, M) chunk; returns the usual :class:`IHTResult`.

        ``row_mask`` (optional (B,) bool) marks which rows are live user
        requests: masked rows of ``Y`` are zeroed before the solve (an
        all-zero row fixes at x = 0), the journal stores only the valid rows
        of x, and a drained chunk has zeros at the invalid rows, as the live
        solve.

        With a journal, the chunk index is this server's submission count; the
        inputs (mask included) are journaled before the solve and the result
        after. Under ``resume=True`` a chunk whose result is journaled is
        drained from disk instead of solved."""
        if Y.ndim != 2:
            raise ValueError(f"BatchServer.submit expects (B, M) chunks, got {tuple(Y.shape)}")
        mask = ChunkJournal._norm_mask(row_mask, Y.shape[0])
        if mask is not None:
            keep = torch.from_numpy(mask).to(Y.device)
            Y = torch.where(keep[:, None], Y, torch.zeros_like(Y))
        idx = self.n_chunks
        self.n_chunks += 1
        self.n_items += Y.shape[0] if mask is None else int(mask.sum())
        k = key if key is not None else self.key
        if self.journal is not None:
            if self._resume and self.journal.is_complete(idx):
                self.journal.verify_submit(idx, Y, k, mask)
                self.n_drained += 1
                x = torch.from_numpy(self.journal.load_result_full(idx)).to(Y.device)
                return IHTResult(x=x, trace=self._placeholder_trace(Y.shape[0], Y.device))
            self.journal.record_submit(idx, Y, k, mask)
        self._shapes.add(tuple(Y.shape))
        res = sharded_qniht_run(self.phi, Y, k, mesh=self.mesh, **self._statics)
        if self.journal is not None:
            self.journal.record_result(idx, res.x, mask)
        return res

    def _placeholder_trace(self, b: int, device) -> IHTTrace:
        """Trace shell for a drained chunk (the journal persists only x)."""
        n_iters = self._statics["n_iters"]
        nanbuf = torch.from_numpy(np.full((n_iters, b), np.nan, np.float32)).to(device)
        return IHTTrace(resid_q=nanbuf, resid_true=nanbuf.clone(), mu=nanbuf.clone(),
                        support_changed=torch.zeros((n_iters, b), dtype=torch.bool,
                                                    device=device),
                        backtracks=torch.zeros((n_iters, b), dtype=torch.int32,
                                               device=device))

    def serve(self, chunks, keys=None):
        """Drive a stream: yields one :class:`IHTResult` per chunk. ``keys``
        (optional iterable) supplies per-chunk observation keys; when
        exhausted or None, chunks fall back to the construction key."""
        key_iter = iter(keys) if keys is not None else None
        for Y in chunks:
            k = next(key_iter, None) if key_iter is not None else None
            yield self.submit(Y, k)

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    @property
    def compile_cache_keys(self) -> tuple:
        """Distinct chunk shapes seen so far."""
        return tuple(sorted(self._shapes))
