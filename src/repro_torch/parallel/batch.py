"""Batch recovery for serving, on one device (port of the single-device half
of ``repro.parallel.batch``).

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
* :class:`BatchServer` — the multi-chunk server: Φ̂ packed once at
  construction, a stream of equally shaped ``(B, M)`` chunks solved with
  per-chunk keys, optionally write-ahead journaled;
* :func:`make_batch_mesh` — the serving "mesh", which on one device is the
  device itself.

The reference splits the rows over a ``("batch",)`` device mesh with
``shard_map``; that half (``sharded_qniht_run``, ``sharded_segment_run``,
``state_shardings``, ``force_host_devices``) is not yet ported: it comes
over ``torch.distributed``. Here every chunk runs on the device of its Φ.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.core.niht import IHTResult, IHTTrace, SolverState, _validate, qniht_batch
from repro_torch.core.operators import PackedStreamingOperator
from repro_torch.device import resolve_device
from repro_torch.parallel.journal import ChunkJournal
from repro_torch.quant.formats import as_granularity

SHARDING_NOT_PORTED = ("sharding the batch over several devices is not yet ported "
                       "(ROADMAP.md queue 1, \"Sharding over several devices\": over "
                       "torch.distributed)")


def make_batch_mesh(n_devices: Optional[int] = None, device=None) -> torch.device:
    """The serving mesh of one device: ``device`` itself (default ``cuda``).

    ``n_devices`` may be None or 1; more raises, since sharding the batch is
    not yet ported."""
    if n_devices is not None:
        if n_devices < 1:
            raise ValueError(f"n_devices must be >= 1, got {n_devices}")
        if n_devices > 1:
            raise NotImplementedError(SHARDING_NOT_PORTED)
    return resolve_device(device)


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
    return SolverState(
        k=state.k, X=state.X[:b], done=state.done[:b], streak=state.streak[:b],
        last=IHTTrace(*(t[:b] for t in state.last)),
        trace=IHTTrace(*(t[:, :b] for t in state.trace)),
        Y=state.Y[:b], key=state.key,
    )


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


class BatchServer:
    """Multi-chunk recovery service on one device: the chunked serving loop.

    Holds one measurement operator and one solver configuration, and solves a
    stream of equally shaped ``(B, M)`` observation chunks on the device of
    Φ. Amortization contract:

    * **pack once** — with ``backend="packed"``, Φ̂ is quantized and packed at
      construction (keyed as the solver would: ``fold_in(kφ, 0)`` of the
      construction key's second split half), and every chunk streams the same
      codes through the ``qmm`` kernels as a matrix-free operator, so no
      chunk quantizes or packs Φ̂;
    * **per-chunk keys** — ``submit(Y, key=k)`` draws the chunk's observation
      quantization from ``k`` (default: the construction key).

    ``compile_cache_keys`` records the distinct chunk shapes seen (the
    reference compiles once per shape; here nothing is compiled per shape).

    Bit-identity: with construction key K and ``submit(Y, key=K)``, row ``b``
    equals ``qniht_batch(phi, Y, ..., key=K)`` of the user-level backend
    configuration bit for bit.

    Restartability: with ``journal_dir`` set, every chunk is write-ahead
    journaled (:class:`~repro_torch.parallel.journal.ChunkJournal`) — inputs
    before the solve, result after. A restarted server with the same
    ``journal_dir`` and ``resume=True``, fed the same deterministic stream,
    drains completed chunks from disk (``n_drained`` counts them) and replays
    in-flight ones; the ``x`` stream is bit-identical to the uninterrupted
    run's. Drained chunks carry a NaN/zero placeholder trace.
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
        self.mesh = mesh if mesh is not None else make_batch_mesh(n_devices, dev)
        if dev is not None and torch.device(self.mesh) != dev:
            raise ValueError(f"the mesh is device {self.mesh}, but Φ lies on {dev}")
        self.key = key if key is not None else prng.PRNGKey(0)
        self.phi = phi
        self.journal = ChunkJournal(journal_dir) if journal_dir is not None else None
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
        res = qniht_batch(self.phi, Y, key=k, **self._statics)
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
        return 1

    @property
    def compile_cache_keys(self) -> tuple:
        """Distinct chunk shapes seen so far."""
        return tuple(sorted(self._shapes))
