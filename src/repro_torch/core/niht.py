"""Normalized Iterative Hard Thresholding, full precision and quantized (QNIHT).

Port of ``repro.core.niht`` (the paper's Algorithm 1):

* step size µ = ||g_Γ||² / ||Φ̂ g_Γ||² on the current support Γ,
* proposal x⁺ = H_s(x + µ g) with g = Φ̂₁†(ŷ − Φ̂₂ x),
* if the support changes, accept only when µ ≤ (1−c)·ω with
  ω = ||x⁺−x||² / ||Φ̂₁(x⁺−x)||², else shrink µ ← µ/(k(1−c)) and re-propose,
* Φ̂ redrawn every iteration (``requantize="pair"``) or quantized once
  (``"fixed"``); ``backend="packed"`` streams the fixed quantization's packed
  codes through the ``qmm`` kernels, with one scale per tensor (shared codes),
  per row (``scale_granularity="per_channel"``) or per g codes along the
  contraction (``"per_block"``, ``group_size=g``; the group kernel); a
  matrix-free operator (``mv``/``rmv``, e.g. the MRI operators of
  :mod:`repro_torch.core.operators`) is applied as it is;
* H_s is the exact top s (``threshold="topk"``) or, for a real signal, the
  streaming histogram-select-mask of paper §8 (``threshold="hsthresh"``):
  on the card one launch of the fused ``repro_hsthresh`` kernel per proposal
  for the whole batch, on the CPU its plain version.

``early_exit`` stops the loop once every row is done: lossless
(``exit_tol=0``, a row is done at a bitwise fixed point, and the result is the
one of ``early_exit=False`` bit for bit) or the freeze rule (``exit_tol > 0``,
a row is frozen after ``_EXIT_PATIENCE`` consecutive updates with
‖x⁺−x‖ ≤ exit_tol·‖x⁺‖, and re-emits its last trace row). Trace rows past the
stop are filled with the stationary last row. :class:`SolverState`,
:func:`solver_init`, :func:`solver_segment` and :func:`solver_result` run the
same iterations in segments; any split of ``[0, n_iters)`` gives the one-shot
run's bits.

PyTorch idiom in place of JAX's: the batch axis is written out, the iteration
loop is a Python loop (so ``unroll``, a ``lax.scan`` knob, has no effect) and
the per-row backtracking a Python loop on ``active.any()``; with
``early_exit`` the loop also reads ``done.all()`` once per iteration. Every
stochastic draw derives from ``key`` exactly as in the reference (ŷ from
``split(key)[0]``, Φ̂ from ``fold_in(split(key)[1], 0)``), so both packages
quantize identically.

The freeze rule promises results that do not depend on how rows are grouped
into batches. torch's batched reductions and products (on the CPU and in
cuBLAS and cuFFT) pick their summation order by batch size, so with
``exit_tol > 0`` the solver sums each row on its own (:func:`_rowwise_sqnorm`)
and applies each operator one row at a time (:class:`_RowBlocks`), or in
blocks of up to 16 rows for the packed operator on the card, whose ``qmm``
kernels give row b of such a block the bits of a batch of one.

:func:`qniht_batch_sharded` splits the batch's rows over a mesh of
``torch.distributed`` ranks (:mod:`repro_torch.parallel.batch`); the serving
layer on these segments is :mod:`repro_torch.parallel`.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import random as prng
from repro_torch.core.operators import is_linear_operator, make_iteration_operators
from repro_torch.core.threshold import hard_threshold, top_s_mask
from repro_torch.kernels.hsthresh.ops import hsthresh
from repro_torch.quant.formats import as_granularity
from repro_torch.quant.quantize import fake_quantize


class IHTTrace(NamedTuple):
    """Per-iteration diagnostics, (n_iters,) per problem; batched runs (n_iters, B)."""

    resid_q: torch.Tensor        # ||ŷ − Φ̂ x||₂ (the cost the algorithm minimizes)
    resid_true: torch.Tensor     # ||y − Φ x||₂ against full-precision data
    mu: torch.Tensor             # accepted step size
    support_changed: torch.Tensor
    backtracks: torch.Tensor


class IHTResult(NamedTuple):
    x: torch.Tensor
    trace: IHTTrace


# consecutive sub-tol updates required before the freeze rule (exit_tol > 0)
# declares a row stalled
_EXIT_PATIENCE = 3

# row length multiple of the row-local sums: every padded row starts on a
# 128-byte boundary, so a row's sum takes the same path in any batch
_ROW_ALIGN = 32


def _rows_sqnorm(v: torch.Tensor) -> torch.Tensor:
    """Squared l2 norm along the last axis (per problem)."""
    return (v * v.conj()).real.sum(dim=-1) if v.is_complex() else (v * v).sum(dim=-1)


def _rowwise_sqnorm(v: torch.Tensor) -> torch.Tensor:
    """:func:`_rows_sqnorm` with each row summed on its own, as a 1-D tensor
    of one length and alignment whatever the batch: the bits of a row do not
    depend on the other rows or on their number."""
    sq = (v * v.conj()).real if v.is_complex() else v * v
    sq = F.pad(sq, (0, -sq.shape[-1] % _ROW_ALIGN))
    return torch.stack([row.sum() for row in sq])


class _RowBlocks:
    """An operator applied to blocks of at most ``rows`` rows, each block
    copied to a fresh tensor, where the operator computes each row of a call
    of up to ``rows`` rows alone (``independent_rows``; 1 for one that does
    not say: torch.matmul, cuBLAS and cuFFT pick their summation by batch
    size). A row's bits then do not depend on the batch it came in."""

    def __init__(self, op, rows: int):
        self.op, self.rows = op, rows

    def _apply(self, f, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] <= self.rows:
            return f(x)
        return torch.cat([f(block.clone()) for block in x.split(self.rows)])

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return self._apply(self.op.mv, x)

    def rmv(self, r: torch.Tensor) -> torch.Tensor:
        return self._apply(self.op.rmv, r)


def _row_local(op) -> _RowBlocks:
    """``op`` applied in blocks of its ``independent_rows`` (default 1)."""
    return _RowBlocks(op, getattr(op, "independent_rows", 1))


def _project(a: torch.Tensor, real_signal: bool, nonneg: bool) -> torch.Tensor:
    if real_signal:
        a = a.real if a.is_complex() else a
        if nonneg:
            a = torch.clamp_min(a, 0.0)
    return a


def _make_hs(threshold: str, s: int):
    """Batched H_s: (B, N) → (B, N) with per-row support size ≤ s."""
    if threshold == "topk":
        return lambda v: hard_threshold(v, s)
    if threshold == "hsthresh":
        return lambda v: hsthresh(v, s)
    raise ValueError(f"unknown threshold {threshold!r} (use 'topk' or 'hsthresh')")


def _niht_iteration_batch(X, Yhat, op1, op2, s, c, shrink_k, max_backtracks,
                          real_signal, nonneg, hs, sqnorm=_rows_sqnorm):
    """One NIHT step on a batch of problems sharing Φ̂.

    ``op1`` is Φ̂_{2n-1} (gradient, step size, acceptance), ``op2`` is Φ̂_{2n}
    (residual). Each operator application serves the whole batch; support
    logic and backtracking are per row. ``sqnorm`` takes the per-row squared
    norms. Returns (X_new, mu, changed, n_bt).
    """
    eps = 1e-30
    R = Yhat - op2.mv(X)
    G = op1.rmv(R)

    # Γ: support of x, or (x = 0, the first iteration) the top s of the gradient
    on_init = _rows_sqnorm(X) == 0.0
    gamma = torch.where(on_init[:, None], top_s_mask(G, s), X.abs() > 0)

    Gg = torch.where(gamma, G, torch.zeros_like(G))
    mu0 = sqnorm(Gg) / (sqnorm(op1.mv(Gg)) + eps)

    def propose(mu):
        A = X.to(G.dtype) + mu[:, None] * G
        return hs(_project(A, real_signal, nonneg).to(X.dtype))

    def accept(mu, Xp):
        same = ((Xp.abs() > 0) == gamma).all(dim=-1)
        D = Xp - X
        omega = sqnorm(D) / (sqnorm(op1.mv(D)) + eps)
        return same | (mu <= (1.0 - c) * omega)

    mu, Xp = mu0, propose(mu0)
    active = ~accept(mu, Xp)
    n_bt = torch.zeros(X.shape[0], dtype=torch.int32, device=X.device)
    while True:
        act = active & (n_bt < max_backtracks)
        if not bool(act.any()):
            break
        mu = torch.where(act, mu / (shrink_k * (1.0 - c)), mu)
        Xp = torch.where(act[:, None], propose(mu), Xp)
        n_bt = n_bt + act.to(torch.int32)
        active = act & ~accept(mu, Xp)
    changed = ~((Xp.abs() > 0) == gamma).all(dim=-1)
    return Xp, mu, changed, n_bt


def niht_iteration(x: torch.Tensor, y_hat: torch.Tensor, op1, op2, s: int, c: float,
                   shrink_k: float, max_backtracks: int, real_signal: bool, nonneg: bool,
                   threshold: str = "topk"):
    """One NIHT step on a single problem. ``op1``/``op2`` follow the
    :mod:`repro_torch.core.operators` protocol (``mv``/``rmv`` over a batch
    axis): ``op1`` is Φ̂_{2n-1} (gradient, step size, acceptance), ``op2``
    Φ̂_{2n} (residual). Returns (x_new, mu, changed, n_backtracks)."""
    X, mu, ch, nbt = _niht_iteration_batch(
        x[None, :], y_hat[None, :], op1, op2, s, c, shrink_k, max_backtracks,
        real_signal, nonneg, _make_hs(threshold, s))
    return X[0], mu[0], ch[0], nbt[0]


def _nan_rows(B: int, device) -> torch.Tensor:
    """(B,) float32 NaN markers, built on the host and transferred: a
    transfer, not an operation that produces a NaN, so it passes the
    sanitizer (:mod:`repro_torch.analysis.sanitize`), as in the reference."""
    return torch.from_numpy(np.full((B,), np.nan, np.float32)).to(device)


def _validate(phi, bits_phi, bits_y, key, requantize, backend, threshold, real_signal,
              scale_granularity="per_tensor", group_size=None, early_exit=False,
              exit_tol=0.0, unroll=1):
    if (bits_phi or bits_y) and key is None:
        raise ValueError("quantized NIHT needs a PRNG key")
    if requantize not in ("pair", "fixed"):
        raise ValueError(f"unknown requantize {requantize!r}")
    if early_exit and bits_phi and requantize == "pair":
        raise ValueError(
            "early_exit skips iterations once x reaches a bitwise fixed point, "
            "which is only absorbing when every iteration applies the same "
            "operators; requantize='pair' redraws Φ̂ each iteration — use "
            "requantize='fixed' (or full precision) with early_exit")
    if exit_tol < 0.0:
        raise ValueError(f"exit_tol must be >= 0, got {exit_tol}")
    if exit_tol > 0.0 and not early_exit:
        raise ValueError("exit_tol is the early_exit freeze tolerance; set early_exit=True")
    if unroll < 1:
        raise ValueError(f"unroll must be a positive int, got {unroll}")
    if unroll > 1 and early_exit:
        raise ValueError(
            "unroll is the reference's lax.scan knob; the early_exit loop has a "
            "data-dependent trip count and cannot unroll — use unroll with "
            "early_exit=False")
    if backend not in ("dense", "packed"):
        raise ValueError(f"unknown backend {backend!r} (use 'dense' or 'packed')")
    gran = as_granularity(scale_granularity, group_size)   # validates the spelling
    if not gran.is_per_tensor and backend != "packed":
        raise ValueError(
            "scale_granularity selects the Φ̂ scale layout of the packed "
            "streaming backend; use backend='packed' (for per-band observation "
            "scales quantize y up front: repro_torch.sensing.quantize_observations)")
    if is_linear_operator(phi):
        if bits_phi:
            raise ValueError(
                "bits_phi only applies to dense Φ arrays; a matrix-free operator "
                "owns its representation")
        if backend != "dense":
            raise ValueError("backend='packed' packs a dense Φ array")
    if backend == "packed":
        if not bits_phi:
            raise ValueError("backend='packed' needs bits_phi (it streams packed codes)")
        if requantize != "fixed":
            raise ValueError(
                "backend='packed' is the requantize='fixed' deployment mode; "
                "use backend='dense' for requantize='pair'")
    if threshold == "hsthresh" and not real_signal:
        raise ValueError("threshold='hsthresh' is the real-signal streaming H_s")


def _quantize_rows(Y: torch.Tensor, bits_y: int, ky: torch.Tensor) -> torch.Tensor:
    """One draw ŷ per problem, every row with the same key ``ky`` (and its own
    scale), so that batch row b reproduces the single-problem run."""
    return torch.stack([fake_quantize(Y[b], bits_y, ky) for b in range(Y.shape[0])])


def _x_dtype(phi, real_signal: bool) -> torch.dtype:
    return torch.float32 if (real_signal or not phi.dtype.is_complex) else phi.dtype


def _solver_setup(phi, Y, s, bits_phi, bits_y, key, requantize, backend, threshold,
                  c, shrink_k, max_backtracks, real_signal, nonneg, with_trace,
                  scale_granularity="per_tensor", group_size=None, row_local=False):
    """Returns ``(X0, iteration)``; ``iteration(X, i)`` is Algorithm 1's step
    at global iteration i, returning X_new and the trace row (rq, rt, mu,
    changed, n_bt). Everything stochastic derives from ``key`` and the step
    takes the global index, so any split of the iterations into segments
    computes the same bits. ``row_local`` sums and applies the trace's Φ one
    row at a time (the freeze rule's grouping contract)."""
    key = key if key is not None else prng.PRNGKey(0)
    ky, kphi = prng.split(key)
    Yhat = _quantize_rows(Y, bits_y, ky) if bits_y else Y
    X0 = torch.zeros((Y.shape[0], phi.shape[1]), dtype=_x_dtype(phi, real_signal),
                     device=Y.device)
    hs = _make_hs(threshold, s)
    sqnorm = _rowwise_sqnorm if row_local else _rows_sqnorm
    phi_true, get_ops = make_iteration_operators(
        phi, bits_phi, requantize, backend, kphi,
        granularity=as_granularity(scale_granularity, group_size))
    if row_local:
        phi_true = _row_local(phi_true)
    # the skipped residuals' markers, one transfer per setup
    nan_row = None if with_trace else _nan_rows(Y.shape[0], Y.device)

    def iteration(X, i):
        op1, op2 = get_ops(i)
        if row_local:
            op1, op2 = _row_local(op1), _row_local(op2)
        X_new, mu, changed, n_bt = _niht_iteration_batch(
            X, Yhat, op1, op2, s, c, shrink_k, max_backtracks, real_signal, nonneg, hs,
            sqnorm)
        if with_trace:
            rq = torch.sqrt(sqnorm(Yhat - op2.mv(X_new)))
            rt = torch.sqrt(sqnorm(Y - phi_true.mv(X_new)))
        else:
            # skip the two residual products (one of them streams dense Φ)
            rq = rt = nan_row
        return X_new, (rq, rt, mu, changed, n_bt)

    return X0, iteration


def _first_trace_row(B: int, device) -> IHTTrace:
    """What a row re-emits before its first iteration: NaN residuals, µ 0."""
    return IHTTrace(resid_q=_nan_rows(B, device), resid_true=_nan_rows(B, device),
                    mu=torch.zeros((B,), device=device),
                    support_changed=torch.zeros((B,), dtype=torch.bool, device=device),
                    backtracks=torch.zeros((B,), dtype=torch.int32, device=device))


def _advance(iteration, k, k_end, X, done, streak, last, early_exit, exit_tol):
    """Iterations k .. k_end−1, fewer once every row is done (``early_exit``).

    Lossless (``exit_tol == 0``): a done row recomputes its fixed point
    unmasked, so the rows match ``early_exit=False`` bit for bit. Freeze
    (``exit_tol > 0``): a done row keeps its x and re-emits ``last``; a row
    is done after ``_EXIT_PATIENCE`` consecutive ‖x⁺−x‖² ≤ exit_tol²·‖x⁺‖²
    (one tiny step can be a backtracking artefact, not a stall). Returns
    (k_stop, X, done, streak, last, rows), ``rows`` the trace rows of
    iterations k .. k_stop−1."""
    rows = []
    while k < k_end and not (early_exit and bool(done.all())):
        X_c, outs = iteration(X, k)
        if exit_tol > 0.0:
            X_c = torch.where(done[:, None], X, X_c)
            outs = tuple(torch.where(done, p, o) for p, o in zip(last, outs))
        if early_exit:
            if exit_tol == 0.0:
                newly = (X_c == X).all(dim=-1)
            else:
                small = (_rowwise_sqnorm(X_c - X)
                         <= (exit_tol * exit_tol) * _rowwise_sqnorm(X_c))
                streak = torch.where(small, streak + 1, torch.zeros_like(streak))
                newly = streak >= _EXIT_PATIENCE
            done = done | newly
        X, last = X_c, IHTTrace(*outs)
        rows.append(outs)
        k += 1
    return k, X, done, streak, last, rows


def _stack_rows(rows, B: int, device) -> IHTTrace:
    if rows:
        return IHTTrace(*(torch.stack(col) for col in zip(*rows)))
    return IHTTrace(*(torch.zeros((0, B), dtype=t.dtype, device=device)
                      for t in _first_trace_row(B, device)))


def _fill_tail(trace: IHTTrace, last: IHTTrace, n_rows: int) -> IHTTrace:
    """The trace with ``n_rows`` copies of the stationary row ``last`` appended."""
    if n_rows <= 0:
        return trace
    return IHTTrace(*(torch.cat([t, o[None].expand(n_rows, *o.shape)])
                      for t, o in zip(trace, last)))


def _qniht_core(phi, Y, s, n_iters, bits_phi, bits_y, key, requantize, backend,
                threshold, c, shrink_k, max_backtracks, real_signal, nonneg, with_trace,
                scale_granularity="per_tensor", group_size=None, early_exit=False,
                exit_tol=0.0):
    """Batched implementation behind qniht / qniht_batch (Y is (B, M))."""
    B = Y.shape[0]
    X, iteration = _solver_setup(phi, Y, s, bits_phi, bits_y, key, requantize, backend,
                                 threshold, c, shrink_k, max_backtracks, real_signal,
                                 nonneg, with_trace, scale_granularity, group_size,
                                 row_local=exit_tol > 0.0)
    done = streak = last = None           # the early exit's state, made only when used
    if early_exit:
        done = torch.zeros((B,), dtype=torch.bool, device=Y.device)
        streak = torch.zeros((B,), dtype=torch.int32, device=Y.device)
        last = _first_trace_row(B, Y.device)
    k_stop, X, _, _, last, rows = _advance(iteration, 0, n_iters, X, done, streak, last,
                                           early_exit, exit_tol)
    trace = _fill_tail(_stack_rows(rows, B, Y.device), last, n_iters - k_stop)
    return IHTResult(x=X, trace=trace)


class SolverState(NamedTuple):
    """The solver's whole state at an iteration boundary: the checkpoint unit.

    * ``k``      — () int32, the next iteration index.
    * ``X``      — (B, N) iterate (the support is ``|X| > 0``).
    * ``done``   — (B,) bool, rows the early exit has finished.
    * ``streak`` — (B,) int32, consecutive sub-``exit_tol`` updates.
    * ``last``   — the last emitted trace row, what frozen rows re-emit and
      the tail is filled with.
    * ``trace``  — (n_iters, B) buffers, written for iterations < ``k``.
    * ``Y``      — (B, M) raw observations; ŷ and Φ̂ are recomputed from
      (``Y``, ``key``) in every segment rather than stored.
    * ``key``    — the run's PRNG key (a CPU tensor, as every key of the port).

    Every tensor but ``key`` lies on the solve's device.
    """

    k: torch.Tensor
    X: torch.Tensor
    done: torch.Tensor
    streak: torch.Tensor
    last: IHTTrace
    trace: IHTTrace
    Y: torch.Tensor
    key: torch.Tensor


def solver_init(phi, Y: torch.Tensor, s: int, n_iters: int = 50, *,
                bits_phi: Optional[int] = None, bits_y: Optional[int] = None,
                key: Optional[torch.Tensor] = None, requantize: str = "pair",
                backend: str = "dense", threshold: str = "topk", c: float = 0.01,
                shrink_k: float = 2.0, max_backtracks: int = 30,
                real_signal: bool = False, nonneg: bool = False, with_trace: bool = True,
                scale_granularity: str = "per_tensor", group_size: Optional[int] = None,
                early_exit: bool = False, exit_tol: float = 0.0) -> SolverState:
    """Fresh :class:`SolverState` for ``qniht_batch(phi, Y, s, n_iters, ...)``
    run in segments; the same validation and defaults as :func:`qniht_batch`
    (``unroll`` excepted)."""
    if Y.ndim != 2:
        raise ValueError("solver_init expects Y of shape (B, M); wrap one y as y[None]")
    _validate(phi, bits_phi, bits_y, key, requantize, backend, threshold, real_signal,
              scale_granularity, group_size, early_exit, exit_tol)
    B, dev = Y.shape[0], Y.device
    last = _first_trace_row(B, dev)
    return SolverState(
        k=torch.zeros((), dtype=torch.int32, device=dev),
        X=torch.zeros((B, phi.shape[1]), dtype=_x_dtype(phi, real_signal), device=dev),
        done=torch.zeros((B,), dtype=torch.bool, device=dev),
        streak=torch.zeros((B,), dtype=torch.int32, device=dev),
        last=last,
        trace=IHTTrace(*(torch.zeros((n_iters, B), dtype=t.dtype, device=dev)
                         for t in last)),
        Y=Y,
        key=key if key is not None else prng.PRNGKey(0),
    )


# one source of truth for the solver-config defaults of the segmented entry
# points (solver_segment's keyword defaults and the resilient runner)
_SEG_DEFAULTS = dict(
    bits_phi=None, bits_y=None, requantize="pair", backend="dense",
    threshold="topk", c=0.01, shrink_k=2.0, max_backtracks=30,
    real_signal=False, nonneg=False, with_trace=True,
    scale_granularity="per_tensor", group_size=None, early_exit=False,
    exit_tol=0.0,
)


def solver_segment(phi, state: SolverState, n_steps: int, *, s: int,
                   bits_phi: Optional[int] = None, bits_y: Optional[int] = None,
                   requantize: str = "pair", backend: str = "dense",
                   threshold: str = "topk", c: float = 0.01, shrink_k: float = 2.0,
                   max_backtracks: int = 30, real_signal: bool = False,
                   nonneg: bool = False, with_trace: bool = True,
                   scale_granularity: str = "per_tensor", group_size: Optional[int] = None,
                   early_exit: bool = False, exit_tol: float = 0.0) -> SolverState:
    """Advance ``state`` by ``n_steps`` iterations (fewer only at the horizon).

    Contract: for any split of ``[0, n_iters)`` into segments,
    ``solver_result`` of the final state is bit for bit ``qniht_batch(phi, Y,
    ...)`` with the same arguments, which must be passed alike to every call.
    Once every row is done (``early_exit``) the rest of the segment's trace
    rows are filled with the stationary row, so ``k`` always lands on
    ``min(k + n_steps, n_iters)``. The input state is left as it was."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    _validate(phi, bits_phi, bits_y, state.key, requantize, backend, threshold,
              real_signal, scale_granularity, group_size, early_exit, exit_tol)
    n_iters = state.trace.mu.shape[0]
    _, iteration = _solver_setup(phi, state.Y, s, bits_phi, bits_y, state.key, requantize,
                                 backend, threshold, c, shrink_k, max_backtracks,
                                 real_signal, nonneg, with_trace, scale_granularity,
                                 group_size, row_local=exit_tol > 0.0)
    k0 = int(state.k)
    k_end = min(k0 + n_steps, n_iters)
    k_stop, X, done, streak, last, rows = _advance(
        iteration, k0, k_end, state.X, state.done, state.streak, state.last, early_exit,
        exit_tol)
    trace = IHTTrace(*(t.clone() for t in state.trace))
    if rows:
        for buf, col in zip(trace, zip(*rows)):
            buf[k0:k_stop] = torch.stack(col)
    for buf, o in zip(trace, last):
        buf[k_stop:k_end] = o
    return SolverState(k=torch.full_like(state.k, k_end), X=X, done=done, streak=streak,
                       last=last, trace=trace, Y=state.Y, key=state.key)


def solver_result(state: SolverState) -> IHTResult:
    """The :class:`IHTResult` of a state; trace rows at iterations ≥ ``k`` (a
    run finished before the horizon) hold the stationary last row."""
    k = int(state.k)
    trace = _fill_tail(IHTTrace(*(t[:k] for t in state.trace)), state.last,
                       state.trace.mu.shape[0] - k)
    return IHTResult(x=state.X, trace=trace)


def qniht(phi, y: torch.Tensor, s: int, n_iters: int = 50, *,
          bits_phi: Optional[int] = None, bits_y: Optional[int] = None,
          key: Optional[torch.Tensor] = None, requantize: str = "pair",
          backend: str = "dense", threshold: str = "topk", c: float = 0.01,
          shrink_k: float = 2.0, max_backtracks: int = 30, real_signal: bool = False,
          nonneg: bool = False, with_trace: bool = True,
          scale_granularity: str = "per_tensor", group_size: Optional[int] = None,
          early_exit: bool = False, exit_tol: float = 0.0, unroll: int = 1) -> IHTResult:
    """Low-precision NIHT (Algorithm 1) on one problem; ``y`` is (M,).

    Arguments as ``repro.core.niht.qniht``. ``phi`` is a dense (M, N) tensor
    (real or complex) or an operator with ``mv``/``rmv``; ``key`` a
    :mod:`repro_torch.random` key. ``unroll`` is accepted and has no effect.
    The solve runs on ``y``'s device."""
    if y.ndim != 1:
        raise ValueError(f"qniht expects y of shape (M,), got ndim={y.ndim}; "
                         "use qniht_batch for a (B, M) stack of observations")
    _validate(phi, bits_phi, bits_y, key, requantize, backend, threshold, real_signal,
              scale_granularity, group_size, early_exit, exit_tol, unroll)
    res = _qniht_core(phi, y[None, :], s, n_iters, bits_phi, bits_y, key, requantize,
                      backend, threshold, c, shrink_k, max_backtracks, real_signal,
                      nonneg, with_trace, scale_granularity, group_size, early_exit,
                      exit_tol)
    return IHTResult(x=res.x[0], trace=IHTTrace(*(t[:, 0] for t in res.trace)))


def qniht_batch(phi, Y: torch.Tensor, s: int, n_iters: int = 50, *,
                bits_phi: Optional[int] = None, bits_y: Optional[int] = None,
                key: Optional[torch.Tensor] = None, requantize: str = "pair",
                backend: str = "dense", threshold: str = "topk", c: float = 0.01,
                shrink_k: float = 2.0, max_backtracks: int = 30,
                real_signal: bool = False, nonneg: bool = False, with_trace: bool = True,
                scale_granularity: str = "per_tensor", group_size: Optional[int] = None,
                early_exit: bool = False, exit_tol: float = 0.0,
                unroll: int = 1) -> IHTResult:
    """Recover B observation vectors of one Φ at once; ``Y`` is (B, M).

    Every operator application is one (B, ·) product or kernel call, so the
    packed Φ̂ streams once per application for all B rows. Row b computes
    what ``qniht(phi, Y[b], ...)`` computes, up to f32 accumulation order;
    with ``exit_tol > 0``, bit for bit."""
    if Y.ndim != 2:
        raise ValueError("qniht_batch expects Y of shape (B, M)")
    _validate(phi, bits_phi, bits_y, key, requantize, backend, threshold, real_signal,
              scale_granularity, group_size, early_exit, exit_tol, unroll)
    return _qniht_core(phi, Y, s, n_iters, bits_phi, bits_y, key, requantize, backend,
                       threshold, c, shrink_k, max_backtracks, real_signal, nonneg,
                       with_trace, scale_granularity, group_size, early_exit, exit_tol)


def qniht_batch_sharded(phi, Y: torch.Tensor, s: int, n_iters: int = 50, *, mesh=None,
                        n_devices: Optional[int] = None, bits_phi: Optional[int] = None,
                        bits_y: Optional[int] = None, key: Optional[torch.Tensor] = None,
                        requantize: str = "pair", backend: str = "dense",
                        threshold: str = "topk", c: float = 0.01, shrink_k: float = 2.0,
                        max_backtracks: int = 30, real_signal: bool = False,
                        nonneg: bool = False, with_trace: bool = True,
                        scale_granularity: str = "per_tensor",
                        group_size: Optional[int] = None, early_exit: bool = True,
                        exit_tol: float = 0.0, unroll: int = 1) -> IHTResult:
    """:func:`qniht_batch` with the B axis split over a mesh of ranks: the
    multi-device serving mode.

    Every rank of the mesh calls it with the same global ``Y`` and gets the
    global result. ``mesh`` is a
    :class:`~repro_torch.parallel.dist.BatchMesh` (default:
    :func:`~repro_torch.parallel.batch.make_batch_mesh` of ``n_devices``,
    inside a process group the first ``n_devices`` of its ranks, all by
    default). Each rank pads ``Y`` to a multiple of the width, solves its own
    contiguous block of rows on its own device with Φ̂ (or the matrix-free
    operator) and the key of its own, with no collective inside an
    iteration, and the ranks ``all_gather`` x and the trace and strip the
    padding (an all-zero row converges at the first iteration, so padding
    never delays a rank).

    Contract: row b is ``qniht_batch(phi, Y, ...)``'s row b bit for bit,
    trace included, at every width: the same draws, and each row meets the
    shapes of the one-device solve (see :mod:`repro_torch.parallel.batch`).
    ``early_exit`` defaults to True here: a rank whose rows have all
    converged stops instead of riding along with the slowest row of the
    whole batch.

    Called with ``n_devices`` > 1 outside a process group it raises a
    ``ValueError``: the ranks come from
    :func:`~repro_torch.parallel.dist.spawn_ranks`, or from the CLIs'
    ``--devices``. All other arguments as :func:`qniht_batch`."""
    if Y.ndim != 2:
        raise ValueError("qniht_batch_sharded expects Y of shape (B, M)")
    _validate(phi, bits_phi, bits_y, key, requantize, backend, threshold, real_signal,
              scale_granularity, group_size, early_exit, exit_tol, unroll)
    from repro_torch.parallel.batch import sharded_qniht_run

    return sharded_qniht_run(
        phi, Y, key, mesh=mesh, n_devices=n_devices, s=s, n_iters=n_iters,
        bits_phi=bits_phi, bits_y=bits_y, requantize=requantize, backend=backend,
        threshold=threshold, c=c, shrink_k=shrink_k, max_backtracks=max_backtracks,
        real_signal=real_signal, nonneg=nonneg, with_trace=with_trace,
        scale_granularity=scale_granularity, group_size=group_size, early_exit=early_exit,
        exit_tol=exit_tol)


def niht(phi, y, s, n_iters=50, **kw) -> IHTResult:
    """Full-precision NIHT (the paper's baseline)."""
    return qniht(phi, y, s, n_iters, bits_phi=None, bits_y=None, **kw)


def stopping_iterations(xs_norm: float, eps_s: float) -> int:
    """The paper's natural stopping criterion n* = ⌈log₂(‖xˢ‖ / ε_s)⌉."""
    if eps_s <= 0 or xs_norm <= 0:
        return 1
    return max(1, math.ceil(math.log2(xs_norm / eps_s)))
