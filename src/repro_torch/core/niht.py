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
  contraction (``"per_block"``, ``group_size=g``; the group kernel);
* H_s is the exact top s (``threshold="topk"``) or, for a real signal, the
  streaming histogram-select-mask of paper §8 (``threshold="hsthresh"``),
  one launch of the ``hist`` and ``mask`` kernels per proposal for the
  whole batch.

PyTorch idiom in place of JAX's: the batch axis is written out, the iteration
loop is a Python loop and the per-row backtracking a Python loop on
``active.any()``. Every stochastic draw derives from ``key`` exactly as in the
reference (ŷ from ``split(key)[0]``, Φ̂ from ``fold_in(split(key)[1], 0)``),
so both packages quantize identically.

Not yet ported: ``early_exit``, ``exit_tol``, ``unroll``, the segmented
``SolverState`` path and sharding; :func:`_validate` rejects them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

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


def _rows_sqnorm(v: torch.Tensor) -> torch.Tensor:
    """Squared l2 norm along the last axis (per problem)."""
    return (v * v.conj()).real.sum(dim=-1) if v.is_complex() else (v * v).sum(dim=-1)


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
                          real_signal, nonneg, hs):
    """One NIHT step on a batch of problems sharing Φ̂.

    ``op1`` is Φ̂_{2n-1} (gradient, step size, acceptance), ``op2`` is Φ̂_{2n}
    (residual). Each operator application serves the whole batch; support
    logic and backtracking are per row. Returns (X_new, mu, changed, n_bt).
    """
    eps = 1e-30
    R = Yhat - op2.mv(X)
    G = op1.rmv(R)

    # Γ: support of x, or (x = 0, the first iteration) the top s of the gradient
    on_init = _rows_sqnorm(X) == 0.0
    gamma = torch.where(on_init[:, None], top_s_mask(G, s), X.abs() > 0)

    Gg = torch.where(gamma, G, torch.zeros_like(G))
    mu0 = _rows_sqnorm(Gg) / (_rows_sqnorm(op1.mv(Gg)) + eps)

    def propose(mu):
        A = X.to(G.dtype) + mu[:, None] * G
        return hs(_project(A, real_signal, nonneg).to(X.dtype))

    def accept(mu, Xp):
        same = ((Xp.abs() > 0) == gamma).all(dim=-1)
        D = Xp - X
        omega = _rows_sqnorm(D) / (_rows_sqnorm(op1.mv(D)) + eps)
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


def _validate(phi, bits_phi, bits_y, key, requantize, backend, threshold, real_signal,
              scale_granularity="per_tensor", group_size=None, early_exit=False,
              exit_tol=0.0, unroll=1):
    if early_exit or exit_tol or unroll != 1:
        raise NotImplementedError("early_exit, exit_tol and unroll are not yet ported")
    if (bits_phi or bits_y) and key is None:
        raise ValueError("quantized NIHT needs a PRNG key")
    if requantize not in ("pair", "fixed"):
        raise ValueError(f"unknown requantize {requantize!r}")
    if backend not in ("dense", "packed"):
        raise ValueError(f"unknown backend {backend!r} (use 'dense' or 'packed')")
    gran = as_granularity(scale_granularity, group_size)   # validates the spelling
    if not gran.is_per_tensor and backend != "packed":
        raise ValueError(
            "scale_granularity selects the Φ̂ scale layout of the packed "
            "streaming backend; use backend='packed'")
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


def _solver_setup(phi, Y, s, bits_phi, bits_y, key, requantize, backend, threshold,
                  c, shrink_k, max_backtracks, real_signal, nonneg, with_trace,
                  scale_granularity="per_tensor", group_size=None):
    """Returns ``(X0, iteration)``; ``iteration(X, i)`` is Algorithm 1's step
    at iteration i, returning X_new and the trace row (rq, rt, mu, changed, n_bt)."""
    key = key if key is not None else prng.PRNGKey(0)
    ky, kphi = prng.split(key)
    Yhat = _quantize_rows(Y, bits_y, ky) if bits_y else Y
    n = phi.shape[1]
    x_dtype = torch.float32 if (real_signal or not phi.dtype.is_complex) else phi.dtype
    X0 = torch.zeros((Y.shape[0], n), dtype=x_dtype, device=Y.device)
    hs = _make_hs(threshold, s)
    phi_true, get_ops = make_iteration_operators(
        phi, bits_phi, requantize, backend, kphi,
        granularity=as_granularity(scale_granularity, group_size))

    def iteration(X, i):
        op1, op2 = get_ops(i)
        X_new, mu, changed, n_bt = _niht_iteration_batch(
            X, Yhat, op1, op2, s, c, shrink_k, max_backtracks, real_signal, nonneg, hs)
        if with_trace:
            rq = torch.sqrt(_rows_sqnorm(Yhat - op2.mv(X_new)))
            rt = torch.sqrt(_rows_sqnorm(Y - phi_true.mv(X_new)))
        else:
            # skip the two residual products (one of them streams dense Φ)
            rq = rt = torch.full((X.shape[0],), float("nan"), device=X.device)
        return X_new, (rq, rt, mu, changed, n_bt)

    return X0, iteration


def _qniht_core(phi, Y, s, n_iters, bits_phi, bits_y, key, requantize, backend,
                threshold, c, shrink_k, max_backtracks, real_signal, nonneg, with_trace,
                scale_granularity="per_tensor", group_size=None):
    """Batched implementation behind qniht / qniht_batch (Y is (B, M))."""
    X, iteration = _solver_setup(phi, Y, s, bits_phi, bits_y, key, requantize, backend,
                                 threshold, c, shrink_k, max_backtracks, real_signal,
                                 nonneg, with_trace, scale_granularity, group_size)
    rows = []
    for i in range(n_iters):
        X, row = iteration(X, i)
        rows.append(row)
    if rows:
        cols = [torch.stack(col) for col in zip(*rows)]
    else:
        B = Y.shape[0]
        cols = [torch.zeros((0, B), dtype=dt, device=Y.device) for dt in
                (torch.float32, torch.float32, torch.float32, torch.bool, torch.int32)]
    return IHTResult(x=X, trace=IHTTrace(*cols))


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
    :mod:`repro_torch.random` key. The solve runs on ``y``'s device."""
    if y.ndim != 1:
        raise ValueError(f"qniht expects y of shape (M,), got ndim={y.ndim}; "
                         "use qniht_batch for a (B, M) stack of observations")
    _validate(phi, bits_phi, bits_y, key, requantize, backend, threshold, real_signal,
              scale_granularity, group_size, early_exit, exit_tol, unroll)
    res = _qniht_core(phi, y[None, :], s, n_iters, bits_phi, bits_y, key, requantize,
                      backend, threshold, c, shrink_k, max_backtracks, real_signal,
                      nonneg, with_trace, scale_granularity, group_size)
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
    what ``qniht(phi, Y[b], ...)`` computes, up to f32 accumulation order."""
    if Y.ndim != 2:
        raise ValueError("qniht_batch expects Y of shape (B, M)")
    _validate(phi, bits_phi, bits_y, key, requantize, backend, threshold, real_signal,
              scale_granularity, group_size, early_exit, exit_tol, unroll)
    return _qniht_core(phi, Y, s, n_iters, bits_phi, bits_y, key, requantize, backend,
                       threshold, c, shrink_k, max_backtracks, real_signal, nonneg,
                       with_trace, scale_granularity, group_size)


def niht(phi, y, s, n_iters=50, **kw) -> IHTResult:
    """Full-precision NIHT (the paper's baseline)."""
    return qniht(phi, y, s, n_iters, bits_phi=None, bits_y=None, **kw)
