"""Serving-workload configs (copy of ``repro.configs.serve_batch``).

Models the heavy-traffic scenario the ROADMAP's north star describes: a
stream of fixed-shape observation chunks (instrument-rate data from many
users/stations) recovered against ONE measurement operator by
:class:`repro_torch.parallel.batch.BatchServer`.

The workload is deliberately *heterogeneous*: real streams are. Each chunk
carries a leading burst of ``hard_fraction`` hard rows — geometrically
decaying (near-compressible) coefficients at lower SNR, the kind of item
whose support NIHT resolves slowly — followed by clean flat s-sparse rows.
``n_iters`` is the serving horizon, sized for the hard rows; the per-row
freeze rule (``exit_tol``) is what keeps that horizon cheap for everyone
else: in one fused batch every easy row rides along for the hardest row's
iterations.
"""
import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    name: str
    m: int = 512
    n: int = 1024
    s: int = 64
    chunk: int = 64              # rows per incoming (B, M) chunk
    n_chunks: int = 4            # chunks per measured stream
    n_iters: int = 96            # the serving horizon: sized for the hard rows
    snr_easy_db: float = 30.0
    snr_hard_db: float = 15.0
    hard_decay: float = 0.85     # hard rows: amplitudes decay^j (compressible)
    hard_fraction: float = 1.0 / 8.0    # leading burst of hard rows per chunk
    exit_tol: float = 1e-5       # per-row freeze tolerance (0 → exact rule)
    bits_phi: Optional[int] = None      # None → f32 operator; set for packed
    bits_y: Optional[int] = None
    backend: str = "dense"              # "dense" | "packed"
    seed: int = 0
    # run under repro_torch.analysis.sanitize (NaN/Inf tripwires and the
    # kernel-build counter), with the real residual trace (with_trace=True)
    sanitize: bool = False

    @property
    def n_hard(self) -> int:
        """Hard rows at the head of each chunk (at least 1 when fraction > 0)."""
        if self.hard_fraction <= 0:
            return 0
        return max(1, int(round(self.chunk * self.hard_fraction)))


@dataclasses.dataclass(frozen=True)
class ContinuousServeConfig:
    """Bursty single-request arrival workload for the continuous-batching
    scheduler (:mod:`repro_torch.parallel.scheduler`).

    Where :class:`ServeConfig` streams pre-cut ``(B, M)`` chunks, this models
    the request-level reality underneath: individual observations arriving on
    a Poisson clock with periodic bursts, a mix of hard (slow-converging
    compressible, low SNR) and easy rows, and ``priority_classes`` priority
    levels assigned round-robin (class 0 most urgent). The hard/easy mix is
    what makes horizons *heterogeneous* — easy requests freeze after a few
    segments while hard ones run the full ``n_iters`` — which is exactly the
    regime where mid-flight refill beats lockstep chunking.

    ``deadline_slack`` (per priority class, optional): class ``p`` requests
    get ``deadline = arrival_tick + deadline_slack * (p + 1)``; ``None``
    disables deadlines (the benchmark workload, so continuous and lockstep
    answer the identical request set and quality comparisons are apples to
    apples — deadline shedding is exercised by the property tests).
    """

    name: str
    m: int = 512
    n: int = 1024
    s: int = 64
    n_requests: int = 64         # total arrivals in the trace
    slots: int = 8               # rows of the live SolverState
    seg_len: int = 8             # iterations per segment (refill granularity)
    n_iters: int = 96            # horizon, sized for the hard requests
    queue_depth: int = 64
    age_every: int = 8           # aging window (anti-starvation); 0 disables
    arrival_rate: float = 1.5    # mean Poisson arrivals per tick
    burst_every: int = 12        # every k-th tick also lands a burst ...
    burst_size: int = 6          # ... of this many extra requests
    priority_classes: int = 3
    deadline_slack: Optional[int] = None
    # per-request horizon (iteration budget): easy requests carry this,
    # hard ones the full n_iters — the heterogeneous-horizon regime where
    # mid-flight refill pays (None → every request gets n_iters). Keep both
    # multiples of seg_len so the horizon clamp never shortens a segment.
    n_iters_easy: Optional[int] = 24
    snr_easy_db: float = 30.0
    snr_hard_db: float = 15.0
    hard_decay: float = 0.85
    hard_fraction: float = 1.0 / 8.0
    exit_tol: float = 1e-5
    bits_phi: Optional[int] = None
    bits_y: Optional[int] = None
    backend: str = "dense"
    seed: int = 0
    sanitize: bool = False


CONFIG = ServeConfig(name="serve-gaussian")

# Packed-operator serving: Φ̂ packed once at server construction, every chunk
# streams the same int4 codes (bits_y=8 observation quantization per chunk).
PACKED = ServeConfig(name="serve-gaussian-packed", bits_phi=4, bits_y=8,
                     backend="packed")

SMOKE = ServeConfig(name="serve-gaussian-smoke", m=64, n=128, s=8, chunk=8,
                    n_chunks=2, n_iters=40)

# Fault-injection harness stream: small chunks but enough of them that a
# kill -TERM reliably lands mid-stream (the kill/resume tests kill after the
# first chunk's progress line and the restarted run must drain the journaled
# prefix and replay the rest bit-identically).
# sanitize=True: resumed runs are NaN-checked too (a restart that drains a
# torn or garbage journal entry should trip the sanitizer, not serve it).
FAULT = ServeConfig(name="serve-gaussian-fault", m=48, n=96, s=5, chunk=8,
                    n_chunks=5, n_iters=30, sanitize=True)

# Same stream through the packed-operator server (the restart must rebuild
# the identical packed codes from the construction key).
FAULT_PACKED = ServeConfig(name="serve-gaussian-fault-packed", m=48, n=96, s=5,
                           chunk=8, n_chunks=5, n_iters=30, bits_phi=4,
                           bits_y=8, backend="packed", sanitize=True)

# Continuous-batching benchmark workload: 64 heterogeneous requests against
# an 8-slot table. seg_len | n_iters keeps the horizon clamp from ever
# shortening a segment, so every segment has one length.
# exit_tol=0 (the exact bitwise-fixed-point rule) on purpose: the 1e-5 freeze
# would stop the hard rows almost as early as the easy ones, hiding the
# heterogeneous-horizon regime this benchmark exists to measure; arrival_rate
# 2/tick keeps a queue backlog so throughput is service-limited, not
# arrival-limited.
CONTINUOUS = ContinuousServeConfig(name="serve-continuous", exit_tol=0.0,
                                   arrival_rate=2.0)

CONTINUOUS_PACKED = ContinuousServeConfig(name="serve-continuous-packed",
                                          exit_tol=0.0, arrival_rate=2.0,
                                          bits_phi=4, bits_y=8,
                                          backend="packed")

# CI-sized: small enough for the sched smoke, still heterogeneous enough
# that continuous visibly out-admits lockstep.
CONTINUOUS_SMOKE = ContinuousServeConfig(name="serve-continuous-smoke", m=64,
                                         n=128, s=8, n_requests=20, slots=4,
                                         seg_len=8, n_iters=40,
                                         n_iters_easy=16, arrival_rate=1.0,
                                         burst_every=6, burst_size=3)
