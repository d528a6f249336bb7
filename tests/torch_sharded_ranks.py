"""The rank side of ``tests/test_torch_sharded.py``: the instances and the
work each gloo rank does. A module of its own, importable by the spawned
rank processes, which import neither JAX nor pytest.

Instances are the reference's sharded test matrix (``tests/test_sharded_batch.py``):
B = 10 Gaussian rows of a 48 × 96 Φ, s = 5, 25 iterations (padding in play at
widths 3 and 4), 6 MRI rows of a 16 × 16 phantom (s = 24, 12 iterations) in
the pixel basis (Fourier) and in Haar wavelets; and the scheduler's
(``tests/test_scheduler.py``): a 16 × 32 Φ, 8 requests, 8 slots.
"""
import os
import shutil

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.core.niht import qniht_batch, qniht_batch_sharded
from repro_torch.launch.resilience import Preempted, recover_resilient
from repro_torch.parallel import BatchServer, ContinuousScheduler, Request, make_batch_mesh
from repro_torch.parallel.dist import barrier
from repro_torch.sensing.gaussian import make_gaussian_problem
from repro_torch.sensing.mri import make_mri_problem

B, M, N, S, N_ITERS = 10, 48, 96, 5, 25
WIDTHS = (2, 3, 4)
PACKED = dict(bits_phi=4, bits_y=8, requantize="fixed", backend="packed", with_trace=False)
# name -> (problem, s, n_iters, solver keywords); the key is added per call
CASES = {
    "dense": ("gaussian", S, N_ITERS, {}),
    "packed_per_tensor": ("gaussian", S, N_ITERS, PACKED),
    "packed_per_block": ("gaussian", S, N_ITERS,
                         {**PACKED, "scale_granularity": "per_block", "group_size": 8}),
    "fourier": ("pixel", 24, 12, dict(real_signal=True, nonneg=True, bits_y=8,
                                      with_trace=False)),
    "wavelet": ("haar", 24, 12, dict(real_signal=True, nonneg=False, bits_y=8,
                                     with_trace=False)),
    "freeze": ("gaussian", S, N_ITERS, dict(exit_tol=1e-5, with_trace=False)),
}
SCHED_M, SCHED_N, SCHED_S, SCHED_ITERS = 16, 32, 3, 12
RESUME_EVERY = 5


def key():
    return prng.PRNGKey(0)


def gaussian():
    """(Φ, Y): the B rows share Φ, row b's signal and noise from fold_in(key, b + 1)."""
    k = key()
    base = make_gaussian_problem(M, N, S, 20.0, k, device="cpu")
    Y = torch.stack([make_gaussian_problem(M, N, S, 20.0, prng.fold_in(k, b + 1),
                                           phi=base.phi, device="cpu").y for b in range(B)])
    return base.phi, Y


def mri(basis):
    """(operator, Y): six scalings of one 16 × 16 phantom's k-space samples."""
    prob = make_mri_problem(16, 24, 0.5, key(), snr_db=None, sparsity_basis=basis,
                            device="cpu")
    return prob.op, torch.stack([prob.y * (1.0 + 0.1 * t) for t in range(6)])


def problem(name):
    return gaussian() if name == "gaussian" else mri(name)


def solve(name, mesh=None):
    """Case ``name`` solved on one device (``mesh`` None: ``qniht_batch``
    with early exit where the sharded default has it) or over ``mesh``."""
    which, s, n_iters, kw = CASES[name]
    phi, Y = problem(which)
    if mesh is None:
        return qniht_batch(phi, Y, s, n_iters, key=key(), early_exit=True, **kw)
    return qniht_batch_sharded(phi, Y, s, n_iters, mesh=mesh, key=key(), **kw)


def scheduler_arrivals():
    """(Φ, arrivals) of the reference's 4-device scheduler test."""
    rng = np.random.default_rng(42)
    phi = (rng.standard_normal((SCHED_M, SCHED_N)) / np.sqrt(SCHED_M)).astype(np.float32)

    def mk_y():
        x = np.zeros(SCHED_N, np.float32)
        x[rng.choice(SCHED_N, SCHED_S, replace=False)] = rng.standard_normal(SCHED_S)
        return (phi @ x).astype(np.float32)

    arrivals = [(i // 2, Request(rid=i, y=mk_y(), priority=i % 2, n_iters=[4, 8, 12][i % 3]))
                for i in range(8)]
    return torch.from_numpy(phi), arrivals


def scheduler(mesh=None, journal_dir=None, resume=False):
    phi, arrivals = scheduler_arrivals()
    sch = ContinuousScheduler(phi, SCHED_S, SCHED_ITERS, slots=8, seg_len=4,
                              key=prng.PRNGKey(7), mesh=mesh,
                              n_devices=None if mesh is not None else 1,
                              journal_dir=journal_dir, resume=resume)
    return sch, arrivals


def schedule(mesh=None):
    """{rid: x} of the scheduler over the arrivals, and {rid: reference_solve}."""
    sch, arrivals = scheduler(mesh)
    reports = sch.run(arrivals)
    refs = {req.rid: sch.reference_solve(req.y, req.n_iters).numpy() for _, req in arrivals}
    return {rid: np.asarray(r.x) for rid, r in reports.items()}, refs


def schedule_stopped(mesh, journal_dir, trip):
    """The scheduler on ``mesh``, journaled, stopped when ``trip`` says so:
    (the tick it stopped at, {rid: x} of the requests it finished)."""
    sch, arrivals = scheduler(mesh, journal_dir)
    reports = sch.run(arrivals, stop=lambda: trip.requested)
    return sch.preempted_at, {rid: np.asarray(r.x) for rid, r in reports.items()
                              if r.status == "done"}


def serve_chunks(mesh=None, backend="dense"):
    """Two chunks (Y and Y/2) through a BatchServer: their x."""
    phi, Y = gaussian()
    kw = dict(bits_phi=4, bits_y=8, backend="packed") if backend == "packed" else {}
    srv = BatchServer(phi, S, N_ITERS, key=key(), mesh=mesh,
                      n_devices=None if mesh is not None else 1, **kw)
    return [r.x for r in srv.serve([Y, Y * 0.5])], srv.n_shards


def resilient(directory, mesh=None, guard=None, resume=False):
    phi, Y = gaussian()
    return recover_resilient(phi, Y, S, N_ITERS, checkpoint_dir=directory,
                             ckpt_every=RESUME_EVERY, resume=resume, mesh=mesh, guard=guard,
                             key=key(), **PACKED)


class TripOnce:
    """A stand-in for a preemption guard that reports a request at its
    ``after``-th poll (a SIGTERM that reached one rank only)."""

    def __init__(self, after):
        self.polls, self.after = 0, after

    @property
    def requested(self):
        self.polls += 1
        return self.polls == self.after


def run_matrix(mesh, tmp):
    """Every rank's share of the module's checks; returns a dict of numpy
    results (the same on every rank of a mesh)."""
    out = {}
    for width in WIDTHS:
        sub = make_batch_mesh(width, "cpu")
        if not sub.member:
            continue
        for name in CASES:
            res = solve(name, sub)
            out[("solve", name, width)] = (res.x.numpy(), [t.numpy() for t in res.trace])
    for width in (2, 4):
        sub = make_batch_mesh(width, "cpu")
        if sub.member:
            for backend in ("dense", "packed"):
                xs, shards = serve_chunks(sub, backend)
                out[("serve", backend, width)] = ([x.numpy() for x in xs], shards)
    out["schedule"] = schedule(mesh)
    # a stop that reached rank 2 alone, before the third segment: every rank
    # stops at the same tick, and rank 0's journal resumes on one device
    out["schedule_stopped"] = schedule_stopped(
        mesh, os.path.join(tmp, "schedule"), TripOnce(3) if mesh.rank == 2 else TripOnce(0))
    # elastic resume: a SIGTERM that reaches rank 1 alone stops every rank
    # after the first segment of a width-4 run; the checkpoint then resumes
    # at width 2 (here) and on one device (in the test)
    killed = os.path.join(tmp, "killed")
    try:
        resilient(killed, mesh, TripOnce(1) if mesh.rank == 1 else TripOnce(0))
    except Preempted as e:
        out["preempted_at"] = e.k
    barrier(mesh)
    if mesh.rank == 0:
        shutil.copytree(killed, os.path.join(tmp, "resume_2"))
        shutil.copytree(killed, os.path.join(tmp, "resume_1"))
    barrier(mesh)
    sub = make_batch_mesh(2, "cpu")
    if sub.member:
        res = resilient(os.path.join(tmp, "resume_2"), sub, resume=True)
        out["resumed_2"] = (res.x.numpy(), [t.numpy() for t in res.trace])
    return out


def raise_on_rank_1(mesh):
    """Rank 1 raises; rank 0 waits in a collective that rank 1 never joins."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 failed on purpose")
    barrier(mesh)
    return mesh.rank


# -- the card: ranks sharing one GPU over gloo ------------------------------------------------

CARD_BATCH = 6
CARD_CASES = {
    # LOFAR CS302 SMOKE, 2-bit Φ̂ on QMM, per_tensor and per_block (g = 64 on QMM_GROUP),
    # and the fused H_s
    "lofar_per_tensor": dict(backend="packed", requantize="fixed", bits_phi=2, bits_y=8),
    "lofar_per_block": dict(backend="packed", requantize="fixed", bits_phi=2, bits_y=8,
                            scale_granularity="per_block", group_size=64),
    "lofar_hsthresh": dict(backend="packed", requantize="fixed", bits_phi=2, bits_y=8,
                           threshold="hsthresh"),
    # the dense complex Φ through cuBLAS, and the freeze rule's row blocks
    "lofar_dense": {},
    "lofar_freeze": dict(backend="packed", requantize="fixed", bits_phi=2, bits_y=8,
                         exit_tol=1e-4),
}


def card_solve(name, mesh=None, device=None):
    """Case ``name`` on the card: LOFAR CS302 SMOKE, a batch of CARD_BATCH
    skies, on one device (``mesh`` None) or over ``mesh``. Returns x and the
    trace on the host."""
    from repro_torch.configs import CONFIGS
    from repro_torch.launch.recover import lofar_instance

    cs = CONFIGS["lofar-smoke"]
    dev = mesh.device if mesh is not None else device
    phi, Y, _ = lofar_instance(cs, 0, CARD_BATCH, dev)
    kw = dict(CARD_CASES[name], key=prng.PRNGKey(0), real_signal=True, nonneg=True)
    if mesh is None:
        res = qniht_batch(phi, Y, cs.n_sources, cs.n_iters, early_exit=True, **kw)
    else:
        res = qniht_batch_sharded(phi, Y, cs.n_sources, cs.n_iters, mesh=mesh, **kw)
    return res.x.cpu(), [t.cpu() for t in res.trace]


def card_cases(mesh):
    return {name: card_solve(name, mesh) for name in CARD_CASES}
