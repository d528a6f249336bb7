"""The port's continuous-batching scheduler and state splices
(``repro_torch.parallel.scheduler``, ``parallel.batch``) against the JAX
reference, and its own bit-identity contract.

Against the reference, on the same numpy Φ, y and key:

* ``AdmissionQueue`` decisions identical on the reference's own sequences
  and on fuzzed ones;
* ``pad_state``, ``strip_state`` and ``refill_rows`` on one numpy state:
  every leaf bit for bit;
* ``ContinuousScheduler`` answers within ‖Δx‖ ≤ 1e-3·‖x‖ per request, and
  the same decision log (the two sides differ only in f32 summation order).

Within the port, bitwise: every request's answer is its ``reference_solve``
(``qniht_batch`` over ``[y, 0, ..., 0]`` at the slot width), whatever the
arrival order, co-tenants, slots, segment length or policy; a splice leaves
every other row (trace columns included) as it was, through the splice and
through the next segment, and leaves its input state alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.niht import SolverState as JState, IHTTrace as JTrace
from repro.parallel import (
    AdmissionQueue as JQueue,
    ContinuousScheduler as JScheduler,
    Request as JRequest,
    pad_state as jpad_state,
    refill_rows as jrefill_rows,
    strip_state as jstrip_state,
)
from repro_torch import convert
from repro_torch.core.niht import IHTTrace, SolverState, solver_init, solver_segment
from repro_torch.parallel import (
    AdmissionQueue,
    ChunkJournal,
    ContinuousScheduler,
    Request,
    make_batch_mesh,
    pad_state,
    refill_rows,
    segment_step,
    strip_state,
)


@pytest.fixture(autouse=True, scope="module")
def _leave_no_jax_executables():
    """Drop the JAX executables this module's reference calls compiled: an
    eager primitive cached with jax_debug_nans off would keep later tests in
    the process (tests/test_sanitize.py) from tripping."""
    yield
    jax.clear_caches()


M, N, S, N_ITERS = 16, 32, 3, 12
JKEY = jax.random.PRNGKey(7)
KEY = convert.key_from_numpy(np.asarray(JKEY))
PHI_NP = (np.random.default_rng(42).standard_normal((M, N)) / np.sqrt(M)).astype(np.float32)
PHI = torch.from_numpy(PHI_NP)


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    with jax.threefry_partitionable(True):
        yield


def _j(a):
    a = np.asarray(a)
    return jnp.asarray(a, dtype=a.dtype)


def _mk_y(rng):
    x = np.zeros(N, np.float32)
    x[rng.choice(N, S, replace=False)] = rng.standard_normal(S).astype(np.float32)
    return PHI_NP @ x


def _fuzz_trace(rng, n_req, budgets=(4, 8, 12)):
    """Bursty arrivals (repeated ticks), fuzzed priorities and budgets."""
    ticks = np.cumsum(rng.integers(0, 3, n_req))
    return [(int(ticks[i]), Request(rid=i, y=_mk_y(rng), priority=int(rng.integers(0, 3)),
                                    n_iters=int(rng.choice(budgets))))
            for i in range(n_req)]


def _as_jax_trace(arrivals):
    return [(t, JRequest(rid=r.rid, y=np.asarray(r.y), priority=r.priority,
                         deadline=r.deadline, n_iters=r.n_iters)) for t, r in arrivals]


# the early_exit-compatible configurations: full precision (the lossless
# rule), the freeze rule, fake-quantized 8-bit fixed, packed 4-bit
CONFIGS = {
    "f32": dict(),
    "f32-freeze": dict(exit_tol=1e-4),
    "fakequant8": dict(bits_phi=8, bits_y=8, requantize="fixed"),
    "packed4": dict(bits_phi=4, bits_y=8, requantize="fixed", backend="packed"),
}


def _scheduler(**kw):
    kw.setdefault("key", KEY)
    return ContinuousScheduler(PHI, S, N_ITERS, **kw)


# --- the bit-identity contract within the port -------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("seed", range(4))
def test_fuzzed_arrivals_are_their_reference_solves(seed, name):
    """Whatever the arrival order, co-tenants, slot count, segment length or
    refill timing, each answer is bitwise its standalone solve."""
    rng = np.random.default_rng(1000 * list(CONFIGS).index(name) + seed)
    slots, seg_len = int(rng.integers(2, 5)), int(rng.choice([2, 4]))
    arrivals = _fuzz_trace(rng, 5)
    sch = _scheduler(slots=slots, seg_len=seg_len, queue_depth=32, **CONFIGS[name])
    reports = sch.run(arrivals)
    for _, req in arrivals:
        rep = reports[req.rid]
        assert rep.status == "done"
        assert rep.iters_used is not None and rep.iters_used <= req.n_iters
        assert rep.latency_s is not None and rep.latency_s >= 0
        np.testing.assert_array_equal(rep.x, sch.reference_solve(req.y, req.n_iters).numpy())


def test_lockstep_gives_the_continuous_answers():
    arrivals = _fuzz_trace(np.random.default_rng(5), 6)
    outs = {p: _scheduler(slots=3, seg_len=4, policy=p).run(arrivals)
            for p in ("continuous", "lockstep")}
    for _, req in arrivals:
        np.testing.assert_array_equal(outs["continuous"][req.rid].x,
                                      outs["lockstep"][req.rid].x)


def test_decisions_deterministic_given_trace():
    arrivals = _fuzz_trace(np.random.default_rng(6), 6)
    runs = []
    for _ in range(2):
        sch = _scheduler(slots=2, seg_len=4, queue_depth=3, age_every=2)
        runs.append((sch.log, sch.run(arrivals)))
    assert runs[0][0] == runs[1][0]
    for rid, rep in runs[0][1].items():
        assert rep.status == runs[1][1][rid].status
        if rep.x is not None:
            np.testing.assert_array_equal(rep.x, runs[1][1][rid].x)


def test_tensor_requests_are_numpy_requests():
    """A request's y may be a tensor; the answer is the same."""
    rng = np.random.default_rng(13)
    arrivals = _fuzz_trace(rng, 4)
    as_tensors = [(t, Request(rid=r.rid, y=torch.from_numpy(r.y), priority=r.priority,
                              n_iters=r.n_iters)) for t, r in arrivals]
    a = _scheduler(slots=2, seg_len=4).run(arrivals)
    b = _scheduler(slots=2, seg_len=4).run(as_tensors)
    for rid in a:
        np.testing.assert_array_equal(a[rid].x, b[rid].x)


# --- against the reference ------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_scheduler_matches_reference(name):
    """Same trace, Φ and key through both packages: the same decision log and
    statistics, and each answer within 1e-3 of the reference's."""
    rng = np.random.default_rng(21)
    arrivals = _fuzz_trace(rng, 6)
    kw = dict(slots=3, seg_len=4, queue_depth=4, age_every=2, **CONFIGS[name])
    t = _scheduler(**kw)
    tr = t.run(arrivals)
    j = JScheduler(_j(PHI_NP), S, N_ITERS, key=JKEY, **kw)
    jr = j.run(_as_jax_trace(arrivals))
    assert t.log == j.log
    assert t.stats() == j.stats()
    for rid, rep in jr.items():
        xj = np.asarray(rep.x)
        assert np.linalg.norm(tr[rid].x - xj) <= 1e-3 * np.linalg.norm(xj)


QUEUE_SEQUENCES = {
    # the reference's own AdmissionQueue sequences (tests/test_scheduler.py)
    "fifo_within_class": (dict(depth=8), [("offer", 0, 0, 0, None), ("offer", 1, 0, 0, None),
                                          ("offer", 2, 0, 0, None), ("offer", 3, 0, 0, None),
                                          ("pop", 1), ("pop", 1), ("pop", 1), ("pop", 1)]),
    "strict_priority": (dict(depth=8), [("offer", 0, 2, 0, None), ("offer", 1, 0, 0, None),
                                        ("pop", 0)]),
    "aging": (dict(depth=8, age_every=2), [("offer", 0, 2, 0, None), ("offer", 1, 0, 4, None),
                                           ("pop", 6)]),
    "overflow": (dict(depth=1), [("offer", 0, 1, 0, None), ("offer", 1, 1, 0, None),
                                 ("offer", 2, 0, 0, None), ("pop", 0)]),
    "shed_expired": (dict(depth=8), [("offer", 0, 0, 0, 3), ("offer", 1, 0, 0, None),
                                     ("shed", 3), ("shed", 4), ("len",)]),
}


def _drive(queue, request, ops):
    out, seq = [], 0
    for op in ops:
        if op[0] == "offer":
            _, rid, prio, tick, deadline = op
            admitted, shed = queue.offer(request(rid=rid, y=np.zeros(M), priority=prio,
                                                 deadline=deadline), tick=tick, seq=seq)
            seq += 1
            out.append(("offer", admitted, None if shed is None else shed.req.rid))
        elif op[0] == "pop":
            e = queue.pop(op[1])
            out.append(("pop", None if e is None else e.req.rid))
        elif op[0] == "shed":
            out.append(("shed", [e.req.rid for e in queue.shed_expired(op[1])]))
        else:
            out.append(("len", len(queue)))
    return out


def _fuzzed_ops(seed, n=40):
    rng = np.random.default_rng(seed)
    ops, tick = [], 0
    for rid in range(n):
        tick += int(rng.integers(0, 2))
        kind = rng.choice(["offer", "offer", "pop", "shed"])
        if kind == "offer":
            deadline = None if rng.random() < 0.5 else tick + int(rng.integers(0, 4))
            ops.append(("offer", rid, int(rng.integers(0, 3)), tick, deadline))
        else:
            ops.append((str(kind), tick))
    return ops


@pytest.mark.parametrize("name", list(QUEUE_SEQUENCES) + [f"fuzz{s}" for s in range(4)])
def test_admission_queue_decisions_are_the_reference_s(name):
    if name.startswith("fuzz"):
        seed = int(name[4:])
        kw, ops = dict(depth=3, age_every=seed % 3), _fuzzed_ops(seed)
    else:
        kw, ops = QUEUE_SEQUENCES[name]
    assert _drive(AdmissionQueue(**kw), Request, ops) == _drive(JQueue(**kw), JRequest, ops)


# --- splices against the reference ----------------------------------------------------------

def _numpy_state(b=4, n_iters=N_ITERS, seed=0):
    rng = np.random.default_rng(seed)

    def trace(shape):
        return (rng.standard_normal(shape).astype(np.float32),
                rng.standard_normal(shape).astype(np.float32),
                rng.random(shape).astype(np.float32),
                rng.random(shape) < 0.5,
                rng.integers(0, 5, shape).astype(np.int32))

    return dict(k=np.int32(5), X=rng.standard_normal((b, N)).astype(np.float32),
                done=rng.random(b) < 0.5, streak=rng.integers(0, 3, b).astype(np.int32),
                last=trace((b,)), trace=trace((n_iters, b)),
                Y=rng.standard_normal((b, M)).astype(np.float32),
                key=np.asarray(JKEY))


def _port_state(d):
    t = torch.from_numpy
    return SolverState(k=torch.tensor(d["k"]), X=t(d["X"]), done=t(d["done"]),
                       streak=t(d["streak"]), last=IHTTrace(*map(t, d["last"])),
                       trace=IHTTrace(*map(t, d["trace"])), Y=t(d["Y"]),
                       key=convert.key_from_numpy(d["key"]))


def _jax_state(d):
    return JState(k=_j(d["k"]), X=_j(d["X"]), done=_j(d["done"]),
                  streak=_j(d["streak"]), last=JTrace(*map(_j, d["last"])),
                  trace=JTrace(*map(_j, d["trace"])), Y=_j(d["Y"]),
                  key=_j(d["key"]))


def _leaves(state):
    """(name, numpy array) of every leaf of either package's state."""
    out = []
    for name in state._fields:
        v = getattr(state, name)
        if name in ("last", "trace"):
            out += [(f"{name}.{f}", np.asarray(u)) for f, u in zip(v._fields, v)]
        elif name == "key":
            out.append((name, np.asarray(v).astype(np.uint32)))
        else:
            out.append((name, np.asarray(v)))
    return out


def assert_states_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, u), (_, v) in zip(la, lb):
        assert u.dtype == v.dtype and u.shape == v.shape, name
        np.testing.assert_array_equal(u, v, err_msg=name)


@pytest.mark.parametrize("n_shards", [1, 3, 4, 8])
def test_pad_and_strip_state_match_reference(n_shards):
    d = _numpy_state()
    tp, tb = pad_state(_port_state(d), n_shards)
    jp, jb = jpad_state(_jax_state(d), n_shards)
    assert tb == jb == 4
    assert_states_equal(tp, jp)
    assert_states_equal(strip_state(tp, tb), jstrip_state(jp, jb))
    assert_states_equal(strip_state(tp, tb), _port_state(d))


@pytest.mark.parametrize("rows,live", [([2], [True]), ([0, 3], [True, False]),
                                       ([3, 1, 0], [False, True, True]),
                                       ([0, 1, 2, 3], [False] * 4)])
def test_refill_rows_matches_reference(rows, live):
    d = _numpy_state(seed=1)
    Y_rows = np.random.default_rng(2).standard_normal((len(rows), M)).astype(np.float32)
    Y_rows[[i for i, v in enumerate(live) if not v]] = 0.0
    t_in = _port_state(d)
    before = [(n, a.copy()) for n, a in _leaves(t_in)]
    t = refill_rows(t_in, rows, Y_rows, live)
    assert_states_equal(t, jrefill_rows(_jax_state(d), rows, Y_rows, live))
    # the input state keeps every bit (the splice writes into clones)
    for (name, a), (_, b) in zip(before, _leaves(t_in)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    # untouched rows, trace columns included, are the input's
    others = [b for b in range(4) if b not in rows]
    for (name, a), (_, b) in zip(_leaves(t_in), _leaves(t)):
        if name in ("k", "key"):
            np.testing.assert_array_equal(a, b)
        else:
            axis = 1 if name.startswith("trace.") else 0
            np.testing.assert_array_equal(np.take(a, others, axis), np.take(b, others, axis),
                                          err_msg=name)


def _advanced_state():
    rng = np.random.default_rng(9)
    Y = torch.from_numpy(np.stack([_mk_y(rng) for _ in range(4)]))
    state = solver_init(PHI, Y, S, n_iters=N_ITERS, early_exit=True)
    return solver_segment(PHI, state, 4, s=S, early_exit=True)


@pytest.mark.parametrize("name", ["f32", "f32-freeze", "fakequant8"])
def test_untouched_rows_identical_through_next_segment(name):
    """The splice perturbs neither the other rows nor their next segment,
    and leaves the state it was given (whose Y the segment shares) alone."""
    kw = {k: v for k, v in CONFIGS[name].items()}
    kw.setdefault("key", KEY)
    rng = np.random.default_rng(9)
    Y = torch.from_numpy(np.stack([_mk_y(rng) for _ in range(4)]))
    seg_kw = {k: v for k, v in kw.items() if k != "key"}
    state = solver_segment(PHI, solver_init(PHI, Y, S, n_iters=N_ITERS, early_exit=True,
                                            **kw), 4, s=S, early_exit=True, **seg_kw)
    y_before = state.Y.clone()
    spliced = refill_rows(state, [2], _mk_y(np.random.default_rng(11))[None], [True])
    assert torch.equal(state.Y, y_before)
    a = solver_segment(PHI, state, 4, s=S, early_exit=True, **seg_kw)
    b = solver_segment(PHI, spliced, 4, s=S, early_exit=True, **seg_kw)
    others = [0, 1, 3]
    for u, v in ((a.X, b.X), (a.done, b.done), (a.streak, b.streak)):
        assert torch.equal(u[others], v[others])
    for u, v in zip(a.trace, b.trace):
        assert torch.equal(u[:, others].nan_to_num(), v[:, others].nan_to_num())


def test_pad_rows_stay_zero_through_a_segment():
    """A pad row (Y = 0, X = 0, done) is a bitwise fixed point: zero after a
    segment under the lossless rule, 8-bit y and packed Φ̂ alike."""
    for kw in ({}, dict(bits_y=8), CONFIGS["packed4"]):
        sch = _scheduler(slots=4, seg_len=4, **kw)
        state = refill_rows(sch._state, [0], _mk_y(np.random.default_rng(3))[None], [True])
        out = segment_step(sch.phi, state, 4, **sch._statics)
        assert torch.equal(out.X[1:], torch.zeros_like(out.X[1:]))
        assert bool(out.done[1:].all()) and not torch.isnan(out.X).any()


def test_refill_validation():
    state = _advanced_state()
    with pytest.raises(ValueError, match="distinct"):
        refill_rows(state, [1, 1], np.zeros((2, M), np.float32), [True, True])
    with pytest.raises(ValueError, match="out of range"):
        refill_rows(state, [7], np.zeros((1, M), np.float32), [True])
    with pytest.raises(ValueError, match="Y_rows shape"):
        refill_rows(state, [0], np.zeros((2, M), np.float32), [True])
    with pytest.raises(ValueError, match="one flag per row"):
        refill_rows(state, [0], np.zeros((1, M), np.float32), [True, False])


# --- scheduling invariants ------------------------------------------------------------------

def test_fifo_within_class_end_to_end():
    rng = np.random.default_rng(0)
    sch = _scheduler(slots=1, seg_len=4)
    sch.run([(0, Request(rid=i, y=_mk_y(rng), n_iters=4)) for i in range(6)])
    assert [rid for _, ev, rid, _ in sch.log if ev == "start"] == [0, 1, 2, 3, 4, 5]


def test_no_starvation_under_aging():
    rng = np.random.default_rng(1)
    victim = Request(rid=99, y=_mk_y(rng), priority=2, n_iters=4)
    flood = [(t, Request(rid=t, y=_mk_y(rng), priority=0, n_iters=4)) for t in range(20)]
    arrivals = sorted([(0, victim)] + flood, key=lambda a: a[0])
    rep = _scheduler(slots=1, seg_len=4, age_every=2, queue_depth=64).run(arrivals)[99]
    assert rep.status == "done" and rep.start_tick <= 2 * 2 + 4
    starved = _scheduler(slots=1, seg_len=4, age_every=0, queue_depth=64).run(arrivals)[99]
    assert starved.start_tick > rep.start_tick


def test_deadlines_and_overflow_are_shed_and_reported():
    rng = np.random.default_rng(2)
    sch = _scheduler(slots=1, seg_len=4)
    reports = sch.run([(0, Request(rid=0, y=_mk_y(rng), n_iters=12)),
                       (0, Request(rid=1, y=_mk_y(rng), deadline=1, n_iters=4))])
    assert reports[1].status == "shed_deadline" and reports[1].x is None
    assert reports[0].status == "done" and sch.stats()["n_shed_deadline"] == 1
    sch = _scheduler(slots=1, seg_len=4, queue_depth=1)
    reports = sch.run([(0, Request(rid=0, y=_mk_y(rng), n_iters=12)),
                       (1, Request(rid=1, y=_mk_y(rng), priority=1, n_iters=4)),
                       (1, Request(rid=2, y=_mk_y(rng), priority=0, n_iters=4))])
    assert reports[1].status == "shed_queue_full" and reports[2].status == "done"


def test_stats_fields():
    sch = _scheduler(slots=2, seg_len=4)
    sch.run(_fuzz_trace(np.random.default_rng(7), 4))
    st = sch.stats()
    assert 0 < st["slot_occupancy"] <= 1
    assert st["segments_run"] >= 1 and st["n_done"] == 4
    assert sum(st["segment_lengths"].values()) == st["segments_run"]
    assert sch.slot_table() == [None, None]


def test_scheduler_validation():
    rng = np.random.default_rng(8)
    with pytest.raises(ValueError, match="policy"):
        _scheduler(policy="roundrobin")
    with pytest.raises(ValueError, match="early_exit"):
        _scheduler(bits_phi=8, bits_y=8, requantize="pair")
    with pytest.raises(ValueError, match="slots"):
        _scheduler(slots=0)
    with pytest.raises(ValueError, match="resume"):
        _scheduler(resume=True)
    with pytest.raises(ValueError, match="n_iters"):
        _scheduler(slots=2).run([(0, Request(rid=0, y=_mk_y(rng), n_iters=99))])
    with pytest.raises(ValueError, match="duplicate"):
        _scheduler(slots=2).run([(0, Request(rid=1, y=_mk_y(rng), n_iters=4)),
                                 (0, Request(rid=1, y=_mk_y(rng), n_iters=4))])
    with pytest.raises(ValueError, match="nondecreasing"):
        _scheduler(slots=2).run([(3, Request(rid=0, y=_mk_y(rng))),
                                 (1, Request(rid=1, y=_mk_y(rng)))])
    with pytest.raises(ValueError, match="y shape"):
        _scheduler(slots=2).run([(0, Request(rid=0, y=np.zeros(M + 1, np.float32)))])


def test_sharding_is_refused():
    """Outside a process group a mesh has one device: more raises, naming
    where ranks come from (tests/test_torch_sharded.py runs them); a mesh
    that is not a BatchMesh is refused."""
    with pytest.raises(ValueError, match="spawn_ranks"):
        make_batch_mesh(2, "cpu")
    with pytest.raises(ValueError, match="spawn_ranks"):
        _scheduler(n_devices=2)
    with pytest.raises(TypeError, match="BatchMesh"):
        _scheduler(mesh=torch.device("cpu"))
    with pytest.raises(TypeError, match="BatchMesh"):
        segment_step(PHI, _advanced_state(), 2, mesh=torch.device("cpu"), s=S)
    assert make_batch_mesh(1, "cpu").device == torch.device("cpu")
    assert _scheduler(n_devices=1).device == torch.device("cpu")


# --- the journal under the request id -------------------------------------------------------

def test_scheduler_journals_and_drains_on_resume(tmp_path):
    arrivals = _fuzz_trace(np.random.default_rng(12), 4)
    first = _scheduler(slots=2, seg_len=4, journal_dir=str(tmp_path)).run(arrivals)
    j = ChunkJournal(str(tmp_path))
    for _, req in arrivals:
        assert j.is_complete(req.rid)
        np.testing.assert_array_equal(j.load_submit(req.rid)[0][0], req.y)
    again = _scheduler(slots=2, seg_len=4, journal_dir=str(tmp_path), resume=True)
    reports = again.run(arrivals)
    assert again.n_drained == 4 and again.segments_run == 0
    for rid, rep in reports.items():
        assert rep.drained and rep.x.tobytes() == first[rid].x.tobytes()


def test_resume_rejects_a_diverged_request(tmp_path):
    arrivals = _fuzz_trace(np.random.default_rng(14), 2)
    _scheduler(slots=2, seg_len=4, journal_dir=str(tmp_path)).run(arrivals)
    t0, r0 = arrivals[0]
    changed = [(t0, Request(rid=r0.rid, y=r0.y + 1.0, n_iters=r0.n_iters))] + arrivals[1:]
    with pytest.raises(ValueError, match="journal mismatch"):
        _scheduler(slots=2, seg_len=4, journal_dir=str(tmp_path), resume=True).run(changed)


def test_jax_scheduler_journal_drains_in_the_port(tmp_path):
    """The reference journals the requests, the port drains them: the same
    bytes."""
    arrivals = _fuzz_trace(np.random.default_rng(15), 4)
    j = JScheduler(_j(PHI_NP), S, N_ITERS, slots=2, seg_len=4, key=JKEY,
                   journal_dir=str(tmp_path)).run(_as_jax_trace(arrivals))
    t = _scheduler(slots=2, seg_len=4, journal_dir=str(tmp_path), resume=True)
    reports = t.run(arrivals)
    assert t.n_drained == 4
    for rid, rep in reports.items():
        assert rep.x.tobytes() == np.asarray(j[rid].x).tobytes()
