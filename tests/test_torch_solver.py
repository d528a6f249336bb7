"""The rest of the port's solver against the JAX reference: early exit (the
lossless fixed-point exit and the freeze rule), ``unroll``, segments
(``SolverState``, ``solver_init``/``solver_segment``/``solver_result``) and
their validation.

Tolerances: against the reference, x within 1e-3·‖x‖ with the same support,
and the residual traces (‖ŷ − Φ̂x‖, ‖y − Φx‖) within rtol 1e-3 / atol 1e-5:
the two sides differ only in f32 summation order. The step size µ is not
compared: once x sits at the least-squares point of its support, g_Γ and so
µ = ‖g_Γ‖²/‖Φ̂g_Γ‖² are rounding noise on either side. Within the port the
contracts are exact: lossless exit equals no exit, any segmentation equals
the one-shot run, and the freeze rule gives every row the same bits in any
batch.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from test_torch_niht import gaussian_case


@pytest.fixture(autouse=True, scope="module")
def _leave_no_jax_executables():
    """Drop the JAX executables this module's reference calls compiled: an
    eager primitive cached with jax_debug_nans off would keep later tests in
    the process (tests/test_sanitize.py) from tripping."""
    yield
    jax.clear_caches()


tn = importlib.import_module("repro_torch.core.niht")   # the module: the package exports the function niht
jn = importlib.import_module("repro.core.niht")   # repro.core re-exports niht the function

S, N_ITERS, BATCH = 6, 40, 4


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """The port reproduces jax.random under jax_threefry_partitionable=True
    (JAX 0.9's default): hold the reference to that mode whatever the
    process default is."""
    with jax.threefry_partitionable(True):
        yield


def _j(a):
    return jnp.asarray(a, dtype=a.dtype)


CONFIGS = {
    "packed8": dict(bits_phi=8, bits_y=8, requantize="fixed", backend="packed"),
    "packed2": dict(bits_phi=2, bits_y=8, requantize="fixed", backend="packed"),
    "fake_fixed": dict(bits_phi=4, bits_y=8, requantize="fixed"),
    "full": dict(),
    "hsthresh": dict(bits_phi=8, bits_y=8, requantize="fixed", backend="packed",
                     threshold="hsthresh", real_signal=True),
}


def _case(batch=BATCH, seed=11):
    phi, Y, _ = gaussian_case(64, 128, S, batch, seed=seed)
    jkey = jax.random.PRNGKey(seed)
    return (phi, Y, jkey), (torch.from_numpy(phi), torch.from_numpy(Y),
                            convert.key_from_numpy(np.asarray(jkey)))


def assert_close_to_reference(res_t, res_j):
    xj, xt = np.asarray(res_j.x), res_t.x.numpy()
    assert np.linalg.norm(xt - xj) <= 1e-3 * np.linalg.norm(xj)
    np.testing.assert_array_equal(xt != 0, xj != 0)
    for name in ("resid_q", "resid_true"):
        np.testing.assert_allclose(getattr(res_t.trace, name).numpy(),
                                   np.asarray(getattr(res_j.trace, name)),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def assert_same_bits(a, b):
    assert torch.equal(a.x, b.x)
    for name, u, v in zip(a.trace._fields, a.trace, b.trace):
        assert torch.equal(u, v) or (u.is_floating_point() and torch.equal(
            torch.isnan(u), torch.isnan(v)) and torch.equal(u.nan_to_num(), v.nan_to_num())), name


def test_constants_and_defaults_are_the_reference_s():
    assert tn._EXIT_PATIENCE == jn._EXIT_PATIENCE
    assert tn._SEG_DEFAULTS == jn._SEG_DEFAULTS
    assert tn.SolverState._fields == jn.SolverState._fields


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_lossless_exit_matches_reference(name):
    (phi, Y, jkey), (phi_t, Y_t, tkey) = _case()
    kw = CONFIGS[name]
    res_j = jn.qniht_batch(_j(phi), _j(Y), S, N_ITERS, key=jkey,
                           early_exit=True, **kw)
    res_t = tn.qniht_batch(phi_t, Y_t, S, N_ITERS, key=tkey, early_exit=True, **kw)
    assert_close_to_reference(res_t, res_j)


@pytest.mark.parametrize("batch", [1, BATCH])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_lossless_exit_is_the_full_run_bit_for_bit(name, batch):
    _, (phi_t, Y_t, tkey) = _case(batch)
    kw = CONFIGS[name]
    full = tn.qniht_batch(phi_t, Y_t, S, N_ITERS, key=tkey, **kw)
    early = tn.qniht_batch(phi_t, Y_t, S, N_ITERS, key=tkey, early_exit=True, **kw)
    assert_same_bits(early, full)


@pytest.mark.parametrize("seed,batch,name", [(11, 1, "packed8"), (11, 4, "packed2"),
                                              (5, 4, "fake_fixed")])
def test_lossless_exit_stops_early(monkeypatch, seed, batch, name):
    """The loop stops once every row sits at its fixed point (on these
    instances well before 200 iterations), and the tail re-emits the
    stationary row."""
    _, (phi_t, Y_t, tkey) = _case(batch, seed)
    calls = []
    setup = tn._solver_setup

    def counting(*a, **k):
        x0, it = setup(*a, **k)
        return x0, lambda X, i: (calls.append(i), it(X, i))[1]

    monkeypatch.setattr(tn, "_solver_setup", counting)
    res = tn.qniht_batch(phi_t, Y_t, S, 200, key=tkey, early_exit=True, **CONFIGS[name])
    assert 0 < len(calls) < 100
    assert torch.equal(res.trace.mu[-1], res.trace.mu[len(calls) - 1])
    monkeypatch.setattr(tn, "_solver_setup", setup)
    assert_same_bits(res, tn.qniht_batch(phi_t, Y_t, S, 200, key=tkey, **CONFIGS[name]))


@pytest.mark.parametrize("exit_tol", [1e-3, 2e-2])
@pytest.mark.parametrize("name", ["packed8", "fake_fixed", "full"])
def test_freeze_rule_matches_reference(name, exit_tol):
    (phi, Y, jkey), (phi_t, Y_t, tkey) = _case()
    kw = CONFIGS[name]
    res_j = jn.qniht_batch(_j(phi), _j(Y), S, N_ITERS, key=jkey,
                           early_exit=True, exit_tol=exit_tol, **kw)
    res_t = tn.qniht_batch(phi_t, Y_t, S, N_ITERS, key=tkey, early_exit=True,
                           exit_tol=exit_tol, **kw)
    assert_close_to_reference(res_t, res_j)


@pytest.mark.parametrize("groups", [(1, 1, 1, 1), (2, 2), (3, 1)])
@pytest.mark.parametrize("name", ["packed8", "fake_fixed", "full"])
def test_freeze_rule_is_row_local(name, groups):
    """exit_tol > 0 gives every row the same bits whatever batch it is in."""
    _, (phi_t, Y_t, tkey) = _case()
    kw = dict(CONFIGS[name], early_exit=True, exit_tol=2e-2)
    whole = tn.qniht_batch(phi_t, Y_t, S, N_ITERS, key=tkey, **kw)
    start = 0
    for g in groups:
        part = tn.qniht_batch(phi_t, Y_t[start:start + g], S, N_ITERS, key=tkey, **kw)
        assert torch.equal(part.x, whole.x[start:start + g])
        for u, v in zip(part.trace, whole.trace):
            assert torch.equal(u, v[:, start:start + g])
        start += g


class _BlockRecorder:
    """A row-local operator of at most ``independent_rows`` rows that records
    the batch of every call."""

    def __init__(self, rows):
        self.independent_rows, self.calls = rows, []
        self.w = torch.arange(1.0, 6.0)

    def mv(self, x):
        self.calls.append(x.shape[0])
        return x * self.w

    def rmv(self, r):
        self.calls.append(r.shape[0])
        return r / self.w


@pytest.mark.parametrize("rows,batch,calls", [
    (4, 3, [3]), (4, 4, [4]), (4, 10, [4, 4, 2]), (16, 40, [16, 16, 8]),
    (None, 3, [1, 1, 1]),
])
def test_row_local_applies_blocks_of_independent_rows(rows, batch, calls):
    """The freeze rule applies an operator in blocks of its independent_rows
    (one row at a time when it does not say), and the blocks put together
    give the whole batch's result."""
    op = _BlockRecorder(rows)
    if rows is None:
        del op.independent_rows
    x = torch.randn(batch, 5, generator=torch.Generator().manual_seed(batch))
    local = tn._row_local(op)
    assert torch.equal(local.mv(x), x * op.w)
    assert torch.equal(local.rmv(x), x / op.w)
    assert op.calls == calls + calls


@pytest.mark.parametrize("granularity", ["per_tensor", "per_channel"])
def test_packed_operator_is_row_local_only_on_the_card(granularity):
    """On the CPU the packed operator's plain version is a torch.matmul: no
    row is promised its own bits, so the freeze rule goes one row at a time."""
    from repro_torch import random as prng
    from repro_torch.core.operators import PackedStreamingOperator

    phi = torch.randn(16, 32, generator=torch.Generator().manual_seed(3))
    op = PackedStreamingOperator.pack(phi, 8, prng.PRNGKey(0), granularity=granularity)
    assert op.independent_rows == 1


def test_freeze_rule_freezes_rows():
    """A frozen row stops updating and re-emits its last trace row; a loose
    tolerance freezes every row well before the horizon."""
    _, (phi_t, Y_t, tkey) = _case()
    res = tn.qniht_batch(phi_t, Y_t, S, N_ITERS, key=tkey, early_exit=True, exit_tol=0.5,
                         **CONFIGS["packed8"])
    stationary = (res.trace.mu[1:] == res.trace.mu[:-1]).all(dim=1)
    assert bool(stationary[N_ITERS // 2:].all())


@pytest.mark.parametrize("unroll", [2, 4])
def test_unroll_has_no_effect(unroll):
    (phi, Y, jkey), (phi_t, Y_t, tkey) = _case()
    kw = CONFIGS["packed8"]
    base = tn.qniht_batch(phi_t, Y_t, S, N_ITERS, key=tkey, **kw)
    res = tn.qniht_batch(phi_t, Y_t, S, N_ITERS, key=tkey, unroll=unroll, **kw)
    assert_same_bits(res, base)
    res_j = jn.qniht_batch(_j(phi), _j(Y), S, N_ITERS, key=jkey,
                           unroll=unroll, **kw)
    assert_close_to_reference(res, res_j)


def test_unroll_single_problem_matches_reference():
    (phi, Y, jkey), (phi_t, Y_t, tkey) = _case(1)
    kw = CONFIGS["fake_fixed"]
    res_j = jn.qniht(_j(phi), _j(Y[0]), S, N_ITERS, key=jkey, unroll=3, **kw)
    res_t = tn.qniht(phi_t, Y_t[0], S, N_ITERS, key=tkey, unroll=3, **kw)
    assert_close_to_reference(res_t, res_j)


def _segments(phi_t, Y_t, tkey, splits, n_iters=N_ITERS, **kw):
    st = tn.solver_init(phi_t, Y_t, S, n_iters, key=tkey, **kw)
    for n in splits:
        st = tn.solver_segment(phi_t, st, n, s=S, **kw)
    return st


SPLITS = [(N_ITERS,), (1, N_ITERS - 1), (7, 13, 20), (10, 10, 10, 10), (3,) * 14]


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("exit", ["none", "lossless", "freeze"])
def test_any_segmentation_is_the_one_shot_run(splits, exit):
    _, (phi_t, Y_t, tkey) = _case()
    kw = dict(CONFIGS["packed8"],
              **{"none": {}, "lossless": dict(early_exit=True),
                 "freeze": dict(early_exit=True, exit_tol=2e-2)}[exit])
    one = tn.qniht_batch(phi_t, Y_t, S, N_ITERS, key=tkey, **kw)
    st = _segments(phi_t, Y_t, tkey, splits, **kw)
    assert int(st.k) == N_ITERS
    assert_same_bits(tn.solver_result(st), one)


@pytest.mark.parametrize("name", ["packed8", "fake_fixed", "hsthresh"])
def test_segments_match_reference(name):
    (phi, Y, jkey), (phi_t, Y_t, tkey) = _case()
    kw = CONFIGS[name]
    st_j = jn.solver_init(_j(phi), _j(Y), S, N_ITERS, key=jkey, **kw)
    for n in (7, 13, 20):
        st_j = jn.solver_segment(_j(phi), st_j, n, s=S, **kw)
    st_t = _segments(phi_t, Y_t, tkey, (7, 13, 20), **kw)
    assert_close_to_reference(tn.solver_result(st_t), jn.solver_result(st_j))
    np.testing.assert_array_equal(st_t.done.numpy(), np.asarray(st_j.done))


@pytest.mark.parametrize("early_exit", [False, True])
def test_partial_state_result_matches_reference(early_exit):
    """A state finished before the horizon: trace rows ≥ k hold the last row."""
    (phi, Y, jkey), (phi_t, Y_t, tkey) = _case()
    kw = dict(CONFIGS["packed8"], early_exit=early_exit)
    st_j = jn.solver_segment(_j(phi), jn.solver_init(
        _j(phi), _j(Y), S, N_ITERS, key=jkey, **kw), 9, s=S, **kw)
    st_t = _segments(phi_t, Y_t, tkey, (9,), **kw)
    assert int(st_t.k) == int(st_j.k) == 9
    res_t = tn.solver_result(st_t)
    assert_close_to_reference(res_t, jn.solver_result(st_j))
    assert torch.equal(res_t.trace.mu[9:], st_t.last.mu[None].expand(N_ITERS - 9, -1))


def test_solver_init_matches_reference():
    (phi, Y, jkey), (phi_t, Y_t, tkey) = _case()
    st_j = jn.solver_init(_j(phi), _j(Y), S, N_ITERS, key=jkey)
    st_t = tn.solver_init(phi_t, Y_t, S, N_ITERS, key=tkey)
    for name, a, b in zip(st_t._fields, st_t, st_j):
        if name in ("last", "trace"):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u.numpy(), np.asarray(v))
                assert u.numpy().dtype == np.asarray(v).dtype
        elif name == "key":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert a.numpy().dtype == np.asarray(b).dtype, name


def test_segment_leaves_its_input_state_alone():
    _, (phi_t, Y_t, tkey) = _case()
    kw = CONFIGS["packed8"]
    st0 = _segments(phi_t, Y_t, tkey, (5,), **kw)
    saved = [t.clone() for t in (st0.X, *st0.trace)]
    tn.solver_segment(phi_t, st0, 5, s=S, **kw)
    assert all(torch.equal(a, b) for a, b in zip(saved, (st0.X, *st0.trace)))


def test_segment_stops_at_the_horizon():
    _, (phi_t, Y_t, tkey) = _case()
    st = _segments(phi_t, Y_t, tkey, (35, 30), **CONFIGS["packed8"])
    assert int(st.k) == N_ITERS


@pytest.mark.parametrize("kw", [
    dict(early_exit=True, bits_phi=4, bits_y=8, requantize="pair"),
    dict(exit_tol=1e-3),
    dict(exit_tol=-1.0, early_exit=True),
    dict(unroll=2, early_exit=True),
    dict(unroll=0),
])
def test_invalid_options_raise_as_in_the_reference(kw):
    (phi, Y, jkey), (phi_t, Y_t, tkey) = _case(1)
    with pytest.raises(ValueError):
        jn.qniht(_j(phi), _j(Y[0]), S, 3, key=jkey, **kw)
    with pytest.raises(ValueError):
        tn.qniht(phi_t, Y_t[0], S, 3, key=tkey, **kw)


@pytest.mark.parametrize("kw", [
    dict(early_exit=True, bits_phi=4, bits_y=8, requantize="pair"),
    dict(exit_tol=1e-3),
])
def test_segment_validation(kw):
    _, (phi_t, Y_t, tkey) = _case(1)
    with pytest.raises(ValueError):
        tn.solver_init(phi_t, Y_t, S, 5, key=tkey, **kw)
    st = tn.solver_init(phi_t, Y_t, S, 5, key=tkey)
    with pytest.raises(ValueError):
        tn.solver_segment(phi_t, st, 2, s=S, key=tkey, **kw) if "key" in kw else \
            tn.solver_segment(phi_t, st, 2, s=S, **kw)
    with pytest.raises(ValueError):
        tn.solver_segment(phi_t, st, 0, s=S)
    with pytest.raises(ValueError):
        tn.solver_init(phi_t, Y_t[0], S, 5)


def test_rowwise_sqnorm_is_the_batched_sum():
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.standard_normal((3, 1001)).astype(np.float32))
    torch.testing.assert_close(tn._rowwise_sqnorm(v), tn._rows_sqnorm(v), rtol=1e-6, atol=0)
    c = torch.complex(v, v.flip(0))
    torch.testing.assert_close(tn._rowwise_sqnorm(c), tn._rows_sqnorm(c), rtol=1e-6, atol=0)
