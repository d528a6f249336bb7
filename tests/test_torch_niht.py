"""The port's solver against the JAX reference, on identical inputs.

Problems are made with numpy from a seed and handed to both packages; the
port's key is the reference's key, converted, so both draw the same ŷ and Φ̂.
Tolerance (the reference's own packed-vs-dense contract,
tests/test_operators.py): ‖Δx‖ ≤ 1e-3·‖x_jax‖, identical supports, and
resid_q within rtol 1e-3 / atol 1e-5. The two sides differ only in f32
summation order (XLA dots against torch products).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.niht import qniht as jax_qniht, qniht_batch as jax_qniht_batch
from repro_torch import convert
from repro_torch.core.niht import qniht, qniht_batch
from repro_torch.core.recovery import relative_error


@pytest.fixture(autouse=True, scope="module")
def _leave_no_jax_executables():
    """Drop the JAX executables this module's reference calls compiled: an
    eager primitive cached with jax_debug_nans off would keep later tests in
    the process (tests/test_sanitize.py) from tripping."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """The port reproduces jax.random under jax_threefry_partitionable=True
    (JAX 0.9's default): hold the reference to that mode whatever the
    process default is."""
    with jax.threefry_partitionable(True):
        yield


def _j(a):
    return jnp.asarray(a, dtype=a.dtype)


def gaussian_case(m, n, s, batch, seed):
    rng = np.random.default_rng(seed)
    phi = rng.standard_normal((m, n)).astype(np.float32)
    X = np.zeros((batch, n), np.float32)
    for b in range(batch):
        X[b, rng.choice(n, s, replace=False)] = rng.standard_normal(s)
    Y = X @ phi.T
    Y += 0.05 * np.sqrt(np.mean(Y**2)) * rng.standard_normal(Y.shape)
    return phi, Y.astype(np.float32), X


def assert_solve_close(res_t, res_j):
    xj, xt = np.asarray(res_j.x), res_t.x.numpy()
    ref = np.linalg.norm(xj)
    assert np.linalg.norm(xt - xj) <= 1e-3 * ref
    np.testing.assert_array_equal(xt != 0, xj != 0)
    np.testing.assert_allclose(res_t.trace.resid_q.numpy(), np.asarray(res_j.trace.resid_q),
                               rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("bits", [2, 8])
@pytest.mark.parametrize("backend", ["packed", "dense"])
def test_gaussian_solve_matches_reference(backend, bits, batch):
    """gaussian-smoke shape (64×128, s=6): packed and fake-fixed QNIHT."""
    phi, Y, X = gaussian_case(64, 128, 6, batch, seed=100 + bits)
    jkey = jax.random.PRNGKey(10 + bits)
    kw = dict(bits_phi=bits, bits_y=8, requantize="fixed", backend=backend)
    phi_t, Y_t = torch.from_numpy(phi), torch.from_numpy(Y)
    tkey = convert.key_from_numpy(np.asarray(jkey))
    if batch == 1:
        res_j = jax_qniht(_j(phi), _j(Y[0]), 6, 25, key=jkey, **kw)
        res_t = qniht(phi_t, Y_t[0], 6, 25, key=tkey, **kw)
    else:
        res_j = jax_qniht_batch(_j(phi), _j(Y), 6, 25, key=jkey, **kw)
        res_t = qniht_batch(phi_t, Y_t, 6, 25, key=tkey, **kw)
    assert_solve_close(res_t, res_j)
    if bits == 8:   # 8-bit Φ̂ recovers: the solve is not trivially zero
        err = relative_error(res_t.x.reshape(batch, -1)[0], torch.from_numpy(X[0]))
        assert float(err) < 0.15


def test_complex_packed_solve_matches_reference():
    """A complex 48×96 Φ with a real signal, as tests/test_operators.py."""
    rng = np.random.default_rng(13)
    m, n = 48, 96
    phi = np.asarray(rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n)),
                     dtype=np.complex64)
    x = np.zeros(n, np.float32)
    x[:4] = [1.0, 0.8, -0.5, 0.3]
    y = phi @ x
    jkey = jax.random.PRNGKey(13)
    kw = dict(bits_phi=8, bits_y=8, requantize="fixed", real_signal=True, nonneg=False)
    for backend in ("packed", "dense"):
        res_j = jax_qniht(_j(phi), _j(y), 4, 25, key=jkey,
                          backend=backend, **kw)
        res_t = qniht(torch.from_numpy(phi), torch.from_numpy(y), 4, 25,
                      key=convert.key_from_numpy(np.asarray(jkey)), backend=backend, **kw)
        assert_solve_close(res_t, res_j)


def test_batch_rows_match_single_solves():
    """Row b of qniht_batch is qniht on Y[b] with the same key (port only)."""
    phi, Y, _ = gaussian_case(64, 128, 6, 3, seed=7)
    kw = dict(bits_phi=4, bits_y=8, requantize="fixed", backend="packed",
              key=convert.key_from_numpy(np.asarray(jax.random.PRNGKey(3))))
    phi_t, Y_t = torch.from_numpy(phi), torch.from_numpy(Y)
    res_b = qniht_batch(phi_t, Y_t, 6, 20, **kw)
    assert res_b.x.shape == (3, 128) and res_b.trace.mu.shape == (20, 3)
    for b in range(3):
        res_s = qniht(phi_t, Y_t[b], 6, 20, **kw)
        ref = float(torch.linalg.vector_norm(res_s.x))
        assert float(torch.linalg.vector_norm(res_b.x[b] - res_s.x)) <= 1e-3 * ref


def test_packed_matches_fake_fixed_within_port():
    """backend='packed' streams the codes the fake-fixed path carries as f32."""
    phi, Y, _ = gaussian_case(64, 128, 6, 2, seed=11)
    kw = dict(bits_phi=2, bits_y=8, requantize="fixed",
              key=convert.key_from_numpy(np.asarray(jax.random.PRNGKey(5))))
    phi_t, Y_t = torch.from_numpy(phi), torch.from_numpy(Y)
    r_p = qniht_batch(phi_t, Y_t, 6, 25, backend="packed", **kw)
    r_d = qniht_batch(phi_t, Y_t, 6, 25, backend="dense", **kw)
    ref = float(torch.linalg.vector_norm(r_d.x))
    assert float(torch.linalg.vector_norm(r_p.x - r_d.x)) <= 1e-3 * ref
    torch.testing.assert_close(r_p.trace.resid_q, r_d.trace.resid_q, rtol=1e-3, atol=1e-5)


def test_pair_mode_matches_reference():
    """requantize='pair' redraws Φ̂ each iteration from fold_in(kphi, 2i[+1])."""
    phi, Y, _ = gaussian_case(32, 64, 3, 1, seed=21)
    jkey = jax.random.PRNGKey(21)
    kw = dict(bits_phi=8, bits_y=8, requantize="pair")
    res_j = jax_qniht(_j(phi), _j(Y[0]), 3, 10, key=jkey, **kw)
    res_t = qniht(torch.from_numpy(phi), torch.from_numpy(Y[0]), 3, 10,
                  key=convert.key_from_numpy(np.asarray(jkey)), **kw)
    assert_solve_close(res_t, res_j)


def test_without_trace_fills_nan():
    phi, Y, _ = gaussian_case(32, 64, 3, 1, seed=2)
    res = qniht(torch.from_numpy(phi), torch.from_numpy(Y[0]), 3, 5, with_trace=False)
    assert torch.isnan(res.trace.resid_q).all() and torch.isnan(res.trace.resid_true).all()
    assert res.trace.mu.shape == (5,)


@pytest.mark.parametrize("kw", [dict(threshold="hsthresh", real_signal=True),
                                dict(scale_granularity="per_channel", backend="packed",
                                     bits_phi=8, requantize="fixed")])
def test_hsthresh_and_per_channel_match_reference(kw):
    """Options the first slice refused, now ported: the same solve as the
    reference's."""
    phi, Y, _ = gaussian_case(16, 32, 2, 1, seed=3)
    jkey = jax.random.PRNGKey(0)
    res_j = jax_qniht(_j(phi), _j(Y[0]), 2, 3, key=jkey, **kw)
    res_t = qniht(torch.from_numpy(phi), torch.from_numpy(Y[0]), 2, 3,
                  key=convert.key_from_numpy(np.asarray(jkey)), **kw)
    assert_solve_close(res_t, res_j)


@pytest.mark.parametrize("kw", [dict(early_exit=True), dict(unroll=2)])
def test_early_exit_and_unroll_match_reference(kw):
    """Options the earlier slices refused, now ported (tests/test_torch_solver.py
    holds them in depth): the same solve as the reference's."""
    phi, Y, _ = gaussian_case(16, 32, 2, 1, seed=3)
    jkey = jax.random.PRNGKey(0)
    res_j = jax_qniht(_j(phi), _j(Y[0]), 2, 3, key=jkey, **kw)
    res_t = qniht(torch.from_numpy(phi), torch.from_numpy(Y[0]), 2, 3,
                  key=convert.key_from_numpy(np.asarray(jkey)), **kw)
    assert_solve_close(res_t, res_j)


@pytest.mark.parametrize("kw", [dict(backend="packed"),
                                dict(backend="packed", bits_phi=4, requantize="pair"),
                                dict(bits_phi=4)])
def test_invalid_combinations_raise(kw):
    phi, Y, _ = gaussian_case(16, 32, 2, 1, seed=4)
    with pytest.raises(ValueError):
        qniht(torch.from_numpy(phi), torch.from_numpy(Y[0]), 2, 3, **kw)
