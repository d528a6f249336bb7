"""Problem generators of the port against the reference, and one lofar-smoke
packed solve through both packages.

* Station baselines and the sky grid are numpy in both packages: bitwise.
* measurement_matrix: atol 1e-4. Its phase is a K=2 product, which the two
  packages may fuse differently; the solve below hands Φ across as numpy anyway.
* The solve: ‖Δx‖ ≤ 1e-3·‖x_jax‖, identical supports, resid_q rtol 1e-3 /
  atol 1e-5 (the reference's packed-vs-dense contract).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.lofar_cs302 import SMOKE as JAX_LOFAR_SMOKE
from repro.core.niht import qniht as jax_qniht
from repro.sensing.gaussian import make_gaussian_problem as jax_make_gaussian_problem
from repro.sensing.sky import make_sky as jax_make_sky
from repro.sensing.telescope import Station as JaxStation
from repro.sensing.telescope import measurement_matrix as jax_measurement_matrix
from repro.sensing.telescope import sky_grid as jax_sky_grid
from repro.sensing.telescope import visibilities as jax_visibilities
from repro_torch import convert
from repro_torch.configs.lofar_cs302 import SMOKE
from repro_torch.core.niht import qniht
from repro_torch.sensing.gaussian import make_gaussian_problem
from repro_torch.sensing.sky import make_sky
from repro_torch.sensing.telescope import Station, measurement_matrix, sky_grid, visibilities
from torch_threads import one_torch_thread  # noqa: F401 -- autouse: one intra-op thread


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


def test_configs_are_copies():
    assert dataclasses.asdict(SMOKE) == dataclasses.asdict(JAX_LOFAR_SMOKE)


@pytest.mark.parametrize("n_antennas", [4, 30])
@pytest.mark.parametrize("auto", [False, True])
def test_station_baselines_bitwise(n_antennas, auto):
    ours = Station(n_antennas=n_antennas, include_autocorrelations=auto)
    ref = JaxStation(n_antennas=n_antennas, include_autocorrelations=auto)
    np.testing.assert_array_equal(ours.baselines(), ref.baselines())
    assert ours.n_baselines == ref.n_baselines == ours.baselines().shape[0]


def test_sky_grid_bitwise():
    np.testing.assert_array_equal(sky_grid(32, 1.5), jax_sky_grid(32, 1.5))


def test_measurement_matrix_close():
    st = Station(n_antennas=SMOKE.n_antennas, seed=SMOKE.seed)
    ours = measurement_matrix(st, SMOKE.resolution, SMOKE.extent, device="cpu")
    ref = np.asarray(jax_measurement_matrix(JaxStation(n_antennas=SMOKE.n_antennas,
                                                       seed=SMOKE.seed),
                                            SMOKE.resolution, SMOKE.extent))
    assert ours.dtype == torch.complex64 and ours.shape == (870, 1024)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 7])
def test_sky_and_visibilities(seed):
    """The sky from a key is the reference's: positions bit for bit, fluxes
    (uniforms) bit for bit; the noise within 1e-5 relative (``normal``)."""
    jk = jax.random.PRNGKey(seed)
    key = convert.key_from_numpy(np.asarray(jk))
    x = make_sky(32, 8, key, min_sep=4, device="cpu")
    assert x.shape == (1024,) and int((x > 0).sum()) == 8 and float(x.min()) >= 0
    x_ref = np.asarray(jax_make_sky(32, 8, jk, min_sep=4))
    np.testing.assert_array_equal(x.numpy(), x_ref)
    phi = measurement_matrix(Station(n_antennas=4), 32, 1.5, device="cpu")
    y, e = visibilities(phi, x, 0.0, key)
    clean = phi @ x.to(phi.dtype)
    np.testing.assert_allclose(float(torch.vdot(e, e).real), float(torch.vdot(clean, clean).real),
                               rtol=1.0)   # 0 dB: noise power of the signal's order
    assert torch.allclose(y - e, clean)
    _, e_ref = jax_visibilities(_j(phi.numpy()), _j(x_ref), 0.0, jk)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), rtol=1e-5,
                               atol=1e-5 * float(np.abs(np.asarray(e_ref)).max()))


def test_gaussian_problem_shapes_and_sharing():
    """Support bit for bit, Φ, x and y within 1e-5 relative of the
    reference's ``make_gaussian_problem`` for the same key; a shared Φ is
    reused as it is."""
    jk = jax.random.PRNGKey(1)
    key = convert.key_from_numpy(np.asarray(jk))
    p = make_gaussian_problem(16, 32, 3, 20.0, key, device="cpu")
    assert p.phi.shape == (16, 32) and int((p.x_true != 0).sum()) == 3
    ref = jax_make_gaussian_problem(16, 32, 3, 20.0, jk)
    np.testing.assert_array_equal(p.x_true.numpy() != 0, np.asarray(ref.x_true) != 0)
    for ours, theirs in ((p.phi, ref.phi), (p.x_true, ref.x_true), (p.y, ref.y)):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(theirs).max()))
    k2 = jax.random.fold_in(jk, 2)
    q = make_gaussian_problem(16, 32, 3, None, convert.key_from_numpy(np.asarray(k2)),
                              phi=p.phi, device="cpu")
    assert q.phi is p.phi or torch.equal(q.phi, p.phi)
    assert torch.equal(q.y, q.phi @ q.x_true)
    q_ref = jax_make_gaussian_problem(16, 32, 3, None, k2, phi=ref.phi)
    np.testing.assert_array_equal(q.x_true.numpy() != 0, np.asarray(q_ref.x_true) != 0)


def test_lofar_smoke_packed_solve_matches_reference():
    """lofar-smoke (870×1024 complex Φ, s=8, 20 iterations), 2-bit packed Φ̂."""
    st = JaxStation(n_antennas=SMOKE.n_antennas, seed=SMOKE.seed)
    phi = np.asarray(jax_measurement_matrix(st, SMOKE.resolution, SMOKE.extent))
    rng = np.random.default_rng(302)
    x = np.zeros(phi.shape[1], np.float32)
    x[rng.choice(phi.shape[1], SMOKE.n_sources, replace=False)] = rng.uniform(0.5, 1.0,
                                                                              SMOKE.n_sources)
    noise = rng.standard_normal(phi.shape[0]) + 1j * rng.standard_normal(phi.shape[0])
    y = np.asarray(phi @ x + 0.5 * noise, dtype=np.complex64)
    jkey = jax.random.PRNGKey(0)
    kw = dict(bits_phi=2, bits_y=8, requantize="fixed", backend="packed",
              real_signal=True, nonneg=True)
    res_j = jax_qniht(_j(phi), _j(y), SMOKE.n_sources, SMOKE.n_iters, key=jkey, **kw)
    res_t = qniht(torch.from_numpy(np.array(phi)), torch.from_numpy(y), SMOKE.n_sources, SMOKE.n_iters,
                  key=convert.key_from_numpy(np.asarray(jkey)), **kw)
    xj, xt = np.asarray(res_j.x), res_t.x.numpy()
    assert np.linalg.norm(xt - xj) <= 1e-3 * np.linalg.norm(xj)
    np.testing.assert_array_equal(xt != 0, xj != 0)
    np.testing.assert_allclose(res_t.trace.resid_q.numpy(), np.asarray(res_j.trace.resid_q),
                               rtol=1e-3, atol=1e-5)
