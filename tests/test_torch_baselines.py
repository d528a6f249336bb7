"""The port's baselines (``repro_torch.core.baselines``), dirty image and beam,
sky helpers and single NIHT step against the reference's, on the same numpy
inputs.

Tolerances:

* ``spectral_norm``: 1e-5 relative;
* ``iht``, ``cosamp``, ``fista_l1``: x within 1e-4 relative (of max|x|), the
  same support, and the residual trace within 1e-4 relative;
* ``clean``: components, residual and peaks within 1e-5 (absolute, on an
  image of peak ~1), the components at the same positions;
* ``dirty_image``, ``dirty_beam``: 1e-4 absolute, each package on its own Φ
  (the two Φ differ by up to 1e-4);
* ``to_image``: bit for bit; ``ascii_render``: the same string;
* ``niht_iteration``: x within 1e-5 relative, the same support, µ within 1e-5
  relative, the same support-change flag and backtracks.

Inputs: a Gaussian 64×128 Φ, s = 4, 20 dB noise (real signal), and the
lofar-smoke station (870×1024 complex Φ, 8 sources at 0 dB, the sky from
``PRNGKey(0)``; real signal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.lofar_cs302 import SMOKE as JAX_LOFAR_SMOKE
from repro.core import baselines as jb
from repro.core.niht import niht_iteration as jax_niht_iteration
from repro.core.operators import DenseOperator as JaxDense
from repro.sensing.sky import ascii_render as jax_ascii_render
from repro.sensing.sky import make_sky as jax_make_sky
from repro.sensing.sky import to_image as jax_to_image
from repro.sensing.telescope import Station as JaxStation
from repro.sensing.telescope import dirty_beam as jax_dirty_beam
from repro.sensing.telescope import dirty_image as jax_dirty_image
from repro.sensing.telescope import measurement_matrix as jax_measurement_matrix
from repro.sensing.telescope import visibilities as jax_visibilities
from repro_torch.core import baselines as tb
from repro_torch.core.niht import niht_iteration
from repro_torch.core.operators import DenseOperator
from repro_torch.sensing.sky import ascii_render, to_image
from repro_torch.sensing.telescope import Station, dirty_beam, dirty_image, measurement_matrix

R = JAX_LOFAR_SMOKE.resolution


def _j(a):
    """A numpy array as a JAX array of its own dtype (no float64 narrowing)."""
    a = np.asarray(a)
    return jnp.asarray(a, dtype=a.dtype)


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


@pytest.fixture(scope="module")
def gaussian():
    rng = np.random.default_rng(4)
    phi = rng.standard_normal((64, 128)).astype(np.float32)
    x = np.zeros(128, np.float32)
    x[rng.choice(128, 4, replace=False)] = rng.standard_normal(4)
    clean_y = phi @ x
    sigma = np.sqrt(clean_y @ clean_y / 100.0 / 64)
    y = (clean_y + sigma * rng.standard_normal(64)).astype(np.float32)
    return phi, y, 4


@pytest.fixture(scope="module")
def lofar():
    with jax.threefry_partitionable(True):
        st = JaxStation(n_antennas=JAX_LOFAR_SMOKE.n_antennas, seed=JAX_LOFAR_SMOKE.seed)
        phi = jax_measurement_matrix(st, R, JAX_LOFAR_SMOKE.extent)
        key = jax.random.PRNGKey(0)
        x = jax_make_sky(R, JAX_LOFAR_SMOKE.n_sources, key, min_sep=JAX_LOFAR_SMOKE.min_sep)
        y, _ = jax_visibilities(phi, x, JAX_LOFAR_SMOKE.snr_db, key)
    return np.array(phi), np.array(y), JAX_LOFAR_SMOKE.n_sources


@pytest.fixture(params=["gaussian", "lofar"])
def problem(request, gaussian, lofar):
    return gaussian if request.param == "gaussian" else lofar


def _t(a):
    return torch.from_numpy(np.array(a))


def _hold_solution(x, resid, x_ref, resid_ref):
    x, x_ref = x.numpy(), np.asarray(x_ref)
    np.testing.assert_array_equal(x != 0, x_ref != 0)
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=1e-4 * np.abs(x_ref).max())
    resid_ref = np.asarray(resid_ref)
    np.testing.assert_allclose(resid.numpy(), resid_ref, rtol=1e-4, atol=0)


def test_spectral_norm(problem):
    phi = problem[0]
    ours = float(tb.spectral_norm(_t(phi)))
    ref = float(jb.spectral_norm(_j(phi)))
    assert abs(ours - ref) <= 1e-5 * ref


@pytest.mark.parametrize("method,n_iters", [("iht", 50), ("cosamp", 20)])
def test_iht_and_cosamp(problem, method, n_iters):
    phi, y, s = problem
    x, resid = getattr(tb, method)(_t(phi), _t(y), s, n_iters, real_signal=True)
    x_ref, resid_ref = getattr(jb, method)(_j(phi), _j(y), s, n_iters,
                                           real_signal=True)
    assert resid.shape == (n_iters,) and x.dtype == torch.float32
    _hold_solution(x, resid, x_ref, resid_ref)


def test_cosamp_complex_signal(lofar):
    """real_signal=False: a complex x, candidates scattered back by adding."""
    phi, y, s = lofar
    x, resid = tb.cosamp(_t(phi), _t(y), s, 6)
    x_ref, resid_ref = jb.cosamp(_j(phi), _j(y), s, 6)
    assert x.dtype == torch.complex64
    _hold_solution(x, resid, x_ref, resid_ref)


@pytest.mark.parametrize("lam", [None, 0.5])
def test_fista_l1(problem, lam):
    phi, y, _ = problem
    x, resid = tb.fista_l1(_t(phi), _t(y), lam=lam, n_iters=100, real_signal=True)
    x_ref, resid_ref = jb.fista_l1(_j(phi), _j(y), lam=lam, n_iters=100,
                                   real_signal=True)
    _hold_solution(x, resid, x_ref, resid_ref)


def test_fista_momenta_are_the_reference_float32_sequence():
    """The host-side momenta equal the reference's t update inside its
    compiled scan, bit for bit."""
    @jax.jit
    def momenta():
        def step(t, _):
            t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
            return t_new, (t - 1.0) / t_new
        return jax.lax.scan(step, jnp.float32(1.0), None, length=400)[1]

    assert tb._fista_momenta(400) == np.asarray(momenta()).tolist()


def test_dirty_image_and_beam(lofar):
    phi_ref, y, _ = lofar
    phi = measurement_matrix(Station(n_antennas=JAX_LOFAR_SMOKE.n_antennas,
                                     seed=JAX_LOFAR_SMOKE.seed), R, JAX_LOFAR_SMOKE.extent,
                             device="cpu")
    img = dirty_image(phi, _t(y), R)
    beam = dirty_beam(phi, R)
    assert img.shape == beam.shape == (R, R) and img.dtype == torch.float32
    np.testing.assert_allclose(img.numpy(), np.asarray(jax_dirty_image(phi_ref, y, R)),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(beam.numpy(), np.asarray(jax_dirty_beam(phi_ref, R)),
                               rtol=0, atol=1e-4)
    assert float(beam[R // 2, R // 2]) == pytest.approx(float(beam.max()))


@pytest.mark.parametrize("gain,n_iters,threshold", [(0.1, 200, 0.0), (0.3, 40, 0.05)])
def test_clean(lofar, gain, n_iters, threshold):
    """Högbom CLEAN on the reference's dirty image and beam (handed across)."""
    phi, y, _ = lofar
    img = np.asarray(jax_dirty_image(phi, y, R))
    beam = np.asarray(jax_dirty_beam(phi, R))
    comps, resid, peaks = tb.clean(_t(img), _t(beam), gain, n_iters, threshold)
    c_ref, r_ref, p_ref = jb.clean(_j(img), _j(beam), gain, n_iters,
                                   threshold)
    assert peaks.shape == (n_iters,)
    np.testing.assert_array_equal(comps.numpy() != 0, np.asarray(c_ref) != 0)
    for ours, ref in ((comps, c_ref), (resid, r_ref), (peaks, p_ref)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_clean_takes_the_first_maximum_and_wraps_the_beam():
    """Two equal peaks: both packages take the first (argmax order); a peak
    at the corner shifts the beam periodically."""
    img = np.zeros((8, 8), np.float32)
    img[0, 0] = img[5, 6] = 1.0
    beam = np.zeros((8, 8), np.float32)
    beam[4, 4], beam[4, 5], beam[3, 4] = 1.0, 0.5, 0.25
    ours = tb.clean(_t(img), _t(beam), 0.5, 3)
    ref = jb.clean(_j(img), _j(beam), 0.5, 3)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_to_image_and_ascii_render(lofar):
    phi, y, _ = lofar
    re, im = np.random.default_rng(1).standard_normal((2, R * R)).astype(np.float32)
    x = re + 1j * im                                   # complex64
    np.testing.assert_array_equal(to_image(_t(x), R).numpy(),
                                  np.asarray(jax_to_image(_j(x), R)))
    img = np.asarray(jax_dirty_image(phi, y, R))
    for width in (64, 16, 7):
        assert ascii_render(_t(img), width) == jax_ascii_render(_j(img), width)
    assert ascii_render(img) == jax_ascii_render(_j(img))


def test_niht_iteration(gaussian):
    phi, y, s = gaussian
    x0 = np.zeros(phi.shape[1], np.float32)
    x1, mu, changed, nbt = niht_iteration(_t(x0), _t(y), DenseOperator(_t(phi)),
                                          DenseOperator(_t(phi)), s, 0.01, 2.0, 30, False,
                                          False)
    op = JaxDense(_j(phi))
    x1_ref, mu_ref, ch_ref, nbt_ref = jax_niht_iteration(_j(x0), _j(y), op,
                                                         op, s, 0.01, 2.0, 30, False, False)
    x1_ref = np.asarray(x1_ref)
    assert x1.shape == (phi.shape[1],) and int((x1 != 0).sum()) <= s
    np.testing.assert_array_equal(x1.numpy() != 0, x1_ref != 0)
    np.testing.assert_allclose(x1.numpy(), x1_ref, rtol=0, atol=1e-5 * np.abs(x1_ref).max())
    assert abs(float(mu) - float(mu_ref)) <= 1e-5 * float(mu_ref)
    assert bool(changed) == bool(ch_ref) and int(nbt) == int(nbt_ref)
