"""The port's RIP machinery (``repro_torch.core.rip``) against the reference's
``repro.core.rip`` on the same numpy inputs.

Tolerances:

* the supports ``rics_sampled`` draws (``sampled_supports``): bit for bit;
* singular values, γ, α̂ and β̂: 1e-5 relative (singular values relative to
  the largest; a float32 Gram and ``eigvalsh`` or ``svd`` in another order);
* ``min_bits_lemma1``, ``gamma_hat_bound``, ``eps_q``, ``corollary1_coeffs``,
  ``theorem3_bound``, ``gamma_from_rics`` and ``stopping_iterations``: exact
  (the same float formulas on the same inputs); ``effective_scale`` of a
  scale vector and ``eps_s`` sum in float32, so 1e-6 relative.
* lofar-smoke's Φ is ill-conditioned, and there the singular values are held
  to the float64 SVD within the float32 Gram method's own error (see
  :func:`test_singular_values_and_gamma`).

Inputs: a Gaussian 64×128 Φ (s = 4) and the lofar-smoke station (870×1024
complex64 Φ, the reference's matrix handed across as numpy).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.lofar_cs302 import SMOKE as JAX_LOFAR_SMOKE
from repro.core import rip as jrip
from repro.core.niht import stopping_iterations as jax_stopping_iterations
from repro.sensing.telescope import Station as JaxStation
from repro.sensing.telescope import measurement_matrix as jax_measurement_matrix
from repro.sensing.telescope import tune_extent_for_gamma as jax_tune_extent
from repro_torch import convert
from repro_torch import random as prng
from repro_torch.core import rip
from repro_torch.core.niht import stopping_iterations
from repro_torch.kernels.qmm.ops import pack_weights
from repro_torch.sensing.telescope import Station, tune_extent_for_gamma

REL = 1e-5


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
def gaussian_phi():
    return np.random.default_rng(0).standard_normal((64, 128)).astype(np.float32)


@pytest.fixture(scope="module")
def lofar_phi():
    st = JaxStation(n_antennas=JAX_LOFAR_SMOKE.n_antennas, seed=JAX_LOFAR_SMOKE.seed)
    return np.array(jax_measurement_matrix(st, JAX_LOFAR_SMOKE.resolution,
                                             JAX_LOFAR_SMOKE.extent))


@pytest.fixture(params=["gaussian", "lofar"])
def phi(request, gaussian_phi, lofar_phi):
    return gaussian_phi if request.param == "gaussian" else lofar_phi


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b))))


def test_singular_values_and_gamma(phi):
    """Gaussian (γ ≈ 4): 1e-5 relative. lofar-smoke is ill-conditioned (γ ≈
    2,300, σ_min ≈ 4e-4·σ_max): the float32 Gram and ``eigvalsh`` the
    reference uses put every σ within ~3e-5·σ_max of the float64 SVD in
    either package, so each package is held to the float64 SVD within
    1e-4·σ_max, the two to each other within 1e-4·σ_max, and γ within the
    relative error that σ_min's own error allows."""
    sv = rip.singular_values(torch.from_numpy(phi)).numpy()
    sv_ref = np.asarray(jrip.singular_values(_j(phi)))
    assert sv.shape == sv_ref.shape and np.all(np.diff(sv) <= 0)
    g = float(rip.gamma_full(torch.from_numpy(phi)))
    g_ref = float(jrip.gamma_full(_j(phi)))
    if not np.iscomplexobj(phi):
        assert _rel(sv, sv_ref) <= REL
        assert abs(g - g_ref) <= REL * abs(g_ref)
        return
    exact = np.linalg.svd(phi.astype(np.complex128), compute_uv=False)
    tol = 1e-4 * exact[0]
    for got in (sv, sv_ref):
        assert np.max(np.abs(got - exact)) <= tol
    assert np.max(np.abs(sv - sv_ref)) <= tol
    assert abs(g - g_ref) <= (g_ref + 1.0) * 2 * tol / sv_ref[-1]


@pytest.mark.parametrize("seed,n,s,n_samples", [(3, 128, 4, 32), (11, 1024, 16, 8),
                                                (0, 65536, 60, 2)])
def test_sampled_supports_bitwise(seed, n, s, n_samples):
    jk = jax.random.PRNGKey(seed)
    ours = rip.sampled_supports(n, s, n_samples, convert.key_from_numpy(np.asarray(jk)))
    ref = np.stack([np.asarray(jax.random.choice(k, n, (s,), replace=False))
                    for k in jax.random.split(jk, n_samples)])
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_rics_sampled_and_gamma_from_rics(phi):
    s = 8
    a, b = rip.rics_sampled(torch.from_numpy(phi), s)
    a_ref, b_ref = jrip.rics_sampled(_j(phi), s)
    assert abs(float(a) - float(a_ref)) <= REL * float(a_ref)
    assert abs(float(b) - float(b_ref)) <= REL * float(b_ref)
    g = float(rip.gamma_from_rics(a, b))
    g_ref = float(jrip.gamma_from_rics(a_ref, b_ref))
    assert abs(g - g_ref) <= REL * abs(g_ref)
    # the float formula itself, on the same floats: exact
    assert float(rip.gamma_from_rics(float(a_ref), float(b_ref))) == float(
        jrip.gamma_from_rics(float(a_ref), float(b_ref)))


def _port_scales(phi, granularity):
    """The per-group scales of the port's own quantizer for Φ's real part."""
    w = pack_weights(torch.from_numpy(np.ascontiguousarray(phi.real)), 2, prng.PRNGKey(0),
                     granularity=granularity)
    return w.scale.reshape(-1).numpy()


@pytest.mark.parametrize("scale", ["scalar", "per_channel", "per_block"])
def test_lemma1_bits_and_float_formulas_exact(gaussian_phi, scale):
    """Exact for a scalar scale. A vector of group scales enters through its
    float32 root-mean-square, whose sum each package orders its own way: 1
    ulp apart (1e-6 relative), so the bit width is held exactly and the
    bound γ̂ to 1e-6 relative."""
    if scale == "scalar":
        c = 1.7
        assert rip.effective_scale(c) == jrip.effective_scale(c)
    else:
        c = _port_scales(gaussian_phi, scale if scale == "per_channel" else "per_block:16")
        assert abs(rip.effective_scale(c) / jrip.effective_scale(c) - 1.0) <= 1e-6
    for gamma, alpha, size in ((0.01, 0.8, 8), (0.05, 1.3, 60), (0.07, 0.9, 8)):
        assert (rip.min_bits_lemma1(gamma, alpha, size, scale=c)
                == jrip.min_bits_lemma1(gamma, alpha, size, scale=c))
        for bits in (2, 4, 8):
            ours = rip.gamma_hat_bound(gamma, alpha, size, bits, scale=c)
            ref = jrip.gamma_hat_bound(gamma, alpha, size, bits, scale=c)
            assert ours == ref if scale == "scalar" else abs(ours / ref - 1.0) <= 1e-6
    assert rip.min_bits_lemma1(0.07, 0.9, 8) == 64
    assert rip.eps_q(870, 1.3, 2.5, 2, 8, 1.5, 0.7) == jrip.eps_q(870, 1.3, 2.5, 2, 8, 1.5, 0.7)
    assert rip.corollary1_coeffs(30, 1.2, 1.4) == jrip.corollary1_coeffs(30, 1.2, 1.4)
    assert rip.theorem3_bound(12, 3.0, 0.1, 0.2) == jrip.theorem3_bound(12, 3.0, 0.1, 0.2)
    for xs_norm, eps in ((3.0, 0.01), (1.0, 2.0), (0.0, 1.0), (2.0, 0.0)):
        assert stopping_iterations(xs_norm, eps) == jax_stopping_iterations(xs_norm, eps)


def test_eps_s():
    re, im = np.random.default_rng(5).standard_normal((2, 256)).astype(np.float32)
    for x in (re, re + 1j * im):                       # float32 and complex64
        ours = float(rip.eps_s(torch.from_numpy(x), 10, 0.3, 1.7))
        ref = float(jrip.eps_s(_j(x), 10, 0.3, 1.7))
        assert abs(ours - ref) <= 1e-6 * abs(ref)


def test_tune_extent_for_gamma():
    """The Fig. 7 sweep at the lofar-smoke station, 16×16: each extent's Φ
    is built by its own package (Φ differs by up to 1e-4), γ within 1e-3
    relative, and the same best extent."""
    extents = np.array([0.5, 1.0, 2.0])
    st = Station(n_antennas=JAX_LOFAR_SMOKE.n_antennas, seed=JAX_LOFAR_SMOKE.seed)
    ours, best = tune_extent_for_gamma(st, 16, extents, target=1.0, device="cpu")
    ref, best_ref = jax_tune_extent(
        JaxStation(n_antennas=JAX_LOFAR_SMOKE.n_antennas, seed=JAX_LOFAR_SMOKE.seed), 16,
        extents, target=1.0)
    assert [d for d, _ in ours] == [d for d, _ in ref]
    for (_, g), (_, g_ref) in zip(ours, ref):
        assert abs(g - g_ref) <= 1e-3 * abs(g_ref)
    assert best == best_ref
