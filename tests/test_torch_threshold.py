"""H_s and the recovery metrics of the port against the reference.

Supports are compared bit for bit, ties included: the port takes the top s
from a stable descending sort, so equal magnitudes go to the lower index, as
``jax.lax.top_k`` does. Metric values agree to f32 rounding (rtol 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import recovery as jrec
from repro.core.threshold import hard_threshold as jax_hard_threshold
from repro.core.threshold import top_s_mask as jax_top_s_mask
from repro_torch.core import recovery as trec
from repro_torch.core.threshold import hard_threshold, support, top_s_mask


@pytest.fixture(autouse=True, scope="module")
def _leave_no_jax_executables():
    """Drop the JAX executables this module's reference calls compiled: an
    eager primitive cached with jax_debug_nans off would keep later tests in
    the process (tests/test_sanitize.py) from tripping."""
    yield
    jax.clear_caches()


def _j(a):
    return jnp.asarray(a, dtype=a.dtype)


def _tied_rows(seed):
    """Rows with many exactly tied magnitudes (of both signs) and zeros."""
    rng = np.random.default_rng(seed)
    return rng.choice([-2.0, -1.0, 0.0, 1.0, 2.0, 0.5], size=(6, 40)).astype(np.float32)


@pytest.mark.parametrize("s", [1, 3, 8, 39])
def test_top_s_mask_ties_match_lax_top_k(s):
    x = _tied_rows(s)
    want = np.stack([np.asarray(jax_top_s_mask(_j(row), s)) for row in x])
    np.testing.assert_array_equal(top_s_mask(torch.from_numpy(x), s).numpy(), want)


def test_hard_threshold_complex_rows():
    rng = np.random.default_rng(1)
    x = np.asarray(rng.standard_normal((3, 50)) + 1j * rng.standard_normal((3, 50)),
                   dtype=np.complex64)
    want = np.asarray(jax.vmap(lambda v: jax_hard_threshold(v, 5))(_j(x)))
    np.testing.assert_array_equal(hard_threshold(torch.from_numpy(x), 5).numpy(), want)
    assert support(torch.from_numpy(np.array(want))).sum(dim=-1).tolist() == [5, 5, 5]


def test_hard_threshold_keeps_everything_when_s_covers_the_row():
    x = torch.randn(2, 7)
    assert torch.equal(hard_threshold(x, 7), x)


def test_metrics_match_reference():
    rng = np.random.default_rng(2)
    r = 16
    x_true = np.zeros(r * r, np.float32)
    x_true[rng.choice(r * r, 6, replace=False)] = rng.uniform(0.5, 1.0, 6)
    x_hat = (x_true + 0.05 * rng.standard_normal(r * r)).astype(np.float32)
    tt, th = torch.from_numpy(x_true), torch.from_numpy(x_hat)
    pairs = [
        (trec.relative_error(th, tt), jrec.relative_error(_j(x_hat), _j(x_true))),
        (trec.support_recovery(th, tt, 6), jrec.support_recovery(_j(x_hat), _j(x_true), 6)),
        (trec.source_recovery(th.reshape(r, r), tt.reshape(r, r), 6, 1),
         jrec.source_recovery(_j(x_hat).reshape(r, r), _j(x_true).reshape(r, r), 6, 1)),
        (trec.psnr(th, tt), jrec.psnr(_j(x_hat), _j(x_true))),
        (trec.snr_db(tt, th - tt), jrec.snr_db(_j(x_true), _j(x_hat - x_true))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
