"""repro_torch.random against jax.random, bit for bit.

The port's threefry2x32 must give the reference's words exactly: every
stochastic-rounding draw (ŷ, Φ̂) rests on them. Tolerance: bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch import convert
from repro_torch import random as prng


@pytest.fixture(autouse=True, scope="module")
def _leave_no_jax_executables():
    """Drop the JAX executables this module's reference calls compiled: an
    eager primitive cached with jax_debug_nans off would keep later tests in
    the process (tests/test_sanitize.py) from tripping."""
    yield
    jax.clear_caches()


KEYS = [0, 1, 42, 302, 2**31 - 1, -7]


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """The port reproduces jax.random under jax_threefry_partitionable=True
    (JAX 0.9's default): hold the reference to that mode whatever the
    process default is."""
    with jax.threefry_partitionable(True):
        yield


def _pair(seed):
    jk = jax.random.PRNGKey(seed)
    return jk, convert.key_from_numpy(np.asarray(jk))


def test_published_vectors():
    key = prng.PRNGKey(0)
    assert prng.bits(key, (4,)).tolist() == [4070199207, 4202968722, 1427181096, 2012915765]
    assert prng.split(key).tolist() == [[1797259609, 2579123966], [928981903, 3453687069]]
    np.testing.assert_array_equal(prng.uniform(key, (3,)).numpy(),
                                  np.asarray([0.947667, 0.9785799, 0.33229148], np.float32))


@pytest.mark.parametrize("seed", KEYS)
def test_prngkey_matches(seed):
    jk, tk = _pair(seed)
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(), np.asarray(jk).astype(np.int64))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))


@pytest.mark.parametrize("seed", KEYS)
@pytest.mark.parametrize("num", [2, 3, 4])
def test_split_matches(seed, num):
    jk, tk = _pair(seed)
    np.testing.assert_array_equal(prng.split(tk, num).numpy(),
                                  np.asarray(jax.random.split(jk, num)).astype(np.int64))


@pytest.mark.parametrize("seed", KEYS)
@pytest.mark.parametrize("data", [0, 1, 5, 2**31 + 5, 2**32 - 1])
def test_fold_in_matches(seed, data):
    jk, tk = _pair(seed)
    np.testing.assert_array_equal(prng.fold_in(tk, data).numpy(),
                                  np.asarray(jax.random.fold_in(jk, data)).astype(np.int64))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (4, 1, 6), (0,)])
@pytest.mark.parametrize("seed", [0, 302])
def test_bits_match(shape, seed):
    jk, tk = _pair(seed)
    np.testing.assert_array_equal(
        prng.bits(tk, shape).numpy(),
        np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (4, 1, 6), (0,)])
@pytest.mark.parametrize("seed", [0, 302])
def test_uniform_match(shape, seed):
    jk, tk = _pair(seed)
    u = prng.uniform(tk, shape).numpy()
    assert u.dtype == np.float32
    np.testing.assert_array_equal(u, np.asarray(jax.random.uniform(jk, shape)))


def test_chunked_draw_matches(monkeypatch):
    """Large draws are made in chunks; the chunk boundary changes nothing."""
    jk, tk = _pair(9)
    monkeypatch.setattr(prng, "_CHUNK", 64)
    shape = (13, 37)                      # 481 elements over 8 chunks
    np.testing.assert_array_equal(prng.uniform(tk, shape).numpy(),
                                  np.asarray(jax.random.uniform(jk, shape)))


def test_derived_keys_chain():
    """The solver's derivations: split → fold_in → split, as in make_iteration_operators."""
    jk, tk = _pair(11)
    jy, jphi = jax.random.split(jk)
    ty, tphi = prng.split(tk)
    jre, jim = jax.random.split(jax.random.fold_in(jphi, 0))
    tre, tim = prng.split(prng.fold_in(tphi, 0))
    for a, b in ((jy, ty), (jre, tre), (jim, tim)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a).astype(np.int64))


def test_bad_key_and_seed_raise():
    with pytest.raises(ValueError):
        prng.split(prng.PRNGKey(0)[:1])
    with pytest.raises(ValueError):
        prng.PRNGKey(2**40)
    with pytest.raises(ValueError):
        convert.key_from_numpy(np.zeros(2, np.int32))


@pytest.mark.parametrize("seed", KEYS)
@pytest.mark.parametrize("n,size", [(1, 1), (10, 3), (1024, 8), (4624, 30), (65536, 60)])
def test_choice_without_replacement_matches(seed, n, size):
    jk, tk = _pair(seed)
    np.testing.assert_array_equal(
        prng.choice(tk, n, size).numpy(),
        np.asarray(jax.random.choice(jk, n, (size,), replace=False)))


@pytest.mark.parametrize("seed", KEYS)
@pytest.mark.parametrize("lo,hi", [(0.5, 1.0), (-2.0, 3.0), (0.1, 0.7)])
def test_bounded_uniform_matches(seed, lo, hi):
    jk, tk = _pair(seed)
    np.testing.assert_array_equal(
        prng.uniform(tk, (257,), minval=lo, maxval=hi).numpy(),
        np.asarray(jax.random.uniform(jk, (257,), minval=lo, maxval=hi)))
