"""The port's stochastic-rounding quantizer against the JAX reference.

Inputs are made with numpy from a seed; keys are ``PRNGKey(seed)`` in both
packages, which draw the same threefry words. On the CPU the port's
``sqround`` runs its plain version. Tolerance: none. Codes and scales must
equal the reference's bit for bit, both its Pallas kernel in interpret mode
(``use_pallas=True, interpret=True``) and its oracle (``use_pallas=False``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sqround.ops import sqround as jax_sqround
from repro.kernels.sqround.ref import uniform01_from_bits as jax_uniform01
from repro_torch import random as prng
from repro_torch.kernels.sqround import kernel as sq_kernel
from repro_torch.kernels.sqround.kernel import narrow_words
from repro_torch.kernels.sqround.ops import sqround
from repro_torch.kernels.sqround.ref import sqround_ref, uniform01_from_bits
from repro_torch.quant.formats import BY_BITS

BITS = [2, 4, 8]
SHAPES = [(1, 1), (70, 90), (333, 1001)]


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """The port reproduces jax.random under jax_threefry_partitionable=True
    (JAX 0.9's default): hold the reference to that mode whatever the
    process default is."""
    with jax.threefry_partitionable(True):
        yield


def _values(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 3.0).astype(np.float32)


def _both(v: np.ndarray, bits: int, seed: int, scale=None):
    """(port codes, port scale, [(reference codes, reference scale) for the
    kernel in interpret mode and for the oracle])."""
    codes, s = sqround(torch.from_numpy(v), bits, prng.PRNGKey(seed),
                       None if scale is None else torch.tensor(scale, dtype=torch.float32))
    jkey = jax.random.PRNGKey(seed)
    jscale = None if scale is None else jnp.float32(scale)
    jv = jnp.asarray(v, dtype=jnp.float32)
    refs = [jax_sqround(jv, bits, jkey, jscale, use_pallas=True, interpret=True),
            jax_sqround(jv, bits, jkey, jscale, use_pallas=False)]
    return codes, s, refs


def _assert_same(codes, s, refs):
    assert codes.dtype == torch.int8
    for c_ref, s_ref in refs:
        np.testing.assert_array_equal(codes.numpy(), np.asarray(c_ref))
        assert np.float32(s.item()).tobytes() == np.asarray(s_ref, np.float32).tobytes()


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", SHAPES)
def test_codes_and_scale_bitwise(bits, shape):
    v = _values(shape, sum(shape) + bits)
    _assert_same(*_both(v, bits, seed=bits + shape[0]))


@pytest.mark.parametrize("bits", BITS)
def test_explicit_scale_bitwise(bits):
    """A scale below max|v| clips; one above leaves headroom."""
    v = _values((70, 90), bits)
    for scale in (1.5, 17.0):
        codes, s, refs = _both(v, bits, seed=5, scale=scale)
        assert s.item() == scale
        _assert_same(codes, s, refs)


@pytest.mark.parametrize("bits", BITS)
def test_all_zero_values_take_scale_one(bits):
    codes, s, refs = _both(np.zeros((70, 90), np.float32), bits, seed=3)
    assert s.item() == 1.0
    assert not codes.any()
    _assert_same(codes, s, refs)


@pytest.mark.parametrize("bits", BITS)
def test_grid_points_and_full_scale(bits):
    """Values exactly on the code grid (p_up = 0: never rounded up) and at
    ±scale round to themselves; values beyond the scale clip to ±K."""
    k = BY_BITS[bits].half_steps
    grid = np.arange(-k, k + 1, dtype=np.float32) / k * 2.0      # scale 2.0
    v = np.resize(grid, 70 * 90)
    v[-4:] = [2.0, -2.0, 5.0, -5.0]
    v = v.reshape(70, 90)
    codes, s, refs = _both(v, bits, seed=11, scale=2.0)
    _assert_same(codes, s, refs)
    expect = np.clip(np.rint(v / 2.0 * k), -k, k).astype(np.int8)
    np.testing.assert_array_equal(codes.numpy(), expect)


def test_codes_within_range_and_unbiased():
    """2 bits, the harshest grid: codes in [-1, 1] and E[code·scale/K] = v
    over many keys (the reference's own statistical check)."""
    v = np.random.default_rng(2).uniform(-1, 1, (8, 8)).astype(np.float32)
    vt = torch.from_numpy(v)
    total = torch.zeros(8, 8)
    for seed in range(400):
        codes, s = sqround(vt, 2, prng.PRNGKey(seed))
        assert int(codes.min()) >= -1 and int(codes.max()) <= 1
        total += codes.float() * s
    np.testing.assert_allclose((total / 400).numpy(), v, atol=0.1)


def test_uniform01_bitwise_and_in_range():
    key = prng.PRNGKey(4)
    u = prng.bits(key, (1000,))
    f = uniform01_from_bits(u)
    ju = jax.random.bits(jax.random.PRNGKey(4), (1000,), dtype=jnp.uint32)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jax_uniform01(ju)))
    assert float(f.min()) >= 0.0 and float(f.max()) < 1.0


def test_narrowed_words_give_the_same_codes():
    """The kernel reads int32 words with the same bits as the int64 holder."""
    v = torch.from_numpy(_values((31, 45), 9))
    u = prng.bits(prng.PRNGKey(6), v.shape)
    assert int(u.max()) >= 2**31                 # some words need the top bit
    words = narrow_words(u)
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy().view(np.uint32), u.numpy().astype(np.uint32))
    scale = v.abs().amax()
    for bits in BITS:
        assert torch.equal(sqround_ref(v, words, scale, bits), sqround_ref(v, u, scale, bits))


def test_rejects_bad_inputs():
    with pytest.raises(ValueError):
        sqround(torch.zeros(4), 8, prng.PRNGKey(0))
    with pytest.raises(TypeError):
        sqround(torch.zeros(2, 3, dtype=torch.float64), 8, prng.PRNGKey(0))
    with pytest.raises(TypeError):
        narrow_words(torch.zeros(3, dtype=torch.float32))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never computes on the CPU: it raises before any
    build or launch, and counts nothing."""
    v = torch.ones(2, 3)
    before = sq_kernel.SQROUND.launches
    with pytest.raises(ValueError, match="CUDA"):
        sq_kernel.sqround_cuda(v, prng.bits(prng.PRNGKey(0), v.shape), torch.tensor(1.0), 8)
    assert sq_kernel.SQROUND.launches == before
