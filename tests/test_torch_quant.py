"""repro_torch.quant against repro.quant: codes, scales, packed bytes and
fake-quantized values, bit for bit (same IEEE f32 operations in the same
order, and the same uniforms from the same key)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.qmm.ops import _zero_byte as jax_zero_byte
from repro.quant.pack import pack_codes as jax_pack, unpack_codes as jax_unpack
from repro.quant.quantize import (
    dequantize_codes as jax_dequantize_codes,
    fake_quantize as jax_fake_quantize,
    quantize as jax_quantize,
    quantize_codes as jax_quantize_codes,
)
from repro_torch import convert
from repro_torch.kernels.qmm.ops import _zero_byte
from repro_torch.quant.pack import pack_codes, packed_len, unpack_codes
from repro_torch.quant.quantize import (
    dequantize_codes,
    fake_quantize,
    quantize,
    quantize_codes,
)


@pytest.fixture(autouse=True, scope="module")
def _leave_no_jax_executables():
    """Drop the JAX executables this module's reference calls compiled: an
    eager primitive cached with jax_debug_nans off would keep later tests in
    the process (tests/test_sanitize.py) from tripping."""
    yield
    jax.clear_caches()


BITS = [2, 4, 8]
SHAPES = [(37,), (48, 96)]


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """The port reproduces jax.random under jax_threefry_partitionable=True
    (JAX 0.9's default): hold the reference to that mode whatever the
    process default is."""
    with jax.threefry_partitionable(True):
        yield


def _j(a):
    return jnp.asarray(a, dtype=a.dtype)


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return np.asarray(rng.standard_normal(shape) + 1j * rng.standard_normal(shape),
                      dtype=np.complex64)


def _keys(seed):
    jk = jax.random.PRNGKey(seed)
    return jk, convert.key_from_numpy(np.asarray(jk))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("stochastic", [True, False])
def test_quantize_codes_real(shape, bits, stochastic):
    v = _real(shape, bits)
    jk, tk = _keys(7) if stochastic else (None, None)
    cj, sj = jax_quantize_codes(_j(v), bits, jk)
    ct, st = quantize_codes(torch.from_numpy(v), bits, tk)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("bits", BITS)
def test_quantize_codes_per_channel(bits):
    v = _real((13, 29), 3)
    jk, tk = _keys(8)
    cj, sj = jax_quantize_codes(_j(v), bits, jk, channel_axis=0)
    ct, st = quantize_codes(torch.from_numpy(v), bits, tk, channel_axis=0)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", BITS)
def test_quantize_complex_shared_scale(shape, bits):
    v = _complex(shape, bits + 1)
    jk, tk = _keys(3)
    qj = jax_quantize(_j(v), bits, jk)
    qt = quantize(torch.from_numpy(v), bits, tk)
    assert qt.is_complex and qt.codes.shape == (2, *shape)
    np.testing.assert_array_equal(qt.codes.numpy(), np.asarray(qj.codes))
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(qj.scale))


@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("bits", BITS)
def test_fake_quantize_bitwise(kind, bits):
    v = _real((48, 96), 5) if kind == "real" else _complex((48, 96), 5)
    jk, tk = _keys(bits)
    out_j = np.asarray(jax_fake_quantize(_j(v), bits, jk))
    out_t = fake_quantize(torch.from_numpy(v), bits, tk)
    assert out_t.dtype == torch.from_numpy(v).dtype
    np.testing.assert_array_equal(out_t.numpy(), out_j)


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_fake_quantize_keeps_wide_dtypes(dtype):
    v = torch.randn(20, dtype=dtype, generator=torch.Generator().manual_seed(0))
    out = fake_quantize(v, 8, convert.key_from_numpy(np.asarray(jax.random.PRNGKey(0))))
    assert out.dtype == dtype
    assert float((out - v).abs().max()) <= float(v.abs().max()) / 64 * 1.5


@pytest.mark.parametrize("bits", BITS)
def test_dequantize_codes(bits):
    v = _real((13, 29), 9)
    cj, sj = jax_quantize_codes(_j(v), bits)
    np.testing.assert_array_equal(
        dequantize_codes(torch.from_numpy(np.array(cj)), torch.from_numpy(np.array(sj)),
                         bits).numpy(),
        np.asarray(jax_dequantize_codes(cj, sj, bits)))


@pytest.mark.parametrize("n", [1, 3, 4, 5, 96, 870])
@pytest.mark.parametrize("bits", BITS)
def test_pack_bytes_bitwise(n, bits):
    k = 2 ** (bits - 1) // 2
    codes = np.random.default_rng(n).integers(-k, k + 1, size=(5, n)).astype(np.int8)
    pj = np.asarray(jax_pack(_j(codes), bits))
    pt = pack_codes(torch.from_numpy(codes), bits)
    assert pt.dtype == torch.uint8 and pt.shape == (5, packed_len(n, bits))
    np.testing.assert_array_equal(pt.numpy(), pj)
    np.testing.assert_array_equal(unpack_codes(pt, bits, n).numpy(), codes)
    np.testing.assert_array_equal(unpack_codes(pt, bits, n).numpy(),
                                  np.asarray(jax_unpack(_j(pj), bits, n)))


@pytest.mark.parametrize("bits", BITS)
def test_zero_byte(bits):
    assert _zero_byte(bits) == jax_zero_byte(bits)
    codes = torch.zeros((1, 8 // bits), dtype=torch.int8)
    assert int(pack_codes(codes, bits)[0, 0]) == _zero_byte(bits)


@pytest.mark.parametrize("bits", BITS)
def test_quantize_codes_per_block(bits):
    """per_block codes and compact (…, ⌈n/g⌉) scales, ragged last group."""
    v = _real((13, 29), 11)
    jk, tk = _keys(12)
    cj, sj = jax_quantize_codes(_j(v), bits, jk, granularity="per_block:4")
    ct, st = quantize_codes(torch.from_numpy(v), bits, tk, granularity="per_block:4")
    assert st.shape == (13, 8)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
