"""The port's flash attention against the JAX reference.

Inputs are made with numpy from a seed and handed to both packages. On the
CPU the port's ``flash_attention`` repeats K/V and runs its plain version.
It is held against the reference's oracle path
(``flash_attention(use_pallas=False)``) and its Pallas kernel in interpret
mode (``use_pallas=True, interpret=True``), with the reference's own
kernel-vs-oracle tolerances: |Δ| <= 2e-4 (abs and rel) for float32 inputs,
2e-2 for bfloat16 and float16 (16-bit inputs and outputs).

Where the reference's two paths disagree, the port follows the oracle
``attention_ref``: causal attention with Sq < Sk aligns the diagonal
bottom-right (the Pallas kernel aligns it top-left), and ragged lengths
(which the Pallas path refuses) are masked. Those cases are held against the
oracle only; the Pallas path only where it accepts the shape and aligns the
same way (Sq = Sk, or not causal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flashattn.ops import flash_attention as jax_flash_attention
from repro_torch.kernels.flashattn import kernel as fa_kernel
from repro_torch.kernels.flashattn.ops import attention_plain, flash_attention


@pytest.fixture(autouse=True, scope="module")
def _leave_no_jax_executables():
    """Drop the JAX executables this module's reference calls compiled: an
    eager primitive cached with jax_debug_nans off would keep later tests in
    the process (tests/test_sanitize.py) from tripping."""
    yield
    jax.clear_caches()


F32_TOL = 2e-4
BF16_TOL = 2e-2


def _qkv(b, hq, hkv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    return q, k, v


def _port(arrays, causal, dtype=torch.float32):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    out = flash_attention(q, k, v, causal=causal)
    assert out.dtype == dtype
    return out.float().numpy()


def _reference(arrays, causal, pallas, dtype=jnp.float32):
    q, k, v = (jnp.asarray(a, dtype) for a in arrays)
    kw = dict(use_pallas=True, interpret=True, block_q=64, block_k=64) if pallas else dict(
        use_pallas=False)
    return np.asarray(jax_flash_attention(q, k, v, causal=causal, **kw), np.float32)


def _hold(arrays, causal, *, pallas=True, tol=F32_TOL, dtype=(torch.float32, jnp.float32)):
    out = _port(arrays, causal, dtype[0])
    np.testing.assert_allclose(out, _reference(arrays, causal, False, dtype[1]),
                               rtol=tol, atol=tol)
    if pallas:
        np.testing.assert_allclose(out, _reference(arrays, causal, True, dtype[1]),
                                   rtol=tol, atol=tol)
    return out


# (causal, B, H, S, D): the reference's shape sweep, S a multiple of its 64 block
SWEEP = [(False, 2, 2, 128, 64), (True, 3, 4, 192, 32), (True, 2, 1, 256, 64)]


@pytest.mark.parametrize("causal,b,h,s,d", SWEEP)
def test_shape_sweep(causal, b, h, s, d):
    _hold(_qkv(b, h, h, s, s, d, seed=b * h + s + d), causal)


@pytest.mark.parametrize("hq,hkv", [(4, 1), (4, 2), (8, 8)])
def test_gqa_ratios(hq, hkv):
    _hold(_qkv(2, hq, hkv, 128, 128, 64, seed=hq + hkv), True)


@pytest.mark.parametrize("dtype,tol", [((torch.float32, jnp.float32), F32_TOL),
                                       ((torch.bfloat16, jnp.bfloat16), BF16_TOL),
                                       ((torch.float16, jnp.float16), BF16_TOL)])
def test_dtypes(dtype, tol):
    _hold(_qkv(1, 2, 2, 128, 128, 64, seed=1), True, tol=tol, dtype=dtype)


def test_cross_attention_longer_kv():
    """Sq != Sk, not causal: both reference paths agree."""
    _hold(_qkv(2, 2, 2, 64, 256, 32, seed=2), False)


@pytest.mark.parametrize("causal", [True, False])
def test_starcoder2_smoke_widths(causal):
    """starcoder2-3b's SMOKE attention: 4 query heads on 2 KV heads, D = 16,
    at its 64-token attention chunk."""
    _hold(_qkv(2, 4, 2, 64, 64, 16, seed=3), causal)


@pytest.mark.parametrize("causal", [True, False])
def test_starcoder2_smoke_widths_float16(causal):
    """The same SMOKE width in float16, the card's tensor-core kernel's other
    16-bit type: q's dtype out, within the reference's 16-bit tolerance."""
    _hold(_qkv(2, 4, 2, 64, 64, 16, seed=3), causal, tol=BF16_TOL,
          dtype=(torch.float16, jnp.float16))


def test_causal_cross_attention_follows_the_oracle():
    """Causal Sq < Sk: row i sees keys j <= i + Sk - Sq (``attention_ref``),
    so the rows equal the last Sq rows of the square causal call."""
    arrays = _qkv(1, 4, 2, 64, 256, 32, seed=4)
    out = _hold(arrays, True, pallas=False)
    q, k, v = arrays
    q_full = np.random.default_rng(5).standard_normal((1, 4, 256, 32)).astype(np.float32)
    q_full[:, :, -64:] = q
    square = _port((q_full, k, v), True)
    np.testing.assert_allclose(out, square[:, :, -64:], rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(100, 100), (37, 100), (333, 333)])
def test_ragged_lengths_follow_the_oracle(causal, sq, sk):
    """Lengths that are no multiple of a block; the Pallas path refuses them."""
    _hold(_qkv(2, 4, 2, sq, sk, 64, seed=sq + sk), causal, pallas=False)


def test_causality():
    """Changing future keys must not change causal outputs."""
    q, k, v = _qkv(1, 2, 1, 128, 128, 32, seed=6)
    out1 = _port((q, k, v), True)
    k2, v2 = k.copy(), v.copy()
    k2[:, :, 100:] = 99.0
    v2[:, :, 100:] = -99.0
    out2 = _port((q, k2, v2), True)
    np.testing.assert_array_equal(out1[:, :, :100], out2[:, :, :100])


def test_scale_defaults_to_inverse_sqrt_d():
    arrays = _qkv(1, 2, 2, 16, 16, 64, seed=7)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    assert torch.equal(flash_attention(q, k, v, causal=False),
                       flash_attention(q, k, v, causal=False, scale=0.125))


def test_rejects_what_the_reference_cannot_answer():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 3, 2, 8, 8, 16))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k, v)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 16, 8, 16))
    with pytest.raises(ValueError, match="Sq <= Sk"):
        flash_attention(q, k, v, causal=True)
    flash_attention(q, k, v, causal=False)          # not causal: every row sees every key


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never computes on the CPU: it raises before any
    build or launch, and counts nothing."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 8, 8, 32))
    before = fa_kernel.FLASH.launches
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.FLASH(q, k, v, True, 0.1)
    assert fa_kernel.FLASH.launches == before
    assert torch.equal(attention_plain(q, k, v, causal=True, scale=0.1),
                       flash_attention(q, k, v, causal=True, scale=0.1))


def test_card_route_by_dtype():
    """A CUDA tensor goes to one fixed kernel by dtype: float32 to the CUDA-core
    FLASH, bfloat16 and float16 to the tensor-core FLASH_TC; nothing else."""
    from repro_torch.kernels.flashattn import ops as fa_ops

    assert fa_ops.CUDA_KERNELS == {torch.float32: fa_kernel.FLASH,
                                   torch.bfloat16: fa_kernel.FLASH_TC,
                                   torch.float16: fa_kernel.FLASH_TC}
    assert fa_kernel.FLASH.library is not fa_kernel.FLASH_TC.library
    assert fa_kernel.FLASH_TC.library.source.name == "flashattn_wgmma.cu"


@pytest.mark.parametrize("dtype,error,match", [(torch.bfloat16, ValueError, "CUDA"),
                                               (torch.float16, ValueError, "CUDA"),
                                               (torch.float32, TypeError, "dtype")])
def test_tensor_core_wrapper_refuses_before_launching(dtype, error, match):
    """FLASH_TC never computes on the CPU and takes only 16-bit inputs: it
    raises before any build or launch, and counts nothing."""
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(1, 2, 1, 8, 8, 32))
    before = fa_kernel.FLASH_TC.launches
    with pytest.raises(error, match=match):
        fa_kernel.FLASH_TC(q, k, v, True, 0.1)
    assert fa_kernel.FLASH_TC.launches == before


@pytest.mark.parametrize("d", [8, 160, 256])
@pytest.mark.parametrize("dtype,tol", [((torch.float32, jnp.float32), F32_TOL),
                                       ((torch.bfloat16, jnp.bfloat16), BF16_TOL)])
def test_head_dims_of_the_reference_configs(d, dtype, tol):
    """The head dims the reference's model configs use besides 16-128:
    qwen3_moe_235b's smoke D = 8, stablelm_12b's 160, recurrentgemma_2b's 256."""
    _hold(_qkv(1, 4, 2, 64, 64, d, seed=d), True, tol=tol, dtype=dtype)


def _view(t, offset):
    """t's values as a contiguous view that starts ``offset`` elements into a
    larger tensor."""
    flat = torch.zeros(offset + t.numel(), dtype=t.dtype)
    view = flat[offset:].view(t.shape)
    view.copy_(t)
    return view


# the route of an aligned input, and of one off a 16-byte boundary
TWINS = {"FLASH": "FLASH_UNALIGNED", "FLASH_TC": "FLASH_TC_UNALIGNED"}


@pytest.mark.parametrize("dtype,d,want", [(torch.float32, 64, "FLASH"),
                                          (torch.float32, 8, "FLASH"),
                                          (torch.float32, 256, "FLASH"),
                                          (torch.bfloat16, 64, "FLASH_TC"),
                                          (torch.float16, 128, "FLASH_TC"),
                                          (torch.bfloat16, 8, "FLASH_TC"),
                                          (torch.float16, 160, "FLASH_TC"),
                                          (torch.bfloat16, 256, "FLASH_TC")])
@pytest.mark.parametrize("offset", [0, 2, 4])
def test_card_route_by_dtype_head_dim_and_alignment(dtype, d, want, offset):
    """The fixed route on the card: by dtype (float32 to the CUDA cores,
    16-bit to the tensor cores, at every head dim), then by alignment (a view
    off a 16-byte boundary to the dtype's unaligned twin, never a copy)."""
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(1, 2, 1, 8, 8, d))
    if offset:
        q = _view(q, offset)
    aligned = offset * q.element_size() % 16 == 0
    got = fa_kernel.cuda_kernel(q, k, v)
    assert got is getattr(fa_kernel, want if aligned else TWINS[want])
    assert d in got.head_dims and dtype in got.dtypes
    assert got.needs_alignment == aligned
    assert got.library.source.name == ("flashattn_wgmma.cu" if want == "FLASH_TC"
                                       else "flashattn.cu")
    # the CPU runs the plain version whatever the route would be
    ref = attention_plain(q, k, v, causal=True, scale=d ** -0.5)
    assert torch.equal(flash_attention(q, k, v, causal=True), ref)


@pytest.mark.parametrize("offset", [0, 1, 2, 8])
@pytest.mark.parametrize("d", fa_kernel.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_every_16_bit_input_takes_a_tensor_core_route(dtype, d, offset):
    """bf16 and fp16 at every head dim of the configs, with q, k and v views
    0, 1, 2 or 8 elements into larger tensors: aligned (0, 8) to FLASH_TC,
    off the boundary (1, 2) to FLASH_TC_UNALIGNED, both in flashattn_wgmma.cu;
    no CUDA-core route takes 16-bit inputs any more."""
    q, k, v = (_view(torch.from_numpy(a).to(dtype), offset) if offset
               else torch.from_numpy(a).to(dtype) for a in _qkv(1, 4, 2, 8, 8, d))
    got = fa_kernel.cuda_kernel(q, k, v)
    assert got is (fa_kernel.FLASH_TC if offset in (0, 8) else fa_kernel.FLASH_TC_UNALIGNED)
    assert got.library is fa_kernel.TC_LIBRARY and dtype in got.dtypes
    assert not hasattr(fa_kernel, "FLASH_CORE")
    assert [kk.entry for kk in fa_kernel.KERNELS if dtype in kk.dtypes] == [
        "repro_flash_attention_tc", "repro_flash_attention_tc_unaligned"]


@pytest.mark.parametrize("kernel,dtype,d,match", [
    ("FLASH_TC_UNALIGNED", torch.float32, 64, "dtype"),
    ("FLASH_UNALIGNED", torch.bfloat16, 8, "dtype"),
    ("FLASH_TC", torch.bfloat16, 96, "head dim"),
    ("FLASH_UNALIGNED", torch.float16, 96, "dtype")])
def test_wrappers_refuse_what_their_kernel_does_not_take(kernel, dtype, d, match):
    """Each route's wrapper raises before any build or launch for a dtype or
    head dim its kernel has no instantiation of (before it looks at the
    device), and counts nothing."""
    k_obj = getattr(fa_kernel, kernel)
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(1, 2, 1, 8, 8, d))
    before = k_obj.launches
    with pytest.raises((TypeError, ValueError), match=match):
        k_obj(q, k, v, True, 0.1)
    assert k_obj.launches == before and k_obj._lib is None
