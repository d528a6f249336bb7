"""The card's route for the packed matmul, and the arithmetic its tensor-core
kernel relies on, checked on the CPU.

* The route is fixed by the group size: per-row scales and ``per_block`` with
  g a multiple of 16 run on ``qmm_wgmma.cu`` (``QMM``, ``QMM_GROUP``), any
  other g on the CUDA-core ``qmm.cu`` (``QMM_GROUP_CORE``). A CPU tensor
  launches neither.
* The kernel multiplies on the tensor cores in bf16 and stays exact by
  splitting every f32 x into three bf16 pieces, x = hi + mid + lo. A numpy
  model of that split (round to nearest even, as ``cvt.rn.bf16x2.f32``) is
  held to it here.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.qmm import kernel as qmm_kernel
from repro_torch.kernels.qmm.ops import cuda_kernel, group_kernel, pack_weights, qmm


def bf16(x):
    """float32 -> the nearest bfloat16 (ties to even), as float32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    r = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16
    return r.astype(np.uint32).view(np.float32)


def split3(x):
    """hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each
    difference taken in float32 as the kernel's producer does."""
    x = np.asarray(x, np.float32)
    hi = bf16(x)
    r = (x - hi).astype(np.float32)
    mid = bf16(r)
    lo = bf16((r - mid).astype(np.float32))
    return hi, mid, lo


def full_mantissa(rng, n, lo_exp, hi_exp):
    """f32 values with random 24-bit significands, signs and exponents."""
    sig = rng.integers(2 ** 23, 2 ** 24, n).astype(np.float64)
    e = rng.integers(lo_exp, hi_exp + 1, n)
    sign = rng.choice([-1.0, 1.0], n)
    return (sign * np.ldexp(sig, e - 23)).astype(np.float32)


@pytest.mark.parametrize("g", [16, 32, 48, 64, 128, 1024])
def test_multiples_of_16_route_to_the_tensor_core_kernel(g):
    assert group_kernel(g) is qmm_kernel.QMM_GROUP
    assert qmm_kernel.QMM_GROUP.library.source.name == "qmm_wgmma.cu"
    assert qmm_kernel.QMM_GROUP.entry == "repro_qmm_group_tc"


@pytest.mark.parametrize("g", [1, 2, 4, 8, 24, 40, 72])
def test_other_group_sizes_route_to_the_cuda_core_kernel(g):
    assert group_kernel(g) is qmm_kernel.QMM_GROUP_CORE
    assert qmm_kernel.QMM_GROUP_CORE.library.source.name == "qmm.cu"
    assert qmm_kernel.QMM_GROUP_CORE.entry == "repro_qmm_group"


@pytest.mark.parametrize("granularity,want", [("per_tensor", "QMM"), ("per_channel", "QMM"),
                                              ("per_block:64", "QMM_GROUP"),
                                              ("per_block:16", "QMM_GROUP"),
                                              ("per_block:8", "QMM_GROUP_CORE")])
def test_route_of_packed_weights(granularity, want):
    w = pack_weights(torch.randn(16, 128), 4, granularity=granularity)
    assert cuda_kernel(w) is getattr(qmm_kernel, want)


def test_per_row_entry_is_in_the_tensor_core_library():
    assert qmm_kernel.QMM.library is qmm_kernel.LIBRARY
    assert qmm_kernel.LIBRARY.source.name == "qmm_wgmma.cu"
    assert qmm_kernel.SOURCE.is_file() and qmm_kernel.CORE_SOURCE.is_file()
    assert set(qmm_kernel.LIBRARY.entries) == {"repro_qmm_tc_splits", "repro_qmm_tc",
                                               "repro_qmm_group_tc"}
    assert set(qmm_kernel.CORE_LIBRARY.entries) == {"repro_qmm_group"}


@pytest.mark.parametrize("granularity", ["per_channel", "per_block:64", "per_block:8"])
def test_cpu_tensors_launch_no_kernel(granularity):
    kernels = (qmm_kernel.QMM, qmm_kernel.QMM_GROUP, qmm_kernel.QMM_GROUP_CORE)
    before = [k.launches for k in kernels]
    w = pack_weights(torch.randn(8, 64), 4, granularity=granularity)
    y = qmm(torch.randn(3, 64), w)
    assert y.shape == (3, 8)
    assert [k.launches for k in kernels] == before
    assert all(k._lib is None for k in kernels)


def test_group_wrappers_refuse_cpu_tensors_and_bad_group_sizes():
    w = pack_weights(torch.randn(16, 64), 4, granularity="per_block:8")
    with pytest.raises(ValueError, match="CUDA"):
        qmm_kernel.QMM_GROUP_CORE(torch.randn(2, 64), w.packed, w.scale, 4, 64, 8)
    with pytest.raises(ValueError, match="CUDA"):
        qmm_kernel.QMM_GROUP(torch.randn(2, 64), w.packed, w.scale, 4, 64, 8)
    assert qmm_kernel.QMM_GROUP.multiple == 16 and qmm_kernel.QMM_GROUP_CORE.multiple == 1


@pytest.mark.parametrize("lo_exp,hi_exp", [(-110, -60), (-60, -1), (-1, 30), (30, 126)])
def test_three_bf16_pieces_sum_exactly_to_x(lo_exp, hi_exp):
    """hi + mid + lo == x, exactly, for f32 x with full 24-bit significands
    over the exponent range the split covers: 2⁻¹¹⁰ ≤ |x| < 2¹²⁸ − 2¹¹⁹.

    The subnormal edge: below 2⁻¹¹⁰ the lo piece can fall under bfloat16's
    smallest subnormal (2⁻¹³³), where it rounds and the split is no longer
    exact (see the next test); at the top, bf16(x) overflows to inf from
    2¹²⁸ − 2¹¹⁹ on."""
    x = full_mantissa(np.random.default_rng(lo_exp + 200), 20000, lo_exp, hi_exp)
    hi, mid, lo = split3(x)
    assert np.all(np.isfinite(hi))
    # each piece is a bf16 value, and their sum is x exactly (float64 holds it)
    for p in (hi, mid, lo):
        assert np.array_equal(bf16(p), p)
    total = hi.astype(np.float64) + mid.astype(np.float64) + lo.astype(np.float64)
    assert np.array_equal(total, x.astype(np.float64))


def test_the_split_loses_bits_past_its_edges():
    """Below 2⁻¹¹⁰ the lo piece rounds (the subnormal edge) and at 2¹²⁸ − 2¹¹⁹
    hi overflows: the model shows both, so the stated range is the real one."""
    tiny = full_mantissa(np.random.default_rng(7), 5000, -125, -120)
    hi, mid, lo = split3(tiny)
    total = hi.astype(np.float64) + mid.astype(np.float64) + lo.astype(np.float64)
    assert not np.array_equal(total, tiny.astype(np.float64))
    top = np.float32(np.ldexp(2.0 ** 24 - 1, 127 - 23))   # the largest f32
    with np.errstate(invalid="ignore"):
        assert np.isinf(split3(np.array([top]))[0][0])


@pytest.mark.parametrize("c", [1, 3, 7, 37, 63, 64])
def test_one_nonzero_code_gives_one_rounding(c):
    """A row of Φ̂ with a single nonzero code c contributes c·hi, c·mid and
    c·lo, each exact in f32 (8 × 7 bits). The kernel sums them as
    hi + (mid + lo): mid + lo = x − hi has at most 16 significant bits, so
    c·(mid + lo) is exact and only the last sum rounds, giving fl(c·x) as
    the f32 reference does."""
    x = full_mantissa(np.random.default_rng(c), 20000, -20, 20)
    hi, mid, lo = split3(x)
    c = np.float32(c)
    ours = (c * hi + (c * mid + c * lo)).astype(np.float32)
    assert np.array_equal(ours, (c * x).astype(np.float32))
    # without lo the error is ~2⁻¹⁶ relative: far past one rounding, under 1e-5·|c x|
    no_lo = (c * hi + c * mid).astype(np.float32)
    rel = np.abs(no_lo.astype(np.float64) - c * x.astype(np.float64)) / np.abs(c * x)
    assert rel.max() > 2.0 ** -20 and rel.max() < 1e-5


def test_the_other_order_rounds_twice():
    """(hi + mid) + lo is not fl(c·x): when x − hi is small, hi + mid spans
    more than 24 bits, so c·(hi + mid) already rounds."""
    x = full_mantissa(np.random.default_rng(37), 20000, -20, 20)
    hi, mid, lo = split3(x)
    c = np.float32(37)
    other = ((c * hi + c * mid) + c * lo).astype(np.float32)
    assert not np.array_equal(other, (c * x).astype(np.float32))
