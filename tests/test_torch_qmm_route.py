"""The card's route for the packed matmul, and the arithmetic its tensor-core
kernel relies on, checked on the CPU.

* The route is fixed by the group size and the codes' alignment: per-row
  scales and ``per_block`` with g a multiple of 16 run on ``qmm_wgmma.cu``
  (``QMM``, ``QMM_GROUP``) when the codes start on a 16-byte boundary; any
  other g, and codes that do not (a row-slice view), on the CUDA-core
  ``qmm.cu``, which reads bytes (``QMM_CORE``, ``QMM_GROUP_CORE``). A CPU
  tensor launches none.
* The kernel multiplies on the tensor cores in bf16 and stays exact by
  splitting every f32 x into three bf16 pieces, x = hi + mid + lo. A row
  whose largest |x| lies outside [2^-40, 2^64) is first scaled by a power
  of two, 2^E, that puts its largest |x| in [2^64, 2^65). A numpy model of
  the prescale and the split (round to nearest even, as
  ``cvt.rn.bf16x2.f32``) is held to it here.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.qmm import kernel as qmm_kernel
from repro_torch.kernels.qmm.ops import (
    PackedWeights,
    cuda_kernel,
    group_kernel,
    pack_weights,
    qmm,
)


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


def row_exponent(row):
    """The power of two the kernel's producer scales an x row by
    (``row_exponent`` in ``qmm_wgmma.cu``): 0 when the row's largest |x| lies
    in [2^-40, 2^64) or the row is zero, else 64 - floor(log2 max|x|)."""
    m = float(np.abs(row).max())
    if m == 0.0:
        return 0
    e = np.frexp(m)[1] - 1
    return 0 if -40 <= e < 64 else 64 - e


def prescale(row):
    """The row times 2^E, in float32 (exact: the row's largest |x| lands in
    [2^-40, 2^65), nothing overflows and nothing of interest underflows)."""
    e = row_exponent(row)
    return np.ldexp(np.asarray(row, np.float32), e).astype(np.float32), e


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
    assert set(qmm_kernel.LIBRARY.entries) == {"repro_qmm_tc", "repro_qmm_group_tc",
                                               "repro_qmm_tc_batched_splits",
                                               "repro_qmm_tc_batched"}
    assert qmm_kernel.QMM_BATCHED.library is qmm_kernel.LIBRARY
    assert set(qmm_kernel.CORE_LIBRARY.entries) == {"repro_qmm", "repro_qmm_group"}


def test_expert_entry_is_in_its_own_library():
    assert qmm_kernel.QMM_EXPERTS.library is qmm_kernel.EXPERTS_LIBRARY
    assert qmm_kernel.EXPERTS_LIBRARY.source.name == "qmm_experts.cu"
    assert qmm_kernel.EXPERTS_SOURCE.is_file()
    assert set(qmm_kernel.EXPERTS_LIBRARY.entries) == {"repro_qmm_experts"}


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
    hi overflows: the model shows both, so the stated range is the real one.
    The kernel's prescale repairs both: a row of such x, times its 2^E,
    splits exactly, and 2^-E brings the pieces' sum back to x."""
    tiny = full_mantissa(np.random.default_rng(7), 5000, -125, -120)
    hi, mid, lo = split3(tiny)
    total = hi.astype(np.float64) + mid.astype(np.float64) + lo.astype(np.float64)
    assert not np.array_equal(total, tiny.astype(np.float64))
    top = np.float32(np.ldexp(2.0 ** 24 - 1, 127 - 23))   # the largest f32
    with np.errstate(invalid="ignore"):
        assert np.isinf(split3(np.array([top]))[0][0])
    big = full_mantissa(np.random.default_rng(8), 5000, 100, 126)
    big[17] = top
    for row in (tiny, big):
        scaled, e = prescale(row)
        hi, mid, lo = split3(scaled)
        assert np.all(np.isfinite(hi))
        total = hi.astype(np.float64) + mid.astype(np.float64) + lo.astype(np.float64)
        assert np.array_equal(np.ldexp(total, -e), row.astype(np.float64))


@pytest.mark.parametrize("seed", range(4))
def test_prescale_covers_every_finite_x(seed):
    """A row that spans the whole f32 range (2⁻¹²⁶ up to the largest f32):
    after the prescale its largest |x| lies in [2^64, 2^65), so sums keep
    their headroom, every x down to 2^-174 of the largest splits exactly,
    and what does not (only a row spanning more than 2^174 has such x)
    misses by at most 2^-134 in the scaled row: 2^-198 of the largest |x|."""
    rng = np.random.default_rng(seed)
    row = full_mantissa(rng, 20000, -126, 127)
    row[rng.integers(0, 20000, 3)] = np.float32(np.ldexp(2.0 ** 24 - 1, 127 - 23))
    row[rng.integers(0, 20000, 3)] = np.float32(2.0 ** -126)
    scaled, e = prescale(row)
    top = np.abs(scaled).max()
    assert 2.0 ** 64 <= top < 2.0 ** 65
    hi, mid, lo = split3(scaled)
    total = hi.astype(np.float64) + mid.astype(np.float64) + lo.astype(np.float64)
    want = np.ldexp(row.astype(np.float64), e)
    exact = np.abs(row.astype(np.float64)) >= float(np.abs(row).max()) * 2.0 ** -174
    assert exact.sum() > 10000 and (~exact).sum() > 1000
    assert np.array_equal(total[exact], want[exact])
    assert np.abs(total - want).max() <= 2.0 ** -134
    assert np.abs(total - want).max() <= 2.0 ** -198 * float(top)


@pytest.mark.parametrize("lo_exp,hi_exp,e", [(-125, -111, 175), (-60, -41, 105), (-90, -40, 0),
                                             (-20, 20, 0), (50, 63, 0), (100, 110, -46),
                                             (126, 127, -63)])
def test_row_exponent(lo_exp, hi_exp, e):
    """Rows whose largest |x| lies in [2^-40, 2^64) are split as they are:
    every x down to 2^-70 of the largest is then at least 2^-110, in the
    exact range, and sums stay below 2^101; other rows are scaled."""
    row = full_mantissa(np.random.default_rng(e + 100), 1000, lo_exp, hi_exp)
    row[0] = np.float32(np.ldexp(1.5, hi_exp))
    assert row_exponent(row) == e
    assert row_exponent(np.zeros(5, np.float32)) == 0


@pytest.mark.parametrize("seed", range(3))
def test_rows_in_the_window_split_exactly_unscaled(seed):
    """A row left unscaled (largest |x| in [2^-40, 2^64)): every x down to
    2^-70 of the largest splits exactly as it is."""
    rng = np.random.default_rng(seed)
    top = int(rng.integers(-40, 64))
    row = full_mantissa(rng, 20000, top - 70, top - 1)
    row[0] = np.float32(np.ldexp(1.0, top))
    assert row_exponent(row) == 0
    hi, mid, lo = split3(row)
    total = hi.astype(np.float64) + mid.astype(np.float64) + lo.astype(np.float64)
    assert np.array_equal(total, row.astype(np.float64))


def _misaligned(w, offset):
    """The same codes as a contiguous view that starts ``offset`` bytes into a
    larger buffer (as a row slice of a bigger packed operand would)."""
    buf = torch.zeros(offset + w.packed.numel() + 16, dtype=torch.uint8)
    view = buf[offset:offset + w.packed.numel()].view(w.packed.shape)
    view.copy_(w.packed)
    return PackedWeights(view, w.scale, w.bits, w.k_dim, w.granularity)


@pytest.mark.parametrize("offset", [1, 2, 8])
@pytest.mark.parametrize("granularity,want", [("per_tensor", "QMM_CORE"),
                                              ("per_channel", "QMM_CORE"),
                                              ("per_block:64", "QMM_GROUP_CORE"),
                                              ("per_block:8", "QMM_GROUP_CORE")])
def test_codes_off_a_16_byte_boundary_route_to_the_byte_load_kernel(offset, granularity, want):
    """No copy into an aligned buffer: a view that starts off a 16-byte
    boundary routes to the CUDA-core row walk of qmm.cu, which reads bytes."""
    w = _misaligned(pack_weights(torch.randn(16, 128), 4, granularity=granularity), offset)
    assert not qmm_kernel.tc_aligned(w.packed)
    assert cuda_kernel(w) is getattr(qmm_kernel, want)
    assert getattr(qmm_kernel, want).library.source.name == "qmm.cu"
    assert torch.equal(qmm(torch.ones(2, 128), w),
                       qmm(torch.ones(2, 128), _misaligned(w, 0)))
    if granularity == "per_block:64":
        assert group_kernel(64, w.packed) is qmm_kernel.QMM_GROUP_CORE
        assert group_kernel(64) is qmm_kernel.QMM_GROUP


def test_byte_load_route_refuses_cpu_tensors():
    w = pack_weights(torch.randn(16, 64), 4)
    with pytest.raises(ValueError, match="CUDA"):
        qmm_kernel.QMM_CORE(torch.randn(2, 64), w.packed, w.scale, 4, 64)
    assert qmm_kernel.QMM_CORE.launches == 0 and qmm_kernel.QMM_CORE.entry == "repro_qmm"


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
