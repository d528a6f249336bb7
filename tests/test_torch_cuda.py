"""Tests of the Hopper kernels that need the card (marker ``cuda``).

They skip on a machine without a GPU and nvcc; on the card run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance for qmm and qmm_group, as in the CPU tests: |Δ| ≤ 1e-5·|ref| +
1e-5·(|x|@|w|ᵀ) against the plain version, with TF32 off. Beside it, the
tensor-core kernel (``qmm_wgmma.cu``) is held to what a tolerance cannot
show: integer x equals the plain version bit for bit, rows of Φ̂ with one
nonzero code give fl(c·x) (bit for bit; 2 ulp grouped), and row b of an
M = 8 call equals the M = 1 call on row b. x at the edges of f32 (every |x|
below 2⁻¹¹⁰, the largest f32, rows spanning the whole range) is held to the
same rule, computed in float64, and where the plain version overflows the
kernel must give inf or nan in the same places. hist, mask, the fused H_s
and sqround equal their plain versions bit for bit. Flash attention: |Δ| ≤ 2e-4
(abs and rel) for float32 inputs (the CUDA-core kernels FLASH and
FLASH_UNALIGNED), 2e-2 for bfloat16 and float16 (the tensor-core kernels
FLASH_TC and FLASH_TC_UNALIGNED), the reference's kernel-vs-oracle bounds; for the 16-bit types also ‖Δ‖₂ ≤ 2⁻⁷·‖ref‖₂ for
every output row (one bfloat16 ulp, relative: the most that rounding both
results to bfloat16 can set them apart), which scales with the output where
2e-2 does not. Serving (``repro_torch.parallel``), bit for bit: a request's
row is the same in any slot of a table of co-tenants (dense f32 and packed
Φ̂ at 8 slots, packed at 24), ``serve_scheduled(verify=True)`` holds every
request to its ``reference_solve``, a splice leaves its input state and the
other rows alone, and pad rows stay zero through a segment. Sharding
(``repro_torch.parallel.dist``): two gloo ranks sharing the card solve the
LOFAR SMOKE batch to the one-device solve's bits.
"""
import math
import shutil
from pathlib import Path

import pytest
import torch

from repro_torch import random as prng
from repro_torch.core.niht import qniht_batch
from repro_torch.core.niht import qniht, solver_init, solver_segment
from repro_torch.kernels.flashattn import kernel as fa_kernel
from repro_torch.kernels.flashattn.ops import attention_plain, flash_attention
from repro_torch.kernels.hsthresh import kernel as hs_kernel
from repro_torch.kernels.hsthresh.ops import hsthresh
from repro_torch.kernels.hsthresh.ref import hist_ref, hsthresh_ref, mask_ref, row_vmax
from repro_torch.kernels.qmm import kernel as qmm_kernel
from repro_torch.kernels.qmm.ops import (
    PackedWeights,
    cuda_kernel,
    group_kernel,
    pack_operator,
    pack_weights,
    qmm,
)
from repro_torch.kernels.qmm.ref import qmm_group_ref, qmm_ref
from repro_torch.kernels.sqround import kernel as sq_kernel
from repro_torch.kernels.sqround.ops import sqround
from repro_torch.kernels.sqround.ref import sqround_ref
from repro_torch.quant.pack import pack_codes, unpack_codes
from repro_torch.quant.quantize import expand_block_scale

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    if shutil.which("nvcc") is None and not (Path("/usr/local/cuda/bin/nvcc")
                                             .exists()):
        pytest.skip("needs nvcc to build the kernel")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape", [(1, 870, 4096), (8, 4096, 870), (5, 333, 1001),
                                   (64, 64, 2048), (3, 7, 5), (64, 870, 65536),
                                   (64, 65536, 870), (1, 2048, 870)])
def test_kernel_matches_plain_version(cuda, bits, shape):
    m, n, k = shape
    gen = torch.Generator(device=cuda).manual_seed(m + n + k)
    w = pack_weights(torch.randn(n, k, generator=gen, device=cuda), bits, prng.PRNGKey(bits))
    x = torch.randn(m, k, generator=gen, device=cuda)
    before = qmm_kernel.QMM.launches
    y = qmm(x, w)
    assert qmm_kernel.QMM.launches == before + 1
    ref = qmm_ref(x, w.packed, w.scale, bits, k)
    wabs = unpack_codes(w.packed, bits, k).float().abs() * (w.scale.reshape(-1, 1) /
                                                           (2 ** (bits - 1) // 2))
    tol = 1e-5 * ref.abs() + 1e-5 * (x.abs() @ wabs.T)
    assert bool(((y - ref).abs() <= tol).all())


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("c", [1, 320])
@pytest.mark.parametrize("enk", [(16, 768, 2048), (16, 2048, 768), (3, 333, 1001)])
def test_batched_kernel_matches_plain_version(cuda, bits, c, enk):
    """QMM_BATCHED over a stack of E expert kernels (qwen3-moe-30b's wi and wo
    shapes; a ragged one whose rows are not 16-byte multiples) at a decode
    step's C = 1 and a prefill group's C = 320 slots an expert, one launch,
    held to qmm's rule against the per-expert plain version."""
    from repro_torch.kernels.qmm.ops import qmm_batched
    from repro_torch.kernels.qmm.ref import qmm_batched_ref
    from repro_torch.models.quantized import quantize_weight

    e, n, k = enk
    gen = torch.Generator(device=cuda).manual_seed(e + n + k + c)
    qw = quantize_weight(torch.randn(e, k, n, generator=gen, device=cuda) * 0.02, bits)
    x = torch.randn(e, c, k, generator=gen, device=cuda)
    x[0, 0] = 0.0                                  # an empty slot
    before = qmm_kernel.QMM_BATCHED.launches
    y = qmm_batched(x, qw.packed, qw.scale, bits, k)
    assert qmm_kernel.QMM_BATCHED.launches == before + 1 and y.shape == (e, c, n)
    ref = qmm_batched_ref(x, qw.packed, qw.scale, bits, k)
    wabs = unpack_codes(qw.packed, bits, k).float().abs() * (qw.scale / (2 ** (bits - 1) // 2))
    tol = 1e-5 * ref.abs() + 1e-5 * torch.matmul(x.abs(), wabs.transpose(-1, -2))
    assert bool(((y - ref).abs() <= tol).all())
    assert bool((y[0, 0] == 0).all())


def test_batched_kernel_rejects_bad_inputs(cuda):
    """Codes off a 16-byte boundary raise (there is no per-expert route), as
    do a scale of the wrong size and a stack of another length than x's."""
    from repro_torch.models.quantized import quantize_weight

    qw = quantize_weight(torch.randn(4, 64, 48, device=cuda), 4)
    x = torch.randn(4, 2, 64, device=cuda)
    raw = torch.empty(qw.packed.numel() + 16, dtype=torch.uint8, device=cuda)
    off = raw[1:1 + qw.packed.numel()].view(qw.packed.shape)
    off.copy_(qw.packed)
    with pytest.raises(ValueError, match="16-byte"):
        qmm_kernel.QMM_BATCHED(x, off, qw.scale, 4, 64)
    with pytest.raises(ValueError, match="scale"):
        qmm_kernel.QMM_BATCHED(x, qw.packed, qw.scale[:3], 4, 64)
    with pytest.raises(ValueError):
        qmm_kernel.QMM_BATCHED(x[:3], qw.packed, qw.scale, 4, 64)


# rows of each expert in use for the QMM_EXPERTS cases, from C and E: all C,
# none, a ragged prefix per expert (0 .. C), and values past either end
# (clamped to [0, C])
def _expert_rows(case, e, c, device):
    gen = torch.Generator().manual_seed(e + c)
    rows = {"full": torch.full((e,), c),
            "zero": torch.zeros(e, dtype=torch.int64),
            "ragged": torch.randint(0, c + 1, (e,), generator=gen),
            "past": torch.tensor([c + 5, -3, c, 2 ** 30] * (e // 4 + 1))[:e]}[case]
    return rows.to(torch.int32).to(device)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("c", [1, 7, 64, 160, 320, 512])
@pytest.mark.parametrize("rows_case", ["full", "zero", "ragged", "past"])
@pytest.mark.parametrize("enk", [(16, 768, 2048), (8, 2048, 768)])
def test_expert_kernel_matches_plain_version(cuda, bits, c, rows_case, enk):
    """QMM_EXPERTS over a stack of expert kernels (qwen3-moe-30b's wi and wo
    shapes) on bf16 x, one launch, held to qmm's rule against the plain
    version with the same rows in use; x's rows past them hold random
    values, which the rows contract writes as 0."""
    from repro_torch.kernels.qmm.ops import qmm_batched
    from repro_torch.kernels.qmm.ref import qmm_batched_ref
    from repro_torch.models.quantized import quantize_weight

    e, n, k = enk
    gen = torch.Generator(device=cuda).manual_seed(e + n + k + c + bits)
    qw = quantize_weight(torch.randn(e, k, n, generator=gen, device=cuda) * 0.02, bits)
    x = torch.randn(e, c, k, generator=gen, device=cuda).to(torch.bfloat16)
    rows = _expert_rows(rows_case, e, c, cuda)
    launched = (qmm_kernel.QMM_EXPERTS.launches, qmm_kernel.QMM_BATCHED.launches)
    y = qmm_batched(x, qw.packed, qw.scale, bits, k, rows)
    assert (qmm_kernel.QMM_EXPERTS.launches, qmm_kernel.QMM_BATCHED.launches) == (
        launched[0] + 1, launched[1]) and y.shape == (e, c, n) and y.dtype == torch.float32
    ref = qmm_batched_ref(x.float(), qw.packed, qw.scale, bits, k, rows)
    wabs = unpack_codes(qw.packed, bits, k).float().abs() * (qw.scale / (2 ** (bits - 1) // 2))
    tol = 1e-5 * ref.abs() + 1e-5 * torch.matmul(x.float().abs(), wabs.transpose(-1, -2))
    assert bool(((y - ref).abs() <= tol).all())
    in_use = torch.arange(c, device=cuda) < rows.clamp(0, c)[:, None]
    assert bool((y[~in_use] == 0).all())


@pytest.mark.parametrize("c", [1, 320])
def test_expert_kernel_is_deterministic_and_equals_the_full_product(cuda, c):
    """Two launches on the same inputs give the same bits (split-K parts at
    C = 1 are summed in a fixed order), and on x whose rows past ``rows``
    are zero, as dispatch leaves them, the result is the full product's."""
    from repro_torch.kernels.qmm.ops import qmm_batched
    from repro_torch.models.quantized import quantize_weight

    e, n, k = 128, 768, 2048
    gen = torch.Generator(device=cuda).manual_seed(c)
    qw = quantize_weight(torch.randn(e, k, n, generator=gen, device=cuda) * 0.02, 4)
    rows = _expert_rows("ragged", e, c, cuda)
    x = torch.randn(e, c, k, generator=gen, device=cuda).to(torch.bfloat16)
    x[~(torch.arange(c, device=cuda) < rows[:, None])] = 0
    y1 = qmm_batched(x, qw.packed, qw.scale, 4, k, rows)
    y2 = qmm_batched(x, qw.packed, qw.scale, 4, k, rows)
    full = qmm_batched(x, qw.packed, qw.scale, 4, k)
    assert torch.equal(y1, y2) and torch.equal(y1, full)


def test_expert_route_by_dtype_and_refusals(cuda):
    """qmm_batched routes bf16 x to QMM_EXPERTS, float32 x to QMM_BATCHED
    (rows ignored), and refuses other dtypes; QMM_EXPERTS refuses f16 x,
    codes off a 16-byte boundary, rows on the CPU or of another shape, and
    rows of x or codes that TMA cannot stride."""
    from repro_torch.kernels.qmm.ops import qmm_batched
    from repro_torch.kernels.qmm.ref import qmm_batched_ref
    from repro_torch.models.quantized import quantize_weight

    qw = quantize_weight(torch.randn(4, 64, 48, device=cuda), 4)
    x = torch.randn(4, 3, 64, device=cuda)
    rows = torch.tensor([3, 0, 1, 2], dtype=torch.int32, device=cuda)
    kernels = (qmm_kernel.QMM_EXPERTS, qmm_kernel.QMM_BATCHED)
    before = [kk.launches for kk in kernels]
    y32 = qmm_batched(x, qw.packed, qw.scale, 4, 64, rows)
    assert [kk.launches for kk in kernels] == [before[0], before[1] + 1]
    assert bool((y32[1] != 0).any())                    # float32 computes every row
    yb = qmm_batched(x.to(torch.bfloat16), qw.packed, qw.scale, 4, 64, rows)
    assert [kk.launches for kk in kernels] == [before[0] + 1, before[1] + 1]
    ref = qmm_batched_ref(x.to(torch.bfloat16).float(), qw.packed, qw.scale, 4, 64, rows)
    assert bool(((yb - ref).abs() <= 1e-5 * ref.abs() + 1e-6).all())
    with pytest.raises(TypeError):
        qmm_batched(x.half(), qw.packed, qw.scale, 4, 64, rows)
    xb = x.to(torch.bfloat16)
    with pytest.raises(TypeError):
        qmm_kernel.QMM_EXPERTS(x.half(), qw.packed, qw.scale, 4, 64, rows)
    raw = torch.empty(qw.packed.numel() + 16, dtype=torch.uint8, device=cuda)
    off = raw[1:1 + qw.packed.numel()].view(qw.packed.shape)
    off.copy_(qw.packed)
    with pytest.raises(ValueError, match="16-byte"):
        qmm_kernel.QMM_EXPERTS(xb, off, qw.scale, 4, 64, rows)
    with pytest.raises(ValueError, match="CUDA"):
        qmm_kernel.QMM_EXPERTS(xb, qw.packed, qw.scale, 4, 64, rows.cpu())
    with pytest.raises(ValueError, match="rows"):
        qmm_kernel.QMM_EXPERTS(xb, qw.packed, qw.scale, 4, 64, rows[:3])
    with pytest.raises(TypeError):
        qmm_kernel.QMM_EXPERTS(xb, qw.packed, qw.scale, 4, 64, rows.long())
    odd = quantize_weight(torch.randn(4, 36, 48, device=cuda), 4)      # K = 36, Kp = 18
    with pytest.raises(ValueError, match="multiple"):
        qmm_kernel.QMM_EXPERTS(torch.zeros(4, 3, 36, dtype=torch.bfloat16, device=cuda),
                               odd.packed, odd.scale, 4, 36, rows)


def test_expert_products_make_no_host_sync(cuda):
    """moe.expert_product on the kernel route (a W4 stack, bf16 x, rows on
    the card) makes no device-to-host copy: the host never reads rows."""
    from repro_torch.models import moe
    from repro_torch.models.quantized import quantize_weight

    w = quantize_weight(torch.randn(8, 256, 128, device=cuda) * 0.02, 4)
    x = torch.randn(8, 5, 256, device=cuda).to(torch.bfloat16)
    rows = torch.tensor([5, 0, 3, 1, 5, 2, 0, 4], dtype=torch.int32, device=cuda)
    moe.expert_product(x, w, torch.bfloat16, rows)               # build and warm up
    before = qmm_kernel.QMM_EXPERTS.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = moe.expert_product(x, w, torch.bfloat16, rows)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert qmm_kernel.QMM_EXPERTS.launches == before + 1 and y.dtype == torch.bfloat16


def test_kernel_rejects_bad_inputs(cuda):
    w = pack_weights(torch.randn(16, 40, device=cuda), 4)
    with pytest.raises(TypeError):
        qmm_kernel.qmm_cuda(torch.randn(2, 40, device=cuda, dtype=torch.float64),
                            w.packed, w.scale, 4, 40)
    with pytest.raises(ValueError):
        qmm_kernel.qmm_cuda(torch.randn(2, 41, device=cuda), w.packed, w.scale, 4, 41)
    with pytest.raises(ValueError):
        qmm_kernel.qmm_cuda(torch.randn(40, 2, device=cuda).T, w.packed, w.scale, 4, 40)


def test_packed_solve_on_card_matches_cpu(cuda):
    """The same complex problem, packed, on the card and on the CPU."""
    gen = torch.Generator().manual_seed(0)
    phi = torch.complex(torch.randn(48, 96, generator=gen), torch.randn(48, 96, generator=gen))
    x = torch.zeros(2, 96)
    x[0, :4] = torch.tensor([1.0, 0.8, 0.5, 0.3])
    x[1, 10:14] = torch.tensor([0.9, 0.7, 0.6, 0.2])
    Y = x.to(phi.dtype) @ phi.T
    kw = dict(bits_phi=8, bits_y=8, key=prng.PRNGKey(1), requantize="fixed",
              backend="packed", real_signal=True)
    before = qmm_kernel.QMM.launches
    r_gpu = qniht_batch(phi.to(cuda), Y.to(cuda), 4, 25, **kw)
    assert qmm_kernel.QMM.launches > before
    r_cpu = qniht_batch(phi, Y, 4, 25, **kw)
    ref = float(torch.linalg.vector_norm(r_cpu.x))
    assert float(torch.linalg.vector_norm(r_gpu.x.cpu() - r_cpu.x)) <= 1e-3 * ref
    assert torch.equal(r_gpu.x.cpu() != 0, r_cpu.x != 0)


def test_pack_operator_on_card_matches_cpu(cuda):
    """The PRNG and packing run as tensor ops on the card: same bytes."""
    phi = torch.randn(40, 72, generator=torch.Generator().manual_seed(3))
    key = prng.PRNGKey(9)
    a = pack_operator(phi, 2, key, shared=True)
    b = pack_operator(phi.to(cuda), 2, key, shared=True)
    assert torch.equal(a.fwd_re.packed, b.fwd_re.packed.cpu())
    assert torch.equal(a.adj_re.packed, b.adj_re.packed.cpu())


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("g", [None, 64])
@pytest.mark.parametrize("shape", [(1, 870, 4096), (8, 4096, 870), (5, 333, 1001), (3, 7, 5)])
def test_group_kernel_matches_plain_version(cuda, bits, g, shape):
    m, n, k = shape
    g = 8 // bits if g is None else g
    gen = torch.Generator(device=cuda).manual_seed(m + n + k + g)
    w = pack_weights(torch.randn(n, k, generator=gen, device=cuda), bits, prng.PRNGKey(bits),
                     granularity=f"per_block:{g}")
    x = torch.randn(m, k, generator=gen, device=cuda)
    routed = group_kernel(g)          # g = 64 on the tensor cores, g = 8 // bits on qmm.cu
    kernels = (qmm_kernel.QMM, qmm_kernel.QMM_GROUP, qmm_kernel.QMM_GROUP_CORE)
    before = [k.launches for k in kernels]
    y = qmm(x, w)
    assert [k.launches for k in kernels] == [b + (k is routed) for k, b in zip(kernels, before)]
    ref = qmm_group_ref(x, w.packed, w.scale, bits, k, g)
    wabs = (unpack_codes(w.packed, bits, k).float().abs() * expand_block_scale(w.scale, g, k)
            / (2 ** (bits - 1) // 2))
    tol = 1e-5 * ref.abs() + 1e-5 * (x.abs() @ wabs.T)
    assert bool(((y - ref).abs() <= tol).all())


def test_group_kernel_rejects_bad_inputs(cuda):
    w = pack_weights(torch.randn(16, 40, device=cuda), 4, granularity="per_block:8")
    x = torch.randn(2, 40, device=cuda)
    with pytest.raises(ValueError):
        qmm_kernel.qmm_group_cuda(x, w.packed, w.scale, 4, 40, 3)
    with pytest.raises(ValueError):       # g = 8 is not the tensor-core kernel's
        qmm_kernel.qmm_group_cuda(x, w.packed, w.scale, 4, 40, 8)
    with pytest.raises(ValueError):
        qmm_kernel.QMM_GROUP_CORE(x, w.packed, w.scale[:, :2].contiguous(), 4, 40, 8)
    w16 = pack_weights(torch.randn(16, 40, device=cuda), 4, granularity="per_block:16")
    with pytest.raises(ValueError):
        qmm_kernel.qmm_group_cuda(x, w16.packed, w16.scale[:, :2].contiguous(), 4, 40, 16)


# the LOFAR CS302 orientations: 870 baselines x 65,536 pixels, 16,384-byte
# (TMA) rows forward, 218-byte rows (2 bits) in the adjoint
LOFAR_SHAPES = [(870, 65536), (65536, 870)]


def _onehot_codes(gen, n, k, bits, device):
    kh = 2 ** (bits - 1) // 2
    codes = torch.zeros(n, k, dtype=torch.int8, device=device)
    sign = torch.randint(0, 2, (n,), generator=gen, device=device) * 2 - 1
    value = (torch.randint(1, kh + 1, (n,), generator=gen, device=device) * sign).to(torch.int8)
    codes[torch.arange(n, device=device),
          torch.randint(0, k, (n,), generator=gen, device=device)] = value
    return codes


def _ulps(got, want):
    _, e = torch.frexp(want)
    return float(((got - want).abs() / torch.ldexp(torch.ones_like(want), e - 24)).max())


@pytest.mark.parametrize("bits", [2, 8])
@pytest.mark.parametrize("nk", LOFAR_SHAPES)
@pytest.mark.parametrize("m", [1, 8, 64])
def test_integer_x_is_bit_for_bit(cuda, bits, nk, m):
    """Σ|x|·|c − K_h| < 2²⁴ in every row: every partial sum is exact in f32."""
    n, k = nk
    kh = 2 ** (bits - 1) // 2
    gen = torch.Generator(device=cuda).manual_seed(bits * m + n)
    codes = torch.randint(-kh, kh + 1, (n, k), generator=gen, device=cuda,
                          dtype=torch.int32).to(torch.int8)
    packed = pack_codes(codes, bits)
    x = torch.randint(-2, 3, (m, k), generator=gen, device=cuda).float()
    scale = torch.rand(n, generator=gen, device=cuda) + 0.5
    assert torch.equal(qmm_kernel.QMM(x, packed, scale, bits, k),
                       qmm_ref(x, packed, scale, bits, k))
    g = 64                                  # power-of-two scales {1/2, 1}, |x| <= 1
    gscale = 2.0 ** -torch.randint(0, 2, (n, (k + g - 1) // g), generator=gen,
                                   device=cuda).float()
    x1 = x.clamp(-1, 1)
    assert torch.equal(qmm_kernel.QMM_GROUP(x1, packed, gscale, bits, k, g),
                       qmm_group_ref(x1, packed, gscale, bits, k, g))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("nk", LOFAR_SHAPES)
def test_one_nonzero_code_per_row(cuda, bits, nk):
    """A row with one nonzero code c gives fl(c·x) for full-mantissa x: the
    three bf16 pieces of x all count (dropping lo misses by ~2⁻¹⁶)."""
    n, k = nk
    gen = torch.Generator(device=cuda).manual_seed(bits + n)
    packed = pack_codes(_onehot_codes(gen, n, k, bits, cuda), bits)
    x = torch.randn(8, k, generator=gen, device=cuda) * 3.7
    scale = torch.rand(n, generator=gen, device=cuda) + 0.5
    assert torch.equal(qmm_kernel.QMM(x, packed, scale, bits, k),
                       qmm_ref(x, packed, scale, bits, k))
    gscale = torch.rand(n, (k + 63) // 64, generator=gen, device=cuda) + 0.5
    assert _ulps(qmm_kernel.QMM_GROUP(x, packed, gscale, bits, k, 64),
                 qmm_group_ref(x, packed, gscale, bits, k, 64)) <= 2.0


@pytest.mark.parametrize("bits", [2, 8])
@pytest.mark.parametrize("nk", LOFAR_SHAPES + [(333, 1001)])
@pytest.mark.parametrize("g", [None, 64, 16])
def test_batch_rows_equal_single_rows(cuda, bits, nk, g):
    """Row b of an M = 8 call computes, bit for bit, what M = 1 does."""
    n, k = nk
    gen = torch.Generator(device=cuda).manual_seed(bits + n + (g or 0))
    gran = "per_channel" if g is None else f"per_block:{g}"
    w = pack_weights(torch.randn(n, k, generator=gen, device=cuda), bits, prng.PRNGKey(bits),
                     granularity=gran)
    x = torch.randn(8, k, generator=gen, device=cuda)
    y = qmm(x, w)
    assert torch.equal(y, torch.cat([qmm(x[b:b + 1].contiguous(), w) for b in range(8)]))


FLT_MAX = torch.finfo(torch.float32).max


def _edge_x(kind, m, k, gen, device):
    """x at the edges of the three-piece split: every |x| in [2⁻¹²⁵, 2⁻¹¹⁰)
    ("tiny"); rows whose largest |x| is the largest f32 over x near 2⁸⁰
    ("top"); rows spanning the whole range, 2⁻¹²⁶ to the largest f32
    ("mixed"); rows with two entries of the largest f32, whose sums overflow
    where their codes agree in sign and add up past 1 ("overflow")."""
    sign = torch.where(torch.rand(m, k, generator=gen, device=device) < 0.5, -1.0, 1.0)
    mant = 1.0 + torch.rand(m, k, generator=gen, device=device)

    def pick(lo, hi):
        e = torch.randint(lo, hi, (m, k), generator=gen, device=device).float()
        return sign * mant * torch.exp2(e)
    rows = torch.arange(m, device=device)
    cols = lambda: torch.randint(0, k, (m,), generator=gen, device=device)  # noqa: E731
    if kind == "tiny":
        return pick(-125, -110)
    if kind == "top":
        x = torch.randn(m, k, generator=gen, device=device) * 2.0 ** 80
        x[rows, cols()] = FLT_MAX * sign[:, 0]
        return x
    if kind == "mixed":
        x = pick(-126, 80)
        x[rows, cols()] = FLT_MAX * sign[:, 1]
        x[rows, cols()] = 2.0 ** -126
        return x
    x = torch.randn(m, k, generator=gen, device=device)
    c0 = cols()
    x[rows, c0] = FLT_MAX
    x[rows, (c0 + 1 + cols() % (k - 1)) % k] = FLT_MAX
    return x


def _hold_edges(y, ref, x, wabs):
    """The 1e-5 rule, computed in float64 (so that |x|@|w| does not overflow
    to an infinite tolerance), where the plain version is finite; inf or nan
    in the same places where it is not."""
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(y), fin), int((torch.isfinite(y) != fin).sum())
    tol = 1e-5 * ref.double().abs() + 1e-5 * (x.double().abs() @ wabs.double().T)
    err = (y.double() - ref.double()).abs()
    assert bool((err[fin] <= tol[fin]).all()), float((err - tol)[fin].max())


@pytest.mark.parametrize("bits", [2, 8])
@pytest.mark.parametrize("nk", LOFAR_SHAPES)
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("kind", ["tiny", "top", "mixed", "overflow"])
def test_split_edges_follow_the_plain_version(cuda, bits, nk, m, kind):
    """x at both edges of the three-piece split, through QMM and QMM_GROUP
    (g = 64), at the LOFAR shapes: the per-row power-of-two prescale keeps
    every finite x exact where it counts (rows of tiny x no longer lose their
    lo piece, the largest f32 no longer splits into inf)."""
    n, k = nk
    kh = 2 ** (bits - 1) // 2
    gen = torch.Generator(device=cuda).manual_seed(bits + n + m)
    codes = torch.randint(-kh, kh + 1, (n, k), generator=gen, device=cuda,
                          dtype=torch.int32).to(torch.int8)
    packed = pack_codes(codes, bits)
    scale = torch.rand(n, generator=gen, device=cuda) * 0.25 + 0.5
    gscale = torch.rand(n, (k + 63) // 64, generator=gen, device=cuda) * 0.25 + 0.5
    x = _edge_x(kind, m, k, gen, cuda)
    wabs = codes.float().abs() * (scale[:, None] / kh)
    before = qmm_kernel.QMM.launches
    _hold_edges(qmm_kernel.qmm_cuda(x, packed, scale, bits, k),
                qmm_ref(x, packed, scale, bits, k), x, wabs)
    assert qmm_kernel.QMM.launches == before + 1
    gabs = codes.float().abs() * expand_block_scale(gscale, 64, k) / kh
    _hold_edges(qmm_kernel.QMM_GROUP(x, packed, gscale, bits, k, 64),
                qmm_group_ref(x, packed, gscale, bits, k, 64), x, gabs)
    if kind == "overflow":            # the case is real: some outputs overflow, not all
        ref = qmm_ref(x, packed, scale, bits, k)
        assert 0 < int((~torch.isfinite(ref)).sum()) < ref.numel()


@pytest.mark.parametrize("kind", ["tiny", "mixed", "top"])
def test_split_edges_past_the_first_ranges_of_a_block(cuda, kind):
    """M = 200 at the LOFAR forward shape gives a block more than four x
    ranges (m-tile, split): the consumers take the first four ranges' row
    maxima up front and the producer takes the later ones itself. Both
    must scale the edge rows."""
    n, k = LOFAR_SHAPES[0]
    gen = torch.Generator(device=cuda).manual_seed(200)
    codes = torch.randint(-1, 2, (n, k), generator=gen, device=cuda,
                          dtype=torch.int32).to(torch.int8)
    packed = pack_codes(codes, 2)
    scale = torch.rand(n, generator=gen, device=cuda) * 0.25 + 0.5
    x = _edge_x(kind, 200, k, gen, cuda)
    _hold_edges(qmm_kernel.QMM(x, packed, scale, 2, k), qmm_ref(x, packed, scale, 2, k), x,
                codes.float().abs() * scale[:, None])


def _codes_at(packed, offset):
    """The same codes as a contiguous view that starts ``offset`` bytes into a
    larger buffer (the start of a row slice of a bigger packed operand)."""
    buf = torch.zeros(offset + packed.numel() + 16, dtype=torch.uint8, device=packed.device)
    view = buf[offset:offset + packed.numel()].view(packed.shape)
    view.copy_(packed)
    return view


@pytest.mark.parametrize("offset", [1, 2, 8])
@pytest.mark.parametrize("bits", [2, 8])
@pytest.mark.parametrize("shape", [(1, 870, 65536), (8, 65536, 870), (5, 333, 1001)])
@pytest.mark.parametrize("g", [None, 64])
def test_misaligned_codes_take_the_byte_load_route(cuda, offset, bits, shape, g):
    """Codes that start off a 16-byte boundary compute on the CUDA-core row
    walk (QMM_CORE per row, QMM_GROUP_CORE grouped), launched once, never
    the tensor-core kernel, and agree with the plain version."""
    m, n, k = shape
    gen = torch.Generator(device=cuda).manual_seed(offset + bits + n)
    gran = "per_channel" if g is None else f"per_block:{g}"
    w0 = pack_weights(torch.randn(n, k, generator=gen, device=cuda), bits, prng.PRNGKey(bits),
                      granularity=gran)
    w = PackedWeights(_codes_at(w0.packed, offset), w0.scale, bits, k, w0.granularity)
    assert w.packed.data_ptr() % 16
    x = torch.randn(m, k, generator=gen, device=cuda)
    routed = qmm_kernel.QMM_CORE if g is None else qmm_kernel.QMM_GROUP_CORE
    assert cuda_kernel(w) is routed
    kernels = (qmm_kernel.QMM, qmm_kernel.QMM_GROUP, qmm_kernel.QMM_CORE,
               qmm_kernel.QMM_GROUP_CORE)
    before = [kk.launches for kk in kernels]
    y = qmm(x, w)
    assert [kk.launches for kk in kernels] == [b + (kk is routed) for kk, b in
                                               zip(kernels, before)]
    kh = 2 ** (bits - 1) // 2
    if g is None:
        ref = qmm_ref(x, w.packed, w.scale, bits, k)
        wabs = unpack_codes(w.packed, bits, k).float().abs() * (w.scale.reshape(-1, 1) / kh)
    else:
        ref = qmm_group_ref(x, w.packed, w.scale, bits, k, g)
        wabs = (unpack_codes(w.packed, bits, k).float().abs()
                * expand_block_scale(w.scale, g, k) / kh)
    assert bool(((y - ref).abs() <= 1e-5 * ref.abs() + 1e-5 * (x.abs() @ wabs.T)).all())
    # the kernel-level entry points route the same way
    direct = (qmm_kernel.qmm_cuda(x, w.packed, w.scale, bits, k) if g is None else
              qmm_kernel.qmm_group_cuda(x, w.packed, w.scale, bits, k, g))
    assert torch.equal(direct, y)


def test_group_size_8_runs_on_the_cuda_core_kernel(cuda):
    """g = 8 is no multiple of 16: the route sends it to qmm.cu's kernel,
    whose counter alone moves."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    w = pack_weights(torch.randn(333, 1001, generator=gen, device=cuda), 4, prng.PRNGKey(4),
                     granularity="per_block:8")
    assert cuda_kernel(w) is qmm_kernel.QMM_GROUP_CORE
    x = torch.randn(5, 1001, generator=gen, device=cuda)
    before = (qmm_kernel.QMM_GROUP.launches, qmm_kernel.QMM_GROUP_CORE.launches)
    y = qmm(x, w)
    assert (qmm_kernel.QMM_GROUP.launches,
            qmm_kernel.QMM_GROUP_CORE.launches) == (before[0], before[1] + 1)
    ref = qmm_group_ref(x, w.packed, w.scale, 4, 1001, 8)
    wabs = unpack_codes(w.packed, 4, 1001).float().abs() * expand_block_scale(w.scale, 8, 1001) / 4
    assert bool(((y - ref).abs() <= 1e-5 * ref.abs() + 1e-5 * (x.abs() @ wabs.T)).all())


@pytest.mark.parametrize("shape", [(1, 65536), (8, 65536), (3, 1001), (2, 5)])
@pytest.mark.parametrize("kind", ["normal", "flat", "sparse"])
def test_hist_and_mask_equal_plain_versions(cuda, shape, kind):
    gen = torch.Generator(device=cuda).manual_seed(shape[0] * shape[1])
    x = torch.randn(*shape, generator=gen, device=cuda)
    if kind == "flat":
        x = torch.ones_like(x)
    elif kind == "sparse":
        x = torch.clamp_min(x, 0.0) ** 3
    vmax = row_vmax(x.abs())
    h = hs_kernel.hist_cuda(x, vmax, 2048)
    assert torch.equal(h, hist_ref(x.abs(), vmax, 2048))
    assert int(h.sum()) == x.numel()
    t = vmax * 0.3
    assert torch.equal(hs_kernel.mask_cuda(x, t), mask_ref(x, t))


def test_hsthresh_on_card_equals_cpu(cuda):
    """hsthresh on a CUDA tensor is one launch of the fused kernel, and no
    hist or mask launch; its output equals the CPU's plain chain."""
    x = torch.randn(5, 3000, generator=torch.Generator().manual_seed(1))
    before = (hs_kernel.HSTHRESH.launches, hs_kernel.HIST.launches, hs_kernel.MASK.launches)
    out = hsthresh(x.to(cuda), 17)
    assert (hs_kernel.HSTHRESH.launches, hs_kernel.HIST.launches,
            hs_kernel.MASK.launches) == (before[0] + 1, before[1], before[2])
    assert torch.equal(out.cpu(), hsthresh(x, 17))


def _hs_rows(kind, b, n, gen, device):
    """Rows for the fused H_s: generic, the projected iterate's nonnegative
    half-zero rows, threshold-bin ties straddling the cluster's chunk
    boundaries (8,192 elements apart), a flat row, an all-zero row."""
    x = torch.randn(b, n, generator=gen, device=device)
    if kind == "sparse":
        x = torch.clamp_min(x, 0.0)
    elif kind == "straddle":
        x = x * 0.1
        for edge in range(0, n, 8192):
            a, e = max(0, edge - 6), min(n, edge + 6)
            x[:, a:e] = torch.where(torch.rand(b, e - a, generator=gen, device=device) < 0.5,
                                    1.0, -1.0)
    elif kind == "flat":
        x = torch.full((b, n), -0.75, device=device)
    elif kind == "zeros":
        x = torch.zeros(b, n, device=device)
    return x


@pytest.mark.parametrize("shape", [(1, 65536), (8, 65536), (3, 1001), (2, 2 ** 22), (4, 20)])
@pytest.mark.parametrize("kind", ["generic", "sparse", "straddle", "flat", "zeros"])
@pytest.mark.parametrize("s", [30, 1001])
def test_fused_hsthresh_equals_plain_version(cuda, shape, kind, s):
    """The fused kernel equals hsthresh_ref bit for bit (nbins 2,048) in one
    launch per call: one-chunk and eight-chunk clusters, rows resident in
    shared memory and a 2²² row streamed from global memory, ties across
    chunk edges, flat and all-zero rows, and N <= s."""
    gen = torch.Generator(device=cuda).manual_seed(shape[0] + shape[1] + s)
    x = _hs_rows(kind, *shape, gen, cuda)
    before = hs_kernel.HSTHRESH.launches
    y = hs_kernel.hsthresh_cuda(x, s, 2048)
    assert hs_kernel.HSTHRESH.launches == before + 1
    want = hsthresh_ref(x, s, 2048)
    torch.cuda.synchronize()
    assert torch.equal(y, want), int((y != want).sum())
    assert int((y != 0).sum(dim=1).max()) <= s


@pytest.mark.parametrize("nbins", [1, 12288])
@pytest.mark.parametrize("shape", [(2, 65536), (3, 1001)])
@pytest.mark.parametrize("s", [0, 30])
def test_fused_hsthresh_at_the_bin_counts_it_takes(cuda, nbins, shape, s):
    """The fewest and the most bins the kernel takes (12,288: 48 KB of
    counters in each CTA beside its chunk), and s = 0."""
    gen = torch.Generator(device=cuda).manual_seed(nbins + shape[1] + s)
    x = torch.randn(*shape, generator=gen, device=cuda)
    assert torch.equal(hs_kernel.hsthresh_cuda(x, s, nbins), hsthresh_ref(x, s, nbins))


def test_fused_hsthresh_off_the_vector_boundary(cuda):
    """A batch whose rows start anywhere (N odd, and a view one element into
    its storage): the bulk copy takes each chunk's aligned middle, plain
    loads the ends."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    flat = torch.randn(1 + 3 * 65537, generator=gen, device=cuda)
    x = flat[1:].view(3, 65537)
    assert torch.equal(hs_kernel.hsthresh_cuda(x, 30, 2048), hsthresh_ref(x, 30, 2048))


@pytest.mark.parametrize("kw", [dict(threshold="hsthresh"),
                                dict(scale_granularity="per_block", group_size=16),
                                dict(scale_granularity="per_channel")])
def test_slice2_solves_on_card_match_cpu(cuda, kw):
    """The real-signal complex path, packed, on the card and on the CPU."""
    gen = torch.Generator().manual_seed(0)
    phi = torch.complex(torch.randn(48, 96, generator=gen), torch.randn(48, 96, generator=gen))
    x = torch.zeros(96)
    x[:4] = torch.tensor([1.0, 0.8, 0.5, 0.3])
    y = x.to(phi.dtype) @ phi.T
    args = dict(bits_phi=8, bits_y=8, key=prng.PRNGKey(1), requantize="fixed",
                backend="packed", real_signal=True, nonneg=True, **kw)
    r_gpu = qniht(phi.to(cuda), y.to(cuda), 4, 25, **args)
    r_cpu = qniht(phi, y, 4, 25, **args)
    ref = float(torch.linalg.vector_norm(r_cpu.x))
    assert float(torch.linalg.vector_norm(r_gpu.x.cpu() - r_cpu.x)) <= 1e-3 * ref
    assert torch.equal(r_gpu.x.cpu() != 0, r_cpu.x != 0)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape", [(1, 1), (512, 512), (333, 1001), (870, 4096)])
def test_sqround_kernel_equals_plain_version(cuda, bits, shape):
    gen = torch.Generator(device=cuda).manual_seed(shape[0] + bits)
    v = torch.randn(*shape, generator=gen, device=cuda) * 3.0
    key = prng.PRNGKey(bits + shape[1])
    before = sq_kernel.SQROUND.launches
    codes, scale = sqround(v, bits, key)
    assert sq_kernel.SQROUND.launches == before + 1
    u = prng.bits(key, shape, device=cuda)
    assert torch.equal(codes, sqround_ref(v, u, scale, bits))
    codes_cpu, scale_cpu = sqround(v.cpu(), bits, key)
    assert torch.equal(codes.cpu(), codes_cpu) and scale.item() == scale_cpu.item()


def test_sqround_kernel_off_the_vector_boundary(cuda):
    """A view that starts one element into its storage takes the scalar loop."""
    flat = torch.randn(1 + 37 * 41, device=cuda)
    v = flat[1:].view(37, 41)
    u = prng.bits(prng.PRNGKey(3), v.shape, device=cuda)
    scale = v.abs().amax()
    for bits in (2, 4, 8):
        assert torch.equal(sq_kernel.sqround_cuda(v, u, scale, bits),
                           sqround_ref(v, u, scale, bits))


# (B, Hq, Hkv, Sq, Sk, D): ragged, causal cross, starcoder2-3b SMOKE and full
# head widths, no GQA, one query row
FLASH_SHAPES = [(2, 4, 2, 333, 333, 64), (1, 4, 2, 64, 256, 32), (2, 4, 2, 64, 64, 16),
                (1, 24, 2, 300, 300, 128), (2, 8, 8, 128, 128, 64), (1, 2, 1, 1, 77, 32)]


def _flash_held(q, k, v, causal, tol):
    """flash_attention on the card, launched once on the kernel of q's dtype
    (FLASH for float32, FLASH_TC for bfloat16 and float16) and none on the
    other, held to the plain version: |Δ| ≤ tol (abs and rel), and 16-bit
    rows ‖Δ‖₂ ≤ 2⁻⁷·‖ref‖₂."""
    kernel, other = ((fa_kernel.FLASH, fa_kernel.FLASH_TC) if q.dtype == torch.float32
                     else (fa_kernel.FLASH_TC, fa_kernel.FLASH))
    before, before_other = kernel.launches, other.launches
    out = flash_attention(q, k, v, causal=causal)
    assert kernel.launches == before + 1 and other.launches == before_other
    assert out.dtype == q.dtype and out.shape == q.shape
    ref = attention_plain(q, k, v, causal=causal, scale=1.0 / math.sqrt(q.shape[-1]))
    err = (out.float() - ref.float()).abs()
    assert bool((err <= tol + tol * ref.float().abs()).all()), float(err.max())
    if q.dtype != torch.float32:
        row_rel = err.norm(dim=-1) / ref.float().norm(dim=-1)
        assert float(row_rel.max()) <= 2.0 ** -7, float(row_rel.max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_attention_kernel_matches_plain_version(cuda, dtype, tol, causal, shape):
    b, hq, hkv, sq, sk, d = shape
    gen = torch.Generator(device=cuda).manual_seed(sq + sk + d)
    q = torch.randn(b, hq, sq, d, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, hkv, sk, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, hkv, sk, d, generator=gen, device=cuda).to(dtype)
    _flash_held(q, k, v, causal, tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_tensor_cores_at_starcoder2_width(cuda, dtype):
    """starcoder2-3b's attention (24 query heads on 2 KV heads, D = 128),
    causal, S = 4,096: 32 KV tiles per late query tile through the ring."""
    gen = torch.Generator(device=cuda).manual_seed(4096)
    q, k, v = (torch.randn(1, h, 4096, 128, generator=gen, device=cuda).to(dtype)
               for h in (24, 2, 2))
    _flash_held(q, k, v, True, 2e-2)


def _launched_once(kernel, fn):
    """fn() launches ``kernel`` once and no other flash attention kernel."""
    before = [kk.launches for kk in fa_kernel.KERNELS]
    out = fn()
    assert [kk.launches for kk in fa_kernel.KERNELS] == [
        b + (kk is kernel) for kk, b in zip(fa_kernel.KERNELS, before)]
    return out


def _flash_view(t, offset):
    """t as a contiguous view that starts ``offset`` elements into a larger
    tensor (no copy of it is ever made by the route)."""
    flat = torch.zeros(offset + t.numel(), dtype=t.dtype, device=t.device)
    view = flat[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_flash_attention_refuses_a_misaligned_view(cuda, which):
    """A float32 view that starts one element (4 bytes) into its storage is
    not refused any more, nor copied: it goes to FLASH_UNALIGNED (scalar
    loads), launched once, and agrees with the plain version."""
    inputs = {"q": torch.randn(1, 4, 64, 32, device=cuda),
              **{n: torch.randn(1, 2, 64, 32, device=cuda) for n in "kv"}}
    inputs[which] = _flash_view(inputs[which], 1)
    out = _launched_once(fa_kernel.FLASH_UNALIGNED, lambda: flash_attention(
        inputs["q"], inputs["k"], inputs["v"], causal=True))
    ref = attention_plain(inputs["q"], inputs["k"], inputs["v"], causal=True,
                          scale=32 ** -0.5)
    assert bool(((out - ref).abs() <= 2e-4 + 2e-4 * ref.abs()).all())


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_flash_attention_tc_refuses_a_misaligned_view(cuda, which):
    """A bfloat16 view that starts one element into its storage cannot feed
    the tensor-core kernel's TMA: it goes to FLASH_TC_UNALIGNED (the producer
    warpgroup loads the tiles itself), is not copied, and agrees with the
    plain version under the 16-bit rules."""
    shapes = {"q": (1, 4, 64, 32), "k": (1, 2, 64, 32), "v": (1, 2, 64, 32)}
    inputs = {n: torch.randn(*shape, device=cuda).to(torch.bfloat16)
              for n, shape in shapes.items()}
    inputs[which] = _flash_view(inputs[which], 1)
    _flash_held_on(fa_kernel.FLASH_TC_UNALIGNED, inputs["q"], inputs["k"], inputs["v"], True,
                   2e-2)


def _flash_held_on(kernel, q, k, v, causal, tol, window=None, q_offset=None):
    """flash_attention launched once on ``kernel`` and held to the plain
    version (with the same window and query offset): |Δ| ≤ tol (abs and
    rel), and 16-bit rows ‖Δ‖₂ ≤ 2⁻⁷·‖ref‖₂."""
    out = _launched_once(kernel, lambda: flash_attention(q, k, v, causal=causal, window=window,
                                                         q_offset=q_offset))
    assert out.dtype == q.dtype and out.shape == q.shape
    ref = attention_plain(q, k, v, causal=causal, scale=1.0 / math.sqrt(q.shape[-1]),
                          window=window, q_offset=q_offset)
    err = (out.float() - ref.float()).abs()
    assert bool((err <= tol + tol * ref.float().abs()).all()), float(err.max())
    if q.dtype != torch.float32:
        row_rel = err.norm(dim=-1) / ref.float().norm(dim=-1)
        assert float(row_rel.max()) <= 2.0 ** -7, float(row_rel.max())


FLASH_TOLS = [(torch.float32, 2e-4), (torch.bfloat16, 2e-2), (torch.float16, 2e-2)]


@pytest.mark.parametrize("dtype,tol", FLASH_TOLS)
@pytest.mark.parametrize("d", [8, 160, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_head_dims_of_the_reference_configs(cuda, dtype, tol, d, causal):
    """D = 8 (qwen3_moe_235b smoke), 160 (stablelm_12b) and 256
    (recurrentgemma_2b): float32 on FLASH (CUDA cores), 16-bit on FLASH_TC
    (tensor cores), ragged lengths and GQA, held under the flash rules."""
    gen = torch.Generator(device=cuda).manual_seed(d + causal)
    q = torch.randn(2, 4, 200, d, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(2, 2, 333, d, generator=gen, device=cuda).to(dtype) for _ in "kv")
    kernel = fa_kernel.FLASH if dtype == torch.float32 else fa_kernel.FLASH_TC
    _flash_held_on(kernel, q, k, v, causal, tol)


@pytest.mark.parametrize("dtype,tol", FLASH_TOLS)
@pytest.mark.parametrize("offset", [2, 4])
@pytest.mark.parametrize("d", [32, 128, 160])
def test_flash_attention_views_off_the_16_byte_boundary(cuda, dtype, tol, offset, d):
    """q, k and v as views 2 or 4 elements into larger tensors: off a 16-byte
    boundary they run on FLASH_UNALIGNED (float32) or FLASH_TC_UNALIGNED
    (16-bit); a float32 view 4 elements in (16 bytes) is aligned and keeps
    its usual route."""
    gen = torch.Generator(device=cuda).manual_seed(offset + d)
    q = _flash_view(torch.randn(1, 4, 130, d, generator=gen, device=cuda).to(dtype), offset)
    k, v = (_flash_view(torch.randn(1, 2, 130, d, generator=gen, device=cuda).to(dtype),
                        offset) for _ in "kv")
    if (offset * q.element_size()) % 16:
        kernel = (fa_kernel.FLASH_UNALIGNED if dtype == torch.float32
                  else fa_kernel.FLASH_TC_UNALIGNED)
    else:
        kernel = fa_kernel.cuda_kernel(q, k, v)
        assert kernel is not fa_kernel.FLASH_UNALIGNED
    _flash_held_on(kernel, q, k, v, True, tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [160, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("views", ["qkv", "k"])
def test_flash_attention_tc_views_one_element_in(cuda, dtype, d, causal, views):
    """16-bit views 1 element (2 bytes) into larger tensors at the widest
    head dims, D = 160 (stablelm_12b; the third chunk half filled) and 256
    (recurrentgemma_2b): FLASH_TC_UNALIGNED, GQA, ragged Sq and Sk, held
    under the 16-bit rules."""
    gen = torch.Generator(device=cuda).manual_seed(d + 2 * causal + len(views))
    q = torch.randn(2, 4, 200, d, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(2, 2, 333, d, generator=gen, device=cuda).to(dtype) for _ in "kv")
    inputs = {n: (_flash_view(t, 1) if n in views else t) for n, t in zip("qkv", (q, k, v))}
    _flash_held_on(fa_kernel.FLASH_TC_UNALIGNED, inputs["q"], inputs["k"], inputs["v"],
                   causal, 2e-2)


# (causal, Sq, Sk, window, q_offset): a sliding window and a query offset
FLASH_BANDS = [(True, 333, 333, 64, None), (False, 200, 333, 50, None),
               (True, 200, 333, None, 133), (True, 200, 333, None, 0),
               (True, 200, 333, 100, 40), (True, 700, 700, 129, 0)]
# (route, dtype, elements the views start into their storage)
FLASH_ROUTES = [("FLASH", torch.float32, 0), ("FLASH_UNALIGNED", torch.float32, 1),
                ("FLASH_TC", torch.bfloat16, 0), ("FLASH_TC", torch.float16, 0),
                ("FLASH_TC_UNALIGNED", torch.bfloat16, 1)]


@pytest.mark.parametrize("route,dtype,offset", FLASH_ROUTES)
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("band", FLASH_BANDS)
def test_flash_attention_window_and_offset_on_every_route(cuda, route, dtype, offset, d, band):
    """Each of the four routes with a window (causal or not; 700 rows at a
    window of 129 skip whole KV tiles below the band) and with query row 0
    at key q_offset, held to the plain version under its route's rules."""
    causal, sq, sk, window, q_offset = band
    gen = torch.Generator(device=cuda).manual_seed(sq + sk + d + offset)
    q = torch.randn(2, 4, sq, d, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(2, 2, sk, d, generator=gen, device=cuda).to(dtype) for _ in "kv")
    if offset:
        q, k, v = (_flash_view(t, offset) for t in (q, k, v))
    _flash_held_on(getattr(fa_kernel, route), q, k, v, causal,
                   2e-4 if dtype == torch.float32 else 2e-2, window, q_offset)


@pytest.mark.parametrize("which", ["sqround", "flash_attention", "flash_attention_tc"])
def test_missing_library_raises_on_a_cuda_tensor(cuda, which, monkeypatch, tmp_path):
    """A CUDA tensor never falls back to the plain version: with the kernel's
    library missing the entry point raises, and nothing is counted."""
    library, kernel = {"sqround": (sq_kernel.LIBRARY, sq_kernel.SQROUND),
                       "flash_attention": (fa_kernel.LIBRARY, fa_kernel.FLASH),
                       "flash_attention_tc": (fa_kernel.TC_LIBRARY, fa_kernel.FLASH_TC)}[which]
    monkeypatch.setattr(library, "_lib", None)
    monkeypatch.setattr(library, "source", tmp_path / "missing.cu")
    x = torch.randn(1, 2, 64, 32, device=cuda)
    if which == "flash_attention_tc":
        x = x.to(torch.bfloat16)
    before = kernel.launches
    with pytest.raises((FileNotFoundError, RuntimeError)):
        if which == "sqround":
            sqround(x[0, 0], 8, prng.PRNGKey(0))
        else:
            flash_attention(x, x[:, :1], x[:, :1])
    assert kernel.launches == before


# --- the rest of the solver and the MRI path on the card ------------------------------

@pytest.mark.parametrize("granularity", ["per_channel", "per_block:64", "per_block:8"])
@pytest.mark.parametrize("m", [8, qmm_kernel.ROW_LOCAL_ROWS])
@pytest.mark.parametrize("bits", [2, 8])
@pytest.mark.parametrize("shape", [(870, 65536), (65536, 870), (256, 512)])
def test_qmm_rows_are_independent_of_the_batch(cuda, bits, shape, m, granularity):
    """Dense codes, full-mantissa x: row b of a call of up to ROW_LOCAL_ROWS
    rows equals the M = 1 call on row b bit for bit, on the tensor-core and
    the CUDA-core routes (PackedStreamingOperator.independent_rows; the
    freeze rule's grouping contract rests on it)."""
    n, k = shape
    gen = torch.Generator(device=cuda).manual_seed(n + k + bits)
    w = torch.randn(n, k, generator=gen, device=cuda)
    pw = pack_weights(w, bits, prng.PRNGKey(bits), granularity=granularity)
    x = torch.randn(m, k, generator=gen, device=cuda)
    y = qmm(x, pw)
    rows = torch.cat([qmm(x[b:b + 1].clone(), pw) for b in range(m)])
    assert torch.equal(rows, y)


@pytest.mark.parametrize("granularity", ["per_tensor", "per_channel", "per_block:64"])
@pytest.mark.parametrize("batch", [17, 32, 64])
def test_row_local_packed_operator_past_the_kernel_rows(cuda, batch, granularity):
    """Past ROW_LOCAL_ROWS rows the freeze rule applies the packed operator in
    blocks of ROW_LOCAL_ROWS, and every row keeps the bits of a batch of one
    (both orientations, complex Φ̂ as LOFAR's)."""
    from repro_torch.core.niht import _row_local
    from repro_torch.core.operators import PackedStreamingOperator

    gen = torch.Generator(device=cuda).manual_seed(batch)
    phi = torch.complex(torch.randn(870, 4096, generator=gen, device=cuda),
                        torch.randn(870, 4096, generator=gen, device=cuda))
    op = PackedStreamingOperator.pack(phi, 2, prng.PRNGKey(5), granularity=granularity)
    assert op.independent_rows == qmm_kernel.ROW_LOCAL_ROWS
    local = _row_local(op)
    x = torch.randn(batch, 4096, generator=gen, device=cuda)
    r = torch.complex(torch.randn(batch, 870, generator=gen, device=cuda),
                      torch.randn(batch, 870, generator=gen, device=cuda))
    fwd, adj = local.mv(x), local.rmv(r)
    for b in range(batch):
        assert torch.equal(fwd[b:b + 1], op.mv(x[b:b + 1].clone()))
        assert torch.equal(adj[b:b + 1], op.rmv(r[b:b + 1].clone()))


def _gaussian(cuda, batch, seed):
    gen = torch.Generator().manual_seed(seed)
    phi = torch.randn(128, 256, generator=gen)
    X = torch.zeros(batch, 256)
    for b in range(batch):
        X[b, torch.randperm(256, generator=gen)[:8]] = torch.randn(8, generator=gen)
    Y = X @ phi.T + 0.05 * torch.randn(batch, 128, generator=gen)
    return phi.to(cuda), Y.to(cuda)


@pytest.mark.parametrize("batch", [4, 20])
@pytest.mark.parametrize("exit_tol", [0.0, 1e-4])
def test_early_exit_contracts_on_the_card(cuda, exit_tol, batch):
    """Lossless exit = no exit, bit for bit; the freeze rule gives each row
    the bits of its single solve, also past ROW_LOCAL_ROWS rows; segments
    give the one-shot bits."""
    from repro_torch.core.niht import solver_init, solver_result, solver_segment

    phi, Y = _gaussian(cuda, batch, 3)
    kw = dict(bits_phi=8, bits_y=8, key=prng.PRNGKey(1), requantize="fixed",
              backend="packed")
    full = qniht_batch(phi, Y, 8, 30, early_exit=exit_tol > 0, exit_tol=exit_tol, **kw)
    if exit_tol == 0.0:
        early = qniht_batch(phi, Y, 8, 30, early_exit=True, **kw)
        assert torch.equal(early.x, full.x)
        assert all(torch.equal(a, b) for a, b in zip(early.trace, full.trace))
    else:
        for b in range(batch):
            one = qniht(phi, Y[b], 8, 30, early_exit=True, exit_tol=exit_tol, **kw)
            assert torch.equal(one.x, full.x[b])
            assert all(torch.equal(a, c[:, b]) for a, c in zip(one.trace, full.trace))
    st = solver_init(phi, Y, 8, 30, early_exit=exit_tol > 0, exit_tol=exit_tol, **kw)
    seg_kw = {k: v for k, v in kw.items() if k != "key"}
    for n in (4, 11, 15):
        st = solver_segment(phi, st, n, s=8, early_exit=exit_tol > 0, exit_tol=exit_tol,
                            **seg_kw)
    seg = solver_result(st)
    assert torch.equal(seg.x, full.x)
    assert all(torch.equal(a, b) for a, b in zip(seg.trace, full.trace))


@pytest.mark.parametrize("basis", ["pixel", "haar", "db4"])
def test_mri_operators_on_the_card_match_the_cpu(cuda, basis):
    from repro_torch.sensing.mri import make_mri_problem

    p_cpu = make_mri_problem(64, 300, 0.35, prng.PRNGKey(2), sparsity_basis=basis,
                             device="cpu")
    p_gpu = make_mri_problem(64, 300, 0.35, prng.PRNGKey(2), sparsity_basis=basis,
                             device=cuda)
    torch.testing.assert_close(p_gpu.y.cpu(), p_cpu.y, rtol=0, atol=1e-5)
    torch.testing.assert_close(p_gpu.x_true.cpu(), p_cpu.x_true, rtol=0, atol=1e-5)
    r = torch.randn(3, p_cpu.op.shape[0], dtype=torch.complex64)
    torch.testing.assert_close(p_gpu.op.rmv(r.to(cuda)).cpu(), p_cpu.op.rmv(r), rtol=0,
                               atol=1e-5)


def test_mri_hsthresh_solve_launches_the_fused_kernel(cuda):
    from repro_torch.configs import CONFIGS
    from repro_torch.launch.recover import mri_instance

    cfg = CONFIGS["mri-wavelet-smoke"]
    prob, y, _, kw = mri_instance(cfg, 0, 2, cuda, cfg.bits_y, "per_band")
    before = hs_kernel.HSTHRESH.launches
    res = qniht_batch(prob.op, y, cfg.n_sparse, cfg.n_iters, threshold="hsthresh", **kw)
    steps = int(res.trace.backtracks.max(dim=1).values.sum())
    assert hs_kernel.HSTHRESH.launches - before == cfg.n_iters + steps


# --- serving (repro_torch.parallel) on the card ---------------------------------------------

def _serve_workload(cuda, name, n_requests):
    """Φ and the first requests' y of a serve-continuous config, on the card."""
    import dataclasses

    from repro_torch.configs import SERVE_CONFIGS
    from repro_torch.launch.serve import build_requests

    cfg = dataclasses.replace(SERVE_CONFIGS[name], n_requests=n_requests)
    phi, arrivals, _, _ = build_requests(cfg, prng.PRNGKey(cfg.seed), cuda)
    return cfg, phi, [req.y for _, req in arrivals]


def _serve_kw(packed):
    return dict(bits_phi=4, bits_y=8, backend="packed", requantize="fixed") if packed else {}


@pytest.mark.parametrize("slots,packed", [(8, False), (8, True), (24, True)])
def test_a_row_keeps_its_bits_in_any_slot(cuda, slots, packed):
    """The scheduler's contract at the solver: y in slot b of a table of
    co-tenants gives row 0 of [y; 0; ...] at the same width, bit for bit:
    on the dense f32 Φ (cuBLAS, torch.sort, the row sums) and on the 4-bit
    packed Φ̂ (qmm) at 8 slots, and on the packed Φ̂ at 24, past the 16 rows
    a qmm call keeps row-local."""
    cfg, phi, ys = _serve_workload(cuda, "serve-continuous-packed", slots + 1)
    kw = dict(_serve_kw(packed), key=prng.PRNGKey(cfg.seed), early_exit=True,
              with_trace=False)
    y, others = ys[0], torch.stack(ys[1:])
    alone = torch.zeros_like(others)
    alone[0] = y
    want = qniht_batch(phi, alone, cfg.s, cfg.n_iters_easy, **kw).x[0]
    for b in sorted({0, slots // 2 - 1, slots - 1, min(16, slots - 1)}):
        Y = others.clone()
        Y[b] = y
        got = qniht_batch(phi, Y, cfg.s, cfg.n_iters_easy, **kw).x[b]
        assert torch.equal(got, want), f"slot {b} of {slots}"


@pytest.mark.parametrize("packed", [False, True])
def test_scheduler_answers_are_their_reference_solves_on_the_card(cuda, packed):
    """serve_scheduled(verify=True) on the card: every request of the smoke
    trace bitwise its reference_solve (dense f32 and 4-bit packed)."""
    import dataclasses

    from repro_torch.configs import SERVE_CONFIGS
    from repro_torch.launch.serve import serve_scheduled

    cfg = SERVE_CONFIGS["serve-continuous-smoke"]
    if packed:
        cfg = dataclasses.replace(cfg, bits_phi=4, bits_y=8, backend="packed")
    out = serve_scheduled(cfg, "continuous", verify=True, device=cuda)
    assert out["completed"] == cfg.n_requests


@pytest.fixture(scope="module")
def two_ranks_on_the_card():
    """The LOFAR SMOKE cases solved by two gloo ranks sharing the card
    (spawned once for the module)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    import torch_sharded_ranks as ranks
    from repro_torch.parallel.dist import spawn_ranks

    return spawn_ranks(ranks.card_cases, 2, device="cuda", backend="gloo")


@pytest.mark.parametrize("name", ["lofar_per_tensor", "lofar_per_block", "lofar_hsthresh",
                                  "lofar_dense", "lofar_freeze"])
def test_two_gloo_ranks_on_the_card_are_one_rank_bitwise(cuda, two_ranks_on_the_card, name):
    """Two ranks sharing the card over gloo, each solving 3 of 6 LOFAR SMOKE
    skies (QMM, QMM_GROUP, the fused H_s, cuBLAS on the dense complex Φ, the
    freeze rule's row blocks): x and the whole trace on each rank equal the
    one-device solve bit for bit."""
    import torch_sharded_ranks as ranks

    x, trace = ranks.card_solve(name, device=cuda)
    for rank, by_name in enumerate(two_ranks_on_the_card):
        got_x, got_trace = by_name[name]
        assert torch.equal(got_x, x), f"x of rank {rank}"
        for got, want in zip(got_trace, trace):
            assert torch.equal(got.nan_to_num(), want.nan_to_num()), f"trace of rank {rank}"


def test_splice_purity_on_the_card(cuda):
    """refill_rows on CUDA tensors writes into clones: the input state keeps
    every bit (its Y is the one the segment shares), the other rows too, and
    their next segment is the same."""
    from repro_torch.parallel import refill_rows

    cfg, phi, ys = _serve_workload(cuda, "serve-continuous-packed", 5)
    kw = dict(_serve_kw(True), early_exit=True, with_trace=True)
    st = solver_init(phi, torch.stack(ys[:4]), cfg.s, 24, key=prng.PRNGKey(0), **kw)
    st = solver_segment(phi, st, 8, s=cfg.s, **kw)
    before = [t.clone() for t in (st.X, st.done, st.streak, st.Y, *st.last, *st.trace)]
    spliced = refill_rows(st, [2], ys[4][None], [True])
    after = (st.X, st.done, st.streak, st.Y, *st.last, *st.trace)
    assert all(torch.equal(a.nan_to_num(), b.nan_to_num()) if a.is_floating_point()
               else torch.equal(a, b) for a, b in zip(before, after))
    a = solver_segment(phi, st, 8, s=cfg.s, **kw)
    b = solver_segment(phi, spliced, 8, s=cfg.s, **kw)
    keep = [0, 1, 3]
    assert torch.equal(a.X[keep], b.X[keep]) and torch.equal(a.done[keep], b.done[keep])
    for u, v in zip(a.trace, b.trace):
        assert torch.equal(u[:, keep].nan_to_num(), v[:, keep].nan_to_num())


@pytest.mark.parametrize("packed", [False, True])
def test_pad_rows_stay_zero_on_the_card(cuda, packed):
    """Pad rows (Y = 0, X = 0, done) stay bitwise zero through a segment,
    no NaN from a 0/0 in the step size or a zero scale."""
    from repro_torch.parallel import ContinuousScheduler, refill_rows, segment_step

    cfg, phi, ys = _serve_workload(cuda, "serve-continuous-packed", 1)
    kw = _serve_kw(packed)
    kw.setdefault("bits_y", 8)
    sch = ContinuousScheduler(phi, cfg.s, 24, slots=8, seg_len=8, key=prng.PRNGKey(0), **kw)
    st = refill_rows(sch._state, [3], ys[0][None], [True])
    out = segment_step(sch.phi, st, 8, **sch._statics)
    pads = [b for b in range(8) if b != 3]
    assert torch.equal(out.X[pads], torch.zeros_like(out.X[pads]))
    assert bool(out.done[pads].all()) and not torch.isnan(out.X).any()
    assert out.X[3].abs().sum() > 0


def _lofar_smoke_dirty(device):
    from repro_torch.configs.lofar_cs302 import SMOKE
    from repro_torch.launch.recover import lofar_instance
    from repro_torch.sensing.telescope import dirty_beam, dirty_image

    phi, y, _ = lofar_instance(SMOKE, 0, 0, device)
    return (phi, dirty_image(phi, y, SMOKE.resolution),
            dirty_beam(phi, SMOKE.resolution))


def test_clean_on_the_card(cuda):
    """Högbom CLEAN on the card against the port on the CPU, same dirty
    image and beam: components at the same positions, values within 1e-5,
    and no host sync inside the loop (the shift is a gather on the device)."""
    from repro_torch.core.baselines import clean

    _, img, beam = _lofar_smoke_dirty(cuda)
    comps, resid, peaks = clean(img, beam, 0.1, 120)
    c_cpu, r_cpu, p_cpu = clean(img.cpu(), beam.cpu(), 0.1, 120)
    assert torch.equal(comps.cpu() != 0, c_cpu != 0)
    for got, want in ((comps, c_cpu), (resid, r_cpu), (peaks, p_cpu)):
        assert (got.cpu() - want).abs().max() <= 1e-5
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        clean(img, beam, 0.1, 8)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_rics_sampled_on_the_card(cuda):
    """The sampled supports are drawn on the card bit for bit as on the CPU,
    and α̂, β̂ agree with the CPU's to 1e-5 relative."""
    from repro_torch.core.rip import rics_sampled, sampled_supports

    phi, _, _ = _lofar_smoke_dirty(cuda)
    key = prng.PRNGKey(3)
    assert torch.equal(sampled_supports(phi.shape[1], 16, 32, key, device=cuda).cpu(),
                       sampled_supports(phi.shape[1], 16, 32, key))
    a, b = rics_sampled(phi, 16)
    a_cpu, b_cpu = rics_sampled(phi.cpu(), 16)
    assert abs(float(a) - float(a_cpu)) <= 1e-5 * float(a_cpu)
    assert abs(float(b) - float(b_cpu)) <= 1e-5 * float(b_cpu)


def test_kernel_output_tripwire_names_the_kernel(cuda):
    """A finite x near the float32 maximum whose product with Φ̂ overflows
    only inside ``repro_qmm_tc``: the sanitizer names the kernel's entry
    (no eager op around it sees an Inf), and outside it the kernel gives
    inf, as ``qmm_ref`` does."""
    from repro_torch.analysis.sanitize import sanitize

    gen = torch.Generator(device=cuda).manual_seed(31)
    # positive weights: the sums overflow to +inf, never inf − inf
    w = pack_weights(torch.rand(64, 512, generator=gen, device=cuda) + 0.5, 8, prng.PRNGKey(8))
    x = torch.full((1, 512), 3.0e38, device=cuda)
    assert cuda_kernel(w) is qmm_kernel.QMM
    y = qmm(x, w)
    assert torch.isinf(y).any() and torch.isinf(qmm_ref(x, w.packed, w.scale, 8, 512)).any()
    with sanitize():
        with pytest.raises(FloatingPointError, match="kernel repro_qmm_tc"):
            qmm(x, w)
        qmm(torch.ones((1, 512), device=cuda), w)


# ---------------------------------------------------------------------------
# the dense LM on the card (repro_torch.models)

# (in, out) of starcoder2-3b's six QWeight products: wq, wk (= wv), wo, MLP wi, wo
STARCODER2_3B_PRODUCTS = [(3072, 4096), (3072, 256), (4096, 3072), (3072, 12288),
                          (12288, 3072)]


@pytest.mark.parametrize("shape", STARCODER2_3B_PRODUCTS)
def test_qweight_product_on_qmm_matches_materialize(cuda, shape):
    """A decode product (M = 8) of a layer slice of a stacked 4-bit kernel
    launches QMM once and agrees with materialize + matmul within qmm's
    1e-5 rule; a prefill's product (M > QMM_MAX_ROWS) launches none."""
    from repro_torch.models import layers as lm_layers
    from repro_torch.models.quantized import quantize_weight

    k, n = shape
    gen = torch.Generator(device=cuda).manual_seed(k + n)
    qw = quantize_weight(torch.randn(2, k, n, generator=gen, device=cuda) * 0.02, 4)[1]
    assert cuda_kernel(qw.packed_weights()) is qmm_kernel.QMM
    x = torch.randn(8, k, generator=gen, device=cuda)
    before = qmm_kernel.QMM.launches
    y = lm_layers.qweight_product(x, qw)
    assert qmm_kernel.QMM.launches == before + 1
    w = qw.dequantize(torch.float32)
    ref = x @ w
    assert bool(((y - ref).abs() <= 1e-5 * ref.abs() + 1e-5 * (x.abs() @ w.abs())).all())
    p = {"w": qw, "b": torch.randn(n, generator=gen, device=cuda)}
    y16 = lm_layers.dense(p, x.to(torch.bfloat16))
    assert y16.dtype == torch.bfloat16 and qmm_kernel.QMM.launches == before + 2
    xs = torch.randn(lm_layers.QMM_MAX_ROWS + 1, k, generator=gen, device=cuda)
    lm_layers.dense(p, xs)
    assert qmm_kernel.QMM.launches == before + 2


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal,sq,sk", [(True, 300, 300), (False, 40, 300)])
def test_chunked_attention_on_flash(cuda, dtype, tol, causal, sq, sk):
    """chunked_attention launches one flash kernel (FLASH_TC for bf16, FLASH
    for f32) and agrees with its plain version, also with a window and, for
    causal Sq ≠ Sk, with query i at key q_offset + i; with a gradient and a
    window it takes KernelAttention (one kernel launch, one call of the
    backward route), its gradients those of autograd through the plain
    forward."""
    from repro_torch.models import layers as lm_layers

    gen = torch.Generator(device=cuda).manual_seed(sq + sk)
    q = torch.randn(2, 8, sq, 128, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(2, 2, sk, 128, generator=gen, device=cuda).to(dtype) for _ in range(2))
    kernel = fa_kernel.FLASH_TC if dtype == torch.bfloat16 else fa_kernel.FLASH
    before = kernel.launches
    out = lm_layers.chunked_attention(q, k, v, causal=causal)
    assert kernel.launches == before + 1 and out.dtype == dtype
    ref = lm_layers.chunked_attention_plain(q, k, v, causal=causal, chunk=128)
    assert torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
    for qq, kw in ((q[:, :, :sk], dict(window=64)), (q[:, :, :10], dict(q_offset=0)),
                   (q[:, :, :10], dict(q_offset=100, window=30))):
        before = kernel.launches
        out = lm_layers.chunked_attention(qq, k, v, causal=True, **kw)
        assert kernel.launches == before + 1
        ref = lm_layers.chunked_attention_plain(qq, k, v, causal=True, chunk=128, **kw)
        assert torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol), kw
    qg = q[:, :, :sk].detach().clone().requires_grad_(True)
    before = (kernel.launches, lm_layers.ATTENTION_BACKWARD.launches)
    out = lm_layers.chunked_attention(qg, k, v, causal=True, window=64, chunk=128)
    out.float().sum().backward()
    moved = (kernel.launches - before[0], lm_layers.ATTENTION_BACKWARD.launches - before[1])
    assert moved == (1, 1)
    qp = q[:, :, :sk].detach().clone().requires_grad_(True)
    ref = lm_layers.chunked_attention_plain(qp, k, v, causal=True, window=64, chunk=128)
    ref.float().sum().backward()
    assert float((qg.grad.float() - qp.grad.float()).norm()) <= (
        2.0 ** -6 if dtype == torch.bfloat16 else 1e-4) * float(qp.grad.float().norm())


@pytest.mark.parametrize("bits", [None, 4])
def test_smoke_model_on_the_card_matches_the_cpu(cuda, bits):
    """A two-layer starcoder2-3b SMOKE model in float32, full precision and
    W4: prefill and decode steps on the card (flash, qmm) against the same
    weights on the CPU, within 1e-4·max|logits|; the routes are counted."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import decode_step, init_cache, init_params, prefill
    from repro_torch.models.quantized import quantize_params, tree_to
    from repro_torch.quant.policy import QuantPolicy

    cfg = dataclasses.replace(get_smoke_config("starcoder2_3b"), dtype="float32")
    params = init_params(cfg, prng.PRNGKey(0), device=cuda)
    if bits:
        params = quantize_params(params, bits)
    policy = QuantPolicy(weight_bits=bits)
    toks = prng.randint(prng.PRNGKey(1), (2, 12), 0, cfg.vocab_size, device=cuda)

    def run(tree, t):
        cache = init_cache(cfg, 2, 16, policy, device=t.device)
        out, cache = prefill(cfg, tree, t[:, :8], cache, policy=policy)
        outs = [out]
        for i in range(8, 12):
            out, cache = decode_step(cfg, tree, t[:, i], cache, policy=policy)
            outs.append(out)
        return torch.stack(outs, dim=1)

    qmm_before, flash_before = qmm_kernel.QMM.launches, fa_kernel.FLASH.launches
    card = run(params, toks)
    assert fa_kernel.FLASH.launches - flash_before == cfg.n_layers
    # 16 prefill rows and 2 per decode step: every product goes to qmm
    assert qmm_kernel.QMM.launches - qmm_before == (5 * 6 * cfg.n_layers if bits else 0)
    cpu = run(tree_to(params, "cpu"), toks.cpu())
    assert float((card.cpu() - cpu).abs().max()) <= 1e-4 * float(cpu.abs().max())


def test_chunked_attention_casts_float32_kv_to_q_dtype(cuda):
    """A bf16 query over float32 K/V (the vlm's cross-attention over float32
    image embeddings) takes the counted cast (ATTENTION_KV_CAST) and one
    FLASH_TC launch, and agrees with the plain version on the cast K/V."""
    from repro_torch.models import layers as lm_layers

    gen = torch.Generator(device=cuda).manual_seed(25)
    q = torch.randn(2, 8, 40, 128, generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(2, 2, 300, 128, generator=gen, device=cuda) for _ in range(2))
    before = (fa_kernel.FLASH_TC.launches, lm_layers.ATTENTION_KV_CAST.launches)
    out = lm_layers.chunked_attention(q, k, v, causal=False)
    assert (fa_kernel.FLASH_TC.launches, lm_layers.ATTENTION_KV_CAST.launches) == (
        before[0] + 1, before[1] + 1)
    ref = lm_layers.chunked_attention_plain(q, k.to(torch.bfloat16), v.to(torch.bfloat16),
                                            causal=False, chunk=128)
    assert out.dtype == torch.bfloat16
    assert torch.allclose(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", ["whisper_tiny", "llama32_vision_11b"])
@pytest.mark.parametrize("bits", [None, 4])
def test_cross_attention_smoke_model_on_the_card_matches_the_cpu(cuda, arch, bits):
    """The cross-attention SMOKE models in float32, full precision and W4:
    encode (whisper), prefill over the memory and decode steps on the card
    (FLASH for every attention, causal and not; qmm for the decode
    products) against the same weights and inputs on the CPU, within
    1e-4·max|logits|."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import decode_step, encode, init_cache, init_params, prefill
    from repro_torch.models.quantized import quantize_params, tree_to
    from repro_torch.quant.policy import QuantPolicy

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = init_params(cfg, prng.PRNGKey(0), device=cuda)
    if bits:
        params = quantize_params(params, bits)
    policy = QuantPolicy(weight_bits=bits)
    toks = prng.randint(prng.PRNGKey(1), (2, 12), 0, cfg.vocab_size, device=cuda)
    rows = cfg.encoder_seq if cfg.family == "encdec" else cfg.n_image_tokens
    source = prng.normal(prng.PRNGKey(2), (2, rows, cfg.d_model), device=cuda)

    def run(tree, t, src):
        mem = encode(cfg, tree, src, policy) if cfg.family == "encdec" else src
        cache = init_cache(cfg, 2, 16, policy, mem_len=rows, device=t.device)
        out, cache = prefill(cfg, tree, t[:, :8], cache, policy=policy, memory=mem)
        outs = [out]
        for i in range(8, 12):
            out, cache = decode_step(cfg, tree, t[:, i], cache, policy=policy)
            outs.append(out)
        return torch.stack(outs, dim=1)

    flash_before = fa_kernel.FLASH.launches
    card = run(params, toks, source)
    cross = sum(kind == "xattn" for kind in cfg.pattern_for_layers())
    assert fa_kernel.FLASH.launches - flash_before == cfg.n_encoder_layers + cfg.n_layers + cross
    cpu = run(tree_to(params, "cpu"), toks.cpu(), source.cpu())
    assert float((card.cpu() - cpu).abs().max()) <= 1e-4 * float(cpu.abs().max())


def test_hybrid_smoke_generate_kernel_routes_match_plain_routes(cuda, monkeypatch):
    """recurrentgemma-2b's SMOKE config cut to 5 layers (a period and two
    tail layers), bf16 under W4KV8: generate from a 40-token prompt, past
    its window of 32, and 12 decode steps, on the card's kernel routes (one
    windowed FLASH_TC launch per prefill, QMM once per product in the
    prefill's 80 rows and each decode step: 4 RG-LRU layers × 8 + 1
    attention layer × 7); the plain routes,
    teacher-forced on the same tokens, within 2e-2·max|logits|."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import decode_step, generate, init_cache, init_params, prefill
    from repro_torch.models import layers as lm_layers
    from repro_torch.models.quantized import materialize, quantize_params
    from repro_torch.quant.policy import QuantPolicy

    cfg = dataclasses.replace(get_smoke_config("recurrentgemma_2b"), n_layers=5)
    params = quantize_params(init_params(cfg, prng.PRNGKey(0), device=cuda), 4)
    policy = QuantPolicy(weight_bits=4, kv_bits=8)
    prompt = prng.randint(prng.PRNGKey(1), (2, 40), 0, cfg.vocab_size, device=cuda)
    qmm_before = qmm_kernel.QMM.launches
    flash_before = dict(fa_kernel.FLASH_TC.launches_by_shape)
    toks, logits = generate(cfg, params, prompt, 13, policy)
    windowed = (2, 4, 1, 40, 40, 16, 0, 32)
    assert fa_kernel.FLASH_TC.launches_by_shape[windowed] - flash_before.get(windowed, 0) == 1
    assert qmm_kernel.QMM.launches - qmm_before == 13 * (4 * 8 + 7)
    monkeypatch.setattr(lm_layers, "qweight_product",
                        lambda x, w: x @ materialize(w, x.dtype))
    monkeypatch.setattr(lm_layers, "attention_kernel",
                        lambda q, k, v, causal, window=None, q_offset=0:
                        lm_layers.chunked_attention_plain(q, k, v, causal=causal,
                                                          chunk=cfg.attn_chunk, window=window,
                                                          q_offset=q_offset))
    cache = init_cache(cfg, 2, 40 + 13 + 8, policy, device=cuda)
    plain, cache = prefill(cfg, params, prompt, cache, policy=policy)
    plain = [plain]
    for i in range(12):
        out, cache = decode_step(cfg, params, toks[:, i], cache, policy=policy)
        plain.append(out)
    plain = torch.stack(plain, dim=1)
    assert float((logits.float() - plain.float()).abs().max()) <= 2e-2 * float(
        plain.float().abs().max())


@pytest.mark.parametrize("dtype,rel", [(torch.bfloat16, 2.0 ** -6), (torch.float32, 1e-4)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_function_gradients_on_the_card(cuda, dtype, rel, causal):
    """chunked_attention with inputs that require a gradient runs the kernel
    forward (one flash launch) and the plain backward route (one call of
    ATTENTION_BACKWARD); dq, dk, dv agree with autograd through the plain
    forward within ``rel`` in 2-norm (bf16: both round the gradients to
    bf16 and start from outputs one bf16 ulp apart; f32: the sums' order)."""
    from repro_torch.models import layers as lm_layers

    gen = torch.Generator(device=cuda).manual_seed(int(causal))
    base = [torch.randn(2, h, 384, 128, generator=gen, device=cuda).to(dtype) for h in (8, 2, 2)]
    dout = torch.randn(2, 8, 384, 128, generator=gen, device=cuda).to(dtype)
    kernel = fa_kernel.FLASH_TC if dtype == torch.bfloat16 else fa_kernel.FLASH
    grads = []
    for plain in (False, True):
        q, k, v = (t.clone().requires_grad_(True) for t in base)
        before = (kernel.launches, lm_layers.ATTENTION_BACKWARD.launches)
        if plain:
            out = lm_layers.chunked_attention_plain(q, k, v, causal=causal, chunk=128)
        else:
            out = lm_layers.chunked_attention(q, k, v, causal=causal, chunk=128)
        out.backward(dout)
        moved = (kernel.launches - before[0], lm_layers.ATTENTION_BACKWARD.launches - before[1])
        assert moved == ((0, 0) if plain else (1, 1))
        grads.append((q.grad, k.grad, v.grad))
    for a, b in zip(*grads):
        assert a.dtype == dtype and bool(torch.isfinite(a).all())
        assert float((a.float() - b.float()).norm()) <= rel * float(b.float().norm())


@pytest.mark.parametrize("dtype,rel", [(torch.bfloat16, 2.0 ** -6), (torch.float32, 1e-4)])
@pytest.mark.parametrize("window,sq,q_offset", [(64, 384, 0), (None, 200, 184), (64, 200, 184)])
def test_windowed_attention_gradients_on_the_card(cuda, dtype, rel, window, sq, q_offset):
    """chunked_attention with a window, a query offset (Sq ≠ Sk) or both, and
    inputs that require a gradient: the kernel forward (one launch) and the
    plain backward route with the same window and offset (one call of
    ATTENTION_BACKWARD); dq, dk, dv agree with autograd through the plain
    forward within ``rel`` in 2-norm."""
    from repro_torch.models import layers as lm_layers

    gen = torch.Generator(device=cuda).manual_seed(sq + (window or 0))
    base = [torch.randn(2, h, s, 128, generator=gen, device=cuda).to(dtype)
            for h, s in ((8, sq), (2, 384), (2, 384))]
    dout = torch.randn(2, 8, sq, 128, generator=gen, device=cuda).to(dtype)
    kernel = fa_kernel.FLASH_TC if dtype == torch.bfloat16 else fa_kernel.FLASH
    kw = dict(causal=True, chunk=128, window=window, q_offset=q_offset)
    grads = []
    for plain in (False, True):
        q, k, v = (t.clone().requires_grad_(True) for t in base)
        before = (kernel.launches, lm_layers.ATTENTION_BACKWARD.launches)
        fn = lm_layers.chunked_attention_plain if plain else lm_layers.chunked_attention
        fn(q, k, v, **kw).backward(dout)
        moved = (kernel.launches - before[0], lm_layers.ATTENTION_BACKWARD.launches - before[1])
        assert moved == ((0, 0) if plain else (1, 1))
        grads.append((q.grad, k.grad, v.grad))
    for a, b in zip(*grads):
        assert a.dtype == dtype and bool(torch.isfinite(a).all())
        assert float((a.float() - b.float()).norm()) <= rel * float(b.float().norm())


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "mamba2_370m"])
def test_recurrent_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """Two make_train_step steps of the SMOKE config in float32 (Q8
    gradients, IHT at 50%) on the card and on the CPU from the same state:
    the losses within 1e-4 relative, the sparsity the same; on the card the
    projection is one HSTHRESH launch per eligible leaf, Q8 takes SQROUND,
    and the hybrid's attention layer one windowed FLASH launch forward and
    one in the remat recompute with one backward-route call a step."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticStream
    from repro_torch.models import layers as lm_layers
    from repro_torch.optim import IHTConfig, adamw, iht, sparsity_report
    from repro_torch.quant.policy import QuantPolicy
    from repro_torch.train import init_state, make_train_step
    from repro_torch.tree import tree_flatten_with_path, tree_map

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    cfg_iht = IHTConfig(sparsity=0.5, min_size=2048)
    opt = adamw(3e-3)
    step = make_train_step(cfg, opt, policy=QuantPolicy(grad_bits=8), iht=cfg_iht)
    card = init_state(cfg, opt, prng.PRNGKey(0), device=cuda)
    cpu = tree_map(lambda t: t.cpu(), card)
    n_eligible = sum(iht.eligible(p, leaf, cfg_iht) for p, leaf in
                     tree_flatten_with_path(card.params))
    runs = {}
    for where, state in (("card", card), ("cpu", cpu)):
        stream = SyntheticStream(0, 2, 64, cfg.vocab_size,
                                 device=cuda if where == "card" else "cpu")
        before = (hs_kernel.HSTHRESH.launches, sq_kernel.SQROUND.launches,
                  fa_kernel.FLASH.launches, lm_layers.ATTENTION_BACKWARD.launches)
        losses = []
        for i in range(2):
            state, m = step(state, stream.at_step(i))
            losses.append(float(m["loss"]))
        moved = (hs_kernel.HSTHRESH.launches - before[0], sq_kernel.SQROUND.launches - before[1],
                 fa_kernel.FLASH.launches - before[2],
                 lm_layers.ATTENTION_BACKWARD.launches - before[3])
        runs[where] = (losses, sparsity_report(state.params, cfg_iht), moved)
    attn = 1 if cfg.family == "hybrid" else 0
    assert runs["card"][2][0] == 2 * n_eligible and runs["card"][2][1] > 0
    assert runs["card"][2][2:] == (2 * 2 * attn, 2 * attn)
    assert runs["cpu"][2] == (0, 0, 0, 0)
    for a, b in zip(runs["card"][0], runs["cpu"][0]):
        assert math.isfinite(a) and abs(a - b) <= 1e-4 * abs(b)
    assert runs["card"][1] == runs["cpu"][1] == 0.5


@pytest.mark.parametrize("dtype,rel", [(torch.bfloat16, 2.0 ** -6), (torch.float32, 1e-4)])
@pytest.mark.parametrize("heads,d,sq,sk,chunk", [((8, 2), 128, 96, 300, 128),
                                                 ((6, 6), 64, 256, 1500, 1024)])
def test_noncausal_attention_gradients_with_ragged_keys_on_the_card(cuda, dtype, rel, heads, d,
                                                                    sq, sk, chunk):
    """The cross-attention's and the encoder's call with a gradient:
    non-causal, Sq ≠ Sk, Sk off the kernel's key tiles (300; whisper-tiny's
    1,500 frames, whose plain backward takes 750-key chunks): one flash
    launch forward, one call of ATTENTION_BACKWARD; dq, dk, dv within
    ``rel`` of autograd through the plain forward in 2-norm."""
    from repro_torch.models import layers as lm_layers

    hq, hkv = heads
    gen = torch.Generator(device=cuda).manual_seed(sq + sk)
    base = [torch.randn(2, h, s, d, generator=gen, device=cuda).to(dtype)
            for h, s in ((hq, sq), (hkv, sk), (hkv, sk))]
    dout = torch.randn(2, hq, sq, d, generator=gen, device=cuda).to(dtype)
    kernel = fa_kernel.FLASH_TC if dtype == torch.bfloat16 else fa_kernel.FLASH
    grads = []
    for plain in (False, True):
        q, k, v = (t.clone().requires_grad_(True) for t in base)
        before = (kernel.launches, lm_layers.ATTENTION_BACKWARD.launches)
        fn = lm_layers.chunked_attention_plain if plain else lm_layers.chunked_attention
        fn(q, k, v, causal=False, chunk=chunk).backward(dout)
        moved = (kernel.launches - before[0], lm_layers.ATTENTION_BACKWARD.launches - before[1])
        assert moved == ((0, 0) if plain else (1, 1))
        grads.append((q.grad, k.grad, v.grad))
    for a, b in zip(*grads):
        assert a.dtype == dtype and bool(torch.isfinite(a).all())
        assert float((a.float() - b.float()).norm()) <= rel * float(b.float().norm())


def test_float32_kv_cast_carries_the_gradient_on_the_card(cuda):
    """The vlm's image layer under autograd: a bf16 query over K/V projected
    from float32 image rows by float32 weights. chunked_attention casts K/V
    to bf16 (one ATTENTION_KV_CAST), launches FLASH_TC once and the backward
    route once; the gradients reach the float32 weights through the cast,
    float32, within 2⁻⁶ in 2-norm of autograd through the plain forward on
    the same cast."""
    from repro_torch.models import layers as lm_layers

    gen = torch.Generator(device=cuda).manual_seed(29)
    mem = torch.randn(2, 300, 256, generator=gen, device=cuda)
    q0 = torch.randn(2, 8, 96, 128, generator=gen, device=cuda).to(torch.bfloat16)
    w0 = [torch.randn(256, 2 * 128, generator=gen, device=cuda) / 16 for _ in range(2)]
    dout = torch.randn(2, 8, 96, 128, generator=gen, device=cuda).to(torch.bfloat16)
    grads = []
    for plain in (False, True):
        q = q0.clone().requires_grad_(True)
        wk, wv = (w.clone().requires_grad_(True) for w in w0)
        k, v = ((mem @ w).reshape(2, 300, 2, 128).transpose(1, 2) for w in (wk, wv))
        before = (fa_kernel.FLASH_TC.launches, lm_layers.ATTENTION_KV_CAST.launches,
                  lm_layers.ATTENTION_BACKWARD.launches)
        if plain:
            out = lm_layers.chunked_attention_plain(q, k.to(torch.bfloat16), v.to(torch.bfloat16),
                                                    causal=False, chunk=128)
        else:
            out = lm_layers.chunked_attention(q, k, v, causal=False, chunk=128)
        out.backward(dout)
        moved = tuple(a - b for a, b in zip((fa_kernel.FLASH_TC.launches,
                                             lm_layers.ATTENTION_KV_CAST.launches,
                                             lm_layers.ATTENTION_BACKWARD.launches), before))
        assert moved == ((0, 0, 0) if plain else (1, 1, 1))
        grads.append((q.grad, wk.grad, wv.grad))
    for (a, b), dtype in zip(zip(*grads), (torch.bfloat16, torch.float32, torch.float32)):
        assert a.dtype == dtype and bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0
        assert float((a.float() - b.float()).norm()) <= 2.0 ** -6 * float(b.float().norm())


@pytest.mark.parametrize("arch", ["whisper_tiny", "llama32_vision_11b"])
def test_cross_attention_smoke_loss_and_grads_on_the_card_match_the_cpu(cuda, arch):
    """loss_fn of the cross-attention SMOKE models in float32 with a memory
    (whisper's stub frames, encoded inside; the vlm's image rows) and every
    gradient leaf, the encoder's included, on the card and on the CPU from
    the same weights: the loss within 1e-4 relative, each leaf within 1e-4
    of its max|g|. On the card FLASH runs once per encoder layer (no remat)
    and twice per decoder self- and cross-attention call (the forward and
    the remat recompute), the backward route once per call."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params, loss_fn
    from repro_torch.models import layers as lm_layers
    from repro_torch.models.quantized import tree_to
    from repro_torch.tree import keystr, tree_flatten_with_path, tree_leaves

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = init_params(cfg, prng.PRNGKey(0), device=cuda)
    toks = prng.randint(prng.PRNGKey(1), (2, 49), 0, cfg.vocab_size, device=cuda)
    rows = cfg.encoder_seq if cfg.family == "encdec" else cfg.n_image_tokens
    memory = prng.normal(prng.PRNGKey(2), (2, rows, cfg.d_model), device=cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "memory": memory}
    runs = []
    for tree, b in ((params, batch), (tree_to(params, "cpu"),
                                      {k: v.cpu() for k, v in batch.items()})):
        leaves = tree_leaves(tree)
        for p in leaves:
            p.requires_grad_(True)
        before = (fa_kernel.FLASH.launches, lm_layers.ATTENTION_BACKWARD.launches)
        loss = loss_fn(cfg, tree, b)
        loss.backward()
        moved = (fa_kernel.FLASH.launches - before[0],
                 lm_layers.ATTENTION_BACKWARD.launches - before[1])
        runs.append((float(loss.detach()), [p.grad.cpu() for p in leaves], moved))
    cross = sum(kind == "xattn" for kind in cfg.pattern_for_layers())
    calls = cfg.n_layers + cross
    assert runs[0][2] == (cfg.n_encoder_layers + 2 * calls, cfg.n_encoder_layers + calls)
    assert runs[1][2] == (0, 0)
    assert abs(runs[0][0] - runs[1][0]) <= 1e-4 * abs(runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    names = [keystr(path) for path, _ in tree_flatten_with_path(params)]
    encoder = [g for name, g in zip(names, runs[0][1]) if name.startswith("['encoder']")]
    assert all(float(g.abs().max()) > 0 for g in encoder)
    assert bool(encoder) == (cfg.family == "encdec")


def test_vlm_bf16_loss_casts_the_image_kv_with_a_gradient(cuda):
    """llama-3.2-vision-11b's SMOKE config in bf16 over float32 image rows:
    loss_fn and its backward cast the image layer's K/V twice (the forward
    and the remat recompute), launch FLASH_TC twice per attention call and
    the backward route once; the gradients of the image layer's wk and wv
    are finite and not all zero."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params, loss_fn
    from repro_torch.models import layers as lm_layers
    from repro_torch.tree import tree_leaves

    cfg = get_smoke_config("llama32_vision_11b")
    params = init_params(cfg, prng.PRNGKey(0), device=cuda)
    toks = prng.randint(prng.PRNGKey(1), (2, 33), 0, cfg.vocab_size, device=cuda)
    memory = prng.normal(prng.PRNGKey(2), (2, cfg.n_image_tokens, cfg.d_model), device=cuda)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    before = (fa_kernel.FLASH_TC.launches, lm_layers.ATTENTION_KV_CAST.launches,
              lm_layers.ATTENTION_BACKWARD.launches)
    loss = loss_fn(cfg, params, {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                                 "memory": memory})
    loss.backward()
    moved = tuple(a - b for a, b in zip((fa_kernel.FLASH_TC.launches,
                                         lm_layers.ATTENTION_KV_CAST.launches,
                                         lm_layers.ATTENTION_BACKWARD.launches), before))
    calls = cfg.n_layers + 1
    assert moved == (2 * calls, 2, calls)
    assert math.isfinite(float(loss))
    slot = f"slot{cfg.pattern_for_layers().index('xattn')}"
    for name in ("wk", "wv"):
        g = params["slots"][slot]["xattn"][name]["w"].grad
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


def test_fused_hsthresh_on_a_row_past_two_to_the_thirty(cuda):
    """One row of 2³⁰ + 12,345 entries (a stacked MLP leaf of the training
    projection is 1.13e9): the fused kernel equals hsthresh_ref bit for bit
    and keeps exactly s entries."""
    n = (1 << 30) + 12345
    gen = torch.Generator(device=cuda).manual_seed(30)
    x = torch.randn(1, n, generator=gen, device=cuda)
    s = n // 2
    before = hs_kernel.HSTHRESH.launches
    got = hsthresh(x, s, nbins=4096)
    assert hs_kernel.HSTHRESH.launches == before + 1
    assert int(torch.count_nonzero(got)) == s
    want = hsthresh_ref(x, s, 4096)
    assert torch.equal(got, want)


def test_chunked_gradient_compression_on_the_card(cuda, monkeypatch):
    """fake_grad_compression on the card (one sqround launch per chunk of
    each leaf, a ragged last chunk) equals the CPU's plain path bit for bit,
    and the kernel's codes on words with the low 9 bits cleared equal the
    plain version's."""
    from repro_torch.kernels.sqround.kernel import narrow_words
    from repro_torch.parallel import collectives

    monkeypatch.setattr(collectives, "CHUNK", 1 << 16)
    gen = torch.Generator(device=cuda).manual_seed(31)
    grads = {"a": {"w": torch.randn(3, 300, 500, generator=gen, device=cuda)},
             "b": torch.randn(1000, generator=gen, device=cuda) * 1e-3,
             "z": torch.zeros(7, 9, device=cuda)}
    cpu = {"a": {"w": grads["a"]["w"].cpu()}, "b": grads["b"].cpu(), "z": grads["z"].cpu()}
    key = prng.PRNGKey(9)
    before = sq_kernel.SQROUND.launches
    collectives.fake_grad_compression(grads, 8, key)
    assert sq_kernel.SQROUND.launches - before == 7 + 1 + 1        # ⌈450,000 / 65,536⌉ + 1 + 1
    collectives.fake_grad_compression(cpu, 8, key)
    for a, b in ((grads["a"]["w"], cpu["a"]["w"]), (grads["b"], cpu["b"]), (grads["z"], cpu["z"])):
        assert torch.equal(a.cpu(), b)
    v = torch.randn(1, 1 << 16, generator=gen, device=cuda)
    words = (prng._bits_flat(key, 0, 1 << 16, cuda) & ~0x1FF).view(1, -1)
    scale = v.abs().amax()
    assert torch.equal(sq_kernel.sqround_cuda(v, narrow_words(words), scale, 8),
                       sqround_ref(v, words, scale, 8))
