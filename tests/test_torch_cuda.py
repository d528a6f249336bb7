"""Tests of the Hopper kernels that need the card (marker ``cuda``).

They skip on a machine without a GPU and nvcc; on the card run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance for qmm and qmm_group, as in the CPU tests: |Δ| ≤ 1e-5·|ref| +
1e-5·(|x|@|w|ᵀ) against the plain version, with TF32 off. hist and mask
equal their plain versions bit for bit.
"""
import shutil
from pathlib import Path

import pytest
import torch

from repro_torch import random as prng
from repro_torch.core.niht import qniht_batch
from repro_torch.core.niht import qniht
from repro_torch.kernels.hsthresh import kernel as hs_kernel
from repro_torch.kernels.hsthresh.ops import hsthresh
from repro_torch.kernels.hsthresh.ref import hist_ref, mask_ref, row_vmax
from repro_torch.kernels.qmm import kernel as qmm_kernel
from repro_torch.kernels.qmm.ops import pack_operator, pack_weights, qmm
from repro_torch.kernels.qmm.ref import qmm_group_ref, qmm_ref
from repro_torch.quant.pack import unpack_codes
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
                                   (64, 64, 2048), (3, 7, 5)])
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
    before = (qmm_kernel.QMM.launches, qmm_kernel.QMM_GROUP.launches)
    y = qmm(x, w)
    assert (qmm_kernel.QMM.launches, qmm_kernel.QMM_GROUP.launches) == (before[0],
                                                                         before[1] + 1)
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
    with pytest.raises(ValueError):
        qmm_kernel.qmm_group_cuda(x, w.packed, w.scale[:, :2].contiguous(), 4, 40, 8)


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
    x = torch.randn(5, 3000, generator=torch.Generator().manual_seed(1))
    before = (hs_kernel.HIST.launches, hs_kernel.MASK.launches)
    out = hsthresh(x.to(cuda), 17)
    assert (hs_kernel.HIST.launches, hs_kernel.MASK.launches) == (before[0] + 1,
                                                                   before[1] + 1)
    assert torch.equal(out.cpu(), hsthresh(x, 17))


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
