"""Tests of the Hopper qmm kernel that need the card (marker ``cuda``).

They skip on a machine without a GPU and nvcc; on the card run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance, as in the CPU tests: |Δ| ≤ 1e-5·|ref| + 1e-5·(|x|@|w|ᵀ) against the
plain version, with TF32 off.
"""
import shutil
from pathlib import Path

import pytest
import torch

from repro_torch import random as prng
from repro_torch.core.niht import qniht_batch
from repro_torch.kernels.qmm import kernel as qmm_kernel
from repro_torch.kernels.qmm.ops import pack_operator, pack_weights, qmm
from repro_torch.kernels.qmm.ref import qmm_ref
from repro_torch.quant.pack import unpack_codes

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
