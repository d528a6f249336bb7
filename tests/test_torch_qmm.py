"""The port's packed matmul path against the JAX reference.

On the CPU ``repro_torch``'s ``qmm`` runs its plain version (``qmm_ref``);
here it is held against the reference's Pallas kernel run in interpret mode
(``qmm(..., use_pallas=True, interpret=True)``) and against the reference's
``qmm_ref``. Tolerance rtol 1e-5 plus atol 1e-5·(|x|@|w|ᵀ): the summation
order differs (the reference's own kernel-vs-oracle bound). Packed bytes and
scales are compared bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.qmm.ops import (
    pack_operator as jax_pack_operator,
    pack_weights as jax_pack_weights,
    packed_matvec as jax_packed_matvec,
    packed_rmatvec as jax_packed_rmatvec,
    qmm as jax_qmm,
)
from repro.kernels.qmm.ref import qmm_ref as jax_qmm_ref
from repro_torch import convert
from repro_torch.kernels.qmm import kernel as qmm_kernel
from repro_torch.kernels.qmm.ops import (
    PackedWeights,
    pack_operator,
    pack_weights,
    packed_matvec,
    packed_rmatvec,
    qmm,
)
from repro_torch.kernels.qmm.ref import qmm_ref
from repro_torch.quant.pack import unpack_codes


@pytest.fixture(autouse=True, scope="module")
def _leave_no_jax_executables():
    """Drop the JAX executables this module's reference calls compiled: an
    eager primitive cached with jax_debug_nans off would keep later tests in
    the process (tests/test_sanitize.py) from tripping."""
    yield
    jax.clear_caches()


BITS = [2, 4, 8]
# (M, N, K): ragged M, N and K, a K that fills whole bytes, and tiny edges
SHAPES = [(1, 7, 5), (5, 33, 97), (3, 130, 870)]


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """The port reproduces jax.random under jax_threefry_partitionable=True
    (JAX 0.9's default): hold the reference to that mode whatever the
    process default is."""
    with jax.threefry_partitionable(True):
        yield


def _j(a):
    return jnp.asarray(a, dtype=a.dtype)


def _keys(seed):
    jk = jax.random.PRNGKey(seed)
    return jk, convert.key_from_numpy(np.asarray(jk))


def _bound(x, w: PackedWeights):
    """1e-5·(|x| @ |dequant(w)|ᵀ): the f32 summation-order bound."""
    codes = unpack_codes(w.packed, w.bits, w.k_dim).to(torch.float32).abs()
    wabs = codes * (w.scale.reshape(-1, 1).abs() / (2 ** (w.bits - 1) // 2))
    return 1e-5 * (x.abs() @ wabs.T)


def assert_qmm_close(got, want, bound):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want) + np.asarray(bound))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", BITS)
def test_qmm_matches_pallas_interpret_and_ref(shape, bits):
    m, n, k = shape
    rng = np.random.default_rng(m * n * k + bits)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((n, k)).astype(np.float32)
    jk, tk = _keys(bits)
    pw_j = jax_pack_weights(_j(w), bits, jk)
    pw_t = convert.packed_weights_from_numpy(pw_j, "cpu")
    x_t = torch.from_numpy(x)
    y_t = qmm(x_t, pw_t)
    bound = _bound(x_t, pw_t)
    assert_qmm_close(y_t, jax_qmm(_j(x), pw_j, use_pallas=True, interpret=True), bound)
    assert_qmm_close(y_t, jax_qmm_ref(_j(x), pw_j.packed, pw_j.scale, bits, k), bound)
    assert_qmm_close(qmm_ref(x_t, pw_t.packed, pw_t.scale, bits, k), y_t, bound)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("per_channel", [False, True])
def test_pack_weights_bitwise(bits, per_channel):
    w = np.random.default_rng(bits).standard_normal((19, 45)).astype(np.float32)
    jk, tk = _keys(20 + bits)
    pj = jax_pack_weights(_j(w), bits, jk, per_channel=per_channel)
    pt = pack_weights(torch.from_numpy(w), bits, tk, per_channel=per_channel)
    np.testing.assert_array_equal(pt.packed.numpy(), np.asarray(pj.packed))
    np.testing.assert_array_equal(pt.scale.numpy(), np.asarray(pj.scale))
    assert (pt.bits, pt.k_dim, str(pt.granularity)) == (pj.bits, pj.k_dim, str(pj.granularity))


@pytest.mark.parametrize("bits", [2, 8])
@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("shared", [True, False])
def test_pack_operator_bitwise(bits, kind, shared):
    rng = np.random.default_rng(31)
    phi = rng.standard_normal((24, 40)).astype(np.float32)
    if kind == "complex":
        phi = np.asarray(phi + 1j * rng.standard_normal((24, 40)), dtype=np.complex64)
    jk, tk = _keys(40 + bits)
    oj = jax_pack_operator(_j(phi), bits, jk, shared=shared)
    ot = pack_operator(torch.from_numpy(phi), bits, tk, shared=shared)
    assert ot.is_complex == oj.is_complex and ot.nbytes == oj.nbytes
    for name in ("fwd_re", "fwd_im", "adj_re", "adj_im"):
        wj, wt = getattr(oj, name), getattr(ot, name)
        if wj is None:
            assert wt is None
            continue
        np.testing.assert_array_equal(wt.packed.numpy(), np.asarray(wj.packed))
        np.testing.assert_array_equal(wt.scale.numpy(), np.asarray(wj.scale))


@pytest.mark.parametrize("phi_kind", ["real", "complex"])
@pytest.mark.parametrize("x_kind", ["real", "complex"])
@pytest.mark.parametrize("batch", [0, 3])
def test_packed_matvec_rmatvec(phi_kind, x_kind, batch):
    """Φ̂x and Φ̂†r through the 1-, 2- and 4-call decompositions."""
    bits = 2 if batch else 8
    rng = np.random.default_rng(bits + batch)
    m, n = 48, 96
    phi = rng.standard_normal((m, n)).astype(np.float32)
    if phi_kind == "complex":
        phi = np.asarray(phi + 1j * rng.standard_normal((m, n)), dtype=np.complex64)

    def vec(length):
        shp = (batch, length) if batch else (length,)
        v = rng.standard_normal(shp).astype(np.float32)
        if x_kind == "complex":
            v = np.asarray(v + 1j * rng.standard_normal(shp), dtype=np.complex64)
        return v

    x, r = vec(n), vec(m)
    jk, _ = _keys(50)
    oj = jax_pack_operator(_j(phi), bits, jk, shared=True)
    ot = convert.packed_operator_from_numpy(oj, "cpu")
    for got, want in ((packed_matvec(ot, torch.from_numpy(x)), jax_packed_matvec(oj, _j(x))),
                      (packed_rmatvec(ot, torch.from_numpy(r)), jax_packed_rmatvec(oj, _j(r)))):
        want = np.asarray(want)
        assert got.shape == want.shape and got.is_complex() == np.iscomplexobj(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_cpu_dispatch_never_launches_the_kernel():
    before = qmm_kernel.QMM.launches
    w = pack_weights(torch.randn(16, 40), 4)
    y = qmm(torch.randn(3, 40), w)
    assert y.shape == (3, 16) and y.dtype == torch.float32
    assert qmm_kernel.QMM.launches == before == 0
    assert not qmm_kernel.QMM.launches_by_shape
    assert qmm_kernel.QMM._lib is None          # nothing was built either


def test_qmm_checks_shapes_and_devices():
    w = pack_weights(torch.randn(16, 40), 2)
    with pytest.raises(ValueError):
        qmm(torch.randn(3, 41), w)
    with pytest.raises(ValueError, match="CUDA"):
        qmm_kernel.qmm_cuda(torch.randn(3, 40), w.packed, w.scale, 2, 40)


def test_w_t_is_accepted_and_ignored():
    op = pack_operator(torch.randn(16, 40), 4, shared=True)
    x = torch.randn(2, 40)
    torch.testing.assert_close(qmm(x, op.fwd_re, w_t=op.adj_re), qmm(x, op.fwd_re),
                               rtol=0, atol=0)


def test_build_dir_is_under_the_checkout():
    assert qmm_kernel.build_dir().parts[-2:] == ("build", "repro_torch")
    assert qmm_kernel.SOURCE.is_file()
    assert "sm_90a" in " ".join(qmm_kernel.NVCC_FLAGS)
