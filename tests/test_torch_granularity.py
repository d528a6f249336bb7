"""Block-scaled (per_block) and per-channel packed Φ̂ of the port against the
JAX reference, on identical inputs made with numpy from a seed.

Codes, scales and packed bytes are compared bit for bit (same IEEE f32
operations in the same order, and the same uniforms from the same key).
``qmm_group_ref`` agrees with the reference to 1e-5 relative plus
1e-5·(|x|@|w|ᵀ): the two differ only in f32 summation order. Solves agree to
‖Δx‖ ≤ 1e-3·‖x_jax‖ with identical supports (the reference's own
packed-vs-dense contract).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.niht import qniht as jax_qniht, qniht_batch as jax_qniht_batch
from repro.core.operators import PackedStreamingOperator as JaxPackedStreamingOperator
from repro.kernels.qmm.ops import (
    pack_operator as jax_pack_operator,
    pack_weights as jax_pack_weights,
    packed_matvec as jax_packed_matvec,
    packed_rmatvec as jax_packed_rmatvec,
    qmm as jax_qmm,
)
from repro.kernels.qmm.ref import qmm_group_ref as jax_qmm_group_ref
from repro.quant import policy as jax_policy
from repro.quant.pack import validate_group_packing as jax_validate_group_packing
from repro.quant.quantize import (
    block_scale as jax_block_scale,
    dequantize_codes as jax_dequantize_codes,
    expand_block_scale as jax_expand_block_scale,
    fake_quantize as jax_fake_quantize,
    quantize as jax_quantize,
    quantize_codes as jax_quantize_codes,
)
from repro_torch import convert
from repro_torch.core.operators import PackedStreamingOperator
from repro_torch.kernels.qmm import kernel as qmm_kernel
from repro_torch.kernels.qmm.ops import (
    pack_operator,
    pack_weights,
    packed_matvec,
    packed_rmatvec,
    qmm,
)
from repro_torch.kernels.qmm.ref import qmm_group_ref
from repro_torch.core.niht import qniht, qniht_batch
from repro_torch.quant import policy
from repro_torch.quant.pack import unpack_codes, validate_group_packing
from repro_torch.quant.quantize import (
    block_scale,
    dequantize_codes,
    expand_block_scale,
    fake_quantize,
    quantize,
    quantize_codes,
)
from torch_threads import one_torch_thread  # noqa: F401 -- autouse: one intra-op thread


@pytest.fixture(autouse=True, scope="module")
def _leave_no_jax_executables():
    """Drop the JAX executables this module's reference calls compiled: an
    eager primitive cached with jax_debug_nans off would keep later tests in
    the process (tests/test_sanitize.py) from tripping."""
    yield
    jax.clear_caches()


REPO = Path(__file__).resolve().parents[1]
BITS = [2, 4, 8]
# g = the packing word (8 // bits), 16 and 64; K = 101 leaves every last group short
GROUPS = ["vpb", 16, 64]


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


def _group(g, bits):
    return 8 // bits if g == "vpb" else g


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return np.asarray(rng.standard_normal(shape) + 1j * rng.standard_normal(shape),
                      dtype=np.complex64)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("n", [1, 64, 101])
@pytest.mark.parametrize("g", [1, 16, 64])
def test_block_scale_and_expand_bitwise(n, g):
    v = _real((5, n), n + g)
    v[1, :] = 0.0                                 # an all-zero row guards to scale 1
    sj, st = jax_block_scale(_j(v), g), block_scale(torch.from_numpy(v), g)
    _eq(st, sj)
    _eq(expand_block_scale(st, g, n), jax_expand_block_scale(sj, g, n))


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("stochastic", [True, False])
def test_quantize_codes_per_block_bitwise(bits, g, stochastic):
    g = _group(g, bits)
    v = _real((13, 101), bits + g)
    jk, tk = _keys(g) if stochastic else (None, None)
    gran = f"per_block:{g}"
    cj, sj = jax_quantize_codes(_j(v), bits, jk, granularity=gran)
    ct, st = quantize_codes(torch.from_numpy(v), bits, tk, granularity=gran)
    assert tuple(st.shape) == (13, -(-101 // g))
    _eq(ct, cj)
    _eq(st, sj)
    _eq(dequantize_codes(ct, st, bits, granularity=gran),
        jax_dequantize_codes(cj, sj, bits, granularity=gran))


@pytest.mark.parametrize("bits", BITS)
def test_quantize_codes_explicit_block_scale(bits):
    """An explicit compact (N, ⌈K/g⌉) scale is expanded along the last axis."""
    v = _real((6, 40), bits)
    scale = np.abs(_real((6, 3), 3 * bits)) + 0.5
    cj, _ = jax_quantize_codes(_j(v), bits, None, _j(scale), granularity="per_block:16")
    ct, st = quantize_codes(torch.from_numpy(v), bits, None, torch.from_numpy(scale),
                            granularity="per_block:16")
    _eq(ct, cj)
    np.testing.assert_array_equal(st.numpy(), scale)


@pytest.mark.parametrize("gran", ["per_channel", "per_block:16"])
@pytest.mark.parametrize("bits", BITS)
def test_quantize_complex_granular_bitwise(bits, gran):
    """Real and imaginary parts share one scale per group (their max)."""
    v = _complex((9, 70), bits)
    jk, tk = _keys(bits + 1)
    qj = jax_quantize(_j(v), bits, jk, granularity=gran)
    qt = quantize(torch.from_numpy(v), bits, tk, granularity=gran)
    _eq(qt.codes, qj.codes)
    _eq(qt.scale, qj.scale)
    _eq(qt.elementwise_scale(), qj.elementwise_scale())
    _eq(qt.dequantize(), qj.dequantize())


@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("bits", BITS)
def test_fake_quantize_per_block_bitwise(kind, bits):
    v = _real((12, 75), 4) if kind == "real" else _complex((12, 75), 4)
    jk, tk = _keys(30 + bits)
    out_j = np.asarray(jax_fake_quantize(_j(v), bits, jk, granularity="per_block:8"))
    out_t = fake_quantize(torch.from_numpy(v), bits, tk, granularity="per_block:8")
    assert out_t.dtype == torch.from_numpy(v).dtype
    np.testing.assert_array_equal(out_t.numpy(), out_j)


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("bits", BITS)
def test_pack_weights_per_block_bitwise(bits, g):
    g = _group(g, bits)
    w = _real((19, 101), 50 + bits)
    jk, tk = _keys(60 + g)
    pj = jax_pack_weights(_j(w), bits, jk, granularity=f"per_block:{g}")
    pt = pack_weights(torch.from_numpy(w), bits, tk, granularity=f"per_block:{g}")
    _eq(pt.packed, pj.packed)
    _eq(pt.scale, pj.scale)
    assert (pt.bits, pt.k_dim, str(pt.granularity)) == (pj.bits, pj.k_dim, str(pj.granularity))
    assert pt.nbytes == pj.nbytes and pt.scale_nbytes == pj.scale_nbytes


@pytest.mark.parametrize("bits,g", [(2, 6), (4, 3), (2, 2)])
def test_validate_group_packing_matches_reference(bits, g):
    with pytest.raises(ValueError, match="straddle"):
        jax_validate_group_packing(g, bits)
    with pytest.raises(ValueError, match="straddle"):
        validate_group_packing(g, bits)
    with pytest.raises(ValueError, match="straddle"):
        pack_weights(torch.ones(3, 24), bits, granularity=f"per_block:{g}")


@pytest.mark.parametrize("bits,kind,gran", [(2, "complex", "per_block:16"),
                                            (2, "complex", "per_channel"),
                                            (4, "real", "per_block:16"),
                                            (4, "real", "per_channel")])
def test_pack_operator_per_orientation_bitwise(bits, kind, gran):
    """shared=False: each orientation (and part) from split(key, 2) or
    split(key, 4), scales along each orientation's own contraction axis."""
    phi = _real((24, 70), 31) if kind == "real" else _complex((24, 70), 31)
    jk, tk = _keys(40 + bits)
    oj = jax_pack_operator(_j(phi), bits, jk, shared=False, granularity=gran)
    ot = pack_operator(torch.from_numpy(phi), bits, tk, shared=False, granularity=gran)
    assert ot.nbytes == oj.nbytes and ot.scale_nbytes == oj.scale_nbytes
    for name in ("fwd_re", "fwd_im", "adj_re", "adj_im"):
        wj, wt = getattr(oj, name), getattr(ot, name)
        if wj is None:
            assert wt is None
            continue
        _eq(wt.packed, wj.packed)
        _eq(wt.scale, wj.scale)
        assert str(wt.granularity) == str(wj.granularity)


@pytest.mark.parametrize("gran", ["per_channel", "per_block:16"])
def test_shared_codes_refuse_orientation_scales(gran):
    with pytest.raises(ValueError, match="shared=True"):
        jax_pack_operator(jnp.ones((4, 8)), 4, shared=True, granularity=gran)
    with pytest.raises(ValueError, match="shared=True"):
        pack_operator(torch.ones(4, 8), 4, shared=True, granularity=gran)


def _group_bound(x: torch.Tensor, w) -> np.ndarray:
    """1e-5·(|x| @ |dequant(w)|ᵀ): the f32 summation-order bound."""
    g, k = w.granularity.group_size, w.k_dim
    wabs = (unpack_codes(w.packed, w.bits, k).to(torch.float32).abs()
            * expand_block_scale(w.scale, g, k) / (2 ** (w.bits - 1) // 2))
    return 1e-5 * (x.abs() @ wabs.T).numpy()


def _assert_close(got: torch.Tensor, want, bound) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert np.all(np.abs(got.numpy() - want) <= 1e-5 * np.abs(want) + bound)


@pytest.mark.parametrize("shape,g", [((5, 33, 101), 16), ((3, 130, 870), 64)])
@pytest.mark.parametrize("bits", BITS)
def test_qmm_group_ref_matches_reference(bits, g, shape):
    """Against the reference's plain version and, at the smaller shape and 2
    bits, its Pallas kernel run in interpret mode; ragged M, N, K, short last
    groups."""
    m, n, k = shape
    rng = np.random.default_rng(m * n + k + bits + g)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((n, k)).astype(np.float32)
    jk, _ = _keys(bits + g)
    pw_j = jax_pack_weights(_j(w), bits, jk, granularity=f"per_block:{g}")
    pw_t = convert.packed_weights_from_numpy(pw_j, "cpu")
    assert tuple(pw_t.scale.shape) == (n, -(-k // g))
    x_t = torch.from_numpy(x)
    got = qmm_group_ref(x_t, pw_t.packed, pw_t.scale, bits, k, g)
    bound = _group_bound(x_t, pw_t)
    _assert_close(got, jax_qmm_group_ref(_j(x), pw_j.packed, pw_j.scale, bits, k, g), bound)
    if n == 33 and bits == 2:
        _assert_close(got, jax_qmm(_j(x), pw_j, use_pallas=True, interpret=True), bound)
    # qmm on a CPU tensor routes per_block weights to the plain group version
    torch.testing.assert_close(qmm(x_t, pw_t), got, rtol=0, atol=0)


def test_cpu_group_dispatch_never_launches_a_kernel():
    before = (qmm_kernel.QMM.launches, qmm_kernel.QMM_GROUP.launches)
    w = pack_weights(torch.randn(16, 40), 4, granularity="per_block:8")
    y = qmm(torch.randn(3, 40), w)
    assert y.shape == (3, 16)
    assert (qmm_kernel.QMM.launches, qmm_kernel.QMM_GROUP.launches) == before == (0, 0)
    assert qmm_kernel.QMM_GROUP._lib is None
    with pytest.raises(ValueError, match="CUDA"):
        qmm_kernel.qmm_group_cuda(torch.randn(3, 40), w.packed, w.scale, 4, 40, 8)


@pytest.mark.parametrize("gran", ["per_block:16"])
@pytest.mark.parametrize("batch", [3])
def test_granular_packed_matvec_rmatvec(gran, batch):
    """Φ̂x and Φ̂†r of a complex per-orientation operator, complex x and r."""
    rng = np.random.default_rng(7 + batch)
    m, n = 40, 90
    phi = _complex((m, n), 5)

    def vec(length):
        shp = (batch, length) if batch else (length,)
        return np.asarray(rng.standard_normal(shp) + 1j * rng.standard_normal(shp),
                          dtype=np.complex64)

    x, r = vec(n), vec(m)
    jk, _ = _keys(70)
    oj = jax_pack_operator(_j(phi), 4, jk, granularity=gran)
    ot = convert.packed_operator_from_numpy(oj, "cpu")
    for got, want in ((packed_matvec(ot, torch.from_numpy(x)), jax_packed_matvec(oj, _j(x))),
                      (packed_rmatvec(ot, torch.from_numpy(r)), jax_packed_rmatvec(oj, _j(r)))):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("gran", ["per_block:16"])
def test_packed_streaming_operator_pack(gran):
    phi = _complex((24, 48), 9)
    jk, tk = _keys(9)
    opj = JaxPackedStreamingOperator.pack(_j(phi), 4, jk, granularity=gran)
    opt = PackedStreamingOperator.pack(torch.from_numpy(phi), 4, tk, granularity=gran)
    assert str(opt.granularity) == str(opj.granularity)
    assert (opt.nbytes, opt.scale_nbytes, opt.shape) == (opj.nbytes, opj.scale_nbytes,
                                                        tuple(opj.shape))
    _eq(opt.packed.adj_im.packed, opj.packed.adj_im.packed)
    _eq(opt.packed.adj_im.scale, opj.packed.adj_im.scale)


def _gaussian(m, n, s, batch, seed):
    rng = np.random.default_rng(seed)
    phi = rng.standard_normal((m, n)).astype(np.float32)
    X = np.zeros((batch, n), np.float32)
    for b in range(batch):
        X[b, rng.choice(n, s, replace=False)] = rng.standard_normal(s)
    Y = X @ phi.T
    Y += 0.05 * np.sqrt(np.mean(Y**2)) * rng.standard_normal(Y.shape)
    return phi, Y.astype(np.float32), X


def _assert_solve_close(res_t, res_j):
    xj, xt = np.asarray(res_j.x), res_t.x.numpy()
    assert np.linalg.norm(xt - xj) <= 1e-3 * np.linalg.norm(xj)
    np.testing.assert_array_equal(xt != 0, xj != 0)
    np.testing.assert_allclose(res_t.trace.resid_q.numpy(), np.asarray(res_j.trace.resid_q),
                               rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("gran,bits,batch", [("per_block", 4, 1), ("per_block", 8, 3),
                                             ("per_channel", 8, 3)])
def test_gaussian_granular_solve_matches_reference(gran, bits, batch):
    """gaussian-smoke shape (64×128, s=6), g = 16 for per_block."""
    phi, Y, X = _gaussian(64, 128, 6, batch, seed=200 + bits)
    jk, tk = _keys(20 + bits)
    kw = dict(bits_phi=bits, bits_y=8, requantize="fixed", backend="packed",
              scale_granularity=gran, group_size=16 if gran == "per_block" else None)
    if batch == 1:
        res_j = jax_qniht(_j(phi), _j(Y[0]), 6, 25, key=jk, **kw)
        res_t = qniht(torch.from_numpy(phi), torch.from_numpy(Y[0]), 6, 25, key=tk, **kw)
    else:
        res_j = jax_qniht_batch(_j(phi), _j(Y), 6, 25, key=jk, **kw)
        res_t = qniht_batch(torch.from_numpy(phi), torch.from_numpy(Y), 6, 25, key=tk, **kw)
    _assert_solve_close(res_t, res_j)


def _lofar_smoke():
    """The LOFAR smoke station's Φ (870×1,024 complex) and 2 skies, from the
    reference's own functions, handed to both packages as numpy."""
    from repro.configs.lofar_cs302 import SMOKE
    from repro.sensing.sky import make_sky
    from repro.sensing.telescope import Station, measurement_matrix, visibilities

    phi = measurement_matrix(Station(n_antennas=SMOKE.n_antennas, seed=SMOKE.seed),
                             SMOKE.resolution, SMOKE.extent)
    key = jax.random.PRNGKey(4)
    skies = [make_sky(SMOKE.resolution, SMOKE.n_sources, jax.random.fold_in(key, b),
                      min_sep=SMOKE.min_sep) for b in range(2)]
    Y = np.stack([np.asarray(visibilities(phi, x, SMOKE.snr_db, jax.random.fold_in(key, b))[0])
                  for b, x in enumerate(skies)])
    return SMOKE, np.asarray(phi), Y


def test_lofar_smoke_per_block_solve_matches_reference():
    cs, phi, Y = _lofar_smoke()
    jk, tk = _keys(12)
    kw = dict(bits_phi=2, bits_y=8, requantize="fixed", backend="packed", real_signal=True,
              nonneg=True, scale_granularity="per_block", group_size=16)
    res_j = jax_qniht_batch(_j(phi), _j(Y), cs.n_sources, 10, key=jk, **kw)
    res_t = qniht_batch(torch.from_numpy(phi), torch.from_numpy(Y), cs.n_sources, 10,
                        key=tk, **kw)
    _assert_solve_close(res_t, res_j)


@pytest.mark.parametrize("kw", [dict(scale_granularity="per_block", group_size=16),
                                dict(scale_granularity="per_channel")])
def test_granularity_needs_the_packed_backend(kw):
    phi, Y, _ = _gaussian(16, 32, 2, 1, seed=3)
    jk, tk = _keys(0)
    with pytest.raises(ValueError, match="packed"):
        jax_qniht(_j(phi), _j(Y[0]), 2, 3, key=jk, bits_phi=4, **kw)
    with pytest.raises(ValueError, match="packed"):
        qniht(torch.from_numpy(phi), torch.from_numpy(Y[0]), 2, 3, key=tk, bits_phi=4, **kw)


@pytest.mark.parametrize("name", ["FULL_PRECISION", "W8", "W4", "W4KV8", "W2KV8",
                                  "PAPER_2_8", "PAPER_4_8", "PAPER_8_8"])
def test_named_policies_match_reference(name):
    a, b = getattr(policy, name), getattr(jax_policy, name)
    fields = ("weight_bits", "kv_bits", "grad_bits", "stochastic", "phi_bits", "y_bits",
              "scale_granularity", "group_size")
    assert [getattr(a, f) for f in fields] == [getattr(b, f) for f in fields]
    assert (a.quantizes_weights, a.quantizes_kv, a.quantizes_grads) == (
        b.quantizes_weights, b.quantizes_kv, b.quantizes_grads)


@pytest.mark.parametrize("kw", [dict(phi_bits=3), dict(scale_granularity="per_block"),
                                dict(scale_granularity="per_cube")])
def test_policy_validates_like_reference(kw):
    with pytest.raises(ValueError):
        jax_policy.QuantPolicy(**kw)
    with pytest.raises(ValueError):
        policy.QuantPolicy(**kw)


def test_policy_granularity():
    p = policy.QuantPolicy(phi_bits=2, y_bits=8, scale_granularity="per_block", group_size=64)
    q = jax_policy.QuantPolicy(phi_bits=2, y_bits=8, scale_granularity="per_block",
                               group_size=64)
    assert str(p.granularity) == str(q.granularity) == "per_block:64"
    assert p.granularity.scale_nbytes((870, 65536)) == q.granularity.scale_nbytes((870, 65536))


def test_recover_cli_per_block_on_cpu():
    """The command line of the README, in a process of its own."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.recover", "--config", "gaussian-smoke",
         "--backend", "packed", "--bits-phi", "8", "--device", "cpu",
         "--scale-granularity", "per_block", "--group-size", "16"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("[recover] gaussian-smoke 8&8bit[packed]: rel_error=")
    assert float(line.split("rel_error=")[1].split()[0]) < 0.2


@pytest.mark.parametrize("argv", [["--scale-granularity", "per_block", "--group-size", "8",
                                   "--batch", "2"],
                                  ["--scale-granularity", "per_channel", "--batch", "2"]])
def test_recover_cli_granular_on_cpu(argv, capsys):
    from repro_torch.launch import recover

    recover.main(["--config", "gaussian-smoke", "--backend", "packed", "--bits-phi", "8",
                  "--device", "cpu", *argv])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[recover] gaussian-smoke 8&8bit[packed]: ")
    rel = float(line.split("rel_error" + ("_mean=" if "--batch" in argv else "="))[1].split()[0])
    assert rel < 0.2


@pytest.mark.parametrize("argv,match", [
    (["--backend", "fake", "--scale-granularity", "per_block", "--group-size", "16"],
     "--backend packed"),
    (["--backend", "packed", "--scale-granularity", "per_block"], "--group-size"),
])
def test_recover_cli_granularity_rules(argv, match, capsys):
    from repro_torch.launch import recover

    with pytest.raises((SystemExit, ValueError)) as exc:
        recover.main(["--device", "cpu", "--config", "gaussian-smoke", *argv])
    text = str(exc.value) + capsys.readouterr().err
    assert match in text
