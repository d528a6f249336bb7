"""The port's MRI path against the JAX reference: the PRNG draws it rests on
(``randint``, ``normal``), the wavelet transform, the matrix-free operators,
the instances (masks, phantoms, observations, per-band quantization) and the
solves.

Tolerances: integer artifacts and everything numpy draws from a seed are
bitwise (``randint`` words, masks, phantoms, band indices, sparsified
phantoms); ``normal`` within 1e-6 (XLA's float32 erfinv polynomial, the order
of its float operations aside); transforms and operators within 1e-5
(absolute, on unit-scale data); per-band ŷ within 1e-6; solves within 1e-3
(‖Δx‖ ≤ 1e-3·‖x‖ with the same support, PSNR within 0.01 dB).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import operators as jops
from repro.sensing import mri as jmri
from repro.transforms import wavelet as jwav
from repro_torch import convert, random as prng
from repro_torch.core import operators as tops
from repro_torch.core.niht import qniht, qniht_batch
from repro_torch.core.recovery import psnr
from repro_torch.launch import recover
from repro_torch.sensing import mri as tmri
from repro_torch.transforms import wavelet as twav
from torch_threads import one_torch_thread  # noqa: F401 -- autouse: one intra-op thread


@pytest.fixture(autouse=True, scope="module")
def _leave_no_jax_executables():
    """Drop the JAX executables this module's reference calls compiled: an
    eager primitive cached with jax_debug_nans off would keep later tests in
    the process (tests/test_sanitize.py) from tripping."""
    yield
    jax.clear_caches()


jniht = importlib.import_module("repro.core.niht")


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


# --- random: randint, normal ------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 5, 302, 2**31 - 1, -7])
@pytest.mark.parametrize("bounds", [(0, 2**31 - 1), (0, 10), (-5, 7), (3, 3), (9, 2),
                                    (-2**31, 2**31 - 1), (7, 70000)])
def test_randint_matches_jax_bit_for_bit(seed, bounds):
    jk, tk = _keys(seed)
    want = np.asarray(jax.random.randint(jk, (257,), *bounds))
    got = prng.randint(tk, (257,), *bounds)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 5, 42])
def test_randint_scalar_is_the_mask_seed(seed):
    jk, tk = _keys(seed)
    assert int(prng.randint(tk, (), 0, 2**31 - 1)) == int(
        jax.random.randint(jk, (), 0, 2**31 - 1))


def test_randint_refuses_bounds_past_int32():
    with pytest.raises(OverflowError):
        prng.randint(prng.PRNGKey(0), (3,), 0, 2**31)


@pytest.mark.parametrize("seed", [0, 1, 7, 302])
def test_normal_matches_jax_within_1e6(seed):
    jk, tk = _keys(seed)
    want = np.asarray(jax.random.normal(jk, (200_000,)))
    got = prng.normal(tk, (200_000,))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-6


# --- wavelets -----------------------------------------------------------------

def test_filters_and_levels_match_reference():
    for w in ("haar", "db4"):
        assert twav.wavelet_filters(w) == jwav.wavelet_filters(w)
        for r in (1, 2, 4, 6, 8, 12, 64, 256):
            assert twav.max_levels(r, w) == jwav.max_levels(r, w)
    with pytest.raises(ValueError):
        twav.wavelet_filters("db8")


@pytest.mark.parametrize("levels", [None, 1, 2])
@pytest.mark.parametrize("wavelet", ["haar", "db4"])
@pytest.mark.parametrize("complex_input", [False, True])
def test_dwt2_idwt2_match_reference(wavelet, levels, complex_input):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    if complex_input:
        x = np.asarray(x + 1j * rng.standard_normal(x.shape), dtype=np.complex64)
    for fj, ft in ((jwav.dwt2, twav.dwt2), (jwav.idwt2, twav.idwt2)):
        want = np.asarray(fj(_j(x), wavelet, levels))
        got = ft(torch.from_numpy(x), wavelet, levels).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("wavelet", ["haar", "db4"])
def test_dwt2_round_trip_and_adjoint(wavelet):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 32, 32)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((3, 32, 32)).astype(np.float32))
    torch.testing.assert_close(twav.idwt2(twav.dwt2(x, wavelet), wavelet), x,
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(torch.linalg.vector_norm(twav.dwt2(x, wavelet)),
                               torch.linalg.vector_norm(x), rtol=1e-5, atol=0)
    lhs = float((twav.dwt2(x, wavelet) * c).sum())
    rhs = float((x * twav.idwt2(c, wavelet)).sum())
    assert abs(lhs - rhs) <= 1e-5 * float(torch.linalg.vector_norm(x)
                                          * torch.linalg.vector_norm(c))


def test_flatten_unflatten_and_bad_shapes():
    v = torch.arange(2 * 64, dtype=torch.float32).reshape(2, 64)
    assert torch.equal(twav.flatten_coeffs(twav.unflatten_coeffs(v, 8)), v)
    with pytest.raises(ValueError):
        twav.dwt2(torch.zeros(4, 8))
    with pytest.raises(ValueError):
        twav.dwt2(torch.zeros(8, 8), "haar", levels=9)


# --- operators ------------------------------------------------------------------

def _fourier_pair(r=32, fraction=0.4, seed=1):
    jk, tk = _keys(seed)
    mask = jmri.cartesian_mask(r, fraction, jk)
    assert np.array_equal(mask, tmri.cartesian_mask(r, fraction, tk))
    return (jops.SubsampledFourierOperator.from_mask(mask),
            tops.SubsampledFourierOperator.from_mask(mask, device="cpu"))


def _composed_pair(r=32, wavelet="haar"):
    fj, ft = _fourier_pair(r)
    return (jops.ComposedOperator(fj, jops.WaveletSynthesisOperator(r, wavelet)),
            tops.ComposedOperator(ft, tops.WaveletSynthesisOperator(r, wavelet)))


@pytest.mark.parametrize("kind", ["fourier", "haar", "db4", "synthesis"])
@pytest.mark.parametrize("batched", [False, True])
def test_operators_match_reference(kind, batched):
    if kind == "fourier":
        oj, ot = _fourier_pair()
    elif kind == "synthesis":
        oj, ot = jops.WaveletSynthesisOperator(32, "db4"), tops.WaveletSynthesisOperator(32, "db4")
    else:
        oj, ot = _composed_pair(wavelet=kind)
    assert tuple(ot.shape) == tuple(oj.shape) and ot.nbytes == oj.nbytes
    assert str(ot.dtype).split(".")[-1] == str(np.dtype(oj.dtype))
    rng = np.random.default_rng(5)
    lead = (3,) if batched else ()
    x = rng.standard_normal(lead + (oj.shape[1],)).astype(np.float32)
    r = np.asarray(rng.standard_normal(lead + (oj.shape[0],))
                   + 1j * rng.standard_normal(lead + (oj.shape[0],)), dtype=np.complex64)
    if kind == "synthesis":
        r = r.real.copy()
    np.testing.assert_allclose(ot.mv(torch.from_numpy(x)).numpy(),
                               np.asarray(oj.mv(_j(x))), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ot.rmv(torch.from_numpy(r)).numpy(),
                               np.asarray(oj.rmv(_j(r))), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["fourier", "haar", "db4"])
def test_adjoint_identity(kind):
    ot = _fourier_pair()[1] if kind == "fourier" else _composed_pair(wavelet=kind)[1]
    rng = np.random.default_rng(6)
    x = torch.from_numpy(np.asarray(rng.standard_normal(ot.shape[1])
                                    + 1j * rng.standard_normal(ot.shape[1]), dtype=np.complex64))
    r = torch.from_numpy(np.asarray(rng.standard_normal(ot.shape[0])
                                    + 1j * rng.standard_normal(ot.shape[0]), dtype=np.complex64))
    lhs = torch.vdot(ot.mv(x), r)
    rhs = torch.vdot(x, ot.rmv(r))
    assert abs(complex(lhs - rhs)) <= 1e-5 * float(torch.linalg.vector_norm(x)
                                                   * torch.linalg.vector_norm(r))


def test_fourier_operator_mask_and_geometry():
    fj, ft = _fourier_pair()
    np.testing.assert_array_equal(ft.mask().numpy(), np.asarray(fj.mask()))
    np.testing.assert_array_equal(ft.indices.numpy(), np.asarray(fj.indices))
    assert ft.kspace_op is ft
    cj, ct = _composed_pair()
    assert ct.kspace_op is ct.outer
    with pytest.raises(ValueError):
        tops.SubsampledFourierOperator.from_mask(np.zeros((4, 4), bool))
    with pytest.raises(ValueError):
        tops.ComposedOperator(ft, tops.WaveletSynthesisOperator(16))


def test_mri_operators_pass_the_solver_operator_seam():
    _, ct = _composed_pair()
    assert tops.is_linear_operator(ct)
    phi_true, get_ops = tops.make_iteration_operators(ct, None, "pair", "dense", None)
    assert phi_true is ct and get_ops(3) == (ct, ct)


# --- instances --------------------------------------------------------------------

@pytest.mark.parametrize("density", ["uniform", "variable"])
@pytest.mark.parametrize("r,fraction,seed", [(64, 0.35, 0), (48, 0.2, 5), (256, 0.35, 0)])
def test_cartesian_masks_bit_for_bit(r, fraction, seed, density):
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(tmri.cartesian_mask(r, fraction, tk, density),
                                  jmri.cartesian_mask(r, fraction, jk, density))


def test_mask_validation_matches_reference():
    _, tk = _keys(0)
    for kw in (dict(fraction=0.0), dict(fraction=0.5, density="radial"),
               dict(fraction=0.01, center_fraction=0.5)):
        with pytest.raises(ValueError):
            tmri.cartesian_mask(32, key=tk, **kw)


@pytest.mark.parametrize("seed", [0, 3, 17])
@pytest.mark.parametrize("r", [64, 256])
def test_phantoms_bit_for_bit(r, seed):
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(tmri.brain_phantom(r, tk, device="cpu").numpy(),
                                  np.asarray(jmri.brain_phantom(r, jk)))
    np.testing.assert_array_equal(tmri.shepp_logan(r, device="cpu").numpy(),
                                  np.asarray(jmri.shepp_logan(r)))


@pytest.mark.parametrize("s", [120, 2000])
def test_sparsify_keeps_the_reference_s_ties(s):
    """The phantom is piecewise constant: thousands of tied pixels, broken
    by index as lax.top_k breaks them."""
    img = jmri.shepp_logan(128)
    np.testing.assert_array_equal(
        tmri.sparsify_image(tmri.shepp_logan(128, device="cpu"), s).numpy(),
        np.asarray(jmri.sparsify_image(img, s)))


@pytest.mark.parametrize("n_bands", [1, 8, 16])
def test_bands_and_band_scales_match(n_bands):
    fj, ft = _fourier_pair(64, 0.35)
    bj = np.asarray(jmri.kspace_radial_bands(fj, n_bands=n_bands))
    bt = tmri.kspace_radial_bands(ft, n_bands=n_bands)
    np.testing.assert_array_equal(bt.numpy(), bj)
    np.testing.assert_array_equal(
        tmri.kspace_radial_bands(ft.indices, resolution=64, n_bands=n_bands).numpy(), bj)
    rng = np.random.default_rng(8)
    y = np.asarray(rng.standard_normal((2, fj.shape[0])) * 1j
                   + rng.standard_normal((2, fj.shape[0])), dtype=np.complex64)
    y[:, bj == 0] = 0                          # one all-zero band: scale 1
    np.testing.assert_array_equal(
        tmri.kspace_band_scales(torch.from_numpy(y), bt, n_bands).numpy(),
        np.asarray(jmri.kspace_band_scales(_j(y), _j(bj), n_bands)))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("batch", [0, 3])
@pytest.mark.parametrize("basis", ["pixel", "haar"])
def test_per_band_observations_match(bits, batch, basis):
    jk, tk = _keys(9)
    pj = jmri.make_mri_problem(64, 500, 0.35, jk, sparsity_basis=basis)
    pt = tmri.make_mri_problem(64, 500, 0.35, tk, sparsity_basis=basis, device="cpu")
    y = np.array(pj.y)
    if batch:
        y = np.asarray(np.stack([y * (1.0 + 0.5 * b) for b in range(batch)]), dtype=np.complex64)
    want = np.asarray(jmri.quantize_observations(_j(y), bits, jk, "per_band",
                                                 pj.op, 16))
    got = tmri.quantize_observations(torch.from_numpy(y), bits, tk, "per_band", pt.op, 16)
    assert got.dtype == torch.complex64
    assert np.abs(got.numpy() - want).max() <= 1e-6
    if batch:
        one = tmri.quantize_observations(torch.from_numpy(y[1]), bits, tk, "per_band",
                                         pt.op, 16)
        assert torch.equal(got[1], one)


def test_per_tensor_observations_and_validation():
    jk, tk = _keys(9)
    pj = jmri.make_mri_problem(32, 80, 0.5, jk)
    y = np.array(pj.y)
    np.testing.assert_allclose(
        tmri.quantize_observations(torch.from_numpy(y), 8, tk).numpy(),
        np.asarray(jmri.quantize_observations(_j(y), 8, jk)), rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        tmri.quantize_observations(torch.from_numpy(y), 8, tk, "per_block")
    with pytest.raises(ValueError):
        tmri.quantize_observations(torch.from_numpy(y), 8, tk, "per_band")


@pytest.mark.parametrize("basis", ["pixel", "haar", "db4"])
@pytest.mark.parametrize("snr_db", [None, 20.0])
def test_problems_match_reference(basis, snr_db):
    jk, tk = _keys(12)
    pj = jmri.make_mri_problem(64, 300, 0.35, jk, snr_db=snr_db, sparsity_basis=basis,
                               phantom="brain")
    pt = tmri.make_mri_problem(64, 300, 0.35, tk, snr_db=snr_db, sparsity_basis=basis,
                               phantom="brain", device="cpu")
    for name in ("y", "e", "x_true", "image_true"):
        np.testing.assert_allclose(getattr(pt, name).numpy(), np.asarray(getattr(pj, name)),
                                   rtol=0, atol=1e-5, err_msg=name)
    assert pt.op.shape == tuple(pj.op.shape) and pt.op.nbytes == pj.op.nbytes
    np.testing.assert_allclose(pt.to_image(pt.x_true).numpy(),
                               np.asarray(pj.to_image(pj.x_true)), rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        tmri.make_mri_problem(32, 80, 0.5, tk, sparsity_basis="dct", device="cpu")


# --- solves ----------------------------------------------------------------------------

def _x_close(x_t, x_j):
    x_j = np.asarray(x_j)
    assert np.linalg.norm(x_t.numpy() - x_j) <= 1e-3 * np.linalg.norm(x_j)
    np.testing.assert_array_equal(x_t.numpy() != 0, x_j != 0)


@pytest.mark.parametrize("config", ["mri-smoke", "mri-wavelet-smoke"])
def test_smoke_config_solves_match_reference(config):
    """The recover CLI's instance and solve at the smoke configs, single."""
    cfg = recover.CONFIGS[config]
    jk, tk = _keys(0)
    jl = importlib.import_module("repro.launch.recover")
    pj = jmri.make_mri_problem(cfg.resolution, cfg.n_sparse, cfg.fraction, jk,
                               sparsity_basis=cfg.sparsity_basis)
    prob, y, truth, kw = recover.mri_instance(cfg, 0, 0, "cpu", cfg.bits_y,
                                              cfg.scale_granularity)
    if cfg.scale_granularity == "per_band":
        yj = jmri.quantize_observations(pj.y, cfg.bits_y, jk, "per_band", pj.op, cfg.n_bands)
        jkw = dict(real_signal=True, nonneg=cfg.sparsity_basis == "pixel")
    else:
        yj = pj.y
        jkw = dict(real_signal=True, nonneg=True, bits_y=cfg.bits_y, key=jk)
    res_j = jniht.qniht(pj.op, yj, cfg.n_sparse, cfg.n_iters, **jkw)
    res_t = qniht(prob.op, y, cfg.n_sparse, cfg.n_iters, **kw)
    _x_close(res_t.x, res_j.x)
    r = cfg.resolution
    ps_j = float(jl.psnr(pj.to_image(res_j.x).reshape(r, r), pj.image_true.reshape(r, r)))
    out, res_cli, _ = recover.recover_mri(cfg, cfg.bits_y, 0, 0, "cpu", cfg.scale_granularity)
    assert torch.equal(res_cli.x, res_t.x)
    assert abs(out["psnr"] - ps_j) <= 0.01


def test_wavelet_smoke_batch_matches_reference():
    cfg = recover.CONFIGS["mri-wavelet-smoke"]
    jk, _ = _keys(0)
    prob, Y, truth, kw = recover.mri_instance(cfg, 0, 2, "cpu", cfg.bits_y, "per_band")
    pj = jmri.make_mri_problem(cfg.resolution, cfg.n_sparse, cfg.fraction, jk,
                               sparsity_basis="haar")
    imgs = jnp.stack([jmri.brain_phantom(cfg.resolution, jax.random.fold_in(jk, b)).ravel()
                      for b in range(2)])
    np.testing.assert_array_equal(truth.numpy(), np.asarray(imgs))
    Yj, _ = jmri.mri_observations(pj.op.kspace_op, imgs, None, jax.random.fold_in(jk, 2))
    Yj = jmri.quantize_observations(Yj, cfg.bits_y, jk, "per_band", pj.op, cfg.n_bands)
    assert np.abs(Y.numpy() - np.asarray(Yj)).max() <= 1e-5
    res_j = jniht.qniht_batch(pj.op, Yj, cfg.n_sparse, cfg.n_iters, real_signal=True)
    res_t = qniht_batch(prob.op, Y, cfg.n_sparse, cfg.n_iters, **kw)
    for b in range(2):
        _x_close(res_t.x[b], res_j.x[b])


def test_hsthresh_and_early_exit_on_the_mri_operator():
    """threshold='hsthresh' and the lossless exit on Φ = P_Ω F W†, as the
    reference runs them."""
    cfg = recover.CONFIGS["mri-wavelet-smoke"]
    jk, _ = _keys(0)
    prob, y, _, kw = recover.mri_instance(cfg, 0, 0, "cpu", cfg.bits_y, "per_band")
    pj = jmri.make_mri_problem(cfg.resolution, cfg.n_sparse, cfg.fraction, jk,
                               sparsity_basis="haar")
    yj = jmri.quantize_observations(pj.y, cfg.bits_y, jk, "per_band", pj.op, cfg.n_bands)
    for extra in (dict(threshold="hsthresh"), dict(early_exit=True)):
        res_j = jniht.qniht(pj.op, yj, cfg.n_sparse, cfg.n_iters, real_signal=True, **extra)
        res_t = qniht(prob.op, y, cfg.n_sparse, cfg.n_iters, **kw, **extra)
        _x_close(res_t.x, res_j.x)
    base = qniht(prob.op, y, cfg.n_sparse, cfg.n_iters, **kw)
    early = qniht(prob.op, y, cfg.n_sparse, cfg.n_iters, early_exit=True, **kw)
    assert torch.equal(base.x, early.x)


@pytest.mark.parametrize("argv", [["--config", "mri-smoke"],
                                  ["--config", "mri-wavelet-smoke", "--batch", "2"],
                                  ["--config", "mri-smoke", "--scale-granularity", "per_band",
                                   "--group-size", "4", "--sparsity-basis", "db4"]])
def test_recover_cli_mri_on_cpu(argv, capsys):
    recover.main(["--device", "cpu", *argv])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"[recover] {argv[1]} y@8bit[")
    assert "psnr" in line


@pytest.mark.parametrize("argv", [["--config", "mri-smoke", "--scale-granularity", "per_block"],
                                  ["--config", "lofar-smoke", "--scale-granularity", "per_band"],
                                  ["--config", "gaussian-smoke", "--sparsity-basis", "haar"]])
def test_recover_cli_rejects_misplaced_granularity(argv):
    with pytest.raises(SystemExit) as exc:
        recover.main(["--device", "cpu", *argv])
    assert exc.value.code == 2


@pytest.mark.slow
def test_acceptance_full_image_128_psnr30():
    """The reference's tests/test_mri.py acceptance on the port: the whole
    128×128 phantom at 35% variable-density sampling through Φ = P_Ω F W†
    reaches 30 dB, with f32 and with 8-bit per-band observations."""
    r, s = 128, 2000
    _, key = _keys(16)
    prob = tmri.make_mri_problem(r, s, 0.35, key, sparsity_basis="haar", device="cpu")
    img_true = prob.image_true.reshape(r, r)
    res = qniht(prob.op, prob.y, s, 40, real_signal=True)
    assert float(psnr(prob.to_image(res.x).reshape(r, r), img_true)) >= 30.0
    yq = tmri.quantize_observations(prob.y, 8, key, granularity="per_band", op=prob.op,
                                    n_bands=16)
    res_q = qniht(prob.op, yq, s, 40, real_signal=True)
    assert float(psnr(prob.to_image(res_q.x).reshape(r, r), img_true)) >= 30.0
