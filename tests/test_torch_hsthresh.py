"""The streaming H_s of the port (histogram, select, mask, tie fill) and the
bisection H_s against the JAX reference, on identical inputs made with numpy
from a seed.

Histograms, thresholds and outputs are compared bit for bit, row by row: the
port repeats the reference's IEEE f32 operations in the same order, and its
batch axis only runs the reference's vector code once per row. The solver
uses ``nbins=2048``, as the reference's ``hsthresh`` passes it. Solves agree
to ‖Δx‖ ≤ 1e-3·‖x_jax‖ with identical supports.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.niht import qniht as jax_qniht, qniht_batch as jax_qniht_batch
from repro.core.threshold import (
    find_threshold_bisect as jax_find_threshold_bisect,
    hard_threshold_bisect as jax_hard_threshold_bisect,
)
from repro.kernels.hsthresh import ref as jref
from repro.kernels.hsthresh.ops import hsthresh as jax_hsthresh
from repro_torch import convert
from repro_torch.core.niht import qniht, qniht_batch
from repro_torch.core.threshold import (
    find_threshold_bisect,
    hard_threshold,
    hard_threshold_bisect,
)
from repro_torch.kernels.hsthresh import kernel as hs_kernel
from repro_torch.kernels.hsthresh.ops import hsthresh
from repro_torch.kernels.hsthresh.ref import (
    fill_threshold_bin,
    hist_ref,
    hsthresh_ref,
    mask_ref,
    row_vmax,
    select_threshold,
    tie_fill_mask,
)
from torch_threads import one_torch_thread  # noqa: F401 -- autouse: one intra-op thread


@pytest.fixture(autouse=True, scope="module")
def _leave_no_jax_executables():
    """Drop the JAX executables this module's reference calls compiled: an
    eager primitive cached with jax_debug_nans off would keep later tests in
    the process (tests/test_sanitize.py) from tripping."""
    yield
    jax.clear_caches()


NBINS = 2048


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """The port reproduces jax.random under jax_threefry_partitionable=True
    (JAX 0.9's default): hold the reference to that mode whatever the
    process default is."""
    with jax.threefry_partitionable(True):
        yield


def _j(a):
    return jnp.asarray(a, dtype=a.dtype)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _rows(kind: str) -> np.ndarray:
    """Three rows of a kind: generic, flat (every magnitude tied), plateaus
    tied at the threshold, zeros but for one entry, signed ties, and a
    nonnegative row with most entries zero (the projected LOFAR iterate)."""
    rng = np.random.default_rng(len(kind))
    n = 300
    if kind == "generic":
        x = rng.standard_normal((3, n))
    elif kind == "flat":
        x = np.ones((3, n))
    elif kind == "plateaus":
        x = np.concatenate([np.full((3, n // 2), 2.0), np.full((3, n - n // 2), 1.0)], axis=1)
    elif kind == "zeros":
        x = np.zeros((3, n))
        x[:, 3] = 1.0
        x[1] = 0.0
    elif kind == "signed_ties":
        x = rng.choice([-2.0, -1.0, 0.0, 1.0, 2.0, 0.5], size=(3, n))
    else:
        x = np.maximum(rng.standard_normal((3, n)), 0.0) ** 3
    return x.astype(np.float32)


KINDS = ["generic", "flat", "plateaus", "zeros", "signed_ties", "sparse_nonneg"]


@pytest.mark.parametrize("kind", KINDS)
def test_hist_and_select_bitwise_per_row(kind):
    x = _rows(kind)
    mag_t = torch.from_numpy(x).abs()
    vmax_t = row_vmax(mag_t)
    h_t = hist_ref(mag_t, vmax_t, NBINS)
    assert h_t.dtype == torch.int32 and h_t.shape == (3, NBINS)
    for s in (1, 7, 150):
        t_t = select_threshold(h_t, vmax_t, s)
        for b in range(3):
            mag = jnp.abs(_j(x[b]))
            vmax = jnp.maximum(jnp.max(mag), 1e-30)
            _eq(vmax_t[b], vmax)
            h = jref.hist_ref(mag, vmax, NBINS)
            _eq(h_t[b], h)
            _eq(t_t[b], jref.select_threshold(h, vmax, s))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("s", [1, 7, 150, 300])
def test_hsthresh_bitwise_per_row(kind, s):
    """The batched port against the reference's vector ``hsthresh_ref`` with
    nbins=2048, which is what its solver takes off the TPU, row by row."""
    x = _rows(kind)
    out_t = hsthresh(torch.from_numpy(x), s)
    torch.testing.assert_close(hsthresh_ref(torch.from_numpy(x), s, NBINS), out_t,
                               rtol=0, atol=0)
    for b in range(3):
        want = jref.hsthresh_ref(_j(x[b]), s, NBINS)
        _eq(out_t[b], want)
        _eq(out_t[b], jax_hsthresh(_j(x[b]), s))
        _eq(hsthresh(torch.from_numpy(x[b]), s), want)      # the vector form
        assert int((out_t[b] != 0).sum()) <= s


@pytest.mark.parametrize("s", [5, 40])
def test_hsthresh_matches_the_pallas_kernels_in_interpret_mode(s):
    """N a multiple of the reference's block (1,024): its padded Pallas route
    then bins exactly what the port bins."""
    x = np.random.default_rng(s).standard_normal((2, 2048)).astype(np.float32)
    out_t = hsthresh(torch.from_numpy(x), s)
    for b in range(2):
        _eq(out_t[b], jax_hsthresh(_j(x[b]), s, use_pallas=True, interpret=True))


def test_hsthresh_default_nbins_of_the_ref_is_4096():
    x = _rows("generic")
    for b in range(3):
        _eq(hsthresh_ref(torch.from_numpy(x[b]), 9), jref.hsthresh_ref(_j(x[b]), 9))


@pytest.mark.parametrize("kind", ["generic", "signed_ties", "plateaus"])
def test_mask_and_fill_bitwise(kind):
    x = _rows(kind)
    xt = torch.from_numpy(x)
    t = torch.tensor([0.5, 1.0, 1.5], dtype=torch.float32)
    binw = torch.tensor([0.25, 0.5, 0.5], dtype=torch.float32)
    y = mask_ref(xt, t)
    filled = fill_threshold_bin(xt, y, t, binw, 20)
    for b in range(3):
        yj = jref.mask_ref(_j(x[b]), jnp.float32(t[b].item()))
        _eq(y[b], yj)
        _eq(filled[b], jref.fill_threshold_bin(_j(x[b]), yj, jnp.float32(t[b].item()),
                                               jnp.float32(binw[b].item()), 20))


@pytest.mark.parametrize("s", [0, 3, 10])
def test_tie_fill_mask_bitwise(s):
    rng = np.random.default_rng(s)
    strict = rng.random((4, 50)) < 0.1
    tied = (rng.random((4, 50)) < 0.3) & ~strict
    got = tie_fill_mask(torch.from_numpy(strict), torch.from_numpy(tied), s)
    for b in range(4):
        _eq(got[b], jref.tie_fill_mask(_j(strict[b]), _j(tied[b]), s))


@functools.lru_cache(maxsize=None)
def _jax_bisect(s):
    """The reference's vector functions, vmapped over rows and compiled once
    per s (the ops are exact or elementwise, so each row is the vector's)."""
    return (jax.jit(jax.vmap(lambda v: jax_hard_threshold_bisect(v, s))),
            jax.jit(jax.vmap(lambda m: jax_find_threshold_bisect(m, s))))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("s", [1, 5, 64])
def test_hard_threshold_bisect_bitwise(kind, s):
    x = _rows(kind)
    got = hard_threshold_bisect(torch.from_numpy(x), s)
    t = find_threshold_bisect(torch.from_numpy(x).abs(), s)
    jax_h, jax_t = _jax_bisect(s)
    _eq(got, jax_h(_j(x)))
    _eq(t, jax_t(jnp.abs(_j(x))))
    _eq(got[1], jax_hard_threshold_bisect(_j(x[1]), s))      # the vector call itself


def test_bisect_equals_exact_on_distinct_magnitudes():
    x = torch.from_numpy(_rows("generic"))
    torch.testing.assert_close(hard_threshold_bisect(x, 12), hard_threshold(x, 12),
                               rtol=0, atol=0)


def test_cpu_hsthresh_never_launches_a_kernel():
    before = (hs_kernel.HIST.launches, hs_kernel.MASK.launches)
    hsthresh(torch.randn(4, 100), 5)
    assert (hs_kernel.HIST.launches, hs_kernel.MASK.launches) == before == (0, 0)
    assert hs_kernel.HIST._lib is None and hs_kernel.MASK._lib is None
    with pytest.raises(ValueError, match="CUDA"):
        hs_kernel.hist_cuda(torch.randn(2, 10), torch.ones(2), NBINS)
    with pytest.raises(ValueError, match="CUDA"):
        hs_kernel.mask_cuda(torch.randn(2, 10), torch.ones(2))


def _fused_model(x: torch.Tensor, s: int, nbins: int, clusters: int,
                 warps: int = 16) -> torch.Tensor:
    """A plain torch model of ``csrc/hsthresh_fused.cu``'s decomposition of
    each row into ``clusters`` chunks (the CTAs of a cluster) of ``warps``
    segments each: per-chunk maxima and histograms summed, the same pick in
    every chunk (idx = the number of bins whose suffix sum exceeds s), strict
    and tied counts per chunk and warp, and a tie's row rank from the
    exclusive prefix of the tied counts of the lower chunks and warps plus
    its rank inside its warp."""
    b, n = x.shape
    per = -(-n // clusters)
    L = -(-per // 4) * 4
    bounds = [(min(n, r * L), min(n, (r + 1) * L)) for r in range(clusters)]
    mags = [x[:, a:e].abs() for a, e in bounds]
    cmax = torch.stack([m.amax(dim=1) if m.shape[1] else torch.zeros(b) for m in mags], dim=1)
    vmax = torch.clamp_min(cmax.amax(dim=1), 1e-30)
    hist = torch.zeros(b, nbins, dtype=torch.int32)
    for m in mags:
        hist += hist_ref(m, vmax, nbins)
    picks = []
    for _ in bounds:                      # every chunk picks from the same counts
        tail = hist.flip(-1).cumsum(-1).flip(-1)
        idx = (tail > s).sum(dim=-1)
        picks.append(idx.to(torch.float32) * vmax / nbins)
    assert all(torch.equal(p, picks[0]) for p in picks)
    t = picks[0]
    lo = (t - vmax / nbins).unsqueeze(-1)
    y = torch.zeros_like(x)
    # per chunk and warp segment: strict survivors and ties
    segs, strict_total = [], torch.zeros(b, dtype=torch.int64)
    for a, e in bounds:
        seg = -(-(-(-(e - a) // warps)) // 32) * 32
        for w in range(warps):
            wa, we = min(e, a + w * seg), min(e, a + (w + 1) * seg)
            mag = x[:, wa:we].abs()
            st = mag > t.unsqueeze(-1)
            ti = (mag >= lo) & ~st & (mag > 0)
            segs.append((wa, we, st, ti))
            strict_total += st.sum(dim=1)
    room = (s - strict_total).unsqueeze(-1)
    before = torch.zeros(b, 1, dtype=torch.int64)          # ties of lower chunks and warps
    for wa, we, st, ti in segs:
        rank = before + torch.cumsum(ti.to(torch.int64), dim=1) - ti.to(torch.int64)
        keep = st | (ti & (rank < room))
        y[:, wa:we] = torch.where(keep, x[:, wa:we], torch.zeros_like(x[:, wa:we]))
        before = before + ti.sum(dim=1, keepdim=True)
    return y


def _fused_rows(kind: str, n: int, clusters: int) -> np.ndarray:
    """Rows for the decomposition: generic, threshold-bin ties that straddle
    the chunk boundaries, a flat row, an all-zero row."""
    rng = np.random.default_rng(n + clusters)
    if kind == "generic":
        x = rng.standard_normal((2, n))
    elif kind == "straddle":
        # a plateau of equal magnitudes around every chunk boundary, above a
        # generic floor: the plateau is the threshold bin
        x = rng.standard_normal((2, n)) * 0.1
        L = -(-(-(-n // clusters)) // 4) * 4
        for r in range(1, clusters):
            a, e = min(n, max(0, r * L - 5)), min(n, r * L + 5)
            x[:, a:e] = np.where(rng.random((2, e - a)) < 0.5, 1.0, -1.0)
        x[:, :3] = 1.0
    elif kind == "flat":
        x = np.full((2, n), 0.75)
        x[1] *= -1.0
    else:
        x = np.zeros((2, n))
    return x.astype(np.float32)


@pytest.mark.parametrize("clusters", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("kind", ["generic", "straddle", "flat", "zeros"])
@pytest.mark.parametrize("n,s", [(4096, 30), (1001, 30), (20, 30), (30, 30), (1001, 7)])
def test_fused_decomposition_is_bitwise(clusters, kind, n, s):
    """The fused kernel's chunked algorithm, modelled in plain torch, equals
    hsthresh_ref and the reference's hsthresh_ref (nbins 2,048) bit for bit,
    for any number of chunks: ties straddling chunk edges, flat and all-zero
    rows, N <= s and the ragged N = 1,001."""
    x = _fused_rows(kind, n, clusters)
    xt = torch.from_numpy(x)
    got = _fused_model(xt, s, NBINS, clusters)
    torch.testing.assert_close(got, hsthresh_ref(xt, s, NBINS), rtol=0, atol=0)
    for b in range(x.shape[0]):
        _eq(got[b], jref.hsthresh_ref(_j(x[b]), s, NBINS))
        assert int((got[b] != 0).sum()) <= max(s, 0)


def test_fused_decomposition_fills_ties_across_chunks_in_index_order():
    """More ties than room, spread over every chunk: exactly s entries
    survive, the first s tied ones by index, whichever chunk holds them."""
    n, s = 4096, 30
    x = np.zeros((1, n), np.float32)
    x[0, ::100] = 2.0                       # 41 equal magnitudes over the row
    for clusters in (2, 3, 8, 16):
        got = _fused_model(torch.from_numpy(x), s, NBINS, clusters)
        kept = torch.nonzero(got[0]).flatten()
        assert kept.tolist() == list(range(0, 100 * s, 100))
        _eq(got[0], jref.hsthresh_ref(_j(x[0]), s, NBINS))


def test_cpu_hsthresh_launches_no_fused_kernel():
    before = hs_kernel.HSTHRESH.launches
    out = hsthresh(torch.randn(3, 500), 9)
    assert out.shape == (3, 500) and hs_kernel.HSTHRESH.launches == before == 0
    assert hs_kernel.HSTHRESH._lib is None
    with pytest.raises(ValueError, match="CUDA"):
        hs_kernel.hsthresh_cuda(torch.randn(2, 10), 3, NBINS)
    assert hs_kernel.HSTHRESH.library.source.name == "hsthresh_fused.cu"
    assert hs_kernel.HSTHRESH.library.source.is_file()


def test_hsthresh_refuses_complex():
    with pytest.raises(TypeError):
        hsthresh(torch.ones(8, dtype=torch.complex64), 2)


def _lofar_smoke(batch):
    from repro.configs.lofar_cs302 import SMOKE
    from repro.sensing.sky import make_sky
    from repro.sensing.telescope import Station, measurement_matrix, visibilities

    phi = measurement_matrix(Station(n_antennas=SMOKE.n_antennas, seed=SMOKE.seed),
                             SMOKE.resolution, SMOKE.extent)
    key = jax.random.PRNGKey(8)
    skies = [make_sky(SMOKE.resolution, SMOKE.n_sources, jax.random.fold_in(key, b),
                      min_sep=SMOKE.min_sep) for b in range(batch)]
    Y = np.stack([np.asarray(visibilities(phi, x, SMOKE.snr_db, jax.random.fold_in(key, b))[0])
                  for b, x in enumerate(skies)])
    return SMOKE, np.array(phi), Y, np.stack([np.asarray(x) for x in skies])


def _assert_solve_close(res_t, res_j):
    xj, xt = np.asarray(res_j.x), res_t.x.numpy()
    assert np.linalg.norm(xt - xj) <= 1e-3 * np.linalg.norm(xj)
    np.testing.assert_array_equal(xt != 0, xj != 0)
    np.testing.assert_allclose(res_t.trace.resid_q.numpy(), np.asarray(res_j.trace.resid_q),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_array_equal(res_t.trace.backtracks.numpy(),
                                  np.asarray(res_j.trace.backtracks))


@pytest.mark.parametrize("backend", ["packed"])
def test_lofar_smoke_hsthresh_solve_matches_reference(backend):
    """threshold='hsthresh' on the real-signal LOFAR path, batch 2 and one row."""
    cs, phi, Y, _ = _lofar_smoke(2)
    jk = jax.random.PRNGKey(5)
    tk = convert.key_from_numpy(np.asarray(jk))
    kw = dict(bits_phi=2, bits_y=8, requantize="fixed", backend=backend, real_signal=True,
              nonneg=True, threshold="hsthresh")
    res_j = jax_qniht_batch(_j(phi), _j(Y), cs.n_sources, 12, key=jk, **kw)
    res_t = qniht_batch(torch.from_numpy(phi), torch.from_numpy(Y), cs.n_sources, 12, key=tk,
                        **kw)
    _assert_solve_close(res_t, res_j)
    res_1 = qniht(torch.from_numpy(phi), torch.from_numpy(Y[1]), cs.n_sources, 12, key=tk,
                  **kw)
    ref = float(torch.linalg.vector_norm(res_t.x[1]))
    assert float(torch.linalg.vector_norm(res_1.x - res_t.x[1])) <= 1e-3 * ref


def test_gaussian_hsthresh_single_solve_matches_reference():
    rng = np.random.default_rng(3)
    phi = rng.standard_normal((64, 128)).astype(np.float32)
    x = np.zeros(128, np.float32)
    x[rng.choice(128, 6, replace=False)] = np.abs(rng.standard_normal(6)) + 0.5
    y = (phi @ x).astype(np.float32)
    jk = jax.random.PRNGKey(2)
    kw = dict(bits_phi=8, bits_y=8, requantize="fixed", backend="dense", real_signal=True,
              threshold="hsthresh")
    res_j = jax_qniht(_j(phi), _j(y), 6, 20, key=jk, **kw)
    res_t = qniht(torch.from_numpy(phi), torch.from_numpy(y), 6, 20,
                  key=convert.key_from_numpy(np.asarray(jk)), **kw)
    _assert_solve_close(res_t, res_j)


def test_hsthresh_needs_a_real_signal():
    phi = torch.randn(16, 32)
    with pytest.raises(ValueError, match="real-signal"):
        jax_qniht(_j(phi.numpy()), jnp.ones(16), 2, 3, threshold="hsthresh")
    with pytest.raises(ValueError, match="real-signal"):
        qniht(phi, torch.ones(16), 2, 3, threshold="hsthresh")
