"""The port's runtime sanitizer (``repro_torch.analysis.sanitize``): the
NaN/Inf tripwire and the kernel-build counter, the twins of the reference's
``tests/test_sanitize.py``.

The reference counts XLA compiles; the port's compile step is the build or
load of a CUDA kernel library (``CudaLibrary.build``). On this machine no
kernel builds, so the counter tests load a shared library that exists
already (torch's extension module) through ``CudaLibrary``: a load is what the
counter counts, and a second ``build`` of the same object must not count.
The serving tests hold the contract the reference states, NaN-clean solves
with zero builds after warm-up, on the CPU. The kernel-output check is held
here on the function every launch calls; the card-only case is in
``tests/test_torch_cuda.py``.
"""
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import random as prng
from repro_torch.analysis.sanitize import CompileCounter, check_kernel_output, sanitize
from repro_torch.core.niht import qniht
from repro_torch.kernels.cudalib import CudaLibrary
from repro_torch.launch import recover
from repro_torch.parallel import BatchServer
from torch_threads import one_torch_thread  # noqa: F401 -- autouse: one intra-op thread

REPO = Path(__file__).resolve().parents[1]


def _problem(m, n, s, b, seed):
    rng = np.random.default_rng(seed)
    phi = torch.from_numpy((rng.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32))
    X = np.zeros((b, n), dtype=np.float32)
    for i in range(b):
        X[i, rng.choice(n, size=s, replace=False)] = rng.standard_normal(s)
    return phi, torch.from_numpy(X) @ phi.T


def _loaded_library(tmp_path) -> CudaLibrary:
    """A CudaLibrary whose built file already exists (torch's own extension
    module): ``build`` loads it as it loads a built kernel library, with no
    compiler."""
    lib = CudaLibrary(tmp_path / "none.cu", {"PyInit__C": []})
    lib.library_path = lambda: Path(torch._C.__file__)
    return lib


def _no_tripwire():
    return not importlib.import_module("repro_torch.analysis.sanitize")._TRIPWIRES


# ---------------------------------------------------------------- counter


def test_compile_counter_counts_fresh_and_cached(tmp_path):
    lib = _loaded_library(tmp_path)
    with CompileCounter() as cc:
        lib.build()
        assert cc.compiles == 1
        cc.mark_warm()
        lib.build()                       # loaded already: no second load
    assert cc.compiles == 1 and cc.compiles_since_warm == 0
    assert cc.compile_seconds > 0.0
    assert "compiles_after_warmup=0" in cc.summary()


def test_compile_counter_detects_rebuild(tmp_path):
    """A fresh library object per call reloads its library each time: the
    port's form of the reference's retrace."""
    with CompileCounter() as cc:
        cc.mark_warm()
        _loaded_library(tmp_path).build()
        _loaded_library(tmp_path).build()
    assert cc.compiles_since_warm == 2


# ---------------------------------------------------------------- sanitize


def test_sanitize_trips_on_nan():
    with sanitize():
        with pytest.raises(FloatingPointError, match="NaN produced by aten.sqrt"):
            torch.sqrt(torch.tensor(-1.0))


def test_sanitize_trips_on_inf():
    with sanitize():
        with pytest.raises(FloatingPointError, match="Inf produced by aten.div"):
            torch.tensor(1.0) / torch.tensor(0.0)
        with pytest.raises(FloatingPointError, match="Inf produced by aten._to_copy"):
            torch.tensor([1e300], dtype=torch.float64).to(torch.float32)   # a cast overflows


def test_sanitize_restores_state():
    assert _no_tripwire()
    with sanitize():
        assert not _no_tripwire()
    assert _no_tripwire() and bool(torch.isnan(torch.sqrt(torch.tensor(-1.0))))
    # restoration must also survive the tripwire firing
    try:
        with sanitize():
            torch.log(torch.tensor(0.0))
    except FloatingPointError:
        pass
    assert _no_tripwire() and bool(torch.isinf(torch.log(torch.tensor(0.0))))


def test_sanitize_allows_intentional_nan_transfer():
    """The solver's marker idiom: NaN built on the host and transferred is
    a transfer, not an operation; so are copies of it."""
    with sanitize():
        buf = torch.from_numpy(np.full((5,), np.nan, np.float32)).to(torch.float64)
        assert bool(torch.isnan(buf).all())
        assert bool(torch.isnan(buf.clone().contiguous()).all())
        assert bool(torch.isnan(torch.tensor([float("nan"), 1.0]))[0])


def test_sanitize_threads_counter(tmp_path):
    with sanitize(counter=CompileCounter()) as cc:
        assert isinstance(cc, CompileCounter)
        _loaded_library(tmp_path).build()
    assert cc.compiles >= 1


@pytest.mark.parametrize("nans,infs", [(True, True), (False, True), (True, False)])
def test_kernel_output_check_names_the_entry(nans, infs):
    """What a kernel writes through ctypes is checked by its launch, named
    by its entry, while the sanitizer is on, and for what it is on for."""
    out = torch.tensor([1.0, float("inf"), float("nan")])
    check_kernel_output("repro_qmm_tc", out)            # off: nothing
    with sanitize(nans=nans, infs=infs):
        with pytest.raises(FloatingPointError, match="kernel repro_qmm_tc") as exc:
            check_kernel_output("repro_qmm_tc", out)
        assert ("NaN" if nans else "Inf") in str(exc.value)
        check_kernel_output("repro_qmm_tc", torch.ones(3))
        check_kernel_output("repro_hist", torch.zeros(3, dtype=torch.int32))


# ------------------------------------------------------- serving contract


def test_batchserver_builds_nothing_for_three_same_shape_chunks():
    """Three same-shape chunks through a BatchServer: no kernel library is
    built or loaded after the first chunk (on the CPU none at all)."""
    phi, Y = _problem(m=33, n=65, s=3, b=6, seed=7)
    srv = BatchServer(phi, s=3, n_iters=12, with_trace=True)
    with sanitize(counter=CompileCounter()) as cc:
        srv.submit(Y[:2])
        cc.mark_warm()
        for chunk in (Y[2:4], Y[4:6]):
            srv.submit(chunk)
    assert cc.compiles_since_warm == 0, cc.summary()
    assert srv.n_chunks == 3


@pytest.mark.parametrize("backend", ["dense", "packed"])
def test_qniht_builds_nothing_on_repeated_same_shape_calls(backend):
    m, n = (35, 67) if backend == "dense" else (39, 69)
    phi, Y = _problem(m=m, n=n, s=3, b=1, seed=11)
    kw = dict(s=3, n_iters=10, bits_phi=8, bits_y=8, backend=backend, requantize="fixed",
              key=prng.PRNGKey(0), with_trace=False)
    first = qniht(phi, Y[0], **kw).x
    with CompileCounter() as cc:
        again = qniht(phi, Y[0], **kw).x
        qniht(phi, Y[0] * 0.5, **kw)
    assert cc.compiles == 0, cc.summary()
    assert torch.equal(first, again)


def test_batchserver_solve_is_nan_clean_under_sanitizer():
    phi, Y = _problem(m=45, n=89, s=3, b=2, seed=3)
    with sanitize():
        srv = BatchServer(phi, s=3, n_iters=25, with_trace=True)
        res = srv.submit(Y)
    assert torch.isfinite(res.x).all()


@pytest.mark.parametrize("backend", ["dense", "packed"])
def test_qniht_trips_on_a_nan_planted_in_y(backend):
    """A NaN planted in y (a transfer) trips at the first operation that
    computes with it, not later in a garbage recovery."""
    phi, Y = _problem(m=31, n=63, s=3, b=1, seed=5)
    y = Y[0].clone()
    y[4] = float("nan")
    with sanitize():
        with pytest.raises(FloatingPointError, match="NaN produced by aten"):
            qniht(phi, y, 3, 5, bits_phi=8, bits_y=8, backend=backend, requantize="fixed",
                  key=prng.PRNGKey(0))


@pytest.mark.parametrize("exit_tol", [0.0, 1e-3])
def test_solver_markers_pass_the_sanitizer(exit_tol):
    """The row an early-exit solve holds before its first iteration is NaN
    markers, built on the host and transferred: the lossless exit and the
    freeze rule run clean under the tripwire."""
    phi, Y = _problem(m=29, n=61, s=3, b=2, seed=9)
    with sanitize():
        res = qniht(phi, Y[0], 3, 8, early_exit=True, exit_tol=exit_tol)
    assert torch.isfinite(res.x).all() and torch.isfinite(res.trace.resid_q).all()


def test_sanitize_refuses_a_trace_of_markers():
    """``with_trace=False`` fills the trace with NaN markers; stacking them
    is an operation that produces NaN, which the tripwire refuses, as the
    reference's does: sanitized runs compute the real trace."""
    phi, Y = _problem(m=29, n=61, s=3, b=2, seed=9)
    with sanitize():
        with pytest.raises(FloatingPointError, match="aten.stack"):
            qniht(phi, Y[0], 3, 8, with_trace=False)


def test_recover_cli_sanitize_and_profile_dir_on_the_cpu(tmp_path, capsys):
    recover.main(["--config", "lofar-smoke", "--backend", "packed", "--device", "cpu",
                  "--sanitize", "--profile-dir", str(tmp_path / "prof")])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == ("[sanitize] ok compiles=0 compiles_after_warmup=n/a compile_s=0.00 "
                         "debug_nans=on debug_infs=on")
    assert lines[-1].startswith("[recover] lofar-smoke 2&8bit[packed]: rel_error=")
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


def test_recover_cli_full_precision_is_the_dense_backend(capsys):
    recover.main(["--config", "gaussian-smoke", "--device", "cpu", "--full-precision"])
    dense = capsys.readouterr().out.strip().splitlines()[-1]
    recover.main(["--config", "gaussian-smoke", "--device", "cpu", "--backend", "dense"])
    assert dense.startswith("[recover] gaussian-smoke 32bit: rel_error=")
    strip = lambda line: line.split(" wall_s=")[0]   # noqa: E731
    assert strip(dense) == strip(capsys.readouterr().out.strip().splitlines()[-1])


def test_recover_cli_devices_still_exits_2():
    """``--devices`` with ``--sanitize`` still exits 2 without ``--batch``
    (the rows it splits); with a batch each rank runs under the tripwire and
    rank 0 prints the ``[sanitize]`` line and the result."""
    base = [sys.executable, "-m", "repro_torch.launch.recover", "--device", "cpu",
            "--devices", "2", "--sanitize"]
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run(base, capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 2 and "combine it with --batch" in out.stderr
    out = subprocess.run([*base, "--config", "gaussian-smoke", "--batch", "4"],
                         capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 2 and lines[0].startswith("[sanitize] ok compiles=0 ")
    assert lines[1].startswith("[recover] gaussian-smoke 2&8bit[fake]: batch=4 ")


def test_a_failed_build_counts_nothing_and_leaves_no_file(tmp_path, monkeypatch):
    """A build that cannot run nvcc raises, loads nothing (no count) and
    leaves no temporary file in the build directory."""
    from repro_torch.kernels import cudalib

    monkeypatch.setattr(cudalib, "build_dir", lambda: tmp_path / "build")
    monkeypatch.setattr(cudalib, "_nvcc", lambda: str(tmp_path / "no-nvcc"))
    src = tmp_path / "k.cu"
    src.write_text("extern \"C\" int k(void *s) { return 0; }\n")
    with CompileCounter() as cc:
        with pytest.raises(FileNotFoundError):
            CudaLibrary(src, {"k": []}).build()
    assert cc.compiles == 0 and list((tmp_path / "build").iterdir()) == []
