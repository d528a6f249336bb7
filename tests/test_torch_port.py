"""Boundaries of the port: it imports neither JAX nor the JAX package, its
entry points run on the GPU unless asked for the CPU, and its recover CLI
reproduces the README quickstart's bound on the CPU."""
import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.launch import recover
from torch_threads import one_torch_thread  # noqa: F401 -- autouse: one intra-op thread

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
SMOKE = REPO / "chip_smoke.py"


@pytest.fixture(autouse=True, scope="module")
def _leave_no_jax_executables():
    """Drop the JAX executables the reference draws below compiled: an eager
    primitive cached with jax_debug_nans off would keep later tests in the
    process (tests/test_sanitize.py) from tripping."""
    yield
    if "jax" in sys.modules:
        sys.modules["jax"].clear_caches()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PORT)], prefix="repro_torch."))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top.startswith("jax") or top == "jaxlib" or top == "repro"


def test_importing_the_port_loads_no_jax_and_no_reference():
    mods = _port_modules()
    assert "repro_torch.kernels.qmm.kernel" in mods and "repro_torch.launch.recover" in mods
    assert {"repro_torch.core.rip", "repro_torch.core.baselines",
            "repro_torch.analysis.sanitize"} <= set(mods)
    code = (
        "import sys, importlib, runpy\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"ns = runpy.run_path({str(SMOKE)!r}, run_name='chip_smoke_imports')\n"
        "ns['load_port']()\n"
        "print('\\n'.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    assert "torch" in loaded and "repro_torch.core.niht" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in
                                        [*PORT.rglob("*.py"), SMOKE]))
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not [n for n in names if _forbidden(n)], (path, node.lineno, names)


def _imports_jax(tree) -> bool:
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                 [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        if any(n == "jax" or n.startswith("jax.") for n in names):
            return True
    return False


def _clears_jax_caches_at_module_end(tree) -> bool:
    """A module-scoped autouse fixture ``_leave_no_jax_executables`` that
    calls ``clear_caches``."""
    for node in tree.body:
        if not (isinstance(node, ast.FunctionDef) and node.name == "_leave_no_jax_executables"):
            continue
        keywords = {kw.arg: getattr(kw.value, "value", None)
                    for dec in node.decorator_list if isinstance(dec, ast.Call)
                    for kw in dec.keywords}
        calls = [n.func.attr for n in ast.walk(node)
                 if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)]
        return (keywords.get("autouse") is True and keywords.get("scope") == "module"
                and "clear_caches" in calls)
    return False


@pytest.mark.parametrize("path", sorted(p.name for p in (REPO / "tests").glob("test_torch_*.py")))
def test_port_test_files_that_import_jax_clear_its_caches(path):
    """A port test file that calls the reference compiles eager JAX
    primitives with jax_debug_nans and jax_debug_infs off; left cached, they
    keep tests/test_sanitize.py from tripping when ``--dist loadfile`` puts
    it in the same worker (test_torch_mri.py and test_torch_threshold.py
    did). Every such file clears JAX's caches at module end."""
    tree = ast.parse((REPO / "tests" / path).read_text())
    if _imports_jax(tree):
        assert _clears_jax_caches_at_module_end(tree), (
            f"tests/{path} imports jax but has no module-scoped autouse fixture "
            "_leave_no_jax_executables calling jax.clear_caches()")


def test_cuda_is_the_default_device_and_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.device import resolve_device
    from repro_torch.sensing.gaussian import make_gaussian_problem

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        make_gaussian_problem(8, 16, 2)
    with pytest.raises(RuntimeError):
        recover.main(["--config", "gaussian-smoke", "--backend", "packed"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_recover_cli_gaussian_smoke_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.recover", "--config", "gaussian-smoke",
         "--backend", "packed", "--bits-phi", "8", "--device", "cpu"],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("[recover] gaussian-smoke 8&8bit[packed]: rel_error=")
    rel = float(line.split("rel_error=")[1].split()[0])
    assert rel < 0.15


def test_recover_cli_default_device_fails_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the CPU-only failure cannot show here")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.recover", "--config", "gaussian-smoke"],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=120)
    assert out.returncode != 0 and "torch.cuda.is_available() is False" in out.stderr
    assert "[recover]" not in out.stdout


@pytest.mark.parametrize("argv,says", [
    (["--devices", "2"], "combine it with --batch"),
    (["--batch", "2", "--dist-backend", "gloo"], "--dist-backend"),
])
def test_recover_rejects_unported_options(argv, says, capsys):
    """What --devices still refuses: it splits a batch's rows, so it needs
    --batch, and --dist-backend names the backend of N > 1 ranks."""
    with pytest.raises(SystemExit) as exc:
        recover.main(["--device", "cpu", *argv])
    assert exc.value.code == 2
    assert says in capsys.readouterr().err


def test_recover_cli_devices_4_prints_the_one_device_line(capfd):
    """``--devices 4`` (four gloo ranks on the CPU): rank 0 alone prints, and
    its line is the one-device run's, x_digest included."""
    argv = ["--device", "cpu", "--config", "gaussian-smoke", "--batch", "10"]
    recover.main(argv)
    one = capfd.readouterr().out.strip().splitlines()
    recover.main([*argv, "--devices", "4"])
    four = capfd.readouterr().out.strip().splitlines()
    assert len(one) == len(four) == 1 and "x_digest=" in one[0]
    assert one[0].split(" wall_s=")[0] == four[0].split(" wall_s=")[0]


def test_recover_lofar_smoke_batch_on_cpu():
    from repro_torch.configs.lofar_cs302 import SMOKE as LOFAR_SMOKE

    out, res, x_true = recover.recover_lofar(LOFAR_SMOKE, "packed", 2, 8, seed=1, batch=2,
                                             device="cpu")
    assert res.x.shape == x_true.shape == (2, 1024)
    assert out["rel_error_max"] < 0.5 and res.trace.resid_q.shape == (LOFAR_SMOKE.n_iters, 2)


def _reference_lofar_instance(cs, seed, batch):
    """(Y, X) as ``repro.launch.recover.recover_lofar`` draws them: the sky
    and its noise from ``PRNGKey(seed)``, row b from ``fold_in(key, b)``."""
    import jax

    from repro.sensing.sky import make_sky
    from repro.sensing.telescope import Station, measurement_matrix, visibilities

    with jax.threefry_partitionable(True):
        key = jax.random.PRNGKey(seed)
        phi = measurement_matrix(Station(n_antennas=cs.n_antennas, seed=cs.seed),
                                 cs.resolution, cs.extent)
        keys = [jax.random.fold_in(key, b) for b in range(batch)] if batch else [key]
        xs = [make_sky(cs.resolution, cs.n_sources, k, min_sep=cs.min_sep) for k in keys]
        ys = [visibilities(phi, x, cs.snr_db, k)[0] for x, k in zip(xs, keys)]
    Y, X = np.stack([np.asarray(y) for y in ys]), np.stack([np.asarray(x) for x in xs])
    return (Y, X) if batch else (Y[0], X[0])


def _reference_gaussian_instance(g, seed, batch):
    """(Y, X) as ``repro.launch.recover.recover_gaussian`` draws them: the
    problem from ``PRNGKey(seed)``, row b from ``fold_in(key, b + 1)`` on its Φ."""
    import jax

    from repro.sensing.gaussian import make_gaussian_problem

    with jax.threefry_partitionable(True):
        key = jax.random.PRNGKey(seed)
        prob = make_gaussian_problem(g.m, g.n, g.s, 20.0, key)
        if not batch:
            return np.asarray(prob.y), np.asarray(prob.x_true)
        probs = [make_gaussian_problem(g.m, g.n, g.s, 20.0, jax.random.fold_in(key, b + 1),
                                       phi=prob.phi) for b in range(batch)]
    return (np.stack([np.asarray(p.y) for p in probs]),
            np.stack([np.asarray(p.x_true) for p in probs]))


def _hold_instance(y, x, y_ref, x_ref, exact_values):
    """Supports (sky positions) bit for bit; the values bit for bit for a sky
    (uniform fluxes) and within 1e-5 relative for Gaussian ones (``normal``);
    y within 1e-4 of its largest entry (Φ's own 1e-4 gap and ``normal``)."""
    x, y = x.numpy(), y.numpy()
    np.testing.assert_array_equal(x != 0, x_ref != 0)
    if exact_values:
        np.testing.assert_array_equal(x, x_ref)
    else:
        np.testing.assert_allclose(x, x_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=1e-4 * float(np.abs(y_ref).max()))


@pytest.mark.parametrize("batch", [0, 2])
def test_lofar_instance_is_the_sky_recover_solves(batch):
    from repro_torch.configs.lofar_cs302 import SMOKE as LOFAR_SMOKE

    phi, y, x = recover.lofar_instance(LOFAR_SMOKE, 3, batch, "cpu")
    _, res, x_true = recover.recover_lofar(LOFAR_SMOKE, "dense", None, None, seed=3,
                                           batch=batch, device="cpu")
    assert torch.equal(x, x_true) and phi.shape == (870, 1024)
    assert y.shape == ((batch, 870) if batch else (870,)) and res.x.shape == x.shape
    _hold_instance(y, x, *_reference_lofar_instance(LOFAR_SMOKE, 3, batch), exact_values=True)


def test_gaussian_batch_instance_is_the_batch_recover_solves():
    from repro_torch.configs.gaussian_toy import SMOKE as GAUSS_SMOKE

    phi, Y, X = recover.gaussian_batch_instance(GAUSS_SMOKE, 2, 3, "cpu")
    _, res, x_true = recover.recover_gaussian(GAUSS_SMOKE, "packed", 8, 8, seed=2,
                                              requantize="fixed", batch=3, device="cpu")
    assert torch.equal(X, x_true) and Y.shape == (3, GAUSS_SMOKE.m)
    assert phi.shape == (GAUSS_SMOKE.m, GAUSS_SMOKE.n) and res.x.shape == X.shape
    _hold_instance(Y, X, *_reference_gaussian_instance(GAUSS_SMOKE, 2, 3), exact_values=False)


@pytest.mark.parametrize("config", ["lofar-smoke", "gaussian-smoke"])
@pytest.mark.parametrize("batch", [0, 4])
def test_recover_draws_the_reference_instance(config, batch):
    """For one ``--seed`` the recover CLI's solve sees the reference's
    instance (``recover_lofar``/``recover_gaussian`` return the truth they
    solved; the Gaussian y is the instance function's)."""
    from repro_torch.configs import CONFIGS

    cfg = CONFIGS[config]
    if config.startswith("lofar"):
        _, y, _ = recover.lofar_instance(cfg, 5, batch, "cpu")
        _, _, x = recover.recover_lofar(cfg, "dense", None, None, seed=5, batch=batch,
                                        device="cpu")
        _hold_instance(y, x, *_reference_lofar_instance(cfg, 5, batch), exact_values=True)
        return
    _, _, x = recover.recover_gaussian(cfg, "dense", None, None, seed=5, batch=batch,
                                       device="cpu")
    if batch:
        _, y, x_inst = recover.gaussian_batch_instance(cfg, 5, batch, "cpu")
    else:
        from repro_torch import random as prng
        from repro_torch.sensing.gaussian import make_gaussian_problem

        prob = make_gaussian_problem(cfg.m, cfg.n, cfg.s, 20.0, prng.PRNGKey(5), device="cpu")
        y, x_inst = prob.y, prob.x_true
    assert torch.equal(x, x_inst)
    _hold_instance(y, x, *_reference_gaussian_instance(cfg, 5, batch), exact_values=False)


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    out = subprocess.run([sys.executable, str(SMOKE)], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, alone)
    out = subprocess.run([sys.executable, str(alone)], capture_output=True, text=True,
                         cwd=tmp_path, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_package_docstring_names_the_default():
    assert "cuda" in repro_torch.__doc__
